"""Output writers of the port: the JAX package's npz / VTK / Matlab
writers (``sailfish_tpu/io.py``), casting fields to the simulation
precision through the port's numpy dtype (its ``config.dtype`` is a torch
dtype, which numpy cannot read)."""

from __future__ import annotations

import numpy as np

from sailfish_tpu import io as _io


class _CastToSimulationPrecision:
    def fields_dict(self, cast=False):
        out = super().fields_dict(cast=False)
        if not cast:
            return out
        dt = np.dtype(self.config.np_dtype)
        return {k: (np.asarray(v, dtype=dt)
                    if np.issubdtype(np.asarray(v).dtype, np.floating)
                    else np.asarray(v))
                for k, v in out.items()}


class NPYOutput(_CastToSimulationPrecision, _io.NPYOutput):
    pass


class VTKOutput(_CastToSimulationPrecision, _io.VTKOutput):
    pass


class MatlabOutput(_CastToSimulationPrecision, _io.MatlabOutput):
    pass


FORMATS = {c.format_name: c for c in (NPYOutput, VTKOutput, MatlabOutput)}


def format_name_to_cls(name):
    try:
        return FORMATS[name]
    except KeyError:
        raise ValueError(f'unknown output format {name!r}; '
                         f'known: {sorted(FORMATS)}') from None
