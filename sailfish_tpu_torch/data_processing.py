"""Data processing on the device: axis reductions, product statistics, and
slices of the macroscopic fields.

The port's copy of ``sailfish_tpu/data_processing.py`` (counterpart of the
reference's ``templates/data_processing.mako`` reduction kernels,
``reduction`` :318, ``stats_global`` :489): a statistic is a tensor
reduction over the device state, evaluated on demand or sampled into a
time series by a device hook (``LBSim.add_device_hook``), with no host
round trip.

A statistic follows the reference's spec format: a list of product terms
``[(field_index, power), ...]``; e.g. ``[(0, 1)]`` is <f0>, ``[(0, 2)]``
is <f0^2>, ``[(0, 1), (1, 1)]`` is the <f0 f1> correlation. ``axis``
names the axis NOT reduced over (None = reduce to a scalar), matching the
reference's axis parameter.
"""

from __future__ import annotations

import torch

from sailfish_tpu_torch import state as st
from sailfish_tpu_torch.models.base import LBMixIn

#: built-in field getters: fn(rho, u) -> tensor
FIELD_GETTERS = {
    'rho': lambda rho, u: rho,
    'vx': lambda rho, u: u[0],
    'vy': lambda rho, u: u[1],
    'vz': lambda rho, u: u[2],
    'usq': lambda rho, u: torch.sum(u * u, dim=0),
}

_OPS = {
    'sum': lambda x, dim: torch.sum(x, dim=dim),
    'mean': lambda x, dim: torch.mean(x, dim=dim),
    'max': lambda x, dim: torch.amax(x, dim=dim),
    'min': lambda x, dim: torch.amin(x, dim=dim),
}


def _resolve_fields(fields):
    return [fd if callable(fd) else FIELD_GETTERS[fd] for fd in fields]


def build_reducer(builder, dim, fields, stats=(((0, 1),),), axis=None,
                  op='sum', dtype=None):
    """Returns reduce(f, it=0) -> (n_stats, ...): a reduction over the
    state. ``axis``: spatial axis kept ('x'/'y'/'z' or None). ``dtype``
    of the values reduced: float64 for an fp64 builder, else float32 (the
    JAX package's float64 with x64 off)."""
    getters = _resolve_fields(fields)
    opf = _OPS[op]
    if dtype is None:
        dtype = torch.float64 if builder.dtype == torch.float64 \
            else torch.float32
    if axis is None:
        reduce_axes = tuple(range(dim))
    else:
        keep = dim - 1 - {'x': 0, 'y': 1, 'z': 2}[axis]
        reduce_axes = tuple(a for a in range(dim) if a != keep)

    def reduce_fn(f, it=0):
        rho, u = builder.macro_fields(f, it)
        if isinstance(rho, (tuple, list)):   # multi-component models
            rho = rho[0]
        vals = [g(rho, u).to(dtype) for g in getters]
        outs = []
        for term in stats:
            prod = None
            for fid, power in term:
                v = vals[fid]
                p = v if power == 1 else v ** power
                prod = p if prod is None else prod * p
            outs.append(opf(prod, reduce_axes))
        return torch.stack(outs)

    return reduce_fn


def build_slicer(builder, dim, axis, position, fields=('rho',)):
    """Returns slice_fn(f, it=0) -> (n_fields, *plane): the axis-aligned
    slice at ``position`` of the macroscopic fields (the device half of the
    reference's Vis2DSliceMixIn / ExtractSliceUsq machinery)."""
    getters = _resolve_fields(fields)
    comp = {'x': 0, 'y': 1, 'z': 2}[axis]

    def slice_fn(f, it=0):
        rho, u = builder.macro_fields(f, it)
        if isinstance(rho, (tuple, list)):
            rho = rho[0]
        out = []
        for g in getters:
            v = g(rho, u)
            out.append(v.select(v.dim() - 1 - comp, position))
        return torch.stack(out)

    return slice_fn


class DataProcessingMixIn(LBMixIn):
    """User-facing registration API for reductions and slices.

    On demand:   v = self.compute_reduction(runner, name)
    Time series: self.add_reduction(runner, name, ..., every=k) inside
    before_main_loop, then self.reduction_series(name) afterwards.
    """

    def _dp_state(self):
        if not hasattr(self, '_dp_reducers'):
            self._dp_reducers = {}
            self._dp_hooks = {}
        return self._dp_reducers, self._dp_hooks

    def add_reduction(self, runner, name, fields, stats=(((0, 1),),),
                      axis=None, op='sum', every=None):
        reducers, hooks = self._dp_state()
        fn = build_reducer(runner.builder, self.dim, fields, stats, axis, op)
        reducers[name] = fn
        if every is None:
            return
        # samples land at iterations every, 2 every, ... in slots 0, 1, ...
        # (no zero row at the head)
        nslots = max(self.config.max_iters // every, 1)
        with torch.no_grad():
            sample = fn(runner.f)
        series0 = torch.zeros((nslots,) + tuple(sample.shape),
                              dtype=sample.dtype)

        def hook(f, series, it, _fn=fn, _e=every):
            if it % _e:
                return series
            value = _fn(f, it)
            slot = it // _e - 1
            if slot < series.shape[0]:   # a sample past the last slot drops
                series[slot] = value
            return series

        hooks[name] = (self.add_device_hook(series0, hook, every=every),
                       runner)

    def add_slice(self, runner, name, axis, position, fields=('rho',)):
        reducers, _ = self._dp_state()
        reducers[name] = build_slicer(runner.builder, self.dim, axis,
                                      position, fields)

    def compute_reduction(self, runner, name):
        reducers, _ = self._dp_state()
        with torch.no_grad():
            return st.state_to_numpy(reducers[name](runner.f,
                                                    self.iteration))

    # alias matching the slice terminology
    compute_slice = compute_reduction

    def reduction_series(self, name):
        _, hooks = self._dp_state()
        hook_id, runner = hooks[name]
        return st.state_to_numpy(runner.device_hook_state[hook_id])
