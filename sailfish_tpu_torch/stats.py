"""Flow-statistics mixins: kinetic energy / enstrophy, Reynolds moments.

The port's copy of ``sailfish_tpu/stats.py`` (counterpart of the
reference's ``sailfish/stats.py``: KineticEnergyEnstrophyMixIn :16,
ReynoldsStatsMixIn :56). The reductions are tensor expressions over the
device state; per-iteration sampling runs through a device hook
(``LBSim.add_device_hook``).

Accumulators are float32 under ``--precision=single`` (and ``mixed``) and
float64 under ``double``: the JAX package casts to float64 with x64 off in
single precision, which gives float32, so checkpointed accumulators have
the same dtype in both packages.
"""

from __future__ import annotations

import torch

from sailfish_tpu_torch import state as st
from sailfish_tpu_torch.models.base import LBMixIn, ScalarField


def accumulator_dtype(config):
    """float64 under --precision=double, else float32."""
    return torch.float64 if config.dtype == torch.float64 else torch.float32


def central_difference(field, axis_comp):
    """d field / d x_axis_comp by central differences on periodic rolls
    (``axis_comp`` 0 = x, the last array axis)."""
    ax = field.dim() - 1 - axis_comp
    return (torch.roll(field, -1, ax) - torch.roll(field, 1, ax)) * 0.5


def vorticity_squared(u):
    """|curl u|^2 of the (dim, *S) velocity by ``central_difference``: the
    squared z vorticity in 2D."""
    d = central_difference
    if u.shape[0] == 2:
        w = d(u[1], 0) - d(u[0], 1)
        return w * w
    wx = d(u[2], 1) - d(u[1], 2)
    wy = d(u[0], 2) - d(u[2], 0)
    wz = d(u[1], 0) - d(u[0], 1)
    return wx * wx + wy * wy + wz * wz


class FlowStatsMixIn(LBMixIn):
    """Easy access to flow statistics for LBFluidSim-descendant classes."""


class KineticEnergyEnstrophyMixIn(FlowStatsMixIn):
    """Global kinetic energy and enstrophy densities
    (``sailfish_tpu/stats.py:28-72``)."""

    @classmethod
    def fields(cls):
        return [ScalarField('v_sq', init=0.0), ScalarField('vort_sq',
                                                           init=0.0)]

    def before_main_loop(self, runner):
        dtype = accumulator_dtype(self.config)

        def ke_ens(f):
            _, u = runner.builder.macro_fields(f)
            vsq = torch.sum(u * u, dim=0)
            n = vsq.numel()
            ke = torch.sum(vsq, dtype=dtype) / (2.0 * n)
            ens = torch.sum(vorticity_squared(u), dtype=dtype) / (2.0 * n)
            return ke, ens

        self._ke_ens_fn = ke_ens

    def compute_ke_enstrophy(self, runner):
        """Kinetic energy and enstrophy densities (per node)."""
        with torch.no_grad():
            ke, ens = self._ke_ens_fn(runner.f)
        return float(ke), float(ens)

    # the reference's method name, typo kept
    compute_ke_enstropy = compute_ke_enstrophy


class ReynoldsStatsMixIn(FlowStatsMixIn):
    """First four moments of rho and the velocity components and their
    pair correlations, averaged over the homogeneous axes
    (``sailfish_tpu/stats.py:75-184``).

    Two accumulation modes:
      * device (when ``every`` is given): a device hook accumulates on the
        device state, so the sampling cadence does not depend on the
        host chunk size (cfg.every);
      * host: ``collect_reynolds_stats(runner)`` from after_step,
        accumulating numpy arrays.
    ``reynolds_stats()`` returns whichever accumulator has samples.
    """

    stat_axis = 'y'

    def prepare_reynolds_stats(self, runner, axis=None, every=None,
                               from_iter=0):
        dim = self.dim
        axis = axis or self.stat_axis
        # profile along `axis`: average over the other spatial axes
        keep_ax = (dim - 1) - {'x': 0, 'y': 1, 'z': 2}[axis]
        reduce_axes = tuple(a for a in range(dim) if a != keep_ax)
        dtype = accumulator_dtype(self.config)

        def stats(f):
            rho, u = runner.builder.macro_fields(f)
            fields = {'rho': rho.to(dtype)}
            for a in range(dim):
                fields['uvw'[a] if dim == 3 else 'uv'[a]] = u[a].to(dtype)
            out = {name: torch.stack([torch.mean(fld ** p, dim=reduce_axes)
                                      for p in range(1, 5)])
                   for name, fld in fields.items()}
            names = list(fields)
            for i, a in enumerate(names):
                for b in names[i + 1:]:
                    out[a + b] = torch.mean(fields[a] * fields[b],
                                            dim=reduce_axes)[None]
            return out

        self._reynolds_fn = stats
        if not getattr(self, '_reynolds_restored', False):
            self._reynolds_acc = None
            self._reynolds_samples = 0
        self._reynolds_runner = runner
        self._reynolds_hook_id = None
        if every is None:
            return
        # one evaluation gives the accumulators' shapes and dtypes
        with torch.no_grad():
            acc0 = {k: torch.zeros_like(v) for k, v in stats(runner.f).items()}
        init = (torch.zeros((), dtype=torch.int32), acc0)

        def hook(f, state, it):
            if it < from_iter or it % every:
                return state
            cnt, acc = state
            s = stats(f)
            return cnt + 1, {k: acc[k] + s[k] for k in acc}

        self._reynolds_hook_id = self.add_device_hook(
            init, hook, every=every, from_iter=from_iter)

    def checkpoint_state(self):
        return {'acc': getattr(self, '_reynolds_acc', None),
                'samples': getattr(self, '_reynolds_samples', 0)}

    def restore_checkpoint_state(self, state):
        self._reynolds_acc = state['acc']
        self._reynolds_samples = state['samples']
        self._reynolds_restored = True

    def collect_reynolds_stats(self, runner):
        """One host sample of the statistics, added to the host
        accumulator (numpy arrays); returns the sample."""
        with torch.no_grad():
            sample = st.tree_map(st.state_to_numpy,
                                 self._reynolds_fn(runner.f))
        if self._reynolds_acc is None:
            self._reynolds_acc = sample
        else:
            self._reynolds_acc = {k: self._reynolds_acc[k] + v
                                  for k, v in sample.items()}
        self._reynolds_samples += 1
        return sample

    def reynolds_stats(self):
        """Accumulated mean profiles (host samples if any, else the device
        accumulator), or None without samples."""
        if self._reynolds_samples:
            return {k: v / self._reynolds_samples
                    for k, v in self._reynolds_acc.items()}
        if self._reynolds_hook_id is not None:
            cnt, acc = self._reynolds_runner.device_hook_state[
                self._reynolds_hook_id]
            cnt = int(cnt)
            if cnt == 0:
                return None
            return {k: st.state_to_numpy(v) / cnt for k, v in acc.items()}
        return None
