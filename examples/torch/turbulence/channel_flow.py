#!/usr/bin/env python
"""Turbulent channel flow between two parallel plates on the PyTorch/CUDA
port (twin of examples/turbulence/channel_flow.py: D3Q19 BGK, fp32, Guo
forcing).

Body-force-driven channel at a prescribed friction Reynolds number
Re_tau, with selectable wall treatment (full-way / half-way bounce-back
or the Tamm-Mott-Smith turbulent wall). The initial state is a log-law
mean profile seeded with a divergence-free random perturbation; Reynolds
statistics are accumulated on the device every ``--stats_every``
iterations by a device hook, whatever the output cadence.

Geometry: wall-normal = y, streamwise = x (periodic, 6H), spanwise = z
(periodic). On a CUDA device the scene runs on the stream-and-collide
kernel's forcing mode (its wall rows for --wall=bbl / tms).

Run from the repository root:
    PYTHONPATH=. python examples/torch/turbulence/channel_flow.py \
        --max_iters=1000
"""

import math
import os

import numpy as np

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.geo import LBGeometry3D
from sailfish_tpu_torch.models.base import LBForcedSim
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.node_type import (NTFullBBWall, NTHalfBBWall,
                                          NTWallTMS)
from sailfish_tpu_torch.stats import ReynoldsStatsMixIn
from sailfish_tpu_torch.subdomain import Subdomain3D

VON_KARMAN = 0.41
LOGLAW_B = 5.5
# y+ where the linear sublaw meets the log law (continuity point)
YPLUS_MATCH = 11.44532166

WALL_TYPES = {
    'hbb': NTFullBBWall,
    'bbl': NTHalfBBWall,
    'tms': NTWallTMS,
}


def friction_velocity(u_center, re_tau):
    """u_tau from the prescribed centerline velocity via the log law
    evaluated at the channel center (y+ = Re_tau)."""
    return u_center / (math.log(re_tau) / VON_KARMAN + LOGLAW_B)


def loglaw_profile(y_plus):
    """Mean streamwise velocity in wall units."""
    u_plus = np.log(np.maximum(y_plus, 1e-10)) / VON_KARMAN + LOGLAW_B
    return np.where(y_plus < YPLUS_MATCH, y_plus, u_plus)


def divergence_free_noise(shape, smooth, seed):
    """Curl of a smoothed random vector potential: solenoidal by
    construction. ``shape`` is (z, y, x); smoothing wraps periodically."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(seed)
    pot = [gaussian_filter(
        rng.standard_normal(shape).astype(np.float32), smooth,
        mode='wrap') for _ in range(3)]

    def periodic_gradient(a):
        # roll-based central differences: periodic on every axis, so the
        # curl cancellation (solenoidality) holds on the wrap planes too
        # (np.gradient's one-sided edge stencils would break it there)
        return [(np.roll(a, -1, axis=ax) - np.roll(a, 1, axis=ax)) / 2.0
                for ax in range(a.ndim)]

    # gradients in array order (z, y, x)
    dA = [periodic_gradient(a) for a in pot]
    # curl components: indices are array axes (0=z, 1=y, 2=x)
    wx = dA[1][0] - dA[0][1]   # dAy/dz - dAz/dy
    wy = dA[0][2] - dA[2][0]   # dAz/dx - dAx/dz
    wz = dA[2][1] - dA[1][2]   # dAx/dy - dAy/dx
    return wx, wy, wz


class ChannelSubdomain(Subdomain3D):
    u_center = 0.05

    def boundary_conditions(self, hx, hy, hz):
        self.set_node((hy == 0) | (hy == self.gy - 1),
                      self.config._wall_cls)

    def initial_conditions(self, sim, hx, hy, hz):
        cfg = self.config
        H = cfg.H
        u_tau = friction_velocity(self.u_center, cfg.Re_tau)
        # distance from the nearest wall surface, in lattice units
        wall_off = -cfg._wall_cls.location
        y_wall = np.minimum(hy - wall_off, (self.gy - 1 - hy) - wall_off)
        y_wall = np.maximum(y_wall + 1.0, 1e-3)
        u_mean = loglaw_profile(y_wall * u_tau / cfg.visc) * u_tau

        sim.rho[:] = 1.0
        sim.vx[:] = u_mean

        amp = 0.03 * u_mean / self.u_center
        if cfg.perturbation_file:
            with np.load(cfg.perturbation_file) as noise:
                wx, wy, wz = noise['wx'], noise['wy'], noise['wz']
            if wx.shape != hx.shape:
                raise ValueError(
                    'perturbation shape %s != domain shape %s'
                    % (wx.shape, hx.shape))
        else:
            wx, wy, wz = divergence_free_noise(
                hx.shape, smooth=max(2.0, H / 8.0),
                seed=cfg.seed or 1234)
        norm = max(np.abs(wx).max(), np.abs(wy).max(), np.abs(wz).max())
        sim.vx[:] += wx / norm * amp
        sim.vy[:] += wy / norm * amp
        sim.vz[:] += wz / norm * amp
        # (the noise is solenoidal under any axis naming; which curl
        # component lands on which velocity does not matter)


class ChannelSim(LBFluidSim, LBForcedSim, ReynoldsStatsMixIn):
    subdomain = ChannelSubdomain

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--H', type=int, default=40,
                           help='channel half-height in lattice units')
        group.add_argument('--Re_tau', type=float, default=180.0,
                           help='friction Reynolds number')
        group.add_argument('--wall', choices=sorted(WALL_TYPES),
                           default='hbb', help='wall treatment')
        group.add_argument('--stats_every', type=int, default=20,
                           help='Reynolds-stats sampling stride')
        group.add_argument('--perturbation_file', type=str, default='',
                           help='npz with precomputed wx/wy/wz noise '
                                '(examples/turbulence/utils/'
                                'channel_make_rand_field.py)')
        group.add_argument('--streamwise', type=int, default=0,
                           help='streamwise length override (default '
                                '6*H)')

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'grid': 'D3Q19',
            'seed': 1234,
            'periodic_x': True,
            'periodic_z': True,
            'max_iters': 500000,
            'every': 50000,
            'perf_stats_every': 5000,
        })

    @classmethod
    def modify_config(cls, config):
        config._wall_cls = WALL_TYPES[config.wall]
        # dry full-way walls need one extra node on each side to keep the
        # channel height at 2H
        pad = 2 if config._wall_cls.location == 0.5 else 0
        config.lat_ny = 2 * config.H + pad     # wall-normal
        config.lat_nx = config.streamwise or 6 * config.H  # streamwise
        config.lat_nz = 2 * config.H           # spanwise
        u_tau = friction_velocity(ChannelSubdomain.u_center,
                                  config.Re_tau)
        config.visc = u_tau * config.H / config.Re_tau

    def __init__(self, config):
        super().__init__(config)
        u_tau = friction_velocity(ChannelSubdomain.u_center,
                                  config.Re_tau)
        # mean-momentum balance: a = u_tau^2 / H
        self.accel = u_tau * u_tau / config.H
        self.add_body_force((self.accel, 0.0, 0.0))

    def transient_iters(self):
        """Two flow-through times at u_tau-scaled velocity."""
        cfg = self.config
        u_tau = friction_velocity(ChannelSubdomain.u_center, cfg.Re_tau)
        return int(2 * cfg.lat_nx * cfg.H / (u_tau * cfg.H))

    def before_main_loop(self, runner):
        self.prepare_reynolds_stats(
            runner, axis='y', every=self.config.stats_every,
            from_iter=min(self.transient_iters(),
                          self.config.max_iters // 2))

    def after_step(self, runner):
        if not self.need_output():
            return
        stats = self.reynolds_stats()
        if stats is None or not self.config.output:
            return
        out_dir = os.path.dirname(self.config.output) or '.'
        base = os.path.basename(self.config.output)
        fname = os.path.join(out_dir,
                             f'{base}_reyn_stats.{self.iteration}.npz')
        np.savez(fname, **stats)


if __name__ == '__main__':
    LBSimulationController(ChannelSim, LBGeometry3D).run()
