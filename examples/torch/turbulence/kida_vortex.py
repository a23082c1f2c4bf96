#!/usr/bin/env python
"""Freely decaying Kida vortex turbulence in a periodic box on the
PyTorch/CUDA port (twin of examples/turbulence/kida_vortex.py: D3Q15 BGK,
fp32).

Kida & Murakami, Phys. Fluids 30, 2030 (1987): a high-symmetry initial
condition that transitions to turbulence and exhibits Kolmogorov-like
decay. Kinetic energy and enstrophy are sampled on the device every
``--stats_every`` iterations by a device hook and written alongside the
output.

Run from the repository root:
    PYTHONPATH=. python examples/torch/turbulence/kida_vortex.py \
        --max_iters=1000
"""

import numpy as np
import torch

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.geo import LBGeometry3D
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.stats import (KineticEnergyEnstrophyMixIn,
                                      central_difference)
from sailfish_tpu_torch.subdomain import Subdomain3D


class KidaSubdomain(Subdomain3D):
    max_v = 0.05

    def boundary_conditions(self, hx, hy, hz):
        pass

    def initial_conditions(self, sim, hx, hy, hz):
        cfg = self.config
        x = (hx + cfg.shift_x) * (2.0 * np.pi / self.gx)
        y = (hy + cfg.shift_y) * (2.0 * np.pi / self.gy)
        z = (hz + cfg.shift_z) * (2.0 * np.pi / self.gz)
        s, c = np.sin, np.cos
        sim.rho[:] = 1.0
        sim.vx[:] = self.max_v * s(x) * (c(3 * y) * c(z) - c(y) * c(3 * z))
        sim.vy[:] = self.max_v * s(y) * (c(3 * z) * c(x) - c(z) * c(3 * x))
        sim.vz[:] = self.max_v * s(z) * (c(3 * x) * c(y) - c(x) * c(3 * y))


class KidaSim(LBFluidSim, KineticEnergyEnstrophyMixIn):
    subdomain = KidaSubdomain

    @classmethod
    def add_options(cls, group, dim):
        # phase shifts let regression runs verify translation invariance
        group.add_argument('--shift_x', type=int, default=0)
        group.add_argument('--shift_y', type=int, default=0)
        group.add_argument('--shift_z', type=int, default=0)
        group.add_argument('--stats_every', type=int, default=20,
                           help='KE/enstrophy sampling stride')

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'periodic_x': True,
            'periodic_y': True,
            'periodic_z': True,
            'lat_nx': 110,
            'lat_ny': 110,
            'lat_nz': 110,
            'grid': 'D3Q15',
            'visc': 0.001375,
            'perf_stats_every': 200,
        })

    @classmethod
    def modify_config(cls, config):
        if not config.quiet:
            re = config.lat_nx * cls.subdomain.max_v / config.visc
            print(f'Re = {re:g}')

    def before_main_loop(self, runner):
        # KE/enstrophy time series on the device: one slot per stride
        cfg = self.config
        every = cfg.stats_every
        nslots = cfg.max_iters // every + 1

        def ke_ens(f):
            _, u = runner.builder.macro_fields(f)
            vsq = torch.sum(u * u, dim=0)
            d = central_difference
            wx = d(u[2], 1) - d(u[1], 2)
            wy = d(u[0], 2) - d(u[2], 0)
            wz = d(u[1], 0) - d(u[0], 1)
            n = vsq.numel()
            ke = torch.sum(vsq) / (2.0 * n)
            ens = torch.sum(wx * wx + wy * wy + wz * wz) / (2.0 * n)
            return ke, ens

        init = torch.zeros((nslots, 3), dtype=torch.float32)

        def hook(f, series, it):
            if it % every:
                return series
            ke, ens = ke_ens(f)
            if it // every < nslots:   # a sample past the last slot drops
                series[it // every, 0] = float(it)
                series[it // every, 1] = ke
                series[it // every, 2] = ens
            return series

        self._series_hook = self.add_device_hook(init, hook, every=every)
        self._kida_runner = runner

    def ke_enstrophy_series(self):
        series = self._kida_runner.device_hook_state[
            self._series_hook].cpu().numpy()
        return series[series[:, 0] > 0]

    def after_step(self, runner):
        if self.iteration >= self.config.max_iters and self.config.output:
            np.savetxt(f'{self.config.output}_ke_ens.dat',
                       self.ke_enstrophy_series())


if __name__ == '__main__':
    LBSimulationController(KidaSim, LBGeometry3D).run()
