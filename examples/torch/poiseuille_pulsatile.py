#!/usr/bin/env python
"""Pulsatile channel flow driven by an oscillating pressure gradient, on
the PyTorch/CUDA port (twin of examples/poiseuille_pulsatile.py: D2Q9 BGK,
fp32).

The drive is either a sinusoidal pressure difference across the channel
(DynamicValue density BCs) or a sinusoidal body force (a DynamicValue
passed to add_body_force), selected with --drive. The callables receive
t = iteration * --dt_per_lattice_time_unit as a tensor and use torch.

Run from the repository root:
    PYTHONPATH=. python examples/torch/poiseuille_pulsatile.py \
        --max_iters=1000
"""

import numpy as np

import torch

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.geo import LBGeometry2D
from sailfish_tpu_torch.models.base import LBForcedSim
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.node_type import DynamicValue, \
    NTEquilibriumDensity, NTFullBBWall
from sailfish_tpu_torch.subdomain import Subdomain2D

MAX_V = 0.02
OMEGA = 2.0 * np.pi / 2000.0   # drive period in steps


class PulsatileChannel(Subdomain2D):
    def boundary_conditions(self, hx, hy):
        wall = (hy == 0) | (hy == self.gy - 1)
        self.set_node(wall, NTFullBBWall)
        if self.config.drive != 'pressure':
            return
        width = self.gy - 2.0
        visc = self.config.visc
        # peak density offset giving max_v at the parabola apex:
        # dp/dx = 8 mu u_max / w^2, rho = 1 +- 3 dp L / 2
        amp = MAX_V * 8.0 * visc / width ** 2 * self.gx * 1.5

        inlet = DynamicValue(
            lambda t, _a=amp: 1.0 + _a * torch.sin(OMEGA * t))
        outlet = DynamicValue(
            lambda t, _a=amp: 1.0 - _a * torch.sin(OMEGA * t))
        not_wall = ~wall
        self.set_node(not_wall & (hx == 0), NTEquilibriumDensity(inlet))
        self.set_node(not_wall & (hx == self.gx - 1),
                      NTEquilibriumDensity(outlet))

    def initial_conditions(self, sim, hx, hy):
        sim.rho[:] = 1.0


class PulsatileSim(LBFluidSim, LBForcedSim):
    subdomain = PulsatileChannel

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': 128,
            'lat_ny': 48,
            'visc': 0.05,
        })

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--drive', type=str, default='pressure',
                           choices=['pressure', 'force'])

    @classmethod
    def modify_config(cls, config):
        if config.drive == 'force':
            config.periodic_x = True

    def __init__(self, config):
        super().__init__(config)
        if config.drive == 'force':
            width = config.lat_ny - 2.0
            amp = MAX_V * 8.0 * config.visc / width ** 2
            self.add_body_force(DynamicValue(
                lambda t, _a=amp: _a * torch.sin(OMEGA * t), 0.0))


if __name__ == '__main__':
    LBSimulationController(PulsatileSim, LBGeometry2D).run()
