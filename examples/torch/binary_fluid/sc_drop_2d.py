#!/usr/bin/env python
"""Stationary drop in a binary Shan-Chen fluid with attractive
self-interaction (G11 < 0, classic potential) on the PyTorch/CUDA port
(twin of examples/binary_fluid/sc_drop_2d.py: D2Q9, fully periodic, fp32).

Run from the repository root:
    PYTHONPATH=. python examples/torch/binary_fluid/sc_drop_2d.py \
        --max_iters=1000
"""

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.geo import LBGeometry2D
from sailfish_tpu_torch.models.binary import LBBinaryFluidShanChen
from sailfish_tpu_torch.subdomain import Subdomain2D


class SingleDropDomain(Subdomain2D):
    radius = 64

    def boundary_conditions(self, hx, hy):
        pass

    def initial_conditions(self, sim, hx, hy):
        inside = (self.gx / 2 - hx) ** 2 + (self.gy / 2 - hy) ** 2 \
            <= self.radius ** 2
        sim.rho[:] = 2.0
        sim.phi[:] = 0.02
        sim.rho[inside] = 0.02
        sim.phi[inside] = 0.2


class SCDropSim(LBBinaryFluidShanChen):
    subdomain = SingleDropDomain

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': 256,
            'lat_ny': 256,
            'G11': -4.8,
            'visc': 1.0 / 6.0,
            'periodic_x': True,
            'periodic_y': True,
            'sc_potential': 'classic',
            'every': 20,
        })


if __name__ == '__main__':
    LBSimulationController(SCDropSim, LBGeometry2D).run()
