#!/usr/bin/env python
"""Two stationary drops in a three-component Shan-Chen system on the
PyTorch/CUDA port (twin of examples/ternary_fluid/sc_drop_2d.py).

Each drop is a different minority component with attractive
self-interaction (G11, G33 < 0), suspended in a bath of the second
component. On a CUDA device it runs on the K = 3 Shan-Chen kernels.

Run from the repository root:
    PYTHONPATH=. python examples/torch/ternary_fluid/sc_drop_2d.py \
        --max_iters=1000
or on the CPU (the torch engine):
    PYTHONPATH=. python examples/torch/ternary_fluid/sc_drop_2d.py \
        --platform=cpu --lat_nx=64 --lat_ny=64 --max_iters=20 --every=20
"""

import numpy as np

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.geo import LBGeometry2D
from sailfish_tpu_torch.models.ternary import LBTernaryFluidShanChen
from sailfish_tpu_torch.subdomain import Subdomain2D


class TwoDropDomain(Subdomain2D):
    radius = 32

    def boundary_conditions(self, hx, hy):
        pass

    def initial_conditions(self, sim, hx, hy):
        r_sq = self.radius ** 2
        drop_a = (hx - self.gx // 4) ** 2 + (hy - self.gy // 4) ** 2 <= r_sq
        drop_b = (hx - 3 * self.gx // 4) ** 2 + \
            (hy - 3 * self.gy // 4) ** 2 <= r_sq

        sim.rho[:] = 2.0
        sim.phi[:] = 0.02
        sim.theta[:] = 0.02
        sim.rho[drop_a | drop_b] = 0.02
        sim.phi[drop_a] = 0.5
        sim.theta[drop_b] = 2.0


class TernaryDropSim(LBTernaryFluidShanChen):
    subdomain = TwoDropDomain

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': 256,
            'lat_ny': 256,
            'G11': -4.8,
            'G33': -4.8,
            'visc': 1.0 / 6.0,
            'periodic_x': True,
            'periodic_y': True,
            'sc_potential': 'classic',
        })


if __name__ == '__main__':
    LBSimulationController(TernaryDropSim, LBGeometry2D).run()
