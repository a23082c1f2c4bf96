#!/usr/bin/env python
"""Shallow-water ("free surface") relaxation of a Gaussian hump on the
PyTorch/CUDA port (twin of examples/fs_gaussian.py: D2Q9, BGK, the
shallow-water equilibrium at g = 0.001, fully periodic, fp32).

The depth field rho plays the role of the water column height; the
initial hump radiates gravity waves at c = sqrt(g h).

Run from the repository root:
    PYTHONPATH=. python examples/torch/fs_gaussian.py --max_iters=1000
"""

import numpy as np

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.geo import LBGeometry2D
from sailfish_tpu_torch.models.single import LBFreeSurface
from sailfish_tpu_torch.subdomain import Subdomain2D


class GaussianHumpDomain(Subdomain2D):
    amplitude = 0.4

    def boundary_conditions(self, hx, hy):
        pass

    def initial_conditions(self, sim, hx, hy):
        width = min(self.gx, self.gy) / 12.0
        r_sq = (hx - self.gx / 2.0) ** 2 + (hy - self.gy / 2.0) ** 2
        sim.rho[:] = 1.0 + self.amplitude * np.exp(-r_sq / width ** 2)


class FSSim(LBFreeSurface):
    subdomain = GaussianHumpDomain

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': 62,
            'lat_ny': 62,
            'every': 10,
            'visc': 0.005,
            'periodic_x': True,
            'periodic_y': True,
        })


if __name__ == '__main__':
    LBSimulationController(FSSim, LBGeometry2D).run()
