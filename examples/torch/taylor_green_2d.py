#!/usr/bin/env python
"""2D Taylor-Green vortex decay on the PyTorch/CUDA port (twin of
examples/taylor_green_2d.py: D2Q9 BGK, fp32, fully periodic; the analytic
viscous decay is the canonical accuracy check).

Run from the repository root:
    PYTHONPATH=. python examples/torch/taylor_green_2d.py --max_iters=1000
"""

import numpy as np

from sailfish_tpu_torch.geo import LBGeometry2D
from sailfish_tpu_torch.subdomain import Subdomain2D
from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.models.single import LBFluidSim


class TaylorGreenSubdomain(Subdomain2D):
    max_v = 0.02

    def boundary_conditions(self, hx, hy):
        pass

    def initial_conditions(self, sim, hx, hy):
        kx = 2.0 * np.pi / self.gx
        ky = 2.0 * np.pi / self.gy
        sim.vx[:] = -self.max_v * np.cos(kx * hx) * np.sin(ky * hy)
        sim.vy[:] = self.max_v * np.sin(kx * hx) * np.cos(ky * hy)
        sim.rho[:] = 1.0 - (3.0 / 4.0) * self.max_v ** 2 * (
            np.cos(2 * kx * hx) + np.cos(2 * ky * hy))


class TaylorGreenSim(LBFluidSim):
    subdomain = TaylorGreenSubdomain

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': 256,
            'lat_ny': 256,
            'visc': 0.01,
            'periodic_x': True,
            'periodic_y': True})


if __name__ == '__main__':
    LBSimulationController(TaylorGreenSim, LBGeometry2D).run()
