#!/usr/bin/env python
"""Flow past a square cylinder in a force-driven periodic channel on the
PyTorch/CUDA port (twin of examples/square_cylinder_2d.py: D2Q9 BGK,
fp32).

Run from the repository root:
    PYTHONPATH=. python examples/torch/square_cylinder_2d.py --max_iters=1000
"""

import numpy as np

from sailfish_tpu_torch.geo import EqualSubdomainsGeometry2D
from sailfish_tpu_torch.subdomain import Subdomain2D
from sailfish_tpu_torch.node_type import NTFullBBWall
from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.models.base import LBForcedSim


class SquareCylinderBlock(Subdomain2D):
    def boundary_conditions(self, hx, hy):
        self.set_node((hy == 0) | (hy == self.gy - 1), NTFullBBWall)
        d = self.gy // 6
        x0 = self.gx // 4
        y0 = self.gy // 2
        square = ((np.abs(hx - x0) <= d // 2) &
                  (np.abs(hy - y0) <= d // 2))
        self.update_node(square, NTFullBBWall)

    def initial_conditions(self, sim, hx, hy):
        sim.rho[:] = 1.0


class SquareCylinderSim(LBFluidSim, LBForcedSim):
    subdomain = SquareCylinderBlock

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': 512,
            'lat_ny': 128,
            'visc': 0.01,
            'periodic_x': True})

    def __init__(self, config):
        super().__init__(config)
        self.add_body_force((1e-6, 0.0))


if __name__ == '__main__':
    LBSimulationController(SquareCylinderSim, EqualSubdomainsGeometry2D).run()
