#!/usr/bin/env python
"""3D lid-driven cavity on the PyTorch/CUDA port (twin of
examples/ldc_3d.py, the scene bench.py times: D3Q19 BGK, fp32).

Run from the repository root:
    PYTHONPATH=. python examples/torch/ldc_3d.py --max_iters=1000
"""

import numpy as np

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.node_type import NTFullBBWall, NTRegularizedVelocity
from sailfish_tpu_torch.subdomain import Subdomain3D


class LDCBlock(Subdomain3D):
    """3D lid-driven cavity geometry."""

    max_v = 0.05

    def boundary_conditions(self, hx, hy, hz):
        wall_map = ((hz == 0) | (hx == self.gx - 1) | (hx == 0) | (hy == 0) |
                    (hy == self.gy - 1))
        self.set_node(wall_map, NTFullBBWall)
        self.set_node((hz == self.gz - 1) & np.logical_not(wall_map),
                      NTRegularizedVelocity((self.max_v, 0.0, 0.0)))

    def initial_conditions(self, sim, hx, hy, hz):
        sim.rho[:] = 1.0
        sim.vx[hz == self.gz - 1] = self.max_v


class LDCSim(LBFluidSim):
    subdomain = LDCBlock

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': 64,
            'lat_ny': 64,
            'lat_nz': 64,
            'grid': 'D3Q19'})


if __name__ == '__main__':
    LBSimulationController(LDCSim).run()
