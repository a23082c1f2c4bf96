#!/usr/bin/env python
"""2D lid-driven cavity on the PyTorch/CUDA port (twin of
examples/ldc_2d.py: D2Q9 BGK, fp32).

Run from the repository root:
    PYTHONPATH=. python examples/torch/ldc_2d.py --max_iters=1000
"""

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.node_type import NTFullBBWall, NTRegularizedVelocity
from sailfish_tpu_torch.subdomain import Subdomain2D


class LDCBlock(Subdomain2D):
    #: lid speed in lattice units
    max_v = 0.1

    def boundary_conditions(self, hx, hy):
        last_x = self.gx - 1
        last_y = self.gy - 1
        lid = (hy == last_y) & (hx > 0) & (hx < last_x)
        box = (hx == 0) | (hx == last_x) | (hy == 0)
        self.set_node(lid, NTRegularizedVelocity((self.max_v, 0.0)))
        self.set_node(box, NTFullBBWall)

    def initial_conditions(self, sim, hx, hy):
        sim.rho[:] = 1.0
        # start the lid row already moving to avoid a startup shock
        sim.vx[hy == self.gy - 1] = self.max_v


class LDCSim(LBFluidSim):
    subdomain = LDCBlock

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({'lat_nx': 256, 'lat_ny': 256})


if __name__ == '__main__':
    LBSimulationController(LDCSim).run()
