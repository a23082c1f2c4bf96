#!/usr/bin/env python
"""Body-force-driven flow past a circular cylinder between two plates on
the PyTorch/CUDA port (twin of examples/cylinder.py: D2Q9 BGK, fp32, a
constant acceleration along the periodic flow axis; --vertical flips the
flow direction, --force_implementation picks guo, edm or velocity_shift).

Run from the repository root:
    PYTHONPATH=. python examples/torch/cylinder.py --max_iters=1000
"""

import numpy as np

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.geo import EqualSubdomainsGeometry2D
from sailfish_tpu_torch.models.base import LBForcedSim
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.node_type import NTFullBBWall
from sailfish_tpu_torch.subdomain import Subdomain2D


class CylinderBlock(Subdomain2D):
    def _layout(self):
        """(channel span, cylinder center) for the chosen orientation:
        the cylinder diameter is span/3, centered across the channel,
        two diameters downstream."""
        if self.config.vertical:
            diam = self.gx / 3
            return diam, (self.gx / 2, 2 * diam)
        diam = self.gy / 3
        return diam, (2 * diam, self.gy / 2)

    def boundary_conditions(self, hx, hy):
        diam, (x0, y0) = self._layout()
        if self.config.vertical:
            sides = (hx == 0) | (hx == self.gx - 1)
        else:
            sides = (hy == 0) | (hy == self.gy - 1)
        self.set_node(sides, NTFullBBWall)
        r_sq = np.square(hx - x0) + np.square(hy - y0)
        self.update_node(r_sq < diam ** 2 / 4.0, NTFullBBWall)

    def initial_conditions(self, sim, hx, hy):
        sim.rho[:] = 1.0


class CylinderSimulation(LBFluidSim, LBForcedSim):
    subdomain = CylinderBlock

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({'lat_nx': 256, 'lat_ny': 128, 'visc': 0.1})

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--vertical', action='store_true',
                           default=False, help='flow along the Y axis')

    @classmethod
    def modify_config(cls, config):
        if config.vertical:
            config.periodic_y = True
        else:
            config.periodic_x = True

    def __init__(self, config):
        super().__init__(config)
        accel = 1e-5
        self.add_body_force((0.0, accel) if config.vertical
                            else (accel, 0.0))


if __name__ == '__main__':
    LBSimulationController(CylinderSimulation,
                           EqualSubdomainsGeometry2D).run()
