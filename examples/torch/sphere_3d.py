#!/usr/bin/env python
"""Body-force-driven duct flow past a sphere on the PyTorch/CUDA port
(twin of examples/sphere_3d.py: D3Q19 BGK, fp32, bounce-back duct walls on
the y/z faces, periodic along x, a sphere of one third the duct height two
diameters from the inlet, a constant acceleration along x;
--force_implementation picks guo, edm or velocity_shift).

Run from the repository root:
    PYTHONPATH=. python examples/torch/sphere_3d.py --max_iters=1000
"""

import numpy as np

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.geo import EqualSubdomainsGeometry3D
from sailfish_tpu_torch.models.base import LBForcedSim
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.node_type import NTFullBBWall
from sailfish_tpu_torch.subdomain import Subdomain3D


class SphereBlock(Subdomain3D):
    def sphere_geometry(self):
        """(diameter, center) -- diameter = gy/3, two diameters in."""
        diam = self.gy / 3.0
        center = (2.0 * diam, self.gy / 2.0, self.gz / 2.0)
        return diam, center

    def boundary_conditions(self, hx, hy, hz):
        duct = ((hy == 0) | (hy == self.gy - 1) |
                (hz == 0) | (hz == self.gz - 1))
        self.set_node(duct, NTFullBBWall)

        diam, (x0, y0, z0) = self.sphere_geometry()
        r_sq = (np.square(hx - x0) + np.square(hy - y0)
                + np.square(hz - z0))
        inside = r_sq <= np.square(diam / 2.0)
        self.set_node(inside & ~duct, NTFullBBWall)

    def initial_conditions(self, sim, hx, hy, hz):
        sim.rho[:] = 1.0


class SphereSimulation(LBFluidSim, LBForcedSim):
    subdomain = SphereBlock

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': 128,
            'lat_ny': 64,
            'lat_nz': 64,
            'visc': 0.01,
            'grid': 'D3Q19',
        })

    @classmethod
    def modify_config(cls, config):
        config.periodic_x = True

    def __init__(self, config):
        super().__init__(config)
        self.add_body_force((1e-5, 0.0, 0.0))


if __name__ == '__main__':
    LBSimulationController(SphereSimulation,
                           EqualSubdomainsGeometry3D).run()
