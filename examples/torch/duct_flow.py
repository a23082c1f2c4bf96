#!/usr/bin/env python
"""Force-driven flow through a rectangular duct on the PyTorch/CUDA port
(twin of examples/duct_flow.py: D3Q19 BGK, fp32, half-way bounce-back
walls on the four x/y faces by default, --wall=fullbb for full-way, a
constant acceleration along the periodic z axis), with the analytic series
solution of F. M. White, Viscous Fluid Flow (2nd ed., Eq. 3.48).

Run from the repository root:
    PYTHONPATH=. python examples/torch/duct_flow.py --max_iters=1000
"""

import numpy as np

from sailfish_tpu_torch.geo import EqualSubdomainsGeometry3D
from sailfish_tpu_torch.subdomain import Subdomain3D
from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.models.base import LBForcedSim
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.node_type import NTFullBBWall, NTHalfBBWall


class DuctSubdomain(Subdomain3D):
    max_v = 0.02
    wall_bc = NTHalfBBWall

    def boundary_conditions(self, hx, hy, hz):
        wall_map = ((hx == 0) | (hx == self.gx - 1) |
                    (hy == 0) | (hy == self.gy - 1))
        self.set_node(wall_map, self.wall_bc)

    def initial_conditions(self, sim, hx, hy, hz):
        sim.rho[:] = 1.0
        # the profile depends on (x, y) only: one z-plane, broadcast
        sim.vz[:] = self.analytical(hx[0], hy[0])

    @classmethod
    def width(cls, config):
        return config.lat_ny - 1 - 2 * cls.wall_bc.location

    @classmethod
    def accel(cls, config):
        ii = np.arange(1, 100, 2)
        ssum = np.sum((-1.0) ** ((ii - 1) / 2.0)
                      * (1 - np.cosh(0) / np.cosh(ii * np.pi / 2))
                      * np.cos(0) / ii ** 3)
        a = cls.width(config) / 2.0
        prefactor = 16 * a ** 2 / (config.visc * np.pi ** 3)
        return cls.max_v / (prefactor * ssum)

    def analytical(self, hx, hy):
        cfg = self.config
        a = self.width(cfg) / 2.0
        hyc = hy - self.wall_bc.location
        hxc = hx - self.wall_bc.location
        ry = a - hyc
        rx = a - hxc
        prefactor = 16 * a ** 2 / (cfg.visc * np.pi ** 3) * self.accel(cfg)
        ii = np.arange(1, 100, 2)
        out = np.zeros_like(rx, dtype=np.float64)
        for i in ii:
            out += ((-1.0) ** ((i - 1) / 2.0)
                    * (1 - np.cosh(i * np.pi * rx / (2 * a))
                       / np.cosh(i * np.pi / 2))
                    * np.cos(i * np.pi * ry / (2 * a)) / i ** 3)
        return prefactor * out


class DuctSim(LBFluidSim, LBForcedSim):
    subdomain = DuctSubdomain

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': 64,
            'lat_ny': 64,
            'lat_nz': 16,
            'visc': 0.1,
            'grid': 'D3Q19',
            'periodic_z': True})

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--wall', type=str, default='halfbb',
                           choices=['fullbb', 'halfbb'])

    @classmethod
    def modify_config(cls, config):
        cls.subdomain.wall_bc = (NTHalfBBWall if config.wall == 'halfbb'
                                 else NTFullBBWall)

    def __init__(self, config):
        super().__init__(config)
        self.add_body_force((0.0, 0.0,
                             self.subdomain.accel(config)))


if __name__ == '__main__':
    LBSimulationController(DuctSim, EqualSubdomainsGeometry3D).run()
