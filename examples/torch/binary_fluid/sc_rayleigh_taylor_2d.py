#!/usr/bin/env python
"""Rayleigh-Taylor instability on the PyTorch/CUDA port (twin of
examples/binary_fluid/sc_rayleigh_taylor_2d.py): a heavy Shan-Chen
component atop a light one under gravity, which acts on the heavy
component only. On a CUDA device the forced Shan-Chen kernels run it.

Run from the repository root:
    PYTHONPATH=. python examples/torch/binary_fluid/sc_rayleigh_taylor_2d.py \
        --max_iters=1000
"""

import numpy as np

from sailfish_tpu_torch.geo import LBGeometry2D
from sailfish_tpu_torch.subdomain import Subdomain2D
from sailfish_tpu_torch.node_type import NTFullBBWall
from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.models.binary import LBBinaryFluidShanChen


class RayleighTaylorDomain(Subdomain2D):
    def boundary_conditions(self, hx, hy):
        self.set_node((hy == 0) | (hy == self.gy - 1), NTFullBBWall)

    def initial_conditions(self, sim, hx, hy):
        sim.rho[:] = np.random.rand(*sim.rho.shape) / 100.0
        sim.phi[:] = np.random.rand(*sim.phi.shape) / 100.0
        sim.rho[hy <= self.gy / 2] += 1.0
        sim.phi[hy <= self.gy / 2] = 1e-4
        sim.rho[hy > self.gy / 2] = 1e-4
        sim.phi[hy > self.gy / 2] += 1.0


class RayleighTaylorSCSim(LBBinaryFluidShanChen):
    subdomain = RayleighTaylorDomain

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': 640,
            'lat_ny': 400,
            'grid': 'D2Q9',
            'G12': 1.2,
            'visc': 1.0 / 6.0,
            'periodic_x': True})

    def __init__(self, config):
        super().__init__(config)
        # gravity acts on the heavy (phi) component only
        self.add_body_force((0.0, -0.15 / config.lat_ny), grid=1)


if __name__ == '__main__':
    LBSimulationController(RayleighTaylorSCSim, LBGeometry2D).run()
