#!/usr/bin/env python
"""Two-layer Poiseuille flow of a free-energy binary mixture with a
viscosity contrast on the PyTorch/CUDA port (twin of
examples/binary_fluid/fe_poiseuille_2d.py: D2Q9, full bounce-back walls
at y = 0 and y = ny - 1, a uniform Guo body force along x, fp32;
``--bc_wall_grad_phase`` sets the wetting gradient at the walls).

Run from the repository root:
    PYTHONPATH=. python examples/torch/binary_fluid/fe_poiseuille_2d.py \
        --max_iters=1000
"""

import numpy as np

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.models.base import LBForcedSim
from sailfish_tpu_torch.models.binary import LBBinaryFluidFreeEnergy
from sailfish_tpu_torch.node_type import NTFullBBWall
from sailfish_tpu_torch.subdomain import Subdomain2D


class PoiseuilleDomain(Subdomain2D):
    def boundary_conditions(self, hx, hy):
        self.set_node((hy == 0) | (hy == self.gy - 1), NTFullBBWall)

    def initial_conditions(self, sim, hx, hy):
        sim.rho[:] = 1.0
        sim.phi[:] = np.where(hy < self.gy / 2, 1.0, -1.0)


class FEPoiseuilleSim(LBBinaryFluidFreeEnergy, LBForcedSim):
    subdomain = PoiseuilleDomain

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': 128,
            'lat_ny': 64,
            'grid': 'D2Q9',
            'kappa': 0.04,
            'A': 0.04,
            'Gamma': 1.0,
            'tau_a': 2.5,
            'tau_b': 0.7,
            'tau_phi': 1.0,
            'periodic_x': True})

    def __init__(self, config):
        super().__init__(config)
        self.add_body_force((1e-6, 0.0))


if __name__ == '__main__':
    LBSimulationController(FEPoiseuilleSim).run()
