#!/usr/bin/env python
"""Binary free-energy spinodal decomposition on the PyTorch/CUDA port
(twin of examples/binary_fluid/fe_separation_2d.py: D2Q9, Landau
free-energy mixture with a viscosity contrast tau_a = 4.5 / tau_b = 0.8,
fully periodic, fp32).

Run from the repository root:
    PYTHONPATH=. python examples/torch/binary_fluid/fe_separation_2d.py \
        --max_iters=1000
"""

import numpy as np

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.models.binary import LBBinaryFluidFreeEnergy
from sailfish_tpu_torch.subdomain import Subdomain2D


class SeparationDomain(Subdomain2D):
    def initial_conditions(self, sim, hx, hy):
        sim.rho[:] = 1.0
        sim.phi[:] = np.random.rand(*sim.phi.shape) / 100.0 - 0.005

    def boundary_conditions(self, hx, hy):
        pass


class SeparationFESim(LBBinaryFluidFreeEnergy):
    subdomain = SeparationDomain

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': 256,
            'lat_ny': 256,
            'grid': 'D2Q9',
            'kappa': 2e-4,
            'Gamma': 25.0,
            'A': 1e-4,
            'tau_a': 4.5,
            'tau_b': 0.8,
            'tau_phi': 1.0,
            'periodic_x': True,
            'periodic_y': True})


if __name__ == '__main__':
    LBSimulationController(SeparationFESim).run()
