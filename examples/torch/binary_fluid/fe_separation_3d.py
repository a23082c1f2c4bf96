#!/usr/bin/env python
"""3D spinodal decomposition of a free-energy binary mixture on the
PyTorch/CUDA port (twin of examples/binary_fluid/fe_separation_3d.py:
D3Q19, phi = U(0, 1e-4) noise coarsening into domains, fully periodic,
fp32; ``--model=mrt`` relaxes the fluid grid by FE-MRT).

Run from the repository root:
    PYTHONPATH=. python examples/torch/binary_fluid/fe_separation_3d.py \
        --max_iters=1000
"""

import numpy as np

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.models.binary import LBBinaryFluidFreeEnergy
from sailfish_tpu_torch.subdomain import Subdomain3D


class SeparationDomain3D(Subdomain3D):
    def boundary_conditions(self, hx, hy, hz):
        pass

    def initial_conditions(self, sim, hx, hy, hz):
        sim.rho[:] = 1.0
        sim.phi[:] = np.random.rand(*sim.phi.shape) * 1e-4


class SeparationFESim3D(LBBinaryFluidFreeEnergy):
    subdomain = SeparationDomain3D

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': 64,
            'lat_ny': 64,
            'lat_nz': 64,
            'grid': 'D3Q19',
            'kappa': 2e-4,
            'A': 2e-4,
            'Gamma': 25.0,
            'tau_a': 4.5,
            'tau_b': 0.8,
            'tau_phi': 1.0,
            'periodic_x': True,
            'periodic_y': True,
            'periodic_z': True,
        })


if __name__ == '__main__':
    LBSimulationController(SeparationFESim3D).run()
