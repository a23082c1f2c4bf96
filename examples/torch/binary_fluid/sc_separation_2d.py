#!/usr/bin/env python
"""Binary Shan-Chen demixing on the PyTorch/CUDA port (twin of
examples/binary_fluid/sc_separation_2d.py: D2Q9, two BGK components with
the repulsive cross-coupling G12 = 1.2, fully periodic, fp32).

Run from the repository root:
    PYTHONPATH=. python examples/torch/binary_fluid/sc_separation_2d.py \
        --max_iters=1000
"""

import numpy as np

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.models.binary import LBBinaryFluidShanChen
from sailfish_tpu_torch.subdomain import Subdomain2D


class SeparationDomain(Subdomain2D):
    def initial_conditions(self, sim, hx, hy):
        sim.rho[:] = 1.0 + np.random.rand(*sim.rho.shape) / 1000.0
        sim.phi[:] = 1.0 + np.random.rand(*sim.phi.shape) / 1000.0

    def boundary_conditions(self, hx, hy):
        pass


class SeparationSCSim(LBBinaryFluidShanChen):
    subdomain = SeparationDomain

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': 256,
            'lat_ny': 256,
            'grid': 'D2Q9',
            'G12': 1.2,
            'visc': 1.0 / 6.0,
            'periodic_x': True,
            'periodic_y': True})


if __name__ == '__main__':
    LBSimulationController(SeparationSCSim).run()
