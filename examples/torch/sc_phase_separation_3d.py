#!/usr/bin/env python
"""3D spinodal decomposition of a single-component Shan-Chen fluid on the
PyTorch/CUDA port (twin of examples/sc_phase_separation_3d.py: D3Q19,
BGK, the classic pseudopotential, G = -5, fully periodic, fp32): a
near-critical uniform density with 1 % noise separates into liquid and
vapor domains. On a card it runs on the kernel engine: the density
pre-pass, then the stream-and-collide kernel's Shan-Chen mode.

Run from the repository root:
    PYTHONPATH=. python examples/torch/sc_phase_separation_3d.py \\
        --max_iters=1000
"""

import numpy as np

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.geo import LBGeometry3D
from sailfish_tpu_torch.models.single import LBSingleFluidShanChen
from sailfish_tpu_torch.subdomain import Subdomain3D


class SeparationSubdomain3D(Subdomain3D):
    def boundary_conditions(self, hx, hy, hz):
        pass

    def initial_conditions(self, sim, hx, hy, hz):
        sim.rho[:] = np.random.rand(*sim.rho.shape) / 100 + 0.693


class SCSim3D(LBSingleFluidShanChen):
    subdomain = SeparationSubdomain3D

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': 128,
            'lat_ny': 128,
            'lat_nz': 128,
            'grid': 'D3Q19',
            'G': -5.0,
            'visc': 1.0 / 6.0,
            'periodic_x': True,
            'periodic_y': True,
            'periodic_z': True,
            'sc_potential': 'classic',
        })


if __name__ == '__main__':
    LBSimulationController(SCSim3D, LBGeometry3D).run()
