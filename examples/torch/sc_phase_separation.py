#!/usr/bin/env python
"""Spinodal decomposition of a single-component Shan-Chen fluid on the
PyTorch/CUDA port (twin of examples/sc_phase_separation.py: D2Q9, BGK,
the classic pseudopotential, G = -5, fully periodic, fp32).

A uniform density near the critical point of the classic potential
(rho ~ 0.693 = ln 2) is seeded with 1 % uniform noise from the run's
``--seed`` and separates into liquid and vapor domains that coarsen.

Run from the repository root:
    PYTHONPATH=. python examples/torch/sc_phase_separation.py \\
        --max_iters=1000
"""

import numpy as np

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.geo import LBGeometry2D
from sailfish_tpu_torch.models.single import LBSingleFluidShanChen
from sailfish_tpu_torch.subdomain import Subdomain2D


class SeparationSubdomain(Subdomain2D):
    def boundary_conditions(self, hx, hy):
        pass

    def initial_conditions(self, sim, hx, hy):
        # ln(2) mean density + 1% uniform noise to seed the instability
        sim.rho[:] = np.random.rand(*sim.rho.shape) / 100 + 0.693


class SCSim(LBSingleFluidShanChen):
    subdomain = SeparationSubdomain

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': 256,
            'lat_ny': 256,
            'G': -5.0,
            'visc': 1.0 / 6.0,
            'periodic_x': True,
            'periodic_y': True,
            'sc_potential': 'classic',
            'every': 20,
        })


if __name__ == '__main__':
    LBSimulationController(SCSim, LBGeometry2D).run()
