#!/usr/bin/env python
"""Capillary wave in a Shan-Chen binary mixture on the PyTorch/CUDA port
(twin of examples/binary_fluid/sc_capillary_wave_2d.py).

Multiple sinusoidal interface waves relax freely; each component's
density away from / at its interface equilibrium values was chosen so
the interface starts near mechanical equilibrium.

The tank is closed by half-way bounce-back walls (NTHalfBBWall). The
JAX package runs half-way walls in a mixture only on its XLA engine, and
the port's mixture kernels refuse them by name, so on a CUDA device pass
--engine=torch.

Run from the repository root:
    PYTHONPATH=. python examples/torch/binary_fluid/sc_capillary_wave_2d.py \
        --engine=torch --max_iters=1000
"""

import numpy as np

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.geo import LBGeometry2D
from sailfish_tpu_torch.lattice import relaxation_time
from sailfish_tpu_torch.models.binary import LBBinaryFluidShanChen
from sailfish_tpu_torch.node_type import NTHalfBBWall, _NTUnused
from sailfish_tpu_torch.subdomain import Subdomain2D

W = 512
H = 512
N_WAVES = 16
AMPLITUDE = 10
VISC = 1.0 / 18.0
# component densities at two-phase SC equilibrium (G12 = 4.5)
RHO_MAJOR = 1.00011520663
RHO_MINOR = 0.00341573787


class SCWaveDomain(Subdomain2D):
    def boundary_conditions(self, hx, hy):
        self.set_node((hy == 1) | (hy == self.gy - 2), NTHalfBBWall)
        self.set_node((hy == 0) | (hy == self.gy - 1), _NTUnused)

    def initial_conditions(self, sim, hx, hy):
        from scipy.ndimage import gaussian_filter
        surface = H / 2 + AMPLITUDE * np.sin(
            2.0 * np.pi * hx * N_WAVES / W)
        below = hy < surface
        sim.rho[:] = np.where(below, RHO_MAJOR, RHO_MINOR)
        sim.phi[:] = np.where(below, RHO_MINOR, RHO_MAJOR)
        # soften the interface to suppress the initial pressure shock
        sim.rho[:] = gaussian_filter(sim.rho, 3)
        sim.phi[:] = gaussian_filter(sim.phi, 3)


class SCCapillaryWaveSim(LBBinaryFluidShanChen):
    subdomain = SCWaveDomain

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': W,
            'lat_ny': H + 2,
            'grid': 'D2Q9',
            'visc': VISC,
            'tau_phi': relaxation_time(VISC),
            'G12': 4.5,
            'periodic_x': True,
        })


if __name__ == '__main__':
    LBSimulationController(SCCapillaryWaveSim, LBGeometry2D).run()
