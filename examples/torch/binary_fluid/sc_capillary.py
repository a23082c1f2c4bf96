#!/usr/bin/env python
"""Taylor bubble pushed through a capillary constriction (Shan-Chen) on
the PyTorch/CUDA port (twin of examples/binary_fluid/sc_capillary.py).

A periodic 2D channel carries a long gas bubble (minority component)
toward a nozzle-shaped throat formed by two trapezoidal wall wedges. A weak
body force drives both components so the flow stays in the low Reynolds /
capillary-dominated regime. On a CUDA device the forced Shan-Chen kernels
run it.

Run from the repository root:
    PYTHONPATH=. python examples/torch/binary_fluid/sc_capillary.py \
        --max_iters=1000
"""

import numpy as np

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.geo import LBGeometry2D
from sailfish_tpu_torch.lattice import relaxation_time
from sailfish_tpu_torch.models.binary import LBBinaryFluidShanChen
from sailfish_tpu_torch.node_type import NTFullBBWall
from sailfish_tpu_torch.subdomain import Subdomain2D

MAX_V = 0.005
VISC = 1.0 / 6.0
# Dissolved-phase background value used by the classic SC mixture.
RHO_MINOR = 0.124


class CapillaryThroatDomain(Subdomain2D):
    """Channel with a linear-taper constriction in the middle."""

    def _wedge_height(self, hx):
        # Throat geometry scales with the channel height so the example
        # can be shrunk for smoke tests.
        throat_gap = 32.0 * self.gy / 200.0
        throat_len = float(self.gy)
        shoulder = (self.gy - throat_gap) // 2
        # Trapezoid: full height `shoulder` over the central section,
        # falling off with unit slope on both sides.
        ramp = shoulder + throat_len / 2 - np.abs(hx - self.gx / 2)
        return np.minimum(shoulder, ramp)

    def boundary_conditions(self, hx, hy):
        wedge = self._wedge_height(hx)
        walls = (hy == 0) | (hy == self.gy - 1)
        walls |= hy < wedge
        walls |= (self.gy - hy) < wedge
        self.set_node(walls, NTFullBBWall)

    def initial_conditions(self, sim, hx, hy):
        bubble_r = 30.0 * self.gy / 200.0
        inside = ((hx - 2 * bubble_r) ** 2
                  + (hy - self.gy / 2.0) ** 2) < bubble_r ** 2
        sim.rho[:] = np.where(inside, RHO_MINOR, 1.0)
        sim.phi[:] = np.where(inside, 1.0, RHO_MINOR)


class CapillaryTaylorSim(LBBinaryFluidShanChen):
    subdomain = CapillaryThroatDomain

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': 640,
            'lat_ny': 200,
            'grid': 'D2Q9',
            'visc': VISC,
            'tau_phi': relaxation_time(VISC),
            'G12': 1.6,
            'periodic_x': True,
        })

    def __init__(self, config):
        super().__init__(config)
        # Poiseuille-style estimate of the force needed for MAX_V at
        # the channel scale.
        accel = MAX_V * 8.0 * config.visc / config.lat_ny
        self.add_body_force((accel, 0.0))
        self.add_body_force((accel, 0.0), grid=1)


if __name__ == '__main__':
    LBSimulationController(CapillaryTaylorSim, LBGeometry2D).run()
