#!/usr/bin/env python
"""Two-species layered Poiseuille flow (Shan-Chen mixture) on the
PyTorch/CUDA port (twin of examples/binary_fluid/sc_poiseuille_2d.py).

Component 1 fills the channel core, component 2 the near-wall layers;
a body force drives both along the channel (Guo forcing with
acceleration semantics).

The channel is closed by half-way bounce-back walls (NTHalfBBWall). The
JAX package runs half-way walls in a mixture only on its XLA engine, and
the port's mixture kernels refuse them by name, so on a CUDA device pass
--engine=torch.

Run from the repository root:
    PYTHONPATH=. python examples/torch/binary_fluid/sc_poiseuille_2d.py \
        --engine=torch --max_iters=1000
"""

import numpy as np

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.geo import LBGeometry2D
from sailfish_tpu_torch.lattice import relaxation_time
from sailfish_tpu_torch.models.binary import LBBinaryFluidShanChen
from sailfish_tpu_torch.node_type import NTHalfBBWall, _NTUnused
from sailfish_tpu_torch.subdomain import Subdomain2D

H = 256
MAX_V = 0.05
VISC_OUTER = 1.0 / 6.0
VISC_CORE = VISC_OUTER / 5.0


class LayeredChannelDomain(Subdomain2D):
    def boundary_conditions(self, hx, hy):
        self.set_node((hx == 1) | (hx == self.gx - 2), NTHalfBBWall)
        self.set_node((hx == 0) | (hx == self.gx - 1), _NTUnused)

    def initial_conditions(self, sim, hx, hy):
        core = (hx > H / 4) & (hx <= 3 * H / 4)
        sim.rho[:] = np.where(core, 1.0, 1e-6)
        sim.phi[:] = np.where(core, 1e-6, 1.0)


class LayeredPoiseuilleSim(LBBinaryFluidShanChen):
    subdomain = LayeredChannelDomain

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': H + 2,
            'lat_ny': H // 4,
            'grid': 'D2Q9',
            'visc': VISC_CORE,
            'tau_phi': relaxation_time(VISC_OUTER),
            'G12': 1.2,
            'periodic_y': True,
        })

    def __init__(self, config):
        super().__init__(config)
        accel = MAX_V * 32.0 / H ** 2 / (3.0 / VISC_OUTER
                                         + 1.0 / VISC_CORE)
        self.add_body_force((0.0, accel))
        self.add_body_force((0.0, accel), grid=1)


if __name__ == '__main__':
    LBSimulationController(LayeredPoiseuilleSim, LBGeometry2D).run()
