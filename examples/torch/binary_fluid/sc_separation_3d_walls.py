#!/usr/bin/env python
"""3D Shan-Chen demixing inside a closed box of full bounce-back walls on
the PyTorch/CUDA port (twin of
examples/binary_fluid/sc_separation_3d_walls.py: D3Q19, G12 = 1.2, fp32).

Run from the repository root:
    PYTHONPATH=. python examples/torch/binary_fluid/sc_separation_3d_walls.py \
        --max_iters=1000
"""

import numpy as np

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.models.binary import LBBinaryFluidShanChen
from sailfish_tpu_torch.node_type import NTFullBBWall
from sailfish_tpu_torch.subdomain import Subdomain3D


class WalledSeparationDomain(Subdomain3D):
    def boundary_conditions(self, hx, hy, hz):
        edge = (hx == 0) | (hy == 0) | (hz == 0) | \
            (hx == self.gx - 1) | (hy == self.gy - 1) | \
            (hz == self.gz - 1)
        self.set_node(edge, NTFullBBWall)

    def initial_conditions(self, sim, hx, hy, hz):
        sim.rho[:] = 1.0 + np.random.rand(*sim.rho.shape) / 1000.0
        sim.phi[:] = 1.0 + np.random.rand(*sim.phi.shape) / 1000.0


class WalledSeparationSim(LBBinaryFluidShanChen):
    subdomain = WalledSeparationDomain

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': 192,
            'lat_ny': 192,
            'lat_nz': 192,
            'grid': 'D3Q19',
            'G12': 1.2,
            'visc': 1.0 / 6.0,
        })


if __name__ == '__main__':
    LBSimulationController(WalledSeparationSim).run()
