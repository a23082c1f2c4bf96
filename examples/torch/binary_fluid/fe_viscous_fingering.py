#!/usr/bin/env python
"""Viscous fingering (Saffman-Taylor instability) in a 3D channel on the
PyTorch/CUDA port (twin of examples/binary_fluid/fe_viscous_fingering.py:
D3Q19, full bounce-back plates at z = 0 and z = nz - 1, a uniform body
force along x, FE-MRT on the fluid grid, the density grid relaxing with
the bare fluid velocity and the order parameter with the force-shifted
one, fp32).

Run from the repository root:
    PYTHONPATH=. python examples/torch/binary_fluid/fe_viscous_fingering.py \
        --max_iters=1000
"""

import numpy as np

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.models.base import LBForcedSim
from sailfish_tpu_torch.models.binary import LBBinaryFluidFreeEnergy
from sailfish_tpu_torch.node_type import NTFullBBWall
from sailfish_tpu_torch.subdomain import Subdomain3D


class FingeringDomain(Subdomain3D):
    def boundary_conditions(self, hx, hy, hz):
        self.set_node((hz == 0) | (hz == self.gz - 1), NTFullBBWall)

    def initial_conditions(self, sim, hx, hy, hz):
        mod = 8.0 * np.cos(2.0 * np.pi * hy / self.gy)
        sim.rho[:] = 1.0
        sim.phi[:] = np.where(
            (hx <= 50.0 - mod) | (hx >= 100.0 - mod), -1.0, 1.0)


class FingeringFESim(LBBinaryFluidFreeEnergy, LBForcedSim):
    subdomain = FingeringDomain

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': 320,
            'lat_ny': 101,
            'lat_nz': 37,
            'grid': 'D3Q19',
            'tau_a': 4.5,
            'tau_b': 0.6,
            'tau_phi': 1.0,
            'kappa': 9.18e-5,
            'Gamma': 25.0,
            'A': 1.41e-4,
            'model': 'mrt',
            'periodic_x': True,
            'periodic_y': True,
            'periodic_z': True,
        })

    def __init__(self, config):
        super().__init__(config)
        self.add_body_force((3.0e-5, 0.0, 0.0), grid=0, accel=False)
        self.use_force_for_equilibrium(None, target_grid=0)
        self.use_force_for_equilibrium(0, target_grid=1)


if __name__ == '__main__':
    LBSimulationController(FingeringFESim).run()
