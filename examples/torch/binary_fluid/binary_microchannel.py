#!/usr/bin/env python
"""Long bubble translating in a microchannel (free-energy binary model) on
the PyTorch/CUDA port (twin of examples/binary_fluid/binary_microchannel.py:
D2Q9, a 15 H x H channel between two layers of full bounce-back walls on
each side, a gas slug driven by a uniform body force at capillary number
``--Ca``, the order parameter advecting with the force-shifted velocity,
fp32).

Run from the repository root:
    PYTHONPATH=. python examples/torch/binary_fluid/binary_microchannel.py \
        --max_iters=1000
"""

import math

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.models.base import LBForcedSim
from sailfish_tpu_torch.models.binary import LBBinaryFluidFreeEnergy
from sailfish_tpu_torch.node_type import NTFullBBWall
from sailfish_tpu_torch.subdomain import Subdomain2D


class MicrochannelDomain(Subdomain2D):
    wall_layers = 2

    def boundary_conditions(self, hx, hy):
        walls = (hy < self.wall_layers) | \
            (hy >= self.gy - self.wall_layers)
        self.set_node(walls, NTFullBBWall)

    def initial_conditions(self, sim, hx, hy):
        film = self.config.film_thickness + self.wall_layers
        sim.rho[:] = 1.0
        sim.phi[:] = 1.0
        slug = ((hx >= self.gx / 3) & (hx < 2 * self.gx / 3) &
                (hy >= film) & (hy < self.gy - film))
        sim.phi[slug] = -1.0


class MicrochannelSim(LBBinaryFluidFreeEnergy, LBForcedSim):
    subdomain = MicrochannelDomain

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--H', type=int, default=51,
                           help='channel height in nodes')
        group.add_argument('--Ca', type=float, default=1.0,
                           help='target capillary number')
        group.add_argument('--film_thickness', type=int, default=6,
                           help='initial liquid film thickness in nodes')

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'tau_a': 2.5,
            'tau_b': 0.7,
            'tau_phi': 1.0,
            'kappa': 0.04,
            'A': 0.04,
            'Gamma': 1.0,
            'periodic_x': True,
        })

    @classmethod
    def modify_config(cls, config):
        # 15 H x H channel; extra rows for the full-way wall layers
        config.lat_nx = 15 * config.H
        config.lat_ny = config.H + 2 + MicrochannelDomain.wall_layers

    def __init__(self, config):
        super().__init__(config)
        sigma = math.sqrt(8.0 * config.kappa * config.A / 9.0)
        visc_liq = (config.tau_a - 0.5) / 3.0
        u_bubble = config.Ca * sigma / config.tau_a
        force = u_bubble * 8.0 * visc_liq / config.H ** 2
        if not config.quiet:
            re = config.H * u_bubble / visc_liq
            print(f'Ca={config.Ca:.2f} Re={re:.2f} '
                  f'u_bubble={u_bubble:.4e} force={force:.4e}')
        self.add_body_force((force, 0.0), grid=0)
        self.use_force_for_equilibrium(0, target_grid=1)


if __name__ == '__main__':
    LBSimulationController(MicrochannelSim).run()
