#!/usr/bin/env python
"""Flexible cylinder of IBM particles in a channel flow on the
PyTorch/CUDA port (twin of examples/ibm_cylinder.py): a ring of
spring-tethered Lagrangian markers deforms under a body-force-driven
flow between two walls.

The immersed-boundary step (spread the spring forces, the forced fluid
step, move the markers) is plain tensor code, as in the JAX package, which
runs it on XLA: the kernel engine refuses it by name, so on a CUDA device
pass --engine=torch. Sharding (--mesh) is refused by name too.

Run from the repository root:
    PYTHONPATH=. python examples/torch/ibm_cylinder.py --engine=torch \
        --max_iters=1000
A marker spacing near one node, as the method needs, at a full width:
    PYTHONPATH=. python examples/torch/ibm_cylinder.py --engine=torch \
        --lat_nx=4096 --lat_ny=2048 --radius=256 --n_markers=1600 \
        --max_iters=500
"""

import numpy as np

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.geo import LBGeometry2D
from sailfish_tpu_torch.models.single import LBIBMFluidSim, Particle
from sailfish_tpu_torch.node_type import NTFullBBWall
from sailfish_tpu_torch.subdomain import Subdomain2D


class ChannelSubdomain(Subdomain2D):
    def boundary_conditions(self, hx, hy):
        self.set_node((hy == 0) | (hy == self.gy - 1), NTFullBBWall)

    def initial_conditions(self, sim, hx, hy):
        sim.rho[:] = 1.0


class IBMSim(LBIBMFluidSim):
    subdomain = ChannelSubdomain

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': 128,
            'lat_ny': 64,
            'visc': 0.05,
            'periodic_x': True})

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--n_markers', type=int, default=36)
        group.add_argument('--radius', type=float, default=8.0)
        group.add_argument('--stiffness', type=float, default=0.03)

    def __init__(self, config):
        super().__init__(config)
        self.add_body_force((1e-5, 0.0))
        x0 = config.lat_nx / 4.0
        y0 = config.lat_ny / 2.0
        for k in range(config.n_markers):
            phi = 2.0 * np.pi * k / config.n_markers
            pos = (x0 + config.radius * np.cos(phi),
                   y0 + config.radius * np.sin(phi))
            self.add_particle(Particle(pos, stiffness=config.stiffness))


if __name__ == '__main__':
    LBSimulationController(IBMSim, LBGeometry2D).run()
