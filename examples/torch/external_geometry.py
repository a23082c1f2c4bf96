#!/usr/bin/env python
"""Flow through a voxelized geometry loaded from a .npy file on the
PyTorch/CUDA port (twin of examples/external_geometry.py: D3Q19 BGK, fp32,
a body force along x with periodic wrap).

The geometry file is a Boolean array (True = solid). With no file given, a
sinusoidally constricted pipe is generated on the fly and kept as
``pipe.npy`` beside this script.

Run from the repository root:
    PYTHONPATH=. python examples/torch/external_geometry.py --max_iters=1000
"""

import os

import numpy as np

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.models.base import LBForcedSim
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.node_type import NTFullBBWall
from sailfish_tpu_torch.subdomain import Subdomain3D


def generate_pipe(path, length=128, radius=20):
    """Write a wavy-pipe wall map: radius modulated +-20% along x."""
    shape = (2 * radius + 1, 2 * radius + 1, length)
    hz, hy, hx = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]]
    r_local = (radius - 0.7) * (0.8 + 0.2 * np.sin(
        2 * np.pi * hx / float(length)))
    solid = (hz - radius) ** 2 + (hy - radius) ** 2 > r_local ** 2
    # written under another name first: a concurrent reader never sees half
    # a file
    tmp = f'{path}.{os.getpid()}.tmp.npy'
    np.save(tmp, solid)
    os.replace(tmp, path)
    return path


class VoxelSubdomain(Subdomain3D):
    def boundary_conditions(self, hx, hy, hz):
        wall_map = getattr(self.config, '_wall_map', None)
        if wall_map is None:
            return
        local = self.select_subdomain(wall_map, hx, hy, hz)
        self.set_node(local, NTFullBBWall)

    def initial_conditions(self, sim, hx, hy, hz):
        sim.rho[:] = 1.0


class ExternalSimulation(LBFluidSim, LBForcedSim):
    subdomain = VoxelSubdomain

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--geometry', type=str, default='pipe.npy',
                           help='Boolean .npy file defining solid nodes')

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'visc': 0.01,
            'grid': 'D3Q19',
            'periodic_x': True,
        })

    @classmethod
    def modify_config(cls, config):
        if not config.geometry:
            return
        path = config.geometry
        if path == 'pipe.npy':
            # default demo geometry lives next to this script
            path = os.path.join(
                os.path.dirname(os.path.realpath(__file__)), path)
            if not os.path.exists(path):
                generate_pipe(path)
        solid = np.load(path)
        config._wall_map = solid
        config.lat_nz, config.lat_ny, config.lat_nx = solid.shape

    def __init__(self, config):
        super().__init__(config)
        self.add_body_force((1e-5, 0.0, 0.0))


if __name__ == '__main__':
    LBSimulationController(ExternalSimulation).run()
