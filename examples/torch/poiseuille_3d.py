#!/usr/bin/env python
"""3D Poiseuille flow in a circular pipe on the PyTorch/CUDA port (twin of
examples/poiseuille_3d.py: D3Q19 BGK, fp32): driven by a body force
(--drive=force, the default) or by equilibrium-density faces
(--drive=pressure).

Run from the repository root:
    PYTHONPATH=. python examples/torch/poiseuille_3d.py --max_iters=1000
"""

import numpy as np

from sailfish_tpu_torch.geo import EqualSubdomainsGeometry3D
from sailfish_tpu_torch.subdomain import Subdomain3D
from sailfish_tpu_torch.node_type import NTFullBBWall, NTEquilibriumDensity
from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.models.base import LBForcedSim


class PoiseuilleSubdomain(Subdomain3D):
    """3D Poiseuille geometry: circular pipe along flow_direction."""

    max_v = 0.02
    wall_bc = NTFullBBWall

    @property
    def channel_length(self):
        d = self.config.flow_direction
        return {'x': self.config.lat_nx, 'y': self.config.lat_ny,
                'z': self.config.lat_nz}[d] - 1

    @property
    def pressure_delta(self):
        return (self.max_v * (16.0 * self.config.visc) *
                self.channel_length /
                (self.channel_width(self.config) ** 2))

    def _inlet_outlet_maps(self, hx, hy, hz, wall_map):
        not_wall = np.logical_not(wall_map)
        d = self.config.flow_direction
        if d == 'z':
            return (hz == 0) & not_wall, (hz == self.gz - 1) & not_wall
        if d == 'y':
            return (hy == 0) & not_wall, (hy == self.gy - 1) & not_wall
        return (hx == 0) & not_wall, (hx == self.gx - 1) & not_wall

    def _set_pressure_bc(self, hx, hy, hz, wall_map):
        inlet_map, outlet_map = self._inlet_outlet_maps(hx, hy, hz,
                                                        wall_map)
        pressure = self.pressure_delta
        self.set_node(inlet_map,
                      NTEquilibriumDensity(1.0 + 3.0 * pressure / 2.0))
        self.set_node(outlet_map,
                      NTEquilibriumDensity(1.0 - 3.0 * pressure / 2.0))

    def boundary_conditions(self, hx, hy, hz):
        radiussq = (self.channel_width(self.config) / 2.0) ** 2
        d = self.config.flow_direction
        if d == 'z':
            wall_map = ((hx - (self.gx / 2 - 0.5)) ** 2
                        + (hy - (self.gy / 2 - 0.5)) ** 2 >= radiussq)
        elif d == 'y':
            wall_map = ((hx - (self.gx / 2 - 0.5)) ** 2
                        + (hz - (self.gz / 2 - 0.5)) ** 2 >= radiussq)
        else:
            wall_map = ((hy - (self.gy / 2 - 0.5)) ** 2
                        + (hz - (self.gz / 2 - 0.5)) ** 2 >= radiussq)
        self.set_node(wall_map, self.wall_bc)
        if self.config.drive == 'pressure':
            self._set_pressure_bc(hx, hy, hz, wall_map)

    def initial_conditions(self, sim, hx, hy, hz):
        sim.rho[:] = 1.0
        if not self.config.stationary:
            return
        if self.config.drive == 'pressure':
            pressure = self.pressure_delta
            d = self.config.flow_direction
            if d == 'x':
                sim.rho[:] = 1.0 + 3.0 * pressure * (self.gx / 2.0 - hx) \
                    / self.channel_length
            elif d == 'y':
                sim.rho[:] = 1.0 + 3.0 * pressure * (self.gy / 2.0 - hy) \
                    / self.channel_length
            else:
                sim.rho[:] = 1.0 + 3.0 * pressure * (self.gz / 2.0 - hz) \
                    / self.channel_length

    def _velocity_profile(self, r):
        width = self.channel_width(self.config)
        return self.max_v / (width / 2.0) ** 2 * ((width / 2.0) ** 2
                                                  - r ** 2)

    @classmethod
    def channel_width(cls, config):
        return cls.width(config) - 1 - 2 * cls.wall_bc.location

    @classmethod
    def width(cls, config):
        if config.flow_direction == 'x':
            return min(config.lat_ny, config.lat_nz)
        if config.flow_direction == 'y':
            return min(config.lat_nx, config.lat_nz)
        return min(config.lat_nx, config.lat_ny)


class PoiseuilleSim(LBFluidSim, LBForcedSim):
    subdomain = PoiseuilleSubdomain

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': 64,
            'lat_ny': 64,
            'lat_nz': 64,
            'visc': 0.1,
        })

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--flow_direction', type=str, default='x',
                           choices=['x', 'y', 'z'])
        group.add_argument('--stationary', action='store_true',
                           default=False)
        group.add_argument('--drive', type=str, default='force',
                           choices=['force', 'pressure'])

    @classmethod
    def modify_config(cls, config):
        if config.drive == 'force':
            config.periodic_x = config.flow_direction == 'x'
            config.periodic_y = config.flow_direction == 'y'
            config.periodic_z = config.flow_direction == 'z'

    def __init__(self, config):
        super().__init__(config)
        if config.drive == 'force':
            channel_width = self.subdomain.channel_width(config)
            accel = self.subdomain.max_v * (16.0 * config.visc) / \
                channel_width ** 2
            force_vec = {'x': (accel, 0.0, 0.0),
                         'y': (0.0, accel, 0.0),
                         'z': (0.0, 0.0, accel)}[config.flow_direction]
            self.add_body_force(force_vec)


if __name__ == '__main__':
    LBSimulationController(PoiseuilleSim, EqualSubdomainsGeometry3D).run()
