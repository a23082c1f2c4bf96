#!/usr/bin/env python
"""Plane Poiseuille flow on the PyTorch/CUDA port (twin of
examples/poiseuille.py: D2Q9 BGK, fp32), validated against the analytic
parabola. The channel runs along either axis (--horizontal), is driven by
a body force or by equilibrium-density ends (--drive), and has full-way or
half-way bounce-back walls (--wall); the wall type shifts the effective
channel width by 2 * wall.location, which the analytic profile accounts
for.

Run from the repository root:
    PYTHONPATH=. python examples/torch/poiseuille.py --max_iters=1000
"""

import numpy as np

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.geo import LBGeometry2D
from sailfish_tpu_torch.models.base import LBForcedSim
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.node_type import NTEquilibriumDensity, \
    NTFullBBWall, NTHalfBBWall
from sailfish_tpu_torch.subdomain import Subdomain2D


class PoiseuilleSubdomain(Subdomain2D):
    #: peak (centerline) velocity of the target parabola
    max_v = 0.02
    wall_bc = NTFullBBWall

    # -- geometry helpers, axis-generic --------------------------------------

    @classmethod
    def width(cls, config):
        """Node count across the channel (including wall rows)."""
        return config.lat_ny if config.horizontal else config.lat_nx

    @classmethod
    def channel_width(cls, config):
        """Hydrodynamic width: the wall plane sits wall_bc.location
        nodes outside the outermost wall node."""
        return cls.width(config) - 1 - 2 * cls.wall_bc.location

    @classmethod
    def pressure_grad(cls, config):
        """|dp/dx| sustaining max_v (Poiseuille balance
        8 mu u_max / w^2)."""
        return cls.max_v * 8.0 * config.visc / \
            cls.channel_width(config) ** 2

    @classmethod
    def velocity_profile(cls, config, cross_coord):
        """Analytic parabola over the cross-channel coordinate."""
        w = cls.channel_width(config)
        half = w / 2.0
        dist = np.abs(half - (cross_coord - cls.wall_bc.location))
        return 4.0 * cls.max_v / w ** 2 * (half ** 2 - dist ** 2)

    # -- scene ----------------------------------------------------------------

    def _axes(self, hx, hy):
        """(along, across, n_along): coordinate arrays along/across the
        flow and the channel length."""
        if self.config.horizontal:
            return hx, hy, self.gx
        return hy, hx, self.gy

    def boundary_conditions(self, hx, hy):
        along, across, n_along = self._axes(hx, hy)
        if self.config.drive == 'pressure':
            # density offsets rho = 1 +- 3/2 * dp * L across the ends
            dp_total = self.pressure_grad(self.config) * n_along
            interior = (across > 0) & (across < across.max())
            self.set_node(interior & (along == 0),
                          NTEquilibriumDensity(1.0 + 3.0 * dp_total / 2.0))
            self.set_node(interior & (along == along.max()),
                          NTEquilibriumDensity(1.0 - 3.0 * dp_total / 2.0))
        self.set_node(across == 0, self.wall_bc)
        self.set_node(across == across.max(), self.wall_bc)

    def initial_conditions(self, sim, hx, hy):
        sim.rho[:] = 1.0
        if not self.config.stationary:
            return
        along, across, n_along = self._axes(hx, hy)
        if self.config.drive == 'pressure':
            # linear pressure ramp matching the end reservoirs
            dp = self.pressure_grad(self.config)
            sim.rho[:] = 1.0 + 3.0 * dp * (n_along / 2.0 - along)
        else:
            profile = self.velocity_profile(self.config, across)
            if self.config.horizontal:
                sim.vx[:] = profile
            else:
                sim.vy[:] = profile


class PoiseuilleSim(LBFluidSim, LBForcedSim):
    subdomain = PoiseuilleSubdomain

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({'lat_nx': 128, 'lat_ny': 128, 'visc': 0.1})

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--horizontal', action='store_true',
                           default=False, help='flow along the X axis')
        group.add_argument('--stationary', action='store_true',
                           default=False,
                           help='start from the analytic solution')
        group.add_argument('--drive', type=str, default='force',
                           choices=['force', 'pressure'])
        group.add_argument('--wall', type=str, default='fullbb',
                           choices=['fullbb', 'halfbb'])

    @classmethod
    def modify_config(cls, config):
        if config.drive == 'force':
            # periodic along the flow; walls close the other axis
            config.periodic_x = config.horizontal
            config.periodic_y = not config.horizontal
        cls.subdomain.wall_bc = (NTHalfBBWall if config.wall == 'halfbb'
                                 else NTFullBBWall)

    def __init__(self, config):
        super().__init__(config)
        if config.drive == 'force':
            accel = self.subdomain.pressure_grad(config)
            self.add_body_force((accel, 0.0) if config.horizontal
                                else (0.0, accel))


if __name__ == '__main__':
    LBSimulationController(PoiseuilleSim, LBGeometry2D).run()
