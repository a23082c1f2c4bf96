#!/usr/bin/env python
"""Poiseuille flow with a time-ramped, spatially-profiled inlet, on the
PyTorch/CUDA port (twin of examples/poiseuille_sa.py: D2Q9 BGK, fp32).

Two ways to express a space- AND time-dependent boundary parameter:

  --velocity=equation       a callable of (t, hx, hy) evaluating the
                            parabola inline;
  --velocity=spatial_array  a precomputed per-node SpatialArray profile
                            multiplied by a time ramp.

Both ramp the inlet parabola linearly over the first 5000 iterations,
with a fixed-pressure outlet. The callables receive torch tensors.

Run from the repository root:
    PYTHONPATH=. python examples/torch/poiseuille_sa.py --max_iters=1000
"""

import torch

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.geo import LBGeometry2D
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.node_type import DynamicValue, \
    NTEquilibriumDensity, NTEquilibriumVelocity, NTFullBBWall, SpatialArray
from sailfish_tpu_torch.subdomain import Subdomain2D

RAMP_ITERS = 5000.0


def time_ramp(t):
    return torch.clamp(t / RAMP_ITERS, max=1.0)


class RampedInletChannel(Subdomain2D):
    max_v = 0.02

    def _parabola(self, hy):
        width = self.gy - 2.0
        radius = width / 2.0
        return self.max_v * (1.0 - (hy + 0.5 - radius) ** 2
                             / radius ** 2)

    def boundary_conditions(self, hx, hy):
        wall = (hy == 0) | (hy == self.gy - 1)
        self.set_node(wall, NTFullBBWall)
        interior = ~wall
        self.set_node(interior & (hx == self.gx - 1),
                      NTEquilibriumDensity(1.0))

        if self.config.velocity == 'equation':
            max_v = self.max_v
            width = self.gy - 2.0
            radius = width / 2.0

            def vx(t, hx_, hy_, _m=max_v, _r=radius):
                parab = _m * (1.0 - (hy_ + 0.5 - _r) ** 2 / _r ** 2)
                return parab * time_ramp(t)

            inlet = DynamicValue(vx, 0.0)
        else:
            profile = SpatialArray(self._parabola(hy), where=hx == 0)
            inlet = DynamicValue(profile * time_ramp, 0.0)
        self.set_node(interior & (hx == 0),
                      NTEquilibriumVelocity(inlet))

    def initial_conditions(self, sim, hx, hy):
        sim.rho[:] = 1.0


class RampedPoiseuilleSim(LBFluidSim):
    subdomain = RampedInletChannel

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--velocity', type=str, default='equation',
                           choices=['equation', 'spatial_array'])

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({'lat_nx': 128, 'lat_ny': 128, 'visc': 0.1})


if __name__ == '__main__':
    LBSimulationController(RampedPoiseuilleSim, LBGeometry2D).run()
