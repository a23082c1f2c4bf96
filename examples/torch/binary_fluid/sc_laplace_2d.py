#!/usr/bin/env python
"""Laplace-law validation with a stationary Shan-Chen drop on the
PyTorch/CUDA port (twin of examples/binary_fluid/sc_laplace_2d.py).

A circular drop of component 1 sits in a bath of component 2. At
equilibrium the pressure jump across the interface obeys
Delta p = sigma / R (2D), so running several radii yields the surface
tension and validates the multiphase coupling quantitatively.

In the SC mixture model the (ideal + interaction) pressure is
p = cs^2 (rho + phi) + cs^2 G rho phi with cs^2 = 1/3 absorbed into the
lattice units used below.

Run from the repository root:
    PYTHONPATH=. python examples/torch/binary_fluid/sc_laplace_2d.py \
        --max_iters=1000
"""

import numpy as np

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.geo import LBGeometry2D
from sailfish_tpu_torch.lattice import relaxation_time
from sailfish_tpu_torch.models.binary import LBBinaryFluidShanChen
from sailfish_tpu_torch.subdomain import Subdomain2D

SIZE = 128
RADIUS = 20
COUPLING = 3.5
VISC = 1.0 / 3.0


class DropDomain(Subdomain2D):
    radius = RADIUS

    def boundary_conditions(self, hx, hy):
        pass

    def initial_conditions(self, sim, hx, hy):
        inside = (hx - self.gx / 2) ** 2 + \
            (hy - self.gy / 2) ** 2 < self.radius ** 2
        sim.rho[:] = np.where(inside, 1.0, 1e-4)
        sim.phi[:] = np.where(inside, 1e-4, 1.0)


class LaplaceSim(LBBinaryFluidShanChen):
    subdomain = DropDomain

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': SIZE,
            'lat_ny': SIZE,
            'grid': 'D2Q9',
            'visc': VISC,
            'tau_phi': relaxation_time(VISC),
            'G12': COUPLING,
            'periodic_x': True,
            'periodic_y': True,
        })

    def pressure_jump(self):
        """Delta p between the drop center and the far field."""
        def p(rho, phi):
            return (rho + phi) + COUPLING * rho * phi

        c = self.config.lat_ny // 2, self.config.lat_nx // 2
        p_in = p(self.rho[c], self.phi[c])
        p_out = p(self.rho[10, 10], self.phi[10, 10])
        return float(p_in - p_out)

    def after_step(self, runner):
        if self.need_output() and not self.config.quiet:
            print(self.iteration, 'dp =', self.pressure_jump())


def measure_surface_tension(radius, iters=4000, size=SIZE):
    """Run to near-equilibrium and return (delta_p, radius)."""
    class Dom(DropDomain):
        pass
    Dom.radius = radius

    class Sim(LaplaceSim):
        subdomain = Dom

        def after_step(self, runner):
            pass

    ctrl = LBSimulationController(Sim, default_config=dict(
        lat_nx=size, lat_ny=size, max_iters=iters, every=iters,
        quiet=True))
    ctrl.run(ignore_cmdline=True)
    r = ctrl._runner
    r._fields_to_host()
    return r.sim.pressure_jump(), radius


if __name__ == '__main__':
    LBSimulationController(LaplaceSim, LBGeometry2D).run()
