#!/usr/bin/env python
"""Womersley flow: oscillatory pressure-driven pipe flow on the
PyTorch/CUDA port (twin of examples/womersley.py: D3Q19 BGK, fp32, the
pipe of examples/torch/poiseuille_3d.py with time-dependent equilibrium
densities 1 +- 1.5 dp sin(omega t) at its two ends). The DynamicValue
callables receive t = iteration * --dt_per_lattice_time_unit as a tensor
and use torch.

Run from the repository root:
    PYTHONPATH=. python examples/torch/womersley.py --max_iters=1000
"""

import importlib.util
import os
from math import sqrt

import numpy as np
import torch

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.geo import EqualSubdomainsGeometry3D
from sailfish_tpu_torch.node_type import NTEquilibriumDensity, DynamicValue


def _sibling(name):
    """examples/torch/<name>.py, loaded by path (a module of the same name
    may be the JAX example's)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f'{name}.py')
    spec = importlib.util.spec_from_file_location(f'torch_{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_pipe = _sibling('poiseuille_3d')
PoiseuilleSim, PoiseuilleSubdomain = _pipe.PoiseuilleSim, \
    _pipe.PoiseuilleSubdomain

omega = 0.0005
visc = 0.01


class WomersleySubdomain(PoiseuilleSubdomain):
    max_v = 0.04

    def _set_pressure_bc(self, hx, hy, hz, wall_map):
        inlet_map, outlet_map = self._inlet_outlet_maps(hx, hy, hz,
                                                        wall_map)
        dp = self.pressure_delta

        self.set_node(inlet_map, NTEquilibriumDensity(DynamicValue(
            lambda t: 1.0 + 1.5 * dp * torch.sin(t * omega))))
        self.set_node(outlet_map, NTEquilibriumDensity(DynamicValue(
            lambda t: 1.0 - 1.5 * dp * torch.sin(t * omega))))

        log = self.config.logger if hasattr(self.config, 'logger') else None
        if log:
            log.info('Re = %.2f' % (self.max_v * self.channel_width(
                self.config) / 2.0 / visc))
            log.info('Wo = %.2f' % (self.channel_width(self.config) / 2.0
                                    * sqrt(omega / visc)))

    def womersley_profile(self, r, t, alpha, omega_):
        """Analytic oscillatory profile (for validation)."""
        from scipy.special import jv
        dpdx = self.pressure_delta * self.channel_length
        A = 1j
        return np.real(
            (1 - jv(0, 1j ** 1.5 * alpha * r) / jv(0, 1j ** 1.5 * alpha))
            * np.exp(1j * omega_ * t) * A / omega_ * 1j) * dpdx


class WomersleySim(PoiseuilleSim):
    subdomain = WomersleySubdomain

    @classmethod
    def update_defaults(cls, defaults):
        PoiseuilleSim.update_defaults(defaults)
        defaults.update({
            'drive': 'pressure',
            'grid': 'D3Q19',
            'lat_nx': 256,
            'visc': visc,
        })


if __name__ == '__main__':
    LBSimulationController(WomersleySim, EqualSubdomainsGeometry3D).run()
