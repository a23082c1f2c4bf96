#!/usr/bin/env python
"""Capillary wave relaxation in the free-energy binary model on the
PyTorch/CUDA port (twin of examples/binary_fluid/fe_capillary_wave_2d.py:
D2Q9, fp32, half-way walls).

A sinusoidally perturbed interface between two components relaxes
freely. Potential-flow theory gives the oscillation frequency
omega = sqrt(sigma k^3 / (2 rho)) and decay rate gamma = 2 nu k^2 with
k = 2 pi / wavelength; the FE surface tension is
sigma = sqrt(8 kappa A / 9). The interface height is recorded on the
device every ``--height_every`` iterations by a device hook.

Run from the repository root:
    PYTHONPATH=. python examples/torch/binary_fluid/fe_capillary_wave_2d.py \
        --max_iters=1000
"""

import numpy as np
import torch

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.geo import LBGeometry2D
from sailfish_tpu_torch.lattice import relaxation_time
from sailfish_tpu_torch.models.binary import LBBinaryFluidFreeEnergy
from sailfish_tpu_torch.node_type import NTHalfBBWall, _NTUnused
from sailfish_tpu_torch.subdomain import Subdomain2D

H = 256
AMPLITUDE = 10
N_WAVES = 1
VISC = 1.0 / 18.0


class CapillaryWaveDomain(Subdomain2D):
    def boundary_conditions(self, hx, hy):
        self.set_node((hy == 1) | (hy == self.gy - 2), NTHalfBBWall)
        self.set_node((hy == 0) | (hy == self.gy - 1), _NTUnused)

    def initial_conditions(self, sim, hx, hy):
        surface = self.gx / 2 + AMPLITUDE * np.sin(
            2.0 * np.pi * hx * N_WAVES / self.gx)
        sim.rho[:] = 1.0
        sim.phi[:] = np.where(hy < surface, 1.0, -1.0)


class CapillaryWaveSim(LBBinaryFluidFreeEnergy):
    subdomain = CapillaryWaveDomain

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': H,
            'lat_ny': H + 2,
            'grid': 'D2Q9',
            'tau_a': relaxation_time(VISC),
            'tau_b': relaxation_time(VISC),
            'tau_phi': 1.0,
            # wide interface to avoid aliasing in the height measurement
            'kappa': 0.04,
            'A': 0.02,
            'Gamma': 0.8,
            'periodic_x': True,
        })

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--height_every', type=int, default=25,
                           help='interface-height sampling stride')

    def before_main_loop(self, runner):
        """Record the interface height at the wave crest column by a
        device hook: height = y where phi crosses zero, measured as
        sum(phi > 0) along the column."""
        cfg = self.config
        every = cfg.height_every
        nslots = cfg.max_iters // every + 1
        col = self.subdomain.dim and (cfg.lat_nx // (4 * N_WAVES))
        builder = runner.builder

        def height(f):
            (rho, phi), _ = builder.macro_fields(f)
            return torch.sum((phi[:, col] > 0.0).to(torch.float32))

        init = torch.zeros((nslots,), dtype=torch.float32)

        def hook(f, series, it):
            if it % every:
                return series
            h = height(f)
            if it // every < nslots:   # a sample past the last slot drops
                series[it // every] = h
            return series

        self._height_hook = self.add_device_hook(init, hook, every=every)
        self._runner_ref = runner

    def interface_heights(self):
        return self._runner_ref.device_hook_state[
            self._height_hook].cpu().numpy()

    def after_step(self, runner):
        if self.iteration >= self.config.max_iters and self.config.output:
            np.savetxt(f'{self.config.output}_heights.dat',
                       self.interface_heights())


if __name__ == '__main__':
    LBSimulationController(CapillaryWaveSim, LBGeometry2D).run()
