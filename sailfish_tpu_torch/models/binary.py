"""Binary fluid models of the port: Shan-Chen and free-energy mixtures.

The JAX package's binary models (``sailfish_tpu/models/binary.py:18-152``)
are numpy-only at import time: their options, fields and host-side field
plumbing are reused by subclassing. The port replaces the three methods
that touch device arrays: the initial state (a 2-tuple of distribution
tensors), the device -> host field copy and the step builder.
"""

from __future__ import annotations

import numpy as np
import torch

from sailfish_tpu import lattice
from sailfish_tpu.models import binary as _binary
from sailfish_tpu_torch import equilibrium as eq
from sailfish_tpu_torch.models.base import LBForcedSim
from sailfish_tpu_torch.ops import multigrid


def _host(t):
    return t.detach().cpu().numpy().astype(np.float64)


class LBBinaryFluidBase(_binary.LBBinaryFluidBase):
    """Two-distribution binary fluid on torch tensors."""

    def make_initial_state(self, builder, dtype):
        """Equilibria of (rho, u) and (phi, u) on the builder's device."""
        def dev(arr):
            return torch.as_tensor(arr, dtype=dtype, device=builder.device)

        rho, phi = dev(self.rho), dev(self.phi)
        u = dev(np.stack(self.velocity_components()))
        return (eq.bgk_equilibrium(self.grid, rho, u),
                eq.bgk_equilibrium(self.grid, phi, u))

    def update_host_fields(self, macro):
        """Copy device macro fields into the host-side float64 arrays."""
        (rho, phi), u = macro
        self.rho[...] = _host(rho)
        self.phi[...] = _host(phi)
        comps = self.velocity_components()
        for a in range(self.dim):
            comps[a][...] = _host(u[a])


class LBBinaryFluidFreeEnergy(LBBinaryFluidBase,
                              _binary.LBBinaryFluidFreeEnergy):
    """Binary free-energy mixture (Landau functional)."""

    def make_step_builder(self, maps, dtype, device):
        cfg = self.config
        body_force = None
        if isinstance(self, LBForcedSim):
            body_force = self.body_force(0)
        return multigrid.FreeEnergyStepBuilder(
            self.grid, maps,
            tau_a=cfg.tau_a, tau_b=cfg.tau_b, tau_phi=cfg.tau_phi,
            A=cfg.A, kappa=cfg.kappa, Gamma=cfg.Gamma,
            wall_grad_phase=cfg.bc_wall_grad_phase,
            body_force=body_force,
            eq_force_map=getattr(self, '_eq_force_map', None),
            model=getattr(cfg, 'model', 'bgk'),
            force_model=getattr(cfg, 'force_implementation', 'guo'),
            dtype=dtype, device=device)


class LBBinaryFluidShanChen(LBBinaryFluidBase,
                            _binary.LBBinaryFluidShanChen):
    """Binary Shan-Chen mixture."""

    def make_step_builder(self, maps, dtype, device):
        cfg = self.config
        tau = lattice.relaxation_time(cfg.visc)
        couplings = {(0, 0): cfg.G11, (0, 1): cfg.G12, (1, 1): cfg.G22}
        # grid 0 relaxes at tau(visc), grid 1 at tau_phi
        return multigrid.ShanChenMultiStepBuilder(
            self.grid, maps, [tau, cfg.tau_phi], couplings,
            potential=cfg.sc_potential,
            body_forces=[self.body_force(0), self.body_force(1)],
            force_model=getattr(cfg, 'force_implementation', 'guo'),
            dtype=dtype, device=device)
