"""Binary fluid models of the port: Shan-Chen and free-energy mixtures.

The host-side code of the JAX package's binary models
(``sailfish_tpu/models/binary.py:18-152``: options, fields, host field
plumbing) merged with the three methods that touch device arrays: the
initial state (a 2-tuple of distribution tensors), the device -> host
field copy and the step builder.
"""

from __future__ import annotations

import numpy as np
import torch

from sailfish_tpu_torch import equilibrium as eq
from sailfish_tpu_torch import lattice
from sailfish_tpu_torch.models.base import LBForcedSim, LBSim, \
    ScalarField, VectorField
from sailfish_tpu_torch.ops import multigrid


def _host(t):
    return t.detach().cpu().numpy().astype(np.float64)


class LBBinaryFluidBase(LBSim):
    """Two-distribution binary fluid on torch tensors
    (reference lb_binary.py:14-137)."""

    nonlocality = 1

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--tau_phi', type=float, default=1.0,
                           help='relaxation time for the phase field')

    def __init__(self, config):
        super().__init__(config)
        grid_name = getattr(config, 'grid', None) or \
            ('D2Q9' if self.dim == 2 else 'D3Q19')
        self.grid = lattice.get_grid(grid_name)
        self.grids = [self.grid, self.grid]

    @property
    def dim(self):
        return self.subdomain.dim

    def init_fields(self, shape):
        self.rho = np.ones(shape, dtype=np.float64)
        self.phi = np.zeros(shape, dtype=np.float64)
        self.vx = np.zeros(shape, dtype=np.float64)
        self.vy = np.zeros(shape, dtype=np.float64)
        if self.dim == 3:
            self.vz = np.zeros(shape, dtype=np.float64)

    def velocity_components(self):
        comps = [self.vx, self.vy]
        if self.dim == 3:
            comps.append(self.vz)
        return comps

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

    def host_fields(self):
        return {'rho': self.rho, 'phi': self.phi,
                'v': self.velocity_components()}

    @classmethod
    def fields(cls):
        return [ScalarField('rho'), ScalarField('phi'), VectorField('v')]


class LBBinaryFluidFreeEnergy(LBBinaryFluidBase):
    """Binary mixture via the Landau free-energy functional
    (reference lb_binary.py:139-374)."""

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--bc_wall_grad_phase', type=float, default=0.0,
                           help='phase gradient at walls (wetting)')
        group.add_argument('--bc_wall_grad_order', type=int, default=2,
                           choices=[1, 2])
        group.add_argument('--Gamma', type=float, default=0.5)
        group.add_argument('--kappa', type=float, default=0.5)
        group.add_argument('--A', type=float, default=0.5)
        group.add_argument('--tau_a', type=float, default=1.0,
                           help='relaxation time of the A component')
        group.add_argument('--tau_b', type=float, default=1.0,
                           help='relaxation time of the B component')
        group.add_argument('--model', type=str, choices=['bgk', 'mrt'],
                           default='bgk',
                           help='LB collision model for the fluid grid '
                           '(reference lb_binary.py:175)')

    @classmethod
    def fields(cls):
        return [ScalarField('rho'), ScalarField('phi'), VectorField('v'),
                ScalarField('phi_laplacian')]

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
            dtype=dtype, device=device,
            time_unit=getattr(cfg, 'dt_per_lattice_time_unit', 1.0))


class LBBinaryFluidShanChen(LBBinaryFluidBase, LBForcedSim):
    """Binary Shan-Chen mixture (reference lb_binary.py:375-517)."""

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--visc', type=float, default=1.0,
                           help='numerical viscosity')
        group.add_argument('--G11', type=float, default=0.0)
        group.add_argument('--G12', type=float, default=0.0)
        group.add_argument('--G22', type=float, default=0.0)
        group.add_argument('--sc_potential', type=str,
                           choices=['linear', 'classic'], default='linear')

    def make_step_builder(self, maps, dtype, device):
        cfg = self.config
        tau = lattice.relaxation_time(cfg.visc)
        couplings = {(0, 0): cfg.G11, (0, 1): cfg.G12, (1, 1): cfg.G22}
        # grid 0 relaxes at tau(visc), grid 1 at tau_phi (reference
        # lb_binary_fluid.mako:38-44)
        return multigrid.ShanChenMultiStepBuilder(
            self.grid, maps, [tau, cfg.tau_phi], couplings,
            potential=cfg.sc_potential,
            body_forces=[self.body_force(0), self.body_force(1)],
            force_model=getattr(cfg, 'force_implementation', 'guo'),
            dtype=dtype, device=device,
            time_unit=getattr(cfg, 'dt_per_lattice_time_unit', 1.0))
