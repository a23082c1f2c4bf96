"""Ternary fluid models of the port: three-component Shan-Chen mixtures.

The host-side code of the JAX package's ternary model
(``sailfish_tpu/models/ternary.py:16-109``: options, fields, host field
plumbing) merged with the three methods that touch device arrays: the
initial state (a 3-tuple of distribution tensors), the device -> host
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


class LBTernaryFluidBase(LBSim):
    """Three-distribution fluid on torch tensors
    (reference lb_ternary.py:14-150)."""

    nonlocality = 1

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--tau_phi', type=float, default=1.0,
                           help='relaxation time for the phi field')
        group.add_argument('--tau_theta', type=float, default=1.0,
                           help='relaxation time for the theta field')

    def __init__(self, config):
        super().__init__(config)
        grid_name = getattr(config, 'grid', None) or \
            ('D2Q9' if self.dim == 2 else 'D3Q19')
        self.grid = lattice.get_grid(grid_name)
        self.grids = [self.grid] * 3

    @property
    def dim(self):
        return self.subdomain.dim

    def init_fields(self, shape):
        self.rho = np.ones(shape, dtype=np.float64)
        self.phi = np.zeros(shape, dtype=np.float64)
        self.theta = np.zeros(shape, dtype=np.float64)
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
        """Equilibria of (rho, u), (phi, u) and (theta, u) on the builder's
        device."""
        def dev(arr):
            return torch.as_tensor(arr, dtype=dtype, device=builder.device)

        u = dev(np.stack(self.velocity_components()))
        return tuple(eq.bgk_equilibrium(self.grid, dev(fld), u)
                     for fld in (self.rho, self.phi, self.theta))

    def update_host_fields(self, macro):
        """Copy device macro fields into the host-side float64 arrays."""
        (rho, phi, theta), u = macro
        self.rho[...] = _host(rho)
        self.phi[...] = _host(phi)
        self.theta[...] = _host(theta)
        comps = self.velocity_components()
        for a in range(self.dim):
            comps[a][...] = _host(u[a])

    def host_fields(self):
        return {'rho': self.rho, 'phi': self.phi, 'theta': self.theta,
                'v': self.velocity_components()}

    @classmethod
    def fields(cls):
        return [ScalarField('rho'), ScalarField('phi'),
                ScalarField('theta'), VectorField('v')]


class LBTernaryFluidShanChen(LBTernaryFluidBase, LBForcedSim):
    """Ternary Shan-Chen mixture (reference lb_ternary.py:154-333)."""

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--visc', type=float, default=1.0,
                           help='numerical viscosity')
        for name in ('G11', 'G12', 'G13', 'G22', 'G23', 'G33'):
            group.add_argument(f'--{name}', type=float, default=0.0,
                               help=f'Shan-Chen {name[1]}<->{name[2]} '
                                    'interaction strength')
        group.add_argument('--sc_potential', type=str,
                           choices=['linear', 'classic'], default='linear')

    def make_step_builder(self, maps, dtype, device):
        cfg = self.config
        tau = lattice.relaxation_time(cfg.visc)
        couplings = {(0, 0): cfg.G11, (0, 1): cfg.G12, (0, 2): cfg.G13,
                     (1, 1): cfg.G22, (1, 2): cfg.G23, (2, 2): cfg.G33}
        # per-grid relaxation times (reference lb_ternary_fluid.mako:20-29)
        return multigrid.ShanChenMultiStepBuilder(
            self.grid, maps, [tau, cfg.tau_phi, cfg.tau_theta], couplings,
            potential=cfg.sc_potential,
            body_forces=[self.body_force(k) for k in range(3)],
            force_model=getattr(cfg, 'force_implementation', 'guo'),
            dtype=dtype, device=device,
            time_unit=getattr(cfg, 'dt_per_lattice_time_unit', 1.0))
