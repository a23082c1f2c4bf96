"""Multi-distribution (K-component) step builders on torch tensors.

Port of ``sailfish_tpu/ops/multigrid.py:70-209``: ``MultigridStepBuilder``
and ``ShanChenMultiStepBuilder``, the torch engine of the binary (and
ternary) Shan-Chen mixtures and the semantics reference of the kernel
engine (``ops/sc_multi.py``). The state is a K-tuple of (Q, *S)
post-collision distributions. Each component runs its own single-grid
``StepBuilder`` for the node classes (walls, BCs); the couplings (common
velocity, pseudopotential cross-forces) live here.

The binary free-energy model (``laplacian_and_grad``,
``FreeEnergyStepBuilder``) waits for its own slice and raises.
"""

from __future__ import annotations

import torch

from sailfish_tpu_torch import equilibrium as eq
from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch.ops import collide as co
from sailfish_tpu_torch.ops.step import StepBuilder

_FREE_ENERGY_TODO = ('the binary free-energy model is not ported yet '
                     '(ROADMAP.md section A, the free-energy slice: '
                     'B8/B10)')


def laplacian_and_grad(field, dim, boundary_mask=None):
    raise NotImplementedError(_FREE_ENERGY_TODO)


def common_velocity(grid, fss, rhos, taus):
    """u' = (sum_k mom_k / tau_k) / (sum_k rho_k / tau_k), (dim, *S)."""
    num = None
    den = None
    for fs, rho, tau in zip(fss, rhos, taus):
        mom = eq.momentum(grid, fs)
        num = mom / tau if num is None else num + mom / tau
        den = rho / tau if den is None else den + rho / tau
    return num / den[None]


def sc_forces(grid, rhos, couplings, potential):
    """Per-component pseudopotential forces [(dim, *S) or None] from the
    couplings {(j, k): G_jk}: each pair acts on j from k's density and,
    for j != k, on k from j's."""
    forces = [None] * len(rhos)
    for (j, k), G in couplings.items():
        if G == 0.0:
            continue
        Fj = co.shan_chen_force(grid, rhos[j], rhos[k], G, potential)
        forces[j] = Fj if forces[j] is None else forces[j] + Fj
        if j != k:
            Fk = co.shan_chen_force(grid, rhos[k], rhos[j], G, potential)
            forces[k] = Fk if forces[k] is None else forces[k] + Fk
    return forces


def shifted_velocity(u, force, tau, rho):
    """The equilibrium velocity u + tau F / rho of one component (``u``
    itself when no force acts on it)."""
    return u if force is None else u + tau * force / rho[None]


class MultigridStepBuilder:
    """Base for K-component models: one StepBuilder per component for BC
    handling, shared node maps, coupled collision implemented by
    subclasses via ``collide_all`` and ``common_velocity``."""

    def __init__(self, grid, maps, taus, *, body_force=None,
                 body_forces=None, force_model='guo',
                 dtype=torch.float32, device='cpu'):
        if force_model != 'guo':
            raise NotImplementedError(
                'multi-component models implement Guo body forcing only '
                f'(got --force_implementation={force_model}); edm and '
                'velocity_shift cover single-fluid models')
        for bad in (nt.NTGuoDensity, nt.NTWallTMS):
            if bad.id in maps.present_types:
                raise NotImplementedError(
                    f'{bad.__name__} is not supported in multi-component '
                    'models yet (single-fluid StepBuilder only)')
        self.grid = grid
        self.maps = maps
        self.taus = [float(t) for t in taus]
        self.dtype = dtype
        self.device = torch.device(device)
        if body_forces is None:
            body_forces = [body_force] + [None] * (len(self.taus) - 1)
        for bf in body_forces:
            if bf is not None and (isinstance(bf, nt.DynamicValue)
                                   or any(callable(c) for c in tuple(bf))):
                raise NotImplementedError(
                    'DynamicValue body forces cover single-fluid models '
                    'only (StepBuilder.force_at); multi-component models '
                    'take constant per-component forces')
        self.body_forces = body_forces
        self.body_force = body_forces[0]
        # the component builders refuse what the torch step does not
        # implement yet (body forces among it)
        self.components = [
            StepBuilder(grid, maps, model='bgk', tau=tau,
                        body_force=body_forces[k], dtype=dtype,
                        device=device)
            for k, tau in enumerate(self.taus)]
        # all components share the node maps
        self.b0 = self.components[0]

    def collide_all(self, fss, rhos, u):
        raise NotImplementedError

    def common_velocity(self, fss, rhos):
        raise NotImplementedError

    def _streamed_all(self, state):
        return [c.fix_missing(c.gather(f), f)
                for c, f in zip(self.components, state)]

    def build(self):
        """step(state, it=0) -> next state, on K-tuples of (Q, *S)."""

        def step(state, it=0):
            fss = self._streamed_all(state)
            rhos = [eq.density(self.grid, fs) for fs in fss]
            u = self.common_velocity(fss, rhos)
            # macroscopic BC overrides apply to the fluid component
            rho0, u = self.b0._solve_macro_bc(fss[0], rhos[0], u)
            rhos = [rho0] + rhos[1:]
            fss = [c._pre_collision_bc(fs, rho, u)
                   for c, fs, rho in zip(self.components, fss, rhos)]
            fposts = self.collide_all(fss, rhos, u)
            out = []
            for c, fs, fpost in zip(self.components, fss, fposts):
                if c.has_dry:
                    fpost = torch.where(c.wet[None], fpost, fs)
                out.append(c._post_collision(fs, fpost))
            return tuple(out)

        return step

    def macro_fields(self, state, it=0):
        """([rho_k], u): component densities (BC overrides on component
        0) and the common velocity, for output."""
        fss = self._streamed_all(state)
        rhos = [eq.density(self.grid, fs) for fs in fss]
        u = self.common_velocity(fss, rhos)
        rho0, u = self.b0._solve_macro_bc(fss[0], rhos[0], u)
        return ([rho0] + rhos[1:], u)


class ShanChenMultiStepBuilder(MultigridStepBuilder):
    """K-component Shan-Chen mixture: common velocity
      u' = (sum_k mom_k / tau_k) / (sum_k rho_k / tau_k)
    and per-component equilibrium velocity u_k = u' + tau_k F_k / rho_k
    with pseudopotential cross-forces F_k."""

    def __init__(self, grid, maps, taus, couplings, *, potential='linear',
                 body_force=None, body_forces=None, force_model='guo',
                 dtype=torch.float32, device='cpu'):
        """couplings: dict {(j, k): G_jk} (symmetric; includes (k, k) for
        self-interaction)."""
        super().__init__(grid, maps, taus, body_force=body_force,
                         body_forces=body_forces, force_model=force_model,
                         dtype=dtype, device=device)
        if potential not in co.SHAN_CHEN_POTENTIALS:
            raise ValueError(f'unknown Shan-Chen potential {potential!r}')
        self.couplings = dict(couplings)
        self.potential = potential

    def common_velocity(self, fss, rhos):
        return common_velocity(self.grid, fss, rhos, self.taus)

    def _forces(self, rhos):
        return sc_forces(self.grid, rhos, self.couplings, self.potential)

    def collide_all(self, fss, rhos, u):
        forces = self._forces(rhos)
        return [c._collide(fs, rho, u,
                           u_eq=shifted_velocity(u, F, tau, rho))
                for c, fs, rho, F, tau in zip(self.components, fss, rhos,
                                              forces, self.taus)]


class FreeEnergyStepBuilder(MultigridStepBuilder):
    """Binary free-energy model: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_FREE_ENERGY_TODO)
