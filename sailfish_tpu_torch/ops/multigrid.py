"""Multi-distribution (K-component) step builders on torch tensors.

Port of ``sailfish_tpu/ops/multigrid.py``: ``MultigridStepBuilder``,
``ShanChenMultiStepBuilder`` and ``FreeEnergyStepBuilder``, the torch
engine of the binary (and ternary) Shan-Chen mixtures and of the binary
free-energy model, and the semantics reference of their kernel engines
(``ops/sc_multi.py``, ``ops/fe_step.py``). The state is a K-tuple of
(Q, *S) post-collision distributions. Each component runs its own
single-grid ``StepBuilder`` for the node classes (walls, BCs); the
couplings (common velocity, pseudopotential cross-forces, the Landau
chemical potential) live here.
"""

from __future__ import annotations

import numpy as np
import torch

from sailfish_tpu_torch import equilibrium as eq
from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch.ops import collide as co
from sailfish_tpu_torch.ops.step import (StepBuilder, is_dynamic_force,
                                         sample)


def laplacian_and_grad(field, dim, boundary_mask=None):
    """Isotropic laplacian and gradient stencils of ``field`` (*S),
    periodic wrap (``sailfish_tpu/ops/multigrid.py:28-67``, the same
    terms in the same order). Returns (lap (*S), grad (dim, *S))."""
    def at(*vec):
        return sample(field, vec)

    if dim == 2:
        fe, fw = at(1, 0), at(-1, 0)
        fn, fs = at(0, 1), at(0, -1)
        fne, fnw = at(1, 1), at(-1, 1)
        fse, fsw = at(1, -1), at(-1, -1)
        grad = torch.stack([
            (-fnw - fsw + fse + fne) / 12.0 + (fe - fw) / 3.0,
            (-fse - fsw + fne + fnw) / 12.0 + (fn - fs) / 3.0,
        ])
        lap = (fnw + fne + fsw + fse + 4.0 * (fe + fw + fn + fs)
               - 20.0 * field) / 6.0
        return lap, grad
    fe, fw = at(1, 0, 0), at(-1, 0, 0)
    fn, fs = at(0, 1, 0), at(0, -1, 0)
    ft, fb = at(0, 0, 1), at(0, 0, -1)
    fne, fnw = at(1, 1, 0), at(-1, 1, 0)
    fse, fsw = at(1, -1, 0), at(-1, -1, 0)
    fte, ftw = at(1, 0, 1), at(-1, 0, 1)
    fbe, fbw = at(1, 0, -1), at(-1, 0, -1)
    ftn, fts = at(0, 1, 1), at(0, -1, 1)
    fbn, fbs = at(0, 1, -1), at(0, -1, -1)
    grad = torch.stack([
        (-fnw - fsw - ftw - fbw + fse + fne + fte + fbe) / 12.0
        + (fe - fw) / 6.0,
        (-fse - fsw - fts - fbs + fne + fnw + ftn + fbn) / 12.0
        + (fn - fs) / 6.0,
        (-fbe - fbw - fbn - fbs + fte + ftw + ftn + fts) / 12.0
        + (ft - fb) / 6.0,
    ])
    lap = ((fnw + fne + fse + fsw + fte + ftw + ftn + fts
            + fbe + fbw + fbn + fbs) / 6.0
           + (ft + fb + fe + fw + fn + fs) / 3.0 - 4.0 * field)
    return lap, grad


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

    #: whether each component's StepBuilder is given its body force; a
    #: model that applies the forces in ``collide_all`` sets it False
    forces_in_components = True

    def __init__(self, grid, maps, taus, *, body_force=None,
                 body_forces=None, force_model='guo',
                 dtype=torch.float32, device='cpu', time_unit=1.0):
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
            if bf is not None and is_dynamic_force(bf):
                raise NotImplementedError(
                    'DynamicValue body forces cover single-fluid models '
                    'only (StepBuilder.force_at); multi-component models '
                    'take constant per-component forces')
        self.body_forces = body_forces
        self.body_force = body_forces[0]
        self.components = [
            StepBuilder(grid, maps, model='bgk', tau=tau,
                        body_force=(body_forces[k]
                                    if self.forces_in_components else None),
                        dtype=dtype, device=device, time_unit=time_unit)
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

    def stream_phase(self, state):
        """The step's first phase on the K-tuple ``state``: (fss, rhos),
        the components' post-stream distributions and densities (what the
        couplings sample at the neighbours: a sharded step exchanges the
        densities' ghost planes before ``collide_phase``)."""
        fss = self._streamed_all(state)
        return fss, [eq.density(self.grid, fs) for fs in fss]

    def collide_phase(self, fss, rhos, it=0):
        """The step's second phase from ``stream_phase``'s (fss, rhos) at
        iteration ``it``: common velocity, BCs, the coupled collision;
        returns the next K-tuple."""
        u = self.common_velocity(fss, rhos)
        # macroscopic BC overrides apply to the fluid component, with its
        # parameters at this step's iteration
        rho0, u = self.b0._solve_macro_bc(fss[0], rhos[0], u, it)
        rhos = [rho0] + list(rhos[1:])
        fss = [c._pre_collision_bc(fs, rho, u)
               for c, fs, rho in zip(self.components, fss, rhos)]
        fposts = self.collide_all(fss, rhos, u)
        out = []
        for c, fs, fpost in zip(self.components, fss, fposts):
            if c.has_dry:
                fpost = torch.where(c.wet[None], fpost, fs)
            out.append(c._post_collision(fs, fpost))
        return tuple(out)

    def build(self):
        """step(state, it=0) -> next state, on K-tuples of (Q, *S):
        ``collide_phase`` of ``stream_phase``."""

        def step(state, it=0):
            return self.collide_phase(*self.stream_phase(state), it)

        return step

    def macro_fields(self, state, it=0):
        """([rho_k], u): component densities (BC overrides on component
        0) and the common velocity, for output."""
        fss = self._streamed_all(state)
        rhos = [eq.density(self.grid, fs) for fs in fss]
        u = self.common_velocity(fss, rhos)
        rho0, u = self.b0._solve_macro_bc(fss[0], rhos[0], u, it)
        return ([rho0] + rhos[1:], u)


class ShanChenMultiStepBuilder(MultigridStepBuilder):
    """K-component Shan-Chen mixture: common velocity
      u' = (sum_k mom_k / tau_k) / (sum_k rho_k / tau_k)
    and per-component equilibrium velocity u_k = u' + tau_k F_k / rho_k
    with pseudopotential cross-forces F_k."""

    def __init__(self, grid, maps, taus, couplings, *, potential='linear',
                 body_force=None, body_forces=None, force_model='guo',
                 dtype=torch.float32, device='cpu', time_unit=1.0):
        """couplings: dict {(j, k): G_jk} (symmetric; includes (k, k) for
        self-interaction)."""
        super().__init__(grid, maps, taus, body_force=body_force,
                         body_forces=body_forces, force_model=force_model,
                         dtype=dtype, device=device, time_unit=time_unit)
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


def fe_weights(grid):
    """Free-energy stencil weights (``sailfish_tpu/ops/multigrid.py:212-252``):
    a dict of per-direction coefficient vectors (numpy, index 0 = rest,
    zero there)."""
    Q = grid.Q
    dim = grid.dim
    wi = np.zeros(Q)
    wxx = np.zeros(Q)
    wyy = np.zeros(Q)
    wzz = np.zeros(Q)
    wxy = np.zeros(Q)
    wyz = np.zeros(Q)
    wxz = np.zeros(Q)
    for i in range(1, Q):
        x = grid.basis[i]
        n2 = int(x @ x)
        wxy[i] = x[0] * x[1] / 4.0
        if dim == 3:
            wyz[i] = x[1] * x[2] / 4.0
            wxz[i] = x[0] * x[2] / 4.0
            if n2 == 1:
                wi[i] = 1.0 / 6.0
                wxx[i] = 5.0 / 12.0 if abs(x[0]) == 1 else -1.0 / 3.0
                wyy[i] = 5.0 / 12.0 if abs(x[1]) == 1 else -1.0 / 3.0
                wzz[i] = 5.0 / 12.0 if abs(x[2]) == 1 else -1.0 / 3.0
            else:
                wi[i] = 1.0 / 12.0
                wxx[i] = -1.0 / 24.0 if abs(x[0]) == 1 else 1.0 / 12.0
                wyy[i] = -1.0 / 24.0 if abs(x[1]) == 1 else 1.0 / 12.0
                wzz[i] = -1.0 / 24.0 if abs(x[2]) == 1 else 1.0 / 12.0
        else:
            if n2 == 1:
                wi[i] = 1.0 / 3.0
                wxx[i] = 1.0 / 3.0 if abs(x[0]) == 1 else -1.0 / 6.0
                wyy[i] = 1.0 / 3.0 if abs(x[1]) == 1 else -1.0 / 6.0
            else:
                wi[i] = 1.0 / 12.0
                wxx[i] = -1.0 / 24.0
                wyy[i] = -1.0 / 24.0
    return dict(wi=wi, wxx=wxx, wyy=wyy, wzz=wzz, wxy=wxy, wyz=wyz,
                wxz=wxz)


def dry_map(maps):
    """(*S) bool map of the nodes whose type is not wet (walls, excluded
    and propagation-only nodes)."""
    return ~np.isin(maps.type_map, [t for t in maps.present_types
                                    if nt.get_node_type(t).wet_node])


def wetting_mirror(grid, phi, dry_orient, wall_grad_phase):
    """``phi`` with every dry node of orientation k >= 1 replaced by phi at
    its neighbour along orientation vector k, minus ``wall_grad_phase``
    (the wetting condition, ``sailfish_tpu/ops/multigrid.py:335-347``).
    Dry nodes of orientation 0 keep their own phi."""
    out = phi
    for k in range(1, 2 * grid.dim + 1):
        vec = grid.orientation_vectors[k - 1]
        out = torch.where(dry_orient == k,
                          sample(phi, vec) - wall_grad_phase, out)
    return out


def fe_mrt_moments(grid):
    """(rows, shear): the moments the FE-MRT relaxation forms, conserved
    ones first, then the shear-stress ones, as indices into the rows of
    ``grid.mrt_matrix``; ``shear`` is the set of shear-stress indices."""
    rows = [int(k) for k in grid.mrt_conserved] + \
        [int(k) for k in grid.mrt_shear]
    return rows, {int(k) for k in grid.mrt_shear}


def _scaled(c, t):
    return t if c == 1.0 else (-t if c == -1.0 else c * t)


def fe_mrt_relax(grid, z, inv_tau0):
    """FE-MRT relaxation terms, moment-wise
    (``sailfish_tpu/ops/pallas_multi2d.py:36-88``): with per-moment rates
    0 (conserved), 1/tau0 (shear) and 1 (the rest),
      f - M^-1 diag(s) M fneq == feq + P_cons fneq + (1 - 1/tau0) P_shear fneq.
    ``z``: the Q planes fneq_i (plus half the Guo term under forcing).
    Returns the Q correction planes P_cons z + (1 - 1/tau0) P_shear z,
    None where every inverse coefficient vanishes. Unrolled +/- sums over
    the conserved and shear moments: no matmul on the Q axis."""
    M = np.asarray(grid.mrt_matrix, np.float64)
    Minv = np.asarray(grid.mrt_inv, np.float64)
    rows, shear = fe_mrt_moments(grid)
    one_m_it = 1.0 - inv_tau0
    moms = {}
    for kk in rows:
        acc = None
        for j in range(grid.Q):
            c = float(M[kk, j])
            if c == 0.0:
                continue
            term = _scaled(c, z[j])
            acc = term if acc is None else acc + term
        if kk in shear and acc is not None:
            acc = one_m_it * acc
        moms[kk] = acc
    out = []
    for i in range(grid.Q):
        acc = None
        for kk in rows:
            c = float(Minv[i, kk])
            if moms[kk] is None or c == 0.0:
                continue
            term = _scaled(c, moms[kk])
            acc = term if acc is None else acc + term
        out.append(acc)
    return out


class FreeEnergyStepBuilder(MultigridStepBuilder):
    """Binary free-energy model (Landau functional;
    ``sailfish_tpu/ops/multigrid.py:255-455``).

    Component 0: fluid density distribution, relaxing at the
    phi-interpolated tau (BGK, or FE-MRT with ``model='mrt'``); component
    1: order parameter, relaxing at tau_phi. A uniform Guo body force acts
    on component 0; ``eq_force_map`` {target grid: force grid or None}
    picks the velocity each equilibrium is built with."""

    #: the body force enters this model's collision, not the components'
    #: (the JAX step never reads a component's force either)
    forces_in_components = False

    def __init__(self, grid, maps, *, tau_a, tau_b, tau_phi, A, kappa,
                 Gamma, wall_grad_phase=0.0, body_force=None,
                 eq_force_map=None, model='bgk', force_model='guo',
                 dtype=torch.float32, device='cpu', time_unit=1.0):
        super().__init__(grid, maps, [(tau_a + tau_b) / 2.0, tau_phi],
                         body_force=body_force, force_model=force_model,
                         dtype=dtype, device=device, time_unit=time_unit)
        if model not in ('bgk', 'mrt'):
            raise ValueError(f'free-energy model must be bgk or mrt, '
                             f'got {model!r}')
        self.fe_model = model
        self.eq_force_map = dict(eq_force_map or {})
        self.tau_a = float(tau_a)
        self.tau_b = float(tau_b)
        self.tau_phi = float(tau_phi)
        self.A = float(A)
        self.kappa = float(kappa)
        self.Gamma = float(Gamma)
        self.wall_grad_phase = float(wall_grad_phase)
        self.fe_w = {k: torch.as_tensor(v, dtype=dtype)
                     for k, v in fe_weights(grid).items()}
        # wetting: a dry node's orientation code (1-based, into
        # grid.orientation_vectors; 0 where undetected), 0 at wet nodes
        dry = dry_map(maps)
        self._has_dry_nodes = bool(dry.any())
        self._dry_orient = torch.as_tensor(
            maps.orientation * dry.astype(np.int32), device=self.device)

    def _force(self, force, like):
        """A constant (dim,) force as a (dim, 1, ...) tensor like ``like``
        (a (dim, *S) field)."""
        return torch.as_tensor(
            np.asarray(force, dtype=np.float64).reshape(
                (self.grid.dim,) + (1,) * (like.dim() - 1)),
            dtype=like.dtype, device=like.device)

    def common_velocity(self, fss, rhos):
        """u = j / rho of the fluid grid, plus half the body force."""
        u = eq.momentum(self.grid, fss[0]) / rhos[0][None]
        if self.body_force is not None:
            u = u + 0.5 * self._force(self.body_force, u)
        return u

    def _phi_with_wetting(self, phi):
        if not self._has_dry_nodes:
            return phi
        return wetting_mirror(self.grid, phi, self._dry_orient,
                              self.wall_grad_phase)

    def _eq_velocity(self, u, target):
        """Velocity entering ``target``'s equilibrium, honoring the
        ``eq_force_map`` overrides; ``u`` is ``common_velocity``'s output
        (``sailfish_tpu/ops/multigrid.py:349-369``)."""
        if target not in self.eq_force_map:
            return u
        u_base = u
        if self.body_force is not None:
            u_base = u - 0.5 * self._force(self.body_force, u)
        src = self.eq_force_map[target]
        if src is None:
            return u_base
        f_src = self.body_forces[src]
        if f_src is None:
            return u_base
        return u_base + 0.5 * self._force(f_src, u)

    def eq_velocity_offsets(self):
        """The two equilibrium velocities as constant offsets from the
        common velocity: [(dim,) numpy vector per target grid], the form
        the kernel takes them in."""
        dim = self.grid.dim
        half = (np.zeros(dim) if self.body_force is None else
                0.5 * np.asarray(self.body_force, dtype=np.float64))
        out = []
        for target in (0, 1):
            off = np.zeros(dim)
            if target in self.eq_force_map:
                off = off - half
                src = self.eq_force_map[target]
                if src is not None and self.body_forces[src] is not None:
                    off = off + 0.5 * np.asarray(self.body_forces[src],
                                                 dtype=np.float64)
            out.append(off)
        return out

    def collide_all(self, fss, rhos, u):
        return self.fe_collide(fss, rhos, u, self._phi_with_wetting(rhos[1]))

    def fe_collide(self, fss, rhos, u, phi_w):
        """Post-collision [f0, f1] of the post-stream ``fss`` with
        densities ``rhos`` = [rho, phi], common velocity ``u`` and the
        order parameter ``phi_w`` with the wetting mirror applied (the
        laplacian and gradient read it); every node collides."""
        g = self.grid
        rho, phi = rhos
        lap, grad = laplacian_and_grad(phi_w, g.dim)
        A, kappa, Gamma = self.A, self.kappa, self.Gamma

        u0 = self._eq_velocity(u, 0)
        u1 = self._eq_velocity(u, 1)
        cu = eq.dot_cu(g, u0)
        usq = torch.sum(u0 * u0, dim=0)
        if u1 is u0:
            cu1, usq1 = cu, usq
        else:
            cu1 = eq.dot_cu(g, u1)
            usq1 = torch.sum(u1 * u1, dim=0)
        w = self.fe_w

        # fluid equilibrium (cs^2 = 1/3, so the lambda terms vanish)
        pb = rho / 3.0 + A * (-(phi * phi) / 2.0 + 0.75 * phi ** 4)
        kphl = kappa * phi * lap
        gx = grad[0]
        gy = grad[1]
        gz = grad[2] if g.dim == 3 else None
        feq_parts = []
        for i in range(1, g.Q):
            t = w['wi'][i] * (pb - kphl + rho * cu[i]
                              + 1.5 * (cu[i] * cu[i] * rho
                                       - rho * usq / 3.0))
            t = t + kappa * (w['wxx'][i] * gx * gx + w['wyy'][i] * gy * gy
                             + w['wxy'][i] * gx * gy)
            if g.dim == 3:
                t = t + kappa * (w['wzz'][i] * gz * gz
                                 + w['wyz'][i] * gy * gz
                                 + w['wxz'][i] * gx * gz)
            feq_parts.append(t)
        feq0 = rho - sum(feq_parts)
        feq = torch.stack([feq0] + feq_parts)

        # order-parameter equilibrium
        mu = A * (-phi + phi ** 3) - kappa * lap
        geq_parts = []
        for i in range(1, g.Q):
            t = w['wi'][i] * (Gamma * mu + cu1[i] * phi
                              + 1.5 * phi * (cu1[i] * cu1[i]
                                             - usq1 / 3.0))
            geq_parts.append(t)
        geq0 = phi - sum(geq_parts)
        geq = torch.stack([geq0] + geq_parts)

        # phi-interpolated relaxation time
        tau0 = self.tau_b + (torch.clamp(phi, -1.0, 1.0) + 1.0) * \
            (self.tau_a - self.tau_b) * 0.5
        inv_tau0 = 1.0 / tau0
        fvec = (None if self.body_force is None
                else self._force(self.body_force, u))
        if self.fe_model == 'mrt':
            # FE-MRT: non-conserved non-shear moments relax fully, shear
            # moments at the local 1/tau0; moment-space Guo forcing
            # (I - S/2) F_i with the same rates
            z = fss[0] - feq
            half = None
            if fvec is not None:
                half = 0.5 * co.guo_force_terms(g, u, fvec, 0.0, rho)
                z = z + half
            corr = fe_mrt_relax(g, [z[i] for i in range(g.Q)], inv_tau0)
            fpost0 = torch.stack([feq[i] if c is None else feq[i] + c
                                  for i, c in enumerate(corr)])
            if half is not None:
                fpost0 = fpost0 + half
        else:
            fpost0 = fss[0] + (feq - fss[0]) * inv_tau0[None]
            if fvec is not None:
                # the discrete-force correction at the local tau
                fpost0 = fpost0 + co.guo_force_terms(g, u, fvec, inv_tau0,
                                                     rho)
        fpost1 = fss[1] + (geq - fss[1]) / self.tau_phi
        return [fpost0, fpost1]
