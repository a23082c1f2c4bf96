"""The stream-and-collide step as plain PyTorch tensor code.

Port of a subset of ``sailfish_tpu/ops/step.py`` (``StepBuilder``,
:73-862): the "torch" engine, and the port's semantics reference on every
device. The state holds POST-COLLISION distributions (Q, *S) in the
lattice's standard direction order; one step is gather (pull streaming)
-> fix missing -> macro -> BC solve -> pre-collision BC -> collide ->
dry-node handling, exactly the JAX phase sequence.

The subset: BGK collision with the second-order equilibrium, a constant
or per-node body force (Guo, exact-difference or velocity-shift forcing),
no subgrid model, no Shan-Chen, fp32 or fp64 storage, and the node types
fluid, the excluded / propagation-only "keep" types,
``NTFullBBWall`` and the six elementwise ("native") BC types with static
parameters. Anything else raises ``NotImplementedError`` when the builder
is made, the way the JAX engine's ``_IMPLEMENTED_TYPES`` does. The
multi-component builders (``ops/multigrid.py``) run one ``StepBuilder``
per component through its per-phase methods (``_solve_macro_bc`` ...
``_post_collision``).

The BC phases are module-level functions over an explicit instance list
``(cls, orientation, mask, rho_bc, vel_bc)`` so the kernel's plain
reference (``ops/lbm_step.step_reference``) runs the same code with its
per-instance scalar parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from sailfish_tpu_torch import equilibrium as eq
from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch.equilibrium import signed_sum
from sailfish_tpu_torch.ops import collide as co

#: Elementwise BC families (macro solve -> reconstruction -> collide, no
#: neighbour sampling); ``sailfish_tpu/ops/pallas_step.py:57``.
NATIVE_BC_TYPES = (nt.NTEquilibriumVelocity, nt.NTEquilibriumDensity,
                   nt.NTZouHeVelocity, nt.NTZouHeDensity,
                   nt.NTRegularizedVelocity, nt.NTRegularizedDensity)

#: Node types this engine implements; a present type outside the set
#: raises at build time.
_IMPLEMENTED_TYPES = (
    nt._NTFluid, nt._NTGhost, nt._NTUnused, nt._NTPropagationOnly,
    nt.NTFullBBWall) + NATIVE_BC_TYPES


def pull(arr, vec):
    """Value of ``arr`` at x - vec (vec in (cx, cy[, cz]) order): the
    streaming gather, a roll by +vec over the (z, y, x) axes."""
    shifts, dims = [], []
    for a, comp in enumerate(vec):
        if comp:
            shifts.append(int(comp))
            dims.append(arr.dim() - 1 - a)
    return torch.roll(arr, shifts, dims) if shifts else arr


def sample(arr, vec):
    """Value of ``arr`` at x + vec."""
    return pull(arr, [-int(c) for c in vec])


def gather(grid, f):
    """Pull streaming: fs_i(x) = f_i(x - c_i), periodic wrap."""
    return torch.stack([pull(f[i], grid.basis[i]) for i in range(grid.Q)])


def solve_macro_bc(grid, instances, fs, rho, u):
    """Per-instance macroscopic overrides (Zou & He solves;
    ``sailfish_tpu/ops/step.py:584-617``). ``instances``: list of
    (cls, orientation, mask, rho_bc, vel_bc) with disjoint masks."""
    fl = [fs[i] for i in range(grid.Q)]
    for cls, k, mask, rho_bc, vel_bc in instances:
        n = grid.orientation_vectors[k - 1]
        cn = grid.basis @ n
        s0 = signed_sum((cn == 0).astype(int), fl)
        sin = signed_sum((cn < 0).astype(int), fl)
        if 'velocity' in cls.param_names:
            un = signed_sum(n, [vel_bc[a] for a in range(grid.dim)])
            rho_s = (s0 + 2.0 * sin) / (1.0 - un)
            rho = torch.where(mask, rho_s, rho)
            u = torch.where(mask[None], vel_bc, u)
        else:
            un = 1.0 - (s0 + 2.0 * sin) / rho_bc
            uvec = torch.stack([un * int(n[a]) for a in range(grid.dim)])
            rho = torch.where(mask, rho_bc, rho)
            u = torch.where(mask[None], uvec, u)
    return rho, u


def _noneq_bb(grid, fs, feq, unknown):
    """Unknown f_i <- f_opp + feq_i - feq_opp (non-equilibrium
    bounce-back)."""
    out = []
    for i in range(grid.Q):
        if unknown[i]:
            o = int(grid.opposite[i])
            out.append(fs[o] + feq[i] - feq[o])
        else:
            out.append(fs[i])
    return torch.stack(out)


def pre_collision_bc(grid, instances, fs, rho, u, incompressible=False):
    """Distribution reconstruction at BC nodes
    (``sailfish_tpu/ops/step.py:632-670``)."""
    for cls, k, mask, _rho_bc, _vel_bc in instances:
        n = grid.orientation_vectors[k - 1]
        unknown = grid.unknown_mask(n)
        feq = eq.bgk_equilibrium(grid, rho, u,
                                 incompressible=incompressible)
        if cls in (nt.NTEquilibriumVelocity, nt.NTEquilibriumDensity):
            fs = torch.where(mask[None], feq, fs)
        elif cls in (nt.NTZouHeVelocity, nt.NTZouHeDensity):
            fz = _noneq_bb(grid, fs, feq, unknown)
            # tangential momentum fixup (reference sym.zouhe_fixup)
            mom = eq.momentum(grid, fz)
            naxis = (k - 1) // 2
            for a in range(grid.dim):
                if a == naxis:
                    continue
                coeff = np.where(unknown, grid.basis[:, a], 0)
                denom = float(np.sum(coeff * grid.basis[:, a]))
                if denom == 0.0:
                    continue
                dj = rho * u[a] - mom[a]
                corr = torch.stack([
                    (float(coeff[i]) / denom) * dj if coeff[i] else
                    torch.zeros_like(dj) for i in range(grid.Q)])
                fz = fz + corr
            fs = torch.where(mask[None], fz, fs)
        elif cls in (nt.NTRegularizedVelocity, nt.NTRegularizedDensity):
            fnb = _noneq_bb(grid, fs, feq, unknown)
            pi = eq.second_moment_noneq(grid, fnb, feq)
            freg = eq.regularized_f(grid, rho, u, pi,
                                    incompressible=incompressible)
            fs = torch.where(mask[None], freg, fs)
    return fs


def bounce_back(grid, fs, fpost, fullbb):
    """Full bounce-back walls store the arriving distributions reflected
    (``sailfish_tpu/ops/step.py:753-770``, without slip). ``fullbb`` is a
    boolean node map, or None when no wall is present."""
    if fullbb is None:
        return fpost
    opp = torch.as_tensor(grid.opposite, dtype=torch.long, device=fs.device)
    return torch.where(fullbb[None], fs[opp], fpost)


def select_dry(grid, fs, fpost, wet, fullbb):
    """The dry/keep select of ``sailfish_tpu/ops/step.py:819-822``: dry
    nodes keep their post-stream values ``fs``, full bounce-back walls
    store them reflected. ``wet`` is a boolean node map, or None when
    every node is wet."""
    if wet is not None:
        fpost = torch.where(wet[None], fpost, fs)
    return bounce_back(grid, fs, fpost, fullbb)


FORCE_MODELS = ('guo', 'edm', 'velocity_shift')


def is_dynamic_force(body_force):
    """Whether ``body_force`` holds time or space callables (a
    ``DynamicValue``, or a sequence with a callable component)."""
    return isinstance(body_force, nt.DynamicValue) \
        or any(callable(c) for c in tuple(body_force))


def forced_collide(grid, fs, rho, u, tau_inv, force=None, force_model='guo',
                   u_eq=None, incompressible=False):
    """BGK relaxation under the body force ``force`` (an acceleration,
    (dim, *S) or broadcastable; None: no force), the BGK branch of
    ``sailfish_tpu/ops/step.py:690-751``. ``guo`` relaxes towards
    feq(rho, u_eq + a/2) and adds the Guo term; ``velocity_shift`` relaxes
    towards feq(rho, u_eq + tau a) and adds nothing; ``edm`` relaxes
    towards feq(rho, u_eq) and adds feq(rho, u + a) - feq(rho, u) with
    the bare ``u``. ``u_eq`` (default ``u``) is the equilibrium velocity a
    multi-component coupling has shifted already."""
    if u_eq is None:
        u_eq = u
    if force is not None:
        if force_model == 'guo':
            u_eq = u_eq + 0.5 * force
        elif force_model == 'velocity_shift':
            u_eq = u_eq + (1.0 / tau_inv) * force
    fpost = co.bgk_collide(grid, fs, rho, u_eq, tau_inv,
                           incompressible=incompressible)
    if force is not None:
        if force_model == 'guo':
            fpost = fpost + co.guo_force_terms(grid, u_eq, force, tau_inv,
                                               rho)
        elif force_model == 'edm':
            fpost = fpost + co.edm_shift(grid, rho, u, force,
                                         incompressible=incompressible)
    return fpost


def collide_and_select(grid, fs2, rho, u, tau_inv, wet, fullbb,
                       incompressible=False, force=None, force_model='guo'):
    """``forced_collide`` on every node (BC nodes take the force with
    their solved rho and u), then ``select_dry``."""
    fpost = forced_collide(grid, fs2, rho, u, tau_inv, force, force_model,
                           incompressible=incompressible)
    return select_dry(grid, fs2, fpost, wet, fullbb)


class StepBuilder:
    """Builds the single-device step function for a single-fluid BGK
    model (the torch engine). Parameters mirror the JAX builder's."""

    def __init__(self, grid, maps, *, model='bgk', visc=None, tau=None,
                 incompressible=False, smagorinsky=0.0, body_force=None,
                 force_model='guo', sc_coupling=0.0, equilibrium='bgk',
                 dtype=torch.float32, device='cpu', storage='fp'):
        if force_model not in FORCE_MODELS:
            raise ValueError(
                f'force_model must be guo, edm or velocity_shift; '
                f'got {force_model!r}')
        unported = []
        if model != 'bgk':
            unported.append(f'model={model}')
        if smagorinsky > 0.0:
            unported.append('the Smagorinsky subgrid model')
        if body_force is not None and is_dynamic_force(body_force):
            unported.append('DynamicValue body forces (time- or '
                            'space-dependent callables)')
        if sc_coupling != 0.0:
            unported.append('Shan-Chen coupling')
        if equilibrium != 'bgk':
            unported.append(f'equilibrium={equilibrium}')
        if storage != 'fp':
            unported.append(f'{storage} storage (--precision=mixed)')
        if maps.dynamic:
            unported.append('DynamicValue BC parameters (SpatialArray, '
                            'time series)')
        if unported:
            raise NotImplementedError(
                'not ported to the torch engine yet: ' + ', '.join(unported))
        self.grid = grid
        self.maps = maps
        self.tau = float(tau if tau is not None
                         else grid.relaxation_time(visc))
        self.tau_inv = 1.0 / self.tau
        self.incompressible = incompressible
        self.dtype = dtype
        self.device = torch.device(device)
        #: the body force as given (an acceleration: a (dim,) vector or a
        #: (dim, *S) field) and ``force``, the same baked for the device:
        #: (dim, 1, ..., 1) or (dim, *S)
        self.body_force = body_force
        self.force_model = force_model
        self.force = None
        if body_force is not None:
            shape = maps.type_map.shape
            bf = np.asarray(body_force, dtype=np.float64)
            if bf.shape not in ((grid.dim,), (grid.dim,) + shape):
                raise ValueError(
                    f'body force needs shape ({grid.dim},) or '
                    f'{(grid.dim,) + shape}; got {bf.shape}')
            if bf.ndim == 1:
                bf = bf.reshape((grid.dim,) + (1,) * len(shape))
            self.force = torch.as_tensor(bf, dtype=dtype, device=self.device)
        self._prepare_static()

    def _prepare_static(self):
        m = self.maps
        tm = m.type_map
        present = m.present_types
        implemented = {c.id for c in _IMPLEMENTED_TYPES}
        for tid in present:
            if tid not in implemented:
                raise NotImplementedError(
                    f'node type {nt.get_node_type(tid).__name__} has no '
                    'BC implementation in the torch engine yet')

        def dev(arr, dtype=None):
            return torch.as_tensor(arr, dtype=dtype, device=self.device)

        wet = np.isin(tm, [t for t in present
                           if nt.get_node_type(t).wet_node])
        self.wet = None if wet.all() else dev(wet)
        self.fullbb = (dev(tm == nt.NTFullBBWall.id)
                       if nt.NTFullBBWall.id in present else None)
        rho_bc = dev(m.param_rho, self.dtype)
        vel_bc = dev(m.param_vel, self.dtype)
        # (type, orientation) instances; orientation 0 (undetected) nodes
        # get no BC, as in the JAX engine
        self.bc_instances = []
        for tid in present:
            cls = nt.get_node_type(tid)
            if cls not in NATIVE_BC_TYPES:
                continue
            sel = tm == tid
            for k in np.unique(m.orientation[sel]):
                if k == 0:
                    continue
                mask = sel & (m.orientation == int(k))
                self.bc_instances.append(
                    (cls, int(k), dev(mask), rho_bc, vel_bc))

    # -- phases --------------------------------------------------------------

    def feq(self, rho, u):
        return eq.bgk_equilibrium(self.grid, rho, u,
                                  incompressible=self.incompressible)

    def gather(self, f):
        return gather(self.grid, f)

    def fix_missing(self, fs, f):
        """Replace distributions whose pull source was not wet. None of
        the JAX engine's fix-missing branches (link-tagged walls, TMS,
        extended copy, outflow families) belongs to the implemented
        types, so this is the identity here."""
        return fs

    def phases(self, fs, f, it=0):
        """fix missing -> macro -> BC solves -> pre-collision BC ->
        collide -> dry/post handling (``sailfish_tpu/ops/step.py:809``)."""
        g = self.grid
        fs = self.fix_missing(fs, f)
        rho, u = eq.macroscopic(g, fs)
        rho, u = solve_macro_bc(g, self.bc_instances, fs, rho, u)
        fs2 = pre_collision_bc(g, self.bc_instances, fs, rho, u,
                               self.incompressible)
        return collide_and_select(g, fs2, rho, u, self.tau_inv, self.wet,
                                  self.fullbb, self.incompressible,
                                  self.force, self.force_model)

    # -- per-phase pieces for the multi-component builders -----------------
    # (the names and semantics of ``sailfish_tpu/ops/step.py:584-770``)

    @property
    def has_dry(self):
        return self.wet is not None

    def _solve_macro_bc(self, fs, rho, u):
        return solve_macro_bc(self.grid, self.bc_instances, fs, rho, u)

    def _pre_collision_bc(self, fs, rho, u):
        return pre_collision_bc(self.grid, self.bc_instances, fs, rho, u,
                                self.incompressible)

    def _collide(self, fs, rho, u, u_eq=None):
        """``forced_collide`` with this builder's body force; ``u_eq``
        (default ``u``) is the shifted equilibrium velocity of the
        multi-component couplings, and the force's own shift is added to
        it."""
        return forced_collide(self.grid, fs, rho, u, self.tau_inv,
                              self.force, self.force_model, u_eq=u_eq,
                              incompressible=self.incompressible)

    def _post_collision(self, fs, fpost):
        return bounce_back(self.grid, fs, fpost, self.fullbb)

    # -- public --------------------------------------------------------------

    def streamed(self, f):
        return self.fix_missing(self.gather(f), f)

    def macro_fields(self, f, it=0):
        """rho, u with BC overrides applied (output fields); under a body
        force of any model u is the force-corrected u + a/2
        (``sailfish_tpu/ops/step.py:840-842``)."""
        fs = self.streamed(f)
        rho, u = eq.macroscopic(self.grid, fs)
        rho, u = solve_macro_bc(self.grid, self.bc_instances, fs, rho, u)
        if self.force is not None:
            u = u + 0.5 * self.force
        return rho, u

    def build(self):
        """step(f, it=0) -> f_next on post-collision states."""

        def step(f, it=0):
            return self.phases(self.gather(f), f, it)

        return step
