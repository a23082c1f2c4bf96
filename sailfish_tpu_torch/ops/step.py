"""The stream-and-collide step as plain PyTorch tensor code.

Port of a subset of ``sailfish_tpu/ops/step.py`` (``StepBuilder``,
:73-862): the "torch" engine, and the port's semantics reference on every
device. The state holds POST-COLLISION distributions (Q, *S) in the
lattice's standard direction order; one step is gather (pull streaming)
-> fix missing -> macro -> BC solve -> pre-collision BC -> collide ->
dry-node handling, exactly the JAX phase sequence.

The subset: BGK, MRT or TRT collision (TRT is MRT with the same rate
vector, ``sailfish_tpu/ops/step.py:271-272``), optionally with the
Smagorinsky subgrid tau field, or the entropic ELBM collision
(``ops/entropic.py``, ``sailfish_tpu/ops/step.py:726-745``); the
second-order equilibrium (compressible or the incompressible He-Luo form),
the product-form (entropic) one or the D2Q9 shallow-water one, a body
force (Guo, exact-difference or velocity-shift forcing) that is constant,
per-node or a ``DynamicValue`` of time and space, the single-component
Shan-Chen velocity shift, fp32 or fp64 storage or int16 fixed-point
storage with fp32 math (``storage='int16'``, ``--precision=mixed``,
``ops/mixed.py``), and the node types
fluid, the excluded / propagation-only "keep" types, the local walls
(``NTFullBBWall``, ``NTHalfBBWall``, ``NTWallTMS``, ``NTSlip``), the six
elementwise ("native") BC types, whose parameters may be
``DynamicValue``s, and the outflow family (``OUTFLOW_TYPES``: the BCs that
sample neighbours along the normal or a plane mean, Guo's density
extrapolation, the extended copy). Anything
else raises ``NotImplementedError`` when the StepBuilder is made, the way the
JAX engine's ``_IMPLEMENTED_TYPES`` does. The multi-component builders
(``ops/multigrid.py``) run one ``StepBuilder`` per component through its
per-phase methods (``_solve_macro_bc`` ... ``_post_collision``).

Time-dependent values see t = iteration * ``time_unit``
(``--dt_per_lattice_time_unit``), with t a tensor of the StepBuilder's dtype,
as in ``sailfish_tpu/ops/step.py:563-582, :672-688``: the step is
``step(f, it)``.

The phases are module-level functions over explicit arguments -- the
instance list ``(cls, orientation, mask, rho_bc, vel_bc)``, the tag planes,
the TMS and slip masks -- and ``step_phases`` runs them in the JAX order,
so the kernel's plain reference (``ops/lbm_step.step_reference``) runs the
same code with its per-row parameters.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sailfish_tpu_torch import equilibrium as eq
from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch.equilibrium import signed_sum
from sailfish_tpu_torch.ops import collide as co
from sailfish_tpu_torch.ops import entropic as ent
from sailfish_tpu_torch.ops.mixed import DEFAULT_RANGE, MixedScales

#: Elementwise BC families (macro solve -> reconstruction -> collide, no
#: neighbour sampling); ``sailfish_tpu/ops/pallas_step.py:57``.
NATIVE_BC_TYPES = (nt.NTEquilibriumVelocity, nt.NTEquilibriumDensity,
                   nt.NTZouHeVelocity, nt.NTZouHeDensity,
                   nt.NTRegularizedVelocity, nt.NTRegularizedDensity)

#: Walls that fix the links the node-type map tags as missing
#: (``NodeMaps.link_tags``): half-way bounce-back and Tamm-Mott-Smith.
LINK_TAG_TYPES = (nt.NTHalfBBWall, nt.NTWallTMS)

#: The outflow family whose instances replace the unknown distributions
#: in ``fix_missing`` (``sailfish_tpu/ops/step.py:466-561``): they sample
#: the post-collision state at neighbours along the inward normal, or the
#: node's own values, or a plane mean (``NTLaminarize``, which replaces all
#: Q distributions).
FIX_TYPES = (nt.NTDoNothing, nt.NTCopy, nt.NTYuOutflow, nt.NTNeumann,
             nt.NTLaminarize)

#: The outflow-family types of this engine: ``FIX_TYPES``, Guo's density
#: BC (a post-collision overlay, ``guo_density_overlay``), the extended
#: copy (static gathers, ``extended_copy_gathers``) and Grad's outflow.
#: ``NTGradFreeflow`` has no ``needs_orientation``, so the JAX engine's
#: instance list leaves it out (``sailfish_tpu/ops/step.py:165-168``) and
#: its Grad branch (:503-527) is never reached: its nodes collide as fluid
#: nodes, in both engines.
OUTFLOW_TYPES = FIX_TYPES + (nt.NTGuoDensity, nt.NTExtendedCopy,
                             nt.NTGradFreeflow)

#: Node types whose prescribed scalar (``NodeMaps.param_scalar``) the BC
#: reads: the Neumann gradient and the laminarization strength alpha.
SCALAR_TYPES = (nt.NTNeumann, nt.NTLaminarize)

#: Node types this engine implements; a present type outside the set
#: raises at build time.
_IMPLEMENTED_TYPES = (
    nt._NTFluid, nt._NTGhost, nt._NTUnused, nt._NTPropagationOnly,
    nt.NTFullBBWall, nt.NTSlip) + LINK_TAG_TYPES + NATIVE_BC_TYPES \
    + OUTFLOW_TYPES


def global_coords(shape, device=None):
    """Global coordinate tensors (hx, hy[, hz]), int32, of a spatial shape
    in array order (.., z, y, x): what space-dependent ``DynamicValue``
    callables receive (``sailfish_tpu/ops/step.py:51-56``)."""
    grids = np.meshgrid(*[np.arange(n) for n in shape], indexing='ij')
    return tuple(torch.as_tensor(grids[len(shape) - 1 - a], dtype=torch.int32,
                                 device=device)
                 for a in range(len(shape)))


def map_coords(maps, device=None):
    """``global_coords`` of the nodes of ``maps``; for a shard's maps
    (``parallel/halo.shard_maps``, which keeps ``rows``, the global index
    of each plane along the outermost axis, and on a mesh of two axes
    ``cols``, along the next) the coordinates along those axes are the
    global ones."""
    coords = list(global_coords(maps.type_map.shape, device))
    dim = len(coords)
    for axis, index in enumerate((getattr(maps, 'rows', None),
                                  getattr(maps, 'cols', None))):
        if index is None:
            continue
        # coords run (x, y[, z]): spatial axis ``axis`` is coords[-1 - axis]
        shape = [1] * dim
        shape[axis] = -1
        glob = torch.as_tensor(np.asarray(index), dtype=torch.int32,
                               device=device).reshape(shape)
        coords[dim - 1 - axis] = torch.broadcast_to(
            glob, coords[dim - 1 - axis].shape).contiguous()
    return tuple(coords)


def time_of(it, dtype, time_unit, device=None):
    """t = it * time_unit as a 0-d tensor of ``dtype``, rounded as the
    JAX engine's ``jnp.asarray(it, dtype) * time_unit``."""
    return torch.tensor(it, dtype=dtype, device=device) * time_unit


def dynamic_values(exprs, t, coords, shape, dtype, device=None):
    """The components of a ``DynamicValue`` evaluated at time ``t`` (and,
    for space-dependent ones, at ``coords``), each cast to ``dtype`` and
    broadcast to ``shape``."""
    return [torch.broadcast_to(
        torch.as_tensor(nt.DynamicValue.evaluate(e, t, coords), dtype=dtype,
                        device=device), shape) for e in exprs]


def is_space_dependent(exprs):
    """Whether any component takes coordinates (arity above 1)."""
    return any(nt.DynamicValue.arity(e) > 1 for e in exprs)


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


def tag_planes(grid, link_tags, device=None):
    """(Q, *S) bool planes of a node-type map's ``link_tags`` words: plane
    i marks the nodes whose incoming f_i is missing (bit 0 is unused)."""
    t = torch.as_tensor(link_tags, dtype=torch.int32, device=device)
    return torch.stack([((t >> i) & 1).bool() for i in range(grid.Q)])


def equilibrium_fn(grid, incompressible=False, equilibrium='bgk',
                   gravity=0.0):
    """The model's equilibrium as a function feq(rho, u) -> (Q, *S)
    (``StepBuilder.feq`` of ``sailfish_tpu/ops/step.py:352-364``): the
    second-order one (incompressible or not), with ``equilibrium``
    'elbm' the product form (``entropic.elbm_equilibrium``, which has no
    incompressible variant), or with 'shallow_water' the D2Q9
    shallow-water one at ``gravity``."""
    if equilibrium == 'elbm':
        return functools.partial(ent.elbm_equilibrium, grid)
    if equilibrium == 'shallow_water':
        return functools.partial(eq.shallow_water_equilibrium, grid,
                                 gravity=gravity)
    return functools.partial(eq.bgk_equilibrium, grid,
                             incompressible=incompressible)


def fix_missing(grid, fs, f, tags=None, tms=None, feq=None, instances=(),
                ext_gathers=(), lam_means=None):
    """Replace the distributions whose pull source is not wet
    (``sailfish_tpu/ops/step.py:436-561``). Tagged links (``tags``, the
    (Q, *S) planes of ``tag_planes``, or None) take f_opp, the node's own
    post-collision value: half-way bounce-back. At the TMS nodes (``tms``,
    a node mask, or None) the target macros are then taken from the
    bounce-filled distributions and the tagged links set to their
    equilibrium ``feq`` (``equilibrium_fn``; default the compressible
    second-order one). Then the extended copies (``ext_gathers``, from
    ``extended_copy_gathers``) and the instances of ``FIX_TYPES`` among
    ``instances`` (``fix_outflow``, with ``lam_means``). Returns (fs,
    target): target is (rho, u) of the TMS nodes, None without them."""
    target = None
    if tags is not None:
        opp = torch.as_tensor(grid.opposite, dtype=torch.long,
                              device=fs.device)
        fs = torch.where(tags, f[opp], fs)
    if tms is not None:
        target = eq.macroscopic(grid, fs)
        feq_tg = (feq or equilibrium_fn(grid))(*target)
        fs = torch.where(tms[None] & tags, feq_tg, fs)
    if ext_gathers:
        flat = fs.reshape(grid.Q, -1).clone()
        f_flat = f.reshape(grid.Q, -1)
        for d, d2, dst, src in ext_gathers:
            flat[d, dst] = f_flat[d2, src]
        fs = flat.reshape(fs.shape)
    return fix_outflow(grid, fs, f, instances, lam_means), target


def fix_outflow(grid, fs, f, instances, lam_means=None):
    """The outflow BCs of ``FIX_TYPES`` among ``instances`` ((cls,
    orientation, mask, scalar, vel_bc); ``scalar`` the (*S) field of the
    Neumann gradient or the laminarization alpha), in their order
    (``sailfish_tpu/ops/step.py:466-561``). Every sample reads the
    post-collision state ``f`` at x + v, wrapping periodically; the unknown
    directions i (c_i . n > 0, n the inward normal) take
      NTDoNothing   f_i(x)
      NTCopy        f_i(x + n - c_i)                  (fs_i(x + n))
      NTYuOutflow   2 f_i(x + n - c_i) - f_i(x + 2n - c_i)
      NTNeumann     f_opp(x + c_i) + 6 w_i c_i . phi,
                    phi = u(f(x + 2n)) + 2 gradient n
    and ``NTLaminarize`` blends all Q distributions towards their mean over
    the instance's nodes in each plane normal to n, (1 - alpha) fs + alpha
    mean (the count floored at 1; ``plane_means``, or ``lam_means[k]`` for
    the instance of orientation k when given: the means a sharded step
    computed over the whole mesh, laid out as ``plane_means`` lays
    them)."""
    for cls, k, mask, scalar, _vel in instances:
        if cls not in FIX_TYPES:
            continue
        n = np.asarray(grid.orientation_vectors[k - 1])
        unknown = grid.unknown_mask(n)
        if cls is nt.NTLaminarize:
            mean = lam_means[k] if lam_means and k in lam_means \
                else plane_means(fs, mask, (k - 1) // 2)
            blended = (1.0 - scalar) * fs + scalar * mean
            fs = torch.where(mask[None], blended, fs)
            continue
        if cls is nt.NTNeumann:
            f2n = torch.stack([sample(f[i], 2 * n) for i in range(grid.Q)])
            _rho2, u2 = eq.macroscopic(grid, f2n)
            phi = [u2[a] + 2.0 * scalar * int(n[a]) for a in range(grid.dim)]
        upd = []
        for i in range(grid.Q):
            if not unknown[i]:
                upd.append(fs[i])
                continue
            c = grid.basis[i]
            if cls is nt.NTDoNothing:
                val = f[i]
            elif cls is nt.NTCopy:
                val = sample(f[i], n - c)
            elif cls is nt.NTYuOutflow:
                val = 2.0 * sample(f[i], n - c) - sample(f[i], 2 * n - c)
            else:
                o = int(grid.opposite[i])
                cphi = sum(float(c[a]) * phi[a] for a in range(grid.dim))
                val = sample(f[o], c) + 6.0 * float(grid.weights[i]) * cphi
            upd.append(torch.where(mask, val, fs[i]))
        fs = torch.stack(upd)
    return fs


def plane_entries(mask, naxis):
    """The planes normal to the axis ``naxis`` (0 = x) of the nodes of
    ``mask`` (*S, a bool array or tensor): (lo, counts, nodes) with ``lo``
    the lowest coordinate along the axis that holds a node, ``counts`` the
    nodes in each plane from ``lo`` to the highest, and ``nodes`` their
    flat indices (int64 numpy), plane by plane, ascending within a plane;
    (0, [], empty) without a node."""
    m = mask.cpu().numpy() if torch.is_tensor(mask) else np.asarray(mask)
    flat = np.flatnonzero(m)
    if flat.size == 0:
        return 0, [], flat.astype(np.int64)
    coord = np.unravel_index(flat, m.shape)[m.ndim - 1 - naxis]
    lo, hi = int(coord.min()), int(coord.max())
    order = np.argsort(coord, kind='stable')
    counts = np.bincount(coord - lo, minlength=hi - lo + 1)
    return lo, [int(c) for c in counts], flat[order].astype(np.int64)


def entry_means(vals, counts):
    """(entries, Q) means of the (Q, sum(counts)) values ``vals`` of the
    entries' nodes, entry by entry: each entry's (Q, count) block summed
    by ``torch.sum`` over a contiguous copy, divided by the count floored
    at 1. The same values in the same order give the same bits, so a
    sharded step that gathers them from its shards
    (``parallel/halo.MeshLaminarize``) gets the unsharded means."""
    out, pos = [], 0
    for count in counts:
        block = vals[:, pos:pos + count].contiguous()
        out.append(torch.sum(block, dim=1) / float(max(count, 1)))
        pos += count
    return torch.stack(out) if out else vals.new_zeros((0, vals.shape[0]))


def spread_means(means, lo, shape, naxis):
    """The (entries, Q) ``means`` of the planes ``lo``, ``lo`` + 1, ...
    normal to the axis ``naxis`` as a (Q, *S)-broadcastable tensor over a
    domain of the spatial ``shape``: extent ``shape`` along that axis, 1
    along the others, 0 at the planes without an entry."""
    arr_axis = len(shape) - 1 - naxis
    out_shape = [means.shape[1]] + [1] * len(shape)
    out_shape[1 + arr_axis] = shape[arr_axis]
    out = means.new_zeros((shape[arr_axis], means.shape[1]))
    out[lo:lo + means.shape[0]] = means
    return out.T.reshape(out_shape)


def plane_means(fs, mask, naxis):
    """The mean of the distributions ``fs`` (Q, *S) over the nodes of
    ``mask`` (*S) in each plane normal to the axis ``naxis`` (0 = x), the
    count floored at 1 (``sailfish_tpu/ops/step.py:548-558``): (Q, *S)
    with extent 1 along every other axis (``spread_means``). Each plane's
    sum runs over its nodes' values gathered in flat order
    (``plane_entries``, ``entry_means``), so it does not depend on the
    extent of the domain around them."""
    lo, counts, nodes = plane_entries(mask, naxis)
    q = fs.shape[0]
    vals = fs.reshape(q, -1)[:, torch.as_tensor(nodes, device=fs.device)]
    return spread_means(entry_means(vals, counts), lo, fs.shape[1:], naxis)


def extended_copy_gathers(grid, maps, device=None):
    """The static gathers of every ``NTExtendedCopy`` instance
    (``sailfish_tpu/ops/step.py:274-330``): (d, d2, dst, src), each missing
    direction d of a node x read from f_{d2}(T x - c_{d2}), d2 the image of
    d under the rotation part of the node's 4x4 affine map T, periodic wrap;
    dst and src flat node indices (long tensors on ``device``)."""
    shape = maps.type_map.shape
    dim = grid.dim
    coords = np.meshgrid(*[np.arange(s) for s in shape], indexing='ij')
    coords = [coords[dim - 1 - a] for a in range(dim)]

    def rotate_dist(i, rot):
        c = np.zeros(3)
        c[:dim] = grid.basis[i][:dim]
        t = np.rint(rot @ c).astype(int)
        for j in range(grid.Q):
            cj = np.zeros(3, dtype=int)
            cj[:dim] = grid.basis[j][:dim]
            if np.array_equal(cj, t):
                return j
        raise ValueError(
            'NTExtendedCopy transformation does not map lattice vector '
            f'{grid.basis[i]} onto the lattice')

    gathers = []
    for mask, T in maps.extended:
        T = np.asarray(T, dtype=np.float64)
        sel_all = mask & (maps.type_map == nt.NTExtendedCopy.id)
        for k in np.unique(maps.orientation[sel_all]):
            if k == 0:
                continue
            sel = sel_all & (maps.orientation == int(k))
            if not sel.any():
                continue
            unknown = grid.unknown_mask(grid.orientation_vectors[int(k) - 1])
            idx = np.nonzero(sel)
            dst = np.ravel_multi_index(idx, shape)
            pos = np.zeros((4, dst.size))
            for a in range(dim):
                pos[a] = coords[a][idx]
            pos[3] = 1.0
            src_xyz = np.rint(T @ pos)[:dim].astype(np.int64)
            for d in range(grid.Q):
                if not unknown[d]:
                    continue
                d2 = rotate_dist(d, T[:3, :3])
                src = [(src_xyz[a] - int(grid.basis[d2][a]))
                       % shape[len(shape) - 1 - a] for a in range(dim)]
                gathers.append((d, d2, torch.as_tensor(dst, device=device),
                                torch.as_tensor(np.ravel_multi_index(
                                    tuple(reversed(src)), shape),
                                    device=device)))
    return gathers


def guo_density_overlay(grid, fs, fpost, instances, tau_inv, feq=None):
    """Guo's extrapolation density BC (``sailfish_tpu/ops/step.py
    :783-807``): each ``NTGuoDensity`` node x of ``instances`` stores
    feq(rho_bc, u_B) + (1 - 1/tau)(fs(B) - feq(rho_B, u_B)) in place of its
    relaxed values, B = x + n, with rho_B, u_B the moments of ``fs`` (the
    fixed post-stream distributions) at B and ``feq`` the model's
    equilibrium."""
    feq = feq or equilibrium_fn(grid)
    for cls, k, mask, rho_bc, _vel in instances:
        if cls is not nt.NTGuoDensity:
            continue
        fs_b = sample(fs, grid.orientation_vectors[k - 1])
        rho_b, u_b = eq.macroscopic(grid, fs_b)
        val = feq(rho_bc, u_b) + (1.0 - tau_inv) * (fs_b - feq(rho_b, u_b))
        fpost = torch.where(mask[None], val, fpost)
    return fpost


def apply_tms(grid, fpost, rho, u, tms, target, feq=None):
    """The post-collision part of the TMS wall
    (``sailfish_tpu/ops/step.py:772-781``): TMS nodes add feq(target) -
    feq(rho, u) to their relaxed distributions."""
    if tms is None:
        return fpost
    feq = feq or equilibrium_fn(grid)
    corr = feq(*target) - feq(rho, u)
    return torch.where(tms[None], fpost + corr, fpost)


def solve_macro_bc(grid, instances, fs, rho, u):
    """Per-instance macroscopic overrides (Zou & He solves;
    ``sailfish_tpu/ops/step.py:584-617``; a Guo density node's rho is its
    prescribed one). ``instances``: list of (cls, orientation, mask, rho_bc,
    vel_bc) with disjoint masks; ``rho_bc`` of ``SCALAR_TYPES`` is their
    scalar."""
    fl = [fs[i] for i in range(grid.Q)]
    for cls, k, mask, rho_bc, vel_bc in instances:
        if cls is nt.NTGuoDensity:
            # no solve: the node's values are the post-collision overlay
            # (guo_density_overlay); rho is pinned for output
            rho = torch.where(mask, rho_bc, rho)
            continue
        if cls not in NATIVE_BC_TYPES:
            continue
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


def pre_collision_bc(grid, instances, fs, rho, u, incompressible=False,
                     feq=None):
    """Distribution reconstruction at BC nodes
    (``sailfish_tpu/ops/step.py:632-670``) with the model's equilibrium
    ``feq`` (default ``equilibrium_fn(grid, incompressible)``). The
    regularized reconstruction adds its stress term to the second-order
    equilibrium whatever the model's, as the JAX engine's
    ``regularized_f`` does."""
    feq = feq or equilibrium_fn(grid, incompressible)
    for cls, k, mask, _rho_bc, _vel_bc in instances:
        if cls not in NATIVE_BC_TYPES:
            continue
        n = grid.orientation_vectors[k - 1]
        unknown = grid.unknown_mask(n)
        f_eq = feq(rho, u)
        if cls in (nt.NTEquilibriumVelocity, nt.NTEquilibriumDensity):
            fs = torch.where(mask[None], f_eq, fs)
        elif cls in (nt.NTZouHeVelocity, nt.NTZouHeDensity):
            fz = _noneq_bb(grid, fs, f_eq, unknown)
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
            fnb = _noneq_bb(grid, fs, f_eq, unknown)
            pi = eq.second_moment_noneq(grid, fnb, f_eq)
            freg = eq.regularized_f(grid, rho, u, pi,
                                    incompressible=incompressible)
            fs = torch.where(mask[None], freg, fs)
    return fs


def bounce_back(grid, fs, fpost, fullbb, slip=()):
    """Dry-node walls (``sailfish_tpu/ops/step.py:753-770``): full
    bounce-back nodes store the arriving distributions reflected, slip
    nodes store them with the velocity component along their normal
    reversed (``grid.slip_swap``). ``fullbb`` is a boolean node map, or
    None when no such wall is present; ``slip`` a sequence of (axis, node
    mask), one per normal axis."""
    if fullbb is not None:
        opp = torch.as_tensor(grid.opposite, dtype=torch.long,
                              device=fs.device)
        fpost = torch.where(fullbb[None], fs[opp], fpost)
    for axis, mask in slip:
        perm = torch.as_tensor(grid.slip_swap(axis), dtype=torch.long,
                               device=fs.device)
        fpost = torch.where(mask[None], fs[perm], fpost)
    return fpost


def select_dry(grid, fs, fpost, wet, fullbb, slip=()):
    """The dry/keep select of ``sailfish_tpu/ops/step.py:819-822``: dry
    nodes keep their post-stream values ``fs``, full bounce-back and slip
    walls store them reflected (``bounce_back``). ``wet`` is a boolean
    node map, or None when every node is wet."""
    if wet is not None:
        fpost = torch.where(wet[None], fpost, fs)
    return bounce_back(grid, fs, fpost, fullbb, slip)


FORCE_MODELS = ('guo', 'edm', 'velocity_shift')


class Entropic:
    """The entropic collision's settings: the base relaxation time ``tau``
    (beta = 1 / (2 tau)), the Newton stops ``entropy_tol`` and
    ``alpha_tol``; ``last_alpha`` holds the alpha field of the last
    collision made with them (``sailfish_tpu/ops/step.py:726-735``)."""

    def __init__(self, tau, entropy_tol=1e-6, alpha_tol=1e-10):
        self.tau = float(tau)
        self.entropy_tol = float(entropy_tol)
        self.alpha_tol = float(alpha_tol)
        self.last_alpha = None
        #: with ``record_branches`` set, ``last_branch`` holds the dispatch
        #: branch of each node of the last collision
        #: (``entropic.branches``) and ``last_dev`` the deviation it was
        #: taken on (``entropic.deviation``)
        self.record_branches = False
        self.last_branch = None
        self.last_dev = None


def is_dynamic_force(body_force):
    """Whether ``body_force`` holds time or space callables (a
    ``DynamicValue``, or a sequence with a callable component)."""
    return isinstance(body_force, nt.DynamicValue) \
        or any(callable(c) for c in tuple(body_force))


def forced_collide(grid, fs, rho, u, tau_inv, force=None, force_model='guo',
                   u_eq=None, incompressible=False, rates=None,
                   smagorinsky=0.0, feq=None, sc_coupling=0.0,
                   sc_potential='linear', sc_rho=None, elbm=None, skip=None):
    """The collision under the body force ``force`` (an acceleration,
    (dim, *S) or broadcastable; None: no force), ``_collide`` of
    ``sailfish_tpu/ops/step.py:690-751``. ``guo`` relaxes towards
    feq(rho, u_eq + a/2) and adds the Guo term; ``velocity_shift`` relaxes
    towards feq(rho, u_eq + tau a) and adds nothing; ``edm`` relaxes
    towards feq(rho, u_eq) and adds feq(rho, u + a) - feq(rho, u) with
    the bare ``u``. ``u_eq`` (default ``u``) is the equilibrium velocity a
    multi-component coupling has shifted already.

    With ``sc_coupling`` G != 0 the single-component Shan-Chen force
    F = -G psi(rho) sum_i w_i c_i psi(sc_rho(x + c_i)) shifts u_eq by
    tau F / rho before the body force's shift (:705-721); ``sc_rho`` is the
    density the neighbours' psi is taken from (default ``rho``; the
    kernel's plain version passes the pre-pass density).

    The relaxation: MRT (``mrt_collide``) with the rate vector ``rates``
    when it is given, else BGK towards ``feq`` (``equilibrium_fn``; default
    the second-order one of ``incompressible``) at 1/tau = ``tau_inv``, or
    with ``smagorinsky`` > 0 at the local Smagorinsky rate, whose strain
    comes from feq(rho, u) at the unshifted velocity. The LES field sets
    only the BGK relaxation: the Guo prefactor and the velocity shift keep
    the base tau, and MRT ignores the field, as in the JAX engine.

    With ``elbm`` (an ``Entropic``) the relaxation is the entropic one,
    ``entropic.elbm_collide`` towards the product form at u_eq with the
    base tau, whatever ``feq``, ``incompressible`` and ``smagorinsky``
    say; the force's term follows as under BGK, and the alpha field goes
    to ``elbm.last_alpha``. ``skip``: the nodes whose result the caller
    discards (dry nodes), kept out of the Newton solve's convergence
    test."""
    feq = feq or equilibrium_fn(grid, incompressible)
    tau_eff = tau_inv
    if smagorinsky > 0.0 and rates is None and elbm is None:
        tau_eff = co.smagorinsky_tau_inv(grid, fs, feq(rho, u), rho,
                                         1.0 / tau_inv, smagorinsky)[None]
    if u_eq is None:
        u_eq = u
    if sc_coupling != 0.0:
        F = co.shan_chen_force(grid, rho, rho if sc_rho is None else sc_rho,
                               sc_coupling, sc_potential)
        u_eq = u_eq + (1.0 / tau_inv) * F / rho[None]
    if force is not None:
        if force_model == 'guo':
            u_eq = u_eq + 0.5 * force
        elif force_model == 'velocity_shift':
            u_eq = u_eq + (1.0 / tau_inv) * force
    if rates is not None:
        fpost = co.mrt_collide(grid, fs, rho, u_eq, rates,
                               incompressible=incompressible)
    elif elbm is not None:
        fpost, elbm.last_alpha = ent.elbm_collide(
            grid, fs, rho, u_eq, elbm.tau, skip=skip,
            entropy_tol=elbm.entropy_tol, alpha_tol=elbm.alpha_tol)
        if elbm.record_branches:
            fneq = ent.elbm_equilibrium(grid, rho, u_eq) - fs
            elbm.last_dev = ent.deviation(grid, fs, fneq)
            elbm.last_branch = ent.branches(grid, fs, fneq)
    else:
        fpost = fs + tau_eff * (feq(rho, u_eq) - fs)
    if force is not None:
        if force_model == 'guo':
            fpost = fpost + co.guo_force_terms(grid, u_eq, force, tau_inv,
                                               rho)
        elif force_model == 'edm':
            fpost = fpost + co.edm_shift(grid, rho, u, force,
                                         incompressible=incompressible)
    return fpost


def step_phases(grid, fs, f, tau_inv, instances=(), *, wet=None,
                fullbb=None, slip=(), tags=None, tms=None, force=None,
                force_model='guo', incompressible=False, rates=None,
                smagorinsky=0.0, feq=None, sc_coupling=0.0,
                sc_potential='linear', sc_rho=None, elbm=None,
                ext_gathers=(), lam_means=None):
    """One step after the gather, in the JAX order
    (``sailfish_tpu/ops/step.py:809-825``): fix missing (with the outflow
    family and the extended copies ``ext_gathers``) -> macro -> BC solves
    -> pre-collision BC -> ``forced_collide`` on every node (BC
    nodes with their solved rho and u; the collision model of ``rates``
    and ``smagorinsky`` or the entropic one of ``elbm``, the equilibrium
    ``feq`` and the Shan-Chen shift of ``sc_coupling``) -> dry select and
    dry walls -> the TMS shift -> the Guo density overlay.
    ``fs``: the gathered distributions; ``f``: the state they were pulled
    from; ``instances``: (cls, orientation, mask, rho_bc, vel_bc) with the
    parameters of this step (of ``SCALAR_TYPES``: the scalar in place of
    rho_bc); ``lam_means``: the laminarize plane means of a sharded step
    (``fix_outflow``), None to compute them here."""
    feq = feq or equilibrium_fn(grid, incompressible)
    streamed = stream_phase(grid, fs, f, instances, tags=tags, tms=tms,
                            feq=feq, ext_gathers=ext_gathers,
                            lam_means=lam_means)
    return collide_phase(
        grid, streamed, tau_inv, instances, wet=wet, fullbb=fullbb,
        slip=slip, tms=tms, force=force, force_model=force_model,
        incompressible=incompressible, rates=rates, smagorinsky=smagorinsky,
        feq=feq, sc_coupling=sc_coupling, sc_potential=sc_potential,
        sc_rho=sc_rho, elbm=elbm)


def stream_phase(grid, fs, f, instances=(), *, tags=None, tms=None,
                 feq=None, ext_gathers=(), lam_means=None):
    """The first phase of ``step_phases``: fix missing, then the macroscopic
    fields and the BC solves. Returns (fs, target, rho, u): the fixed
    post-stream distributions, the TMS target, and the post-stream density
    and velocity, the density being what the Shan-Chen force samples at
    the neighbours (a sharded step exchanges it before ``collide_phase``)."""
    fs, target = fix_missing(grid, fs, f, tags, tms, feq, instances,
                             ext_gathers, lam_means)
    rho, u = eq.macroscopic(grid, fs)
    rho, u = solve_macro_bc(grid, instances, fs, rho, u)
    return fs, target, rho, u


def collide_phase(grid, streamed, tau_inv, instances=(), *, wet=None,
                  fullbb=None, slip=(), tms=None, force=None,
                  force_model='guo', incompressible=False, rates=None,
                  smagorinsky=0.0, feq=None, sc_coupling=0.0,
                  sc_potential='linear', sc_rho=None, elbm=None):
    """The second phase of ``step_phases`` from ``stream_phase``'s result
    ``streamed``: pre-collision BC, collision, dry select, TMS shift and
    the Guo density overlay."""
    fs, target, rho, u = streamed
    fs2 = pre_collision_bc(grid, instances, fs, rho, u, incompressible, feq)
    fpost = forced_collide(grid, fs2, rho, u, tau_inv, force, force_model,
                           incompressible=incompressible, rates=rates,
                           smagorinsky=smagorinsky, feq=feq,
                           sc_coupling=sc_coupling,
                           sc_potential=sc_potential, sc_rho=sc_rho,
                           elbm=elbm, skip=None if wet is None else ~wet)
    fpost = select_dry(grid, fs2, fpost, wet, fullbb, slip)
    fpost = apply_tms(grid, fpost, rho, u, tms, target, feq)
    return guo_density_overlay(grid, fs, fpost, instances, tau_inv, feq)


#: collision models of the torch engine (``--model``)
MODELS = ('bgk', 'mrt', 'trt', 'elbm')
#: equilibria of the torch engine ('elbm': the product form)
EQUILIBRIA = ('bgk', 'elbm', 'shallow_water')


class StepBuilder:
    """Builds the single-device step function for a single-fluid model
    (the torch engine). Parameters mirror the JAX builder's;
    ``time_unit`` is ``--dt_per_lattice_time_unit``. ``model`` 'mrt' and
    'trt' keep the rate vector ``mrt_rates``
    (``sailfish_tpu/ops/step.py:271-272``: the same for both);
    ``smagorinsky`` > 0 is the LES constant; ``sc_coupling`` G != 0 (with
    ``sc_potential``) the single-component Shan-Chen force;
    ``equilibrium`` 'shallow_water' the D2Q9 shallow-water equilibrium at
    ``gravity`` (rho is the water height), 'elbm' the product form.
    ``model`` 'elbm' is the entropic collision (``elbm``, an ``Entropic``)
    with the Newton stops ``entropy_tolerance`` (0.0: 1e-6 in fp32, 1e-10
    in fp64) and ``alpha_tolerance``; it ignores ``smagorinsky`` and, in
    its relaxation, ``incompressible`` and ``equilibrium``, as the JAX
    engine does. ``storage`` 'int16' keeps the
    state on the int16 grid of ``ops/mixed.MixedScales`` at ``mixed_range``
    (default ``DEFAULT_RANGE``)."""

    def __init__(self, grid, maps, *, model='bgk', visc=None, tau=None,
                 incompressible=False, smagorinsky=0.0, body_force=None,
                 force_model='guo', sc_coupling=0.0, sc_potential='linear',
                 equilibrium='bgk', gravity=0.0, dtype=torch.float32,
                 device='cpu', storage='fp', mixed_range=None,
                 entropy_tolerance=0.0, alpha_tolerance=1e-10,
                 time_unit=1.0):
        if force_model not in FORCE_MODELS:
            raise ValueError(
                f'force_model must be guo, edm or velocity_shift; '
                f'got {force_model!r}')
        if sc_potential not in co.SHAN_CHEN_POTENTIALS:
            raise ValueError(f'sc_potential must be linear or classic; '
                             f'got {sc_potential!r}')
        unported = []
        if model not in MODELS:
            unported.append(f'model={model}')
        if equilibrium not in EQUILIBRIA:
            unported.append(f'equilibrium={equilibrium}')
        if unported:
            raise NotImplementedError(
                'not ported to the torch engine yet: ' + ', '.join(unported))
        if storage not in ('fp', 'int16'):
            raise ValueError(f"storage must be 'fp' or 'int16'; got "
                             f'{storage!r}')
        if equilibrium == 'shallow_water' and grid.name != 'D2Q9':
            raise NotImplementedError(
                'the shallow-water equilibrium is defined on D2Q9 only; '
                f'got {grid.name}')
        self.sc_coupling = float(sc_coupling)
        self.sc_potential = sc_potential
        self.equilibrium = equilibrium
        self.gravity = float(gravity)
        self.grid = grid
        self.maps = maps
        self.tau = float(tau if tau is not None
                         else grid.relaxation_time(visc))
        self.tau_inv = 1.0 / self.tau
        self.model = model
        self.mrt_rates = (grid.mrt_relaxation_rates(self.tau)
                          if model in ('mrt', 'trt') else None)
        self.smagorinsky = float(smagorinsky)
        # the ELBM Newton stops (--entropy_tolerance, --alpha_tolerance;
        # 0.0 selects the precision's default, sailfish_tpu/ops/step.py
        # :93-98)
        self.entropy_tolerance = float(entropy_tolerance) \
            if entropy_tolerance > 0.0 else \
            (1e-6 if dtype == torch.float32 else 1e-10)
        self.alpha_tolerance = float(alpha_tolerance)
        #: the entropic collision's settings under model 'elbm', else None
        self.elbm = (Entropic(self.tau, self.entropy_tolerance,
                              self.alpha_tolerance)
                     if model == 'elbm' else None)
        self.incompressible = incompressible
        self._feq = equilibrium_fn(grid, incompressible, equilibrium,
                                   self.gravity)
        self.dtype = dtype
        self.device = torch.device(device)
        self.time_unit = float(time_unit)
        #: the laminarize rows' plane means that a sharded step computed
        #: over the whole mesh ({orientation: (Q, ...) tensor}, as
        #: ``plane_means`` lays them out over this builder's maps), read by
        #: its next phases in their place; None: computed from the maps
        self.lam_means = None
        # 16-bit fixed-point distribution storage (--precision=mixed;
        # ops/mixed.py): the math stays fp32 and the step passes its
        # result through the int16 grid (``build``); the refusals and
        # their reasons are the JAX engine's
        # (sailfish_tpu/ops/step.py:128-144)
        self.storage = storage
        #: the ``MixedScales`` of int16 storage, else None
        self.mixed = None
        if storage == 'int16':
            if dtype != torch.float32:
                raise NotImplementedError(
                    'mixed 16-bit storage requires fp32 compute')
            if self.sc_coupling != 0.0:
                raise NotImplementedError(
                    'mixed 16-bit storage does not cover Shan-Chen '
                    '(phase separation drives O(1) density deviations '
                    'past any useful fixed-point range)')
            if equilibrium != 'bgk':
                raise NotImplementedError(
                    'mixed 16-bit storage covers the standard '
                    f'equilibrium only (got {equilibrium})')
            self.mixed = MixedScales(
                grid, DEFAULT_RANGE if mixed_range is None else mixed_range)
        #: the body force as given (an acceleration: a (dim,) vector, a
        #: (dim, *S) field or a DynamicValue) and either ``force``, the
        #: same baked for the device ((dim, 1, ..., 1) or (dim, *S)), or
        #: ``force_expr``, the components of a DynamicValue force,
        #: evaluated each step by ``force_at``
        self.body_force = body_force
        self.force_model = force_model
        self.force = None
        self.force_expr = None
        if body_force is not None and is_dynamic_force(body_force):
            self.force_expr = tuple(body_force)
            if len(self.force_expr) != grid.dim:
                raise ValueError(f'body force needs {grid.dim} components; '
                                 f'got {len(self.force_expr)}')
        elif body_force is not None:
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
        tagged = [c.id for c in LINK_TAG_TYPES if c.id in present]
        self.tags = (tag_planes(self.grid, m.link_tags, self.device)
                     if tagged else None)
        self.tms = (dev(tm == nt.NTWallTMS.id)
                    if nt.NTWallTMS.id in present else None)
        # slip walls: one mask per normal axis; orientation 0 (undetected)
        # nodes keep their streamed values, as in the JAX engine
        self.slip = []
        if nt.NTSlip.id in present:
            sel = tm == nt.NTSlip.id
            axes = sorted({(int(k) - 1) // 2
                           for k in np.unique(m.orientation[sel]) if k})
            for axis in axes:
                ks = (2 * axis + 1, 2 * axis + 2)
                self.slip.append(
                    (axis, dev(sel & np.isin(m.orientation, ks))))
        self.rho_bc = dev(m.param_rho, self.dtype)
        self.vel_bc = dev(m.param_vel, self.dtype)
        #: the scalar parameter field (the Neumann gradient, the
        #: laminarization alpha) when such a node is present, else None
        self.scalar = (dev(m.param_scalar, self.dtype)
                       if any(nt.get_node_type(t) in SCALAR_TYPES
                              for t in present) else None)
        # (type, orientation, mask) instances of the native BCs and the
        # outflow family, in the JAX engine's order (present types, then
        # orientations; a type without needs_orientation -- NTGradFreeflow
        # -- is left out, :160-170); orientation 0 (undetected) nodes get
        # no BC, as in the JAX engine
        self.bc_instances = []
        for tid in present:
            cls = nt.get_node_type(tid)
            if cls not in NATIVE_BC_TYPES + OUTFLOW_TYPES \
                    or not cls.needs_orientation:
                continue
            sel = tm == tid
            for k in np.unique(m.orientation[sel]):
                if k == 0:
                    continue
                mask = sel & (m.orientation == int(k))
                self.bc_instances.append((cls, int(k), dev(mask)))
        #: the static gathers of the NTExtendedCopy nodes (whole-domain
        #: builders only, as in the JAX engine)
        self.ext_gathers = extended_copy_gathers(self.grid, m, self.device) \
            if getattr(m, 'extended', None) else []
        #: DynamicValue BC parameters: (node mask, parameter name, exprs)
        self.dynamic = [(dev(mask), name, exprs)
                        for mask, name, exprs in m.dynamic]
        exprs = [e for _, _, ex in m.dynamic for e in ex]
        self.coords = (map_coords(m, self.device)
                       if is_space_dependent(exprs + list(
                           self.force_expr or ())) else ())

    # -- time-dependent values ------------------------------------------------

    def time(self, it):
        """t of iteration ``it``, a 0-d tensor on the StepBuilder's device."""
        return time_of(it, self.dtype, self.time_unit, self.device)

    def bc_params(self, it=0):
        """(rho_bc, vel_bc) fields at iteration ``it``: the static
        parameters with every DynamicValue evaluated over its nodes
        (``sailfish_tpu/ops/step.py:563-582``)."""
        rho_bc, vel_bc = self.rho_bc, self.vel_bc
        if not self.dynamic:
            return rho_bc, vel_bc
        t = self.time(it)
        for mask, name, exprs in self.dynamic:
            vals = dynamic_values(exprs, t, self.coords, mask.shape,
                                  self.dtype, self.device)
            if name == 'velocity':
                vel_bc = torch.where(mask[None], torch.stack(vals), vel_bc)
            elif name == 'density':
                rho_bc = torch.where(mask, vals[0], rho_bc)
        return rho_bc, vel_bc

    def instances_at(self, it=0):
        """The BC instances with their parameters at iteration ``it``."""
        rho_bc, vel_bc = self.bc_params(it)
        return [(cls, k, mask,
                 self.scalar if cls in SCALAR_TYPES else rho_bc, vel_bc)
                for cls, k, mask in self.bc_instances]

    def force_at(self, it=0):
        """The body force at iteration ``it``: the baked constant or field,
        or the DynamicValue evaluated (``sailfish_tpu/ops/step.py
        :672-688``): (dim, 1, ..., 1) when every component is uniform,
        else (dim, *S)."""
        if self.force_expr is None:
            return self.force
        shape = self.maps.type_map.shape
        vals = [torch.as_tensor(
            nt.DynamicValue.evaluate(e, self.time(it), self.coords),
            dtype=self.dtype, device=self.device) for e in self.force_expr]
        if any(v.dim() for v in vals):
            vals = [torch.broadcast_to(v, shape) for v in vals]
        else:
            vals = [v.reshape((1,) * len(shape)) for v in vals]
        return torch.stack(vals)

    # -- phases --------------------------------------------------------------

    def feq(self, rho, u):
        """The model's equilibrium (``equilibrium_fn``)."""
        return self._feq(rho, u)

    def gather(self, f):
        return gather(self.grid, f)

    def fix_missing(self, fs, f):
        """Replace distributions whose pull source was not wet: half-way
        bounce-back on tagged links, the TMS target equilibrium, then the
        extended copies and the outflow family (whose parameters are
        static)."""
        return fix_missing(self.grid, fs, f, self.tags, self.tms,
                           self._feq, [(cls, k, mask, self.scalar, None)
                                       for cls, k, mask in self.bc_instances
                                       if cls in FIX_TYPES],
                           self.ext_gathers, self.lam_means)[0]

    def phases(self, fs, f, it=0):
        """``step_phases`` with this builder's maps, and parameters and
        force at iteration ``it``: ``collide_phase`` of ``stream_phase``."""
        instances = self.instances_at(it)
        return self.collide_phase(
            self.stream_phase(f, it, fs, instances), it, instances=instances)

    def stream_phase(self, f, it=0, fs=None, instances=None):
        """The step's first phase on the state ``f`` at iteration ``it``
        (``fs``: its gathered distributions, default gathered here;
        ``instances``: ``instances_at(it)``, computed here by default):
        ``step.stream_phase``'s (fs, target, rho, u)."""
        return stream_phase(
            self.grid, self.gather(f) if fs is None else fs, f,
            self.instances_at(it) if instances is None else instances,
            tags=self.tags, tms=self.tms, feq=self._feq,
            ext_gathers=self.ext_gathers, lam_means=self.lam_means)

    def collide_phase(self, streamed, it=0, sc_rho=None, instances=None):
        """The step's second phase from ``stream_phase``'s ``streamed`` at
        iteration ``it``; ``sc_rho``: the density the Shan-Chen force
        samples at the neighbours (default ``streamed``'s own: a sharded
        step passes it with its ghost planes exchanged)."""
        return collide_phase(
            self.grid, streamed, self.tau_inv,
            self.instances_at(it) if instances is None else instances,
            wet=self.wet, fullbb=self.fullbb, slip=self.slip, tms=self.tms,
            force=self.force_at(it), force_model=self.force_model,
            incompressible=self.incompressible, rates=self.mrt_rates,
            smagorinsky=self.smagorinsky, feq=self._feq,
            sc_coupling=self.sc_coupling, sc_potential=self.sc_potential,
            sc_rho=sc_rho, elbm=self.elbm)

    @property
    def last_alpha(self):
        """The alpha field of the last entropic collision (None before
        one, or under another model)."""
        return None if self.elbm is None else self.elbm.last_alpha

    # -- per-phase pieces for the multi-component builders -----------------
    # (the names and semantics of ``sailfish_tpu/ops/step.py:584-770``)

    @property
    def has_dry(self):
        return self.wet is not None

    def _solve_macro_bc(self, fs, rho, u, it=0):
        return solve_macro_bc(self.grid, self.instances_at(it), fs, rho, u)

    def _pre_collision_bc(self, fs, rho, u):
        # the reconstruction reads no prescribed parameter
        return pre_collision_bc(
            self.grid, [(cls, k, mask, None, None)
                        for cls, k, mask in self.bc_instances],
            fs, rho, u, self.incompressible, self._feq)

    def _collide(self, fs, rho, u, u_eq=None):
        """``forced_collide`` with this builder's body force; ``u_eq``
        (default ``u``) is the shifted equilibrium velocity of the
        multi-component couplings, and the force's own shift is added to
        it."""
        return forced_collide(self.grid, fs, rho, u, self.tau_inv,
                              self.force, self.force_model, u_eq=u_eq,
                              incompressible=self.incompressible,
                              rates=self.mrt_rates,
                              smagorinsky=self.smagorinsky, feq=self._feq,
                              sc_coupling=self.sc_coupling,
                              sc_potential=self.sc_potential, elbm=self.elbm,
                              skip=None if self.wet is None else ~self.wet)

    def _post_collision(self, fs, fpost):
        return bounce_back(self.grid, fs, fpost, self.fullbb, self.slip)

    # -- public --------------------------------------------------------------

    def streamed(self, f):
        return self.fix_missing(self.gather(f), f)

    def macro_fields(self, f, it=0):
        """rho, u with BC overrides applied (output fields) at iteration
        ``it``; under a body force of any model u is the force-corrected
        u + a/2 (``sailfish_tpu/ops/step.py:834-843``); the Shan-Chen force
        is not added to it."""
        fs = self.streamed(f)
        rho, u = eq.macroscopic(self.grid, fs)
        rho, u = solve_macro_bc(self.grid, self.instances_at(it), fs, rho, u)
        force = self.force_at(it)
        if force is not None:
            u = u + 0.5 * force
        return rho, u

    def build(self):
        """step(f, it=0) -> f_next on post-collision states; ``it`` is the
        iteration the step computes (time-dependent values see it). With
        int16 storage the result passes through the int16 grid every step,
        ``dequant(quant(.))`` (``sailfish_tpu/ops/step.py:845-863``):
        ``quant(dequant(q)) == q``, so the fp32 state is equivalent to an
        int16 one."""

        def step(f, it=0):
            return self.phases(self.gather(f), f, it)

        if self.mixed is None:
            return step
        mx = self.mixed

        def step_mixed(f, it=0):
            return mx.snap(step(f, it))

        return step_mixed
