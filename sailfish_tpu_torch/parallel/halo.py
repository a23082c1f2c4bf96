"""Sharded stepping of single-fluid scenes: ghost planes and their
exchanges.

Port of the single-fluid part of ``sailfish_tpu/parallel/halo.py``
(``ShardedPallasStep3D`` :170, ``ShardedPallasStep2D`` :760). The domain is
split along its outermost axis (z in 3D, y in 2D) into equal slabs, one
per shard of the mesh. Each shard holds its slab with one ghost plane on
each side: a (Q, L + 2, ...) tensor whose planes 0 and L + 1 hold the
ring neighbours' boundary planes. The ring wraps, so the global periodic
streaming is the same as on one device (``halo.py:1-20``).

On a mesh of two axes (('z', 'y') in 3D, ('y', 'x') in 2D, ``--mesh=AxB``)
the slab is cut and padded along the next axis too: (Q, Lo + 2, Li + 2,
...), the shards in mesh order (the outer axis slowest), each axis a ring
of its own. The exchange then fills three kinds of region
(``region_directions``): the outer axis's ghost planes over the inner
axis's interior, the inner axis's ghost rows (3D) or columns (2D) over the
outer axis's interior, and the edges (3D) or corners (2D) where the two
cross, read directly from the diagonal neighbour (the JAX package forwards
them in two hops, :364-377, :763-771): the ``halo_edge_exchange`` mode of
the same kernel, one launch per device.

A step is the one-device pull step run on each padded slab, then the
exchange. The step of a slab is the scene's own (the torch engine's
``StepBuilder`` step, or one launch of the ``lbm_step`` kernel through
``ops/lbm_step.KernelStep``) on the slab's maps: the global node-type,
orientation, link-tag and BC-parameter maps cut to the slab's planes and
its ghost planes, so every BC face, varying box, dynamic row, wall and
force stays local to its shard, whichever shard boundary crosses it. The
step computes the ghost planes too, from wrapped neighbours: their output
is thrown away (overwritten by the exchange where the next step reads it,
and never read elsewhere). That is design (b) of the ghost-plane mode: no
kernel changes, 2 / L more node work (2 / Lo + 2 / Li on two axes). The
exchange then copies each
shard's first and last interior planes into its ring neighbours' ghost
planes, in the directions that cross the boundary (``crossing_directions``:
5 of 19 in D3Q19, 3 of 9 in D2Q9). On the kernel engine that is the
``halo_exchange`` kernel (``ops/csrc/halo.cu``): one launch per device,
each filling the ghost planes of the shards on its device on that device's
stream, reading a neighbour's plane on another GPU through peer access,
after CUDA events that order it behind the steps of its neighbours'
devices (``exchange_plan``). The torch engine, and the CPU, use the plain
version (``ShardedStep.exchange_reference``: PyTorch index copies,
``ghost_copy``).

Single-component Shan-Chen splits each shard's step in two (its
post-stream density pre-pass, then the step that reads psi of the density
one plane out): between them the density exchange copies the densities of
each shard's first and last interior planes into its neighbours' ghost
planes (``ShardedStep.density_exchange``; the same kernel on whole planes,
counted as ``halo_rho_exchange_<grid>``, ``halo_rho_edge_exchange_<grid>``
on two axes), the counterpart of JAX's
``stream_rho_edges`` (:51-107). The mixtures and the free-energy model
shard the same way in ``parallel/halo_multi.py``.

The outflow family (``ops/step.OUTFLOW_TYPES``) runs on the slab like any
other BC row, on both engines (the JAX package's patch planes and blocks,
``_compute_patch_padded`` :653, :823-887): a node of an outflow row reads
its neighbours along its inward normal from the state it pulls from, and
those reads stay in its slab's interior, or read across a sharded axis
only the directions the ghost planes carry (a tangential read x - c_i of
direction i, as the pull's). A row whose samples along the normal reach
past the slab's interior (a face inside the domain at a shard boundary, or
shards thinner than the reach: 1 plane for ``NTYuOutflow``, 2 for
``NTNeumann`` and ``NTGuoDensity``) is refused by name
(``outflow_reach_reasons``). The ghost planes' copies of outflow rows
sample through the slab's wrap, and their output is thrown away with the
rest of the ghost planes'; on a ring of one shard they are fluid nodes
(``shard_maps``' ``unwrap``). The laminarize plane mean is a reduction over a
plane that crosses shards: ``MeshLaminarize`` gathers the plane's pulled
values from the shards' interiors in the unsharded order and reduces them
as the unsharded step does (the same bits), before the shards' steps.
Force objects read their windows from the shards' interiors
(``ShardedStep.gather_box``).

Refused by name on a mesh (``mesh_reasons``): meshes of three axes,
Shan-Chen (single or mixture) with a BC row (JAX's Pallas engines refuse
it, :297, :894, and on an x-sharded 2D mesh :853-858), ``NTExtendedCopy``
(its gathers read the whole domain), an outflow row whose samples reach
past a shard's interior, immersed-boundary scenes (the JAX runner cannot
shard their particle positions) and composite steps.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes

import numpy as np
import torch

from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch.ops import lbm_step as ls
from sailfish_tpu_torch.ops import step as st
from sailfish_tpu_torch.ops.ibm import IBMStepBuilder
from sailfish_tpu_torch.parallel import mesh as pmesh
from sailfish_tpu_torch.subdomain import NodeMaps

#: the C struct's limits (csrc/halo.cu HALO_MAX_SHARDS, HALO_MAX_DIRS,
#: HALO_MAX_EDGE_DIRS)
MAX_SHARDS = 16
MAX_DIRS = 9
MAX_EDGE_DIRS = 3
#: launches of the exchange kernel, per lattice (the state's Q): the
#: distributions' exchange ``halo_exchange_<grid>`` and the density
#: exchange of the Shan-Chen and free-energy steps
#: ``halo_rho_exchange_<grid>``; on a mesh of two axes their edge mode,
#: ``halo_edge_exchange_<grid>`` and ``halo_rho_edge_exchange_<grid>``
LAUNCHES = dict.fromkeys(
    (f'halo_{kind}_{g}'
     for kind in ('exchange', 'rho_exchange', 'edge_exchange',
                  'rho_edge_exchange')
     for g in ('d2q9', 'd3q15', 'd3q19', 'd3q27')), 0)
#: the ghost regions of a slab, (outer side, inner side): -1 the low ghost
#: planes, +1 the high ones, 0 the interior along that axis; a one-axis
#: mesh has the first two, a two-axis one all eight (the last four the
#: edges, in csrc/halo.cu's order)
REGIONS = ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (1, -1),
           (1, 1))


def reset_launch_counts():
    """Zero ``LAUNCHES``."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def crossing_directions(grid, axis=0):
    """(lo, hi): the directions whose pull step reads the low ghost plane
    (c = +1 along the sharded spatial axis ``axis``: 0 the outermost, z in
    3D and y in 2D; 1 the next, y in 3D and x in 2D) and the high one (c =
    -1)."""
    comp = grid.dim - 1 - axis
    lo = tuple(i for i in range(grid.Q) if int(grid.basis[i][comp]) > 0)
    hi = tuple(i for i in range(grid.Q) if int(grid.basis[i][comp]) < 0)
    return lo, hi


def region_directions(grid, two_axis=False):
    """{region: directions} (``REGIONS``; the first two only without
    ``two_axis``): the directions whose pull step reads a ghost region, c
    = -side along each axis where its side is not 0. On two axes the
    regions (+-1, 0) and (0, +-1) are the crossing directions of each axis
    and the four edges those that cross both."""
    dim = grid.dim
    out = {}
    for so, si in REGIONS[:8 if two_axis else 2]:
        out[(so, si)] = tuple(
            i for i in range(grid.Q)
            if (so == 0 or int(grid.basis[i][dim - 1]) == -so)
            and (si == 0 or int(grid.basis[i][dim - 2]) == -si))
    return out


#: how many planes along its inward normal n an outflow row's node reads
#: beyond its own (``ops/step.fix_outflow``, ``guo_density_overlay``):
#: ``NTYuOutflow`` f_i(x + 2n - c_i) with c_i . n = 1, ``NTNeumann`` f(x +
#: 2n), ``NTGuoDensity`` f_i(x + n - c_i) with c_i . n = -1; the other rows
#: read their own plane or their pull sources only
OUTFLOW_REACH = {'NTYuOutflow': 1, 'NTNeumann': 2, 'NTGuoDensity': 2}


def outflow_reach_reasons(mesh_shape, builder):
    """The outflow rows of ``builder``'s scene whose samples along their
    inward normal, an axis that a mesh of ``mesh_shape`` shards, reach
    past a shard's interior planes (into a ghost plane, which holds only
    the directions that cross it): one reason per row, naming it."""
    shape = builder.maps.type_map.shape
    dim = len(shape)
    reasons = []
    for cls, k, mask in builder.bc_instances:
        reach = OUTFLOW_REACH.get(cls.__name__, 0)
        naxis = (k - 1) // 2
        arr_axis = dim - 1 - naxis
        if not reach or arr_axis >= min(len(mesh_shape), 2):
            continue
        length = shape[arr_axis] // mesh_shape[arr_axis]
        if length * mesh_shape[arr_axis] != shape[arr_axis]:
            continue        # validate_divisible names it
        sign = int(builder.grid.orientation_vectors[k - 1][naxis])
        m = mask.cpu().numpy() if torch.is_tensor(mask) else mask
        local = np.nonzero(m)[arr_axis] % length + reach * sign
        if np.any((local < 0) | (local >= length)):
            name = pmesh.axis_names(dim)[arr_axis]
            reasons.append(
                f'{cls.__name__} (orientation {k}) samples {reach} '
                f'plane(s) along its inward normal, past the interior of a '
                f'{length}-plane shard along {name} (its ghost planes hold '
                'only the directions that cross them; the JAX package '
                'recomputes such patch planes over the whole domain, '
                'sailfish_tpu/parallel/halo.py:653; thicker shards, or a '
                'face normal to an unsharded axis, run)')
    return reasons


def mesh_reasons(mesh_shape, dim, builder):
    """Why a run of ``builder``'s scene cannot be sharded over a mesh of
    ``mesh_shape`` (empty when it can), each naming what JAX runs there."""
    from sailfish_tpu_torch.ops.multigrid import (
        FreeEnergyStepBuilder, ShanChenMultiStepBuilder)
    reasons = []
    if len(mesh_shape) == 3:
        reasons.append(
            '3-axis meshes (the JAX runner steps them on its GSPMD XLA '
            'path, sailfish_tpu/parallel/mesh.py:60-65)')
    sc = isinstance(builder, ShanChenMultiStepBuilder) or (
        isinstance(builder, st.StepBuilder) and builder.sc_coupling != 0.0)
    if isinstance(builder, IBMStepBuilder):
        reasons.append(
            'an immersed-boundary scene (IBMStepBuilder: the JAX runner '
            'cannot shard it either: it shards every leaf of the state, '
            'the (dim, Np) particle positions included, and '
            'jax.device_put raises on them, sailfish_tpu/runner.py:90-92; '
            'run it unsharded)')
    if not isinstance(builder, (st.StepBuilder, ShanChenMultiStepBuilder,
                                FreeEnergyStepBuilder)):
        reasons.append(
            f'a composite step ({type(builder).__name__}: the JAX runner '
            'steps it on one device or on its XLA path)')
    else:
        # a K-component model's BC rows are its components'
        single = builder if isinstance(builder, st.StepBuilder) \
            else builder.b0
        if single.ext_gathers or any(cls is nt.NTExtendedCopy for cls, _k,
                                     _m in single.bc_instances):
            reasons.append(
                'NTExtendedCopy rows (their gathers read the whole domain; '
                'the JAX runner keeps them off its fused kernels, '
                'sailfish_tpu/runner.py:346-349)')
        reasons += outflow_reach_reasons(mesh_shape, single)
        outflow = sorted({cls.__name__ for cls, _k, _m in
                          single.bc_instances if cls in st.OUTFLOW_TYPES
                          and cls is not nt.NTExtendedCopy})
        if single is not builder and outflow:
            reasons.append(
                'the outflow family\'s rows (' + ', '.join(outflow) + ') in '
                f'a K-component model ({type(builder).__name__}: its sharded '
                'step, parallel/halo_multi.py, carries no mesh-wide plane '
                'mean; single-fluid scenes run them on a mesh)')
    if sc and (ls.classify_nodes(builder.maps)[1] or builder.maps.dynamic):
        what = 'planes' if dim == 3 else 'blocks'
        where = '297' if dim == 3 else '894'
        if dim == 2 and len(mesh_shape) == 2:
            where += ', and :853-858 on a mesh over x'
        reasons.append(
            f'Shan-Chen with complex-BC {what} needs global psi sampling '
            'in the patch windows; use the XLA engine (the JAX package\'s '
            f'refusal, sailfish_tpu/parallel/halo.py:{where}: a BC row '
            'beside a Shan-Chen coupling)')
    return reasons


def take(a, rows, cols=None, axis=0):
    """``a`` (a numpy array or a tensor) cut to the planes ``rows`` of its
    axis ``axis`` and, unless ``cols`` is None, to the planes ``cols`` of
    the next axis."""
    if torch.is_tensor(a):
        a = a.index_select(axis, torch.as_tensor(rows, device=a.device))
        if cols is not None:
            a = a.index_select(axis + 1,
                               torch.as_tensor(cols, device=a.device))
        return a
    a = np.take(np.asarray(a), rows, axis)
    if cols is not None:
        a = np.take(a, cols, axis + 1)
    return np.ascontiguousarray(a)


def shard_maps(maps, rows, cols=None, unwrap=(), ghost=1):
    """``maps`` (a ``NodeMaps``) cut to the planes ``rows`` of its
    outermost axis and, on a mesh of two axes, ``cols`` of the next;
    ``rows`` and ``cols`` are kept, so that coordinates stay global
    (``step.map_coords``). ``unwrap``: the array axes along which the mesh
    is a ring of one shard, whose ``ghost`` planes on either side hold the
    slab's own far planes: there the nodes of outflow-family rows become
    fluid nodes, so that such a row stands once in the slab (its ghost
    copies' output is thrown away in any case, and a varying row's
    parameter box then spans its own planes only)."""
    shape = (len(rows),) + maps.type_map.shape[1:]
    if cols is not None:
        shape = shape[:1] + (len(cols),) + shape[2:]
    out = NodeMaps(shape, maps.dim)
    for name in ('type_map', 'orientation', 'link_tags', 'param_rho',
                 'param_scalar'):
        setattr(out, name, take(getattr(maps, name), rows, cols))
    out.param_vel = take(maps.param_vel, rows, cols, axis=1)
    out.dynamic = [(take(mask, rows, cols), name, exprs)
                   for mask, name, exprs in maps.dynamic]
    out.extended = []
    out.rows = np.asarray(rows)
    out.cols = None if cols is None else np.asarray(cols)
    if unwrap:
        outflow = np.isin(out.type_map, [c.id for c in st.OUTFLOW_TYPES])
        wrapped = np.zeros(shape, dtype=bool)
        for a in unwrap:
            index = [slice(None)] * len(shape)
            for side in (slice(0, ghost), slice(shape[a] - ghost, None)):
                index[a] = side
                wrapped[tuple(index)] = True
        sel = outflow & wrapped
        out.type_map[sel] = nt._NTFluid.id
        out.orientation[sel] = 0
    return out


def shard_builder(builder, maps, device):
    """A ``StepBuilder`` of ``builder``'s scene on the shard maps ``maps``
    (``shard_maps``) on ``device``: the same settings, the static maps of
    the shard, a per-node body force cut to its planes (and rows), an
    entropic collision state of its own."""
    b = copy.copy(builder)
    b.maps = maps
    b.device = torch.device(device)
    if b.elbm is not None:
        b.elbm = copy.copy(builder.elbm)
    if builder.force is not None:
        force = builder.force
        if force.shape[1] != 1:
            force = take(force, maps.rows, maps.cols, axis=1)
        b.force = force.to(b.device)
    if builder.force_expr is None and builder.body_force is not None \
            and np.ndim(builder.body_force) > 1:
        b.body_force = take(builder.body_force, maps.rows, maps.cols,
                            axis=1)
    b._prepare_static()
    return b


def on_device(device):
    """A context in which CUDA work goes to ``device`` (a kernel launched
    from C takes the current device's context); nothing for the CPU."""
    if device.type == 'cuda':
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class Sharded:
    """A state laid out over a mesh: ``parts``, one (Q, L + 2, ...) tensor
    per shard in mesh order, on the shard's device; planes 1 ... L are the
    shard's slab, planes 0 and L + 1 its ghost planes (on two axes (Q, Lo
    + 2, Li + 2, ...), padded along both)."""

    def __init__(self, parts):
        self.parts = list(parts)


class _HaloParams(ctypes.Structure):
    _fields_ = [('part', ctypes.c_ulonglong * MAX_SHARDS),
                ('n_shards', ctypes.c_int), ('planes', ctypes.c_int),
                ('units', ctypes.c_int), ('unit_bytes', ctypes.c_int),
                ('n_lo', ctypes.c_int), ('n_hi', ctypes.c_int),
                ('lo', ctypes.c_int * MAX_DIRS),
                ('hi', ctypes.c_int * MAX_DIRS),
                ('n_dst', ctypes.c_int),
                ('dst', ctypes.c_int * MAX_SHARDS),
                ('ghost', ctypes.c_int), ('depth', ctypes.c_int),
                ('n_comp', ctypes.c_int),
                ('comp_units', ctypes.c_longlong),
                ('n_inner', ctypes.c_int), ('inner_planes', ctypes.c_int),
                ('row_units', ctypes.c_int),
                ('n_lo_in', ctypes.c_int), ('n_hi_in', ctypes.c_int),
                ('lo_in', ctypes.c_int * MAX_DIRS),
                ('hi_in', ctypes.c_int * MAX_DIRS),
                ('n_edge', ctypes.c_int * 4),
                ('edge', (ctypes.c_int * MAX_EDGE_DIRS) * 4)]


def exchange_functions(lib):
    """(``halo_exchange``, ``halo_enable_peer``) of a loaded
    ``csrc/halo.cu`` library, typed for ``ctypes``, after checking that its
    parameter block matches ``_HaloParams``."""
    lib.halo_params_size.restype = ctypes.c_int
    if lib.halo_params_size() != ctypes.sizeof(_HaloParams):
        raise RuntimeError('HaloParams layout differs between csrc/halo.cu '
                           'and parallel/halo.py')
    fn = lib.halo_exchange
    fn.argtypes = [ctypes.POINTER(_HaloParams), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    peer = lib.halo_enable_peer
    peer.argtypes = [ctypes.c_int, ctypes.c_int]
    peer.restype = ctypes.c_int
    return fn, peer


def neighbour(s, region, counts):
    """The shard whose planes fill ``region`` (``REGIONS``) of shard ``s``
    on a mesh of ``counts`` shards per axis (one axis: the ring
    neighbour; two: the outer, inner or diagonal one)."""
    n_in = counts[1] if len(counts) == 2 else 1
    n_out = counts[0]
    io, ii = divmod(s, n_in)
    so, si = region
    return (io + so) % n_out * n_in + (ii + si) % n_in


def exchange_plan(devices, counts=None):
    """The launches of one exchange for shards on ``devices`` (mesh
    order) of a mesh of ``counts`` shards per axis (default one axis):
    [(device, the shards whose ghost planes its launch fills, the other
    devices whose shards it reads)], devices in order of first
    appearance."""
    counts = (len(devices),) if counts is None else tuple(counts)
    regions = REGIONS[:8 if len(counts) == 2 else 2]
    plan = {}
    for s, d in enumerate(devices):
        dst, peers = plan.setdefault(d, ([], []))
        dst.append(s)
        for region in regions:
            q = devices[neighbour(s, region, counts)]
            if q != d and q not in peers:
                peers.append(q)
    return [(d, tuple(dst), tuple(peers)) for d, (dst, peers) in plan.items()]


def exchange_params(ptrs, length, plane_bytes, lo, hi, dst, ghost=1,
                    depth=1, n_comp=1, comp_bytes=0, inner=None):
    """The ``halo_exchange`` parameter block of one launch: the shards'
    buffers at the addresses ``ptrs`` (mesh order), each (``n_comp``, C,
    ``length`` + 2 ``ghost``, plane) with ``plane_bytes`` bytes per plane
    and ``comp_bytes`` from one component to the next; the channels ``lo``
    and ``hi`` of a component (the crossing directions,
    ``crossing_directions``; (0,) for a density buffer, C = 1) copied,
    ``depth`` planes per side; ``dst``: the shards whose ghost planes the
    launch fills. ``inner``: on a mesh of two axes (the edge mode), (the
    shards along the inner axis, its slab length, the bytes of one row
    along it, {region: channels} of the inner axis's ghost rows and of the
    edges, ``region_directions``); a plane is then ``length`` + 2
    ``ghost`` rows."""
    p = _HaloParams()
    for s, ptr in enumerate(ptrs):
        p.part[s] = ptr
    p.n_shards = len(ptrs)
    p.planes = length + 2 * ghost
    # the copy unit divides a row (a plane on one axis) and the component
    # stride
    run = plane_bytes if inner is None else inner[2]
    p.unit_bytes = next(u for u in (16, 4, 2)
                        if run % u == 0 and comp_bytes % u == 0)
    p.units = plane_bytes // p.unit_bytes
    p.n_lo, p.n_hi = len(lo), len(hi)
    for j, k in enumerate(lo):
        p.lo[j] = k
    for j, k in enumerate(hi):
        p.hi[j] = k
    p.n_dst = len(dst)
    for j, s in enumerate(dst):
        p.dst[j] = s
    p.ghost, p.depth, p.n_comp = ghost, depth, n_comp
    p.comp_units = comp_bytes // p.unit_bytes
    if inner is not None:
        n_inner, inner_length, row_bytes, regions = inner
        p.n_inner = n_inner
        p.inner_planes = inner_length + 2 * ghost
        p.row_units = row_bytes // p.unit_bytes
        if p.units != p.inner_planes * p.row_units:
            raise ValueError(f'a plane of {plane_bytes} B is not '
                             f'{p.inner_planes} rows of {row_bytes} B')
        p.n_lo_in, p.n_hi_in = len(regions[(0, -1)]), len(regions[(0, 1)])
        for j, k in enumerate(regions[(0, -1)]):
            p.lo_in[j] = k
        for j, k in enumerate(regions[(0, 1)]):
            p.hi_in[j] = k
        for e, region in enumerate(REGIONS[4:]):
            p.n_edge[e] = len(regions[region])
            for j, k in enumerate(regions[region]):
                p.edge[e][j] = k
    return p


def ghost_span(side, length, ghost, depth):
    """(first destination plane, first source plane, planes) of the
    region side ``side`` along an axis of ``length`` interior planes: -1
    the ``depth`` low ghost planes from the last interior ones of the
    neighbour below, +1 the high ones from the first of the neighbour
    above, 0 the interior."""
    if side < 0:
        return ghost - depth, length + ghost - depth, depth
    if side > 0:
        return length + ghost, ghost, depth
    return ghost, ghost, length


def ghost_copy(parts, length, ghost=1, depth=1, indices=None, inner=None):
    """The exchange as PyTorch copies (the plain version of
    ``halo_exchange``): ``parts`` in mesh order, each a list of one
    shard's tensors (its components), each with ``length`` + 2 ``ghost``
    planes along its axis 1 with ``indices`` (a distributions' tensor),
    else along its axis 0 (a density). The
    ``depth`` low ghost planes of shard s take the last ``depth`` interior
    planes of shard s - 1, the ``depth`` high ghost planes the first
    ``depth`` of shard s + 1: with ``indices`` (device -> {region: the
    index tensor of its channels, along axis 0}) only those channels, else
    whole planes (a density). ``inner``: on a mesh of two axes, (the shards
    along the inner axis, its slab length); the tensors are padded along
    the next axis too, and every region of ``REGIONS`` is filled from its
    neighbour (``neighbour``: the diagonal one for an edge)."""
    axis = 0 if indices is None else 1
    counts = (len(parts),) if inner is None else \
        (len(parts) // inner[0], inner[0])
    regions = REGIONS[:2] if inner is None else REGIONS
    for s, dst in enumerate(parts):
        for region in regions:
            src = parts[neighbour(s, region, counts)]
            spans = [(axis, ghost_span(region[0], length, ghost, depth))]
            if inner is not None:
                spans.append((axis + 1, ghost_span(region[1], inner[1],
                                                   ghost, depth)))
            for d, b in zip(dst, src):
                to, frm = d, b
                for ax, (at, start, n) in spans:
                    to = to.narrow(ax, at, n)
                    frm = frm.narrow(ax, start, n)
                if indices is None:
                    to.copy_(frm.to(d.device))
                else:
                    picked = frm.index_select(0, indices(b.device)[region])
                    to.index_copy_(0, indices(d.device)[region],
                                   picked.to(d.device))


def runs(dst, src):
    """The maximal runs over which the positions ``dst`` and the indices
    ``src`` (equal-length int arrays) both step by one: [(dst start, src
    start, length)]."""
    out = []
    for j in range(len(dst)):
        if out and dst[j] == dst[j - 1] + 1 and src[j] == src[j - 1] + 1:
            out[-1][2] += 1
        else:
            out.append([int(dst[j]), int(src[j]), 1])
    return [tuple(r) for r in out]


def copy_box(out, src, axis_maps):
    """Copy into ``out`` (C, *B) from ``src`` (C, *S) along the spatial
    axes: ``axis_maps`` per axis (positions in ``out``, indices in
    ``src``), copied run by run (``runs``), across devices where they
    differ."""
    per_axis = [runs(d, s_) for d, s_ in axis_maps]
    for combo in np.ndindex(*[len(r) for r in per_axis]):
        to, frm = out, src
        for a, j in enumerate(combo):
            d0, s0, n = per_axis[a][j]
            to = to.narrow(1 + a, d0, n)
            frm = frm.narrow(1 + a, s0, n)
        to.copy_(frm)


class MeshLaminarize:
    """The laminarize pre-pass of a sharded step (``ShardedStep.lam``):
    the plane means of every ``NTLaminarize`` row of the whole domain, from
    the pulled values of the shards' interior nodes, reduced in the
    unsharded step's order so that they have its bits, then handed to each
    shard's step.

    ``rows``: per laminarize instance of the global builder (orientation
    k), (k, normal axis, lowest coordinate, nodes per plane, the nodes'
    global flat indices plane by plane: ``step.plane_entries``). Per shard
    and row, ``pos`` (the places of the shard's interior nodes in the row's
    node list) and ``pull`` (the flat slab indices of each node's Q pull
    sources, (Q, nodes)). The plain version (``means``: gather the pulled
    values in the unsharded order onto the first shard's device, then
    ``step.entry_means``, the unsharded torch step's reduction) feeds the
    torch engine (``spread``) and, on CPU tensors, the kernel engine's plain
    version (``plain_into``: each shard kernel's ``lam.mean``). On CUDA
    the kernel engine runs ``laminarize_mean_ghost_<grid>``
    (``csrc/lbm_step.cu``): one launch per step on the first shard's
    device, one block per plane reading the shards' slabs (peer reads
    across GPUs) in the unsharded order, as ``laminarize_mean_<grid>``
    does on one device, and writing each mean into the entries of every
    shard that reads the plane."""

    def __init__(self, stepper):
        self.stepper = stepper
        builder = stepper.builder
        self.grid = grid = builder.grid
        shape = builder.maps.type_map.shape
        self.dim = dim = len(shape)
        self.rows = []
        for cls, k, mask in builder.bc_instances:
            if cls is nt.NTLaminarize:
                self.rows.append((k, (k - 1) // 2)
                                 + st.plane_entries(mask, (k - 1) // 2))
        g = stepper.ghost
        n_sharded = len(stepper.counts)
        self.devices = list(stepper.mesh.devices)
        self.dev0 = torch.device(self.devices[0])
        lens = [stepper.length] + \
            ([stepper.inner[1]] if n_sharded == 2 else [])
        #: a slab's spatial shape, ghost planes included (every shard's)
        self.slab_shape = slab = tuple(n + 2 * g for n in lens) \
            + tuple(shape[n_sharded:])
        #: per shard, per row: the places of its interior nodes in the
        #: row's node list (on the first shard's device), their flat slab
        #: indices, and their Q pull sources there (on the shard's device)
        self.pos, self.local, self.pull = [], [], []
        for s in range(stepper.mesh.size):
            offs = [stepper.rows[s][g]] + \
                ([stepper.cols[s][g]] if n_sharded == 2 else [])
            pos_s, local_s, pull_s = [], [], []
            for _k, _ax, _lo, _counts, nodes in self.rows:
                coords = list(np.unravel_index(nodes, shape))
                inside = np.ones(nodes.size, dtype=bool)
                for a in range(n_sharded):
                    inside &= (coords[a] >= offs[a]) \
                        & (coords[a] < offs[a] + lens[a])
                lc = [c[inside] for c in coords]
                for a in range(n_sharded):
                    lc[a] = lc[a] - offs[a] + g
                local = np.ravel_multi_index(lc, slab) if lc[0].size \
                    else np.zeros(0, dtype=np.int64)
                pull = np.stack([np.ravel_multi_index(
                    [(lc[a] - int(grid.basis[i][dim - 1 - a])) % slab[a]
                     for a in range(dim)], slab) if lc[0].size
                    else np.zeros(0, dtype=np.int64)
                    for i in range(grid.Q)])
                dev = self.devices[s]
                pos_s.append(torch.as_tensor(np.flatnonzero(inside),
                                             device=self.dev0))
                local_s.append(local.astype(np.int64))
                pull_s.append(torch.as_tensor(pull.astype(np.int64),
                                              device=dev))
            self.pos.append(pos_s)
            self.local.append(local_s)
            self.pull.append(pull_s)
        #: the global entries: the rows' planes in row order, and each
        #: row's first entry
        self.first = np.cumsum([0] + [len(r[3]) for r in self.rows])
        self.entries = int(self.first[-1])
        self._kernel = None

    # -- the plain version -----------------------------------------------

    def means(self, parts):
        """The (entries, Q) plane means of every row, row after row, from
        the shards' slabs ``parts``, on the first shard's device: the
        pulled values of each row's nodes gathered in the unsharded order,
        then ``step.entry_means``."""
        q = self.grid.Q
        out = []
        for r, (_k, _ax, _lo, counts, nodes) in enumerate(self.rows):
            vals = torch.zeros((q, nodes.size), dtype=parts[0].dtype,
                               device=self.dev0)
            for s, part in enumerate(parts):
                if self.pos[s][r].numel():
                    v = torch.gather(part.reshape(q, -1), 1, self.pull[s][r])
                    vals.index_copy_(1, self.pos[s][r], v.to(self.dev0))
            out.append(st.entry_means(vals, counts))
        return torch.cat(out)

    def _index(self, s, k, coords):
        """The global entries of the planes at the slab coordinates
        ``coords`` of shard ``s`` along row ``k``'s normal (-1 where the
        row has no plane there)."""
        r = next(j for j, row in enumerate(self.rows) if row[0] == k)
        _k, naxis, lo, counts, _nodes = self.rows[r]
        arr_axis = self.dim - 1 - naxis
        stp = self.stepper
        glob = np.asarray(coords)
        if arr_axis == 0:
            glob = stp.rows[s][glob]
        elif arr_axis == 1 and stp.inner is not None:
            glob = stp.cols[s][glob]
        rel = glob - lo
        return np.where((rel >= 0) & (rel < len(counts)),
                        self.first[r] + rel, -1)

    def spread(self, s, builder, means):
        """The torch engine's ``lam_means`` of shard ``s`` (its
        ``builder``) from the global ``means``: {orientation: (Q, ...)
        tensor over the slab}, 0 at the planes the row lacks."""
        out = {}
        padded = torch.cat([means, means.new_zeros((1, means.shape[1]))])
        shape = builder.maps.type_map.shape
        for cls, k, _mask in builder.bc_instances:
            if cls is not nt.NTLaminarize:
                continue
            naxis = (k - 1) // 2
            arr_axis = self.dim - 1 - naxis
            idx = self._index(s, k, np.arange(shape[arr_axis]))
            sel = torch.as_tensor(np.where(idx < 0, self.entries, idx),
                                  device=means.device)
            out[k] = st.spread_means(padded.index_select(0, sel), 0, shape,
                                     naxis).to(builder.device)
        return out

    def shard_entries(self, s, ks):
        """The global entry of each entry of shard ``s``'s kernel ``ks``
        (its ``lam`` spans; -1 where the row has no plane there)."""
        out = np.full(ks.lam.mean.shape[0], -1, dtype=np.int64)
        for j, lo, count in ks.lam.spans:
            e = ks.params.out.lam_entry[j]
            out[e:e + count] = self._index(
                s, ks.table[j].orientation, np.arange(lo, lo + count))
        return out

    def plain_into(self, parts, kernels):
        """The plain version of the mesh pre-pass: ``means`` of ``parts``
        written into each shard kernel's ``lam.mean`` (0 where its plane
        has no global entry: a ghost copy's)."""
        means = self.means(parts)
        padded = torch.cat([means, means.new_zeros((1, means.shape[1]))])
        for s, ks in enumerate(kernels):
            if ks.lam is None:
                continue        # the shard holds no laminarize node
            idx = self.shard_entries(s, ks)
            sel = torch.as_tensor(np.where(idx < 0, self.entries, idx),
                                  device=means.device)
            ks.lam.mean.copy_(padded.index_select(0, sel))

    # -- the kernel ------------------------------------------------------

    def _kernel_arrays(self, kernels):
        """The launch's device arrays on the first shard's device: the
        nodes coded shard * (slab nodes) + flat index, entry by entry, and
        their offsets; the destinations (each shard entry's address in its
        ``lam.mean``) per global entry, and their offsets."""
        q = self.grid.Q
        slab_n = int(np.prod(self.slab_shape))
        codes, start = [], [0]
        for r, (_k, _ax, _lo, counts, nodes) in enumerate(self.rows):
            code = np.zeros(nodes.size, dtype=np.int64)
            for s in range(len(kernels)):
                pos = self.pos[s][r].cpu().numpy()
                code[pos] = s * slab_n + self.local[s][r]
            codes.append(code)
            for c in counts:
                start.append(start[-1] + c)
        dst = [[] for _ in range(self.entries)]
        for s, ks in enumerate(kernels):
            if ks.lam is None:
                continue
            base = ks.lam.mean.data_ptr()
            for e, g in enumerate(self.shard_entries(s, ks)):
                if g >= 0:
                    dst[g].append(base + 4 * q * e)
        dst_start = np.cumsum([0] + [len(d) for d in dst])
        flat = [a for d in dst for a in d]

        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a, dtype=dtype),
                                   device=self.dev0)

        return (dev(np.concatenate(codes), np.int64), dev(start, np.int32),
                dev(np.asarray(flat or [0], dtype=np.uint64).view(np.int64),
                    np.int64), dev(dst_start, np.int32))

    def launch(self, parts, kernels, name):
        """``laminarize_mean_ghost_<grid>`` on the first shard's device
        over the shards' buffers ``parts`` (CUDA), after the work the
        other devices queued; the shards' next steps wait for it. Counted
        in ``lbm_step.LAUNCHES[name]``."""
        stp = self.stepper
        if self._kernel is None:
            from sailfish_tpu_torch.ops import build
            fn = ls.laminarize_ghost_function(
                build.load(ls.OUTFLOW_LIBRARY).lib, self.grid.name)
            stp._load_exchange()
            for d in dict.fromkeys(self.devices):
                if d != self.dev0:
                    for a, b in ((self.dev0, d), (d, self.dev0)):
                        rc = stp._peer_fn(a.index, b.index)
                        if rc != 0:
                            raise RuntimeError(
                                f'{name}: {a} cannot reach {b} (peer '
                                f'access, error {rc})')
            self._kernel = (fn, self._kernel_arrays(kernels), {})
        fn, (codes, start, dst, dst_start), ptr_cache = self._kernel
        key = tuple(p.data_ptr() for p in parts)
        if key not in ptr_cache:
            ptr_cache.clear()
            ptr_cache[key] = torch.as_tensor(
                np.asarray(key, dtype=np.uint64).view(np.int64),
                device=self.dev0)
        others = [d for d in dict.fromkeys(self.devices) if d != self.dev0]
        stream = torch.cuda.current_stream(self.dev0)
        for d in others:
            stream.wait_event(torch.cuda.current_stream(d).record_event())
        with torch.cuda.device(self.dev0):
            rc = fn(ptr_cache[key].data_ptr(), codes.data_ptr(),
                    start.data_ptr(), self.entries, dst.data_ptr(),
                    dst_start.data_ptr(), ctypes.byref(kernels[0].params),
                    stream.cuda_stream)
        if rc != 0:
            raise RuntimeError(f'{name} launch failed: CUDA error {rc}')
        if others:
            done = stream.record_event()
            for d in others:
                torch.cuda.current_stream(d).wait_event(done)
        ls.LAUNCHES[name] += 1


class ShardedStep:
    """The sharded step of a single-fluid ``StepBuilder`` scene over a
    mesh of one axis (z of a 3D domain, y of a 2D one: ``axis_name``) or
    of two (('z', 'y'), ('y', 'x'): ``axis_names``; ``inner`` = (the
    shards along the inner axis, its slab length), else None).

    ``builder``: the scene's global builder; ``domain_shape``: its spatial
    shape; ``mesh``: a ``parallel.mesh.Mesh``; ``engine``: 'torch' (each
    slab stepped by its ``StepBuilder``, ``builders``) or 'kernel' (one
    ``KernelStep`` per slab, ``kernels``; their launches count as
    ``lbm_step_ghost_<kind><grid>``, the key of the same step unsharded
    with ``ghost_`` after ``lbm_step_``). The state is a ``Sharded``;
    ``run``, ``codes_of``, ``run_codes`` and ``state_of`` are those of
    ``KernelStep`` over it (int16 codes under --precision=mixed on the
    kernel engine), and take a global tensor too, which they shard first.
    ``exchanges`` counts exchanges (the kernel's launches, one per device,
    count in ``LAUNCHES`` under ``name``, ``halo_edge_exchange_<grid>`` on
    two axes); ``launches`` counts the shards' step launches. Under
    single-component Shan-Chen (``sc``) each step is the shards' density
    pre-passes, the density exchange
    (``density_exchange``, counted in ``rho_exchanges`` and under
    ``rho_name``), the shards' steps and the exchange; with a laminarize
    row the mesh pre-pass (``lam``, ``lam_prepass``) comes first."""

    #: ghost planes on each side of a slab
    ghost = 1

    def __init__(self, builder, domain_shape, mesh, engine='torch'):
        self._setup(builder, domain_shape, mesh, engine)
        unwrap = [a for a, c in enumerate(self.counts) if c == 1]
        self.builders = [
            shard_builder(builder, shard_maps(builder.maps, rows, cols,
                                              unwrap, self.ghost), d)
            for rows, cols, d in zip(self.rows, self.cols, mesh.devices)]
        self.sc = builder.sc_coupling != 0.0
        self.kernels = None
        self.steps = None
        #: the int16 scales of the kernel engine's codes, else None
        self.mixed = None
        if engine == 'kernel':
            from sailfish_tpu_torch.ops.lbm_step import KernelStep
            self.kernels = [KernelStep(b) for b in self.builders]
            for ks in self.kernels:
                ks.name = ks.name.replace('lbm_step_', 'lbm_step_ghost_', 1)
                ks.rho_name = ks.rho_name.replace('_nk1_', '_nk1_ghost_', 1)
            self.mixed = builder.mixed
        elif not self.sc:
            self.steps = [b.build() for b in self.builders]
        if any(cls is nt.NTLaminarize for cls, _k, _m in
               builder.bc_instances):
            self.lam = MeshLaminarize(self)
            for ks in self.kernels or ():
                ks.mesh_means = True

    def _setup(self, builder, domain_shape, mesh, engine):
        """The checks and the layout shared with the K-component step:
        refusals, the mesh axes, ``length`` (and ``inner``), ``rows`` (each
        shard's planes with its ghost planes; ``cols`` along the inner
        axis, None on one axis), the ghost regions' directions
        (``regions``; ``lo`` and ``hi`` of the outer axis), the exchanges'
        names and their state."""
        dim = len(domain_shape)
        reasons = mesh_reasons(tuple(mesh.shape.values()), dim, builder)
        if reasons:
            raise NotImplementedError(
                'not ported to sailfish_tpu_torch on a mesh (--mesh) yet: '
                + '; '.join(reasons))
        self.axis_name = 'z' if dim == 3 else 'y'
        names = list(pmesh.axis_names(dim)[:2])
        if list(mesh.axis_names) not in (names[:1], names):
            raise ValueError(f'{type(self).__name__} shards the '
                             f'{" or ".join(map(repr, names))} axes of a '
                             f'{dim}D domain; got mesh axes '
                             f'{list(mesh.axis_names)}')
        pmesh.validate_divisible(domain_shape, mesh)
        n = mesh.size
        if n > MAX_SHARDS:
            raise ValueError(f'at most {MAX_SHARDS} shards; got {n}')
        self.builder = builder
        self.grid = builder.grid
        self.mesh = mesh
        self.engine = engine
        #: the shards per sharded axis, outer to inner
        self.counts = pmesh.counts_of(mesh)
        two_axis = len(self.counts) == 2
        self.length = domain_shape[0] // self.counts[0]
        self.inner = (self.counts[1], domain_shape[1] // self.counts[1]) \
            if two_axis else None
        for length in (self.length,) + (self.inner[1:] if two_axis else ()):
            if length < self.ghost:
                raise ValueError(f'{length} planes per shard; the slab '
                                 f'needs at least its {self.ghost} ghost '
                                 'planes\' worth')
        rows = [pmesh.shard_rows(domain_shape, self.counts, s, self.ghost)
                for s in range(n)]
        self.rows = [r[0] for r in rows]
        self.cols = [r[1] if two_axis else None for r in rows]
        #: the nodes of a slab's plane (its ghost rows included) and of a
        #: row along the inner axis (the axes below it)
        self.row_nodes = int(np.prod(domain_shape[2:]))
        self.plane_nodes = int(np.prod(domain_shape[1:])) if not two_axis \
            else (self.inner[1] + 2 * self.ghost) * self.row_nodes
        self.regions = region_directions(self.grid, two_axis)
        self.lo, self.hi = self.regions[(-1, 0)], self.regions[(1, 0)]
        g = self.grid.name.lower()
        edge = 'edge_' if two_axis else ''
        self.name = f'halo_{edge}exchange_{g}'
        self.rho_name = f'halo_rho_{edge}exchange_{g}'
        self.exchanges = 0
        self.rho_exchanges = 0
        #: the laminarize pre-pass over the mesh (``MeshLaminarize``), or
        #: None without a laminarize row; its launches count as
        #: ``lam_name`` in ``lbm_step.LAUNCHES``
        self.lam = None
        self.lam_name = f'laminarize_mean_ghost_{g}'
        self._index = {}
        self._fn = None
        self._peer_fn = None
        self._plans = {}

    # -- layout --------------------------------------------------------------

    def shard(self, f):
        """The ``Sharded`` state of the global (Q, *S) tensor ``f`` (or
        K-tuple of them), ghost planes filled (as an exchange fills them,
        and more)."""
        return Sharded(pmesh.split(f if torch.is_tensor(f) else tuple(f),
                                   self.mesh, ghost=self.ghost))

    def gather(self, state, device=None):
        """The global (Q, *S) tensor (or K-tuple) of a ``Sharded`` state
        (its slabs, the ghost planes cropped), on ``device`` (default the
        first shard's)."""
        return pmesh.gather(state.parts, device, ghost=self.ghost,
                            counts=self.counts)

    def as_sharded(self, f):
        """``f`` if it is a ``Sharded`` state, else ``shard(f)``."""
        return f if isinstance(f, Sharded) else self.shard(f)

    def interior(self, t, axis=1):
        """The shard's own nodes of ``t``, a slab padded along its axes
        ``axis`` (and ``axis`` + 1 on two axes): its ghost planes
        cropped."""
        t = t.narrow(axis, self.ghost, self.length)
        if self.inner is not None:
            t = t.narrow(axis + 1, self.ghost, self.inner[1])
        return t

    def gather_box(self, state, idx, component=0):
        """The block of the global state at the global coordinates ``idx``
        (one int array per spatial axis, outer to inner; periodic indices
        may wrap), a (Q, *lengths) tensor on the first shard's device,
        copied from the shards' interiors: no global copy of the state
        (the windows of force objects). A K-tuple state gives its
        ``component``."""
        parts = [p if torch.is_tensor(p) else p[component]
                 for p in state.parts]
        first = parts[0]
        out = torch.empty((first.shape[0],) + tuple(len(i) for i in idx),
                          dtype=first.dtype, device=first.device)
        g = self.ghost
        n_sharded = len(self.counts)
        for s, part in enumerate(parts):
            maps = []
            for a, glob in enumerate(idx):
                glob = np.asarray(glob)
                pos = np.arange(glob.size)
                if a < n_sharded:
                    rows = self.rows[s] if a == 0 else self.cols[s]
                    length = self.length if a == 0 else self.inner[1]
                    off = int(rows[g])
                    keep = (glob >= off) & (glob < off + length)
                    pos, glob = pos[keep], glob[keep] - off + g
                maps.append((pos, glob))
            if all(m[0].size for m in maps):
                copy_box(out, part, maps)
        return out

    def is_finite(self, state):
        """Whether every value of the shards' slabs is finite."""
        return all(bool(torch.isfinite(self.interior(f)).all())
                   for part in state.parts
                   for f in ((part,) if torch.is_tensor(part) else part))

    # -- exchange ------------------------------------------------------------

    def _indices(self, device):
        """{region: the index tensor of its directions} on ``device``."""
        key = str(device)
        if key not in self._index:
            self._index[key] = {
                region: torch.as_tensor(d, dtype=torch.long, device=device)
                for region, d in self.regions.items()}
        return self._index[key]

    def _load_exchange(self):
        """Bind ``halo_exchange`` and ``halo_enable_peer`` (``_fn``,
        ``_peer_fn``) of the built ``csrc/halo.cu``."""
        if self._fn is None:
            from sailfish_tpu_torch.ops import build
            self._fn, self._peer_fn = exchange_functions(
                build.load('halo').lib)

    def exchange_reference(self, parts):
        """The exchange as PyTorch index copies (the plain version): ghost
        plane 0 of shard s takes the ``lo`` directions of plane L of shard
        s - 1, ghost plane L + 1 the ``hi`` directions of plane 1 of shard
        s + 1; on two axes the inner axis's ghost rows and the edges
        likewise (``ghost_copy``)."""
        ghost_copy([[p] for p in parts], self.length, indices=self._indices,
                   inner=self.inner)

    def density_exchange_reference(self, rhos):
        """The density exchange as PyTorch copies (its plain version):
        ghost plane 0 of shard s's density ``rhos[s]`` (L + 2, ...) takes
        plane L of shard s - 1's, plane L + 1 plane 1 of shard s + 1's; on
        two axes every ghost region likewise."""
        ghost_copy([[r] for r in rhos], self.length, inner=self.inner)

    def _on_kernels(self, tensors):
        """Whether the exchanges of ``tensors`` run the kernel: on the
        kernel engine, with a shard on a CUDA device."""
        return self.kernels is not None and any(
            t.device.type != 'cpu' for t in tensors)

    def exchange(self, parts):
        """Fill the ghost planes of the shards' buffers ``parts`` that the
        next step reads: on the kernel engine with the shards on CUDA
        devices, one ``halo_exchange`` launch per device (counted in
        ``LAUNCHES``); on the torch engine, or on the CPU,
        ``exchange_reference``."""
        self.exchanges += 1
        if not self._on_kernels(parts):
            self.exchange_reference(parts)
            return
        self._launch(self._plan_for(parts), self.name)

    def density_exchange(self, rhos):
        """Fill the ghost planes of the shards' post-stream densities
        ``rhos`` (each (L + 2, ...) fp32) that the Shan-Chen force reads:
        one ``halo_exchange`` launch per device on whole planes (counted
        under ``rho_name``) on the kernel engine, else
        ``density_exchange_reference``."""
        self.rho_exchanges += 1
        if not self._on_kernels(rhos):
            self.density_exchange_reference(rhos)
            return
        self._launch(self._plan('rho', rhos, self.whole_regions()),
                     self.rho_name, wait_done=False)

    def whole_regions(self):
        """{region: (0,)}: every ghost region of a density buffer, whole."""
        return dict.fromkeys(self.regions, (0,))

    def _launch(self, plan, name, wait_done=True):
        """The exchange kernel's launches of ``plan`` (``_plan``), each on
        its device's current stream after CUDA events that order it behind
        the work its neighbours' devices queued; with ``wait_done`` the
        next work of each device is ordered behind its neighbours'
        launches too (it overwrites planes they read). Counted in
        ``LAUNCHES[name]``."""
        multi = len(plan) > 1
        if multi:
            # each launch reads planes its neighbours' devices just wrote
            ready = {d: torch.cuda.current_stream(d).record_event()
                     for d, _p, _q in plan}
        for d, params, peers in plan:
            stream = torch.cuda.current_stream(d)
            for q in peers:
                stream.wait_event(ready[q])
            with torch.cuda.device(d):
                rc = self._fn(ctypes.byref(params), stream.cuda_stream)
            if rc != 0:
                raise RuntimeError(f'{name} launch failed on {d}: '
                                   f'error {rc}')
            LAUNCHES[name] += 1
        if multi and wait_done:
            # and the next step on a device overwrites planes that its
            # neighbours' devices read: after their launches
            done = {d: torch.cuda.current_stream(d).record_event()
                    for d, _p, _q in plan}
            for d, _p, peers in plan:
                stream = torch.cuda.current_stream(d)
                for q in peers:
                    stream.wait_event(done[q])

    @property
    def launches(self):
        """The step launches of the shards' kernels."""
        return sum(ks.launches for ks in self.kernels or ())

    def _plan_for(self, parts):
        """The exchange kernel's launches for ``parts``: [(device, its
        parameter block, the devices its shards' neighbours are on)] (kept
        while the buffers stay the same; peer access enabled where a
        launch reads another device)."""
        return self._plan('f', parts, self.regions)

    def _plan(self, key, bufs, regions, depth=1, n_comp=1, comp_bytes=0):
        """The launches of the exchange ``key`` on the shards' buffers
        ``bufs`` (each of ``n_comp`` components ``comp_bytes`` apart;
        ``exchange_params``), copying the directions ``regions`` gives for
        each ghost region: [(device, its parameter block, the devices its
        shards' neighbours are on)], kept while the buffers stay the same;
        peer access enabled where a launch reads another device."""
        ptrs = tuple(b.data_ptr() for b in bufs)
        cached = self._plans.get(key)
        if cached is not None and cached[0] == ptrs:
            return cached[1]
        first = bufs[0]
        for b in bufs:
            if b.device.type != 'cuda' or not b.is_contiguous() \
                    or b.shape != first.shape or b.dtype != first.dtype:
                raise ValueError(
                    f'{self.name}: every shard buffer a contiguous CUDA '
                    f'tensor of one shape and dtype; got {b.device} '
                    f'{tuple(b.shape)} {b.dtype}')
        self._load_exchange()
        size = first.element_size()
        inner = None if self.inner is None else \
            self.inner + (self.row_nodes * size, regions)
        plan = []
        for d, dst, peers in exchange_plan([b.device for b in bufs],
                                           self.counts):
            for q in peers:
                rc = self._peer_fn(d.index, q.index)
                if rc != 0:
                    raise RuntimeError(
                        f'{self.name}: {d} cannot read {q} (peer access, '
                        f'error {rc}): the exchange reads a neighbour\'s '
                        'plane in place')
            plan.append((d, exchange_params(
                ptrs, self.length, self.plane_nodes * size, regions[(-1, 0)],
                regions[(1, 0)], dst, self.ghost, depth, n_comp, comp_bytes,
                inner), peers))
        self._plans[key] = (ptrs, plan)
        return plan

    # -- stepping ------------------------------------------------------------

    def run(self, f, n, it0=0):
        """``n`` steps from the state ``f`` (``Sharded`` or global), the
        first computing iteration ``it0``; returns the ``Sharded`` result.
        On the kernel engine under --precision=mixed the fp32 state is
        quantized into each shard's A buffer and the result returned
        dequantized in its ``out`` buffer, as ``KernelStep.run`` does."""
        if self.kernels is None:
            parts = self.as_sharded(f).parts
            for i in range(n):
                parts = self.torch_step(parts, it0 + i)
                self.exchange(parts)
            return Sharded(parts)
        if self.mixed is None:
            return self.run_codes(f, n, it0)
        return self.state_of(self.run_codes(self.codes_of(f), n, it0))

    def torch_step(self, parts, it=0):
        """The torch engine's step of the shards ``parts`` at iteration
        ``it``, before the exchange; under Shan-Chen its two phases with
        the density exchange between them."""
        if self.lam is not None:
            means = self.lam.means(parts)
            for s, b in enumerate(self.builders):
                b.lam_means = self.lam.spread(s, b, means)
        if not self.sc:
            return [step(p, it) for step, p in zip(self.steps, parts)]
        streamed = [b.stream_phase(p, it)
                    for b, p in zip(self.builders, parts)]
        rhos = [s[2] for s in streamed]
        self.density_exchange(rhos)
        return [b.collide_phase(s, it, sc_rho=rho)
                for b, s, rho in zip(self.builders, streamed, rhos)]

    def codes_of(self, f):
        """Under --precision=mixed on the kernel engine, the ``Sharded``
        int16 codes to step from for the fp32 state ``f``: each part
        quantized into its shard's A buffer (A or B itself when it is
        one)."""
        parts = self.as_sharded(f).parts
        return Sharded(p if p is ks.a or p is ks.b
                       else ks.a.copy_(self.mixed.quant(p))
                       for ks, p in zip(self.kernels, parts))

    def state_of(self, codes):
        """Under --precision=mixed on the kernel engine, the fp32
        ``Sharded`` state of the ``Sharded`` codes: dequantized into each
        shard's ``out`` buffer."""
        return Sharded(ks.out.copy_(self.mixed.dequant(p))
                       for ks, p in zip(self.kernels, codes.parts))

    def run_codes(self, f, n, it0=0):
        """``n`` steps of the kernel engine from the state ``f`` of the
        kernels' dtype (fp32, or int16 codes under --precision=mixed),
        ``Sharded`` or global, without the mixed conversions; returns the
        ``Sharded`` state in the shards' A or B buffers."""
        cur = []
        for ks, p in zip(self.kernels, self.as_sharded(f).parts):
            if p is not ks.a and p is not ks.b:
                p = ks.a.copy_(p)
            cur.append(p)
        for i in range(n):
            nxt = [ks.b if p is ks.a else ks.a
                   for ks, p in zip(self.kernels, cur)]
            if self.sc:
                for ks, src in zip(self.kernels, cur):
                    with on_device(src.device):
                        ks.density_into(src, ks.rho)
                self.density_exchange([ks.rho for ks in self.kernels])
            if self.lam is not None:
                self.lam_prepass(cur)
            for ks, src, dst in zip(self.kernels, cur, nxt):
                with on_device(src.device):
                    ks.collide_into(src, dst, it0 + i)
            self.exchange(nxt)
            cur = nxt
        return Sharded(cur)

    def lam_prepass(self, parts):
        """The laminarize plane means over the mesh from the shards' states
        ``parts`` into the shard kernels' ``lam.mean``: one
        ``laminarize_mean_ghost_<grid>`` launch (counted as ``lam_name``)
        on CUDA shards, its plain version (``MeshLaminarize.plain_into``)
        on the CPU."""
        if self._on_kernels(parts):
            self.lam.launch(parts, self.kernels, self.lam_name)
        else:
            self.lam.plain_into(parts, self.kernels)

    def reference(self, state, it=0):
        """Step ``it`` of the kernel engine's plain version from ``state``
        (``Sharded`` or global): each shard's ``KernelStep.reference``
        (under Shan-Chen after the plain pre-pass and density exchange),
        then ``exchange_reference``; returns a new ``Sharded`` state."""
        from sailfish_tpu_torch.ops import sc_multi
        parts = self.as_sharded(state).parts
        if self.lam is not None:
            self.lam.plain_into(parts, self.kernels)
        rhos = [None] * len(parts)
        if self.sc:
            rhos = [sc_multi.rho_reference(p, self.grid) for p in parts]
            self.density_exchange_reference(rhos)
        out = []
        for ks, p, rho in zip(self.kernels, parts, rhos):
            ks.set_iteration(it)
            out.append(ks.reference(p, rho))
        self.exchange_reference(out)
        return Sharded(out)

    def macro_fields(self, state, it=0):
        """(rho, u) of a ``Sharded`` state as the global builder's
        ``macro_fields`` gives them, computed per shard on the device and
        gathered on the first shard's device (with a laminarize row after
        the mesh's plane means)."""
        if self.lam is not None:
            means = self.lam.means(state.parts)
            for s, b in enumerate(self.builders):
                b.lam_means = self.lam.spread(s, b, means)
        rho, u = zip(*(b.macro_fields(p, it)
                       for b, p in zip(self.builders, state.parts)))
        return (pmesh.gather(rho, axis=0, ghost=1, counts=self.counts),
                pmesh.gather(u, axis=1, ghost=1, counts=self.counts))
