"""The kernel engine: one fused stream-and-collide CUDA kernel launch per
step, with native BCs of static, varying or time-dependent parameters, the
local walls (half-way bounce-back, Tamm-Mott-Smith, slip), a constant or
time-dependent uniform body force, and the collision models BGK, MRT/TRT,
Smagorinsky LES (with the compressible or the incompressible equilibrium)
and the entropic ELBM (``--model=elbm``, the compressible equilibrium at
its BC rows); the D2Q9 shallow-water equilibrium; the single-component
Shan-Chen mode, two launches per step: the post-stream density pre-pass
``rho_poststream`` of ``csrc/sc_multi.cu`` (at nk = 1), then the step; and
int16 state buffers under ``--precision=mixed`` (``ops/mixed.py``: the
kernel dequantizes each pulled code in registers and quantizes each stored
value, the math fp32; entries ``lbm_step_mixed_<grid>``). All of that on
D2Q9 and D3Q19; on D3Q15 and D3Q27 the kernel runs BGK (the compressible
or the incompressible equilibrium, every force model, every BC and wall
row) in fp32, built from a library of their own
(``csrc/lbm_step_lattices.cu``), and refuses the other modes by name. The
outflow family's rows (``NTDoNothing``, ``NTCopy``, ``NTYuOutflow``,
``NTNeumann``, ``NTLaminarize``, ``NTGuoDensity``: ``OUTFLOW_TYPES``) run
in instantiations of their own (``csrc/lbm_step_outflow.cu``: BGK, either
equilibrium, every force model, fp32, D2Q9 and D3Q19; entries
``lbm_step_outflow_<grid>``), a laminarize row after a plane-mean pre-pass
of its own (``laminarize_mean_<grid>``, ``mean_into``).

Counterpart of ``sailfish_tpu/ops/pallas_step.py`` (``PallasStep3D``,
``make_kernel_3d``) and ``sailfish_tpu/ops/pallas_step2d.py``
(``PallasStep2D``, ``make_kernel_2d``) in their mask + in-kernel native-BC
(``kbc``) modes and their patch-plane / patch-block mode of the outflow
family (``patch_rows`` :812, :834-843, prologue ``compute_patch_plane``
:2306; ``pallas_step2d.py`` ``patch_blocks`` :57, :138), fp32 or
``mixed`` (int16 codes: ``pallas_step.py:961-978``,
``pallas_step2d.py:128-132``), with and without forcing (Guo,
exact-difference and velocity-shift, ``pallas_step.py:246-341``; a
time-only force is the runtime ``rt_force`` mode, :185-232) and
collision-model modes
(``_feq_i`` :281, ``mrt_pair_rates`` :344, ``_collide_prepass`` :372,
``_mrt_corr`` :452, ``_collide_pair`` :472), shallow-water (the
``_feq_i`` branch :289-294) and ``sc`` modes (``_sc_shift_moments``
:714-785; its pre-pass ``make_rho_kernel_3d`` / ``_2d``, B5 / B6), and of
their patch kernels
``make_bc_patch_kernel_3d`` / ``_2d`` (see ``ops/bc_patch.py``), which on
the TPU also carry the link-tagged walls, TMS and the dynamic BC
families. The kernel itself is ``csrc/lbm_step.cu``; this module
classifies the nodes into kernel mask codes, puts every BC instance and
local wall into one BC table (uniform instances with their scalars,
varying ones with the address of their per-node parameters in the array
of ``ops/bc_patch.py``; half-way and TMS walls one row per type, slip
walls one row per normal axis), checks that a scene is eligible, writes
the values of time-dependent rows and forces before each launch, and
wraps the launch.

Beside the wrapper lives ``step_reference``: the same function (state,
mask codes, BC table, parameter array and link tags in; next state out)
as plain PyTorch, built from the torch engine's phase functions. The tests
use it on the CPU and ``chip_smoke.py`` holds the kernel against it on the
card; the main path never calls it on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import math
import re
from collections import namedtuple

import numpy as np
import torch

from sailfish_tpu_torch import lattice
from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch.ops import bc_patch
from sailfish_tpu_torch.ops import step as st

#: limits of the C table and parameter blocks (csrc/lbm_common.cuh
#: LBM_MAX_Q, LBM_MAX_BC)
MAX_Q = 27
MAX_BC = 16
#: CUDA grid y/z extent limit (one block row per (y, z))
MAX_GRID_YZ = 65535
#: the kernel addresses a node inside its (y, x) plane with a 32-bit int
MAX_PLANE_FLOATS = 2 ** 31 - 1
#: lattices the kernel is instantiated for
KERNEL_GRIDS = ('D2Q9', 'D3Q15', 'D3Q19', 'D3Q27')
#: the lattices whose instantiations are in ``csrc/lbm_step_lattices.cu``
#: (BGK, either equilibrium, every force model, wall rows or not, fp32); a
#: mode they lack is refused by name (``_lattice_reasons``)
OTHER_LATTICES = ('D3Q15', 'D3Q27')
#: the library of the other lattices' instantiations
LATTICES_LIBRARY = 'lbm_step_lattices'
#: the library of the outflow family's instantiations (BGK, either
#: equilibrium, every force model, wall rows on, fp32, D2Q9 and D3Q19) and
#: of the laminarize pre-pass
OUTFLOW_LIBRARY = 'lbm_step_outflow'
#: kernel launches over all ``KernelStep`` objects, counted apart by what
#: the launch computes, the first that applies: ``lbm_step_dyn_<grid>``
#: (a BC row or the body force takes values that change from step to step,
#: written before the launch: the JAX package's dynamic patch planes and
#: ``rt_force``), ``lbm_step_wall_<grid>`` (a half-way, TMS or slip wall
#: row: the kernel instantiation with wall rows; the link-tagged families
#: of the JAX patch kernels), ``lbm_step_mrt_<grid>`` (the MRT/TRT
#: relaxation), ``lbm_step_les_<grid>`` (BGK at the Smagorinsky rate),
#: ``lbm_step_incomp_<grid>`` (the incompressible equilibrium; these three
#: the collision-model mode of the JAX package's kernels), below
#: ``lbm_step_elbm_<grid>`` (the entropic collision, its ELBM mode), after
#: ``lbm_step_sc_<grid>`` (the Shan-Chen mode; its C entry is
#: ``lbm_step_sc_<grid>``) and ``lbm_step_sw_<grid>`` (the shallow-water
#: equilibrium), which rank below the wall rows and above the models,
#: ``lbm_step_force_<grid>`` (a constant body force: the forcing mode),
#: ``lbm_step_vary_<grid>`` (some instance reads per-node parameters: the
#: work of the JAX package's patch kernels) and ``lbm_step_<grid>`` (BGK,
#: compressible, no force, every BC row uniform); one C entry,
#: ``lbm_step_<grid>``, serves all but the Shan-Chen mode. The Shan-Chen
#: mode's pre-pass counts as ``rho_poststream_nk1_<grid>``. Every launch on
#: int16 buffers (``--precision=mixed``, any of the above that the mode
#: takes) counts as ``lbm_step_mixed_<grid>``, its C entry's name, and
#: every launch of a scene with an outflow row (``OUTFLOW_TYPES``) as
#: ``lbm_step_outflow_<grid>``, its C entry's name; that scene's
#: laminarize pre-pass, when it has a laminarize row, as
#: ``laminarize_mean_<grid>``. A launch on a shard's ghost-plane buffers
#: (``parallel/halo.py``) counts under its key with ``ghost_`` after
#: ``lbm_step_`` (``lbm_step_ghost_<kind><grid>``), the Shan-Chen pre-pass
#: of a shard as ``rho_poststream_nk1_ghost_<grid>``, and the laminarize
#: pre-pass over the whole mesh (``parallel/halo.MeshLaminarize``: one
#: launch per step, whatever the shards) as
#: ``laminarize_mean_ghost_<grid>``.
LAUNCH_KINDS = ('', 'vary_', 'force_', 'incomp_', 'les_', 'mrt_', 'elbm_',
                'sw_', 'sc_', 'wall_', 'dyn_', 'mixed_', 'outflow_')
#: the kinds a launch on one of ``OTHER_LATTICES`` can be (BGK only, fp32)
OTHER_LATTICE_KINDS = ('', 'vary_', 'force_', 'incomp_', 'wall_', 'dyn_')
LAUNCHES = dict.fromkeys(
    [f'lbm_step_{v}{g.lower()}' for v in LAUNCH_KINDS
     for g in ('D2Q9', 'D3Q19')]
    + [f'rho_poststream_nk1_{v}{g}' for v in ('', 'ghost_')
       for g in ('d2q9', 'd3q19')]
    + [f'laminarize_mean_{v}{g}' for v in ('', 'ghost_')
       for g in ('d2q9', 'd3q19')]
    + [f'lbm_step_{v}{g.lower()}' for v in OTHER_LATTICE_KINDS
       for g in OTHER_LATTICES]
    + [f'lbm_step_ghost_{v}{g.lower()}' for v in LAUNCH_KINDS
       for g in ('D2Q9', 'D3Q19')]
    + [f'lbm_step_ghost_{v}{g.lower()}' for v in OTHER_LATTICE_KINDS
       for g in OTHER_LATTICES], 0)
#: rewrites of a block of the per-node parameter array before a launch (a
#: space- and time-dependent BC row), over all ``KernelStep`` objects, per
#: lattice: each is a few small PyTorch launches on the kernel's stream
BCP_REWRITES = dict.fromkeys((f'bcp_{g.lower()}' for g in KERNEL_GRIDS), 0)
#: force model -> its code in the kernel's parameter block
#: (csrc/lbm_common.cuh FORCE_*); 0 is no force
FORCE_CODES = {name: 1 + i for i, name in enumerate(st.FORCE_MODELS)}
#: collision model -> its code in the parameter block (csrc/lbm_common.cuh
#: MODEL_*): TRT is MRT with the same rate vector
MODEL_CODES = {'bgk': 0, 'mrt': 1, 'trt': 1, 'les': 2, 'elbm': 3}
#: equilibrium -> its code in the parameter block (csrc/lbm_common.cuh
#: EQ_*)
EQ_CODES = {'bgk': 0, 'incompressible': 1, 'shallow_water': 2}
#: Shan-Chen potential -> its code (csrc/lbm_common.cuh SC_*)
SC_POTENTIALS = {'linear': 0, 'classic': 1}
#: model code -> the csrc source whose library holds its instantiations
#: (each builds lbm_step.cu with one collision model, so the four compile
#: in parallel)
LIBRARIES = {0: 'lbm_step', 1: 'lbm_step_mrt', 2: 'lbm_step_les',
             3: 'lbm_step_elbm'}
#: the same for the int16 state of --precision=mixed (each source builds
#: lbm_step.cu with LBM_MIXED and one collision model)
MIXED_LIBRARIES = {0: 'lbm_step_mixed', 1: 'lbm_step_mixed_mrt',
                   2: 'lbm_step_mixed_les', 3: 'lbm_step_mixed_elbm'}


def reset_launch_counts():
    """Zero ``LAUNCHES`` and ``BCP_REWRITES`` (before a run whose launches
    are to be counted)."""
    for counts in (LAUNCHES, BCP_REWRITES):
        for name in counts:
            counts[name] = 0


#: node type -> BC kind of csrc/lbm_common.cuh (native BCs: even
#: velocity, odd density; then the local walls)
BC_KINDS = {
    nt.NTEquilibriumVelocity: 0, nt.NTEquilibriumDensity: 1,
    nt.NTZouHeVelocity: 2, nt.NTZouHeDensity: 3,
    nt.NTRegularizedVelocity: 4, nt.NTRegularizedDensity: 5,
    nt.NTHalfBBWall: 6, nt.NTWallTMS: 7, nt.NTSlip: 8,
    nt.NTDoNothing: 9, nt.NTCopy: 10, nt.NTYuOutflow: 11, nt.NTNeumann: 12,
    nt.NTLaminarize: 13, nt.NTGuoDensity: 14,
}
#: the wall kinds: rows that read the link-tag map (half-way, TMS) or
#: store a slip reflection, served by the kernel instantiation with walls
WALL_TYPES = st.LINK_TAG_TYPES + (nt.NTSlip,)
#: the outflow family's rows, served by the outflow instantiations
#: (``OUTFLOW_LIBRARY``); ``NTGradFreeflow`` nodes collide as fluid nodes
#: (mask code 0) and ``NTExtendedCopy`` is refused
#: (``step.OUTFLOW_TYPES``)
OUTFLOW_TYPES = st.FIX_TYPES + (nt.NTGuoDensity,)

#: one BC-table row: node type id, orientation code (1-based, into
#: grid.orientation_vectors; 0 for the half-way and TMS rows, whose
#: geometry is in each node's link tags; a slip row, which serves both
#: orientations of one normal axis, holds the first), prescribed density
#: and velocity (x, y, z), and for an instance whose parameters vary from
#: node to node the ``bc_patch.Box`` of its block in the parameter array
#: (else None; the scalars then hold the values at the instance's first
#: node and are not read)
BCRow = namedtuple('BCRow', ('type_id', 'orientation', 'rho', 'u', 'box'),
                   defaults=(None,))


def classify_nodes(maps):
    """Mask codes for the kernel (``pallas_step.py:62-119``).

    Returns (mask, instances, reasons): ``mask`` is uint8 (*S) with
    0 = collide (fluid, and ``NTGradFreeflow``, which collides as a fluid
    node in both JAX engines: ``step.OUTFLOW_TYPES``), 1 = reflect
    (``NTFullBBWall``), 2 = keep (excluded and propagation-only nodes),
    3+j = row j of the BC table; ``instances`` is the list of (type_id,
    orientation, node selection) in code order: one per native-BC or
    outflow (type, orientation), one per half-way / TMS wall type
    (orientation 0) and one per slip normal axis; ``reasons`` names every
    node class the kernel cannot take (``NTExtendedCopy``)."""
    tm = maps.type_map
    mask = np.zeros(tm.shape, dtype=np.uint8)
    instances = []
    reasons = []
    for tid in maps.present_types:
        cls = nt.get_node_type(tid)
        sel = tm == tid
        if tid == nt._NTFluid.id or cls is nt.NTGradFreeflow:
            continue
        if cls is nt.NTExtendedCopy:
            reasons.append('node type NTExtendedCopy (its gathers read the '
                           'whole domain; the JAX runner keeps it off its '
                           'kernels too, sailfish_tpu/runner.py:346-349; '
                           '--engine=torch runs it)')
            continue
        if cls is nt.NTFullBBWall:
            mask[sel] = 1
        elif cls.excluded or cls.propagation_only:
            mask[sel] = 2
        elif cls in st.LINK_TAG_TYPES:
            instances.append((tid, 0, sel))
        elif cls in BC_KINDS:
            ks = np.unique(maps.orientation[sel])
            if 0 in ks:
                reasons.append(f'{cls.__name__} nodes without a '
                               'detected orientation')
            if cls is nt.NTSlip:
                for axis in sorted({(int(k) - 1) // 2 for k in ks if k}):
                    pair = (2 * axis + 1, 2 * axis + 2)
                    instances.append((tid, pair[0], sel & np.isin(
                        maps.orientation, pair)))
                continue
            for k in ks:
                if k:
                    instances.append(
                        (tid, int(k), sel & (maps.orientation == int(k))))
        else:
            reasons.append(f'node type {cls.__name__}')
    if len(instances) > MAX_BC:
        reasons.append(f'{len(instances)} BC instances (the kernel takes '
                       f'at most {MAX_BC})')
    else:
        for j, (_tid, _k, inst) in enumerate(instances):
            mask[inst] = 3 + j
    return mask, instances, reasons


def bc_table(maps, instances, boxes=None):
    """One ``BCRow`` per instance, holding its prescribed parameters at its
    first node (the parameters of a uniform instance; the scalar of a
    Neumann or laminarize row in rho's place) and its entry of ``boxes``
    (``bc_patch.instance_boxes``; default: all uniform)."""
    rows = []
    boxes = boxes or [None] * len(instances)
    for (tid, k, sel), box in zip(instances, boxes):
        cls = nt.get_node_type(tid)
        rho, vel = 1.0, [0.0, 0.0, 0.0]
        if cls in st.SCALAR_TYPES:
            rho = float(maps.param_scalar[sel][0])
        elif 'velocity' in cls.param_names:
            for a in range(maps.param_vel.shape[0]):
                vel[a] = float(maps.param_vel[a][sel][0])
        elif 'density' in cls.param_names:
            rho = float(maps.param_rho[sel][0])
        rows.append(BCRow(tid, k, rho, tuple(vel), box))
    return rows


def kernel_ineligibility(builder, nodes=None):
    """Reasons the kernel cannot run ``builder``'s scene (empty when it
    can); ``nodes`` is ``classify_nodes`` of its maps when the caller has
    it (which refuses ``NTExtendedCopy``; the outflow rows' own refusals
    are ``_outflow_reasons``); an MRT
    rate vector that does not split into one even and one odd rate
    (``mrt_pair_rates``) is refused here, and so are, by name, the
    product-form equilibrium (``--entropic_equilibrium``: the JAX runner
    keeps it off its kernels too, ``sailfish_tpu/runner.py:375-376``) and
    ELBM with the incompressible equilibrium at its BC rows (the kernel's
    ELBM mode is built with the compressible one). A body force that
    varies from node to node, constant or a DynamicValue of space, runs on
    the torch engine only (the JAX runner
    keeps it off its kernels too, ``sailfish_tpu/runner.py:386-395``,
    ``pallas_step.py:2608-2612``). So do what the JAX runner keeps off its
    Shan-Chen and shallow-water kernels (``sailfish_tpu/runner.py:355-385``,
    ``pallas_step.py:2603-2608``, ``pallas_step2d.py:1313-1316``):
    Shan-Chen with a model other than BGK, with a body force other than a
    constant Guo one, with BC rows (native BCs, half-way, TMS or slip
    walls: patch rows in JAX) or with the shallow-water equilibrium; the
    shallow-water equilibrium with a model other than BGK (or the
    incompressible flag, which has no shallow-water form) or with EDM."""
    reasons = []
    if builder.force_expr is not None:
        if st.is_space_dependent(builder.force_expr):
            reasons.append('space-dependent DynamicValue body force (the '
                           'kernel takes one acceleration per step; '
                           '--engine=torch runs it)')
    elif builder.body_force is not None \
            and np.ndim(builder.body_force) > 1:
        reasons.append('space-varying body force (the kernel takes one '
                       'constant acceleration; --engine=torch runs a '
                       'per-node field)')
    if builder.grid.name not in KERNEL_GRIDS:
        reasons.append(f'lattice {builder.grid.name} (the kernel is built '
                       f'for {", ".join(KERNEL_GRIDS)})')
    if builder.dtype != torch.float32:
        reasons.append(f'{builder.dtype} (the kernel is fp32 only)')
    if builder.equilibrium == 'elbm':
        reasons.append('equilibrium=elbm (the product-form equilibrium of '
                       '--entropic_equilibrium; --engine=torch runs it)')
    if builder.model == 'elbm' and builder.incompressible:
        reasons.append('model=elbm with --incompressible (the kernel\'s '
                       'ELBM mode reconstructs its BC rows with the '
                       'compressible equilibrium; --engine=torch runs it)')
    if builder.mrt_rates is not None:
        try:
            mrt_pair_rates(builder.grid, builder.mrt_rates)
        except NotImplementedError as exc:
            reasons.append(str(exc))
    shape = builder.maps.type_map.shape
    if any(s > MAX_GRID_YZ for s in shape[:-1]):
        reasons.append(f'domain {shape}: y and z extents above '
                       f'{MAX_GRID_YZ}')
    if shape[-1] * shape[-2] > MAX_PLANE_FLOATS:
        reasons.append(f'domain {shape}: {shape[-1] * shape[-2]} nodes in '
                       f'one (y, x) plane (the kernel indexes at most '
                       f'{MAX_PLANE_FLOATS})')
    _mask, instances, why = nodes or classify_nodes(builder.maps)
    reasons += why
    if not why:
        reasons += bc_patch.instance_boxes(builder.maps, instances)[1]
    reasons += _mode_reasons(builder, instances)
    reasons += _mixed_reasons(builder)
    reasons += _lattice_reasons(builder)
    reasons += _outflow_reasons(builder, instances)
    return reasons


def _outflow_reasons(builder, instances):
    """The refusals of the outflow rows: the kernel's outflow
    instantiations are BGK (either equilibrium, every force model) in
    fp32 on D2Q9 and D3Q19; the rest is refused by name (the JAX kernels
    take MRT, LES, ELBM and int16 state in their patch-plane mode, and
    ROADMAP.md lists them as still to port; the Shan-Chen mode refuses
    every BC row in ``_mode_reasons``). An ``NTGuoDensity`` node reads the
    post-stream values of x + n as pulled: a neighbour there whose values
    ``fix_missing`` replaces (a half-way, TMS or outflow node) is refused
    too."""
    kinds = sorted({nt.get_node_type(tid).__name__
                    for tid, _k, _sel in instances
                    if nt.get_node_type(tid) in OUTFLOW_TYPES})
    if not kinds:
        return []
    rows = f'outflow rows ({", ".join(kinds)})'
    why = '; --engine=torch runs it)'
    reasons = []
    if builder.model != 'bgk' or builder.smagorinsky > 0.0:
        reasons.append(f'{rows} with {_model_name(builder)} (the kernel\'s '
                       f'outflow instantiations are BGK only{why}')
    if getattr(builder, 'mixed', None) is not None:
        reasons.append(f'{rows} under --precision=mixed (the kernel\'s '
                       f'outflow instantiations are fp32 only{why}')
    if builder.grid.name in OTHER_LATTICES:
        reasons.append(f'{rows} on {builder.grid.name} (the kernel\'s '
                       f'outflow instantiations are built for D2Q9 and '
                       f'D3Q19 only{why}')
    if builder.equilibrium == 'shallow_water':
        reasons.append(f'{rows} with the shallow-water equilibrium (the '
                       f'kernel\'s outflow instantiations take the '
                       f'second-order equilibria only{why}')
    tm = builder.maps.type_map
    fixed = np.isin(tm, [c.id for c in st.FIX_TYPES + st.LINK_TAG_TYPES
                         + (nt.NTExtendedCopy,)])
    for tid, k, sel in instances:
        if nt.get_node_type(tid) is not nt.NTGuoDensity:
            continue
        n = builder.grid.orientation_vectors[k - 1]
        if (st.sample(torch.as_tensor(fixed), n).numpy() & sel).any():
            reasons.append(f'NTGuoDensity (orientation {k}) beside a node '
                           'whose missing distributions are replaced (a '
                           'half-way, TMS or outflow node at x + n; '
                           '--engine=torch runs it)')
    return reasons


def _lattice_reasons(builder):
    """The modes of the kernel that are built for D2Q9 and D3Q19 only: on
    the ``OTHER_LATTICES`` the kernel runs BGK (either equilibrium, every
    force model, wall rows or not) in fp32, and refuses the rest by name
    (the JAX kernel takes them on any lattice; ROADMAP.md lists them as
    still to port)."""
    name = builder.grid.name
    if name not in OTHER_LATTICES:
        return []
    why = 'is built for D2Q9 and D3Q19 only; --engine=torch runs it'
    reasons = []
    if builder.model in ('mrt', 'trt', 'elbm'):
        reasons.append(f'model={builder.model} on {name} (the kernel\'s '
                       f'{builder.model.upper()} mode {why})')
    elif builder.smagorinsky > 0.0:
        reasons.append(f'the Smagorinsky LES model on {name} (the kernel\'s '
                       f'LES mode {why})')
    if builder.sc_coupling != 0.0:
        reasons.append(f'Shan-Chen on {name} (the kernel\'s SC mode {why})')
    if builder.equilibrium == 'shallow_water':
        reasons.append(f'shallow water on {name} (D2Q9 only)')
    if getattr(builder, 'mixed', None) is not None:
        reasons.append(f'--precision=mixed on {name} (the kernel\'s int16 '
                       f'mode {why})')
    return reasons


def _mixed_reasons(builder):
    """The refusals of int16 storage: what the ``StepBuilder`` refuses
    under it (``sailfish_tpu/ops/step.py:128-144``), named again here for
    a builder made otherwise; JAX's mixed Pallas path takes every other
    single-fluid BGK / MRT / LES scene."""
    if getattr(builder, 'mixed', None) is None:
        return []
    reasons = []
    if builder.dtype != torch.float32:
        reasons.append('mixed 16-bit storage requires fp32 compute')
    if builder.sc_coupling != 0.0:
        reasons.append('mixed 16-bit storage does not cover Shan-Chen')
    if builder.equilibrium != 'bgk':
        reasons.append('mixed 16-bit storage covers the standard '
                       f'equilibrium only (got {builder.equilibrium})')
    return reasons


def _model_name(builder):
    """The collision model of ``builder`` as the refusals name it."""
    if builder.model == 'bgk' and builder.smagorinsky > 0.0:
        return 'the Smagorinsky LES model'
    return f'model={builder.model}'


def _mode_reasons(builder, instances):
    """The refusals of the Shan-Chen and shallow-water modes (see
    ``kernel_ineligibility``); ``instances`` are the BC-table rows of
    ``classify_nodes``."""
    reasons = []
    sw = builder.equilibrium == 'shallow_water'
    fm = builder.force_model if builder.body_force is not None else None
    if builder.sc_coupling != 0.0:
        if builder.model != 'bgk' or builder.smagorinsky > 0.0:
            reasons.append(f'Shan-Chen with {_model_name(builder)} (the '
                           'kernel\'s Shan-Chen mode is BGK only; '
                           '--engine=torch runs it)')
        if builder.incompressible:
            reasons.append('Shan-Chen with the incompressible equilibrium')
        if sw:
            reasons.append('Shan-Chen with the shallow-water equilibrium')
        if builder.force_expr is not None:
            reasons.append('Shan-Chen with a DynamicValue body force (the '
                           'kernel\'s Shan-Chen mode takes a constant Guo '
                           'force)')
        elif fm is not None and fm != 'guo':
            reasons.append(f'Shan-Chen with the {fm} body force (the '
                           'kernel\'s Shan-Chen mode takes a constant Guo '
                           'force)')
        kinds = sorted({nt.get_node_type(tid).__name__
                        for tid, _k, _sel in instances})
        if kinds:
            reasons.append(f'Shan-Chen with BC rows ({", ".join(kinds)}; '
                           'the kernel\'s Shan-Chen mode takes full '
                           'bounce-back walls only, --engine=torch runs '
                           'them)')
    if sw:
        if builder.model != 'bgk' or builder.smagorinsky > 0.0:
            reasons.append(f'shallow water with {_model_name(builder)} (the '
                           'kernel\'s shallow-water equilibrium is BGK '
                           'only; --engine=torch runs it)')
        if builder.incompressible:
            reasons.append('shallow water with --incompressible')
        if fm == 'edm':
            reasons.append('shallow water with the edm body force (EDM '
                           'shifts the second-order equilibrium; '
                           '--engine=torch runs it)')
    return reasons


def box_params(row, bcp, shape):
    """Full-shape prescribed fields (rho (*S), u (dim, *S)) of the varying
    table row ``row``: its block of the parameter array ``bcp`` inside its
    box, rho = 1 and u = 0 elsewhere (no node of the instance lies
    there)."""
    dim = len(shape)
    ext = tuple(reversed(row.box.ext[:dim]))
    n = (1 + dim) * int(np.prod(ext))
    block = bcp[row.box.offset:row.box.offset + n].reshape((1 + dim,) + ext)
    full = torch.zeros((1 + dim,) + tuple(shape), dtype=bcp.dtype,
                       device=bcp.device)
    full[0] = 1.0
    full[(slice(None),) + bc_patch.box_slices(row.box, dim)] = block
    return full[0], full[1:]


def step_reference(f, mask, table, grid, tau_inv, bcp=None, force=None,
                   force_model='guo', tags=None, rates=None,
                   smagorinsky=0.0, incompressible=False, equilibrium='bgk',
                   gravity=0.0, sc_coupling=0.0, sc_potential='linear',
                   sc_rho=None, mixed=None, elbm=None, lam_means=None):
    """Plain PyTorch version of the kernel: one step
    of state ``f`` (Q, *S) under uint8 mask codes ``mask`` (*S) and BC
    table ``table`` (list of ``BCRow``), with relaxation rate ``tau_inv``.
    A row with a box takes each node's rho and u from the fp32 parameter
    array ``bcp`` (``bc_patch.param_array``). The nodes of a half-way or
    TMS row fix the links that the int32 map ``tags`` (the node-type map's
    ``link_tags``) marks as missing; slip rows are dry and store the
    reflection of their axis. ``force`` is a uniform acceleration (x, y[,
    z]) acting on every colliding node, BC nodes included, by
    ``force_model``. The collision is MRT with the rate vector ``rates``
    when it is given, else BGK, at the local Smagorinsky rate when
    ``smagorinsky`` > 0, with the incompressible equilibrium when
    ``incompressible``, or with ``equilibrium`` 'shallow_water' the D2Q9
    shallow-water one at ``gravity``, or with ``elbm`` (a
    ``step.Entropic``: tau and the Newton stops) the entropic collision.
    With ``sc_coupling`` G != 0 (the
    Shan-Chen mode) the neighbours' psi comes from ``sc_rho``, the density
    the pre-pass wrote (default: ``sc_multi.rho_reference`` of ``f``). With
    ``mixed`` (an ``ops/mixed.MixedScales``) ``f`` holds int16 codes: they
    are dequantized, stepped and the result quantized, int16 out.
    ``lam_means``: the laminarize rows' plane means ({orientation: (Q,
    ...) tensor}, ``KernelStep.lam_spread``) when a mesh pre-pass computed
    them, else they are computed here. The phases are the torch engine's
    (``step.step_phases``)."""
    if mixed is not None:
        return mixed.quant(step_reference(
            mixed.dequant(f), mask, table, grid, tau_inv, bcp, force,
            force_model, tags, rates, smagorinsky, incompressible,
            equilibrium, gravity, sc_coupling, sc_potential, sc_rho,
            elbm=elbm))
    ones = (1,) * (f.dim() - 1)
    instances, slip = [], []
    tagged = tms = None
    for j, row in enumerate(table):
        cls = nt.get_node_type(row.type_id)
        sel = mask == 3 + j
        if cls in st.LINK_TAG_TYPES:
            tagged = sel if tagged is None else tagged | sel
            if cls is nt.NTWallTMS:
                tms = sel if tms is None else tms | sel
            continue
        if cls is nt.NTSlip:
            slip.append(((row.orientation - 1) // 2, sel))
            continue
        if row.box is not None:
            rho_bc, vel_bc = box_params(row, bcp.to(f.dtype), mask.shape)
        else:
            rho_bc = torch.tensor(row.rho, dtype=f.dtype,
                                  device=f.device).reshape(ones)
            vel_bc = torch.tensor(row.u[:grid.dim], dtype=f.dtype,
                                  device=f.device).reshape(
                                      (grid.dim,) + ones)
        instances.append((cls, row.orientation, sel, rho_bc, vel_bc))
    planes = None
    if tagged is not None:
        planes = st.tag_planes(grid, tags, f.device) & tagged[None]
    wet = (mask == 0) | (mask >= 3)
    for _axis, sel in slip:
        wet = wet & ~sel
    if force is not None:
        force = torch.tensor(force[:grid.dim], dtype=f.dtype,
                             device=f.device).reshape((grid.dim,) + ones)
    if sc_coupling != 0.0 and sc_rho is None:
        from sailfish_tpu_torch.ops import sc_multi
        sc_rho = sc_multi.rho_reference(f, grid)
    return st.step_phases(
        grid, st.gather(grid, f), f, tau_inv, instances, wet=wet,
        fullbb=mask == 1, slip=slip, tags=planes, tms=tms, force=force,
        force_model=force_model, incompressible=incompressible, rates=rates,
        smagorinsky=smagorinsky,
        feq=st.equilibrium_fn(grid, incompressible, equilibrium, gravity),
        sc_coupling=sc_coupling, sc_potential=sc_potential, sc_rho=sc_rho,
        elbm=elbm, lam_means=lam_means)


class _BC(ctypes.Structure):
    _fields_ = [('kind', ctypes.c_int), ('axis', ctypes.c_int),
                ('sign', ctypes.c_int), ('rho', ctypes.c_float),
                ('u', ctypes.c_float * 3)]


class _Vary(ctypes.Structure):
    _fields_ = [('varies', ctypes.c_int), ('lo', ctypes.c_int * 3),
                ('ext', ctypes.c_int * 3), ('offset', ctypes.c_int)]


class _Force(ctypes.Structure):
    _fields_ = [('model', ctypes.c_int), ('a', ctypes.c_float * 3),
                ('shift', ctypes.c_float * 3), ('pref', ctypes.c_float)]


class _Collide(ctypes.Structure):
    _fields_ = [('model', ctypes.c_int), ('equilibrium', ctypes.c_int),
                ('s_e', ctypes.c_float), ('s_o', ctypes.c_float),
                ('tau', ctypes.c_float), ('tau2', ctypes.c_float),
                ('les_c', ctypes.c_float), ('gravity', ctypes.c_float)]


class _ShanChen(ctypes.Structure):
    _fields_ = [('potential', ctypes.c_int), ('g', ctypes.c_float),
                ('tau', ctypes.c_float)]


class _Entropic(ctypes.Structure):
    _fields_ = [('beta', ctypes.c_float), ('entropy_tol', ctypes.c_float),
                ('alpha_tol', ctypes.c_float)]


class _Mixed(ctypes.Structure):
    _fields_ = [('ws', ctypes.c_float * MAX_Q),
                ('inv_ws', ctypes.c_float * MAX_Q)]


def mixed_params(mixed):
    """The int16 grid's constants ``ws`` and ``inv_ws`` of the
    ``MixedScales`` ``mixed`` for the mixed entries (``csrc/lbm_common.cuh``
    LBMMixed); the weights are the kernel's compile-time ones."""
    m = _Mixed()
    for i, (ws, inv) in enumerate(zip(mixed.ws, mixed.inv_ws)):
        m.ws[i] = ws
        m.inv_ws[i] = inv
    return m


class _Outflow(ctypes.Structure):
    _fields_ = [('lam_entry', ctypes.c_int * MAX_BC),
                ('lam_lo', ctypes.c_int * MAX_BC)]


class _Params(ctypes.Structure):
    _fields_ = [('nx', ctypes.c_int), ('ny', ctypes.c_int),
                ('nz', ctypes.c_int), ('nbc', ctypes.c_int),
                ('tau_inv', ctypes.c_float),
                ('bc', _BC * MAX_BC), ('vary', _Vary * MAX_BC),
                ('force', _Force), ('coll', _Collide), ('sc', _ShanChen),
                ('elbm', _Entropic), ('out', _Outflow)]


class _Tables(ctypes.Structure):
    _fields_ = [('q', ctypes.c_int), ('dim', ctypes.c_int),
                ('c', (ctypes.c_int * 3) * MAX_Q),
                ('w', ctypes.c_float * MAX_Q),
                ('opp', ctypes.c_int * MAX_Q),
                ('slip', (ctypes.c_int * MAX_Q) * 3),
                ('minv', (ctypes.c_float * 4) * MAX_Q),
                ('logw', ctypes.c_float * MAX_Q)]


def mrt_conserved_columns(grid):
    """(Q, 1 + dim) float64: the columns of ``grid.mrt_inv`` of the
    conserved moments (density, then momentum along x, y[, z]), with the
    round-off entries of the inversion (below 1e-12) set to 0. Raises
    RuntimeError unless the conserved rows of ``grid.mrt_matrix`` are the
    ones and c_a, which is what the kernel sums its moments with."""
    cons = [int(k) for k in grid.mrt_conserved]
    rows = np.vstack([np.ones(grid.Q)] + [grid.basis[:, a]
                                          for a in range(grid.dim)])
    if cons != list(range(1 + grid.dim)) or not np.array_equal(
            grid.mrt_matrix[cons], rows):
        raise RuntimeError(f'the conserved MRT moments of {grid.name} are '
                           'not (1, c_x, c_y[, c_z])')
    cols = grid.mrt_inv[:, cons].copy()
    cols[np.abs(cols) < 1e-12] = 0.0
    return cols


def lattice_tables(grid):
    """``_Tables`` filled from ``sailfish_tpu_torch.lattice``: what the
    kernel's ``lbm_lattice_tables`` must copy out for ``grid`` (entries
    beyond Q, the z component in 2D, the slip permutation of the z axis in
    2D and the M^-1 column of the z momentum in 2D are 0); ``logw`` is the
    float64 ln w_i rounded to float32, as ``ops/entropic.py`` rounds it."""
    t = _Tables()
    t.q, t.dim = grid.Q, grid.dim
    minv = mrt_conserved_columns(grid)
    for i in range(grid.Q):
        for a in range(grid.dim):
            t.c[i][a] = int(grid.basis[i][a])
        t.w[i] = float(grid.weights[i])
        t.opp[i] = int(grid.opposite[i])
        t.logw[i] = math.log(float(grid.weights[i]))
        for k in range(1 + grid.dim):
            t.minv[i][k] = float(minv[i, k])
    for a in range(grid.dim):
        for i, j in enumerate(grid.slip_swap(a)):
            t.slip[a][i] = int(j)
    return t


def check_tables(tables, grid):
    """Raise RuntimeError unless the ``_Tables`` ``tables`` (the kernel's
    compile-time tables of one lattice) equal ``lattice_tables(grid)``,
    every integer exactly and every weight and M^-1 entry to the last bit
    of its float32."""
    ref = lattice_tables(grid)
    bad = [name for name, _ in _Tables._fields_
           if not np.array_equal(np.asarray(getattr(tables, name)),
                                 np.asarray(getattr(ref, name)))]
    if bad:
        raise RuntimeError(
            f'the compile-time {grid.name} tables of '
            f'csrc/lattice_tables.cuh differ from '
            f'sailfish_tpu_torch.lattice in {", ".join(bad)}')


def set_force(p, grid, force, force_model, tau_inv):
    """Write the uniform acceleration ``force`` (x, y[, z]) into the block
    ``p``: the model's code, the acceleration, the equilibrium-velocity
    shift s a (s = 1/2 for Guo, tau for the velocity shift, 0 for the
    exact-difference method) and the Guo prefactor 1 - 1/(2 tau), each
    computed in fp64 and stored as fp32."""
    s = {'guo': 0.5, 'velocity_shift': 1.0 / tau_inv,
         'edm': 0.0}[force_model]
    p.force.model = FORCE_CODES[force_model]
    p.force.pref = 1.0 - 0.5 * tau_inv
    for a in range(grid.dim):
        p.force.a[a] = force[a]
        p.force.shift[a] = s * force[a]


def mrt_pair_rates(grid, rates):
    """(s_e, s_o): the one rate of the even and the one of the odd
    non-conserved moments of the MRT rate vector ``rates``
    (``pallas_step.py:344-369``), which the kernel's parity split relaxes
    with. Raises NotImplementedError, naming it, for a vector with two
    different rates of one parity; the Gram-Schmidt rates of
    ``Grid.mrt_relaxation_rates`` always split."""
    rates = np.asarray(rates, dtype=np.float64)
    cons = set(int(k) for k in grid.mrt_conserved)
    split = {}
    for k in range(grid.Q):
        if k in cons:
            continue
        parity = 'even' if grid.mrt_parity[k] > 0 else 'odd'
        if abs(split.setdefault(parity, rates[k]) - rates[k]) > 1e-12:
            raise NotImplementedError(
                f'an MRT rate vector with more than one {parity} rate (the '
                'kernel relaxes the parity-split TRT form; --engine=torch '
                'runs any vector)')
    return float(split['even']), float(split['odd'])


def set_collision(p, grid, tau_inv, rates=None, smagorinsky=0.0,
                  incompressible=False, equilibrium='bgk', gravity=0.0,
                  elbm=None):
    """Write the collision model into the block ``p``: ELBM (code 3, and
    in ``p.elbm`` beta = 1 / (2 tau) and the Newton stops of ``elbm``, a
    ``step.Entropic``, beta computed in fp64; the Smagorinsky constant is
    ignored, as the JAX engine ignores it) when ``elbm`` is given, else MRT
    (code 1, its even and odd rates from ``mrt_pair_rates``) when
    ``rates`` is given, else LES (code 2: tau, tau^2 and 36 C^2, computed
    in fp64) when ``smagorinsky`` > 0, else BGK (code 0); and the
    equilibrium (``EQ_CODES``: 'shallow_water' with its ``gravity``, else
    the compressible or the incompressible one)."""
    c = p.coll
    if equilibrium == 'shallow_water':
        c.equilibrium = EQ_CODES['shallow_water']
        c.gravity = gravity
    else:
        c.equilibrium = EQ_CODES['incompressible' if incompressible
                                 else 'bgk']
    if elbm is not None:
        c.model = MODEL_CODES['elbm']
        p.elbm.beta = 1.0 / (2.0 * elbm.tau)
        p.elbm.entropy_tol = elbm.entropy_tol
        p.elbm.alpha_tol = elbm.alpha_tol
    elif rates is not None:
        c.model = MODEL_CODES['mrt']
        c.s_e, c.s_o = mrt_pair_rates(grid, rates)
    elif smagorinsky > 0.0:
        c.model = MODEL_CODES['les']
        tau = 1.0 / tau_inv
        c.tau, c.tau2 = tau, tau * tau
        c.les_c = 36.0 * smagorinsky ** 2
    else:
        c.model = MODEL_CODES['bgk']


def set_row(p, j, rho, u):
    """Write the prescribed density and velocity (x, y, z) of BC row ``j``
    into the block ``p``."""
    p.bc[j].rho = rho
    for a in range(3):
        p.bc[j].u[a] = u[a]


def kernel_params(grid, shape, table, tau_inv, force=None,
                  force_model='guo', rates=None, smagorinsky=0.0,
                  incompressible=False, equilibrium='bgk', gravity=0.0,
                  sc_coupling=0.0, sc_potential='linear', elbm=None):
    """The kernel's by-value parameter block: domain extents, relaxation
    rate, the BC table, behind it where each varying row's per-node
    parameters lie, the body force (``set_force``; None: model code 0,
    no force), the collision model and equilibrium (``set_collision``)
    and the Shan-Chen mode's potential code, coupling and tau (read only
    by that mode's instantiations). A row's axis and sign are those of its
    orientation (0 for the half-way and TMS rows). The lattice tables are
    compile-time in the kernel (``check_tables``)."""
    p = _Params()
    nz, ny, nx = (1,) * (3 - len(shape)) + tuple(shape)
    p.nx, p.ny, p.nz = nx, ny, nz
    p.nbc = len(table)
    p.tau_inv = tau_inv
    for j, row in enumerate(table):
        p.bc[j].kind = BC_KINDS[nt.get_node_type(row.type_id)]
        if row.orientation:
            n = grid.orientation_vectors[row.orientation - 1]
            axis = int(np.flatnonzero(n)[0])
            p.bc[j].axis = axis
            p.bc[j].sign = int(n[axis])
        set_row(p, j, row.rho, row.u)
        if row.box is not None:
            p.vary[j].varies = 1
            p.vary[j].offset = row.box.offset
            for a in range(3):
                p.vary[j].lo[a] = row.box.lo[a]
                p.vary[j].ext[a] = row.box.ext[a]
    if force is not None:
        set_force(p, grid, force, force_model, tau_inv)
    set_collision(p, grid, tau_inv, rates, smagorinsky, incompressible,
                  equilibrium, gravity, elbm)
    p.sc.potential = SC_POTENTIALS[sc_potential]
    p.sc.g = sc_coupling
    p.sc.tau = 1.0 / tau_inv
    return p


#: names of the template parameters of ``lbm_step_kernel``, in order (the
#: storage type is read from its mangled letter; ``outflow`` is False in an
#: older build's names, which lack it)
INSTANCE_PARAMS = ('dim', 'q', 'force', 'walls', 'model', 'equilibrium',
                   'sc', 'storage', 'outflow')


def instantiation(fn):
    """The template arguments of the ``lbm_step_kernel`` instantiation
    whose mangled name is ``fn``, as {name of ``INSTANCE_PARAMS``: value}
    (``force``, ``model`` and ``equilibrium`` by their names, ``walls``,
    ``sc`` and ``outflow`` as bools, ``storage`` 'fp32' or 'int16'), or
    None for another function. A name with fewer arguments (an older
    build's, without the outflow switch or the storage type: fp32) gets
    the ones it has; an older build's sixth argument, the bool
    ``incompressible``, keeps that name."""
    m = re.search(r'lbm_step_kernelI((?:L[ib]n?\d+E)+)([fs]?)(Lb[01]E)?E',
                  fn)
    if not m:
        return None
    args = re.findall(r'L([ib])(n?)(\d+)E', m.group(1))
    vals = [(-1 if sign else 1) * int(num) for _kind, sign, num in args]
    out = dict(zip(INSTANCE_PARAMS, vals))
    if m.group(2):
        out['storage'] = 'int16' if m.group(2) == 's' else 'fp32'
    if m.group(3):
        out['outflow'] = m.group(3) == 'Lb1E'
    out['force'] = (('none',) + st.FORCE_MODELS)[out['force']]
    for key in ('walls', 'sc'):
        if key in out:
            out[key] = bool(out[key])
    if 'model' in out:
        out['model'] = ('bgk', 'mrt', 'les', 'elbm')[out['model']]
    if 'equilibrium' in out:
        if args[5][0] == 'b':
            out['incompressible'] = bool(out.pop('equilibrium'))
        else:
            out['equilibrium'] = tuple(EQ_CODES)[out['equilibrium']]
    return out


def kernel_function(lib, name):
    """The C entry ``name`` (``lbm_step_<grid>``, the Shan-Chen mode's
    ``lbm_step_sc_<grid>`` or the int16 state's ``lbm_step_mixed_<grid>``;
    grid ``d2q9`` / ``d3q19``, or ``d3q15`` / ``d3q27`` of
    ``csrc/lbm_step_lattices.cu``) of a loaded ``csrc/lbm_step.cu`` library,
    typed for ``ctypes``, after checking that the library's parameter
    blocks match ``_Params`` (and, for a mixed entry, ``_Mixed``) and that
    the compile-time tables of the entry's lattice match
    ``sailfish_tpu_torch.lattice`` (``check_tables``)."""
    lib.lbm_params_size.restype = ctypes.c_int
    if lib.lbm_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError('LBMParams layout differs between '
                           'csrc/lbm_common.cuh and ops/lbm_step.py')
    mixed = name.startswith('lbm_step_mixed_')
    if mixed:
        lib.lbm_mixed_size.restype = ctypes.c_int
        if lib.lbm_mixed_size() != ctypes.sizeof(_Mixed):
            raise RuntimeError('LBMMixed layout differs between '
                               'csrc/lbm_common.cuh and ops/lbm_step.py')
    lib.lbm_tables_size.restype = ctypes.c_int
    if lib.lbm_tables_size() != ctypes.sizeof(_Tables):
        raise RuntimeError('LBMTables layout differs between '
                           'csrc/lbm_common.cuh and ops/lbm_step.py')
    grid = lattice.get_grid(name.rsplit('_', 1)[1].upper())
    tables = _Tables()
    lib.lbm_lattice_tables.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(_Tables)]
    lib.lbm_lattice_tables.restype = ctypes.c_int
    if lib.lbm_lattice_tables(grid.dim, grid.Q, ctypes.byref(tables)) != 0:
        raise RuntimeError(f'csrc/lattice_tables.cuh has no {grid.name}')
    check_tables(tables, grid)
    fn = getattr(lib, name)
    # lbm_step_<grid>: (a, b, mask, bcp, tags, params, stream);
    # lbm_step_sc_<grid>: (a, rho_pre, b, mask, params, stream);
    # lbm_step_mixed_<grid>: (a, b, mask, bcp, tags, params, mixed, stream);
    # lbm_step_outflow_<grid>: (a, b, mask, bcp, tags, lam, params, stream)
    n_ptr = 4 if name.startswith('lbm_step_sc_') else \
        6 if name.startswith('lbm_step_outflow_') else 5
    blocks = [ctypes.POINTER(_Params)]
    if mixed:
        blocks.append(ctypes.POINTER(_Mixed))
    fn.argtypes = [ctypes.c_void_p] * n_ptr + blocks + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def laminarize_function(lib, grid_name):
    """The laminarize pre-pass ``laminarize_mean_<grid>`` of the outflow
    library, typed for ``ctypes``: (a, nodes, start, entries, mean,
    params, stream)."""
    fn = getattr(lib, f'laminarize_mean_{grid_name.lower()}')
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p,
                                           ctypes.POINTER(_Params),
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def laminarize_ghost_function(lib, grid_name):
    """The laminarize pre-pass over a mesh ``laminarize_mean_ghost_<grid>``
    of the outflow library, typed for ``ctypes``: (parts, nodes, start,
    entries, dst, dst_start, params, stream)."""
    fn = getattr(lib, f'laminarize_mean_ghost_{grid_name.lower()}')
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] \
        + [ctypes.c_void_p] * 2 + [ctypes.POINTER(_Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


#: the laminarize rows' entries: ``nodes`` (int64 flat indices of their
#: nodes, entry by entry), ``start`` (int32, entries + 1 offsets into
#: nodes), ``mean`` (the (entries, Q) fp32 buffer of the plane means) and
#: ``spans`` ((row, lowest coordinate along its normal, entries) per
#: laminarize row, in row order)
LamEntries = namedtuple('LamEntries', ('nodes', 'start', 'mean', 'spans'))


def laminarize_entries(grid, table, mask, params):
    """The entries of the laminarize pre-pass for the BC table ``table``
    on the uint8 mask codes ``mask``: one per coordinate along each
    laminarize row's normal, from the lowest that holds a node of the row
    to the highest, in row order, each listing the row's nodes in that
    plane. Writes each row's first entry and lowest coordinate into
    ``params.out``. Returns ``LamEntries`` on the mask's device, or None
    without a laminarize row."""
    codes = mask.cpu().numpy()
    nodes, start, spans = [], [0], []
    for j, row in enumerate(table):
        if nt.get_node_type(row.type_id) is not nt.NTLaminarize:
            continue
        lo, counts, flat = st.plane_entries(codes == 3 + j,
                                            (row.orientation - 1) // 2)
        params.out.lam_entry[j] = len(start) - 1
        params.out.lam_lo[j] = lo
        spans.append((j, lo, len(counts)))
        nodes.append(flat)
        for count in counts:
            start.append(start[-1] + count)
    if not nodes:
        return None
    dev = mask.device
    return LamEntries(
        torch.as_tensor(np.concatenate(nodes).astype(np.int64), device=dev),
        torch.as_tensor(np.asarray(start, dtype=np.int32), device=dev),
        torch.zeros((len(start) - 1, grid.Q), dtype=torch.float32,
                    device=dev), tuple(spans))


class KernelStep:
    """The kernel engine for one scene: two state buffers A and B swapped
    every step, the uint8 mask, the BC table (mask code 3 + its index),
    ``bcp`` (the fp32 per-node parameter array of the varying rows),
    ``vary`` (whether any row varies), ``tags`` (the int32 link-tag map
    when a half-way or TMS row exists, else None), ``walls`` (whether a
    wall row exists), ``dynamic`` (the ``bc_patch.DynamicRow`` of each row
    whose values depend on time), ``force`` (the body force of the last
    launch, an acceleration (x, y[, z]), or None) with its
    ``force_model``, ``force_expr`` (the components of a time-only
    DynamicValue force, else None), the collision model (``rates``: the
    MRT rate vector or None, ``smagorinsky``: the LES constant, 0 without,
    ``incompressible``, ``equilibrium`` and ``gravity``), ``sc_coupling``
    ``elbm`` (the entropic collision's ``step.Entropic``, or None),
    and ``sc_potential`` (the Shan-Chen mode when the coupling is not 0:
    ``rho``, the (*S) buffer of the pre-pass densities, and ``rho_name``,
    the pre-pass's key of ``LAUNCHES``), ``library`` (the csrc source of its
    collision model, ``LIBRARIES``), ``entry`` (the C entry,
    ``lbm_step_<grid>``, which picks the kernel instantiation of the
    block's force model and equilibrium and of whether it has wall rows, or
    ``lbm_step_sc_<grid>``, or with an outflow row (``outflow``)
    ``lbm_step_outflow_<grid>``, its laminarize rows' pre-pass entries
    ``lam``, a ``LamEntries`` or None), ``name`` (the key of ``LAUNCHES``
    its step launches count under) and ``launches``, the number of step
    launches this object has made: one per step (and as many pre-pass
    launches, ``prepass_launches``, in the Shan-Chen mode and with a
    laminarize row).

    Under ``--precision=mixed`` (the StepBuilder's ``mixed``, an
    ``ops/mixed.MixedScales``, kept as ``mixed``) A and B hold int16 codes,
    the library is that of ``MIXED_LIBRARIES``, the entry and the name
    ``lbm_step_mixed_<grid>``; ``run`` quantizes the fp32 state it is given
    into A once and returns the dequantized result in ``out``, an fp32
    buffer of its own (``quant(dequant(q)) == q``, so the round trip is
    exact); ``run_codes`` steps codes."""

    def __init__(self, builder):
        maps = builder.maps
        nodes = classify_nodes(maps)
        reasons = kernel_ineligibility(builder, nodes)
        if reasons:
            raise NotImplementedError(
                'the CUDA stream-and-collide kernel cannot run this scene: '
                + '; '.join(reasons))
        self.grid = builder.grid
        self.tau_inv = builder.tau_inv
        self.time_unit = builder.time_unit
        mask_np, instances, _ = nodes
        boxes, _ = bc_patch.instance_boxes(maps, instances)
        self.table = bc_table(maps, instances, boxes)
        self.vary = any(box is not None for box in boxes)
        self.shape = mask_np.shape
        self.device = builder.device
        self.mask = torch.as_tensor(mask_np, device=self.device)
        self.bcp = torch.as_tensor(
            bc_patch.param_array(maps, boxes, instances), device=self.device)
        types = {nt.get_node_type(row.type_id) for row in self.table}
        self.walls = bool(types & set(WALL_TYPES))
        self.tags = (torch.as_tensor(maps.link_tags, device=self.device)
                     if types & set(st.LINK_TAG_TYPES) else None)
        self.dynamic = bc_patch.dynamic_rows(maps, instances, boxes,
                                             self.bcp)
        full = (self.grid.Q,) + self.shape
        self.mixed = builder.mixed
        #: the state buffers' dtype: int16 codes under --precision=mixed
        self.dtype = torch.float32 if self.mixed is None else torch.int16
        self.a = torch.empty(full, dtype=self.dtype, device=self.device)
        self.b = torch.empty_like(self.a)
        self.out = None if self.mixed is None else torch.empty(
            full, dtype=torch.float32, device=self.device)
        self.mixed_params = None if self.mixed is None else \
            mixed_params(self.mixed)
        self.force_model = builder.force_model
        self.force_expr = builder.force_expr
        self.rates = builder.mrt_rates
        self.smagorinsky = builder.smagorinsky
        self.incompressible = builder.incompressible
        self.equilibrium = builder.equilibrium
        self.gravity = builder.gravity
        self.elbm = builder.elbm
        self.sc_coupling = builder.sc_coupling
        self.sc_potential = builder.sc_potential
        self.sc = self.sc_coupling != 0.0
        self.rho = (torch.empty(self.shape, dtype=torch.float32,
                                device=self.device) if self.sc else None)
        self.force = None
        if self.force_expr is not None:
            self.force = self._force_at(self._time(0))
        elif builder.body_force is not None:
            self.force = tuple(float(a) for a in builder.body_force)
        self.params = kernel_params(
            self.grid, self.shape, self.table, self.tau_inv, self.force,
            self.force_model, self.rates, self.smagorinsky,
            self.incompressible, self.equilibrium, self.gravity,
            self.sc_coupling, self.sc_potential, self.elbm)
        #: whether a row of the outflow family exists (the outflow
        #: instantiations, ``OUTFLOW_LIBRARY``)
        self.outflow = bool(types & set(OUTFLOW_TYPES))
        self.lam = laminarize_entries(self.grid, self.table, self.mask,
                                      self.params)
        self.library = LATTICES_LIBRARY \
            if self.grid.name in OTHER_LATTICES else \
            OUTFLOW_LIBRARY if self.outflow else \
            (LIBRARIES if self.mixed is None
             else MIXED_LIBRARIES)[self.params.coll.model]
        g = self.grid.name.lower()
        self.entry = f'lbm_step_{"sc_" if self.sc else ""}' \
            f'{"" if self.mixed is None else "mixed_"}' \
            f'{"outflow_" if self.outflow else ""}{g}'
        kind = 'mixed_' if self.mixed is not None else \
            'outflow_' if self.outflow else \
            'dyn_' if self.dynamic or self.force_expr is not None else \
            'wall_' if self.walls else \
            'sc_' if self.sc else \
            'sw_' if self.equilibrium == 'shallow_water' else \
            'elbm_' if self.elbm is not None else \
            'mrt_' if self.rates is not None else \
            'les_' if self.smagorinsky > 0.0 else \
            'incomp_' if self.incompressible else \
            'force_' if self.force is not None else \
            'vary_' if self.vary else ''
        self.name = f'lbm_step_{kind}{g}'
        self.rho_name = f'rho_poststream_nk1_{g}'
        self.lam_name = f'laminarize_mean_{g}'
        #: whether a mesh pre-pass writes the plane means into ``lam.mean``
        #: (``parallel/halo.MeshLaminarize``): the step then runs no
        #: pre-pass of its own, and its plain version reads them there
        self.mesh_means = False
        self.launches = 0
        self.prepass_launches = 0
        self._fn = None
        self._rho_fn = None
        self._rho_params = None
        self._lam_fn = None

    def _time(self, it):
        """t of iteration ``it``: a 0-d fp32 CPU tensor, so evaluating a
        time-only value needs no device synchronization."""
        return st.time_of(it, torch.float32, self.time_unit)

    def _force_at(self, t):
        """The time-only DynamicValue force at ``t``, each component cast
        to fp32 (as the torch engine's ``force_at`` casts it)."""
        return tuple(float(torch.as_tensor(
            nt.DynamicValue.evaluate(e, t, ()), dtype=torch.float32))
            for e in self.force_expr)

    def set_iteration(self, it):
        """Write the values of iteration ``it`` before its launch: the
        scalars of the time-only rows into the table and the parameter
        block, the block of each space-dependent row into ``bcp`` (on the
        current stream, after the launches that read the old one), and a
        time-only force into the block."""
        if not self.dynamic and self.force_expr is None:
            return
        t = self._time(it)
        dim = self.grid.dim
        for d in self.dynamic:
            if d.static is None:
                rho, u = d.scalars_at(t, dim)
                self.table[d.row] = self.table[d.row]._replace(rho=rho, u=u)
                set_row(self.params, d.row, rho, u)
                continue
            box = self.table[d.row].box
            n = d.static.numel()
            d.write_block(t, self.bcp[box.offset:box.offset + n].view(
                d.static.shape))
            BCP_REWRITES[f'bcp_{self.grid.name.lower()}'] += 1
        if self.force_expr is not None:
            self.force = self._force_at(t)
            set_force(self.params, self.grid, self.force, self.force_model,
                      self.tau_inv)

    def step_into(self, src, dst, it=0):
        """Step ``it`` from ``src`` into ``dst`` (distinct (Q, *S)
        buffers of ``dtype``, fp32 or the int16 codes of --precision=mixed,
        on the mask's device). On a CUDA tensor this launches the kernel
        once (in the Shan-Chen mode after the pre-pass into ``rho``, with a
        laminarize row after the pre-pass ``mean_into``); on a CPU tensor
        it runs ``step_reference`` (in the Shan-Chen mode with
        ``density_into``'s densities). In the Shan-Chen mode it is
        ``density_into(src, rho)`` then ``collide_into``: a sharded step
        calls the two with the density exchange between them."""
        if self.sc:
            self._check_buffers(src, dst)
            self.density_into(src, self.rho)
        self.collide_into(src, dst, it)

    def collide_into(self, src, dst, it=0):
        """Step ``it`` from ``src`` into ``dst`` as ``step_into`` makes it,
        without the Shan-Chen pre-pass: that mode reads the densities
        ``rho`` holds."""
        self._check_buffers(src, dst)
        self.set_iteration(it)
        if src.device.type == 'cpu':
            dst.copy_(self.reference(src, self.rho))
        else:
            if self.lam is not None and not self.mesh_means:
                self.mean_into(src, self.lam.mean)
            self._launch(src, dst)

    def _check_buffers(self, src, dst):
        full = (self.grid.Q,) + self.shape
        for t in (src, dst):
            if t.dtype != self.dtype or tuple(t.shape) != full:
                raise ValueError(f'expected {self.dtype} {full}, got '
                                 f'{t.dtype} {tuple(t.shape)}')
            if not t.is_contiguous():
                raise ValueError('state buffers must be contiguous')
            if t.device != self.mask.device:
                raise ValueError(f'state on {t.device}, mask on '
                                 f'{self.mask.device}')
        if src.data_ptr() == dst.data_ptr():
            raise ValueError('the pull step cannot run in place')

    def reference(self, f, rho=None):
        """``step_reference`` of this scene on the state ``f``, with the
        values of the last ``set_iteration``; in the Shan-Chen mode with
        the pre-pass densities ``rho`` (default ``sc_multi.rho_reference``
        of ``f``); under --precision=mixed on int16 codes; with
        ``mesh_means`` with the plane means in ``lam.mean``."""
        return step_reference(f, self.mask, self.table, self.grid,
                              self.tau_inv, self.bcp, self.force,
                              self.force_model, self.tags, self.rates,
                              self.smagorinsky, self.incompressible,
                              self.equilibrium, self.gravity,
                              self.sc_coupling, self.sc_potential, rho,
                              self.mixed, self.elbm,
                              self.lam_spread() if self.mesh_means
                              and self.lam is not None else None)

    def lam_spread(self, mean=None):
        """The plane means ``mean`` (default ``lam.mean``; (entries, Q))
        as the torch engine lays them out ({orientation: (Q, ...) tensor},
        ``step.spread_means``) for ``step_reference``'s ``lam_means``."""
        mean = self.lam.mean if mean is None else mean
        out = {}
        for j, lo, count in self.lam.spans:
            row = self.table[j]
            e = self.params.out.lam_entry[j]
            out[row.orientation] = st.spread_means(
                mean[e:e + count], lo, self.shape,
                (row.orientation - 1) // 2)
        return out

    def _stream(self, t):
        return torch.cuda.current_stream(t.device).cuda_stream

    def density_into(self, src, rho):
        """The post-stream density of the (Q, *S) state ``src`` into the
        (*S) fp32 buffer ``rho``: the ``rho_poststream`` kernel of
        ``csrc/sc_multi.cu`` at nk = 1 on a CUDA tensor (counted as
        ``rho_name``), ``sc_multi.torch_density`` on a CPU tensor (so that
        the kernel engine equals the torch engine there)."""
        from sailfish_tpu_torch.ops import sc_multi
        if tuple(rho.shape) != self.shape or rho.dtype != torch.float32 \
                or not rho.is_contiguous() or rho.device != src.device:
            raise ValueError(f'expected a contiguous float32 {self.shape} '
                             f'density on {src.device}')
        if src.device.type == 'cpu':
            rho.copy_(sc_multi.torch_density(src, self.grid))
            return
        if src.device.type != 'cuda':
            raise ValueError(f'no kernel for device {src.device}')
        if self._rho_fn is None:
            from sailfish_tpu_torch.ops import build
            lib = build.load_all(['sc_multi', self.library])['sc_multi'].lib
            self._rho_fn = sc_multi.kernel_functions(lib, self.grid.name)[0]
            self._rho_params = sc_multi.kernel_params(
                self.grid, self.shape, [1.0], {}, 'linear')
        rc = self._rho_fn(src.data_ptr(), rho.data_ptr(), 1,
                          ctypes.byref(self._rho_params), self._stream(src))
        if rc != 0:
            raise RuntimeError(f'{self.rho_name} launch failed: CUDA error '
                               f'{rc}')
        self.prepass_launches += 1
        LAUNCHES[self.rho_name] += 1

    def mean_into(self, src, mean):
        """The laminarize rows' plane means of the post-stream state of
        ``src`` into ``mean`` (an (entries, Q) fp32 buffer): the
        ``laminarize_mean`` pre-pass on a CUDA tensor (counted as
        ``lam_name``), ``laminarize_mean_reference`` on a CPU tensor."""
        lam = self.lam
        if lam is None:
            raise ValueError('the scene has no laminarize row')
        if tuple(mean.shape) != tuple(lam.mean.shape) \
                or mean.dtype != torch.float32 or not mean.is_contiguous() \
                or mean.device != src.device:
            raise ValueError(f'expected a contiguous float32 '
                             f'{tuple(lam.mean.shape)} buffer on '
                             f'{src.device}')
        if src.device.type == 'cpu':
            mean.copy_(self.laminarize_mean_reference(src))
            return
        if src.device.type != 'cuda':
            raise ValueError(f'no kernel for device {src.device}')
        if self._lam_fn is None:
            from sailfish_tpu_torch.ops import build
            self._lam_fn = laminarize_function(
                build.load(OUTFLOW_LIBRARY).lib, self.grid.name)
        rc = self._lam_fn(src.data_ptr(), lam.nodes.data_ptr(),
                          lam.start.data_ptr(), lam.mean.shape[0],
                          mean.data_ptr(), ctypes.byref(self.params),
                          self._stream(src))
        if rc != 0:
            raise RuntimeError(f'{self.lam_name} launch failed: CUDA error '
                               f'{rc}')
        self.prepass_launches += 1
        LAUNCHES[self.lam_name] += 1

    def laminarize_mean_reference(self, f):
        """Plain version of the laminarize pre-pass: the (entries, Q)
        plane means of the post-stream state of ``f``, each laminarize
        row's entries in order of the coordinate along its normal, by the
        torch engine's sums (``step.plane_means``)."""
        fs = st.gather(self.grid, f)
        return torch.cat([
            st.plane_means(fs, self.mask == 3 + j,
                           (self.table[j].orientation - 1) // 2)
            .reshape(self.grid.Q, -1).T[lo:lo + count]
            for j, lo, count in self.lam.spans])

    def _launch(self, src, dst):
        """The step kernel from ``src`` into ``dst``; in the Shan-Chen mode
        it reads the densities in ``rho``, with a laminarize row the plane
        means in ``lam.mean``."""
        if src.device.type != 'cuda':
            raise ValueError(f'no kernel for device {src.device}')
        if self._fn is None:
            from sailfish_tpu_torch.ops import build
            self._fn = kernel_function(build.load(self.library).lib,
                                       self.entry)
        if self.sc:
            rc = self._fn(src.data_ptr(), self.rho.data_ptr(),
                          dst.data_ptr(), self.mask.data_ptr(),
                          ctypes.byref(self.params), self._stream(src))
        else:
            tags = None if self.tags is None else self.tags.data_ptr()
            extra = [] if not self.outflow else \
                [None if self.lam is None else self.lam.mean.data_ptr()]
            blocks = [ctypes.byref(self.params)]
            if self.mixed is not None:
                blocks.append(ctypes.byref(self.mixed_params))
            rc = self._fn(src.data_ptr(), dst.data_ptr(),
                          self.mask.data_ptr(), self.bcp.data_ptr(), tags,
                          *extra, *blocks, self._stream(src))
        if rc != 0:
            raise RuntimeError(f'{self.name} launch failed: CUDA error {rc}')
        self.launches += 1
        LAUNCHES[self.name] += 1

    def diagnostics_into(self, src, dst, diag, it=0, plain=False):
        """Step ``it`` from ``src`` into ``dst`` as ``step_into`` does
        (with ``plain``, by the plain version on any device), and write what
        the alpha solve of each colliding node did into ``diag``, a (2, *S)
        fp32 buffer: alpha in ``diag[0]``, the branch in ``diag[1]`` (0 tiny
        deviation, 1 series, 2 Newton; from the kernel, 2 + k after k Newton
        steps). Nodes that do not collide keep what ``diag`` held. Under the
        ELBM collision only."""
        if self.elbm is None:
            raise ValueError('diagnostics of the alpha solve need the ELBM '
                             'collision')
        want = (2,) + self.shape
        if tuple(diag.shape) != want or diag.dtype != torch.float32 \
                or not diag.is_contiguous() or diag.device != src.device:
            raise ValueError(f'expected a contiguous float32 {want} buffer '
                             f'on {src.device}')
        if plain or src.device.type == 'cpu':
            self.set_iteration(it)
            self.elbm.record_branches = True
            try:
                dst.copy_(self.reference(src))
            finally:
                self.elbm.record_branches = False
            collides = (self.mask == 0) | (self.mask >= 3)
            for j, row in enumerate(self.table):
                if nt.get_node_type(row.type_id) is nt.NTSlip:
                    collides &= self.mask != 3 + j
            diag[0] = torch.where(collides, self.elbm.last_alpha, diag[0])
            diag[1] = torch.where(collides, self.elbm.last_branch.float(),
                                  diag[1])
            return
        from sailfish_tpu_torch.ops import build
        set_diag = build.load(self.library).lib.lbm_elbm_diagnostics
        set_diag.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        set_diag.restype = ctypes.c_int
        stream = self._stream(src)

        def point(ptr):
            rc = set_diag(ptr, stream)
            if rc != 0:
                raise RuntimeError(f'lbm_elbm_diagnostics failed: CUDA error '
                                   f'{rc}')

        point(diag.data_ptr())
        try:
            self.step_into(src, dst, it)
        finally:
            # a step_into that refuses its buffers must not leave the
            # library writing into ``diag`` at its next launch
            point(None)

    def run(self, f, n, it0=0):
        """``n`` steps from state ``f``, the first computing iteration
        ``it0``; returns the buffer (A or B) that holds the result. A state
        that is not one of the two buffers is copied into A first. Under
        --precision=mixed the fp32 ``f`` is quantized into A and the result
        returned dequantized in ``out`` (``run_codes`` steps the codes)."""
        if self.mixed is None:
            return self.run_codes(f, n, it0)
        return self.state_of(self.run_codes(self.codes_of(f), n, it0))

    def codes_of(self, f):
        """Under --precision=mixed, the buffer of int16 codes to step from
        for the fp32 state ``f``: ``f`` quantized into A (A or B itself
        when ``f`` is one of them)."""
        if f is self.a or f is self.b:
            return f
        return self.a.copy_(self.mixed.quant(f))

    def state_of(self, codes):
        """Under --precision=mixed, the fp32 state of the int16 ``codes``:
        dequantized into ``out``."""
        return self.out.copy_(self.mixed.dequant(codes))

    def run_codes(self, f, n, it0=0):
        """``n`` steps from the state ``f`` of ``dtype`` (fp32, or int16
        codes under --precision=mixed), as ``run`` without the mixed
        conversions; returns the buffer (A or B) that holds the result."""
        if f is not self.a and f is not self.b:
            self.a.copy_(f)
            f = self.a
        other = self.b if f is self.a else self.a
        for i in range(n):
            self.step_into(f, other, it0 + i)
            f, other = other, f
        return f
