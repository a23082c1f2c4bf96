"""The CUDA kernels on the card (marker ``cuda``; skips without a device).

Imports no jax, so it also runs where jax is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernel is held against ``step_reference``, its plain PyTorch version,
from one random state (numpy seed) over a mask holding every code 0/1/2/3+:
the LDC scenes (regularized velocity lid, normal -z / -y) and channels
with velocity/density faces of each BC pair normal to x and to z.
Tolerance: wet-node max |df| <= 1e-5 after 50 steps (fp32; FMA
contraction and summation order differ between the two).

The Shan-Chen kernels (``ops/sc_multi``) are held against
``rho_reference`` and ``sc_multi_reference`` on the three binary
separation twins (a block of excluded nodes added), from seeded
near-uniform two-component states: the density pre-pass after one launch
(<= 1e-6) and the coupled step over 20 steps (wet-node max |df| <= 1e-5).
So are the step kernel's other modes (``SC_MODE_CASES``: K = 3, and a
constant Guo force on every component at K = 2 and 3, in 2D and 3D, with
walls and self-couplings; launches counted as ``sc_multi_force_<grid>``,
``sc_multi_k3_<grid>``, ``sc_multi_k3_force_<grid>``) and the pre-pass at
K = 3; the forced, ternary and porous twins run through the controller on
the kernel engine against the torch engine, and the mixtures the kernels
cannot run (half-way walls, a per-node force) raise by name. The D3Q19
step's tile (``SC3_CASES``: each of its four instantiations on shapes that
are no multiple of the tile and with fewer z-planes than a block marches
over, both potentials, mask codes 0, 1 and 2) is held against
``sc_multi_reference`` for 20 steps (<= 1e-5); other tiles give the same
bits, a wrong geometry is refused, ptxas reports no stack frame and no
spill for the four, and its compile-time tables equal ``lattice``'s.

The kernel with varying BC rows (launches counted as
``lbm_step_vary_<grid>``: native BCs that read each node's own rho and u
from the parameter array of ``ops/bc_patch``) is held against
``step_reference`` on parabolic-inlet
channels of each BC pair, 3D with the inlet normal to z and to x and 2D
normal to y and to x (the inlet face thinned so it has holes and the mask
holds every code): one launch (wet-node max |df| <= 1e-6) and 50 steps
(<= 1e-5). The channels run through the controller on the kernel engine,
one launch per step, and on the torch engine for 30 steps (<= 1e-5).

Every face the kernel's BC dispatch has a case for (``FACE_SIZES``: the
inlet at the low end and the outlet at the high end of x, y and z in 3D, of
x and y in 2D) is held against ``step_reference`` for each BC pair with
uniform and with varying rows, the inlet face thinned, on domains whose x
extent is more than one block and not a multiple of it: wet-node max |df|
<= 1e-5 after 200 steps (fp32; FMA contraction and summation order differ
between the two). One more case checks an x-row block that holds BC nodes
of two instances.

The kernel's forcing mode (a constant body force by the Guo,
exact-difference or velocity-shift model; launches counted as
``lbm_step_force_<grid>``) is held against ``step_reference`` with the
same force on the force-driven scenes (sphere_3d, cylinder, poiseuille_3d,
a block of excluded nodes added; 50 steps, <= 1e-5, and a state that moves
with the force) and on forced channels with native-BC faces normal to x, y
and z, whose BC nodes take the force (``FACE_SIZES``, uniform and varying
rows, 200 steps, <= 1e-5). The forced scenes run through the controller on
the kernel engine and on the torch engine for 30 steps (<= 1e-5); a
per-node force raises there and names the reason.

The local walls (launches counted as ``lbm_step_wall_<grid>``: the
instantiation with wall rows) are held against ``step_reference``:
half-way and TMS boxes closed on every axis (edges, corners, a block of
excluded nodes) unforced and under each force model, slip faces normal to
each axis, half-way walls beside a varying native inlet; 100 steps, <=
1e-5, and the walls moved the state away from full bounce-back. The
time-dependent rows (``lbm_step_dyn_<grid>``: time-only density rows, a
time series, a space- and time-dependent inlet rewritten into the
parameter array, a time-only force) are held against it from a nonzero
iteration with the values written before each launch, and the five twins
of the slice run through the controller on the kernel engine, one launch
per step, against the torch engine on the card.

The collision-model mode (MRT/TRT, BGK at the Smagorinsky LES rate, the
incompressible equilibrium; launches counted as ``lbm_step_mrt_<grid>``,
``lbm_step_les_<grid>``, ``lbm_step_incomp_<grid>`` below ``dyn_`` and
``wall_``) is held against ``step_reference`` with the same model: every
model unforced and under each force model on the forced sphere and the
cylinder, on half-way and TMS boxes, and on native-BC faces normal to each
axis (50 / 200 steps, <= 1e-5; one launch <= 1e-6, and the model moves one
step from a random state away from BGK by more than 1e-4); the models run
through the controller against the torch engine, and ptxas reports 0 B
frame, no spills and at most 128 registers for all 122 ``lbm_step``
instantiations.

The free-energy kernels (``ops/fe_step``: the ``rho_poststream`` pre-pass on
the order parameter, then ``fe_step``) are held against ``rho_reference``
and ``fe_step_reference`` on the five free-energy twins (a block of
excluded nodes added), BGK and FE-MRT, with and without a wetting
gradient, from seeded states with sharp interfaces: the pre-pass after one
launch (<= 1e-6) and 20 steps (wet-node max |df| <= 1e-5). The 3D kernel's
tile is stressed on ragged shapes (``FE_TILE_CASES``: odd x and y, fewer
z-planes than a block marches over, the reach-2 wetting mirror wrapping
on small periodic extents), other tiles must give the same bits, and its
compile-time tables must equal ``lattice``'s.

The single-component Shan-Chen mode (``lbm_step_sc_<grid>`` after the
pre-pass ``rho_poststream_nk1_<grid>``) and the shallow-water equilibrium
(``lbm_step_sw_d2q9``) are held against ``step_reference`` from each
scene's own seeded start (``SINGLE_MODE_CUDA``: both potentials, Guo
forces, full bounce-back boxes, excluded nodes, shapes that are no
multiple of the block; shallow water unforced, under Guo and the velocity
shift, and in channels of each native BC pair): the pre-pass after one
launch (<= 1e-6) and 20 steps (wet-node max |df| <= 1e-5), and the mode
moved the state; the four twins run through the controller on the kernel
engine against the torch engine, one (or pre-pass + step) launch per step;
the scenes the kernel refuses raise by name; ptxas reports 0 B frame, no
spills and at most 128 registers for all 122 instantiations.

Under ``--precision=mixed`` (int16 A/B buffers, ``lbm_step_mixed_<grid>``)
the kernel is held against ``step_reference`` in codes
(``torch_scenes.mixed_errors``, ``MIXED_CASES``: the cavities, each force
model, MRT at tau != 1, LES, the incompressible equilibrium, half-way, TMS
and slip walls, varying inlets along z and x, time-only rows, shapes that
are no multiple of the block): one launch within one code of the plain
version, and after 50 steps within 2 codes of the fp64 plain version, or
within 2 times the fp32 plain version's distance to it; every one of the
65,536 codes of every direction comes back unchanged through the kernel's
own conversions; the controller runs the mode on int16 buffers, one
launch per step under the mixed key; ptxas reports 0 B frame, no spills
and at most 128 registers for its 112 instantiations.

The ELBM mode (``lbm_step_elbm_<grid>``, int16 ``lbm_step_mixed_<grid>``)
is held against ``step_reference`` with the entropic collision
(``ELBM_CASES``): from smooth states of amplitude 1e-2 (every node on the
series branch, alpha 2 - 1e-3) 200 steps within 1e-5; from a state pushed
into the Newton branch one launch with the same branch at every node,
within 1e-5 or within ``FP64_FACTOR`` times the fp32 plain version's
distance to the fp64 plain version (``torch_scenes.elbm_branches``); under
each force model and with wall rows one launch from each state by that
rule, then 20 steps from the smooth one, in which the walls push nodes
into the Newton branch, with the mean distance to the fp64 plain version
within ``ELBM_MEAN_FACTOR`` times the fp32 plain version's
(``torch_scenes.elbm_errors``); int16 in codes (``mixed_errors``); a
refused diagnostics launch leaves the library's diagnostics pointer
unset; the default engine runs it under its key and refuses the
product-form equilibrium and ELBM with --incompressible by name.

The outflow rows (``lbm_step_outflow_<grid>``, ``csrc/lbm_step_outflow.cu``;
with a laminarize row after the pre-pass ``laminarize_mean_<grid>``) are
held against ``step_reference`` on the inflow/outflow channels of each
kernel-borne type (``torch_scenes.outflow_channel``), outlet normal to x
and to y (2D) or z (3D), a block of excluded nodes added, unforced and
under each force model: one launch within 1e-6 and 100 steps within 1e-5;
the pre-pass's plane means against ``laminarize_mean_reference`` (1e-6);
ptxas reports 16 instantiations without a stack frame; the open channels
with their force objects and --init_iters run through the controller on
the kernel engine against the torch engine on the card.

On a mesh (``parallel/halo.py``, shards repeated on the one card through
``parallel/mesh.devices_override``): the exchange kernel
``halo_exchange`` (``csrc/halo.cu``) equals its plain version bit for bit
on fp32 and int16 buffers of 1-4 shards, and with the shards on two or
more GPUs (one launch per GPU, peer reads) where there are; the
ghost-plane mode (each
shard's ``lbm_step`` on its padded slab, then the exchange) stays within
1e-5 of its plain version (the torch engine's sharded step) over 50 steps
from a random state; and the controller's runs over 2 and 4 shards equal
the unsharded kernel run bit for bit, one ``lbm_step_ghost_<kind><grid>``
launch per shard and step and one exchange per step; so does one shard
per GPU where there are two or more.

The Shan-Chen and free-energy steps on a mesh (``parallel/halo_multi.py``,
and single-component Shan-Chen in ``parallel/halo.py``): the exchange
kernel on the K-component buffers (K = 2, 3; one and two ghost planes) and
on the density buffers (every rho_k of a mixture, phi over two ghost
planes under wetting, a single fluid's rho) equals its plain version bit
for bit over 1, 2 and 4 shards on the card and with shards on several
GPUs where there are; the ghost-mode pre-pass and step stay within 1e-5
of their plain versions over 20 steps; and the controller's runs over 2
and 4 shards equal the unsharded kernel run bit for bit, one ghost-mode
pre-pass and step launch per shard and step and one launch of each
exchange per step.

On meshes of two axes (('z', 'y'), ('y', 'x')) the edge mode of both
exchanges (``halo_edge_exchange_<grid>``, ``halo_rho_edge_exchange_
<grid>``: ghost planes, ghost rows or columns, and the edges or corners
from the diagonal shard) equals its plain version bit for bit on fp32 and
int16 buffers, K = 1-3, one and two ghost layers, on 2x2 and 1x4 (3D),
2x2 and 1x2 / 1x4 (2D); the controller's runs over 2x2 and 1x4 shards on
the card equal the unsharded kernel run bit for bit; and over four GPUs
as a 2x2 mesh (one shard per GPU, skipped below four) too.

The outflow family on a mesh: each kernel-borne outflow type on its
channel, flowing along a sharded axis and across it, over 2 / 1x2 and 2x2
shards on the card: the shards' ``lbm_step_ghost_outflow_<grid>``
launches (after the laminarize pre-pass over the mesh,
``laminarize_mean_ghost_<grid>``) within 1e-6 of the sharded step's plain
version for one step and 1e-5 for 50, and the controller's run the
unsharded kernel run's bits; the mesh pre-pass within 1e-6 of its plain
version and equal to the unsharded ``laminarize_mean_<grid>`` bit for bit;
the open channels' state and drag series over 2 and 2x2 shards the
unsharded run's bits; with shards on two or four GPUs too where there are.
"""

import ctypes

import numpy as np
import pytest
import torch

from sailfish_tpu_torch.ops import build
from sailfish_tpu_torch.ops import fe_step as fe
from sailfish_tpu_torch.ops import lbm_step as ls
from sailfish_tpu_torch.ops import sc_multi as sm
from sailfish_tpu_torch.ops.step import FORCE_MODELS
from torch_scenes import (ACCEL, BC_PAIRS, BINARY_SCENES, FE_SCENES,
                          SC_MORE_GOLDEN_FLAGS, SINGLE_GOLDEN_FLAGS,
                          SC_SINGLE_SCENES, SHALLOW_WATER_SCENES,
                          TERNARY_GOLDEN_FLAGS, WALL_DYNAMIC_SCENES, WALLS,
                          binary_twin, box_cfg, box_sim, channel_sim,
                          channel_sim_2d, forced, forced_channel_sim,
                          forced_channel_sim_2d, forced_mixture,
                          halfbb_beside_parabolic_inlet, mixed_errors,
                          INCOMPRESSIBLE_UNSTABLE, KERNEL_OUTFLOW_KINDS,
                          open_channel, outflow_channel,
                          elbm_branches, elbm_errors, newton_state,
                          smooth_feq, FP64_FACTOR,
                          all_codes, periodic_box, random_binary_state,
                          shear_wave_viscosity,
                          random_fe_state, random_feq, run, shallow_water,
                          slip_sim, ternary_separation, ternary_twin,
                          time_series_density_sim, twin, unforced, walled,
                          walls_moved, wet_map, with_keep_block,
                          with_patch_row_mix)

SIZES = {
    'ldc_3d': dict(lat_nx=48, lat_ny=40, lat_nz=32),
    'ldc_2d': dict(lat_nx=300, lat_ny=200),
}
CHANNEL = dict(lat_nx=40, lat_ny=24, lat_nz=32)
SCENES = {scene: (lambda s=scene: twin(s), SIZES[scene]) for scene in SIZES}
for _pair in BC_PAIRS:
    for _axis in 'xz':
        SCENES[f'channel_{_axis}_{_pair}'] = (
            lambda p=_pair, a=_axis: channel_sim(p, a), CHANNEL)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


@pytest.mark.cuda
@pytest.mark.parametrize('scene', sorted(SCENES))
def test_kernel_matches_step_reference(cuda, scene):
    make_sim, size = SCENES[scene]
    r = run(with_keep_block(make_sim()), platform='cuda', engine='kernel',
            max_iters=0, **size)
    ks = r.kernel
    codes = sorted(torch.unique(ks.mask).tolist())
    assert codes[:3] == [0, 1, 2] and codes[-1] >= 3, codes
    grid = r.sim.grid
    f0 = random_feq(grid, ks.shape, seed=3, device='cuda')
    fk = ks.run(f0, 50)
    fr = f0
    for _ in range(50):
        fr = ks.reference(fr)
    torch.cuda.synchronize()
    assert ks.launches == 50 and not ks.vary
    wet = (ks.mask == 0) | (ks.mask >= 3)
    assert float((fk - fr)[:, wet].abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize('scene', sorted(SIZES))
def test_default_engine_on_cuda_is_the_kernel(cuda, scene):
    ls.reset_launch_counts()
    r = run(twin(scene), max_iters=30, every=10, **SIZES[scene])
    assert r.engine == 'kernel'
    assert r.kernel.launches == ls.LAUNCHES[r.kernel.name] == 30
    assert bool(torch.isfinite(r.f).all())
    ref = run(twin(scene), engine='torch', max_iters=30, every=10,
              **SIZES[scene])
    assert ref.engine == 'torch' and ref.kernel is None
    assert float((r.f - ref.f).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_wrapper_refuses_bad_buffers(cuda):
    r = run(twin('ldc_2d'), platform='cuda', engine='kernel', max_iters=0,
            lat_nx=64, lat_ny=32)
    ks = r.kernel
    with pytest.raises(ValueError, match='in place'):
        ks.step_into(ks.a, ks.a)
    with pytest.raises(ValueError, match='state on cpu'):
        ks.step_into(ks.a.cpu(), ks.b)
    with pytest.raises(ValueError, match='contiguous'):
        ks.step_into(ks.a.transpose(1, 2).contiguous().transpose(1, 2),
                     ks.b)
    assert ks.launches == 0


#: (dimension, inlet axis) -> size; the flow axis is the long one
VARY_SIZES = {
    (3, 'z'): dict(lat_nx=40, lat_ny=24, lat_nz=32, periodic_x=True),
    (3, 'x'): dict(lat_nx=40, lat_ny=24, lat_nz=32, periodic_z=True),
    (2, 'y'): dict(lat_nx=300, lat_ny=200),
    (2, 'x'): dict(lat_nx=300, lat_ny=200),
}


def _parabolic(pair, dim, axis):
    return (channel_sim(pair, axis, profile='parabolic') if dim == 3
            else channel_sim_2d(pair, axis=axis))


@pytest.mark.cuda
@pytest.mark.parametrize('dim,axis', sorted(VARY_SIZES))
@pytest.mark.parametrize('pair', sorted(BC_PAIRS))
def test_varying_step_matches_reference(cuda, pair, dim, axis):
    sim = with_patch_row_mix(with_keep_block(_parabolic(pair, dim, axis)),
                             axis)
    r = run(sim, platform='cuda', engine='kernel', max_iters=0,
            **VARY_SIZES[dim, axis])
    ks = r.kernel
    assert ks.vary and ks.name == f'lbm_step_vary_{r.sim.grid.name.lower()}'
    assert any(row.box is not None for row in ks.table)
    assert sorted(torch.unique(ks.mask).tolist())[:4] == [0, 1, 2, 3]
    f0 = random_feq(r.sim.grid, ks.shape, seed=6, device='cuda')
    wet = (ks.mask == 0) | (ks.mask >= 3)
    out = torch.zeros_like(f0)
    ks.step_into(f0, out)
    torch.cuda.synchronize()
    assert ks.launches == 1
    assert float((out - ks.reference(f0))[:, wet].abs().max()) <= 1e-6
    fk = ks.run(f0, 50)
    fr = f0
    for _ in range(50):
        fr = ks.reference(fr)
    torch.cuda.synchronize()
    assert ks.launches == 51
    assert float((fk - fr)[:, wet].abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize('dim,axis', sorted(VARY_SIZES))
def test_default_engine_on_cuda_makes_one_launch_per_step(cuda, dim, axis):
    ls.reset_launch_counts()
    sim = _parabolic('regularized', dim, axis)
    r = run(sim, max_iters=30, every=10, **VARY_SIZES[dim, axis])
    assert r.engine == 'kernel' and r.kernel.vary
    assert ls.LAUNCHES[r.kernel.name] == r.kernel.launches == 30
    assert sum(ls.LAUNCHES.values()) == 30
    ref = run(sim, engine='torch', max_iters=30, every=10,
              **VARY_SIZES[dim, axis])
    assert ref.engine == 'torch'
    assert bool(torch.isfinite(r.f).all())
    wet = (r.kernel.mask == 0) | (r.kernel.mask >= 3)
    assert float((r.f - ref.f)[:, wet].abs().max()) <= 1e-5


#: (dimension, face axis) -> size: x spans two blocks of 128, the second
#: ragged
FACE_SIZES = {
    (3, 'x'): dict(lat_nx=200, lat_ny=12, lat_nz=10, periodic_z=True),
    (3, 'y'): dict(lat_nx=200, lat_ny=12, lat_nz=10, periodic_x=True),
    (3, 'z'): dict(lat_nx=200, lat_ny=12, lat_nz=10, periodic_x=True),
    (2, 'x'): dict(lat_nx=300, lat_ny=40),
    (2, 'y'): dict(lat_nx=300, lat_ny=40),
}


def face_case(pair, dim, axis, profile):
    """The channel of BC pair ``pair`` flowing along ``axis`` (velocity
    face of inward normal +axis at the low end, density face of inward
    normal -axis at the high end), uniform or parabolic inlet, with a block
    of excluded nodes and the inlet face thinned."""
    sim = (channel_sim(pair, axis, profile=profile) if dim == 3
           else channel_sim_2d(pair, profile=profile, axis=axis))
    return with_patch_row_mix(with_keep_block(sim), axis)


@pytest.mark.cuda
@pytest.mark.parametrize('profile', [None, 'parabolic'])
@pytest.mark.parametrize('dim,axis', sorted(FACE_SIZES))
@pytest.mark.parametrize('pair', sorted(BC_PAIRS))
def test_kernel_matches_step_reference_on_every_face(cuda, pair, dim, axis,
                                                     profile):
    r = run(face_case(pair, dim, axis, profile), platform='cuda',
            engine='kernel', max_iters=0, **FACE_SIZES[dim, axis])
    ks = r.kernel
    a = 'xyz'.index(axis)
    faces = {(ks.params.bc[j].axis, ks.params.bc[j].sign)
             for j in range(len(ks.table))}
    assert {(a, 1), (a, -1)} <= faces
    assert ks.vary == (profile is not None)
    assert 128 < ks.shape[-1] and ks.shape[-1] % 128
    assert sorted(torch.unique(ks.mask).tolist())[:4] == [0, 1, 2, 3]
    f0 = random_feq(r.sim.grid, ks.shape, seed=9, device='cuda')
    fk = ks.run(f0, 200)
    fr = f0
    for _ in range(200):
        fr = ks.reference(fr)
    torch.cuda.synchronize()
    assert ks.launches == 200
    wet = (ks.mask == 0) | (ks.mask >= 3)
    assert float((fk - fr)[:, wet].abs().max()) <= 1e-5


@pytest.mark.cuda
def test_block_with_bc_nodes_of_two_instances(cuda):
    """A thinned z-normal inlet: the BC nodes beside a hole detect another
    orientation, so one x-row block holds nodes of several table rows."""
    r = run(face_case('zouhe', 3, 'z', 'parabolic'), platform='cuda',
            engine='kernel', max_iters=0, **FACE_SIZES[3, 'z'])
    ks = r.kernel
    rows = ks.mask.reshape(-1, ks.shape[-1])[:, :128]
    per_block = [len(set(row[row >= 3].tolist())) for row in rows]
    assert max(per_block) >= 2
    f0 = random_feq(r.sim.grid, ks.shape, seed=10, device='cuda')
    out = torch.zeros_like(f0)
    ks.step_into(f0, out)
    torch.cuda.synchronize()
    wet = (ks.mask == 0) | (ks.mask >= 3)
    assert float((out - ks.reference(f0))[:, wet].abs().max()) <= 1e-6


#: force-driven scenes -> size (x ragged against the block of 128)
FORCED_SIZES = {
    'sphere_3d': dict(lat_nx=72, lat_ny=40, lat_nz=32),
    'cylinder': dict(lat_nx=300, lat_ny=120),
    'poiseuille_3d': dict(lat_nx=40, lat_ny=40, lat_nz=24),
}


def _wet(ks):
    return (ks.mask == 0) | (ks.mask >= 3)


@pytest.mark.cuda
@pytest.mark.parametrize('model', FORCE_MODELS)
@pytest.mark.parametrize('scene', sorted(FORCED_SIZES))
def test_forced_kernel_matches_step_reference(cuda, scene, model):
    r = run(with_keep_block(twin(scene)), platform='cuda', engine='kernel',
            max_iters=0, force_implementation=model, **FORCED_SIZES[scene])
    ks = r.kernel
    grid = r.sim.grid
    assert ks.force is not None and ks.force_model == model
    assert ks.name == f'lbm_step_force_{grid.name.lower()}'
    assert ks.params.force.model == ls.FORCE_CODES[model]
    assert sorted(torch.unique(ks.mask).tolist()) == [0, 1, 2]
    f0 = random_feq(grid, ks.shape, seed=11, device='cuda')
    ls.reset_launch_counts()
    fk = ks.run(f0, 50)
    fr = fu = f0
    for _ in range(50):
        fr = ks.reference(fr)
        fu = ls.step_reference(fu, ks.mask, ks.table, grid, ks.tau_inv)
    torch.cuda.synchronize()
    assert ks.launches == 50 == ls.LAUNCHES[ks.name]
    assert sum(ls.LAUNCHES.values()) == 50
    wet = _wet(ks)
    assert float((fk - fr)[:, wet].abs().max()) <= 1e-5
    # the force moves the state by far more than the tolerance
    assert float((fk - fu)[:, wet].abs().max()) > 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize('model', FORCE_MODELS)
@pytest.mark.parametrize('profile', [None, 'parabolic'])
@pytest.mark.parametrize('dim,axis', sorted(FACE_SIZES))
@pytest.mark.parametrize('pair', ['regularized', 'zouhe'])
def test_forced_kernel_matches_step_reference_on_every_face(
        cuda, pair, dim, axis, profile, model):
    """BC nodes take the force in ``bc_face``: forced channels with the
    inlet at the low and the outlet at the high end of each axis."""
    sim = (forced_channel_sim(pair, axis, profile) if dim == 3
           else forced_channel_sim_2d(pair, profile, axis))
    sim = with_patch_row_mix(with_keep_block(sim), axis)
    r = run(sim, platform='cuda', engine='kernel', max_iters=0,
            force_implementation=model, **FACE_SIZES[dim, axis])
    ks = r.kernel
    assert ks.name == f'lbm_step_force_{r.sim.grid.name.lower()}'
    assert ks.vary == (profile is not None)
    assert sorted(torch.unique(ks.mask).tolist())[:4] == [0, 1, 2, 3]
    f0 = random_feq(r.sim.grid, ks.shape, seed=12, device='cuda')
    fk = ks.run(f0, 200)
    fr = f0
    for _ in range(200):
        fr = ks.reference(fr)
    fu = ls.step_reference(f0, ks.mask, ks.table, r.sim.grid, ks.tau_inv,
                           ks.bcp)
    out = torch.zeros_like(f0)
    ks.step_into(f0, out)
    torch.cuda.synchronize()
    assert ks.launches == 201
    assert float((fk - fr)[:, _wet(ks)].abs().max()) <= 1e-5
    # after one step the BC nodes differ from the unforced step's by the
    # force's size and from the forced plain version's by rounding
    bc = ks.mask >= 3
    assert float((out - fu)[:, bc].abs().max()) > 1e-7
    assert float((out - ks.reference(f0))[:, bc].abs().max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize('scene', sorted(FORCED_SIZES))
def test_default_engine_on_cuda_is_the_forced_kernel(cuda, scene):
    ls.reset_launch_counts()
    r = run(twin(scene), max_iters=30, every=10, **FORCED_SIZES[scene])
    assert r.engine == 'kernel'
    name = f'lbm_step_force_{r.sim.grid.name.lower()}'
    assert r.kernel.name == name
    assert r.kernel.launches == ls.LAUNCHES[name] == 30
    assert sum(ls.LAUNCHES.values()) == 30
    assert bool(torch.isfinite(r.f).all())
    ref = run(twin(scene), engine='torch', max_iters=30, every=10,
              **FORCED_SIZES[scene])
    assert ref.engine == 'torch' and ref.kernel is None
    assert float((r.f - ref.f)[:, _wet(r.kernel)].abs().max()) <= 1e-5


@pytest.mark.cuda
def test_per_node_force_raises_on_the_default_engine(cuda):
    """No silent change of engine: the default engine on the card refuses
    four_rolls_mill's per-node force by name; ``--engine=torch`` runs it."""
    with pytest.raises(NotImplementedError,
                       match='space-varying body force'):
        run(twin('four_rolls_mill'), max_iters=0, lat_nx=64, lat_ny=64)
    r = run(twin('four_rolls_mill'), engine='torch', max_iters=10, every=10,
            lat_nx=64, lat_ny=64)
    assert r.engine == 'torch' and bool(torch.isfinite(r.f).all())


@pytest.mark.cuda
@pytest.mark.parametrize('grid_name', ls.KERNEL_GRIDS)
def test_lbm_tables_equal_the_lattice(cuda, grid_name):
    from sailfish_tpu_torch import lattice
    grid = lattice.get_grid(grid_name)
    ref = ls.lattice_tables(grid)
    libraries = [ls.LATTICES_LIBRARY] if grid_name in ls.OTHER_LATTICES \
        else ls.LIBRARIES.values()
    for library in libraries:
        lib = build.load(library).lib
        ls.kernel_function(lib, f'lbm_step_{grid_name.lower()}')  # raises
        tables = ls._Tables()
        assert lib.lbm_lattice_tables(grid.dim, grid.Q,
                                      ctypes.byref(tables)) == 0
        for name, _ in ls._Tables._fields_[2:]:
            assert bytes(getattr(tables, name)) == \
                bytes(getattr(ref, name)), (library, name)
        assert (tables.q, tables.dim) == (grid.Q, grid.dim)


#: wall scenes for the kernel: name -> (sim, size); 3D x ragged against the
#: block of 128
WALL_CASES = {}
for _w in ('halfbb', 'tms'):
    for _dim in (2, 3):
        for _model in (None,) + FORCE_MODELS:
            WALL_CASES[f'{_w}_{_dim}d_{_model}'] = (
                lambda w=_w, d=_dim, m=_model: box_sim(
                    WALLS[w], d, tuple(range(d)), ACCEL if m else None),
                dict(box_cfg(_dim, tuple(range(_dim))),
                     **(dict(lat_nx=72, lat_ny=40, lat_nz=24) if _dim == 3
                        else dict(lat_nx=300, lat_ny=120))),
                _model)
for _dim, _axes in ((2, 'xy'), (3, 'xyz')):
    for _a, _name in enumerate(_axes):
        WALL_CASES[f'slip_{_dim}d_{_name}'] = (
            lambda d=_dim, a=_a: slip_sim(d, a),
            dict(lat_nx=72, lat_ny=40, lat_nz=24) if _dim == 3
            else dict(lat_nx=300, lat_ny=120), 'guo')
WALL_CASES['halfbb_inlet_3d'] = (lambda: halfbb_beside_parabolic_inlet(3),
                                 dict(lat_nx=72, lat_ny=40, lat_nz=24,
                                      periodic_x=True), None)
WALL_CASES['halfbb_inlet_2d'] = (lambda: halfbb_beside_parabolic_inlet(2),
                                 dict(lat_nx=300, lat_ny=120), None)


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(WALL_CASES))
def test_wall_kernel_matches_step_reference(cuda, case):
    make_sim, size, model = WALL_CASES[case]
    extra = dict(force_implementation=model) if model else {}
    r = run(make_sim(), platform='cuda', engine='kernel', max_iters=0,
            **size, **extra)
    ks = r.kernel
    assert ks.walls and ks.name == f'lbm_step_wall_{ks.grid.name.lower()}'
    assert ks.params.force.model == ls.FORCE_CODES.get(model, 0)
    f0 = random_feq(ks.grid, ks.shape, seed=21, device='cuda')
    ls.reset_launch_counts()
    fk = ks.run(f0, 100)
    fr = f0
    for _ in range(100):
        fr = ks.reference(fr)
    torch.cuda.synchronize()
    assert ls.LAUNCHES[ks.name] == 100 == sum(ls.LAUNCHES.values())
    assert float((fk - fr)[:, _wet(ks)].abs().max()) <= 1e-5
    assert walls_moved(ks, f0) > 1e-4


#: time-dependent scenes: name -> (sim, size, it0, what varies)
DYN_CASES = {
    'womersley': (lambda: twin('womersley'),
                  dict(lat_nx=72, lat_ny=24, lat_nz=24), 3000, 'rows'),
    'pulsatile_pressure': (lambda: twin('poiseuille_pulsatile'),
                           dict(lat_nx=300, lat_ny=48), 500, 'rows'),
    'pulsatile_force': (lambda: twin('poiseuille_pulsatile'),
                        dict(lat_nx=300, lat_ny=48, drive='force'), 500,
                        'force'),
    'time_series': (time_series_density_sim, dict(lat_nx=300, lat_ny=48),
                    60, 'rows'),
    'sa_spatial_array': (lambda: twin('poiseuille_sa'),
                         dict(lat_nx=300, lat_ny=96,
                              velocity='spatial_array'), 2500, 'block'),
    'sa_equation': (lambda: twin('poiseuille_sa'),
                    dict(lat_nx=300, lat_ny=96, velocity='equation'), 2500,
                    'block'),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(DYN_CASES))
def test_dynamic_kernel_matches_step_reference(cuda, case):
    make_sim, size, it0, what = DYN_CASES[case]
    r = run(make_sim(), platform='cuda', engine='kernel', max_iters=0,
            **size)
    ks = r.kernel
    assert ks.name == f'lbm_step_dyn_{ks.grid.name.lower()}'
    assert (ks.force_expr is not None) == (what == 'force')
    assert any(d.static is not None for d in ks.dynamic) == (what == 'block')
    f0 = random_feq(ks.grid, ks.shape, seed=22, device='cuda')
    ls.reset_launch_counts()
    fk = ks.run(f0, 100, it0=it0).clone()
    fr = f0
    for i in range(100):
        ks.set_iteration(it0 + i)
        fr = ks.reference(fr)
    torch.cuda.synchronize()
    assert ls.LAUNCHES[ks.name] == 100 == sum(ls.LAUNCHES.values())
    assert ls.BCP_REWRITES[f'bcp_{ks.grid.name.lower()}'] == \
        (200 if what == 'block' else 0)
    wet = _wet(ks)
    assert float((fk - fr)[:, wet].abs().max()) <= 1e-5
    f_zero = ks.run(f0, 100)
    assert float((fk - f_zero)[:, wet].abs().max()) > 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize('scene', WALL_DYNAMIC_SCENES)
def test_default_engine_on_cuda_runs_the_slice_in_one_launch(cuda, scene):
    ls.reset_launch_counts()
    r = run(twin(scene), max_iters=30, every=10,
            **SINGLE_GOLDEN_FLAGS[scene])
    assert r.engine == 'kernel'
    assert r.kernel.launches == ls.LAUNCHES[r.kernel.name] == 30
    assert sum(ls.LAUNCHES.values()) == 30
    assert bool(torch.isfinite(r.f).all())
    ref = run(twin(scene), engine='torch', max_iters=30, every=10,
              **SINGLE_GOLDEN_FLAGS[scene])
    assert float((r.f - ref.f)[:, _wet(r.kernel)].abs().max()) <= 1e-5


@pytest.mark.cuda
def test_wall_rows_need_the_tag_map(cuda):
    r = run(twin('duct_flow'), platform='cuda', engine='kernel',
            max_iters=0, lat_nx=16, lat_ny=16, lat_nz=8)
    ks = r.kernel
    ks.tags = None
    with pytest.raises(RuntimeError, match='launch failed'):
        ks.step_into(ks.a, ks.b)


#: the collision models as controller flags
COLLISION = {
    'mrt': dict(model='mrt'),
    'trt': dict(model='trt'),
    'les': dict(subgrid='les-smagorinsky', smagorinsky_const=0.2),
    'mrt_les': dict(model='mrt', subgrid='les-smagorinsky',
                    smagorinsky_const=0.2),
    'incompressible': dict(incompressible=True),
    'incompressible_mrt': dict(incompressible=True, model='mrt'),
    'incompressible_les': dict(incompressible=True,
                               subgrid='les-smagorinsky',
                               smagorinsky_const=0.2),
}
#: the launch key of each (its precedence below dyn_ and wall_)
COLLISION_KEY = {'mrt': 'mrt_', 'trt': 'mrt_', 'les': 'les_',
                 'mrt_les': 'mrt_', 'incompressible': 'incomp_',
                 'incompressible_mrt': 'mrt_', 'incompressible_les': 'les_'}
#: the collision-model scenes: the forced sphere at tau = 0.8 and the
#: cylinder at tau = 0.56 (x ragged against the block of 128; at tau = 1
#: the odd MRT rate equals the even one and MRT is BGK)
COLLISION_SIZES = {
    'sphere_3d': dict(lat_nx=72, lat_ny=40, lat_nz=32, visc=0.1),
    'cylinder': dict(lat_nx=300, lat_ny=120, visc=0.02),
}


def _model_moved(ks, f0):
    """Largest wet change the model of ``ks`` makes to one step of its
    plain version from ``f0``, against BGK with the compressible
    equilibrium (after 50 steps a closed box has nearly come to rest under
    either), and the kernel's one launch from ``f0`` against the plain
    version: (moved, error)."""
    one = torch.empty_like(f0)
    ks.step_into(f0, one)
    ref = ks.reference(f0)
    bgk = ls.step_reference(f0, ks.mask, ks.table, ks.grid, ks.tau_inv,
                            ks.bcp, ks.force, ks.force_model, ks.tags)
    wet = _wet(ks)
    return (float((ref - bgk)[:, wet].abs().max()),
            float((one - ref)[:, wet].abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize('force', (None,) + FORCE_MODELS)
@pytest.mark.parametrize('model', sorted(COLLISION))
@pytest.mark.parametrize('scene', sorted(COLLISION_SIZES))
def test_collision_kernel_matches_step_reference(cuda, scene, model, force):
    """Each collision model's instantiation (no wall rows) under each force
    model against ``step_reference``: 50 steps, wet max |df| <= 1e-5, and
    the model moved one step away from BGK (one launch within 1e-6)."""
    sim = twin(scene) if force else unforced(twin(scene))
    extra = dict(force_implementation=force) if force else {}
    r = run(with_keep_block(sim), platform='cuda', engine='kernel',
            max_iters=0, **COLLISION_SIZES[scene], **COLLISION[model],
            **extra)
    ks = r.kernel
    grid = ks.grid.name.lower()
    assert ks.name == f'lbm_step_{COLLISION_KEY[model]}{grid}'
    assert ks.params.force.model == ls.FORCE_CODES.get(force, 0)
    f0 = random_feq(ks.grid, ks.shape, seed=23, device='cuda')
    ls.reset_launch_counts()
    fk = ks.run(f0, 50)
    fr = f0
    for _ in range(50):
        fr = ks.reference(fr)
    torch.cuda.synchronize()
    assert ls.LAUNCHES[ks.name] == 50 == sum(ls.LAUNCHES.values())
    wet = _wet(ks)
    assert float((fk - fr)[:, wet].abs().max()) <= 1e-5
    moved, err = _model_moved(ks, f0)
    assert moved > 1e-4 and err <= 1e-6, (moved, err)


#: the wall rows under each collision model: (wall, dim)
COLLISION_WALLS = [(w, d) for w in ('halfbb', 'tms') for d in (2, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize('force', (None,) + FORCE_MODELS)
@pytest.mark.parametrize('model', ['mrt', 'les', 'incompressible',
                                   'incompressible_mrt',
                                   'incompressible_les'])
@pytest.mark.parametrize('wall,dim', COLLISION_WALLS)
def test_collision_kernel_with_wall_rows(cuda, wall, dim, model, force):
    """The wall instantiations of each collision model (half-way and TMS
    boxes closed on every axis, a block of excluded nodes) under each force
    model: 50 steps against ``step_reference``."""
    axes = tuple(range(dim))
    size = dict(box_cfg(dim, axes),
                **(dict(lat_nx=72, lat_ny=40, lat_nz=24) if dim == 3
                   else dict(lat_nx=300, lat_ny=120)))
    extra = dict(force_implementation=force) if force else {}
    r = run(box_sim(WALLS[wall], dim, axes, ACCEL if force else None),
            platform='cuda', engine='kernel', max_iters=0, visc=0.1,
            **size, **COLLISION[model], **extra)
    ks = r.kernel
    assert ks.name == f'lbm_step_wall_{ks.grid.name.lower()}'
    f0 = random_feq(ks.grid, ks.shape, seed=24, device='cuda')
    fk = ks.run(f0, 50)
    fr = f0
    for _ in range(50):
        fr = ks.reference(fr)
    torch.cuda.synchronize()
    assert ks.launches == 50
    wet = _wet(ks)
    assert float((fk - fr)[:, wet].abs().max()) <= 1e-5
    moved, err = _model_moved(ks, f0)
    assert moved > 1e-4 and err <= 1e-6, (moved, err)


@pytest.mark.cuda
@pytest.mark.parametrize('model', ['mrt', 'les', 'incompressible'])
@pytest.mark.parametrize('dim,axis', sorted(FACE_SIZES))
def test_collision_kernel_on_every_face(cuda, dim, axis, model):
    """Native-BC faces normal to each axis (regularized, parabolic inlet
    thinned, Guo force) close with the model's collision in ``bc_face``:
    200 steps against ``step_reference``."""
    sim = (forced_channel_sim('regularized', axis, 'parabolic') if dim == 3
           else forced_channel_sim_2d('regularized', 'parabolic', axis))
    sim = with_patch_row_mix(with_keep_block(sim), axis)
    r = run(sim, platform='cuda', engine='kernel', max_iters=0, visc=0.1,
            **FACE_SIZES[dim, axis], **COLLISION[model])
    ks = r.kernel
    assert ks.vary and ks.params.coll.model == ls.MODEL_CODES.get(
        COLLISION[model].get('model'),
        2 if 'subgrid' in COLLISION[model] else 0)
    f0 = random_feq(ks.grid, ks.shape, seed=25, device='cuda')
    fk = ks.run(f0, 200)
    fr = f0
    for _ in range(200):
        fr = ks.reference(fr)
    torch.cuda.synchronize()
    assert float((fk - fr)[:, _wet(ks)].abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize('model', sorted(COLLISION))
def test_default_engine_on_cuda_runs_the_collision_model(cuda, model):
    """Through the controller: one launch per step under the model's key,
    and the torch engine's state within 1e-5 after 30 steps."""
    ls.reset_launch_counts()
    cfg = dict(SINGLE_GOLDEN_FLAGS['sphere_3d'], **COLLISION[model])
    r = run(twin('sphere_3d'), max_iters=30, every=10, **cfg)
    name = f'lbm_step_{COLLISION_KEY[model]}d3q19'
    assert r.engine == 'kernel' and r.kernel.name == name
    assert ls.LAUNCHES[name] == 30 == sum(ls.LAUNCHES.values())
    ref = run(twin('sphere_3d'), engine='torch', max_iters=30, every=10,
              **cfg)
    assert bool(torch.isfinite(r.f).all())
    assert float((r.f - ref.f)[:, _wet(r.kernel)].abs().max()) <= 1e-5


@pytest.mark.cuda
def test_every_lbm_step_instantiation_runs_in_registers(cuda):
    """ptxas: all 122 instantiations (2 lattices x 4 force models x wall
    rows or not x 3 collision models x 2 equilibria; the ELBM collision
    with the compressible equilibrium, 16; the shallow-water
    equilibrium of D2Q9 BGK under no force, Guo or the velocity shift, with
    wall rows or not; the Shan-Chen mode of both lattices, unforced or
    Guo), each collision model's in its own library, with 0 B stack frame,
    no spills and at most 128 registers."""
    usage = {}
    for code, name in ls.LIBRARIES.items():
        lib = build.load(name)
        for fn, use in build.ptxas_usage(lib.log).items():
            inst = ls.instantiation(fn)
            if inst:
                assert ls.MODEL_CODES[inst['model']] == code, (name, fn)
                usage[fn] = use
    insts = [ls.instantiation(fn) for fn in usage]
    kinds = {tuple(inst.values()) for inst in insts}
    assert len(usage) == len(kinds) == 2 * 4 * 2 * 3 * 2 + 16 + 6 + 4
    assert sum(inst['model'] == 'elbm' for inst in insts) == 16
    assert sum(inst['sc'] for inst in insts) == 4
    assert sum(inst['equilibrium'] == 'shallow_water' for inst in insts) == 6
    assert {inst['storage'] for inst in insts} == {'fp32'}
    for fn, use in usage.items():
        assert use['stack_frame'] == use['spill_stores'] \
            == use['spill_loads'] == 0, (fn, use)
        assert use['registers'] <= 128, (fn, use)


BINARY_SIZES = {
    'sc_separation_2d': dict(lat_nx=200, lat_ny=96),
    'sc_separation_3d': dict(lat_nx=40, lat_ny=24, lat_nz=32),
    'sc_separation_3d_walls': dict(lat_nx=40, lat_ny=24, lat_nz=32),
}


def _binary_engine(scene, **cfg):
    r = run(with_keep_block(binary_twin(scene)), platform='cuda',
            engine='kernel', max_iters=0, **BINARY_SIZES[scene], **cfg)
    ks = r.kernel
    assert isinstance(ks, sm.SCMultiStep)
    return r, ks


@pytest.mark.cuda
@pytest.mark.parametrize('scene', sorted(BINARY_SCENES))
def test_rho_poststream_matches_rho_reference(cuda, scene):
    r, ks = _binary_engine(scene)
    f = random_binary_state(r.sim.grid, ks.shape, seed=4, device='cuda',
                            u_rms=0.02)
    rho = torch.empty_like(ks.rho)
    ks.density_into(f, rho)
    torch.cuda.synchronize()
    assert ks.launches[ks.rho_name] == 1
    ref = torch.stack([sm.rho_reference(f[k], r.sim.grid)
                       for k in range(ks.K)])
    assert float((rho - ref).abs().max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize('potential', ['linear', 'classic'])
@pytest.mark.parametrize('scene', sorted(BINARY_SCENES))
def test_sc_multi_matches_reference(cuda, scene, potential):
    r, ks = _binary_engine(scene, sc_potential=potential)
    codes = sorted(torch.unique(ks.mask).tolist())
    assert codes == ([0, 1, 2] if 'walls' in scene else [0, 2]), codes
    grid = r.sim.grid
    f0 = random_binary_state(grid, ks.shape, seed=5, device='cuda')
    fk = ks.run(tuple(f0), 20)
    fr = tuple(f0)
    for _ in range(20):
        rhos = [sm.rho_reference(f, grid) for f in fr]
        fr = sm.sc_multi_reference(fr, rhos, ks.mask, grid, ks.taus,
                                   ks.couplings, ks.potential)
    torch.cuda.synchronize()
    assert ks.launches == {ks.rho_name: 20, ks.name: 20}
    wet = ks.mask == 0
    err = float((torch.stack(fk) - torch.stack(fr))[:, :, wet].abs().max())
    assert err <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize('scene', sorted(BINARY_SCENES))
def test_default_engine_on_cuda_is_the_sc_kernel(cuda, scene):
    sm.reset_launch_counts()
    r = run(binary_twin(scene), max_iters=30, every=10, seed=2,
            **BINARY_SIZES[scene])
    assert r.engine == 'kernel' and isinstance(r.kernel, sm.SCMultiStep)
    assert sm.LAUNCHES[r.kernel.name] == 30
    assert sm.LAUNCHES[r.kernel.rho_name] == 30
    ref = run(binary_twin(scene), engine='torch', max_iters=30, every=10,
              seed=2, **BINARY_SIZES[scene])
    assert ref.engine == 'torch' and ref.kernel is None
    wet = r.kernel.mask == 0
    for fk, ft in zip(r.f, ref.f):
        assert bool(torch.isfinite(fk).all())
        assert float((fk - ft)[:, wet].abs().max()) <= 1e-5


#: the step kernel's modes beyond K = 2 unforced: case -> (scene, flags,
#: launch name); self-couplings on, the forces (``MIX_ACCELS``) on every
#: component
SC_MODE_CASES = {
    'k2_forced_2d': (lambda: forced_mixture(binary_twin('sc_separation_2d')),
                     dict(BINARY_SIZES['sc_separation_2d'], G11=-0.3),
                     'sc_multi_force_d2q9'),
    'k2_forced_3d_walls': (
        lambda: forced_mixture(binary_twin('sc_separation_3d_walls')),
        dict(BINARY_SIZES['sc_separation_3d_walls'], G22=0.2,
             sc_potential='classic'), 'sc_multi_force_d3q19'),
    'k2_rayleigh_taylor': (lambda: binary_twin('sc_rayleigh_taylor_2d'),
                           dict(lat_nx=200, lat_ny=96),
                           'sc_multi_force_d2q9'),
    'k3_drop_2d': (lambda: ternary_twin('sc_drop_2d'),
                   dict(lat_nx=200, lat_ny=96), 'sc_multi_k3_d2q9'),
    'k3_3d_walls': (lambda: ternary_separation(3, walls=True),
                    dict(BINARY_SIZES['sc_separation_3d'], G11=-0.3,
                         G33=0.2), 'sc_multi_k3_d3q19'),
    'k3_3d_classic': (lambda: ternary_separation(3),
                      dict(BINARY_SIZES['sc_separation_3d'], G22=-0.3,
                           sc_potential='classic'), 'sc_multi_k3_d3q19'),
    'k3_forced_2d_walls': (
        lambda: forced_mixture(ternary_separation(2, walls=True)),
        dict(BINARY_SIZES['sc_separation_2d'], G22=-0.3,
             sc_potential='classic'), 'sc_multi_k3_force_d2q9'),
    'k3_forced_3d': (lambda: forced_mixture(ternary_separation(3)),
                     dict(BINARY_SIZES['sc_separation_3d'], G11=-0.3,
                          G33=0.2), 'sc_multi_k3_force_d3q19'),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(SC_MODE_CASES))
def test_sc_multi_mode_matches_reference(cuda, case):
    """Each mode against ``sc_multi_reference`` over 20 steps from a seeded
    near-uniform K-component state (a block of excluded nodes added), its
    launches under its own name, and the pre-pass at its K after one
    launch."""
    make_sim, cfg, name = SC_MODE_CASES[case]
    r = run(with_keep_block(make_sim()), platform='cuda', engine='kernel',
            max_iters=0, **cfg)
    ks = r.kernel
    assert isinstance(ks, sm.SCMultiStep) and ks.name == name
    codes = sorted(torch.unique(ks.mask).tolist())
    assert codes == ([0, 1, 2] if 'walls' in case or 'rayleigh' in case
                     else [0, 2]), codes
    grid = r.sim.grid
    f0 = random_binary_state(grid, ks.shape, seed=6, device='cuda',
                             u_rms=0.02, K=ks.K)
    rho = torch.empty_like(ks.rho)
    sm.reset_launch_counts()
    ks.density_into(f0, rho)
    ref = torch.stack([sm.rho_reference(f0[k], grid) for k in range(ks.K)])
    assert float((rho - ref).abs().max()) <= 1e-6
    fk = ks.run(tuple(f0), 20)
    fr = tuple(f0)
    for _ in range(20):
        fr = ks.reference(fr, [sm.rho_reference(f, grid) for f in fr])
    torch.cuda.synchronize()
    assert ks.launches == {ks.rho_name: 21, ks.name: 20}
    assert sm.LAUNCHES[name] == 20 and sm.LAUNCHES[ks.rho_name] == 21
    assert sum(sm.LAUNCHES.values()) == 41
    wet = ks.mask == 0
    err = float((torch.stack(fk) - torch.stack(fr))[:, :, wet].abs().max())
    assert err <= 1e-5


#: the D3Q19 step's tile on ragged shapes: case -> (scene, flags, launch
#: name), each run on the default tile and on 32 x 8 x 16
#: (``SC3_TILES``): 37 x 23 x 11 and 37 x 23 x 5 are no multiple of
#: either in x and z (nor of 32 x 8 in y), and hold fewer z-planes than a
#: block of 32 x 8 x 16 marches over (37 x 23 x 5 than one of the default
#: tile); the walled scenes hold mask codes 0, 1 and 2, the others 0 and 2
SC3_RAGGED = dict(lat_nx=37, lat_ny=23, lat_nz=11)
SC3_THIN = dict(lat_nx=37, lat_ny=23, lat_nz=5)
SC3_CASES = {
    'k2_walls': (lambda: binary_twin('sc_separation_3d_walls'),
                 SC3_RAGGED, 'sc_multi_d3q19'),
    'k2_thin_classic': (lambda: binary_twin('sc_separation_3d'),
                        dict(SC3_THIN, sc_potential='classic', G11=-0.3,
                             G22=0.2), 'sc_multi_d3q19'),
    'k2_forced_walls_classic': (
        lambda: forced_mixture(binary_twin('sc_separation_3d_walls')),
        dict(SC3_RAGGED, sc_potential='classic', G22=0.2),
        'sc_multi_force_d3q19'),
    'k2_forced_thin': (lambda: forced_mixture(binary_twin('sc_separation_3d')),
                       dict(SC3_THIN, G11=-0.3), 'sc_multi_force_d3q19'),
    'k3_walls': (lambda: ternary_separation(3, walls=True),
                 dict(SC3_RAGGED, G11=-0.3, G33=0.2), 'sc_multi_k3_d3q19'),
    'k3_thin_classic': (lambda: ternary_separation(3),
                        dict(SC3_THIN, sc_potential='classic', G22=-0.3),
                        'sc_multi_k3_d3q19'),
    'k3_forced_walls_classic': (
        lambda: forced_mixture(ternary_separation(3, walls=True)),
        dict(SC3_RAGGED, sc_potential='classic', G22=-0.3),
        'sc_multi_k3_force_d3q19'),
    'k3_forced_thin': (lambda: forced_mixture(ternary_separation(3)),
                       dict(SC3_THIN, G11=-0.3, G33=0.2),
                       'sc_multi_k3_force_d3q19'),
}


SC3_TILES = (sm.TILE_3D, (32, 8, 16))


def _sc3_engine(case):
    make_sim, cfg, name = SC3_CASES[case]
    r = run(with_keep_block(make_sim()), platform='cuda', engine='kernel',
            max_iters=0, **cfg)
    ks = r.kernel
    assert isinstance(ks, sm.SCMultiStep) and ks.name == name
    return r, ks


@pytest.mark.cuda
@pytest.mark.parametrize('tile', SC3_TILES)
@pytest.mark.parametrize('case', sorted(SC3_CASES))
def test_sc3_tile_on_ragged_shapes(cuda, case, tile):
    r, ks = _sc3_engine(case)
    codes = sorted(torch.unique(ks.mask).tolist())
    assert codes == ([0, 1, 2] if 'walls' in case else [0, 2]), codes
    ks.set_tile(tile)
    t = ks.tile
    assert t.grid[0] * t.tx > ks.shape[2] and t.grid[2] * t.kz > ks.shape[0]
    assert t.ty == 1 or t.grid[1] * t.ty > ks.shape[1]
    grid = r.sim.grid
    f0 = random_binary_state(grid, ks.shape, seed=9, device='cuda',
                             u_rms=0.02, K=ks.K)
    fk = ks.run(tuple(f0), 20)
    fr = tuple(f0)
    for _ in range(20):
        fr = ks.reference(fr, [sm.rho_reference(f, grid) for f in fr])
    torch.cuda.synchronize()
    assert ks.launches == {ks.rho_name: 20, ks.name: 20}
    wet = ks.mask == 0
    err = float((torch.stack(fk) - torch.stack(fr))[:, :, wet].abs().max())
    assert err <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['k2_forced_walls_classic',
                                  'k3_forced_thin'])
def test_sc3_tiles_give_the_same_bits(cuda, case):
    """Each node runs the same arithmetic whatever the tile; a tile the C
    side does not take is refused there and raises."""
    _r, ks = _sc3_engine(case)
    f0 = tuple(random_binary_state(ks.grid, ks.shape, seed=10,
                                   device='cuda', u_rms=0.02, K=ks.K))
    outs = []
    for tile in (sm.TILE_3D, (64, 4, 3), (16, 8, 2), (8, 4, 7), (40, 6, 1)):
        ks.set_tile(tile)
        outs.append(torch.stack(ks.run(f0, 3)).clone())
    torch.cuda.synchronize()
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    ks._tile_params.smem_bytes -= 4
    with pytest.raises(RuntimeError, match='launch failed: CUDA error'):
        ks.collide_into(ks.a, ks.rho, ks.b)


@pytest.mark.cuda
def test_sc3_instantiations_run_in_registers(cuda):
    """ptxas: the four D3Q19 step instantiations with 0 B stack frame, no
    spills and at most 128 registers (16 resident warps per SM at 256
    threads a block); the D2Q9 step keeps its four."""
    usage = {fn: use for fn, use in build.ptxas_usage(
        build.load('sc_multi').log).items() if 'registers' in use}
    kinds = {}
    for fn, use in usage.items():
        inst = sm.instantiation(fn)
        if inst:
            kinds[(inst['dim'], inst['k'], inst['forced'])] = (fn, use)
    assert sorted(kinds) == [(d, k, f) for d in (2, 3) for k in (2, 3)
                             for f in (False, True)]
    for (dim, _k, _f), (fn, use) in kinds.items():
        assert ('sc3_kernel' in fn) == (dim == 3), fn
        if dim == 3:
            assert use['stack_frame'] == use['spill_stores'] \
                == use['spill_loads'] == 0, (fn, use)
            assert use['registers'] <= 128, (fn, use)


@pytest.mark.cuda
def test_sc3_tables_equal_the_lattice(cuda):
    lib = build.load('sc_multi').lib
    sm.kernel_functions(lib, 'D3Q19')    # raises on any difference
    tables = sm._Tables()
    lib.sc_d3q19_tables(ctypes.byref(tables))
    ref = sm.lattice_tables()
    for name, _ in sm._Tables._fields_:
        assert bytes(getattr(tables, name)) == bytes(getattr(ref, name)), \
            name


#: twins of this slice through the controller on the card: scene -> (sim,
#: flags, launch name)
SC_TWINS = {
    'sc_rayleigh_taylor_2d': (
        lambda: binary_twin('sc_rayleigh_taylor_2d'),
        SC_MORE_GOLDEN_FLAGS['sc_rayleigh_taylor_2d'], 'sc_multi_force_d2q9'),
    'sc_capillary': (lambda: binary_twin('sc_capillary'),
                     SC_MORE_GOLDEN_FLAGS['sc_capillary'],
                     'sc_multi_force_d2q9'),
    'ternary_sc_drop_2d': (lambda: ternary_twin('sc_drop_2d'),
                           TERNARY_GOLDEN_FLAGS['sc_drop_2d'],
                           'sc_multi_k3_d2q9'),
    'ternary_separation_3d': (lambda: ternary_separation(3),
                              dict(lat_nx=40, lat_ny=24, lat_nz=32),
                              'sc_multi_k3_d3q19'),
}


@pytest.mark.cuda
@pytest.mark.parametrize('scene', sorted(SC_TWINS))
def test_default_engine_on_cuda_runs_the_mixture_mode(cuda, scene):
    make_sim, cfg, name = SC_TWINS[scene]
    sm.reset_launch_counts()
    r = run(make_sim(), max_iters=30, every=10, seed=2, **cfg)
    assert r.engine == 'kernel' and r.kernel.name == name
    assert sm.LAUNCHES[name] == sm.LAUNCHES[r.kernel.rho_name] == 30
    assert sum(sm.LAUNCHES.values()) == 60
    ref = run(make_sim(), engine='torch', max_iters=30, every=10, seed=2,
              **cfg)
    wet = r.kernel.mask == 0
    for fk, ft in zip(r.f, ref.f):
        assert bool(torch.isfinite(fk).all())
        assert float((fk - ft)[:, wet].abs().max()) <= 1e-5


@pytest.mark.cuda
def test_mixtures_the_kernel_cannot_run_raise_on_the_default_engine(cuda):
    """No silent change of engine: half-way walls and a per-node force in a
    mixture raise by name; ``--engine=torch`` runs them."""
    with pytest.raises(NotImplementedError, match='NTHalfBBWall'):
        run(binary_twin('sc_poiseuille_2d'), max_iters=0,
            **SC_MORE_GOLDEN_FLAGS['sc_poiseuille_2d'])
    r = run(binary_twin('sc_poiseuille_2d'), engine='torch', max_iters=10,
            every=10, **SC_MORE_GOLDEN_FLAGS['sc_poiseuille_2d'])
    assert r.engine == 'torch' and all(bool(torch.isfinite(f).all())
                                       for f in r.f)
    base = binary_twin('sc_separation_2d')

    class PerNode(base):
        def __init__(self, config):
            super().__init__(config)
            self.add_body_force(np.full((2, 32, 32), 1e-5), grid=1)

    with pytest.raises(NotImplementedError,
                       match='space-varying body force on component 1'):
        run(PerNode, max_iters=0, lat_nx=32, lat_ny=32)


@pytest.mark.cuda
def test_porous_anisotropy_runs_the_forced_lbm_step(cuda):
    """The random porous matrix (full bounce-back, one constant Guo force)
    on the forcing mode of ``lbm_step``: one launch per step, and the torch
    engine's state within 1e-5 after 30 steps."""
    cfg = dict(lat_nx=48, lat_ny=40, lat_nz=32, porosity=0.75, seed=3)
    ls.reset_launch_counts()
    r = run(twin('porous_anisotropy'), max_iters=30, every=10, **cfg)
    assert r.engine == 'kernel' and r.kernel.name == 'lbm_step_force_d3q19'
    assert ls.LAUNCHES['lbm_step_force_d3q19'] == 30 \
        == sum(ls.LAUNCHES.values())
    ref = run(twin('porous_anisotropy'), engine='torch', max_iters=30,
              every=10, **cfg)
    assert bool(torch.isfinite(r.f).all())
    assert float((r.f - ref.f)[:, _wet(r.kernel)].abs().max()) <= 1e-5


FE_SIZES = {
    'fe_separation_2d': dict(lat_nx=200, lat_ny=96),
    'fe_separation_3d': dict(lat_nx=40, lat_ny=24, lat_nz=32),
    'fe_poiseuille_2d': dict(lat_nx=200, lat_ny=96),
    'fe_viscous_fingering': dict(lat_nx=160, lat_ny=24, lat_nz=16),
    'binary_microchannel': dict(H=17),
}
#: (scene, flags): each scene with its defaults, FE-MRT on the periodic
#: ones and a wetting gradient on the walled ones
FE_CASES = [(scene, {}) for scene in sorted(FE_SCENES)] + [
    ('fe_separation_2d', dict(model='mrt')),
    ('fe_separation_3d', dict(model='mrt', tau_a=3.0, tau_b=0.8)),
    ('fe_poiseuille_2d', dict(bc_wall_grad_phase=0.05)),
    ('fe_viscous_fingering', dict(bc_wall_grad_phase=-0.03)),
    ('binary_microchannel', dict(bc_wall_grad_phase=0.04, model='mrt')),
]


def _fe_engine(scene, **cfg):
    r = run(with_keep_block(binary_twin(scene)), platform='cuda',
            engine='kernel', max_iters=0, **FE_SIZES[scene], **cfg)
    ks = r.kernel
    assert isinstance(ks, fe.FEStep)
    return r, ks


@pytest.mark.cuda
@pytest.mark.parametrize('scene', sorted(FE_SCENES))
def test_fe_prepass_matches_rho_reference(cuda, scene):
    r, ks = _fe_engine(scene)
    f = random_fe_state(r.sim.grid, ks.shape, seed=4, device='cuda')
    phi = torch.empty_like(ks.phi)
    ks.phi_into(f, phi)
    torch.cuda.synchronize()
    assert ks.launches[ks.rho_name] == 1
    ref = sm.rho_reference(f[1], r.sim.grid)
    assert float((phi - ref).abs().max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize('case', range(len(FE_CASES)))
def test_fe_step_matches_reference(cuda, case):
    scene, cfg = FE_CASES[case]
    r, ks = _fe_engine(scene, **cfg)
    codes = sorted(torch.unique(ks.mask).tolist())
    walls = scene not in ('fe_separation_2d', 'fe_separation_3d')
    assert codes == ([0, 1, 2] if walls else [0, 2]), codes
    grid = r.sim.grid
    f0 = random_fe_state(grid, ks.shape, seed=5, device='cuda')
    fk = ks.run(tuple(f0), 20)
    fr = tuple(f0)
    for _ in range(20):
        phi = sm.rho_reference(fr[1], grid)
        fr = fe.fe_step_reference(fr, phi, ks.mask, ks.orient, ks.builder)
    torch.cuda.synchronize()
    assert ks.launches == {ks.rho_name: 20, ks.name: 20}
    wet = ks.mask == 0
    err = float((torch.stack(fk) - torch.stack(fr))[:, :, wet].abs().max())
    assert err <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize('scene', sorted(FE_SCENES))
def test_default_engine_on_cuda_is_the_fe_kernel(cuda, scene):
    sm.reset_launch_counts()
    fe.reset_launch_counts()
    r = run(binary_twin(scene), max_iters=30, every=10, seed=2,
            **FE_SIZES[scene])
    assert r.engine == 'kernel' and isinstance(r.kernel, fe.FEStep)
    assert fe.LAUNCHES[r.kernel.name] == 30
    assert sm.LAUNCHES[r.kernel.rho_name] == 30
    ref = run(binary_twin(scene), engine='torch', max_iters=30, every=10,
              seed=2, **FE_SIZES[scene])
    assert ref.engine == 'torch' and ref.kernel is None
    wet = r.kernel.mask == 0
    for fk, ft in zip(r.f, ref.f):
        assert bool(torch.isfinite(fk).all())
        assert float((fk - ft)[:, wet].abs().max()) <= 1e-5


#: (scene, size, flags, with a block of excluded nodes): ragged shapes for
#: the 3D kernel's tile (32 x 8 threads, 16 z-planes by default)
FE_TILE_CASES = [
    ('fe_separation_3d', dict(lat_nx=37, lat_ny=13, lat_nz=5), {}, False),
    ('fe_separation_3d', dict(lat_nx=37, lat_ny=13, lat_nz=5),
     dict(model='mrt', tau_a=3.0, tau_b=0.8), False),
    ('fe_separation_3d', dict(lat_nx=37, lat_ny=13, lat_nz=5), {}, True),
    ('fe_viscous_fingering', dict(lat_nx=45, lat_ny=11, lat_nz=6),
     dict(bc_wall_grad_phase=-0.03), True),
    ('fe_viscous_fingering', dict(lat_nx=45, lat_ny=11, lat_nz=6),
     dict(bc_wall_grad_phase=-0.03, model='bgk'), True),
]


def _fe_tile_engine(case):
    scene, size, cfg, keep = FE_TILE_CASES[case]
    sim = binary_twin(scene)
    r = run(with_keep_block(sim) if keep else sim, platform='cuda',
            engine='kernel', max_iters=0, **size, **cfg)
    assert isinstance(r.kernel, fe.FEStep)
    return r, r.kernel


@pytest.mark.cuda
@pytest.mark.parametrize('case', range(len(FE_TILE_CASES)))
def test_fe3_tile_on_ragged_shapes(cuda, case):
    r, ks = _fe_tile_engine(case)
    assert ks.tile.grid[2] * ks.tile.kz >= ks.shape[0]
    assert ks.tile.halo == (2 if ks.orient is not None else 1)
    grid = r.sim.grid
    f0 = random_fe_state(grid, ks.shape, seed=7, device='cuda')
    fk = ks.run(tuple(f0), 20)
    fr = tuple(f0)
    for _ in range(20):
        phi = sm.rho_reference(fr[1], grid)
        fr = fe.fe_step_reference(fr, phi, ks.mask, ks.orient, ks.builder)
    torch.cuda.synchronize()
    assert ks.launches == {ks.rho_name: 20, ks.name: 20}
    wet = ks.mask == 0
    err = float((torch.stack(fk) - torch.stack(fr))[:, :, wet].abs().max())
    assert err <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize('case', [0, 3])
def test_fe3_tiles_give_the_same_bits(cuda, case):
    """Each node runs the same arithmetic whatever the tile."""
    _r, ks = _fe_tile_engine(case)
    f0 = tuple(random_fe_state(ks.grid, ks.shape, seed=8, device='cuda'))
    outs = []
    for tile in (fe.TILE_3D, (64, 4, 3), (16, 8, 2), (8, 4, 7)):
        ks.set_tile(tile)
        outs.append(torch.stack(ks.run(f0, 3)).clone())
    torch.cuda.synchronize()
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


@pytest.mark.cuda
def test_fe3_tables_equal_the_lattice(cuda):
    lib = build.load('fe_step').lib
    fe.kernel_function(lib, 'D3Q19')    # raises on any difference
    tables = fe._Tables()
    lib.fe_d3q19_tables(ctypes.byref(tables))
    ref = fe.lattice_tables()
    for name, _ in fe._Tables._fields_:
        assert bytes(getattr(tables, name)) == bytes(getattr(ref, name)), \
            name


#: the single-component Shan-Chen and shallow-water cases: name -> (sim
#: class, flags); 200 x 96 and 40 x 24 x 20 are no multiple of the block
SC_2D, SC_3D = twin('sc_phase_separation'), twin('sc_phase_separation_3d')
FS = twin('fs_gaussian')
SC_LINEAR = dict(sc_potential='linear', G=-1.6)
RAGGED_2D = dict(lat_nx=200, lat_ny=96)
RAGGED_3D = dict(lat_nx=40, lat_ny=24, lat_nz=20)
SW_CHANNEL = dict(lat_nx=200, lat_ny=96, visc=0.05, gravity=0.01)
SINGLE_MODE_CUDA = {
    'sc_2d_classic': (SC_2D, RAGGED_2D),
    'sc_2d_linear_box_keep': (with_keep_block(walled(SC_2D)),
                              dict(RAGGED_2D, **SC_LINEAR)),
    'sc_2d_guo': (forced(SC_2D, (1e-3, -5e-4)), RAGGED_2D),
    'sc_3d_classic_box_keep': (with_keep_block(walled(SC_3D)), RAGGED_3D),
    'sc_3d_linear': (SC_3D, dict(RAGGED_3D, **SC_LINEAR)),
    'sc_3d_guo_box': (walled(forced(SC_3D, (1e-3, -5e-4, 2.5e-4))),
                      RAGGED_3D),
    'sw_hump_keep': (with_keep_block(FS), RAGGED_2D),
    'sw_hump_guo': (forced(FS, (2e-4, -1e-4)), RAGGED_2D),
    'sw_hump_velocity_shift': (forced(FS, (2e-4, -1e-4)), dict(
        RAGGED_2D, force_implementation='velocity_shift')),
    'sw_channel_equilibrium_keep': (with_keep_block(shallow_water(
        channel_sim_2d('equilibrium'))), SW_CHANNEL),
    'sw_channel_zouhe_x': (shallow_water(channel_sim_2d('zouhe', axis='x')),
                           SW_CHANNEL),
    'sw_channel_regularized': (shallow_water(channel_sim_2d('regularized')),
                               dict(SW_CHANNEL, visc=1.0 / 6.0)),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(SINGLE_MODE_CUDA))
def test_single_mode_kernel_matches_step_reference(cuda, case):
    sim_cls, cfg = SINGLE_MODE_CUDA[case]
    r = run(sim_cls, platform='cuda', engine='kernel', max_iters=0,
            seed=5, **cfg)
    ks = r.kernel
    g = ks.grid.name.lower()
    assert ks.name == f'lbm_step_{"sc" if ks.sc else "sw"}_{g}'
    f0 = r.f.clone()
    if ks.sc:
        rho = torch.empty_like(ks.rho)
        ks.density_into(f0, rho)
        torch.cuda.synchronize()
        assert float((rho - sm.rho_reference(f0, ks.grid)).abs().max()) \
            <= 1e-6
    ls.reset_launch_counts()
    fk = ks.run(f0, 20)
    fr = fb = f0
    for _ in range(20):
        fr = ks.reference(fr)
        fb = ls.step_reference(fb, ks.mask, ks.table, ks.grid, ks.tau_inv,
                               ks.bcp, ks.force, ks.force_model, ks.tags)
    torch.cuda.synchronize()
    assert ls.LAUNCHES[ks.name] == ks.launches == 20
    if ks.sc:
        assert ls.LAUNCHES[ks.rho_name] == 20
    wet = _wet(ks)
    assert float((fk - fr)[:, wet].abs().max()) <= 1e-5
    assert float((fr - fb)[:, wet].abs().max()) > 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize('scene', SC_SINGLE_SCENES + SHALLOW_WATER_SCENES)
def test_single_mode_twins_on_the_kernel_engine(cuda, scene):
    """The twin through the controller on the default engine (the kernel)
    against the torch engine on the card, 30 steps."""
    cfg = dict(SINGLE_GOLDEN_FLAGS[scene], max_iters=30, every=10, seed=2)
    ls.reset_launch_counts()
    r = run(twin(scene), **cfg)
    assert r.engine == 'kernel'
    ks = r.kernel
    per_step = 2 if ks.sc else 1
    assert ls.LAUNCHES[ks.name] == 30
    assert sum(ls.LAUNCHES.values()) == per_step * 30
    ref = run(twin(scene), engine='torch', **cfg)
    assert float((r.f - ref.f).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize('flags,match', [
    (dict(model='mrt'), 'Shan-Chen with model=mrt'),
    (dict(force_implementation='edm'), 'Shan-Chen with the edm body force'),
])
def test_single_mode_refusals_on_the_default_engine(cuda, flags, match):
    sim = forced(SC_2D, (1e-3, 0.0)) if 'force_implementation' in flags \
        else SC_2D
    with pytest.raises(NotImplementedError, match=match):
        run(sim, max_iters=0, lat_nx=64, lat_ny=64, **flags)


#: --precision=mixed, kernel against plain version: name -> (sim class,
#: flags, first iteration)
MIXED_CUBE = dict(lat_nx=48, lat_ny=40, lat_nz=32)
MIXED_CASES = {
    'ldc_3d': (with_keep_block(twin('ldc_3d')), MIXED_CUBE, 0),
    'ldc_2d': (with_keep_block(twin('ldc_2d')),
               dict(lat_nx=300, lat_ny=200), 0),
    'ldc_3d_ragged': (with_keep_block(twin('ldc_3d')),
                      dict(lat_nx=37, lat_ny=23, lat_nz=11), 0),
    'sphere_3d_guo': (with_keep_block(twin('sphere_3d')), MIXED_CUBE, 0),
    'sphere_3d_velocity_shift': (twin('sphere_3d'), dict(
        MIXED_CUBE, force_implementation='velocity_shift'), 0),
    'cylinder_edm': (twin('cylinder'), dict(
        lat_nx=300, lat_ny=200, force_implementation='edm'), 0),
    'halfbb_box_3d_guo': (box_sim(WALLS['halfbb'], 3, (0, 1, 2), ACCEL),
                          box_cfg(3, (0, 1, 2)), 0),
    'tms_box_2d': (box_sim(WALLS['tms'], 2, (0, 1)), box_cfg(2, (0, 1)), 0),
    'slip_3d_y': (slip_sim(3, 1), dict(MIXED_CUBE, periodic_x=True,
                                        periodic_z=True), 0),
    'parabolic_z': (with_keep_block(channel_sim(
        'regularized', 'z', profile='parabolic')), dict(
            lat_nx=40, lat_ny=24, lat_nz=32, periodic_x=True), 0),
    'parabolic_x_zouhe': (channel_sim('zouhe', 'x', profile='parabolic'),
                          dict(lat_nx=40, lat_ny=24, lat_nz=32,
                               periodic_z=True), 0),
    'ldc_3d_mrt': (twin('ldc_3d'), dict(MIXED_CUBE, model='mrt',
                                        visc=0.05), 0),
    'sphere_3d_les': (twin('sphere_3d'), dict(
        MIXED_CUBE, subgrid='les-smagorinsky', smagorinsky_const=0.2), 0),
    'ldc_2d_incompressible': (twin('ldc_2d'), dict(
        lat_nx=300, lat_ny=200, incompressible=True), 0),
    'womersley': (twin('womersley'), dict(lat_nx=32, lat_ny=32,
                                          lat_nz=32), 3000),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(MIXED_CASES))
def test_mixed_kernel_matches_step_reference_in_codes(cuda, case):
    sim_cls, cfg, it0 = MIXED_CASES[case]
    r = run(sim_cls, platform='cuda', engine='kernel', max_iters=0,
            precision='mixed', **cfg)
    ks = r.kernel
    assert ks.name == ks.entry == f'lbm_step_mixed_{ks.grid.name.lower()}'
    assert ks.a.dtype == ks.b.dtype == torch.int16
    q0 = ks.mixed.quant(random_feq(ks.grid, ks.shape, seed=3,
                                   device='cuda'))
    errs = mixed_errors(ks, q0, 50, it0)
    torch.cuda.synchronize()
    assert ks.launches == 51, errs


@pytest.mark.cuda
@pytest.mark.parametrize('dim,size', [
    (2, dict(lat_nx=256, lat_ny=256)),
    (3, dict(lat_nx=64, lat_ny=32, lat_nz=32))])
def test_mixed_kernel_round_trips_every_code(cuda, dim, size):
    """Every int16 code of every direction through the kernel's own
    dequantize and quantize: a periodic fluid box at 1/tau = 0 stores
    f + 0 (feq - f) = f, so each code must come back, streamed."""
    from sailfish_tpu_torch.ops.step import pull
    r = run(periodic_box(dim), platform='cuda', engine='kernel',
            max_iters=0, precision='mixed', periodic_x=True,
            periodic_y=True, periodic_z=True, **size)
    ks = r.kernel
    assert ks.table == [] and int(ks.mask.max()) == 0
    ks.tau_inv = ks.params.tau_inv = 0.0
    q = all_codes(ks.grid, ks.shape, 'cuda')
    out = torch.empty_like(q)
    ks.step_into(q, out)
    torch.cuda.synchronize()
    want = torch.stack([pull(q[i], ks.grid.basis[i])
                        for i in range(ks.grid.Q)])
    assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize('scene', sorted(SIZES))
def test_mixed_controller_path_runs_int16_buffers(cuda, scene):
    """--precision=mixed through the controller: the kernel engine on
    int16 A/B buffers, one launch per step under the mixed key, the fp32
    state on the int16 grid, and within 3e-5 of the torch engine in rho
    and u (two code steps of the heaviest distribution)."""
    ls.reset_launch_counts()
    cfg = dict(SIZES[scene], max_iters=30, every=10, precision='mixed')
    r = run(twin(scene), **cfg)
    ks = r.kernel
    g = ks.grid.name.lower()
    assert r.engine == 'kernel' and ks.name == f'lbm_step_mixed_{g}'
    assert ks.a.dtype == ks.b.dtype == torch.int16
    assert ks.a.element_size() * ks.a.numel() == 2 * ks.grid.Q * int(
        np.prod(ks.shape))
    assert ls.LAUNCHES[ks.name] == sum(ls.LAUNCHES.values()) == 30
    assert torch.equal(ks.mixed.snap(r.f), r.f)
    ref = run(twin(scene), engine='torch', **cfg)
    rho_k, u_k = r.builder.macro_fields(r.f)
    rho_t, u_t = ref.builder.macro_fields(ref.f)
    assert float((rho_k - rho_t).abs().max()) <= 3e-5
    assert float((u_k - u_t).abs().max()) <= 3e-5


@pytest.mark.cuda
def test_every_mixed_instantiation_runs_in_registers(cuda):
    """ptxas: the 112 int16 instantiations (2 lattices x 4 force models x
    wall rows or not x 3 collision models x 2 equilibria, and the ELBM
    collision's 16 with the compressible one), each collision model's in
    its own library, with 0 B stack frame, no spills and at most 128
    registers."""
    insts = []
    for code, name in ls.MIXED_LIBRARIES.items():
        for fn, use in build.ptxas_usage(build.load(name).log).items():
            inst = ls.instantiation(fn)
            if inst:
                assert ls.MODEL_CODES[inst['model']] == code, (name, fn)
                assert inst['storage'] == 'int16' and not inst['sc'], fn
                insts.append(tuple(inst.values()))
                assert use['stack_frame'] == use['spill_stores'] \
                    == use['spill_loads'] == 0, (fn, use)
                assert use['registers'] <= 128, (fn, use)
    assert len(insts) == len(set(insts)) == 2 * 4 * 2 * 3 * 2 + 16


@pytest.mark.cuda
def test_mixed_shear_wave_viscosity(cuda):
    """Shear-wave decay on the mixed kernel (tests/test_mixed.py:141-176):
    the viscosity measured from the decay of the first Fourier mode within
    1.5 % of the configured one."""
    n, visc, steps = 64, 0.02, 400
    r = run(periodic_box(3), platform='cuda', engine='kernel', max_iters=0,
            precision='mixed', periodic_x=True, periodic_y=True,
            periodic_z=True, lat_nx=n, lat_ny=8, lat_nz=8, visc=visc)
    ks = r.kernel
    assert ks.a.dtype == torch.int16
    nu = shear_wave_viscosity(ks, r.builder, n, visc, steps=steps)
    assert ks.launches == 2 * steps
    assert abs(nu - visc) / visc < 0.015, nu


@pytest.mark.cuda
@pytest.mark.parametrize('flags,match', [
    (dict(precision='mixed', G=-1.6), 'does not cover Shan-Chen'),
    (dict(precision='mixed', gravity=0.01), 'standard equilibrium only'),
])
def test_mixed_refusals_on_the_default_engine(cuda, flags, match):
    sim = SC_2D if 'G' in flags else twin('fs_gaussian')
    with pytest.raises(NotImplementedError, match=match):
        run(sim, max_iters=0, lat_nx=64, lat_ny=64, **flags)


#: the ELBM mode against its plain version: name -> (sim class, flags)
ELBM_SMOOTH = {
    'box_2d': (periodic_box(2), dict(lat_nx=300, lat_ny=200,
                                     periodic_x=True, periodic_y=True)),
    'box_3d': (periodic_box(3), dict(lat_nx=40, lat_ny=36, lat_nz=24,
                                     periodic_x=True, periodic_y=True,
                                     periodic_z=True)),
}
#: name -> (sim class under an acceleration or none, flags)
ELBM_CASES = {
    'ldc_2d': (lambda a: forced(twin('ldc_2d'), a[:2]) if a
               else twin('ldc_2d'), SIZES['ldc_2d']),
    'ldc_3d': (lambda a: forced(twin('ldc_3d'), a) if a else twin('ldc_3d'),
               SIZES['ldc_3d']),
    'halfbb_box_3d': (lambda a: box_sim(WALLS['halfbb'], 3, (0, 1, 2), a),
                      box_cfg(3, (0, 1, 2))),
    'tms_box_2d': (lambda a: box_sim(WALLS['tms'], 2, (0, 1),
                                     a and a[:2]), box_cfg(2, (0, 1))),
    'slip_3d_y': (lambda a: slip_sim(3, 1, a) if a
                  else unforced(slip_sim(3, 1)),
                  dict(lat_nx=40, lat_ny=24, lat_nz=16, periodic_x=True,
                       periodic_z=True)),
    'channel_z_regularized': (
        lambda a: forced(channel_sim('regularized', 'z'), a) if a
        else channel_sim('regularized', 'z'), CHANNEL),
}


def _elbm(sim, cfg, **extra):
    r = run(with_keep_block(sim), platform='cuda', engine='kernel',
            max_iters=0, model='elbm', visc=0.01, **dict(cfg, **extra))
    ks = r.kernel
    assert ks.params.coll.model == ls.MODEL_CODES['elbm']
    assert ks.library == (ls.LIBRARIES if ks.mixed is None
                          else ls.MIXED_LIBRARIES)[ls.MODEL_CODES['elbm']]
    return ks


@pytest.mark.cuda
@pytest.mark.parametrize('scene', sorted(ELBM_SMOOTH))
def test_elbm_kernel_matches_step_reference_on_smooth_flow(cuda, scene):
    sim, cfg = ELBM_SMOOTH[scene]
    ks = _elbm(sim, cfg)
    assert ks.name == f'lbm_step_elbm_{ks.grid.name.lower()}'
    f0 = smooth_feq(ks.grid, ks.shape, 5, 'cuda', amp=1e-2)
    b = elbm_branches(ks, f0)
    assert b['kernel'][2] == b['plain'][2] == 0 < b['kernel'][1], b
    assert b['err'] <= 1e-6, b
    e = elbm_errors(ks, f0, 200, 1e-5)
    assert e['err'] <= 1e-5, e


@pytest.mark.cuda
@pytest.mark.parametrize('scene', ['ldc_2d', 'ldc_3d'])
def test_elbm_kernel_newton_branch(cuda, scene):
    """One launch from a state pushed into the Newton branch: the same
    branch at every node, and f within 1e-5 of the plain version or within
    ``FP64_FACTOR`` times its distance to the fp64 plain version (the
    Newton solve stops on an entropy residual of 1e-6, which fixes alpha
    only to 1e-6 / |dH/dalpha|: up to 1e-2 where fneq is small)."""
    make, cfg = ELBM_CASES[scene]
    ks = _elbm(make(None), cfg)
    b = elbm_branches(ks, newton_state(ks.grid, ks.shape, 7, 'cuda'),
                      tol=1e-5)
    assert b['same'] and b['kernel'][2] > 0.9 * sum(b['kernel']), b
    assert 1 <= b['iters'] <= 20, b
    assert b['err'] <= 1e-5 or b['k64'] <= FP64_FACTOR * b['p64'], b


@pytest.mark.cuda
@pytest.mark.parametrize('force', (None,) + FORCE_MODELS)
@pytest.mark.parametrize('case', sorted(ELBM_CASES))
def test_elbm_kernel_matches_step_reference(cuda, case, force):
    make, cfg = ELBM_CASES[case]
    if force:
        cfg = dict(cfg, force_implementation=force)
    ks = _elbm(make(ACCEL if force else None), cfg)
    assert (ks.force is not None) == bool(force)
    f0 = smooth_feq(ks.grid, ks.shape, 6, 'cuda', amp=1e-2)
    for f in (f0, newton_state(ks.grid, ks.shape, 6, 'cuda')):
        b = elbm_branches(ks, f, tol=1e-5)
        assert b['newton_same'], b
        assert b['k64'] is None or b['k64'] <= FP64_FACTOR * b['p64'], b
    elbm_errors(ks, f0, 20, 1e-5, newton=True)
    assert ks.launches == 22, ks.launches


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['ldc_2d', 'ldc_3d', 'tms_box_2d',
                                  'halfbb_box_3d'])
def test_mixed_elbm_kernel_matches_step_reference_in_codes(cuda, case):
    make, cfg = ELBM_CASES[case]
    ks = _elbm(make(None), cfg, precision='mixed')
    assert ks.name == ks.entry == f'lbm_step_mixed_{ks.grid.name.lower()}'
    q0 = ks.mixed.quant(smooth_feq(ks.grid, ks.shape, 8, 'cuda'))
    # one launch: within a code of the heaviest direction, or (Newton
    # nodes of a lid) by the fp64 criterion
    b = elbm_branches(ks, q0, tol=float(max(ks.mixed.ws)))
    assert b['newton_same'], b
    assert b['k64'] is None or b['k64'] <= FP64_FACTOR * b['p64'], b
    mixed_errors(ks, q0, 50, one_launch=False)


def _patch(ks, k):
    """Node index of the k-th 4 x 6 patch of the last two axes (every z
    in 3D): rows 4 + 10 (k // 3) on, columns 4 + 12 (k % 3) on."""
    a, b = 4 + 10 * (k // 3), 4 + 12 * (k % 3)
    return (Ellipsis, slice(a, a + 4), slice(b, b + 6))


#: the edges of dev = max_i |fneq_i| / max(f_i, 1e-12) in fp32, one patch
#: each: (direction or None for every one, value; None: the rest weights).
#: 1e-30 and 2e-37 lie on either side of 2^-120, where the reciprocal of
#: f_i leaves the range a node can prove its fast path exact in; no value
#: is subnormal (the CPU's plain version may flush one to zero)
ELBM_DEV_EDGES = [(1, 0.0), (2, 5e-13), (3, 1e-12), (4, -1e-3),
                  (None, None), (1, 1e-30), (2, 2e-37), (3, 1.0)]
#: on int16 state at --mixed_range=1: direction -> code (-32768 decodes to
#: a negative f, -32767 to f = 0 within an ulp of w; None: all codes 0,
#: the rest weights)
ELBM_CODE_EDGES = [(1, -32768), (2, -32767), (None, 0), (3, 32767)]


@pytest.mark.cuda
@pytest.mark.parametrize('scene', sorted(ELBM_SMOOTH))
def test_elbm_kernel_at_the_edges_of_dev(cuda, scene):
    """One launch and 20 steps from a smooth flow whose patches stream
    values at the edges of the deviation dev into the nodes: a zero, a
    negative, a subnormal f_i, f_i below, at and far above the 1e-12 floor
    of its divisor, and nodes at rest (zero fneq). The same branch at
    every node as the plain version, and the ``elbm_errors`` rule (the
    edges make Newton nodes whose alpha the entropy stop fixes loosely)."""
    sim, cfg = ELBM_SMOOTH[scene]
    ks = _elbm(sim, cfg)
    f0 = smooth_feq(ks.grid, ks.shape, 5, 'cuda', amp=1e-2)
    for k, (i, v) in enumerate(ELBM_DEV_EDGES):
        if i is None:
            for j, w in enumerate(ks.grid.weights):
                f0[j][_patch(ks, k)] = w
        else:
            f0[i][_patch(ks, k)] = v
    b = elbm_branches(ks, f0)
    assert b['same'] and min(b['kernel']) > 0, b
    elbm_errors(ks, f0, 20, 1e-5, newton=True)


@pytest.mark.cuda
@pytest.mark.parametrize('scene', sorted(ELBM_SMOOTH))
def test_mixed_elbm_kernel_at_the_edges_of_dev(cuda, scene):
    """The int16 state's edges of dev: the most negative code (a negative
    f_i), the code of f_i = 0, the largest code and nodes at rest, in
    patches of a quantized smooth flow: one launch with the same branch at
    every node as the plain version, then the ``mixed_errors`` rule."""
    sim, cfg = ELBM_SMOOTH[scene]
    ks = _elbm(sim, cfg, precision='mixed', mixed_range=1.0)
    q0 = ks.mixed.quant(smooth_feq(ks.grid, ks.shape, 8, 'cuda', amp=1e-2))
    for k, (i, code) in enumerate(ELBM_CODE_EDGES):
        q0[slice(None) if i is None else i][_patch(ks, k)] = code
    b = elbm_branches(ks, q0)
    assert b['same'] and min(b['kernel']) > 0, b
    mixed_errors(ks, q0, 50, one_launch=False)


@pytest.mark.cuda
def test_refused_diagnostics_launch_unsets_the_pointer(cuda):
    """``diagnostics_into`` points the library at its buffer only for its
    own launch: when ``step_into`` refuses the buffers, a later launch
    writes nothing there."""
    make, cfg = ELBM_CASES['ldc_2d']
    ks = _elbm(make(None), cfg)
    f0 = smooth_feq(ks.grid, ks.shape, 5, 'cuda', amp=1e-2)
    diag = torch.full((2,) + ks.shape, -1.0, device='cuda')
    with pytest.raises(ValueError):
        ks.diagnostics_into(f0, torch.empty_like(f0, dtype=torch.float64),
                            diag)
    ks.step_into(f0, torch.empty_like(f0))
    torch.cuda.synchronize()
    assert bool((diag == -1.0).all())
    ks.diagnostics_into(f0, torch.empty_like(f0), diag)
    assert bool((diag[1] >= 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize('scene', sorted(SIZES))
def test_default_engine_on_cuda_runs_elbm(cuda, scene):
    """--model=elbm through the controller: the ELBM kernel, one launch per
    step under its key, within 2e-5 of the torch engine on the card."""
    ls.reset_launch_counts()
    cfg = dict(SIZES[scene], max_iters=20, every=10, model='elbm')
    r = run(twin(scene), **cfg)
    key = f'lbm_step_elbm_{r.sim.grid.name.lower()}'
    assert r.engine == 'kernel' and r.kernel.name == key
    assert ls.LAUNCHES[key] == sum(ls.LAUNCHES.values()) == 20
    ref = run(twin(scene), engine='torch', **cfg)
    wet = _wet(r.kernel)
    assert float((r.f - ref.f)[:, wet].abs().max()) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize('flags,match', [
    (dict(model='elbm', entropic_equilibrium=True), 'equilibrium=elbm'),
    (dict(entropic_equilibrium=True), 'equilibrium=elbm'),
    (dict(model='elbm', incompressible=True), 'model=elbm with '
     '--incompressible'),
])
def test_elbm_refusals_on_the_default_engine(cuda, flags, match):
    with pytest.raises(NotImplementedError, match=match):
        run(twin('ldc_2d'), max_iters=0, lat_nx=64, lat_ny=64, **flags)


#: the instantiation classes of the D3Q15 / D3Q27 library (BGK with either
#: equilibrium, each force model, wall rows or not) on a cavity, a forced
#: native-BC channel and half-way / TMS boxes: name -> (sim, size, flags)
LATTICE_CASES = {
    'ldc': (lambda: twin('ldc_3d'), dict(lat_nx=40, lat_ny=24, lat_nz=20),
            {}),
    'ldc_incompressible': (lambda: twin('ldc_3d'),
                           dict(lat_nx=40, lat_ny=24, lat_nz=20),
                           dict(incompressible=True)),
}
for _model in FORCE_MODELS:
    _i = FORCE_MODELS.index(_model)
    LATTICE_CASES[f'channel_{_model}'] = (
        lambda a='xyz'[_i]: forced_channel_sim('zouhe', a),
        dict(lat_nx=40, lat_ny=24, lat_nz=20,
             **{'periodic_z' if _i == 0 else 'periodic_x': True}),
        dict(force_implementation=_model))
    for _w in ('halfbb', 'tms'):
        LATTICE_CASES[f'{_w}_{_model}'] = (
            lambda w=_w: box_sim(WALLS[w], 3, (0, 1, 2), ACCEL),
            dict(box_cfg(3, (0, 1, 2)), lat_nx=40, lat_ny=24, lat_nz=20),
            dict(force_implementation=_model, incompressible=_i == 1))
LATTICE_CASES['halfbb_unforced'] = (
    lambda: box_sim(WALLS['halfbb'], 3, (0, 1, 2)),
    dict(box_cfg(3, (0, 1, 2)), lat_nx=40, lat_ny=24, lat_nz=20), {})
LATTICE_CASES['slip_x'] = (lambda: slip_sim(3, 0),
                           dict(lat_nx=40, lat_ny=24, lat_nz=20,
                                periodic_y=True, periodic_z=True), {})


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(LATTICE_CASES))
@pytest.mark.parametrize('grid_name', ls.OTHER_LATTICES)
def test_other_lattice_kernel_matches_step_reference(cuda, grid_name, case):
    """The D3Q15 / D3Q27 instantiations against ``step_reference`` on the
    same lattice: 100 steps, wet-node max |df| <= 1e-5."""
    make_sim, size, flags = LATTICE_CASES[case]
    r = run(with_keep_block(make_sim()), platform='cuda', engine='kernel',
            max_iters=0, grid=grid_name, **size, **flags)
    ks = r.kernel
    assert ks.library == ls.LATTICES_LIBRARY
    assert ks.entry == f'lbm_step_{grid_name.lower()}'
    f0 = random_feq(r.sim.grid, ks.shape, seed=5, device='cuda')
    fk = ks.run(f0, 100)
    fr = f0
    for _ in range(100):
        fr = ks.reference(fr)
    torch.cuda.synchronize()
    assert ks.launches == 100
    wet = (ks.mask == 0) | (ks.mask >= 3)
    assert float((fk - fr)[:, wet].abs().max()) <= 1e-5


@pytest.mark.cuda
def test_other_lattice_instantiations(cuda):
    """ptxas: the library of the other lattices holds 2 lattices x 4 force
    models x wall rows or not x 2 equilibria, BGK, fp32, without a stack
    frame or spills."""
    lib = build.load(ls.LATTICES_LIBRARY)
    insts = {}
    for fn, use in build.ptxas_usage(lib.log).items():
        inst = ls.instantiation(fn)
        if inst:
            insts[fn] = inst
            assert use['stack_frame'] == use['spill_stores'] \
                == use['spill_loads'] == 0, (fn, use)
    kinds = {tuple(i.values()) for i in insts.values()}
    assert len(kinds) == 2 * 4 * 2 * 2
    assert {i['q'] for i in insts.values()} == {15, 27}
    assert {i['model'] for i in insts.values()} == {'bgk'}
    assert {i['storage'] for i in insts.values()} == {'fp32'}


#: the outflow channels of the card tests: (dimension, outlet axis) -> size
#: (x extents that are more than one block and no multiple of it); EDM runs
#: with the incompressible equilibrium but on the Yu and Guo density rows,
#: which diverge under it on every engine, the JAX package's too
#: (``INCOMPRESSIBLE_UNSTABLE``)
OUTFLOW_SIZES = {(2, 'x'): dict(lat_nx=300, lat_ny=40),
                 (2, 'y'): dict(lat_nx=200, lat_ny=64),
                 (3, 'x'): dict(lat_nx=150, lat_ny=24, lat_nz=20),
                 (3, 'z'): dict(lat_nx=140, lat_ny=24, lat_nz=32)}
OUTFLOW_ACCEL = (1e-5, -4e-6, 2.5e-6)


@pytest.mark.cuda
@pytest.mark.parametrize('force', (None,) + FORCE_MODELS)
@pytest.mark.parametrize('where', sorted(OUTFLOW_SIZES))
@pytest.mark.parametrize('kind', [k for k in KERNEL_OUTFLOW_KINDS
                                  if k != 'NTGradFreeflow'])
def test_outflow_kernel_matches_step_reference(cuda, kind, where, force):
    dim, axis = where
    sim = outflow_channel(kind, dim, axis)
    flags = {}
    if force:
        sim = forced(sim, OUTFLOW_ACCEL[:dim])
        flags = dict(force_implementation=force,
                     incompressible=force == 'edm'
                     and kind not in INCOMPRESSIBLE_UNSTABLE)
    r = run(with_keep_block(sim), platform='cuda', engine='kernel',
            max_iters=0, **OUTFLOW_SIZES[where], **flags)
    ks = r.kernel
    assert ks.outflow and ks.library == ls.OUTFLOW_LIBRARY
    assert ks.name == f'lbm_step_outflow_{r.sim.grid.name.lower()}'
    f0 = random_feq(r.sim.grid, ks.shape, seed=3, device='cuda')
    wet = (ks.mask == 0) | (ks.mask >= 3)
    if ks.lam is not None:
        mean = torch.empty_like(ks.lam.mean)
        ks.mean_into(f0, mean)
        ref = ks.laminarize_mean_reference(f0)
        assert float((mean - ref).abs().max()) <= 1e-6
    one = ks.run(f0, 1).clone()
    assert float((one - ks.reference(f0))[:, wet].abs().max()) <= 1e-6
    fk = ks.run(f0, 100)
    fr = f0
    for _ in range(100):
        fr = ks.reference(fr)
    torch.cuda.synchronize()
    assert ks.launches == 101
    # one launch per step, and the pre-pass's own above
    assert ks.prepass_launches == (102 if ks.lam is not None else 0)
    assert float((fk - fr)[:, wet].abs().max()) <= 1e-5


@pytest.mark.cuda
def test_outflow_instantiations(cuda):
    """ptxas: the outflow library holds 2 lattices x 4 force models x 2
    equilibria, BGK with wall rows, fp32, without a stack frame or
    spills, and the laminarize pre-pass of each lattice."""
    lib = build.load(ls.OUTFLOW_LIBRARY)
    usage = build.ptxas_usage(lib.log)
    insts = {fn: ls.instantiation(fn) for fn in usage
             if ls.instantiation(fn)}
    for fn in insts:
        use = usage[fn]
        assert use['stack_frame'] == use['spill_stores'] \
            == use['spill_loads'] == 0, (fn, use)
    assert len({tuple(i.values()) for i in insts.values()}) == 2 * 4 * 2
    assert all(i['outflow'] and i['walls'] and i['model'] == 'bgk'
               and i['storage'] == 'fp32' for i in insts.values())
    assert sum('laminarize_mean_kernel' in fn for fn in usage) == 2


@pytest.mark.cuda
@pytest.mark.parametrize('dim', [3, 2])
def test_open_channel_on_the_kernel_engine(cuda, dim):
    """The open channel with its force object through the controller:
    kernel engine (one launch per step) against the torch engine on the
    card, 60 steps, drag sampled every 20; and --init_iters on both."""
    size = dict(lat_nx=96, lat_ny=32, lat_nz=32) if dim == 3 else \
        dict(lat_nx=384, lat_ny=96)
    cfg = dict(platform='cuda', max_iters=60, every=20, init_iters=10,
               **size)
    ls.reset_launch_counts()
    rk = run(open_channel(dim), engine='kernel', **cfg)
    name = f'lbm_step_outflow_{rk.sim.grid.name.lower()}'
    # the ten of the initialization by a KernelStep of their own
    assert ls.LAUNCHES[name] == 70 and rk.kernel.launches == 60
    rt = run(open_channel(dim), engine='torch', **cfg)
    wet = (rk.kernel.mask == 0) | (rk.kernel.mask >= 3)
    assert float((rk.f - rt.f)[:, wet].abs().max()) <= 1e-5
    assert [it for it, _F in rk.sim.drag] == [20, 40, 60]
    for (_i, fk), (_j, ft) in zip(rk.sim.drag, rt.sim.drag):
        assert np.allclose(fk, ft, rtol=1e-3, atol=1e-4)
    assert rk.sim.drag[-1][1][0] > 0


MESH_SCENES = {
    'ldc_3d': (lambda: twin('ldc_3d'), dict(lat_nx=48, lat_ny=40, lat_nz=32)),
    'ldc_2d': (lambda: twin('ldc_2d'), dict(lat_nx=300, lat_ny=200)),
    'ldc_3d_int16': (lambda: twin('ldc_3d'),
                     dict(lat_nx=48, lat_ny=40, lat_nz=32,
                          precision='mixed')),
    'duct_flow': (lambda: twin('duct_flow'),
                  dict(lat_nx=32, lat_ny=32, lat_nz=32)),
}


def _mesh_run(scene, mesh, devices=None, **cfg):
    from sailfish_tpu_torch.parallel import mesh as pmesh
    make, size = MESH_SCENES[scene]
    with pmesh.devices_override(devices or ['cuda'] * 4):
        return run(make(), platform='cuda', mesh=mesh, **size, **cfg)


@pytest.mark.cuda
@pytest.mark.parametrize('mesh', ['1', '2', '4'])
@pytest.mark.parametrize('scene', ['ldc_3d', 'ldc_2d', 'ldc_3d_int16'])
def test_halo_exchange_kernel_equals_its_plain_version(cuda, scene, mesh):
    from sailfish_tpu_torch.parallel import halo
    r = _mesh_run(scene, mesh, max_iters=0)
    stp = r.stepper
    g = torch.Generator(device='cuda').manual_seed(5)
    parts = [(torch.rand(ks.a.shape, generator=g, device='cuda') * 1e3)
             .to(ks.a.dtype) for ks in stp.kernels]
    ref = [p.clone() for p in parts]
    halo.reset_launch_counts()
    stp.exchange(parts)
    stp.exchange_reference(ref)
    torch.cuda.synchronize()
    assert halo.LAUNCHES[stp.name] == 1
    assert all(torch.equal(a, b) for a, b in zip(parts, ref))


@pytest.mark.cuda
@pytest.mark.parametrize('scene', ['duct_flow', 'ldc_2d', 'ldc_3d'])
def test_ghost_mode_matches_its_plain_version(cuda, scene):
    from sailfish_tpu_torch.parallel import halo
    r = _mesh_run(scene, '2', max_iters=0)
    stp = r.stepper
    plain = halo.ShardedStep(r.builder, r._domain_shape(), r.mesh, 'torch')
    f0 = random_feq(r.sim.grid, r._domain_shape(), seed=3, device='cuda')
    fk = stp.gather(stp.run(f0, 50))
    fr = plain.gather(plain.run(f0, 50))
    torch.cuda.synchronize()
    wet = torch.cat([((ks.mask == 0) | (ks.mask >= 3))[1:-1]
                     for ks in stp.kernels], 0)
    assert float((fk - fr)[:, wet].abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize('mesh', ['2', '4'])
@pytest.mark.parametrize('scene', sorted(MESH_SCENES))
def test_shards_on_one_card_equal_the_unsharded_kernel(cuda, scene, mesh):
    from sailfish_tpu_torch.parallel import halo
    make, size = MESH_SCENES[scene]
    ref = run(make(), platform='cuda', max_iters=40, every=20, **size)
    ls.reset_launch_counts()
    halo.reset_launch_counts()
    r = _mesh_run(scene, mesh, max_iters=40, every=20)
    torch.cuda.synchronize()
    g = r.sim.grid.name.lower()
    assert r.engine == 'kernel' and r.kernel is r.stepper
    # each shard's launches under its mode's ghost key
    names = {ks.name for ks in r.stepper.kernels}
    assert names == {ref.kernel.name.replace('lbm_step_', 'lbm_step_ghost_')}
    assert sum(ls.LAUNCHES[n] for n in names) == 40 * int(mesh)
    assert sum(ls.LAUNCHES.values()) == 40 * int(mesh)
    assert halo.LAUNCHES[f'halo_exchange_{g}'] == 40
    assert torch.equal(r.f, ref.f)


@pytest.mark.cuda
@pytest.mark.parametrize('scene', ['ldc_3d', 'ldc_3d_int16'])
def test_shards_on_several_gpus_equal_the_unsharded_kernel(cuda, scene):
    """One shard per visible GPU (two or more): the exchange kernel runs
    once per GPU and step, reading its neighbours' planes through peer
    access, and the run equals the unsharded kernel run bit for bit."""
    from sailfish_tpu_torch.parallel import halo
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip('needs two or more CUDA devices')
    n = max(k for k in (2, 4, 8) if k <= n)
    make, size = MESH_SCENES[scene]
    ref = run(make(), platform='cuda', max_iters=40, every=20, **size)
    halo.reset_launch_counts()
    r = run(make(), platform='cuda', mesh=str(n), max_iters=40, every=20,
            **size)
    stp = r.stepper
    assert [d.index for d in stp.mesh.devices] == list(range(n))
    assert [ks.a.device.index for ks in stp.kernels] == list(range(n))
    assert stp.exchanges == 40 and halo.LAUNCHES[stp.name] == 40 * n
    assert torch.equal(r.f.to(ref.f.device), ref.f)


@pytest.mark.cuda
@pytest.mark.parametrize('layout', ['one_per_gpu', 'alternating'])
def test_halo_exchange_across_gpus_equals_its_plain_version(cuda, layout):
    """The exchange kernel with shards on two or more GPUs (one shard per
    GPU, or four shards alternating over two): one launch per GPU, the
    plain version's bits."""
    from sailfish_tpu_torch.parallel import halo
    from sailfish_tpu_torch.parallel import mesh as pmesh
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip('needs two or more CUDA devices')
    devices = [f'cuda:{i}' for i in range(max(k for k in (2, 4, 8)
                                               if k <= n))] \
        if layout == 'one_per_gpu' else ['cuda:0', 'cuda:1'] * 2
    make, size = MESH_SCENES['ldc_3d']
    with pmesh.devices_override(devices):
        r = run(make(), platform='cuda', mesh=str(len(devices)),
                max_iters=0, **size)
    stp = r.stepper
    parts = [torch.rand(ks.a.shape, generator=torch.Generator(
        device=ks.a.device).manual_seed(s), device=ks.a.device)
        for s, ks in enumerate(stp.kernels)]
    ref = [p.clone() for p in parts]
    halo.reset_launch_counts()
    stp.exchange(parts)
    stp.exchange_reference(ref)
    for d in set(devices):
        torch.cuda.synchronize(d)
    assert halo.LAUNCHES[stp.name] == len(set(devices))
    assert all(torch.equal(a, b) for a, b in zip(parts, ref))


#: the K-component and Shan-Chen scenes on a mesh: name -> (sim class
#: factory, flags)
MESH_MULTI_SCENES = {
    'sc_separation_3d': (lambda: binary_twin('sc_separation_3d'),
                         dict(lat_nx=48, lat_ny=40, lat_nz=32)),
    'ternary_3d_forced': (lambda: forced_mixture(ternary_separation(3)),
                          dict(lat_nx=48, lat_ny=40, lat_nz=32)),
    'sc_separation_2d': (lambda: binary_twin('sc_separation_2d'),
                         dict(lat_nx=300, lat_ny=200)),
    'fe_mrt_3d': (lambda: binary_twin('fe_separation_3d'),
                  dict(lat_nx=48, lat_ny=40, lat_nz=32, model='mrt')),
    'fe_viscous_fingering': (lambda: binary_twin('fe_viscous_fingering'),
                             dict(lat_nx=64, lat_ny=32, lat_nz=32)),
    'fe_poiseuille_2d': (lambda: binary_twin('fe_poiseuille_2d'),
                         dict(lat_nx=300, lat_ny=200,
                              bc_wall_grad_phase=0.02)),
    'sc_phase_separation_3d': (lambda: twin('sc_phase_separation_3d'),
                               dict(lat_nx=48, lat_ny=40, lat_nz=32)),
    'sc_phase_separation': (lambda: twin('sc_phase_separation'),
                            dict(lat_nx=300, lat_ny=200)),
}


def _multi_run(scene, mesh, devices=None, **cfg):
    from sailfish_tpu_torch.parallel import mesh as pmesh
    make, size = MESH_MULTI_SCENES[scene]
    with pmesh.devices_override(devices or ['cuda'] * 4):
        return run(make(), platform='cuda', mesh=mesh, seed=1234, **size,
                   **cfg)


def _exchange_both(stp):
    """Both exchanges of ``stp`` on random buffers of its kernels' shapes
    against their plain versions; returns whether each gave the same
    bits."""
    gens = {}

    def rand(t):
        g = gens.setdefault(t.device, torch.Generator(
            device=t.device).manual_seed(5))
        return torch.rand(t.shape, generator=g, device=t.device)

    multi = hasattr(stp, 'K')
    if multi:
        bufs = [rand(ks.a) for ks in stp.kernels]
        ref = [b.clone() for b in bufs]
        stp.exchange_buffers(bufs)
        stp.exchange_reference([r.unbind(0) for r in ref])
        rhos = [rand(ks.phi if stp.fe else ks.rho) for ks in stp.kernels]
    else:
        bufs = [rand(ks.a) for ks in stp.kernels]
        ref = [b.clone() for b in bufs]
        stp.exchange(bufs)
        stp.exchange_reference(ref)
        rhos = [rand(ks.rho) for ks in stp.kernels]
    rref = [r.clone() for r in rhos]
    stp.density_exchange(rhos)
    stp.density_exchange_reference(rref)
    for d in {b.device for b in bufs}:
        torch.cuda.synchronize(d)
    return (all(torch.equal(a, b) for a, b in zip(bufs, ref)),
            all(torch.equal(a, b) for a, b in zip(rhos, rref)))


@pytest.mark.cuda
@pytest.mark.parametrize('mesh', ['1', '2', '4'])
@pytest.mark.parametrize('scene', ['sc_separation_3d', 'ternary_3d_forced',
                                   'fe_viscous_fingering', 'fe_poiseuille_2d',
                                   'sc_phase_separation_3d'])
def test_multi_exchange_kernels_equal_their_plain_versions(cuda, scene,
                                                           mesh):
    from sailfish_tpu_torch.parallel import halo
    stp = _multi_run(scene, mesh, max_iters=0).stepper
    halo.reset_launch_counts()
    assert _exchange_both(stp) == (True, True)
    assert halo.LAUNCHES[stp.name] == halo.LAUNCHES[stp.rho_name] == 1


@pytest.mark.cuda
@pytest.mark.parametrize('scene', sorted(MESH_MULTI_SCENES))
def test_multi_ghost_mode_matches_its_plain_version(cuda, scene):
    """Each shard's ghost-mode pre-pass and step, with both exchanges,
    against the plain version of the sharded step for 20 steps from the
    scene's own start."""
    r = _multi_run(scene, '2', max_iters=0)
    stp = r.stepper
    s0 = stp.as_sharded(r.f)
    sk = stp.run(stp.gather(s0), 20)
    sr = stp.shard(stp.gather(s0))
    for i in range(20):
        sr = stp.reference(sr, i)
    torch.cuda.synchronize()
    wet = torch.as_tensor(wet_map(r.maps), device='cuda')
    leaves = (lambda f: (f,) if torch.is_tensor(f) else f)
    err = max(float((a - b)[:, wet].abs().max())
              for a, b in zip(leaves(stp.gather(sk)), leaves(stp.gather(sr))))
    assert err <= 1e-5, err


@pytest.mark.cuda
@pytest.mark.parametrize('mesh', ['2', '4'])
@pytest.mark.parametrize('scene', sorted(MESH_MULTI_SCENES))
def test_multi_shards_on_one_card_equal_the_unsharded_kernel(cuda, scene,
                                                             mesh):
    from sailfish_tpu_torch.parallel import halo
    make, size = MESH_MULTI_SCENES[scene]
    ref = run(make(), platform='cuda', max_iters=40, every=20, seed=1234,
              **size)
    for counts in (ls.LAUNCHES, sm.LAUNCHES, fe.LAUNCHES):
        for k in counts:
            counts[k] = 0
    halo.reset_launch_counts()
    r = _multi_run(scene, mesh, max_iters=40, every=20)
    torch.cuda.synchronize()
    g = r.sim.grid.name.lower()
    n = int(mesh)
    stp = r.stepper
    assert r.engine == 'kernel' and r.kernel is stp
    names = {(ks.rho_name, ks.name) for ks in stp.kernels}
    assert len(names) == 1
    ((rho_name, name),) = names
    assert 'ghost_' in rho_name and 'ghost_' in name
    counts = {**ls.LAUNCHES, **sm.LAUNCHES, **fe.LAUNCHES}
    assert counts[rho_name] == counts[name] == 40 * n
    assert sum(counts.values()) == 80 * n
    assert halo.LAUNCHES[f'halo_exchange_{g}'] == 40
    assert halo.LAUNCHES[f'halo_rho_exchange_{g}'] == 40
    leaves = (lambda f: (f,) if torch.is_tensor(f) else f)
    assert all(torch.equal(a, b) for a, b in zip(leaves(r.f),
                                                 leaves(ref.f)))


@pytest.mark.cuda
@pytest.mark.parametrize('scene', ['sc_separation_3d', 'fe_viscous_fingering',
                                   'sc_phase_separation_3d'])
def test_multi_shards_on_several_gpus_equal_the_unsharded_kernel(cuda,
                                                                 scene):
    """One shard per visible GPU (two or more): both exchanges once per
    GPU and step, each its plain version's bits on random buffers, and
    the run equals the unsharded kernel run bit for bit."""
    from sailfish_tpu_torch.parallel import halo
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip('needs two or more CUDA devices')
    n = max(k for k in (2, 4, 8) if k <= n)
    make, size = MESH_MULTI_SCENES[scene]
    ref = run(make(), platform='cuda', max_iters=40, every=20, seed=1234,
              **size)
    halo.reset_launch_counts()
    r = _multi_run(scene, str(n), [f'cuda:{i}' for i in range(n)],
                   max_iters=40, every=20)
    stp = r.stepper
    assert [ks.a.device.index for ks in stp.kernels] == list(range(n))
    g = r.sim.grid.name.lower()
    assert halo.LAUNCHES[f'halo_exchange_{g}'] == 40 * n
    assert halo.LAUNCHES[f'halo_rho_exchange_{g}'] == 40 * n
    leaves = (lambda f: (f,) if torch.is_tensor(f) else f)
    assert all(torch.equal(a.to(b.device), b)
               for a, b in zip(leaves(r.f), leaves(ref.f)))
    assert _exchange_both(stp) == (True, True)


# -- two-axis meshes: the edge mode ------------------------------------------

def _edge_exchanges(stp, dtype=None):
    """Both exchanges of ``stp`` (two axes) on random buffers of its
    kernels' shapes against their plain versions: (the distributions'
    bits equal, the densities' bits equal). ``dtype``: the state's
    (int16 codes: random codes)."""
    gens = {}

    def rand(shape, device, dt=torch.float32):
        g = gens.setdefault(device, torch.Generator(device=device)
                            .manual_seed(5))
        x = torch.rand(shape, generator=g, device=device)
        return x if dt == torch.float32 else (x * 3e4).to(dt)

    ks0 = stp.kernels[0]
    bufs = [rand(ks.a.shape, ks.a.device, ks.a.dtype) for ks in stp.kernels]
    ref = [b.clone() for b in bufs]
    if hasattr(stp, 'K'):
        stp.exchange_buffers(bufs)
        stp.exchange_reference([r.unbind(0) for r in ref])
        shape = (ks0.phi if stp.fe else ks0.rho).shape
    else:
        stp.exchange(bufs)
        stp.exchange_reference(ref)
        shape = ks0.shape
    rhos = [rand(shape, ks.a.device) for ks in stp.kernels]
    rref = [r.clone() for r in rhos]
    stp.density_exchange(rhos)
    stp.density_exchange_reference(rref)
    for d in {b.device for b in bufs}:
        torch.cuda.synchronize(d)
    return (all(torch.equal(a, b) for a, b in zip(bufs, ref)),
            all(torch.equal(a, b) for a, b in zip(rhos, rref)))


@pytest.mark.cuda
@pytest.mark.parametrize('mesh', ['2x2', '1x4'])
@pytest.mark.parametrize('scene', ['ldc_3d', 'ldc_2d', 'ldc_3d_int16'])
def test_edge_exchange_kernel_equals_its_plain_version(cuda, scene, mesh):
    from sailfish_tpu_torch.parallel import halo
    stp = _mesh_run(scene, mesh, max_iters=0).stepper
    assert stp.inner is not None and stp.name.startswith('halo_edge_')
    halo.reset_launch_counts()
    assert _edge_exchanges(stp) == (True, True)
    assert halo.LAUNCHES[stp.name] == halo.LAUNCHES[stp.rho_name] == 1


@pytest.mark.cuda
@pytest.mark.parametrize('mesh', ['2x2', '1x4', '1x2'])
@pytest.mark.parametrize('scene', ['sc_separation_3d', 'ternary_3d_forced',
                                   'fe_viscous_fingering', 'fe_poiseuille_2d',
                                   'sc_phase_separation_3d',
                                   'sc_separation_2d'])
def test_multi_edge_exchange_kernels_equal_their_plain_versions(cuda, scene,
                                                                mesh):
    from sailfish_tpu_torch.parallel import halo
    stp = _multi_run(scene, mesh, max_iters=0).stepper
    halo.reset_launch_counts()
    assert _edge_exchanges(stp) == (True, True)
    assert halo.LAUNCHES[stp.name] == halo.LAUNCHES[stp.rho_name] == 1


@pytest.mark.cuda
@pytest.mark.parametrize('mesh', ['2x2', '1x4'])
@pytest.mark.parametrize('scene', sorted(MESH_SCENES))
def test_two_axis_shards_on_one_card_equal_the_unsharded_kernel(cuda, scene,
                                                                mesh):
    from sailfish_tpu_torch.parallel import halo
    make, size = MESH_SCENES[scene]
    ref = run(make(), platform='cuda', max_iters=40, every=20, **size)
    ls.reset_launch_counts()
    halo.reset_launch_counts()
    r = _mesh_run(scene, mesh, max_iters=40, every=20)
    torch.cuda.synchronize()
    g = r.sim.grid.name.lower()
    assert r.engine == 'kernel' and r.kernel is r.stepper
    names = {ks.name for ks in r.stepper.kernels}
    assert names == {ref.kernel.name.replace('lbm_step_', 'lbm_step_ghost_')}
    assert sum(ls.LAUNCHES.values()) == 40 * 4
    assert halo.LAUNCHES[f'halo_edge_exchange_{g}'] == 40 \
        == sum(halo.LAUNCHES.values())
    assert torch.equal(r.f, ref.f)


@pytest.mark.cuda
@pytest.mark.parametrize('scene', sorted(MESH_MULTI_SCENES))
def test_multi_two_axis_shards_on_one_card_equal_the_unsharded_kernel(
        cuda, scene):
    from sailfish_tpu_torch.parallel import halo
    make, size = MESH_MULTI_SCENES[scene]
    ref = run(make(), platform='cuda', max_iters=40, every=20, seed=1234,
              **size)
    for counts in (ls.LAUNCHES, sm.LAUNCHES, fe.LAUNCHES):
        for k in counts:
            counts[k] = 0
    halo.reset_launch_counts()
    r = _multi_run(scene, '2x2', max_iters=40, every=20)
    torch.cuda.synchronize()
    g = r.sim.grid.name.lower()
    stp = r.stepper
    assert r.engine == 'kernel' and r.kernel is stp
    ((rho_name, name),) = {(ks.rho_name, ks.name) for ks in stp.kernels}
    counts = {**ls.LAUNCHES, **sm.LAUNCHES, **fe.LAUNCHES}
    assert counts[rho_name] == counts[name] == 40 * 4
    assert sum(counts.values()) == 80 * 4
    assert halo.LAUNCHES[f'halo_edge_exchange_{g}'] == 40
    assert halo.LAUNCHES[f'halo_rho_edge_exchange_{g}'] == 40
    leaves = (lambda f: (f,) if torch.is_tensor(f) else f)
    assert all(torch.equal(a, b) for a, b in zip(leaves(r.f),
                                                 leaves(ref.f)))


@pytest.mark.cuda
@pytest.mark.parametrize('scene', ['ldc_3d', 'ldc_2d', 'ldc_3d_int16',
                                   'sc_separation_3d', 'fe_viscous_fingering',
                                   'sc_separation_2d'])
def test_two_axis_shards_on_four_gpus_equal_the_unsharded_kernel(cuda,
                                                                 scene):
    """A 2x2 mesh with one shard per GPU: each GPU's edge exchange reads
    its outer, inner and diagonal neighbours through peer access, once per
    GPU and step; the run equals the unsharded kernel run bit for bit, and
    both exchanges their plain versions on random buffers."""
    from sailfish_tpu_torch.parallel import halo
    if torch.cuda.device_count() < 4:
        pytest.skip('needs four CUDA devices')
    devices = [f'cuda:{i}' for i in range(4)]
    multi = scene in MESH_MULTI_SCENES
    make, size = (MESH_MULTI_SCENES if multi else MESH_SCENES)[scene]
    extra = dict(seed=1234) if multi else {}
    ref = run(make(), platform='cuda', max_iters=40, every=20, **size,
              **extra)
    halo.reset_launch_counts()
    r = (_multi_run(scene, '2x2', devices, max_iters=40, every=20) if multi
         else _mesh_run(scene, '2x2', devices, max_iters=40, every=20))
    stp = r.stepper
    assert [ks.a.device.index for ks in stp.kernels] == [0, 1, 2, 3]
    assert halo.LAUNCHES[stp.name] == 40 * 4
    leaves = (lambda f: (f,) if torch.is_tensor(f) else f)
    assert all(torch.equal(a.to(b.device), b)
               for a, b in zip(leaves(r.f), leaves(ref.f)))
    assert _edge_exchanges(stp) == (True, True)


# -- the outflow family, the laminarize plane mean and force objects on a
# -- mesh (the ghost-plane outflow mode; laminarize_mean_ghost_<grid>)

#: the meshes of the outflow card tests per (dimension, flow axis): along
#: the sharded axis and across it, one axis and two
OUTFLOW_MESHES = {(3, 'z'): ('2', '2x2'), (3, 'x'): ('2', '2x2'),
                  (2, 'y'): ('2', '2x2'), (2, 'x'): ('1x2', '2x2')}


def _outflow_mesh_run(kind, where, mesh, devices=None, **cfg):
    from sailfish_tpu_torch.parallel import mesh as pmesh
    dim, axis = where
    with pmesh.devices_override(devices or ['cuda'] * 4):
        return run(outflow_channel(kind, dim, axis), platform='cuda',
                   mesh=mesh, **OUTFLOW_SIZES[where], **cfg)


@pytest.mark.cuda
@pytest.mark.parametrize('where,mesh', [(w, m) for w in sorted(OUTFLOW_MESHES)
                                        for m in OUTFLOW_MESHES[w]])
@pytest.mark.parametrize('kind', [k for k in KERNEL_OUTFLOW_KINDS
                                  if k != 'NTGradFreeflow'])
def test_ghost_outflow_mode_matches_its_plain_version(cuda, kind, where,
                                                      mesh):
    """The shards' ``lbm_step_ghost_outflow_<grid>`` launches (after the
    mesh pre-pass with a laminarize row) from a random state against the
    sharded step's plain version: one step within 1e-6, 50 within 1e-5 on
    the wet nodes; then 40 steps through the controller, the unsharded
    kernel run's bits, one ghost launch per shard holding an outflow row
    and step, and one exchange per step."""
    from sailfish_tpu_torch.parallel import halo
    r = _outflow_mesh_run(kind, where, mesh, max_iters=0)
    stp = r.stepper
    g = r.sim.grid.name.lower()
    f0 = random_feq(r.sim.grid, r._domain_shape(), seed=3, device='cuda')
    wet = torch.as_tensor(wet_map(r.maps), device='cuda')
    one = stp.gather(stp.run(f0, 1))
    ref = stp.gather(stp.reference(f0))
    assert float((one - ref)[:, wet].abs().max()) <= 1e-6
    fk = stp.gather(stp.run(f0, 50))
    s = stp.shard(f0)
    for _ in range(50):
        s = stp.reference(s)
    torch.cuda.synchronize()
    assert float((fk - stp.gather(s))[:, wet].abs().max()) <= 1e-5
    ref = run(outflow_channel(kind, *where), platform='cuda', max_iters=40,
              every=20, **OUTFLOW_SIZES[where])
    ls.reset_launch_counts()
    halo.reset_launch_counts()
    r = _outflow_mesh_run(kind, where, mesh, max_iters=40, every=20)
    torch.cuda.synchronize()
    stp = r.stepper
    outflow = [ks for ks in stp.kernels if ks.outflow]
    assert outflow and all(ks.name == f'lbm_step_ghost_outflow_{g}'
                           for ks in outflow)
    assert ls.LAUNCHES[f'lbm_step_ghost_outflow_{g}'] == 40 * len(outflow)
    assert ls.LAUNCHES[stp.lam_name] == (40 if kind == 'NTLaminarize'
                                         else 0)
    assert sum(halo.LAUNCHES.values()) == 40 == stp.exchanges
    assert torch.equal(r.f, ref.f)


@pytest.mark.cuda
@pytest.mark.parametrize('where,mesh', [((2, 'y'), '2'), ((2, 'x'), '2x2'),
                                        ((3, 'z'), '2'), ((3, 'x'), '2x2')])
def test_laminarize_mesh_prepass_matches_its_plain_version(cuda, where,
                                                          mesh):
    """``laminarize_mean_ghost_<grid>``: one launch writes every shard
    kernel's plane means; they equal the plain version's within 1e-6 and
    the unsharded ``laminarize_mean_<grid>``'s bit for bit."""
    r = _outflow_mesh_run('NTLaminarize', where, mesh, max_iters=0)
    stp = r.stepper
    f0 = random_feq(r.sim.grid, r._domain_shape(), seed=5, device='cuda')
    parts = stp.shard(f0).parts
    ls.reset_launch_counts()
    stp.lam_prepass(parts)
    torch.cuda.synchronize()
    assert ls.LAUNCHES[stp.lam_name] == 1 == sum(ls.LAUNCHES.values())
    got = [ks.lam.mean.clone() if ks.lam is not None else None
           for ks in stp.kernels]
    stp.lam.plain_into(parts, stp.kernels)
    flat = run(outflow_channel('NTLaminarize', *where), platform='cuda',
               max_iters=0, **OUTFLOW_SIZES[where]).kernel
    mean = torch.empty_like(flat.lam.mean)
    flat.mean_into(f0, mean)
    padded = torch.cat([mean, mean.new_zeros((1, mean.shape[1]))])
    for s, (ks, m) in enumerate(zip(stp.kernels, got)):
        if ks.lam is None:
            continue
        assert float((m - ks.lam.mean).abs().max()) <= 1e-6
        idx = stp.lam.shard_entries(s, ks)
        inside = torch.as_tensor(idx >= 0, device='cuda')
        want = padded[torch.as_tensor(np.where(idx < 0, -1, idx),
                                      device='cuda')]
        assert torch.equal(m[inside], want[inside])


@pytest.mark.cuda
@pytest.mark.parametrize('mesh', ['2', '2x2'])
@pytest.mark.parametrize('dim', [3, 2])
def test_open_channel_shards_on_one_card(cuda, dim, mesh):
    """The open channel with its force object over the mesh on one card:
    the unsharded kernel run's state and drag series, bit for bit."""
    from sailfish_tpu_torch.parallel import mesh as pmesh
    size = dict(lat_nx=96, lat_ny=32, lat_nz=32) if dim == 3 else \
        dict(lat_nx=384, lat_ny=96)
    cfg = dict(platform='cuda', max_iters=60, every=20, **size)
    ref = run(open_channel(dim), **cfg)
    with pmesh.devices_override(['cuda'] * 4):
        r = run(open_channel(dim), mesh=mesh, **cfg)
    assert r.kernel is r.stepper
    assert torch.equal(r.f, ref.f)
    assert [(it, tuple(F)) for it, F in r.sim.drag] == \
        [(it, tuple(F)) for it, F in ref.sim.drag]


@pytest.mark.cuda
@pytest.mark.parametrize('scene', ['open_sphere_3d', 'laminarize_2d'])
def test_outflow_shards_on_several_gpus(cuda, scene):
    """One shard per visible GPU (two or four), then 2x2 on four: the
    unsharded kernel run's state (and drag series) bit for bit, the
    laminarize pre-pass reading its planes across GPUs."""
    from sailfish_tpu_torch.parallel import mesh as pmesh
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip('needs two or more CUDA devices')
    if scene == 'open_sphere_3d':
        make = (lambda: open_channel(3))
        size = dict(lat_nx=96, lat_ny=32, lat_nz=32)
    else:
        make = (lambda: outflow_channel('NTLaminarize', 2, 'x'))
        size = dict(lat_nx=384, lat_ny=96)
    cfg = dict(platform='cuda', max_iters=40, every=20, **size)
    ref = run(make(), **cfg)
    meshes = [str(max(k for k in (2, 4) if k <= n))] + \
        (['2x2'] if n >= 4 else [])
    for mesh in meshes:
        k = int(np.prod([int(c) for c in mesh.split('x')]))
        with pmesh.devices_override([f'cuda:{i}' for i in range(k)]):
            r = run(make(), mesh=mesh, **cfg)
        assert [ks.a.device.index for ks in r.stepper.kernels] == \
            list(range(k))
        assert torch.equal(r.f.to(ref.f.device), ref.f), mesh
        if hasattr(ref.sim, 'drag'):
            assert [tuple(F) for _i, F in r.sim.drag] == \
                [tuple(F) for _i, F in ref.sim.drag]
