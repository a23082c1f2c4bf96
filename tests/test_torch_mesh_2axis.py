"""Sharded runs of single-fluid scenes on meshes of two axes (``--mesh=AxB``:
('z', 'y') in 3D, ('y', 'x') in 2D; ``sailfish_tpu_torch/parallel``) on the
CPU.

* A run over 3D ``2x2``, ``1x2``, ``2x1``, ``1x4`` and 2D ``1x2``, ``2x2``,
  ``1x4`` meshes equals the unsharded run bit for bit, on the torch engine
  and on the kernel engine's plain version (the runner's engine forced to
  'kernel'): the cavities (the 3D lid cut by the y shards, its side walls
  on the y ring's boundary; the 2D lid cut by the x shards), the
  Taylor-Green vortex, single-component Shan-Chen, and on ``2x2`` one
  scene per mode class (MRT, LES under Guo, ELBM, int16 codes, half-way
  walls, dynamic and varying rows, D3Q15 with its hook, TMS walls with the
  Reynolds hook, an x-normal inlet face cut by the y shards, a y-normal 2D
  inlet cut by the x shards, a hook over int16 codes).
* The exchange on two axes fills every ghost region of every slab, node
  by node: the outer axis's ghost planes over the inner axis's interior,
  the inner axis's ghost rows, and the edges (corners in 2D) from the
  diagonal neighbour, each in its crossing directions only; the density
  exchange whole regions; the launch plan and the parameter blocks of the
  edge mode.
* The port's sharded run against the JAX runner's run on the same mesh
  (on the CPU the JAX runner steps two-axis meshes on its XLA engine, its
  default there): rho and u within 1e-6 after 20 steps.
* A checkpoint written on ``2x2`` restores on ``2``, unsharded and in the
  JAX package.
* What a two-axis mesh still refuses, by name.
"""

import glob
import os
from unittest import mock

import numpy as np
import pytest
import torch

from sailfish_tpu.controller import \
    LBSimulationController as JaxController
from sailfish_tpu_torch import lattice
from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.parallel import halo
from sailfish_tpu_torch.parallel import mesh as pmesh
from sailfish_tpu_torch.runner import SubdomainRunner
from torch_scenes import (REPO, SINGLE_SCENES, channel_sim, channel_sim_2d,
                          load_example, run, turbulence_twin, twin, wet_map)

torch.set_num_threads(1)

CUBE = dict(lat_nx=16, lat_ny=16, lat_nz=16)
SQUARE = dict(lat_nx=32, lat_ny=32)
#: the 2D runs over x shards: a slab's rows at least 32 nodes long. On the
#: CPU ``torch.sum`` over the directions rounds the last (plane count mod
#: 32) nodes of a tensor in another order than the rest; a slab's row must
#: hold them, so that they fall on its last ghost row
#: (``test_narrow_2d_slabs_round_the_last_row_otherwise_on_the_cpu``)
WIDE = dict(lat_nx=128, lat_ny=32)
MESHES_3D = ('2x2', '1x2', '2x1', '1x4')
MESHES_2D = ('1x2', '2x2', '1x4')


def _run_on(engine, sim_cls, **cfg):
    with mock.patch.object(SubdomainRunner, '_select_engine',
                           lambda self: engine):
        return run(sim_cls, platform='cpu', **cfg)


def _size(mesh):
    return int(np.prod([int(c) for c in mesh.split('x')]))


#: scene -> (sim class factory, flags, meshes)
BITWISE = {
    'ldc_3d': (lambda: twin('ldc_3d'), CUBE, MESHES_3D),
    'ldc_3d_24': (lambda: twin('ldc_3d'),
                  dict(lat_nx=24, lat_ny=16, lat_nz=16), ('2x2',)),
    'ldc_2d': (lambda: twin('ldc_2d'), WIDE, MESHES_2D),
    'ldc_2d_32': (lambda: twin('ldc_2d'), SQUARE, ('2x2', '1x2')),
    'taylor_green_2d': (lambda: twin('taylor_green_2d'),
                        dict(lat_nx=128, lat_ny=48), MESHES_2D),
    'sc_phase_separation_3d': (lambda: twin('sc_phase_separation_3d'), CUBE,
                               MESHES_3D),
    'sc_phase_separation': (lambda: twin('sc_phase_separation'), WIDE,
                            MESHES_2D),
    'mrt': (lambda: twin('ldc_3d'), dict(CUBE, model='mrt', visc=0.05),
            ('2x2',)),
    'les_guo_sphere': (lambda: twin('sphere_3d'),
                       dict(lat_nx=24, lat_ny=16, lat_nz=16,
                            subgrid='les-smagorinsky', visc=0.05), ('2x2',)),
    'elbm': (lambda: twin('ldc_2d_entropic'), SQUARE, ('2x2',)),
    'int16': (lambda: twin('ldc_3d'), dict(CUBE, precision='mixed'),
              ('2x2',)),
    'duct_flow_halfway': (lambda: twin('duct_flow'),
                          dict(lat_nx=16, lat_ny=16, lat_nz=8), ('2x2',)),
    'womersley_dynamic': (lambda: twin('womersley'),
                          dict(lat_nx=32, lat_ny=12, lat_nz=12), ('2x2',)),
    'poiseuille_sa_varying': (lambda: twin('poiseuille_sa'),
                              dict(lat_nx=48, lat_ny=32,
                                   velocity='spatial_array'), ('2x2',)),
    'kida_d3q15_hook': (lambda: turbulence_twin('kida_vortex'),
                        dict(CUBE, visc=0.01, stats_every=5), ('2x2',)),
    'channel_flow_tms_hook': (lambda: turbulence_twin('channel_flow'),
                              dict(H=8, Re_tau=60, wall='tms',
                                   stats_every=5), ('2x2',)),
    'inlet_x_cut_by_y_shards': (
        lambda: channel_sim('regularized', 'x', profile='parabolic'),
        dict(CUBE, periodic_z=True), ('2x2', '1x4')),
    'inlet_y_cut_by_x_shards_2d': (
        lambda: channel_sim_2d('zouhe', axis='y'), WIDE, ('2x2',)),
    'int16_hook': (lambda: twin('ldc_2d_unorm'),
                   dict(SQUARE, unorm_every=7, precision='mixed'), ('2x2',)),
}
CASES = [(scene, engine, mesh) for scene, (_m, _f, meshes) in BITWISE.items()
         for engine in ('torch', 'kernel') for mesh in meshes]


@pytest.mark.parametrize('scene,engine,mesh', CASES)
def test_two_axis_run_equals_the_unsharded_run_bitwise(scene, engine, mesh):
    make, flags, _meshes = BITWISE[scene]
    steps = 20
    cfg = dict(max_iters=steps, every=steps // 2, seed=1234, **flags)
    ref = _run_on(engine, make(), **cfg)
    r = _run_on(engine, make(), mesh=mesh, **cfg)
    stp = r.stepper
    assert r.engine == engine and (r.kernel is stp) == (engine == 'kernel')
    assert stp.mesh.size == _size(mesh) and len(stp.mesh.axis_names) == 2
    assert stp.inner is not None and 'edge_' in stp.name
    assert stp.exchanges == steps
    assert r.sim.iteration == ref.sim.iteration == steps
    assert torch.equal(r.f, ref.f), float((r.f - ref.f).abs().max())
    # the output fields are reduced per shard, over rows cut along the
    # inner axis: PyTorch's vectorized CPU reductions may round a node's
    # sum in another order than over the whole row (one ulp)
    r._fields_to_host()
    ref._fields_to_host()
    for name in ('rho', 'vx', 'vy'):
        np.testing.assert_array_max_ulp(getattr(r.sim, name),
                                        getattr(ref.sim, name), maxulp=1)
    if r.device_hook_state:
        for a, b in zip(r.device_hook_state, ref.device_hook_state):
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                torch.testing.assert_close(x, y, rtol=1e-5, atol=0)


@pytest.mark.parametrize('mesh', ['2x2', '1x4'])
@pytest.mark.parametrize('engine', ['torch', 'kernel'])
def test_narrow_2d_slabs_round_the_last_row_otherwise_on_the_cpu(engine,
                                                                 mesh):
    """On the CPU, PyTorch's vectorized sum over the directions rounds the
    last (plane count mod 32) nodes of a tensor in another order than the
    rest. The Taylor-Green vortex at 32 x 48 has slabs of 26 x 18 nodes on
    ``2x2`` (468 mod 32 = 20) and 50 x 10 on ``1x4`` (500 mod 32 = 20): the
    tail reaches the last interior row, whose densities may round an ulp
    apart from the unsharded run's; the state stays within 1e-6 after 20
    steps. The CUDA kernels compute each node alone: on the card narrow
    slabs give the unsharded bits (tests/test_torch_cuda.py)."""
    cfg = dict(max_iters=20, every=20, seed=1234, lat_nx=32, lat_ny=48)
    ref = _run_on(engine, twin('taylor_green_2d'), **cfg)
    r = _run_on(engine, twin('taylor_green_2d'), mesh=mesh, **cfg)
    assert r.stepper.builders[0].maps.type_map.shape[1] < 32
    diff = float((r.f - ref.f).abs().max())
    assert diff <= 1e-6, diff


def test_a_varying_row_on_a_ring_of_one_shard():
    """On ``1x4`` the y ring has one shard, so its ghost rows wrap onto the
    slab's own: the y-normal inlet at y = 0 stands on rows 1 and L + 1 of
    every slab, and its parameter box spans the slab. The torch engine
    gives the unsharded bits; the kernel engine refuses the box by name,
    as it does on a ``--mesh=1`` ring of one (the box limit of
    ``ops/bc_patch.instance_boxes``)."""
    cfg = dict(max_iters=20, every=10, seed=1234, **SQUARE)
    ref = _run_on('torch', channel_sim_2d('zouhe', axis='y'), **cfg)
    r = _run_on('torch', channel_sim_2d('zouhe', axis='y'), mesh='1x4',
                **cfg)
    assert torch.equal(r.f, ref.f)
    for mesh in ('1x4', '1'):
        with pytest.raises(NotImplementedError,
                           match='NTZouHeVelocity .*bounding box'):
            _run_on('kernel', channel_sim_2d('zouhe', axis='y'), mesh=mesh,
                    **cfg)


@pytest.mark.parametrize('mesh', ['2x2', '1x4'])
def test_a_device_hook_on_a_two_axis_mesh_matches_the_unsharded_run(mesh):
    flags = dict(CUBE, visc=0.01, stats_every=5, max_iters=20, every=20)
    mine = run(turbulence_twin('kida_vortex'), platform='cpu', mesh=mesh,
               **flags).sim.ke_enstrophy_series()
    ref = run(turbulence_twin('kida_vortex'), platform='cpu',
              **flags).sim.ke_enstrophy_series()
    assert list(mine[:, 0]) == [5.0, 10.0, 15.0, 20.0]
    np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=0)


# -- the layout and the exchange ---------------------------------------------

@pytest.mark.parametrize('counts,ghost', [((2, 2), 0), ((2, 2), 1),
                                          ((1, 4), 2), ((3, 1), 1)])
def test_split_and_gather_on_two_axes_are_inverse(counts, ghost):
    f = torch.arange(3 * 6 * 8 * 5, dtype=torch.float32).reshape(3, 6, 8, 5)
    mesh = pmesh.make_mesh(counts, 3, ['cpu'] * int(np.prod(counts)))
    parts = pmesh.split(f, mesh, ghost=ghost)
    lo, li = 6 // counts[0], 8 // counts[1]
    assert [tuple(p.shape) for p in parts] == \
        [(3, lo + 2 * ghost, li + 2 * ghost, 5)] * len(parts)
    assert torch.equal(pmesh.gather(parts, ghost=ghost, counts=counts), f)
    # shard s = (outer, inner), the outer axis slowest; the rings wrap
    for s, p in enumerate(parts):
        io, ii = pmesh.shard_index(s, counts)
        rows = pmesh.slab_rows(6, counts[0], io, ghost)
        cols = pmesh.slab_rows(8, counts[1], ii, ghost)
        assert torch.equal(p, f[:, rows][:, :, cols])


def _layout(grid_name, counts, ghost=1):
    """A torch-engine stepper of a periodic box on a mesh of ``counts``
    shards (the scene only lends it its layout)."""
    dim = 2 if grid_name == 'D2Q9' else 3
    flags = dict(lat_nx=8, lat_ny=12, lat_nz=12) if dim == 3 else \
        dict(lat_nx=12, lat_ny=12)
    scene = {'D3Q19': 'ldc_3d', 'D2Q9': 'ldc_2d'}.get(grid_name, 'ldc_3d')
    if grid_name in ('D3Q15', 'D3Q27'):
        flags['grid'] = grid_name
    r = _run_on('torch', twin(scene), mesh='x'.join(map(str, counts)),
                max_iters=0, **flags)
    return r.stepper


@pytest.mark.parametrize('grid_name,edge', [('D2Q9', 1), ('D3Q15', 2),
                                            ('D3Q19', 1), ('D3Q27', 3)])
def test_region_directions_on_two_axes(grid_name, edge):
    """The ghost planes and rows take the crossing directions of their
    axis; each edge the directions that cross both axes towards it."""
    grid = lattice.get_grid(grid_name)
    regions = halo.region_directions(grid, two_axis=True)
    assert regions[(-1, 0)] == halo.crossing_directions(grid)[0]
    assert regions[(1, 0)] == halo.crossing_directions(grid)[1]
    assert regions[(0, -1)] == halo.crossing_directions(grid, 1)[0]
    assert regions[(0, 1)] == halo.crossing_directions(grid, 1)[1]
    dim = grid.dim
    for so, si in halo.REGIONS[4:]:
        dirs = regions[(so, si)]
        assert len(dirs) == edge
        for i in dirs:
            assert int(grid.basis[i][dim - 1]) == -so
            assert int(grid.basis[i][dim - 2]) == -si
    assert halo.region_directions(grid) == {
        k: regions[k] for k in halo.REGIONS[:2]}


@pytest.mark.parametrize('grid_name,counts', [
    ('D3Q19', (2, 2)), ('D3Q19', (1, 3)), ('D3Q27', (3, 2)),
    ('D2Q9', (2, 2)), ('D2Q9', (1, 4)), ('D2Q9', (3, 1))])
def test_edge_exchange_fills_every_region_node_by_node(grid_name, counts):
    """After ``exchange_reference`` on two axes every ghost node holds, in
    the directions of its region, the value the global state has there
    (``shard``); every other ghost value, and the interior, is left as it
    was. An edge (corner) node's directions come from the diagonal
    shard."""
    stp = _layout(grid_name, counts)
    grid, g = stp.grid, stp.ghost
    shape = tuple(pmesh.counts_of(stp.mesh)[a] * n for a, n in
                  enumerate((stp.length, stp.inner[1]))) + \
        tuple(stp.builders[0].maps.type_map.shape[2:])
    f = torch.rand((grid.Q,) + shape, generator=torch.Generator()
                   .manual_seed(3))
    full = stp.shard(f).parts
    parts = []
    for p in full:
        p = p.clone()
        p[:, :g] = -1.0
        p[:, -g:] = -1.0
        p[:, :, :g] = -1.0
        p[:, :, -g:] = -1.0
        parts.append(p)
    stp.exchange_reference(parts)
    lo, li = stp.length, stp.inner[1]

    def side(i, n):
        return -1 if i < g else 1 if i >= n + g else 0

    for p, ref in zip(parts, full):
        for z in range(lo + 2 * g):
            for y in range(li + 2 * g):
                region = (side(z, lo), side(y, li))
                dirs = stp.regions.get(region, tuple(range(grid.Q)))
                for i in range(grid.Q):
                    want = ref[i, z, y] if i in dirs else \
                        torch.full_like(ref[i, z, y], -1.0)
                    assert torch.equal(p[i, z, y], want), (z, y, i)


@pytest.mark.parametrize('grid_name,counts,ghost', [
    ('D3Q19', (2, 2), 1), ('D2Q9', (1, 2), 1), ('D2Q9', (2, 2), 2)])
def test_density_edge_exchange_fills_every_ghost_node(grid_name, counts,
                                                      ghost):
    """The density exchange on two axes fills every ghost node (``ghost``
    deep, the edges and corners from the diagonal shard) with the global
    density there, and leaves the interior alone."""
    stp = _layout(grid_name, counts)
    n_out, n_in = counts
    shape = (n_out * stp.length, n_in * stp.inner[1]) + \
        tuple(stp.builders[0].maps.type_map.shape[2:])
    rho = torch.rand(shape, generator=torch.Generator().manual_seed(4))
    full = pmesh.split(rho, stp.mesh, axis=0, ghost=ghost)
    parts = [p.clone() for p in full]
    for p in parts:
        p[:ghost] = -1.0
        p[-ghost:] = -1.0
        p[:, :ghost] = -1.0
        p[:, -ghost:] = -1.0
    halo.ghost_copy([[p] for p in parts], stp.length, ghost, ghost,
                    inner=stp.inner)
    for p, ref in zip(parts, full):
        assert torch.equal(p, ref)


@pytest.mark.parametrize('devices,counts,plan', [
    (['a'] * 4, (2, 2), [('a', (0, 1, 2, 3), ())]),
    (['a', 'b', 'c', 'd'], (2, 2),
     [('a', (0,), ('c', 'b', 'd')), ('b', (1,), ('d', 'a', 'c')),
      ('c', (2,), ('a', 'd', 'b')), ('d', (3,), ('b', 'c', 'a'))]),
    (['a', 'b', 'c', 'd'], (1, 4),
     [('a', (0,), ('d', 'b')), ('b', (1,), ('a', 'c')),
      ('c', (2,), ('b', 'd')), ('d', (3,), ('c', 'a'))]),
    (['a', 'a', 'b', 'b'], (2, 2), [('a', (0, 1), ('b',)),
                                    ('b', (2, 3), ('a',))])])
def test_edge_exchange_plan_waits_for_every_neighbour(devices, counts, plan):
    """One launch per device; it waits for the devices of its shards'
    outer, inner and diagonal neighbours."""
    assert halo.exchange_plan(devices, counts) == plan


def test_edge_exchange_params_of_one_launch():
    """The parameter block of the edge mode: the inner axis's shards,
    padded rows and row units, the crossing directions of its ghost rows
    and of the four edges; the copy unit divides a row."""
    grid = lattice.get_grid('D3Q19')
    regions = halo.region_directions(grid, two_axis=True)
    row, rows, length, inner_length = 8 * 4, 6, 4, 4
    plane = rows * row
    p = halo.exchange_params((11, 22, 33, 44), length, plane,
                             regions[(-1, 0)], regions[(1, 0)], (0, 3), 1,
                             1, 2, grid.Q * 6 * plane,
                             (2, inner_length, row, regions))
    assert p.n_inner == 2 and p.inner_planes == 6 and p.unit_bytes == 16
    assert p.row_units * 16 == row and p.units == 6 * p.row_units
    assert (p.n_lo_in, p.n_hi_in) == (5, 5)
    assert list(p.lo_in)[:5] == list(regions[(0, -1)])
    assert list(p.hi_in)[:5] == list(regions[(0, 1)])
    assert list(p.n_edge) == [1, 1, 1, 1]
    assert [p.edge[e][0] for e in range(4)] == \
        [regions[r][0] for r in halo.REGIONS[4:]]
    # a 2D row is one value: 4-byte units at a row's stride
    g2 = lattice.get_grid('D2Q9')
    r2 = halo.region_directions(g2, two_axis=True)
    q = halo.exchange_params((1, 2), 4, 6 * 4, r2[(-1, 0)], r2[(1, 0)],
                             (0, 1), 1, 1, 1, 0, (2, 4, 4, r2))
    assert q.unit_bytes == 4 and q.row_units == 1 and q.units == 6
    with pytest.raises(ValueError, match='rows of'):
        halo.exchange_params((1, 2), 4, 7 * 4, r2[(-1, 0)], r2[(1, 0)],
                             (0, 1), 1, 1, 1, 0, (2, 4, 4, r2))


def test_shard_maps_keep_both_global_coordinates():
    """A shard's maps keep ``rows`` and ``cols``; ``map_coords`` gives the
    global coordinate along both sharded axes."""
    from sailfish_tpu_torch.ops import step as st
    r = _run_on('torch', twin('ldc_3d'), mesh='2x2', max_iters=0, **CUBE)
    for b, rows, cols in zip(r.stepper.builders, r.stepper.rows,
                             r.stepper.cols):
        m = b.maps
        assert list(m.rows) == list(rows) and list(m.cols) == list(cols)
        assert np.array_equal(m.type_map,
                              r.maps.type_map[rows][:, cols])
        hx, hy, hz = st.map_coords(m)
        assert torch.equal(hz[:, 0, 0], torch.as_tensor(rows,
                                                        dtype=torch.int32))
        assert torch.equal(hy[0, :, 0], torch.as_tensor(cols,
                                                        dtype=torch.int32))
        assert torch.equal(hx[0, 0], torch.arange(16, dtype=torch.int32))


def test_exchange_on_the_cpu_is_the_plain_version_on_two_axes():
    """On CPU tensors the edge exchange is ``exchange_reference`` and
    launches nothing; the shards' launches count under the ghost key."""
    r = _run_on('kernel', twin('ldc_3d'), mesh='2x2', max_iters=0, **CUBE)
    stp = r.stepper
    assert {ks.name for ks in stp.kernels} == {'lbm_step_ghost_d3q19'}
    assert stp.name == 'halo_edge_exchange_d3q19'
    assert stp.rho_name == 'halo_rho_edge_exchange_d3q19'
    parts = [p.clone() for p in r.state.parts]
    halo.reset_launch_counts()
    with mock.patch.object(halo.ShardedStep, 'exchange_reference') as ref:
        stp.exchange(parts)
    ref.assert_called_once_with(parts)
    assert sum(halo.LAUNCHES.values()) == 0 and stp.exchanges == 1


# -- against the JAX runner on a mesh ----------------------------------------

def _jax_runner(rel, cls_name, **cfg):
    cls = getattr(load_example(rel, f'jax_mesh2_{cls_name}'), cls_name)
    jc = JaxController(cls, default_config=dict(quiet=True, platform='cpu',
                                                **cfg))
    jc.run(ignore_cmdline=True)
    return jc._runner


@pytest.mark.parametrize('scene,mesh,flags,tol', [
    ('ldc_3d', '2x2', CUBE, 1e-6),
    ('ldc_2d', '2x2', SQUARE, 1e-6),
    ('ldc_2d', '1x2', SQUARE, 1e-6),
    ('taylor_green_2d', '2x2', dict(lat_nx=32, lat_ny=48), 1e-6),
    ('sc_phase_separation_3d', '1x2', CUBE, 1e-6),
])
def test_two_axis_run_matches_the_jax_runner_on_the_same_mesh(
        scene, mesh, flags, tol, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, 'examples'))
    cfg = dict(max_iters=20, every=20, seed=1234, mesh=mesh, **flags)
    jr = _jax_runner(f'{scene}.py', SINGLE_SCENES[scene], **cfg)
    assert jr.mesh is not None and len(jr.mesh.axis_names) == 2
    r = run(twin(scene), platform='cpu', **cfg)
    assert r.stepper is not None and r.stepper.inner is not None
    jr._fields_to_host()
    r._fields_to_host()
    wet = wet_map(r.maps)
    names = ('rho', 'vx', 'vy') + (('vz',) if r.sim.dim == 3 else ())
    for name in names:
        a, b = getattr(r.sim, name), getattr(jr.sim, name)
        assert np.max(np.abs(a[wet] - b[wet])) <= tol, name
    assert np.ptp(r.sim.rho[wet]) > 1e-7


# -- checkpoints -------------------------------------------------------------

def _ldc3(tmp_path, name, **cfg):
    ctrl = LBSimulationController(twin('ldc_3d'), default_config=dict(
        platform='cpu', quiet=True, checkpoint_file=str(tmp_path / name),
        final_checkpoint=True, **CUBE, **cfg))
    ctrl.run(ignore_cmdline=True)
    return ctrl._runner


@pytest.mark.parametrize('second', ['2', '', '1x4'])
def test_checkpoint_from_a_two_axis_mesh_restores_anywhere(tmp_path,
                                                           second):
    """10 steps on ``2x2``, checkpoint (the global layout), 10 more on
    another layout == 20 steps unsharded, bit for bit."""
    _ldc3(tmp_path, 'a', max_iters=10, every=10, mesh='2x2')
    (cpoint,) = glob.glob(str(tmp_path / 'a') + '*.cpoint.npz')
    assert np.load(cpoint)['dist0a'].shape == (19, 16, 16, 16)
    r = _ldc3(tmp_path, 'b', max_iters=20, every=20, mesh=second,
              restore_from=cpoint)
    ref = _ldc3(tmp_path, 'c', max_iters=20, every=20)
    assert r.sim.iteration == 20 and (r.stepper is None) == (not second)
    assert torch.equal(r.f, ref.f)


def test_two_axis_checkpoint_continues_in_the_jax_package(tmp_path,
                                                          monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, 'examples'))
    r = _ldc3(tmp_path, 'm', max_iters=10, every=10, mesh='2x2')
    (cpoint,) = glob.glob(str(tmp_path / 'm') + '*.cpoint.npz')
    cfg = dict(max_iters=20, every=20, **CUBE)
    restored = _jax_runner('ldc_3d.py', 'LDCSim', restore_from=cpoint,
                           **cfg)
    ref = _jax_runner('ldc_3d.py', 'LDCSim', **cfg)
    assert restored.sim.iteration == 20
    wet = wet_map(r.maps)
    f, f_ref = np.asarray(restored.f), np.asarray(ref.f)
    assert np.max(np.abs(f[:, wet] - f_ref[:, wet])) <= 1e-6


# -- what a two-axis mesh still refuses --------------------------------------

def _sc_walls_3d():
    """Single-component Shan-Chen in 3D with half-way walls at y = 0 and
    y = max: a BC row beside the coupling, on the y ring's boundary."""
    base = twin('sc_phase_separation_3d')

    class Walls(base.subdomain):
        def boundary_conditions(self, hx, hy, hz):
            self.set_node((hy == 0) | (hy == self.gy - 1), nt.NTHalfBBWall)

    class Sim(base):
        subdomain = Walls

    return Sim


REFUSALS = {
    'shan_chen_bc_row_zy': (_sc_walls_3d, dict(CUBE, mesh='1x2'),
                            'Shan-Chen with complex-BC planes needs global '
                            r'psi sampling.*halo\.py:297'),
    'composite_step_zy': (lambda: turbulence_twin('channel_cube'),
                          dict(H=6, Re_tau=60, buf_az=3, main_az=5, ay=2.5,
                               mesh='2x2'),
                          'a composite step'),
    'three_axis_zyx': (lambda: twin('ldc_3d'), dict(CUBE, mesh='2x2x1'),
                      '3-axis meshes'),
}


@pytest.mark.parametrize('case', sorted(REFUSALS))
def test_refused_on_a_two_axis_mesh_by_name(case):
    make, cfg, match = REFUSALS[case]
    ctrl = LBSimulationController(make(), default_config=dict(
        platform='cpu', max_iters=2, quiet=True, **cfg))
    with pytest.raises(NotImplementedError, match=match):
        ctrl.run(ignore_cmdline=True)


def test_an_inner_axis_that_does_not_divide_is_refused():
    ctrl = LBSimulationController(twin('ldc_3d'), default_config=dict(
        platform='cpu', max_iters=2, quiet=True, lat_nx=8, lat_ny=10,
        lat_nz=8, mesh='2x4'))
    with pytest.raises(ValueError, match='axis y .*not divisible'):
        ctrl.run(ignore_cmdline=True)
