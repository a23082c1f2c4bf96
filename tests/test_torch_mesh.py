"""Sharded runs of the port (``--mesh``, ``sailfish_tpu_torch/parallel``)
on the CPU.

* ``parse_mesh_shape`` agrees with the JAX package's on valid and invalid
  strings; ``make_mesh``, ``validate_divisible``, ``split`` / ``gather``.
* A run over 2 and 4 shards equals the unsharded run bit for bit, on the
  torch engine and on the kernel engine's plain version (the runner's
  engine forced to 'kernel': on CPU tensors ``KernelStep`` runs
  ``step_reference`` and the exchange its PyTorch version): the 2D cavity
  at 32^2 over 120 steps (the JAX package's own check,
  ``tests/test_physics.py:48-64``), the 3D one at 16^3, and one small
  scene per mode class (MRT, LES under Guo, ELBM, int16 codes, half-way
  walls, dynamic and varying rows, D3Q15 with its hook, TMS walls with
  the Reynolds hook, an inlet face that the shard boundary crosses,
  ``--init_iters``, a hook over int16 codes).
* The port's sharded run against the JAX runner's run with the same mesh
  on the 8 host devices of ``tests/conftest.py``: rho and u within 1e-6
  after 20 steps (int16: 2 codes and 3e-5, the rule of
  ``tests/test_torch_mixed.py``).
* A checkpoint written on a mesh restores without one and into the JAX
  package; one written without a mesh restores on a mesh.
* Hook series on a mesh equal the unsharded ones (rtol 1e-5).
* The exchange fills exactly the crossing directions of the ghost planes.
* Every case refused on a mesh raises by name.
"""

import glob
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax
from sailfish_tpu.controller import \
    LBSimulationController as JaxController
from sailfish_tpu.parallel import mesh as jax_mesh
from sailfish_tpu_torch import lattice
from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.parallel import halo
from sailfish_tpu_torch.parallel import mesh as pmesh
from sailfish_tpu_torch.runner import SubdomainRunner
from torch_scenes import (REPO, binary_twin, channel_sim, load_example,
                          outflow_channel, run, turbulence_twin, twin,
                          wet_map)

torch.set_num_threads(1)


# -- the mesh ----------------------------------------------------------------

@pytest.mark.parametrize('text,dim', [
    ('', 3), ('4', 3), ('2', 2), ('2x2', 3), ('1x4', 2), ('2x1x2', 3),
    ('2x2x2', 2), ('1x1x1x2', 3)])
def test_parse_mesh_shape_agrees_with_jax(text, dim):
    def call(fn):
        try:
            return fn(text, dim), None
        except ValueError as exc:
            return None, str(exc)

    assert call(pmesh.parse_mesh_shape) == \
        call(jax_mesh.parse_mesh_shape)


def test_make_mesh_names_axes_and_counts_devices():
    cpu = torch.device('cpu')
    mesh = pmesh.make_mesh((4,), 3, [cpu] * 4)
    assert mesh.axis_names == ('z',) and mesh.shape == {'z': 4}
    assert mesh.devices == [cpu] * 4 and mesh.size == 4
    assert pmesh.make_mesh((2,), 2, [cpu] * 3).axis_names == ('y',)
    assert pmesh.make_mesh((2, 2), 3, [cpu] * 4).axis_names == ('z', 'y')
    with pytest.raises(ValueError, match='needs 4 devices; only 2'):
        pmesh.make_mesh((4,), 3, [cpu] * 2)
    with pmesh.devices_override([cpu] * 2):
        assert pmesh.make_mesh((2,), 3).devices == [cpu, cpu]
        with pytest.raises(ValueError, match='needs 3 devices'):
            pmesh.make_mesh((3,), 3)


def test_validate_divisible_agrees_with_jax():
    mesh = pmesh.make_mesh((4,), 3, ['cpu'] * 4)
    jmesh = jax_mesh.make_mesh((4,), 3, jax.devices('cpu'))
    pmesh.validate_divisible((16, 6, 5), mesh)
    with pytest.raises(ValueError) as mine:
        pmesh.validate_divisible((18, 8, 8), mesh)
    with pytest.raises(ValueError) as theirs:
        jax_mesh.validate_divisible((18, 8, 8), jmesh)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize('ghost', [0, 1])
def test_split_and_gather_are_inverse(ghost):
    f = torch.arange(3 * 8 * 2 * 5, dtype=torch.float32).reshape(3, 8, 2, 5)
    mesh = pmesh.make_mesh((4,), 3, ['cpu'] * 4)
    parts = pmesh.split(f, mesh, ghost=ghost)
    assert [tuple(p.shape) for p in parts] == [(3, 2 + 2 * ghost, 2, 5)] * 4
    assert torch.equal(pmesh.gather(parts, ghost=ghost), f)
    if ghost:
        # the ring wraps: shard 0's low ghost plane is the last plane
        assert torch.equal(parts[0][:, 0], f[:, -1])
        assert torch.equal(parts[3][:, -1], f[:, 0])
        assert list(pmesh.slab_rows(8, 4, 0, 1)) == [7, 0, 1, 2]


@pytest.mark.parametrize('grid_name,n', [('D2Q9', 3), ('D3Q15', 5),
                                         ('D3Q19', 5), ('D3Q27', 9)])
def test_exchange_fills_the_crossing_directions(grid_name, n):
    """After ``exchange_reference`` the crossing directions of every ghost
    plane hold the ring neighbour's plane, as ``shard`` of the global
    state has them; the other directions are left as they were."""
    grid = lattice.get_grid(grid_name)
    lo, hi = halo.crossing_directions(grid)
    assert len(lo) == len(hi) == n
    shape = (12, 4, 3) if grid.dim == 3 else (12, 5)
    f = torch.rand((grid.Q,) + shape, generator=torch.Generator()
                   .manual_seed(3))
    step = mock.Mock(spec=halo.ShardedStep)
    step.length, step.lo, step.hi = 4, lo, hi
    step.inner, step.regions = None, halo.region_directions(grid)
    step._index = {}
    step._indices = lambda dev: halo.ShardedStep._indices(step, dev)
    full = pmesh.split(f, pmesh.make_mesh((3,), grid.dim, ['cpu'] * 3),
                       ghost=1)
    parts = [p.clone() for p in full]
    for p in parts:
        p[:, 0] = -1.0
        p[:, -1] = -1.0
    halo.ShardedStep.exchange_reference(step, parts)
    for p, ref in zip(parts, full):
        assert torch.equal(p[:, 1:-1], ref[:, 1:-1])
        for plane, dirs in ((0, lo), (-1, hi)):
            for i in range(grid.Q):
                want = ref[i, plane] if i in dirs else \
                    torch.full_like(ref[i, plane], -1.0)
                assert torch.equal(p[i, plane], want), (plane, i)


@pytest.mark.parametrize('devices,plan', [
    (['a'], [('a', (0,), ())]),
    (['a', 'a', 'a', 'a'], [('a', (0, 1, 2, 3), ())]),
    (['a', 'b'], [('a', (0,), ('b',)), ('b', (1,), ('a',))]),
    (['a', 'b', 'c', 'd'], [('a', (0,), ('d', 'b')), ('b', (1,), ('a', 'c')),
                            ('c', (2,), ('b', 'd')), ('d', (3,), ('c', 'a'))]),
    (['a', 'a', 'b', 'b'], [('a', (0, 1), ('b',)), ('b', (2, 3), ('a',))]),
    (['a', 'b', 'a', 'b'], [('a', (0, 2), ('b',)), ('b', (1, 3), ('a',))])])
def test_exchange_plan_launches_once_per_device(devices, plan):
    """One exchange launch per device, filling the ghost planes of the
    shards on it and waiting for the devices its shards' ring neighbours
    are on."""
    assert halo.exchange_plan(devices) == plan


@pytest.mark.parametrize('dtype,nodes,unit', [
    (torch.float32, 8 * 6, 16), (torch.float32, 5 * 6, 4),
    (torch.int16, 5 * 3, 2)])
def test_exchange_params_of_one_launch(dtype, nodes, unit):
    """The parameter block of one launch: every shard's buffer (a
    neighbour on another device included), its destinations only, the
    widest copy unit that divides a plane."""
    grid = lattice.get_grid('D3Q19')
    lo, hi = halo.crossing_directions(grid)
    plane = nodes * torch.tensor([], dtype=dtype).element_size()
    p = halo.exchange_params((11, 22, 33, 44), 4, plane, lo, hi, (1, 3))
    assert list(p.part)[:4] == [11, 22, 33, 44] and p.n_shards == 4
    assert p.planes == 6 and p.unit_bytes == unit
    assert p.units * unit == plane
    assert (p.n_lo, p.n_hi) == (5, 5)
    assert list(p.lo)[:5] == list(lo) and list(p.hi)[:5] == list(hi)
    assert p.n_dst == 2 and list(p.dst)[:2] == [1, 3]


@pytest.mark.parametrize('scene,engine,key', [
    ('ldc_3d', 'kernel', 'lbm_step_ghost_d3q19'),
    ('int16', 'kernel', 'lbm_step_ghost_mixed_d3q19'),
    ('duct_flow_halfway', 'kernel', 'lbm_step_ghost_wall_d3q19'),
    ('elbm', 'kernel', 'lbm_step_ghost_elbm_d2q9'),
    ('ldc_3d', 'torch', None)])
def test_exchange_on_the_cpu_is_the_plain_version(scene, engine, key):
    """On CPU tensors the exchange is ``exchange_reference`` and launches
    nothing, on either engine; a shard's step counts under its own mode's
    ghost key (its unsharded key with ``ghost_`` after ``lbm_step_``)."""
    make, flags, _steps = BITWISE[scene]
    r = _run_on(engine, make(), mesh='2', max_iters=0, **flags)
    stp = r.stepper
    if key is not None:
        assert {ks.name for ks in stp.kernels} == {key}
    parts = [p.clone() for p in r.state.parts]
    halo.reset_launch_counts()
    with mock.patch.object(halo.ShardedStep, 'exchange_reference') as ref:
        stp.exchange(parts)
    ref.assert_called_once_with(parts)
    assert sum(halo.LAUNCHES.values()) == 0 and stp.exchanges == 1


def test_the_runner_takes_a_sharded_state():
    """``runner.f`` takes a global state or, on a mesh, a ``Sharded`` one;
    ``state`` is what the engine steps."""
    make, flags, _steps = BITWISE['ldc_3d']
    r = _run_on('torch', make(), mesh='4', max_iters=0, **flags)
    f = torch.rand(r.f.shape, generator=torch.Generator().manual_seed(2))
    r.f = r.stepper.shard(f)
    assert isinstance(r.state, halo.Sharded)
    assert torch.equal(r.f, f)
    r.f = 2 * f
    assert torch.equal(r.stepper.gather(r.state), 2 * f)


# -- bit for bit against the unsharded run -----------------------------------

def _state(r):
    return r.f.clone()


#: scene -> (sim class factory, flags, steps)
BITWISE = {
    'ldc_2d': (lambda: twin('ldc_2d'), dict(lat_nx=32, lat_ny=32), 120),
    'ldc_3d': (lambda: twin('ldc_3d'),
               dict(lat_nx=16, lat_ny=16, lat_nz=16), 20),
    'mrt': (lambda: twin('ldc_3d'),
            dict(lat_nx=16, lat_ny=16, lat_nz=16, model='mrt', visc=0.05),
            20),
    'les_guo_sphere': (lambda: twin('sphere_3d'),
                       dict(lat_nx=32, lat_ny=16, lat_nz=16,
                            subgrid='les-smagorinsky', visc=0.05), 20),
    'elbm': (lambda: twin('ldc_2d_entropic'), dict(lat_nx=32, lat_ny=32),
             20),
    'int16': (lambda: twin('ldc_3d'),
              dict(lat_nx=16, lat_ny=16, lat_nz=16, precision='mixed'), 20),
    'duct_flow_halfway': (lambda: twin('duct_flow'),
                          dict(lat_nx=16, lat_ny=16, lat_nz=8), 20),
    'womersley_dynamic': (lambda: twin('womersley'),
                          dict(lat_nx=32, lat_ny=12, lat_nz=12), 20),
    'poiseuille_sa_varying': (lambda: twin('poiseuille_sa'),
                              dict(lat_nx=48, lat_ny=32,
                                   velocity='spatial_array'), 20),
    'kida_d3q15_hook': (lambda: turbulence_twin('kida_vortex'),
                        dict(lat_nx=16, lat_ny=16, lat_nz=16, visc=0.01,
                             stats_every=5), 20),
    'channel_flow_tms_hook': (lambda: turbulence_twin('channel_flow'),
                              dict(H=8, Re_tau=60, wall='tms',
                                   stats_every=5), 20),
    'inlet_face_across_shards': (
        lambda: channel_sim('regularized', 'x', profile='parabolic'),
        dict(lat_nx=16, lat_ny=16, lat_nz=16, periodic_z=True), 20),
    'init_iters': (lambda: twin('ldc_2d'),
                   dict(lat_nx=32, lat_ny=32, init_iters=5), 20),
    'int16_hook': (lambda: twin('ldc_2d_unorm'),
                   dict(lat_nx=32, lat_ny=32, unorm_every=7,
                        precision='mixed'), 20),
}
CASES = [(scene, engine, mesh) for scene in BITWISE
         for engine in ('torch', 'kernel')
         for mesh in (('2', '4') if scene in ('ldc_2d', 'ldc_3d')
                      else ('2',))]


def _run_on(engine, sim_cls, **cfg):
    with mock.patch.object(SubdomainRunner, '_select_engine',
                           lambda self: engine):
        return run(sim_cls, platform='cpu', **cfg)


@pytest.mark.parametrize('scene,engine,mesh', CASES)
def test_sharded_run_equals_the_unsharded_run_bitwise(scene, engine, mesh):
    make, flags, steps = BITWISE[scene]
    cfg = dict(max_iters=steps, every=steps // 2, **flags)
    ref = _run_on(engine, make(), **cfg)
    r = _run_on(engine, make(), mesh=mesh, **cfg)
    assert r.engine == engine and r.stepper is not None
    assert r.mesh.size == int(mesh)
    assert (r.kernel is r.stepper) == (engine == 'kernel')
    assert r.stepper.exchanges == steps
    assert r.sim.iteration == ref.sim.iteration == steps
    assert torch.equal(_state(r), _state(ref))
    r._fields_to_host()
    ref._fields_to_host()
    for name in ('rho', 'vx', 'vy'):
        np.testing.assert_array_equal(getattr(r.sim, name),
                                      getattr(ref.sim, name))


def test_hook_series_on_a_mesh_match_the_unsharded_run():
    flags = dict(lat_nx=16, lat_ny=16, lat_nz=16, visc=0.01, stats_every=5,
                 max_iters=20, every=20)
    mine = run(turbulence_twin('kida_vortex'), platform='cpu', mesh='4',
               **flags).sim.ke_enstrophy_series()
    ref = run(turbulence_twin('kida_vortex'), platform='cpu',
              **flags).sim.ke_enstrophy_series()
    assert list(mine[:, 0]) == [5.0, 10.0, 15.0, 20.0]
    np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=0)


# -- against the JAX runner on a mesh ----------------------------------------

def _jax_runner(rel, cls_name, **cfg):
    cls = getattr(load_example(rel, f'jax_mesh_{cls_name}'), cls_name)
    jc = JaxController(cls, default_config=dict(quiet=True, platform='cpu',
                                                **cfg))
    jc.run(ignore_cmdline=True)
    return jc._runner


@pytest.mark.parametrize('scene,mesh,flags', [
    ('ldc_2d', '2', dict(lat_nx=32, lat_ny=32)),
    ('ldc_2d', '4', dict(lat_nx=32, lat_ny=32)),
    ('ldc_3d', '2', dict(lat_nx=16, lat_ny=16, lat_nz=16)),
    ('ldc_3d', '4', dict(lat_nx=16, lat_ny=16, lat_nz=16)),
    ('ldc_3d_int16', '2', dict(lat_nx=16, lat_ny=16, lat_nz=16,
                               precision='mixed')),
])
def test_sharded_run_matches_the_jax_runner_on_the_same_mesh(
        scene, mesh, flags, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, 'examples'))
    base = scene.replace('_int16', '')
    cfg = dict(max_iters=20, every=20, seed=1234, mesh=mesh, **flags)
    jr = _jax_runner(f'{base}.py', 'LDCSim', **cfg)
    assert jr.mesh is not None and jr.mesh.size == int(mesh)
    r = run(twin(base), platform='cpu', **cfg)
    assert r.stepper is not None
    jr._fields_to_host()
    r._fields_to_host()
    wet = wet_map(r.maps)
    tol = 3e-5 if 'int16' in scene else 1e-6
    for name in ('rho', 'vx', 'vy') + (('vz',) if base == 'ldc_3d' else ()):
        a, b = getattr(r.sim, name), getattr(jr.sim, name)
        assert np.max(np.abs(a[wet] - b[wet])) <= tol, name
    if 'int16' in scene:
        mx = r.builder.mixed
        q = mx.quant(r.f)
        jq = mx.quant(torch.as_tensor(np.array(jr.f)))
        assert int((q.int() - jq.int())[:, torch.as_tensor(wet)]
                   .abs().max()) <= 2


# -- checkpoints -------------------------------------------------------------

def _ldc3(tmp_path, name, **cfg):
    ctrl = LBSimulationController(twin('ldc_3d'), default_config=dict(
        platform='cpu', quiet=True, lat_nx=16, lat_ny=16, lat_nz=16,
        checkpoint_file=str(tmp_path / name), final_checkpoint=True, **cfg))
    ctrl.run(ignore_cmdline=True)
    return ctrl._runner


@pytest.mark.parametrize('first,second', [('2', ''), ('', '4')])
def test_checkpoint_restores_across_meshes(tmp_path, first, second):
    """10 steps on one layout, checkpoint, 10 more on the other ==
    20 steps unsharded, bit for bit; the checkpoint is in the global
    layout of an unsharded run."""
    _ldc3(tmp_path, 'a', max_iters=10, every=10, mesh=first)
    (cpoint,) = glob.glob(str(tmp_path / 'a') + '*.cpoint.npz')
    saved = np.load(cpoint)
    assert saved['dist0a'].shape == (19, 16, 16, 16)
    r = _ldc3(tmp_path, 'b', max_iters=20, every=20, mesh=second,
              restore_from=cpoint)
    ref = _ldc3(tmp_path, 'c', max_iters=20, every=20)
    assert r.sim.iteration == 20 and (r.stepper is None) == (not second)
    assert torch.equal(r.f, ref.f)


def test_mesh_checkpoint_continues_in_the_jax_package(tmp_path,
                                                      monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, 'examples'))
    r = _ldc3(tmp_path, 'm', max_iters=10, every=10, mesh='2')
    (cpoint,) = glob.glob(str(tmp_path / 'm') + '*.cpoint.npz')
    cfg = dict(max_iters=20, every=20, lat_nx=16, lat_ny=16, lat_nz=16)
    restored = _jax_runner('ldc_3d.py', 'LDCSim', restore_from=cpoint,
                           **cfg)
    ref = _jax_runner('ldc_3d.py', 'LDCSim', **cfg)
    assert restored.sim.iteration == 20
    wet = wet_map(r.maps)
    f, f_ref = np.asarray(restored.f), np.asarray(ref.f)
    assert np.max(np.abs(f[:, wet] - f_ref[:, wet])) <= 1e-6


# -- refusals ----------------------------------------------------------------

REFUSALS = {
    # meshes of two axes run (tests/test_torch_mesh_2axis.py), and so do
    # the outflow family and force objects (tests/test_torch_mesh_outflow.
    # py); the four cases that refused them keep their ids and hold what a
    # two-axis or x mesh still refuses: an outflow row whose samples reach
    # past a shard's interior along the inner axis of ('z','y') and along x
    # of ('y','x'), a mixture on three axes, Shan-Chen with a BC row on a
    # mesh over x (the JAX package's line)
    'two_axis': (lambda: outflow_channel('NTNeumann', 3, 'y'),
                 dict(lat_nx=16, lat_ny=16, lat_nz=16, mesh='2x8'),
                 r'NTNeumann \(orientation \d\) samples 2 plane\(s\).*'
                 r'2-plane shard along y'),
    'x_2d': (lambda: outflow_channel('NTGuoDensity', 2, 'x'),
             dict(lat_nx=32, lat_ny=16, mesh='1x16'),
             r'NTGuoDensity \(orientation \d\) samples 2 plane\(s\).*'
             r'2-plane shard along x'),
    'mixture_two_axis': (lambda: binary_twin('sc_separation_3d'),
                         dict(lat_nx=8, lat_ny=8, lat_nz=8, mesh='2x1x2'),
                         '3-axis meshes'),
    'free_energy_x_2d': (
        lambda: binary_twin('sc_capillary_wave_2d'),
        dict(lat_nx=16, lat_ny=18, mesh='1x2'),
        'Shan-Chen with complex-BC blocks needs global psi sampling.*'
        ':853-858 on a mesh over x'),
    'three_axis': (lambda: twin('ldc_3d'),
                   dict(lat_nx=8, lat_ny=8, lat_nz=8, mesh='1x1x2'),
                   '3-axis meshes'),
    'shan_chen_mixture_bc_row': (
        lambda: binary_twin('sc_capillary_wave_2d'),
        dict(lat_nx=16, lat_ny=18, mesh='2'),
        'Shan-Chen with complex-BC blocks needs global psi sampling'),
    # the outflow family and force objects run on a mesh; what of it is
    # still refused: the extended copy, and a face whose samples reach
    # past a thin shard
    'extended_copy': (lambda: outflow_channel('NTExtendedCopy', 2, 'x'),
                      dict(lat_nx=32, lat_ny=16, mesh='2'),
                      r'NTExtendedCopy rows.*sailfish_tpu/runner.py:346-349'),
    'outflow_thin_shards': (
        lambda: outflow_channel('NTYuOutflow', 2, 'y'),
        dict(lat_nx=16, lat_ny=16, mesh='16'),
        r'NTYuOutflow \(orientation \d\) samples 1 plane\(s\).*'
        r'1-plane shard along y'),
    'composite_step': (lambda: turbulence_twin('channel_cube'),
                       dict(H=6, Re_tau=60, buf_az=3, main_az=5, ay=2.5,
                            mesh='2'),
                       'a composite step'),
    'cluster': (lambda: twin('ldc_2d'),
                dict(lat_nx=8, lat_ny=8, mesh='2', cluster=True),
                '--cluster'),
}


@pytest.mark.parametrize('case', sorted(REFUSALS))
def test_refused_on_a_mesh_by_name(case):
    make, cfg, match = REFUSALS[case]
    ctrl = LBSimulationController(make(), default_config=dict(
        platform='cpu', max_iters=2, quiet=True, **cfg))
    with pytest.raises(NotImplementedError, match=match):
        ctrl.run(ignore_cmdline=True)


def test_an_indivisible_domain_is_refused():
    ctrl = LBSimulationController(twin('ldc_2d'), default_config=dict(
        platform='cpu', max_iters=2, quiet=True, lat_nx=8, lat_ny=10,
        mesh='4'))
    with pytest.raises(ValueError, match='not divisible'):
        ctrl.run(ignore_cmdline=True)


def test_a_mesh_on_cuda_needs_its_devices():
    """Without enough visible GPUs a mesh raises, naming the count, and
    never falls back to fewer shards or to the CPU."""
    with mock.patch.object(torch.cuda, 'device_count', lambda: 1):
        with pytest.raises(ValueError, match='needs 2 devices; only 1'):
            pmesh.make_mesh((2,), 3)
