"""Sharded runs of the Shan-Chen models and the free-energy model
(``--mesh``, ``sailfish_tpu_torch/parallel/halo_multi.py`` and the
Shan-Chen part of ``parallel/halo.py``) on the CPU.

* A run over 2 and 4 shards equals the unsharded run bit for bit
  (``torch.equal`` on every component, every plane), on the torch engine
  and on the kernel engine's plain version (the runner's engine forced to
  'kernel': on CPU tensors the kernel objects run their plain versions and
  the exchanges their PyTorch copies): binary Shan-Chen in 2D and 3D, with
  walls across the shard boundaries, a forced ternary, Rayleigh-Taylor
  (walls and gravity), free-energy separation in 2D and 3D, FE-MRT, the
  wetting scenes (``fe_viscous_fingering``, ``fe_poiseuille_2d``, and
  one-node plates beside a shard boundary, which need the two ghost planes
  of phi), single-component Shan-Chen in 2D and 3D.
* The port's sharded run against the JAX runner's run with the same mesh
  on the 8 host devices of ``tests/conftest.py`` (its own engine selection
  on the CPU): wet nodes after 20 steps within the tolerance of the
  unsharded comparison of the same model (5e-6 for the mixtures and the
  free-energy model, 1e-6 for single-component Shan-Chen).
* A mixture checkpoint written on a 2-shard mesh holds K ``dist{k}a``
  arrays in the global layout, restores without a mesh bit for bit, and
  continues in the JAX package.
* The exchanges on the CPU fill the crossing directions of every
  component and the density ghost planes, and nothing else.
"""

import glob
import os
from unittest import mock

import numpy as np
import pytest
import torch

from sailfish_tpu.controller import \
    LBSimulationController as JaxController
from sailfish_tpu.models.ternary import \
    LBTernaryFluidShanChen as JaxTernary
from sailfish_tpu.subdomain import Subdomain3D as JaxSubdomain3D
from sailfish_tpu_torch import lattice
from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.parallel import halo
from sailfish_tpu_torch.parallel import mesh as pmesh
from sailfish_tpu_torch.parallel.halo_multi import ShardedMultiStep
from sailfish_tpu_torch.runner import SubdomainRunner
from torch_scenes import (BINARY_SCENES, FE_SCENES, REPO, SC_MORE_SCENES,
                          SINGLE_SCENES, binary_twin, forced_mixture,
                          load_example, run, ternary_separation, twin,
                          wet_map)

torch.set_num_threads(1)

CUBE = dict(lat_nx=16, lat_ny=16, lat_nz=16)
SQUARE = dict(lat_nx=32, lat_ny=32)


def wetting_plates():
    """``fe_separation_2d`` with a wall gradient of phi and two one-node
    plates of full bounce-back, one on each side of the boundary between
    the two shards of a 32^2 domain (y = 15 and y = 16): the wetting
    mirror of a plate node on a ghost plane reads phi two planes out."""
    base = binary_twin('fe_separation_2d')

    class Plates(base.subdomain):
        def boundary_conditions(self, hx, hy):
            self.set_node((hy == 15) & (hx > 4) & (hx < 12), nt.NTFullBBWall)
            self.set_node((hy == 16) & (hx > 18) & (hx < 26),
                          nt.NTFullBBWall)

    class Sim(base):
        subdomain = Plates

        @classmethod
        def update_defaults(cls, defaults):
            super().update_defaults(defaults)
            defaults['bc_wall_grad_phase'] = 0.01

    return Sim


#: scene -> (sim class factory, flags, ghost planes per side)
BITWISE = {
    'sc_separation_3d': (lambda: binary_twin('sc_separation_3d'), CUBE, 1),
    'sc_separation_2d': (lambda: binary_twin('sc_separation_2d'), SQUARE, 1),
    'sc_separation_3d_walls': (
        lambda: binary_twin('sc_separation_3d_walls'), CUBE, 1),
    'ternary_3d_forced': (lambda: forced_mixture(ternary_separation(3)),
                          CUBE, 1),
    'sc_rayleigh_taylor_2d': (
        lambda: binary_twin('sc_rayleigh_taylor_2d'), SQUARE, 1),
    'fe_separation_3d': (lambda: binary_twin('fe_separation_3d'), CUBE, 1),
    'fe_separation_2d': (lambda: binary_twin('fe_separation_2d'), SQUARE,
                         1),
    'fe_mrt_3d': (lambda: binary_twin('fe_separation_3d'),
                  dict(CUBE, model='mrt'), 1),
    'fe_viscous_fingering': (lambda: binary_twin('fe_viscous_fingering'),
                             dict(lat_nx=32, lat_ny=16, lat_nz=16), 2),
    'fe_poiseuille_2d': (lambda: binary_twin('fe_poiseuille_2d'),
                         dict(SQUARE, bc_wall_grad_phase=0.02), 2),
    'fe_wetting_plates': (wetting_plates, SQUARE, 2),
    'sc_phase_separation_3d': (lambda: twin('sc_phase_separation_3d'), CUBE,
                               1),
    'sc_phase_separation': (lambda: twin('sc_phase_separation'), SQUARE, 1),
}
CASES = [(scene, engine, mesh) for scene in BITWISE
         for engine in ('torch', 'kernel') for mesh in ('2', '4')]


def _run_on(engine, sim_cls, **cfg):
    with mock.patch.object(SubdomainRunner, '_select_engine',
                           lambda self: engine):
        return run(sim_cls, platform='cpu', **cfg)


def _leaves(f):
    return (f,) if torch.is_tensor(f) else tuple(f)


@pytest.mark.parametrize('scene,engine,mesh', CASES)
def test_sharded_run_equals_the_unsharded_run_bitwise(scene, engine, mesh):
    make, flags, ghost = BITWISE[scene]
    steps = 20
    cfg = dict(max_iters=steps, every=steps // 2, seed=1234, **flags)
    ref = _run_on(engine, make(), **cfg)
    r = _run_on(engine, make(), mesh=mesh, **cfg)
    stp = r.stepper
    multi = not torch.is_tensor(r.f)
    assert isinstance(stp, ShardedMultiStep) == multi
    assert r.engine == engine and stp.mesh.size == int(mesh)
    assert (r.kernel is stp) == (engine == 'kernel')
    assert stp.ghost == ghost
    assert stp.exchanges == stp.rho_exchanges == steps
    assert r.sim.iteration == ref.sim.iteration == steps
    for k, (a, b) in enumerate(zip(_leaves(r.f), _leaves(ref.f))):
        assert a.shape == b.shape
        assert torch.equal(a, b), (k, float((a - b).abs().max()))
    r._fields_to_host()
    ref._fields_to_host()
    for name in ('rho', 'vx', 'vy') + (('phi',) if multi else ()):
        np.testing.assert_array_equal(getattr(r.sim, name),
                                      getattr(ref.sim, name))


@pytest.mark.parametrize('scene', ['sc_separation_3d', 'fe_poiseuille_2d',
                                   'sc_phase_separation'])
def test_shard_kernels_count_under_their_ghost_keys(scene):
    """On the kernel engine each shard's pre-pass and step count under the
    unsharded keys with ``ghost_`` after the kernel's prefix."""
    make, flags, _ghost = BITWISE[scene]
    r = _run_on('kernel', make(), mesh='2', max_iters=0, **flags)
    names = {(ks.rho_name, ks.name) for ks in r.stepper.kernels}
    want = {
        'sc_separation_3d': ('rho_poststream_ghost_d3q19',
                             'sc_multi_ghost_d3q19'),
        'fe_poiseuille_2d': ('rho_poststream_ghost_d2q9',
                             'fe_step_ghost_d2q9'),
        'sc_phase_separation': ('rho_poststream_nk1_ghost_d2q9',
                                'lbm_step_ghost_sc_d2q9'),
    }[scene]
    assert names == {want}


def test_a_device_hook_on_a_mesh_sees_the_global_mixture():
    """``fe_capillary_wave_2d`` (half-way walls, which the free-energy
    kernel refuses, so the torch engine) with its interface-height device
    hook over 2 shards: the state and the hook's state equal the unsharded
    run's bit for bit."""
    from torch_scenes import FE_HALFWAY_GOLDEN_FLAGS
    cfg = dict(max_iters=20, every=10, seed=1234,
               **FE_HALFWAY_GOLDEN_FLAGS['fe_capillary_wave_2d'])
    ref = _run_on('torch', binary_twin('fe_capillary_wave_2d'), **cfg)
    r = _run_on('torch', binary_twin('fe_capillary_wave_2d'), mesh='2',
                **cfg)
    assert isinstance(r.stepper, ShardedMultiStep)
    assert all(torch.equal(a, b) for a, b in zip(r.f, ref.f))
    (mine,), (theirs,) = r.device_hook_state, ref.device_hook_state
    assert torch.equal(mine, theirs)


# -- against the JAX runner on a mesh ----------------------------------------

def _jax_ternary():
    return forced_mixture(ternary_separation(3, JaxSubdomain3D, JaxTernary))


#: case -> (port sim factory, JAX sim factory, flags, tolerance)
JAX_CASES = {
    'sc_separation_3d_walls': (
        lambda: binary_twin('sc_separation_3d_walls'),
        lambda: getattr(load_example(
            'binary_fluid/sc_separation_3d_walls.py', 'jaxm_sc3w'),
            BINARY_SCENES['sc_separation_3d_walls']), CUBE, 5e-6),
    'sc_rayleigh_taylor_2d': (
        lambda: binary_twin('sc_rayleigh_taylor_2d'),
        lambda: getattr(load_example(
            'binary_fluid/sc_rayleigh_taylor_2d.py', 'jaxm_rt'),
            SC_MORE_SCENES['sc_rayleigh_taylor_2d']), SQUARE, 5e-6),
    'ternary_3d_forced': (lambda: forced_mixture(ternary_separation(3)),
                          _jax_ternary, CUBE, 5e-6),
    'fe_3d_wetting': (
        lambda: binary_twin('fe_viscous_fingering'),
        lambda: getattr(load_example('binary_fluid/fe_viscous_fingering.py',
                                     'jaxm_fevf'),
                        FE_SCENES['fe_viscous_fingering']),
        dict(lat_nx=32, lat_ny=16, lat_nz=16), 5e-6),
    'fe_2d_wetting': (
        lambda: binary_twin('fe_poiseuille_2d'),
        lambda: getattr(load_example('binary_fluid/fe_poiseuille_2d.py',
                                     'jaxm_fep'),
                        FE_SCENES['fe_poiseuille_2d']),
        dict(SQUARE, bc_wall_grad_phase=0.02), 5e-6),
    'sc_single_3d': (
        lambda: twin('sc_phase_separation_3d'),
        lambda: getattr(load_example('sc_phase_separation_3d.py',
                                     'jaxm_scp3'),
                        SINGLE_SCENES['sc_phase_separation_3d']), CUBE, 1e-6),
    'sc_single_2d': (
        lambda: twin('sc_phase_separation'),
        lambda: getattr(load_example('sc_phase_separation.py', 'jaxm_scp'),
                        SINGLE_SCENES['sc_phase_separation']), SQUARE, 1e-6),
}


@pytest.mark.parametrize('case', sorted(JAX_CASES))
def test_sharded_run_matches_the_jax_runner_on_the_same_mesh(case,
                                                             monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, 'examples'))
    mine, theirs, flags, tol = JAX_CASES[case]
    cfg = dict(max_iters=20, every=20, seed=1234, mesh='2', **flags)
    jc = JaxController(theirs(), default_config=dict(
        quiet=True, platform='cpu', **cfg))
    jc.run(ignore_cmdline=True)
    jr = jc._runner
    assert jr.mesh is not None and jr.mesh.size == 2
    r = run(mine(), platform='cpu', **cfg)
    assert r.stepper is not None and r.mesh.size == 2
    jr._fields_to_host()
    r._fields_to_host()
    wet = wet_map(r.maps)
    names = ['rho', 'vx', 'vy'] + (['vz'] if r.sim.dim == 3 else [])
    if not torch.is_tensor(r.f):
        names += ['phi'] + (['theta'] if len(r.f) == 3 else [])
    for name in names:
        a, b = getattr(r.sim, name), getattr(jr.sim, name)
        assert np.max(np.abs(a[wet] - b[wet])) <= tol, name
    # the fields are not uniform, so the comparison is not trivial
    assert np.ptp(r.sim.rho[wet]) > 1e-5


# -- checkpoints -------------------------------------------------------------

def _mixture(tmp_path, name, scene, **cfg):
    ctrl = LBSimulationController(scene, default_config=dict(
        platform='cpu', quiet=True, seed=7, checkpoint_file=str(
            tmp_path / name), final_checkpoint=True, **CUBE, **cfg))
    ctrl.run(ignore_cmdline=True)
    return ctrl._runner


@pytest.mark.parametrize('scene,k', [('sc_separation_3d_walls', 2),
                                     ('ternary', 3)])
def test_mixture_checkpoint_from_a_mesh_restores_unsharded(tmp_path, scene,
                                                           k):
    """10 steps on 2 shards, checkpoint, 10 more without a mesh == 20
    steps without one, bit for bit; the checkpoint holds K components in
    the global layout."""
    sim = (lambda: forced_mixture(ternary_separation(3))) \
        if scene == 'ternary' else (lambda: binary_twin(scene))
    _mixture(tmp_path, 'a', sim(), max_iters=10, every=10, mesh='2')
    (cpoint,) = glob.glob(str(tmp_path / 'a') + '*.cpoint.npz')
    saved = np.load(cpoint)
    assert sorted(f for f in saved.files if f.startswith('dist')) == \
        [f'dist{i}a' for i in range(k)]
    for i in range(k):
        assert saved[f'dist{i}a'].shape == (19, 16, 16, 16)
    r = _mixture(tmp_path, 'b', sim(), max_iters=20, every=20,
                 restore_from=cpoint)
    ref = _mixture(tmp_path, 'c', sim(), max_iters=20, every=20)
    assert r.stepper is None and r.sim.iteration == 20
    for a, b in zip(r.f, ref.f):
        assert torch.equal(a, b)


def test_mixture_checkpoint_from_a_mesh_continues_in_the_jax_package(
        tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, 'examples'))
    scene = 'sc_separation_3d_walls'
    r = _mixture(tmp_path, 'm', binary_twin(scene), max_iters=10, every=10,
                 mesh='2')
    (cpoint,) = glob.glob(str(tmp_path / 'm') + '*.cpoint.npz')
    jax_cls = getattr(load_example(f'binary_fluid/{scene}.py', 'jaxck_sc'),
                      BINARY_SCENES[scene])

    def jax_run(**cfg):
        jc = JaxController(jax_cls, default_config=dict(
            quiet=True, platform='cpu', seed=7, max_iters=20, every=20,
            **CUBE, **cfg))
        jc.run(ignore_cmdline=True)
        return jc._runner

    restored = jax_run(restore_from=cpoint)
    ref = jax_run()
    assert restored.sim.iteration == 20
    wet = wet_map(r.maps)
    for a, b in zip(restored.f, ref.f):
        a, b = np.asarray(a), np.asarray(b)
        assert np.max(np.abs(a[:, wet] - b[:, wet])) <= 5e-6


# -- the exchanges on the CPU ------------------------------------------------

def _stepper(scene, mesh='3'):
    make, flags, _ghost = BITWISE[scene]
    flags = dict(flags)
    if 'lat_nz' in flags:
        flags['lat_nz'] = 12
    else:
        flags['lat_ny'] = 12
    return _run_on('torch', make(), mesh=mesh, max_iters=0, **flags).stepper


@pytest.mark.parametrize('scene', ['ternary_3d_forced', 'sc_separation_2d',
                                   'fe_poiseuille_2d'])
def test_exchange_fills_every_component_s_crossing_directions(scene):
    """After ``exchange_reference`` the inner ghost plane on each side of
    every component holds its ring neighbour's plane in the crossing
    directions, as ``shard`` of the global state has them; every other
    value is left as it was."""
    stp = _stepper(scene)
    g, n, length = stp.ghost, stp.mesh.size, stp.length
    grid = stp.grid
    shape = (n * length,) + tuple(stp.builders[0].maps.type_map.shape[1:])
    gen = torch.Generator().manual_seed(3)
    f = tuple(torch.rand((grid.Q,) + shape, generator=gen)
              for _ in range(stp.K))
    full = stp.shard(f).parts
    parts = [tuple(c.clone() for c in p) for p in full]
    for p in parts:
        for c in p:
            c[:, :g] = -1.0
            c[:, -g:] = -1.0
    stp.exchange_reference(parts)
    lo, hi = stp.lo, stp.hi
    for p, ref in zip(parts, full):
        for c, r in zip(p, ref):
            assert torch.equal(c[:, g:-g], r[:, g:-g])
            for plane, dirs in ((g - 1, lo), (length + g, hi)):
                for i in range(grid.Q):
                    want = r[i, plane] if i in dirs else \
                        torch.full_like(r[i, plane], -1.0)
                    assert torch.equal(c[i, plane], want), (plane, i)
            for plane in list(range(g - 1)) + list(range(length + g + 1,
                                                         length + 2 * g)):
                assert bool((c[:, plane] == -1.0).all()), plane


@pytest.mark.parametrize('scene', ['ternary_3d_forced', 'fe_poiseuille_2d',
                                   'sc_phase_separation'])
def test_density_exchange_fills_the_ghost_planes(scene):
    """The density exchange fills every ghost plane of each density (both
    of each side where the slab has two) with the global density there,
    and leaves the interior alone."""
    stp = _stepper(scene)
    g, n, length = stp.ghost, stp.mesh.size, stp.length
    shape = (n * length,) + tuple(stp.builders[0].maps.type_map.shape[1:])
    k = 1 if isinstance(stp, ShardedMultiStep) and stp.fe else \
        getattr(stp, 'K', 1)
    gen = torch.Generator().manual_seed(4)
    rho = torch.rand((k,) + shape, generator=gen)
    full = pmesh.split(rho, stp.mesh, axis=1, ghost=g)
    parts = [p.clone() for p in full]
    for p in parts:
        p[:, :g] = -1.0
        p[:, -g:] = -1.0
    if isinstance(stp, ShardedMultiStep) and not stp.fe:
        stp.density_exchange_reference(parts)
    else:
        stp.density_exchange_reference([p[0] for p in parts])
    for p, ref in zip(parts, full):
        assert torch.equal(p, ref)


def test_exchange_params_of_a_mixture_and_of_its_densities():
    """The parameter blocks of a K-component launch: the component stride
    in copy units, the ghost planes and depth; a density launch copies
    whole planes (one direction) of K components."""
    grid = lattice.get_grid('D3Q19')
    lo, hi = halo.crossing_directions(grid)
    plane, length, ghost = 8 * 6 * 4, 4, 2
    comp = grid.Q * (length + 2 * ghost) * plane
    p = halo.exchange_params((11, 22), length, plane, lo, hi, (0, 1), ghost,
                             1, 3, comp)
    assert p.planes == length + 4 and p.unit_bytes == 16
    assert (p.ghost, p.depth, p.n_comp) == (2, 1, 3)
    assert p.comp_units * 16 == comp
    r = halo.exchange_params((11, 22), length, plane, (0,), (0,), (1,),
                             ghost, ghost, 2, (length + 4) * plane)
    assert (p.n_lo, p.n_hi, r.n_lo, r.n_hi) == (5, 5, 1, 1)
    assert (r.depth, r.n_comp, r.n_dst) == (2, 2, 1)
    assert r.comp_units * 16 == (length + 4) * plane


# -- what stays refused ------------------------------------------------------

def test_a_halfway_wall_beside_a_shan_chen_coupling_is_refused():
    """Single-component Shan-Chen with a BC row (here half-way walls) is
    refused on a mesh with the JAX package's reason."""
    base = twin('sc_phase_separation')

    class Walls(base.subdomain):
        def boundary_conditions(self, hx, hy):
            self.set_node((hy == 0) | (hy == self.gy - 1), nt.NTHalfBBWall)

    class Sim(base):
        subdomain = Walls

    ctrl = LBSimulationController(Sim, default_config=dict(
        platform='cpu', max_iters=2, quiet=True, mesh='2', **SQUARE))
    with pytest.raises(NotImplementedError,
                       match='Shan-Chen with complex-BC blocks needs global '
                             'psi sampling'):
        ctrl.run(ignore_cmdline=True)
