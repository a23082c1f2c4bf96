"""Sharded runs of the Shan-Chen mixtures and the free-energy model on
meshes of two axes (``--mesh=AxB``: ('z', 'y') in 3D, ('y', 'x') in 2D;
``sailfish_tpu_torch/parallel/halo_multi.py``) on the CPU.

* A run over 3D ``2x2``, ``1x2``, ``2x1``, ``1x4`` and 2D ``1x2``, ``2x2``,
  ``1x4`` meshes equals the unsharded run bit for bit on every component,
  on the torch engine and on the kernel engine's plain version: binary
  Shan-Chen and free-energy separation in 2D and 3D on every mesh; walls,
  a forced ternary, Rayleigh-Taylor, FE-MRT and the wetting scenes (two
  ghost layers) on ``2x2``; one-node wetting plates on either side of a y
  (3D) or x (2D) shard boundary, where the wetting mirror reads phi two
  rows out across the boundary.
* The density exchange of a K = 3 mixture and of the free-energy model
  with walls (two ghost layers) fills every ghost node of every density,
  the edges and corners from the diagonal shard.
* The port's sharded run against the JAX runner's run on the same mesh
  (its XLA engine on the CPU): wet nodes within 5e-6 after 20 steps.
* A mixture checkpoint written on ``2x2`` restores unsharded bit for bit.
"""

import glob
import os
from unittest import mock

import numpy as np
import pytest
import torch

from sailfish_tpu.controller import \
    LBSimulationController as JaxController
from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.parallel import halo
from sailfish_tpu_torch.parallel import mesh as pmesh
from sailfish_tpu_torch.parallel.halo_multi import ShardedMultiStep
from sailfish_tpu_torch.runner import SubdomainRunner
from torch_scenes import (BINARY_SCENES, FE_SCENES, REPO, binary_twin,
                          forced_mixture, load_example, run,
                          ternary_separation, wet_map)

torch.set_num_threads(1)

CUBE = dict(lat_nx=16, lat_ny=16, lat_nz=16)
SQUARE = dict(lat_nx=32, lat_ny=32)
#: 2D runs over four x shards: rows of at least 32 nodes per slab (on the
#: CPU a tensor's last plane-count-mod-32 nodes sum their directions in
#: another order, test_torch_mesh_2axis.py)
WIDE = dict(lat_nx=128, lat_ny=32)
MESHES_3D = ('2x2', '1x2', '2x1', '1x4')
MESHES_2D = ('1x2', '2x2', '1x4')


def plates_across_x():
    """``fe_separation_2d`` with a wall gradient of phi and two one-node
    plates of full bounce-back, one on each side of the boundary between
    the x shards of a 32-wide ``1x2`` or ``2x2`` mesh (x = 15 and x = 16):
    the wetting mirror of a plate node on a ghost column reads phi two
    columns out."""
    base = binary_twin('fe_separation_2d')

    class Plates(base.subdomain):
        def boundary_conditions(self, hx, hy):
            self.set_node((hx == 15) & (hy > 4) & (hy < 12), nt.NTFullBBWall)
            self.set_node((hx == 16) & (hy > 18) & (hy < 26),
                          nt.NTFullBBWall)

    class Sim(base):
        subdomain = Plates

        @classmethod
        def update_defaults(cls, defaults):
            super().update_defaults(defaults)
            defaults['bc_wall_grad_phase'] = 0.01

    return Sim


def plates_across_y():
    """``fe_separation_3d`` with a wall gradient of phi and two one-node
    plates of full bounce-back on either side of the boundary between the
    y shards of a 16-high ``1x2`` or ``2x2`` mesh (y = 7 and y = 8)."""
    base = binary_twin('fe_separation_3d')

    class Plates(base.subdomain):
        def boundary_conditions(self, hx, hy, hz):
            self.set_node((hy == 7) & (hx > 2) & (hx < 8) & (hz > 1)
                          & (hz < 14), nt.NTFullBBWall)
            self.set_node((hy == 8) & (hx > 9) & (hx < 14) & (hz > 3)
                          & (hz < 12), nt.NTFullBBWall)

    class Sim(base):
        subdomain = Plates

        @classmethod
        def update_defaults(cls, defaults):
            super().update_defaults(defaults)
            defaults['bc_wall_grad_phase'] = 0.01

    return Sim


#: scene -> (sim class factory, flags, ghost layers, meshes)
BITWISE = {
    'sc_separation_3d': (lambda: binary_twin('sc_separation_3d'), CUBE, 1,
                         MESHES_3D),
    'sc_separation_2d': (lambda: binary_twin('sc_separation_2d'), WIDE, 1,
                         MESHES_2D),
    'fe_separation_3d': (lambda: binary_twin('fe_separation_3d'), CUBE, 1,
                         MESHES_3D),
    'fe_separation_2d': (lambda: binary_twin('fe_separation_2d'),
                         dict(lat_nx=128, lat_ny=48), 1, MESHES_2D),
    'sc_separation_3d_walls': (
        lambda: binary_twin('sc_separation_3d_walls'), CUBE, 1,
        ('2x2', '1x4')),
    'ternary_3d_forced': (lambda: forced_mixture(ternary_separation(3)),
                          dict(lat_nx=24, lat_ny=16, lat_nz=16), 1,
                          ('2x2',)),
    'sc_rayleigh_taylor_2d': (
        lambda: binary_twin('sc_rayleigh_taylor_2d'), SQUARE, 1, ('2x2',)),
    'fe_mrt_3d': (lambda: binary_twin('fe_separation_3d'),
                  dict(CUBE, model='mrt'), 1, ('2x2',)),
    'fe_viscous_fingering': (lambda: binary_twin('fe_viscous_fingering'),
                             dict(lat_nx=32, lat_ny=16, lat_nz=16), 2,
                             ('2x2',)),
    'fe_poiseuille_2d': (lambda: binary_twin('fe_poiseuille_2d'),
                         dict(SQUARE, bc_wall_grad_phase=0.02), 2,
                         ('2x2', '1x2')),
    'fe_plates_across_x': (plates_across_x, SQUARE, 2, ('1x2', '2x2')),
    'fe_plates_across_y': (plates_across_y, CUBE, 2, ('1x2', '2x2')),
}
CASES = [(scene, engine, mesh)
         for scene, (_m, _f, _g, meshes) in BITWISE.items()
         for engine in ('torch', 'kernel') for mesh in meshes]


def _run_on(engine, sim_cls, **cfg):
    with mock.patch.object(SubdomainRunner, '_select_engine',
                           lambda self: engine):
        return run(sim_cls, platform='cpu', **cfg)


@pytest.mark.parametrize('scene,engine,mesh', CASES)
def test_two_axis_mixture_equals_the_unsharded_run_bitwise(scene, engine,
                                                           mesh):
    make, flags, ghost, _meshes = BITWISE[scene]
    steps = 20
    cfg = dict(max_iters=steps, every=steps // 2, seed=1234, **flags)
    ref = _run_on(engine, make(), **cfg)
    r = _run_on(engine, make(), mesh=mesh, **cfg)
    stp = r.stepper
    assert isinstance(stp, ShardedMultiStep) and stp.inner is not None
    assert r.engine == engine and (r.kernel is stp) == (engine == 'kernel')
    assert stp.ghost == ghost and 'edge_' in stp.rho_name
    assert stp.exchanges == stp.rho_exchanges == steps
    for k, (a, b) in enumerate(zip(r.f, ref.f)):
        assert a.shape == b.shape
        assert torch.equal(a, b), (k, float((a - b).abs().max()))
    # the output fields reduce per shard: one ulp (test_torch_mesh_2axis)
    r._fields_to_host()
    ref._fields_to_host()
    for name in ('rho', 'phi', 'vx', 'vy'):
        np.testing.assert_array_max_ulp(getattr(r.sim, name),
                                        getattr(ref.sim, name), maxulp=1)


def test_shard_kernels_count_under_their_ghost_keys_on_two_axes():
    make, flags, _g, _m = BITWISE['fe_poiseuille_2d']
    r = _run_on('kernel', make(), mesh='2x2', max_iters=0, **flags)
    stp = r.stepper
    assert {(ks.rho_name, ks.name) for ks in stp.kernels} == \
        {('rho_poststream_ghost_d2q9', 'fe_step_ghost_d2q9')}
    assert (stp.name, stp.rho_name) == ('halo_edge_exchange_d2q9',
                                        'halo_rho_edge_exchange_d2q9')
    assert [tuple(ks.shape) for ks in stp.kernels] == [(20, 20)] * 4


@pytest.mark.parametrize('scene,mesh', [('ternary_3d_forced', '2x2'),
                                        ('fe_poiseuille_2d', '2x2'),
                                        ('fe_plates_across_y', '1x2')])
def test_density_edge_exchange_fills_every_ghost_node(scene, mesh):
    make, flags, ghost, _m = BITWISE[scene]
    stp = _run_on('torch', make(), mesh=mesh, max_iters=0,
                  **flags).stepper
    counts = pmesh.counts_of(stp.mesh)
    shape = (counts[0] * stp.length, counts[1] * stp.inner[1]) + \
        tuple(stp.builders[0].maps.type_map.shape[2:])
    k = 1 if stp.fe else stp.K
    rho = torch.rand((k,) + shape, generator=torch.Generator()
                     .manual_seed(4))
    full = pmesh.split(rho, stp.mesh, axis=1, ghost=ghost)
    parts = [p.clone() for p in full]
    for p in parts:
        p[:, :ghost] = -1.0
        p[:, -ghost:] = -1.0
        p[:, :, :ghost] = -1.0
        p[:, :, -ghost:] = -1.0
    stp.density_exchange_reference([p[0] for p in parts] if stp.fe
                                   else parts)
    for p, ref in zip(parts, full):
        assert torch.equal(p, ref)


# -- against the JAX runner on a mesh ----------------------------------------

def _jax_cls(scene):
    name = BINARY_SCENES.get(scene) or FE_SCENES[scene]
    return getattr(load_example(f'binary_fluid/{scene}.py',
                                f'jaxm2_{scene}'), name)


@pytest.mark.parametrize('scene,mesh,flags', [
    ('sc_separation_3d', '2x2', CUBE),
    ('fe_separation_3d', '1x2', CUBE),
    ('sc_separation_2d', '2x2', SQUARE),
    ('fe_separation_2d', '1x2', SQUARE),
])
def test_two_axis_mixture_matches_the_jax_runner_on_the_same_mesh(
        scene, mesh, flags, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, 'examples'))
    cfg = dict(max_iters=20, every=20, seed=1234, mesh=mesh, **flags)
    jc = JaxController(_jax_cls(scene), default_config=dict(
        quiet=True, platform='cpu', **cfg))
    jc.run(ignore_cmdline=True)
    jr = jc._runner
    assert jr.mesh is not None and len(jr.mesh.axis_names) == 2
    r = run(binary_twin(scene), platform='cpu', **cfg)
    assert r.stepper is not None and r.stepper.inner is not None
    jr._fields_to_host()
    r._fields_to_host()
    wet = wet_map(r.maps)
    names = ['rho', 'phi', 'vx', 'vy'] + (['vz'] if r.sim.dim == 3 else [])
    for name in names:
        a, b = getattr(r.sim, name), getattr(jr.sim, name)
        assert np.max(np.abs(a[wet] - b[wet])) <= 5e-6, name
    assert np.ptp(r.sim.phi[wet]) > 1e-6


def test_mixture_checkpoint_from_a_two_axis_mesh_restores_unsharded(
        tmp_path):
    def go(name, **cfg):
        ctrl = LBSimulationController(
            binary_twin('sc_separation_3d_walls'), default_config=dict(
                platform='cpu', quiet=True, seed=7,
                checkpoint_file=str(tmp_path / name), final_checkpoint=True,
                **CUBE, **cfg))
        ctrl.run(ignore_cmdline=True)
        return ctrl._runner

    go('a', max_iters=10, every=10, mesh='2x2')
    (cpoint,) = glob.glob(str(tmp_path / 'a') + '*.cpoint.npz')
    saved = np.load(cpoint)
    assert [saved[f'dist{i}a'].shape for i in range(2)] == \
        [(19, 16, 16, 16)] * 2
    r = go('b', max_iters=20, every=20, restore_from=cpoint)
    ref = go('c', max_iters=20, every=20)
    assert r.stepper is None and r.sim.iteration == 20
    assert all(torch.equal(a, b) for a, b in zip(r.f, ref.f))
    assert halo.LAUNCHES['halo_rho_edge_exchange_d3q19'] == 0
