"""The port's binary free-energy model on the torch engine, on the CPU.

* ``ops/multigrid.laplacian_and_grad`` and ``ops/collide.guo_force_terms``
  against the JAX functions on seeded numpy fields, 2D and 3D (1e-6).
* ``fe_mrt_relax`` (unrolled sums over the conserved and shear moments)
  against the dense FE-MRT projections of the JAX builder (1e-6), and the
  builder's constant equilibrium-velocity offsets against its own
  ``_eq_velocity``.
* The five free-energy twins through the port's controller against the
  JAX XLA engine through the JAX controller (the same scene, seed and
  flags; FE-MRT on the separations, a wetting gradient on the Poiseuille
  channel): rho and phi after 20 steps within 5e-6 on wet nodes, the
  tolerance the JAX package holds its own pair of engines to
  (tests/test_multi_pallas.py:32-33). The JAX Pallas FE kernels in
  interpret mode are held to that XLA engine by the JAX package itself.
* The same twins against the stored goldens (rtol 1e-5, atol 5e-7) at the
  harness's flags, 20 steps, seed 1234.
* A free-energy checkpoint (walls, body force) carries between the
  packages: JAX 10 steps + port 10 steps == JAX 20 steps, and the reverse.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu import lattice
from sailfish_tpu.ops import collide as jco
from sailfish_tpu.ops import multigrid as jmg
from sailfish_tpu_torch.ops import collide as tco
from sailfish_tpu_torch.ops import multigrid as mg
from sailfish_tpu_torch.state import state_to_numpy
from test_torch_multigrid import run_jax, run_port
from torch_scenes import (FE_GOLDEN_FLAGS, FE_SCENES, REPO, binary_twin,
                          cpu_runner, load_example, wet_map)

torch.set_num_threads(1)

#: (scene, extra flags) compared with the JAX XLA engine
XLA_CASES = [(scene, {}) for scene in sorted(FE_SCENES)] + [
    ('fe_separation_2d', dict(model='mrt')),
    ('fe_separation_3d', dict(model='mrt')),
    ('fe_poiseuille_2d', dict(bc_wall_grad_phase=0.02)),
]


def jax_sim(scene):
    mod = load_example(f'binary_fluid/{scene}.py', f'jax_{scene}')
    return getattr(mod, FE_SCENES[scene])


def _field(dim, seed, lo=-1.0, hi=1.0):
    shape = (12, 10) if dim == 2 else (6, 8, 10)
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize('dim', [2, 3])
def test_laplacian_and_grad_match_jax(dim):
    phi = _field(dim, seed=dim)
    lap_j, grad_j = jmg.laplacian_and_grad(jnp.asarray(phi), dim)
    lap_t, grad_t = mg.laplacian_and_grad(torch.from_numpy(phi), dim)
    assert lap_t.shape == phi.shape and grad_t.shape == (dim,) + phi.shape
    assert np.max(np.abs(lap_t.numpy() - np.asarray(lap_j))) <= 1e-6
    assert np.max(np.abs(grad_t.numpy() - np.asarray(grad_j))) <= 1e-6
    assert np.ptp(lap_t.numpy()) > 1.0


@pytest.mark.parametrize('tau', ['scalar', 'field'])
@pytest.mark.parametrize('dim', [2, 3])
def test_guo_force_terms_match_jax(dim, tau):
    grid = lattice.D2Q9 if dim == 2 else lattice.D3Q19
    rho = _field(dim, seed=1, lo=0.9, hi=1.1)
    u = np.stack([_field(dim, seed=2 + a, lo=-0.05, hi=0.05)
                  for a in range(dim)])
    accel = np.asarray([1e-3, -2e-3, 5e-4][:dim], np.float32).reshape(
        (dim,) + (1,) * dim)
    tau_inv = (0.8 if tau == 'scalar'
               else 1.0 / _field(dim, seed=9, lo=0.6, hi=4.5))
    fj = np.asarray(jco.guo_force_terms(
        grid, jnp.asarray(u), jnp.asarray(accel),
        tau_inv if tau == 'scalar' else jnp.asarray(tau_inv),
        jnp.asarray(rho)))
    ft = tco.guo_force_terms(
        grid, torch.from_numpy(u), torch.from_numpy(accel),
        tau_inv if tau == 'scalar' else torch.from_numpy(tau_inv),
        torch.from_numpy(rho)).numpy()
    assert ft.shape == (grid.Q,) + rho.shape
    assert np.max(np.abs(ft - fj)) <= 1e-6
    assert np.max(np.abs(ft)) > 1e-4


@pytest.mark.parametrize('dim', [2, 3])
def test_fe_mrt_relax_matches_dense_projections(dim):
    """P_cons z + (1 - 1/tau0) P_shear z from the unrolled moment sums
    equals z - P_rest z - (1/tau0) P_shear z with the JAX builder's dense
    projections (``_prepare_fe_mrt``)."""
    grid = lattice.D2Q9 if dim == 2 else lattice.D3Q19
    rng = np.random.default_rng(dim)
    shape = (5, 7) if dim == 2 else (3, 4, 5)
    z = rng.standard_normal((grid.Q,) + shape).astype(np.float32) * 1e-2
    inv_tau0 = (1.0 / rng.uniform(0.6, 4.5, shape)).astype(np.float32)
    corr = mg.fe_mrt_relax(grid, list(torch.from_numpy(z)),
                           torch.from_numpy(inv_tau0))
    got = np.stack([np.zeros(shape) if c is None else c.numpy()
                    for c in corr])
    e_shear = np.zeros(grid.Q)
    e_shear[grid.mrt_shear] = 1.0
    e_rest = np.ones(grid.Q)
    e_rest[grid.mrt_shear] = 0.0
    e_rest[grid.mrt_conserved] = 0.0
    p_shear = grid.mrt_inv @ np.diag(e_shear) @ grid.mrt_matrix
    p_rest = grid.mrt_inv @ np.diag(e_rest) @ grid.mrt_matrix
    zf = z.reshape(grid.Q, -1).astype(np.float64)
    want = (zf - p_rest @ zf - inv_tau0.reshape(-1) * (p_shear @ zf))
    assert np.max(np.abs(got.reshape(grid.Q, -1) - want)) <= 1e-6


@pytest.mark.parametrize('scene', ['fe_viscous_fingering',
                                   'binary_microchannel',
                                   'fe_poiseuille_2d', 'fe_separation_2d'])
def test_eq_velocity_offsets_match_eq_velocity(scene):
    cfg = dict(FE_GOLDEN_FLAGS[scene])
    r = cpu_runner(binary_twin(scene), **cfg)
    b = r.builder
    shape = r.maps.type_map.shape
    u = torch.from_numpy(np.random.default_rng(0).uniform(
        -0.05, 0.05, (b.grid.dim,) + shape).astype(np.float32))
    for target, off in enumerate(b.eq_velocity_offsets()):
        want = b._eq_velocity(u, target)
        got = u + torch.as_tensor(off, dtype=u.dtype).reshape(
            (b.grid.dim,) + (1,) * len(shape))
        assert float((got - want).abs().max()) <= 1e-7


@pytest.mark.parametrize('case', range(len(XLA_CASES)))
def test_torch_engine_matches_jax_xla_engine(case):
    scene, extra = XLA_CASES[case]
    cfg = dict(max_iters=20, every=20, seed=1234, **FE_GOLDEN_FLAGS[scene],
               **extra)
    jr = run_jax(jax_sim(scene), engine='xla', **cfg)
    assert jr.engine == 'xla'
    r = run_port(binary_twin(scene), **cfg)
    assert r.engine == 'torch' and len(r.f) == 2
    assert r.builder.fe_model == extra.get('model', r.config.model)
    jr._fields_to_host()
    r._fields_to_host()
    wet = wet_map(r.maps)
    assert ('separation' in scene) == wet.all()
    for name in ('rho', 'phi', 'vx', 'vy'):
        d = np.abs(getattr(r.sim, name) - getattr(jr.sim, name))[wet]
        assert d.max() <= 5e-6, (name, d.max())
    # the order parameter is not uniform, so the comparison is not trivial
    assert np.ptp(r.sim.phi[wet]) > 1e-5


@pytest.mark.parametrize('scene', sorted(FE_SCENES))
def test_matches_golden(scene, tmp_path):
    out = str(tmp_path / scene)
    r = run_port(binary_twin(scene), max_iters=20, every=20, seed=1234,
                 output=out, **FE_GOLDEN_FLAGS[scene])
    assert r.engine == 'torch'
    data = np.load(f'{out}.0.0000020.npz')
    ref = np.load(os.path.join(REPO, 'tests', 'goldens',
                               f'binary_fluid_{scene}.npz'))
    assert sorted(data.files) == sorted(ref.files)
    for k in ref.files:
        np.testing.assert_allclose(data[k], ref[k], rtol=1e-5, atol=5e-7,
                                   err_msg=f'{scene}:{k}')


def _checkpoint(tmp_path, tag):
    (cpoint,) = glob.glob(str(tmp_path / tag) + '*.cpoint.npz')
    return cpoint


@pytest.mark.parametrize('first', ['jax', 'port'])
def test_fe_checkpoint_carries_between_packages(first, tmp_path):
    """``first`` runs 10 steps and checkpoints; the other package restores
    and runs to 20 steps; the result matches ``first`` run for 20 (walls,
    wetting and a body force, so the model's parameters carry over)."""
    scene = 'fe_poiseuille_2d'
    cfg = dict(seed=7, lat_nx=16, lat_ny=12, bc_wall_grad_phase=0.02)
    runners = {'jax': (run_jax, jax_sim(scene)),
               'port': (run_port, binary_twin(scene))}
    second = 'port' if first == 'jax' else 'jax'
    run_a, sim_a = runners[first]
    run_b, sim_b = runners[second]
    run_a(sim_a, max_iters=10, every=10, checkpoint_file=str(tmp_path / 'a'),
          final_checkpoint=True, **cfg)
    saved = np.load(_checkpoint(tmp_path, 'a'))
    assert {'dist0a', 'dist1a', 'state', 'sim_state'} <= set(saved.files)
    ref = run_a(sim_a, max_iters=20, every=20, **cfg)
    r = run_b(sim_b, max_iters=20, every=20,
              restore_from=_checkpoint(tmp_path, 'a'),
              checkpoint_file=str(tmp_path / 'b'), final_checkpoint=True,
              **cfg)
    assert r.sim.iteration == 20
    wet = wet_map(r.maps)
    assert not wet.all()
    back = np.load(_checkpoint(tmp_path, 'b'))
    assert back['state'][0] == 20
    for k in range(2):
        fr = np.asarray(ref.f[k].cpu() if first == 'port' else ref.f[k])
        fb = back[f'dist{k}a']
        assert fb.shape == fr.shape
        assert np.max(np.abs(fb[:, wet] - fr[:, wet])) <= 5e-6
    if second == 'port':
        for k in range(2):
            np.testing.assert_array_equal(back[f'dist{k}a'],
                                          state_to_numpy(r.f[k]))


def test_native_bc_in_free_energy_scene_matches_jax():
    """A velocity BC face in a free-energy scene runs on the torch engine
    (through the component StepBuilders; the kernel refuses it) and
    matches the JAX XLA engine."""
    from sailfish_tpu import node_type as jnt
    from sailfish_tpu_torch import node_type as tnt

    def with_inlet(base, types):
        class Inlet(base.subdomain):
            def boundary_conditions(self, hx, hy):
                self.set_node(hy == 0, types.NTFullBBWall)
                self.set_node(hy == self.gy - 1,
                              types.NTEquilibriumVelocity((0.01, 0.0)))

        class Sim(base):
            subdomain = Inlet

        return Sim

    scene = 'fe_poiseuille_2d'
    cfg = dict(lat_nx=16, lat_ny=12, max_iters=20, every=20, seed=3)
    jr = run_jax(with_inlet(jax_sim(scene), jnt), engine='xla', **cfg)
    r = run_port(with_inlet(binary_twin(scene), tnt), **cfg)
    assert r.engine == 'torch'
    jr._fields_to_host()
    r._fields_to_host()
    wet = wet_map(r.maps)
    for name in ('rho', 'phi', 'vx', 'vy'):
        d = np.abs(getattr(r.sim, name) - getattr(jr.sim, name))[wet]
        assert d.max() <= 5e-6, (name, d.max())
    assert np.abs(r.sim.vx[-1]).max() > 5e-3    # the inlet drives the flow
