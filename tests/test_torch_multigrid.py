"""The port's binary Shan-Chen mixtures on the torch engine, on the CPU.

* ``ops/collide.shan_chen_force`` against the JAX function, both
  potentials, 2D and 3D (1e-6).
* The three binary separation twins through the port's controller against
  the JAX XLA engine through the JAX controller (the same scene, seed and
  flags): rho and phi after 20 steps within 5e-6 on wet nodes, the
  tolerance the JAX package holds its own pair of engines to
  (tests/test_multi_pallas.py:32-33), for both potentials.
* The same twins against the stored goldens at the golden harness's
  tolerance (rtol 1e-5, atol 5e-7; tests/examples_harness.py:149), with the
  harness's flags (:39, :49, :76), 20 steps, seed 1234.
* Binary checkpoints carry between the packages (``dist0a``, ``dist1a``,
  ``sim_state``): JAX 10 steps + port 10 steps == JAX 20 steps, and the
  reverse, within 5e-6 on wet nodes.
* What is not ported raises; the free-energy model runs (its own tests
  are tests/test_torch_free_energy.py and tests/test_torch_fe_step.py).
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu import lattice
from sailfish_tpu.controller import \
    LBSimulationController as JaxController
from sailfish_tpu.ops import collide as jco
from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.models.binary import LBBinaryFluidFreeEnergy
from sailfish_tpu_torch.ops import collide as tco
from sailfish_tpu_torch.ops import multigrid as mg
from sailfish_tpu_torch.state import state_to_numpy
from sailfish_tpu_torch.subdomain import Subdomain2D
from torch_scenes import (BINARY_SCENES, REPO, binary_twin, load_example,
                          wet_map)

torch.set_num_threads(1)

#: the golden harness's flags for the three scenes
GOLDEN_FLAGS = {
    'sc_separation_2d': dict(lat_nx=32, lat_ny=32),
    'sc_separation_3d': dict(lat_nx=16, lat_ny=16, lat_nz=16),
    'sc_separation_3d_walls': dict(lat_nx=24, lat_ny=24, lat_nz=24),
}


def jax_sim(scene):
    mod = load_example(f'binary_fluid/{scene}.py', f'jax_{scene}')
    return getattr(mod, BINARY_SCENES[scene])


def run_port(sim_cls, **cfg):
    ctrl = LBSimulationController(sim_cls, default_config=dict(
        platform='cpu', quiet=True, **cfg))
    ctrl.run(ignore_cmdline=True)
    return ctrl._runner


def run_jax(sim_cls, **cfg):
    ctrl = JaxController(sim_cls, default_config=dict(
        platform='cpu', quiet=True, **cfg))
    ctrl.run(ignore_cmdline=True)
    return ctrl._runner


@pytest.mark.parametrize('potential', ['linear', 'classic'])
@pytest.mark.parametrize('dim', [2, 3])
def test_shan_chen_force_matches_jax(dim, potential):
    grid = lattice.D2Q9 if dim == 2 else lattice.D3Q19
    shape = (12, 10) if dim == 2 else (6, 8, 10)
    rng = np.random.default_rng(dim)
    ra = (1.0 + 0.3 * rng.random(shape)).astype(np.float32)
    rb = (0.5 + 0.3 * rng.random(shape)).astype(np.float32)
    fj = np.asarray(jco.shan_chen_force(grid, jnp.asarray(ra),
                                        jnp.asarray(rb), 1.2, potential))
    ft = tco.shan_chen_force(grid, torch.from_numpy(ra),
                             torch.from_numpy(rb), 1.2, potential).numpy()
    assert ft.shape == (dim,) + shape
    assert np.max(np.abs(ft - fj)) <= 1e-6


@pytest.mark.parametrize('potential', ['linear', 'classic'])
@pytest.mark.parametrize('scene', sorted(BINARY_SCENES))
def test_torch_engine_matches_jax_xla_engine(scene, potential):
    cfg = dict(max_iters=20, every=20, seed=1234, sc_potential=potential,
               **GOLDEN_FLAGS[scene])
    jr = run_jax(jax_sim(scene), engine='xla', **cfg)
    assert jr.engine == 'xla'
    r = run_port(binary_twin(scene), **cfg)
    assert r.engine == 'torch' and len(r.f) == 2
    jr._fields_to_host()
    r._fields_to_host()
    wet = wet_map(r.maps)
    assert ('walls' in scene) == (not wet.all())
    for name in ('rho', 'phi', 'vx', 'vy'):
        d = np.abs(getattr(r.sim, name) - getattr(jr.sim, name))[wet]
        assert d.max() <= 5e-6, (name, d.max())
    # the fields are not uniform, so the comparison is not trivial
    assert np.ptp(r.sim.rho[wet]) > 1e-5 and np.ptp(r.sim.phi[wet]) > 1e-5


@pytest.mark.parametrize('scene', sorted(BINARY_SCENES))
def test_matches_golden(scene, tmp_path):
    out = str(tmp_path / scene)
    r = run_port(binary_twin(scene), max_iters=20, every=20, seed=1234,
                 output=out, **GOLDEN_FLAGS[scene])
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
def test_binary_checkpoint_carries_between_packages(first, tmp_path):
    """``first`` runs 10 steps and checkpoints; the other package restores
    and runs to 20 steps; the result matches ``first`` run for 20."""
    scene = 'sc_separation_3d_walls'
    cfg = dict(seed=7, lat_nx=12, lat_ny=10, lat_nz=8)
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


def test_single_fluid_checkpoint_does_not_restore_into_a_mixture(tmp_path):
    from torch_scenes import twin
    run_port(twin('ldc_2d'), max_iters=2, every=2, lat_nx=8, lat_ny=8,
             checkpoint_file=str(tmp_path / 's'), final_checkpoint=True)
    with pytest.raises(ValueError, match='1 distribution arrays'):
        run_port(binary_twin('sc_separation_2d'), max_iters=4, every=4,
                 lat_nx=8, lat_ny=8,
                 restore_from=_checkpoint(tmp_path, 's'))


class _Empty(Subdomain2D):
    def boundary_conditions(self, hx, hy):
        pass

    def initial_conditions(self, sim, hx, hy):
        sim.rho[:] = 1.0
        sim.phi[:] = 0.0


def test_free_energy_model_runs():
    class Sim(LBBinaryFluidFreeEnergy):
        subdomain = _Empty

    r = run_port(Sim, max_iters=2, lat_nx=8, lat_ny=8)
    assert r.sim.iteration == 2 and r.engine == 'torch'
    assert isinstance(r.builder, mg.FreeEnergyStepBuilder)
    assert r.builder.components[0].tau == 1.0   # (tau_a + tau_b) / 2
    assert all(bool(torch.isfinite(f).all()) for f in r.f)
    lap, grad = mg.laplacian_and_grad(torch.zeros(4, 4), 2)
    assert lap.shape == (4, 4) and grad.shape == (2, 4, 4)


def test_unported_forcing_raises():
    sim = binary_twin('sc_separation_2d')

    class Forced(sim):
        def __init__(self, config):
            super().__init__(config)
            self.add_body_force((0.0, -1e-5), grid=1)

    # a constant force on one component runs on the torch engine and is
    # the mixture kernel's forcing mode; a per-node force runs on the torch
    # engine only, and the kernel refuses it by name; a time-dependent
    # force is refused by both
    r = run_port(Forced, max_iters=2, lat_nx=8, lat_ny=8)
    assert r.engine == 'torch' and r.builder.components[0].force is None
    assert r.builder.components[1].force.flatten().tolist() \
        == pytest.approx([0.0, -1e-5])
    from sailfish_tpu_torch.ops import sc_multi
    assert sc_multi.kernel_ineligibility(r.builder) == []
    assert sc_multi.SCMultiStep(r.builder).name == 'sc_multi_force_d2q9'

    class PerNode(sim):
        def __init__(self, config):
            super().__init__(config)
            self.add_body_force(np.full((2, 8, 8), 1e-5), grid=1)

    r = run_port(PerNode, max_iters=2, lat_nx=8, lat_ny=8)
    assert r.engine == 'torch'
    with pytest.raises(NotImplementedError,
                       match='space-varying body force on component 1'):
        sc_multi.SCMultiStep(r.builder)

    class Ramped(sim):
        def __init__(self, config):
            super().__init__(config)
            self.add_body_force((0.0, lambda t: -1e-7 * t), grid=1)

    with pytest.raises(NotImplementedError,
                       match='DynamicValue body forces'):
        run_port(Ramped, max_iters=2, lat_nx=8, lat_ny=8)
    with pytest.raises(NotImplementedError, match='Guo body forcing only'):
        run_port(sim, max_iters=2, lat_nx=8, lat_ny=8,
                 force_implementation='edm')
