"""The port's ternary Shan-Chen model on the torch engine, on the CPU.

* ``models/ternary.LBTernaryFluidShanChen`` against the JAX package's
  through both controllers on the same scene, seed and flags
  (``torch_scenes.ternary_separation``: three components with pairwise
  repulsion, the self-couplings G11, G22, G33 on, a constant Guo force on
  component 1), the JAX side on its XLA engine, the plain reference its
  tests hold the Pallas mixture kernels to (tests/test_multi_pallas.py:
  50-62): rho, phi, theta and v after 20 steps within 5e-6 on wet nodes,
  2D at 48^2 and 3D at 12x10x8 (with walls), linear and classic
  potentials. The largest difference of each run is printed (``-s``).
* The ternary twin ``examples/torch/ternary_fluid/sc_drop_2d.py`` against
  its golden (rtol 1e-5, atol 5e-7; 20 steps, seed 1234).
* Ternary checkpoints carry between the packages (``dist0a`` ...
  ``dist2a``, ``sim_state``): JAX 10 steps + port 10 steps == JAX 20
  steps, and the reverse, within 5e-6 on wet nodes.
"""

import glob

import numpy as np
import pytest
import torch

from sailfish_tpu.controller import \
    LBSimulationController as JaxController
from sailfish_tpu.models.ternary import \
    LBTernaryFluidShanChen as JaxTernary
from sailfish_tpu.subdomain import Subdomain2D as JaxSubdomain2D
from sailfish_tpu.subdomain import Subdomain3D as JaxSubdomain3D
from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.state import state_to_numpy
from torch_scenes import (MIX_ACCELS, TERNARY_GOLDEN_FLAGS, forced_mixture,
                          golden_run, ternary_separation, ternary_twin,
                          wet_map)

torch.set_num_threads(1)

SIZES = {2: dict(lat_nx=48, lat_ny=48),
         3: dict(lat_nx=12, lat_ny=10, lat_nz=8)}
#: the self-couplings of the comparison (attractive on 1 and 3)
SELF = dict(G11=-0.3, G22=0.2, G33=-0.2)
#: a constant force on component 1 only
ONE_FORCE = (None, MIX_ACCELS[1], None)


def scene(package, dim, walls):
    if package == 'jax':
        sub = JaxSubdomain3D if dim == 3 else JaxSubdomain2D
        sim = ternary_separation(dim, sub, JaxTernary, walls=walls)
    else:
        sim = ternary_separation(dim, walls=walls)
    return forced_mixture(sim, ONE_FORCE)


def run(package, sim_cls, **cfg):
    ctrl_cls = JaxController if package == 'jax' else LBSimulationController
    ctrl = ctrl_cls(sim_cls, default_config=dict(platform='cpu', quiet=True,
                                                 **cfg))
    ctrl.run(ignore_cmdline=True)
    return ctrl._runner


@pytest.mark.parametrize('potential', ['linear', 'classic'])
@pytest.mark.parametrize('dim', [2, 3])
def test_torch_engine_matches_jax_xla_engine(dim, potential):
    walls = dim == 3
    cfg = dict(max_iters=20, every=20, seed=1234, sc_potential=potential,
               **SELF, **SIZES[dim])
    jr = run('jax', scene('jax', dim, walls), engine='xla', **cfg)
    assert jr.engine == 'xla'
    r = run('port', scene('port', dim, walls), **cfg)
    assert r.engine == 'torch' and len(r.f) == 3
    forces = [c.force is not None for c in r.builder.components]
    assert forces == [False, True, False]
    jr._fields_to_host()
    r._fields_to_host()
    wet = wet_map(r.maps)
    assert walls == (not wet.all())
    names = ['rho', 'phi', 'theta', 'vx', 'vy'] + (['vz'] if dim == 3
                                                    else [])
    worst = {}
    for name in names:
        d = np.abs(getattr(r.sim, name) - getattr(jr.sim, name))[wet]
        worst[name] = float(d.max())
        assert d.max() <= 5e-6, (name, d.max())
    print(f'ternary {dim}D {potential}: largest wet |d| against the JAX '
          f'XLA engine after 20 steps: {worst}')
    # the fields are not uniform, so the comparison is not trivial
    for name in names:
        assert np.ptp(getattr(r.sim, name)[wet]) > 1e-5, name


def test_ternary_twin_matches_golden(tmp_path):
    r = golden_run(ternary_twin('sc_drop_2d'), 'ternary_fluid_sc_drop_2d',
                   tmp_path, **TERNARY_GOLDEN_FLAGS['sc_drop_2d'])
    assert len(r.f) == 3 and r.builder.potential == 'classic'
    assert r.builder.couplings[(0, 0)] == r.builder.couplings[(2, 2)] == -4.8


def _checkpoint(tmp_path, tag):
    (cpoint,) = glob.glob(str(tmp_path / tag) + '*.cpoint.npz')
    return cpoint


@pytest.mark.parametrize('first', ['jax', 'port'])
def test_ternary_checkpoint_carries_between_packages(first, tmp_path):
    """``first`` runs 10 steps and checkpoints; the other package restores
    and runs to 20 steps; the result matches ``first`` run for 20."""
    cfg = dict(seed=7, sc_potential='classic', **SELF, **SIZES[3])
    second = 'port' if first == 'jax' else 'jax'
    sim_a, sim_b = scene(first, 3, True), scene(second, 3, True)
    run(first, sim_a, max_iters=10, every=10,
        checkpoint_file=str(tmp_path / 'a'), final_checkpoint=True, **cfg)
    saved = np.load(_checkpoint(tmp_path, 'a'))
    assert {'dist0a', 'dist1a', 'dist2a', 'state', 'sim_state'} \
        <= set(saved.files)
    ref = run(first, sim_a, max_iters=20, every=20, **cfg)
    r = run(second, sim_b, max_iters=20, every=20,
            restore_from=_checkpoint(tmp_path, 'a'),
            checkpoint_file=str(tmp_path / 'b'), final_checkpoint=True,
            **cfg)
    assert r.sim.iteration == 20
    wet = wet_map(r.maps)
    back = np.load(_checkpoint(tmp_path, 'b'))
    assert back['state'][0] == 20
    for k in range(3):
        fr = np.asarray(ref.f[k].cpu() if first == 'port' else ref.f[k])
        fb = back[f'dist{k}a']
        assert fb.shape == fr.shape
        assert np.max(np.abs(fb[:, wet] - fr[:, wet])) <= 5e-6
    if second == 'port':
        for k in range(3):
            np.testing.assert_array_equal(back[f'dist{k}a'],
                                          state_to_numpy(r.f[k]))
