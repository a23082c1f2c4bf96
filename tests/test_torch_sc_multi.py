"""The Shan-Chen kernel engine's Python side: eligibility, parameter
block, buffers, and the kernels' plain PyTorch versions.

* ``rho_reference`` against the JAX density pre-pass kernels run the way
  the JAX tests run them on the CPU (interpret mode): B6
  ``make_rho_kernel_2d`` on the (Q, Y, X) state, B5 ``make_rho_kernel_3d``
  on the cz-permuted layout with the wrap planes, as
  ``PallasStepSCMulti3D.pad_state`` calls it (1e-6).
* ``sc_multi_reference`` against the torch multigrid step, one step from a
  random two-component state, with and without walls and with a block of
  excluded nodes, for both potentials (1e-6); and so for three components
  and for constant Guo forces on every component, at K = 2 and 3, in 2D
  and 3D (``MODE_CASES``).
* ``SCMultiStep`` on CPU tensors runs the plain versions and launches
  nothing; each mode has its launch name; its refusals name their reasons
  (K = 4, a per-node or DynamicValue force, half-way walls, native BCs).

The CUDA kernels themselves run only on a card (tests/test_torch_cuda.py).
"""

import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu import lattice
from sailfish_tpu.ops.pallas_step import cz_groups, make_rho_kernel_3d
from sailfish_tpu.ops.pallas_step2d import make_rho_kernel_2d
from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch.ops import sc_multi as sm
from sailfish_tpu_torch.ops import lbm_step as ls
from torch_scenes import (BINARY_SCENES, MIX_ACCELS, binary_twin,
                          cpu_runner, forced_mixture, random_binary_state,
                          random_feq, ternary_separation, ternary_twin, twin,
                          with_keep_block)

torch.set_num_threads(1)

SMALL = {
    'sc_separation_2d': dict(lat_nx=20, lat_ny=16),
    'sc_separation_3d': dict(lat_nx=12, lat_ny=10, lat_nz=8),
    'sc_separation_3d_walls': dict(lat_nx=12, lat_ny=10, lat_nz=8),
}


@pytest.mark.parametrize('dim', [2, 3])
def test_rho_reference_matches_jax_rho_kernel(dim):
    grid = lattice.D2Q9 if dim == 2 else lattice.D3Q19
    shape = (16, 24) if dim == 2 else (4, 8, 16)
    f = random_feq(grid, shape, seed=11, device='cpu')
    jb = types.SimpleNamespace(grid=grid, dtype=jnp.float32)
    fj = jnp.asarray(f.numpy())
    if dim == 2:
        rho_j = make_rho_kernel_2d(jb, *shape, by=8, interpret=True)(fj)
    else:
        perm = np.asarray(cz_groups(grid)[0])
        fp = fj[perm]
        rho_j = make_rho_kernel_3d(jb, *shape, interpret=True)(
            fp, fp[:, -1], fp[:, 0])
    rho_t = sm.rho_reference(f, grid)
    assert rho_t.shape == shape
    assert np.max(np.abs(rho_t.numpy() - np.asarray(rho_j))) <= 1e-6


@pytest.mark.parametrize('potential', ['linear', 'classic'])
@pytest.mark.parametrize('scene', sorted(BINARY_SCENES))
def test_sc_multi_reference_matches_torch_multigrid_step(scene, potential):
    r = cpu_runner(with_keep_block(binary_twin(scene)),
                   sc_potential=potential, G11=-0.3, G22=0.2,
                   **SMALL[scene])
    b = r.builder
    mask_np = ls.classify_nodes(r.maps)[0]
    assert sorted(np.unique(mask_np)) == (
        [0, 1, 2] if 'walls' in scene else [0, 2])
    mask = torch.from_numpy(mask_np)
    grid = r.sim.grid
    f = random_binary_state(grid, mask_np.shape, seed=3, device='cpu',
                            u_rms=0.02)
    rhos = [sm.rho_reference(fk, grid) for fk in f]
    ref = sm.sc_multi_reference(tuple(f), rhos, mask, grid, b.taus,
                                b.couplings, b.potential)
    out = b.build()(tuple(f))
    for fr, ft in zip(ref, out):
        assert fr.shape == ft.shape
        assert float((fr - ft).abs().max()) <= 1e-6


#: the step kernel's other modes: case -> (scene, flags, launch name). Each
#: has a block of excluded nodes; the walled ones full bounce-back walls
#: too; the self-couplings are on and the forces (``MIX_ACCELS``, every
#: component) act with the pseudopotential forces
MODE_CASES = {
    'k2_forced_2d': (lambda: forced_mixture(binary_twin('sc_separation_2d')),
                     dict(SMALL['sc_separation_2d'], G11=-0.3),
                     'sc_multi_force_d2q9'),
    'k2_forced_3d_walls': (
        lambda: forced_mixture(binary_twin('sc_separation_3d_walls')),
        dict(SMALL['sc_separation_3d_walls'], G22=0.2,
             sc_potential='classic'), 'sc_multi_force_d3q19'),
    'k3_2d': (lambda: ternary_twin('sc_drop_2d'), dict(lat_nx=24, lat_ny=20),
              'sc_multi_k3_d2q9'),
    'k3_3d_walls': (lambda: ternary_separation(3, walls=True),
                    dict(SMALL['sc_separation_3d'], G11=-0.3, G33=0.2),
                    'sc_multi_k3_d3q19'),
    'k3_forced_2d_walls': (
        lambda: forced_mixture(ternary_separation(2, walls=True)),
        dict(SMALL['sc_separation_2d'], G22=-0.3, sc_potential='classic'),
        'sc_multi_k3_force_d2q9'),
    'k3_forced_3d': (lambda: forced_mixture(ternary_separation(3)),
                     dict(SMALL['sc_separation_3d'], G11=-0.3, G33=0.2),
                     'sc_multi_k3_force_d3q19'),
}


@pytest.mark.parametrize('case', sorted(MODE_CASES))
def test_sc_multi_reference_matches_torch_multigrid_step_in_every_mode(case):
    make_sim, cfg, name = MODE_CASES[case]
    r = cpu_runner(with_keep_block(make_sim()), **cfg)
    b = r.builder
    ks = sm.SCMultiStep(b)
    assert ks.name == name
    K = ks.K
    assert K == (3 if 'k3' in case else 2)
    assert [a is not None for a in ks.accels] == [('forced' in case)] * K
    codes = sorted(np.unique(ks.mask.numpy()))
    assert codes == ([0, 1, 2] if 'walls' in case else [0, 2])
    grid = r.sim.grid
    f = tuple(random_binary_state(grid, ks.shape, seed=3, device='cpu',
                                  u_rms=0.02, K=K))
    rhos = [sm.rho_reference(fk, grid) for fk in f]
    ref = ks.reference(f, rhos)
    out = b.build()(f)
    for fr, ft in zip(ref, out):
        assert fr.shape == ft.shape
        assert float((fr - ft).abs().max()) <= 1e-6
    if 'forced' in case:
        # the forces act: the same step without them differs
        bare = sm.sc_multi_reference(f, rhos, ks.mask, grid, ks.taus,
                                     ks.couplings, ks.potential)
        assert max(float((x - y).abs().max())
                   for x, y in zip(ref, bare)) > 1e-5


def test_kernel_engine_on_cpu_runs_the_plain_versions():
    r = cpu_runner(binary_twin('sc_separation_3d_walls'), **SMALL[
        'sc_separation_3d_walls'])
    ks = sm.SCMultiStep(r.builder)
    assert (ks.rho_name, ks.name) == ('rho_poststream_d3q19',
                                      'sc_multi_d3q19')
    step = r.builder.build()
    ref = r.f
    for _ in range(5):
        ref = step(ref)
    out = ks.run(r.f, 3)
    assert out[0].data_ptr() == ks.b[0].data_ptr()
    out = ks.run(out, 2)   # continues in the buffers, no copy: B -> A -> B
    assert out[1].data_ptr() == ks.b[1].data_ptr()
    for fo, fr in zip(out, ref):
        assert torch.equal(fo, fr)
    # a CPU tensor never launches a kernel
    assert ks.launches == {ks.rho_name: 0, ks.name: 0}
    assert set(sm.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError, match='in place'):
        ks.collide_into(ks.a, ks.rho, ks.a)
    with pytest.raises(ValueError, match='float32'):
        ks.step_into(ks.a.double(), ks.b)
    with pytest.raises(ValueError, match='1 components, expected 2'):
        ks.run(out[:1], 1)


def test_engine_auto_is_torch_on_cpu_and_kernel_raises():
    r = cpu_runner(binary_twin('sc_separation_2d'), lat_nx=8, lat_ny=8)
    assert r.engine == 'torch' and r.kernel is None
    with pytest.raises(RuntimeError, match='needs a CUDA device'):
        cpu_runner(binary_twin('sc_separation_2d'), engine='kernel',
                   lat_nx=8, lat_ny=8)


def test_refuses_native_bc_instances():
    base = binary_twin('sc_separation_2d')

    class Inlet(base.subdomain):
        def boundary_conditions(self, hx, hy):
            self.set_node(hy == 0, nt.NTFullBBWall)
            self.set_node(hy == self.gy - 1,
                          nt.NTEquilibriumVelocity((0.01, 0.0)))

    class Sim(base):
        subdomain = Inlet

    r = cpu_runner(Sim, lat_nx=8, lat_ny=8)
    reasons = sm.kernel_ineligibility(r.builder)
    assert reasons and 'NTEquilibriumVelocity' in reasons[0]
    with pytest.raises(NotImplementedError, match='NTEquilibriumVelocity'):
        sm.SCMultiStep(r.builder)


def test_refusal_reasons():
    r = cpu_runner(binary_twin('sc_separation_2d'), lat_nx=8, lat_ny=8)
    b = r.builder
    assert sm.kernel_ineligibility(b) == []
    # a constant force on a component is the forcing mode
    b.body_forces = [None, np.array([0.0, -1e-5])]
    assert sm.kernel_ineligibility(b) == []
    b.body_forces = [None, np.full((2, 8, 8), 1e-5)]
    b.couplings[(1, 0)] = 0.5
    reasons = sm.kernel_ineligibility(b)
    assert any('space-varying body force on component 1' in why
               for why in reasons)
    assert any('coupling key (1, 0)' in why for why in reasons)
    b.body_forces = [nt.DynamicValue(lambda t: 1e-7 * t, 0.0), None]
    assert any('DynamicValue body force on component 0' in why
               for why in sm.kernel_ineligibility(b))
    r = cpu_runner(binary_twin('sc_separation_2d'), lat_nx=8, lat_ny=8,
                   precision='double')
    assert any('fp32 only' in why
               for why in sm.kernel_ineligibility(r.builder))
    single = cpu_runner(twin('ldc_2d'), lat_nx=8, lat_ny=8)
    assert 'Shan-Chen mixtures' in sm.kernel_ineligibility(
        single.builder)[0]


def test_ternary_and_forced_mixtures_are_eligible():
    """K = 3 and constant forces on any component are accepted; K = 4 is
    refused by name (the C block would take it, the step kernel has no
    instantiation)."""
    r = cpu_runner(forced_mixture(ternary_twin('sc_drop_2d'),
                                  (None, MIX_ACCELS[1], MIX_ACCELS[2])),
                   lat_nx=16, lat_ny=16)
    b = r.builder
    assert len(b.taus) == 3 and sm.kernel_ineligibility(b) == []
    ks = sm.SCMultiStep(b)
    assert (ks.rho_name, ks.name) == ('rho_poststream_d2q9',
                                      'sc_multi_k3_force_d2q9')
    assert ks.launches == {ks.rho_name: 0, ks.name: 0}
    assert list(ks.params.force[0]) == [0.0, 0.0, 0.0]
    np.testing.assert_allclose(list(ks.params.force[2])[:2],
                               MIX_ACCELS[2][:2], rtol=1e-7)
    b.taus.append(1.0)
    assert any('4 components (the step kernel is built for K = 2, 3)'
               in why for why in sm.kernel_ineligibility(b))


def test_refuses_half_way_walls_in_a_mixture():
    """The JAX mixture kernels take no half-way walls (their XLA engine
    runs them); the port's kernel refuses them by name and the torch
    engine runs them."""
    r = cpu_runner(binary_twin('sc_poiseuille_2d'), lat_nx=18, lat_ny=8)
    reasons = sm.kernel_ineligibility(r.builder)
    assert any('NTHalfBBWall' in why for why in reasons), reasons
    with pytest.raises(NotImplementedError, match='NTHalfBBWall'):
        sm.SCMultiStep(r.builder)


def test_step_modes_have_their_launch_names():
    assert [sm.step_mode(K, forced) for K in (2, 3)
            for forced in (False, True)] == list(sm.STEP_MODES)
    assert set(sm.LAUNCHES) == {
        f'{kind}_{g}' for kind in ('rho_poststream',) + sm.STEP_MODES
        for g in ('d2q9', 'd3q19')}


def test_kernel_params():
    grid = lattice.D3Q19
    p = sm.kernel_params(grid, (4, 6, 8), [1.0, 0.8],
                         {(0, 0): 0.0, (0, 1): 1.2, (1, 1): -0.5},
                         'classic', [None, np.array([1e-5, -2e-5, 3e-5])])
    assert (p.nx, p.ny, p.nz, p.potential) == (8, 6, 4, 1)
    assert [list(p.c[i]) for i in range(grid.Q)] == grid.basis.tolist()
    assert list(p.opp)[:grid.Q] == grid.opposite.tolist()
    np.testing.assert_allclose(list(p.w)[:grid.Q], grid.weights, rtol=1e-7)
    np.testing.assert_allclose([p.tau[0], p.tau[1], p.tau_inv[1]],
                               [1.0, 0.8, 1.25], rtol=1e-7)
    np.testing.assert_allclose([p.g[0][1], p.g[1][1], p.g[1][0]],
                               [1.2, -0.5, 0.0], rtol=1e-7)
    assert list(p.force[0]) == [0.0, 0.0, 0.0]
    np.testing.assert_allclose(list(p.force[1]), [1e-5, -2e-5, 3e-5],
                               rtol=1e-7)


def test_params_layout_matches_the_c_struct():
    # int nx, ny, nz, potential; int c[27][3]; float w[27]; int opp[27];
    # float tau[4], tau_inv[4]; float g[4][4]; float force[4][3]: every
    # member 4 bytes wide, so the block keeps 4-byte alignment
    assert ctypes.sizeof(sm._Params) == 4 * (4 + 27 * 3 + 27 + 27 + 4 + 4
                                             + 16 + 12)
    assert ctypes.alignment(sm._Params) == 4
    assert sm._Params.force.offset == ctypes.sizeof(sm._Params) - 48
