"""The Shan-Chen kernel engine's Python side: eligibility, parameter
block, buffers, and the kernels' plain PyTorch versions.

* ``rho_reference`` against the JAX density pre-pass kernels run the way
  the JAX tests run them on the CPU (interpret mode): B6
  ``make_rho_kernel_2d`` on the (Q, Y, X) state, B5 ``make_rho_kernel_3d``
  on the cz-permuted layout with the wrap planes, as
  ``PallasStepSCMulti3D.pad_state`` calls it (1e-6).
* ``sc_multi_reference`` against the torch multigrid step, one step from a
  random two-component state, with and without walls and with a block of
  excluded nodes, for both potentials (1e-6).
* ``SCMultiStep`` on CPU tensors runs the plain versions and launches
  nothing; its refusals name their reasons.

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
from torch_scenes import (BINARY_SCENES, binary_twin, cpu_runner,
                          random_binary_state, random_feq, twin,
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
    b.body_forces = [None, np.array([0.0, -1e-5])]
    b.couplings[(1, 0)] = 0.5
    reasons = sm.kernel_ineligibility(b)
    assert any('body forces' in why for why in reasons)
    assert any('coupling key (1, 0)' in why for why in reasons)
    r = cpu_runner(binary_twin('sc_separation_2d'), lat_nx=8, lat_ny=8,
                   precision='double')
    assert any('fp32 only' in why
               for why in sm.kernel_ineligibility(r.builder))
    single = cpu_runner(twin('ldc_2d'), lat_nx=8, lat_ny=8)
    assert 'Shan-Chen mixtures' in sm.kernel_ineligibility(
        single.builder)[0]


def test_kernel_params():
    grid = lattice.D3Q19
    p = sm.kernel_params(grid, (4, 6, 8), [1.0, 0.8],
                         {(0, 0): 0.0, (0, 1): 1.2, (1, 1): -0.5},
                         'classic')
    assert (p.nx, p.ny, p.nz, p.potential) == (8, 6, 4, 1)
    assert [list(p.c[i]) for i in range(grid.Q)] == grid.basis.tolist()
    assert list(p.opp)[:grid.Q] == grid.opposite.tolist()
    np.testing.assert_allclose(list(p.w)[:grid.Q], grid.weights, rtol=1e-7)
    np.testing.assert_allclose([p.tau[0], p.tau[1], p.tau_inv[1]],
                               [1.0, 0.8, 1.25], rtol=1e-7)
    np.testing.assert_allclose([p.g[0][1], p.g[1][1], p.g[1][0]],
                               [1.2, -0.5, 0.0], rtol=1e-7)


def test_params_layout_matches_the_c_struct():
    # int nx, ny, nz, potential; int c[27][3]; float w[27]; int opp[27];
    # float tau[4], tau_inv[4]; float g[4][4]
    assert ctypes.sizeof(sm._Params) == 4 * (4 + 27 * 3 + 27 + 27 + 4 + 4
                                             + 16)
