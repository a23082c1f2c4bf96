"""The kernel engine's Python side: node classification, BC table,
eligibility, parameter block, and ``step_reference`` (the plain PyTorch
version of the CUDA kernel).

``step_reference`` is held against the JAX Pallas engine run the way the
JAX tests run it on the CPU (``engine='pallas'``, interpret mode): LDC 3D
16^3 and LDC 2D 32^2 for 8 steps, whose lids land on the in-kernel
native-BC (``kbc``) mode. Tolerance: wet-node max |df| <= 1e-5
(tests/test_sharded_pallas.py:31). The CUDA kernel itself runs only on a
card (tests/test_torch_cuda.py).
"""

import ctypes

import numpy as np
import pytest
import torch

from sailfish_tpu import lattice
from sailfish_tpu import node_type as nt
from sailfish_tpu.controller import \
    LBSimulationController as JaxController
from sailfish_tpu.subdomain import Subdomain2D
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.ops import bc_patch as bp
from sailfish_tpu_torch.ops import lbm_step as ls
from sailfish_tpu_torch.state import state_to_numpy
from torch_scenes import (BC_PAIRS, channel_sim, cpu_runner, load_example,
                          random_feq, twin, with_keep_block)

torch.set_num_threads(1)

LDC = {
    'ldc_3d': dict(lat_nx=16, lat_ny=16, lat_nz=16),
    'ldc_2d': dict(lat_nx=32, lat_ny=32),
}


@pytest.mark.parametrize('scene', sorted(LDC))
def test_step_reference_matches_jax_pallas_engine(scene):
    cfg = LDC[scene]
    jax_sim = load_example(f'{scene}.py', f'jax_{scene}').LDCSim
    jc = JaxController(jax_sim, default_config=dict(
        max_iters=8, every=8, quiet=True, engine='pallas', platform='cpu',
        **cfg))
    jc.run(ignore_cmdline=True)
    jr = jc._runner
    assert jr.engine == 'pallas'
    # the lid runs in-kernel (kbc), the mode the CUDA kernel ports
    kbc = jr._pallas.kbc
    assert len(kbc) == 1 and kbc[0][1] == nt.NTRegularizedVelocity.id

    r = cpu_runner(twin(scene), **cfg)
    mask_np, instances, reasons = ls.classify_nodes(r.maps)
    assert reasons == []
    assert ls.kernel_ineligibility(r.builder) == []
    table = ls.bc_table(r.maps, instances)
    mask = torch.from_numpy(mask_np)
    f = r.f
    for _ in range(8):
        f = ls.step_reference(f, mask, table, r.sim.grid, r.builder.tau_inv)
    wet = (mask_np == 0) | (mask_np >= 3)
    fj = np.asarray(jr.f)
    assert np.max(np.abs(state_to_numpy(f)[:, wet] - fj[:, wet])) <= 1e-5


def test_ldc_classification_and_table():
    r = cpu_runner(twin('ldc_3d'), lat_nx=8, lat_ny=8, lat_nz=8)
    mask, instances, reasons = ls.classify_nodes(r.maps)
    assert reasons == []
    assert sorted(np.unique(mask)) == [0, 1, 3]
    tm = r.maps.type_map
    assert np.array_equal(mask == 1, tm == nt.NTFullBBWall.id)
    assert np.array_equal(mask == 3, tm == nt.NTRegularizedVelocity.id)
    table = ls.bc_table(r.maps, instances)
    # lid: inward normal -z (orientation 6), u = (0.05, 0, 0)
    assert table == [ls.BCRow(nt.NTRegularizedVelocity.id, 6, 1.0,
                              (0.05, 0.0, 0.0))]
    p = ls.kernel_params(r.sim.grid, mask.shape, table, r.builder.tau_inv)
    assert (p.nx, p.ny, p.nz, p.nbc) == (8, 8, 8, 1)
    assert (p.bc[0].kind, p.bc[0].axis, p.bc[0].sign) == (4, 2, -1)
    g = lattice.D3Q19
    assert [list(p.c[i]) for i in range(g.Q)] == g.basis.tolist()
    assert list(p.opp)[:g.Q] == g.opposite.tolist()
    np.testing.assert_allclose(list(p.w)[:g.Q], g.weights, rtol=1e-7)


def test_keep_codes_and_uniformity():
    class Scene(Subdomain2D):
        def boundary_conditions(self, hx, hy):
            self.set_node(hy == 0, nt.NTFullBBWall)
            self.set_node((hy == self.gy - 1) & (hx < 4), nt._NTUnused)
            self.set_node((hy == self.gy - 1) & (hx >= 4),
                          nt.NTZouHeVelocity((hx / 100.0, 0.0)))

    class Sim(LBFluidSim):
        subdomain = Scene

    r = cpu_runner(Sim, lat_nx=8, lat_ny=8)
    mask, instances, reasons = ls.classify_nodes(r.maps)
    assert sorted(np.unique(mask)) == [0, 1, 2, 3]
    (tid, _k, sel), = instances
    assert bp.varying_params(r.maps, tid, sel) == [
        'spatially varying NTZouHeVelocity velocity']
    # the varying instance runs on the patch kernel (its row, y = 7);
    # the main kernel keeps its nodes (code 2) and has no BC table
    ks = ls.KernelStep(r.builder)
    assert ks.table == [] and ks.patch.rows.tolist() == [7]
    assert sorted(np.unique(ks.mask.numpy())) == [0, 1, 2]
    assert np.array_equal(ks.patch.mask_rows.numpy()[0], mask[7])


@pytest.mark.parametrize('cfg,match', [
    (dict(precision='double'), 'fp32 only'),
    (dict(incompressible=True), 'incompressible'),
])
def test_ineligible_configurations(cfg, match):
    r = cpu_runner(twin('ldc_2d'), lat_nx=8, lat_ny=8, **cfg)
    assert any(match in why for why in ls.kernel_ineligibility(r.builder))


def test_kernel_step_on_cpu_runs_the_plain_version():
    r = cpu_runner(twin('ldc_2d'), lat_nx=16, lat_ny=16)
    ks = ls.KernelStep(r.builder)
    step = r.builder.build()
    ref = r.f
    for _ in range(5):
        ref = step(ref)
    out = ks.run(r.f, 5)
    assert out is ks.a or out is ks.b
    assert torch.equal(out, ref)
    # a CPU tensor never launches the kernel
    assert ks.launches == 0
    assert ls.LAUNCHES[ks.name] == 0
    with pytest.raises(ValueError, match='in place'):
        ks.step_into(ks.a, ks.a)
    with pytest.raises(ValueError, match='float32'):
        ks.step_into(ks.a.double(), ks.b)


@pytest.mark.parametrize('axis', ['x', 'z'])
@pytest.mark.parametrize('pair', sorted(BC_PAIRS))
def test_step_reference_matches_torch_engine(pair, axis):
    """The per-instance BC table path of ``step_reference`` against the
    torch engine's per-node parameter fields, on velocity/density faces
    normal to x and z with a block of excluded nodes (mask codes 0-4),
    from a random equilibrium state: 10 steps, wet-node max |df| <= 1e-6.
    """
    r = cpu_runner(with_keep_block(channel_sim(pair, axis)), lat_nx=16,
                   lat_ny=12, lat_nz=12)
    mask_np, instances, reasons = ls.classify_nodes(r.maps)
    assert reasons == [] and sorted(np.unique(mask_np)) == [0, 1, 2, 3, 4]
    assert not any(bp.varying_params(r.maps, t, sel)
                   for t, _k, sel in instances)
    table = ls.bc_table(r.maps, instances)
    mask = torch.from_numpy(mask_np)
    f = ft = random_feq(r.sim.grid, mask_np.shape, seed=7, device='cpu')
    step = r.builder.build()
    for _ in range(10):
        f = ls.step_reference(f, mask, table, r.sim.grid, r.builder.tau_inv)
        ft = step(ft)
    wet = torch.from_numpy((mask_np == 0) | (mask_np >= 3))
    assert float((f - ft)[:, wet].abs().max()) <= 1e-6


def test_params_layout_matches_the_c_struct():
    # int nx, ny, nz, nbc; float tau_inv; int c[27][3]; float w[27];
    # int opp[27]; LBMBC bc[16] with LBMBC = 4 ints/floats + float[3]
    assert ctypes.sizeof(ls._Params) == 4 * (5 + 27 * 3 + 27 + 27
                                             + 16 * 7)
