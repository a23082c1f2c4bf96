"""The free-energy kernel engine's Python side: eligibility, parameter
block, buffers, and the kernels' plain PyTorch versions.

* ``fe_step_reference`` (given the ``rho_reference`` pre-pass) against the
  torch engine's free-energy step, one step from a seeded state with sharp
  interfaces, on the five twins with a block of excluded nodes (mask codes
  0/1/2), BGK and FE-MRT, with and without a wetting gradient (1e-6).
* ``FEStep`` on CPU tensors runs the plain versions and equals the torch
  engine step for step; it launches nothing; its refusals name their
  reasons.
* The ``ctypes`` parameter block holds what ``csrc/fe_step.cu`` reads.
* The 3D kernel's launch geometry (``tile_geometry``) on ragged shapes,
  and the check of its compile-time lattice tables (``check_tables``),
  fed the lattice's own tables and perturbed copies; the tables written
  in the CUDA source equal the lattice's.

The CUDA kernels themselves run only on a card (tests/test_torch_cuda.py).
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from sailfish_tpu import lattice
from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch.ops import fe_step as fe
from sailfish_tpu_torch.ops import lbm_step as ls
from sailfish_tpu_torch.ops import multigrid as mg
from sailfish_tpu_torch.ops import sc_multi as sm
from torch_scenes import (FE_SCENES, binary_twin, cpu_runner,
                          random_fe_state, twin, with_keep_block)

torch.set_num_threads(1)

SMALL = {
    'fe_separation_2d': dict(lat_nx=20, lat_ny=16),
    'fe_separation_3d': dict(lat_nx=12, lat_ny=10, lat_nz=8),
    'fe_poiseuille_2d': dict(lat_nx=20, lat_ny=16),
    'fe_viscous_fingering': dict(lat_nx=24, lat_ny=10, lat_nz=8),
    'binary_microchannel': dict(H=7),
}
CASES = [(scene, {}) for scene in sorted(FE_SCENES)] + [
    ('fe_separation_2d', dict(model='mrt')),
    ('fe_separation_3d', dict(model='mrt', tau_a=3.0, tau_b=0.8)),
    ('fe_poiseuille_2d', dict(bc_wall_grad_phase=0.05)),
    ('fe_viscous_fingering', dict(bc_wall_grad_phase=-0.03)),
    ('binary_microchannel', dict(bc_wall_grad_phase=0.04, model='mrt')),
]
WALLED = ('fe_poiseuille_2d', 'fe_viscous_fingering', 'binary_microchannel')


def _engine(scene, **cfg):
    r = cpu_runner(with_keep_block(binary_twin(scene)), **SMALL[scene],
                   **cfg)
    return r, fe.FEStep(r.builder)


@pytest.mark.parametrize('case', range(len(CASES)))
def test_fe_step_reference_matches_torch_engine_step(case):
    scene, cfg = CASES[case]
    r, ks = _engine(scene, **cfg)
    mask_np = ks.mask.numpy()
    assert sorted(np.unique(mask_np)) == (
        [0, 1, 2] if scene in WALLED else [0, 2])
    grid = r.sim.grid
    f = random_fe_state(grid, ks.shape, seed=3, device='cpu')
    phi = sm.rho_reference(f[1], grid)
    ref = fe.fe_step_reference(tuple(f), phi, ks.mask, ks.orient,
                               r.builder)
    out = r.builder.build()(tuple(f))
    for fr, ft in zip(ref, out):
        assert fr.shape == ft.shape
        assert float((fr - ft).abs().max()) <= 1e-6
    # the wetting mirror is in play where the scene has oriented walls
    assert (scene in WALLED) == bool((ks.orient is not None)
                                     and (ks.orient > 0).any())


@pytest.mark.parametrize('scene', ['binary_microchannel',
                                   'fe_viscous_fingering'])
def test_kernel_engine_on_cpu_runs_the_plain_versions(scene):
    r, ks = _engine(scene, bc_wall_grad_phase=0.02)
    assert (ks.rho_name, ks.name) == (
        f'rho_poststream_{ks.grid.name.lower()}',
        f'fe_step_{ks.grid.name.lower()}')
    assert ks.mrt == (scene == 'fe_viscous_fingering')
    step = r.builder.build()
    state = tuple(random_fe_state(r.sim.grid, ks.shape, seed=8,
                                  device='cpu'))
    ref = state
    for _ in range(5):
        ref = step(ref)
    out = ks.run(state, 3)
    assert out[0].data_ptr() == ks.b[0].data_ptr()
    out = ks.run(out, 2)   # continues in the buffers, no copy: B -> A -> B
    assert out[1].data_ptr() == ks.b[1].data_ptr()
    for fo, fr in zip(out, ref):
        assert torch.equal(fo, fr)
    # a CPU tensor never launches a kernel
    assert ks.launches == {ks.rho_name: 0, ks.name: 0}
    assert set(fe.LAUNCHES.values()) == {0}
    assert set(sm.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError, match='in place'):
        ks.collide_into(ks.a, ks.phi, ks.a)
    with pytest.raises(ValueError, match='float32'):
        ks.step_into(ks.a.double(), ks.b)
    with pytest.raises(ValueError, match='1 components, expected 2'):
        ks.run(out[:1], 1)


def test_engine_auto_is_torch_on_cpu_and_kernel_raises():
    r = cpu_runner(binary_twin('fe_separation_2d'), lat_nx=8, lat_ny=8)
    assert r.engine == 'torch' and r.kernel is None
    with pytest.raises(RuntimeError, match='needs a CUDA device'):
        cpu_runner(binary_twin('fe_separation_2d'), engine='kernel',
                   lat_nx=8, lat_ny=8)


def test_refuses_native_bc_instances():
    base = binary_twin('fe_poiseuille_2d')

    class Inlet(base.subdomain):
        def boundary_conditions(self, hx, hy):
            self.set_node(hy == 0, nt.NTFullBBWall)
            self.set_node(hy == self.gy - 1,
                          nt.NTEquilibriumVelocity((0.01, 0.0)))

    class Sim(base):
        subdomain = Inlet

    r = cpu_runner(Sim, lat_nx=8, lat_ny=8)
    reasons = fe.kernel_ineligibility(r.builder)
    assert reasons and 'NTEquilibriumVelocity' in reasons[0]
    with pytest.raises(NotImplementedError, match='NTEquilibriumVelocity'):
        fe.FEStep(r.builder)


def test_refusal_reasons(monkeypatch):
    r = cpu_runner(binary_twin('fe_separation_3d'), lat_nx=8, lat_ny=6,
                   lat_nz=6)
    assert fe.kernel_ineligibility(r.builder) == []
    monkeypatch.setattr(ls, 'MAX_GRID_YZ', 5)
    assert any('y and z extents above 5' in why
               for why in fe.kernel_ineligibility(r.builder))
    monkeypatch.undo()
    r = cpu_runner(binary_twin('fe_separation_2d'), lat_nx=8, lat_ny=8,
                   precision='double')
    assert any('fp32 only' in why
               for why in fe.kernel_ineligibility(r.builder))
    r = cpu_runner(binary_twin('fe_separation_3d'), lat_nx=6, lat_ny=6,
                   lat_nz=6, grid='D3Q27')
    assert r.sim.grid.name == 'D3Q27'
    assert any('lattice D3Q27' in why
               for why in fe.kernel_ineligibility(r.builder))
    single = cpu_runner(twin('ldc_2d'), lat_nx=8, lat_ny=8)
    assert 'free-energy model' in fe.kernel_ineligibility(
        single.builder)[0]
    sc = cpu_runner(binary_twin('sc_separation_2d'), lat_nx=8, lat_ny=8)
    assert 'free-energy model' in fe.kernel_ineligibility(sc.builder)[0]


def test_builder_refusals_come_first():
    """What ``MultigridStepBuilder`` refuses never reaches the kernel."""
    base = binary_twin('fe_poiseuille_2d')

    class Dynamic(base):
        def __init__(self, config):
            super().__init__(config)
            self.add_body_force((lambda t: 1e-6, 0.0))

    with pytest.raises(NotImplementedError, match='DynamicValue'):
        cpu_runner(Dynamic, lat_nx=8, lat_ny=8)
    with pytest.raises(NotImplementedError, match='Guo body forcing only'):
        cpu_runner(base, lat_nx=8, lat_ny=8, force_implementation='edm')

    class GuoDensity(base.subdomain):
        def boundary_conditions(self, hx, hy):
            super().boundary_conditions(hx, hy)
            self.set_node((hx == 0) & (hy == 3), nt.NTGuoDensity(1.0))

    class Sim(base):
        subdomain = GuoDensity

    with pytest.raises(NotImplementedError, match='NTGuoDensity'):
        cpu_runner(Sim, lat_nx=8, lat_ny=8)


def test_kernel_params():
    r = cpu_runner(binary_twin('fe_viscous_fingering'), lat_nx=12,
                   lat_ny=8, lat_nz=6, bc_wall_grad_phase=0.03)
    b = r.builder
    grid = lattice.D3Q19
    p = fe.kernel_params(b, (6, 8, 12), wetting=True)
    assert (p.nx, p.ny, p.nz, p.has_force, p.wetting) == (12, 8, 6, 1, 1)
    assert [list(p.c[i]) for i in range(grid.Q)] == grid.basis.tolist()
    assert list(p.opp)[:grid.Q] == grid.opposite.tolist()
    assert [list(v) for v in p.ov] == grid.orientation_vectors.tolist()
    np.testing.assert_allclose(list(p.w)[:grid.Q], grid.weights, rtol=1e-7)
    for name, vals in mg.fe_weights(grid).items():
        np.testing.assert_allclose(list(getattr(p, name))[:grid.Q], vals,
                                   rtol=1e-7)
    np.testing.assert_allclose(
        [p.tau_a, p.tau_b, p.inv_tau_phi, p.A, p.kappa, p.Gamma,
         p.wall_grad],
        [4.5, 0.6, 1.0, 1.41e-4, 9.18e-5, 25.0, 0.03], rtol=1e-7)
    np.testing.assert_allclose(list(p.force), [3e-5, 0.0, 0.0], rtol=1e-7)
    # density grid: bare velocity; order parameter: the force-shifted one
    np.testing.assert_allclose(list(p.off0), [-1.5e-5, 0.0, 0.0], rtol=1e-7)
    np.testing.assert_allclose(list(p.off1), [0.0, 0.0, 0.0])
    rows, shear = mg.fe_mrt_moments(grid)
    assert p.n_mom == len(rows) == 9
    assert list(p.mom_shear) == [int(k in shear) for k in rows]
    for k, kk in enumerate(rows):
        np.testing.assert_allclose(list(p.mom_row[k])[:grid.Q],
                                   grid.mrt_matrix[kk], rtol=1e-7)
        np.testing.assert_allclose([p.minv[i][k] for i in range(grid.Q)],
                                   grid.mrt_inv[:, kk], rtol=1e-6,
                                   atol=1e-12)


def test_params_layout_matches_the_c_struct():
    # int nx, ny, nz, has_force, wetting, n_mom; int c[19][3]; int
    # opp[19]; int ov[6][3]; float w, wi, wxx, wyy, wzz, wxy, wyz,
    # wxz [19]; float tau_a, tau_b, inv_tau_phi, A, kappa, Gamma,
    # wall_grad; float force[3], off0[3], off1[3]; int mom_shear[9];
    # float mom_row[9][19]; float minv[19][9]
    assert ctypes.sizeof(fe._Params) == 4 * (
        6 + 19 * 3 + 19 + 18 + 8 * 19 + 7 + 9 + 9 + 2 * 9 * 19)


@pytest.mark.parametrize('wetting', [False, True])
@pytest.mark.parametrize('shape', [(5, 13, 37), (37, 101, 320),
                                   (256, 256, 256), (1, 1, 1)])
def test_tile_geometry_covers_ragged_domains(shape, wetting):
    t = fe.tile_geometry(shape, wetting)
    nz, ny, nx = shape
    assert (t.tx, t.ty, t.kz) == fe.TILE_3D
    # the grid covers the domain and no block is wholly outside it
    assert t.grid[0] * t.tx >= nx > (t.grid[0] - 1) * t.tx
    assert t.grid[1] * t.ty >= ny > (t.grid[1] - 1) * t.ty
    assert t.grid[2] * t.kz >= nz > (t.grid[2] - 1) * t.kz
    assert t.halo == (2 if wetting else 1)
    plane = (t.tx + 2 * t.halo) * (t.ty + 2 * t.halo)
    nraw = 3 if wetting else 4
    assert t.smem_bytes >= 4 * nraw * plane
    assert t.smem_bytes < 48 * 1024
    p = t.params()
    assert (p.tx, p.ty, p.kz, tuple(p.grid), p.smem_bytes) == (
        t.tx, t.ty, t.kz, t.grid, t.smem_bytes)
    assert ctypes.sizeof(p) == 4 * 7


@pytest.mark.parametrize('tile, why', [
    ((32, 16, 4), '1 to 256 threads'),
    ((0, 8, 4), '1 to 256 threads'),
    ((32, 8, 0), 'at least one z-plane'),
    ((1, 1, 4), 'more than 4 per thread'),
])
def test_tile_geometry_refuses_what_the_kernel_does_not_take(tile, why):
    with pytest.raises(ValueError, match=why):
        fe.tile_geometry((8, 8, 8), True, tile)


def test_fe_step_3d_has_a_tile_and_2d_none():
    r3, ks3 = _engine('fe_viscous_fingering')
    assert ks3.tile == fe.tile_geometry(ks3.shape, True)
    ks3.set_tile((64, 4, 3))
    assert (ks3.tile.tx, ks3.tile.ty, ks3.tile.kz) == (64, 4, 3)
    assert ks3._tile_params.grid[2] == -(-ks3.shape[0] // 3)
    _r2, ks2 = _engine('fe_poiseuille_2d')
    assert ks2.tile is None and ks2._tile_args == ()


def test_check_tables_accepts_the_lattice():
    fe.check_tables(fe.lattice_tables(lattice.D3Q19))
    t = fe.lattice_tables(lattice.D3Q19)
    grid = lattice.D3Q19
    assert np.ctypeslib.as_array(t.c).tolist() == grid.basis.tolist()
    assert list(t.opp) == grid.opposite.tolist()
    assert np.ctypeslib.as_array(t.ov).tolist() == \
        grid.orientation_vectors.tolist()
    np.testing.assert_array_equal(np.ctypeslib.as_array(t.w),
                                  grid.weights.astype(np.float32))
    for name, vals in mg.fe_weights(grid).items():
        np.testing.assert_array_equal(np.ctypeslib.as_array(getattr(t, name)),
                                      np.float32(vals))


@pytest.mark.parametrize('field', [name for name, _ in fe._Tables._fields_])
def test_check_tables_raises_on_a_perturbed_copy(field):
    t = fe.lattice_tables(lattice.D3Q19)
    arr = np.ctypeslib.as_array(getattr(t, field)).reshape(-1)
    if arr.dtype == np.float32:
        # one ulp off in the last entry
        arr[-1] = np.nextafter(arr[-1], np.float32(np.inf))
    else:
        arr[-1] += 1
    with pytest.raises(RuntimeError, match=f'differ .* in {field}$'):
        fe.check_tables(t)


def _source_table(text, decl):
    body = re.search(re.escape(decl) + r'\s*=\s*\{(.*?)\};', text, re.S)
    return [int(v) for v in re.findall(r'-?\d+', body.group(1))]


def test_cuda_source_tables_equal_the_lattice():
    """The literal D3Q19 tables that csrc/fe_step.cu includes (struct
    D3Q19 in csrc/lattice_tables.cuh)."""
    from sailfish_tpu_torch.ops import build
    assert '#include "lattice_tables.cuh"' in \
        (build.CSRC / 'fe_step.cu').read_text()
    text = (build.CSRC / 'lattice_tables.cuh').read_text()
    grid = lattice.D3Q19
    assert _source_table(text, 'constexpr int t[19][3]') == \
        grid.basis.reshape(-1).tolist()
    assert _source_table(text, 'constexpr int t[19]') == \
        grid.opposite.tolist()
