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
* The D3Q19 step kernel's launch geometry (``tile_geometry``) on ragged
  shapes for K = 2 and 3, its refusals (a domain of 2^31 nodes or more
  among them), the Python mirror of its compile-time tables against
  ``lattice``, the mangled names of both step kernels, and D2Q9 scenes on
  the one-row launch (no tile).
* The register-design variants of ``tools/sc_tile_sweep.py`` still find
  what they edit in the shipped source, and a variant written outside
  ``csrc`` keys its build on the headers of ``csrc`` too.

The CUDA kernels themselves run only on a card (tests/test_torch_cuda.py).
"""

import ctypes
import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu import lattice
from sailfish_tpu.ops.pallas_step import cz_groups, make_rho_kernel_3d
from sailfish_tpu.ops.pallas_step2d import make_rho_kernel_2d
from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch.ops import build
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
    # a launch on a shard's ghost-plane buffers counts with ghost_ after
    # the kernel's prefix
    assert set(sm.LAUNCHES) == {
        name for kind in ('rho_poststream',) + sm.STEP_MODES
        for g in ('d2q9', 'd3q19')
        for name in (f'{kind}_{g}', sm.ghost_name(f'{kind}_{g}'))}
    assert sm.ghost_name('sc_multi_k3_force_d3q19') == \
        'sc_multi_ghost_k3_force_d3q19'
    assert sm.ghost_name('rho_poststream_d2q9') == \
        'rho_poststream_ghost_d2q9'


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


@pytest.mark.parametrize('K', [2, 3])
@pytest.mark.parametrize('shape', [(5, 13, 37), (11, 23, 37), (3, 1, 1),
                                   (256, 256, 256), (1, 1, 1)])
def test_tile_geometry_covers_ragged_domains(shape, K):
    t = sm.tile_geometry(shape, K)
    nz, ny, nx = shape
    assert (t.tx, t.ty, t.kz) == sm.TILE_3D
    # the grid covers the domain and no block is wholly outside it
    assert t.grid[0] * t.tx >= nx > (t.grid[0] - 1) * t.tx
    assert t.grid[1] * t.ty >= ny > (t.grid[1] - 1) * t.ty
    assert t.grid[2] * t.kz >= nz > (t.grid[2] - 1) * t.kz
    # per component four density planes of (ty + 2) x (tx + 2) floats
    assert t.halo == 1
    assert t.smem_bytes == 4 * 4 * K * (t.tx + 2) * (t.ty + 2)
    assert t.smem_bytes <= sm.SMEM_LIMIT
    p = t.params()
    assert (p.tx, p.ty, p.kz, tuple(p.grid), p.smem_bytes) == (
        t.tx, t.ty, t.kz, t.grid, t.smem_bytes)
    # int tx, ty, kz, grid[3], smem_bytes (csrc/sc_multi.cu SCTile)
    assert ctypes.sizeof(p) == 4 * 7


def test_tile_geometry_at_the_sized_tile():
    """At 32 x 8 and K = 3 a block stages 16,320 B: three components of
    four 34 x 10 planes."""
    assert sm.tile_geometry((64, 64, 64), 3, (32, 8, 16)).smem_bytes \
        == 16320
    assert sm.tile_geometry((64, 64, 64), 2, (32, 8, 16)).smem_bytes \
        == 10880


@pytest.mark.parametrize('shape, K, tile, why', [
    ((8, 8, 8), 2, (32, 16, 4), '1 to 256 threads'),
    ((8, 8, 8), 3, (0, 8, 4), '1 to 256 threads'),
    ((8, 8, 8), 2, (32, 8, 0), 'at least one z-plane'),
    ((8, 8, 8), 3, (1, 1, 4), 'more than 4 per thread'),
    ((8, 8, 8), 2, (5, 1, 4), 'more than 4 per thread'),
    ((2048, 1024, 1024), 2, sm.TILE_3D, '2\\^31 nodes'),
    ((1024, 2048, 1024), 3, sm.TILE_3D, '2\\^31 nodes'),
])
def test_tile_geometry_refuses_what_the_kernel_does_not_take(shape, K, tile,
                                                             why):
    with pytest.raises(ValueError, match=why):
        sm.tile_geometry(shape, K, tile)


def test_domain_of_2_31_nodes_is_refused_by_name():
    """The D3Q19 step's offsets are 32-bit: the wrapper refuses a domain of
    2^31 nodes or more by name; one node fewer passes, and the D2Q9 step
    (64-bit offsets) is not held to it."""
    big = (2048, 1024, 1024)
    assert any('2^31 nodes or more' in why
               for why in sm.domain_reasons('D3Q19', big))
    assert sm.domain_reasons('D3Q19', (2047, 1024, 1024)) == []
    assert sm.domain_reasons('D2Q9', (32768, 65536)) == []
    assert 'y and z extents' in sm.domain_reasons('D3Q19', (8, 70000, 8))[0]


def test_d3q19_tables_mirror_the_lattice():
    """``lattice_tables`` (what ``sc_d3q19_tables`` must copy out of the
    kernel) holds the lattice's directions, opposites and float32 weights;
    ``check_tables`` names a table that differs."""
    grid = lattice.D3Q19
    t = sm.lattice_tables()
    # int c[19][3]; int opp[19]; float w[19] (csrc/sc_multi.cu SCTables)
    assert ctypes.sizeof(sm._Tables) == 4 * (19 * 3 + 19 + 19)
    assert [list(t.c[i]) for i in range(19)] == grid.basis.tolist()
    assert list(t.opp) == grid.opposite.tolist()
    assert np.array_equal(np.ctypeslib.as_array(t.w),
                          grid.weights.astype(np.float32))
    sm.check_tables(t)
    t.w[7] = np.nextafter(np.float32(t.w[7]), np.float32(1))
    t.opp[1] = 1
    with pytest.raises(RuntimeError, match='differ .* in opp, w'):
        sm.check_tables(t)


@pytest.mark.parametrize('fn, inst', [
    ('_Z15sc_multi_kernelILi2ELi9ELi3ELb1EEvPKfS1_PfPKh8SCParams',
     dict(dim=2, q=9, k=3, forced=True)),
    ('_Z15sc_multi_kernelILi3ELi19ELi2EEvPKfS1_PfPKh8SCParams',
     dict(dim=3, q=19, k=2, forced=False)),
    ('_Z10sc3_kernelILi3ELb0EEvPKfS1_PfPKh8SCParams6SCTile',
     dict(dim=3, q=19, k=3, forced=False)),
    ('_Z10sc3_kernelILi2ELb1EEvPKfS1_PfPKh8SCParams6SCTile',
     dict(dim=3, q=19, k=2, forced=True)),
    ('_Z21rho_poststream_kernelILi3ELi19EEvPKfPfi8SCParams', None),
])
def test_instantiation_reads_both_step_kernels(fn, inst):
    assert sm.instantiation(fn) == inst


@pytest.mark.parametrize('case', sorted(MODE_CASES))
def test_d3q19_scenes_take_the_tile_and_d2q9_the_row(case):
    """A D3Q19 engine launches the tile kernel with the geometry of its
    shape and K (the tile argument after the parameter block); a D2Q9 one
    keeps the one-row launch and passes no tile."""
    make_sim, cfg, _name = MODE_CASES[case]
    ks = sm.SCMultiStep(cpu_runner(make_sim(), **cfg).builder)
    if ks.grid.name == 'D2Q9':
        assert ks.tile is None and ks._tile_args == ()
        return
    assert ks.tile == sm.tile_geometry(ks.shape, ks.K)
    assert ks._tile_args[0]._obj is ks._tile_params
    ks.set_tile((8, 4, 3))
    assert (ks.tile.tx, ks.tile.ty, ks.tile.kz) == (8, 4, 3)
    assert ks._tile_params.grid[2] == -(-ks.shape[0] // 3)
    assert ks.tile.smem_bytes == 16 * ks.K * 10 * 6


def sweep_tool():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'tools', 'sc_tile_sweep.py')
    spec = importlib.util.spec_from_file_location('sc_tile_sweep', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('variant,held,bounds', [
    ('repull', False, 2),
    ('blocks=3', True, 3),
    ('repull+blocks=4', False, 4),
])
def test_sweep_variants_edit_the_shipped_source(variant, held, bounds):
    """Each variant applies to the shipped kernel exactly once: the shipped
    source holds the K Q pulled values and __launch_bounds__(256, 2);
    ``repull`` pulls again at every read, ``blocks=n`` plans for n
    blocks."""
    tool = sweep_tool()
    text = (build.CSRC / 'sc_multi.cu').read_text()
    assert text.count(tool.HELD) == 1 and text.count(tool.BOUNDS) == 1
    out = tool.variant_source(variant, text)
    assert (tool.HELD in out) == held
    assert (tool.REPULLED in out) != held
    assert out.count(f'__launch_bounds__(SC3_THREADS, {bounds})') == 1
    with pytest.raises(ValueError, match='exactly once'):
        tool.variant_source(variant, out)
    with pytest.raises(ValueError, match='unknown variant'):
        tool.variant_source('spill', text)


def test_variant_source_outside_csrc_hashes_the_csrc_headers(tmp_path):
    """A sweep variant under build/sweep includes lattice_tables.cuh
    through -I: an edit of that header must change the variant's build
    key, as it does the shipped source's."""
    src = tmp_path / 'sc_multi_repull.cu'
    src.write_text((build.CSRC / 'sc_multi.cu').read_text())
    files = build.hashed_files(src)
    assert build.CSRC / 'lattice_tables.cuh' in files
    shipped = build.hashed_files(build.CSRC / 'sc_multi.cu')
    assert shipped == [build.CSRC / 'sc_multi.cu'] + sorted(
        build.CSRC.glob('*.cuh'))
