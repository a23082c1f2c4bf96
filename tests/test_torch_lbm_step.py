"""The kernel engine's Python side: node classification, BC table,
eligibility and its named refusals, parameter block, and
``step_reference`` (the plain PyTorch version of the CUDA kernel).

``step_reference`` is held against the JAX Pallas engine run the way the
JAX tests run it on the CPU (``engine='pallas'``, interpret mode): LDC 3D
16^3 and LDC 2D 32^2 for 8 steps, whose lids land on the in-kernel
native-BC (``kbc``) mode. Tolerance: wet-node max |df| <= 1e-5
(tests/test_sharded_pallas.py:31). The CUDA kernel itself runs only on a
card (tests/test_torch_cuda.py).
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from sailfish_tpu import lattice
from sailfish_tpu import node_type as nt
from sailfish_tpu.controller import \
    LBSimulationController as JaxController
from sailfish_tpu.subdomain import Subdomain2D
from sailfish_tpu_torch import lattice as lattice_torch
from sailfish_tpu_torch import node_type as nt_torch
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.ops import bc_patch as bp
from sailfish_tpu_torch.ops import lbm_step as ls
from sailfish_tpu_torch.state import state_to_numpy
from torch_scenes import (BC_PAIRS, channel_sim, channel_sim_2d, cpu_runner,
                          load_example, random_feq, twin, with_keep_block)

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
    # the lattice tables are compile-time in the kernel, not in the block
    assert not {'c', 'w', 'opp'} & {name for name, _ in ls._Params._fields_}
    g = lattice.D3Q19
    t = ls.lattice_tables(r.sim.grid)
    assert [list(t.c[i]) for i in range(g.Q)] == g.basis.tolist()
    assert list(t.opp)[:g.Q] == g.opposite.tolist()
    np.testing.assert_allclose(list(t.w)[:g.Q], g.weights, rtol=1e-7)


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
    # the varying instance is a row of the one BC table (code 3) with
    # the box of its nodes (x = 4..7 of the row y = 7); its per-node u_x
    # and u_y follow rho in the parameter array
    ks = ls.KernelStep(r.builder)
    assert ks.vary and (ks.entry, ks.name) == ('lbm_step_d2q9',
                                               'lbm_step_vary_d2q9')
    assert [(t.type_id, t.box) for t in ks.table] == [
        (tid, bp.Box(0, (4, 7, 0), (4, 1, 1)))]
    assert np.array_equal(ks.mask.numpy(), mask)
    np.testing.assert_array_equal(
        ks.bcp.numpy().reshape(3, 4),
        np.array([[1.0] * 4, [0.04, 0.05, 0.06, 0.07], [0.0] * 4],
                 dtype=np.float32))
    p = ks.params
    assert (p.vary[0].varies, p.vary[0].offset) == (1, 0)
    assert (list(p.vary[0].lo), list(p.vary[0].ext)) == ([4, 7, 0],
                                                         [4, 1, 1])
    assert p.vary[1].varies == 0


@pytest.mark.parametrize('cfg,match', [
    (dict(precision='double'), 'fp32 only'),
    (dict(lat_nx=4, lat_ny=70000), 'y and z extents above 65535'),
])
def test_ineligible_configurations(cfg, match):
    r = cpu_runner(twin('ldc_2d'), **{'lat_nx': 8, 'lat_ny': 8, **cfg})
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
    # int nx, ny, nz, nbc; float tau_inv; LBMBC bc[16] with LBMBC = 4
    # ints/floats + float[3]; then LBMVary vary[16] with LBMVary = int
    # varies, lo[3], ext[3], offset: 32 B a row; then LBMForce = int model,
    # float a[3], shift[3], pref: 32 B; then LBMCollide = int model,
    # equilibrium, float s_e, s_o, tau, tau2, les_c, gravity: 32 B; then
    # LBMShanChen = int potential, float g, tau: 12 B; then LBMEntropic =
    # float beta, entropy_tol, alpha_tol: 12 B; then, at the end,
    # LBMOutflow = int lam_entry[16], lam_lo[16]: 128 B. No lattice table
    # (the
    # kernel's are compile-time: 540 B less than with c, w and opp), and
    # no member is wider than 4 bytes (an 8-byte one changes the block's
    # alignment, which once slowed the kernel by 20 %)
    assert ctypes.sizeof(ls._BC) == 28
    assert ls._Params.bc.offset == 4 * 5
    assert ls._Params.vary.offset == 4 * (5 + 16 * 7) == 468
    assert ctypes.sizeof(ls._Vary) == 32
    assert ls._Params.force.offset == 468 + 16 * 32 == 980
    assert ctypes.sizeof(ls._Force) == 32
    assert ls._Params.coll.offset == 980 + 32 == 1012
    assert ctypes.sizeof(ls._Collide) == 32
    assert ls._Params.sc.offset == 1012 + 32 == 1044
    assert ctypes.sizeof(ls._ShanChen) == 12
    assert ls._Params.elbm.offset == 1044 + 12 == 1056
    assert ctypes.sizeof(ls._Entropic) == 12
    assert ls._Params.out.offset == 1056 + 12 == 1068
    assert ctypes.sizeof(ls._Outflow) == 128
    assert ctypes.sizeof(ls._Params) == 1068 + 128 == 1196
    for struct in (ls._BC, ls._Vary, ls._Force, ls._Collide, ls._ShanChen,
                   ls._Entropic, ls._Outflow, ls._Params):
        assert ctypes.alignment(struct) == 4


@pytest.mark.parametrize('model,shift', [
    ('guo', 0.5), ('edm', 0.0), ('velocity_shift', 0.8)])
def test_kernel_params_carry_the_force(model, shift):
    """The block holds the force model's code, the acceleration, the
    equilibrium-velocity shift s a (s = 1/2, 0 or tau) and the Guo
    prefactor 1 - 1/(2 tau), fp64 products cast to fp32; without a force
    the code is 0 and every float of the force block 0."""
    accel = (1e-5, -4e-6, 2.5e-6)
    tau_inv = 1.0 / 0.8
    for grid in (lattice_torch.D2Q9, lattice_torch.D3Q19):
        shape = (4,) * grid.dim
        p = ls.kernel_params(grid, shape, [], tau_inv, accel[:grid.dim],
                             model)
        assert p.force.model == ls.FORCE_CODES[model] > 0
        want = np.zeros(3)
        want[:grid.dim] = accel[:grid.dim]
        assert list(p.force.a) == list(want.astype(np.float32))
        assert list(p.force.shift) == list((shift * want).astype(np.float32))
        assert p.force.pref == np.float32(1.0 - 0.5 * tau_inv)
        bare = ls.kernel_params(grid, shape, [], tau_inv)
        assert bare.force.model == 0
        assert bytes(bare.force) == bytes(ctypes.sizeof(ls._Force))
    assert ls.FORCE_CODES == {'guo': 1, 'edm': 2, 'velocity_shift': 3}
    # LBMTables: int q, dim; int c[27][3]; float w[27]; int opp[27];
    # int slip[3][27]; float minv[27][4]; float logw[27]
    assert ctypes.sizeof(ls._Tables) == 4 * (2 + 27 * 3 + 27 + 27 + 3 * 27
                                             + 27 * 4 + 27)


class _FakeLib:
    """Stands for a loaded ``csrc/lbm_step.cu`` library: the sizes it
    reports, and ``lbm_lattice_tables`` copying out the lattice's own
    tables after ``spoil`` has changed them."""

    class Entry:
        argtypes = restype = None

    def __init__(self, params=None, tables=None, spoil=None):
        self.lbm_params_size = lambda: (
            ctypes.sizeof(ls._Params) if params is None else params)
        self.lbm_tables_size = lambda: (
            ctypes.sizeof(ls._Tables) if tables is None else tables)
        self.lbm_step_d2q9 = self.Entry()
        self.lbm_step_d3q19 = self.Entry()
        self.lbm_step_sc_d2q9 = self.Entry()
        self.lbm_step_sc_d3q19 = self.Entry()
        self.lbm_step_d3q15 = self.Entry()
        self.lbm_step_d3q27 = self.Entry()
        self.lbm_step_outflow_d3q19 = self.Entry()

        def copy_out(dim, q, ref):
            name = f'D{dim}Q{q}'
            if name not in ls.KERNEL_GRIDS:
                return 1
            t = ls.lattice_tables(lattice_torch.get_grid(name))
            if spoil:
                spoil(t)
            ctypes.memmove(ref, ctypes.byref(t), ctypes.sizeof(t))
            return 0

        self.lbm_lattice_tables = copy_out
        self.lbm_lattice_tables.argtypes = None


def test_kernel_function_checks_the_params_size():
    """``kernel_function`` refuses a library whose ``LBMParams`` or
    ``LBMTables`` differs from ``_Params`` / ``_Tables``, and types the
    entry otherwise (parameter array fourth, link tags fifth, parameter
    block sixth)."""
    with pytest.raises(RuntimeError, match='LBMParams layout differs'):
        ls.kernel_function(_FakeLib(params=ctypes.sizeof(ls._Params) - 8),
                           'lbm_step_d3q19')
    with pytest.raises(RuntimeError, match='LBMTables layout differs'):
        ls.kernel_function(_FakeLib(tables=ctypes.sizeof(ls._Tables) + 4),
                           'lbm_step_d3q19')
    fn = ls.kernel_function(_FakeLib(), 'lbm_step_d3q19')
    assert fn.argtypes[:5] == [ctypes.c_void_p] * 5
    assert fn.argtypes[5] == ctypes.POINTER(ls._Params)
    # the Shan-Chen entry: state, densities, output, mask, block, stream
    fn = ls.kernel_function(_FakeLib(), 'lbm_step_sc_d3q19')
    assert fn.argtypes[:4] == [ctypes.c_void_p] * 4
    assert fn.argtypes[4] == ctypes.POINTER(ls._Params)
    # the outflow entry: the plane means of the laminarize pre-pass sixth
    fn = ls.kernel_function(_FakeLib(), 'lbm_step_outflow_d3q19')
    assert fn.argtypes[:6] == [ctypes.c_void_p] * 6
    assert fn.argtypes[6] == ctypes.POINTER(ls._Params)
    # launches are counted apart by what they compute; one entry serves
    # all but the Shan-Chen mode, whose pre-pass counts apart too, the
    # int16 state's mode and the outflow rows, whose laminarize pre-pass
    # counts apart too; a launch on a shard's ghost-plane buffers counts
    # under its kind with ghost_ after lbm_step_, the Shan-Chen pre-pass of
    # a shard with ghost_ after nk1_, the laminarize pre-pass over a mesh
    # with ghost_ after mean_
    assert sorted(ls.LAUNCHES) == sorted(['lbm_step_d2q9', 'lbm_step_d3q19',
                                   'lbm_step_dyn_d2q9',
                                   'lbm_step_dyn_d3q19',
                                   'lbm_step_elbm_d2q9',
                                   'lbm_step_elbm_d3q19',
                                   'lbm_step_force_d2q9',
                                   'lbm_step_force_d3q19',
                                   'lbm_step_incomp_d2q9',
                                   'lbm_step_incomp_d3q19',
                                   'lbm_step_les_d2q9',
                                   'lbm_step_les_d3q19',
                                   'lbm_step_mixed_d2q9',
                                   'lbm_step_mixed_d3q19',
                                   'lbm_step_mrt_d2q9',
                                   'lbm_step_mrt_d3q19',
                                   'lbm_step_outflow_d2q9',
                                   'lbm_step_outflow_d3q19',
                                   'laminarize_mean_d2q9',
                                   'laminarize_mean_d3q19',
                                   'laminarize_mean_ghost_d2q9',
                                   'laminarize_mean_ghost_d3q19',
                                   'lbm_step_sc_d2q9',
                                   'lbm_step_sc_d3q19',
                                   'lbm_step_sw_d2q9',
                                   'lbm_step_sw_d3q19',
                                   'lbm_step_vary_d2q9',
                                   'lbm_step_vary_d3q19',
                                   'lbm_step_wall_d2q9',
                                   'lbm_step_wall_d3q19',
                                   'rho_poststream_nk1_d2q9',
                                   'rho_poststream_nk1_d3q19',
                                   'rho_poststream_nk1_ghost_d2q9',
                                   'rho_poststream_nk1_ghost_d3q19'] + [
        f'lbm_step_{kind}{g}' for g in ('d3q15', 'd3q27')
        for kind in ('', 'dyn_', 'force_', 'incomp_', 'vary_', 'wall_')] + [
        f'lbm_step_ghost_{kind}{g}' for g in ('d2q9', 'd3q19')
        for kind in ('', 'dyn_', 'elbm_', 'force_', 'incomp_', 'les_',
                     'mixed_', 'mrt_', 'outflow_', 'sc_', 'sw_', 'vary_',
                     'wall_')] + [
        f'lbm_step_ghost_{kind}{g}' for g in ('d3q15', 'd3q27')
        for kind in ('', 'dyn_', 'force_', 'incomp_', 'vary_', 'wall_')])


def _many_instances_sim():
    """A 3D box whose six faces each carry Zou-He, equilibrium and
    regularized velocity nodes in stripes: 6 orientations x 3 types = 18
    native-BC instances, two more than the kernel's table holds."""
    from sailfish_tpu_torch.subdomain import Subdomain3D

    class Scene(Subdomain3D):
        def boundary_conditions(self, hx, hy, hz):
            h, g = (hx, hy, hz), (self.gx, self.gy, self.gz)
            types = (nt_torch.NTZouHeVelocity, nt_torch.NTEquilibriumVelocity,
                     nt_torch.NTRegularizedVelocity)
            edge = np.zeros(self.shape, dtype=bool)
            for a in range(3):
                edge |= (h[a] == 0) | (h[a] == g[a] - 1)
            self.set_node(edge, nt_torch.NTFullBBWall)
            for a in range(3):
                others = [k for k in range(3) if k != a]
                inner = np.ones(self.shape, dtype=bool)
                for k in others:
                    inner &= (h[k] >= 2) & (h[k] < g[k] - 2)
                stripe = h[others[0]] % 3
                for face in (0, g[a] - 1):
                    for t, cls in enumerate(types):
                        self.update_node(
                            (h[a] == face) & inner & (stripe == t),
                            cls((0.0, 0.0, 0.0)))

    class Sim(LBFluidSim):
        subdomain = Scene

    return Sim


def _no_orientation_sim():
    """A Zou-He velocity node buried in a wall three nodes thick: no wet
    neighbour along any axis, no detected orientation."""
    from sailfish_tpu_torch.subdomain import Subdomain2D as TorchSubdomain2D

    class Scene(TorchSubdomain2D):
        def boundary_conditions(self, hx, hy):
            self.set_node(hx <= 2, nt_torch.NTFullBBWall)
            self.update_node((hx == 1) & (hy == 4),
                             nt_torch.NTZouHeVelocity((0.01, 0.0)))

    class Sim(LBFluidSim):
        subdomain = Scene

    return Sim


def _diagonal_sim():
    """Two velocity nodes with different u on the x = 0 column, 32 rows
    apart (a box of 1 x 33), the rest of the column a wall."""
    from sailfish_tpu_torch.subdomain import Subdomain2D as TorchSubdomain2D

    class Scene(TorchSubdomain2D):
        def boundary_conditions(self, hx, hy):
            self.set_node((hx == 0) & ~np.isin(hy, (8, 40)),
                          nt_torch.NTFullBBWall)
            self.set_node((hx == 0) & np.isin(hy, (8, 40)),
                          nt_torch.NTZouHeVelocity((0.001 * hy, 0.0)))

    class Sim(LBFluidSim):
        subdomain = Scene

    return Sim


@pytest.mark.parametrize('make_sim,cfg,match', [
    (_many_instances_sim, dict(lat_nx=12, lat_ny=12, lat_nz=12),
     r'18 BC instances \(the kernel takes at most 16\)'),
    (_no_orientation_sim, dict(lat_nx=8, lat_ny=8),
     'NTZouHeVelocity nodes without a detected orientation'),
    (_diagonal_sim, dict(lat_nx=16, lat_ny=48),
     r'2 nodes with spatially varying parameters in a bounding box of 33 '
     r'\(the parameter array takes at most 16 times the node count\)'),
], ids=['too_many_instances', 'no_orientation', 'sparse_box'])
def test_remaining_refusals_are_named(make_sim, cfg, match):
    r = cpu_runner(make_sim(), **cfg)
    with pytest.raises(NotImplementedError, match=match):
        ls.KernelStep(r.builder)


@pytest.mark.parametrize('dim,axis', [(3, 'z'), (3, 'x'), (2, 'y'), (2, 'x')])
@pytest.mark.parametrize('pair', sorted(BC_PAIRS))
def test_step_reference_takes_per_node_parameters(pair, dim, axis):
    """``step_reference`` with a varying row (parameters from the array)
    against the torch engine's per-node parameter fields, with a block of
    excluded nodes, from a random equilibrium state: 10 steps, wet-node
    max |df| <= 1e-6; and the same table with the box dropped (the scalars
    of the first node everywhere) must differ: the array is what is
    read."""
    if dim == 3:
        sim = channel_sim(pair, axis, profile='parabolic')
        cfg = dict(lat_nx=16, lat_ny=12, lat_nz=12)
    else:
        sim = channel_sim_2d(pair, axis=axis)
        cfg = dict(lat_nx=24, lat_ny=20)
    r = cpu_runner(with_keep_block(sim), **cfg)
    mask_np, instances, reasons = ls.classify_nodes(r.maps)
    assert reasons == [] and sorted(np.unique(mask_np)) == [0, 1, 2, 3, 4]
    boxes, why = bp.instance_boxes(r.maps, instances)
    assert why == [] and sum(b is not None for b in boxes) == 1
    table = ls.bc_table(r.maps, instances, boxes)
    bcp = torch.from_numpy(bp.param_array(r.maps, boxes))
    mask = torch.from_numpy(mask_np)
    f0 = random_feq(r.sim.grid, mask_np.shape, seed=8, device='cpu')
    f = ft = f0
    step = r.builder.build()
    for _ in range(10):
        f = ls.step_reference(f, mask, table, r.sim.grid, r.builder.tau_inv,
                              bcp)
        ft = step(ft)
    wet = torch.from_numpy((mask_np == 0) | (mask_np >= 3))
    assert float((f - ft)[:, wet].abs().max()) <= 1e-6
    flat = [row._replace(box=None) for row in table]
    fu = ls.step_reference(f0, mask, flat, r.sim.grid, r.builder.tau_inv)
    fv = ls.step_reference(f0, mask, table, r.sim.grid, r.builder.tau_inv,
                           bcp)
    assert float((fu - fv)[:, wet].abs().max()) > 1e-4


def _source_table(text, decl):
    body = re.search(re.escape(decl) + r'\s*=\s*\{(.*?)\};', text, re.S)
    return [int(v) for v in re.findall(r'-?\d+', body.group(1))]


@pytest.mark.parametrize('name', ['D2Q9', 'D3Q19'])
def test_cuda_source_tables_equal_the_lattice(name):
    """The literal tables of ``struct D2Q9`` / ``struct D3Q19`` in
    csrc/lattice_tables.cuh, the port's one copy: c and opp entry by entry
    in the direction order of ``lattice``, w by its three shells."""
    from sailfish_tpu_torch.ops import build
    text = (build.CSRC / 'lattice_tables.cuh').read_text()
    assert len(re.findall(r'^struct D3Q19 ', text, re.M)) == 1
    for other in ('lbm_common.cuh', 'lbm_step.cu', 'fe_step.cu'):
        assert not re.search(r'^struct D3Q19 ',
                             (build.CSRC / other).read_text(), re.M)
    grid = lattice_torch.get_grid(name)
    assert grid.basis.tolist() == lattice.get_grid(name).basis.tolist()
    q, dim = grid.Q, grid.dim
    assert _source_table(text, f'constexpr int t[{q}][{dim}]') == \
        grid.basis.reshape(-1).tolist()
    assert _source_table(text, f'constexpr int t[{q}]') == \
        grid.opposite.tolist()
    struct = text[text.index(f'struct {name} '):]
    w = re.search(r'static constexpr float w\(int i\) \{(.*?)\}', struct,
                  re.S).group(1)
    shells = [float(a) / float(b) for a, b in
              re.findall(r'\(float\)\((\d+\.\d+) / (\d+\.\d+)\)', w)]
    n2 = (grid.basis ** 2).sum(axis=1)
    np.testing.assert_array_equal(np.float32([shells[k] for k in n2]),
                                  grid.weights.astype(np.float32))


@pytest.mark.parametrize('name', ls.KERNEL_GRIDS)
def test_check_tables_accepts_the_lattice(name):
    grid = lattice_torch.get_grid(name)
    t = ls.lattice_tables(grid)
    ls.check_tables(t, grid)
    assert (t.q, t.dim) == (grid.Q, grid.dim)
    c = np.ctypeslib.as_array(t.c)
    assert c[:grid.Q, :grid.dim].tolist() == grid.basis.tolist()
    assert not c[grid.Q:].any() and not c[:, grid.dim:].any()
    assert list(t.opp)[:grid.Q] == grid.opposite.tolist()
    np.testing.assert_array_equal(np.ctypeslib.as_array(t.w)[:grid.Q],
                                  grid.weights.astype(np.float32))
    # the check at load: a library whose tables are the lattice's passes
    ls.kernel_function(_FakeLib(), f'lbm_step_{name.lower()}')


@pytest.mark.parametrize('field', [f for f, _ in ls._Tables._fields_])
@pytest.mark.parametrize('name', ls.KERNEL_GRIDS)
def test_check_tables_raises_on_a_perturbed_copy(name, field):
    grid = lattice_torch.get_grid(name)

    def spoil(t):
        if field in ('q', 'dim'):
            setattr(t, field, getattr(t, field) + 1)
            return
        arr = np.ctypeslib.as_array(getattr(t, field)).reshape(-1)
        if arr.dtype == np.float32:
            # one ulp off in the first entry
            arr[0] = np.nextafter(arr[0], np.float32(np.inf))
        else:
            arr[3] += 1

    t = ls.lattice_tables(grid)
    spoil(t)
    with pytest.raises(RuntimeError, match=f'{name} tables .* in {field}$'):
        ls.check_tables(t, grid)
    # and through the check that runs when the library loads
    with pytest.raises(RuntimeError, match=f'differ .* in {field}$'):
        ls.kernel_function(_FakeLib(spoil=spoil),
                           f'lbm_step_{name.lower()}')


def test_plane_beyond_32_bit_offsets_is_refused(monkeypatch):
    """The kernel addresses a node inside its (y, x) plane with an int: a
    plane too large for it is refused by name."""
    r = cpu_runner(twin('ldc_3d'), lat_nx=8, lat_ny=6, lat_nz=4)
    assert ls.kernel_ineligibility(r.builder) == []
    assert ls.MAX_PLANE_FLOATS == 2 ** 31 - 1
    monkeypatch.setattr(ls, 'MAX_PLANE_FLOATS', 47)
    assert ls.kernel_ineligibility(r.builder) == [
        'domain (4, 6, 8): 48 nodes in one (y, x) plane (the kernel '
        'indexes at most 47)']
    with pytest.raises(NotImplementedError, match='one .y, x. plane'):
        ls.KernelStep(r.builder)


def test_kernel_takes_elbm_and_names_what_it_refuses():
    """``kernel_ineligibility`` takes ``--model=elbm`` (fp32 and int16, any
    force model, wall rows), with its code and block: beta = 1 / (2 tau),
    the Newton stops, the Smagorinsky constant ignored; it names the
    product-form equilibrium (under BGK, MRT or ELBM), ELBM with the
    incompressible equilibrium and Shan-Chen under ELBM."""
    from sailfish_tpu_torch.ops.step import StepBuilder
    for extra in ({}, dict(precision='mixed'),
                  dict(subgrid='les-smagorinsky', smagorinsky_const=0.1)):
        r = cpu_runner(twin('ldc_3d'), lat_nx=8, lat_ny=8, lat_nz=8,
                       model='elbm', visc=0.05, **extra)
        assert ls.kernel_ineligibility(r.builder) == []
        ks = ls.KernelStep(r.builder)
        assert ks.params.coll.model == ls.MODEL_CODES['elbm']
        assert ks.params.elbm.beta == np.float32(1.0 / (2.0 * r.builder.tau))
        assert ks.library == ('lbm_step_mixed_elbm' if extra.get('precision')
                              else 'lbm_step_elbm')
        assert ks.name == ('lbm_step_mixed_d3q19' if extra.get('precision')
                           else 'lbm_step_elbm_d3q19')
    r = cpu_runner(twin('ldc_2d'), lat_nx=8, lat_ny=8)
    cases = [(dict(model='elbm', equilibrium='elbm'), 'equilibrium=elbm'),
             (dict(equilibrium='elbm'), 'equilibrium=elbm'),
             (dict(model='mrt', equilibrium='elbm'), 'equilibrium=elbm'),
             (dict(model='elbm', incompressible=True),
              'model=elbm with --incompressible'),
             (dict(model='elbm', sc_coupling=-1.6),
              'Shan-Chen with model=elbm')]
    for kwargs, match in cases:
        b = StepBuilder(r.sim.grid, r.maps, visc=0.1, **kwargs)
        assert any(match in why for why in ls.kernel_ineligibility(b)), \
            kwargs
