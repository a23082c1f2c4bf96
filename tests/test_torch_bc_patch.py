"""Native BCs with spatially varying parameters on the kernel engine: the
parameter array of ``ops/bc_patch.py`` and the varying rows of
``lbm_step.step_reference``, the plain PyTorch version of
``lbm_step_kernel`` (``csrc/lbm_step.cu``).

* The rows of ``step_reference`` that hold the varying inlet against the
  JAX Pallas patch kernels (``make_bc_patch_kernel_3d`` / ``_2d``) run in
  interpret mode, on parabolic-inlet channels (32x16x16, 64^2) from a
  seeded random state: max |df| <= 1e-6.
* ``KernelStep`` on the CPU (``step_reference``) against the JAX XLA engine
  for 20 steps, for the three native BC pairs, 3D with the inlet normal to
  z and to x and 2D normal to y and to x (wet-node max |df| <= 1e-6), and
  the z- / y-normal ones against the JAX Pallas engine in interpret mode,
  which takes the patch-kernel route there (1e-6).
* The structure: one BC table holding every instance, the varying ones
  with a box; the parameter array's layout and offsets; a face with
  holes; a scene where the JAX routing demotes a uniform instance (the
  port keeps three instances in one table); the refusal of a varying
  instance whose bounding box is far larger than its node count.

The JAX twins of the channels are built here from the JAX package's own
``Subdomain`` classes, with the same numpy profile function.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu import lattice as jlattice
from sailfish_tpu import node_type as jnt
from sailfish_tpu.controller import \
    LBSimulationController as JaxController
from sailfish_tpu.models.single import LBFluidSim as JaxFluidSim
from sailfish_tpu.ops.pallas_step import (PallasStep3D, cz_groups,
                                          make_bc_patch_kernel_3d)
from sailfish_tpu.ops.pallas_step2d import make_bc_patch_kernel_2d
from sailfish_tpu.ops.step import StepBuilder as JaxStepBuilder
from sailfish_tpu.subdomain import Subdomain2D as JaxSubdomain2D
from sailfish_tpu.subdomain import Subdomain3D as JaxSubdomain3D
from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.ops import bc_patch as bp
from sailfish_tpu_torch.ops import lbm_step as ls
from sailfish_tpu_torch.state import state_to_numpy
from sailfish_tpu_torch.subdomain import Subdomain3D
from torch_scenes import (BC_PAIRS, U_INLET, channel_sim, channel_sim_2d,
                          cpu_runner, parabolic_profile, random_feq, wet_map,
                          with_keep_block, with_patch_row_mix)

torch.set_num_threads(1)

TOL = 1e-6
STEPS = 20
SIZES = {3: dict(lat_nx=32, lat_ny=16, lat_nz=16, periodic_x=True),
         2: dict(lat_nx=64, lat_ny=64)}
#: (dimension, inlet axis) -> size; the axes array axis 0 is normal to
#: are SIZES' channels
AXIS_SIZES = {(3, 'z'): SIZES[3], (2, 'y'): SIZES[2],
              (3, 'x'): dict(lat_nx=16, lat_ny=16, lat_nz=32,
                             periodic_z=True),
              (2, 'x'): dict(lat_nx=64, lat_ny=48)}
FLOW_AXIS = {3: 'z', 2: 'y'}

JAX_PAIRS = {
    'equilibrium': (jnt.NTEquilibriumVelocity, jnt.NTEquilibriumDensity),
    'zouhe': (jnt.NTZouHeVelocity, jnt.NTZouHeDensity),
    'regularized': (jnt.NTRegularizedVelocity, jnt.NTRegularizedDensity),
}


def port_channel(pair, dim, axis=None):
    axis = axis or FLOW_AXIS[dim]
    return (channel_sim(pair, axis, profile='parabolic') if dim == 3
            else channel_sim_2d(pair, axis=axis))


def jax_channel(pair, dim, axis=None):
    """The JAX twin of ``port_channel``: the same walls, parabolic inlet,
    density outlet and initial state on the JAX package's classes."""
    vel_cls, den_cls = JAX_PAIRS[pair]
    axis = axis or FLOW_AXIS[dim]
    a = 'xyz'.index(axis)
    if dim == 3:
        class Channel(JaxSubdomain3D):
            def boundary_conditions(self, hx, hy, hz):
                h, n = (hx, hy, hz)[a], (self.gx, self.gy, self.gz)[a]
                walls = (hy == 0) | (hy == self.gy - 1)
                self.set_node(walls, jnt.NTFullBBWall)
                u = parabolic_profile(hy, self.gy)
                u_in = tuple(u if i == a else 0.0 for i in range(3))
                self.set_node((h == 0) & ~walls, vel_cls(u_in))
                self.set_node((h == n - 1) & ~walls, den_cls(1.0))

            def initial_conditions(self, sim, hx, hy, hz):
                sim.rho[:] = 1.0
                getattr(sim, f'v{axis}')[:] = 0.01
    else:
        class Channel(JaxSubdomain2D):
            def boundary_conditions(self, hx, hy):
                h, n = (hx, hy)[a], (self.gx, self.gy)[a]
                s, ns = (hx, hy)[1 - a], (self.gx, self.gy)[1 - a]
                walls = (s == 0) | (s == ns - 1)
                self.set_node(walls, jnt.NTFullBBWall)
                u = parabolic_profile(s, ns)
                u_in = tuple(u if i == a else 0.0 for i in range(2))
                self.set_node((h == 0) & ~walls, vel_cls(u_in))
                self.set_node((h == n - 1) & ~walls, den_cls(1.0))

            def initial_conditions(self, sim, hx, hy):
                sim.rho[:] = 1.0
                getattr(sim, f'v{axis}')[:] = 0.01

    class Sim(JaxFluidSim):
        subdomain = Channel

    return Sim


def run_jax(sim_cls, **cfg):
    ctrl = JaxController(sim_cls, default_config=dict(
        platform='cpu', quiet=True, **cfg))
    ctrl.run(ignore_cmdline=True)
    return ctrl._runner


def test_parabolic_profile():
    n = 16
    u = parabolic_profile(np.arange(n), n)
    assert u[0] < 0 and u[-1] < 0      # wall nodes (overridden by walls)
    np.testing.assert_allclose(u[1:-1], u[1:-1][::-1], atol=1e-15)
    np.testing.assert_allclose(parabolic_profile([0.5, n - 1.5], n), 0.0,
                               atol=1e-15)
    assert parabolic_profile((n - 1) / 2, n) == pytest.approx(U_INLET)


def _rows_by_type(ks):
    return {row.type_id: (j, row) for j, row in enumerate(ks.table)}


@pytest.mark.parametrize('dim', [3, 2])
@pytest.mark.parametrize('pair', sorted(BC_PAIRS))
def test_routing_of_the_parabolic_channel(pair, dim):
    """Both instances sit in ONE table: the varying inlet with the box of
    its face (row 0 of the array's axis 0: the z = 0 plane, the y = 0
    row), the uniform outlet with its scalar; each is mask code 3 + its
    index; the parameter array holds the inlet's profile."""
    r = cpu_runner(port_channel(pair, dim), **SIZES[dim])
    ks = ls.KernelStep(r.builder)
    vel_cls, den_cls = BC_PAIRS[pair]
    assert ks.vary and ks.name == f'lbm_step_vary_d{dim}q{r.sim.grid.Q}'
    rows = _rows_by_type(ks)
    assert len(ks.table) == 2
    jv, inlet = rows[vel_cls.id]
    jd, outlet = rows[den_cls.id]
    assert (inlet.orientation, outlet.orientation) == (2 * dim - 1, 2 * dim)
    assert outlet.box is None and outlet.rho == 1.0
    tm = r.maps.type_map
    # walls take the first and last node across the channel
    across = tm.shape[-2 if dim == 3 else -1]
    if dim == 3:
        assert inlet.box == bp.Box(0, (0, 1, 0), (tm.shape[2], across - 2, 1))
    else:
        assert inlet.box == bp.Box(0, (1, 0, 0), (across - 2, 1, 1))
    mask = ks.mask.numpy()
    assert np.array_equal(mask == 3 + jv, tm == vel_cls.id)
    assert np.array_equal(mask == 3 + jd, tm == den_cls.id)
    assert np.array_equal(mask == 1, tm == nt.NTFullBBWall.id)
    bcp = ks.bcp.numpy()
    assert bcp.dtype == np.float32
    assert bcp.shape == ((1 + dim) * int(np.prod(inlet.box.ext)),)
    rho_f, vel_f = ls.box_params(inlet, ks.bcp, ks.shape)
    sel = tm == vel_cls.id
    for a in range(dim):
        np.testing.assert_array_equal(
            vel_f[a].numpy()[sel],
            r.maps.param_vel[a][sel].astype(np.float32))
    assert np.ptp(vel_f[dim - 1].numpy()[sel]) > 0.02


def _patch_inputs(pair, dim, seed):
    """(port runner, KernelStep, random fp32 state, the inlet's table index
    and row) of the channel."""
    r = cpu_runner(port_channel(pair, dim), **SIZES[dim])
    ks = ls.KernelStep(r.builder)
    f = random_feq(r.sim.grid, ks.shape, seed=seed, device='cpu')
    j, inlet = _rows_by_type(ks)[BC_PAIRS[pair][0].id]
    return r, ks, f, j, inlet


def _patch_planes(ks, j, inlet, rows):
    """What the JAX patch kernels take for the listed rows of axis 0: the
    mask codes with the inlet as patch instance 0 (code 3), and the (1 +
    dim, R, *plane) parameter planes read back from the port's array."""
    m = ks.mask.numpy()[rows].astype(np.int32)
    assert set(np.unique(m)) <= {0, 1, 3 + j}
    m[m == 3 + j] = 3
    rho_f, vel_f = ls.box_params(inlet, ks.bcp, ks.shape)
    bcp = np.stack([rho_f.numpy()[rows]]
                   + [v.numpy()[rows] for v in vel_f])
    return m, bcp


@pytest.mark.parametrize('pair', sorted(BC_PAIRS))
def test_patch_reference_matches_jax_kernel_3d(pair):
    """The z = 0 plane of ``step_reference`` against the TPU patch
    kernel's plane."""
    r, ks, f, j, inlet = _patch_inputs(pair, 3, seed=11)
    grid = jlattice.get_grid('D3Q19')
    jb = JaxStepBuilder(grid, r.maps, visc=r.config.visc,
                        dtype=jnp.float32)
    Z, Y, X = ks.shape
    rows = np.array([0])
    mask_rows, bcp = _patch_planes(ks, j, inlet, rows)
    insts = ((inlet.type_id, inlet.orientation),)
    kern = make_bc_patch_kernel_3d(jb, Z, len(rows), Y, X, insts,
                                   interpret=True)
    perm, inv, _ = cz_groups(grid)
    out = np.asarray(kern(jnp.asarray(f.numpy()[perm]),
                          jnp.asarray(mask_rows), jnp.asarray(bcp),
                          jnp.asarray(rows.astype(np.int32))))
    ref = ks.reference(f).numpy()[:, rows]
    assert ref.shape == (19, len(rows), Y, X)
    assert np.max(np.abs(ref - out[inv])) <= TOL


@pytest.mark.parametrize('pair', sorted(BC_PAIRS))
def test_patch_reference_matches_jax_kernel_2d(pair):
    """The 2D TPU kernel works on y-blocks of ``by`` rows: the first
    block of ``step_reference``'s result is compared."""
    r, ks, f, j, inlet = _patch_inputs(pair, 2, seed=12)
    grid = jlattice.get_grid('D2Q9')
    jb = JaxStepBuilder(grid, r.maps, visc=r.config.visc,
                        dtype=jnp.float32)
    Y, X = ks.shape
    by = 8
    insts = ((inlet.type_id, inlet.orientation),)
    kern = make_bc_patch_kernel_2d(jb, Y, X, by, (0,), insts,
                                   interpret=True)
    block_mask, bcp = _patch_planes(ks, j, inlet, np.arange(by))
    out = np.asarray(kern(jnp.asarray(f.numpy()),
                          jnp.asarray(block_mask[None]),
                          jnp.asarray(bcp[:, None])))
    ref = ks.reference(f).numpy()[:, :by]
    assert ref.shape == (9, by, X)
    assert np.max(np.abs(ref - out[:, 0])) <= TOL


def _port_kernel_run(pair, dim, axis=None, steps=STEPS):
    r = cpu_runner(port_channel(pair, dim, axis),
                   **AXIS_SIZES[dim, axis or FLOW_AXIS[dim]])
    ks = ls.KernelStep(r.builder)
    assert ks.vary
    return r, ks, ks.run(r.f, steps)


def _matches_jax_xla(pair, dim, axis):
    jr = run_jax(jax_channel(pair, dim, axis), engine='xla', max_iters=STEPS,
                 every=STEPS, **AXIS_SIZES[dim, axis])
    assert jr.engine == 'xla'
    r, ks, f = _port_kernel_run(pair, dim, axis)
    wet = wet_map(r.maps)
    fj = np.asarray(jr.f)
    assert np.max(np.abs(state_to_numpy(f)[:, wet] - fj[:, wet])) <= TOL
    assert ks.launches == 0                              # CPU: plain only
    assert all(n == 0 for n in ls.LAUNCHES.values())


@pytest.mark.parametrize('dim', [3, 2])
@pytest.mark.parametrize('pair', sorted(BC_PAIRS))
def test_kernel_step_matches_jax_xla_engine(pair, dim):
    _matches_jax_xla(pair, dim, FLOW_AXIS[dim])


@pytest.mark.parametrize('dim', [3, 2])
@pytest.mark.parametrize('pair', sorted(BC_PAIRS))
def test_x_normal_kernel_step_matches_jax_xla_engine(pair, dim):
    """A varying inlet normal to x: a node on every row of the array's
    axis 0, which the TPU patch design cannot take."""
    _matches_jax_xla(pair, dim, 'x')


@pytest.mark.parametrize('dim', [3, 2])
def test_kernel_step_matches_jax_pallas_engine(dim):
    """The JAX Pallas engine (interpret mode) routes the regularized
    inlet to its patch kernel (``bc_rows`` / ``bc_blocks`` == (0,))."""
    jr = run_jax(jax_channel('regularized', dim), engine='pallas',
                 max_iters=STEPS, every=STEPS, **SIZES[dim])
    assert jr.engine == 'pallas'
    p = jr._pallas
    assert (p.bc_rows if dim == 3 else p.bc_blocks) == (0,)
    assert len(p.bc_instances) == 1
    r, ks, f = _port_kernel_run('regularized', dim)
    wet = wet_map(r.maps)
    fj = np.asarray(jr.f)
    assert np.max(np.abs(state_to_numpy(f)[:, wet] - fj[:, wet])) <= TOL


def _jax_pallas_3d(r):
    grid = jlattice.get_grid('D3Q19')
    jb = JaxStepBuilder(grid, r.maps, visc=r.config.visc,
                        dtype=jnp.float32)
    return PallasStep3D(jb, r.maps.type_map.shape, interpret=True)


def _box_rows(box, dim):
    """The rows of the array's axis 0 that a box covers."""
    a = dim - 1
    return tuple(range(box.lo[a], box.lo[a] + box.ext[a]))


@pytest.mark.parametrize('pair', sorted(BC_PAIRS))
def test_routing_matches_jax_bc_rows(pair):
    """The z-planes the JAX engine hands to its patch kernel are the ones
    the port's varying boxes cover."""
    r = cpu_runner(port_channel(pair, 3), **SIZES[3])
    _mask, instances, _ = ls.classify_nodes(r.maps)
    boxes, reasons = bp.instance_boxes(r.maps, instances)
    assert reasons == []
    rows = sorted({z for b in boxes if b for z in _box_rows(b, 3)})
    assert tuple(rows) == _jax_pallas_3d(r).bc_rows == (0,)


def demotion_sim():
    """A z = 0 inlet of two halves: x < 16 a Zou-He velocity inlet with
    the parabolic profile (varying), x >= 16 a uniform equilibrium
    velocity inlet, which shares the plane (the JAX routing demotes it to
    the patch kernel); a uniform density outlet at the top plane."""
    class Scene(Subdomain3D):
        def boundary_conditions(self, hx, hy, hz):
            walls = (hy == 0) | (hy == self.gy - 1)
            self.set_node(walls, nt.NTFullBBWall)
            inlet = (hz == 0) & ~walls
            u = parabolic_profile(hy, self.gy)
            self.set_node(inlet & (hx < 16),
                          nt.NTZouHeVelocity((0.0, 0.0, u)))
            self.set_node(inlet & (hx >= 16),
                          nt.NTEquilibriumVelocity((0.0, 0.0, 0.02)))
            self.set_node((hz == self.gz - 1) & ~walls,
                          nt.NTRegularizedDensity(1.0))

    class Sim(LBFluidSim):
        subdomain = Scene

    return Sim


def test_demotion_matches_jax_bc_instances():
    """Where the JAX routing sends two instances to its patch kernel (the
    varying one and the uniform one it demotes), the port keeps all three
    in one table, only the varying one with a box, and equals the torch
    engine."""
    r = cpu_runner(demotion_sim(), **SIZES[3])
    jp = _jax_pallas_3d(r)
    assert jp.bc_instances == (
        (nt.NTZouHeVelocity.id, 5), (nt.NTEquilibriumVelocity.id, 5))
    assert jp.bc_rows == (0,)
    ks = ls.KernelStep(r.builder)
    assert sorted((t.type_id, t.orientation) for t in ks.table) == sorted(
        jp.bc_instances + ((nt.NTRegularizedDensity.id, 6),))
    rows = _rows_by_type(ks)
    varying = [t.type_id for t in ks.table if t.box is not None]
    assert varying == [nt.NTZouHeVelocity.id]
    # the box covers the varying half of the plane only
    assert rows[nt.NTZouHeVelocity.id][1].box == bp.Box(
        0, (0, 1, 0), (16, 14, 1))
    assert rows[nt.NTEquilibriumVelocity.id][1].u == (0.0, 0.0, 0.02)
    tm = r.maps.type_map
    for tid, (j, _row) in rows.items():
        assert np.array_equal(ks.mask.numpy() == 3 + j, tm == tid)
    # and the whole step agrees with the torch engine
    step = r.builder.build()
    f = ft = random_feq(r.sim.grid, ks.shape, seed=3, device='cpu')
    f = ks.run(f, 10)
    for _ in range(10):
        ft = step(ft)
    wet = torch.from_numpy(wet_map(r.maps))
    assert float((f - ft)[:, wet].abs().max()) <= TOL


def sparse_face_sim():
    """An x = 0 face whose Zou-He velocity nodes, with a varying profile,
    are the two ends of one diagonal of the face only; the rest of the
    face is a wall."""
    class Scene(Subdomain3D):
        def boundary_conditions(self, hx, hy, hz):
            face = hx == 0
            ends = face & (((hy == 1) & (hz == 1))
                           | ((hy == self.gy - 2) & (hz == self.gz - 2)))
            self.set_node(face & ~ends, nt.NTFullBBWall)
            self.set_node(ends, nt.NTZouHeVelocity((0.001 * hy, 0.0, 0.0)))

    class Sim(LBFluidSim):
        subdomain = Scene

    return Sim


def test_varying_x_normal_face_is_refused():
    """Only when it is sparse: two varying nodes whose bounding box is 10
    x 10 nodes of the face exceed ``MAX_BOX_FACTOR``, and the kernel
    engine refuses by name. (A full x-normal varying face runs:
    ``test_varying_x_normal_face_runs_and_matches``.)"""
    r = cpu_runner(sparse_face_sim(), lat_nx=16, lat_ny=12, lat_nz=12)
    reasons = ls.kernel_ineligibility(r.builder)
    assert len(reasons) == 1
    assert 'NTZouHeVelocity' in reasons[0] and \
        '2 nodes with spatially varying parameters in a bounding box of ' \
        '100' in reasons[0], reasons
    assert 100 > bp.MAX_BOX_FACTOR * 2
    with pytest.raises(NotImplementedError, match='bounding box'):
        ls.KernelStep(r.builder)


def test_varying_x_normal_face_runs_and_matches():
    """An x-normal varying face puts a node on every z-plane and every
    y-row; the kernel engine takes it in the same launch and equals the
    torch engine."""
    r = cpu_runner(channel_sim('zouhe', axis='x', profile='parabolic'),
                   lat_nx=16, lat_ny=12, lat_nz=12, periodic_z=True)
    assert ls.kernel_ineligibility(r.builder) == []
    ks = ls.KernelStep(r.builder)
    j, inlet = _rows_by_type(ks)[nt.NTZouHeVelocity.id]
    assert inlet.box == bp.Box(0, (0, 1, 0), (1, 10, 12))
    assert ks.bcp.numel() == 4 * 120
    step = r.builder.build()
    f = ks.run(r.f, STEPS)
    ft = r.f
    for _ in range(STEPS):
        ft = step(ft)
    wet = torch.from_numpy(wet_map(r.maps))
    assert float((f - ft)[:, wet].abs().max()) <= TOL


def test_parameter_array_beyond_32_bit_offsets_is_refused(monkeypatch):
    """The kernel's parameter block holds a block's offset as an int (an
    8-byte member would slow the kernel): an array too long for it is
    refused by name."""
    r = cpu_runner(port_channel('zouhe', 2), **SIZES[2])
    assert ls.kernel_ineligibility(r.builder) == []
    monkeypatch.setattr(bp, 'MAX_PARAM_FLOATS', 100)
    reasons = ls.kernel_ineligibility(r.builder)
    assert reasons == ['186 per-node BC parameters (the kernel indexes at '
                       'most 100)']


def _holey(pair, dim, axis):
    sim = with_patch_row_mix(with_keep_block(port_channel(pair, dim, axis)),
                             axis)
    return cpu_runner(sim, **AXIS_SIZES[dim, axis])


@pytest.mark.parametrize('dim,axis', sorted(AXIS_SIZES))
def test_parameter_array_layout_and_offsets(dim, axis):
    """The blocks lie end to end in instance order, each [rho, u_x,
    u_y(, u_z)] component-major over its box with x fastest: the index
    the kernel computes for a node finds the node's own parameters."""
    r = _holey('zouhe', dim, axis)
    maps = r.maps
    _mask, instances, _ = ls.classify_nodes(maps)
    boxes, reasons = bp.instance_boxes(maps, instances)
    assert reasons == []
    bcp = bp.param_array(maps, boxes)
    assert bcp.dtype == np.float32 and bcp.ndim == 1
    offset = 0
    varying = 0
    for (tid, _k, sel), box in zip(instances, boxes):
        if box is None:
            assert not bp.varying_params(maps, tid, sel)
            continue
        varying += 1
        assert box.offset == offset
        vol = int(np.prod(box.ext))
        offset += (1 + dim) * vol
        assert vol <= bp.MAX_BOX_FACTOR * int(sel.sum())
        idx = np.nonzero(sel)            # array axes ((z, )y, x)
        x, y = idx[-1], idx[-2]
        z = idx[0] if dim == 3 else np.zeros_like(x)
        for c, (lo, ext) in zip((x, y, z), zip(box.lo, box.ext)):
            assert lo == c.min() and ext == c.max() - c.min() + 1
        at = box.offset + ((z - box.lo[2]) * box.ext[1]
                           + (y - box.lo[1])) * box.ext[0] + (x - box.lo[0])
        np.testing.assert_array_equal(
            bcp[at], maps.param_rho[sel].astype(np.float32))
        for a in range(dim):
            np.testing.assert_array_equal(
                bcp[at + (1 + a) * vol],
                maps.param_vel[a][sel].astype(np.float32))
    assert varying >= 1 and bcp.size == offset
    # nothing varying: one zero, so the array still has an address
    assert bp.param_array(maps, [None] * len(boxes)).tolist() == [0.0]


@pytest.mark.parametrize('dim,axis', sorted(AXIS_SIZES))
@pytest.mark.parametrize('pair', sorted(BC_PAIRS))
def test_face_with_holes_matches_torch_engine(pair, dim, axis):
    """The inlet face thinned (fluid and excluded nodes in it) and a block
    of excluded nodes in the bulk: every mask code, boxes with nodes of
    other kinds inside them; 10 steps from a random state."""
    r = _holey(pair, dim, axis)
    ks = ls.KernelStep(r.builder)
    codes = sorted(np.unique(ks.mask.numpy()))
    assert codes[:4] == [0, 1, 2, 3] and ks.vary
    step = r.builder.build()
    f = ft = random_feq(r.sim.grid, ks.shape, seed=5, device='cpu')
    f = ks.run(f, 10)
    for _ in range(10):
        ft = step(ft)
    wet = torch.from_numpy(wet_map(r.maps))
    assert float((f - ft)[:, wet].abs().max()) <= TOL
