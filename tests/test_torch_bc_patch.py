"""The patch-row kernel's Python side (``ops/bc_patch.py``): routing and
``bc_patch_reference``, the plain PyTorch version of ``csrc/bc_patch.cu``.

* ``bc_patch_reference`` against the JAX Pallas patch kernels
  (``make_bc_patch_kernel_3d`` / ``_2d``) run in interpret mode, on the
  patch rows of parabolic-inlet channels (32x16x16, 64^2) from a seeded
  random state: max |df| <= 1e-6.
* ``KernelStep`` on the CPU (``step_reference`` + ``bc_patch_reference``)
  against the JAX XLA engine for 20 steps, for the three native BC pairs in
  3D and 2D (wet-node max |df| <= 1e-6), and against the JAX Pallas engine
  in interpret mode, which takes the patch-kernel route there (1e-6).
* The routing against ``PallasStep3D``'s (``bc_rows``, and
  ``bc_instances`` in a demotion case), and the refusal of a varying face
  that covers more than a quarter of the z-planes.

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
                          cpu_runner, parabolic_profile, random_feq, wet_map)

torch.set_num_threads(1)

TOL = 1e-6
STEPS = 20
SIZES = {3: dict(lat_nx=32, lat_ny=16, lat_nz=16, periodic_x=True),
         2: dict(lat_nx=64, lat_ny=64)}

JAX_PAIRS = {
    'equilibrium': (jnt.NTEquilibriumVelocity, jnt.NTEquilibriumDensity),
    'zouhe': (jnt.NTZouHeVelocity, jnt.NTZouHeDensity),
    'regularized': (jnt.NTRegularizedVelocity, jnt.NTRegularizedDensity),
}


def port_channel(pair, dim):
    return (channel_sim(pair, profile='parabolic') if dim == 3
            else channel_sim_2d(pair))


def jax_channel(pair, dim):
    """The JAX twin of ``port_channel``: the same walls, parabolic inlet,
    density outlet and initial state on the JAX package's classes."""
    vel_cls, den_cls = JAX_PAIRS[pair]
    if dim == 3:
        class Channel(JaxSubdomain3D):
            def boundary_conditions(self, hx, hy, hz):
                walls = (hy == 0) | (hy == self.gy - 1)
                self.set_node(walls, jnt.NTFullBBWall)
                u = parabolic_profile(hy, self.gy)
                self.set_node((hz == 0) & ~walls, vel_cls((0.0, 0.0, u)))
                self.set_node((hz == self.gz - 1) & ~walls, den_cls(1.0))

            def initial_conditions(self, sim, hx, hy, hz):
                sim.rho[:] = 1.0
                sim.vz[:] = 0.01
    else:
        class Channel(JaxSubdomain2D):
            def boundary_conditions(self, hx, hy):
                walls = (hx == 0) | (hx == self.gx - 1)
                self.set_node(walls, jnt.NTFullBBWall)
                u = parabolic_profile(hx, self.gx)
                self.set_node((hy == 0) & ~walls, vel_cls((0.0, u)))
                self.set_node((hy == self.gy - 1) & ~walls, den_cls(1.0))

            def initial_conditions(self, sim, hx, hy):
                sim.rho[:] = 1.0
                sim.vy[:] = 0.01

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


@pytest.mark.parametrize('dim', [3, 2])
@pytest.mark.parametrize('pair', sorted(BC_PAIRS))
def test_routing_of_the_parabolic_channel(pair, dim):
    """The varying inlet goes to the patch kernel on row 0 (the z = 0
    plane, the y = 0 row); the uniform outlet stays in the BC table; the
    inlet's nodes keep (code 2) in the main kernel's mask."""
    r = cpu_runner(port_channel(pair, dim), **SIZES[dim])
    ks = ls.KernelStep(r.builder)
    vel_cls, den_cls = BC_PAIRS[pair]
    assert ks.patch.rows.tolist() == [0]
    assert [(t.type_id, t.orientation) for t in ks.patch.table] == \
        [(vel_cls.id, 2 * dim - 1)]
    assert [(t.type_id, t.orientation) for t in ks.table] == \
        [(den_cls.id, 2 * dim)]
    tm = r.maps.type_map
    assert np.all(ks.mask.numpy()[tm == vel_cls.id] == 2)
    assert np.all(ks.mask.numpy()[tm == den_cls.id] == 3)
    mrow = ks.patch.mask_rows.numpy()[0]
    assert np.array_equal(mrow == 3, tm[0] == vel_cls.id)
    assert np.array_equal(mrow == 1, tm[0] == nt.NTFullBBWall.id)
    bcp = ks.patch.bcp.numpy()
    assert bcp.shape == (1 + dim, 1) + tm.shape[1:]
    np.testing.assert_array_equal(bcp[dim][0][tm[0] == vel_cls.id],
                                  r.maps.param_vel[dim - 1][0][
                                      tm[0] == vel_cls.id].astype(
                                          np.float32))


def _patch_inputs(pair, dim, seed):
    """(port runner, KernelStep, random fp32 state) of the channel."""
    r = cpu_runner(port_channel(pair, dim), **SIZES[dim])
    ks = ls.KernelStep(r.builder)
    f = random_feq(r.sim.grid, ks.shape, seed=seed, device='cpu')
    return r, ks, f


@pytest.mark.parametrize('pair', sorted(BC_PAIRS))
def test_patch_reference_matches_jax_kernel_3d(pair):
    r, ks, f = _patch_inputs(pair, 3, seed=11)
    grid = jlattice.get_grid('D3Q19')
    jb = JaxStepBuilder(grid, r.maps, visc=r.config.visc,
                        dtype=jnp.float32)
    Z, Y, X = ks.shape
    rows = ks.patch.rows.numpy()
    insts = tuple((t.type_id, t.orientation) for t in ks.patch.table)
    kern = make_bc_patch_kernel_3d(jb, Z, len(rows), Y, X, insts,
                                   interpret=True)
    perm, inv, _ = cz_groups(grid)
    out = np.asarray(kern(jnp.asarray(f.numpy()[perm]),
                          jnp.asarray(ks.patch.mask_rows.numpy(),
                                      dtype=jnp.int32),
                          jnp.asarray(ks.patch.bcp.numpy()),
                          jnp.asarray(rows)))
    ref = ks.patch.reference(f).numpy()
    assert ref.shape == (19, len(rows), Y, X)
    assert np.max(np.abs(ref - out[inv])) <= TOL


@pytest.mark.parametrize('pair', sorted(BC_PAIRS))
def test_patch_reference_matches_jax_kernel_2d(pair):
    """The 2D TPU kernel works on y-blocks of ``by`` rows: the port's
    patch rows are set to the block's rows, and the block is compared."""
    r, ks, f = _patch_inputs(pair, 2, seed=12)
    grid = jlattice.get_grid('D2Q9')
    jb = JaxStepBuilder(grid, r.maps, visc=r.config.visc,
                        dtype=jnp.float32)
    Y, X = ks.shape
    by = 8
    insts = tuple((t.type_id, t.orientation) for t in ks.patch.table)
    kern = make_bc_patch_kernel_2d(jb, Y, X, by, (0,), insts,
                                   interpret=True)
    route = bp.route(r.maps, *ls.classify_nodes(r.maps)[:2])
    rows = np.arange(by)
    mask_rows = route.mask_rows
    assert mask_rows.shape == (1, X)
    block_mask = np.concatenate([mask_rows, route.mask[1:by]])
    bcp = bp.param_planes(r.maps, rows, 2)
    out = np.asarray(kern(jnp.asarray(f.numpy()),
                          jnp.asarray(block_mask[None], dtype=jnp.int32),
                          jnp.asarray(bcp[:, None])))
    ref = bp.bc_patch_reference(
        f, torch.from_numpy(rows), torch.from_numpy(block_mask),
        torch.from_numpy(bcp), ks.patch.table, r.sim.grid,
        r.builder.tau_inv).numpy()
    assert ref.shape == (9, by, X)
    assert np.max(np.abs(ref - out[:, 0])) <= TOL


def _port_kernel_run(pair, dim, steps=STEPS):
    r = cpu_runner(port_channel(pair, dim), **SIZES[dim])
    ks = ls.KernelStep(r.builder)
    assert ks.patch is not None
    return r, ks, ks.run(r.f, steps)


@pytest.mark.parametrize('dim', [3, 2])
@pytest.mark.parametrize('pair', sorted(BC_PAIRS))
def test_kernel_step_matches_jax_xla_engine(pair, dim):
    jr = run_jax(jax_channel(pair, dim), engine='xla', max_iters=STEPS,
                 every=STEPS, **SIZES[dim])
    assert jr.engine == 'xla'
    r, ks, f = _port_kernel_run(pair, dim)
    wet = wet_map(r.maps)
    fj = np.asarray(jr.f)
    assert np.max(np.abs(state_to_numpy(f)[:, wet] - fj[:, wet])) <= TOL
    assert ks.launches == 0 and ks.patch.launches == 0   # CPU: plain only


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


@pytest.mark.parametrize('pair', sorted(BC_PAIRS))
def test_routing_matches_jax_bc_rows(pair):
    r = cpu_runner(port_channel(pair, 3), **SIZES[3])
    route = bp.route(r.maps, *ls.classify_nodes(r.maps)[:2])
    assert tuple(route.rows) == _jax_pallas_3d(r).bc_rows == (0,)


def demotion_sim():
    """A z = 0 inlet of two halves: x < 16 a Zou-He velocity inlet with
    the parabolic profile (varying), x >= 16 a uniform equilibrium
    velocity inlet, which shares the plane and is demoted; a uniform
    density outlet at the top plane stays in the BC table."""
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
    r = cpu_runner(demotion_sim(), **SIZES[3])
    mask, instances, _ = ls.classify_nodes(r.maps)
    route = bp.route(r.maps, mask, instances)
    jp = _jax_pallas_3d(r)
    ours = tuple((instances[j][0], instances[j][1]) for j in route.patch)
    # the varying instance first, then the demoted one
    assert ours == jp.bc_instances == (
        (nt.NTZouHeVelocity.id, 5), (nt.NTEquilibriumVelocity.id, 5))
    assert len(route.patch) == 2 and len(route.uniform) == 1
    assert tuple(route.rows) == jp.bc_rows == (0,)
    # the demoted instance is patch code 3 + its position in route.patch
    ks = ls.KernelStep(r.builder)
    tm = r.maps.type_map[0]
    mrow = ks.patch.mask_rows.numpy()[0]
    for p, j in enumerate(route.patch):
        assert np.all(mrow[tm == instances[j][0]] == 3 + p)
    assert [t.type_id for t in ks.table] == [nt.NTRegularizedDensity.id]
    # and the whole step agrees with the torch engine
    step = r.builder.build()
    f = ft = random_feq(r.sim.grid, ks.shape, seed=3, device='cpu')
    f = ks.run(f, 10)
    for _ in range(10):
        ft = step(ft)
    wet = torch.from_numpy(wet_map(r.maps))
    assert float((f - ft)[:, wet].abs().max()) <= TOL


def test_varying_x_normal_face_is_refused():
    """An x-normal varying face puts a node on every z-plane: more than
    MAX_PATCH_FRACTION of Z, so the kernel engine refuses, naming it."""
    r = cpu_runner(channel_sim('zouhe', axis='x', profile='parabolic'),
                   lat_nx=16, lat_ny=12, lat_nz=12, periodic_z=True)
    reasons = ls.kernel_ineligibility(r.builder)
    assert any('12/12 z-planes' in why and 'spatially varying' in why
               for why in reasons), reasons
    with pytest.raises(NotImplementedError, match='z-planes'):
        ls.KernelStep(r.builder)
