"""Single-fluid body forces of the port on the CPU: the torch engine and the
kernel engine's plain version against the JAX package.

* ``ops/collide.edm_shift`` and ``guo_force_terms`` against the JAX
  functions on seeded fields (1e-6).
* The torch ``StepBuilder`` with a force against the JAX XLA engine's
  ``StepBuilder`` on the same node maps, state and force: the three force
  models, a constant vector and a per-node field, on sphere_3d 32x16x16,
  cylinder 64x32 and poiseuille_3d 16^3, 20 steps, wet-node max |df| <=
  1e-6, and ``macro_fields`` (the force-corrected velocity) <= 1e-6.
* Forced minus unforced after 20 steps against the JAX difference, 1e-3
  of the largest difference: a sign error or a missing density factor is
  of the size of the difference itself.
* ``step_reference`` (the kernel's plain version) with a force against the
  torch engine's step (1e-6), and for Guo on sphere_3d against the JAX
  Pallas engine in interpret mode (1e-5,
  tests/test_sharded_pallas.py:31).
* A force-driven plane channel run to its steady state on the torch engine
  gives the analytic parabola for each force model (after
  tests/test_physics.py:262-272).
* A ``DynamicValue`` force and, on the kernel engine, a per-node force
  raise and name the reason; a forced scene never changes engine silently.

The forced channels with native-BC faces are in
tests/test_torch_forcing_channels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu import lattice as jlattice
from sailfish_tpu.controller import \
    LBSimulationController as JaxController
from sailfish_tpu.ops import collide as jco
from sailfish_tpu.ops.step import StepBuilder as JaxStepBuilder
from sailfish_tpu_torch import lattice
from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.ops import collide as tco
from sailfish_tpu_torch.ops import lbm_step as ls
from sailfish_tpu_torch.ops.step import FORCE_MODELS, StepBuilder
from sailfish_tpu_torch.state import state_to_numpy
from sailfish_tpu_torch.subdomain import Subdomain2D
from torch_scenes import (SINGLE_GOLDEN_FLAGS, cpu_runner, forced,
                          load_example, run, twin, wet_map)

torch.set_num_threads(1)

STEPS = 20
TOL = 1e-6
SCENES = ('sphere_3d', 'cylinder', 'poiseuille_3d')


def seeded_fields(dim, seed, shape=None):
    """rho (1 +- 0.01), u (0.02 rms) and a per-node acceleration (1e-5
    rms) on a small domain, float32, drawn with numpy from ``seed``."""
    shape = shape or ((6, 7, 8) if dim == 3 else (9, 10))
    rng = np.random.default_rng(seed)
    rho = (1.0 + 0.01 * rng.standard_normal(shape)).astype(np.float32)
    u = (0.02 * rng.standard_normal((dim,) + shape)).astype(np.float32)
    accel = (1e-5 * rng.standard_normal((dim,) + shape)).astype(np.float32)
    return rho, u, accel


def force_of(kind, dim, shape, seed=3):
    """A constant acceleration with every component set, or a per-node
    field of the same size, float64."""
    vec = np.array([1e-5, -4e-6, 2.5e-6][:dim])
    if kind == 'vector':
        return vec
    rng = np.random.default_rng(seed)
    return vec.reshape((dim,) + (1,) * len(shape)) \
        * (1.0 + 0.5 * rng.standard_normal((dim,) + tuple(shape)))


@pytest.mark.parametrize('kind', ['vector', 'field'])
@pytest.mark.parametrize('dim', [2, 3])
def test_force_terms_match_jax(dim, kind):
    name = 'D2Q9' if dim == 2 else 'D3Q19'
    g, jg = lattice.get_grid(name), jlattice.get_grid(name)
    rho, u, accel = seeded_fields(dim, seed=dim)
    if kind == 'vector':
        accel = accel[(slice(None),) + (slice(0, 1),) * dim]
    tau_inv = 1.0 / 0.8
    guo = tco.guo_force_terms(g, torch.from_numpy(u),
                              torch.from_numpy(accel), tau_inv,
                              torch.from_numpy(rho))
    jguo = jco.guo_force_terms(jg, jnp.asarray(u), jnp.asarray(accel),
                               tau_inv, jnp.asarray(rho))
    edm = tco.edm_shift(g, torch.from_numpy(rho), torch.from_numpy(u),
                        torch.from_numpy(accel))
    jedm = jco.edm_shift(jg, jnp.asarray(rho), jnp.asarray(u),
                         jnp.asarray(accel))
    assert guo.shape == edm.shape == (g.Q,) + rho.shape
    assert np.max(np.abs(guo.numpy() - np.asarray(jguo))) <= TOL
    assert np.max(np.abs(edm.numpy() - np.asarray(jedm))) <= TOL
    # the terms are of the force's size, so the comparison is not trivial
    assert float(guo.abs().max()) > 1e-7 and float(edm.abs().max()) > 1e-7


def both_builders(scene, model, force, **extra):
    """(port runner without steps, its StepBuilder with ``force``, the JAX
    StepBuilder on the same maps with the same force)."""
    r = cpu_runner(twin(scene), **SINGLE_GOLDEN_FLAGS[scene], **extra)
    tb = StepBuilder(r.sim.grid, r.maps, visc=r.config.visc,
                     body_force=force, force_model=model)
    jb = JaxStepBuilder(r.sim.grid, r.maps, visc=r.config.visc,
                        dtype=jnp.float32, body_force=force,
                        force_model=model)
    return r, tb, jb


def run_both(r, tb, jb, steps=STEPS):
    """(port state, JAX state) as numpy after ``steps`` steps from the
    runner's initial state."""
    jstep = jax.jit(jb.build())
    step = tb.build()
    ft, fj = r.f, jnp.asarray(state_to_numpy(r.f))
    for _ in range(steps):
        ft, fj = step(ft), jstep(fj)
    return state_to_numpy(ft), np.asarray(fj)


@pytest.mark.parametrize('kind', ['vector', 'field'])
@pytest.mark.parametrize('model', FORCE_MODELS)
@pytest.mark.parametrize('scene', SCENES)
def test_forced_step_matches_jax_xla_engine(scene, model, kind):
    r0 = cpu_runner(twin(scene), **SINGLE_GOLDEN_FLAGS[scene])
    force = force_of(kind, r0.sim.grid.dim, r0.maps.type_map.shape)
    r, tb, jb = both_builders(scene, model, force)
    ft, fj = run_both(r, tb, jb)
    wet = wet_map(r.maps)
    assert np.max(np.abs(ft[:, wet] - fj[:, wet])) <= TOL

    rho_j, u_j = jax.jit(jb.macro_fields)(jnp.asarray(fj))
    rho_t, u_t = tb.macro_fields(torch.from_numpy(fj.copy()))
    assert np.max(np.abs(rho_t.numpy()[wet] - np.asarray(rho_j)[wet])) \
        <= TOL
    assert np.max(np.abs(u_t.numpy()[:, wet] - np.asarray(u_j)[:, wet])) \
        <= TOL
    # every model's output velocity carries the half-force correction
    _, u_bare = StepBuilder(r.sim.grid, r.maps, visc=r.config.visc) \
        .macro_fields(torch.from_numpy(fj.copy()))
    half = 0.5 * torch.as_tensor(np.broadcast_to(
        tb.force.numpy(), u_bare.shape).copy())
    assert float((u_t - u_bare - half)[:, torch.from_numpy(wet)]
                 .abs().max()) <= 1e-9


@pytest.mark.parametrize('model', FORCE_MODELS)
@pytest.mark.parametrize('scene', ['sphere_3d', 'cylinder'])
def test_force_effect_matches_jax(scene, model):
    """What the force adds (forced minus unforced state) against the same
    difference of the JAX engine: within 1e-3 of its largest entry. Each
    fp32 engine's own rounding is ~1e-7 in f after 20 steps, so the force
    is ten times the scenes' (the difference ~7e-4) and the viscosity 0.1
    (the scenes' 0.01 amplifies rounding)."""
    r0 = cpu_runner(twin(scene), **SINGLE_GOLDEN_FLAGS[scene])
    force = 10.0 * force_of('vector', r0.sim.grid.dim,
                            r0.maps.type_map.shape)
    forced_t, forced_j = run_both(
        *both_builders(scene, model, force, visc=0.1))
    bare_t, bare_j = run_both(*both_builders(scene, model, None, visc=0.1))
    wet = wet_map(r0.maps)
    dt = (forced_t - bare_t)[:, wet]
    dj = (forced_j - bare_j)[:, wet]
    scale = np.max(np.abs(dj))
    assert scale > 1e-4
    assert np.max(np.abs(dt - dj)) <= 1e-3 * scale


def kernel_inputs(r):
    mask_np, instances, reasons = ls.classify_nodes(r.maps)
    assert reasons == []
    return (torch.from_numpy(mask_np), ls.bc_table(r.maps, instances),
            (mask_np == 0) | (mask_np >= 3))


@pytest.mark.parametrize('model', FORCE_MODELS)
@pytest.mark.parametrize('scene', SCENES)
def test_step_reference_with_force_matches_torch_engine(scene, model):
    """The kernel's plain version takes the force as (vector, model) and
    runs the torch engine's own collision: 20 steps through the scene's
    runner, wet-node max |df| <= 1e-6, and the state moves with the
    force."""
    r = cpu_runner(twin(scene), force_implementation=model,
                   **SINGLE_GOLDEN_FLAGS[scene])
    assert r.builder.force is not None and r.builder.force_model == model
    assert ls.kernel_ineligibility(r.builder) == []
    mask, table, wet = kernel_inputs(r)
    force = tuple(float(a) for a in r.builder.body_force)
    step = r.builder.build()
    f = ft = fu = r.f
    for _ in range(STEPS):
        f = ls.step_reference(f, mask, table, r.sim.grid,
                              r.builder.tau_inv, force=force,
                              force_model=model)
        fu = ls.step_reference(fu, mask, table, r.sim.grid,
                               r.builder.tau_inv)
        ft = step(ft)
    wet = torch.from_numpy(wet)
    assert float((f - ft)[:, wet].abs().max()) <= TOL
    assert float((f - fu)[:, wet].abs().max()) > 1e-6


def test_step_reference_with_guo_force_matches_jax_pallas_engine():
    """``step_reference`` with the Guo force against the JAX Pallas engine
    in interpret mode, whose fused kernel applies the force itself
    (``pallas_step.py:_moments``, ``_force_term``): sphere_3d 32x16x16, 8
    steps, wet-node max |df| <= 1e-5."""
    cfg = SINGLE_GOLDEN_FLAGS['sphere_3d']
    jax_sim = load_example('sphere_3d.py', 'jax_sphere_3d').SphereSimulation
    jc = JaxController(jax_sim, default_config=dict(
        max_iters=8, every=8, quiet=True, engine='pallas', platform='cpu',
        **cfg))
    jc.run(ignore_cmdline=True)
    assert jc._runner.engine == 'pallas'
    r = cpu_runner(twin('sphere_3d'), **cfg)
    mask, table, wet = kernel_inputs(r)
    f = r.f
    for _ in range(8):
        f = ls.step_reference(f, mask, table, r.sim.grid,
                              r.builder.tau_inv,
                              force=tuple(r.builder.body_force),
                              force_model='guo')
    fj = np.asarray(jc._runner.f)
    assert np.max(np.abs(state_to_numpy(f)[:, wet] - fj[:, wet])) <= 1e-5


@pytest.mark.parametrize('model', FORCE_MODELS)
def test_kernel_step_on_cpu_runs_the_forced_plain_version(model):
    r = cpu_runner(twin('cylinder'), lat_nx=32, lat_ny=16,
                   force_implementation=model)
    ks = ls.KernelStep(r.builder)
    assert ks.force == (1e-5, 0.0) and ks.force_model == model
    assert ks.name == 'lbm_step_force_d2q9' and ks.entry == 'lbm_step_d2q9'
    step = r.builder.build()
    ref = r.f
    for _ in range(5):
        ref = step(ref)
    assert torch.equal(ks.run(r.f, 5), ref)
    assert ks.launches == 0 and ls.LAUNCHES[ks.name] == 0


class _PlaneChannel(Subdomain2D):
    """Bounce-back walls at y = 0 and y = gy - 1, periodic along x."""

    def boundary_conditions(self, hx, hy):
        self.set_node((hy == 0) | (hy == self.gy - 1), nt.NTFullBBWall)

    def initial_conditions(self, sim, hx, hy):
        sim.rho[:] = 1.0


class _PlaneSim(LBFluidSim):
    subdomain = _PlaneChannel


@pytest.mark.parametrize('model', FORCE_MODELS)
def test_poiseuille_steady_state(model):
    """A plane channel driven by a constant acceleration along x reaches
    the analytic parabola u(y) = a / (2 nu) (y - 1/2)(ny - 3/2 - y)
    between full bounce-back walls (which sit half a node inside) for
    every force model: 2,500 steps at ny = 18 (e-folding time H^2 /
    (pi^2 nu) = 260 steps), max error below 5e-3 of the peak. A wrong
    sign, a missing density or a missing half-force correction is an
    error of order one."""
    ny, visc, accel = 18, 0.1, 1e-6
    r = run(forced(_PlaneSim, (accel, 0.0)), platform='cpu', lat_nx=4,
            lat_ny=ny, visc=visc, periodic_x=True, max_iters=2500,
            every=2500, force_implementation=model)
    assert r.engine == 'torch'
    r._fields_to_host()
    y = np.arange(ny)
    ref = accel / (2.0 * visc) * (y - 0.5) * (ny - 1.5 - y)
    prof = r.sim.vx[:, 1]
    fluid = (y > 0) & (y < ny - 1)
    err = np.max(np.abs(prof[fluid] - ref[fluid])) / ref.max()
    print(model, 'max profile error / peak =', err)
    assert err < 5e-3, (model, err)
    # across the channel only fp32 rounding moves
    assert np.max(np.abs(r.sim.vy[fluid])) < 1e-3 * ref.max()


def test_dynamic_force_raises():
    """A DynamicValue force of space runs on the torch engine; the kernel
    engine takes one acceleration per step and names it."""
    sim = forced(twin('ldc_2d'),
                 nt.DynamicValue(lambda t, hx, hy: 1e-6 * hy, 0.0))
    r = cpu_runner(sim, lat_nx=8, lat_ny=8)
    assert r.engine == 'torch' and r.builder.force_at(3).shape == (2, 8, 8)
    with pytest.raises(NotImplementedError,
                       match='space-dependent DynamicValue body force'):
        ls.KernelStep(r.builder)


def test_per_node_force_is_refused_by_the_kernel_engine_by_name():
    """four_rolls_mill's per-node force runs on the torch engine; the
    kernel engine names it instead of dropping to another engine."""
    r = cpu_runner(twin('four_rolls_mill'), lat_nx=16, lat_ny=16)
    assert r.engine == 'torch' and r.builder.force.shape == (2, 16, 16)
    assert ls.kernel_ineligibility(r.builder) == [
        'space-varying body force (the kernel takes one constant '
        'acceleration; --engine=torch runs a per-node field)']
    with pytest.raises(NotImplementedError,
                       match='cannot run this scene: space-varying body '
                             'force'):
        ls.KernelStep(r.builder)


def test_force_shape_is_checked():
    r = cpu_runner(twin('ldc_2d'), lat_nx=8, lat_ny=8)
    with pytest.raises(ValueError, match='body force needs shape'):
        StepBuilder(r.sim.grid, r.maps, visc=0.1,
                    body_force=np.array([1e-5, 0.0, 0.0]))
