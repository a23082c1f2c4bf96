"""Time-dependent parameters on the CPU: ``DynamicValue`` BC parameters and
body forces, and the iteration that reaches the step.

* Analogues of the five tests of tests/test_dynamic.py on the port (the
  pulsed cavity, a time series, a space-dependent lid, the time unit, the
  SpatialArray inlet), each held against the JAX XLA engine's run of the
  same scene.
* The runner hands each step its iteration: a chunked run equals one step
  at a time from ``it0``; a checkpoint restart at iteration N continues
  with t = N; ``--dt_per_lattice_time_unit`` scales t.
* The torch ``StepBuilder`` against the JAX XLA engine from a nonzero
  iteration, where the value has moved: time-only densities (womersley),
  a space- and time-dependent inlet (poiseuille_sa) and a time-only force
  (poiseuille_pulsatile --drive=force); 20 steps, wet-node max |df| <=
  1e-6.
* ``step_reference`` with the values ``KernelStep`` writes before each
  launch (time-only rows, a rewritten block of the parameter array, a
  time-only force) against the torch engine's step.

The callables of a scene run through both packages use ``xsin``, which
calls torch on a tensor and jax.numpy on a tracer; where a twin's
callables are torch's, the JAX side gets JAX callables of the same
values.
"""

import copy
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu import node_type as jnt
from sailfish_tpu.controller import \
    LBSimulationController as JaxController
from sailfish_tpu.ops.step import StepBuilder as JaxStepBuilder
from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.ops import lbm_step as ls
from sailfish_tpu_torch.state import state_to_numpy
from sailfish_tpu_torch.subdomain import Subdomain2D
from torch_scenes import (cpu_runner, load_example, random_feq, run, twin,
                          time_series_density_sim, wet_map)

torch.set_num_threads(1)

TOL = 1e-6
STEPS = 20


def xsin(x):
    return torch.sin(x) if isinstance(x, torch.Tensor) else jnp.sin(x)


# -- tests/test_dynamic.py analogues ----------------------------------------

def _cavity_sim(value, profile=False, sub=Subdomain2D, sim_base=LBFluidSim,
                types=nt):
    """The pulsed cavity of tests/test_dynamic.py (32^2, a lid of
    ``value``); ``profile``: the parabolic lid of
    test_space_dependent_dynamic instead. ``sub``, ``sim_base`` and
    ``types`` pick the package."""
    N = 32

    class Cav(sub):
        def boundary_conditions(self, hx, hy):
            wall = (hx == 0) | (hx == self.gx - 1) | (hy == 0)
            lid = value
            if profile:
                lid = types.DynamicValue(
                    lambda t, hx, hy: 0.1 * (hx / N) * (1.0 - hx / N) * 4.0,
                    0.0)
            self.set_node((hy == self.gy - 1) & ~wall,
                          types.NTEquilibriumVelocity(lid))
            self.set_node(wall, types.NTFullBBWall)

        def initial_conditions(self, sim, hx, hy):
            sim.rho[:] = 1.0

    class Sim(sim_base):
        subdomain = Cav

        def after_step(self, runner):
            runner._fields_to_host()
            vx = runner.sim.vx
            self.lid.append(float(vx[-1, vx.shape[1] // 2]))

    Sim.lid = []
    return Sim


def _cavity_runs(value_port, value_jax, iters, profile=False, **extra):
    """(port lid series, JAX lid series, port runner, JAX runner): the
    pulsed cavity through each package's controller, the lid velocity
    recorded after every chunk of iters / 4 steps."""
    from sailfish_tpu.models.single import LBFluidSim as JaxFluidSim
    from sailfish_tpu.subdomain import Subdomain2D as JaxSubdomain2D
    cfg = dict(lat_nx=32, lat_ny=32, visc=0.1, max_iters=iters,
               every=iters // 4, quiet=True, **extra)
    port = _cavity_sim(value_port, profile)
    r = run(port, platform='cpu', **{k: v for k, v in cfg.items()
                                     if k != 'quiet'})
    jsim = _cavity_sim(value_jax, profile, JaxSubdomain2D, JaxFluidSim, jnt)
    c = JaxController(jsim, default_config=dict(platform='cpu', **cfg))
    c.run(ignore_cmdline=True)
    return np.array(port.lid), np.array(jsim.lid), r, c._runner


def _same_lid(lid, jlid, r, jr):
    assert lid.shape == jlid.shape and np.max(np.abs(lid - jlid)) <= TOL
    wet = wet_map(r.maps)
    f, fj = state_to_numpy(r.f), np.asarray(jr.f)
    assert np.max(np.abs(f[:, wet] - fj[:, wet])) <= TOL


def test_dynamic_velocity_oscillates():
    om = 2 * np.pi / 200.0
    value = (lambda t: 0.05 * xsin(om * t), 0.0)
    lid, jlid, r, jr = _cavity_runs(nt.DynamicValue(*value),
                                    jnt.DynamicValue(*value), 200)
    assert np.all(np.isfinite(lid))
    # the lid follows the prescribed oscillation: its sign changes
    assert lid.max() > 0.01 and lid.min() < -0.01, lid
    _same_lid(lid, jlid, r, jr)


def test_time_series_param():
    data = [0.0, 0.05, 0.0, -0.05]
    series = nt.LinearlyInterpolatedTimeSeries(data, step_size=25)
    jseries = jnt.LinearlyInterpolatedTimeSeries(data, step_size=25)
    lid, jlid, r, jr = _cavity_runs(
        nt.DynamicValue(series.exprs[0], 0.0),
        jnt.DynamicValue(jseries.exprs[0], 0.0), 100)
    assert np.all(np.isfinite(lid))
    assert lid.max() > 0.01
    _same_lid(lid, jlid, r, jr)


def test_space_dependent_dynamic():
    """fn(t, hx, hy): a parabolic lid profile."""
    lid, jlid, r, jr = _cavity_runs(None, None, 100, profile=True)
    r._fields_to_host()
    vx = r.sim.vx
    N = 32
    assert vx[-1, N // 2] > vx[-1, 3] > 0
    assert vx[-1, N // 2] == pytest.approx(0.1, rel=0.1)
    _same_lid(lid, jlid, r, jr)


def test_dt_per_lattice_time_unit_scales_t():
    """Halving dt while doubling the callable's frequency reproduces the
    baseline bitwise; with the callable fixed the flag changes the flow
    (and matches the JAX run with the same flag)."""
    om = 2 * np.pi / 100.0

    def lid(freq, dt=1.0):
        sim = _cavity_sim(nt.DynamicValue(
            lambda t: 0.05 * xsin(freq * t), 0.0))
        run(sim, platform='cpu', lat_nx=32, lat_ny=32, visc=0.1,
            max_iters=100, every=25, dt_per_lattice_time_unit=dt)
        return np.array(sim.lid)

    base = lid(om)
    scaled = lid(2.0 * om, dt=0.5)
    assert np.array_equal(base, scaled), (base, scaled)
    other = lid(2.0 * om)
    assert not np.allclose(base, other)
    value = (lambda t: 0.05 * xsin(2.0 * om * t), 0.0)
    lid_p, jlid, r, jr = _cavity_runs(nt.DynamicValue(*value),
                                      jnt.DynamicValue(*value), 100,
                                      dt_per_lattice_time_unit=0.5)
    assert np.array_equal(lid_p, scaled)
    _same_lid(lid_p, jlid, r, jr)


def test_spatial_array_matches_equation():
    """SpatialArray * time ramp gives the flow of the inline callable
    (poiseuille_sa twin, both modes), and the twin's SpatialArray run
    equals the JAX example's."""
    cfg = dict(lat_nx=48, lat_ny=32, visc=0.1, max_iters=300, every=300)

    def vx(mode):
        r = run(twin('poiseuille_sa'), platform='cpu', velocity=mode, **cfg)
        r._fields_to_host()
        return np.array(r.sim.vx), r

    vx_eq, _ = vx('equation')
    vx_sa, r = vx('spatial_array')
    assert np.all(np.isfinite(vx_sa))
    assert vx_sa.max() > 1e-4          # the ramp has begun
    np.testing.assert_allclose(vx_sa, vx_eq, rtol=2e-3, atol=5e-6)
    jsim = load_example('poiseuille_sa.py', 'jax_poiseuille_sa')
    c = JaxController(jsim.RampedPoiseuilleSim, default_config=dict(
        platform='cpu', quiet=True, velocity='spatial_array', **cfg))
    c.run(ignore_cmdline=True)
    wet = wet_map(r.maps)
    f, fj = state_to_numpy(r.f), np.asarray(c._runner.f)
    assert np.max(np.abs(f[:, wet] - fj[:, wet])) <= TOL


# -- the iteration reaches the step -----------------------------------------

def _ramped_lid():
    """The pulsed cavity with a lid whose speed changes fast (period 40
    steps), so a step that saw the wrong t shows."""
    return _cavity_sim(nt.DynamicValue(
        lambda t: 0.05 * xsin(2 * np.pi / 40.0 * t), 0.0))


def test_runner_passes_the_iteration():
    """Chunks of 7 through the controller (the torch engine, and the
    kernel engine's plain version) equal 30 single steps that each see
    their iteration; at t = 0 every step would be a different flow."""
    r = run(_ramped_lid(), platform='cpu', lat_nx=16, lat_ny=16,
            max_iters=30, every=7)
    assert r.sim.iteration == 30
    r0 = cpu_runner(_ramped_lid(), lat_nx=16, lat_ny=16)
    step = r0.builder.build()
    f = f0 = r0.f
    for it in range(30):
        f = step(f, it)
    assert torch.equal(r.f, f)
    frozen = f0
    for _ in range(30):
        frozen = step(frozen)
    assert float((frozen - f).abs().max()) > 1e-3
    ks = ls.KernelStep(r0.builder)
    fk = f0
    for it0 in range(0, 30, 7):
        fk = ks.run(fk, min(7, 30 - it0), it0=it0).clone()
    assert float((fk - f).abs().max()) <= TOL


def test_checkpoint_restart_continues_with_t(tmp_path):
    """A restart from the checkpoint of iteration 20 runs iterations 20 ..
    39, with the lid of those iterations: it ends where an unbroken run
    of 40 ends."""
    cfg = dict(lat_nx=16, lat_ny=16, every=10)
    run(_ramped_lid(), platform='cpu', max_iters=20,
        checkpoint_file=str(tmp_path / 'cp'), final_checkpoint=True, **cfg)
    (cpoint,) = glob.glob(str(tmp_path / 'cp') + '*.cpoint.npz')
    restored = run(_ramped_lid(), platform='cpu', max_iters=40,
                   restore_from=cpoint, **cfg)
    whole = run(_ramped_lid(), platform='cpu', max_iters=40, **cfg)
    assert restored.sim.iteration == whole.sim.iteration == 40
    assert torch.equal(restored.f, whole.f)
    # from t = 0 again (--norestore_time) the flow differs
    again = run(_ramped_lid(), platform='cpu', max_iters=20,
                restore_from=cpoint, restore_time=False, **cfg)
    assert float((again.f - whole.f).abs().max()) > 1e-3


# -- the torch engine against the JAX XLA engine at a nonzero iteration ----

def _jax_maps(maps, *exprs):
    """``maps`` with the expressions of its DynamicValue entries replaced,
    in order, by ``exprs`` (JAX callables of the same values)."""
    m = copy.copy(maps)
    m.dynamic = [(mask, name, e) for (mask, name, _), e
                 in zip(maps.dynamic, exprs)]
    return m


def _against_jax(r, jmaps, it0, body_force=None, moved=1e-5):
    """20 steps of the port's step and the JAX XLA engine's from a seeded
    state at iteration ``it0``: wet-node max |df| <= 1e-6, and the state
    differs from the same 20 steps at iteration 0 by more than
    ``moved``."""
    jb = JaxStepBuilder(r.sim.grid, jmaps, visc=r.config.visc,
                        dtype=jnp.float32, body_force=body_force,
                        force_model=r.builder.force_model)
    jstep = jax.jit(jb.build())
    step = r.builder.build()
    f0 = random_feq(r.sim.grid, r.maps.type_map.shape, 11, 'cpu')
    ft, fj, fz = f0, jnp.asarray(f0.numpy()), f0
    for i in range(STEPS):
        ft, fj, fz = step(ft, it0 + i), jstep(fj, it0 + i), step(fz, i)
    wet = wet_map(r.maps)
    ft, fj = state_to_numpy(ft), np.asarray(fj)
    assert np.max(np.abs(ft[:, wet] - fj[:, wet])) <= TOL
    assert np.max(np.abs(ft[:, wet] - state_to_numpy(fz)[:, wet])) > moved
    rho_j, u_j = jax.jit(jb.macro_fields)(jnp.asarray(fj), it0 + STEPS)
    rho_t, u_t = r.builder.macro_fields(torch.from_numpy(fj.copy()),
                                        it0 + STEPS)
    assert np.max(np.abs(u_t.numpy()[:, wet] - np.asarray(u_j)[:, wet])) \
        <= TOL


def test_time_only_densities_match_jax():
    """womersley: the ends at 1 +- 1.5 dp sin(omega t), from t = 3000
    (sin = 0.997)."""
    r = cpu_runner(twin('womersley'), lat_nx=16, lat_ny=12, lat_nz=12)
    dp = r._subdomain.pressure_delta
    om = 0.0005
    jmaps = _jax_maps(r.maps, (lambda t: 1.0 + 1.5 * dp * jnp.sin(t * om),),
                      (lambda t: 1.0 - 1.5 * dp * jnp.sin(t * om),))
    _against_jax(r, jmaps, 3000)


def test_space_and_time_inlet_matches_jax():
    """poiseuille_sa --velocity=equation: the inlet parabola times a ramp
    min(t / 5000, 1), from t = 2500 (half way up the ramp)."""
    mod = load_example('torch/poiseuille_sa.py', 'torch_poiseuille_sa')
    r = cpu_runner(mod.RampedPoiseuilleSim, lat_nx=32, lat_ny=24,
                   velocity='equation')
    radius = (24 - 2.0) / 2.0

    def vx(t, hx, hy):
        parab = 0.02 * (1.0 - (hy + 0.5 - radius) ** 2 / radius ** 2)
        return parab * jnp.minimum(t / mod.RAMP_ITERS, 1.0)

    jmaps = _jax_maps(r.maps, (vx, 0.0))
    _against_jax(r, jmaps, 2500)


def test_pulsatile_force_matches_jax():
    """poiseuille_pulsatile --drive=force: a sin(omega t) along x, from
    t = 500 (the peak)."""
    mod = load_example('torch/poiseuille_pulsatile.py',
                       'torch_poiseuille_pulsatile')
    r = cpu_runner(mod.PulsatileSim, lat_nx=32, lat_ny=24, drive='force')
    assert r.builder.force_expr is not None and r.builder.force is None
    amp = mod.MAX_V * 8.0 * r.config.visc / (24 - 2.0) ** 2
    force = jnt.DynamicValue(lambda t: amp * jnp.sin(mod.OMEGA * t), 0.0)
    _against_jax(r, r.maps, 500, body_force=force, moved=1e-6)


# -- the kernel engine's per-launch values ----------------------------------

KERNEL_CASES = {
    'womersley': (lambda: twin('womersley'),
                  dict(lat_nx=16, lat_ny=12, lat_nz=12), 3000, 'time'),
    'pulsatile_force': (lambda: twin('poiseuille_pulsatile'),
                        dict(lat_nx=32, lat_ny=20, drive='force'), 500,
                        'force'),
    'sa_spatial_array': (lambda: twin('poiseuille_sa'),
                         dict(lat_nx=32, lat_ny=24,
                              velocity='spatial_array'), 2500, 'space'),
    'time_series': (time_series_density_sim, dict(lat_nx=24, lat_ny=12),
                    60, 'time'),
}


@pytest.mark.parametrize('case', sorted(KERNEL_CASES))
def test_step_reference_with_per_launch_values(case):
    """``KernelStep`` on the CPU (``step_reference`` after each
    ``set_iteration``) against the torch engine from ``it0``; the values
    moved the state."""
    sim, cfg, it0, kind = KERNEL_CASES[case]
    r = cpu_runner(sim(), **cfg)
    ks = ls.KernelStep(r.builder)
    assert ks.name == f'lbm_step_dyn_{r.sim.grid.name.lower()}'
    if kind == 'force':
        assert ks.force_expr is not None and not ks.dynamic
    else:
        assert ks.dynamic and all((d.static is not None) == (kind == 'space')
                                  for d in ks.dynamic)
    f0 = random_feq(ks.grid, ks.shape, 12, 'cpu')
    step = r.builder.build()
    ft = f0
    for i in range(10):
        ft = step(ft, it0 + i)
    fk = ks.run(f0, 10, it0=it0).clone()
    wet = (ks.mask == 0) | (ks.mask >= 3)
    assert float((fk - ft)[:, wet].abs().max()) <= TOL
    f_zero = ks.run(f0, 10).clone()
    assert float((fk - f_zero)[:, wet].abs().max()) > 1e-6
    if kind == 'space':
        assert ls.BCP_REWRITES['bcp_d2q9'] > 0


def test_dynamic_rows_of_the_kernel_table():
    """Time-only rows hold scalars (no box); a DynamicValue that covers
    part of an instance, or depends on space, gets a block of the
    parameter array; ``set_iteration`` writes them and a time-only force
    into the block, fp32 as the torch engine casts them."""
    r = cpu_runner(twin('womersley'), lat_nx=16, lat_ny=12, lat_nz=12)
    ks = ls.KernelStep(r.builder)
    assert [row.box for row in ks.table] == [None, None]
    ks.set_iteration(3000)
    dp = r._subdomain.pressure_delta
    t = torch.tensor(3000.0)
    want = float((1.0 + 1.5 * dp * torch.sin(t * 0.0005)).float())
    assert ks.table[0].rho == want == np.float32(ks.params.bc[0].rho)
    assert ks.params.bc[0].kind == ls.BC_KINDS[nt.NTEquilibriumDensity]

    class Half(Subdomain2D):
        def boundary_conditions(self, hx, hy):
            wall = (hy == 0) | (hy == self.gy - 1)
            self.set_node(wall, nt.NTFullBBWall)
            self.set_node(~wall & (hx == 0), nt.NTEquilibriumVelocity(
                (0.01, 0.0)))
            self.update_node(~wall & (hx == 0) & (hy > 5),
                             nt.NTEquilibriumVelocity(nt.DynamicValue(
                                 lambda t: 1e-5 * t, 0.0)))

    class Sim(LBFluidSim):
        subdomain = Half

    r = cpu_runner(Sim, lat_nx=16, lat_ny=12)
    ks = ls.KernelStep(r.builder)
    (row,) = ks.table
    assert row.box is not None and ks.dynamic[0].static is not None
    ks.set_iteration(100)
    rho, u = ls.box_params(row, ks.bcp, ks.shape)
    assert float(u[0, 3, 0]) == pytest.approx(0.01)
    assert float(u[0, 8, 0]) == pytest.approx(1e-3)
    mod = load_example('torch/poiseuille_pulsatile.py',
                       'torch_poiseuille_pulsatile')
    r = cpu_runner(mod.PulsatileSim, lat_nx=32, lat_ny=20, drive='force',
                   dt_per_lattice_time_unit=2.0)
    ks = ls.KernelStep(r.builder)
    ks.set_iteration(250)
    amp = mod.MAX_V * 8.0 * r.config.visc / (20 - 2.0) ** 2
    a = float(torch.tensor(amp, dtype=torch.float32)
              * torch.sin(mod.OMEGA * torch.tensor(500.0)))
    assert ks.force == (a, 0.0)
    assert ks.params.force.a[0] == np.float32(a)
    assert ks.params.force.shift[0] == np.float32(0.5 * a)
