"""The entropic LBM (ELBM) of the port on the CPU, against the JAX package.

* ``ops/entropic.py`` against ``sailfish_tpu.ops.entropic`` on seeded
  fields, D2Q9 and D3Q19: the product-form equilibrium within 1e-7 (XLA on
  the CPU contracts multiply-adds into FMAs, so a few entries differ by an
  ulp); alpha on each branch of the dispatch: a tiny deviation (2, exact),
  the series (1e-6) and Newton. The Newton alpha is the root of an entropy
  difference that fp32 rounds to ~1e-7, so the two engines land within
  5e-5 of each other (relative) with tight stops; with the default ones
  (an entropy residual of 1e-6) an ulp of XLA's logarithm or an FMA can
  move the step the solve stops at, and the stated bound is 5e-4. Tight
  and loose stops give different alphas (tests/test_models.py:163-189);
  ``skip`` keeps lanes out of the solve without changing the others.
* The torch ``StepBuilder`` under ``model='elbm'`` against the JAX XLA
  engine's on a periodic shear wave (D2Q9 32^2 and D3Q19 16^3, no force,
  Guo, EDM, the velocity shift), 20 steps: f within 1e-6 (every node on
  the tiny or the series branch), alpha within 1e-5 (``ALPHA_TOL`` says
  which operation's rounding differs). ``--entropic_equilibrium`` under
  BGK and under MRT (which ignores it in its relaxation) against JAX
  through the controller, 1e-6. The regularized lid rows off the Newton
  branch (a lid of 1e-3, D2Q9 and D3Q19) against the JAX XLA engine, 1e-6.
  Where two correct fp32 arithmetics part, the witness is the JAX XLA
  engine in fp64 (x64 on the CPU), and the port is held within twice JAX's
  fp32 distance to it: int16 ELBM in codes (or within 2 codes), and the
  cavity of ``examples/ldc_2d_entropic``, whose Newton lanes at the lid
  corners carry the ulps of the stop apart.
* The shear-wave viscosity under ELBM within 2 % (tests/test_models.py
  :37-40); the alpha field of ``LBEntropicFluidSim`` (tests/test_mixins.py
  :45-58) on the port and against JAX's; the tolerances' plumbing.
* What ELBM ignores, as in JAX: the Smagorinsky constant (the entropic
  collision takes the base tau) and, in its relaxation, ``incompressible``
  (the product form has none; BC rows still reconstruct with it).
* The kernel engine's plain version under ELBM equals the torch engine bit
  for bit, and its alpha diagnostics.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu import lattice as jlattice
from sailfish_tpu.controller import \
    LBSimulationController as JaxController
from sailfish_tpu.models.single import LBEntropicFluidSim as JaxEntropicSim
from sailfish_tpu.models.single import LBFluidSim as JaxFluidSim
from sailfish_tpu.ops import entropic as jent
from sailfish_tpu.ops.step import StepBuilder as JaxStepBuilder
from sailfish_tpu.subdomain import Subdomain2D as JaxSubdomain2D
from sailfish_tpu_torch import lattice
from sailfish_tpu_torch.models.single import LBEntropicFluidSim, LBFluidSim
from sailfish_tpu_torch.ops import entropic as ent
from sailfish_tpu_torch.ops import lbm_step as ls
from sailfish_tpu_torch.ops.step import FORCE_MODELS, StepBuilder
from sailfish_tpu_torch.state import state_to_numpy
from sailfish_tpu_torch.subdomain import Subdomain2D
from torch_scenes import (REPO, cpu_runner, elbm_branches, forced,
                          load_example, periodic_box, run,
                          twin, wet_map)

torch.set_num_threads(1)

STEPS = 20
TOL = 1e-6
GRIDS = ('D2Q9', 'D3Q19')
#: Newton alphas, tight stops (entropy 1e-10, alpha 1e-14; relative) /
#: the defaults (absolute)
NEWTON_TIGHT = 5e-5
NEWTON_DEFAULT = 5e-4
ACCEL = (1e-4, -5e-5, 2.5e-5)
#: alpha on the series branch of a resolved flow: alpha - 2 is ~1e-5 there,
#: the ratio of power sums of fneq / f whose odd one (sum fneq^3 / f^2)
#: cancels to ~1e-3 of its terms, so the multiply-adds XLA on the CPU
#: contracts into FMAs (and torch does not) move it by up to ~5e-6; what
#: alpha moves in f (alpha beta fneq, fneq ~1e-4) stays within TOL
ALPHA_TOL = 1e-5


def _fields(name, scale, seed=0, n=512):
    """(f, fneq) float32 of ``n`` lanes: the product form of rho = 1 +
    U(0, 0.05), u = 0.08 U(-1/2, 1/2), less ``scale`` U(-1/2, 1/2) of it
    (tests/test_models.py:173-181)."""
    g = lattice.get_grid(name)
    rng = np.random.RandomState(seed)
    rho = (1.0 + 0.05 * rng.rand(n)).astype(np.float32)
    u = (0.08 * (rng.rand(g.dim, n) - 0.5)).astype(np.float32)
    feq = np.asarray(jent.elbm_equilibrium(
        jlattice.get_grid(name), jnp.asarray(rho), jnp.asarray(u)))
    fneq = (scale * (rng.rand(g.Q, n) - 0.5)).astype(np.float32) * feq
    return rho, u, feq - fneq, fneq


def _alphas(name, f, fneq, **kw):
    aj = np.asarray(jent.entropic_alpha(jlattice.get_grid(name),
                                        jnp.asarray(f), jnp.asarray(fneq),
                                        **kw))
    at = ent.entropic_alpha(lattice.get_grid(name), torch.from_numpy(f),
                            torch.from_numpy(fneq), **kw).numpy()
    return aj, at


@pytest.mark.parametrize('name', GRIDS)
def test_equilibrium_matches_jax(name):
    rho, u, _, _ = _fields(name, 0.0)
    fj = np.asarray(jent.elbm_equilibrium(
        jlattice.get_grid(name), jnp.asarray(rho), jnp.asarray(u)))
    ft = ent.elbm_equilibrium(lattice.get_grid(name), torch.from_numpy(rho),
                              torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-7)
    # the product form conserves mass and momentum
    g = lattice.get_grid(name)
    np.testing.assert_allclose(ft.sum(0), rho, rtol=2e-6)
    np.testing.assert_allclose(g.basis.T @ ft.astype(np.float64),
                               rho * u, atol=2e-6)


@pytest.mark.parametrize('branch,scale', [('tiny', 1e-8), ('series', 1e-3),
                                          ('newton', 0.2)])
@pytest.mark.parametrize('name', GRIDS)
def test_alpha_branches_match_jax(name, branch, scale):
    _, _, f, fneq = _fields(name, scale)
    g = lattice.get_grid(name)
    codes = ent.branches(g, torch.from_numpy(f), torch.from_numpy(fneq))
    want = ('tiny', 'series', 'newton').index(branch)
    assert torch.all(codes == want), codes
    aj, at = _alphas(name, f, fneq)
    if branch == 'tiny':
        assert np.all(aj == 2.0) and np.all(at == 2.0)
    elif branch == 'series':
        np.testing.assert_allclose(at, aj, rtol=0, atol=TOL)
        sj = np.asarray(jent.alpha_series(jlattice.get_grid(name),
                                          jnp.asarray(f), jnp.asarray(fneq)))
        st = ent.alpha_series(g, torch.from_numpy(f),
                              torch.from_numpy(fneq)).numpy()
        np.testing.assert_allclose(st, sj, rtol=0, atol=TOL)
    else:
        assert np.abs(at - aj).max() <= NEWTON_DEFAULT
        aj, at = _alphas(name, f, fneq, entropy_tol=1e-10, alpha_tol=1e-14)
        np.testing.assert_allclose(at, aj, rtol=NEWTON_TIGHT, atol=0)


@pytest.mark.parametrize('name', GRIDS)
def test_tight_and_loose_stops_differ(name):
    """tests/test_models.py:182-189 on the port."""
    _, _, f, fneq = _fields(name, 0.2)
    g = lattice.get_grid(name)
    tight = ent.entropic_alpha(g, torch.from_numpy(f), torch.from_numpy(fneq),
                               entropy_tol=1e-10, alpha_tol=1e-14)
    loose = ent.entropic_alpha(g, torch.from_numpy(f), torch.from_numpy(fneq),
                               entropy_tol=1e-2, alpha_tol=1e-2)
    assert torch.all(torch.isfinite(tight)) and torch.all(
        torch.isfinite(loose))
    assert float((tight - loose).abs().max()) > 1e-5
    _, loose_j = _alphas(name, f, fneq, entropy_tol=1e-2, alpha_tol=1e-2)
    np.testing.assert_array_equal(loose.numpy(), loose_j)


@pytest.mark.parametrize('name', GRIDS)
def test_collide_and_skip_match_jax(name):
    rho, u, f, _ = _fields(name, 1e-3, seed=1)
    g, jg = lattice.get_grid(name), jlattice.get_grid(name)
    skip = np.zeros(f.shape[1], dtype=bool)
    skip[::3] = True
    fj, aj = jent.elbm_collide(jg, jnp.asarray(f), jnp.asarray(rho),
                               jnp.asarray(u), 0.8, skip=jnp.asarray(skip))
    ft, at = ent.elbm_collide(g, torch.from_numpy(f), torch.from_numpy(rho),
                              torch.from_numpy(u), 0.8,
                              skip=torch.from_numpy(skip))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=TOL)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=0, atol=TOL)
    # skipped Newton lanes hold alpha0 and leave the others as they were
    _, _, f2, fneq2 = _fields(name, 0.2, seed=2)
    g_f, g_n = torch.from_numpy(f2), torch.from_numpy(fneq2)
    full = ent.entropic_alpha(g, g_f, g_n)
    part = ent.entropic_alpha(g, g_f, g_n, skip=torch.from_numpy(
        skip[:f2.shape[1]]))
    keep = ~torch.from_numpy(skip[:f2.shape[1]])
    assert torch.equal(full[keep], part[keep])
    assert torch.equal(ent.entropic_alpha(
        g, g_f, g_n, skip=torch.ones(f2.shape[1], dtype=torch.bool)),
        torch.where(torch.isfinite(ent.alpha_series(g, g_f, g_n)),
                    ent.alpha_series(g, g_f, g_n), torch.tensor(2.0)))


def shear_wave(dim, n=32):
    """A periodic box whose fluid starts with the shear wave u_x = 0.01
    sin(2 pi y / n) (tests/test_models.py:13-34)."""
    base = periodic_box(dim)

    class Box(base.subdomain):
        def initial_conditions(self, sim, *h):
            sim.rho[:] = 1.0
            sim.vx[:] = 0.01 * np.sin(2 * np.pi * h[1] / n)

    class Sim(LBFluidSim):
        subdomain = Box

    return Sim


SHEAR = {2: dict(lat_nx=32, lat_ny=32, periodic_x=True, periodic_y=True),
         3: dict(lat_nx=16, lat_ny=32, lat_nz=8, periodic_x=True,
                 periodic_y=True, periodic_z=True)}


def _jax_builder(r, dtype=jnp.float32, **kw):
    b = r.builder
    return JaxStepBuilder(r.sim.grid, r.maps, visc=r.config.visc,
                          dtype=dtype, body_force=b.body_force,
                          force_model=b.force_model, model=b.model,
                          equilibrium=b.equilibrium,
                          incompressible=b.incompressible, **kw)


def _torch_steps(r, steps=STEPS):
    """The torch engine's state after ``steps`` from the runner's initial
    state."""
    step = r.builder.build()
    f = r.f
    for it in range(steps):
        f = step(f, it)
    return f


def _engines(r, steps=STEPS, **kw):
    """(torch f, JAX f, torch alpha, JAX alpha) after ``steps`` of both
    XLA and torch engines from the runner's initial state (alpha: of the
    last collision; None but under ELBM)."""
    jb = _jax_builder(r, **kw)
    jstep = jb.build()

    @jax.jit
    def jstep_alpha(f, it):
        out = jstep(f, it)
        return out, getattr(jb, 'last_alpha', None)

    ft = _torch_steps(r, steps)
    fj = jnp.asarray(r.f.numpy())
    for it in range(steps):
        fj, aj = jstep_alpha(fj, it)
    at = r.builder.last_alpha
    return (ft, np.asarray(fj), None if at is None else at.numpy(),
            None if aj is None else np.asarray(aj))


@pytest.mark.parametrize('force', (None,) + FORCE_MODELS)
@pytest.mark.parametrize('dim', [2, 3])
def test_torch_engine_matches_jax_xla_engine(dim, force):
    sim = shear_wave(dim)
    cfg = dict(SHEAR[dim], model='elbm', visc=0.02)
    if force:
        sim = forced(sim, ACCEL[:dim])
        cfg['force_implementation'] = force
    r = cpu_runner(sim, **cfg)
    assert r.builder.elbm is not None and r.builder.entropy_tolerance == 1e-6
    ft, fj, at, aj = _engines(r)
    np.testing.assert_allclose(state_to_numpy(ft), fj, rtol=0, atol=TOL)
    # alpha of the last collision: near 2 on a resolved wave, not 2
    np.testing.assert_allclose(at, aj, rtol=0, atol=ALPHA_TOL)
    assert 0 < np.abs(at - 2.0).max() < 1e-3


def test_shear_wave_viscosity():
    """tests/test_models.py:37-40 under ELBM on the port."""
    n, nu0, u0, iters = 32, 0.05, 0.01, 400

    class SW(Subdomain2D):
        def boundary_conditions(self, hx, hy):
            pass

        def initial_conditions(self, sim, hx, hy):
            sim.rho[:] = 1.0
            sim.vx[:] = u0 * np.sin(2 * np.pi * hy / n)

    class Sim(LBFluidSim):
        subdomain = SW

    r = run(Sim, platform='cpu', lat_nx=n, lat_ny=n, visc=nu0,
            max_iters=iters, every=iters, periodic_x=True, periodic_y=True,
            model='elbm')
    r._fields_to_host()
    k = 2 * np.pi / n
    amp = abs(np.fft.rfft(r.sim.vx[:, 0])[1]) * 2 / n
    nu = -np.log(amp / u0) / (k * k * iters)
    assert abs(nu - nu0) / nu0 < 0.02, nu


class _TGV(Subdomain2D):
    max_v = 0.02

    def boundary_conditions(self, hx, hy):
        pass

    def initial_conditions(self, sim, hx, hy):
        k = 2 * np.pi / self.gx
        sim.rho[:] = 1.0
        sim.vx[:] = -self.max_v * np.cos(k * hx) * np.sin(k * hy)
        sim.vy[:] = self.max_v * np.sin(k * hx) * np.cos(k * hy)


class _JaxTGV(JaxSubdomain2D):
    boundary_conditions = _TGV.boundary_conditions
    initial_conditions = _TGV.initial_conditions
    max_v = 0.02


def test_entropic_alpha_output():
    """tests/test_mixins.py:45-58 on the port, and the alpha field against
    JAX's."""
    cfg = dict(lat_nx=32, lat_ny=32, visc=0.02, max_iters=50, every=50,
               periodic_x=True, periodic_y=True)

    class Sim(LBEntropicFluidSim):
        subdomain = _TGV

    r = run(Sim, platform='cpu', **cfg)
    assert r.config.model == 'elbm' and r.builder.elbm is not None
    r._fields_to_host()
    alpha = r.sim.alpha
    assert np.all(np.isfinite(alpha))
    assert abs(alpha.mean() - 2.0) < 0.05
    assert 'alpha' in r.sim.host_fields()

    class JSim(JaxEntropicSim):
        subdomain = _JaxTGV

    c = JaxController(JSim, default_config=dict(platform='cpu', quiet=True,
                                                **cfg))
    c.run(ignore_cmdline=True)
    c._runner._fields_to_host()
    np.testing.assert_allclose(alpha, c._runner.sim.alpha, rtol=0,
                               atol=ALPHA_TOL)
    np.testing.assert_allclose(r.sim.vx, c._runner.sim.vx, rtol=0, atol=TOL)


class _JaxShear(JaxSubdomain2D):
    def boundary_conditions(self, hx, hy):
        pass

    def initial_conditions(self, sim, hx, hy):
        sim.rho[:] = 1.0
        sim.vx[:] = 0.01 * np.sin(2 * np.pi * hy / 32)


class _Shear(Subdomain2D):
    boundary_conditions = _JaxShear.boundary_conditions
    initial_conditions = _JaxShear.initial_conditions


def _both(**extra):
    """The port's and JAX's runners after 20 steps of the 32^2 shear wave
    with ``extra`` flags."""
    cfg = dict(lat_nx=32, lat_ny=32, visc=0.05, max_iters=20, every=20,
               periodic_x=True, periodic_y=True, **extra)

    class Sim(LBFluidSim):
        subdomain = _Shear

    class JSim(JaxFluidSim):
        subdomain = _JaxShear

    c = JaxController(JSim, default_config=dict(platform='cpu', quiet=True,
                                                **cfg))
    c.run(ignore_cmdline=True)
    return run(Sim, platform='cpu', **cfg), c._runner


@pytest.mark.parametrize('extra', [
    dict(model='elbm', entropy_tolerance=1e-3, alpha_tolerance=1e-4),
    dict(entropic_equilibrium=True),
    dict(entropic_equilibrium=True, model='mrt'),
], ids=['tolerances', 'entropic_equilibrium', 'entropic_equilibrium_mrt'])
def test_flags_match_jax(extra):
    """The ELBM flags reach the builder (tests/test_models.py:191-225) and
    the port matches JAX under them; the product-form equilibrium moves the
    BGK result (the initial state), and MRT ignores it in its
    relaxation."""
    r, rj = _both(**extra)
    b = r.builder
    assert (b.entropy_tolerance, b.alpha_tolerance) == (
        rj.builder.entropy_tolerance, rj.builder.alpha_tolerance)
    assert b.equilibrium == rj.builder.equilibrium
    np.testing.assert_allclose(state_to_numpy(r.f), np.asarray(rj.f),
                               rtol=0, atol=TOL)
    if extra.get('entropic_equilibrium'):
        assert b.equilibrium == 'elbm'
        plain, _ = _both(**{k: v for k, v in extra.items()
                            if k != 'entropic_equilibrium'})
        assert float((r.f - plain.f).abs().max()) > 1e-9
    else:
        assert (b.entropy_tolerance, b.alpha_tolerance) == (1e-3, 1e-4)


def test_tolerance_defaults():
    r = cpu_runner(twin('ldc_2d'), lat_nx=8, lat_ny=8, model='elbm')
    assert (r.builder.entropy_tolerance, r.builder.alpha_tolerance) == (
        1e-6, 1e-10)
    b = StepBuilder(r.sim.grid, r.maps, visc=0.1, model='elbm',
                    dtype=torch.float64)
    assert b.entropy_tolerance == 1e-10 and b.elbm.entropy_tol == 1e-10


def test_ignored_options():
    """As in JAX, ELBM ignores the Smagorinsky constant (the entropic
    collision takes the base tau) and, in its relaxation, the
    incompressible flag: on a periodic box (no BC row) both leave the
    state bit for bit (and the port matches JAX under the Smagorinsky
    flag); with BC rows incompressible still reconstructs them."""
    cfg = dict(SHEAR[2], model='elbm', visc=0.02)
    ref = _torch_steps(cpu_runner(shear_wave(2), **cfg))
    les = dict(subgrid='les-smagorinsky', smagorinsky_const=0.2)
    for extra in (les, dict(incompressible=True)):
        r = cpu_runner(shear_wave(2), **cfg, **extra)
        assert torch.equal(_torch_steps(r), ref), extra
    r = cpu_runner(shear_wave(2), **cfg, **les)
    assert r.builder.smagorinsky == 0.2
    ft, fj, _, _ = _engines(r, smagorinsky=0.2)
    np.testing.assert_allclose(state_to_numpy(ft), fj, rtol=0, atol=TOL)
    lid = dict(lat_nx=32, lat_ny=32, model='elbm', visc=0.02)
    steps = [_torch_steps(cpu_runner(twin('ldc_2d'), incompressible=i,
                                     **lid), 5) for i in (False, True)]
    assert float((steps[0] - steps[1]).abs().max()) > 1e-9


def _jax_fp64(fn):
    """``fn()`` with JAX's x64 mode on (process-global), then off."""
    jax.config.update('jax_enable_x64', True)
    try:
        return fn()
    finally:
        jax.config.update('jax_enable_x64', False)


def test_int16_elbm_matches_jax_int16_engine():
    """int16 storage under ELBM (the product form is refused there, the
    collision is not): 20 steps of the D3Q19 shear wave against JAX's
    int16 XLA engine. Two correct fp32 arithmetics end a few codes apart
    here (the series alpha's rounding, ``ALPHA_TOL``, crosses code
    boundaries that the weakly damped wave carries on: 4 codes under ELBM
    and under BGK alike), so both are held to the JAX XLA engine in fp64
    with the same quantization in fp64 (JAX's int16 step is its fp32 step
    quantized): the port within 2 codes of it or within twice JAX's
    distance. And the refusal of the product form under
    --precision=mixed."""
    cfg = dict(SHEAR[3], model='elbm', visc=0.02)
    r = cpu_runner(shear_wave(3), precision='mixed', **cfg)
    mx = r.builder.mixed
    assert mx is not None and r.builder.elbm is not None
    ft, fj, _, _ = _engines(r, storage='int16')
    col = (-1,) + (1,) * 3
    w, ws, inv = (np.asarray(v, np.float32).astype(np.float64).reshape(col)
                  for v in (mx.w, mx.ws, mx.inv_ws))

    def codes(f):
        return np.clip(np.round((np.asarray(f, np.float64) - w) * inv),
                       -32768, 32767).astype(np.int32)

    def jax64():
        jstep = jax.jit(_jax_builder(r, dtype=jnp.float64,
                                     entropy_tolerance=1e-6).build())
        q = codes(r.f.numpy())
        for it in range(STEPS):
            q = codes(jstep(jnp.asarray(w + ws * q), it))
        return q

    q64 = _jax_fp64(jax64)
    dq = np.abs(codes(ft.numpy()) - q64).max()
    j64 = np.abs(codes(fj) - q64).max()
    assert dq <= max(2, 2 * j64), (dq, j64)
    with pytest.raises(NotImplementedError, match='standard equilibrium'):
        cpu_runner(shear_wave(3), precision='mixed', entropic_equilibrium=True,
                   **cfg)


def test_cavity_matches_jax(monkeypatch):
    """The entropic cavity (lid 0.01, nu = 1e-4) at 64^2, 25 steps, against
    the JAX XLA engine: within twice the distance of JAX's fp32 run to its
    own fp64 run of the same stops (JAX's Pallas-against-XLA bounds, 1e-5
    in rho and 1e-6 in u at 128^2, tests/test_pallas2d.py:237-248, are
    missed: the Newton lanes at the lid corners stop on an entropy residual
    of 1e-6, and XLA's FMA contractions and its own logf decide at which
    step; ``test_slow_lid_matches_jax`` holds the lid rows off the Newton
    branch at 1e-6)."""
    cfg = dict(lat_nx=64, lat_ny=64, max_iters=25, every=25)
    monkeypatch.syspath_prepend(os.path.join(REPO, 'examples'))
    jsim = load_example('ldc_2d_entropic.py', 'jax_ldc_2d_entropic')

    def jax_run(precision):
        c = JaxController(jsim.EntropicLDCSim, default_config=dict(
            platform='cpu', quiet=True, engine='xla', precision=precision,
            entropy_tolerance=1e-6, **cfg))
        c.run(ignore_cmdline=True)
        return c._runner

    rj = jax_run('single')
    rj64 = _jax_fp64(lambda: jax_run('double'))
    r32 = run(twin('ldc_2d_entropic'), platform='cpu', **cfg)
    wet = wet_map(r32.maps)
    for r in (rj, rj64, r32):
        r._fields_to_host()
    for k in ('rho', 'vx', 'vy', 'alpha'):
        j, exact, a = (getattr(x.sim, k)[wet] for x in (rj, rj64, r32))
        assert exact.dtype == np.float64 and np.all(np.isfinite(a))
        assert np.abs(a - exact).max() <= 2.0 * np.abs(j - exact).max(), k


def slow_lid(dim, v=0.001):
    """The cavity twin of ``dim`` with its lid at ``v``."""
    base = twin('ldc_2d' if dim == 2 else 'ldc_3d')

    class Block(base.subdomain):
        max_v = v

    class Sim(base):
        subdomain = Block

    return Sim


@pytest.mark.parametrize('dim', [2, 3])
def test_slow_lid_matches_jax(dim):
    """The regularized lid rows under ELBM, held off the Newton branch: the
    cavity with its lid at 1e-3 (D2Q9 32^2, D3Q19 16^3, nu = 0.005), 20
    steps of both engines; no node takes the Newton branch at any step,
    most the series at the last, and f is within 1e-6 of the JAX XLA
    engine on wet nodes, alpha within ``ALPHA_TOL``."""
    n = 32 if dim == 2 else 16
    cfg = dict(lat_nx=n, lat_ny=n, model='elbm', visc=0.005)
    if dim == 3:
        cfg['lat_nz'] = n
    r = cpu_runner(slow_lid(dim), **cfg)
    jb = _jax_builder(r)
    jraw = jb.build()

    @jax.jit
    def jstep(f, it):
        out = jraw(f, it)
        return out, jb.last_alpha

    step = r.builder.build()
    r.builder.elbm.record_branches = True
    wet = wet_map(r.maps)
    f, fj = r.f, jnp.asarray(r.f.numpy())
    for it in range(STEPS):
        f = step(f, it)
        fj, aj = jstep(fj, it)
        branch = r.builder.elbm.last_branch.numpy()
        assert not (branch == 2).any(), it
    # the flow has reached most nodes (at rest a node takes the tiny one)
    assert (branch == 1).sum() > 0.5 * wet.sum()
    np.testing.assert_allclose(state_to_numpy(f)[:, wet],
                               np.asarray(fj)[:, wet], rtol=0, atol=TOL)
    at = r.builder.last_alpha.numpy()
    np.testing.assert_allclose(at[wet], np.asarray(aj)[wet], rtol=0,
                               atol=ALPHA_TOL)
    assert 1e-6 < np.abs(at[wet] - 2.0).max() < 1e-2


def test_kernel_engine_plain_version_equals_torch_engine():
    """``KernelStep`` on the CPU under ELBM (its key, the ELBM library and
    parameter block; the plain version) equals the torch engine bit for
    bit, with the kernel's branch diagnostics on the plain side."""
    r = cpu_runner(twin('ldc_2d'), lat_nx=48, lat_ny=32, model='elbm',
                   visc=0.01)
    ks = ls.KernelStep(r.builder)
    assert ks.name == ks.entry.replace('step_', 'step_elbm_') \
        == 'lbm_step_elbm_d2q9'
    assert ks.library == 'lbm_step_elbm'
    assert ks.params.coll.model == ls.MODEL_CODES['elbm'] == 3
    assert np.float32(ks.params.elbm.beta) == np.float32(
        1.0 / (2.0 * r.builder.tau))
    assert (ks.params.elbm.entropy_tol, ks.params.elbm.alpha_tol) == (
        np.float32(1e-6), np.float32(1e-10))
    step = r.builder.build()
    f = r.f
    for it in range(10):
        f = step(f, it)
    assert torch.equal(ks.run(r.f, 10), f)
    b = elbm_branches(ks, f)
    assert b['same'] and b['err'] == 0.0 and b['kernel'][1] > 0, b
