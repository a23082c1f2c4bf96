"""Device hooks in the port's runner (``sim.add_device_hook``), against the
JAX package's XLA engine on the CPU.

* The hook series of ``ldc_2d_unorm`` and ``kida_vortex`` (their twins'
  torch hooks against the JAX scenes' jnp hooks) at the golden harness's
  sizes, 20 steps: the iteration column exactly, the values within rtol
  1e-5 / atol 1e-7.
* Strides: hooks that declare ``every`` / ``from_iter`` run only where
  one of them fires; a hook without a stride makes every hook run after
  every step; each hook is called with the same ``it`` values as in JAX,
  and ``from_iter`` is honoured.
* State: the final ``f`` with hooks is bitwise the final ``f`` without,
  on the torch engine and on the kernel engine's plain version (the
  runner's engine forced to 'kernel': on CPU tensors ``KernelStep`` runs
  ``step_reference``), in fp32 and under ``--precision=mixed``, where the
  kernel engine steps its int16 codes across the splits.
"""

import os

import numpy as np
import pytest
import torch

from sailfish_tpu.controller import \
    LBSimulationController as JaxController
from sailfish_tpu.models.single import LBFluidSim as JaxFluidSim
from sailfish_tpu.subdomain import Subdomain2D as JaxSubdomain2D
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.runner import SubdomainRunner
from sailfish_tpu_torch.subdomain import Subdomain2D
from torch_scenes import (REPO, SINGLE_GOLDEN_FLAGS, TURBULENCE_GOLDEN_FLAGS,
                          load_example, run, turbulence_twin, twin)

torch.set_num_threads(1)


def jax_runner(sim_cls, **cfg):
    jc = JaxController(sim_cls, default_config=dict(
        quiet=True, platform='cpu', engine='xla', **cfg))
    jc.run(ignore_cmdline=True)
    assert jc._runner.engine == 'xla'
    return jc._runner


@pytest.mark.parametrize('scene', ['ldc_2d_unorm', 'kida_vortex'])
def test_hook_series_match_the_jax_xla_engine(scene, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, 'examples'))
    if scene == 'ldc_2d_unorm':
        flags = SINGLE_GOLDEN_FLAGS[scene]
        mine_cls = twin(scene)
        theirs_cls = load_example('ldc_2d_unorm.py',
                                  'jax_ldc_2d_unorm').LDCSimUnorm
    else:
        flags = TURBULENCE_GOLDEN_FLAGS[scene]
        mine_cls = turbulence_twin(scene)
        theirs_cls = load_example('turbulence/kida_vortex.py',
                                  'jax_kida_vortex').KidaSim
    cfg = dict(max_iters=20, every=20, seed=1234, **flags)
    r = run(mine_cls, platform='cpu', **cfg)
    jr = jax_runner(theirs_cls, **cfg)
    if scene == 'ldc_2d_unorm':
        mine, theirs = r.sim.unorm_series(), jr.sim.unorm_series()
        want = [14.0]   # samples at 7, 14 (the first one dropped)
    else:
        mine, theirs = r.sim.ke_enstrophy_series(), \
            jr.sim.ke_enstrophy_series()
        want = [5.0, 10.0, 15.0, 20.0]
    assert mine.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(mine[:, 0], theirs[:, 0])
    assert list(mine[:, 0]) == want
    np.testing.assert_allclose(mine[:, 1:], theirs[:, 1:], rtol=1e-5,
                               atol=1e-7)
    assert np.all(mine[:, 1:] > 0)


def _tgv(base):
    class TGV(base):
        def boundary_conditions(self, hx, hy):
            pass

        def initial_conditions(self, sim, hx, hy):
            k = 2 * np.pi / self.gx
            sim.rho[:] = 1.0
            sim.vx[:] = -0.02 * np.cos(k * hx) * np.sin(k * hy)
            sim.vy[:] = 0.02 * np.sin(k * hx) * np.cos(k * hy)

    return TGV


#: per case: the hooks' (every, from_iter)
STRIDES = {
    'strided': ((3, 5), (4, 0)),
    'mixed': ((3, 5), (None, 0)),
    'unstrided': ((None, 0),),
}


def _recording_sim(base_sim, base_domain, strides, torch_side):
    """A Taylor-Green sim with one hook per (every, from_iter) of
    ``strides``: each records every ``it`` it is called with (slot =
    number of calls so far) and how many of those calls its own stride
    gates in."""

    class Sim(base_sim):
        subdomain = _tgv(base_domain)

        def before_main_loop(self, runner):
            for every, from_iter in strides:
                if torch_side:
                    init = (torch.zeros((), dtype=torch.int32),
                            torch.zeros(64, dtype=torch.int32),
                            torch.zeros((), dtype=torch.int32))

                    def hook(f, state, it, e=every, fi=from_iter):
                        n, its, own = state
                        its[int(n)] = it
                        gate = e is None or (it >= fi and it % e == 0)
                        return n + 1, its, own + int(gate)
                else:
                    import jax.numpy as jnp
                    init = (jnp.zeros((), jnp.int32),
                            jnp.zeros(64, jnp.int32),
                            jnp.zeros((), jnp.int32))

                    def hook(f, state, it, e=every, fi=from_iter):
                        n, its, own = state
                        gate = True if e is None else \
                            (it >= fi) & (jnp.mod(it, e) == 0)
                        return (n + 1, its.at[n].set(it),
                                own + jnp.asarray(gate, jnp.int32))
                self.add_device_hook(init, hook, every=every,
                                     from_iter=from_iter)

    return Sim


@pytest.mark.parametrize('case', sorted(STRIDES))
def test_hooks_see_the_iterations_jax_gives_them(case):
    strides = STRIDES[case]
    cfg = dict(lat_nx=16, lat_ny=16, visc=0.05, max_iters=21, every=8,
               periodic_x=True, periodic_y=True)
    r = run(_recording_sim(LBFluidSim, Subdomain2D, strides, True),
            platform='cpu', **cfg)
    jr = jax_runner(_recording_sim(JaxFluidSim, JaxSubdomain2D, strides,
                                   False), **cfg)
    for (n, its, own), (jn, jits, jown), (every, from_iter) in zip(
            r.device_hook_state, jr.device_hook_state, strides):
        assert int(n) == int(jn)
        calls = its[:int(n)].tolist()
        assert calls == np.asarray(jits)[:int(jn)].tolist()
        assert int(own) == int(jown)
        if case == 'strided':
            # the union of the declared strides, from_iter honoured
            assert calls == sorted({i for i in range(1, 22)
                                    if (i >= 5 and i % 3 == 0)
                                    or i % 4 == 0})
            assert int(own) == len([i for i in calls if i >= from_iter
                                    and i % every == 0])
        else:
            assert calls == list(range(1, 22))


def _hooked(sim_cls, every):
    """``sim_cls`` with a hook that sums rho over the state: strided by
    ``every`` from iteration 3, or without a stride when ``every`` is
    None."""

    class Sim(sim_cls):
        def before_main_loop(self, runner):
            super().before_main_loop(runner)

            def mass(f, acc, it):
                if every is None or it % every == 0:
                    rho, _ = runner.builder.macro_fields(f)
                    acc = acc + rho.sum()
                return acc

            self.add_device_hook(torch.zeros((), dtype=torch.float64),
                                 mass, every=every, from_iter=3)

    return Sim


@pytest.mark.parametrize('every', [None, 4])
@pytest.mark.parametrize('precision', ['single', 'mixed'])
@pytest.mark.parametrize('engine', ['torch', 'kernel'])
def test_hooks_leave_the_state_bitwise_unchanged(engine, precision, every,
                                                 monkeypatch):
    if engine == 'kernel':
        monkeypatch.setattr(SubdomainRunner, '_select_engine',
                            lambda self: 'kernel')
    cfg = dict(platform='cpu', lat_nx=24, lat_ny=20, max_iters=23,
               every=10, precision=precision)
    plain = run(twin('ldc_2d'), **cfg)
    hooked = run(_hooked(twin('ldc_2d'), every), **cfg)
    assert plain.engine == hooked.engine == engine
    assert plain.device_hook_state == ()
    (acc,) = hooked.device_hook_state
    assert float(acc) > 0
    if engine == 'kernel' and precision == 'mixed':
        assert hooked.kernel.mixed is not None
    assert torch.equal(plain.f, hooked.f)
    assert plain.sim.iteration == hooked.sim.iteration == 23
