"""The runner's force objects, ``--init_iters`` and ``--profile_trace`` on
the port against the JAX runner (``sailfish_tpu/runner.py:423-493``,
:556-607, :643-649), on the CPU.

* Momentum-exchange drag on the open channels of ``torch_scenes``
  (``open_channel``: a sphere in a duct with a Yu outlet, a cylinder
  between plates with a copy outlet) at a small size: the port's sums on
  JAX's final state, and the drag series of both runners after 200
  steps, on the torch engine and on the kernel engine's plain version.
  Tolerance: relative to S, the sum of the link terms' magnitudes (the
  drag is a difference of sums of positive terms, each rounded in fp32 in
  its own order): 1e-6 S on the same state, 1e-5 S after 200 steps (the
  two engines' states differ by ulps).
* ``--init_iters`` on the periodic Taylor-Green field of
  tests/test_models.py:112-160: the relaxed density and the restored
  velocity against the JAX runner's, within 1e-6, on both engines; and
  the JAX runner's two refusals.
* ``--profile_trace`` writes a Chrome trace of the main loop, on both
  engines.

The JAX twins of the scenes are built from the JAX package's classes.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from sailfish_tpu import node_type as jnt
from sailfish_tpu.controller import \
    LBSimulationController as JaxController
from sailfish_tpu.models.base import ForceObject as JaxForceObject
from sailfish_tpu.models.single import LBFluidSim as JaxFluidSim
from sailfish_tpu.subdomain import Subdomain2D as JaxSubdomain2D
from sailfish_tpu.subdomain import Subdomain3D as JaxSubdomain3D
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.runner import SubdomainRunner
from sailfish_tpu_torch.subdomain import Subdomain2D
from torch_scenes import binary_twin, open_channel, run, twin

torch.set_num_threads(1)

TOL = 1e-6
STEPS = 200
OPEN_SIZES = {3: dict(lat_nx=48, lat_ny=24, lat_nz=24),
              2: dict(lat_nx=128, lat_ny=64)}


def run_jax(sim_cls, **cfg):
    ctrl = JaxController(sim_cls, default_config=dict(
        platform='cpu', quiet=True, engine='xla', **cfg))
    ctrl.run(ignore_cmdline=True)
    return ctrl._runner


def jax_open_channel(dim):
    return open_channel(dim, jnt,
                        JaxSubdomain3D if dim == 3 else JaxSubdomain2D,
                        JaxFluidSim, JaxForceObject)


@pytest.fixture
def kernel_on_cpu(monkeypatch):
    """The kernel engine on CPU tensors: ``KernelStep`` runs its plain
    version (``step_reference``) there."""
    monkeypatch.setattr(SubdomainRunner, '_select_engine',
                        lambda self: 'kernel')


def link_scale(r):
    """S: the sum over the force objects' links of |f_i(x_f)| +
    |f_opp(x_f + c_i)| on the runner's state, in float64."""
    from sailfish_tpu_torch.runner import window_shifted
    g, dim, f = r.sim.grid, r.sim.dim, r.f.double()
    total = 0.0
    for window, links in r._force_specs:
        for i, link in links:
            f_in = window_shifted(f[int(g.opposite[i])], window, tuple(
                int(g.basis[i][dim - 1 - ax]) for ax in range(dim)))
            total += float(((f[i][window].abs() + f_in.abs())
                            * link).sum())
    return total


def _drag_matches_jax(dim, engine_name):
    jr = run_jax(jax_open_channel(dim), max_iters=STEPS, every=STEPS // 4,
                 **OPEN_SIZES[dim])
    r = run(open_channel(dim), platform='cpu', max_iters=STEPS,
            every=STEPS // 4, **OPEN_SIZES[dim])
    assert r.engine == engine_name
    scale = link_scale(r)
    assert [it for it, _F in r.sim.drag] == [it for it, _F in jr.sim.drag] \
        == [50, 100, 150, 200]
    for (_it, F), (_jt, JF) in zip(r.sim.drag, jr.sim.drag):
        assert np.max(np.abs(np.subtract(F, JF))) <= 10 * TOL * scale
    # drag along the flow; the body sits on the axis, so the lift is small
    F = r.sim.force_objects[0].force()
    assert F[0] > 0 and max(abs(c) for c in F[1:]) < 0.2 * F[0]
    # the port's sums on JAX's state
    r.f = torch.from_numpy(np.asarray(jr.f).copy())
    r.update_force_objects()
    assert np.max(np.abs(np.subtract(r.sim.force_objects[0].force(),
                                     jr.sim.force_objects[0].force()))) \
        <= TOL * scale


@pytest.mark.parametrize('dim', [3, 2])
def test_force_object_drag_matches_jax(dim):
    _drag_matches_jax(dim, 'torch')


@pytest.mark.parametrize('dim', [3, 2])
def test_force_object_drag_on_the_kernel_engine(dim, kernel_on_cpu):
    _drag_matches_jax(dim, 'kernel')


def test_force_object_window_wraps():
    """A force object whose window crosses the periodic edge reads the
    wrapped neighbours: the same force as the same body moved inside."""
    from sailfish_tpu_torch.runner import window_shifted
    plane = torch.arange(24.0).reshape(4, 6)
    win = (slice(0, 2), slice(4, 6))
    np.testing.assert_array_equal(
        window_shifted(plane, win, (-1, 1)).numpy(),
        torch.roll(plane, (1, -1), (0, 1))[win].numpy())
    np.testing.assert_array_equal(window_shifted(plane, win, (0, 0)).numpy(),
                                  plane[win].numpy())


def taylor_green(subdomain_cls, model_cls):
    """The periodic Taylor-Green field of tests/test_models.py:120-134."""

    class TG(subdomain_cls):
        def boundary_conditions(self, hx, hy):
            pass

        def initial_conditions(self, sim, hx, hy):
            sim.rho[:] = 1.0
            sim.vx[:] = 0.05 * np.sin(2 * np.pi * hy / 32) \
                * np.cos(2 * np.pi * hx / 32)
            sim.vy[:] = -0.05 * np.cos(2 * np.pi * hy / 32) \
                * np.sin(2 * np.pi * hx / 32)

    class Sim(model_cls):
        subdomain = TG

    return Sim


INIT = dict(lat_nx=32, lat_ny=32, visc=0.05, periodic_x=True,
            periodic_y=True, init_iters=50)


def _init_iters_match_jax(engine_name):
    jr = run_jax(taylor_green(JaxSubdomain2D, JaxFluidSim), max_iters=0,
                 **INIT)
    jr._fields_to_host()
    r = run(taylor_green(Subdomain2D, LBFluidSim), platform='cpu',
            max_iters=0, **INIT)
    assert r.engine == engine_name
    assert r.config.visc == 0.05 and r.sim.iteration == 0
    r._fields_to_host()
    cold = run(taylor_green(Subdomain2D, LBFluidSim), platform='cpu',
               max_iters=0, **dict(INIT, init_iters=0))
    cold._fields_to_host()
    # the density relaxed, the velocity stayed at the initial conditions
    assert np.max(np.abs(r.sim.rho - cold.sim.rho)) > 100 * TOL
    for name in ('rho', 'vx', 'vy'):
        assert np.max(np.abs(getattr(r.sim, name)
                             - getattr(jr.sim, name))) <= TOL, name
    np.testing.assert_allclose(r.f.numpy(), np.asarray(jr.f), rtol=0,
                               atol=TOL)


def test_init_iters_matches_jax():
    _init_iters_match_jax('torch')


def test_init_iters_on_the_kernel_engine(kernel_on_cpu):
    _init_iters_match_jax('kernel')


def test_init_iters_then_steps_match_jax():
    """The run after the initialization: 20 steps from it."""
    jr = run_jax(taylor_green(JaxSubdomain2D, JaxFluidSim), max_iters=20,
                 every=20, **INIT)
    r = run(taylor_green(Subdomain2D, LBFluidSim), platform='cpu',
            max_iters=20, every=20, **INIT)
    assert np.max(np.abs(r.f.numpy() - np.asarray(jr.f))) <= TOL


@pytest.mark.parametrize('sim,cfg,match', [
    (lambda: binary_twin('sc_separation_2d'), {}, 'single-fluid scenes'),
    (lambda: twin('ldc_2d'), dict(precision='mixed'),
     'does not combine with mixed'),
])
def test_init_iters_refusals(sim, cfg, match):
    with pytest.raises(NotImplementedError, match=match):
        run(sim(), platform='cpu', max_iters=0, lat_nx=8, lat_ny=8,
            init_iters=5, **cfg)


@pytest.mark.parametrize('engine', ['torch', 'kernel'])
def test_profile_trace_writes_a_trace(tmp_path, monkeypatch, engine):
    if engine == 'kernel':
        monkeypatch.setattr(SubdomainRunner, '_select_engine',
                            lambda self: 'kernel')
    r = run(twin('ldc_2d'), platform='cpu', max_iters=4, every=2,
            lat_nx=16, lat_ny=16, profile_trace=str(tmp_path))
    assert r.sim.iteration == 4 and r.engine == engine
    paths = glob.glob(os.path.join(str(tmp_path), '*.pt.trace.json'))
    assert len(paths) == 1
    with open(paths[0]) as fh:
        events = json.load(fh)['traceEvents']
    assert any(e.get('name', '').startswith('aten::') for e in events)
