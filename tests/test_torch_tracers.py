"""The port's tracers (``sailfish_tpu_torch/tracers.py``) against the JAX
package on the CPU.

* One advection step on the same velocity field and positions equals the
  JAX package's bit for bit (2D and 3D, nodes clamped at the edges,
  positions wrapped across them, fp32 and fp64 fields).
* Twin of ``tests/test_mixins.py``: a checkpoint carries the tracer
  positions and the Reynolds statistics, and the split run equals the
  straight one (f and tracers bit for bit, statistics within rtol 1e-6).
* Tracers on ``--mesh=2`` (the sharded step's gathered fields) and on the
  kernel engine (here its plain version; the velocity read from the
  kernel's state) move as on the unsharded torch engine, bit for bit.
* Tracer state crosses the packages through checkpoints both ways: it
  restores to its bits, and the continued positions stay within the
  velocity's tolerance (1e-6 per update) plus an fp32 ulp per update of
  the other package's straight run.
"""

import glob

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from sailfish_tpu.controller import \
    LBSimulationController as JaxController
from sailfish_tpu.tracers import TracerParticles as JaxTracerParticles
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.runner import SubdomainRunner
from sailfish_tpu_torch.stats import ReynoldsStatsMixIn
from sailfish_tpu_torch.subdomain import Subdomain2D
from sailfish_tpu_torch.tracers import TracerParticles
from torch_scenes import load_example, run, twin, with_tracers

torch.set_num_threads(1)


def _positions(sizes, n, seed):
    """(dim, n) positions over the domain, some within a node of its
    edges and some a little outside."""
    rng = np.random.default_rng(seed)
    sz = np.array(sizes, dtype=np.float64)[:, None]
    pos = rng.uniform(0.0, 1.0, (len(sizes), n)) * sz
    pos[:, :4] = rng.uniform(0.0, 0.05, (len(sizes), 4))
    pos[:, 4:8] = sz - rng.uniform(0.0, 0.05, (len(sizes), 4))
    pos[:, 8] = -0.3
    pos[:, 9] = sz[:, 0] + 0.2
    return pos


@pytest.mark.parametrize('dim,dtype', [(2, np.float32), (3, np.float32),
                                       (3, np.float64)])
def test_advection_matches_jax_bit_for_bit(dim, dtype):
    shape = (9, 7, 11)[3 - dim:]
    sizes = tuple(reversed(shape))
    pos = _positions(sizes, 64, seed=dim)
    u = np.random.default_rng(7).normal(0.0, 0.2, (dim,) + shape)
    u = u.astype(dtype)
    x64 = dtype == np.float64
    if x64:
        # the JAX package promotes the positions with x64 on
        jax.config.update('jax_enable_x64', True)
    try:
        ours = TracerParticles(pos, shape)
        theirs = JaxTracerParticles(pos, shape)
        wrapped = np.zeros(pos.shape, dtype=bool)
        for _ in range(3):
            before = ours.to_numpy()
            got = ours.advect(torch.as_tensor(u)).numpy()
            theirs.positions = theirs._advect(theirs.positions,
                                              jnp.asarray(u))
            ref = np.asarray(theirs.positions)
            assert got.dtype == ref.dtype == dtype
            np.testing.assert_array_equal(got, ref)
            wrapped |= np.abs(got - before) > 1.0
    finally:
        jax.config.update('jax_enable_x64', False)
    assert wrapped.any()
    assert np.all((ours.to_numpy() >= 0.0)
                  & (ours.to_numpy() < np.array(sizes)[:, None]))


class _TGV(Subdomain2D):
    max_v = 0.02

    def boundary_conditions(self, hx, hy):
        pass

    def initial_conditions(self, sim, hx, hy):
        k = 2 * np.pi / self.gx
        sim.rho[:] = 1.0
        sim.vx[:] = -self.max_v * np.cos(k * hx) * np.sin(k * hy)
        sim.vy[:] = self.max_v * np.sin(k * hx) * np.cos(k * hy)


def test_checkpoint_restores_mixin_and_tracer_state(tmp_path):
    """Twin of tests/test_mixins.py: the device-hook Reynolds accumulators
    and the tracer positions survive a save/restore split run."""

    def make_sim():
        class Sim(LBFluidSim, ReynoldsStatsMixIn):
            subdomain = _TGV

            def before_main_loop(self, runner):
                self.prepare_reynolds_stats(runner, axis='y', every=5)
                if not hasattr(self, 'tp'):
                    self.tp = TracerParticles(
                        np.array([[3.0, 10.0], [4.0, 20.0]]), (32, 32))
                    self.register_checkpoint_object('tracers', self.tp)

            def after_step(self, runner):
                if self.iteration % self.config.every == 0:
                    self.tp.update(runner)
        return Sim

    def cfg(**kw):
        return dict(platform='cpu', lat_nx=32, lat_ny=32, visc=0.02,
                    every=10, periodic_x=True, periodic_y=True, **kw)

    ra = run(make_sim(), **cfg(max_iters=40))
    cp = str(tmp_path / 'cp')
    run(make_sim(), **cfg(max_iters=20, checkpoint_file=cp,
                          final_checkpoint=True))
    rb = run(make_sim(), **cfg(max_iters=40, restore_from=cp + '.last'))
    assert rb.sim.iteration == 40
    assert torch.equal(ra.f, rb.f)
    sa, sb = ra.sim.reynolds_stats(), rb.sim.reynolds_stats()
    for k in sa:
        np.testing.assert_allclose(sa[k], sb[k], rtol=1e-6, err_msg=k)
    np.testing.assert_array_equal(ra.sim.tp.to_numpy(), rb.sim.tp.to_numpy())
    assert np.abs(ra.sim.tp.to_numpy() - [[3.0, 10.0], [4.0, 20.0]]).max() \
        > 1e-3


CUBE = dict(lat_nx=16, lat_ny=16, lat_nz=16, max_iters=40, every=40)
#: tracers of the cavity runs: (x, y, z) rows of 200 positions
CAVITY_TRACERS = _positions((16, 16, 16), 200, seed=11)


def _cavity_tracers(**cfg):
    r = run(with_tracers(twin('ldc_3d'), CAVITY_TRACERS, 10),
            platform='cpu', **dict(CUBE, **cfg))
    return r, r.sim.tp.to_numpy()


@pytest.mark.parametrize('where', ['mesh', 'kernel'])
def test_tracers_move_as_unsharded_on_the_torch_engine(where, monkeypatch):
    ref_r, ref = _cavity_tracers()
    assert ref_r.engine == 'torch'
    if where == 'kernel':
        monkeypatch.setattr(SubdomainRunner, '_select_engine',
                            lambda self: 'kernel')
        r, got = _cavity_tracers()
        assert r.engine == 'kernel'
    else:
        r, got = _cavity_tracers(mesh='2')
        assert r.stepper is not None
    assert torch.equal(r.f, ref_r.f)
    np.testing.assert_array_equal(got, ref)
    assert np.abs(got - CAVITY_TRACERS).max() > 1e-3


def _jax_tracer_run(iters, **extra):
    jax_sim = load_example('ldc_3d.py', 'jax_ldc_3d').LDCSim
    c = JaxController(with_tracers(jax_sim, CAVITY_TRACERS, 10,
                                   JaxTracerParticles),
                      default_config=dict(platform='cpu', quiet=True,
                                          **dict(CUBE, max_iters=iters,
                                                 **extra)))
    c.run(ignore_cmdline=True)
    return c._runner


def test_tracer_checkpoints_cross_the_packages(tmp_path):
    """JAX 20 steps (2 updates) -> port 20 more, against JAX 40; and port
    20 -> JAX 20 more, against port 40."""
    # 2 updates after the restore: each adds the velocity's difference
    # (within 1e-6) and at most one rounding of the position (< 16)
    tol = 2 * (1e-6 + np.spacing(np.float32(16.0)))
    jax_straight = np.asarray(_jax_tracer_run(40).sim.tp.positions)
    base = str(tmp_path / 'jax')
    j20 = _jax_tracer_run(20, checkpoint_file=base,
                          final_checkpoint=True)
    (cpoint,) = glob.glob(base + '*.cpoint.npz')
    r, _ = _cavity_tracers(max_iters=20, restore_from=cpoint)
    np.testing.assert_array_equal(r.sim.tp.to_numpy(),
                                  np.asarray(j20.sim.tp.positions))
    r, got = _cavity_tracers(restore_from=cpoint)
    assert r.sim.iteration == 40
    assert np.abs(got - jax_straight).max() <= tol
    # and back
    base = str(tmp_path / 'port')
    r20, _ = _cavity_tracers(max_iters=20, checkpoint_file=base,
                             final_checkpoint=True)
    (cpoint,) = glob.glob(base + '*.cpoint.npz')
    _r, port_straight = _cavity_tracers()
    back = _jax_tracer_run(40, restore_from=cpoint)
    assert back.sim.iteration == 40
    assert np.abs(np.asarray(back.sim.tp.positions)
                  - port_straight).max() <= tol
    assert np.abs(port_straight - CAVITY_TRACERS).max() > 1e-3
