"""The port's statistics (``sailfish_tpu_torch.stats``), data processing
(``sailfish_tpu_torch.data_processing``) and hook-state checkpoints,
against the JAX package on the CPU; and the five twins whose scenes run
device hooks against their goldens.

* Reynolds statistics of ``channel_flow`` at the golden harness's flags
  (``--H=8 --Re_tau=60 --wall=tms --stats_every=5``, 20 steps): the
  device mode (a hook from ``from_iter`` = 10) and the host mode
  (``collect_reynolds_stats`` after every 5-step chunk) agree with the JAX
  XLA engine's within 1e-5 relative to the magnitude of the terms each
  profile averages (a mean of terms that cancel, as the wall-normal
  velocity's, is held to that, not to its own small value), in fp32 and
  in fp64; the kinetic energy and enstrophy of the Kida vortex within
  rtol 1e-5 / atol 1e-7, the hook series' tolerance.
* Checkpoints with hook state (a Reynolds accumulator and a series hook):
  written by JAX and restored by the port, and back, the continued run
  agrees with the unbroken run of the other package within 1e-5 relative
  (the states within 1e-6); a restored port run continues the
  accumulators to the unbroken port run's bits; a checkpoint whose hook
  leaves do not match the scene's hooks raises.
* ``data_processing``: reductions (sum, mean, max, axis profiles,
  products), slices and the device series agree with JAX's on the
  Taylor-Green vortex (2D) and the lid-driven cavity (3D), within 1e-5
  relative (rtol; atol 1e-5 of the largest magnitude for sums of terms
  that cancel).
* Goldens (20 steps, seed 1234, rtol 1e-5, atol 5e-7): ``kida_vortex``,
  ``channel_flow``, ``channel_cube``, ``ldc_2d_unorm`` and
  ``fe_capillary_wave_2d``. ``channel_cube`` (tau = 0.5005) carries the
  ulp differences of two correct fp32 engines up to 9.5e-7 in vz at 5 of
  2,940 nodes, so vz is held to atol 1e-6, and the twin's state to the JAX
  XLA engine's within 1e-6 (the port in fp64 is 5.3e-7 from the fp32
  golden in vx: the golden's own rounding).
"""

import glob
import os

import jax
import numpy as np
import pytest
import torch

from sailfish_tpu.controller import \
    LBSimulationController as JaxController
from sailfish_tpu.data_processing import \
    DataProcessingMixIn as JaxDataProcessingMixIn
from sailfish_tpu.models.single import LBFluidSim as JaxFluidSim
from sailfish_tpu.stats import ReynoldsStatsMixIn as JaxReynoldsStatsMixIn
from sailfish_tpu.subdomain import Subdomain2D as JaxSubdomain2D
from sailfish_tpu_torch.data_processing import DataProcessingMixIn
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.state import tree_leaves
from sailfish_tpu_torch.stats import ReynoldsStatsMixIn
from sailfish_tpu_torch.subdomain import Subdomain2D
from torch_scenes import (FE_HALFWAY_GOLDEN_FLAGS, REPO, SINGLE_GOLDEN_FLAGS,
                          TURBULENCE_GOLDEN_FLAGS, binary_twin, golden_run,
                          load_example, run, turbulence_twin, twin)

torch.set_num_threads(1)


def jax_runner(sim_cls, **cfg):
    jc = JaxController(sim_cls, default_config=dict(
        quiet=True, platform='cpu', engine='xla', **cfg))
    jc.run(ignore_cmdline=True)
    assert jc._runner.engine == 'xla'
    return jc._runner


def jax_scene(rel, name, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, 'examples'))
    monkeypatch.syspath_prepend(os.path.join(REPO, 'examples',
                                             'turbulence'))
    return load_example(rel, f'jax_{name}')


def _term_scales(stats):
    """Per key of a ``reynolds_stats`` dict, the magnitude of the terms it
    averages: m2^(p/2) for the p-th moment of a field (m2 the largest
    second moment over the profile), sqrt(m2_a m2_b) for the correlation
    of a and b. A mean of terms that cancel (the wall-normal velocity's)
    is held relative to this, not to its own small value."""
    m2 = {k: float(np.abs(v[1]).max()) for k, v in stats.items()
          if len(v) == 4}
    out = {}
    for k in stats:
        if k in m2:
            out[k] = np.array([m2[k] ** (p / 2) for p in range(1, 5)])[:, None]
        else:
            a, b = ('rho', k[3:]) if k.startswith('rho') else (k[0], k[1:])
            out[k] = np.sqrt(m2[a] * m2[b])
    return out


def assert_profiles_close(mine, theirs, rtol=1e-5):
    """Each profile of ``mine`` within ``rtol`` of ``theirs``, relative to
    the magnitude of the terms it averages (``_term_scales``)."""
    assert sorted(mine) == sorted(theirs)
    theirs = {k: np.asarray(v) for k, v in theirs.items()}
    scales = _term_scales(theirs)
    for k, ref in theirs.items():
        assert mine[k].shape == ref.shape and mine[k].dtype == ref.dtype, k
        err = np.abs(mine[k] - ref) - rtol * np.abs(ref)
        assert np.all(err <= rtol * scales[k]), (k, float(
            (np.abs(mine[k] - ref) / scales[k]).max()))


def _host_mode(sim_cls):
    """``sim_cls`` sampling its Reynolds statistics on the host after every
    chunk instead of through its device hook."""

    class Sim(sim_cls):
        def before_main_loop(self, runner):
            self.prepare_reynolds_stats(runner, axis='y')

        def after_step(self, runner):
            self.collect_reynolds_stats(runner)

    return Sim


@pytest.mark.parametrize('precision', ['single', 'double'])
@pytest.mark.parametrize('mode', ['device', 'host'])
def test_reynolds_stats_match_the_jax_xla_engine(mode, precision,
                                                  monkeypatch):
    flags = dict(TURBULENCE_GOLDEN_FLAGS['channel_flow'], max_iters=20,
                 every=5 if mode == 'host' else 20, seed=1234,
                 precision=precision)
    mine_cls = turbulence_twin('channel_flow')
    theirs_cls = jax_scene('turbulence/channel_flow.py', 'channel_flow',
                           monkeypatch).ChannelSim
    if mode == 'host':
        mine_cls, theirs_cls = _host_mode(mine_cls), _host_mode(theirs_cls)
    r = run(mine_cls, platform='cpu', **flags)
    try:
        jr = jax_runner(theirs_cls, **flags)
    finally:
        # x64 is process-global in JAX
        jax.config.update('jax_enable_x64', False)
    mine, theirs = r.sim.reynolds_stats(), jr.sim.reynolds_stats()
    assert_profiles_close(mine, theirs)
    want = np.float64 if precision == 'double' else np.float32
    assert mine['u'].dtype == want
    assert sorted(mine) == ['rho', 'rhou', 'rhov', 'rhow', 'u', 'uv', 'uw',
                            'v', 'vw', 'w']
    assert mine['u'].shape == (4, r.config.lat_ny)
    if mode == 'device':
        cnt, _acc = r.device_hook_state[0]
        assert int(cnt) == 3 and r.sim._reynolds_samples == 0  # 10, 15, 20
    else:
        assert r.device_hook_state == () and r.sim._reynolds_samples == 4


def test_ke_enstrophy_match_the_jax_xla_engine(monkeypatch):
    flags = dict(TURBULENCE_GOLDEN_FLAGS['kida_vortex'], max_iters=20,
                 every=20, seed=1234)
    r = run(turbulence_twin('kida_vortex'), platform='cpu', **flags)
    jr = jax_runner(jax_scene('turbulence/kida_vortex.py', 'kida_vortex',
                              monkeypatch).KidaSim, **flags)
    mine = r.sim.compute_ke_enstrophy(r)
    theirs = jr.sim.compute_ke_enstrophy(jr)
    # the hook series' tolerance (the enstrophy, of central differences,
    # is 1.5e-5 apart relative)
    np.testing.assert_allclose(mine, theirs, rtol=1e-5, atol=1e-7)
    assert min(mine) > 0


def _tgv(base):
    class TGV(base):
        def boundary_conditions(self, hx, hy):
            pass

        def initial_conditions(self, sim, hx, hy):
            k = 2 * np.pi / self.gx
            sim.rho[:] = 1.0
            sim.vx[:] = -0.03 * np.cos(k * hx) * np.sin(k * hy)
            sim.vy[:] = 0.03 * np.sin(k * hx) * np.cos(k * hy)

    return TGV


def _checkpointed(base_sim, base_domain, stats_mixin, torch_side,
                  series=True):
    """A Taylor-Green sim with Reynolds statistics on a device hook (every
    3 from iteration 4) and, with ``series``, a hook keeping a (slots, 2)
    series of (it, mean rho) every 5 iterations."""

    class Sim(base_sim, stats_mixin):
        subdomain = _tgv(base_domain)

        def before_main_loop(self, runner):
            self.prepare_reynolds_stats(runner, axis='y', every=3,
                                        from_iter=4)
            if not series:
                return
            if torch_side:
                def hook(f, s, it):
                    if it % 5 == 0:
                        rho, _ = runner.builder.macro_fields(f)
                        s[it // 5, 0] = float(it)
                        s[it // 5, 1] = rho.mean()
                    return s
                init = torch.zeros((8, 2), dtype=torch.float32)
            else:
                import jax
                import jax.numpy as jnp

                def hook(f, s, it):
                    def do(s):
                        rho, _ = runner.builder.macro_fields(f)
                        row = jnp.stack([jnp.asarray(it, jnp.float32),
                                         rho.mean()])
                        return s.at[it // 5].set(row)
                    return jax.lax.cond(it % 5 == 0, do, lambda s: s, s)
                init = jnp.zeros((8, 2), jnp.float32)
            self.add_device_hook(init, hook, every=5)

    return Sim


CHECKPOINT_CFG = dict(lat_nx=16, lat_ny=16, visc=0.02, periodic_x=True,
                      periodic_y=True)


def _port_run(tmp_path, iters, series=True, **extra):
    return run(_checkpointed(LBFluidSim, Subdomain2D, ReynoldsStatsMixIn,
                             True, series),
               platform='cpu', max_iters=iters, every=iters,
               **CHECKPOINT_CFG, **extra)


def _jax_run(iters, **extra):
    return jax_runner(_checkpointed(JaxFluidSim, JaxSubdomain2D,
                                    JaxReynoldsStatsMixIn, False),
                      max_iters=iters, every=iters, **CHECKPOINT_CFG,
                      **extra)


def _cpoint(base):
    (cpoint,) = glob.glob(base + '*.cpoint.npz')
    return cpoint


def _assert_hook_states_close(mine, theirs):
    (cnt, acc, series), (jcnt, jacc, jseries) = \
        (mine[0][0], mine[0][1], mine[1]), \
        (theirs[0][0], theirs[0][1], theirs[1])
    assert int(cnt) == int(jcnt) == 6   # 6, 9, ..., 21 of 21
    assert_profiles_close({k: v.numpy() for k, v in acc.items()},
                          {k: np.asarray(v) for k, v in jacc.items()})
    np.testing.assert_array_equal(series[:, 0].numpy(),
                                  np.asarray(jseries)[:, 0])
    np.testing.assert_allclose(series[:, 1].numpy(),
                               np.asarray(jseries)[:, 1], rtol=1e-6)


def test_jax_hook_checkpoint_continues_in_the_port(tmp_path):
    base = str(tmp_path / 'jax')
    _jax_run(11, checkpoint_file=base, final_checkpoint=True)
    with np.load(_cpoint(base)) as cp:
        # Reynolds: (count, the 6 profiles of 2D in sorted key order),
        # then the series
        assert {k for k in cp.files if k.startswith('hook')} == \
            {f'hook{i}' for i in range(8)}
        assert cp['hook7'].shape == (8, 2)
        assert cp['hook0'].dtype == np.int32 and int(cp['hook0']) == 2
    r = _port_run(tmp_path, 21, restore_from=_cpoint(base))
    ref = _jax_run(21)
    assert r.sim.iteration == 21
    _assert_hook_states_close(r.device_hook_state, ref.device_hook_state)
    np.testing.assert_allclose(r.f.numpy(), np.asarray(ref.f), atol=1e-6)


def test_port_hook_checkpoint_continues_in_the_jax_package(tmp_path):
    base = str(tmp_path / 'port')
    _port_run(tmp_path, 11, checkpoint_file=base, final_checkpoint=True)
    restored = _jax_run(21, restore_from=_cpoint(base))
    mine = _port_run(tmp_path, 21)
    assert restored.sim.iteration == 21
    _assert_hook_states_close(mine.device_hook_state,
                              restored.device_hook_state)
    assert_profiles_close(mine.sim.reynolds_stats(),
                          restored.sim.reynolds_stats())


@pytest.mark.parametrize('mode', ['device', 'host'])
def test_restored_run_continues_the_accumulators(mode, tmp_path):
    """10 + 11 steps through a checkpoint give the unbroken run's bits:
    the device accumulators through ``hook{i}``, the host ones through the
    pickled sim state."""
    def port(iters, **extra):
        sim = _checkpointed(LBFluidSim, Subdomain2D, ReynoldsStatsMixIn,
                            True)
        if mode == 'host':
            sim = _host_mode(sim)
        return run(sim, platform='cpu', max_iters=iters, every=5,
                   **CHECKPOINT_CFG, **extra)

    base = str(tmp_path / 'cp')
    port(10, checkpoint_file=base, final_checkpoint=True)
    restored = port(21, restore_from=_cpoint(base))
    whole = port(21)
    assert torch.equal(restored.f, whole.f)
    a, b = restored.sim.reynolds_stats(), whole.sim.reynolds_stats()
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    if mode == 'host':
        assert restored.sim._reynolds_samples == 5   # chunks to 5 ... 21
    else:
        for x, y in zip(tree_leaves(restored.device_hook_state),
                        tree_leaves(whole.device_hook_state)):
            assert torch.equal(x, y)


def test_mismatched_hook_structure_raises(tmp_path):
    base = str(tmp_path / 'cp')
    _port_run(tmp_path, 6, checkpoint_file=base, final_checkpoint=True)
    # the Reynolds hook alone: one leaf fewer than the checkpoint holds
    with pytest.raises(ValueError, match='device-hook state'):
        _port_run(tmp_path, 10, series=False, restore_from=_cpoint(base))
    # no hook at all
    with pytest.raises(ValueError, match='registers no device hook'):
        run(twin('taylor_green_2d'), platform='cpu', max_iters=10,
            every=10, lat_nx=16, lat_ny=16, restore_from=_cpoint(base))


def _dp_sims(dim):
    """The port's and JAX's scene with DataProcessingMixIn and the same
    reductions, slices and series: the Taylor-Green vortex (2D) or the
    lid-driven cavity (3D)."""

    def before(self, runner):
        self.add_reduction(runner, 'mass', ['rho'])
        self.add_reduction(runner, 'ke_profile', ['usq'], axis='y',
                           op='mean')
        self.add_reduction(runner, 'uv_corr', ['vx', 'vy'],
                           stats=[[(0, 1), (1, 1)], [(0, 2)]])
        self.add_reduction(runner, 'vmax', ['vx'], axis='x', op='max')
        self.add_reduction(runner, 'rhomin', ['rho'], op='min')
        self.add_slice(runner, 'row', 'y', 7, fields=('rho', 'vx'))
        self.add_reduction(runner, 'ke', ['usq'], op='sum', every=10)
        if dim == 3:
            self.add_reduction(runner, 'w_profile', ['vz'], axis='z',
                               op='mean', stats=[[(0, 2)]], every=20)
            self.add_slice(runner, 'plane', 'z', 5, fields=('vz',))

    if dim == 2:
        mine_base = type('TGV', (LBFluidSim,), {'subdomain':
                                                 _tgv(Subdomain2D)})
        theirs_base = type('TGV', (JaxFluidSim,),
                           {'subdomain': _tgv(JaxSubdomain2D)})
        cfg = dict(lat_nx=32, lat_ny=32, visc=0.02, periodic_x=True,
                   periodic_y=True)
    else:
        mine_base = twin('ldc_3d')
        theirs_base = load_example('ldc_3d.py', 'jax_ldc_3d').LDCSim
        cfg = dict(lat_nx=16, lat_ny=12, lat_nz=10)
    mine = type('Sim', (mine_base, DataProcessingMixIn),
                {'before_main_loop': before})
    theirs = type('Sim', (theirs_base, JaxDataProcessingMixIn),
                  {'before_main_loop': before})
    return mine, theirs, cfg


@pytest.mark.parametrize('dim', [2, 3])
def test_data_processing_matches_the_jax_package(dim):
    mine_cls, theirs_cls, cfg = _dp_sims(dim)
    cfg = dict(cfg, max_iters=40, every=40)
    r = run(mine_cls, platform='cpu', **cfg)
    jr = jax_runner(theirs_cls, **cfg)
    names = ['mass', 'ke_profile', 'uv_corr', 'vmax', 'rhomin', 'row']
    if dim == 3:
        names.append('plane')
    for name in names:
        mine = r.sim.compute_reduction(r, name)
        theirs = np.asarray(jr.sim.compute_reduction(jr, name))
        assert mine.shape == theirs.shape and mine.dtype == theirs.dtype, \
            name
        np.testing.assert_allclose(mine, theirs, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(theirs).max()),
                                   err_msg=name)
    series = ['ke'] + (['w_profile'] if dim == 3 else [])
    for name in series:
        mine = r.sim.reduction_series(name)
        theirs = np.asarray(jr.sim.reduction_series(name))
        assert mine.shape == theirs.shape, name
        assert np.all(mine != 0), name   # no zero row at the head
        np.testing.assert_allclose(mine, theirs, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(theirs).max()),
                                   err_msg=name)
    assert r.sim.reduction_series('ke').shape == (4, 1)


#: the twins whose scenes run device hooks -> (class, golden, flags, atol)
HOOK_GOLDENS = {
    'kida_vortex': (lambda: turbulence_twin('kida_vortex'),
                    'turbulence_kida_vortex',
                    TURBULENCE_GOLDEN_FLAGS['kida_vortex'], None),
    'channel_flow': (lambda: turbulence_twin('channel_flow'),
                     'turbulence_channel_flow',
                     TURBULENCE_GOLDEN_FLAGS['channel_flow'], None),
    'channel_cube': (lambda: turbulence_twin('channel_cube'),
                     'turbulence_channel_cube',
                     TURBULENCE_GOLDEN_FLAGS['channel_cube'], {'vz': 1e-6}),
    'ldc_2d_unorm': (lambda: twin('ldc_2d_unorm'), 'ldc_2d_unorm',
                     SINGLE_GOLDEN_FLAGS['ldc_2d_unorm'], None),
    'fe_capillary_wave_2d': (
        lambda: binary_twin('fe_capillary_wave_2d'),
        'binary_fluid_fe_capillary_wave_2d',
        FE_HALFWAY_GOLDEN_FLAGS['fe_capillary_wave_2d'], None),
}


@pytest.mark.parametrize('scene', sorted(HOOK_GOLDENS))
def test_hooked_twin_matches_golden(scene, tmp_path):
    make, golden, flags, atol = HOOK_GOLDENS[scene]
    r = golden_run(make(), golden, tmp_path, atol=atol, **flags)
    assert len(r.device_hook_state) == 1


def test_channel_cube_state_matches_the_jax_xla_engine(monkeypatch):
    flags = dict(TURBULENCE_GOLDEN_FLAGS['channel_cube'], max_iters=20,
                 every=20, seed=1234)
    r = run(turbulence_twin('channel_cube'), platform='cpu', **flags)
    jr = jax_runner(jax_scene('turbulence/channel_cube.py', 'channel_cube',
                              monkeypatch).CubeChannelSim, **flags)
    for mine, theirs in zip(r.f, jr.f):
        assert float(np.abs(mine.numpy() - np.asarray(theirs)).max()) \
            <= 1e-6
