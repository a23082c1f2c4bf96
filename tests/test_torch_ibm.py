"""The port's immersed-boundary method (``sailfish_tpu_torch/ops/ibm.py``,
``models/single.LBIBMFluidSim``) against the JAX package on the CPU.

* ``spread_forces`` and ``interpolate_velocity`` on random positions
  (neighbours sharing corner nodes, several markers in one cell,
  positions clipped at the edges), 2D and 3D, within 1e-6; the spreading
  gives the same bits twice.
* The IBM step against the JAX XLA engine: the ``ibm_cylinder`` twin at
  48x24 and a tilted ring of markers in a 16^3 periodic box
  (``torch_scenes.ibm_ring_3d``). One step from the JAX state gives its
  positions bit for bit (f within 1e-6); after 20 steps f within 1e-6 on
  wet nodes; after 20 and 200 steps f and positions within
  ``FP64_FACTOR`` times the JAX fp32 run's distance to the JAX fp64 run
  (the fp32 runs part from fp64 by ~1e-5 in position and ~1e-6 in f).
* The ``ibm_cylinder`` twin against its golden (20 steps, seed 1234,
  rtol 1e-5, atol 5e-7), and the twin of ``tests/test_ibm.py``: tethered
  particles dragged downstream until their springs hold them.
* Checkpoints (``dist0a`` = f, ``dist1a`` = positions) restore to their
  bits and continue across the packages both ways; a split run equals a
  straight run bit for bit.
* The refusals by name: the kernel engine (and any StepBuilder subclass),
  a mesh, ``--init_iters``, ``--precision=mixed``.
"""

import glob

import jax
import numpy as np
import pytest
import torch

from sailfish_tpu.controller import \
    LBSimulationController as JaxController
from sailfish_tpu.models.single import LBIBMFluidSim as JaxIBMFluidSim
from sailfish_tpu.models.single import Particle as JaxParticle
from sailfish_tpu.ops import ibm as jibm
from sailfish_tpu.subdomain import Subdomain3D as JaxSubdomain3D
from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.models.single import LBIBMFluidSim, Particle
from sailfish_tpu_torch.ops import ibm
from sailfish_tpu_torch.ops.step import StepBuilder
from sailfish_tpu_torch.subdomain import Subdomain2D
from torch_scenes import (FP64_FACTOR, SINGLE_GOLDEN_FLAGS, cpu_runner,
                          golden_run, ibm_ring_3d, load_example, run, twin,
                          wet_map)

torch.set_num_threads(1)

CYL = SINGLE_GOLDEN_FLAGS['ibm_cylinder']


def _positions(dim, shape, n, seed):
    """(dim, n) positions in (x, y[, z]) order: pairs 1.4 nodes apart and
    triples in one cell (shared corners), and some outside the domain
    (clipped corners)."""
    rng = np.random.default_rng(seed)
    sizes = np.array(tuple(reversed(shape)), dtype=np.float64)[:, None]
    pos = rng.uniform(0.5, 1.0, (dim, n)) * (sizes - 1.0)
    pos[:, 1:n // 4:2] = pos[:, 0:n // 4 - 1:2] + 1.4 / np.sqrt(dim)
    pos[:, n // 4:n // 2] = np.floor(pos[:, n // 4:n // 4 + 1]) \
        + rng.uniform(0.0, 1.0, (dim, n // 4))
    pos[0, -3] = -0.7
    pos[-1, -2] = sizes[-1, 0] - 0.3
    pos[:, -1] = sizes[:, 0] + 0.6
    return pos


@pytest.mark.parametrize('dim', [2, 3])
def test_spread_and_interpolate_match_jax(dim):
    shape = (12, 10, 14)[3 - dim:]
    pos = _positions(dim, shape, 40, seed=dim)
    rng = np.random.default_rng(10 + dim)
    ref = pos + rng.normal(0.0, 0.5, pos.shape)
    stiff = rng.uniform(0.01, 0.1, pos.shape[1])
    u = rng.normal(0.0, 0.05, (dim,) + shape)
    f32 = np.float32
    t = [torch.as_tensor(a.astype(f32)) for a in (pos, ref, stiff, u)]
    j = [jax.numpy.asarray(a.astype(f32)) for a in (pos, ref, stiff, u)]
    force = ibm.spread_forces(t[0], t[1], t[2], shape, torch.float32)
    jforce = np.asarray(jibm.spread_forces(j[0], j[1], j[2], shape,
                                           jax.numpy.float32))
    assert np.abs(force.numpy() - jforce).max() <= 1e-6
    # every particle's weights sum to 1, clipped corners included: the
    # grid holds the springs' total force
    spring = -stiff[None] * (pos - ref)
    assert np.abs(force.double().sum(dim=tuple(range(1, dim + 1))).numpy()
                  - spring.sum(axis=1)).max() <= 1e-5
    again = ibm.spread_forces(t[0], t[1], t[2], shape, torch.float32)
    assert torch.equal(force, again)
    vel = ibm.interpolate_velocity(t[3], t[0])
    jvel = np.asarray(jibm.interpolate_velocity(j[3], j[0]))
    assert np.abs(vel.numpy() - jvel).max() <= 1e-6


def _jax_ring():
    return ibm_ring_3d(JaxSubdomain3D, JaxIBMFluidSim, JaxParticle)


#: scene -> (port sim class, JAX sim class, flags)
SCENES = {
    'ibm_cylinder': (lambda: twin('ibm_cylinder'),
                     lambda: load_example('ibm_cylinder.py',
                                          'jax_ibm_cylinder').IBMSim, CYL),
    'ibm_ring_3d': (ibm_ring_3d, _jax_ring, {}),
}


def _jax_runner(sim, steps, double=False, **cfg):
    c = JaxController(sim, default_config=dict(
        platform='cpu', max_iters=steps, every=steps, quiet=True,
        engine='xla', precision='double' if double else 'single', **cfg))
    try:
        c.run(ignore_cmdline=True)
    finally:
        # x64 is process-global in JAX
        jax.config.update('jax_enable_x64', False)
    return c._runner


def _state(f):
    return [np.asarray(x) for x in f]


def _states(r, run_to, steps=(20, 200), double=False):
    """The runner ``r``'s state (numpy f, positions) after each of
    ``steps``, continuing its main loop (``run_to(r, n)``)."""
    out = []
    for n in steps:
        if double:
            jax.config.update('jax_enable_x64', True)
        try:
            run_to(r, n)
        finally:
            jax.config.update('jax_enable_x64', False)
        out.append(_state(r.f))
    return out


def _continue(r, n):
    r.config.max_iters = n
    r.main()


@pytest.mark.parametrize('scene', sorted(SCENES))
def test_step_matches_the_jax_xla_engine(scene):
    """One step from the JAX engine's state moves the particles to its
    bits (f within 1e-6); over 20 and 200 steps the two fp32 engines' f
    parts by ulps, which the springs carry into the positions (3 fp32
    ulps after 20 steps at 48x24), so the runs are held to the JAX fp64
    run: within ``FP64_FACTOR`` times the JAX fp32 run's distance to it,
    f also within 1e-6 after 20 steps."""
    port, jax_sim, cfg = SCENES[scene]
    r = run(port(), platform='cpu', max_iters=0, **cfg)
    assert r.engine == 'torch'
    wet = wet_map(r.maps)
    jr = _jax_runner(jax_sim(), 0, **cfg)
    j64 = _jax_runner(jax_sim(), 0, double=True, **cfg)
    ours = _states(r, _continue)
    theirs = _states(jr, _continue)
    exact = _states(j64, _continue, double=True)
    assert np.abs(ours[0][0][:, wet] - theirs[0][0][:, wet]).max() <= 1e-6
    for (f, pos), (jf, jpos), (f64, pos64) in zip(ours, theirs, exact):
        for got, ref, x in ((f[:, wet], jf[:, wet], f64[:, wet]),
                            (pos, jpos, pos64)):
            assert np.abs(got - x).max() <= FP64_FACTOR * max(
                np.abs(ref - x).max(), np.spacing(np.float32(1.0)))
    moved = np.abs(ours[1][1] - r.builder.ref_pos.numpy()).max()
    assert moved > 1e-2, moved
    # one step from the JAX state after 200 steps
    jf, jpos = theirs[1]
    f, pos = r.builder.build()((torch.as_tensor(jf.copy()),
                                torch.as_tensor(jpos.copy())), 200)
    jr.config.max_iters = 201
    jr.main()
    jf, jpos = _state(jr.f)
    assert np.array_equal(pos.numpy(), jpos)
    assert np.abs(f.numpy()[:, wet] - jf[:, wet]).max() <= 1e-6


def test_ibm_cylinder_matches_golden(tmp_path):
    golden_run(twin('ibm_cylinder'), 'ibm_cylinder', tmp_path, **CYL)


def test_particle_drag_equilibrium():
    """Twin of tests/test_ibm.py: tethered particles in a channel driven by
    a body force are dragged downstream until the springs balance the
    flow; the y displacement stays small by symmetry."""
    class Chan(Subdomain2D):
        def boundary_conditions(self, hx, hy):
            pass

        def initial_conditions(self, sim, hx, hy):
            sim.rho[:] = 1.0

    class Sim(LBIBMFluidSim):
        subdomain = Chan

        def __init__(self, config):
            super().__init__(config)
            self.add_body_force((1e-5, 0.0))
            self.add_particle(Particle((16.0, 16.0), stiffness=0.05))
            self.add_particle(Particle((8.0, 8.0), stiffness=0.05))

    r = run(Sim, platform='cpu', lat_nx=32, lat_ny=32, visc=0.05,
            max_iters=1500, every=1500, periodic_x=True, periodic_y=True)
    pos = r.sim.particle_positions(r)
    assert np.all(np.isfinite(pos))
    assert pos[0, 0] > 16.0 and pos[0, 1] > 8.0
    assert pos[0, 0] < 20.0
    assert abs(pos[1, 0] - 16.0) < 0.1
    r._fields_to_host()
    assert np.all(np.isfinite(r.sim.vx))


def test_checkpoints_continue_across_the_packages(tmp_path):
    """A JAX checkpoint after 10 steps restores here to its bits and
    continues: port 10 more ~ JAX 20; and back: port 10 -> JAX 10 ~ JAX
    20 (f within 1e-6 on wet nodes, positions within ``FP64_FACTOR``
    times the JAX fp32 run's distance to its fp64 run, as the step test
    holds them); the port's split run equals its straight run bit for
    bit."""
    jax_sim = SCENES['ibm_cylinder'][1]()
    jf, jpos = _state(_jax_runner(jax_sim, 20, **CYL).f)
    _f64, pos64 = _state(_jax_runner(jax_sim, 20, double=True, **CYL).f)
    pos_tol = FP64_FACTOR * np.abs(jpos - pos64).max()

    def port_run(iters, **extra):
        return run(twin('ibm_cylinder'), platform='cpu', max_iters=iters,
                   every=iters, **CYL, **extra)

    def check(f, pos):
        assert np.abs(f[:, wet] - jf[:, wet]).max() <= 1e-6
        assert np.abs(pos - pos64).max() <= pos_tol

    # the JAX package's checkpoint, restored and continued here
    base = str(tmp_path / 'jax')
    _jax_runner(jax_sim, 10, checkpoint_file=base, final_checkpoint=True,
                **CYL)
    (cpoint,) = glob.glob(base + '*.cpoint.npz')
    saved = np.load(cpoint)
    r = port_run(10, restore_from=cpoint)
    wet = wet_map(r.maps)
    for got, key in zip(r.f, ('dist0a', 'dist1a')):
        assert np.array_equal(got.numpy(), saved[key]), key
    r = port_run(20, restore_from=cpoint)
    assert r.sim.iteration == 20
    check(*_state(r.f))
    # the port's checkpoint, continued by the JAX package
    base = str(tmp_path / 'port')
    port_run(10, checkpoint_file=base, final_checkpoint=True)
    (cpoint,) = glob.glob(base + '*.cpoint.npz')
    saved = np.load(cpoint)
    assert saved['dist0a'].shape == (9, 24, 48)
    assert saved['dist1a'].shape == (2, 36)
    check(*_state(_jax_runner(jax_sim, 20, restore_from=cpoint, **CYL).f))
    # split == straight, bit for bit
    split = port_run(20, restore_from=cpoint)
    straight = port_run(20)
    for a, b in zip(split.f, straight.f):
        assert torch.equal(a, b)


def _refuse_kernel(r):
    return r._kernel_engine()


def _subclass_kernel(r):
    class Sub(StepBuilder):
        pass
    return r._kernel_engine(Sub(r.sim.grid, r.maps, visc=0.05))


@pytest.mark.parametrize('case,match', [
    ('kernel', r'IBMStepBuilder.*sailfish_tpu/runner.py:328.*--engine=torch'),
    ('subclass', r'Sub is not a StepBuilder.*--engine=torch'),
    ('mesh', r'--mesh.*immersed-boundary.*device_put.*runner.py:90-92'),
    ('init_iters', r'--init_iters covers single-fluid scenes only '
     r'\(got IBMStepBuilder\)'),
    ('mixed', r'--precision=mixed covers single-fluid scenes only'),
])
def test_refused_by_name(case, match):
    if case in ('kernel', 'subclass'):
        r = cpu_runner(twin('ibm_cylinder'), **CYL)
        call = _refuse_kernel if case == 'kernel' else _subclass_kernel
        with pytest.raises(NotImplementedError, match=match):
            call(r)
        return
    flags = {'mesh': dict(mesh='2'), 'init_iters': dict(init_iters=5),
             'mixed': dict(precision='mixed')}[case]
    ctrl = LBSimulationController(twin('ibm_cylinder'), default_config=dict(
        platform='cpu', max_iters=2, quiet=True, **CYL, **flags))
    with pytest.raises(NotImplementedError, match=match):
        ctrl.run(ignore_cmdline=True)


def test_auto_engine_on_a_card_refuses_ibm(monkeypatch):
    """Where the default engine is the kernel (a CUDA device), an IBM
    scene raises and names --engine=torch: it never runs the kernel
    without the spring force."""
    from sailfish_tpu_torch.runner import SubdomainRunner
    monkeypatch.setattr(SubdomainRunner, '_select_engine',
                        lambda self: 'kernel')
    ctrl = LBSimulationController(twin('ibm_cylinder'), default_config=dict(
        platform='cpu', max_iters=2, quiet=True, **CYL))
    with pytest.raises(NotImplementedError, match='--engine=torch'):
        ctrl.run(ignore_cmdline=True)
