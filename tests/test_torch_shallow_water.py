"""The D2Q9 shallow-water model of the port (``LBFreeSurface``), on the
CPU.

* ``equilibrium.shallow_water_equilibrium`` against the JAX function on
  seeded fields (1e-6).
* The torch engine (``ops/step.StepBuilder`` with
  ``equilibrium='shallow_water'``) against the JAX XLA engine's
  ``StepBuilder`` on the same node maps and state, 20 steps, wet-node f,
  rho (the water height) and u within 1e-6: the Gaussian hump of
  ``examples/torch/fs_gaussian`` (32^2, periodic), the hump under a
  constant Guo force, and channels with a native velocity / density pair
  of each family (equilibrium, Zou-He, regularized; the BC
  reconstruction takes the model's equilibrium, the regularized one adds
  its stress term to the second-order equilibrium, as the JAX engine's
  ``regularized_f`` does), those within ``BC_TOL`` = 5e-6 (see there),
  as far as the JAX fp32 engine is from the fp64 torch engine.
* ``lbm_step.step_reference`` in the shallow-water mode, the plain
  version the card holds the kernel to, against the JAX package's Pallas
  kernel ``make_kernel_2d`` (``PallasStep2D``, interpret mode, 32^2) on
  the hump, unforced and under the Guo force, 10 steps (1e-6).
* The kernel engine on the CPU equals the torch engine bit for bit;
  ``kernel_ineligibility`` names the refusals (a model other than BGK,
  the incompressible flag, EDM), and the parameter block carries the
  equilibrium code and gravity.
* The twin ``fs_gaussian`` against its golden (rtol 1e-5, atol 5e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu import equilibrium as jeq
from sailfish_tpu import lattice as jlattice
from sailfish_tpu.ops.pallas_step2d import PallasStep2D
from sailfish_tpu.ops.step import StepBuilder as JaxStepBuilder
from sailfish_tpu_torch import equilibrium as teq
from sailfish_tpu_torch import lattice
from sailfish_tpu_torch.ops import lbm_step as ls
from sailfish_tpu_torch.ops.step import StepBuilder
from sailfish_tpu_torch.state import state_to_numpy
from torch_scenes import (BC_PAIRS, SHALLOW_WATER_SCENES,
                          SINGLE_GOLDEN_FLAGS, channel_sim_2d, cpu_runner,
                          forced, golden_run, shallow_water, twin, wet_map)

torch.set_num_threads(1)

STEPS = 20
TOL = 1e-6
#: the channels with native BCs: the Zou-He / equilibrium macroscopic solve
#: assumes the second-order equilibrium's moments, and under the
#: shallow-water one (zeroth moment h (1 + 2 u.u)) the inlet feeds each
#: step's fp32 rounding back into the domain. Both fp32 engines end 1.2e-6
#: to 4.3e-6 from the fp64 torch engine after 20 steps (and from each
#: other); every other case here is within 1e-6
BC_TOL = 5e-6
SIZE = dict(lat_nx=32, lat_ny=32)
#: a constant acceleration (x, y) for the forced hump
SW_ACCEL = (2e-4, -1e-4)

SCENES = {
    'hump': lambda: (twin('fs_gaussian'), SIZE),
    'hump_guo': lambda: (forced(twin('fs_gaussian'), SW_ACCEL), SIZE),
}
for _pair in BC_PAIRS:
    SCENES[f'channel_{_pair}'] = (
        lambda p=_pair: (shallow_water(channel_sim_2d(p)),
                         dict(lat_nx=32, lat_ny=48)))


def test_equilibrium_matches_jax():
    g, jg = lattice.D2Q9, jlattice.get_grid('D2Q9')
    rng = np.random.default_rng(3)
    rho = (1.0 + 0.2 * rng.random((9, 10))).astype(np.float32)
    u = (0.05 * rng.standard_normal((2, 9, 10))).astype(np.float32)
    ours = teq.shallow_water_equilibrium(g, torch.from_numpy(rho),
                                         torch.from_numpy(u), 0.01)
    theirs = jeq.shallow_water_equilibrium(jg, jnp.asarray(rho),
                                           jnp.asarray(u), 0.01)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                               atol=1e-7)
    # its moments: momentum h u, and (with f_0's -3 u.u of the JAX form)
    # the zeroth moment h (1 + 2 u.u), not h
    usq = np.sum(u.astype(np.float64) ** 2, axis=0)
    np.testing.assert_allclose(teq.density(g, ours).numpy(),
                               rho * (1.0 + 2.0 * usq), atol=1e-6)
    np.testing.assert_allclose(teq.momentum(g, ours).numpy(), rho * u,
                               atol=1e-7)


def build(case, **extra):
    sim_cls, cfg = SCENES[case]()
    return cpu_runner(sim_cls, **cfg, **extra)


def jax_builder(r):
    b = r.builder
    return JaxStepBuilder(
        jlattice.get_grid('D2Q9'), r.maps, visc=r.config.visc,
        equilibrium='shallow_water', gravity=b.gravity,
        body_force=None if b.body_force is None else np.asarray(
            b.body_force), force_model=b.force_model, dtype=jnp.float32)


@pytest.mark.parametrize('case', sorted(SCENES))
def test_torch_engine_matches_jax_xla_engine(case):
    r = build(case)
    b = r.builder
    assert (b.equilibrium, b.gravity, r.sim.grid.name) == (
        'shallow_water', 0.001, 'D2Q9')
    jb = jax_builder(r)
    jstep = jax.jit(jb.build())
    fj = jnp.asarray(state_to_numpy(r.f))
    step = b.build()
    ft = r.f
    for it in range(STEPS):
        fj = jstep(fj, it)
        ft = step(ft, it)
    wet = wet_map(r.maps)
    fj_np = np.asarray(fj)
    rho_j, u_j = (np.asarray(x) for x in jax.jit(jb.macro_fields)(fj))
    rho_t, u_t = b.macro_fields(ft)
    errs = (float(np.max(np.abs(state_to_numpy(ft)[:, wet]
                                - fj_np[:, wet]))),
            float(np.max(np.abs(rho_t.numpy()[wet] - rho_j[wet]))),
            float(np.max(np.abs(u_t.numpy()[:, wet] - u_j[:, wet]))))
    print(case, 'max |df|, |drho|, |du|:', errs)
    assert max(errs) <= (BC_TOL if case.startswith('channel') else TOL), errs
    if case.startswith('channel'):
        # the fp64 torch engine: the fp32 one is as far from it as the JAX
        # fp32 engine
        r64 = build(case, precision='double')
        f64 = r64.f
        step64 = r64.builder.build()
        for it in range(STEPS):
            f64 = step64(f64, it)
        d64 = state_to_numpy(f64)[:, wet]
        assert np.max(np.abs(state_to_numpy(ft)[:, wet] - d64)) <= BC_TOL
        assert np.max(np.abs(fj_np[:, wet] - d64)) <= BC_TOL
    # the equilibrium acted: against the same steps with the second-order
    # one
    plain = StepBuilder(b.grid, b.maps, visc=r.config.visc,
                        body_force=b.body_force).build()
    fp = r.f
    for it in range(STEPS):
        fp = plain(fp, it)
    assert float((ft - fp).abs().max()) > 100 * TOL


@pytest.mark.parametrize('case', sorted(SCENES))
def test_kernel_engine_on_cpu_is_the_torch_engine(case):
    r = build(case)
    ks = ls.KernelStep(r.builder)
    assert ks.name == 'lbm_step_sw_d2q9' and not ks.sc
    assert ks.entry == 'lbm_step_d2q9' and ks.library == 'lbm_step'
    fk = ks.run(r.f.clone(), STEPS)
    step = r.builder.build()
    ft = r.f
    for it in range(STEPS):
        ft = step(ft, it)
    assert torch.equal(fk, ft)


@pytest.mark.parametrize('case', ['hump', 'hump_guo'])
def test_step_reference_matches_jax_pallas_interpret(case):
    """The plain version against ``make_kernel_2d``'s shallow-water
    ``_feq_i`` branch in interpret mode, 10 steps, every node wet."""
    r = build(case)
    ks = ls.KernelStep(r.builder)
    pallas = PallasStep2D(jax_builder(r), r.maps.type_map.shape,
                          interpret=True)
    steps = 10
    fj = np.asarray(pallas.run_steps(jnp.asarray(state_to_numpy(r.f)),
                                     steps))
    fr = r.f
    for _ in range(steps):
        fr = ks.reference(fr)
    err = float(np.max(np.abs(state_to_numpy(fr) - fj)))
    print(case, 'max |df| against Pallas interpret:', err)
    assert err <= TOL, err


def test_parameter_block_carries_the_equilibrium():
    r = build('hump_guo', gravity=0.02)
    ks = ls.KernelStep(r.builder)
    c = ks.params.coll
    assert (c.model, c.equilibrium, c.gravity) == (
        0, ls.EQ_CODES['shallow_water'], np.float32(0.02))
    assert ks.params.force.model == ls.FORCE_CODES['guo']


@pytest.mark.parametrize('kwargs,match', [
    (dict(model='mrt'), 'shallow water with model=mrt'),
    (dict(model='trt'), 'shallow water with model=trt'),
    (dict(smagorinsky=0.1), 'shallow water with the Smagorinsky'),
    (dict(incompressible=True), 'shallow water with --incompressible'),
    (dict(body_force=SW_ACCEL, force_model='edm'),
     'shallow water with the edm body'),
])
def test_refusals_name_the_reason(kwargs, match):
    """``LBFreeSurface`` forces BGK (as the JAX class does), so the
    builder is made directly."""
    r = build('hump')
    b = StepBuilder(r.sim.grid, r.maps, visc=0.1,
                    equilibrium='shallow_water', gravity=1e-3, **kwargs)
    reasons = ls.kernel_ineligibility(b)
    assert any(match in why for why in reasons), reasons
    with pytest.raises(NotImplementedError, match=match):
        ls.KernelStep(b)


@pytest.mark.parametrize('model', ['guo', 'velocity_shift'])
def test_other_force_models_and_bc_rows_run_in_the_kernel(model):
    assert ls.kernel_ineligibility(build(
        'hump_guo', force_implementation=model).builder) == []
    for pair in BC_PAIRS:
        assert ls.kernel_ineligibility(
            build(f'channel_{pair}').builder) == []


def test_shallow_water_needs_d2q9():
    r = cpu_runner(twin('ldc_3d'), lat_nx=8, lat_ny=8, lat_nz=8)
    with pytest.raises(NotImplementedError, match='D2Q9 only'):
        StepBuilder(r.sim.grid, r.maps, visc=0.1,
                    equilibrium='shallow_water', gravity=1e-3)


@pytest.mark.parametrize('scene', SHALLOW_WATER_SCENES)
def test_twin_matches_golden(scene, tmp_path):
    r = golden_run(twin(scene), scene, tmp_path,
                   **SINGLE_GOLDEN_FLAGS[scene])
    assert r.builder.equilibrium == 'shallow_water'
    assert ls.kernel_ineligibility(r.builder) == []
