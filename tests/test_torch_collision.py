"""The single-fluid collision models of the port on the CPU: MRT/TRT,
Smagorinsky LES and the incompressible equilibrium, on the torch engine and
in the kernel engine's plain version, against the JAX package.

* ``lattice``: the MRT rate vector, moment matrix and inverse equal JAX's
  (D2Q9, D3Q19; tau 0.52, 0.8, 1, 3); TRT takes the MRT vector.
* ``collide.mrt_collide`` and ``smagorinsky_tau_inv`` against the JAX
  functions on seeded fields (1e-6).
* The torch ``StepBuilder`` against the JAX XLA engine's on the same node
  maps and state, 20 steps, wet-node max |df| <= 1e-6: {mrt, trt, les,
  mrt + les, incompressible, incompressible + mrt / les} x the three force
  models on sphere_3d 32x16x16 and a forced ldc_2d 64^2 (after
  tests/test_sharded_pallas.py:171-200), a channel with regularized
  faces under mrt (after :618), and the half-way, TMS and slip walls
  under mrt, les and incompressible. Each model moves the state away
  from BGK.
* ``step_reference`` (the kernel's plain version) with the model against
  the torch step (1e-6), and the kernel engine's parameter block.
* mrt and les on the 2D and 3D cavities at tau = 0.65 through the port's
  controller against the JAX Pallas engine in interpret mode: rho 2e-6,
  vx 1e-6 (tests/test_pallas2d.py:99-100, tests/test_sharded_pallas.py:165),
  each model moving the fields from BGK's by more than that.
* The shear-wave viscosity within 2 % for bgk/mrt/trt, and LES more
  dissipative than BGK (after tests/test_models.py:37-48).
* trt bit-identical to mrt on both engines; ``--model=elbm`` runs on
  both (tests/test_torch_entropic.py holds it against JAX), and the kernel
  names the product-form equilibrium it refuses.
"""

import ctypes
import functools

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
from sailfish_tpu_torch import equilibrium as teq
from sailfish_tpu_torch import lattice
from sailfish_tpu_torch.ops import collide as tco
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.ops import lbm_step as ls
from sailfish_tpu_torch.ops.step import FORCE_MODELS, StepBuilder
from sailfish_tpu_torch.state import state_to_numpy
from sailfish_tpu_torch.subdomain import Subdomain2D
from torch_scenes import (ACCEL, SINGLE_GOLDEN_FLAGS, WALLS, box_cfg,
                          box_sim, channel_sim, cpu_runner, forced,
                          load_example, random_feq, run, twin, unforced,
                          wet_map)

torch.set_num_threads(1)

STEPS = 20
TOL = 1e-6
SMAG = 0.1
#: collision model -> StepBuilder keywords (the JAX builder's names)
MODELS = {
    'mrt': dict(model='mrt'),
    'trt': dict(model='trt'),
    'les': dict(smagorinsky=SMAG),
    'mrt_les': dict(model='mrt', smagorinsky=SMAG),
    'incompressible': dict(incompressible=True),
    'incompressible_mrt': dict(incompressible=True, model='mrt'),
    'incompressible_les': dict(incompressible=True, smagorinsky=SMAG),
}
#: the same as controller flags
FLAGS = {
    'mrt': dict(model='mrt'),
    'trt': dict(model='trt'),
    'les': dict(subgrid='les-smagorinsky', smagorinsky_const=SMAG),
    'mrt_les': dict(model='mrt', subgrid='les-smagorinsky',
                    smagorinsky_const=SMAG),
    'incompressible': dict(incompressible=True),
    'incompressible_mrt': dict(incompressible=True, model='mrt'),
    'incompressible_les': dict(incompressible=True,
                               subgrid='les-smagorinsky',
                               smagorinsky_const=SMAG),
}
#: the scenes: the force-driven sphere and the cavity under a force
SCENES = {
    'sphere_3d': lambda: (twin('sphere_3d'),
                          SINGLE_GOLDEN_FLAGS['sphere_3d']),
    'ldc_2d': lambda: (forced(twin('ldc_2d'), (1e-5, -4e-6)),
                       dict(lat_nx=64, lat_ny=64, visc=0.05)),
}
# (the cavity's own viscosity gives tau = 1, where the odd MRT rate equals
# the even one and MRT is BGK)


@pytest.mark.parametrize('tau', [0.52, 0.8, 1.0, 3.0])
@pytest.mark.parametrize('name', ['D2Q9', 'D3Q19'])
def test_mrt_tables_match_jax(name, tau):
    g, jg = lattice.get_grid(name), jlattice.get_grid(name)
    np.testing.assert_array_equal(g.mrt_matrix, jg.mrt_matrix)
    np.testing.assert_array_equal(g.mrt_inv, jg.mrt_inv)
    for key in ('mrt_conserved', 'mrt_shear', 'mrt_energy', 'mrt_parity'):
        np.testing.assert_array_equal(getattr(g, key), getattr(jg, key))
    np.testing.assert_array_equal(g.mrt_relaxation_rates(tau),
                                  jg.mrt_relaxation_rates(tau))
    # trt keeps the mrt vector; the kernel splits it into one even and one
    # odd rate, 1/tau and the TRT magic rate
    r = cpu_runner(twin('ldc_2d' if name == 'D2Q9' else 'ldc_3d'),
                   **{'lat_nx': 8, 'lat_ny': 8, 'lat_nz': 8}, model='trt',
                   visc=(tau - 0.5) / 3.0)
    np.testing.assert_array_equal(r.builder.mrt_rates,
                                  g.mrt_relaxation_rates(r.builder.tau))
    s_e, s_o = ls.mrt_pair_rates(g, r.builder.mrt_rates)
    assert s_e == pytest.approx(1.0 / tau)
    assert (1.0 / s_e - 0.5) * (1.0 / s_o - 0.5) == pytest.approx(0.25)


def seeded(dim, seed):
    """rho (1 +- 0.01), u (0.03 rms) and f = feq + 0.01-scaled noise on a
    small domain, float32, drawn with numpy from ``seed``."""
    shape = (6, 7, 8) if dim == 3 else (9, 10)
    q = 19 if dim == 3 else 9
    rng = np.random.default_rng(seed)
    rho = (1.0 + 0.01 * rng.standard_normal(shape)).astype(np.float32)
    u = (0.03 * rng.standard_normal((dim,) + shape)).astype(np.float32)
    noise = (1e-3 * rng.standard_normal((q,) + shape)).astype(np.float32)
    return rho, u, noise


@pytest.mark.parametrize('incompressible', [False, True])
@pytest.mark.parametrize('dim', [2, 3])
def test_collide_functions_match_jax(dim, incompressible):
    name = 'D2Q9' if dim == 2 else 'D3Q19'
    g, jg = lattice.get_grid(name), jlattice.get_grid(name)
    rho, u, noise = seeded(dim, seed=dim)
    feq = teq.bgk_equilibrium(g, torch.from_numpy(rho), torch.from_numpy(u),
                              incompressible=incompressible)
    f = feq + torch.from_numpy(noise)
    jf = jnp.asarray(f.numpy())
    rates = g.mrt_relaxation_rates(0.7)
    out = tco.mrt_collide(g, f, torch.from_numpy(rho), torch.from_numpy(u),
                          rates, incompressible=incompressible)
    jout = jco.mrt_collide(jg, jf, jnp.asarray(rho), jnp.asarray(u), rates,
                           incompressible=incompressible)
    assert np.max(np.abs(out.numpy() - np.asarray(jout))) <= TOL
    # MRT moved f away from BGK, and equals BGK when every rate is 1/tau
    bgk = tco.bgk_collide(g, f, torch.from_numpy(rho), torch.from_numpy(u),
                          1.0 / 0.7, incompressible=incompressible)
    assert float((out - bgk).abs().max()) > 1e-5
    flat = tco.mrt_collide(g, f, torch.from_numpy(rho), torch.from_numpy(u),
                           np.full(g.Q, 1.0 / 0.7),
                           incompressible=incompressible)
    assert float((flat - bgk).abs().max()) <= TOL
    # R's columns are built once per rate vector, dtype and device
    assert tco.mrt_columns(g, tuple(rates), f.dtype, f.device) \
        is tco.mrt_columns(g, tuple(rates), f.dtype, f.device)
    tau_inv = tco.smagorinsky_tau_inv(g, f, feq, torch.from_numpy(rho), 0.7,
                                      SMAG)
    jtau_inv = jco.smagorinsky_tau_inv(jg, jf, jnp.asarray(feq.numpy()),
                                       jnp.asarray(rho), 0.7, SMAG)
    assert tau_inv.shape == rho.shape
    assert np.max(np.abs(tau_inv.numpy() - np.asarray(jtau_inv))) <= TOL
    # the subgrid viscosity only adds: 1/tau_eff below 1/tau
    assert float(tau_inv.max()) < 1.0 / 0.7 - 1e-4


def both_builders(scene, model, force_model, **extra):
    """(port runner without steps, its StepBuilder with the scene's force
    and the collision model, the JAX StepBuilder on the same maps)."""
    sim_cls, cfg = SCENES[scene]()
    r = cpu_runner(sim_cls, **cfg)
    kw = dict(visc=r.config.visc, body_force=r.builder.body_force,
              force_model=force_model, **MODELS.get(model, {}), **extra)
    return (r, StepBuilder(r.sim.grid, r.maps, **kw),
            JaxStepBuilder(r.sim.grid, r.maps, dtype=jnp.float32, **kw))


def start(r):
    """A seeded equilibrium state of random density (1 +- 0.01) and
    velocity (0.02 rms) on the runner's domain: strain enough for the
    Smagorinsky rate and density variations enough for the incompressible
    equilibrium to differ from BGK's within 20 steps."""
    return random_feq(r.sim.grid, r.maps.type_map.shape, 5, 'cpu')


def run_both(r, tb, jb, steps=STEPS):
    """(port state, JAX state) as numpy after ``steps`` steps from
    ``start(r)``."""
    jstep = jax.jit(jb.build())
    step = tb.build()
    ft = start(r)
    fj = jnp.asarray(state_to_numpy(ft))
    for _ in range(steps):
        ft, fj = step(ft), jstep(fj)
    return state_to_numpy(ft), np.asarray(fj)


#: (scene, model, force model) of the engine comparison: every model under
#: each force model on both scenes; the incompressible equilibrium under
#: MRT and LES on sphere_3d with the Guo force
XLA_CASES = [(scene, model, fm) for scene in sorted(SCENES)
             for model in sorted(MODELS) for fm in FORCE_MODELS
             if not model.startswith('incompressible_')
             or (scene, fm) == ('sphere_3d', 'guo')]


@functools.lru_cache(maxsize=None)
def bgk_state(scene, force_model):
    """The BGK state after ``STEPS`` steps from ``start``, as numpy."""
    r, tb, _ = both_builders(scene, 'bgk', force_model)
    step = tb.build()
    f = start(r)
    for _ in range(STEPS):
        f = step(f)
    return state_to_numpy(f)


@pytest.mark.parametrize('scene,model,force_model', XLA_CASES)
def test_step_matches_jax_xla_engine(scene, model, force_model):
    r, tb, jb = both_builders(scene, model, force_model)
    ft, fj = run_both(r, tb, jb)
    wet = wet_map(r.maps)
    assert np.max(np.abs(ft[:, wet] - fj[:, wet])) <= TOL
    # the model changed the result: against BGK from the same start
    fb = bgk_state(scene, force_model)
    assert np.max(np.abs(ft[:, wet] - fb[:, wet])) > 1e-6


def test_regularized_channel_under_mrt_matches_jax():
    """A channel with a regularized velocity inlet and density outlet
    normal to z under mrt (after tests/test_sharded_pallas.py:618)."""
    r = cpu_runner(channel_sim('regularized'), lat_nx=16, lat_ny=12,
                   lat_nz=16, periodic_x=True, model='mrt')
    jb = JaxStepBuilder(r.sim.grid, r.maps, visc=r.config.visc,
                        dtype=jnp.float32, model='mrt')
    ft, fj = run_both(r, r.builder, jb)
    wet = wet_map(r.maps)
    assert np.max(np.abs(ft[:, wet] - fj[:, wet])) <= TOL


@pytest.mark.parametrize('model', ['mrt', 'les', 'incompressible'])
@pytest.mark.parametrize('wall', sorted(WALLS))
def test_walls_under_the_collision_models_match_jax(wall, model):
    """The local walls (half-way, TMS and slip, on every axis of a 3D box
    under the Guo force) with each collision model, through the port's
    controller on the torch engine, against the JAX XLA engine: 20 steps
    from a random state, wet-node max |df| <= 1e-6."""
    r = cpu_runner(box_sim(WALLS[wall], 3, (0, 1, 2), ACCEL), visc=0.05,
                   **box_cfg(3, (0, 1, 2)), **FLAGS[model])
    assert r.engine == 'torch'
    jb = JaxStepBuilder(r.sim.grid, r.maps, visc=r.config.visc,
                        dtype=jnp.float32, body_force=r.builder.body_force,
                        **MODELS[model])
    ft, fj = run_both(r, r.builder, jb)
    wet = wet_map(r.maps)
    assert np.max(np.abs(ft[:, wet] - fj[:, wet])) <= TOL


def kernel_inputs(r):
    mask_np, instances, reasons = ls.classify_nodes(r.maps)
    assert reasons == []
    return (torch.from_numpy(mask_np), ls.bc_table(r.maps, instances),
            torch.from_numpy((mask_np == 0) | (mask_np >= 3)))


@pytest.mark.parametrize('model', ['mrt', 'les', 'incompressible',
                                   'incompressible_mrt'])
def test_step_reference_matches_torch_engine(model):
    """The kernel's plain version with the collision model (and the Guo
    force) against the torch engine's step through the scene's runner, on
    a channel whose regularized faces collide by the model too."""
    r = cpu_runner(forced(channel_sim('regularized', 'x'),
                          (1e-5, -4e-6, 2.5e-6)),
                   lat_nx=16, lat_ny=10, lat_nz=8, periodic_z=True,
                   **FLAGS[model])
    b = r.builder
    assert ls.kernel_ineligibility(b) == []
    mask, table, wet = kernel_inputs(r)
    step = b.build()
    f = ft = r.f
    for _ in range(10):
        f = ls.step_reference(f, mask, table, r.sim.grid, b.tau_inv,
                              force=tuple(b.body_force), force_model='guo',
                              rates=b.mrt_rates, smagorinsky=b.smagorinsky,
                              incompressible=b.incompressible)
        ft = step(ft)
    assert float((f - ft)[:, wet].abs().max()) <= TOL
    ks = ls.KernelStep(b)
    assert torch.equal(ks.run(r.f, 3), step(step(step(r.f))))


@pytest.mark.parametrize('model,name,code', [
    ('bgk', 'lbm_step_force_d3q19', 0),
    ('mrt', 'lbm_step_mrt_d3q19', 1),
    ('mrt_les', 'lbm_step_mrt_d3q19', 1),
    ('les', 'lbm_step_les_d3q19', 2),
    ('incompressible', 'lbm_step_incomp_d3q19', 0),
])
def test_kernel_parameter_block_carries_the_model(model, name, code):
    """The kernel engine takes every model (no refusal), counts its launches
    under the model's key, and writes the model's code, the parity-split
    rates, tau, tau^2 and 36 C^2 (fp64 products cast to fp32) and the
    equilibrium into the block."""
    r = cpu_runner(twin('sphere_3d'), **SINGLE_GOLDEN_FLAGS['sphere_3d'],
                   visc=0.1, **FLAGS.get(model, {}))
    assert ls.kernel_ineligibility(r.builder) == []
    ks = ls.KernelStep(r.builder)
    c = ks.params.coll
    assert (ks.name, c.model) == (name, code)
    assert c.equilibrium == ls.EQ_CODES[
        'incompressible' if model == 'incompressible' else 'bgk']
    tau = r.builder.tau
    if code == 1:
        # the even rate 1/tau, the odd one the TRT magic rate
        assert (c.s_e, c.s_o) == (np.float32(1.0 / tau), np.float32(
            1.0 / (0.25 / (tau - 0.5) + 0.5)))
    else:
        assert c.s_e == c.s_o == 0.0
    if code == 2:
        tau = 1.0 / r.builder.tau_inv
        assert (c.tau, c.tau2, c.les_c) == (np.float32(tau),
                                            np.float32(tau * tau),
                                            np.float32(36.0 * SMAG ** 2))
    else:
        assert c.tau == c.tau2 == c.les_c == 0.0


def test_non_split_rates_are_refused_by_name():
    g = lattice.D3Q19
    rates = g.mrt_relaxation_rates(0.8)
    rates[g.mrt_shear[0]] = 1.1
    with pytest.raises(NotImplementedError, match='more than one even rate'):
        ls.mrt_pair_rates(g, rates)
    r = cpu_runner(twin('ldc_3d'), lat_nx=8, lat_ny=8, lat_nz=8,
                   model='mrt')
    r.builder.mrt_rates = rates
    assert any('more than one even rate' in why
               for why in ls.kernel_ineligibility(r.builder))


def port_fields(sim_cls, steps, **cfg):
    r = run(sim_cls, platform='cpu', max_iters=steps, every=steps, **cfg)
    r._fields_to_host()
    return np.array(r.sim.rho), np.array(r.sim.vx)


def jax_fields(module, cls, steps, **cfg):
    jsim = getattr(load_example(module, f'jax_{cls}_{module[:-3]}'), cls)
    jc = JaxController(jsim, default_config=dict(
        max_iters=steps, every=steps, quiet=True, engine='pallas',
        platform='cpu', **cfg))
    jc.run(ignore_cmdline=True)
    assert jc._runner.engine == 'pallas'
    jc._runner._fields_to_host()
    return np.array(jc._runner.sim.rho), np.array(jc._runner.sim.vx)


#: the cavities at tau = 0.65, where the odd MRT rate differs from the
#: even one and the lid's shear gives the Smagorinsky rate a strain (the
#: forced sphere at rest for 15 steps has too little: LES moves it by
#: 5e-7 there)
PALLAS_CASES = {
    'ldc_2d': (dict(lat_nx=64, lat_ny=64, visc=0.05), 20),
    'ldc_3d': (dict(lat_nx=32, lat_ny=16, lat_nz=16, visc=0.05), 15),
}


@pytest.mark.parametrize('scene', sorted(PALLAS_CASES))
@pytest.mark.parametrize('model', ['mrt', 'les'])
def test_matches_jax_pallas_engine(scene, model):
    """mrt (tests/test_pallas2d.py:91) and les (after
    tests/test_sharded_pallas.py:145) on the cavities, through the port's
    controller and the JAX fused kernels in interpret mode; each model
    moved the fields away from BGK's by more than the tolerance."""
    plain, steps = PALLAS_CASES[scene]
    cfg = dict(plain, **FLAGS[model])
    mine = port_fields(twin(scene), steps, **cfg)
    ref = jax_fields(f'{scene}.py', 'LDCSim', steps, **cfg)
    assert np.max(np.abs(mine[0] - ref[0])) < 2e-6
    assert np.max(np.abs(mine[1] - ref[1])) < 1e-6
    bgk = port_fields(twin(scene), steps, **plain)
    assert np.max(np.abs(mine[0] - bgk[0])) > 2e-6
    assert np.max(np.abs(mine[1] - bgk[1])) > 1e-6


def shear_wave_viscosity(model, N=32, visc=0.05, u0=0.01, iters=400,
                         **extra):
    """The viscosity a decaying shear wave measures on the torch engine
    (tests/test_models.py:13-36): the decay of the wave's Fourier mode."""

    class SW(Subdomain2D):
        def boundary_conditions(self, hx, hy):
            pass

        def initial_conditions(self, sim, hx, hy):
            sim.rho[:] = 1.0
            sim.vx[:] = u0 * np.sin(2 * np.pi * hy / N)

    class Sim(LBFluidSim):
        subdomain = SW

    r = run(Sim, platform='cpu', lat_nx=N, lat_ny=N, visc=visc,
            max_iters=iters, every=iters, periodic_x=True, periodic_y=True,
            model=model, **extra)
    r._fields_to_host()
    k = 2 * np.pi / N
    amp = abs(np.fft.rfft(r.sim.vx[:, 0])[1]) * 2 / N
    return -np.log(amp / u0) / (k * k * iters)


@pytest.mark.parametrize('model', ['bgk', 'mrt', 'trt'])
def test_shear_wave_viscosity(model):
    nu = shear_wave_viscosity(model)
    assert abs(nu - 0.05) / 0.05 < 0.02, (model, nu)


def test_les_smagorinsky_increases_dissipation():
    nu_plain = shear_wave_viscosity('bgk', u0=0.05)
    nu_les = shear_wave_viscosity('bgk', u0=0.05, subgrid='les-smagorinsky',
                                  smagorinsky_const=0.1)
    assert nu_les > nu_plain


def test_trt_is_bit_identical_to_mrt():
    """TRT is MRT with the same rate vector: the same states on the torch
    engine and the same parameter block (and plain version) on the kernel
    engine."""
    states, blocks = [], []
    for model in ('mrt', 'trt'):
        r = cpu_runner(twin('sphere_3d'), **SINGLE_GOLDEN_FLAGS['sphere_3d'],
                       model=model)
        step = r.builder.build()
        f = r.f
        for _ in range(10):
            f = step(f)
        ks = ls.KernelStep(r.builder)
        states += [f, ks.run(r.f, 10)]
        blocks.append(bytes(ks.params))
    assert torch.equal(states[0], states[2])
    assert torch.equal(states[1], states[3])
    assert torch.equal(states[0], states[1])
    assert blocks[0] == blocks[1]
    assert ctypes.sizeof(ls._Params) == len(blocks[0])


def test_elbm_runs_on_both_engines():
    """ELBM is ported: the torch engine and the kernel engine (its plain
    version on the CPU; the kernel on the card, tests/test_torch_cuda.py)
    step it, bit for bit alike here, under its launch key;
    the kernel engine refuses by name the product-form equilibrium, which
    the torch engine runs."""
    r = cpu_runner(unforced(twin('cylinder')), lat_nx=16, lat_ny=8,
                   model='elbm')
    assert r.engine == 'torch' and r.builder.elbm is not None
    ks = ls.KernelStep(r.builder)
    assert ks.name == 'lbm_step_elbm_d2q9'
    f = r.builder.build()(r.f)
    assert torch.equal(ks.run(r.f, 1), f)
    assert torch.all(r.builder.last_alpha != 0)
    r = cpu_runner(unforced(twin('cylinder')), lat_nx=16, lat_ny=8,
                   entropic_equilibrium=True)
    assert r.builder.equilibrium == 'elbm'
    assert any('equilibrium=elbm' in why
               for why in ls.kernel_ineligibility(r.builder))


def test_instantiation_reads_the_template_arguments():
    """``lbm_step.instantiation`` reads a kernel's template arguments from
    its mangled name (the build log's and cuobjdump's), also of a build
    with fewer parameters."""
    sig = 'EvPKfPfPKh10LBMParamsS1_PKi'
    assert ls.instantiation(
        f'_Z15lbm_step_kernelILi3ELi19ELi1ELb1ELi2ELb1E{sig}') == dict(
            dim=3, q=19, force='guo', walls=True, model='les',
            incompressible=True)
    assert ls.instantiation(
        f'_Z15lbm_step_kernelILi2ELi9ELi0ELb0ELi1ELb0E{sig}') == dict(
            dim=2, q=9, force='none', walls=False, model='mrt',
            incompressible=False)
    assert ls.instantiation(f'_Z15lbm_step_kernelILi2ELi9ELi3ELb0E{sig}') \
        == dict(dim=2, q=9, force='velocity_shift', walls=False)
    assert ls.instantiation('_Z16lbm_empty_kernelv') is None


@pytest.mark.parametrize('name', ['D2Q9', 'D3Q19'])
def test_conserved_columns_are_what_the_kernel_folds_in(name):
    """The conserved columns of M^-1 are 1/Q and c_ia / sum_j c_ja^2, the
    constants ``mrt_minv_cons`` of csrc/lattice_tables.cuh computes, to the
    last bit of their float32; the kernel sums the conserved moments with
    the rows 1 and c_a of M."""
    from sailfish_tpu_torch.ops import build
    g = lattice.get_grid(name)
    cols = ls.mrt_conserved_columns(g).astype(np.float32)
    np.testing.assert_array_equal(cols[:, 0], np.float32(1.0 / g.Q))
    for a in range(g.dim):
        norm = int((g.basis[:, a] ** 2).sum())
        np.testing.assert_array_equal(
            cols[:, 1 + a], g.basis[:, a].astype(np.float32)
            * np.float32(1.0 / norm))
    t = ls.lattice_tables(g)
    np.testing.assert_array_equal(
        np.ctypeslib.as_array(t.minv)[:g.Q, :1 + g.dim], cols)
    text = (build.CSRC / 'lattice_tables.cuh').read_text()
    assert 'mrt_minv_cons' in text and 'mrt_minv_axis' in text
