"""Single-component Shan-Chen on the port, on the CPU.

* The torch engine (``ops/step.StepBuilder`` with ``sc_coupling``) against
  the JAX XLA engine's ``StepBuilder`` on the same node maps and state,
  20 steps: the spinodal scenes of ``examples/torch/sc_phase_separation``
  (D2Q9 32^2) and ``_3d`` (D3Q19 16^3) under the linear and the classic
  potential, under a constant Guo force, and in a box of full bounce-back
  walls. Wet-node f, rho and u within 1e-6 (the north star's tolerance).
* ``lbm_step.step_reference`` in its Shan-Chen mode (the neighbours' psi
  from the pre-pass ``sc_multi.rho_reference``), the plain version the
  card holds the kernel to, against the JAX package's Pallas kernels in
  interpret mode (``PallasStep2D`` 32^2, ``PallasStep3D`` 16^3, their
  fused ``sc`` mode with ``emit_rho``; 10 steps, 1e-6) and against the
  torch engine (20 steps, 1e-6).
* The kernel engine on the CPU (``KernelStep``: the pre-pass then the
  plain step) equals the torch engine bit for bit, and counts nothing.
* ``kernel_ineligibility`` names every Shan-Chen scene the kernel refuses
  (a model other than BGK, a body force other than a constant Guo one, BC
  rows, the shallow-water equilibrium), and the parameter block carries
  the mode.
* The three twins ``sc_drop``, ``sc_phase_separation`` and
  ``sc_phase_separation_3d`` against their goldens (rtol 1e-5, atol
  5e-7; 20 steps, seed 1234).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu import lattice as jlattice
from sailfish_tpu.ops.pallas_step import PallasStep3D
from sailfish_tpu.ops.pallas_step2d import PallasStep2D
from sailfish_tpu.ops.step import StepBuilder as JaxStepBuilder
from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch.ops import lbm_step as ls
from sailfish_tpu_torch.ops.step import StepBuilder
from sailfish_tpu_torch.state import state_to_numpy
from torch_scenes import (SC_SINGLE_SCENES, SINGLE_GOLDEN_FLAGS, cpu_runner,
                          forced, golden_run, twin, walled, wet_map)

torch.set_num_threads(1)

STEPS = 20
TOL = 1e-6
SIZES = {2: dict(lat_nx=32, lat_ny=32),
         3: dict(lat_nx=16, lat_ny=16, lat_nz=16)}
#: a constant acceleration with every component and both signs, strong
#: enough that a wrong order of the two velocity shifts shows after 20
#: steps
SC_ACCEL = (1e-3, -5e-4, 2.5e-4)
#: the coupling of each potential: the examples' G = -5 for the classic
#: one; with the linear one (psi = rho) the scenes' rho ~ 0.693 is
#: unstable below G = -1/0.693, and G = -5 blows up within 20 steps, so
#: G = -1.6, just inside the spinodal
COUPLING = {'classic': -5.0, 'linear': -1.6}


def sc_scene(dim):
    return twin('sc_phase_separation_3d' if dim == 3
                else 'sc_phase_separation')


SCENES = {}
for _dim in (2, 3):
    for _pot in ('linear', 'classic'):
        SCENES[f'd{_dim}_{_pot}'] = (_dim, _pot, None, False)
    SCENES[f'd{_dim}_classic_guo'] = (_dim, 'classic', 'guo', False)
    SCENES[f'd{_dim}_classic_box'] = (_dim, 'classic', None, True)
SCENES['d2_linear_guo_box'] = (2, 'linear', 'guo', True)


def build(case, **extra):
    """The port's runner on the CPU (0 steps) of a ``SCENES`` case."""
    dim, potential, force, box = SCENES[case]
    sim = sc_scene(dim)
    if force:
        sim = forced(sim, SC_ACCEL[:dim])
    if box:
        sim = walled(sim)
    return cpu_runner(sim, **SIZES[dim], sc_potential=potential,
                      G=COUPLING[potential], **extra)


def jax_builder(r):
    b = r.builder
    return JaxStepBuilder(
        jlattice.get_grid(r.sim.grid.name), r.maps, visc=r.config.visc,
        sc_coupling=b.sc_coupling, sc_potential=b.sc_potential,
        body_force=None if b.body_force is None else np.asarray(
            b.body_force), force_model=b.force_model, dtype=jnp.float32)


def wet_errors(r, ft, fj, macro_j):
    """Wet-node max |d f|, |d rho|, |d u| of the port's state ``ft``
    against the JAX state ``fj`` and its macro fields."""
    wet = wet_map(r.maps)
    ft_np = state_to_numpy(ft)
    rho_t, u_t = r.builder.macro_fields(ft)
    rho_j, u_j = (np.asarray(x) for x in macro_j)
    return (float(np.max(np.abs(ft_np[:, wet] - fj[:, wet]))),
            float(np.max(np.abs(rho_t.numpy()[wet] - rho_j[wet]))),
            float(np.max(np.abs(u_t.numpy()[:, wet] - u_j[:, wet]))))


@pytest.mark.parametrize('case', sorted(SCENES))
def test_torch_engine_matches_jax_xla_engine(case):
    r = build(case)
    assert r.engine == 'torch' and r.builder.sc_coupling != 0.0
    jb = jax_builder(r)
    jstep = jax.jit(jb.build())
    fj = jnp.asarray(state_to_numpy(r.f))
    step = r.builder.build()
    ft = r.f
    for it in range(STEPS):
        fj = jstep(fj, it)
        ft = step(ft, it)
    fj_np = np.asarray(fj)
    errs = wet_errors(r, ft, fj_np, jax.jit(jb.macro_fields)(fj))
    print(case, 'max |df|, |drho|, |du|:', errs)
    assert max(errs) <= TOL, errs
    # the Shan-Chen force moved the state: against the same steps without
    # it (a kernel that dropped it would pass no other check here)
    b = r.builder
    plain = StepBuilder(b.grid, b.maps, visc=r.config.visc,
                        body_force=b.body_force,
                        force_model=b.force_model).build()
    fp = r.f
    for it in range(STEPS):
        fp = plain(fp, it)
    assert float((ft - fp).abs().max()) > 100 * TOL


def kernel_engine(case, **extra):
    r = build(case, **extra)
    ks = ls.KernelStep(r.builder)
    return r, ks


@pytest.mark.parametrize('case', ['d2_classic_guo', 'd3_linear',
                                  'd3_classic_box', 'd2_linear_guo_box'])
def test_kernel_engine_on_cpu_is_the_torch_engine(case):
    """``KernelStep`` on a CPU tensor: the pre-pass (``torch_density``),
    then ``step_reference``; bit for bit the torch engine, no launch."""
    r, ks = kernel_engine(case)
    assert ks.sc and ks.entry == f'lbm_step_sc_{r.sim.grid.name.lower()}'
    assert ks.name == ks.entry
    ls.reset_launch_counts()
    fk = ks.run(r.f.clone(), STEPS)
    step = r.builder.build()
    ft = r.f
    for it in range(STEPS):
        ft = step(ft, it)
    assert torch.equal(fk, ft)
    assert ks.launches == ks.prepass_launches == 0
    assert set(ls.LAUNCHES.values()) == {0}


@pytest.mark.parametrize('case', ['d2_classic', 'd3_linear',
                                  'd2_classic_guo',
                                  'd3_classic_box'])
def test_step_reference_with_the_prepass_matches_the_torch_engine(case):
    """The plain version with the direction-order pre-pass sum
    (``rho_reference``) against the torch engine (``torch.sum``): the two
    sums differ by ulps, the steps within 1e-6 after 20 steps."""
    r, ks = kernel_engine(case)
    fr = r.f
    for _ in range(STEPS):
        fr = ks.reference(fr)
    step = r.builder.build()
    ft = r.f
    for it in range(STEPS):
        ft = step(ft, it)
    wet = torch.as_tensor(wet_map(r.maps))
    err = float((fr - ft)[:, wet].abs().max())
    assert err <= TOL, err


@pytest.mark.parametrize('dim,potential', [(2, 'classic'), (2, 'linear'),
                                           (3, 'classic')])
def test_step_reference_matches_jax_pallas_interpret(dim, potential):
    """``step_reference``'s Shan-Chen mode with the pre-pass against the
    JAX fused kernel (``make_kernel_2d`` / ``_3d`` with ``sc`` and
    ``emit_rho``, pre-pass ``make_rho_kernel_*``) in interpret mode,
    10 steps, every node wet: within 1e-6 (1.0e-7 to 1.5e-7 measured).
    The JAX kernel emits each next density from its post-collision state
    (``emit_rho``); the plain version sums the pre-pass in direction
    order."""
    r, ks = kernel_engine(f'd{dim}_{potential}')
    jb = jax_builder(r)
    shape = r.maps.type_map.shape
    pallas = (PallasStep3D if dim == 3 else PallasStep2D)(
        jb, shape, interpret=True)
    assert pallas.sc and pallas.emit_rho
    steps = 10
    fj = np.asarray(pallas.run_steps(jnp.asarray(state_to_numpy(r.f)),
                                     steps))
    fr = r.f
    for _ in range(steps):
        fr = ks.reference(fr)
    err = float(np.max(np.abs(state_to_numpy(fr) - fj)))
    print(dim, potential, 'max |df| against Pallas interpret:', err)
    assert err <= TOL, err
    # the Shan-Chen force acted: the state left the unforced one
    fb = r.f
    for _ in range(steps):
        fb = ls.step_reference(fb, ks.mask, ks.table, ks.grid, ks.tau_inv)
    assert float((fr - fb).abs().max()) > 100 * TOL


def test_parameter_block_carries_the_mode():
    r, ks = kernel_engine('d3_classic_guo')
    p = ks.params
    assert (p.sc.potential, p.sc.g, p.sc.tau) == (
        ls.SC_POTENTIALS['classic'], np.float32(COUPLING['classic']),
        np.float32(r.builder.tau))
    assert p.force.model == ls.FORCE_CODES['guo']
    assert (p.coll.model, p.coll.equilibrium) == (0, ls.EQ_CODES['bgk'])
    assert p.nbc == 0 and ks.rho.shape == r.maps.type_map.shape
    assert ks.rho_name == 'rho_poststream_nk1_d3q19'
    assert ks.library == 'lbm_step'


def refusal(case, match, **extra):
    r = build(case, **extra)
    reasons = ls.kernel_ineligibility(r.builder)
    assert any(match in why for why in reasons), reasons
    with pytest.raises(NotImplementedError, match=match):
        ls.KernelStep(r.builder)


@pytest.mark.parametrize('flags,match', [
    (dict(model='mrt'), 'Shan-Chen with model=mrt'),
    (dict(model='trt'), 'Shan-Chen with model=trt'),
    (dict(subgrid='les-smagorinsky'), 'Shan-Chen with the Smagorinsky'),
    (dict(incompressible=True),
     'Shan-Chen with the incompressible equilibrium'),
])
def test_refuses_other_models(flags, match):
    refusal('d2_classic', match, **flags)


@pytest.mark.parametrize('model', ['edm', 'velocity_shift'])
def test_refuses_other_force_models(model):
    refusal('d2_classic_guo', f'Shan-Chen with the {model} body force',
            force_implementation=model)


def test_refuses_a_dynamic_force():
    from sailfish_tpu_torch.models.base import LBForcedSim

    class Ramped(sc_scene(2), LBForcedSim):
        def __init__(self, config):
            super().__init__(config)
            self.add_body_force((lambda t: 1e-6 * t, 0.0))

    r = cpu_runner(Ramped, **SIZES[2])
    assert r.builder.force_expr is not None
    reasons = ls.kernel_ineligibility(r.builder)
    assert any('Shan-Chen with a DynamicValue body force' in why
               for why in reasons), reasons


@pytest.mark.parametrize('node_type', [nt.NTHalfBBWall, nt.NTWallTMS,
                                       nt.NTSlip, nt.NTZouHeDensity])
def test_refuses_bc_rows(node_type):
    """Native BCs and half-way, TMS or slip walls are patch rows in JAX
    (pallas_step.py:2603, pallas_step2d.py:1313-1316); full bounce-back
    walls (``d2_classic_box``) run in the kernel."""
    base = sc_scene(2)
    cls = node_type(1.0) if node_type is nt.NTZouHeDensity else node_type

    class Scene(base.subdomain):
        def boundary_conditions(self, hx, hy):
            self.set_node((hy == 0) | (hy == self.gy - 1), cls)

    class Sim(base):
        subdomain = Scene

    r = cpu_runner(Sim, **SIZES[2], periodic_y=False)
    reasons = ls.kernel_ineligibility(r.builder)
    assert any('Shan-Chen with BC rows' in why and node_type.__name__ in why
               for why in reasons), reasons
    assert ls.kernel_ineligibility(build('d2_classic_box').builder) == []


def test_refuses_shan_chen_with_shallow_water():
    r = build('d2_classic')
    b = StepBuilder(r.sim.grid, r.maps, visc=0.1, sc_coupling=-5.0,
                    equilibrium='shallow_water', gravity=1e-3)
    reasons = ls.kernel_ineligibility(b)
    assert any('Shan-Chen with the shallow-water equilibrium' in why
               for why in reasons), reasons


@pytest.mark.parametrize('scene', SC_SINGLE_SCENES)
def test_twin_matches_golden(scene, tmp_path):
    r = golden_run(twin(scene), scene, tmp_path,
                   **SINGLE_GOLDEN_FLAGS[scene])
    assert r.builder.sc_coupling == -5.0
    assert r.builder.sc_potential == 'classic'
    assert ls.kernel_ineligibility(r.builder) == []


def test_instantiation_reads_the_mode_and_the_equilibrium():
    """``lbm_step.instantiation`` reads the equilibrium code and the
    Shan-Chen switch of this build's mangled names, and an older build's
    bool ``incompressible`` under that name."""
    sig = 'EvPKfPfPKh9LBMParamsS1_PKiS1_'
    assert ls.instantiation(
        f'_Z15lbm_step_kernelILi3ELi19ELi1ELb0ELi0ELi0ELb1E{sig}') == dict(
            dim=3, q=19, force='guo', walls=False, model='bgk',
            equilibrium='bgk', sc=True)
    assert ls.instantiation(
        f'_Z15lbm_step_kernelILi2ELi9ELi3ELb1ELi0ELi2ELb0E{sig}') == dict(
            dim=2, q=9, force='velocity_shift', walls=True, model='bgk',
            equilibrium='shallow_water', sc=False)
    old = '_Z15lbm_step_kernelILi2ELi9ELi0ELb0ELi1ELb1EEvPKfPfPKh'
    assert ls.instantiation(old)['incompressible'] is True
