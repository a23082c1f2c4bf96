"""The port's torch StepBuilder against the JAX XLA engine's StepBuilder.

Each scene's node maps and initial state come from the port's controller
(0 iterations, CPU); the same numpy maps and state then go through
``sailfish_tpu.ops.step.StepBuilder.build()`` (jitted) and the port's
``StepBuilder.build()`` for 20 steps. Tolerance: wet-node max |df| <= 1e-6
(ROADMAP; the two frameworks contract FMAs in different places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu.ops.step import StepBuilder as JaxStepBuilder
from sailfish_tpu_torch import node_type as tnt
from sailfish_tpu_torch.ops.step import StepBuilder
from sailfish_tpu_torch.state import state_to_numpy
from torch_scenes import BC_PAIRS, channel_sim, cpu_runner, twin, wet_map

torch.set_num_threads(1)

STEPS = 20
TOL = 1e-6

SCENES = {
    'ldc_3d': lambda: (twin('ldc_3d'), dict(lat_nx=16, lat_ny=16,
                                            lat_nz=16)),
    'ldc_2d': lambda: (twin('ldc_2d'), dict(lat_nx=32, lat_ny=32)),
}
for _pair in BC_PAIRS:
    # z-normal BC faces (channel) and x-normal ones (duct)
    SCENES[f'channel_{_pair}'] = (
        lambda p=_pair: (channel_sim(p), dict(lat_nx=32, lat_ny=16,
                                              lat_nz=16, periodic_x=True)))
    SCENES[f'duct_{_pair}'] = (
        lambda p=_pair: (channel_sim(p, axis='x'),
                         dict(lat_nx=32, lat_ny=16, lat_nz=16,
                              periodic_z=True)))


@pytest.mark.parametrize('scene', sorted(SCENES))
def test_step_matches_jax_xla_engine(scene):
    sim_cls, cfg = SCENES[scene]()
    r = cpu_runner(sim_cls, **cfg)
    assert r.engine == 'torch'
    f0 = state_to_numpy(r.f)

    jb = JaxStepBuilder(r.sim.grid, r.maps, visc=r.config.visc,
                        dtype=jnp.float32)
    jstep = jax.jit(jb.build())
    fj = jnp.asarray(f0)
    step = r.builder.build()
    ft = r.f
    for _ in range(STEPS):
        fj = jstep(fj)
        ft = step(ft)
    fj = np.asarray(fj)
    ft = state_to_numpy(ft)
    wet = wet_map(r.maps)
    assert np.max(np.abs(ft[:, wet] - fj[:, wet])) <= TOL

    rho_j, u_j = jax.jit(jb.macro_fields)(jnp.asarray(fj))
    rho_t, u_t = r.builder.macro_fields(torch.from_numpy(fj.copy()))
    assert np.max(np.abs(rho_t.numpy()[wet] - np.asarray(rho_j)[wet])) \
        <= TOL
    assert np.max(np.abs(u_t.numpy()[:, wet] - np.asarray(u_j)[:, wet])) \
        <= TOL


@pytest.mark.parametrize('kwargs,match', [
    # ELBM and the product-form equilibrium are ported
    # (test_elbm_and_the_product_form_build); what stays is refused, the
    # ids are the cases' former ones
    pytest.param(dict(equilibrium='shallow_water'), 'shallow-water '
                 'equilibrium is defined on D2Q9 only; got D3Q19',
                 id='kwargs3-shallow-water equilibrium is defined on D2Q9 '
                 'only; got D3Q19'),
    # int16 storage is ported; what it cannot hold is refused with the
    # JAX engine's reasons
    pytest.param(dict(sc_coupling=-5.0, storage='int16'),
                 'mixed 16-bit storage does not cover Shan-Chen',
                 id='kwargs4-int16 storage'),
    pytest.param(dict(storage='int16', dtype=torch.float64),
                 'mixed 16-bit storage requires fp32 compute',
                 id='kwargs6-storage'),
    pytest.param(dict(storage='int16', equilibrium='elbm'),
                 'mixed 16-bit storage covers the standard equilibrium '
                 'only', id='int16-product-form'),
])
def test_unported_options_raise(kwargs, match):
    r = cpu_runner(twin('ldc_3d'), lat_nx=8, lat_ny=8,
                    lat_nz=8)
    with pytest.raises(NotImplementedError, match=match):
        StepBuilder(r.sim.grid, r.maps, visc=0.1, **kwargs)


@pytest.mark.parametrize('kwargs', [
    dict(model='elbm'), dict(model='elbm', smagorinsky=0.03),
    dict(model='mrt', equilibrium='elbm'), dict(equilibrium='elbm'),
    dict(model='elbm', storage='int16')])
def test_elbm_and_the_product_form_build(kwargs):
    """The four ELBM cases that used to raise build and step; the entropic
    collision keeps its settings in ``elbm`` and its alpha field, the
    product form is the builder's equilibrium."""
    r = cpu_runner(twin('ldc_3d'), lat_nx=8, lat_ny=8, lat_nz=8)
    b = StepBuilder(r.sim.grid, r.maps, visc=0.1, **kwargs)
    f = b.build()(b.feq(torch.ones(8, 8, 8), torch.zeros(3, 8, 8, 8)))
    assert torch.all(torch.isfinite(f))
    assert (b.elbm is not None) == (kwargs.get('model') == 'elbm')
    if b.elbm is not None:
        assert b.last_alpha.shape == (8, 8, 8)
        assert b.elbm.tau == b.tau and b.elbm.entropy_tol == 1e-6
    assert b.equilibrium == kwargs.get('equilibrium', 'bgk')


def test_per_node_force_raises_on_the_kernel_engine():
    """The torch engine takes a per-node force field; ``KernelStep`` refuses
    it and names the reason."""
    from sailfish_tpu_torch.ops.lbm_step import KernelStep
    r = cpu_runner(twin('ldc_3d'), lat_nx=8, lat_ny=8, lat_nz=8)
    field = np.full((3, 8, 8, 8), 1e-6)
    builder = StepBuilder(r.sim.grid, r.maps, visc=0.1, body_force=field)
    assert builder.force.shape == (3, 8, 8, 8)
    with pytest.raises(NotImplementedError,
                       match='space-varying body force'):
        KernelStep(builder)


def test_unported_node_type_raises():
    """The outflow family is ported (tests/test_torch_outflow.py); what
    stays refused is Guo's density BC in a mixture, which the
    multi-component builders name as the JAX package's do
    (``sailfish_tpu/ops/multigrid.py:84``)."""
    from torch_scenes import binary_twin
    base = binary_twin('sc_separation_2d')

    class Outflow(base.subdomain):
        def boundary_conditions(self, hx, hy):
            self.set_node(hy == 0, tnt.NTGuoDensity(1.0))

    class Sim(base):
        subdomain = Outflow

    with pytest.raises(NotImplementedError, match='NTGuoDensity is not '
                       'supported in multi-component models'):
        cpu_runner(Sim, lat_nx=8, lat_ny=8)


def test_dynamic_bc_parameters_raise():
    """The torch engine takes DynamicValue BC parameters; a mixture kernel,
    which takes no time-dependent value, names them."""
    from sailfish_tpu_torch.ops import sc_multi
    from torch_scenes import binary_twin
    base = binary_twin('sc_separation_2d')

    class Pulsed(base.subdomain):
        def boundary_conditions(self, hx, hy):
            self.set_node(hy == 0, tnt.NTEquilibriumVelocity(
                tnt.DynamicValue(lambda t: 0.01, 0.0)))

    class Sim(base):
        subdomain = Pulsed

    r = cpu_runner(Sim, lat_nx=8, lat_ny=8)
    assert r.builder.b0.dynamic
    why = sc_multi.kernel_ineligibility(r.builder)
    assert 'DynamicValue BC parameters (the Shan-Chen kernel takes no ' \
        'time-dependent value)' in why
    with pytest.raises(NotImplementedError, match='DynamicValue'):
        sc_multi.SCMultiStep(r.builder)
