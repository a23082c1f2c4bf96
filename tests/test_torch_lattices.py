"""The D3Q15 and D3Q27 lattices on the port's engines, on the CPU.

* The torch engine on D3Q15 and D3Q27 (the cavity with its regularized
  lid, half-way and TMS boxes, Zou-He channels under each force model,
  the incompressible equilibrium) against the JAX XLA engine after 20
  steps at 16^3: wet-node max |df| <= 1e-6.
* The kernel engine (``ops/lbm_step``): each instantiation class of its
  D3Q15 / D3Q27 library (BGK with either equilibrium, each force model,
  wall rows or not) is accepted, its launches counted under the lattice's
  keys, and its plain version (``step_reference``, what a CPU tensor runs)
  is the torch engine's step; what the library lacks (MRT, TRT, LES,
  ELBM, Shan-Chen, shallow water, --precision=mixed) and the lattice
  D3Q13 are refused by name, and so is a composite step builder
  (``channel_cube``'s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu.ops.step import StepBuilder as JaxStepBuilder
from sailfish_tpu_torch.ops import lbm_step as ls
from sailfish_tpu_torch.ops.step import FORCE_MODELS
from sailfish_tpu_torch.state import state_to_numpy
from torch_scenes import (ACCEL, WALLS, box_cfg, box_sim, cpu_runner,
                          forced_channel_sim, random_feq,
                          TURBULENCE_GOLDEN_FLAGS, turbulence_twin, twin,
                          wet_map, with_keep_block)

torch.set_num_threads(1)

STEPS = 20
TOL = 1e-6
CUBE = dict(lat_nx=16, lat_ny=16, lat_nz=16)

#: name -> (sim, flags): every instantiation class of the other lattices'
#: library
CASES = {
    'ldc': (lambda: twin('ldc_3d'), {}),
    'ldc_incompressible': (lambda: twin('ldc_3d'),
                           dict(incompressible=True)),
    'halfbb_box': (lambda: box_sim(WALLS['halfbb'], 3, (0, 1, 2)),
                   box_cfg(3, (0, 1, 2))),
    'slip': (lambda: box_sim(WALLS['slip'], 3, (1,)), box_cfg(3, (1,))),
}
for _i, _model in enumerate(FORCE_MODELS):
    CASES[f'channel_{_model}'] = (
        lambda a='xyz'[_i]: forced_channel_sim('zouhe', a),
        dict(force_implementation=_model,
             **{'periodic_z' if _i == 0 else 'periodic_x': True}))
    CASES[f'tms_box_{_model}'] = (
        lambda: box_sim(WALLS['tms'], 3, (0, 1, 2), ACCEL),
        dict(box_cfg(3, (0, 1, 2)), force_implementation=_model,
             incompressible=_i == 1))


def _runner(grid, case):
    make, flags = CASES[case]
    return cpu_runner(with_keep_block(make()), grid=grid,
                      **dict(CUBE, **flags))


@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('grid', ls.OTHER_LATTICES)
def test_torch_engine_matches_jax_xla_engine(grid, case):
    r = _runner(grid, case)
    b = r.builder
    assert r.engine == 'torch' and r.sim.grid.name == grid
    jb = JaxStepBuilder(r.sim.grid, r.maps, visc=r.config.visc,
                        dtype=jnp.float32, body_force=b.body_force,
                        force_model=b.force_model,
                        incompressible=b.incompressible)
    jstep = jax.jit(jb.build())
    step = b.build()
    f0 = random_feq(r.sim.grid, r.maps.type_map.shape, 5, 'cpu')
    ft, fj = f0, jnp.asarray(f0.numpy())
    for i in range(STEPS):
        ft, fj = step(ft, i), jstep(fj, i)
    wet = wet_map(r.maps)
    err = np.max(np.abs(state_to_numpy(ft)[:, wet] - np.asarray(fj)[:, wet]))
    assert err <= TOL
    # the scene moved away from its start
    assert np.max(np.abs(state_to_numpy(ft) - f0.numpy())) > 100 * TOL


@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('grid', ls.OTHER_LATTICES)
def test_kernel_takes_every_instantiation_class(grid, case):
    r = _runner(grid, case)
    b = r.builder
    assert ls.kernel_ineligibility(b) == []
    ks = ls.KernelStep(b)
    g = grid.lower()
    assert ks.library == ls.LATTICES_LIBRARY == 'lbm_step_lattices'
    assert ks.entry == f'lbm_step_{g}'
    kind = 'wall_' if ks.walls else 'incomp_' if b.incompressible else \
        'force_' if ks.force is not None else ''
    assert ks.name == f'lbm_step_{kind}{g}'
    assert ks.name in ls.LAUNCHES
    assert ks.params.force.model == (
        ls.FORCE_CODES[b.force_model] if b.body_force is not None else 0)
    assert ks.params.coll.model == ls.MODEL_CODES['bgk']
    # the plain version the kernel is held to is the torch engine's step
    f0 = random_feq(r.sim.grid, ks.shape, 6, 'cpu')
    step = b.build()
    ft = f0
    for i in range(3):
        ft = step(ft, i)
    fk = ks.run(f0.clone(), 3)
    assert torch.equal(fk, ft)


#: flags a mode of the kernel takes on D2Q9 / D3Q19 only -> the name its
#: refusal gives
REFUSED_MODES = {
    'mrt': (dict(model='mrt'), 'model=mrt on'),
    'trt': (dict(model='trt'), 'model=trt on'),
    'elbm': (dict(model='elbm'), 'model=elbm on'),
    'les': (dict(subgrid='les-smagorinsky'), 'Smagorinsky LES model on'),
    'mixed': (dict(precision='mixed'), '--precision=mixed on'),
}


@pytest.mark.parametrize('mode', sorted(REFUSED_MODES))
@pytest.mark.parametrize('grid', ls.OTHER_LATTICES)
def test_kernel_refuses_the_modes_it_lacks_by_name(grid, mode):
    flags, why = REFUSED_MODES[mode]
    r = cpu_runner(twin('ldc_3d'), grid=grid, **dict(CUBE, **flags))
    reasons = ls.kernel_ineligibility(r.builder)
    assert any(why in s and grid in s and 'D2Q9 and D3Q19 only' in s
               for s in reasons), reasons
    with pytest.raises(NotImplementedError, match=why):
        ls.KernelStep(r.builder)


@pytest.mark.parametrize('grid', ls.OTHER_LATTICES)
def test_kernel_refuses_shan_chen_on_the_other_lattices(grid):
    r = cpu_runner(twin('sc_phase_separation_3d'), grid=grid,
                   lat_nx=16, lat_ny=16, lat_nz=16)
    reasons = ls.kernel_ineligibility(r.builder)
    assert any(s.startswith(f'Shan-Chen on {grid}') for s in reasons), \
        reasons


def test_kernel_refuses_d3q13_by_name():
    r = cpu_runner(twin('ldc_3d'), grid='D3Q13', **CUBE)
    reasons = ls.kernel_ineligibility(r.builder)
    assert any(s.startswith('lattice D3Q13 (the kernel is built for '
                            'D2Q9, D3Q15, D3Q19, D3Q27)') for s in reasons), \
        reasons


def test_kernel_engine_refuses_a_composite_step_by_name():
    r = cpu_runner(turbulence_twin('channel_cube'),
                   **TURBULENCE_GOLDEN_FLAGS['channel_cube'])
    assert type(r.builder).__name__ == '_CoupledStep'
    with pytest.raises(NotImplementedError,
                       match='step builder _CoupledStep is not a '
                             'StepBuilder'):
        r._kernel_engine()
    with pytest.raises(NotImplementedError, match='sharding'):
        r.builder.shard_constants(None)
