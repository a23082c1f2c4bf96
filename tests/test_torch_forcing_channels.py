"""Body forces at native-BC nodes: channels with a velocity inlet and a
density outlet under a constant force, on the CPU.

The JAX ``phases`` collides the BC nodes after their reconstruction with
the force on (``sailfish_tpu/ops/step.py:818-819``), so a BC node takes
the force with its solved rho and u. No example has a force and native-BC
faces at once; ``torch_scenes.forced_channel_sim`` derives the channels of
``channel_sim`` from ``LBForcedSim``. Faces normal to x, y and z (3D) and x
and y (2D), the regularized and the Zou-He pair, the three force models:

* the torch ``StepBuilder`` against the JAX XLA engine's on the same maps,
  state and force: 20 steps, wet-node max |df| <= 1e-6, and
  ``macro_fields`` <= 1e-6;
* ``step_reference`` (the CUDA kernel's plain version: BC table rows plus
  the force as vector and model) against the torch engine's step on a
  seeded random state with a block of excluded nodes: 10 steps, <= 1e-6,
  and BC nodes that move with the force.
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
from torch_scenes import (CHANNEL_ACCEL, cpu_runner, forced_channel_sim,
                          forced_channel_sim_2d, random_feq, wet_map,
                          with_keep_block)

torch.set_num_threads(1)

STEPS = 20
TOL = 1e-6
#: (dimensions, flow axis) -> size and periodic axis
FACES = {
    (3, 'x'): dict(lat_nx=16, lat_ny=12, lat_nz=12, periodic_z=True),
    (3, 'y'): dict(lat_nx=16, lat_ny=12, lat_nz=12, periodic_x=True),
    (3, 'z'): dict(lat_nx=16, lat_ny=12, lat_nz=12, periodic_x=True),
    (2, 'x'): dict(lat_nx=24, lat_ny=16),
    (2, 'y'): dict(lat_nx=24, lat_ny=16),
}
PAIRS = ('regularized', 'zouhe')


def channel(pair, dim, axis):
    if dim == 3:
        return forced_channel_sim(pair, axis)
    return forced_channel_sim_2d(pair, axis=axis)


@pytest.mark.parametrize('model', FORCE_MODELS)
@pytest.mark.parametrize('dim,axis', sorted(FACES))
@pytest.mark.parametrize('pair', PAIRS)
def test_forced_channel_matches_jax_xla_engine(pair, dim, axis, model):
    r = cpu_runner(channel(pair, dim, axis), force_implementation=model,
                   **FACES[dim, axis])
    assert r.engine == 'torch' and r.builder.force_model == model
    np.testing.assert_array_equal(r.builder.body_force,
                                  CHANNEL_ACCEL[:dim])
    jb = JaxStepBuilder(r.sim.grid, r.maps, visc=r.config.visc,
                        dtype=jnp.float32, body_force=r.builder.body_force,
                        force_model=model)
    jstep = jax.jit(jb.build())
    step = r.builder.build()
    ft, fj = r.f, jnp.asarray(state_to_numpy(r.f))
    for _ in range(STEPS):
        ft, fj = step(ft), jstep(fj)
    ft, fj = state_to_numpy(ft), np.asarray(fj)
    wet = wet_map(r.maps)
    assert np.max(np.abs(ft[:, wet] - fj[:, wet])) <= TOL
    rho_j, u_j = jax.jit(jb.macro_fields)(jnp.asarray(fj))
    rho_t, u_t = r.builder.macro_fields(torch.from_numpy(fj.copy()))
    assert np.max(np.abs(rho_t.numpy()[wet] - np.asarray(rho_j)[wet])) \
        <= TOL
    assert np.max(np.abs(u_t.numpy()[:, wet] - np.asarray(u_j)[:, wet])) \
        <= TOL


@pytest.mark.parametrize('model', FORCE_MODELS)
@pytest.mark.parametrize('dim,axis', sorted(FACES))
@pytest.mark.parametrize('pair', PAIRS)
def test_step_reference_takes_the_force_at_bc_nodes(pair, dim, axis, model):
    r = cpu_runner(with_keep_block(channel(pair, dim, axis)),
                   force_implementation=model, **FACES[dim, axis])
    mask_np, instances, reasons = ls.classify_nodes(r.maps)
    assert reasons == [] and ls.kernel_ineligibility(r.builder) == []
    assert sorted(np.unique(mask_np)) == [0, 1, 2, 3, 4]
    table = ls.bc_table(r.maps, instances)
    mask = torch.from_numpy(mask_np)
    force = tuple(float(a) for a in r.builder.body_force)
    f0 = random_feq(r.sim.grid, mask_np.shape, seed=7, device='cpu')
    step = r.builder.build()

    def reference(f, **force):
        return ls.step_reference(f, mask, table, r.sim.grid,
                                 r.builder.tau_inv, **force)

    f, ft = f0, f0
    for _ in range(10):
        f = reference(f, force=force, force_model=model)
        ft = step(ft)
    wet = torch.from_numpy((mask_np == 0) | (mask_np >= 3))
    assert float((f - ft)[:, wet].abs().max()) <= TOL
    # after one step the BC nodes already differ from the unforced step's
    bc = torch.from_numpy(mask_np >= 3)
    f1 = reference(f0, force=force, force_model=model)
    assert float((f1 - reference(f0))[:, bc].abs().max()) > 1e-7
