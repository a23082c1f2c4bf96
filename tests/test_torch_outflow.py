"""The outflow family on the port's engines against the JAX package.

* The torch engine (``ops/step.py``: ``fix_outflow``,
  ``guo_density_overlay``, ``extended_copy_gathers``) against the JAX XLA
  engine's ``StepBuilder`` for each of the eight types, on the
  inflow/outflow channels of tests/test_bc_catalog.py in 2D and 3D with
  the outlet normal to x and to y (2D) or z (3D), 20 steps from each
  scene's start: wet-node max |df| <= 1e-6, and the output fields.
* The kernel engine's plain version (``lbm_step.step_reference`` with
  the outflow rows of the BC table; ``laminarize_mean_reference`` for the
  plane means of the laminarize pre-pass) against the torch engine: one
  launch from a seeded random state and 20 steps, within 1e-6.
* A z-normal ``NTYuOutflow`` channel (32x16x16) and a y-normal ``NTCopy``
  channel (2D) against the JAX Pallas engine in interpret mode, which
  takes its patch-plane route there (1e-5).
* The classification into BC rows, the varying scalar in the parameter
  array, and what the kernel refuses by name.

The JAX twins of the scenes are built by ``torch_scenes`` from the JAX
package's classes (``nt_mod``, ``subdomain_cls``, ``model_cls``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu import node_type as jnt
from sailfish_tpu.controller import \
    LBSimulationController as JaxController
from sailfish_tpu.models.single import LBFluidSim as JaxFluidSim
from sailfish_tpu.ops.step import StepBuilder as JaxStepBuilder
from sailfish_tpu.subdomain import Subdomain2D as JaxSubdomain2D
from sailfish_tpu.subdomain import Subdomain3D as JaxSubdomain3D
from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch.ops import lbm_step as ls
from sailfish_tpu_torch.state import state_to_numpy
from torch_scenes import (OUTFLOW_KINDS, KERNEL_OUTFLOW_KINDS, cpu_runner,
                          guo_beside_halfbb, outflow_channel, random_feq,
                          wet_map)

torch.set_num_threads(1)

STEPS = 20
TOL = 1e-6
PALLAS_TOL = 1e-5
#: (dimension, outlet axis) -> size: the catalog's 32^2 channel, and
#: 32x16x16 in 3D with the flow along the long axis
SIZES = {(2, 'x'): dict(lat_nx=32, lat_ny=32),
         (2, 'y'): dict(lat_nx=32, lat_ny=32),
         (3, 'x'): dict(lat_nx=32, lat_ny=16, lat_nz=16),
         (3, 'z'): dict(lat_nx=16, lat_ny=16, lat_nz=32)}
#: the channels of each outflow type
CASES = [(kind, dim, axis) for kind in OUTFLOW_KINDS
         for dim, axis in sorted(SIZES)]


def jax_channel(kind, dim, axis):
    return outflow_channel(
        kind, dim, axis, nt_mod=jnt,
        subdomain_cls=JaxSubdomain3D if dim == 3 else JaxSubdomain2D,
        model_cls=JaxFluidSim)


def port_runner(kind, dim, axis):
    return cpu_runner(outflow_channel(kind, dim, axis), **SIZES[dim, axis])


@pytest.mark.parametrize('kind,dim,axis', CASES)
def test_outflow_matches_jax_xla_engine(kind, dim, axis):
    r = port_runner(kind, dim, axis)
    assert r.engine == 'torch'
    assert getattr(nt, kind).id in r.maps.present_types
    f0 = state_to_numpy(r.f)
    jb = JaxStepBuilder(r.sim.grid, r.maps, visc=r.config.visc,
                        dtype=jnp.float32)
    jstep = jax.jit(jb.build())
    fj = jnp.asarray(f0)
    step = r.builder.build()
    ft = r.f
    for it in range(STEPS):
        fj = jstep(fj, it)
        ft = step(ft, it)
    fj = np.asarray(fj)
    wet = wet_map(r.maps)
    assert np.all(np.isfinite(fj))
    assert np.max(np.abs(state_to_numpy(ft)[:, wet] - fj[:, wet])) <= TOL
    # the flow moved: the run tests something
    assert np.max(np.abs(fj - f0)[:, wet]) > 100 * TOL
    rho_j, u_j = jax.jit(jb.macro_fields)(jnp.asarray(fj))
    rho_t, u_t = r.builder.macro_fields(torch.from_numpy(fj.copy()))
    assert np.max(np.abs(rho_t.numpy()[wet] - np.asarray(rho_j)[wet])) \
        <= TOL
    assert np.max(np.abs(u_t.numpy()[:, wet] - np.asarray(u_j)[:, wet])) \
        <= TOL


@pytest.mark.parametrize('kind', OUTFLOW_KINDS)
def test_outflow_incompressible_matches_jax_xla_engine(kind):
    """The same under --incompressible (the model's equilibrium in Guo's
    overlay), 2D along x: 20 steps from the scene's start. The Yu and Guo
    density channels diverge under it in both packages over a longer run
    (``torch_scenes.INCOMPRESSIBLE_UNSTABLE``); 20 steps stay finite."""
    r = cpu_runner(outflow_channel(kind, 2, 'x'), incompressible=True,
                   **SIZES[2, 'x'])
    assert r.builder.incompressible
    jb = JaxStepBuilder(r.sim.grid, r.maps, visc=r.config.visc,
                        incompressible=True, dtype=jnp.float32)
    jstep = jax.jit(jb.build())
    fj = jnp.asarray(state_to_numpy(r.f))
    step = r.builder.build()
    ft = r.f
    for it in range(STEPS):
        fj = jstep(fj, it)
        ft = step(ft, it)
    fj = np.asarray(fj)
    wet = wet_map(r.maps)
    assert np.all(np.isfinite(fj))
    assert np.max(np.abs(state_to_numpy(ft)[:, wet] - fj[:, wet])) <= TOL


def test_controller_runs_match_jax():
    """Both controllers on the 3D Yu channel, 20 steps: the same state."""
    ctrl = JaxController(jax_channel('NTYuOutflow', 3, 'x'),
                         default_config=dict(
                             platform='cpu', quiet=True, engine='xla',
                             max_iters=STEPS, every=STEPS, **SIZES[3, 'x']))
    ctrl.run(ignore_cmdline=True)
    jr = ctrl._runner
    r = cpu_runner(outflow_channel('NTYuOutflow', 3, 'x'),
                   **dict(SIZES[3, 'x'], max_iters=STEPS, every=STEPS))
    wet = wet_map(r.maps)
    diff = state_to_numpy(r.f)[:, wet] - np.asarray(jr.f)[:, wet]
    assert np.max(np.abs(diff)) <= TOL


#: the kernel-borne types on each channel
KERNEL_CASES = [(kind, dim, axis) for kind in KERNEL_OUTFLOW_KINDS
                for dim, axis in sorted(SIZES)]


@pytest.mark.parametrize('kind,dim,axis', KERNEL_CASES)
def test_kernel_reference_matches_torch_engine(kind, dim, axis):
    """``KernelStep`` on CPU tensors (its plain version, with the outflow
    rows of the table and the laminarize pre-pass's means) against the
    torch engine: one launch from a seeded random state, then 20 steps."""
    r = port_runner(kind, dim, axis)
    ks = ls.KernelStep(r.builder)
    g = r.sim.grid.name.lower()
    grad = kind == 'NTGradFreeflow'
    assert ks.outflow != grad
    assert ks.name == (f'lbm_step_{g}' if grad else f'lbm_step_outflow_{g}')
    assert ks.library == ('lbm_step' if grad else ls.OUTFLOW_LIBRARY)
    assert (ks.lam is not None) == (kind == 'NTLaminarize')
    wet = torch.as_tensor(wet_map(r.maps))
    f0 = random_feq(r.sim.grid, ks.shape, seed=1234, device='cpu')
    step = r.builder.build()
    err = (ks.reference(f0) - step(f0, 0))[:, wet].abs().max()
    assert float(err) <= TOL
    fk = ks.run(f0, STEPS)
    ft = f0
    for it in range(STEPS):
        ft = step(ft, it)
    assert torch.all(torch.isfinite(fk))
    assert float((fk - ft)[:, wet].abs().max()) <= TOL
    assert ks.launches == 0 and ks.prepass_launches == 0      # CPU


@pytest.mark.parametrize('dim,axis', sorted(SIZES))
def test_laminarize_means(dim, axis):
    """The laminarize pre-pass's plain version: for every plane normal to
    the row's normal that holds a node of it, the mean of the post-stream
    values over the row's nodes there (float64 sums over the node lists),
    the count floored at 1; entries in order of the coordinate along the
    normal, from the row's lowest (the outlet face: one entry)."""
    r = port_runner('NTLaminarize', dim, axis)
    ks = ls.KernelStep(r.builder)
    [j] = [j for j, row in enumerate(ks.table)
           if row.type_id == nt.NTLaminarize.id]
    a = 'xyz'.index(axis)
    extent = ks.shape[dim - 1 - a]
    assert ks.lam.spans == ((j, extent - 1, 1),)
    assert ks.params.out.lam_entry[j] == 0
    assert ks.params.out.lam_lo[j] == extent - 1
    nodes, start = ks.lam.nodes.numpy(), ks.lam.start.numpy()
    assert start.tolist() == [0, int((ks.mask == 3 + j).sum())]
    f = random_feq(r.sim.grid, ks.shape, seed=5, device='cpu')
    fs = np.stack([np.roll(f[i].numpy(), tuple(
        int(c) for c in r.sim.grid.basis[i][::-1]), tuple(range(dim)))
        for i in range(r.sim.grid.Q)])
    flat = fs.reshape(r.sim.grid.Q, -1).astype(np.float64)
    mean = ks.laminarize_mean_reference(f).numpy()
    assert mean.shape == (1, r.sim.grid.Q)
    coords = np.unravel_index(nodes, ks.shape)[dim - 1 - a]
    assert np.all(coords == extent - 1)
    np.testing.assert_allclose(mean[0], flat[:, nodes].mean(axis=1),
                               rtol=0, atol=TOL)
    buf = torch.empty_like(ks.lam.mean)
    ks.mean_into(f, buf)
    assert torch.equal(buf, ks.laminarize_mean_reference(f))


def laminarize_slab():
    """The laminarize channel with a slab of four more laminarize planes
    (x = 10-13, alpha 0.5) inside it. Orientation detection gives the
    slab's first plane -x, as the outlet's, and the rest +x: two rows, one
    spanning x = 10 to the outlet (22 planes, two of them with nodes), one
    x = 11-13."""
    base = outflow_channel('NTLaminarize', 2, 'x')

    class Scene(base.subdomain):
        def boundary_conditions(self, hx, hy):
            super().boundary_conditions(hx, hy)
            wall = (hy == 0) | (hy == self.gy - 1)
            self.set_node((hx >= 10) & (hx < 14) & ~wall,
                          nt.NTLaminarize(0.5))

    class Sim(base):
        subdomain = Scene

    return Sim


def test_laminarize_rows_spanning_planes():
    """Laminarize rows whose nodes span several planes along their
    normal: one entry per plane from the lowest, means per plane, and the
    kernel engine's plain version against the torch engine."""
    r = cpu_runner(laminarize_slab(), **SIZES[2, 'x'])
    ks = ls.KernelStep(r.builder)
    spans = ks.lam.spans
    assert sum(count for _j, _lo, count in spans) == ks.lam.mean.shape[0]
    assert max(count for _j, _lo, count in spans) > 1
    for j, lo, count in spans:
        assert ks.params.out.lam_lo[j] == lo
    f0 = random_feq(r.sim.grid, ks.shape, seed=9, device='cpu')
    wet = torch.as_tensor(wet_map(r.maps))
    step = r.builder.build()
    fk, ft = ks.run(f0, STEPS), f0
    for it in range(STEPS):
        ft = step(ft, it)
    assert float((fk - ft)[:, wet].abs().max()) <= TOL


def test_outflow_rows_of_the_table():
    """Each outflow instance is a row of its kind and orientation; a
    uniform scalar in the row (the Neumann gradient), a varying one (the
    laminarization alpha) in rho's place of its block of the parameter
    array; NTGradFreeflow nodes are mask code 0."""
    r = port_runner('NTNeumann', 3, 'x')
    ks = ls.KernelStep(r.builder)
    row = [row for row in ks.table if row.type_id == nt.NTNeumann.id][0]
    assert row.rho == pytest.approx(1e-3, rel=1e-7) and row.box is None
    assert ls.BC_KINDS[nt.NTNeumann] == 12
    assert row.orientation == 2                          # -x: inward
    r = port_runner('NTLaminarize', 2, 'y')
    ks = ls.KernelStep(r.builder)
    [(j, row)] = [(j, row) for j, row in enumerate(ks.table)
                  if row.type_id == nt.NTLaminarize.id]
    assert ks.vary and row.box is not None
    rho_f, _vel = ls.box_params(row, ks.bcp, ks.shape)
    sel = (ks.mask == 3 + j).numpy()
    np.testing.assert_allclose(rho_f.numpy()[sel],
                               r.maps.param_scalar[sel], rtol=1e-7)
    assert np.unique(r.maps.param_scalar[sel]).size > 1
    r = port_runner('NTGradFreeflow', 2, 'x')
    mask, instances, why = ls.classify_nodes(r.maps)
    grad = r.maps.type_map == nt.NTGradFreeflow.id
    assert why == [] and grad.any() and np.all(mask[grad] == 0)


SQUARE = dict(lat_nx=16, lat_ny=16)
CUBE = dict(lat_nx=16, lat_ny=16, lat_nz=16)


@pytest.mark.parametrize('scene,cfg,match', [
    (lambda: outflow_channel('NTYuOutflow', 3, 'x'), dict(CUBE, model='mrt'),
     'outflow rows \\(NTYuOutflow\\) with model=mrt'),
    (lambda: outflow_channel('NTCopy', 2, 'x'),
     dict(SQUARE, subgrid='les-smagorinsky'),
     'outflow rows \\(NTCopy\\) with the Smagorinsky LES model'),
    (lambda: outflow_channel('NTDoNothing', 2, 'y'),
     dict(SQUARE, model='elbm'),
     'outflow rows \\(NTDoNothing\\) with model=elbm'),
    (lambda: outflow_channel('NTNeumann', 2, 'x'),
     dict(SQUARE, precision='mixed'),
     'outflow rows \\(NTNeumann\\) under --precision=mixed'),
    (lambda: outflow_channel('NTLaminarize', 3, 'z'),
     dict(CUBE, grid='D3Q27'), 'outflow rows \\(NTLaminarize\\) on D3Q27'),
    (lambda: outflow_channel('NTExtendedCopy', 2, 'x'), SQUARE,
     'node type NTExtendedCopy'),
    (guo_beside_halfbb, SQUARE, 'NTGuoDensity \\(orientation 1\\) beside'),
])
def test_kernel_refuses_by_name(scene, cfg, match):
    """What the outflow instantiations leave out: the torch engine runs
    each scene, the kernel engine names the reason."""
    r = cpu_runner(scene(), **cfg)
    assert r.engine == 'torch'
    with pytest.raises(NotImplementedError, match=match):
        ls.KernelStep(r.builder)


@pytest.mark.parametrize('kind,dim,axis,size', [
    ('NTYuOutflow', 3, 'z', dict(lat_nx=32, lat_ny=16, lat_nz=16)),
    ('NTCopy', 2, 'y', dict(lat_nx=32, lat_ny=32)),
])
def test_kernel_reference_matches_jax_pallas_engine(kind, dim, axis, size):
    """The JAX Pallas engine in interpret mode recomputes the planes (3D)
    or y-blocks (2D) holding the outflow nodes in its XLA prologue and
    overlays them (patch-plane mode); the port's kernel engine (its plain
    version on the CPU) computes them in the step. 20 steps, 1e-5."""
    ctrl = JaxController(jax_channel(kind, dim, axis), default_config=dict(
        platform='cpu', quiet=True, engine='pallas', max_iters=STEPS,
        every=STEPS, **size))
    ctrl.run(ignore_cmdline=True)
    jr = ctrl._runner
    assert jr.engine == 'pallas'
    p = jr._pallas
    patched = p.patch_rows if dim == 3 else p.patch_blocks
    assert len(patched) > 0
    r = cpu_runner(outflow_channel(kind, dim, axis), **size)
    ks = ls.KernelStep(r.builder)
    assert ks.outflow
    f = ks.run(r.f, STEPS)
    wet = wet_map(r.maps)
    assert np.max(np.abs(f.numpy()[:, wet] - np.asarray(jr.f)[:, wet])) \
        <= PALLAS_TOL


def test_instantiation_reads_the_outflow_switch():
    """``lbm_step.instantiation`` reads ``OUTFLOW``, the kernel's last
    template argument (names as ptxas reported them on the card); an
    older build's name without it has no 'outflow'."""
    sig = 'EvPKT6_PS0_PKh9LBMParamsPKfPKiS8_N8ScalesOfIS0_E4typeE'
    inst = ls.instantiation(
        f'_Z15lbm_step_kernelILi3ELi19ELi0ELb1ELi0ELi0ELb0EfLb1E{sig}')
    assert inst == dict(dim=3, q=19, force='none', walls=True, model='bgk',
                        equilibrium='bgk', sc=False, storage='fp32',
                        outflow=True)
    assert ls.instantiation(
        f'_Z15lbm_step_kernelILi2ELi9ELi2ELb0ELi1ELi1ELb0EsLb0E{sig}')[
            'outflow'] is False
    assert 'outflow' not in ls.instantiation(
        '_Z15lbm_step_kernelILi2ELi9ELi0ELb0ELi0ELi2ELb0EfEvPKT6_')
