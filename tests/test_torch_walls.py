"""The local walls on the CPU: half-way bounce-back (``NTHalfBBWall``),
Tamm-Mott-Smith (``NTWallTMS``) and slip (``NTSlip``).

* The torch ``StepBuilder`` against the JAX XLA engine's on the same maps
  and seeded state: boxes whose walls close one axis, or every axis (flat
  faces, edges and corners), with a block of excluded nodes inside the
  fluid, in 2D and 3D, with and without a Guo force; 20 steps, wet-node
  max |df| <= 1e-6, and ``macro_fields`` <= 1e-6.
* ``step_reference`` (the CUDA kernel's plain version: one BC-table row
  per half-way / TMS type, one per slip axis, the link-tag map) against the
  torch engine's step.
* Analogues of tests/test_bc_catalog.py (slip plug flow, no-slip against
  slip, the TMS channel, the TMS target equilibrium) and of the pulsatile
  half-way channel of tests/test_physics.py:368-416, on the port.
* The five twins of the slice against the stored goldens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu.ops.step import StepBuilder as JaxStepBuilder
from sailfish_tpu_torch import lattice
from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch import equilibrium as teq
from sailfish_tpu_torch.models.base import LBForcedSim
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.ops import lbm_step as ls
from sailfish_tpu_torch.ops.step import StepBuilder
from sailfish_tpu_torch.state import state_to_numpy
from sailfish_tpu_torch.subdomain import Subdomain2D, SubdomainSpec2D
from torch_scenes import (ACCEL, SINGLE_GOLDEN_FLAGS, WALL_DYNAMIC_SCENES,
                          WALLS, box_cfg, box_sim, cpu_runner, golden_run,
                          halfbb_beside_parabolic_inlet, random_feq, run,
                          slip_faces_and_plate, twin, walls_moved, wet_map)

torch.set_num_threads(1)

STEPS = 20
TOL = 1e-6


#: (wall, dim, axes, forced): flat faces normal to y without a force, and
#: walls on every axis (edges and corners) under the Guo force
CASES = [(w, d, axes, len(axes) > 1) for w in sorted(WALLS) for d in (2, 3)
         for axes in ((1,), tuple(range(d)))]


@pytest.mark.parametrize('wall,dim,axes,forced_', CASES)
def test_walls_match_jax_xla_engine(wall, dim, axes, forced_):
    accel = ACCEL if forced_ else None
    r = cpu_runner(box_sim(WALLS[wall], dim, axes, accel),
                   **box_cfg(dim, axes))
    assert r.engine == 'torch'
    if wall != 'slip':
        # every wall node has a link into the wall or the excluded block
        assert (r.maps.link_tags[r.maps.type_map == WALLS[wall].id]
                != 0).all()
    jb = JaxStepBuilder(r.sim.grid, r.maps, visc=r.config.visc,
                        dtype=jnp.float32, body_force=r.builder.body_force)
    jstep = jax.jit(jb.build())
    step = r.builder.build()
    f0 = random_feq(r.sim.grid, r.maps.type_map.shape, 5, 'cpu')
    ft, fj = f0, jnp.asarray(f0.numpy())
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


def test_crude_link_tags_match_jax_xla_engine():
    """--nouse_link_tags tags every link along the node's orientation
    (``subdomain.py:318-333``): the same tags, so the same step, in both
    engines, at the edges and corners of a 3D half-way box too."""
    r = cpu_runner(box_sim(nt.NTHalfBBWall, 3, (0, 1, 2), block=False),
                   use_link_tags=False, **box_cfg(3, (0, 1, 2)))
    exact = cpu_runner(box_sim(nt.NTHalfBBWall, 3, (0, 1, 2), block=False),
                       **box_cfg(3, (0, 1, 2)))
    # flat faces agree; edges and corners differ (the point of the flag)
    assert not np.array_equal(r.maps.link_tags, exact.maps.link_tags)
    jb = JaxStepBuilder(r.sim.grid, r.maps, visc=r.config.visc,
                        dtype=jnp.float32)
    jstep = jax.jit(jb.build())
    f0 = random_feq(r.sim.grid, r.maps.type_map.shape, 6, 'cpu')
    ft, fj = f0, jnp.asarray(f0.numpy())
    step = r.builder.build()
    for _ in range(STEPS):
        ft, fj = step(ft), jstep(fj)
    wet = wet_map(r.maps)
    assert np.max(np.abs(state_to_numpy(ft)[:, wet]
                         - np.asarray(fj)[:, wet])) <= TOL


@pytest.mark.parametrize('case', ['halfbb', 'tms', 'slip', 'inlet'])
def test_step_reference_matches_torch_engine(case):
    """The kernel's plain version, built from its BC table and tag map,
    against the torch engine's step; the wall rows move the state away from
    full bounce-back."""
    if case == 'inlet':
        sim, cfg = halfbb_beside_parabolic_inlet(3), dict(
            lat_nx=12, lat_ny=12, lat_nz=14, periodic_x=True)
    elif case == 'slip':
        sim, cfg = slip_faces_and_plate(), dict(
            lat_nx=11, lat_ny=8, lat_nz=9, periodic_y=True, periodic_z=True)
    else:
        sim, cfg = box_sim(WALLS[case], 3, (0, 1, 2), ACCEL), \
            box_cfg(3, (0, 1, 2))
    r = cpu_runner(sim, **cfg)
    ks = ls.KernelStep(r.builder)
    kinds = {nt.get_node_type(row.type_id) for row in ks.table}
    want = {'halfbb': {nt.NTHalfBBWall}, 'tms': {nt.NTWallTMS},
            'slip': {nt.NTSlip},
            'inlet': {nt.NTHalfBBWall, nt.NTRegularizedVelocity,
                      nt.NTRegularizedDensity}}[case]
    assert kinds == want and ks.walls
    assert (ks.tags is None) == (case == 'slip')
    if case == 'slip':
        assert [row.orientation for row in ks.table] == [1, 5]
    assert ks.name == 'lbm_step_wall_d3q19'
    f0 = random_feq(ks.grid, ks.shape, 8, 'cpu')
    step = r.builder.build()
    f, ft = f0, f0
    for _ in range(10):
        f, ft = ks.reference(f), step(ft)
    wet = (ks.mask == 0) | (ks.mask >= 3)
    assert float((f - ft)[:, wet].abs().max()) <= TOL
    # the wall nodes after one step, against full bounce-back walls there
    assert walls_moved(ks, f0) > 1e-4


def test_wall_rows_of_the_kernel_table():
    """One row for all the half-way walls of the duct, edges included; one
    row per slip axis; unoriented slip nodes and the outflow family are
    refused by name."""
    r = cpu_runner(twin('duct_flow'), lat_nx=16, lat_ny=16, lat_nz=8)
    mask, instances, reasons = ls.classify_nodes(r.maps)
    assert reasons == [] and [(t, k) for t, k, _ in instances] \
        == [(nt.NTHalfBBWall.id, 0)]
    ks = ls.KernelStep(r.builder)
    assert ks.name == 'lbm_step_wall_d3q19' and ks.tags.dtype == torch.int32
    assert ks.params.bc[0].kind == ls.BC_KINDS[nt.NTHalfBBWall] == 6
    assert ks.params.force.model == ls.FORCE_CODES['guo']
    r = cpu_runner(slip_faces_and_plate(), lat_nx=11, lat_ny=8, lat_nz=9,
                   periodic_y=True, periodic_z=True)
    _mask, instances, reasons = ls.classify_nodes(r.maps)
    assert reasons == [] and [(t, k) for t, k, _ in instances] == [
        (nt.NTSlip.id, 1), (nt.NTSlip.id, 5)]
    # a box closed on every axis has slip corners with no fluid neighbour
    r = cpu_runner(box_sim(nt.NTSlip, 2, (0, 1), block=False),
                   **box_cfg(2, (0, 1)))
    assert r.engine == 'torch'
    with pytest.raises(NotImplementedError,
                       match='NTSlip nodes without a detected orientation'):
        ls.KernelStep(r.builder)


# -- physics on the port (tests/test_bc_catalog.py analogues) --------------

def _channel(wall_cls, iters, nx=16, ny=18):
    """Force-driven channel along x between two rows of ``wall_cls``
    (tests/test_bc_catalog.py:_channel at a width of 16 fluid rows:
    visc 0.05, a = 1e-5)."""

    class Chan(Subdomain2D):
        def boundary_conditions(self, hx, hy):
            self.set_node((hy == 0) | (hy == self.gy - 1), wall_cls)

        def initial_conditions(self, sim, hx, hy):
            sim.rho[:] = 1.0

    class Sim(LBFluidSim, LBForcedSim):
        subdomain = Chan

        def __init__(self, config):
            super().__init__(config)
            self.add_body_force((1e-5, 0.0))

    r = run(Sim, platform='cpu', lat_nx=nx, lat_ny=ny, visc=0.05,
            max_iters=iters, every=iters, periodic_x=True)
    r._fields_to_host()
    return r.sim


@pytest.fixture(scope='module')
def channels():
    """The channels of the catalog analogues, 1000 steps each (two
    viscous times W^2 / (pi^2 nu) of the 16-row channel)."""
    return {name: _channel(cls, 1000) for name, cls in (
        ('slip', nt.NTSlip), ('fullbb', nt.NTFullBBWall),
        ('tms', nt.NTWallTMS), ('halfbb', nt.NTHalfBBWall))}


def test_slip_wall_plug_flow(channels):
    """Free-slip walls exert no drag: plug flow, not a parabola."""
    prof = channels['slip'].vx[:, 8]
    interior = prof[1:-1]
    assert np.all(np.isfinite(prof))
    assert interior.mean() > 0.9 * 1e-5 * 1000      # 0.9 a t
    assert interior[0] > 0.95 * interior[len(interior) // 2]


def test_noslip_vs_slip(channels):
    """Same force, same time: the slip channel carries much more flow."""
    assert channels['slip'].vx.mean() > 2.0 * channels['fullbb'].vx.mean()


def test_tms_wall_channel(channels):
    """TMS walls in a laminar forced channel: stable, carrying flow, close
    to the half-way bounce-back solution."""
    tms, bb = channels['tms'], channels['halfbb']
    assert np.all(np.isfinite(tms.vx))
    prof_t, prof_b = tms.vx[:, 8], bb.vx[:, 8]
    # half the mean of the developed flow, a W^2 / (12 nu)
    assert prof_t[1:-1].mean() > 0.5 * 1e-5 * 16 ** 2 / (12 * 0.05)
    err = np.abs(prof_t[2:-2] - prof_b[2:-2]).max() / prof_b.max()
    assert err < 0.1, err


def test_tms_missing_dists_are_target_equilibrium():
    """At a TMS node the tagged (missing) distributions equal the
    equilibrium at the target macros of the bounce-filled populations
    (the reference's tests/gpu/tms.py fixture values)."""
    grid = lattice.get_grid('D2Q9')

    def vi(x, y):
        for i in range(grid.Q):
            if grid.basis[i][0] == x and grid.basis[i][1] == y:
                return i
        raise AssertionError

    fi_start = {
        vi(0, 0): 0.4745, vi(1, 0): 0.1179, vi(-1, 0): 0.1045,
        vi(0, -1): 0.1809, vi(-1, -1): 0.03613, vi(1, -1): 0.00946,
        vi(1, 1): 0.02946, vi(0, 1): 0.1110, vi(-1, 1): 0.02613,
    }
    N = 16

    class Dom(Subdomain2D):
        def boundary_conditions(self, hx, hy):
            self.set_node(hy == 0, nt.NTWallTMS)

    class Cfg:
        periodic_x = True
        periodic_y = False

    dom = Dom((8, N), SubdomainSpec2D((0, 0), (N, 8)), grid, Cfg())
    dom.reset()
    b = StepBuilder(grid, dom.maps, visc=1.0 / 12.0)
    f = np.tile(np.asarray(grid.weights, np.float32)[:, None, None],
                (1, 8, N))
    x0 = 5
    for k, v in fi_start.items():
        f[k, 0, x0] = v
    ft = torch.from_numpy(f)
    # no streaming (the reference test disables propagation): fix_missing
    # sees the node's own values
    fs = b.fix_missing(ft, ft).numpy()
    filled = dict(fi_start)
    for k in fi_start:
        if grid.basis[k][1] == 1:
            filled[k] = fi_start[int(grid.opposite[k])]
    rho_bb = sum(filled.values())
    ux = sum(grid.basis[k][0] * v for k, v in filled.items()) / rho_bb
    uy = sum(grid.basis[k][1] * v for k, v in filled.items()) / rho_bb
    feq = teq.bgk_equilibrium(
        grid, torch.tensor(np.float32(rho_bb)),
        torch.tensor(np.array([ux, uy], np.float32))).numpy()
    for k in fi_start:
        if grid.basis[k][1] == 1:    # tagged (missing) directions
            np.testing.assert_allclose(fs[k, 0, x0], feq[k], rtol=2e-6,
                                       err_msg=str(k))
        else:                         # known populations untouched
            np.testing.assert_allclose(fs[k, 0, x0], fi_start[k],
                                       rtol=1e-6)


def test_pulsatile_half_way_channel_is_womersley():
    """A DynamicValue force sin(w t) drives a closed half-way channel; the
    profile matches the analytic Womersley solution within 3 % of its
    amplitude (tests/test_physics.py:368-416 on the port)."""
    NY, OMEGA, A0, VISC = 18, 2.0 * np.pi / 600.0, 1e-5, 0.1

    class Channel(Subdomain2D):
        def boundary_conditions(self, hx, hy):
            self.set_node((hy == 0) | (hy == self.gy - 1), nt.NTHalfBBWall)

        def initial_conditions(self, sim, hx, hy):
            sim.rho[:] = 1.0

    class Sim(LBFluidSim, LBForcedSim):
        subdomain = Channel

        @classmethod
        def modify_config(cls, config):
            config.periodic_x = True

        def __init__(self, config):
            super().__init__(config)
            self.add_body_force(nt.DynamicValue(
                lambda t: A0 * torch.sin(OMEGA * t), 0.0))

    steps = 1800
    r = run(Sim, platform='cpu', lat_nx=8, lat_ny=NY, visc=VISC,
            max_iters=steps, every=steps)
    r._fields_to_host()
    prof = np.array(r.sim.vx[:, 4])
    yc = np.arange(NY) - (NY - 1) / 2.0
    k = np.sqrt(1j * OMEGA / VISC)
    uhat = (A0 / (1j * OMEGA)) * (1.0 - np.cosh(k * yc)
                                  / np.cosh(k * NY / 2.0))
    ana = np.imag(uhat * np.exp(1j * OMEGA * steps))
    err = np.max(np.abs(prof - ana)) / np.max(np.abs(uhat))
    assert err < 0.03, err


@pytest.mark.parametrize('scene', WALL_DYNAMIC_SCENES)
def test_twin_matches_golden(scene, tmp_path):
    """The twins of the slice on the torch engine against the stored
    goldens at the harness's tolerance; each is eligible for the kernel
    engine, under the launch name of what it needs."""
    r = golden_run(twin(scene), scene, tmp_path,
                   **SINGLE_GOLDEN_FLAGS[scene])
    names = {'poiseuille': 'lbm_step_force_d2q9',
             'duct_flow': 'lbm_step_wall_d3q19',
             'womersley': 'lbm_step_dyn_d3q19',
             'poiseuille_pulsatile': 'lbm_step_dyn_d2q9',
             'poiseuille_sa': 'lbm_step_dyn_d2q9'}
    assert ls.kernel_ineligibility(r.builder) == []
    assert ls.KernelStep(r.builder).name == names[scene]
