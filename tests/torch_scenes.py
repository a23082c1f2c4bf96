"""Scenes and runner helpers shared by the port's tests and chip_smoke.py.

Imports the port and never jax, so ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` can use it where jax is absent. The torch
twins of the examples are loaded by path: the JAX examples of the same
file names (``ldc_2d``, ``sc_separation_2d``, ...) may already be
imported under those names.
"""

import importlib.util
import os

import numpy as np
import torch

from sailfish_tpu_torch import equilibrium as teq
from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.models.base import LBForcedSim
from sailfish_tpu_torch.models.single import (LBFluidSim, LBIBMFluidSim,
                                              Particle)
from sailfish_tpu_torch.subdomain import Subdomain2D, Subdomain3D
from sailfish_tpu_torch.tracers import TracerParticles
from sailfish_tpu_torch.vis_mixin import Vis2DSliceMixIn, \
    connect_slice_client

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: velocity/density BC pairs of tests/test_sharded_pallas.py:616-713
BC_PAIRS = {
    'equilibrium': (nt.NTEquilibriumVelocity, nt.NTEquilibriumDensity),
    'zouhe': (nt.NTZouHeVelocity, nt.NTZouHeDensity),
    'regularized': (nt.NTRegularizedVelocity, nt.NTRegularizedDensity),
}


def load_example(rel, name):
    """The module ``examples/<rel>``, loaded by path under ``name``."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, 'examples', rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: single-fluid twins (examples/torch) -> sim class name
SINGLE_SCENES = {
    'ldc_2d': 'LDCSim',
    'ldc_2d_entropic': 'EntropicLDCSim',
    'ldc_3d': 'LDCSim',
    'cylinder': 'CylinderSimulation',
    'sphere_3d': 'SphereSimulation',
    'square_cylinder_2d': 'SquareCylinderSim',
    'external_geometry': 'ExternalSimulation',
    'poiseuille_3d': 'PoiseuilleSim',
    'taylor_green_2d': 'TaylorGreenSim',
    'four_rolls_mill': 'FourRollsMill',
    'poiseuille': 'PoiseuilleSim',
    'duct_flow': 'DuctSim',
    'womersley': 'WomersleySim',
    'poiseuille_pulsatile': 'PulsatileSim',
    'poiseuille_sa': 'RampedPoiseuilleSim',
    'porous_anisotropy': 'PorousSim',
    'sc_drop': 'SCSim',
    'sc_phase_separation': 'SCSim',
    'sc_phase_separation_3d': 'SCSim3D',
    'fs_gaussian': 'FSSim',
    'ldc_2d_unorm': 'LDCSimUnorm',
    'ibm_cylinder': 'IBMSim',
}
#: the golden harness's flags for the single-fluid scenes
#: (tests/examples_harness.py:26-94)
SINGLE_GOLDEN_FLAGS = {
    'ldc_2d': dict(lat_nx=32, lat_ny=32),
    'ldc_2d_entropic': dict(lat_nx=32, lat_ny=32),
    'ldc_3d': dict(lat_nx=16, lat_ny=16, lat_nz=16),
    'cylinder': dict(lat_nx=64, lat_ny=32),
    'sphere_3d': dict(lat_nx=32, lat_ny=16, lat_nz=16),
    'square_cylinder_2d': dict(lat_nx=64, lat_ny=32),
    'external_geometry': {},
    'poiseuille_3d': dict(lat_nx=16, lat_ny=16, lat_nz=16),
    'taylor_green_2d': dict(lat_nx=32, lat_ny=32),
    'four_rolls_mill': dict(lat_nx=32, lat_ny=32),
    'poiseuille': dict(lat_nx=32, lat_ny=32),
    'duct_flow': dict(lat_nx=16, lat_ny=16, lat_nz=8),
    'womersley': dict(lat_nx=32, lat_ny=12, lat_nz=12),
    'poiseuille_pulsatile': dict(lat_nx=48, lat_ny=24),
    'poiseuille_sa': dict(lat_nx=48, lat_ny=32, velocity='spatial_array'),
    'porous_anisotropy': dict(lat_nx=16, lat_ny=16, lat_nz=16,
                              porosity=0.75),
    'sc_drop': dict(lat_nx=48, lat_ny=48),
    'sc_phase_separation': dict(lat_nx=32, lat_ny=32),
    'sc_phase_separation_3d': dict(lat_nx=16, lat_ny=16, lat_nz=16),
    'fs_gaussian': dict(lat_nx=32, lat_ny=32),
    'ldc_2d_unorm': dict(lat_nx=32, lat_ny=32, unorm_every=7),
    'ibm_cylinder': dict(lat_nx=48, lat_ny=24),
}
#: the single-component Shan-Chen twins (the kernel engine's ``sc`` mode,
#: after the density pre-pass) and the shallow-water twin (its
#: shallow-water equilibrium)
SC_SINGLE_SCENES = ('sc_drop', 'sc_phase_separation',
                    'sc_phase_separation_3d')
SHALLOW_WATER_SCENES = ('fs_gaussian',)
#: the single-fluid scenes driven by a constant body force (the kernel
#: engine's forcing mode)
FORCED_SCENES = ('cylinder', 'sphere_3d', 'square_cylinder_2d',
                 'external_geometry', 'poiseuille_3d', 'porous_anisotropy')
#: the scenes of the local walls and time-dependent parameters: half-way
#: walls (duct_flow; poiseuille with --wall=halfbb), time-only density ends
#: (womersley, poiseuille_pulsatile), a time-only force
#: (poiseuille_pulsatile --drive=force) and a space- and time-dependent
#: inlet (poiseuille_sa)
WALL_DYNAMIC_SCENES = ('poiseuille', 'duct_flow', 'womersley',
                       'poiseuille_pulsatile', 'poiseuille_sa')


def twin(scene):
    """The sim class of ``examples/torch/<scene>.py``."""
    mod = load_example(f'torch/{scene}.py', f'torch_{scene}')
    return getattr(mod, SINGLE_SCENES[scene])


#: binary Shan-Chen twins (examples/torch/binary_fluid) -> sim class name
BINARY_SCENES = {
    'sc_separation_2d': 'SeparationSCSim',
    'sc_separation_3d': 'SeparationSCSim',
    'sc_separation_3d_walls': 'WalledSeparationSim',
}
#: more binary Shan-Chen twins (a drop held by the self-coupling G11, a
#: Laplace-law drop, three scenes under body forces and a capillary wave)
#: -> sim class name
SC_MORE_SCENES = {
    'sc_drop_2d': 'SCDropSim',
    'sc_laplace_2d': 'LaplaceSim',
    'sc_rayleigh_taylor_2d': 'RayleighTaylorSCSim',
    'sc_capillary': 'CapillaryTaylorSim',
    'sc_poiseuille_2d': 'LayeredPoiseuilleSim',
    'sc_capillary_wave_2d': 'SCCapillaryWaveSim',
}
#: those of them with a constant body force on a component (Guo forcing;
#: the forced instantiations of the mixture kernels)
SC_FORCED_SCENES = ('sc_rayleigh_taylor_2d', 'sc_capillary',
                    'sc_poiseuille_2d')
#: those of them closed by half-way walls: the JAX package runs these in a
#: mixture on its XLA engine only, and the mixture kernels refuse them by
#: name, so they run on the torch engine on a card too
SC_HALFWAY_SCENES = ('sc_poiseuille_2d', 'sc_capillary_wave_2d')
#: the golden harness's flags for them (tests/examples_harness.py:49-79)
SC_MORE_GOLDEN_FLAGS = {
    'sc_drop_2d': dict(lat_nx=64, lat_ny=64),
    'sc_laplace_2d': dict(lat_nx=64, lat_ny=64),
    'sc_rayleigh_taylor_2d': dict(lat_nx=32, lat_ny=32),
    'sc_capillary': dict(lat_nx=96, lat_ny=32),
    'sc_poiseuille_2d': dict(lat_nx=66, lat_ny=32),
    'sc_capillary_wave_2d': dict(lat_nx=64, lat_ny=66),
}
#: ternary Shan-Chen twins (examples/torch/ternary_fluid) -> sim class name
TERNARY_SCENES = {'sc_drop_2d': 'TernaryDropSim'}
#: the golden harness's flags for them (tests/examples_harness.py:79)
TERNARY_GOLDEN_FLAGS = {'sc_drop_2d': dict(lat_nx=64, lat_ny=64)}
#: binary free-energy twins (examples/torch/binary_fluid) -> sim class name
FE_SCENES = {
    'fe_separation_2d': 'SeparationFESim',
    'fe_separation_3d': 'SeparationFESim3D',
    'fe_poiseuille_2d': 'FEPoiseuilleSim',
    'fe_viscous_fingering': 'FingeringFESim',
    'binary_microchannel': 'MicrochannelSim',
}
#: the golden harness's flags for the free-energy scenes
#: (tests/examples_harness.py:40, :48, :70-75)
FE_GOLDEN_FLAGS = {
    'fe_separation_2d': dict(lat_nx=32, lat_ny=32),
    'fe_separation_3d': dict(lat_nx=16, lat_ny=16, lat_nz=16),
    'fe_poiseuille_2d': dict(lat_nx=32, lat_ny=32),
    'fe_viscous_fingering': dict(lat_nx=160, lat_ny=32, lat_nz=16),
    'binary_microchannel': dict(H=17),
}


#: the free-energy twin between half-way walls (its device hook samples
#: the interface height): the free-energy kernel refuses half-way walls by
#: name, so it runs on the torch engine on a card too
FE_HALFWAY_SCENES = {'fe_capillary_wave_2d': 'CapillaryWaveSim'}
#: the golden harness's flags for it (tests/examples_harness.py:67)
FE_HALFWAY_GOLDEN_FLAGS = {'fe_capillary_wave_2d': dict(lat_nx=64,
                                                        lat_ny=66)}


def binary_twin(scene):
    """The sim class of ``examples/torch/binary_fluid/<scene>.py``."""
    mod = load_example(f'torch/binary_fluid/{scene}.py', f'torch_{scene}')
    return getattr(mod, {**BINARY_SCENES, **SC_MORE_SCENES,
                         **FE_SCENES, **FE_HALFWAY_SCENES}[scene])


#: turbulence twins (examples/torch/turbulence) -> sim class name; their
#: statistics run through device hooks (``sailfish_tpu_torch.stats`` and
#: kida_vortex's own)
TURBULENCE_SCENES = {
    'kida_vortex': 'KidaSim',
    'channel_flow': 'ChannelSim',
    'channel_cube': 'CubeChannelSim',
}
#: the golden harness's flags for them (tests/examples_harness.py:49-91)
TURBULENCE_GOLDEN_FLAGS = {
    'kida_vortex': dict(lat_nx=16, lat_ny=16, lat_nz=16, visc=0.01,
                        stats_every=5),
    'channel_flow': dict(H=8, Re_tau=60, wall='tms', stats_every=5),
    'channel_cube': dict(H=6, Re_tau=60, buf_az=3, main_az=5, ay=2.5,
                         stats_every=5),
}


def turbulence_twin(scene):
    """The sim class of ``examples/torch/turbulence/<scene>.py``."""
    mod = load_example(f'torch/turbulence/{scene}.py',
                       f'torch_turbulence_{scene}')
    return getattr(mod, TURBULENCE_SCENES[scene])


def ternary_twin(scene):
    """The sim class of ``examples/torch/ternary_fluid/<scene>.py``."""
    mod = load_example(f'torch/ternary_fluid/{scene}.py',
                       f'torch_ternary_{scene}')
    return getattr(mod, TERNARY_SCENES[scene])


def ternary_separation(dim=3, subdomain_cls=None, model_cls=None,
                       walls=False):
    """Three-component Shan-Chen demixing in a periodic box (D3Q19 for
    ``dim`` 3, the ``ternary_separation_3d`` scene; D2Q9 for 2): the
    pairwise repulsion G12 = G13 = G23 = 1.0, visc 1/6, and a near-uniform
    start rho, phi, theta = 1 + U(0, 1e-3) drawn from the run's seed
    (tests/test_binary.py:78-96, lifted to 3D). No example is a 3D ternary
    scene; this one gives the K = 3 D3Q19 kernel a path. ``walls``: full
    bounce-back walls on the two faces normal to y. ``subdomain_cls`` and
    ``model_cls`` (default the port's ``Subdomain3D`` / ``Subdomain2D`` and
    ``LBTernaryFluidShanChen``) let a test build the same scene from the
    JAX package's classes."""
    if subdomain_cls is None:
        subdomain_cls = Subdomain3D if dim == 3 else Subdomain2D
    if model_cls is None:
        from sailfish_tpu_torch.models.ternary import LBTernaryFluidShanChen
        model_cls = LBTernaryFluidShanChen

    class Separation(subdomain_cls):
        def boundary_conditions(self, *h):
            if walls:
                self.set_node((h[1] == 0) | (h[1] == self.gy - 1),
                              nt.NTFullBBWall)

        def initial_conditions(self, sim, *h):
            for name in ('rho', 'phi', 'theta'):
                fld = getattr(sim, name)
                fld[:] = 1.0 + np.random.rand(*fld.shape) / 1000.0

    class TernarySeparationSim(model_cls):
        subdomain = Separation

        @classmethod
        def update_defaults(cls, defaults):
            defaults.update({
                'grid': 'D3Q19' if dim == 3 else 'D2Q9',
                'G12': 1.0, 'G13': 1.0, 'G23': 1.0, 'visc': 1.0 / 6.0,
                'periodic_x': True, 'periodic_y': True,
                'periodic_z': True})

    return TernarySeparationSim


#: constant accelerations of the forced mixture comparisons, one per
#: component: every axis, both signs, each component its own, strong
#: enough that the Guo term moves 20 steps well beyond the tolerances
MIX_ACCELS = ((1e-3, -5e-4, 2.5e-4), (-5e-4, 1.5e-3, -1e-3),
              (7.5e-4, 5e-4, 1.25e-3))


def forced_mixture(sim_cls, accels=MIX_ACCELS):
    """The mixture ``sim_cls`` with the constant acceleration ``accels[k]``
    (its first ``dim`` entries; None: none) added to component k's body
    force."""

    class Sim(sim_cls):
        def __init__(self, config):
            super().__init__(config)
            for k, a in enumerate(accels[:len(self.grids)]):
                if a is not None:
                    self.add_body_force(tuple(a[:self.dim]), grid=k)

    return Sim


def run(sim_cls, **cfg):
    """The port's runner after ``LBSimulationController.run`` with the
    config ``cfg`` (quiet, no command line)."""
    ctrl = LBSimulationController(sim_cls, default_config=dict(
        quiet=True, **cfg))
    ctrl.run(ignore_cmdline=True)
    return ctrl._runner


def golden_run(sim_cls, golden_name, tmp_path, atol=None, **cfg):
    """Run 20 steps on the CPU as the golden harness does
    (tests/examples_harness.py: seed 1234, output at step 20) and hold
    every stored field against ``tests/goldens/<golden_name>.npz`` at the
    harness's tolerance (rtol 1e-5, atol 5e-7); ``atol`` maps a field to
    another absolute tolerance. Returns the runner."""
    out = os.path.join(str(tmp_path), golden_name)
    r = run(sim_cls, platform='cpu', max_iters=20, every=20, seed=1234,
            output=out, **cfg)
    assert r.engine == 'torch'
    data = np.load(f'{out}.0.0000020.npz')
    ref = np.load(os.path.join(REPO, 'tests', 'goldens',
                               f'{golden_name}.npz'))
    assert sorted(data.files) == sorted(ref.files)
    for k in ref.files:
        np.testing.assert_allclose(
            data[k], ref[k], rtol=1e-5, atol=(atol or {}).get(k, 5e-7),
            err_msg=f'{golden_name}:{k}')
    return r


def cpu_runner(sim_cls, **cfg):
    """The port's runner after initialization only (no steps), on the
    CPU."""
    return run(sim_cls, **{'platform': 'cpu', 'max_iters': 0, **cfg})


#: peak inlet velocity of the parabolic channels
U_INLET = 0.03


def parabolic_profile(s, n, u_max=U_INLET):
    """Plane-Poiseuille inlet velocity at cross-channel coordinate ``s`` of
    an extent ``n`` whose first and last nodes are full bounce-back walls
    (effective walls half a node inside, at s = 0.5 and n - 1.5):
    4 U (s - 0.5) (n - 1.5 - s) / (n - 2)^2, peak U at the centre."""
    s = np.asarray(s, dtype=np.float64)
    return 4.0 * u_max * (s - 0.5) * (n - 1.5 - s) / float(n - 2) ** 2


def channel_sim(pair, axis='z', profile=None):
    """Velocity inlet at the low face normal to ``axis`` ('x', 'y' or
    'z'), density outlet (rho = 1) at the high face, bounce-back walls
    normal to y, or to z when the channel flows along y
    (tests/test_sharded_pallas.py:616-675 for z, :696-713 for x). The
    inlet velocity is uniform (0.03), or with ``profile='parabolic'`` the
    ``parabolic_profile`` across the walls' axis (a full-shape parameter
    array)."""
    vel_cls, den_cls = BC_PAIRS[pair]
    a = 'xyz'.index(axis)
    wa = 2 if a == 1 else 1

    class Channel(Subdomain3D):
        def boundary_conditions(self, hx, hy, hz):
            h, n = (hx, hy, hz)[a], (self.gx, self.gy, self.gz)[a]
            s, ns = (hx, hy, hz)[wa], (self.gx, self.gy, self.gz)[wa]
            walls = (s == 0) | (s == ns - 1)
            self.set_node(walls, nt.NTFullBBWall)
            un = U_INLET
            if profile == 'parabolic':
                un = parabolic_profile(s, ns)
            u_in = tuple(un if i == a else 0.0 for i in range(3))
            self.set_node((h == 0) & ~walls, vel_cls(u_in))
            self.set_node((h == n - 1) & ~walls, den_cls(1.0))

        def initial_conditions(self, sim, hx, hy, hz):
            sim.rho[:] = 1.0
            getattr(sim, f'v{axis}')[:] = 0.01

    class Sim(LBFluidSim):
        subdomain = Channel

    return Sim


def channel_sim_2d(pair, profile='parabolic', axis='y'):
    """The 2D twin of ``channel_sim``, flowing along ``axis``: bounce-back
    walls normal to the other axis, the velocity inlet
    (``parabolic_profile`` across the channel, or uniform 0.03 with
    ``profile=None``) at the low face normal to ``axis`` (y = 0, or
    x = 0) and the density outlet (rho = 1) at the high face."""
    vel_cls, den_cls = BC_PAIRS[pair]
    a = 'xy'.index(axis)

    class Channel(Subdomain2D):
        def boundary_conditions(self, hx, hy):
            h, n = (hx, hy)[a], (self.gx, self.gy)[a]
            s, ns = (hx, hy)[1 - a], (self.gx, self.gy)[1 - a]
            walls = (s == 0) | (s == ns - 1)
            self.set_node(walls, nt.NTFullBBWall)
            un = U_INLET
            if profile == 'parabolic':
                un = parabolic_profile(s, ns)
            u_in = tuple(un if i == a else 0.0 for i in range(2))
            self.set_node((h == 0) & ~walls, vel_cls(u_in))
            self.set_node((h == n - 1) & ~walls, den_cls(1.0))

        def initial_conditions(self, sim, hx, hy):
            sim.rho[:] = 1.0
            getattr(sim, f'v{axis}')[:] = 0.01

    class Sim(LBFluidSim):
        subdomain = Channel

    return Sim


#: the body force of the forced channels: along the flow and, weaker,
#: across it, so every component and both signs enter
CHANNEL_ACCEL = (1e-5, -4e-6, 2.5e-6)


def forced(sim_cls, accel):
    """``sim_cls`` (an ``LBFluidSim``) with ``LBForcedSim`` mixed in and the
    constant acceleration ``accel`` (x, y[, z]) as its body force;
    ``--force_implementation`` picks the model."""

    class Sim(sim_cls, LBForcedSim):
        def __init__(self, config):
            super().__init__(config)
            self.add_body_force(accel)

    return Sim


def unforced(sim_cls):
    """``sim_cls`` (a force-driven scene) without its body force: the same
    geometry on the unforced step."""

    class Sim(sim_cls):
        def add_body_force(self, *args, **kwargs):
            pass

    return Sim


def forced_channel_sim(pair, axis='z', profile=None, accel=CHANNEL_ACCEL):
    """``channel_sim`` under the constant body force ``accel``: native-BC
    faces normal to ``axis`` whose nodes take the force with the fluid. No
    example has both (poiseuille_3d is driven by a force or by density
    faces)."""
    return forced(channel_sim(pair, axis, profile), accel)


def forced_channel_sim_2d(pair, profile=None, axis='y',
                          accel=CHANNEL_ACCEL[:2]):
    """The 2D twin of ``forced_channel_sim``."""
    return forced(channel_sim_2d(pair, profile, axis), accel)


#: the local walls of ``box_sim``
WALLS = {'halfbb': nt.NTHalfBBWall, 'tms': nt.NTWallTMS, 'slip': nt.NTSlip}
#: the Guo force of the forced wall scenes (every component, both signs)
ACCEL = (1e-5, -4e-6, 2.5e-6)


def box_sim(wall, dim, axes, accel=None, block=True):
    """A box with ``wall`` nodes on both faces normal to each of ``axes``
    (edges and corners where two meet), periodic along the other axes, and
    with ``block`` a 3-node block of excluded nodes inside the fluid (walls
    tagged against it)."""
    base = Subdomain3D if dim == 3 else Subdomain2D

    class Box(base):
        def boundary_conditions(self, *h):
            shape = self.shape[::-1]
            walls = np.zeros(h[0].shape, dtype=bool)
            for a in axes:
                walls |= (h[a] == 0) | (h[a] == shape[a] - 1)
            self.set_node(walls, wall)
            if block:
                sel = np.ones(h[0].shape, dtype=bool)
                for a, hh in enumerate(h):
                    sel &= (hh >= 4) & (hh < 7)
                self.update_node(sel, nt._NTUnused)

        def initial_conditions(self, sim, *h):
            sim.rho[:] = 1.0

    class Sim(LBFluidSim):
        subdomain = Box

    return Sim if accel is None else forced(Sim, accel[:dim])


def box_cfg(dim, axes):
    cfg = dict(lat_nx=14, lat_ny=12) if dim == 2 else \
        dict(lat_nx=11, lat_ny=10, lat_nz=9)
    for a in range(dim):
        cfg[f'periodic_{"xyz"[a]}'] = a not in axes
    return cfg


def slip_faces_and_plate():
    """Slip faces normal to x, and a slip plate normal to z across the
    middle of the box (fluid on both sides), periodic along y and z: a slip
    row for each of two axes, every slip node oriented."""

    class Slip(Subdomain3D):
        def boundary_conditions(self, hx, hy, hz):
            self.set_node((hx == 0) | (hx == self.gx - 1), nt.NTSlip)
            self.set_node((hz == self.gz // 2) & (hx > 2)
                          & (hx < self.gx - 3), nt.NTSlip)

        def initial_conditions(self, sim, hx, hy, hz):
            sim.rho[:] = 1.0

    class Sim(LBFluidSim):
        subdomain = Slip

    return forced(Sim, ACCEL)


def tms_channel_sim(dim):
    """The forced channel of tests/test_bc_catalog.py:_channel with TMS
    walls (a = 1e-5 along x, walls normal to y; periodic x, and z in 3D)."""
    base = Subdomain3D if dim == 3 else Subdomain2D

    class Chan(base):
        def boundary_conditions(self, *h):
            self.set_node((h[1] == 0) | (h[1] == self.shape[-2] - 1),
                          nt.NTWallTMS)

        def initial_conditions(self, sim, *h):
            sim.rho[:] = 1.0

    class Sim(LBFluidSim):
        subdomain = Chan

    return forced(Sim, (1e-5,) + (0.0,) * (dim - 1))


def slip_sim(dim, axis, accel=ACCEL):
    """Slip faces normal to ``axis`` (0, 1 or 2), periodic along the other
    axes, under the force ``accel``."""
    base = Subdomain3D if dim == 3 else Subdomain2D

    class Slip(base):
        def boundary_conditions(self, *h):
            n = self.shape[::-1][axis]
            self.set_node((h[axis] == 0) | (h[axis] == n - 1), nt.NTSlip)

        def initial_conditions(self, sim, *h):
            sim.rho[:] = 1.0

    class Sim(LBFluidSim):
        subdomain = Slip

    return forced(Sim, accel[:dim])


def halfbb_beside_parabolic_inlet(dim):
    """The parabolic-inlet channel of ``dim`` dimensions (a varying
    regularized inlet at the low face normal to z, or y in 2D, a density
    outlet) with half-way walls instead of full bounce-back."""
    base = channel_sim('regularized', 'z', profile='parabolic') \
        if dim == 3 else channel_sim_2d('regularized', 'parabolic', 'y')

    class Walls(base.subdomain):
        def boundary_conditions(self, *h):
            super().boundary_conditions(*h)
            self.update_node(self.maps.type_map == nt.NTFullBBWall.id,
                             nt.NTHalfBBWall)

    class Sim(base):
        subdomain = Walls

    return Sim


def time_series_density_sim():
    """A 2D channel along x between full bounce-back walls, a Zou-He
    density inlet following a ``LinearlyInterpolatedTimeSeries`` (period
    200 steps) and a constant Zou-He density outlet: a time-only BC row."""
    series = nt.LinearlyInterpolatedTimeSeries(
        [1.0, 1.004, 1.0, 0.996], step_size=50)

    class Chan(Subdomain2D):
        def boundary_conditions(self, hx, hy):
            wall = (hy == 0) | (hy == self.gy - 1)
            self.set_node(wall, nt.NTFullBBWall)
            self.set_node(~wall & (hx == 0), nt.NTZouHeDensity(series))
            self.set_node(~wall & (hx == self.gx - 1),
                          nt.NTZouHeDensity(1.0))

        def initial_conditions(self, sim, hx, hy):
            sim.rho[:] = 1.0

    class Sim(LBFluidSim):
        subdomain = Chan

    return Sim


#: the outflow family by class name, in the order of its tests; the kernel
#: carries all but the extended copy (NTGradFreeflow as the fluid node it
#: is in both engines: ``ops/step.OUTFLOW_TYPES``)
OUTFLOW_KINDS = ('NTDoNothing', 'NTCopy', 'NTYuOutflow', 'NTNeumann',
                 'NTGradFreeflow', 'NTLaminarize', 'NTGuoDensity',
                 'NTExtendedCopy')
KERNEL_OUTFLOW_KINDS = OUTFLOW_KINDS[:-1]
#: the outflow types whose channels diverge under --incompressible on every
#: engine, the JAX package's XLA engine too (64x32 from the scene's start:
#: |u| beyond 80 within 1,000 steps; from a random state within 20), so the
#: comparisons take the incompressible equilibrium with the others only
INCOMPRESSIBLE_UNSTABLE = ('NTYuOutflow', 'NTGuoDensity')
#: the inlet velocity of the outflow channels, the Neumann gradient, the
#: Guo densities at the two ends
OUTFLOW_U = 0.02
NEUMANN_GRADIENT = 1e-3
GUO_RHO = (1.02, 0.98)


def outflow_channel(kind, dim, axis, nt_mod=None, subdomain_cls=None,
                    model_cls=None):
    """The inflow/outflow channel of tests/test_bc_catalog.py:13-49, in
    ``dim`` dimensions along ``axis`` ('x', 'y' or 'z'), for the outflow
    type named ``kind``: full bounce-back walls on both faces normal to
    the cross axis (y, or in 2D x when flowing along y, in 3D z when
    flowing along y), an ``NTEquilibriumVelocity`` inlet (``OUTFLOW_U``
    along the axis) on the low face and the ``kind`` outlet on the high
    face (both without the wall nodes), periodic along the third axis. The
    outlet takes its parameters: the gradient ``NEUMANN_GRADIENT``, an
    alpha rising from 0.3 to 0.7 across the channel (a varying scalar), a
    translation by the inward normal (the extended copy, which then equals
    ``NTCopy``: tests/test_bc_catalog.py:209); ``NTGuoDensity`` takes both
    ends at the densities ``GUO_RHO``. Start: rho = 1 and 0.01 along the
    axis; visc 0.05 (tau = 0.65: at tau = 1 Guo's BC keeps no
    non-equilibrium part). ``nt_mod`` (a ``node_type`` module),
    ``subdomain_cls`` and
    ``model_cls`` (default the port's) let a test build the same scene
    from the JAX package's classes."""
    nt_mod = nt_mod or nt
    if subdomain_cls is None:
        subdomain_cls = Subdomain3D if dim == 3 else Subdomain2D
    model_cls = model_cls or LBFluidSim
    a = 'xyz'.index(axis)
    wa = (1 - a) if dim == 2 else (2 if a == 1 else 1)
    third = ({0, 1, 2} - {a, wa}).pop() if dim == 3 else None
    out_cls = getattr(nt_mod, kind)

    class Channel(subdomain_cls):
        def boundary_conditions(self, *h):
            ext = self.shape[::-1]
            s, ns = h[wa], ext[wa]
            walls = (s == 0) | (s == ns - 1)
            self.set_node(walls, nt_mod.NTFullBBWall)
            low = (h[a] == 0) & ~walls
            high = (h[a] == ext[a] - 1) & ~walls
            if kind == 'NTGuoDensity':
                self.set_node(low, out_cls(GUO_RHO[0]))
                self.set_node(high, out_cls(GUO_RHO[1]))
                return
            u_in = tuple(OUTFLOW_U if i == a else 0.0 for i in range(dim))
            self.set_node(low, nt_mod.NTEquilibriumVelocity(u_in))
            if kind == 'NTNeumann':
                node = out_cls(gradient=NEUMANN_GRADIENT)
            elif kind == 'NTLaminarize':
                node = out_cls(0.3 + 0.4 * s / (ns - 1.0))
            elif kind == 'NTExtendedCopy':
                T = np.eye(4)
                T[a, 3] = -1.0
                node = out_cls(transformation=T)
            else:
                node = out_cls()
            self.set_node(high, node)

        def initial_conditions(self, sim, *h):
            sim.rho[:] = 1.0
            getattr(sim, f'v{axis}')[:] = 0.01

    class Sim(model_cls):
        subdomain = Channel

        @classmethod
        def update_defaults(cls, defaults):
            super().update_defaults(defaults)
            defaults['visc'] = 0.05

        @classmethod
        def modify_config(cls, config):
            super().modify_config(config)
            if third is not None:
                setattr(config, f'periodic_{"xyz"[third]}', True)

    return Sim


def guo_beside_halfbb():
    """The 2D Guo density channel along x with a half-way wall node at
    x = 1, y = 5: the neighbour along the inward normal of an inlet node,
    whose missing distributions ``fix_missing`` replaces (the kernel refuses
    the scene by name)."""
    base = outflow_channel('NTGuoDensity', 2, 'x')

    class Scene(base.subdomain):
        def boundary_conditions(self, hx, hy):
            super().boundary_conditions(hx, hy)
            self.set_node((hx == 1) & (hy == 5), nt.NTHalfBBWall)

    class Sim(base):
        subdomain = Scene

    return Sim


#: the open channels of the outflow family's main paths: inlet velocity,
#: viscosity, the body's diameter over the channel's height (Y / 3 sphere,
#: Y / 8 cylinder) and its centre, two diameters behind the inlet
OPEN_U = 0.05
OPEN_VISC = 0.05


def open_channel(dim, nt_mod=None, subdomain_cls=None, model_cls=None,
                 force_object_cls=None):
    """Open-channel flow past a body with its drag read by a force object:
    in 3D (``open_sphere_3d``) a square duct of ``NTFullBBWall`` on the y
    and z faces, a uniform ``NTRegularizedVelocity`` inlet (``OPEN_U``, 0,
    0) at x = 0, an ``NTYuOutflow`` outlet at x = X - 1 and a bounce-back
    sphere of diameter Y / 3 two diameters behind the inlet (the geometry
    of examples/sphere_3d.py, tests/test_force_objects.py:20-30); in 2D
    (``open_cylinder_2d``) plates at y = 0, Y - 1, an ``NTZouHeVelocity``
    inlet, an ``NTCopy`` outlet and a cylinder of diameter Y / 8. One
    ``ForceObject`` bounds the body with a margin of two nodes; the sim
    calls ``runner.update_force_objects()`` after every chunk and keeps
    (iteration, force) in ``drag``. Start: rho = 1, u = (``OPEN_U``, 0[,
    0]) everywhere; visc ``OPEN_VISC``. ``nt_mod``, ``subdomain_cls``,
    ``model_cls`` and ``force_object_cls`` (default the port's) let a test
    build the same scene from the JAX package's classes."""
    nt_mod = nt_mod or nt
    if subdomain_cls is None:
        subdomain_cls = Subdomain3D if dim == 3 else Subdomain2D
    model_cls = model_cls or LBFluidSim
    if force_object_cls is None:
        from sailfish_tpu_torch.models.base import ForceObject
        force_object_cls = ForceObject

    def body(ext):
        """(diameter, centre (x, y[, z])) of the body in a domain of the
        extents ``ext`` (x, y[, z])."""
        diam = ext[1] / (3.0 if dim == 3 else 8.0)
        return diam, (2.0 * diam,) + tuple(e / 2.0 for e in ext[1:])

    class Open(subdomain_cls):
        def boundary_conditions(self, *h):
            ext = self.shape[::-1]
            walls = np.zeros(h[0].shape, dtype=bool)
            for a in range(1, dim):
                walls |= (h[a] == 0) | (h[a] == ext[a] - 1)
            self.set_node(walls, nt_mod.NTFullBBWall)
            u_in = (OPEN_U,) + (0.0,) * (dim - 1)
            inlet = nt_mod.NTRegularizedVelocity if dim == 3 \
                else nt_mod.NTZouHeVelocity
            self.set_node((h[0] == 0) & ~walls, inlet(u_in))
            outlet = nt_mod.NTYuOutflow if dim == 3 else nt_mod.NTCopy
            self.set_node((h[0] == ext[0] - 1) & ~walls, outlet)
            diam, centre = body(ext)
            r_sq = sum(np.square(hh - c) for hh, c in zip(h, centre))
            self.set_node((r_sq <= np.square(diam / 2.0)) & ~walls,
                          nt_mod.NTFullBBWall)

        def initial_conditions(self, sim, *h):
            sim.rho[:] = 1.0
            sim.vx[:] = OPEN_U

    class Sim(model_cls):
        subdomain = Open

        @classmethod
        def update_defaults(cls, defaults):
            super().update_defaults(defaults)
            defaults.update({'visc': OPEN_VISC,
                             'grid': 'D3Q19' if dim == 3 else 'D2Q9'})

        def __init__(self, config):
            super().__init__(config)
            ext = (config.lat_nx, config.lat_ny, config.lat_nz)[:dim]
            diam, centre = body(ext)
            r = diam / 2.0 + 2
            self.add_force_object(force_object_cls(
                tuple(int(c - r) for c in centre),
                tuple(int(c + r) for c in centre)))
            self.drag = []

        def after_step(self, runner):
            super().after_step(runner)
            runner.update_force_objects()
            self.drag.append((self.iteration,
                              self.force_objects[0].force()))

    return Sim


def shallow_water(sim_cls):
    """The 2D scene of ``sim_cls`` (its subdomain) on the shallow-water
    model ``LBFreeSurface`` (D2Q9, BGK, its equilibrium at
    ``--gravity``)."""
    from sailfish_tpu_torch.models.single import LBFreeSurface

    class Sim(LBFreeSurface):
        subdomain = sim_cls.subdomain

    return Sim


def walled(sim_cls, axes=None):
    """``sim_cls`` with full bounce-back walls on both faces normal to each
    of ``axes`` (default: every axis), after its own boundary
    conditions."""
    block = sim_cls.subdomain

    class Box(block):
        def boundary_conditions(self, *h):
            super().boundary_conditions(*h)
            walls = np.zeros(h[0].shape, dtype=bool)
            for a in (range(len(h)) if axes is None else axes):
                walls |= (h[a] == 0) | (h[a] == self.shape[-1 - a] - 1)
            self.set_node(walls, nt.NTFullBBWall)

    class Sim(sim_cls):
        subdomain = Box

    return Sim


def with_keep_block(sim_cls):
    """``sim_cls`` with a block of 4 nodes per axis of excluded (kernel
    mask code 2) nodes a third of the way into the domain, so a kernel
    comparison covers every mask code."""
    block = sim_cls.subdomain

    class Keep(block):
        def boundary_conditions(self, *h):
            super().boundary_conditions(*h)
            sel = np.ones(self.shape, dtype=bool)
            for a, hh in enumerate(h):
                n = self.shape[-1 - a]
                sel &= (hh >= n // 3) & (hh < n // 3 + 4)
            self.update_node(sel, nt._NTUnused)

    class Sim(sim_cls):
        subdomain = Keep

    return Sim


def with_patch_row_mix(sim_cls, axis):
    """``sim_cls`` with the BC nodes of its low face normal to ``axis``
    ('x', 'y' or 'z') thinned: every eighth one along x (along y
    on an x-normal face) made plain fluid and every eighth (offset by
    four) excluded, so the face has holes and holds mask codes 0, 1, 2 and
    3+ (the BC nodes next to the fluid ones detect tangential
    orientations: more, sparser varying instances)."""
    block = sim_cls.subdomain

    class Mix(block):
        def boundary_conditions(self, *h):
            super().boundary_conditions(*h)
            a = 'xyz'.index(axis)
            along = h[1] if a == 0 else h[0]
            tm = self.maps.type_map
            bc = (h[a] == 0) & (tm != nt.NTFullBBWall.id) & (tm != 0)
            self.update_node(bc & (along % 8 == 1), nt._NTFluid)
            self.update_node(bc & (along % 8 == 5), nt._NTUnused)

    class Sim(sim_cls):
        subdomain = Mix

    return Sim


def random_feq(grid, shape, seed, device):
    """fp32 equilibrium state of random density (1 +- 0.01) and velocity
    (0.02 rms) fields drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    rho = torch.tensor(1.0 + 0.01 * rng.standard_normal(shape),
                       dtype=torch.float32, device=device)
    u = torch.tensor(0.02 * rng.standard_normal((grid.dim,) + shape),
                     dtype=torch.float32, device=device)
    return teq.bgk_equilibrium(grid, rho, u).contiguous()


def random_binary_state(grid, shape, seed, device, u_rms=0.0, K=2):
    """fp32 ``K``-component equilibrium state (K, Q, *S): each density
    1 + U(0, 1e-3) as the separation scenes start, and a velocity field of
    ``u_rms`` rms common to all, drawn with numpy from ``seed`` (the first
    two components are the same for every K)."""
    rng = np.random.default_rng(seed)
    u = torch.tensor(u_rms * rng.standard_normal((grid.dim,) + shape),
                     dtype=torch.float32, device=device)
    comps = []
    for _ in range(K):
        rho = torch.tensor(1.0 + rng.random(shape) / 1000.0,
                           dtype=torch.float32, device=device)
        comps.append(teq.bgk_equilibrium(grid, rho, u))
    return torch.stack(comps).contiguous()


def random_fe_state(grid, shape, seed, device, u_rms=0.02):
    """fp32 free-energy state (2, Q, *S): the equilibria of a density
    1 + 0.01 N(0, 1), an order parameter drawn uniformly from [-1, 1] over
    blocks of 4 nodes per axis (sharp interfaces between them) and a
    velocity field of ``u_rms`` rms common to both, drawn with numpy from
    ``seed``."""
    rng = np.random.default_rng(seed)
    rho = torch.tensor(1.0 + 0.01 * rng.standard_normal(shape),
                       dtype=torch.float32, device=device)
    coarse = rng.uniform(-1.0, 1.0, tuple(-(-n // 4) for n in shape))
    for a in range(len(shape)):
        coarse = np.repeat(coarse, 4, axis=a)
    phi = torch.tensor(coarse[tuple(slice(0, n) for n in shape)],
                       dtype=torch.float32, device=device)
    u = torch.tensor(u_rms * rng.standard_normal((grid.dim,) + shape),
                     dtype=torch.float32, device=device)
    return torch.stack([teq.bgk_equilibrium(grid, rho, u),
                        teq.bgk_equilibrium(grid, phi, u)]).contiguous()


def walls_moved(ks, f0):
    """Largest change at the wall nodes of the ``ops/lbm_step.KernelStep``
    ``ks`` after one step of its plain version from ``f0``, against the
    same table with full bounce-back in place of every wall row: what the
    wall rows do."""
    from sailfish_tpu_torch.ops import lbm_step as ls
    walls = torch.zeros_like(ks.mask, dtype=torch.bool)
    table = []
    for j, row in enumerate(ks.table):
        if nt.get_node_type(row.type_id) in ls.WALL_TYPES:
            walls |= ks.mask == 3 + j
            row = row._replace(type_id=nt.NTFullBBWall.id, orientation=1)
        table.append(row)
    bb = ls.step_reference(f0, ks.mask, table, ks.grid, ks.tau_inv, ks.bcp,
                           ks.force, ks.force_model, None, ks.rates,
                           ks.smagorinsky, ks.incompressible)
    return float((ks.reference(f0) - bb)[:, walls].abs().max())


def wet_map(maps):
    """Nodes of the scene that collide (fluid and wet BC nodes)."""
    return np.isin(maps.type_map, [t for t in maps.present_types
                                   if nt.get_node_type(t).wet_node])


#: Where two correct fp32 arithmetics drift apart, the kernel is held to
#: its plain version in fp64 arithmetic (the same steps, stops and
#: quantization): the kernel's distance to it within this many times the
#: fp32 plain version's. The shallow-water mode (tau = 0.515 damps each
#: step's rounding by 6 %), int16 codes (an ulp flips a code, and the flow
#: carries it on) and the ELBM mode's Newton nodes (its entropy stop fixes
#: alpha only to 1e-6 / |dH/dalpha|) use it
FP64_FACTOR = 2.0
#: --precision=mixed, kernel against plain version (``mixed_errors``): one
#: launch from the same codes may differ by one code (the two fp32
#: arithmetics differ by ulps, and an ulp can cross a rounding boundary).
#: Over many steps each such flip is a kick of one code that the flow
#: carries on, so two correct fp32 arithmetics drift apart in codes as far
#: as the scene lets them: the fp32 and the fp64 plain versions of
#: sphere_3d (nu = 0.01) end 6 codes apart after 200 steps, those of
#: ldc_3d 2. So the steps are held by ``FP64_FACTOR``, or within
#: ``MIXED_CODE_FLOOR`` codes
MIXED_ONE_STEP = 1
MIXED_CODE_FLOOR = 2


def code_distance(q, r, wet):
    """(max |q - r|, share of codes that differ) of two int16 states over
    the wet nodes ``wet`` (a bool node map)."""
    d = (q.to(torch.int32) - r.to(torch.int32))[:, wet]
    return int(d.abs().max()), float((d != 0).float().mean())


def mixed_reference64(ks, q):
    """One step of the ``ops/lbm_step.KernelStep`` ``ks``'s plain version
    on the int16 codes ``q`` in fp64 arithmetic: dequantized, widened,
    stepped and quantized (in fp64) with the values of its last
    ``set_iteration``."""
    from sailfish_tpu_torch.ops import lbm_step as ls
    f = ks.mixed.dequant(q).double()
    return ks.mixed.quant(ls.step_reference(
        f, ks.mask, ks.table, ks.grid, ks.tau_inv, ks.bcp, ks.force,
        ks.force_model, ks.tags, ks.rates, ks.smagorinsky,
        ks.incompressible, elbm=ks.elbm))


def mixed_errors(ks, q0, steps, it0=0, one_launch=True):
    """The mixed ``KernelStep`` ``ks`` against its plain version from the
    int16 state ``q0``, from iteration ``it0``: one launch, then ``steps``
    steps of the kernel, of the fp32 plain version and of the fp64 one.
    Asserts the criteria above and returns {'one': max |dq| of the launch,
    'p32': (max, share) kernel to fp32 plain, 'k64': kernel to fp64 plain,
    'p64': fp32 plain to fp64 plain} (codes, wet nodes) and 'df', the
    largest wet |df| of the kernel to the fp32 plain version. Without
    ``one_launch`` the launch is not held to ``MIXED_ONE_STEP`` (the ELBM
    mode's Newton nodes: ``elbm_branches`` holds it instead)."""
    wet = (ks.mask == 0) | (ks.mask >= 3)
    one = torch.empty_like(q0)
    ks.step_into(q0, one, it0)
    d1 = code_distance(one, ks.reference(q0), wet)[0]
    del one
    qk = ks.run_codes(q0, steps, it0).clone()
    q32 = q64 = q0
    for i in range(steps):
        ks.set_iteration(it0 + i)
        q32 = ks.reference(q32)
        q64 = mixed_reference64(ks, q64)
    out = dict(one=d1, p32=code_distance(qk, q32, wet),
               k64=code_distance(qk, q64, wet),
               p64=code_distance(q32, q64, wet),
               df=float((ks.mixed.dequant(qk) - ks.mixed.dequant(q32))[
                   :, wet].abs().max()))
    assert d1 <= MIXED_ONE_STEP or not one_launch, out
    assert out['k64'][0] <= max(MIXED_CODE_FLOOR,
                                FP64_FACTOR * out['p64'][0]), out
    return out


def all_codes(grid, shape, device):
    """int16 state (Q, *S) of ``shape`` (65,536 nodes) in which every
    direction holds each of the 65,536 codes once, direction i's rolled by
    997 i."""
    n = int(np.prod(shape))
    assert n == 65536, shape
    codes = torch.arange(-32768, 32768, dtype=torch.int32)
    return torch.stack([torch.roll(codes, 997 * i).reshape(shape)
                        for i in range(grid.Q)]).to(
                            torch.int16).to(device).contiguous()


def periodic_box(dim):
    """A fluid box with no boundary node (run it with every
    ``periodic_<axis>`` flag): rho = 1 at rest."""

    class Box(Subdomain3D if dim == 3 else Subdomain2D):
        def boundary_conditions(self, *h):
            pass

        def initial_conditions(self, sim, *h):
            sim.rho[:] = 1.0

    class Sim(LBFluidSim):
        subdomain = Box

    return Sim


def shear_wave_viscosity(ks, builder, n, visc, u0=0.01, steps=400):
    """The viscosity a shear wave u_y = u0 sin(2 pi x / n) measures on the
    D3Q19 engine ``ks`` (a ``KernelStep``, or anything with ``run(f,
    steps)``) of the periodic n x 8 x 8 box of ``builder``: from the decay
    of the first Fourier mode of u_y along x between ``steps`` and 2
    ``steps`` (tests/test_mixed.py:141-176)."""
    grid = builder.grid
    dev = builder.device
    k = 2 * np.pi / n
    uy = torch.tensor(np.tile(u0 * np.sin(k * np.arange(n)), (8, 8, 1)),
                      dtype=torch.float32, device=dev)
    u = torch.stack([torch.zeros_like(uy), uy, torch.zeros_like(uy)])
    f = teq.bgk_equilibrium(grid, torch.ones_like(uy), u)

    def amp(f):
        _, uo = teq.macroscopic(grid, builder.streamed(f))
        return float(np.abs(np.fft.rfft(uo[1][4, 4].cpu().numpy())[1])) / n

    f = ks.run(f, steps).clone()
    a1 = amp(f)
    f = ks.run(f, steps).clone()
    a2 = amp(f)
    return -np.log(a2 / a1) / (k * k * steps)


def smooth_feq(grid, shape, seed, device, amp=1e-3):
    """fp32 equilibrium state of smooth density 1 + amp r and velocity amp
    v fields, r and each v_a a sum of three periodic sines of the domain's
    longest waves with phases drawn with numpy from ``seed``: a resolved
    flow, whose nodes take the tiny or the series branch of the entropic
    alpha."""
    rng = np.random.default_rng(seed)
    axes = np.meshgrid(*[np.arange(n) for n in shape], indexing='ij')

    def field():
        out = np.zeros(shape)
        for _ in range(3):
            a = rng.integers(len(shape))
            out += np.sin(2 * np.pi * (axes[a] / shape[a]
                                       + rng.random()))
        return out / 3.0

    rho = torch.tensor(1.0 + amp * field(), dtype=torch.float32,
                       device=device)
    u = torch.tensor(np.stack([amp * field() for _ in range(grid.dim)]),
                     dtype=torch.float32, device=device)
    return teq.bgk_equilibrium(grid, rho, u).contiguous()


def newton_state(grid, shape, seed, device):
    """fp32 state pushed into the Newton branch of the entropic alpha
    (tests/test_models.py:173-181): the product-form equilibrium of rho =
    1 + U(0, 0.05), u = 0.08 U(-1/2, 1/2), less 0.2 U(-1/2, 1/2) of it per
    direction, drawn with numpy from ``seed``; dev > 0.01 at most nodes
    once streamed."""
    from sailfish_tpu_torch.ops import entropic
    rng = np.random.default_rng(seed)
    rho = torch.tensor(1.0 + 0.05 * rng.random(shape), dtype=torch.float32,
                       device=device)
    u = torch.tensor(0.08 * (rng.random((grid.dim,) + shape) - 0.5),
                     dtype=torch.float32, device=device)
    feq = entropic.elbm_equilibrium(grid, rho, u)
    push = torch.tensor(0.2 * (rng.random((grid.Q,) + shape) - 0.5),
                        dtype=torch.float32, device=device)
    return (feq - push * feq).contiguous()


def fp64_distances(ks, f0, fk, fr, steps, it0=0):
    """``steps`` steps of the ``KernelStep`` ``ks``'s plain version in fp64
    arithmetic from the fp32 state ``f0`` (from iteration ``it0``), against
    the kernel's ``fk`` and the fp32 plain version's ``fr`` after the same
    steps. Returns {'k64' / 'p64': wet max |df| of the kernel / of the fp32
    plain version to it, 'k64_mean' / 'p64_mean': the wet means}."""
    f64 = f0.double()
    for it in range(steps):
        ks.set_iteration(it0 + it)
        f64 = ks.reference(f64)
    wet = (ks.mask == 0) | (ks.mask >= 3)
    dk = (fk.double() - f64)[:, wet].abs()
    dp = (fr.double() - f64)[:, wet].abs()
    return dict(k64=float(dk.max()), p64=float(dp.max()),
                k64_mean=float(dk.mean()), p64_mean=float(dp.mean()))


#: the ELBM kernel over many steps in which nodes take the Newton branch
#: (walls or a lid under a flow of amplitude 1e-2): the entropy stop fixes
#: alpha there only to 1e-6 / |dH/dalpha| (1e-3 to 3e-2), so the kernel and
#: the fp32 plain version each scatter about the fp64 plain version, and
#: the largest of ~1e7 such deviations is an extreme of that scatter (its
#: ratio ran 1.0 to 1.74 over the steps of the forced sphere on the H100,
#: 2.9 once). Such runs hold the wet mean distance to the fp64 plain
#: version within this many times the fp32 plain version's (1.00-1.10
#: there); the per-node arithmetic is held by single launches
ELBM_MEAN_FACTOR = 1.25


def elbm_errors(ks, f0, steps, tol, it0=0, newton=False):
    """The ELBM ``KernelStep`` ``ks`` against its plain version from the
    fp32 state ``f0``: ``steps`` steps of the kernel, of the fp32 and of
    the fp64 plain version (the same Newton stops). Returns {'err': wet
    max |df| kernel to fp32 plain} and the ``fp64_distances``, after
    asserting err <= ``tol`` or k64 <= ``FP64_FACTOR`` p64; with
    ``newton`` (a run with Newton nodes) err <= ``tol`` or k64_mean <=
    ``ELBM_MEAN_FACTOR`` p64_mean instead."""
    wet = (ks.mask == 0) | (ks.mask >= 3)
    fk = ks.run(f0, steps, it0).clone()
    f32 = f0
    for i in range(steps):
        ks.set_iteration(it0 + i)
        f32 = ks.reference(f32)
    out = dict(err=float((fk - f32)[:, wet].abs().max()),
               **fp64_distances(ks, f0, fk, f32, steps, it0))
    held = out['k64_mean'] <= ELBM_MEAN_FACTOR * out['p64_mean'] \
        if newton else out['k64'] <= FP64_FACTOR * out['p64']
    assert np.isfinite(out['err']) and (out['err'] <= tol or held), out
    return out


#: how close to the series / Newton threshold of dev (0.01) the plain
#: version's dev may lie at a node that takes the other branch in the kernel:
#: fneq = feq - f cancels to about dev f, so the few ulps of feq by which two
#: fp32 versions' product-form equilibria differ are up to ~3e-5 of dev
#: there (relative)
ELBM_DEV_BAND = 1e-4


def elbm_branches(ks, f0, it=0, tol=None):
    """One launch of the ELBM ``KernelStep`` ``ks`` and one step of its
    plain version from ``f0``, each with the alpha solve's diagnostics
    (``KernelStep.diagnostics_into``). Returns {'err': wet max |df|,
    'kernel' / 'plain': node counts of the branches [tiny, series,
    Newton], 'same': whether every colliding node took the same branch in
    both, 'flips': at how many it did not (a node whose dev lies within
    rounding of 1e-6 may take the tiny branch in one and the series in the
    other: alpha is 2 on either side within ~dev), 'newton_same': whether
    the same nodes took the Newton branch in both, 'newton_flips': at how
    many colliding nodes they did not, 'newton_at_threshold': whether at
    each of those the plain version's dev lies within ``ELBM_DEV_BAND``
    (relative) of the Newton threshold 0.01, where two fp32 versions may
    each be right (True with no such node), 'iters': the kernel's
    most Newton steps at a node (0 without a
    Newton node), 'alpha': the largest |d alpha|, 'k64' / 'p64': wet max
    |df| of the kernel / of the fp32 plain version to the fp64 plain
    version (the same stops), computed only where 'err' passes ``tol``
    (else None)}."""
    wet = (ks.mask == 0) | (ks.mask >= 3)
    dk = torch.full((2,) + ks.shape, -1.0, device=f0.device)
    one = torch.empty_like(f0)
    ks.diagnostics_into(f0, one, dk, it)
    if one.dtype == torch.int16:
        one = ks.mixed.dequant(one)
    ref = torch.empty_like(f0)
    dp = torch.full((2,) + ks.shape, -1.0, device=f0.device)
    ks.diagnostics_into(f0, ref, dp, it, plain=True)
    coll = dp[1] >= 0
    kb = dk[1].clamp(max=2)
    moved = coll & ((kb == 2) != (dp[1] == 2))
    near = (ks.elbm.last_dev / 0.01 - 1.0).abs() <= ELBM_DEV_BAND

    def counts(b):
        return [int((b[coll] == v).sum()) for v in (0, 1, 2)]

    newton = dk[1][coll & (dk[1] >= 2)]
    mixed = ref.dtype == torch.int16
    if mixed:
        ref = ks.mixed.dequant(ref)
    err = float((one - ref)[:, wet].abs().max())
    k64 = p64 = None
    if tol is not None and not err <= tol:
        f64 = ks.mixed.dequant(mixed_reference64(ks, f0)).double() \
            if mixed else ks.reference(f0.double())
        k64 = float((one.double() - f64)[:, wet].abs().max())
        p64 = float((ref.double() - f64)[:, wet].abs().max())
        del f64
    return dict(err=err, k64=k64, p64=p64,
                kernel=counts(kb), plain=counts(dp[1]),
                same=bool(torch.equal(kb[coll], dp[1][coll])),
                flips=int((kb[coll] != dp[1][coll]).sum()),
                newton_same=bool(torch.equal(kb[coll] == 2,
                                             dp[1][coll] == 2)),
                newton_flips=int(moved.sum()),
                newton_at_threshold=bool(near[moved].all()),
                iters=int(newton.max()) - 2 if newton.numel() else 0,
                alpha=float((dk[0] - dp[0])[coll].abs().max()))


#: the 3D IBM ring of ``ibm_ring_3d``: markers, radius, the ring's tilt
#: about x (rad), the spring stiffness and the driving acceleration
IBM_RING = dict(n=24, radius=4.0, tilt=0.5, stiffness=0.03,
                accel=(1e-4, 0.0, 0.0))


def ibm_ring_3d(subdomain_cls=None, model_cls=None, particle_cls=None,
                ring=IBM_RING):
    """A ring of IBM markers (a 3D flexible body, 1.05 nodes apart, so
    neighbours share corner nodes) tilted out of the x-y plane, in a
    periodic box driven along x: default 16^3, nu = 0.05. Pass the JAX
    package's ``Subdomain3D``, ``LBIBMFluidSim`` and ``Particle`` to build
    its twin."""
    sub = subdomain_cls or Subdomain3D
    model = model_cls or LBIBMFluidSim
    part = particle_cls or Particle

    class Box(sub):
        def boundary_conditions(self, hx, hy, hz):
            pass

        def initial_conditions(self, sim, hx, hy, hz):
            sim.rho[:] = 1.0

    class RingSim(model):
        subdomain = Box

        @classmethod
        def update_defaults(cls, defaults):
            defaults.update(lat_nx=16, lat_ny=16, lat_nz=16, visc=0.05,
                            periodic_x=True, periodic_y=True,
                            periodic_z=True)

        def __init__(self, config):
            super().__init__(config)
            self.add_body_force(ring['accel'])
            c = (config.lat_nx / 2.0 + 0.25, config.lat_ny / 2.0 + 0.125,
                 config.lat_nz / 2.0 - 0.375)
            r, t = ring['radius'], ring['tilt']
            for k in range(ring['n']):
                phi = 2.0 * np.pi * k / ring['n']
                pos = (c[0] + r * np.cos(phi),
                       c[1] + r * np.sin(phi) * np.cos(t),
                       c[2] + r * np.sin(phi) * np.sin(t))
                self.add_particle(part(pos, stiffness=ring['stiffness']))

    return RingSim


def with_tracers(sim_cls, positions, every, tracer_cls=None):
    """``sim_cls`` carrying ``TracerParticles`` at ``positions`` (dim, N)
    as ``sim.tp``, registered for checkpoints as 'tracers' and advanced
    after every ``every``-th step (``after_step_interval``); pass the JAX
    package's ``TracerParticles`` to build its twin."""
    tracer_cls = tracer_cls or TracerParticles

    class Sim(sim_cls):
        after_step_interval = every

        def before_main_loop(self, runner):
            super().before_main_loop(runner)
            if not hasattr(self, 'tp'):
                self.tp = tracer_cls(positions, self.rho.shape)
                self.register_checkpoint_object('tracers', self.tp)

        def after_step(self, runner):
            super().after_step(runner)
            if self.iteration % every == 0:
                self.tp.update(runner)

    return Sim


#: how long a slice-server client waits for a message, ms
SLICE_TIMEOUT_MS = 5000


def with_slice_subscriber(sim_cls, timeout_ms=SLICE_TIMEOUT_MS):
    """``sim_cls`` serving slices (``Vis2DSliceMixIn``) with a subscriber
    on 127.0.0.1: at the first ``after_step``, before the server's first
    slice, ``sim.subscriber`` (``connect_slice_client`` with
    ``timeout_ms``) connects and the subscription is awaited at the
    server, so it receives every slice. Close ``sim.subscriber`` and call
    ``sim.close_slice_server()`` after the run."""

    class Sim(sim_cls, Vis2DSliceMixIn):
        subscriber = None

        def after_step(self, runner):
            super().after_step(runner)
            if self.subscriber is not None:
                return
            import zmq
            self.subscriber = connect_slice_client(
                self._port, timeout_ms=timeout_ms)
            # the subscription arrives at the XPUB socket as a message
            if not self._sock.poll(timeout_ms, zmq.POLLIN):
                raise TimeoutError('the subscription did not reach the '
                                   f'slice server within {timeout_ms} ms')
            if self._sock.recv() != b'\x01':
                raise RuntimeError('the slice server got no subscription')

    return Sim
