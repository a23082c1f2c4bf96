#!/usr/bin/env python
"""Turbulent channel flow around a wall-mounted cube on the PyTorch/CUDA
port (twin of examples/turbulence/channel_cube.py: D3Q19 BGK, fp32, Guo
forcing).

Two coupled regions, following the reference scene
(examples/turbulence/channel_cube.py):

  * a RECIRCULATION BUFFER: a streamwise-periodic turbulent channel
    that develops inflow turbulence independently of the main region;
  * the MAIN region: channel walls + a cube obstacle on one wall + a
    pressure outlet, fed by the buffer.

Each region is its own distribution tensor of one step: the buffer is
periodic in z by construction, and the main region's z=0 ghost plane is
overwritten with the buffer's exit-plane post-collision distributions
every iteration, a one-way transfer as a tensor assignment. The composite
step is no StepBuilder, so the kernel engine refuses it by name: the scene
runs with --engine=torch on a CUDA device. Sharding (--mesh) is not
ported, and the composite step refuses it by name.

Geometry (lattice axes): wall-normal = x, spanwise = y (periodic),
streamwise = z.

Run from the repository root:
    PYTHONPATH=. python examples/torch/turbulence/channel_cube.py \
        --engine=torch --max_iters=1000
"""

import importlib.util
import os

import numpy as np

import torch

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.geo import LBGeometry3D
from sailfish_tpu_torch.models.base import LBForcedSim
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.node_type import NTEquilibriumDensity, \
    NTFullBBWall, _NTGhost
from sailfish_tpu_torch.stats import ReynoldsStatsMixIn
from sailfish_tpu_torch.subdomain import Subdomain3D


def _sibling(name):
    """examples/torch/turbulence/<name>.py, loaded by path (a module of
    the same name may be the JAX example's)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f'{name}.py')
    spec = importlib.util.spec_from_file_location(f'torch_{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_channel = _sibling('channel_flow')
divergence_free_noise = _channel.divergence_free_noise
friction_velocity = _channel.friction_velocity
loglaw_profile = _channel.loglaw_profile


def cube_size(config):
    """Cube edge: 2/3 of the channel half-height."""
    return 2 * config.H // 3


def buffer_length(config):
    return int(config.buf_az * cube_size(config))


class CubeChannelDomain(Subdomain3D):
    """The MAIN region: ghost inflow plane, walls, cube, outlet."""

    u_center = 0.025

    def boundary_conditions(self, hx, hy, hz):
        walls = (hx == 0) | (hx == self.gx - 1)
        self.set_node(walls, NTFullBBWall)
        # inflow ghost plane, fed from the buffer every step
        self.set_node((hz == 0) & ~walls, _NTGhost)

        h = cube_size(self.config)
        cube = ((hx > 0) & (hx <= h) &
                (hz >= 3 * h) & (hz < 4 * h) &
                (hy >= 2.7 * h) & (hy < 3.7 * h))
        self.update_node(cube, NTFullBBWall)

        outlet = (hz == self.gz - 1) & ~walls
        self.set_node(outlet, NTEquilibriumDensity(
            1.0, orientation=(0, 0, -1)))

    def initial_conditions(self, sim, hx, hy, hz):
        sim.rho[:] = 1.0
        sim.vz[:] = _mean_profile(self.config, hx)


def _mean_profile(config, hx):
    u_tau = friction_velocity(CubeChannelDomain.u_center, config.Re_tau)
    y_wall = np.minimum(hx, config.lat_nx - 1 - hx) + 0.5
    return loglaw_profile(np.maximum(y_wall, 1e-3) * u_tau
                          / config.visc) * u_tau


class _CoupledStep:
    """Composite step: buffer advances on its own (periodic) lattice,
    then its exit plane becomes the main region's inflow ghost plane."""

    def __init__(self, buf_builder, main_builder):
        self.buf = buf_builder
        self.main = main_builder
        self.maps = main_builder.maps
        self.dtype = main_builder.dtype
        self.device = main_builder.device

    def shard_constants(self, mesh):
        """Sharding the two regions (the JAX scene's parallel.mesh
        branch) is not ported."""
        raise NotImplementedError(
            'channel_cube on a mesh: sharding (parallel.mesh) is not '
            'ported to sailfish_tpu_torch yet')

    def build(self):
        buf_step = self.buf.build()
        main_step = self.main.build()

        def step(state, it=0):
            fb, fm = state
            fb2 = buf_step(fb, it)
            # one-way transfer: post-collision exit plane -> ghost plane,
            # into a copy (the state handed in stays as it was)
            fm = fm.clone()
            fm[:, 0] = fb2[:, -1]
            return (fb2, main_step(fm, it))

        return step

    def macro_fields(self, state, it=0):
        return self.main.macro_fields(state[1], it)


class CubeChannelSim(LBFluidSim, LBForcedSim, ReynoldsStatsMixIn):
    subdomain = CubeChannelDomain

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--H', type=int, default=30,
                           help='channel half-height')
        group.add_argument('--Re_tau', type=float, default=180.0)
        group.add_argument('--buf_az', type=float, default=9.0,
                           help='buffer length in cube edges')
        group.add_argument('--main_az', type=float, default=14.0,
                           help='main-region length in cube edges')
        group.add_argument('--ay', type=float, default=6.4,
                           help='spanwise width in cube edges')
        group.add_argument('--stats_every', type=int, default=10)

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'grid': 'D3Q19',
            'seed': 1341351351,
            'periodic_y': True,
            'max_iters': 1000000,
            'every': 100000,
        })

    @classmethod
    def modify_config(cls, config):
        h = cube_size(config)
        config.lat_nx = 2 * config.H + 2
        config.lat_ny = int(config.ay * h)
        # main region only; the buffer is a separate array
        config.lat_nz = int(config.main_az * h) + 1  # +1 ghost plane
        u_tau = friction_velocity(CubeChannelDomain.u_center,
                                  config.Re_tau)
        config.visc = u_tau * config.H / config.Re_tau

    def __init__(self, config):
        super().__init__(config)
        u_tau = friction_velocity(CubeChannelDomain.u_center,
                                  config.Re_tau)
        self.add_body_force((0.0, 0.0, u_tau * u_tau / config.H))

    # -- composite state ------------------------------------------------------

    def _buffer_shape(self):
        cfg = self.config
        return (buffer_length(cfg), cfg.lat_ny, cfg.lat_nx)

    def make_step_builder(self, maps, dtype, device):
        main = super().make_step_builder(maps, dtype, device)

        # the buffer is a plain walled channel, periodic in y and z
        class BufferDomain(Subdomain3D):
            def boundary_conditions(dom, hx, hy, hz):
                dom.set_node((hx == 0) | (hx == dom.gx - 1),
                             NTFullBBWall)

        import copy
        buf_cfg = copy.copy(self.config)
        buf_cfg.periodic_z = True
        from sailfish_tpu_torch.subdomain import SubdomainSpec3D
        shape = self._buffer_shape()
        spec = SubdomainSpec3D((0, 0, 0), tuple(reversed(shape)))
        dom = BufferDomain(shape, spec, self.grid, buf_cfg)
        dom.reset()
        buf = super().make_step_builder(dom.maps, dtype, device)
        return _CoupledStep(buf, main)

    def make_initial_state(self, builder, dtype):
        cfg = self.config
        f_main = super().make_initial_state(builder.main, dtype)

        # buffer: log-law profile + divergence-free perturbation
        bz, by, bx = self._buffer_shape()
        hz, hy, hx = np.mgrid[0:bz, 0:by, 0:bx]
        u_mean = _mean_profile(cfg, hx)
        wx, wy, wz = divergence_free_noise(
            (bz, by, bx), smooth=max(2.0, cfg.H / 8.0),
            seed=cfg.seed or 1)
        norm = max(np.abs(wx).max(), np.abs(wy).max(),
                   np.abs(wz).max())
        amp = 0.05 * u_mean / CubeChannelDomain.u_center
        dev = builder.buf.device
        rho = torch.ones((bz, by, bx), dtype=dtype, device=dev)
        u = torch.as_tensor(np.stack([
            wx / norm * amp,
            wy / norm * amp,
            u_mean + wz / norm * amp]), dtype=dtype, device=dev)
        f_buf = builder.buf.feq(rho, u)
        return (f_buf, f_main)

    def before_main_loop(self, runner):
        self.prepare_reynolds_stats(
            runner, axis='x', every=self.config.stats_every,
            from_iter=self.config.max_iters // 4)


if __name__ == '__main__':
    LBSimulationController(CubeChannelSim, LBGeometry3D).run()
