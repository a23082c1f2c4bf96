#!/usr/bin/env python
"""Lid-driven cavity convergence monitor on the PyTorch/CUDA port (twin of
examples/ldc_2d_unorm.py: D2Q9 MRT, fp32): ||u_n - u_{n-1}|| over time.

Runs the MRT cavity and records the change of the velocity-magnitude
field between samples, a steady-state convergence diagnostic, sampled
through a device hook every ``--unorm_every`` iterations.

Run from the repository root:
    PYTHONPATH=. python examples/torch/ldc_2d_unorm.py --max_iters=1000
"""

import importlib.util
import os

import numpy as np
import torch

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.geo import LBGeometry2D


def _sibling(name):
    """examples/torch/<name>.py, loaded by path (a module of the same name
    may be the JAX example's)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f'{name}.py')
    spec = importlib.util.spec_from_file_location(f'torch_{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LDCSim = _sibling('ldc_2d').LDCSim


class LDCSimUnorm(LDCSim):
    @classmethod
    def update_defaults(cls, defaults):
        super().update_defaults(defaults)
        defaults.update({
            'lat_nx': 128,
            'lat_ny': 128,
            'max_iters': 30000,
            'every': 250,
            'visc': 0.16011,
            'model': 'mrt',
        })

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--unorm_every', type=int, default=523,
                           help='velocity-norm sampling stride')

    def before_main_loop(self, runner):
        cfg = self.config
        every = cfg.unorm_every
        nslots = cfg.max_iters // every + 2
        shape = (cfg.lat_ny, cfg.lat_nx)
        builder = runner.builder

        def umag(f):
            _, u = builder.macro_fields(f)
            return torch.sqrt(torch.sum(u * u, dim=0))

        init = (torch.zeros(shape, dtype=torch.float32),
                torch.zeros((nslots, 3), dtype=torch.float32))

        def hook(f, state, it):
            if it % every:
                return state
            u_prev, series = state
            u = umag(f)
            n = float(np.prod(shape))
            if it // every < nslots:   # a sample past the last slot drops
                series[it // every, 0] = float(it)
                series[it // every, 1] = torch.sqrt(
                    torch.sum((u - u_prev) ** 2)) / n
                series[it // every, 2] = torch.sqrt(torch.sum(u * u)) / n
            return u.to(u_prev.dtype), series

        self._unorm_hook = self.add_device_hook(init, hook, every=every)
        self._unorm_runner = runner

    def unorm_series(self):
        _, series = self._unorm_runner.device_hook_state[self._unorm_hook]
        series = series.cpu().numpy()
        return series[series[:, 0] > 0][1:]  # drop the bootstrap sample

    def after_step(self, runner):
        if self.iteration >= self.config.max_iters and self.config.output:
            s = self.unorm_series()
            np.savez(f'{self.config.output}_unorm.npz',
                     it=s[:, 0], du_norm=s[:, 1], u_norm=s[:, 2])


if __name__ == '__main__':
    LBSimulationController(LDCSimUnorm, LBGeometry2D).run()
