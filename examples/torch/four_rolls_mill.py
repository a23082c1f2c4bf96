#!/usr/bin/env python
"""Four rolls mill on the PyTorch/CUDA port (twin of
examples/four_rolls_mill.py): the Taylor-Green vortex held steady by a body
force that varies from node to node (a precomputed per-node field). Such a
force runs on the torch engine; the kernel engine refuses it by name, so on
a CUDA device pass --engine=torch.

Run from the repository root:
    PYTHONPATH=. python examples/torch/four_rolls_mill.py --engine=torch \
        --max_iters=1000
"""

import importlib.util
import os

import numpy as np

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.models.base import LBForcedSim


def _beside(name):
    """The module ``name`` beside this script, loaded by path: a module of
    that name may be imported already from ``examples/`` (the original)."""
    spec = importlib.util.spec_from_file_location(
        f'torch_{name}',
        os.path.join(os.path.dirname(os.path.realpath(__file__)),
                     f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_tg = _beside('taylor_green_2d')
TaylorGreenSim, TaylorGreenSubdomain = (_tg.TaylorGreenSim,
                                        _tg.TaylorGreenSubdomain)


class FourRollsMill(TaylorGreenSim, LBForcedSim):
    def __init__(self, config):
        super().__init__(config)
        ny, nx = config.lat_ny, config.lat_nx
        kx = 2.0 * np.pi / nx
        ky = 2.0 * np.pi / ny
        ksq = kx * kx + ky * ky
        # steady state: the force exactly cancels the viscous decay of
        # the initial Taylor-Green field (d u / dt = -nu k^2 u)
        f = ksq * config.visc * TaylorGreenSubdomain.max_v
        hy, hx = np.mgrid[0:ny, 0:nx]
        accel = np.stack([
            -f * np.cos(kx * hx) * np.sin(ky * hy),
            +f * np.sin(kx * hx) * np.cos(ky * hy)])
        self.add_body_force(accel)


if __name__ == '__main__':
    LBSimulationController(FourRollsMill).run()
