#!/usr/bin/env python
"""Entropic-LBM 2D lid-driven cavity with alpha-field output on the
PyTorch/CUDA port (twin of examples/ldc_2d_entropic.py: D2Q9 ELBM, fp32,
lid 0.01, nu = 1e-4, 256^2).

Run from the repository root:
    PYTHONPATH=. python examples/torch/ldc_2d_entropic.py --max_iters=1000
"""

import importlib.util
import os

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.models.single import LBEntropicFluidSim


def _sibling(name):
    """examples/torch/<name>.py, loaded by path (a module of the same name
    may be the JAX example's)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f'{name}.py')
    spec = importlib.util.spec_from_file_location(f'torch_{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_ldc = _sibling('ldc_2d')


class EntropicLDCBlock(_ldc.LDCBlock):
    # a slower lid (the entropic run reaches its high Reynolds number
    # through the viscosity); a subclass, so the cavity twin keeps its own
    max_v = 0.01


class EntropicLDCSim(LBEntropicFluidSim):
    subdomain = EntropicLDCBlock

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'lat_nx': 256,
            'lat_ny': 256,
            'visc': 1e-4})


if __name__ == '__main__':
    LBSimulationController(EntropicLDCSim).run()
