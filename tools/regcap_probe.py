#!/usr/bin/env python3
"""Register-cap probe of the stream-and-collide kernel on one CUDA GPU.

    python3 tools/regcap_probe.py [--steps 2000] [--iters 50]
                                  [--scenes ldc_3d,ldc_2d,...]

Builds variants of ``sailfish_tpu_torch/ops/csrc/lbm_step.cu`` that differ
from it only in the kernel's ``__launch_bounds__``: a minimum number of
resident 128-thread blocks per SM, which caps the registers per thread
(65536 / (128 * blocks), at most 255). The shipped kernel is not changed.

* ``base``: the source as it is, ``__launch_bounds__(LBM_BLOCK, DIM == 3 ?
  4 : MODEL == MODEL_ELBM ? 8 : 1)``: at least four blocks (at most 128
  registers) on D3Q19, no cap on D2Q9 but for ELBM (ptxas takes 72 and 48
  registers);
* ``nocap``: ``(LBM_BLOCK)`` on both instantiations;
* ``min8_3d``: 8 blocks (64 registers) on D3Q19;
* ``min4`` / ``min12_2d``: D3Q19 as shipped, 4 / 12 blocks (128 / 40
  registers) on D2Q9.

Each variant is bound to the main path's ``KernelStep`` for the lid-driven
cavities at 256^3 D3Q19 and 4096^2 D2Q9 (``examples/torch``) and for the
parabolic-inlet channels of the same sizes (``tests/torch_scenes``; BC
nodes with per-node parameters), with the inlet normal to z / y and normal
to x (one BC node at each end of every x-row). The base
kernel first runs the scene for ``--steps`` steps from its initial state;
from there each variant runs 10 steps and reports the max |difference|
from the base kernel's result, then times ``--iters`` launches with CUDA
events, in the order base, variants, variants reversed, base. Prints the
registers and spills that ptxas reports per kernel, one line per timing
and a JSON line.
"""

import argparse
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tests'))
from sailfish_tpu_torch import util  # noqa: E402
from sailfish_tpu_torch.ops import build  # noqa: E402
from sailfish_tpu_torch.ops import lbm_step as ls  # noqa: E402
from torch_scenes import channel_sim, channel_sim_2d, run, twin  # noqa: E402

BOUNDS = ('__launch_bounds__(LBM_BLOCK,\n'
          '                                  DIM == 3 ? 4 : MODEL == '
          'MODEL_ELBM ? 8 : 1)')
VARIANTS = {
    'base': BOUNDS,
    'nocap': '__launch_bounds__(LBM_BLOCK)',
    'min8_3d': '__launch_bounds__(LBM_BLOCK, DIM == 3 ? 8 : 1)',
    'min4': '__launch_bounds__(LBM_BLOCK, 4)',
    'min12_2d': '__launch_bounds__(LBM_BLOCK, DIM == 3 ? 4 : 12)',
}
#: scene -> (sim class loader, size, extra flags)
SCENES = {
    'ldc_3d': (lambda: twin('ldc_3d'), (256, 256, 256), {}),
    'ldc_2d': (lambda: twin('ldc_2d'), (4096, 4096), {}),
    'parabolic_inlet_3d': (
        lambda: channel_sim('regularized', profile='parabolic'),
        (256, 256, 256), {'periodic_x': True}),
    'parabolic_inlet_2d': (lambda: channel_sim_2d('regularized'),
                           (4096, 4096), {}),
    'parabolic_inlet_x_3d': (
        lambda: channel_sim('regularized', 'x', profile='parabolic'),
        (256, 256, 256), {'periodic_z': True}),
    'parabolic_inlet_x_2d': (lambda: channel_sim_2d('regularized', axis='x'),
                             (4096, 4096), {}),
}


def build_variants(out_dir):
    """{variant: KernelLibrary}; the sources are written to ``out_dir``."""
    src = (build.CSRC / 'lbm_step.cu').read_text()
    if src.count(BOUNDS) != 1:
        raise RuntimeError(f'expected one {BOUNDS!r} in lbm_step.cu')
    os.makedirs(out_dir, exist_ok=True)
    libs = {}
    for name, bounds in VARIANTS.items():
        path = os.path.join(out_dir, f'lbm_step_{name}.cu')
        with open(path, 'w') as fh:
            fh.write(src.replace(BOUNDS, bounds))
        libs[name] = build.build_library(path)
    return libs


def probe_scene(scene, libs, steps, iters):
    load, size, extra = SCENES[scene]
    cfg = dict(zip(('lat_nx', 'lat_ny', 'lat_nz'), size), **extra)
    r = run(load(), max_iters=0, **cfg)
    ks = r.kernel
    fns = {name: ls.kernel_function(lib.lib, ks.entry)
           for name, lib in libs.items()}
    ks._fn = fns['base']
    f0 = ks.run(r.f, steps).clone()
    outs = {}
    for name, fn in fns.items():
        ks._fn = fn
        outs[name] = ks.run(f0, 10).clone()
    diffs = {name: float((out - outs['base']).abs().max())
             for name, out in outs.items()}
    del outs
    order = list(VARIANTS) + list(reversed(VARIANTS))
    times = {name: [] for name in VARIANTS}
    nodes = f0[0].numel()
    for name in order:
        ks._fn = fns[name]
        ms = util.cuda_time_ms(lambda: ks.step_into(ks.a, ks.b), iters,
                               warmup=5)
        times[name].append(ms)
        print(f'{scene} {ks.name} {name} after {steps} steps: {ms:.4f} ms '
              f'per launch ({nodes / ms / 1e3:.1f} MLUPS)', flush=True)
    del r, ks, f0
    torch.cuda.empty_cache()
    return dict(scene=scene, size=list(size), steps=steps,
                max_abs_diff=diffs, ms=times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--steps', type=int, default=2000)
    ap.add_argument('--iters', type=int, default=50)
    ap.add_argument('--scenes', default=','.join(SCENES),
                    help='comma-separated, of ' + ', '.join(SCENES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('regcap_probe: torch sees no CUDA device')
    libs = build_variants(os.path.join(REPO, 'build', 'probe'))
    usage = {}
    for name, lib in libs.items():
        usage[name] = {fn: u for fn, u in build.ptxas_usage(lib.log).items()
                       if 'lbm_step_kernel' in fn or 'bc_' in fn}
        for fn, u in sorted(usage[name].items()):
            print(f'ptxas {name}: {fn}: {u}', flush=True)
    results = [probe_scene(scene, libs, args.steps, args.iters)
               for scene in args.scenes.split(',')]
    print(json.dumps({'device': torch.cuda.get_device_name(0),
                      'ptxas': usage, 'regcap_probe': results}))


if __name__ == '__main__':
    main()
