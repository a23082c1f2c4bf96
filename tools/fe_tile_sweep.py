#!/usr/bin/env python3
"""Tile and register-cap sweep of the 3D free-energy kernel on one CUDA GPU.

    python3 tools/fe_tile_sweep.py [--size 256] [--iters 50]
        [--tiles 32x8x16 64x4x16 ...] [--min-blocks 2 3]
        [--baseline PATH]

Sets up ``fe_separation_3d`` (``examples/torch/binary_fluid``) at size^3 on
the kernel engine, BGK and FE-MRT (tau_a 3, tau_b 0.8), runs 20 steps from
its initial state, fills the order parameter with the pre-pass and then
times ``fe_step_d3q19`` alone (CUDA events over ``--iters`` launches, after
5 warm-up launches) on that state:

* for every tile tx x ty x kz of ``--tiles`` (``FEStep.set_tile``), whose
  result must equal the default tile's bit for bit;
* for every minimum of resident blocks of ``--min-blocks`` on the BGK
  instantiation: a variant of ``csrc/fe_step.cu`` that differs only in
  ``__launch_bounds__(FE3_THREADS, MRT ? 1 : <n>)`` (written under
  ``build/sweep``), with its ptxas registers and spills;
* with ``--baseline PATH``, another ``fe_step.cu`` (for example the
  parent commit's, exported by ``git show``) built the same way and timed
  in turns with the shipped kernel (baseline, kernel, kernel, baseline),
  with the largest difference of their outputs after one launch.

Prints one line per timing and a JSON line. The shipped kernel is not
changed.
"""

import argparse
import ctypes
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tests'))
from sailfish_tpu_torch import util  # noqa: E402
from sailfish_tpu_torch.ops import build  # noqa: E402
from sailfish_tpu_torch.ops import fe_step as fe  # noqa: E402
from torch_scenes import binary_twin, run  # noqa: E402

BOUNDS = '__launch_bounds__(FE3_THREADS, MRT ? 1 : 2)'
MODELS = {'bgk': {}, 'mrt': dict(model='mrt', tau_a=3.0, tau_b=0.8)}


def parse_tile(text):
    tx, ty, kz = (int(v) for v in text.split('x'))
    return tx, ty, kz


def engine(model, size):
    """(FEStep, source buffer, phi, destination buffer) after 20 steps of
    ``fe_separation_3d`` at size^3."""
    r = run(binary_twin('fe_separation_3d'), max_iters=0, lat_nx=size,
            lat_ny=size, lat_nz=size, **MODELS[model])
    ks = r.kernel
    assert isinstance(ks, fe.FEStep)
    ks.run(r.f, 20)
    src, dst = ks.b, ks.a
    ks.phi_into(src, ks.phi)
    return ks, src, ks.phi, dst


def timed(ks, launch, iters):
    ms = util.cuda_time_ms(launch, iters, warmup=5)
    return ms, ks.shape[0] * ks.shape[1] * ks.shape[2] / ms / 1e3


def sweep_tiles(model, ks, src, phi, dst, tiles, iters):
    rows, ref = [], None
    for tile in tiles:
        ks.set_tile(tile)
        ks.collide_into(src, phi, dst)
        out = dst.clone()
        same = True if ref is None else bool(torch.equal(out, ref))
        ref = out if ref is None else ref
        ms, mlups = timed(ks, lambda: ks.collide_into(src, phi, dst), iters)
        print(f'{model} tile {tile} grid {ks.tile.grid} smem '
              f'{ks.tile.smem_bytes} B: {ms:.4f} ms per launch '
              f'({mlups:.1f} MLUPS of the step alone); same bits as the '
              f'first tile: {same}', flush=True)
        assert same, tile
        rows.append(dict(model=model, tile=list(tile), ms=ms))
    ks.set_tile(fe.TILE_3D)
    return rows


def bind(ks, fn):
    """Make ``ks`` launch the fe_step entry ``fn``."""
    rho_fn = ks._kernels()[0]
    ks._fns = (rho_fn, fn)


def build_variant(name, text, out_dir):
    path = os.path.join(out_dir, f'fe_step_{name}.cu')
    with open(path, 'w') as fh:
        fh.write(text)
    return build.build_library(path)


def sweep_bounds(ks, src, phi, dst, mins, iters, out_dir):
    text = (build.CSRC / 'fe_step.cu').read_text()
    if text.count(BOUNDS) != 1:
        raise RuntimeError(f'expected one {BOUNDS} in fe_step.cu')
    shipped = ks._kernels()[1]
    rows = []
    for n in mins:
        lib = build_variant(
            f'min{n}', text.replace(BOUNDS, BOUNDS.replace(': 2)',
                                                           f': {n})')),
            out_dir)
        usage = {fn: u for fn, u in build.ptxas_usage(lib.log).items()
                 if 'fe3_kernelILi0ELi0EE' in fn}
        bind(ks, fe.kernel_function(lib.lib, 'D3Q19'))
        ms, mlups = timed(ks, lambda: ks.collide_into(src, phi, dst), iters)
        print(f'bgk launch bounds (256, {n}): {usage}: {ms:.4f} ms per '
              f'launch ({mlups:.1f} MLUPS)', flush=True)
        rows.append(dict(min_blocks=n, ptxas=usage, ms=ms))
    bind(ks, shipped)
    return rows


def baseline_fn(path):
    """The D3Q19 entry of another fe_step.cu, with the signature of its
    kind: (a, phi, b, mask, orient, mrt, params[, tile], stream)."""
    lib = build.build_library(path)
    if hasattr(lib.lib, 'fe_tables_size'):
        return lib, fe.kernel_function(lib.lib, 'D3Q19'), True
    fn = lib.lib.fe_step_d3q19
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int,
                                           ctypes.POINTER(fe._Params),
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn, False


def compare_baseline(model, ks, src, phi, dst, path, iters):
    lib, fn, tiled = baseline_fn(path)
    usage = {f: u for f, u in build.ptxas_usage(lib.log).items()
             if 'fe_step_kernelILi3E' in f or 'fe3_kernel' in f}
    orient = 0 if ks.orient is None else ks.orient.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    extra = (ctypes.byref(ks._tile_params),) if tiled else ()

    def launch_base():
        rc = fn(src.data_ptr(), phi.data_ptr(), dst.data_ptr(),
                ks.mask.data_ptr(), orient, int(ks.mrt),
                ctypes.byref(ks.params), *extra, stream)
        assert rc == 0, rc

    launch_base()
    base_out = dst.clone()
    ks.collide_into(src, phi, dst)
    diff = float((dst - base_out).abs().max())
    times = {'baseline': [], 'kernel': []}
    for name in ('baseline', 'kernel', 'kernel', 'baseline'):
        launch = launch_base if name == 'baseline' else (
            lambda: ks.collide_into(src, phi, dst))
        ms, mlups = timed(ks, launch, iters)
        times[name].append(ms)
        print(f'{model} {name}: {ms:.4f} ms per launch ({mlups:.1f} MLUPS '
              f'of the step alone)', flush=True)
    print(f'{model} baseline {path}: ptxas {usage}; max |kernel - '
          f'baseline| after one launch {diff:.3e}', flush=True)
    return dict(model=model, ms=times, max_abs_diff=diff, ptxas=usage)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--size', type=int, default=256)
    ap.add_argument('--iters', type=int, default=50)
    ap.add_argument('--tiles', nargs='*', default=[
        '32x8x16', '32x8x8', '32x8x32', '64x4x16', '32x4x16', '128x2x16',
        '16x16x16'])
    ap.add_argument('--min-blocks', nargs='*', type=int, default=[])
    ap.add_argument('--baseline', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('fe_tile_sweep: torch sees no CUDA device')
    tiles = [parse_tile(t) for t in args.tiles]
    out_dir = os.path.join(REPO, 'build', 'sweep')
    os.makedirs(out_dir, exist_ok=True)
    report = dict(device=torch.cuda.get_device_name(0), size=args.size,
                  tiles=[], bounds=[], baseline=[])
    for model in MODELS:
        ks, src, phi, dst = engine(model, args.size)
        if args.baseline:
            report['baseline'].append(compare_baseline(
                model, ks, src, phi, dst, args.baseline, args.iters))
        report['tiles'] += sweep_tiles(model, ks, src, phi, dst, tiles,
                                       args.iters)
        if model == 'bgk' and args.min_blocks:
            report['bounds'] = sweep_bounds(ks, src, phi, dst,
                                            args.min_blocks, args.iters,
                                            out_dir)
        del ks, src, phi, dst
        torch.cuda.empty_cache()
    print(json.dumps(report))


if __name__ == '__main__':
    main()
