#!/usr/bin/env python3
"""Tile and register-design sweep of the D3Q19 Shan-Chen step kernel
(``sc3_kernel`` of ``csrc/sc_multi.cu``) on one CUDA GPU.

    python3 tools/sc_tile_sweep.py [--size 256] [--iters 50]
        [--scenes sc_separation_3d,...] [--tiles 32x8x16 64x4x16 ...]
        [--variants repull blocks=3 repull+blocks=3 ...]
        [--tiles-with VARIANT]

For each 3D mixture scene of ``--scenes`` (default: the binary and the
ternary separation, each unforced and with ``MAIN_ACCELS`` on every
component, so every instantiation of the kernel runs) it sets the scene up
at size^3 on the kernel engine, runs 20 steps from a seeded near-uniform
state, fills the densities with the pre-pass and then times
``collide_into`` alone (CUDA events over ``--iters`` launches after 5
warm-up launches) on that state:

* for every tile tx x ty x kz of ``--tiles`` (``SCMultiStep.set_tile``),
  whose result must equal the first tile's bit for bit, with the shipped
  kernel or the variant ``--tiles-with`` (one of ``--variants``);
* for every variant of ``--variants``: ``csrc/sc_multi.cu`` with the
  edits its ``+``-joined parts name (``repull``: each component pulled a
  second time for its relaxation instead of the K*Q pulled values held in
  registers; ``blocks=n``: ``__launch_bounds__(256, n)``), written under
  ``build/sweep`` and built, with the ptxas registers, stack frame and
  spills of its four D3Q19 instantiations and its largest difference from
  the shipped kernel after one launch; the shipped kernel and the
  variants are timed in turns (shipped, variants, variants in reverse,
  shipped).

Prints one line per timing, the card's name and power limit, and a JSON
line. The shipped kernel is not changed.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tests'))
from sailfish_tpu_torch import util  # noqa: E402
from sailfish_tpu_torch.ops import build  # noqa: E402
from sailfish_tpu_torch.ops import sc_multi as sm  # noqa: E402
import torch_scenes as ts  # noqa: E402

#: the accelerations of the forced scenes (chip_smoke.MAIN_ACCELS)
ACCELS = tuple(tuple(1e-3 * c for c in a) for a in ts.MIX_ACCELS)
SCENES = {
    'sc_separation_3d': lambda: ts.binary_twin('sc_separation_3d'),
    'sc_separation_3d_forced': lambda: ts.forced_mixture(
        ts.binary_twin('sc_separation_3d'), ACCELS),
    'ternary_separation_3d': lambda: ts.ternary_separation(3),
    'ternary_separation_3d_forced': lambda: ts.forced_mixture(
        ts.ternary_separation(3), ACCELS),
}


def parse_tile(text):
    return tuple(int(v) for v in text.split('x'))


def engine(scene, size):
    """(SCMultiStep, source buffer, densities, destination buffer) after
    20 steps of ``scene`` at size^3 from a seeded state."""
    ks = ts.run(SCENES[scene](), max_iters=0, lat_nx=size, lat_ny=size,
                lat_nz=size).kernel
    assert isinstance(ks, sm.SCMultiStep) and ks.grid.name == 'D3Q19'
    ks.a.copy_(ts.random_binary_state(ks.grid, ks.shape, 1, 'cuda', K=ks.K))
    ks.run(tuple(ks.a.unbind(0)), 20)
    src, dst = ks.a, ks.b
    ks.density_into(src, ks.rho)
    return ks, src, ks.rho, dst


def timed(ks, launch, iters):
    ms = util.cuda_time_ms(launch, iters, warmup=5)
    return ms, ks.shape[0] * ks.shape[1] * ks.shape[2] / ms / 1e3


def sweep_tiles(scene, ks, src, rho, dst, tiles, iters):
    rows, ref = [], None
    for tile in tiles:
        ks.set_tile(tile)
        ks.collide_into(src, rho, dst)
        out = dst.clone()
        same = True if ref is None else bool(torch.equal(out, ref))
        ref = out if ref is None else ref
        ms, mlups = timed(ks, lambda: ks.collide_into(src, rho, dst), iters)
        print(f'{scene} tile {tile} grid {ks.tile.grid} smem '
              f'{ks.tile.smem_bytes} B: {ms:.4f} ms per launch ({mlups:.1f} '
              f'MLUPS of the step alone); same bits as the first tile: '
              f'{same}', flush=True)
        assert same, tile
        rows.append(dict(scene=scene, tile=list(tile), ms=ms))
    ks.set_tile(sm.TILE_3D)
    return rows


#: the shipped kernel's pulled values, held in registers until the stores,
#: and what ``repull`` puts in their place: every read pulls again
HELD = """\
    float f[K][Q];
    static_for<K>([&](auto KI) {
        static_for<Q>([&](auto I) {
            f[decltype(KI)::value][decltype(I)::value] = pull(KI, I);
        });
    });
    auto val = [&](auto KI, auto I) {
        return f[decltype(KI)::value][decltype(I)::value];
    };
"""
REPULLED = """\
    auto val = [&](auto KI, auto I) { return pull(KI, I); };
"""
BOUNDS = '__launch_bounds__(SC3_THREADS, 2)'


def variant_source(variant, text):
    """``text`` (the shipped sc_multi.cu) with the edits of ``variant``,
    ``+``-joined parts ``repull`` and ``blocks=n``; raises if the shipped
    source no longer holds what an edit replaces."""
    for part in variant.split('+'):
        if part == 'repull':
            old, new = HELD, REPULLED
        elif part.startswith('blocks='):
            old = BOUNDS
            new = f'__launch_bounds__(SC3_THREADS, {int(part[7:])})'
        else:
            raise ValueError(f'unknown variant part {part!r}')
        if text.count(old) != 1:
            raise ValueError(f'{part}: sc_multi.cu does not hold what it '
                             f'replaces exactly once')
        text = text.replace(old, new)
    return text


def build_variants(variants, out_dir):
    """{variant: KernelLibrary} of sc_multi.cu with each variant's edits,
    the sources written to ``out_dir``."""
    text = (build.CSRC / 'sc_multi.cu').read_text()
    paths = []
    for v in variants:
        name = v.replace('+', '_').replace('=', '')
        path = os.path.join(out_dir, f'sc_multi_{name}.cu')
        with open(path, 'w') as fh:
            fh.write(variant_source(v, text))
        paths.append(path)
    return dict(zip(variants, build.build_libraries(paths)))


def sc3_usage(lib):
    """{(K, forced): ptxas usage} of the library's ``sc3_kernel``."""
    out = {}
    for fn, use in build.ptxas_usage(lib.log).items():
        inst = sm.instantiation(fn)
        if inst and inst['dim'] == 3 and 'registers' in use:
            out[f'K{inst["k"]}{"_forced" if inst["forced"] else ""}'] = use
    return out


def compare_variants(scene, ks, src, rho, dst, libs, iters):
    ks.collide_into(src, rho, dst)
    ref = dst.clone()
    fns = {'shipped': ks._fns}
    for v, lib in libs.items():
        fns[v] = sm.kernel_functions(lib.lib, 'D3Q19')
    diffs = {}
    for v in libs:
        ks._fns = fns[v]
        ks.collide_into(src, rho, dst)
        diffs[v] = float((dst - ref).abs().max())
    order = ['shipped'] + list(libs) + list(libs)[::-1] + ['shipped']
    times = {name: [] for name in fns}
    for name in order:
        ks._fns = fns[name]
        ms, _ = timed(ks, lambda: ks.collide_into(src, rho, dst), iters)
        times[name].append(ms)
    ks._fns = fns['shipped']
    rows = []
    for name, t in times.items():
        ms = statistics.mean(t)
        print(f'{scene} {ks.name} {name}: {ms:.4f} ms per launch {t}'
              + ('' if name == 'shipped' else
                 f'; over shipped {ms / statistics.mean(times["shipped"]):.4f}'
                 f'; max |variant - shipped| after one launch '
                 f'{diffs[name]:.3e}'), flush=True)
        rows.append(dict(scene=scene, kernel=ks.name, variant=name, ms=t,
                         max_abs_diff=diffs.get(name, 0.0)))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--size', type=int, default=256)
    ap.add_argument('--iters', type=int, default=50)
    ap.add_argument('--scenes', default=','.join(SCENES))
    ap.add_argument('--tiles', nargs='*', default=[
        '32x8x16', '32x8x8', '32x8x32', '64x4x16', '32x4x16', '128x2x16',
        '16x16x16'])
    ap.add_argument('--variants', nargs='*', default=['repull'])
    ap.add_argument('--tiles-with', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('sc_tile_sweep: torch sees no CUDA device')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out_dir = os.path.join(REPO, 'build', 'sweep')
    os.makedirs(out_dir, exist_ok=True)
    libs = build_variants(args.variants, out_dir)
    report = dict(device=smi, size=args.size, ptxas={}, tiles=[],
                  variants=[])
    report['ptxas']['shipped'] = sc3_usage(build.load('sc_multi'))
    for v, lib in libs.items():
        report['ptxas'][v] = sc3_usage(lib)
    for v, usage in report['ptxas'].items():
        for inst, use in sorted(usage.items()):
            print(f'{v}: sc3_kernel {inst}: {use["registers"]} registers, '
                  f'stack frame {use["stack_frame"]} B, spill '
                  f'{use["spill_stores"]} / {use["spill_loads"]} B',
                  flush=True)
    tiles = [parse_tile(t) for t in args.tiles]
    for scene in args.scenes.split(','):
        ks, src, rho, dst = engine(scene, args.size)
        if libs:
            report['variants'] += compare_variants(scene, ks, src, rho, dst,
                                                   libs, args.iters)
        if tiles:
            if args.tiles_with:
                ks._fns = sm.kernel_functions(libs[args.tiles_with].lib,
                                              'D3Q19')
            report['tiles'] += sweep_tiles(scene, ks, src, rho, dst, tiles,
                                           args.iters)
        del ks, src, rho, dst
        torch.cuda.empty_cache()
    print(json.dumps(report))


if __name__ == '__main__':
    main()
