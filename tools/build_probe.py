#!/usr/bin/env python3
"""Build time of the single-fluid step kernel in two layouts.

    python3 tools/build_probe.py [--out DIR]

The 234 ``lbm_step_kernel`` instantiations are built as the eight
libraries of ``ops/lbm_step.LIBRARIES`` and ``MIXED_LIBRARIES`` (one
``nvcc`` per collision model and storage, all started together, as
``ops/build.load_all`` builds them: 122 fp32 instantiations, 42 of them
BGK, 32 MRT, 32 LES and 16 ELBM, and 112 on int16 state, 32 each for BGK,
MRT and LES and 16 for ELBM), then as one library of all 234
(``lbm_step.cu``, the fp32 BGK library, with every other instantiation
taken by address), with the shipped flags and with nvcc's
``--split-compile=0`` (the optimizer's passes in parallel on every core),
also handed to ptxas. The variants run one after the other, so each has
the machine's cores to itself. A variant that nvcc refuses is reported
with its first error line.

For each variant: its wall seconds, and whether every instantiation gets
the registers, stack frame, spills and SASS instruction count of the eight
libraries. Needs ``nvcc`` (and ``cuobjdump`` for SASS); no GPU. Builds
under DIR (default ``build/build_probe``, emptied first). Ends with one JSON
line.
"""

import argparse
import itertools
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

TOOLS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TOOLS)
sys.path.insert(0, REPO)
sys.path.insert(0, TOOLS)
from kernel_report import find_tool, sass_counts  # noqa: E402
from sailfish_tpu_torch.ops import build, lbm_step as ls  # noqa: E402

SPLIT = ('--split-compile=0',)
VARIANTS = {
    'one': (),
    'one_split': SPLIT,
    'one_split_ptxas': SPLIT + ('-Xptxas', '--split-compile=0'),
}


def one_source(out):
    """Write ``out/lbm_step_all.cu``: ``lbm_step.cu`` (the fp32 BGK
    library) plus the address of every other library's instantiation (fp32
    MRT, LES and ELBM; BGK, MRT, LES and ELBM on int16 state), which makes
    nvcc compile them into the same library. ELBM is built with the
    compressible equilibrium only."""
    rows = []
    for storage, (dim, q), force, walls, model, eq in itertools.product(
            ('float', 'int16_t'), ((2, 9), (3, 19)),
            ('FORCE_NONE', 'FORCE_GUO', 'FORCE_EDM', 'FORCE_VELOCITY_SHIFT'),
            ('false', 'true'),
            ('MODEL_BGK', 'MODEL_MRT', 'MODEL_LES', 'MODEL_ELBM'),
            ('EQ_BGK', 'EQ_INCOMP')):
        if (storage == 'float' and model == 'MODEL_BGK') \
                or (model == 'MODEL_ELBM' and eq != 'EQ_BGK'):
            continue
        rows.append(f'    (void*)lbm_step_kernel<{dim}, {q}, {force}, '
                    f'{walls}, {model}, {eq}, false, {storage}>,')
    src = out / 'lbm_step_all.cu'
    src.write_text('#include "lbm_step.cu"\n\nvoid* lbm_probe_kernels[] = {\n'
                   + '\n'.join(rows) + '\n};\n')
    return src


def nvcc(src, so, extra):
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, *extra, '-I',
           str(build.CSRC), '-o', str(so), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish(procs, t0):
    """(wall seconds, joined log, first error line or None)."""
    logs, error = [], None
    for p in procs:
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0 and error is None:
            error = next((ln for ln in out.splitlines() if 'rror' in ln),
                         out.strip()[:200] or f'rc {p.returncode}')
    return time.perf_counter() - t0, '\n'.join(logs), error


def profile(log, sos, cuobjdump):
    """{instantiation: (registers, stack frame, spill stores, spill loads,
    SASS total)} of the lbm_step kernels in the builds ``sos``."""
    usage = build.ptxas_usage(log)
    sass = {}
    for so in sos:
        if cuobjdump:
            sass.update(sass_counts(so, cuobjdump))
    return {fn: (u.get('registers'), u.get('stack_frame'),
                 u.get('spill_stores'), u.get('spill_loads'),
                 sass.get(fn, {}).get('total'))
            for fn, u in usage.items() if ls.instantiation(fn)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default=os.path.join(REPO, 'build',
                                                  'build_probe'))
    args = ap.parse_args()
    out = Path(args.out)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    version = subprocess.run([build.find_nvcc(), '--version'],
                             capture_output=True, text=True).stdout
    print(version.strip().splitlines()[-1], f'; {os.cpu_count()} cores',
          flush=True)
    cuobjdump = find_tool('cuobjdump')
    result = {}

    names = list(ls.LIBRARIES.values()) + list(ls.MIXED_LIBRARIES.values())
    t0 = time.perf_counter()
    procs = [nvcc(build.CSRC / f'{n}.cu', out / f'lib{n}.so', ())
             for n in names]
    seconds, log, error = finish(procs, t0)
    if error:
        raise SystemExit(f'the shipped libraries do not build: {error}')
    ref = profile(log, [out / f'lib{n}.so' for n in names], cuobjdump)
    result['libraries'] = dict(seconds=round(seconds, 2), kernels=len(ref))
    print(f'{len(names)} libraries in parallel: {seconds:.2f} s, {len(ref)} '
          'instantiations', flush=True)

    src = one_source(out)
    for name, extra in VARIANTS.items():
        so = out / f'lib{name}.so'
        t0 = time.perf_counter()
        seconds, log, error = finish([nvcc(src, so, extra)], t0)
        row = dict(flags=' '.join(extra), seconds=round(seconds, 2))
        if error:
            row['error'] = error
            print(f'{name}: refused after {seconds:.2f} s: {error}',
                  flush=True)
        else:
            got = profile(log, [so], cuobjdump)
            differ = sorted(fn for fn in ref if got.get(fn) != ref[fn])
            row.update(kernels=len(got), differ=len(differ),
                       examples={fn: [ref[fn], got.get(fn)]
                                 for fn in differ[:4]})
            print(f'{name} ({row["flags"] or "shipped flags"}): '
                  f'{seconds:.2f} s, {len(got)} instantiations, '
                  f'{len(differ)} differ from the {len(names)} libraries '
                  '(registers, frame, spills, SASS)', flush=True)
        result[name] = row
    print(json.dumps(result))


if __name__ == '__main__':
    main()
