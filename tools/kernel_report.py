#!/usr/bin/env python3
"""What the compiler made of the port's CUDA kernels.

    python3 tools/kernel_report.py [--sources fe_step sc_multi lbm_step]
                                   [--match fe_step_kernel ...]
                                   [--baseline DIR]

Builds the named ``sailfish_tpu_torch/ops/csrc`` sources (``ops/build``),
and for every kernel function whose mangled name contains one of the
``--match`` strings (default: all) prints

* the registers, the stack frame (local-memory bytes per thread) and the
  spill bytes that ``ptxas -v`` reports, also for a non-inlined device
  function such as a BC chain;
* the SASS instruction count of its body (``cuobjdump -sass`` of the built
  library, NOPs left out), and its mix by opcode class: global loads and
  stores, shared loads and stores, ``cp.async`` (LDGSTS), fp32 arithmetic,
  integer arithmetic, conversions, uniform-datapath and control
  instructions;
* whether ``ncu`` is on the PATH or under the toolkit.

With ``--baseline DIR`` (another checkout, for example ``git archive
<commit> | tar -x -C build/parent``) it also builds DIR's ``lbm_step.cu``
and ``sc_multi.cu``, those of them in ``--sources``. It sets each of
DIR's ``lbm_step_kernel`` instantiations beside this tree's of the same
lattice, force model, wall switch and equilibrium (compressible or
incompressible) with BGK (the template arguments
``ops/lbm_step.instantiation`` reads from the mangled names), DIR's
density pre-pass beside this tree's, and
each of DIR's Shan-Chen step instantiations beside this tree's of the
same lattice, component count and force switch (``ops/sc_multi.
instantiation``; the D3Q19 step is ``sc3_kernel`` here, a redesign shown
side by side): registers, stack frame, spills and the SASS count of every
class, and whether all those kept under their name are the same.

Ends with one JSON line. Needs ``nvcc`` and ``cuobjdump`` (the CUDA
toolkit), not a GPU.
"""

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from sailfish_tpu_torch.ops import build  # noqa: E402

#: opcode (before the first '.') -> class
CLASSES = {
    'LDG': 'global_load', 'STG': 'global_store',
    'LDS': 'shared_load', 'STS': 'shared_store', 'LDGSTS': 'cp_async',
    'LDL': 'local', 'STL': 'local', 'LDC': 'const_load',
    'FFMA': 'fp32', 'FADD': 'fp32', 'FMUL': 'fp32', 'FMNMX': 'fp32',
    'FSEL': 'fp32', 'FSETP': 'fp32', 'MUFU': 'mufu', 'FCHK': 'fp32',
    'IMAD': 'int', 'IADD3': 'int', 'LEA': 'int', 'ISETP': 'int',
    'IABS': 'int', 'LOP3': 'int', 'SHF': 'int', 'SEL': 'int',
    'IMNMX': 'int', 'VIMNMX': 'int', 'PRMT': 'int', 'MOV': 'move',
    'I2F': 'convert', 'F2I': 'convert', 'I2FP': 'convert', 'F2F': 'convert',
    'BAR': 'barrier', 'DEPBAR': 'barrier', 'LDGDEPBAR': 'barrier',
}


def find_tool(name):
    """``name`` beside ``nvcc``, else on the PATH, else None."""
    beside = Path(build.find_nvcc()).parent / name
    if beside.is_file():
        return str(beside)
    return shutil.which(name)


def sass_counts(so_path, cuobjdump):
    """{mangled function: Counter(opcode class -> n, 'total' -> n)}."""
    out = subprocess.run([cuobjdump, '-sass', str(so_path)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            fn = m.group(1)
            counts[fn] = collections.Counter()
            continue
        m = re.search(r'/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)',
                      line)
        if not (m and fn):
            continue
        op = m.group(1).split('.')[0]
        if op == 'NOP':
            continue
        cls = CLASSES.get(op)
        if cls is None:
            if op.startswith('U'):
                cls = 'uniform'
            elif op in ('BRA', 'EXIT', 'BSSY', 'BSYNC', 'RET', 'CALL',
                        'WARPSYNC', 'BMOV', 'YIELD'):
                cls = 'control'
            else:
                cls = 'other'
        counts[fn][cls] += 1
        counts[fn]['total'] += 1
    return counts


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--sources', nargs='+',
                    default=['fe_step', 'sc_multi', 'lbm_step',
                             'lbm_step_mrt', 'lbm_step_les',
                             'lbm_step_mixed', 'lbm_step_mixed_mrt',
                             'lbm_step_mixed_les'])
    ap.add_argument('--match', nargs='*', default=[])
    ap.add_argument('--baseline', default=None)
    args = ap.parse_args()
    cuobjdump = find_tool('cuobjdump')
    ncu = find_tool('ncu')
    print(f'cuobjdump: {cuobjdump}; ncu: {ncu}', flush=True)
    report = {}
    for src, lib in build.load_all(args.sources).items():
        print(f'build {src}: {lib.path.name} in {lib.seconds:.1f} s (0 = '
              'cached)', flush=True)
        usage = build.ptxas_usage(lib.log)
        sass = sass_counts(lib.path, cuobjdump) if cuobjdump else {}
        for fn in sorted(set(usage) | set(sass)):
            if args.match and not any(k in fn for k in args.match):
                continue
            if fn not in sass and not usage.get(fn):
                continue
            row = dict(usage.get(fn, {}), sass=dict(sass.get(fn, {})))
            report[fn] = dict(source=src, **row)
            mix = ', '.join(f'{k} {v}' for k, v in sorted(
                row['sass'].items(), key=lambda kv: -kv[1]))
            print(f'{src}: {fn}: {row.get("registers")} registers, stack '
                  f'frame {row.get("stack_frame")} B, spill '
                  f'{row.get("spill_stores")} / {row.get("spill_loads")} B; '
                  f'SASS {mix}', flush=True)
    out = {'ncu': ncu, 'kernels': report}
    if args.baseline:
        out['baseline'] = {
            src: baseline_report(args.baseline, report, cuobjdump, src)
            for src in ('lbm_step', 'sc_multi') if src in args.sources}
    print(json.dumps(out))


def _lbm_key(fn):
    """(lattice, force model, walls, incompressible) of a BGK fp32
    ``lbm_step_kernel`` instantiation with the compressible or the
    incompressible equilibrium and without the Shan-Chen mode (an older
    build's, whose sixth template argument was the bool
    ``incompressible``, or this one's), else None."""
    from sailfish_tpu_torch.ops import lbm_step as ls
    inst = ls.instantiation(fn)
    if inst is None or inst.get('model', 'bgk') != 'bgk' \
            or inst.get('sc', False) \
            or inst.get('equilibrium') == 'shallow_water' \
            or inst.get('storage') == 'int16':
        return None
    incomp = inst.get('incompressible',
                      inst.get('equilibrium') == 'incompressible')
    return inst['dim'], inst['force'], inst['walls'], incomp


def _function_name(fn):
    """The function identifier of the mangled name ``fn``
    (``lbm_step_kernel``, ``sc3_kernel``, ...)."""
    m = re.match(r'_Z(\d+)', fn)
    return fn[m.end():m.end() + int(m.group(1))] if m else fn


def _sc_key(fn):
    """(lattice, K, forced) of a Shan-Chen step kernel instantiation
    (``sc_multi_kernel`` or the D3Q19 ``sc3_kernel``), the mangled name of
    the density pre-pass, else None."""
    from sailfish_tpu_torch.ops import sc_multi as sm
    if 'rho_poststream_kernel' in fn:
        return fn
    inst = sm.instantiation(fn)
    return None if inst is None else (inst['dim'], inst['k'],
                                      inst['forced'])


def _describe(key):
    if isinstance(key, str):
        return 'pre-pass'
    if len(key) == 4:
        return (f'd{key[0]}, force {key[1]}, walls {int(key[2])}, '
                f'incompressible {int(key[3])}')
    return f'd{key[0]}, K = {key[1]}, forced {int(key[2])}'


def baseline_report(tree, report, cuobjdump, source='lbm_step'):
    """Each kernel instantiation of ``tree``'s ``source`` beside this
    tree's of the same key (``_lbm_key``: lattice, force model and wall
    switch and equilibrium of ``lbm_step_kernel`` with BGK; ``_sc_key``:
    the pre-pass, and lattice, K and forced of the Shan-Chen step). Where
    both trees have the same function (the same identifier; the template
    arguments and kernel parameters may be spelled otherwise, as after a
    bool argument became an int) it must be the same, class by class; a
    key whose function was renamed (``sc_multi_kernel<3, 19, ...>`` ->
    ``sc3_kernel``) is a redesign, shown side by side. Prints one line each and returns
    {'instantiations': [...], 'all_same': bool} (over the unrenamed
    ones)."""
    key = _lbm_key if source == 'lbm_step' else _sc_key
    src = Path(tree) / 'sailfish_tpu_torch' / 'ops' / 'csrc' / f'{source}.cu'
    lib = build.build_library(src)
    usage = build.ptxas_usage(lib.log)
    sass = sass_counts(lib.path, cuobjdump) if cuobjdump else {}

    mine = {}
    for fn, row in report.items():
        if row['source'] == source and key(fn) is not None:
            mine[key(fn)] = (fn, row)
    rows, all_same = [], True
    fields = ('registers', 'stack_frame', 'spill_stores', 'spill_loads')
    for fn in sorted(usage):
        k = key(fn)
        if k is None or 'registers' not in usage[fn]:
            continue
        base = dict(usage[fn], sass=dict(sass.get(fn, {})))
        new_fn, new = mine.get(k, (None, None))
        renamed = new_fn is not None \
            and _function_name(new_fn) != _function_name(fn)
        same = new is not None and all(
            base.get(f) == new.get(f) for f in fields) \
            and base['sass'] == new['sass']
        if not renamed:
            all_same &= same
        diff = '' if same or new is None else ', '.join(
            f'{c} {base["sass"].get(c, 0)} -> {new["sass"].get(c, 0)}'
            for c in sorted(set(base['sass']) | set(new['sass']))
            if base['sass'].get(c, 0) != new['sass'].get(c, 0))
        print(f'baseline {fn} ({_describe(k)}): '
              f'{base.get("registers")} registers, frame '
              f'{base.get("stack_frame")} B, '
              f'{base["sass"].get("total")} SASS; this tree {new_fn}: '
              + ('not built' if new is None else
                 f'{new.get("registers")} registers, frame '
                 f'{new.get("stack_frame")} B, '
                 f'{new["sass"].get("total")} SASS')
              + (': the same, class by class' if same else
                 f': redesigned, {diff}' if renamed else
                 f': differs {diff}'), flush=True)
        rows.append(dict(baseline=fn, tree=new_fn, same=same,
                         redesigned=renamed, baseline_usage=base,
                         tree_usage=new))
    print(f'baseline {source} instantiations the same as this tree\'s, '
          f'class by class: {all_same} ({sum(not r["redesigned"] for r in rows)}'
          f' kept, {sum(r["redesigned"] for r in rows)} redesigned)',
          flush=True)
    return dict(instantiations=rows, all_same=all_same)


if __name__ == '__main__':
    main()
