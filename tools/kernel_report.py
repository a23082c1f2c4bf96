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
<commit> | tar -x -C build/parent``) it also builds, in parallel, DIR's
sources of ``--sources`` among the ``lbm_step`` libraries,
``sc_multi.cu`` and ``halo.cu`` (its exchange kernels set beside this
tree's of the same name: the one-axis ``halo_exchange_kernel``
instantiations). It sets each of DIR's ``lbm_step_kernel``
instantiations beside this tree's of the same template arguments
(lattice, force model, wall switch, collision model, equilibrium,
Shan-Chen mode, storage and outflow switch (False for an older build, which
has none), as ``ops/lbm_step.instantiation`` reads them from the mangled
names; an older build's bool ``incompressible`` read as its
equilibrium), DIR's density pre-pass beside this tree's, and each of
DIR's Shan-Chen step instantiations beside this tree's of the same
lattice, component count and force switch (``ops/sc_multi.
instantiation``; the D3Q19 step is ``sc3_kernel`` here, a redesign shown
side by side): registers, stack frame, spills and the SASS count of
every class, and whether all those kept under their name are the same.

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
                             'lbm_step_mrt', 'lbm_step_les', 'lbm_step_elbm',
                             'lbm_step_mixed', 'lbm_step_mixed_mrt',
                             'lbm_step_mixed_les', 'lbm_step_mixed_elbm',
                             'lbm_step_lattices', 'lbm_step_outflow'])
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
        csrc = Path(args.baseline) / 'sailfish_tpu_torch' / 'ops' / 'csrc'
        theirs = [src for src in args.sources
                  if (src.startswith('lbm_step')
                      or src in ('sc_multi', 'halo'))
                  and (csrc / f'{src}.cu').is_file()]
        libs = build.build_libraries([csrc / f'{src}.cu' for src in theirs])
        out['baseline'] = {
            src: baseline_report(lib, report, cuobjdump, src)
            for src, lib in zip(theirs, libs)}
        lbm = [v for k, v in out['baseline'].items()
               if k.startswith('lbm_step')]
        kept = sum(not r['redesigned'] for v in lbm
                   for r in v['instantiations'])
        same = sum(r['same'] for v in lbm for r in v['instantiations'])
        print(f'baseline lbm_step_kernel: {same} of {kept} instantiations '
              'the same as this tree\'s, class by class', flush=True)
    for label, pick in (('ELBM', lambda k: k[3] == 'elbm'),
                        ('outflow', lambda k: k[7])):
        new = {fn: row for fn, row in report.items()
               if pick(_lbm_key(fn) or ('',) * 8)}
        if not new:
            continue

        def most(field):
            return max(r.get(field, 0) for r in new.values())
        print(f'lbm_step_kernel {label}: {len(new)} instantiations, '
              f'registers {min(r.get("registers", 0) for r in new.values())}'
              f'-{most("registers")}, stack frame at most '
              f'{most("stack_frame")} B, spills at most '
              f'{most("spill_stores")} B', flush=True)
    print(json.dumps(out))


def _lbm_key(fn):
    """(lattice, force model, walls, collision model, equilibrium,
    Shan-Chen mode, storage, outflow) of an ``lbm_step_kernel``
    instantiation (an older build's, whose sixth template argument was the
    bool ``incompressible`` or which has no outflow switch, or this
    one's), else None."""
    from sailfish_tpu_torch.ops import lbm_step as ls
    inst = ls.instantiation(fn)
    if inst is None:
        return None
    eqm = inst.get('equilibrium', 'incompressible'
                   if inst.get('incompressible') else 'bgk')
    lat = f'{inst["dim"]}q{inst["q"]}' if 'q' in inst else inst['dim']
    return (lat, inst['force'], inst['walls'],
            inst.get('model', 'bgk'), eqm, inst.get('sc', False),
            inst.get('storage', 'fp32'), inst.get('outflow', False))


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


def _halo_key(fn):
    """The mangled name of an exchange kernel of ``halo.cu``, else
    None."""
    return fn if 'exchange_kernel' in fn else None


def _describe(key):
    if isinstance(key, str):
        return 'exchange' if 'exchange_kernel' in key else 'pre-pass'
    if len(key) == 8:
        return (f'd{key[0]}, force {key[1]}, walls {int(key[2])}, model '
                f'{key[3]}, equilibrium {key[4]}, sc {int(key[5])}, '
                f'{key[6]}, outflow {int(key[7])}')
    return f'd{key[0]}, K = {key[1]}, forced {int(key[2])}'


def baseline_report(lib, report, cuobjdump, source='lbm_step'):
    """Each kernel instantiation of ``lib`` (a baseline tree's build of
    ``source``) beside this tree's of the same key (``_lbm_key``: the
    template arguments of ``lbm_step_kernel``; ``_sc_key``:
    the pre-pass, and lattice, K and forced of the Shan-Chen step). Where
    both trees have the same function (the same identifier; the template
    arguments and kernel parameters may be spelled otherwise, as after a
    bool argument became an int) it must be the same, class by class; a
    key whose function was renamed (``sc_multi_kernel<3, 19, ...>`` ->
    ``sc3_kernel``) is a redesign, shown side by side. Prints one line each and returns
    {'instantiations': [...], 'all_same': bool} (over the unrenamed
    ones)."""
    key = _lbm_key if source.startswith('lbm_step') else \
        _halo_key if source == 'halo' else _sc_key
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
