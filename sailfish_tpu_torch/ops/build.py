"""Build and load the port's CUDA kernels.

Each ``ops/csrc/*.cu`` source has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``build/kernels/`` at
first use, keyed by a hash of the source, its headers and the flags, and
loaded with ``ctypes``; ``load_all`` compiles several sources in parallel,
and ``start_all`` starts their compilers without waiting for them.
Nothing CUDA-specific happens at import: a machine without ``nvcc``
imports this module and fails only when a kernel is asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
#: ``build/kernels`` at the root of the source checkout
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


class KernelLibrary:
    """A loaded kernel library: the ``ctypes`` handle, where it came from,
    the build's wall seconds (0 when it was already built) and the
    compiler's register/spill report."""

    def __init__(self, lib, path, seconds, log):
        self.lib = lib
        self.path = path
        self.seconds = seconds
        self.log = log


_loaded = {}
#: builds started by ``start_all`` and not finished yet: name -> pending
_pending = {}


def find_nvcc():
    """Path of ``nvcc``: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get('CUDA_HOME'):
        candidates.append(Path(os.environ['CUDA_HOME']) / 'bin' / 'nvcc')
    on_path = shutil.which('nvcc')
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path('/usr/local/cuda/bin/nvcc'))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        'nvcc not found (looked in $CUDA_HOME/bin, PATH and '
        '/usr/local/cuda/bin); the CUDA kernels cannot be built here')


def load(name):
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    return load_all([name])[name]


def start_all(names):
    """Start building ``csrc/<name>.cu`` for every name not loaded or
    started yet, one ``nvcc`` each, all together, without waiting for
    them; ``load`` and ``load_all`` finish a started build."""
    for n in names:
        if n not in _loaded and n not in _pending:
            _pending[n] = _start_build(CSRC / f'{n}.cu')


def load_all(names):
    """Build (if needed) and load ``csrc/<name>.cu`` for every name, with
    one ``nvcc`` per source, all started together; returns {name:
    KernelLibrary}. Cached per process."""
    start_all(names)
    for n in names:
        if n not in _loaded:
            _loaded[n] = _finish_build(*_pending.pop(n))
    return {n: _loaded[n] for n in names}


def build_library(src):
    """Compile the CUDA source ``src`` with ``NVCC_FLAGS`` into
    ``build/kernels/lib<stem>_<hash>.so`` unless that file exists (the
    hash covers the source text, the headers beside it and the flags), and
    load it."""
    return build_libraries([src])[0]


def build_libraries(srcs):
    """``build_library`` of every source of ``srcs``, one ``nvcc`` each,
    all started together; returns the ``KernelLibrary`` list in order."""
    pending = [_start_build(src) for src in srcs]
    return [_finish_build(*p) for p in pending]


def hashed_files(src):
    """The files a build of ``src`` reads and its key hashes: the source,
    every ``.cu`` source beside it that it includes (``lbm_step_mrt.cu``
    builds ``lbm_step.cu`` with another collision model), then every header
    beside it and in ``CSRC`` (``*.cuh``, which a source may include; a
    variant source written elsewhere finds them through ``-I``). An
    installed package must carry them all (``package_data`` in
    setup.py)."""
    src = Path(src)
    included = re.findall(r'^#include "(\w+\.cu)"', src.read_text(), re.M)
    headers = sorted(src.parent.glob('*.cuh'))
    if src.parent.resolve() != CSRC.resolve():
        headers += sorted(CSRC.glob('*.cuh'))
    return [src] + [src.parent / name for name in included] + headers


def _start_build(src):
    """(src, out, running nvcc process or None when built, start time).
    The build key hashes ``hashed_files(src)`` and the flags."""
    src = Path(src)
    digest = hashlib.sha256(
        b''.join(f.read_bytes() for f in hashed_files(src))
        + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f'lib{src.stem}_{digest}.so'
    if out.exists():
        return src, out, None, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # -I: a variant source written elsewhere (tools/) still finds the
    # headers of csrc; a source's own directory is searched first
    cmd = [find_nvcc(), *NVCC_FLAGS, '-I', str(CSRC), '-o',
           str(_tmp_path(out)), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return src, out, proc, time.perf_counter()


def ptxas_usage(log):
    """{mangled function: {'registers': n, 'stack_frame': bytes,
    'spill_stores': bytes, 'spill_loads': bytes}} from an ``nvcc -Xptxas
    -v`` log; the stack frame is the function's local memory per thread
    (arrays the compiler could not keep in registers, and spills)."""
    usage, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            usage.setdefault(fn, {})
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m and fn:
            usage[fn]['stack_frame'] = int(m.group(1))
            usage[fn]['spill_stores'] = int(m.group(2))
            usage[fn]['spill_loads'] = int(m.group(3))
        m = re.search(r'Used (\d+) registers', line)
        if m and fn:
            usage[fn]['registers'] = int(m.group(1))
    return usage


def _tmp_path(out):
    return out.with_name(f'{out.name}.{os.getpid()}.tmp')


def _finish_build(src, out, proc, t0):
    log_path = out.with_suffix('.log')
    seconds = 0.0
    if proc is not None:
        output, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f'nvcc failed ({proc.returncode}) building {src}:\n'
                f'{output}')
        log_path.write_text(output)
        os.replace(_tmp_path(out), out)
    log = log_path.read_text() if log_path.exists() else ''
    return KernelLibrary(ctypes.CDLL(str(out)), out, seconds, log)
