#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernel from ``sailfish_tpu_torch/ops/csrc``, holds it
against its plain PyTorch version (``ops/lbm_step.step_reference``) on the
card from seeded random states (lid-driven cavities, and ducts with
x-normal velocity/density faces of each native BC pair), runs the port's
lid-driven cavity examples through the controller at the benchmark sizes
(D3Q19 256^3, D2Q9 4096^2), checks the results, and prints the
measurements. Every
phase raises on failure, so the exit code is 0 only when all of them
passed; without a CUDA device it exits non-zero before printing a result.
The last line is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

from sailfish_tpu_torch import util
from sailfish_tpu_torch.ops import build
from sailfish_tpu_torch.ops import lbm_step as ls

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, 'tests'))
from torch_scenes import (channel_sim, random_feq, run,  # noqa: E402
                          twin, with_keep_block)

LDC_3D = twin('ldc_3d')
LDC_2D = twin('ldc_2d')

#: kernel-vs-plain tolerance: wet-node max |df| after 200 steps (fp32,
#: FMA contraction and summation order differ between the two)
TOL = 1e-5
#: bytes moved per node per step: Q floats read + Q written + 1 mask byte
BYTES = {'D3Q19': 2 * 19 * 4 + 1, 'D2Q9': 2 * 9 * 4 + 1}
KERNELS = {
    'D3Q19': ('lbm_step_d3q19', 'sailfish_tpu/ops/pallas_step.py:812'),
    'D2Q9': ('lbm_step_d2q9', 'sailfish_tpu/ops/pallas_step2d.py:36'),
}
SOURCE = 'sailfish_tpu_torch/ops/csrc/lbm_step.cu'
DEVICE = 'cuda'


def say(*parts):
    print(*parts, flush=True)


def compare(name, sim_cls, steps=200, **cfg):
    """Kernel vs step_reference on the card from one random state."""
    r = run(with_keep_block(sim_cls), platform=DEVICE, engine='kernel',
            max_iters=0, **cfg)
    ks = r.kernel
    codes = sorted(torch.unique(ks.mask).tolist())
    assert codes[:3] == [0, 1, 2] and codes[-1] >= 3, codes
    f0 = random_feq(r.sim.grid, ks.shape, seed=1234, device=DEVICE)
    fk = ks.run(f0, steps)
    fr = f0
    for _ in range(steps):
        fr = ls.step_reference(fr, ks.mask, ks.table, r.sim.grid,
                               ks.tau_inv)
    util.synchronize(DEVICE)
    assert ks.launches == steps
    wet = (ks.mask == 0) | (ks.mask >= 3)
    err = float((fk - fr)[:, wet].abs().max())
    say(f'compare {name}: {r.sim.grid.name} {ks.shape} {steps} steps, '
        f'mask codes {codes}, wet max|df| = {err:.3e} (tol {TOL:g})')
    assert np.isfinite(err) and err <= TOL, err
    return r.sim.grid.name, err


def golden(scene, sim_cls, **cfg):
    """The kernel engine on the golden harness's small scene (20 steps,
    seed 1234) against tests/goldens at the harness tolerance."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, scene)
        r = run(sim_cls, platform=DEVICE, max_iters=20, every=20,
                seed=1234, output=out, **cfg)
        assert r.engine == 'kernel' and r.kernel.launches == 20
        data = np.load(f'{out}.0.0000020.npz')
        ref = np.load(os.path.join(REPO, 'tests', 'goldens',
                                   f'{scene}.npz'))
        worst = 0.0
        for k in ref.files:
            np.testing.assert_allclose(data[k], ref[k], rtol=1e-5,
                                       atol=5e-7, err_msg=f'{scene}:{k}')
            worst = max(worst, float(np.max(np.abs(data[k] - ref[k]))))
    say(f'golden {scene}: kernel engine matches tests/goldens '
        f'(max |d| = {worst:.3e}; rtol 1e-5, atol 5e-7)')


def copy_bandwidth():
    """Device-to-device copy bandwidth on a 1 GiB tensor, bytes/s
    (read + write)."""
    n = 2 ** 28
    src = torch.ones(n, dtype=torch.float32, device=DEVICE)
    dst = torch.empty_like(src)
    ms = util.cuda_time_ms(lambda: dst.copy_(src), 20, warmup=3)
    return 2 * n * 4 / (ms / 1e3)


def main_path(scene, sim_cls, size, copy_bw, chunk=500, chunks=4):
    """The scene through the controller with the default engine: the
    main path. The kernels' launch counts are zeroed just before the
    controller runs and read just after. MLUPS = median of the chunks
    after the first."""
    cfg = dict(zip(('lat_nx', 'lat_ny', 'lat_nz'), size))
    steps = chunk * chunks
    ls.reset_launch_counts()
    r = run(sim_cls, max_iters=steps, every=chunk, **cfg)
    counts = dict(ls.LAUNCHES)
    assert r.engine == 'kernel', r.engine
    launches = counts[r.kernel.name]
    assert launches == steps == r.sim.iteration == r.kernel.launches, \
        (counts, steps)
    assert sum(counts.values()) == launches, counts
    r._fields_to_host()
    shape = tuple(reversed(size))
    for name, arr in (('rho', r.sim.rho), ('vx', r.sim.vx)):
        assert arr.shape == shape and np.all(np.isfinite(arr)), name
    # wet nodes: no faster than the lid, mass near its initial density
    mask = r.kernel.mask.cpu().numpy()
    wet = (mask == 0) | (mask >= 3)
    assert np.abs(r.sim.vx[wet]).max() <= 1.01 * sim_cls.subdomain.max_v
    assert abs(float(np.mean(r.sim.rho[wet])) - 1.0) < 0.01
    grid = r.sim.grid.name
    mlups = statistics.median(r.mlups_history[1:])
    eff = mlups * 1e6 * BYTES[grid]
    say(f'main path {scene} {"x".join(map(str, size))} ({grid}, engine '
        f'{r.engine}): {launches} launches; MLUPS per {chunk}-step chunk '
        f'{[round(m, 1) for m in r.mlups_history]}; median {mlups:.1f} '
        f'MLUPS; {eff / 1e9:.1f} GB/s effective ({BYTES[grid]} B/node), '
        f'{eff / copy_bw:.3f} of the copy bandwidth')
    # the kernel against its plain version on the main path's own state
    # and shapes (10 steps), then each timed alone on the same tensors
    ks = r.kernel
    f0 = r.f.clone()
    fk = ks.run(f0, 10)
    fr = f0
    for _ in range(10):
        fr = ls.step_reference(fr, ks.mask, ks.table, r.sim.grid,
                               ks.tau_inv)
    wet_t = torch.as_tensor(wet, device=DEVICE)
    err = float((fk - fr)[:, wet_t].abs().max())
    say(f'compare main path {scene}: 10 steps from the state after '
        f'{steps}, wet max|df| = {err:.3e} (tol {TOL:g})')
    assert np.isfinite(err) and err <= TOL, err
    del f0, fk, fr, wet_t
    a, b = ks.a, ks.b
    ms = util.cuda_time_ms(lambda: ks.step_into(a, b), 50, warmup=5)
    plain_ms = util.cuda_time_ms(
        lambda: ls.step_reference(a, ks.mask, ks.table, r.sim.grid,
                                  ks.tau_inv), 5)
    say(f'kernel {ks.name} at {"x".join(map(str, size))}: {ms:.4f} ms per '
        f'launch; step_reference {plain_ms:.3f} ms')
    result = dict(launches=launches, mlups=mlups, ms=ms,
                  plain_ms=plain_ms, err=err)
    del r, ks, a, b
    torch.cuda.empty_cache()
    return grid, result


def plain_path(scene, sim_cls, size, chunk, chunks=4):
    """The same scene on the plain torch engine on the card."""
    cfg = dict(zip(('lat_nx', 'lat_ny', 'lat_nz'), size))
    r = run(sim_cls, engine='torch', max_iters=chunk * chunks,
            every=chunk, **cfg)
    assert r.engine == 'torch' and r.device.type == DEVICE
    assert torch.isfinite(r.f).all()
    mlups = statistics.median(r.mlups_history[1:])
    say(f'plain torch engine {scene} {"x".join(map(str, size))}: MLUPS '
        f'per {chunk}-step chunk {[round(m, 2) for m in r.mlups_history]};'
        f' median {mlups:.2f} MLUPS')
    del r
    torch.cuda.empty_cache()
    return mlups


def main():
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: torch sees no CUDA device')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    say(smi.stdout.strip().splitlines()[0])
    say(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.get_device_name(0)}')

    lib = build.load('lbm_step')
    say(f'build: {lib.path.name} in {lib.seconds:.1f} s (0 = cached)')
    for line in lib.log.splitlines():
        if 'registers' in line or 'spill' in line:
            say('  ptxas:', line.strip())

    errs = {}
    duct = dict(lat_nx=128, lat_ny=64, lat_nz=64)
    for name, sim_cls, cfg in (
            ('ldc_3d', LDC_3D, dict(lat_nx=128, lat_ny=128, lat_nz=128)),
            ('duct_zouhe', channel_sim('zouhe', 'x'), duct),
            ('duct_equilibrium', channel_sim('equilibrium', 'x'), duct),
            ('duct_regularized', channel_sim('regularized', 'x'), duct),
            ('ldc_2d', LDC_2D, dict(lat_nx=1024, lat_ny=1024))):
        grid, err = compare(name, sim_cls, **cfg)
        errs[grid] = max(errs.get(grid, 0.0), err)
    golden('ldc_3d', LDC_3D, lat_nx=16, lat_ny=16, lat_nz=16)
    golden('ldc_2d', LDC_2D, lat_nx=32, lat_ny=32)

    copy_bw = copy_bandwidth()
    say(f'device-to-device copy bandwidth (1 GiB): {copy_bw / 1e9:.1f} GB/s')
    results = {}
    for scene, sim_cls, size in (('ldc_3d', LDC_3D, (256, 256, 256)),
                                 ('ldc_2d', LDC_2D, (4096, 4096))):
        grid, res = main_path(scene, sim_cls, size, copy_bw)
        results[grid] = res
    plain_path('ldc_3d', LDC_3D, (128, 128, 128), chunk=500)
    plain_path('ldc_3d', LDC_3D, (256, 256, 256), chunk=50)
    plain_path('ldc_2d', LDC_2D, (4096, 4096), chunk=100)

    kernels = []
    for grid, (name, replaces) in KERNELS.items():
        res = results[grid]
        assert res['launches'] > 0, name
        kernels.append(dict(name=name, route='cuda', source=SOURCE,
                            replaces=replaces, launches=res['launches'],
                            max_abs_err=max(errs[grid], res['err']),
                            ms=res['ms'],
                            plain_ms=res['plain_ms']))
    say(json.dumps({'kernels': kernels}))
    say(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
