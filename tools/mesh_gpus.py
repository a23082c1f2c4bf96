"""The lid-driven cavity (``examples/torch/ldc_3d.py``, D3Q19 BGK) sharded
along z over several GPUs of one host (``--mesh=N``, one shard per GPU),
against the unsharded run on one GPU.

For N = 2, 4, ... up to the visible GPUs, through
``LBSimulationController.run()`` on the kernel engine:

* strong scaling at ``--size``³ (default 256³): MLUPS over the chunks
  after the first, the final state equal bit for bit to the unsharded
  run's, and the launches of the run (counts zeroed just before, read just
  after): one ``lbm_step_ghost_d3q19`` launch per shard and step, one
  ``halo_exchange_d3q19`` launch per GPU and step, nothing else;
* then, on the run's own buffers: ms per exchange alone (``ShardedStep.
  exchange``: each GPU's launch reading its neighbours' planes through
  peer access, with the CUDA events that order it), and ms per step of the
  shards' step launches alone (all GPUs at once, no exchange), both on the
  host clock between synchronizations of every GPU;
* weak scaling: ``--size``² × (N·``--size``) over N GPUs (one
  ``--size``³ slab each), MLUPS per GPU against the unsharded
  ``--size``³ run on one GPU.

Run it from the repository's root on a host with two or more CUDA
devices::

    python tools/mesh_gpus.py [--size 256] [--steps 300]

It prints each GPU's name and power limit, a line per measurement, and as
its last line a JSON object with the numbers (also written to
``chiprun_out/mesh_gpus.json``).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tests'))
from sailfish_tpu_torch.ops import build  # noqa: E402
from sailfish_tpu_torch.ops import lbm_step as ls  # noqa: E402
from sailfish_tpu_torch.parallel import halo  # noqa: E402
from sailfish_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from torch_scenes import run, twin  # noqa: E402


def synchronize(devices):
    for d in devices:
        torch.cuda.synchronize(d)


def host_ms(fn, iters, devices, warmup=5):
    """Milliseconds per call of ``fn()`` over ``iters`` calls, host clock
    between synchronizations of every device of ``devices``."""
    for _ in range(warmup):
        fn()
    synchronize(devices)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    synchronize(devices)
    return (time.perf_counter() - t0) / iters * 1e3


def cavity(n, size, z, steps, chunk):
    """The cavity of ``size`` × ``size`` × ``z`` nodes through the
    controller, over a z mesh of the first ``n`` GPUs (``n`` = 0: no
    mesh, on cuda:0); returns (runner, MLUPS, step and exchange launches
    of the run)."""
    cfg = dict(lat_nx=size, lat_ny=size, lat_nz=z, max_iters=steps,
               every=chunk)
    ls.reset_launch_counts()
    halo.reset_launch_counts()
    if n == 0:
        r = run(twin('ldc_3d'), **cfg)
    else:
        with pmesh.devices_override([f'cuda:{i}' for i in range(n)]):
            r = run(twin('ldc_3d'), mesh=str(n), **cfg)
    synchronize([f'cuda:{i}' for i in range(max(n, 1))])
    launches = (dict(ls.LAUNCHES), dict(halo.LAUNCHES))
    return r, statistics.median(r.mlups_history[1:]), launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--size', type=int, default=256)
    ap.add_argument('--steps', type=int, default=300)
    ap.add_argument('--chunk', type=int, default=100)
    args = ap.parse_args()
    count = torch.cuda.device_count()
    if count < 2:
        sys.exit('mesh_gpus: needs two or more CUDA devices')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, {count} '
          f'GPUs', flush=True)
    build.load_all(['lbm_step', 'halo'])
    size, steps, chunk = args.size, args.steps, args.chunk
    nodes = size ** 3
    ref, ref_mlups, _ = cavity(0, size, size, steps, chunk)
    ref_f = ref.f.clone()
    del ref
    torch.cuda.empty_cache()
    print(f'unsharded {size}^3 on cuda:0: {ref_mlups:.1f} MLUPS, '
          f'{nodes / ref_mlups / 1e3:.4f} ms per step', flush=True)
    out = dict(size=size, steps=steps, unsharded_mlups=ref_mlups,
               gpus=smi.stdout.strip().splitlines(), strong={}, weak={})
    shard_counts = [k for k in (2, 4, 8) if k <= count]
    for n in shard_counts:
        devices = [f'cuda:{i}' for i in range(n)]
        r, mlups, (counts, xcounts) = cavity(n, size, size, steps, chunk)
        stp = r.stepper
        same = torch.equal(r.f, ref_f)
        assert [ks.a.device.index for ks in stp.kernels] == list(range(n))
        assert counts['lbm_step_ghost_d3q19'] == n * steps \
            == sum(counts.values()), counts
        assert xcounts['halo_exchange_d3q19'] == n * steps \
            == sum(xcounts.values()), xcounts
        parts = [ks.a for ks in stp.kernels]
        x_ms = host_ms(lambda: stp.exchange(parts), 500, devices)

        def launches_only():
            for ks in stp.kernels:
                with torch.cuda.device(ks.a.device):
                    ks.step_into(ks.a, ks.b)

        launch_ms = host_ms(launches_only, 100, devices)
        step_ms = nodes / mlups / 1e3
        print(f'{size}^3 over {n} GPUs (a shard {tuple(stp.kernels[0].shape)}'
              f' each): {mlups:.1f} MLUPS ({mlups / ref_mlups:.3f}x one GPU,'
              f' {mlups / ref_mlups / n:.3f} parallel efficiency), '
              f'{step_ms:.4f} ms per step; the final state equal to the '
              f'unsharded run\'s bit for bit: {same}; {n * steps} '
              f'lbm_step_ghost_d3q19 and {n * steps} halo_exchange_d3q19 '
              f'launches; exchange alone {x_ms:.5f} ms, the shards\' step '
              f'launches alone {launch_ms:.4f} ms per step', flush=True)
        assert same, float((r.f - ref_f).abs().max())
        out['strong'][n] = dict(mlups=mlups, step_ms=step_ms,
                                exchange_ms=x_ms, launches_ms=launch_ms,
                                bitwise=same)
        del r, stp, parts
        torch.cuda.empty_cache()
        r, mlups, _ = cavity(n, size, n * size, steps, chunk)
        print(f'{size}^2 x {n * size} over {n} GPUs ({size}^3 each): '
              f'{mlups:.1f} MLUPS, {mlups / n:.1f} per GPU '
              f'({mlups / n / ref_mlups:.3f} of one GPU\'s {size}^3)',
              flush=True)
        out['weak'][n] = dict(mlups=mlups, per_gpu=mlups / n)
        del r
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(REPO, 'chiprun_out', 'mesh_gpus.json'), 'w') as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
