"""A 3D scene sharded along z over several GPUs of one host (``--mesh=N``,
one shard per GPU), against the unsharded run on one GPU: the lid-driven
cavity (``examples/torch/ldc_3d.py``, D3Q19 BGK, ``--scene ldc_3d``, the
default), the binary Shan-Chen separation
(``examples/torch/binary_fluid/sc_separation_3d.py``, D3Q19, K = 2,
``--scene sc_separation_3d``) or the open channel past a sphere
(``tests/torch_scenes.open_channel(3)``: a regularized inlet, a Yu outlet,
a force object on the sphere; ``--scene open_sphere_3d``, 2 ``--size`` x
``--size``² nodes), whose drag series must equal the unsharded run's bit
for bit too.

For N = 2, 4, ... up to the visible GPUs, through
``LBSimulationController.run()`` on the kernel engine:

* strong scaling at ``--size``³ (default 256³): MLUPS over the chunks
  after the first, the final state equal bit for bit to the unsharded
  run's, and the launches of the run (counts zeroed just before, read just
  after): one ghost-mode step launch per shard and step (after one
  ghost-mode pre-pass for the mixture), one ``halo_exchange_d3q19`` launch
  per GPU and step (and one ``halo_rho_exchange_d3q19`` for the mixture),
  nothing else;
* then, on the run's own buffers: ms per step of the exchanges alone
  (each GPU's launch reading its neighbours' planes through peer access,
  with the CUDA events that order it; the mixture's two), and ms per step
  of the shards' launches alone (all GPUs at once, no exchange), both on
  the host clock between synchronizations of every GPU;
* weak scaling: ``--size``² × (N·``--size``) over N GPUs (one
  ``--size``³ slab each), MLUPS per GPU against the unsharded
  ``--size``³ run on one GPU (not for the open channel, whose body grows
  with the domain).

With ``--mesh AxB`` (for example ``2x2``) it runs that ('z', 'y') mesh
over A·B GPUs instead of the z meshes: one shard per GPU, each GPU's edge
exchange (``halo_edge_exchange_d3q19``, and ``halo_rho_edge_exchange_d3q19``
for the mixture) reading its outer, inner and diagonal neighbours; weak
scaling on (A·``--size``) × (B·``--size``) × ``--size``.

Run it from the repository's root on a host with two or more CUDA
devices::

    python tools/mesh_gpus.py [--scene sc_separation_3d] [--size 256]
                              [--steps 300] [--mesh 2x2]

It prints each GPU's name and power limit, a line per measurement, and as
its last line a JSON object with the numbers (also written to
``chiprun_out/mesh_gpus[_<scene>].json``).
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
from sailfish_tpu_torch.ops import fe_step as fe  # noqa: E402
from sailfish_tpu_torch.ops import lbm_step as ls  # noqa: E402
from sailfish_tpu_torch.ops import sc_multi as sm  # noqa: E402
from sailfish_tpu_torch.parallel import halo  # noqa: E402
from sailfish_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from torch_scenes import binary_twin, open_channel, run, twin  # noqa: E402

#: --scene -> (sim class factory, the csrc sources its kernels need, the
#: domain's x extent in units of --size)
SCENES = {
    'ldc_3d': (lambda: twin('ldc_3d'), ['lbm_step', 'halo'], 1),
    'sc_separation_3d': (lambda: binary_twin('sc_separation_3d'),
                         ['sc_multi', 'halo'], 1),
    'open_sphere_3d': (lambda: open_channel(3),
                       [ls.OUTFLOW_LIBRARY, 'halo'], 2),
}


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


def scene_run(scene, n, size, z, steps, chunk, mesh=None, y=None):
    """``scene`` at ``size`` × ``y`` (default ``size``) × ``z`` nodes
    through the controller, over a z mesh of the first ``n`` GPUs (or the
    mesh ``mesh`` over them; ``n`` = 0: no mesh, on cuda:0); returns
    (runner, MLUPS, kernel and exchange launches of the run)."""
    cfg = dict(lat_nx=SCENES[scene][2] * size, lat_ny=y or size, lat_nz=z,
               max_iters=steps, every=chunk, seed=1)
    for counts in (ls.LAUNCHES, sm.LAUNCHES, fe.LAUNCHES):
        for k in counts:
            counts[k] = 0
    halo.reset_launch_counts()
    make = SCENES[scene][0]
    if n == 0:
        r = run(make(), **cfg)
    else:
        with pmesh.devices_override([f'cuda:{i}' for i in range(n)]):
            r = run(make(), mesh=mesh or str(n), **cfg)
    synchronize([f'cuda:{i}' for i in range(max(n, 1))])
    launches = ({k: v for counts in (ls.LAUNCHES, sm.LAUNCHES, fe.LAUNCHES)
                 for k, v in counts.items()}, dict(halo.LAUNCHES))
    return r, statistics.median(r.mlups_history[1:]), launches


def leaves(f):
    return (f,) if torch.is_tensor(f) else tuple(f)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--scene', choices=sorted(SCENES), default='ldc_3d')
    ap.add_argument('--size', type=int, default=256)
    ap.add_argument('--steps', type=int, default=300)
    ap.add_argument('--chunk', type=int, default=100)
    ap.add_argument('--mesh', default=None,
                    help="a ('z', 'y') mesh, AxB, instead of the z meshes")
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
    scene = args.scene
    build.load_all(SCENES[scene][1])
    size, steps, chunk = args.size, args.steps, args.chunk
    nx = SCENES[scene][2] * size
    nodes = nx * size ** 2
    ref, ref_mlups, _ = scene_run(scene, 0, size, size, steps, chunk)
    ref_f = tuple(f.clone() for f in leaves(ref.f))
    ref_drag = [(it, tuple(F)) for it, F in getattr(ref.sim, 'drag', [])]
    del ref
    torch.cuda.empty_cache()
    print(f'{scene} unsharded {nx}x{size}x{size} on cuda:0: '
          f'{ref_mlups:.1f} MLUPS, {nodes / ref_mlups / 1e3:.4f} ms per '
          f'step' + (f'; drag {ref_drag}' if ref_drag else ''), flush=True)
    out = dict(scene=scene, size=size, steps=steps, mesh=args.mesh,
               unsharded_mlups=ref_mlups,
               gpus=smi.stdout.strip().splitlines(), strong={}, weak={})
    if args.mesh:
        a, b = (int(c) for c in args.mesh.split('x'))
        layouts = [(a * b, args.mesh, a, b)]
        if a * b > count:
            sys.exit(f'mesh_gpus: --mesh {args.mesh} needs {a * b} GPUs')
    else:
        layouts = [(k, None, k, 1) for k in (2, 4, 8) if k <= count]
    for n, mesh, za, yb in layouts:
        devices = [f'cuda:{i}' for i in range(n)]
        r, mlups, (counts, xcounts) = scene_run(scene, n, size, size, steps,
                                                chunk, mesh)
        stp = r.stepper
        multi = hasattr(stp, 'K')
        same = all(torch.equal(a, b) for a, b in zip(leaves(r.f), ref_f))
        drag = [(it, tuple(F)) for it, F in getattr(r.sim, 'drag', [])]
        same_drag = drag == ref_drag
        assert [ks.a.device.index for ks in stp.kernels] == list(range(n))
        ks0 = stp.kernels[0]
        names = [ks0.rho_name, ks0.name] if multi else [ks0.name]
        for name in names:
            assert counts[name] == n * steps, (name, counts)
        assert sum(counts.values()) == len(names) * n * steps, counts
        xnames = [stp.name] + ([stp.rho_name] if multi else [])
        for name in xnames:
            assert xcounts[name] == n * steps, (name, xcounts)
        assert sum(xcounts.values()) == len(xnames) * n * steps, xcounts
        bufs = [ks.a for ks in stp.kernels]
        if multi:
            rhos = [ks.rho for ks in stp.kernels]

            def exchanges():
                stp.density_exchange(rhos)
                stp.exchange_buffers(bufs)

            def launches_only():
                for ks in stp.kernels:
                    with torch.cuda.device(ks.a.device):
                        ks.density_into(ks.a, ks.rho)
                        ks.collide_into(ks.a, ks.rho, ks.b)
        else:
            def exchanges():
                stp.exchange(bufs)

            def launches_only():
                for ks in stp.kernels:
                    with torch.cuda.device(ks.a.device):
                        ks.step_into(ks.a, ks.b)

        x_ms = host_ms(exchanges, 500, devices)
        launch_ms = host_ms(launches_only, 100, devices)
        step_ms = nodes / mlups / 1e3
        print(f'{scene} {nx}x{size}x{size} over {n} GPUs (mesh '
              f'{mesh or n}, a shard {tuple(ks0.shape)} each): '
              f'{mlups:.1f} MLUPS ({mlups / ref_mlups:.3f}x one GPU, '
              f'{mlups / ref_mlups / n:.3f} parallel efficiency), '
              f'{step_ms:.4f} ms per step; the final state equal to the '
              f'unsharded run\'s bit for bit: {same}'
              + (f'; the drag series too: {same_drag}' if ref_drag else '')
              + f'; {", ".join(f"{n * steps} {x}" for x in names + xnames)}'
              f' launches; the exchanges alone {x_ms:.5f} ms, the shards\' '
              f'launches alone {launch_ms:.4f} ms per step', flush=True)
        assert same and same_drag
        out['strong'][mesh or n] = dict(mlups=mlups, step_ms=step_ms,
                                        exchange_ms=x_ms,
                                        launches_ms=launch_ms, bitwise=same,
                                        drag_bitwise=same_drag)
        del r, stp, bufs, ks0
        torch.cuda.empty_cache()
        if SCENES[scene][2] != 1:
            continue
        r, mlups, _ = scene_run(scene, n, size, za * size, steps, chunk,
                                mesh, yb * size)
        print(f'{scene} {size} x {yb * size} x {za * size} over {n} GPUs '
              f'(mesh {mesh or n}, {size}^3 each): {mlups:.1f} MLUPS, '
              f'{mlups / n:.1f} per GPU ({mlups / n / ref_mlups:.3f} of one '
              f'GPU\'s {size}^3)', flush=True)
        out['weak'][mesh or n] = dict(mlups=mlups, per_gpu=mlups / n)
        del r
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    tag = ('' if scene == 'ldc_3d' else f'_{scene}') + \
        (f'_{args.mesh}' if args.mesh else '')
    with open(os.path.join(REPO, 'chiprun_out', f'mesh_gpus{tag}.json'),
              'w') as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
