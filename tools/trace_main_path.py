#!/usr/bin/env python3
"""Device-idle share of the port's main loop, read from a profiler trace.

    python3 tools/trace_main_path.py [--chunk 500] [--scenes ldc_3d,...]
                                     [--out DIR]

Needs one CUDA GPU. For the lid-driven cavities, the force-driven flows
past a sphere and a cylinder (Guo forcing inside the kernel), the
half-way duct (``duct_flow``), the pipe with time-dependent densities
(``womersley``), the ramped SpatialArray inlet (``poiseuille_sa``, whose
parameter block is rewritten by small PyTorch launches every step), the
collision-model paths (``ldc_3d_mrt``, ``sphere_3d_les``,
``cylinder_mrt``), the
parabolic-inlet
channels (``tests/torch_scenes``: one ``lbm_step`` launch each step, its BC
nodes reading per-node parameters; the inlet normal to z / y or to x), the
binary
Shan-Chen separations, the forced Rayleigh-Taylor mixture, the ternary
drops and the ternary 3D separation, the single-component Shan-Chen
separations (``sc_phase_separation_3d`` / ``sc_phase_separation``: the
pre-pass and the stream-and-collide kernel's Shan-Chen mode), the
shallow-water hump (``fs_gaussian``), the cavities under
``--precision=mixed`` (``ldc_3d_mixed`` / ``ldc_2d_mixed``: int16 state
buffers), the entropic cavities (``ldc_2d_entropic``, also
``_mixed``, and ``ldc_3d_elbm``: the ELBM mode), and the binary free-energy
separations of ``examples/torch`` at the benchmark sizes (D3Q19 256^3,
D2Q9 4096^2), the Kida vortex (D3Q15 256^3, its KE / enstrophy device
hook every 20 steps: the hook's kernels count as other kernels),
``bench.py``'s cavity on D3Q27 (``ldc_3d_d3q27``) and the turbulent
channel at its published settings (``channel_flow``, its Reynolds
statistics hook every 20 steps from iteration 250), and the outflow
family's open channels (``open_sphere_3d`` 512x256x256, a Yu outlet;
``open_cylinder_2d`` 8192x2048, a copy outlet; each with its force object
sampled after the chunk) and laminarize channel (``laminarize_channel_2d``
8192x2048: its plane-mean pre-pass and the step), and the cavity sharded
over a one-shard mesh (``ldc_3d_zmesh1``, ``--mesh=1``: each step the
ghost-plane step and the ``halo_exchange`` launch, whose share of the
chunk the kernel means show), and the immersed-boundary channel
(``ibm_cylinder`` 4096x2048 with 1,600 markers on the torch engine, which
the kernels refuse: every kernel is PyTorch's, counted as other kernels)
it
runs the controller
with the default (kernel) engine for one chunk (kernel build, warm-up),
then traces one more chunk of ``SubdomainRunner.main`` with
``torch.profiler`` (CPU and CUDA activities) and reads the exported
Chrome trace:

* ``window``: the ``main`` chunk on the host, a ``record_function`` span;
* ``busy``: the union of the device's kernel, memcpy and memset intervals
  inside the window;
* ``idle share`` = 1 - busy / window; ``gaps`` = the idle time between the
  first kernel's start and the last one's end; the mean duration of each
  of the port's kernels in the trace, and the number of kernels per step
  (1 for the single-fluid scenes, channels included; 2 for the mixtures
  and the single-component Shan-Chen scenes);
  ``other kernels``: the device kernels in the window that are not the
  port's (PyTorch's own, such as a parameter-block rewrite), per step.

Prints one line per scene and a JSON line; the traces are written to
``DIR`` (default ``chiprun_out/traces``).
"""

import argparse
import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tests'))
from torch_scenes import (binary_twin, channel_sim,  # noqa: E402
                          channel_sim_2d, open_channel, outflow_channel, run,
                          ternary_separation, ternary_twin, turbulence_twin,
                          twin)
from sailfish_tpu_torch.parallel import halo  # noqa: E402


def channel(scene):
    """The regularized parabolic-inlet channel of ``scene``."""
    along_x = '_x_' in scene
    if scene.endswith('3d'):
        return channel_sim('regularized', 'x' if along_x else 'z',
                           profile='parabolic')
    return channel_sim_2d('regularized', axis='x' if along_x else 'y')


#: scene -> (sim class loader, size, extra flags)
SCENES = {
    'ldc_3d': (twin, (256, 256, 256), {}),
    'ldc_2d': (twin, (4096, 4096), {}),
    'sphere_3d': (twin, (256, 256, 256), {}),
    'cylinder': (twin, (4096, 4096), {}),
    'duct_flow': (twin, (256, 256, 256), {}),
    'womersley': (twin, (256, 256, 256), {}),
    'poiseuille_sa': (twin, (4096, 4096), {'velocity': 'spatial_array'}),
    'parabolic_inlet_3d': (channel, (256, 256, 256), {'periodic_x': True}),
    'parabolic_inlet_2d': (channel, (4096, 4096), {}),
    'parabolic_inlet_x_3d': (channel, (256, 256, 256), {'periodic_z': True}),
    'parabolic_inlet_x_2d': (channel, (4096, 4096), {}),
    'sc_separation_3d': (binary_twin, (256, 256, 256), {}),
    'sc_separation_2d': (binary_twin, (4096, 4096), {}),
    # the forced and K = 3 modes of the mixture step
    'sc_rayleigh_taylor_2d': (binary_twin, (4096, 4096), {}),
    'ternary_sc_drop_2d': (lambda s: ternary_twin('sc_drop_2d'),
                           (4096, 4096), {}),
    'ternary_separation_3d': (lambda s: ternary_separation(3),
                              (256, 256, 256), {}),
    'fe_separation_3d': (binary_twin, (256, 256, 256), {}),
    'fe_separation_2d': (binary_twin, (4096, 4096), {}),
    # the collision-model mode: the MRT cavity, the sphere under the
    # Smagorinsky model and the cylinder under MRT (both with Guo)
    'ldc_3d_mrt': (lambda s: twin('ldc_3d'), (256, 256, 256),
                   {'model': 'mrt'}),
    'sphere_3d_les': (lambda s: twin('sphere_3d'), (256, 256, 256),
                      {'subgrid': 'les-smagorinsky'}),
    'cylinder_mrt': (lambda s: twin('cylinder'), (4096, 4096),
                     {'model': 'mrt'}),
    # single-component Shan-Chen (pre-pass + the sc mode) and shallow water
    'sc_phase_separation_3d': (twin, (256, 256, 256), {}),
    'sc_phase_separation': (twin, (4096, 4096), {}),
    'fs_gaussian': (twin, (4096, 4096), {}),
    # --precision=mixed: the cavities on int16 buffers (the chunk's
    # whole-state conversions are PyTorch kernels: "other kernels")
    'ldc_3d_mixed': (lambda s: twin('ldc_3d'), (256, 256, 256),
                     {'precision': 'mixed'}),
    'ldc_2d_mixed': (lambda s: twin('ldc_2d'), (4096, 4096),
                     {'precision': 'mixed'}),
    # the entropic collision: the example's cavity (lid 0.01, nu = 1e-4),
    # also on int16 buffers, and bench.py's cavity under --model=elbm
    'ldc_2d_entropic': (twin, (4096, 4096), {}),
    'ldc_2d_entropic_mixed': (lambda s: twin('ldc_2d_entropic'),
                              (4096, 4096), {'precision': 'mixed'}),
    'ldc_3d_elbm': (lambda s: twin('ldc_3d'), (256, 256, 256),
                    {'model': 'elbm'}),
    # D3Q15 with a device hook (KE and enstrophy every 20 steps), D3Q27,
    # and the channel at its published settings (240 x 82 x 80) with its
    # Reynolds statistics hook every 20 steps
    'kida_vortex_256': (lambda s: turbulence_twin('kida_vortex'),
                        (256, 256, 256), {'stats_every': 20}),
    'ldc_3d_d3q27': (lambda s: twin('ldc_3d'), (256, 256, 256),
                     {'grid': 'D3Q27'}),
    'channel_flow': (turbulence_twin, (240, 82, 80),
                     {'H': 40, 'Re_tau': 180, 'wall': 'hbb'}),
    # the outflow family: open channels past a sphere and a cylinder with
    # their force objects, and the laminarize channel
    'open_sphere_3d': (lambda s: open_channel(3), (512, 256, 256), {}),
    'open_cylinder_2d': (lambda s: open_channel(2), (8192, 2048), {}),
    'laminarize_channel_2d': (
        lambda s: outflow_channel('NTLaminarize', 2, 'x'), (8192, 2048), {}),
    # --mesh=1: the step over the shard and its ghost planes, then the
    # ghost-plane exchange
    'ldc_3d_zmesh1': (lambda s: twin('ldc_3d'), (256, 256, 256),
                      {'mesh': '1'}),
    # the immersed-boundary channel on the torch engine (the kernels
    # refuse it): its PyTorch kernels per step
    'ibm_cylinder': (twin, (4096, 2048),
                     {'engine': 'torch', 'radius': 256, 'n_markers': 1600}),
}
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
#: the port's kernels, by their CUDA function names
PORT_KERNELS = ('lbm_step_kernel', 'rho_poststream_kernel',
                'sc_multi_kernel', 'sc3_kernel', 'fe_step_kernel',
                'fe3_kernel', 'laminarize_mean_kernel',
                'halo_exchange_kernel')


def total_launches(kernel):
    """All launches of a kernel engine (an int, or a dict by name; a
    single-fluid engine's pre-pass launches apart), and of the ghost-plane
    exchange (``halo.LAUNCHES``)."""
    n = kernel.launches
    n = sum(n.values()) if isinstance(n, dict) else n
    return n + getattr(kernel, 'prepass_launches', 0) \
        + sum(halo.LAUNCHES.values())


def union_length(intervals):
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def trace_chunk(scene, chunk, out_dir):
    load, size, extra = SCENES[scene]
    cfg = dict(zip(('lat_nx', 'lat_ny', 'lat_nz'), size), **extra)
    r = run(load(scene), max_iters=chunk, every=chunk, **cfg)
    assert r.engine == extra.get('engine', 'kernel'), r.engine
    res = trace_runner_chunk(r, scene, chunk, out_dir)
    res.update(size=list(size))
    del r
    torch.cuda.empty_cache()
    return res


def trace_runner_chunk(r, scene, chunk, out_dir):
    """One more ``chunk``-step chunk of the runner ``r``'s ``main`` (after
    its run: kernels built and warm) under ``torch.profiler``, the Chrome
    trace written into ``out_dir`` and read by ``read_trace``. On the
    torch engine (no ``r.kernel``) every kernel is PyTorch's: ``other
    kernels`` per step is then the step's kernel count."""
    r.config.max_iters += chunk
    port = r.kernel is not None
    launches0 = total_launches(r.kernel) if port else 0
    with torch.no_grad(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function('main_chunk'):
            t0 = time.perf_counter()
            r.main()
            host_s = time.perf_counter() - t0
    launched = total_launches(r.kernel) - launches0 if port else 0
    assert launched % chunk == 0, launched
    path = os.path.join(out_dir, f'{scene}_main_chunk.json')
    prof.export_chrome_trace(path)
    res = read_trace(path, scene, port)
    # the profiler may drop an event at an edge of its window
    assert abs(res['kernels'] - launched) <= 0.01 * launched, \
        (res['kernels'], launched)
    res.update(chunk=chunk, launched=launched,
               kernels_per_step=launched // chunk,
               other_kernels_per_step=res['other_kernels'] / chunk,
               host_s=host_s, trace=os.path.relpath(path, REPO))
    return res


def read_trace(path, scene, port=True):
    """Idle share, gaps and per-kernel mean durations (us) of the
    ``main_chunk`` window of an exported Chrome trace; with ``port``
    False (the torch engine) the gaps are those between PyTorch's
    kernels and no kernel of the port is looked for."""
    with open(path) as fh:
        events = json.load(fh)['traceEvents']
    wins = [e for e in events if e.get('name') == 'main_chunk'
            and e.get('ph') == 'X' and e.get('cat') == 'user_annotation']
    if len(wins) != 1:
        raise RuntimeError(f'{scene}: {len(wins)} main_chunk spans in the '
                           'trace')
    win = wins[0]
    w0, w1 = win['ts'], win['ts'] + win['dur']
    dev = [(max(e['ts'], w0), min(e['ts'] + e['dur'], w1)) for e in events
           if e.get('cat') in DEVICE_CATS and e.get('ph') == 'X'
           and e['ts'] < w1 and e['ts'] + e['dur'] > w0]
    kernels = [e for e in events if e.get('cat') == 'kernel'
               and any(k in e.get('name', '') for k in PORT_KERNELS)]
    others = [e for e in events if e.get('cat') == 'kernel'
              and w0 <= e['ts'] < w1
              and not any(k in e.get('name', '') for k in PORT_KERNELS)]
    by_name = {}
    for e in kernels:
        name = next(k for k in PORT_KERNELS if k in e['name'])
        by_name.setdefault(name, []).append(e['dur'])
    # the kernels whose gaps are measured
    timed = kernels if port else others
    if not timed:
        raise RuntimeError(f'{scene}: the trace holds none of the port\'s '
                           'kernels' if port else f'{scene}: no kernel')
    busy = union_length(dev)
    k0 = min(e['ts'] for e in timed)
    k1 = max(e['ts'] + e['dur'] for e in timed)
    return dict(scene=scene, kernels=len(kernels), other_kernels=len(others),
                window_us=win['dur'],
                busy_us=busy, idle_share=1.0 - busy / win['dur'],
                gaps_us=(k1 - k0) - union_length(
                    [(e['ts'], e['ts'] + e['dur']) for e in timed]),
                kernel_mean_us={k: sum(v) / len(v)
                                for k, v in by_name.items()})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--chunk', type=int, default=500)
    ap.add_argument('--scenes', default=','.join(SCENES),
                    help='comma-separated, of ' + ', '.join(SCENES))
    ap.add_argument('--out', default=os.path.join(REPO, 'chiprun_out',
                                                  'traces'))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('trace_main_path: torch sees no CUDA device')
    os.makedirs(args.out, exist_ok=True)
    results = []
    for scene in args.scenes.split(','):
        res = trace_chunk(scene, args.chunk, args.out)
        means = ', '.join(f'{k} {v:.2f} us'
                          for k, v in res['kernel_mean_us'].items())
        print(f'{scene} {"x".join(map(str, res["size"]))}: {res["kernels"]} '
              f'kernels in the trace ({res["launched"]} launched, '
              f'{res["kernels_per_step"]} per step; other kernels '
              f'{res["other_kernels_per_step"]:.2f} per step), mean '
              f'{means}; window '
              f'{res["window_us"]:.1f} us, device busy {res["busy_us"]:.1f} '
              f'us, idle share {res["idle_share"]:.5f}; gaps between the '
              f'first and last kernel {res["gaps_us"]:.1f} us', flush=True)
        results.append(res)
    print(json.dumps({'device': torch.cuda.get_device_name(0),
                      'trace_main_path': results}))


if __name__ == '__main__':
    main()
