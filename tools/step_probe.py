#!/usr/bin/env python3
"""Time of one step on the kernel engine, scene by scene, and the same for
another checkout of the repository in the same run.

    python3 tools/step_probe.py [--iters 200] [--scenes ldc_3d,...]
                                [--baseline DIR] [--diff-steps 200]

Needs one CUDA GPU. For each scene (D3Q19 256^3, D2Q9 4096^2, fp32) it
sets the scene up on the kernel engine (``KernelStep``), runs 100 steps
from the initial state, then times ``KernelStep.step_into`` -- a whole
step, every launch it makes -- with CUDA events over ``--iters`` steps
after 5 warm-up steps, and counts the kernel launches of one step:

* ``ldc_3d`` / ``ldc_2d``: the lid-driven cavities (uniform BCs);
* ``parabolic_inlet_3d`` / ``_2d``: regularized velocity inlet with the
  plane-Poiseuille profile at z = 0 / y = 0, density outlet;
  ``parabolic_inlet_x_3d`` / ``_x_2d``: the same channels flowing along x;
* ``uniform_inlet_*``: the four channels with a uniform inlet velocity;
* ``sphere_3d`` / ``cylinder``: the force-driven flows past a sphere and a
  cylinder (a constant body force, Guo forcing: the kernel's forcing
  mode), and ``sphere_3d_unforced`` / ``cylinder_unforced``: the same
  geometries without the force, so the forced step is timed beside the
  unforced one;
* the collision-model mode, a scene with a suffix: ``_mrt`` (``--model=mrt``),
  ``_les`` (``--subgrid=les-smagorinsky``), ``_incomp``
  (``--incompressible``): ``ldc_3d_mrt``, ``ldc_3d_les``,
  ``ldc_3d_incomp``, ``ldc_2d_mrt``, ``sphere_3d_les`` and
  ``cylinder_mrt``. A tree without the mode refuses them;
* the ELBM mode (``--model=elbm``), in fp32 and on int16 state
  (``--precision=mixed``, ``--mixed_range=0.5``): the entropic cavity
  ``ldc_2d_entropic`` / ``ldc_2d_entropic_mixed`` and ``bench.py``'s cavity
  ``ldc_3d_elbm`` / ``ldc_3d_elbm_mixed``, from ``smooth_feq`` at
  amplitude 1e-2 (every colliding node starts on the series branch of the
  entropic alpha, as all but 0.03-1 % of the main paths' nodes are). They
  are not in the default list: pass them with ``--scenes`` (``ELBM``);
* the Shan-Chen mixtures (``SCMultiStep``: the density pre-pass and the
  step, two launches a step), timed from a seeded near-uniform K-component
  state: the binary separations ``sc_separation_3d`` / ``sc_separation_2d``
  (K = 2), ``ternary_separation_3d`` (K = 3), and
  ``sc_separation_3d_forced`` / ``ternary_separation_3d_forced`` with a
  constant acceleration on every component (``ACCELS``, those of the
  forced mixture paths of ``chip_smoke.py``): every instantiation of the
  D3Q19 step. They are not in the default list: pass them with
  ``--scenes``.

With ``--baseline DIR``, DIR holds another checkout (for example
``git archive <commit> | tar -x -C build/parent``): every scene is timed in
a process of its own per tree, in the order baseline, this tree, this tree,
baseline, each building its own kernels. A scene a tree cannot set up
(an older tree refuses a body force, or has no twin of the scene) is
reported with the reason instead of a time. Each process also runs every scene at a quarter
of the size per axis (64^3, 1024^2) for ``--diff-steps`` steps from one
seeded state and keeps the result under ``build/probe_states``; the largest
|difference| between the two trees' states, and between the two runs of
this tree, is reported per scene (the files are removed at the end). Prints
one line per timing, the card's name and power limit, and a JSON line.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENES = ('ldc_3d', 'ldc_2d', 'parabolic_inlet_3d', 'parabolic_inlet_2d',
          'uniform_inlet_3d', 'uniform_inlet_2d',
          'parabolic_inlet_x_3d', 'parabolic_inlet_x_2d',
          'uniform_inlet_x_3d', 'uniform_inlet_x_2d',
          'sphere_3d', 'sphere_3d_unforced', 'cylinder', 'cylinder_unforced',
          'ldc_3d_mrt', 'ldc_3d_les', 'ldc_3d_incomp', 'ldc_2d_mrt',
          'sphere_3d_les', 'cylinder_mrt')
#: scene suffix -> the collision model's flags
COLLISION = {'_mrt': dict(model='mrt'),
             '_les': dict(subgrid='les-smagorinsky'),
             '_incomp': dict(incompressible=True)}
#: the force-driven scenes -> dimensions
FORCED = {'sphere_3d': 3, 'cylinder': 2}
#: the Shan-Chen scenes (``--scenes`` only)
MIXTURES = ('sc_separation_3d', 'sc_separation_2d', 'ternary_separation_3d',
            'sc_separation_3d_forced', 'ternary_separation_3d_forced')
#: the ELBM scenes (``--scenes`` only) -> (twin, flags)
ELBM = {'ldc_2d_entropic': ('ldc_2d_entropic', {}),
        'ldc_2d_entropic_mixed': ('ldc_2d_entropic', dict(
            precision='mixed', mixed_range=0.5)),
        'ldc_3d_elbm': ('ldc_3d', dict(model='elbm')),
        'ldc_3d_elbm_mixed': ('ldc_3d', dict(
            model='elbm', precision='mixed', mixed_range=0.5))}
#: the amplitude of the ELBM scenes' smooth start (``smooth_feq``)
ELBM_AMP = 1e-2
SIZES = {3: (256, 256, 256), 2: (4096, 4096)}


def scene_setup(scene, ts):
    """(sim class, config flags) of ``scene`` from the tree's
    ``torch_scenes`` module ``ts``."""
    for suffix, flags in COLLISION.items():
        if scene.endswith(suffix):
            sim_cls, cfg = scene_setup(scene[:-len(suffix)], ts)
            return sim_cls, dict(cfg, **flags)
    base = scene.replace('_unforced', '')
    dim = FORCED.get(base) or (3 if '3d' in scene else 2)
    cfg = dict(zip(('lat_nx', 'lat_ny', 'lat_nz'), SIZES[dim]))
    if scene in MIXTURES:
        return mixture(ts, scene), cfg
    if scene in ELBM:
        base, flags = ELBM[scene]
        return ts.twin(base), dict(cfg, **flags)
    if base in FORCED:
        sim_cls = ts.twin(base)
        return (sim_cls if base == scene else ts.unforced(sim_cls)), cfg
    if scene.startswith('ldc'):
        return ts.twin(f'ldc_{dim}d'), cfg
    profile = 'parabolic' if scene.startswith('parabolic') else None
    along_x = '_x_' in scene
    if dim == 3:
        cfg['periodic_z' if along_x else 'periodic_x'] = True
        return ts.channel_sim('regularized', 'x' if along_x else 'z',
                              profile=profile), cfg
    if along_x:
        return ts.channel_sim_2d('regularized', profile=profile,
                                 axis='x'), cfg
    return ts.channel_sim_2d('regularized', profile=profile), cfg


def mixture(ts, scene):
    """The sim class of the Shan-Chen scene ``scene`` from the tree's
    ``torch_scenes`` module ``ts``; a ``_forced`` scene takes ``ACCELS``,
    the accelerations of chip_smoke.py's forced mixture paths
    (``MIX_ACCELS`` / 1000)."""
    base = scene.replace('_forced', '')
    sim = (ts.ternary_separation(3) if base == 'ternary_separation_3d'
           else ts.binary_twin(base))
    if base == scene:
        return sim
    accels = tuple(tuple(1e-3 * c for c in a) for a in ts.MIX_ACCELS)
    return ts.forced_mixture(sim, accels)


def seeded_state(ts, scene, ks, seed):
    """A seeded start for ``scene``'s kernel engine ``ks``: a random
    equilibrium (single fluid), a near-uniform K-component state or, for
    an ELBM scene, ``smooth_feq`` (quantized on int16 state), in ``ks.a``;
    returns what ``ks.run`` takes."""
    if scene in MIXTURES:
        ks.a.copy_(ts.random_binary_state(ks.grid, ks.shape, seed, 'cuda',
                                          K=ks.K))
        return tuple(ks.a.unbind(0))
    if scene in ELBM:
        f = ts.smooth_feq(ks.grid, ks.shape, seed, 'cuda', amp=ELBM_AMP)
        return ks.a.copy_(f if ks.mixed is None else ks.mixed.quant(f))
    return ks.a.copy_(ts.random_feq(ks.grid, ks.shape, seed, 'cuda'))


def small_state(ts, scene, steps):
    """The state of ``scene`` at a quarter of its size per axis after
    ``steps`` kernel steps from a seeded state, as a CPU tensor."""
    import torch
    sim_cls, cfg = scene_setup(scene, ts)
    cfg = {k: v // 4 if k.startswith('lat_') else v for k, v in cfg.items()}
    ks = ts.run(sim_cls, max_iters=0, **cfg).kernel
    out = ks.run(seeded_state(ts, scene, ks, 2), steps)
    return (torch.stack(out) if isinstance(out, tuple) else out).cpu()


def worker(tree, scenes, iters, states, diff_steps):
    """Time the scenes with the package and scenes of ``tree``; one JSON
    line {scene: {...}}. With ``states`` (a directory), also save each
    scene's ``small_state`` there."""
    sys.path.insert(0, tree)
    sys.path.insert(0, os.path.join(tree, 'tests'))
    import torch
    import torch_scenes as ts
    from sailfish_tpu_torch import util
    from sailfish_tpu_torch.ops import lbm_step as ls
    from sailfish_tpu_torch.ops import sc_multi as sm
    try:
        from sailfish_tpu_torch.ops.bc_patch import LAUNCHES as patch_counts
    except ImportError:
        patch_counts = {}

    def launches():
        return sum(ls.LAUNCHES.values()) + sum(patch_counts.values()) \
            + sum(sm.LAUNCHES.values())

    out = {}
    for scene in scenes:
        try:
            sim_cls, cfg = scene_setup(scene, ts)
            ks = ts.run(sim_cls, max_iters=0, **cfg).kernel
        except (NotImplementedError, TypeError, OSError,
                AttributeError) as exc:
            out[scene] = dict(refused=str(exc)[:200])
            continue
        f = ks.run(seeded_state(ts, scene, ks, 1), 100)
        assert all(bool(torch.isfinite(x).all())
                   for x in (f if isinstance(f, tuple) else (f,))), scene
        n0 = launches()
        ks.step_into(ks.a, ks.b)
        per_step = launches() - n0
        ms = util.cuda_time_ms(lambda: ks.step_into(ks.a, ks.b), iters,
                               warmup=5)
        out[scene] = dict(ms=ms, launches_per_step=per_step, kernel=ks.name)
        del ks, f
        torch.cuda.empty_cache()
        if states:
            os.makedirs(states, exist_ok=True)
            torch.save(small_state(ts, scene, diff_steps),
                       os.path.join(states, f'{scene}.pt'))
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--iters', type=int, default=200)
    ap.add_argument('--scenes', default=','.join(SCENES))
    ap.add_argument('--baseline', default=None)
    ap.add_argument('--diff-steps', type=int, default=200)
    ap.add_argument('--tree', default=None, help=argparse.SUPPRESS)
    ap.add_argument('--states', default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    scenes = args.scenes.split(',')
    if args.tree:
        worker(args.tree, scenes, args.iters, args.states, args.diff_steps)
        return
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    trees = [('this tree', REPO)]
    if args.baseline:
        base = ('baseline', os.path.abspath(args.baseline))
        trees = [base, trees[0], trees[0], base]
    results = []
    states_root = os.path.join(REPO, 'build', 'probe_states')
    states = []
    for turn, (label, tree) in enumerate(trees):
        cmd = [sys.executable, os.path.abspath(__file__), '--tree', tree,
               '--scenes', args.scenes, '--iters', str(args.iters),
               '--diff-steps', str(args.diff_steps)]
        if args.baseline and turn < 3:
            states.append(os.path.join(states_root, str(turn)))
            cmd += ['--states', states[-1]]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=tree,
                              timeout=1500)
        if proc.returncode != 0:
            sys.exit(f'step_probe: {label} failed:\n{proc.stdout}\n'
                     f'{proc.stderr}')
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        for scene, r in res.items():
            if 'ms' in r:
                print(f'{label}: {scene}: {r["ms"]:.4f} ms per step, '
                      f'{r["launches_per_step"]} launch(es) ({r["kernel"]})',
                      flush=True)
            else:
                print(f'{label}: {scene}: not run: {r["refused"]}',
                      flush=True)
        results.append(dict(tree=label, scenes=res))
    diffs = {}
    if args.baseline:
        import torch
        for scene in scenes:
            paths = [os.path.join(d, f'{scene}.pt') for d in states]
            if not all(os.path.exists(p) for p in paths):
                continue
            base, new, again = (torch.load(p) for p in paths)
            diffs[scene] = dict(
                baseline_vs_tree=float((new - base).abs().max()),
                tree_vs_tree=float((again - new).abs().max()))
            print(f'{scene}: after {args.diff_steps} steps at a quarter of '
                  f'the size, max |baseline - this tree| = '
                  f'{diffs[scene]["baseline_vs_tree"]:.3e}, max |this tree '
                  f'- this tree again| = '
                  f'{diffs[scene]["tree_vs_tree"]:.3e}', flush=True)
        shutil.rmtree(states_root, ignore_errors=True)
    print(json.dumps({'device': smi, 'iters': args.iters,
                      'step_probe': results, 'max_abs_diff': diffs}))


if __name__ == '__main__':
    main()
