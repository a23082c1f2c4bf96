#!/usr/bin/env python3
"""How far the ELBM kernel and its plain version each drift from the plain
version in fp64 arithmetic, step by step, on forced scenes with walls.

    python3 tools/elbm_scatter.py

Needs one CUDA GPU. From ``tests/torch_scenes.smooth_feq`` (seed 1234) it
steps the ELBM kernel with the alpha solve's diagnostics, the fp32 plain
version (``step_reference``) with its own, and the fp64 plain version (the
same Newton stops), 50 steps, and prints one JSON line per case: at steps
1, 2, 3, 5, 10, 20, 30, 40 and 50 the wet max |df| of the kernel to the
fp32 plain version, of each to the fp64 one (largest, over the nodes that
never took the Newton branch, and mean), the Newton nodes of each, the
nodes on another branch, and where the kernel's largest gap sits. Cases:
``sphere_3d`` 128 x 64 x 64 (tau 0.53) at amplitude 1e-2 under each force
model, with the keep block of ``chip_smoke.py``'s cases under each force
model, the BGK kernel on the same state, amplitude 1e-3, tau 0.8, and the
D2Q9 ``cylinder`` 1024 x 512 (ELBM and BGK); then one launch from
``newton_state`` under each force model (``elbm_branches``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tests'))
from torch_scenes import (elbm_branches, newton_state, run,  # noqa: E402
                          smooth_feq, twin, with_keep_block)

DEVICE = 'cuda'
STEPS = 50
CHECK = (1, 2, 3, 5, 10, 20, 30, 40, 50)
SPHERE = dict(lat_nx=128, lat_ny=64, lat_nz=64)
CYLINDER = dict(lat_nx=1024, lat_ny=512)


def trail(ks, f0):
    """The rows of the module docstring over ``STEPS`` steps from
    ``f0``."""
    wet = (ks.mask == 0) | (ks.mask >= 3)
    elbm = ks.elbm is not None
    fk, nxt = f0.clone(), torch.empty_like(f0)
    f32, f64 = f0.clone(), f0.double()
    dk = torch.full((2,) + ks.shape, -1.0, device=DEVICE)
    dp = torch.full((2,) + ks.shape, -1.0, device=DEVICE)
    newton_ever = torch.zeros(ks.shape, dtype=torch.bool, device=DEVICE)
    rows = []
    for i in range(STEPS):
        if elbm:
            ks.diagnostics_into(fk, nxt, dk, i)
            nf = torch.empty_like(f32)
            ks.diagnostics_into(f32, nf, dp, i, plain=True)
            f32 = nf
            newton_ever |= dk[1] >= 2
        else:
            ks.step_into(fk, nxt, i)
            ks.set_iteration(i)
            f32 = ks.reference(f32)
        fk, nxt = nxt, fk
        ks.set_iteration(i)
        f64 = ks.reference(f64)
        if i + 1 not in CHECK:
            continue
        k64 = (fk.double() - f64).abs()
        p64 = (f32.double() - f64).abs()
        calm = wet & ~newton_ever
        gap = k64.amax(0)
        gap[~wet] = 0
        at = np.unravel_index(int(gap.argmax()), ks.shape)
        row = dict(step=i + 1,
                   err=float((fk - f32)[:, wet].abs().max()),
                   k64=float(k64[:, wet].max()), p64=float(p64[:, wet].max()),
                   k64_calm=float(k64[:, calm].max()),
                   p64_calm=float(p64[:, calm].max()),
                   k64_mean=float(k64[:, wet].mean()),
                   p64_mean=float(p64[:, wet].mean()),
                   at=[int(x) for x in at], at_mask=int(ks.mask[at]))
        if elbm:
            row.update(newton_k=int((dk[1] >= 2).sum()),
                       newton_p=int((dp[1] >= 2).sum()),
                       flips=int(((dk[1].clamp(max=2) != dp[1])
                                  & (dp[1] >= 0)).sum()),
                       newton_ever=int(newton_ever.sum()),
                       at_newton_ever=bool(newton_ever[at]))
        rows.append(row)
    return rows


def case(scene, cfg, model, force, amp=1e-2, tau=None, newton=False,
         keep=False):
    extra = dict(cfg, force_implementation=force)
    if tau:
        extra['visc'] = (tau - 0.5) / 3.0
    sim = with_keep_block(twin(scene)) if keep else twin(scene)
    r = run(sim, platform=DEVICE, engine='kernel', max_iters=0, model=model,
            seed=1234, **extra)
    ks = r.kernel
    out = dict(scene=scene, keep=keep, model=model, force=force,
               tau=1.0 / ks.tau_inv, kernel=ks.name)
    if newton:
        b = elbm_branches(ks, newton_state(ks.grid, ks.shape, 1234, DEVICE),
                          tol=0.0)
        out['newton_launch'] = b
    else:
        out['amp'] = amp
        out['steps'] = trail(ks, smooth_feq(ks.grid, ks.shape, 1234, DEVICE,
                                            amp=amp))
    print(json.dumps(out), flush=True)
    del r, ks
    torch.cuda.empty_cache()


def main():
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    for keep in (False, True):
        for force in ('guo', 'edm', 'velocity_shift'):
            case('sphere_3d', SPHERE, 'elbm', force, keep=keep)
    case('sphere_3d', SPHERE, 'bgk', 'guo')
    case('sphere_3d', SPHERE, 'elbm', 'guo', amp=1e-3)
    case('sphere_3d', SPHERE, 'elbm', 'guo', tau=0.8)
    case('cylinder', CYLINDER, 'elbm', 'guo')
    case('cylinder', CYLINDER, 'bgk', 'guo')
    for force in ('guo', 'edm', 'velocity_shift'):
        case('sphere_3d', SPHERE, 'elbm', force, newton=True)
        case('cylinder', CYLINDER, 'elbm', force, newton=True)


if __name__ == '__main__':
    main()
