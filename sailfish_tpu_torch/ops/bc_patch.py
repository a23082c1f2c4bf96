"""Patch rows for native BCs with spatially varying parameters.

Counterpart of ``sailfish_tpu/ops/pallas_step.py`` (``make_bc_patch_kernel_3d``
:2197 and its routing in ``PallasStep3D.__init__`` :2602-2659) and
``sailfish_tpu/ops/pallas_step2d.py`` (``make_bc_patch_kernel_2d`` :900,
routing :1239-1342). A native BC (equilibrium, Zou-He or regularized, for
velocity or density) whose prescribed rho or u varies from node to node --
a velocity inlet with a Poiseuille profile -- cannot sit in the main
kernel's BC table of per-instance scalars. Its rows (z-planes in 3D,
y-rows in 2D) are recomputed instead by a second kernel,
``csrc/bc_patch.cu``, from per-node parameter planes, and written straight
into those rows of the step's output after ``lbm_step``.

``route`` splits the instances of ``lbm_step.classify_nodes`` between the
two kernels the way the JAX fixpoint does: varying instances go to the
patch kernel, and a uniform instance that shares a row with them is
demoted to it, since the patch kernel rewrites whole rows. The y-blocks of
the 2D TPU kernel and the window-volume rule of ``kbc_instance_spec``
(:2551-2554) are TPU tiling and cost artifacts and have no counterpart.

Beside the wrapper lives ``bc_patch_reference``, the same function as
plain PyTorch; the CPU runs it, and ``chip_smoke.py`` holds the kernel
against it on the card.
"""

from __future__ import annotations

import ctypes
from collections import namedtuple

import numpy as np
import torch

from sailfish_tpu_torch import equilibrium as eq
from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch.ops import step as st

#: refuse a scene whose patch rows exceed this fraction of the row axis
#: (``PallasStep3D.MAX_PATCH_FRACTION``, pallas_step.py:2585): a varying
#: face normal to x or y puts a node on every z-plane
MAX_PATCH_FRACTION = 0.25
#: kernel launches per kernel name over all ``BCPatch`` objects
LAUNCHES = {'bc_patch_d2q9': 0, 'bc_patch_d3q19': 0}


def reset_launch_counts():
    """Zero ``LAUNCHES`` (before a run whose launches are to be counted)."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def varying_params(maps, tid, sel):
    """Reasons instance (``tid``, node selection ``sel``) cannot run on
    per-instance scalars: one per prescribed parameter that takes more
    than one value over its nodes (the ``kbc_instance_spec`` test,
    pallas_step.py:2537-2549)."""
    cls = nt.get_node_type(tid)
    if 'velocity' in cls.param_names:
        fields = [maps.param_vel[a] for a in range(maps.param_vel.shape[0])]
        what = 'velocity'
    else:
        fields, what = [maps.param_rho], 'density'
    if any(np.unique(fld[sel]).size > 1 for fld in fields):
        return [f'spatially varying {cls.__name__} {what}']
    return []


#: How the native-BC instances are split. ``mask``: the main kernel's
#: mask codes (patch-instance nodes keep, code 2; the uniform instances
#: renumbered 3 + their index in ``uniform``); ``uniform`` and ``patch``:
#: indices into the ``classify_nodes`` instance list, the patch list in
#: the JAX order (varying instances, then the demoted ones); ``rows``: the
#: sorted patch rows; ``mask_rows``: the mask codes of those rows for the
#: patch kernel (patch instance p is code 3 + p); ``reasons``: why the
#: kernel engine cannot take the split (empty when it can).
Route = namedtuple('Route', ('mask', 'uniform', 'patch', 'rows',
                             'mask_rows', 'reasons'))


def route(maps, mask, instances):
    """Split ``lbm_step.classify_nodes``' ``instances`` (mask codes 3 + j
    in ``mask``) between the main kernel's BC table and the patch kernel
    (the fixpoint of pallas_step.py:2628-2656 on rows of axis 0)."""
    rows_of = [set(np.unique(np.nonzero(sel)[0]).tolist())
               for _tid, _k, sel in instances]
    patch = [j for j, (tid, _k, sel) in enumerate(instances)
             if varying_params(maps, tid, sel)]
    uniform = [j for j in range(len(instances)) if j not in patch]
    prows = set().union(*(rows_of[j] for j in patch))
    moved = True
    while moved:
        moved = False
        for j in list(uniform):
            if rows_of[j] & prows:
                uniform.remove(j)
                patch.append(j)
                prows |= rows_of[j]
                moved = True
    rows = sorted(prows)
    reasons = []
    n_rows = mask.shape[0]
    if len(rows) > MAX_PATCH_FRACTION * n_rows:
        axis = 'z-planes' if mask.ndim == 3 else 'y-rows'
        reasons.append(
            f'{len(rows)}/{n_rows} {axis} hold native BCs with spatially '
            f'varying parameters (the patch kernel takes at most '
            f'{MAX_PATCH_FRACTION:g} of them; a varying face must be '
            f'normal to the {axis[0]} axis)')
    main = np.arange(256, dtype=np.uint8)
    sub = np.arange(256, dtype=np.uint8)
    for p, j in enumerate(patch):
        main[3 + j] = 2
        sub[3 + j] = 3 + p
    for u, j in enumerate(uniform):
        main[3 + j] = 3 + u
    return Route(main[mask], uniform, patch, rows, sub[mask[rows]], reasons)


def param_planes(maps, rows, dim):
    """(1 + dim, R, *plane) fp32 parameter planes [rho, u_x, u_y(, u_z)]
    of the patch rows (pallas_step.py:2806-2812)."""
    return np.stack([maps.param_rho[rows]]
                    + [maps.param_vel[a][rows] for a in range(dim)]
                    ).astype(np.float32)


def pull_rows(grid, src, rows):
    """Post-stream distributions of the listed rows (axis 0 of the
    spatial shape): fs_i = src_i(x - c_i), periodic wrap, (Q, R, *plane)."""
    n0 = src.shape[1]
    out = []
    for i in range(grid.Q):
        c = [int(v) for v in grid.basis[i]]
        idx = (rows - c[grid.dim - 1]) % n0
        out.append(st.pull(src[i].index_select(0, idx), c[:grid.dim - 1]))
    return torch.stack(out)


def bc_patch_reference(src, rows, mask_rows, bcp, table, grid, tau_inv):
    """Plain PyTorch version of the kernel: the next state of the listed
    rows, (Q, R, *plane), from the pre-step state ``src`` (Q, *S), the
    rows (int tensor), their mask codes ``mask_rows`` (R, *plane), the
    parameter planes ``bcp`` (1 + dim, R, *plane) and the patch table
    (``lbm_step.BCRow`` per instance, code 3 + index; only the type and
    orientation are read), with relaxation rate ``tau_inv``."""
    fs = pull_rows(grid, src, rows.long())
    rho, u = eq.macroscopic(grid, fs)
    instances = [(nt.get_node_type(row.type_id), row.orientation,
                  mask_rows == 3 + j, bcp[0], bcp[1:1 + grid.dim])
                 for j, row in enumerate(table)]
    rho, u = st.solve_macro_bc(grid, instances, fs, rho, u)
    fs2 = st.pre_collision_bc(grid, instances, fs, rho, u)
    wet = (mask_rows == 0) | (mask_rows >= 3)
    return st.collide_and_select(grid, fs2, rho, u, tau_inv, wet,
                                 mask_rows == 1)


def kernel_function(lib, name, params_type):
    """The C entry ``name`` (``bc_patch_d2q9`` / ``bc_patch_d3q19``) of a
    loaded ``csrc/bc_patch.cu`` library, typed for ``ctypes``, after
    checking that its parameter block is ``params_type``
    (``lbm_step._Params``: the two sources share ``lbm_common.cuh``)."""
    lib.bc_patch_params_size.restype = ctypes.c_int
    if lib.bc_patch_params_size() != ctypes.sizeof(params_type):
        raise RuntimeError('LBMParams layout differs between '
                           'csrc/lbm_common.cuh and ops/lbm_step.py')
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.POINTER(params_type), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class BCPatch:
    """The patch kernel of one scene: its rows, their mask codes and
    parameter planes on the device, the patch table and its by-value
    parameter block (``params``, a ``lbm_step._Params``), and
    ``launches``, the number of kernel launches this object has made."""

    def __init__(self, grid, route_, bcp, table, params, tau_inv, device):
        self.grid = grid
        self.table = table
        self.params = params
        self.tau_inv = tau_inv
        self.rows = torch.as_tensor(route_.rows, dtype=torch.int32,
                                    device=device)
        self.mask_rows = torch.as_tensor(route_.mask_rows, device=device)
        self.bcp = torch.as_tensor(bcp, device=device)
        self.name = f'bc_patch_{grid.name.lower()}'
        self.launches = 0
        self._fn = None

    def reference(self, src):
        """``bc_patch_reference`` of this patch on ``src``."""
        return bc_patch_reference(src, self.rows, self.mask_rows, self.bcp,
                                  self.table, self.grid, self.tau_inv)

    def step_into(self, src, dst):
        """Overwrite the patch rows of ``dst`` with their next state from
        ``src`` (the buffers ``lbm_step.KernelStep.step_into`` checked).
        On a CUDA tensor this launches the kernel on the current stream;
        on a CPU tensor it runs ``bc_patch_reference``."""
        if src.device.type == 'cpu':
            dst[:, self.rows.long()] = self.reference(src)
            return
        if src.device.type != 'cuda':
            raise ValueError(f'no kernel for device {src.device}')
        if self._fn is None:
            from sailfish_tpu_torch.ops import build
            self._fn = kernel_function(build.load('bc_patch').lib,
                                       self.name, type(self.params))
        rc = self._fn(src.data_ptr(), dst.data_ptr(), self.rows.data_ptr(),
                      self.mask_rows.data_ptr(), self.bcp.data_ptr(),
                      len(self.rows), ctypes.byref(self.params),
                      torch.cuda.current_stream(src.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f'{self.name} launch failed: CUDA error {rc}')
        self.launches += 1
        LAUNCHES[self.name] += 1
