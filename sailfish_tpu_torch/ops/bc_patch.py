"""Per-node parameters of native BCs whose prescribed rho or u varies.

Counterpart of ``sailfish_tpu/ops/pallas_step.py``
(``make_bc_patch_kernel_3d`` :2197 and its routing in
``PallasStep3D.__init__`` :2602-2659) and
``sailfish_tpu/ops/pallas_step2d.py`` (``make_bc_patch_kernel_2d`` :900,
routing :1239-1342). A native BC (equilibrium, Zou-He or regularized, for
velocity or density) whose prescribed rho or u varies from node to node --
a velocity inlet with a Poiseuille profile -- cannot sit in the TPU main
kernel, whose BC parameters are scalars, so the JAX package recomputes the
z-planes (3D) or y-blocks (2D) that hold such nodes in a second kernel and
overlays them. A GPU thread can load its own node's parameters, so the
port has no second kernel: the step kernel (``lbm_step_kernel`` in
``csrc/lbm_step.cu``, wrapped by ``ops/lbm_step.KernelStep``) computes the
next state of those nodes in the same launch as every other node, whatever
axis the face is normal to; such launches are counted as
``lbm_step_vary_<grid>`` in ``lbm_step.LAUNCHES``. The
planes, y-blocks, row limit and demotion of the JAX routing are TPU tiling
artifacts and have no counterpart.

This module builds what those nodes read: one fp32 array holding,
for each varying instance, ``[rho, u_x, u_y(, u_z)]`` component-major over
the instance's bounding box (x fastest), and the ``Box`` (offset, origin,
extents) that locates each block. A planar face costs 1 + dim planes of
its own size; memory is proportional to the BC nodes, never to the domain.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np

from sailfish_tpu_torch import node_type as nt

#: refuse a varying instance whose bounding box holds more than this many
#: times its node count (a diagonal sheet of BC nodes through a 3D domain):
#: the parameter array stores whole boxes. A planar face thinned to every
#: eighth node still passes.
MAX_BOX_FACTOR = 16

#: the kernel's parameter block holds a block's offset as a 32-bit int
MAX_PARAM_FLOATS = 2 ** 31 - 1

#: Where a varying instance's parameters lie: ``offset`` of its block in
#: the parameter array (in floats), bounding-box origin ``lo`` and extents
#: ``ext``, both in (x, y, z) order (z: 0 and 1 in 2D).
Box = namedtuple('Box', ('offset', 'lo', 'ext'))


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


def instance_boxes(maps, instances):
    """(boxes, reasons) for ``lbm_step.classify_nodes``' ``instances``:
    a ``Box`` per varying instance and None per uniform one, the offsets
    laid end to end in instance order; ``reasons`` names each varying
    instance whose box exceeds ``MAX_BOX_FACTOR`` times its nodes."""
    dim = maps.type_map.ndim
    boxes, reasons, offset = [], [], 0
    for tid, k, sel in instances:
        if not varying_params(maps, tid, sel):
            boxes.append(None)
            continue
        idx = np.nonzero(sel)
        lo = [int(i.min()) for i in idx]
        ext = [int(i.max()) - a + 1 for i, a in zip(idx, lo)]
        volume = int(np.prod(ext))
        if volume > MAX_BOX_FACTOR * idx[0].size:
            reasons.append(
                f'{nt.get_node_type(tid).__name__} (orientation {k}): '
                f'{idx[0].size} nodes with spatially varying parameters in '
                f'a bounding box of {volume} (the parameter array takes at '
                f'most {MAX_BOX_FACTOR} times the node count)')
        pad = 3 - dim
        boxes.append(Box(offset, tuple(lo[::-1]) + (0,) * pad,
                         tuple(ext[::-1]) + (1,) * pad))
        offset += (1 + dim) * volume
    if offset > MAX_PARAM_FLOATS:
        reasons.append(f'{offset} per-node BC parameters (the kernel '
                       f'indexes at most {MAX_PARAM_FLOATS})')
    return boxes, reasons


def box_slices(box, dim):
    """The box as slices over the array axes ((z, )y, x)."""
    return tuple(slice(box.lo[a], box.lo[a] + box.ext[a])
                 for a in reversed(range(dim)))


def param_array(maps, boxes):
    """The fp32 parameter array of ``instance_boxes``' ``boxes``: per
    varying instance, at its offset, [rho, u_x, u_y(, u_z)] over its box
    in C order (component, (z, )y, x). One zero when nothing varies, so
    the array always has an address."""
    dim = maps.type_map.ndim
    blocks = []
    for box in boxes:
        if box is None:
            continue
        sl = box_slices(box, dim)
        blocks.append(np.stack(
            [maps.param_rho[sl]] + [maps.param_vel[a][sl]
                                    for a in range(dim)]
        ).astype(np.float32).ravel())
    if not blocks:
        return np.zeros(1, dtype=np.float32)
    return np.concatenate(blocks)
