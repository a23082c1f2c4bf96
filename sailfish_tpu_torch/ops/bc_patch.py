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

The outflow family's rows use the same array: Guo's density BC as a
density BC, and the Neumann gradient and the laminarization alpha (static:
the JAX engines read ``param_scalar`` alone) in rho's place when they vary
from node to node.

A native BC whose parameter is a ``DynamicValue`` (``maps.dynamic``) is a
row whose values ``ops/lbm_step.KernelStep`` writes before every launch:
a time-only value covering the whole instance is a pair of scalars of the
row (``dynamic_kind`` 'time'); anything that depends on space, or covers
part of an instance, is a varying row whose block of the array is
recomputed on the device over the box, with the GLOBAL coordinates of its
nodes (``dynamic_rows``, ``DynamicRow.write_block``) -- the work of the JAX
package's dynamic patch planes (``pallas_step.py:2595-2607``).
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch

from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch.ops import step as st

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


def param_name(tid):
    """The parameter a native BC type (or Guo's density BC) prescribes:
    'velocity' or 'density' (None for a type without them)."""
    names = nt.get_node_type(tid).param_names
    for name in ('velocity', 'density'):
        if name in names:
            return name
    return None


def dynamic_entries(maps, tid, sel):
    """The (node mask, exprs) entries of ``maps.dynamic`` that set the
    parameter of instance (``tid``, node selection ``sel``), in the order
    they apply (a later one overrides an earlier one)."""
    name = param_name(tid)
    return [(mask, exprs) for mask, n, exprs in maps.dynamic
            if n == name and (mask & sel).any()]


def dynamic_kind(maps, tid, sel):
    """None when the instance's parameters are static; 'time' when one
    DynamicValue of time alone sets them at every node (two scalars of the
    row, rewritten each step); 'space' otherwise (a block of the parameter
    array, rewritten each step)."""
    entries = dynamic_entries(maps, tid, sel)
    if not entries:
        return None
    if len(entries) == 1 and entries[0][0][sel].all() \
            and not st.is_space_dependent(entries[0][1]):
        return 'time'
    return 'space'


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
    a ``Box`` per varying instance (static parameters that vary, or a
    ``dynamic_kind`` 'space') and None per uniform one, walls and
    time-only rows included, the offsets
    laid end to end in instance order; ``reasons`` names each varying
    instance whose box exceeds ``MAX_BOX_FACTOR`` times its nodes."""
    dim = maps.type_map.ndim
    boxes, reasons, offset = [], [], 0
    for tid, k, sel in instances:
        if nt.get_node_type(tid) in st.SCALAR_TYPES:
            # the Neumann gradient, the laminarization alpha: static (the
            # JAX engines read param_scalar alone), varying or not
            varies = np.unique(maps.param_scalar[sel]).size > 1
        else:
            kind = dynamic_kind(maps, tid, sel) if param_name(tid) \
                else 'time'
            varies = kind == 'space' or (
                kind is None and bool(varying_params(maps, tid, sel)))
        if not varies:
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


def param_array(maps, boxes, instances=None):
    """The fp32 parameter array of ``instance_boxes``' ``boxes``: per
    varying instance, at its offset, [rho, u_x, u_y(, u_z)] over its box
    in C order (component, (z, )y, x); an instance of
    ``step.SCALAR_TYPES`` among ``instances`` (the list the boxes are of)
    holds its scalar in rho's place. One zero when nothing varies, so
    the array always has an address."""
    dim = maps.type_map.ndim
    blocks = []
    tids = [tid for tid, _k, _sel in instances] if instances \
        else [None] * len(boxes)
    for box, tid in zip(boxes, tids):
        if box is None:
            continue
        sl = box_slices(box, dim)
        first = maps.param_scalar if tid is not None and \
            nt.get_node_type(tid) in st.SCALAR_TYPES else maps.param_rho
        blocks.append(np.stack(
            [first[sl]] + [maps.param_vel[a][sl] for a in range(dim)]
        ).astype(np.float32).ravel())
    if not blocks:
        return np.zeros(1, dtype=np.float32)
    return np.concatenate(blocks)


class DynamicRow(namedtuple('DynamicRow', ('row', 'name', 'entries',
                                            'coords', 'static', 'live'))):
    """A BC row (index ``row`` of the table) whose parameter ``name``
    depends on time. ``entries``: its (node mask, exprs) in order, the
    masks cut to the row's box (None for a time-only row, whose one entry
    covers it); ``coords``: the global coordinates (hx, hy[, hz]) over the
    box, as the whole-domain step hands them to a callable (int64, so an
    index into a ``SpatialArray`` needs no cast each step); ``static``:
    the box's block ((1 + dim, *ext)) with every component that no
    callable sets already final; ``live``: the components a callable
    sets, recomputed each step."""

    def scalars_at(self, t, dim):
        """(rho, (u_x, u_y, u_z)) of a time-only row at time ``t``: the
        DynamicValue evaluated and cast to fp32, as the torch engine's
        ``bc_params`` casts it to the StepBuilder's dtype."""
        _mask, exprs = self.entries[0]
        vals = [float(v) for v in st.dynamic_values(
            exprs, t, (), (), torch.float32)]
        if self.name == 'density':
            return vals[0], (0.0, 0.0, 0.0)
        return 1.0, tuple(vals[:dim]) + (0.0,) * (3 - len(vals[:dim]))

    def write_block(self, t, block):
        """Write the row's values at time ``t`` into ``block``, its
        (1 + dim, *ext) view of the parameter array: each live component is
        the static one with the entries applied in order (a later one
        overriding an earlier one), as the torch engine's ``bc_params``
        applies them."""
        shape = block.shape[1:]
        for c in self.live:
            src = self.static[c]
            for mask, exprs in self.entries:
                e = exprs[0] if self.name == 'density' else exprs[c - 1]
                val = e if not callable(e) else st.dynamic_values(
                    [e], t, self.coords, shape, torch.float32,
                    block.device)[0]
                torch.where(mask, val, src, out=block[c])
                src = block[c]


def dynamic_rows(maps, instances, boxes, bcp):
    """A ``DynamicRow`` for every instance whose parameters depend on
    time (``boxes`` from ``instance_boxes``, ``bcp`` the parameter array as
    a tensor on the kernel's device). The block of a space-dependent row
    is written here with its components that no callable sets."""
    dim = maps.type_map.ndim
    rows = []
    coords = None
    for j, ((tid, _k, sel), box) in enumerate(zip(instances, boxes)):
        if not param_name(tid):
            continue
        kind = dynamic_kind(maps, tid, sel)
        if kind is None:
            continue
        name = param_name(tid)
        entries = dynamic_entries(maps, tid, sel)
        if kind == 'time':
            rows.append(DynamicRow(j, name, entries, (), None, ()))
            continue
        if coords is None:
            coords = [c.long() for c in st.map_coords(maps, bcp.device)]
        sl = box_slices(box, dim)
        ext = tuple(reversed(box.ext[:dim]))
        n = (1 + dim) * int(np.prod(ext))
        block = bcp[box.offset:box.offset + n].view((1 + dim,) + ext)
        entries = [(torch.as_tensor(mask[sl], device=bcp.device), exprs)
                   for mask, exprs in entries]
        comps = [0] if name == 'density' else range(1, 1 + dim)
        live = tuple(c for c in comps if any(
            callable(ex[0] if name == 'density' else ex[c - 1])
            for _m, ex in entries))
        for c in comps:
            if c in live:
                continue
            for mask, exprs in entries:
                e = exprs[0] if name == 'density' else exprs[c - 1]
                block[c] = torch.where(mask, e, block[c])
        rows.append(DynamicRow(j, name, entries,
                               tuple(c[sl] for c in coords), block.clone(),
                               live))
    return rows
