"""Device mesh construction and domain sharding.

Port of ``sailfish_tpu/parallel/mesh.py``: the same mesh strings, axis
names and errors. A mesh here is a plain object: its axis names (outer to
inner over the spatial axes, (z, y, x) in 3D and (y, x) in 2D), its shape
and one ``torch.device`` per shard, in shard order (the outer axis
slowest). The domain is split along the sharded axes, the outermost one or
the outer two, into equal slabs, one per shard, each with ``ghost`` planes
of its ring neighbours on either side along every sharded axis
(``slab_rows``); ``split`` and ``gather`` move a (Q, *S) state, or a
K-tuple of them, between the global tensors and the per-shard ones.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

#: the device list ``make_mesh`` uses when it is given none and this is
#: set (``devices_override``); None: the visible CUDA devices
_DEVICES = None


def parse_mesh_shape(mesh_str, dim, n_devices=None):
    """'4' -> (4,); '2x2' -> (2, 2); '' -> None. Shapes are listed
    outer-to-inner over spatial axes (z, y, x) in 3D / (y, x) in 2D."""
    if not mesh_str:
        return None
    shape = tuple(int(p) for p in mesh_str.lower().split('x'))
    max_axes = 3 if dim == 3 else 2
    if len(shape) > max_axes:
        raise ValueError(
            f'mesh {mesh_str!r} has {len(shape)} axes; at most {max_axes} '
            f'spatial axes are sharded in {dim}D')
    return shape


def axis_names(dim):
    """Mesh axis names outer-to-inner."""
    return ('z', 'y', 'x') if dim == 3 else ('y', 'x')


class Mesh:
    """``axis_names`` (outer to inner), ``shape`` (shards per axis) and
    ``devices`` (one ``torch.device`` per shard, the outer axis slowest)."""

    def __init__(self, shape, names, devices):
        self.shape = dict(zip(names, shape))
        self.axis_names = tuple(names)
        self.devices = list(devices)

    @property
    def size(self):
        return len(self.devices)

    def __repr__(self):
        return (f'Mesh({self.shape}, devices='
                f'{[str(d) for d in self.devices]})')


@contextlib.contextmanager
def devices_override(devices):
    """Within the block, ``make_mesh`` without ``devices`` takes its shards
    from ``devices`` (which may repeat a device: several shards on one
    card)."""
    global _DEVICES
    old, _DEVICES = _DEVICES, [torch.device(d) for d in devices]
    try:
        yield
    finally:
        _DEVICES = old


def make_mesh(shape, dim, devices=None):
    """A mesh over the first len(shape) spatial axes. ``devices``: a list
    of devices (a device may repeat); default the override of
    ``devices_override``, else the visible CUDA devices. More shards than
    devices is an error."""
    if devices is None:
        devices = _DEVICES if _DEVICES is not None else [
            torch.device('cuda', i) for i in range(torch.cuda.device_count())]
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f'mesh {shape} needs {n} devices; '
                         f'only {len(devices)} available')
    return Mesh(shape, axis_names(dim)[:len(shape)],
                [torch.device(d) for d in devices[:n]])


def validate_divisible(shape_spatial, mesh):
    """Spatial dims sharded by the mesh must divide evenly."""
    dim = len(shape_spatial)
    for ax_name, size in zip(axis_names(dim), shape_spatial):
        if ax_name in mesh.axis_names:
            n = mesh.shape[ax_name]
            if size % n != 0:
                raise ValueError(
                    f'domain axis {ax_name} (size {size}) not divisible by '
                    f'mesh axis {ax_name} ({n} devices)')


def slab_rows(n_global, n_shards, s, ghost=0):
    """The global indices of shard ``s``'s planes along a sharded axis of
    length ``n_global`` cut into ``n_shards``: its slab and ``ghost``
    planes on either side, wrapping around the ring."""
    length = n_global // n_shards
    return np.arange(s * length - ghost, (s + 1) * length + ghost) \
        % n_global


def shard_index(s, counts):
    """The position of shard ``s`` along each sharded axis of a mesh of
    ``counts`` shards per axis (outer to inner; the outer axis slowest)."""
    return tuple(int(i) for i in np.unravel_index(s, tuple(counts)))


def shard_rows(shape, counts, s, ghost=0):
    """Per sharded axis (the first ``len(counts)`` of the spatial
    ``shape``), the global indices of shard ``s``'s planes with ``ghost``
    planes on either side (``slab_rows``)."""
    return [slab_rows(n, c, i, ghost)
            for n, c, i in zip(shape, counts, shard_index(s, counts))]


def counts_of(mesh):
    """The shards per sharded axis of ``mesh``, outer to inner."""
    return tuple(mesh.shape[a] for a in mesh.axis_names)


def split(f, mesh, axis=1, ghost=0):
    """The per-shard slabs of the global tensor ``f`` along its axes
    ``axis``, ``axis`` + 1, ... (one per sharded axis of ``mesh``; default
    1: the outermost spatial axis of a (Q, *S) state), each with ``ghost``
    wrapped planes on either side of every sharded axis, a contiguous
    tensor on its shard's device. A K-tuple of tensors (a K-component
    state) gives one K-tuple of slabs per shard."""
    if isinstance(f, (tuple, list)):
        return [tuple(c) for c in zip(*(split(x, mesh, axis, ghost)
                                        for x in f))]
    counts = counts_of(mesh)
    shape = f.shape[axis:axis + len(counts)]
    parts = []
    for s, d in enumerate(mesh.devices):
        part = f
        for a, rows in enumerate(shard_rows(shape, counts, s, ghost)):
            part = part.index_select(axis + a, torch.as_tensor(
                rows, device=f.device))
        parts.append(part.to(d).contiguous())
    return parts


def gather(parts, device=None, axis=1, ghost=0, counts=None):
    """The global tensor of the per-shard slabs ``parts`` (in shard order,
    each with ``ghost`` planes on either side of every sharded axis,
    cropped) along ``axis`` (and ``axis`` + 1 for a mesh of two axes:
    ``counts``, the shards per axis, default one axis), on ``device``
    (default the first slab's); of K-tuples of slabs, the K-tuple of
    global tensors."""
    if isinstance(parts[0], (tuple, list)):
        return tuple(gather([p[k] for p in parts], device, axis, ghost,
                            counts)
                     for k in range(len(parts[0])))
    device = parts[0].device if device is None else torch.device(device)
    counts = (len(parts),) if counts is None else tuple(counts)
    crops = []
    for p in parts:
        for a in range(len(counts)):
            p = p.narrow(axis + a, ghost, p.shape[axis + a] - 2 * ghost)
        crops.append(p.to(device))
    inner = counts[-1]
    if len(counts) == 2:
        crops = [torch.cat(crops[i:i + inner], dim=axis + 1)
                 for i in range(0, len(crops), inner)]
    return torch.cat(crops, dim=axis)
