"""Domain decomposition geometry classes.

API counterpart of the reference's ``sailfish/geo.py`` (LBGeometry2D/3D
:22,44, EqualSubdomainsGeometry :69,100, WeightedSubdomainsGeometry3D :137).

The port's copy of ``sailfish_tpu/geo.py``. In the reference each
subdomain becomes a process+GPU connected over ZeroMQ; the port runs the
whole domain on one device (sharded runs are not ported yet). The class
interface (``subdomains()`` returning SubdomainSpec lists) is preserved so
reference scripts port unchanged.
"""

from __future__ import annotations

import numpy as np

from sailfish_tpu_torch.subdomain import SubdomainSpec2D, SubdomainSpec3D


class LBGeometry:
    dim = None

    def __init__(self, config):
        self.config = config

    @classmethod
    def add_options(cls, group, dim):
        return False


class LBGeometry2D(LBGeometry):
    """Single-subdomain 2D geometry (reference geo.py:22)."""
    dim = 2

    def __init__(self, config):
        super().__init__(config)
        self.gx = config.lat_nx
        self.gy = config.lat_ny

    def subdomains(self):
        return [SubdomainSpec2D((0, 0), (self.gx, self.gy))]


class LBGeometry3D(LBGeometry):
    """Single-subdomain 3D geometry (reference geo.py:44)."""
    dim = 3

    def __init__(self, config):
        super().__init__(config)
        self.gx = config.lat_nx
        self.gy = config.lat_ny
        self.gz = config.lat_nz

    def subdomains(self):
        return [SubdomainSpec3D((0, 0, 0), (self.gx, self.gy, self.gz))]


def _splits(total, n):
    """Split `total` nodes into n near-equal contiguous chunks."""
    base = total // n
    sizes = [base + (1 if i < total % n else 0) for i in range(n)]
    starts = np.cumsum([0] + sizes[:-1])
    return list(zip(starts.tolist(), sizes))


class EqualSubdomainsGeometry2D(LBGeometry2D):
    """config.subdomains equal subdomains along Y (reference geo.py:69)."""

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--subdomains', type=int, default=1,
                           help='number of subdomains')
        group.add_argument('--conn_axis', type=str, default='y',
                           choices=['x', 'y'],
                           help='axis along which subdomains are split')
        return True

    def subdomains(self):
        n = self.config.subdomains
        axis = self.config.conn_axis
        out = []
        if axis == 'y':
            for start, size in _splits(self.gy, n):
                out.append(SubdomainSpec2D((0, start), (self.gx, size)))
        else:
            for start, size in _splits(self.gx, n):
                out.append(SubdomainSpec2D((start, 0), (size, self.gy)))
        return out


class EqualSubdomainsGeometry3D(LBGeometry3D):
    """config.subdomains equal subdomains along Z (reference geo.py:100)."""

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--subdomains', type=int, default=1,
                           help='number of subdomains')
        group.add_argument('--conn_axis', type=str, default='z',
                           choices=['x', 'y', 'z'],
                           help='axis along which subdomains are split')
        return True

    def subdomains(self):
        n = self.config.subdomains
        axis = self.config.conn_axis
        out = []
        if axis == 'z':
            for start, size in _splits(self.gz, n):
                out.append(SubdomainSpec3D((0, 0, start),
                                           (self.gx, self.gy, size)))
        elif axis == 'y':
            for start, size in _splits(self.gy, n):
                out.append(SubdomainSpec3D((0, start, 0),
                                           (self.gx, size, self.gz)))
        else:
            for start, size in _splits(self.gx, n):
                out.append(SubdomainSpec3D((start, 0, 0),
                                           (size, self.gy, self.gz)))
        return out


class WeightedSubdomainsGeometry3D(LBGeometry3D):
    """Z-splits proportional to per-slab active-node weight
    (reference geo.py:137)."""

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--subdomains', type=int, default=1)
        return True

    def weights(self):
        """Override: per-z-slab work estimate (default uniform)."""
        return np.ones(self.gz)

    def subdomains(self):
        n = self.config.subdomains
        w = np.asarray(self.weights(), dtype=np.float64)
        cum = np.cumsum(w) / w.sum()
        bounds = [0]
        for i in range(1, n):
            bounds.append(int(np.searchsorted(cum, i / n)) + 1)
        bounds.append(self.gz)
        out = []
        for a, b in zip(bounds[:-1], bounds[1:]):
            if b > a:
                out.append(SubdomainSpec3D((0, 0, a),
                                           (self.gx, self.gy, b - a)))
        return out
