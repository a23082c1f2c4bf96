"""Physical <-> lattice unit and coordinate conversion.

The port's own copy of ``sailfish_tpu/converter.py`` (numpy only): the
counterpart of the reference's ``sailfish/converter.py``
(CoordinateConverter :13, UnitConverter :95). The configuration keys
(fixed by the voxelizer .config format) and the property surface are the
JAX package's, so voxelizer-produced geometry and user scripts port
unchanged: coordinates go through a precomputed per-axis affine map, and
the unit systems share one similarity-completion solver.
"""

from __future__ import annotations

import math

import numpy as np


class CoordinateConverter:
    """Maps physical positions to lattice node indices and back.

    The map is affine per axis: ``lb = phys * scale + shift``, with an
    axis permutation between the physical (x, y, z) order and the LB
    memory (z, y, x) order. ``scale``/``shift`` fold together the
    voxelizer's bounding box, the padding it added and the cuts it
    removed.

    Config keys (the voxelizer .config contract):
      axes: permutation of 'xyz' describing the physical axis order.
      bounding_box: [(x0, x1), (y0, y1), (z0, z1)] physical span.
      size: lattice domain size in LB (z, y, x) order.
      padding: [fwd_x, back_x, fwd_y, back_y, fwd_z, back_z] nodes added.
      cuts: [(fwd, back)] * 3 nodes removed after conversion.
    """

    def __init__(self, config):
        ax = config['axes']
        # lb_axis[i]: which LB index (0=z .. 2=x in reversed order
        # space) physical axis i lands on
        self._to_lb_axis = np.array([2 - ax.index(c) for c in 'xyz'])
        cuts = config.get('cuts', ((0, 0),) * 3)
        pad = config['padding']
        scale = np.empty(3)
        shift = np.empty(3)
        for i, (lo, hi) in enumerate(config['bounding_box']):
            # grid extent as the voxelizer rasterized it: strip the
            # post-hoc padding, restore the cut envelope
            raw_nodes = (config['size'][2 - i] - pad[2 * i]
                         - pad[2 * i + 1] + cuts[i][0] + cuts[i][1])
            cell = (hi - lo) / raw_nodes
            # node index of the raw grid's origin in the final domain
            origin = pad[2 * i] - cuts[i][0]
            scale[i] = 1.0 / cell
            shift[i] = origin - lo / cell
        self._scale = scale
        self._shift = shift

    def to_lb(self, phys_pos, round_=True):
        """Physical (x, y, z) -> LB (z, y, x) position."""
        lb = np.asarray(phys_pos, dtype=float) * self._scale + self._shift
        out = [0, 0, 0]
        for i in range(3):
            v = lb[i]
            out[self._to_lb_axis[i]] = int(round(v)) if round_ else v
        return out

    def from_lb(self, lb_pos):
        """LB (z, y, x) -> physical (x, y, z) position."""
        out = [0.0, 0.0, 0.0]
        for i in range(3):
            v = lb_pos[self._to_lb_axis[i]]
            out[i] = (v - self._shift[i]) / self._scale[i]
        return out


def _complete_similarity(length, velocity, visc, Re):
    """Fill in the one missing member of Re = length * velocity / visc.
    Returns the completed (length, velocity, visc) triple; members
    already present are returned unchanged."""
    if Re is None:
        return length, velocity, visc
    if visc is None and length is not None and velocity is not None:
        visc = length * velocity / Re
    elif length is None and visc is not None and velocity is not None:
        length = Re * visc / velocity
    elif velocity is None and visc is not None and length is not None:
        velocity = Re * visc / length
    return length, velocity, visc


class UnitConverter:
    """Physical <-> lattice unit conversion.

    Both unit systems are (length, velocity, viscosity) triples tied by
    the shared Reynolds number; either side may leave one member blank
    and have it completed by similarity (_complete_similarity). The
    property surface matches the reference (converter.py:95-207)."""

    def __init__(self, visc=None, length=None, velocity=None, Re=None,
                 freq=None):
        self._phys_len, self._phys_vel, self._phys_visc = \
            _complete_similarity(length, velocity, visc, Re)
        self._phys_freq = freq
        self._lb_len = self._lb_vel = self._lb_visc = None

    def set_lb(self, visc=None, length=None, velocity=None):
        self._lb_len, self._lb_vel, self._lb_visc = \
            _complete_similarity(length, velocity, visc, self.Re)
        if visc is None and self._lb_visc is not None:
            assert self._lb_visc <= 1.0 / 6.0, \
                'lattice viscosity too high; refine the resolution'

    # -- dimensionless groups ------------------------------------------------

    @property
    def Re(self):
        return self._phys_len * self._phys_vel / self._phys_visc

    @property
    def Re_lb(self):
        return self._lb_len * self._lb_vel / self._lb_visc

    @property
    def Womersley(self):
        return math.sqrt(2 * math.pi * self._phys_freq
                         * self._phys_len ** 2 / self._phys_visc)

    @property
    def Womersley_lb(self):
        return math.sqrt(2 * math.pi * self.freq_lb * self.len_lb ** 2
                         / self.visc_lb)

    # -- lattice quantities --------------------------------------------------

    @property
    def visc_lb(self):
        return self._lb_visc

    @property
    def velocity_lb(self):
        return self._lb_vel

    @property
    def len_lb(self):
        return self._lb_len

    @property
    def freq_lb(self):
        return 1.0 if self._phys_freq is None else self._phys_freq * self.dt

    # -- resolution ----------------------------------------------------------

    @property
    def dx(self):
        """Physical size of a lattice cell."""
        return self._phys_len / self._lb_len if self._lb_len else 0

    @property
    def dt(self):
        """Physical duration of a lattice step (from viscosity
        similarity: nu_lb = nu_phys * dt / dx^2)."""
        if not self._lb_visc:
            return 0
        return self._lb_visc * self.dx ** 2 / self._phys_visc

    @property
    def info_lb(self):
        return ('Re=%.2f  Wo=%.2f  visc=%.3e  vel=%.3e  len=%.3e  T=%d  '
                'dx=%.4e  dt=%.4e phys_len=%.4e phys_visc=%.4e '
                'phys_vel=%.4e' % (
                    self.Re_lb, self.Womersley_lb, self.visc_lb,
                    self.velocity_lb, self.len_lb, int(1.0 / self.freq_lb),
                    self.dx, self.dt, self._phys_len, self._phys_visc,
                    self._phys_vel))
