"""Boundary-condition node types: the user-facing BC catalog.

The port's copy of ``sailfish_tpu/node_type.py``. The classes are
registered in the same order, so the node-type ids (part of the checkpoint
format) are the JAX package's. Each class is a *declaration* consumed by
the geometry encoder; the BC math lives in ``ops/step.py`` (plain tensor
code) and the CUDA kernels, selected per node via dense node-type masks.
The lazy evaluators (``SpatialArray``, ``LinearlyInterpolatedTimeSeries``)
evaluate with torch.

Params may be scalars/tuples (uniform over the selected nodes) or numpy
arrays / ``multifield`` records (per-node values).
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np

ScratchSize = namedtuple('ScratchSize', ('dim2', 'dim3'))

# Registry: id -> class. IDs are assigned at module load in a fixed order
# (stable across runs; part of the checkpoint format).
_NODE_TYPES = {}


class LBNodeType:
    """Base class for node types (cf. reference node_type.py:18-88)."""

    id = None
    #: Node undergoes the normal relaxation process.
    wet_node = False
    #: Node does not participate in the simulation.
    excluded = False
    #: Node participates in propagation only.
    propagation_only = False
    #: No special processing needed for macroscopic quantities.
    standard_macro = False
    #: Needs a primary-direction orientation vector (into the fluid).
    needs_orientation = False
    #: Supports per-link tagging of directions crossing into walls.
    link_tags = False
    #: Extra per-node floats in global memory.
    scratch_space = 0
    #: Effective boundary location along the normal (+ toward fluid).
    location = 0.0
    #: Wet node that may be marked unused.
    allow_unused = False

    def __init__(self, **params):
        self.orientation = params.pop('orientation', None)
        self.params = params

    @classmethod
    def scratch_space_size(cls, dim):
        if isinstance(cls.scratch_space, int):
            return cls.scratch_space
        return cls.scratch_space.dim2 if dim == 2 else cls.scratch_space.dim3

    # Names of float parameters, in the order they are packed into the
    # per-node parameter fields (see subdomain encoding).
    param_names = ()

    def param_vector(self, dim):
        """Flatten params to a float list following ``param_names``.

        Vector-valued params (e.g. velocity) contribute ``dim`` entries.
        Array-valued params are returned as numpy arrays for per-node
        assignment.
        """
        out = []
        for name in self.param_names:
            v = self.params[name]
            if isinstance(v, (tuple, list)):
                out.extend(v)
            else:
                out.append(v)
        return out


def _register(cls):
    if cls.id is None:
        cls.id = max(_NODE_TYPES, default=-1) + 1
    _NODE_TYPES[cls.id] = cls
    return cls


# --- special types (internal; cf. reference node_type.py:85-110) -----------

@_register
class _NTFluid(LBNodeType):
    """Plain fluid node."""
    wet_node = True
    standard_macro = True
    id = 0


@_register
class _NTGhost(LBNodeType):
    """Ghost (halo) node owned by a neighboring shard."""
    excluded = True


@_register
class _NTUnused(LBNodeType):
    """Node outside the active domain."""
    excluded = True


@_register
class _NTPropagationOnly(LBNodeType):
    """Sentinel node participating in propagation only."""
    propagation_only = True


# --- walls -----------------------------------------------------------------

@_register
class NTHalfBBWall(LBNodeType):
    """Half-way bounce-back no-slip wall (wet; 2nd order; wall at -0.5).

    Tagged links i (crossing into the wall) receive
    f_i(x, t+1) = f*_opp(i)(x, t) (cf. reference node_type.py:115-143)."""
    wet_node = True
    standard_macro = True
    needs_orientation = True
    link_tags = True
    location = -0.5
    allow_unused = True


@_register
class NTFullBBWall(LBNodeType):
    """Full-way bounce-back no-slip wall (dry node; wall at +0.5).

    The node does not collide; distributions are reflected across the node
    center and re-streamed (reference node_type.py:144-170)."""
    standard_macro = True
    location = 0.5
    needs_orientation = True  # only for wetting BCs in binary fluids


@_register
class NTWallTMS(LBNodeType):
    """Tamm-Mott-Smith turbulent wall (Chikatamarla & Karlin 2013;
    reference node_type.py:171-196)."""
    wet_node = True
    needs_orientation = True
    link_tags = True
    location = 0.5
    allow_unused = True
    standard_macro = True


@_register
class NTSlip(LBNodeType):
    """Full-slip (specular reflection) wall (reference node_type.py:402)."""
    standard_macro = True
    needs_orientation = True


# --- density (pressure) BCs ------------------------------------------------

class _DensityBC(LBNodeType):
    needs_orientation = True
    wet_node = True
    param_names = ('density',)

    def __init__(self, density, orientation=None):
        self.params = {'density': density}
        self.orientation = orientation


@_register
class NTEquilibriumDensity(_DensityBC):
    """Full equilibrium reset at prescribed density
    (reference node_type.py:198)."""


@_register
class NTRegularizedDensity(_DensityBC):
    """Regularized (Latt-Chopard) prescribed density; PRE 77, 056703 (2008)
    (reference node_type.py:208)."""


@_register
class NTGuoDensity(_DensityBC):
    """Guo's extrapolation density BC (reference node_type.py:222)."""
    needs_orientation = True


@_register
class NTZouHeDensity(_DensityBC):
    """Zou-He prescribed density: non-equilibrium bounce-back
    (reference node_type.py:229)."""


# --- velocity BCs ----------------------------------------------------------

class _VelocityBC(LBNodeType):
    needs_orientation = True
    wet_node = True
    param_names = ('velocity',)

    def __init__(self, velocity, orientation=None):
        self.params = {'velocity': velocity}
        self.orientation = orientation


@_register
class NTEquilibriumVelocity(_VelocityBC):
    """Full equilibrium reset at prescribed velocity
    (reference node_type.py:246)."""


@_register
class NTZouHeVelocity(_VelocityBC):
    """Zou-He prescribed velocity (reference node_type.py:256)."""


@_register
class NTRegularizedVelocity(_VelocityBC):
    """Regularized prescribed velocity; PRE 77, 056703 (2008)
    (reference node_type.py:269)."""


# --- outflow ---------------------------------------------------------------

@_register
class NTGradFreeflow(LBNodeType):
    """Outflow via Grad's approximation (reference node_type.py:286)."""
    wet_node = True
    standard_macro = True
    scratch_space = ScratchSize(dim2=3, dim3=6)


@_register
class NTDoNothing(LBNodeType):
    """Outflow: unknown distributions keep their previous value
    (reference node_type.py:296)."""
    wet_node = True
    needs_orientation = True
    standard_macro = True


@_register
class NTCopy(LBNodeType):
    """Outflow: copy distributions from the neighbor along the inward
    normal (crude vanishing gradient; reference node_type.py:310)."""
    wet_node = True
    standard_macro = True
    needs_orientation = True


@_register
class NTYuOutflow(LBNodeType):
    """Open boundary of Yu, Mei & Shyy (2005): second-order extrapolation
    f_i(x) = 2 f_i(x+n) - f_i(x+2n) for unknown i
    (reference node_type.py:336)."""
    wet_node = True
    standard_macro = True
    needs_orientation = True


@_register
class NTNeumann(LBNodeType):
    """Neumann BC (Junk & Yang 2008); nonlocal (reference node_type.py:353)."""
    wet_node = True
    standard_macro = True
    needs_orientation = True
    param_names = ('gradient',)

    def __init__(self, gradient=0.0, orientation=None):
        self.params = {'gradient': gradient}
        self.orientation = orientation


@_register
class NTLaminarize(LBNodeType):
    """Average distributions perpendicular to a direction
    (reference node_type.py:385)."""
    needs_orientation = True
    wet_node = True
    standard_macro = True
    param_names = ('alpha',)

    def __init__(self, alpha, orientation=None):
        self.params = {'alpha': alpha}
        self.orientation = orientation


@_register
class NTExtendedCopy(LBNodeType):
    """Copy with a 4x4 affine transformation (extended periodic BC;
    reference node_type.py:320)."""
    wet_node = True
    standard_macro = True
    needs_orientation = True

    def __init__(self, transformation=None, orientation=None):
        assert transformation is not None and \
            np.asarray(transformation).shape == (4, 4), \
            'Invalid shape of transformation array'
        self.params = {'transformation': np.asarray(transformation)}
        self.orientation = orientation


# --- queries (reference node_type.py:419-434) ------------------------------

def get_node_type(type_id):
    return _NODE_TYPES[type_id]


def get_wet_node_type_ids(allow_unused=None):
    return [i for i, nt in _NODE_TYPES.items() if nt.wet_node and
            (allow_unused is None or nt.allow_unused == allow_unused)]


def get_dry_node_type_ids():
    return [i for i, nt in _NODE_TYPES.items() if not nt.wet_node]


def get_orientation_node_type_ids():
    return [i for i, nt in _NODE_TYPES.items() if nt.needs_orientation]


def get_link_tag_node_type_ids():
    return [i for i, nt in _NODE_TYPES.items() if nt.link_tags]


class DynamicValue:
    """Time/space-dependent BC parameter.

    The reference wraps sympy expressions in S.time / S.gx symbols
    (node_type.py:471-570); here a DynamicValue wraps python callables
    evaluated on-device inside the traced step:
      * ``fn(t)`` for pure time dependence, or
      * ``fn(t, hx, hy[, hz])`` for space(+time) dependence,
    where ``t`` is the iteration number (a traced scalar) and hx/hy/hz
    are the global coordinate arrays. Plain numbers are also accepted
    per component.
    """

    def __init__(self, *exprs):
        self.exprs = exprs

    def __iter__(self):
        return iter(self.exprs)

    @staticmethod
    def arity(expr):
        """Number of required (non-default) positional parameters."""
        if not callable(expr):
            return 0
        explicit = getattr(expr, '_dyn_arity', None)
        if explicit is not None:
            return explicit
        import inspect
        try:
            params = inspect.signature(expr).parameters.values()
        except (TypeError, ValueError):
            return 1
        return sum(1 for p in params
                   if p.default is inspect.Parameter.empty and
                   p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD))

    @staticmethod
    def evaluate(expr, t, coords):
        if not callable(expr):
            return expr
        nargs = DynamicValue.arity(expr)
        if nargs <= 1:
            return expr(t)
        return expr(t, *coords[:nargs - 1])


class SpatialArray:
    """Per-node BC parameter values usable inside DynamicValue
    expressions (reference node_type.py:627-671).

    ``values`` is a numpy array: a full-domain field (indexed by the
    node's global coordinates at evaluation time, so it works both for
    the whole-domain step and the fused engine's boundary windows) or a
    1-D profile along the ``index`` axis ('x'/'y'/'z'). Supports
    arithmetic composition with scalars and time/space callables:
    ``SpatialArray(profile) * (lambda t: ramp(t))``.
    """

    def __init__(self, values, index='x', where=None, dim=None):
        self.values = np.asarray(values, dtype=np.float64)
        self.index = index
        # `where` kept for API compatibility; values are read through
        # global coordinates, so no compaction is needed
        self.where = where
        if dim is None:
            if self.values.ndim > 1:
                dim = self.values.ndim
            else:
                dim = 3 if index == 'z' else 2
        #: evaluation arity: t + the coordinate arrays
        self._dyn_arity = 1 + dim

    def __call__(self, t, hx, hy, hz=None):
        import torch
        device = getattr(hx, 'device', None)
        # one copy per device, made at the first call: a time-dependent
        # parameter is evaluated every step
        cache = self.__dict__.setdefault('_on_device', {})
        if device not in cache:
            cache[device] = torch.as_tensor(self.values, device=device)
        v = cache[device]

        def ix(c):
            return torch.as_tensor(c, device=device).long()

        if self.values.ndim == 3:
            return v[ix(hz), ix(hy), ix(hx)]
        if self.values.ndim == 2:
            return v[ix(hy), ix(hx)]
        coord = {'x': hx, 'y': hy, 'z': hz}[self.index]
        return v[ix(coord)]

    # -- arithmetic composition ----------------------------------------------

    def _compose(self, other, op, swap=False):
        nargs = self._dyn_arity
        if callable(other):
            nargs = max(nargs, DynamicValue.arity(other))

        def fn(t, *coords):
            a = DynamicValue.evaluate(self, t, coords)
            b = DynamicValue.evaluate(other, t, coords) \
                if callable(other) else other
            return op(b, a) if swap else op(a, b)

        fn._dyn_arity = nargs
        return fn

    def __mul__(self, other):
        import operator
        return self._compose(other, operator.mul)

    __rmul__ = __mul__

    def __add__(self, other):
        import operator
        return self._compose(other, operator.add)

    __radd__ = __add__

    def __sub__(self, other):
        import operator
        return self._compose(other, operator.sub)

    def __rsub__(self, other):
        import operator
        return self._compose(other, operator.sub, swap=True)


class LinearlyInterpolatedTimeSeries(DynamicValue):
    """Periodic time series sampled at a fixed step, linearly interpolated
    (reference node_type.py:572-626)."""

    def __init__(self, data, step_size=1):
        data = np.asarray(data, dtype=np.float64)
        self.data = data
        self.step_size = step_size

        def fn(t, _data=data, _step=float(step_size)):
            import torch
            device = getattr(t, 'device', None)
            arr = torch.as_tensor(_data, device=device)
            pos = torch.as_tensor(t, dtype=arr.dtype, device=device) / _step
            n = arr.shape[0]
            i0 = torch.floor(pos).long() % n
            i1 = (i0 + 1) % n
            frac = pos - torch.floor(pos)
            return arr[i0] * (1.0 - frac) + arr[i1] * frac

        super().__init__(fn)


def multifield(values, where=None):
    """Collapse arrays/scalars into a structured per-node parameter record
    (API of reference node_type.py:436-470)."""
    shape = None
    new_values = []
    for val in values:
        if isinstance(val, np.ndarray):
            assert shape is None or shape == val.shape
            new_values.append(val.astype(np.float64))
            shape = val.shape
        else:
            new_values.append(None)
    assert shape is not None
    for i, (old, new) in enumerate(zip(values, new_values)):
        if new is None:
            arr = np.zeros(shape, dtype=np.float64)
            arr[:] = old
            new_values[i] = arr
    rec = np.rec.fromarrays(new_values)
    if where is not None:
        return rec[where]
    return rec.flatten()
