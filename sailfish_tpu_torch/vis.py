"""Visualization engine base class and registry.

Port of ``sailfish_tpu/vis.py`` (the reference's ``sailfish/vis.py``,
FluidVis :8,23): ``--mode=visualization`` builds the engine named by
``--vis_engine`` and the runner calls its ``update`` after each output
event. The port's engine is the headless matplotlib frame writer
(``vis_mpl``); the live slice server is ``vis_mixin``.
"""

from __future__ import annotations


class FluidVis:
    """Base class for visualization engines."""

    name = None

    def __init__(self, config, fields_fn):
        """:param fields_fn: callable returning {name: host array, or a
        list of components for a vector field}."""
        self.config = config
        self.fields_fn = fields_fn

    def update(self, iteration):
        raise NotImplementedError


_ENGINES = {}


def register_engine(cls):
    _ENGINES[cls.name] = cls
    return cls


def engine_by_name(name):
    if name not in _ENGINES:
        from sailfish_tpu_torch import vis_mpl  # noqa: F401  (registers 'mpl')
    try:
        return _ENGINES[name]
    except KeyError:
        raise ValueError(f'unknown vis engine {name!r}; '
                         f'known: {sorted(_ENGINES)}') from None
