"""Simulation base classes: LBSim, LBForcedSim, field declarations, mixins.

API-compatible counterpart of the reference's ``sailfish/lb_base.py``
(LBSim :30, LBForcedSim :305, Field/ScalarField/VectorField :397-416,
ForceObject :418, LBMixIn :18); the port's copy of
``sailfish_tpu/models/base.py``. The numerics live in
``sailfish_tpu_torch/ops``; a sim class declares fields, options and
hooks, and configures a step builder.
"""

from __future__ import annotations

import numpy as np


class Field:
    def __init__(self, name, expr=None, need_nn=False, init=0.0,
                 gpu_array=False):
        self.name = name
        self.expr = expr
        self.need_nn = need_nn
        self.init = init
        self.abstract = False


class ScalarField(Field):
    pass


class VectorField(Field):
    pass


class LBMixIn:
    """Mixin hooks scanned by the runner (reference lb_base.py:18-28)."""
    aux_code = ()

    # subclasses may define: after_step(runner), before_main_loop(runner)


class LBSim:
    """Base class for simulations (reference lb_base.py:30-304)."""

    #: Subdomain subclass defining the scene geometry.
    subdomain = None
    #: Lattice dimensionality; set by concrete model classes.
    dim = None
    #: Number of distribution grids (1 single fluid, 2 binary, ...).
    grids = []

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument(
            '--dt_per_lattice_time_unit', type=float, default=1.0,
            help='physical time per lattice step: DynamicValue / '
            'time-series callables receive t = iteration * this '
            '(reference lb_base.py:55-57, boundary.mako:80-83)')

    @classmethod
    def modify_config(cls, config):
        pass

    @classmethod
    def update_defaults(cls, defaults):
        pass

    @classmethod
    def fields(cls):
        return []

    #: Host-side ``after_step`` cadence contract. The runner executes many
    #: iterations per chunk (cfg.every); hooks therefore fire once per
    #: CHUNK, not per iteration (unlike the reference's per-step call,
    #: subdomain_runner.py:1738-1743). A sim that genuinely needs
    #: every-k-iterations host hooks sets after_step_interval = k and the
    #: runner caps chunks to k-boundaries (logging the perf impact).
    #: Per-iteration *sampling* should instead use add_device_hook(),
    #: which runs on the device state inside the chunk, with no host
    #: round trip.
    after_step_interval = None

    def __init__(self, config):
        self.config = config
        self.iteration = 0
        self.need_sync_flag = False
        self.force_objects = []
        self._mixin_after_step = []
        self._mixin_before_main_loop = []
        self._device_hooks = []
        for klass in type(self).mro():
            if not issubclass(klass, LBMixIn) or issubclass(klass, LBSim):
                continue
            if 'after_step' in vars(klass):
                self._mixin_after_step.append(klass.after_step)
            if 'before_main_loop' in vars(klass):
                self._mixin_before_main_loop.append(klass.before_main_loop)

    def add_device_hook(self, init_state, fn, every=None, from_iter=0):
        """Register a DEVICE hook: ``fn(f, state, it) -> state`` runs on the
        device state after a step, with ``it`` the iteration count after
        that step and ``state`` a nested tuple / list / dict of tensors
        that starts as ``init_state`` (tensors, arrays or numbers, moved to
        the device). ``fn`` reads ``f`` and never writes it; it returns
        the new state (it may update its own state's tensors in place).
        The current states are ``runner.device_hook_state`` (a tuple, one
        entry per hook), written to checkpoints and restored with them.

        ``every``/``from_iter`` (optional) DECLARE the hook's sampling
        stride. When every registered hook declares one, the runner splits
        its chunks only where ``it >= from_iter and it % every == 0``
        holds for at least one hook and runs the hooks there; the engine
        runs unchanged between the splits. When any hook declares none,
        every hook runs after every step. Either way a hook may be called
        off its own stride, so it gates itself with a Python ``if`` on
        ``it``."""
        self._device_hooks.append((init_state, fn, every, from_iter))
        return len(self._device_hooks) - 1

    def need_output(self):
        """True when fields should be synced & written this iteration
        (reference lb_base.py:222-252)."""
        if self.config.output_required and self.config.every > 0:
            return self.iteration % self.config.every == 0
        return False

    def need_fields_sync(self):
        if self.need_sync_flag:
            self.need_sync_flag = False
            return True
        return self.need_output()

    def need_checkpoint(self):
        """(reference lb_base.py:254-260)"""
        cfg = self.config
        return (cfg.checkpoint_every > 0 and
                self.iteration >= getattr(cfg, 'checkpoint_from', 0) and
                (self.iteration % cfg.checkpoint_every) == 0 and
                bool(cfg.checkpoint_file))

    # hooks
    def before_main_loop(self, runner):
        pass

    def after_step(self, runner):
        pass

    def add_force_object(self, obj):
        """(reference lb_base.py:296-300)"""
        obj.id = len(self.force_objects)
        self.force_objects.append(obj)

    def register_checkpoint_object(self, name, obj):
        """Register an auxiliary object (e.g. TracerParticles) whose
        ``checkpoint_state()/restore_checkpoint_state()`` join the sim
        state saved in checkpoints. Objects are usually created in
        before_main_loop -- AFTER a restore ran -- so a pending restored
        state is applied here."""
        if not hasattr(self, '_checkpoint_objects'):
            self._checkpoint_objects = {}
        self._checkpoint_objects[name] = obj
        pending = getattr(self, '_pending_object_state', {})
        if name in pending:
            obj.restore_checkpoint_state(pending.pop(name))

    def get_state(self):
        """Complete pickled sim state (reference pickles sim state into
        the checkpoint, subdomain_runner.py:1414-1431): iteration plus
        any mixin state (classes defining ``checkpoint_state``) and
        registered auxiliary objects."""
        state = {'iteration': self.iteration}
        mixins = {}
        for klass in type(self).mro():
            if 'checkpoint_state' in vars(klass):
                mixins[klass.__name__] = klass.checkpoint_state(self)
        if mixins:
            state['mixins'] = mixins
        objs = getattr(self, '_checkpoint_objects', {})
        if objs:
            state['objects'] = {k: o.checkpoint_state()
                                for k, o in objs.items()}
        return state

    def set_state(self, state):
        self.iteration = int(state['iteration'])
        mixins = state.get('mixins', {})
        for klass in type(self).mro():
            if 'restore_checkpoint_state' in vars(klass) and \
                    klass.__name__ in mixins:
                klass.restore_checkpoint_state(self,
                                               mixins[klass.__name__])
        self._pending_object_state = {}
        objs = state.get('objects', {})
        for name, ostate in objs.items():
            obj = getattr(self, '_checkpoint_objects', {}).get(name)
            if obj is not None:
                obj.restore_checkpoint_state(ostate)
            else:
                self._pending_object_state[name] = ostate


class ForceObject:
    """Momentum-exchange force integration over a solid object's boundary
    links (Ladd, PRL 88:048301; reference lb_base.py:418-456).

    :param start:/:param end: N-tuples (x, y[, z]) bounding the object.
    ``force()`` returns the accumulated momentum exchange after the runner
    has called ``update_force_objects()``."""

    def __init__(self, start, end):
        self.start = tuple(start)
        self.end = tuple(end)
        self.id = None
        self._force = None

    def force(self):
        assert self._force is not None, \
            'runner.update_force_objects() has not run yet'
        return tuple(float(c) for c in self._force)

    def __str__(self):
        return f'ForceObject(id={self.id})'


class LBForcedSim(LBSim):
    """Adds constant body forces (reference lb_base.py:305-394)."""

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--force_implementation', type=str,
                           choices=['guo', 'edm', 'velocity_shift'],
                           default='guo',
                           help='how body forces enter the collision '
                           '(reference lb_base.py:325-328): guo '
                           '(2nd-order, default), edm (exact difference '
                           'method), velocity_shift (Shan-Chen-style '
                           'tau-scaled equilibrium shift)')

    def __init__(self, config):
        super().__init__(config)
        self._forces = {}
        self._eq_force_map = {}

    def add_body_force(self, force, grid=0, accel=True):
        """Accumulate a body force (acceleration if accel=True; with
        accel=False the value is a force density, identical for the rho~1
        scenes that use it) on distribution grid ``grid``.

        ``force`` may be a constant (dim,) vector or a DynamicValue of
        per-component time/space callables (reference lb_base.py:346-352
        accepts sympy expressions of S.time / S.gx); dynamic forces are
        evaluated on device each step by the engine (StepBuilder.force_at).
        Mixed constant+dynamic accumulation composes into a DynamicValue.
        """
        from sailfish_tpu_torch import node_type as nt
        prev = self._forces.get(grid)
        dyn_new = isinstance(force, nt.DynamicValue) or \
            any(callable(c) for c in tuple(force))
        if not dyn_new and not isinstance(prev, nt.DynamicValue):
            f = np.asarray(force, dtype=np.float64)
            self._forces[grid] = f if prev is None else prev + f
            return

        def expr_sum(a, b):
            if not callable(a) and not callable(b):
                return float(a) + float(b)
            arity = max(nt.DynamicValue.arity(a),
                        nt.DynamicValue.arity(b), 1)

            def combined(t, *coords):
                return (nt.DynamicValue.evaluate(a, t, coords)
                        + nt.DynamicValue.evaluate(b, t, coords))
            combined._dyn_arity = arity
            return combined

        exprs = tuple(force)
        if prev is not None:
            prev_exprs = tuple(prev)
            if len(prev_exprs) != len(exprs):
                raise ValueError(
                    f'body force on grid {grid} has {len(prev_exprs)} '
                    f'components; cannot accumulate {len(exprs)}')
            exprs = tuple(expr_sum(a, b)
                          for a, b in zip(prev_exprs, exprs))
        self._forces[grid] = nt.DynamicValue(*exprs)

    def use_force_for_equilibrium(self, force_grid, target_grid):
        """Select which grid's body force shifts the velocity used in
        ``target_grid``'s equilibrium: force_grid=None means the bare
        fluid velocity (reference lb_base.py:341-367)."""
        self._eq_force_map[target_grid] = force_grid

    def body_force(self, grid=0):
        return self._forces.get(grid)
