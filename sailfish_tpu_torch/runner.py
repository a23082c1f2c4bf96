"""Simulation runner of the port: device state, the step engine and the
main loop.

Port of a subset of ``sailfish_tpu/runner.py`` (``SubdomainRunner``): one
whole-domain state (a tensor, or a K-tuple of tensors for the
multi-component models) on one device, or sharded over a mesh of one or
two axes (``--mesh``), a chunked main loop with the same MLUPS /
``TimingInfo`` accounting, npz output through the port's writers and
checkpoints in the JAX package's npz layout (``dist0a`` ...
``dist{K-1}a``, ``state``, ``sim_state``), so a JAX checkpoint restores
here and back.

Two engines run the step: ``torch`` (``ops/step.StepBuilder`` or the
``ops/multigrid`` builders, plain tensor code) and ``kernel`` (the CUDA
kernels: ``ops/lbm_step.KernelStep`` for a single fluid,
``ops/sc_multi.SCMultiStep`` for a Shan-Chen mixture,
``ops/fe_step.FEStep`` for the binary free-energy model). There is no
silent fallback between them: a requested or defaulted kernel engine that
cannot run a scene raises with the reasons. The immersed-boundary model's
state is the pair (f, positions) (``ops/ibm.IBMStepBuilder``, on the torch
engine only); checkpoints store it as ``dist0a`` / ``dist1a``, the JAX
runner's leaf order. Under ``--mode=visualization`` the controller gives
the runner an engine (``vis``), updated after each output event
(``sailfish_tpu/runner.py:768-769``).

Device hooks (``sim.add_device_hook``) run on both engines: each chunk is
split at the iterations where a declared stride fires (after every step
when a hook declares none), the engine runs unchanged between the splits,
and the hooks are called there on the device state; their states are
``device_hook_state`` and travel in checkpoints as ``hook{i}``, as the JAX
runner writes them (``sailfish_tpu/runner.py:191-261``, :503-521).
Momentum-exchange force objects (``update_force_objects``), the
consistent initialization of ``--init_iters`` (on the scene's own engine)
and ``--profile_trace`` (a ``torch.profiler`` Chrome trace) run on both
engines, as ``sailfish_tpu/runner.py:423-493``, :556-607 and :643-649
define them.

``--mesh=N`` (``sailfish_tpu/runner.py:84-93``, :96-160) shards a scene
along z (3D) or y (2D) over N devices on either engine, ``--mesh=AxB``
along ('z', 'y') or ('y', 'x') over A x B devices: a single-fluid
``StepBuilder`` scene, single-component Shan-Chen included, through
``parallel/halo.ShardedStep``, a Shan-Chen mixture or the free-energy
model through ``parallel/halo_multi.ShardedMultiStep`` (each shard's slab
with ghost planes, the scene's own step on it, the ghost-plane exchange,
and for the couplings the density exchange between the pre-pass and the
step); the state then lives in ``Sharded`` slabs, and ``f`` is their
global gather (checkpoints with every component, output, hooks and the
scene's own hooks see the global state, in the layout of an unsharded
run). The outflow family runs on a mesh (its laminarize plane means
over the whole mesh, ``parallel/halo.MeshLaminarize``), and force objects
read their windows from the shards (``ShardedStep.gather_box``), both with
the unsharded run's bits. What cannot be sharded is refused by name
(``parallel/halo.mesh_reasons``: meshes of three axes, Shan-Chen with a
BC row, ``NTExtendedCopy``, an outflow row whose samples reach past a
shard's interior, immersed-boundary scenes, composite steps).
"""

from __future__ import annotations

import os
import pickle
import signal
import threading
import time

import numpy as np
import torch

from sailfish_tpu_torch import io as sio
from sailfish_tpu_torch import state as st
from sailfish_tpu_torch import util
from sailfish_tpu_torch.profile import TimeProfile


class SubdomainRunner:
    """Runs one simulation on one device."""

    def __init__(self, sim, geo, output=None, quit_event=None):
        self.sim = sim
        self.config = sim.config
        self.geo = geo
        self._output = output
        self._quit_event = quit_event or util.SimpleEvent()
        self.profile = TimeProfile(self)
        self.kernel = None
        #: the ``parallel/halo.ShardedStep`` (or ``halo_multi.
        #: ShardedMultiStep``) of a run on a mesh, else None
        self.stepper = None
        self.mesh = None
        self._f = None
        self._sharded = None
        #: the ``--mode=visualization`` engine (``vis.FluidVis``), updated
        #: after each output event; None otherwise
        self.vis = None

    # -- the state -----------------------------------------------------------

    @property
    def f(self):
        """The state: on a mesh the global gather of the ``Sharded`` state
        (kept until the next step). Set it to a global state, or on a mesh
        to a ``Sharded`` one."""
        if self.stepper is not None and self._f is None:
            self._f = self.stepper.gather(self._sharded)
        return self._f

    @f.setter
    def f(self, value):
        if self.stepper is None:
            self._f = value
            return
        self._sharded = self.stepper.as_sharded(value)
        self._f = None

    @property
    def state(self):
        """The state as the engine steps it: ``f``, or on a mesh the
        ``Sharded`` state (no gather)."""
        return self.f if self.stepper is None else self._sharded

    # -- initialization ------------------------------------------------------

    def _domain_shape(self):
        cfg = self.config
        if self.sim.dim == 2:
            return (cfg.lat_ny, cfg.lat_nx)
        return (cfg.lat_nz, cfg.lat_ny, cfg.lat_nx)

    def _init_geometry(self):
        shape = self._domain_shape()
        spec = self.geo.subdomains()[0].__class__(
            (0,) * self.sim.dim, tuple(reversed(shape)))
        self._subdomain = self.sim.subdomain(
            shape, spec, self.sim.grid, self.config)
        self._subdomain.reset()
        self.maps = self._subdomain.maps

    def _init_fields(self):
        self.sim.init_fields(self._domain_shape())
        args = self._subdomain._get_mgrid()
        self._subdomain.initial_conditions(self.sim, *args)

    def _init_mesh(self):
        """The mesh of ``--mesh`` (None without one), after refusing by
        name what cannot be sharded; on the CPU every shard is on the CPU
        device."""
        from sailfish_tpu_torch.parallel import halo
        from sailfish_tpu_torch.parallel import mesh as pmesh
        shape = pmesh.parse_mesh_shape(getattr(self.config, 'mesh', ''),
                                       self.sim.dim)
        if shape is None:
            return None
        reasons = halo.mesh_reasons(shape, self.sim.dim, self.builder)
        if reasons:
            raise NotImplementedError(
                'not ported to sailfish_tpu_torch on a mesh (--mesh) yet: '
                + '; '.join(reasons))
        devices = None
        if self.device.type == 'cpu':
            devices = [self.device] * int(np.prod(shape))
        mesh = pmesh.make_mesh(shape, self.sim.dim, devices)
        pmesh.validate_divisible(self._domain_shape(), mesh)
        return mesh

    def _sharded_engine(self, builder):
        """The sharded step of ``builder`` over the mesh on the runner's
        engine: ``parallel/halo_multi.ShardedMultiStep`` for a Shan-Chen
        mixture or the free-energy model (``sailfish_tpu/runner.py:96-146``),
        else ``parallel/halo.ShardedStep``."""
        from sailfish_tpu_torch.ops.multigrid import (
            FreeEnergyStepBuilder, ShanChenMultiStepBuilder)
        from sailfish_tpu_torch.parallel import halo
        if isinstance(builder, (ShanChenMultiStepBuilder,
                                FreeEnergyStepBuilder)):
            from sailfish_tpu_torch.parallel.halo_multi import \
                ShardedMultiStep
            return ShardedMultiStep(builder, self._domain_shape(), self.mesh,
                                    self.engine)
        return halo.ShardedStep(builder, self._domain_shape(), self.mesh,
                                self.engine)

    def _init_state(self):
        cfg = self.config
        self.device = cfg.device
        dtype = cfg.dtype
        self.builder = self.sim.make_step_builder(self.maps, dtype,
                                                  self.device)
        if cfg.precision == 'mixed' \
                and getattr(self.builder, 'mixed', None) is None:
            raise NotImplementedError(
                '--precision=mixed covers single-fluid scenes only: '
                'the minority component of a mixture lives at near-'
                'vacuum density where the int16 step is comparable to '
                'the distribution value itself -- measured unusable at '
                'every --mixed_range (8.5-21% surface-tension error, '
                '>10% mass drift; regtest/mixed_multiphase_probe.py). '
                'Use --precision=single')
        self.f = self._snap(self.sim.make_initial_state(self.builder, dtype))
        self.engine = self._select_engine()
        self.device_hook_state = ()
        self._pending_hook_leaves = None
        self.mesh = self._init_mesh()
        if self.mesh is not None:
            f = self.f
            self.stepper = self._sharded_engine(self.builder)
            if self.engine == 'kernel':
                self.kernel = self.stepper
            self._run_steps = self.stepper.run
            self.f = f
        elif self.engine == 'kernel':
            self.kernel = self._kernel_engine()
            self._run_steps = self.kernel.run
        else:
            step = self.builder.build()

            def run_steps(f, n, it0=0):
                # step i of the chunk computes iteration it0 + i
                # (sailfish_tpu/runner.py:191-209)
                for i in range(n):
                    f = step(f, it0 + i)
                return f

            self._run_steps = run_steps

    def _snap(self, f):
        """``f`` on the int16 grid under --precision=mixed (once, so that
        both engines and any restart step from the same codes:
        ``sailfish_tpu/runner.py:79-83``, :541-546); else ``f``."""
        mixed = getattr(self.builder, 'mixed', None)
        return f if mixed is None else mixed.snap(f)

    def _kernel_engine(self, builder=None):
        """The kernel engine of ``builder``'s model (default the runner's
        builder); it raises, naming the reasons, when its kernel cannot
        run the scene (also when the builder is none of the port's step
        builders, as a scene's own composite step is)."""
        from sailfish_tpu_torch.ops.multigrid import (
            FreeEnergyStepBuilder, ShanChenMultiStepBuilder)
        from sailfish_tpu_torch.ops.step import StepBuilder
        builder = builder or self.builder
        if isinstance(builder, ShanChenMultiStepBuilder):
            from sailfish_tpu_torch.ops.sc_multi import SCMultiStep
            return SCMultiStep(builder)
        if isinstance(builder, FreeEnergyStepBuilder):
            from sailfish_tpu_torch.ops.fe_step import FEStep
            return FEStep(builder)
        from sailfish_tpu_torch.ops.ibm import IBMStepBuilder
        if isinstance(builder, IBMStepBuilder):
            raise NotImplementedError(
                'the CUDA kernels cannot run an immersed-boundary scene '
                '(IBMStepBuilder: the particles\' spring force enters every '
                'step, and the JAX runner keeps a StepBuilder subclass off '
                'its fused kernels, sailfish_tpu/runner.py:328); '
                '--engine=torch runs it')
        # type-exact: a subclass of StepBuilder changes the step, and the
        # kernel would run the plain fluid step without it
        if type(builder) is not StepBuilder:
            raise NotImplementedError(
                'the CUDA kernels cannot run this scene: its step builder '
                f'{type(builder).__name__} is not a StepBuilder, '
                'ShanChenMultiStepBuilder or FreeEnergyStepBuilder (a '
                'composite step); --engine=torch runs it')
        from sailfish_tpu_torch.ops.lbm_step import KernelStep
        return KernelStep(builder)

    def _consistent_init(self):
        """--init_iters (``sailfish_tpu/runner.py:556-607``): N steps at
        nu = 1/6 on the scene's own engine with the iteration pinned to 0
        (time-dependent values see t = 0), so that the density relaxes to
        a pressure field consistent with the initial velocity field; then
        the state is rebuilt as feq(rho_relaxed, u_IC) with the model's
        equilibrium, the velocity held at the user's initial conditions.
        Single-fluid ``StepBuilder`` scenes only, and not under
        --precision=mixed, with the JAX runner's reasons."""
        n = int(getattr(self.config, 'init_iters', 0) or 0)
        if n <= 0:
            return
        from sailfish_tpu_torch.ops.step import StepBuilder
        if type(self.builder) is not StepBuilder:
            raise NotImplementedError(
                '--init_iters covers single-fluid scenes only '
                f'(got {type(self.builder).__name__})')
        if getattr(self.builder, 'mixed', None) is not None:
            raise NotImplementedError(
                '--init_iters does not combine with mixed int16 '
                'storage; initialize at --precision=single')
        log = util.get_logger(self.config)
        log.info('Consistent initialization started (%d iterations at '
                 'nu=1/6).', n)
        visc = self.config.visc
        self.config.visc = 1.0 / 6.0
        try:
            init_b = self.sim.make_step_builder(self.maps, self.config.dtype,
                                                self.device)
            f = self.f
            if self.mesh is not None:
                sharded = self._sharded_engine(init_b)
                s = sharded.shard(f)
                for _ in range(n):
                    s = sharded.run(s, 1, 0)
                f = sharded.gather(s)
            elif self.engine == 'kernel':
                ks = self._kernel_engine(init_b)
                for _ in range(n):
                    f = ks.run(f, 1, 0)
            else:
                step = init_b.build()
                for _ in range(n):
                    f = step(f, 0)
            rho, _u = init_b.macro_fields(f)
            u_ic = torch.as_tensor(np.stack(self.sim.velocity_components()),
                                   dtype=self.config.dtype,
                                   device=self.device)
            self.f = self.builder.feq(rho, u_ic)
        finally:
            self.config.visc = visc
        log.info('Initialization phase complete.')

    # -- force objects (momentum exchange) -----------------------------------

    def _init_force_objects(self):
        """The boundary links of each force object
        (``sailfish_tpu/runner.py:423-483``): in the object's bounding box
        widened by one node (cut at the domain), for each direction i the
        (window-shaped) mask of the links from a wet node x_f to a dry
        node x_f + c_i, as device tensors (``_force_specs``: (window,
        links) per object); and the global coordinates of the window
        widened by one more node on every side (periodic), the block
        ``update_force_objects`` reads (``_force_boxes``)."""
        self._force_specs = []
        self._force_boxes = []
        if not self.sim.force_objects:
            return
        from sailfish_tpu_torch import node_type as nt
        g = self.sim.grid
        m = self.maps
        dim = self.sim.dim
        wet_types = [t for t in m.present_types
                     if nt.get_node_type(t).wet_node]
        shape = m.type_map.shape
        for fo in self.sim.force_objects:
            # the box in (x, y[, z]); the array axes are (.., z, y, x)
            window = tuple(
                slice(max(lo - 1, 0), min(hi + 2, n))
                for lo, hi, n in zip(reversed(fo.start), reversed(fo.end),
                                     shape))
            idx = [np.arange(w.start - 1, w.stop + 1) % n
                   for w, n in zip(window, shape)]
            # dry nodes over the window widened by one node (periodic):
            # the window's nodes and their neighbours x + c_i
            solid = torch.as_tensor(~np.isin(m.type_map[np.ix_(*idx)],
                                             wet_types))
            inner = tuple(slice(1, len(i) - 1) for i in idx)
            links = []
            for i in range(1, g.Q):
                c = [int(g.basis[i][dim - 1 - ax]) for ax in range(dim)]
                neigh = solid[tuple(slice(1 + ca, len(ia) - 1 + ca)
                                    for ca, ia in zip(c, idx))]
                link = ~solid[inner] & neigh
                if link.any():
                    links.append((i, link.to(self.device)))
            self._force_specs.append((window, links))
            self._force_boxes.append(idx)

    def _force_block(self, idx):
        """The state over the global coordinates ``idx`` (one array per
        axis), (Q, *lengths): on a mesh copied from the shards' interiors
        (``ShardedStep.gather_box``: no global gather), else from ``f``."""
        if self.stepper is not None:
            return self.stepper.gather_box(self._sharded, idx)
        from sailfish_tpu_torch.parallel.halo import copy_box
        f = st.leaves(self.f)[0]
        out = torch.empty((f.shape[0],) + tuple(len(i) for i in idx),
                          dtype=f.dtype, device=f.device)
        copy_box(out, f, [(np.arange(len(i)), i) for i in idx])
        return out

    def update_force_objects(self):
        """Each force object's momentum exchange on the post-collision
        state f, F = sum over its links c_i [f_i(x_f) + f_opp(i)(x_f +
        c_i)] (``sailfish_tpu/runner.py:485-493``; Ladd 1994): one sum per
        link direction on the device, in fp32 as the JAX runner sums them,
        the sums brought to the host together and F accumulated over the
        directions in their order in fp32; the result is the object's
        ``force()``. Each object reads only the block of its window widened
        by one node (``_force_block``), on a mesh too, so a sharded run's
        forces have the unsharded run's bits. Nothing without force
        objects."""
        if not getattr(self, '_force_specs', None):
            return
        g = self.sim.grid
        dim = self.sim.dim
        sums = []
        for (_window, links), idx in zip(self._force_specs,
                                         self._force_boxes):
            block = self._force_block(idx)
            inner = tuple(slice(1, len(i) - 1) for i in idx)
            for i, link in links:
                o = int(g.opposite[i])
                c = [int(g.basis[i][dim - 1 - ax]) for ax in range(dim)]
                f_in = block[o][tuple(slice(1 + ca, len(ia) - 1 + ca)
                                      for ca, ia in zip(c, idx))]
                sums.append(torch.where(link, block[i][inner] + f_in,
                                        0.0).sum())
        sums = torch.stack(sums).cpu().numpy() if sums else []
        k = 0
        for fo, (_window, links) in zip(self.sim.force_objects,
                                         self._force_specs):
            force = np.zeros(dim, dtype=np.float32)
            for i, _link in links:
                for a in range(dim):
                    c = int(g.basis[i][a])
                    if c:
                        force[a] = force[a] + np.float32(c) * sums[k]
                k += 1
            fo._force = force

    def _select_engine(self):
        """'kernel' = the model's CUDA kernels; 'torch' = the plain
        tensor step. ``auto`` picks the kernel on a CUDA device and
        the torch step on the CPU; whether the kernel can run the scene is
        checked when it is built, and a refusal raises."""
        choice = getattr(self.config, 'engine', 'auto')
        if choice == 'torch':
            return 'torch'
        if self.device.type == 'cuda':
            return 'kernel'
        if choice == 'kernel':
            raise RuntimeError(
                '--engine=kernel needs a CUDA device; this run is on '
                f'{self.device}')
        return 'torch'

    # -- output & checkpoint -------------------------------------------------

    def macro_fields(self):
        """The output fields of the state at the current iteration, on the
        device: the builder's ``macro_fields`` or, on a mesh, the sharded
        step's (per shard, gathered: no global copy of the state). Output,
        tracers and visualization read them, whichever engine steps."""
        with torch.no_grad():
            return (self.stepper or self.builder).macro_fields(
                self.state, self.sim.iteration)

    def _fields_to_host(self):
        self.sim.update_host_fields(self.macro_fields())

    def _output_fields(self):
        self._fields_to_host()
        if self._output is not None:
            self._output.save(self.sim.iteration)

    def save_checkpoint(self):
        """Distributions (``dist{i}a``, one per state component) +
        pickled sim state + the device-hook states' leaves (``hook{i}``,
        in ``state.tree_leaves`` order), in the JAX package's npz layout
        (``sailfish_tpu/runner.py:503-521``)."""
        fname = sio.checkpoint_filename(
            self.config.checkpoint_file,
            sio.filename_iter_digits(self.config.max_iters), 0,
            self.sim.iteration)
        dists = {f'dist{i}a': st.state_to_numpy(f)
                 for i, f in enumerate(st.leaves(self.f))}
        hooks = {f'hook{i}': np.asarray(st.state_to_numpy(leaf)
                                        if torch.is_tensor(leaf) else leaf)
                 for i, leaf in enumerate(
                     st.tree_leaves(self.device_hook_state))}
        np.savez(fname,
                 state=np.array([self.sim.iteration], dtype=np.int64),
                 sim_state=np.frombuffer(pickle.dumps(self.sim.get_state()),
                                         dtype=np.uint8),
                 **dists, **hooks)

    def restore_checkpoint(self, fname):
        """Restore a checkpoint written by either package. ``sim_state``
        is unpickled: restore only checkpoints this program wrote."""
        cpoint = np.load(fname, allow_pickle=False)
        if 'sim_state' in cpoint:
            self.sim.set_state(pickle.loads(cpoint['sim_state'].tobytes()))
        else:
            self.sim.iteration = int(cpoint['state'][0])
        if not getattr(self.config, 'restore_time', True):
            self.sim.iteration = 0
        # the hooks are registered in before_main_loop, after the restore:
        # their leaves are laid over the hooks' states then (_init_hooks)
        self._pending_hook_leaves = [
            cpoint[k] for k in sorted(
                (k for k in cpoint.files if k.startswith('hook')),
                key=lambda k: int(k[4:]))]
        n = sum(1 for k in cpoint.files
                if k.startswith('dist') and k.endswith('a'))
        self.f = st.from_leaves(self.f, [
            st.state_from_numpy(cpoint[f'dist{i}a'], self.device,
                                self.config.dtype) for i in range(n)])
        # a mixed checkpoint is on the grid already (the identity); an
        # fp32 one restored into a mixed run is snapped once
        self.f = self._snap(self.f)

    # -- main loop -----------------------------------------------------------

    def run(self):
        self._init_geometry()
        self._init_fields()
        self._init_state()
        if not self.config.restore_from:
            with torch.no_grad():
                self._consistent_init()
        self._init_force_objects()
        if self._output is not None:
            self._output.register_field(self.maps.type_map, 'node_type')
            if getattr(self.config, 'debug_dump_node_type_map', False):
                self._output.dump_node_type(self.maps.type_map)
        if self.config.restore_from:
            self.restore_checkpoint(
                sio.resolve_checkpoint(self.config.restore_from))
        self.sim.before_main_loop(self)
        for hook in self.sim._mixin_before_main_loop:
            hook(self.sim, self)
        self._init_hooks()
        trace_dir = getattr(self.config, 'profile_trace', '')
        with torch.no_grad():
            if trace_dir:
                return self._traced_main(trace_dir)
            return self.main()

    def _traced_main(self, trace_dir):
        """``main`` under ``torch.profiler`` (CPU activity, and CUDA
        activity on a CUDA device), the trace written into ``trace_dir``
        as a Chrome trace (``lbm_<pid>_<time>.pt.trace.json``): the
        counterpart of the JAX runner's ``jax.profiler.trace``
        (``sailfish_tpu/runner.py:643-649``)."""
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            result = self.main()
        prof.export_chrome_trace(os.path.join(
            trace_dir, f'lbm_{os.getpid()}_{int(time.time())}.pt.trace.json'))
        return result

    # -- device hooks --------------------------------------------------------

    def _hook_leaf(self, x):
        """A leaf of a hook's initial state as a tensor of its own on the
        device: a tensor keeps its dtype; a numpy array or a Python number
        takes the dtype JAX gives it (64-bit only under
        ``--precision=double``, where the JAX package runs with x64 on)."""
        if torch.is_tensor(x):
            return x.detach().to(self.device).clone()
        a = np.asarray(x)
        if self.config.dtype != torch.float64:
            a = a.astype({np.dtype(np.float64): np.float32,
                          np.dtype(np.int64): np.int32}.get(a.dtype, a.dtype))
        elif a.dtype.kind == 'i':
            a = a.astype(np.int64)
        return torch.as_tensor(a, device=self.device).clone()

    def _init_hooks(self):
        """Give the hooks registered by ``before_main_loop`` their initial
        states (with a restored checkpoint's ``hook{i}`` leaves laid over
        them) and split the main loop's chunks for them."""
        hooks = self.sim._device_hooks
        pending = self._pending_hook_leaves or []
        self._pending_hook_leaves = None
        if not hooks:
            if pending:
                raise ValueError(
                    f'the checkpoint holds {len(pending)} device-hook '
                    'leaves and this scene registers no device hook')
            return
        state = tuple(st.tree_map(self._hook_leaf, init)
                      for init, _fn, _e, _f in hooks)
        if pending:
            leaves = st.tree_leaves(state)
            if len(pending) != len(leaves) or any(
                    tuple(p.shape) != tuple(leaf.shape)
                    for p, leaf in zip(pending, leaves)):
                raise ValueError(
                    'the checkpoint\'s device-hook state does not match the '
                    'registered hooks: leaves of shapes '
                    f'{[tuple(p.shape) for p in pending]} for '
                    f'{[tuple(leaf.shape) for leaf in leaves]}')
            state = st.tree_unflatten(state, [
                torch.as_tensor(p, dtype=leaf.dtype, device=leaf.device)
                for p, leaf in zip(pending, leaves)])
        self.device_hook_state = state
        self._run_steps = self._hooked_run(self._run_steps)

    def hook_iterations(self, it0, n):
        """The iterations of the chunk of ``n`` steps after ``it0`` (the
        count after each step, it0 + 1 ... it0 + n) after which the hooks
        run: those where ``it >= from_iter and it % every == 0`` holds for
        at least one hook when every hook declares ``every``, else all of
        them (``sailfish_tpu/runner.py:238-251``)."""
        hooks = self.sim._device_hooks
        if any(every is None for _i, _fn, every, _f in hooks):
            return list(range(it0 + 1, it0 + n + 1))
        fire = set()
        for _i, _fn, every, from_iter in hooks:
            lo = max(it0 + 1, from_iter)
            fire.update(range(-(-lo // every) * every, it0 + n + 1, every))
        return sorted(fire)

    def _hooked_run(self, run):
        """``run`` (the engine's ``run(f, n, it0)``) split at the hooks'
        iterations, the hooks called there as ``fn(f, state, it)`` with
        ``it`` the iteration count after the step; each returns its new
        state and must not write ``f``. On the kernel engine under
        --precision=mixed the int16 buffers are stepped across the splits
        (``KernelStep.run_codes``: no quantize round trip is added) and the
        hooks see their dequantized copy."""
        fns = [fn for _i, fn, _e, _f in self.sim._device_hooks]
        codes = None   # the KernelStep (or ShardedStep) stepping int16 codes
        if getattr(self.kernel, 'mixed', None) is not None:
            codes = self.kernel
            run = codes.run_codes
        stepper = self.stepper

        def run_steps(f, n, it0=0):
            if codes is not None:
                f = codes.codes_of(f)
            pos = it0
            for it in self.hook_iterations(it0, n):
                f = run(f, it - pos, pos)
                pos = it
                # on a mesh the hooks see the global state, gathered
                view = f if stepper is None else stepper.gather(f)
                if codes is not None:
                    view = codes.mixed.dequant(view)
                self.device_hook_state = tuple(
                    fn(view, s, it)
                    for fn, s in zip(fns, self.device_hook_state))
            if pos < it0 + n:
                f = run(f, it0 + n - pos, pos)
            return f if codes is None else codes.state_of(f)

        return run_steps

    def _synchronize(self):
        """Wait for the device, or for every device of the mesh."""
        devices = [self.device] if self.mesh is None else \
            list(dict.fromkeys(self.mesh.devices))
        for d in devices:
            util.synchronize(d)

    def _install_sighup_checkpoint(self):
        """SIGHUP forces an on-demand checkpoint."""
        if threading.current_thread() is not threading.main_thread():
            return
        if not self.config.checkpoint_file:
            return

        def handler(signum, frame):
            self._checkpoint_requested = True

        signal.signal(signal.SIGHUP, handler)

    def _next_chunk(self):
        """Steps until the next host interaction
        (``sailfish_tpu/runner.py:703-731``)."""
        cfg = self.config
        sim = self.sim
        remaining = cfg.max_iters - sim.iteration
        chunk = cfg.every if cfg.every > 0 else remaining
        if cfg.every > 0:
            chunk = min(chunk, cfg.every - sim.iteration % cfg.every)
        interval = getattr(sim, 'after_step_interval', None)
        if interval:
            chunk = min(chunk, interval - sim.iteration % interval)
        if cfg.checkpoint_every > 0:
            chunk = min(chunk, cfg.checkpoint_every
                        - sim.iteration % cfg.checkpoint_every)
        if cfg.mode == 'benchmark' and cfg.benchmark_minibatch > 0 \
                and sim.iteration >= cfg.benchmark_sample_from:
            chunk = min(chunk, cfg.benchmark_minibatch)
        return max(1, min(chunk, remaining))

    def main(self):
        cfg = self.config
        sim = self.sim
        log = util.get_logger(cfg)
        self._checkpoint_requested = False
        self._install_sighup_checkpoint()
        total_nodes = int(np.prod(self._domain_shape()))
        bench_t0 = None
        bench_iters0 = 0
        bench_samples = []
        t_start = time.time()
        #: per-chunk MLUPS, each chunk timed between device synchronizations
        self.mlups_history = []

        while sim.iteration < cfg.max_iters:
            if self._quit_event.is_set():
                break
            chunk = self._next_chunk()
            self._synchronize()
            t0 = time.perf_counter()
            self.f = self._run_steps(self.state, chunk, sim.iteration)
            self._synchronize()
            t1 = time.perf_counter()
            self.profile.record(TimeProfile.COMP, t1 - t0)
            sim.iteration += chunk
            mlups = total_nodes * chunk / (t1 - t0) / 1e6
            self.mlups_history.append(mlups)
            if cfg.mode == 'benchmark' and \
                    sim.iteration >= cfg.benchmark_sample_from:
                if bench_t0 is None:
                    bench_t0 = t1
                    bench_iters0 = sim.iteration
                else:
                    bench_samples.append(mlups)
            if cfg.check_invalid_results_gpu and \
                    not (self.stepper or st).is_finite(self.state):
                log.error('invalid results (NaN/Inf) on device at '
                          'iteration %d; aborting', sim.iteration)
                break
            if not cfg.quiet and cfg.perf_stats_every > 0 and \
                    (sim.iteration % cfg.perf_stats_every) < chunk:
                log.info('iteration:%d speed:%.2f MLUPS',
                         sim.iteration, mlups)
            if sim.need_output():
                with self.profile.phase(TimeProfile.SYNC):
                    self._fields_to_host()
                with self.profile.phase(TimeProfile.OUTPUT):
                    if self._output is not None:
                        self._output.save(sim.iteration)
                        if getattr(cfg, 'debug_dump_dists', False):
                            self._output.dump_dists(
                                [st.state_to_numpy(f)
                                 for f in st.leaves(self.f)],
                                sim.iteration)
                if self.vis is not None:
                    self.vis.update(sim.iteration)
                if cfg.check_invalid_results_host and \
                        not np.all(np.isfinite(sim.rho)):
                    log.error('invalid results (NaN/Inf) detected; '
                              'aborting')
                    break
            sim.after_step(self)
            for hook in sim._mixin_after_step:
                hook(sim, self)
            if sim.need_checkpoint() or self._checkpoint_requested:
                self._checkpoint_requested = False
                with self.profile.phase(TimeProfile.CHECKPOINT):
                    self.save_checkpoint()

        if cfg.mode == 'benchmark':
            self.profile.summary(total_nodes, sim.iteration, log)
            if len(bench_samples) > 1:
                log.info('MLUPS minibatches: mean=%.1f std=%.1f n=%d',
                         float(np.mean(bench_samples)),
                         float(np.std(bench_samples)), len(bench_samples))
        if cfg.final_checkpoint and cfg.checkpoint_file:
            self.save_checkpoint()
        if cfg.output and cfg.every <= 0:
            self._output_fields()
        if self._output is not None:
            self._output.close()
        elapsed = time.time() - t_start
        hist = self.mlups_history
        result = util.TimingInfo(
            iters=sim.iteration, elapsed=elapsed,
            mlups=np.mean(hist[1:]) if len(hist) > 1
            else (hist[0] if hist else 0.0))
        if bench_t0 is not None and sim.iteration > bench_iters0:
            result = util.TimingInfo(
                iters=sim.iteration, elapsed=elapsed,
                mlups=total_nodes * (sim.iteration - bench_iters0)
                / (time.perf_counter() - bench_t0) / 1e6)
        self.timing = result
        return result


def window_shifted(plane, window, shift):
    """``plane`` (array axes) over ``window`` (a slice per axis) displaced
    by ``shift`` (per axis): plane[window + shift] with periodic wrap,
    built from slices of the window's size
    (``sailfish_tpu/ops/pallas_step.py:122-144`` with the shift negated)."""
    out = plane
    for ax, (w, s) in enumerate(zip(window, shift)):
        n = plane.shape[ax]
        lo, hi = w.start + s, w.stop + s
        if 0 <= lo and hi <= n:
            out = out.narrow(ax, lo, hi - lo)
        elif lo < 0:
            out = torch.cat([out.narrow(ax, n + lo, -lo),
                             out.narrow(ax, 0, hi)], dim=ax)
        else:
            out = torch.cat([out.narrow(ax, lo, n - lo),
                             out.narrow(ax, 0, hi - n)], dim=ax)
    return out
