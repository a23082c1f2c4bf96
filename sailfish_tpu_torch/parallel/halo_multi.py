"""Sharded stepping of the K-component models: the Shan-Chen mixtures
(K = 2, 3) and the binary free-energy model.

Port of ``sailfish_tpu/parallel/halo_multi.py`` (``ShardedPallasSCMulti3D``
:58, ``ShardedPallasFE3D`` :339, ``ShardedPallasSCMulti2D`` :816,
``ShardedPallasFE2D`` :1230) on the layout of ``parallel/halo.py``: the
domain split along z (3D) or y (2D), each shard holding its slab of every
component with ``ghost`` planes on each side, (Q, L + 2G, ...) per
component (one (K, Q, L + 2G, ...) buffer per shard on the kernel engine);
on a mesh of two axes (('z', 'y'), ('y', 'x')) split and padded along the
next axis too, (Q, Lo + 2G, Li + 2G, ...), both exchanges filling the
inner axis's ghost rows and the edges as well (their edge mode).

A step has two phases with an exchange after each, the reference's
"macro pre-exchange" (``halo_multi.py:1-16``):

1. each shard's density pre-pass over its padded slab (``rho_poststream``
   on the kernel engine, ``MultigridStepBuilder.stream_phase`` on the torch
   engine): right on the interior planes, whose pull reads only the
   crossing directions of the ghost planes that the last exchange filled;
2. the density exchange: the post-stream densities of the first and last
   ``G`` interior planes into the neighbours' ghost planes (every rho_k of a
   mixture, the order parameter phi of the free-energy model), which the
   coupling reads one plane out (two with the wetting mirror);
3. each shard's coupled step over its padded slab (``sc_multi`` /
   ``fe_step``, or ``collide_phase``), the ghost planes' output junk;
4. the exchange of every component's crossing directions.

Both exchanges are the ``halo_exchange`` kernel of ``ops/csrc/halo.cu`` on
the kernel engine (one launch per device each: ``halo_rho_exchange_<grid>``
and ``halo_exchange_<grid>``) and PyTorch copies on the torch engine and
the CPU. The free-energy model with walls reads phi two planes out (the
wetting mirror moves the stencil's samples by one more plane,
``pallas_multi3d.py:824-829``): its slabs carry two ghost planes per side
(G = 2: (Q, L + 4, ...)), the distributions' exchange fills the inner one
and the density exchange both. Every other slab has G = 1. Each shard's
kernel object is built from its shard's maps (mask, the dry nodes'
orientations, a per-node force cut to its planes), and its launches count
under its key with ``ghost_`` after the kernel's prefix
(``sc_multi.ghost_name``). A sharded run gives the bits of the unsharded
run of the same engine.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from sailfish_tpu_torch.ops import multigrid as mg
from sailfish_tpu_torch.parallel import halo
from sailfish_tpu_torch.parallel import mesh as pmesh


def shard_multi_builder(builder, maps, device):
    """A K-component builder of ``builder``'s scene on the shard maps
    ``maps`` (``halo.shard_maps``) on ``device``: the same settings, each
    component's ``StepBuilder`` on the shard (``halo.shard_builder``), a
    per-node body force and the free-energy model's dry-node orientations
    cut to the shard's planes (and rows). Whether the wetting mirror runs
    stays the global scene's (a shard without walls runs it as the
    unsharded step does, on no node)."""
    b = copy.copy(builder)
    b.maps = maps
    b.device = torch.device(device)
    b.components = [halo.shard_builder(c, maps, device)
                    for c in builder.components]
    b.b0 = b.components[0]
    b.body_forces = [bf if bf is None or np.ndim(bf) <= 1
                     else halo.take(bf, maps.rows, maps.cols, axis=1)
                     for bf in builder.body_forces]
    b.body_force = b.body_forces[0]
    if isinstance(builder, mg.FreeEnergyStepBuilder):
        b._dry_orient = halo.take(builder._dry_orient, maps.rows,
                                  maps.cols).to(b.device)
    return b


class ShardedMultiStep(halo.ShardedStep):
    """The sharded step of a ``ShanChenMultiStepBuilder`` or
    ``FreeEnergyStepBuilder`` scene over a mesh of one axis (z in 3D, y in
    2D) or two (('z', 'y'), ('y', 'x')). ``engine`` 'torch' steps each
    slab with its shard's builder (``builders``), 'kernel' with one
    ``SCMultiStep`` / ``FEStep`` per slab (``kernels``). The state is a
    ``halo.Sharded`` whose parts are K-tuples of (Q, L + 2 ``ghost``, ...)
    tensors (padded along both axes on two); ``run``, ``reference``,
    ``shard``, ``gather``, ``is_finite`` and ``macro_fields`` are those of
    ``halo.ShardedStep`` over it. ``exchanges`` / ``rho_exchanges`` count
    the two exchanges."""

    def __init__(self, builder, domain_shape, mesh, engine='torch'):
        self.fe = isinstance(builder, mg.FreeEnergyStepBuilder)
        #: two ghost planes where the wetting mirror reads phi two planes
        #: out, else one
        self.ghost = 2 if self.fe and builder._has_dry_nodes else 1
        self._setup(builder, domain_shape, mesh, engine)
        self.K = len(builder.taus)
        self.sc = False
        self.mixed = None
        self.steps = None
        self.builders = [
            shard_multi_builder(builder,
                                halo.shard_maps(builder.maps, rows, cols), d)
            for rows, cols, d in zip(self.rows, self.cols, mesh.devices)]
        self.kernels = None
        if engine == 'kernel':
            from sailfish_tpu_torch.ops import sc_multi as sm
            if self.fe:
                from sailfish_tpu_torch.ops.fe_step import FEStep
                self.kernels = [FEStep(b) for b in self.builders]
            else:
                self.kernels = [sm.SCMultiStep(b) for b in self.builders]
            for ks in self.kernels:
                ks.name = sm.ghost_name(ks.name)
                ks.rho_name = sm.ghost_name(ks.rho_name)
                ks.launches = {ks.rho_name: 0, ks.name: 0}

    # -- exchanges -----------------------------------------------------------

    def exchange_reference(self, parts):
        """The distributions' exchange as PyTorch index copies: the
        crossing directions of every component (``halo.ghost_copy``)."""
        halo.ghost_copy([list(p) for p in parts], self.length, self.ghost,
                        indices=self._indices, inner=self.inner)

    def _density_lists(self, rhos):
        """Each shard's densities as a list of (L + 2G, ...) planes: a
        mixture's (K, ...) buffer or list of K densities, the free-energy
        model's phi."""
        if self.fe:
            return [[r] for r in rhos]
        return [list(r.unbind(0)) if torch.is_tensor(r) else list(r)
                for r in rhos]

    def density_exchange_reference(self, rhos):
        """The density exchange as PyTorch copies: ``ghost`` whole planes of
        each density per side."""
        halo.ghost_copy(self._density_lists(rhos), self.length, self.ghost,
                        self.ghost, inner=self.inner)

    def density_exchange(self, rhos):
        """Fill the ghost planes of the shards' post-stream densities
        ``rhos`` (per shard the (K, L + 2G, ...) buffer or K densities of a
        mixture, phi of the free-energy model): one ``halo_exchange``
        launch per device on whole planes on the kernel engine (counted
        under ``rho_name``), else ``density_exchange_reference``."""
        self.rho_exchanges += 1
        if not self._on_kernels([r if torch.is_tensor(r) else r[0]
                                 for r in rhos]):
            self.density_exchange_reference(rhos)
            return
        comps, comp = (1, 0) if self.fe else \
            (self.K, rhos[0][0].numel() * rhos[0].element_size())
        self._launch(self._plan('rho', rhos, self.whole_regions(),
                                self.ghost, comps, comp),
                     self.rho_name, wait_done=False)

    def _buffers(self, parts):
        """The kernels' (K, Q, ...) buffers that hold the K-tuples
        ``parts``."""
        bufs = [ks._buffer_of(p) for ks, p in zip(self.kernels, parts)]
        if any(b is None for b in bufs):
            raise ValueError(f'{self.name}: a shard\'s state is not held by '
                             'its kernel\'s A or B buffer')
        return bufs

    def exchange(self, parts):
        """Fill the ghost planes of the shards' K-tuples ``parts`` that the
        next step reads: on the kernel engine with CUDA shards one
        ``halo_exchange`` launch per device over every component (the
        parts held by the kernels' buffers), else ``exchange_reference``."""
        if self._on_kernels([p[0] for p in parts]):
            self.exchange_buffers(self._buffers(parts))
            return
        self.exchanges += 1
        self.exchange_reference(parts)

    def exchange_buffers(self, bufs):
        """The distributions' exchange on the kernels' (K, Q, L + 2G, ...)
        buffers ``bufs``: on CUDA one launch per device, else
        ``exchange_reference``."""
        self.exchanges += 1
        if not self._on_kernels(bufs):
            self.exchange_reference([b.unbind(0) for b in bufs])
            return
        self._launch(self._plan_for(bufs), self.name)

    def _plan_for(self, bufs):
        """The distributions' exchange launches for the kernels' buffers
        ``bufs`` (``halo.ShardedStep._plan``)."""
        first = bufs[0]
        return self._plan('f', bufs, self.regions, 1, self.K,
                          first[0].numel() * first.element_size())

    @property
    def launches(self):
        """The step launches of the shards' kernels."""
        return sum(ks.launches[ks.name] for ks in self.kernels or ())

    # -- stepping ------------------------------------------------------------

    def run(self, f, n, it0=0):
        """``n`` steps from the state ``f`` (``Sharded``, or a global
        K-tuple), the first computing iteration ``it0``; returns the
        ``Sharded`` result (on the kernel engine K-tuples of views of the
        kernels' A or B buffers)."""
        parts = self.as_sharded(f).parts
        if self.kernels is None:
            for i in range(n):
                streamed = [b.stream_phase(p)
                            for b, p in zip(self.builders, parts)]
                self.density_exchange(
                    [rhos[1] if self.fe else rhos for _f, rhos in streamed])
                parts = [b.collide_phase(fss, rhos, it0 + i)
                         for b, (fss, rhos) in zip(self.builders, streamed)]
                self.exchange(parts)
            return halo.Sharded(parts)
        cur = []
        for ks, p in zip(self.kernels, parts):
            buf = ks._buffer_of(p)
            if buf is None:
                for k, x in enumerate(p):
                    ks.a[k].copy_(x)
                buf = ks.a
            cur.append(buf)
        rhos = [ks.phi if self.fe else ks.rho for ks in self.kernels]
        for _ in range(n):
            nxt = [ks.b if buf is ks.a else ks.a
                   for ks, buf in zip(self.kernels, cur)]
            for ks, src, rho in zip(self.kernels, cur, rhos):
                with halo.on_device(src.device):
                    if self.fe:
                        ks.phi_into(src, rho)
                    else:
                        ks.density_into(src, rho)
            self.density_exchange(rhos)
            for ks, src, rho, dst in zip(self.kernels, cur, rhos, nxt):
                with halo.on_device(src.device):
                    ks.collide_into(src, rho, dst)
            self.exchange_buffers(nxt)
            cur = nxt
        return halo.Sharded([tuple(b.unbind(0)) for b in cur])

    def reference(self, state, it=0):
        """One step of the kernel engine's plain version from ``state``
        (``Sharded`` or global): the plain pre-pass on each shard, the
        plain density exchange, each shard's plain step
        (``sc_multi_reference`` / ``fe_step_reference``), the plain
        exchange; returns a new ``Sharded`` state."""
        from sailfish_tpu_torch.ops import fe_step
        from sailfish_tpu_torch.ops import sc_multi as sm
        parts = self.as_sharded(state).parts
        if self.fe:
            rhos = [sm.rho_reference(p[1], self.grid) for p in parts]
        else:
            rhos = [[sm.rho_reference(x, self.grid) for x in p]
                    for p in parts]
        self.density_exchange_reference(rhos)
        out = []
        for ks, p, rho in zip(self.kernels, parts, rhos):
            if self.fe:
                out.append(fe_step.fe_step_reference(
                    p, rho, ks.mask, ks.orient, ks.builder))
            else:
                out.append(ks.reference(p, rho))
        self.exchange_reference(out)
        return halo.Sharded(out)

    def macro_fields(self, state, it=0):
        """([rho_k], u) of a ``Sharded`` state as the global builder's
        ``macro_fields`` gives them, computed per shard and gathered on the
        first shard's device."""
        rhos, u = zip(*(b.macro_fields(p, it)
                        for b, p in zip(self.builders, state.parts)))
        return ([pmesh.gather([r[k] for r in rhos], axis=0, ghost=self.ghost,
                              counts=self.counts)
                 for k in range(len(rhos[0]))],
                pmesh.gather(u, axis=1, ghost=self.ghost, counts=self.counts))
