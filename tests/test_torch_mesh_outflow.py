"""The outflow family, the laminarize plane mean and force objects on a
mesh (``--mesh``, ``sailfish_tpu_torch/parallel/halo.py``) on the CPU.

* Every outflow type of the kernel (``torch_scenes.KERNEL_OUTFLOW_KINDS``)
  on its inflow/outflow channel, flowing along a sharded axis and along an
  unsharded one (3D z and x on z meshes of 2 and 4 shards and on 2x2; 2D
  y on y meshes of 2 and 4, x on ('y', 'x') meshes 1x2 and 2x2), on the
  torch engine and on the kernel engine's plain version: the unsharded
  run's bits.
* The open channels (``open_channel(2)``, ``open_channel(3)``): the state
  and the drag series of the force object bit for bit against the
  unsharded run, with ``--init_iters`` on one case.
* Against the JAX runner on the same mesh (the 8 host devices of
  ``tests/conftest.py``): rho and u within 1e-6 after 20 steps, each force
  object's force within 1e-5 relative.
* The laminarize pre-pass over the mesh (``halo.MeshLaminarize``): the
  unsharded means, bit for bit, from the interior nodes alone (each node of
  a row counted once, no ghost copy), and the arrays of its CUDA launch
  read as the kernel reads them give the plain version's means.
* The ghost planes' copies of outflow rows: poisoning every ghost plane
  with NaN before each exchange changes no bit of the run.
* A checkpoint with a force object written on a mesh restores without
  one; an outflow row whose samples reach past a shard's interior is
  refused by name; a varying outflow row on a ring of one shard runs (its
  wrapped ghost copies are fluid nodes), a varying native row there is
  refused by name.
"""

import glob

import numpy as np
import pytest
import torch
from unittest import mock

from sailfish_tpu import node_type as jnt
from sailfish_tpu.controller import \
    LBSimulationController as JaxController
from sailfish_tpu.models.base import ForceObject as JaxForceObject
from sailfish_tpu.models.single import LBFluidSim as JaxFluidSim
from sailfish_tpu.subdomain import Subdomain2D as JaxSubdomain2D
from sailfish_tpu.subdomain import Subdomain3D as JaxSubdomain3D
from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch.ops import step as st
from sailfish_tpu_torch.parallel import halo
from sailfish_tpu_torch.runner import SubdomainRunner
from torch_scenes import (KERNEL_OUTFLOW_KINDS, open_channel,
                          outflow_channel, run, wet_map)

torch.set_num_threads(1)

STEPS = 10
#: (dimension, flow axis) -> (size, meshes): the flow along the sharded
#: outer axis (3D z, 2D y) and along an unsharded one (3D x; 2D x on
#: ('y', 'x') meshes, where the outlet's normal is the sharded x)
CHANNELS = {
    (3, 'z'): (dict(lat_nx=16, lat_ny=16, lat_nz=32), ('2', '4', '2x2')),
    (3, 'x'): (dict(lat_nx=32, lat_ny=16, lat_nz=16), ('2', '4', '2x2')),
    (2, 'y'): (dict(lat_nx=32, lat_ny=64), ('2', '4')),
    (2, 'x'): (dict(lat_nx=64, lat_ny=32), ('1x2', '2x2')),
}
CASES = [(kind, dim, axis, mesh, engine)
         for kind in KERNEL_OUTFLOW_KINDS
         for (dim, axis), (_size, meshes) in sorted(CHANNELS.items())
         for mesh in meshes for engine in ('torch', 'kernel')]
OPEN_SIZES = {3: dict(lat_nx=32, lat_ny=16, lat_nz=16),
              2: dict(lat_nx=64, lat_ny=32)}
JAX_TOL = 1e-6
#: rho of the 2D open channel against the JAX runner: the port's UNSHARDED
#: run already sits 1.01e-6 from the JAX runner's unsharded run at one node
#: behind the cylinder after 20 steps (8.5 fp32 ulps at rho = 1; the JAX
#: runner's own mesh and unsharded runs part by 4.8e-7 there), and the
#: port's mesh run has the port's unsharded bits
#: (``test_open_channel_on_a_mesh``)
JAX_RHO_TOL = {'open_cylinder_2d': 1.5e-6}
FORCE_RTOL = 1e-5


def _run_on(engine, sim_cls, **cfg):
    with mock.patch.object(SubdomainRunner, '_select_engine',
                           lambda self: engine):
        return run(sim_cls, platform='cpu', **cfg)


_REFS = {}


def _unsharded(key, engine, make, **cfg):
    """The unsharded run of ``make()`` on ``engine`` (kept per ``key``)."""
    if (key, engine) not in _REFS:
        _REFS[key, engine] = _run_on(engine, make(), **cfg)
    return _REFS[key, engine]


@pytest.mark.parametrize('kind,dim,axis,mesh,engine', CASES)
def test_outflow_on_a_mesh_equals_the_unsharded_run(kind, dim, axis, mesh,
                                                    engine):
    size, _meshes = CHANNELS[dim, axis]
    cfg = dict(max_iters=STEPS, every=STEPS, **size)
    ref = _unsharded((kind, dim, axis), engine,
                     lambda: outflow_channel(kind, dim, axis), **cfg)
    r = _run_on(engine, outflow_channel(kind, dim, axis), mesh=mesh, **cfg)
    assert r.engine == engine and r.stepper is not None
    assert (r.stepper.lam is not None) == (kind == 'NTLaminarize')
    if engine == 'kernel':
        outflow = [ks for ks in r.stepper.kernels if ks.outflow]
        assert bool(outflow) == (kind != 'NTGradFreeflow')
        assert all(ks.name == 'lbm_step_ghost_outflow_'
                   f'{r.sim.grid.name.lower()}' for ks in outflow)
    assert torch.equal(r.f, ref.f)
    wet = wet_map(r.maps)
    r._fields_to_host()
    ref._fields_to_host()
    for name in ('rho', 'vx', 'vy'):
        np.testing.assert_array_equal(getattr(r.sim, name)[wet],
                                      getattr(ref.sim, name)[wet])


@pytest.mark.parametrize('dim,mesh,engine,init_iters', [
    (2, '2', 'torch', 0), (2, '2x2', 'kernel', 0), (2, '1x2', 'torch', 0),
    (2, '4', 'kernel', 5), (3, '2', 'kernel', 0), (3, '2x2', 'torch', 0),
    (3, '4', 'torch', 3)])
def test_open_channel_on_a_mesh(dim, mesh, engine, init_iters):
    """The state and every drag sample of the open channel's force object
    on the mesh: the unsharded run's bits (the body's window crosses the
    shard boundaries; the links whose dry end lies on another shard
    included)."""
    cfg = dict(max_iters=20, every=5, init_iters=init_iters,
               **OPEN_SIZES[dim])
    ref = _unsharded(('open', dim, init_iters), engine,
                     lambda: open_channel(dim), **cfg)
    r = _run_on(engine, open_channel(dim), mesh=mesh, **cfg)
    assert r.stepper is not None and r.engine == engine
    assert torch.equal(r.f, ref.f)
    assert [it for it, _F in r.sim.drag] == [5, 10, 15, 20]
    for (it, F), (jt, G) in zip(r.sim.drag, ref.sim.drag):
        assert it == jt and np.array_equal(F, G), (it, F, G)
    assert r.sim.drag[-1][1][0] != 0.0


def _jax_runner(sim_cls, **cfg):
    jc = JaxController(sim_cls, default_config=dict(
        quiet=True, platform='cpu', **cfg))
    jc.run(ignore_cmdline=True)
    return jc._runner


def _jax_open_channel(dim):
    return open_channel(dim, jnt,
                        JaxSubdomain3D if dim == 3 else JaxSubdomain2D,
                        JaxFluidSim, JaxForceObject)


@pytest.mark.parametrize('scene,mesh', [
    ('open_cylinder_2d', '2'), ('open_sphere_3d', '2'),
    ('laminarize_2d_y', '2')])
def test_sharded_run_matches_the_jax_runner_on_the_same_mesh(scene, mesh):
    """rho and u after 20 steps within 1e-6 of the JAX runner's run on the
    same mesh of host devices, and the force objects' forces within 1e-5
    relative."""
    if scene == 'laminarize_2d_y':
        size = CHANNELS[2, 'y'][0]
        mine = outflow_channel('NTLaminarize', 2, 'y')
        theirs = outflow_channel('NTLaminarize', 2, 'y', nt_mod=jnt,
                                 subdomain_cls=JaxSubdomain2D,
                                 model_cls=JaxFluidSim)
    else:
        dim = 3 if '3d' in scene else 2
        size = OPEN_SIZES[dim]
        mine, theirs = open_channel(dim), _jax_open_channel(dim)
    cfg = dict(max_iters=20, every=10, mesh=mesh, **size)
    jr = _jax_runner(theirs, **cfg)
    assert jr.mesh is not None and jr.mesh.size == int(mesh)
    r = run(mine, platform='cpu', **cfg)
    assert r.stepper is not None
    jr._fields_to_host()
    r._fields_to_host()
    wet = wet_map(r.maps)
    names = ('rho', 'vx', 'vy') + (('vz',) if r.sim.dim == 3 else ())
    for name in names:
        a, b = getattr(r.sim, name), getattr(jr.sim, name)
        tol = JAX_RHO_TOL.get(scene, JAX_TOL) if name == 'rho' else JAX_TOL
        assert np.max(np.abs(a[wet] - b[wet])) <= tol, name
    if hasattr(r.sim, 'drag'):
        for (it, F), (jt, G) in zip(r.sim.drag, jr.sim.drag):
            assert it == jt
            np.testing.assert_allclose(F, np.asarray(G), rtol=FORCE_RTOL,
                                       atol=FORCE_RTOL * np.abs(G).max())


def _laminarize_runner(mesh, dim=2, axis='y'):
    size, _meshes = CHANNELS[dim, axis]
    return _run_on('kernel', outflow_channel('NTLaminarize', dim, axis),
                   max_iters=0, mesh=mesh, **size)


@pytest.mark.parametrize('mesh,dim,axis', [
    ('4', 2, 'y'), ('2x2', 2, 'x'), ('2', 3, 'z'), ('2x2', 3, 'x')])
def test_laminarize_mean_on_a_mesh(mesh, dim, axis):
    """The mesh pre-pass takes each node of a laminarize row once, from
    the shard whose interior holds it (no ghost copy), and its means are
    the unsharded plane means bit for bit; every shard kernel's entries
    hold the mean of their plane (0 where the row has no plane)."""
    r = _laminarize_runner(mesh, dim, axis)
    stp = r.stepper
    lam = stp.lam
    f = torch.as_tensor(np.random.default_rng(7).uniform(
        0.01, 0.1, r.f.shape).astype(np.float32))
    s = stp.shard(f)
    for r_i, (_k, _ax, _lo, _counts, nodes) in enumerate(lam.rows):
        taken = np.concatenate([p[r_i].numpy() for p in lam.pos])
        assert np.array_equal(np.sort(taken), np.arange(nodes.size))
    means = lam.means(s.parts)
    fs = st.gather(r.sim.grid, f)
    masks = {k: mask for cls, k, mask in r.builder.bc_instances
             if cls is nt.NTLaminarize}
    ref = torch.cat([
        st.plane_means(fs, masks[k], naxis).reshape(r.sim.grid.Q, -1)
        .T[lo:lo + len(counts)]
        for k, naxis, lo, counts, _nodes in lam.rows])
    assert torch.equal(means, ref)
    lam.plain_into(s.parts, stp.kernels)
    padded = torch.cat([means, torch.zeros(1, r.sim.grid.Q)])
    for sh, ks in enumerate(stp.kernels):
        if ks.lam is None:
            continue
        idx = lam.shard_entries(sh, ks)
        assert np.any(idx >= 0)
        assert torch.equal(ks.lam.mean, padded[np.where(idx < 0, -1, idx)])


def test_ghost_prepass_arrays_read_as_the_kernel_reads_them():
    """``laminarize_mean_ghost``'s device arrays, read as the kernel reads
    them (each node's code to its shard and slab index, its Q pulls there,
    the sums in node order; each mean to every destination address): the
    plain version's means in every shard kernel's entries."""
    r = _laminarize_runner('2x2', 3, 'x')
    stp = r.stepper
    lam = stp.lam
    q = r.sim.grid.Q
    f = torch.as_tensor(np.random.default_rng(3).uniform(
        0.01, 0.1, r.f.shape).astype(np.float32))
    parts = stp.shard(f).parts
    codes, start, dst, dst_start = (t.numpy() for t in
                                    lam._kernel_arrays(stp.kernels))
    slab = int(np.prod(lam.slab_shape))
    dim = r.sim.dim
    addr = {}
    for ks in stp.kernels:
        if ks.lam is not None:
            base = ks.lam.mean.data_ptr()
            for e in range(ks.lam.mean.shape[0]):
                addr[base + 4 * q * e] = (ks, e)
    got = {}
    for e in range(len(start) - 1):
        vals = []
        for code in codes[start[e]:start[e + 1]]:
            shard, node = divmod(int(code), slab)
            xyz = np.unravel_index(node, lam.slab_shape)
            src = [np.ravel_multi_index(
                [(xyz[a] - int(r.sim.grid.basis[i][dim - 1 - a]))
                 % lam.slab_shape[a] for a in range(dim)], lam.slab_shape)
                for i in range(q)]
            vals.append(parts[shard].reshape(q, -1)[np.arange(q), src])
        vals = torch.stack(vals, 1) if vals else torch.zeros(q, 0)
        mean = st.entry_means(vals, [vals.shape[1]])[0]
        for d in range(dst_start[e], dst_start[e + 1]):
            got[int(np.uint64(dst[d]))] = mean
    lam.plain_into(parts, stp.kernels)
    assert set(got) <= set(addr) and got
    for a, mean in got.items():
        ks, e = addr[a]
        assert torch.equal(ks.lam.mean[e], mean)


@pytest.mark.parametrize('engine', ['torch', 'kernel'])
@pytest.mark.parametrize('kind,dim,axis,mesh', [
    ('NTYuOutflow', 3, 'z', '2'), ('NTNeumann', 3, 'x', '2x2'),
    ('NTGuoDensity', 2, 'y', '4'), ('NTLaminarize', 2, 'x', '2x2'),
    ('open', 3, 'x', '2')])
def test_ghost_copies_output_is_never_read(kind, dim, axis, mesh, engine):
    """Every ghost plane (rows and edges too) set to NaN before each
    exchange: the exchange refills the directions that cross into them,
    and the run keeps the unsharded run's bits. So no interior node reads
    what the ghost planes' copies of the outflow rows compute."""
    if kind == 'open':
        make, cfg = (lambda: open_channel(dim)), OPEN_SIZES[dim]
    else:
        make, cfg = (lambda: outflow_channel(kind, dim, axis)), \
            CHANNELS[dim, axis][0]
    cfg = dict(max_iters=STEPS, every=STEPS, **cfg)
    ref = _unsharded(('poison', kind, dim, axis), engine, make, **cfg)
    real = halo.ShardedStep.exchange

    def poisoned(self, parts):
        for p in parts:
            keep = self.interior(p).clone()
            p.fill_(float('nan'))
            self.interior(p).copy_(keep)
        real(self, parts)

    with mock.patch.object(halo.ShardedStep, 'exchange', poisoned):
        r = _run_on(engine, make(), mesh=mesh, **cfg)
    assert torch.equal(r.f, ref.f)


def test_checkpoint_with_a_force_object_restores_without_a_mesh(tmp_path):
    """10 steps of the open channel on a 2-shard mesh, checkpoint, 10 more
    unsharded: the state and the drag of 20 unsharded steps, bit for bit;
    the checkpoint holds the global state."""
    cfg = dict(platform='cpu', **OPEN_SIZES[2])
    cp = str(tmp_path / 'oc')
    run(open_channel(2), max_iters=10, every=10, mesh='2',
        checkpoint_file=cp, final_checkpoint=True, **cfg)
    (cpoint,) = glob.glob(cp + '*.cpoint.npz')
    assert np.load(cpoint)['dist0a'].shape == (9, 32, 64)
    r = run(open_channel(2), max_iters=20, every=10, restore_from=cpoint,
            **cfg)
    ref = run(open_channel(2), max_iters=20, every=10, **cfg)
    assert r.stepper is None and torch.equal(r.f, ref.f)
    assert np.array_equal(r.sim.drag[-1][1], ref.sim.drag[-1][1])


@pytest.mark.parametrize('engine', ['torch', 'kernel'])
def test_an_outflow_row_reaching_past_a_shard_is_refused(engine):
    """A Neumann outlet reads f(x + 2n): on 2-plane shards normal to its
    face that is a ghost plane, refused by name on both engines; 4-plane
    shards run."""
    cfg = dict(max_iters=1, lat_nx=32, lat_ny=32)
    with pytest.raises(NotImplementedError,
                       match=r'NTNeumann \(orientation \d\) samples 2 '
                             r'plane\(s\).*2-plane shard along y'):
        _run_on(engine, outflow_channel('NTNeumann', 2, 'y'), mesh='16',
                **cfg)
    assert _run_on(engine, outflow_channel('NTNeumann', 2, 'y'), mesh='8',
                   **cfg).stepper is not None


@pytest.mark.parametrize('engine', ['torch', 'kernel'])
@pytest.mark.parametrize('kind,dim,axis,mesh', [
    ('NTLaminarize', 2, 'y', '1'), ('NTLaminarize', 2, 'x', '1x1'),
    ('NTLaminarize', 3, 'z', '1x2'), ('NTGuoDensity', 2, 'x', '2x1')])
def test_a_varying_outflow_row_on_a_ring_of_one_shard(kind, dim, axis, mesh,
                                                      engine):
    """A varying outflow row (the laminarize alpha rises across the
    channel) normal to the axis of a one-shard ring: the slab's ghost
    planes there hold its own far planes, and their copies of the outflow
    rows are fluid nodes (``halo.shard_maps``' ``unwrap``), so the row
    stands once in the slab and its parameter box spans its own planes:
    both engines give the unsharded bits."""
    size = dict(CHANNELS[dim, axis][0], max_iters=STEPS, every=STEPS)
    ref = _unsharded((kind, dim, axis), engine,
                     lambda: outflow_channel(kind, dim, axis), **size)
    r = _run_on(engine, outflow_channel(kind, dim, axis), mesh=mesh, **size)
    assert torch.equal(r.f, ref.f)
    if engine == 'kernel':
        rows = [row for ks in r.stepper.kernels for row in ks.table
                if row.type_id == getattr(nt, kind).id]
        # one plane along the row's normal, not the slab's span
        assert rows and all(row.box is None
                            or row.box.ext[(row.orientation - 1) // 2] == 1
                            for row in rows)


def test_a_varying_native_row_on_a_ring_of_one_shard_is_refused():
    """The native BC rows keep their wrapped ghost copies: a varying inlet
    normal to a one-shard ring's axis stands twice in the slab, and the
    kernel engine refuses its box by name."""
    from torch_scenes import channel_sim_2d
    with pytest.raises(NotImplementedError,
                       match='NTZouHeVelocity .*bounding box'):
        _run_on('kernel', channel_sim_2d('zouhe', axis='y'), mesh='1',
                lat_nx=32, lat_ny=64, max_iters=1)
