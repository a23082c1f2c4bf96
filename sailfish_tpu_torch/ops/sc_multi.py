"""The kernel engine of the K-component Shan-Chen mixtures: a density
pre-pass and a coupled stream-and-collide step, two CUDA kernels per step.

Counterpart of ``sailfish_tpu/ops/pallas_multi2d.py`` (``PallasStepSCMulti2D``,
:1516-1585) and ``sailfish_tpu/ops/pallas_multi3d.py``
(``PallasStepSCMulti3D``, :1623-1712), which run the TPU kernels B5/B6
(``make_rho_kernel_3d`` / ``_2d``) and B7/B9 (``make_kernel_2d_sc_multi`` /
``make_kernel_3d_sc_multi``): K = 2 or 3 components, each with an optional
constant Guo body force (an acceleration). The kernels are
``csrc/sc_multi.cu``: the density pre-pass ``rho_poststream``, the D2Q9 step
``sc_multi_kernel`` (one x-row per block) and the D3Q19 step ``sc3_kernel``
(a tile of threads in (x, y) that marches over z-planes, with psi of the
densities staged in shared memory and compile-time lattice tables). This
module checks that a scene is eligible, computes the 3D kernel's launch
geometry (``tile_geometry``; ``Tile3D`` is shared with the free-energy
kernel), checks its compile-time tables against ``lattice`` when it loads
the library (``check_tables``), holds the per-component A/B buffers and the
density buffer, and wraps the launches.

Beside the wrapper live the kernels' plain PyTorch versions,
``rho_reference`` and ``sc_multi_reference``. The tests use them on the
CPU and ``chip_smoke.py`` holds the kernels against them on the card; the
main path never calls them on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import dataclasses
import re

import numpy as np
import torch

from sailfish_tpu_torch import equilibrium as eq
from sailfish_tpu_torch import lattice
from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch.ops import collide as co
from sailfish_tpu_torch.ops import lbm_step as ls
from sailfish_tpu_torch.ops import multigrid as mg
from sailfish_tpu_torch.ops import step as st

#: limits of the C parameter block (csrc/sc_multi.cu SC_MAX_Q, SC_MAX_K)
MAX_Q = 27
MAX_K = 4
#: lattices and component counts the step kernel is instantiated for
KERNEL_GRIDS = ('D2Q9', 'D3Q19')
KERNEL_K = (2, 3)
#: potential codes of csrc/sc_multi.cu
POTENTIALS = {'linear': 0, 'classic': 1}
#: the 3D step kernel's tile: threads in x and y, z-planes per block (the
#: sweep of tools/sc_tile_sweep.py on the card, PERF.md)
TILE_3D = (256, 1, 8)
#: limits of the z-marching tile kernels (csrc/sc_multi.cu SC3_THREADS,
#: SC3_MAX_FILL; csrc/fe_step.cu FE3_THREADS, FE3_MAX_FILL)
MAX_TILE_THREADS = 256
MAX_FILL = 4
#: shared memory a block may use without opting in
SMEM_LIMIT = 48 * 1024
#: the tile kernels' offsets are 32-bit: fewer nodes than this
MAX_TILE_NODES = 2 ** 31
#: launch names of the step kernel's modes: ``sc_multi_<grid>`` (K = 2, no
#: body force), ``sc_multi_force_<grid>`` (K = 2, a constant Guo force on
#: some component), ``sc_multi_k3_<grid>`` and ``sc_multi_k3_force_<grid>``
#: (K = 3); the pre-pass is ``rho_poststream_<grid>`` for every K
STEP_MODES = ('sc_multi', 'sc_multi_force', 'sc_multi_k3',
              'sc_multi_k3_force')
#: kernel launches per kernel name over all ``SCMultiStep`` objects; a
#: launch on a shard's ghost-plane buffers (``parallel/halo_multi.py``)
#: counts under its key with ``ghost_`` after the kernel's prefix
#: (``sc_multi_ghost_<grid>``, ``sc_multi_ghost_k3_force_<grid>``,
#: ``rho_poststream_ghost_<grid>``; ``ghost_name``)
LAUNCHES = dict.fromkeys(
    (name for kind in ('rho_poststream',) + STEP_MODES
     for g in KERNEL_GRIDS
     for name in (f'{kind}_{g.lower()}', f'{kind}_{g.lower()}'
                  .replace('rho_poststream_', 'rho_poststream_ghost_', 1)
                  .replace('sc_multi_', 'sc_multi_ghost_', 1))), 0)


def ghost_name(name):
    """The launch key of the kernel ``name`` (``rho_poststream_<...>``,
    ``sc_multi_<...>``, ``fe_step_<...>``) on a shard's ghost-plane
    buffers: ``ghost_`` after the kernel's prefix."""
    for prefix in ('rho_poststream_', 'sc_multi_', 'fe_step_'):
        if name.startswith(prefix):
            return prefix + 'ghost_' + name[len(prefix):]
    raise ValueError(f'no ghost-plane key for {name!r}')


def reset_launch_counts():
    """Zero ``LAUNCHES`` (before a run whose launches are to be counted)."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def rho_reference(f, grid):
    """Plain PyTorch version of ``rho_poststream``: the post-stream
    density rho(x) = sum_i f_i(x - c_i) of one component's (Q, *S) state,
    at every node (walls included), summed in direction order as the
    kernel and the Pallas kernels sum, on every device. (``torch.sum``
    over the Q axis groups the 19 terms of D3Q19 otherwise, and
    differently on the CPU and the card: at the densities of a demixed
    state, up to 4, that alone moves the sum by a few ulps, above the
    pre-pass tolerance of 1e-6.)"""
    g = st.gather(grid, f)
    rho = g[0]
    for i in range(1, grid.Q):
        rho = rho + g[i]
    return rho


def torch_density(f, grid):
    """The torch engine's post-stream density of one component's (Q, *S)
    state (``torch.sum`` over the gathered directions): what the kernel
    engines compute on a CPU tensor, so that they equal the torch engine
    bit for bit there."""
    return eq.density(grid, st.gather(grid, f))


def sc_multi_reference(fs, rhos, mask, grid, taus, couplings, potential,
                       accels=None):
    """Plain PyTorch version of the step kernels: one step of the
    K-component state ``fs`` (K (Q, *S) tensors) given the pre-pass
    densities ``rhos`` (K (*S) tensors), under uint8 mask codes ``mask``
    (0 collide, 1 full bounce-back, 2 keep), relaxation times ``taus``,
    couplings {(j, k): G_jk}, ``potential`` and the constant Guo body
    forces ``accels`` (K (dim,) accelerations or None; None: no force).
    A forced component relaxes towards feq at u_eq = u' + tau F / rho +
    a / 2 (the pseudopotential shift first, then half the acceleration)
    and takes the Guo term at that u_eq
    (``sailfish_tpu/ops/pallas_multi3d.py:548-575``), the torch engine's
    ``forced_collide``. Returns the K next states."""
    fss = [st.gather(grid, f) for f in fs]
    rho_s = [eq.density(grid, x) for x in fss]
    u = mg.common_velocity(grid, fss, rho_s, taus)
    forces = mg.sc_forces(grid, list(rhos), couplings, potential)
    accels = accels or [None] * len(fs)
    wet, fullbb = mask == 0, mask == 1
    out = []
    for x, rho, F, tau, a in zip(fss, rho_s, forces, taus, accels):
        u_eq = mg.shifted_velocity(u, F, tau, rho)
        if a is None:
            fpost = co.bgk_collide(grid, x, rho, u_eq, 1.0 / tau)
        else:
            a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
            fpost = st.forced_collide(
                grid, x, rho, u, 1.0 / tau,
                a.reshape((grid.dim,) + (1,) * (x.dim() - 1)), 'guo',
                u_eq=u_eq)
        out.append(st.select_dry(grid, x, fpost, wet, fullbb))
    return tuple(out)


def step_mode(K, forced):
    """The launch-name prefix of the step kernel's mode for ``K``
    components, with or without a body force (``STEP_MODES``)."""
    return 'sc_multi' + ('_k3' if K == 3 else '') + \
        ('_force' if forced else '')


#: template parameters of ``sc_multi_kernel`` in csrc/sc_multi.cu; the
#: D3Q19 step ``sc3_kernel<K, FORCED>`` has the last two
INSTANCE_PARAMS = ('dim', 'q', 'k', 'forced')


def instantiation(fn):
    """The template arguments of the step kernel instantiation whose
    mangled name is ``fn`` (``sc_multi_kernel``, or ``sc3_kernel`` with dim
    3 and q 19), as {name of ``INSTANCE_PARAMS``: value} (``forced`` a
    bool, False for an older build's name without it), or None for
    another function."""
    m = re.search(r'(sc_multi_kernel|sc3_kernel)I((?:L[ib]n?\d+E)+)E', fn)
    if not m:
        return None
    vals = [int(num) for num in re.findall(r'L[ib]n?(\d+)E', m.group(2))]
    if m.group(1) == 'sc3_kernel':
        vals = [3, 19] + vals
    out = dict(zip(INSTANCE_PARAMS, vals))
    out['forced'] = bool(out.get('forced', 0))
    return out


def kernel_ineligibility(builder):
    """Reasons the kernels cannot run ``builder``'s scene (empty when they
    can)."""
    if not isinstance(builder, mg.ShanChenMultiStepBuilder):
        return [f'{type(builder).__name__} scenes (the kernels run '
                'Shan-Chen mixtures)']
    reasons = []
    grid = builder.grid
    K = len(builder.taus)
    if grid.name not in KERNEL_GRIDS:
        reasons.append(f'lattice {grid.name} (the kernels are built for '
                       f'{", ".join(KERNEL_GRIDS)})')
    if K not in KERNEL_K:
        reasons.append(f'{K} components (the step kernel is built for '
                       f'K = {", ".join(map(str, KERNEL_K))})')
    if builder.dtype != torch.float32:
        reasons.append(f'{builder.dtype} (the kernels are fp32 only)')
    for k, bf in enumerate(builder.body_forces):
        if bf is None:
            continue
        if st.is_dynamic_force(bf):
            reasons.append(f'DynamicValue body force on component {k} '
                           '(the kernel takes constant accelerations)')
        elif np.ndim(bf) > 1:
            reasons.append(f'space-varying body force on component {k} '
                           '(the kernel takes one constant acceleration per '
                           'component; --engine=torch runs a per-node '
                           'field)')
    for (j, k) in builder.couplings:
        if not 0 <= j <= k < K:
            reasons.append(f'coupling key {(j, k)} (the kernel takes '
                           'j <= k < K, each pair once)')
    reasons += domain_reasons(grid.name, builder.maps.type_map.shape)
    _mask, instances, why = ls.classify_nodes(builder.maps)
    reasons += why
    if instances:
        names = sorted({nt.get_node_type(t).__name__
                        for t, _k, _s in instances})
        reasons.append(f'boundary conditions {", ".join(names)} (the '
                       'Shan-Chen kernel takes fluid, full bounce-back walls '
                       'and excluded nodes, mask codes 0/1/2)')
    if builder.maps.dynamic:
        reasons.append('DynamicValue BC parameters (the Shan-Chen kernel '
                       'takes no time-dependent value)')
    return reasons


def domain_reasons(grid_name, shape):
    """Reasons the kernels cannot run a ``grid_name`` domain of ``shape``
    ((nz,) ny, nx): the pre-pass and the D2Q9 step launch one block per
    (y, z) row, and the D3Q19 step's offsets are 32-bit."""
    reasons = []
    if any(s > ls.MAX_GRID_YZ for s in shape[:-1]):
        reasons.append(f'domain {shape}: y and z extents above '
                       f'{ls.MAX_GRID_YZ}')
    if grid_name == 'D3Q19' and int(np.prod(shape)) >= MAX_TILE_NODES:
        reasons.append(f'domain {shape}: 2^31 nodes or more (the D3Q19 '
                       "step kernel's offsets are 32-bit)")
    return reasons


class _Params(ctypes.Structure):
    _fields_ = [('nx', ctypes.c_int), ('ny', ctypes.c_int),
                ('nz', ctypes.c_int), ('potential', ctypes.c_int),
                ('c', (ctypes.c_int * 3) * MAX_Q),
                ('w', ctypes.c_float * MAX_Q),
                ('opp', ctypes.c_int * MAX_Q),
                ('tau', ctypes.c_float * MAX_K),
                ('tau_inv', ctypes.c_float * MAX_K),
                ('g', (ctypes.c_float * MAX_K) * MAX_K),
                ('force', (ctypes.c_float * 3) * MAX_K)]


def kernel_params(grid, shape, taus, couplings, potential, accels=None):
    """The kernels' by-value parameter block: domain extents, the lattice
    tables of ``sailfish_tpu_torch.lattice``, the relaxation times, the
    couplings and each component's constant acceleration (``accels``: K
    (dim,) vectors or None; zero where None)."""
    p = _Params()
    nz, ny, nx = (1,) * (3 - len(shape)) + tuple(shape)
    p.nx, p.ny, p.nz = nx, ny, nz
    p.potential = POTENTIALS[potential]
    for i in range(grid.Q):
        for a in range(grid.dim):
            p.c[i][a] = int(grid.basis[i][a])
        p.w[i] = float(grid.weights[i])
        p.opp[i] = int(grid.opposite[i])
    for k, tau in enumerate(taus):
        p.tau[k] = tau
        p.tau_inv[k] = 1.0 / tau
    for (j, k), G in couplings.items():
        p.g[j][k] = G
    for k, a in enumerate(accels or ()):
        if a is not None:
            for d, v in enumerate(a):
                p.force[k][d] = float(v)
    return p


class _Tile(ctypes.Structure):
    _fields_ = [('tx', ctypes.c_int), ('ty', ctypes.c_int),
                ('kz', ctypes.c_int), ('grid', ctypes.c_int * 3),
                ('smem_bytes', ctypes.c_int)]


@dataclasses.dataclass(frozen=True)
class Tile3D:
    """Launch geometry of a z-marching tile kernel (``sc3_kernel`` here,
    ``fe3_kernel`` of ``ops/fe_step``): blocks of ``tx`` x ``ty`` threads
    over (x, y), each marching over ``kz`` z-planes; ``grid`` (blocks along
    x, y, z); ``halo`` of the staged planes; ``smem_bytes`` of dynamic
    shared memory per block."""
    tx: int
    ty: int
    kz: int
    grid: tuple
    halo: int
    smem_bytes: int

    def params(self):
        """The by-value tile block of the launch (``SCTile`` /
        ``FETile``, one layout)."""
        t = _Tile(self.tx, self.ty, self.kz)
        t.grid[:] = self.grid
        t.smem_bytes = self.smem_bytes
        return t


def tile_launch(shape, tile, halo, smem):
    """``Tile3D`` of a tile kernel for the (nz, ny, nx) domain ``shape``,
    the tile (tx, ty, kz), staged planes of (ty + 2 halo) x (tx + 2 halo)
    entries and ``smem`` shared bytes per block. Raises ValueError on what
    the tile kernels do not take."""
    nz, ny, nx = shape
    tx, ty, kz = tile
    plane = (tx + 2 * halo) * (ty + 2 * halo)
    threads = tx * ty
    if min(tile) < 1 or threads > MAX_TILE_THREADS:
        raise ValueError(f'tile {tile}: 1 to {MAX_TILE_THREADS} threads '
                         'and at least one z-plane')
    if -(-plane // threads) > MAX_FILL:
        raise ValueError(f'tile {tile}: a staged plane of {plane} entries '
                         f'needs more than {MAX_FILL} per thread')
    if smem > SMEM_LIMIT:
        raise ValueError(f'tile {tile}: {smem} B of shared memory')
    if nx * ny * nz >= MAX_TILE_NODES:
        raise ValueError(f'domain {shape}: 2^31 nodes or more (the tile '
                         "kernels' offsets are 32-bit)")
    grid = (-(-nx // tx), -(-ny // ty), -(-nz // kz))
    return Tile3D(tx, ty, kz, grid, halo, smem)


def tile_geometry(shape, K, tile=TILE_3D):
    """``Tile3D`` of ``sc3_kernel`` for the (nz, ny, nx) domain ``shape``,
    ``K`` components and the tile (tx, ty, kz). Shared memory
    (``csrc/sc_multi.cu`` sc3_smem_bytes): per component a ring of four
    density planes of (ty + 2) x (tx + 2) floats (halo 1). Raises
    ValueError on a tile or domain the kernel does not take."""
    tx, ty, _kz = tile
    return tile_launch(shape, tile, 1, 4 * 4 * K * (tx + 2) * (ty + 2))


class _Tables(ctypes.Structure):
    _fields_ = [('c', (ctypes.c_int * 3) * 19), ('opp', ctypes.c_int * 19),
                ('w', ctypes.c_float * 19)]


def lattice_tables(grid=lattice.D3Q19):
    """``_Tables`` filled from ``sailfish_tpu_torch.lattice``: what
    ``sc_d3q19_tables`` must copy out."""
    t = _Tables()
    for i in range(grid.Q):
        t.c[i][:] = [int(v) for v in grid.basis[i]]
        t.opp[i] = int(grid.opposite[i])
        t.w[i] = float(grid.weights[i])
    return t


def check_tables(tables, grid=lattice.D3Q19):
    """Raise RuntimeError unless the ``_Tables`` ``tables`` (the 3D step
    kernel's compile-time tables) equal ``lattice_tables(grid)``, every
    integer exactly and every weight to the last bit of its float32."""
    ref = lattice_tables(grid)
    bad = [name for name, _ in _Tables._fields_
           if bytes(getattr(tables, name)) != bytes(getattr(ref, name))]
    if bad:
        raise RuntimeError(
            f'the compile-time {grid.name} tables of csrc/sc_multi.cu differ '
            f'from sailfish_tpu_torch.lattice in {", ".join(bad)}')


def kernel_functions(lib, grid_name):
    """The C entries (rho_poststream, sc_multi) for ``grid_name`` of a
    loaded ``csrc/sc_multi.cu`` library, typed for ``ctypes``, after
    checking that the library's parameter block matches ``_Params`` and,
    for D3Q19, that the step kernel's compile-time tables match the
    lattice (``check_tables``); the D3Q19 step also takes the ``_Tile``."""
    lib.sc_params_size.restype = ctypes.c_int
    if lib.sc_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError('SCParams layout differs between '
                           'csrc/sc_multi.cu and ops/sc_multi.py')
    g = grid_name.lower()
    rho_fn = getattr(lib, f'rho_poststream_{g}')
    rho_fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.POINTER(_Params), ctypes.c_void_p]
    rho_fn.restype = ctypes.c_int
    step_fn = getattr(lib, f'sc_multi_{g}')
    args = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(_Params)]
    if grid_name == 'D3Q19':
        lib.sc_tables_size.restype = ctypes.c_int
        if lib.sc_tables_size() != ctypes.sizeof(_Tables):
            raise RuntimeError('SCTables layout differs between '
                               'csrc/sc_multi.cu and ops/sc_multi.py')
        tables = _Tables()
        lib.sc_d3q19_tables.argtypes = [ctypes.POINTER(_Tables)]
        lib.sc_d3q19_tables.restype = None
        lib.sc_d3q19_tables(ctypes.byref(tables))
        check_tables(tables, lattice.D3Q19)
        args.append(ctypes.POINTER(_Tile))
    step_fn.argtypes = args + [ctypes.c_void_p]
    step_fn.restype = ctypes.c_int
    return rho_fn, step_fn


class BufferedMultiStep:
    """The A/B buffer handling shared by the K-component kernel engines:
    ``a`` and ``b`` are (K, Q, *S) fp32 tensors swapped every step, and a
    subclass's ``step_into(src, dst)`` makes one step between them."""

    def _check(self, *tensors):
        for t, full in tensors:
            if t.dtype != torch.float32 or tuple(t.shape) != full:
                raise ValueError(f'expected float32 {full}, got '
                                 f'{t.dtype} {tuple(t.shape)}')
            if not t.is_contiguous():
                raise ValueError('kernel buffers must be contiguous')
            if t.device != self.mask.device:
                raise ValueError(f'buffer on {t.device}, mask on '
                                 f'{self.mask.device}')

    def _buffer_of(self, state):
        for buf in (self.a, self.b):
            if all(f.data_ptr() == buf[k].data_ptr()
                   and f.shape == buf[k].shape
                   for k, f in enumerate(state)):
                return buf
        return None

    def run(self, state, n, it0=0):
        """``n`` steps from the K-tuple ``state``; returns the K-tuple of
        views of the buffer (A or B) that holds the result. A state that
        is not held by one of the two buffers is copied into A first.
        ``it0``, the first step's iteration, changes nothing: the mixture
        kernels take no time-dependent value (``kernel_ineligibility``
        refuses every BC row and every force that is not constant)."""
        if len(state) != self.K:
            raise ValueError(f'{len(state)} components, expected {self.K}')
        src = self._buffer_of(state)
        if src is None:
            for k, f in enumerate(state):
                self.a[k].copy_(f)
            src = self.a
        dst = self.b if src is self.a else self.a
        for _ in range(n):
            self.step_into(src, dst)
            src, dst = dst, src
        return tuple(src.unbind(0))


class SCMultiStep(BufferedMultiStep):
    """The kernel engine for one Shan-Chen scene: the K components' A and
    B buffers (one (K, Q, *S) tensor each, swapped every step), the (K,
    *S) density buffer, the uint8 mask, the components' constant
    accelerations ``accels`` (None for an unforced one), the 3D step
    kernel's ``tile`` (None in 2D, whose step takes one x-row per block),
    and ``launches``, this object's kernel launches by kernel name."""

    def __init__(self, builder):
        reasons = kernel_ineligibility(builder)
        if reasons:
            raise NotImplementedError(
                'the CUDA Shan-Chen kernels cannot run this scene: '
                + '; '.join(reasons))
        self.grid = builder.grid
        self.taus = list(builder.taus)
        self.couplings = dict(builder.couplings)
        self.potential = builder.potential
        self.K = len(self.taus)
        self.accels = [None if bf is None else
                       np.asarray(bf, dtype=np.float64)
                       for bf in builder.body_forces]
        self.forced = any(a is not None for a in self.accels)
        mask_np = ls.classify_nodes(builder.maps)[0]
        self.shape = mask_np.shape
        self.device = builder.device
        self.mask = torch.as_tensor(mask_np, device=self.device)
        full = (self.K, self.grid.Q) + self.shape
        self.a = torch.empty(full, dtype=torch.float32, device=self.device)
        self.b = torch.empty_like(self.a)
        self.rho = torch.empty((self.K,) + self.shape, dtype=torch.float32,
                               device=self.device)
        self.params = kernel_params(self.grid, self.shape, self.taus,
                                    self.couplings, self.potential,
                                    self.accels)
        self.tile = None
        self._tile_args = ()
        if self.grid.name == 'D3Q19':
            self.set_tile(TILE_3D)
        g = self.grid.name.lower()
        self.rho_name = f'rho_poststream_{g}'
        self.name = f'{step_mode(self.K, self.forced)}_{g}'
        self.launches = {self.rho_name: 0, self.name: 0}
        self._fns = None

    def set_tile(self, tile):
        """Launch the 3D step kernel with the tile (tx, ty, kz) from now
        on."""
        self.tile = tile_geometry(self.shape, self.K, tile)
        self._tile_params = self.tile.params()
        self._tile_args = (ctypes.byref(self._tile_params),)

    def _launch(self, name, fn, *args, after=()):
        """Launch C entry ``fn`` (0 pre-pass, 1 step) with ``args``, the
        parameter block, ``after`` and the current stream."""
        if self._fns is None:
            from sailfish_tpu_torch.ops import build
            self._fns = kernel_functions(build.load('sc_multi').lib,
                                         self.grid.name)
        rc = self._fns[fn](*args, ctypes.byref(self.params), *after,
                           torch.cuda.current_stream(self.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f'{name} launch failed: CUDA error {rc}')
        self.launches[name] += 1
        LAUNCHES[name] += 1

    def density_into(self, src, rho):
        """Post-stream densities of the (K, Q, *S) state ``src`` into the
        (K, *S) buffer ``rho``: the ``rho_poststream`` kernel on a CUDA
        tensor, ``torch_density`` on a CPU tensor."""
        self._check((src, self.a.shape), (rho, self.rho.shape))
        if src.device.type == 'cpu':
            for k in range(self.K):
                rho[k].copy_(torch_density(src[k], self.grid))
            return
        if src.device.type != 'cuda':
            raise ValueError(f'no kernel for device {src.device}')
        self._launch(self.rho_name, 0, src.data_ptr(), rho.data_ptr(),
                     self.K)

    def collide_into(self, src, rho, dst):
        """One coupled step from ``src`` into ``dst`` (distinct (K, Q, *S)
        buffers) given the pre-pass densities ``rho``: the step kernel
        (``sc_multi_kernel`` in 2D, ``sc3_kernel`` in 3D) on a CUDA tensor,
        ``sc_multi_reference`` on a CPU tensor."""
        self._check((src, self.a.shape), (rho, self.rho.shape),
                    (dst, self.a.shape))
        if src.data_ptr() == dst.data_ptr():
            raise ValueError('the pull step cannot run in place')
        if src.device.type == 'cpu':
            out = self.reference(src.unbind(0), rho.unbind(0))
            for k in range(self.K):
                dst[k].copy_(out[k])
            return
        if src.device.type != 'cuda':
            raise ValueError(f'no kernel for device {src.device}')
        self._launch(self.name, 1, src.data_ptr(), rho.data_ptr(),
                     dst.data_ptr(), self.mask.data_ptr(), self.K,
                     int(self.forced), after=self._tile_args)

    def reference(self, fs, rhos):
        """``sc_multi_reference`` with this scene's parameters: one step
        of the K-tuple ``fs`` given the pre-pass densities ``rhos``."""
        return sc_multi_reference(fs, rhos, self.mask, self.grid, self.taus,
                                  self.couplings, self.potential,
                                  self.accels)

    def step_into(self, src, dst):
        """One step: the density pre-pass into ``self.rho``, then the
        coupled step from ``src`` into ``dst``."""
        self.density_into(src, self.rho)
        self.collide_into(src, self.rho, dst)
