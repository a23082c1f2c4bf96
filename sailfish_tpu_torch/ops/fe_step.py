"""The kernel engine of the binary free-energy model: the order-parameter
pre-pass and the free-energy stream-and-collide step, two CUDA kernels per
step.

Counterpart of ``sailfish_tpu/ops/pallas_multi2d.py`` (``PallasStepFE2D``,
:1451-1513) and ``sailfish_tpu/ops/pallas_multi3d.py`` (``PallasStepFE3D``,
:1715-1799), which run the TPU kernels B8 ``make_kernel_2d_fe`` and B10
``make_kernel_3d_fe``. The step kernels are in ``csrc/fe_step.cu``:
``fe_step_kernel`` (D2Q9, one x-row per block) and ``fe3_kernel`` (D3Q19,
a tile of threads in (x, y) that marches over z-planes with the order
parameter's stencil in shared memory and compile-time lattice tables); the
pre-pass is ``rho_poststream`` of ``csrc/sc_multi.cu`` on the order
parameter's distributions alone. This module checks that a scene is
eligible, computes the 3D kernel's launch geometry (``tile_geometry``),
checks the 3D kernel's compile-time tables against ``lattice`` and
``multigrid.fe_weights`` when it loads the library (``check_tables``),
holds the A/B buffers, the phi buffer and the node maps, and wraps the
launches.

Beside the wrapper live the kernels' plain PyTorch versions,
``sc_multi.rho_reference`` (the pre-pass) and ``fe_step_reference``. The
tests use them on the CPU and ``chip_smoke.py`` holds the kernels against
them on the card; the main path never calls them on a CUDA tensor.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sailfish_tpu_torch import equilibrium as eq
from sailfish_tpu_torch import lattice
from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch.ops import lbm_step as ls
from sailfish_tpu_torch.ops import multigrid as mg
from sailfish_tpu_torch.ops import sc_multi as sm
from sailfish_tpu_torch.ops import step as st

#: limits of the C parameter block (csrc/fe_step.cu FE_MAX_Q, FE_MAX_MOM)
MAX_Q = 19
MAX_MOM = 9
#: lattices the step kernel is instantiated for
KERNEL_GRIDS = ('D2Q9', 'D3Q19')
#: the 3D kernel's tile: threads in x and y, z-planes per block (the sweep
#: of tools/fe_tile_sweep.py on the card, PERF.md); its limits are those of
#: ``sc_multi.tile_launch``
TILE_3D = (128, 2, 8)
#: step-kernel launches per kernel name over all ``FEStep`` objects (the
#: pre-pass counts in ``sc_multi.LAUNCHES``, beside its Shan-Chen use); on
#: a shard's ghost-plane buffers ``fe_step_ghost_<grid>``
LAUNCHES = dict.fromkeys((f'fe_step_{v}{g.lower()}' for v in ('', 'ghost_')
                          for g in KERNEL_GRIDS), 0)


def reset_launch_counts():
    """Zero ``LAUNCHES`` (before a run whose launches are to be counted)."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def fe_step_reference(fs, phi, mask, orient, builder):
    """Plain PyTorch version of ``fe_step``: one step of the two-component
    state ``fs`` ((Q, *S) fluid and order-parameter tensors) given the
    pre-pass order parameter ``phi`` (*S), under uint8 mask codes ``mask``
    (0 collide, 1 full bounce-back, 2 keep) and the dry nodes' orientation
    codes ``orient`` (None without walls), with the constants of the
    ``FreeEnergyStepBuilder`` ``builder``. Returns the two next states."""
    g = builder.grid
    fss = [st.gather(g, f) for f in fs]
    rhos = [eq.density(g, x) for x in fss]
    u = builder.common_velocity(fss, rhos)
    phi_w = phi if orient is None else mg.wetting_mirror(
        g, phi, orient, builder.wall_grad_phase)
    fposts = builder.fe_collide(fss, rhos, u, phi_w)
    wet, fullbb = mask == 0, mask == 1
    return tuple(st.select_dry(g, x, fpost, wet, fullbb)
                 for x, fpost in zip(fss, fposts))


def kernel_ineligibility(builder):
    """Reasons the kernels cannot run ``builder``'s scene (empty when they
    can). ``MultigridStepBuilder`` already refuses DynamicValue forces,
    forcing other than Guo, ``NTGuoDensity`` and ``NTWallTMS``."""
    if not isinstance(builder, mg.FreeEnergyStepBuilder):
        return [f'{type(builder).__name__} scenes (the kernel runs the '
                'binary free-energy model)']
    reasons = []
    grid = builder.grid
    if grid.name not in KERNEL_GRIDS:
        reasons.append(f'lattice {grid.name} (the kernel is built for '
                       f'{", ".join(KERNEL_GRIDS)})')
    if builder.dtype != torch.float32:
        reasons.append(f'{builder.dtype} (the kernels are fp32 only)')
    shape = builder.maps.type_map.shape
    if any(s > ls.MAX_GRID_YZ for s in shape[:-1]):
        reasons.append(f'domain {shape}: y and z extents above '
                       f'{ls.MAX_GRID_YZ}')
    _mask, instances, why = ls.classify_nodes(builder.maps)
    reasons += why
    if instances:
        names = sorted({nt.get_node_type(t).__name__
                        for t, _k, _s in instances})
        reasons.append(f'boundary conditions {", ".join(names)} (the '
                       'free-energy kernel takes fluid, full bounce-back '
                       'walls and excluded nodes, mask codes 0/1/2)')
    if builder.maps.dynamic:
        reasons.append('DynamicValue BC parameters (the free-energy kernel '
                       'takes no time-dependent value)')
    return reasons


class _Params(ctypes.Structure):
    _fields_ = [('nx', ctypes.c_int), ('ny', ctypes.c_int),
                ('nz', ctypes.c_int), ('has_force', ctypes.c_int),
                ('wetting', ctypes.c_int), ('n_mom', ctypes.c_int),
                ('c', (ctypes.c_int * 3) * MAX_Q),
                ('opp', ctypes.c_int * MAX_Q),
                ('ov', (ctypes.c_int * 3) * 6),
                ('w', ctypes.c_float * MAX_Q),
                ('wi', ctypes.c_float * MAX_Q),
                ('wxx', ctypes.c_float * MAX_Q),
                ('wyy', ctypes.c_float * MAX_Q),
                ('wzz', ctypes.c_float * MAX_Q),
                ('wxy', ctypes.c_float * MAX_Q),
                ('wyz', ctypes.c_float * MAX_Q),
                ('wxz', ctypes.c_float * MAX_Q),
                ('tau_a', ctypes.c_float), ('tau_b', ctypes.c_float),
                ('inv_tau_phi', ctypes.c_float),
                ('A', ctypes.c_float), ('kappa', ctypes.c_float),
                ('Gamma', ctypes.c_float), ('wall_grad', ctypes.c_float),
                ('force', ctypes.c_float * 3),
                ('off0', ctypes.c_float * 3), ('off1', ctypes.c_float * 3),
                ('mom_shear', ctypes.c_int * MAX_MOM),
                ('mom_row', (ctypes.c_float * MAX_Q) * MAX_MOM),
                ('minv', (ctypes.c_float * MAX_MOM) * MAX_Q)]


def kernel_params(builder, shape, wetting):
    """The step kernel's by-value parameter block: domain extents, the
    lattice tables of ``sailfish_tpu_torch.lattice``, the free-energy weights,
    the FE-MRT rows of M and columns of M^-1, and the builder's
    constants, body force and equilibrium-velocity offsets."""
    g = builder.grid
    p = _Params()
    nz, ny, nx = (1,) * (3 - len(shape)) + tuple(shape)
    p.nx, p.ny, p.nz = nx, ny, nz
    p.has_force = int(builder.body_force is not None)
    p.wetting = int(wetting)
    for i in range(g.Q):
        for a in range(g.dim):
            p.c[i][a] = int(g.basis[i][a])
        p.opp[i] = int(g.opposite[i])
        p.w[i] = float(g.weights[i])
    for k, vec in enumerate(g.orientation_vectors):
        for a in range(g.dim):
            p.ov[k][a] = int(vec[a])
    for name, vals in mg.fe_weights(g).items():
        arr = getattr(p, name)
        for i in range(g.Q):
            arr[i] = float(vals[i])
    p.tau_a, p.tau_b = builder.tau_a, builder.tau_b
    p.inv_tau_phi = 1.0 / builder.tau_phi
    p.A, p.kappa, p.Gamma = builder.A, builder.kappa, builder.Gamma
    p.wall_grad = builder.wall_grad_phase
    if builder.body_force is not None:
        for a, v in enumerate(np.asarray(builder.body_force, np.float64)):
            p.force[a] = float(v)
    off0, off1 = builder.eq_velocity_offsets()
    for a in range(g.dim):
        p.off0[a] = float(off0[a])
        p.off1[a] = float(off1[a])
    rows, shear = mg.fe_mrt_moments(g)
    p.n_mom = len(rows)
    for k, kk in enumerate(rows):
        p.mom_shear[k] = int(kk in shear)
        for i in range(g.Q):
            p.mom_row[k][i] = float(g.mrt_matrix[kk, i])
            p.minv[i][k] = float(g.mrt_inv[i, kk])
    return p


def tile_geometry(shape, wetting, tile=TILE_3D):
    """``sc_multi.Tile3D`` for the (nz, ny, nx) domain ``shape`` and the
    tile (tx, ty, kz). Shared memory (``csrc/fe_step.cu`` fe3_smem_bytes):
    a ring of raw phi planes of (ty + 2 halo) x (tx + 2 halo) floats, four
    without wetting; with wetting three, plus three phi_w planes of halo 1
    and one orientation byte per raw entry. Raises ValueError on a tile
    the kernel does not take."""
    tx, ty, _kz = tile
    halo = 2 if wetting else 1
    plane = (tx + 2 * halo) * (ty + 2 * halo)
    if wetting:
        smem = 4 * 3 * plane + 4 * 3 * (tx + 2) * (ty + 2) + plane
    else:
        smem = 4 * 4 * plane
    return sm.tile_launch(shape, tile, halo, smem)


class _Tables(ctypes.Structure):
    _fields_ = [('c', (ctypes.c_int * 3) * 19), ('opp', ctypes.c_int * 19),
                ('ov', (ctypes.c_int * 3) * 6)] + [
        (name, ctypes.c_float * 19)
        for name in ('w', 'wi', 'wxx', 'wyy', 'wzz', 'wxy', 'wyz', 'wxz')]


def lattice_tables(grid=lattice.D3Q19):
    """``_Tables`` filled from ``sailfish_tpu_torch.lattice`` and
    ``multigrid.fe_weights``: what ``fe_d3q19_tables`` must copy out."""
    t = _Tables()
    for i in range(grid.Q):
        t.c[i][:] = [int(v) for v in grid.basis[i]]
        t.opp[i] = int(grid.opposite[i])
        t.w[i] = float(grid.weights[i])
    for k, vec in enumerate(grid.orientation_vectors):
        t.ov[k][:] = [int(v) for v in vec]
    for name, vals in mg.fe_weights(grid).items():
        getattr(t, name)[:] = [float(v) for v in vals]
    return t


def check_tables(tables, grid=lattice.D3Q19):
    """Raise RuntimeError unless the ``_Tables`` ``tables`` (the 3D
    kernel's compile-time tables) equal ``lattice_tables(grid)``, every
    integer exactly and every weight to the last bit of its float32."""
    ref = lattice_tables(grid)
    bad = [name for name, _ in _Tables._fields_
           if not np.array_equal(np.ctypeslib.as_array(getattr(tables, name)),
                                 np.ctypeslib.as_array(getattr(ref, name)))]
    if bad:
        raise RuntimeError(
            f'the compile-time {grid.name} tables of csrc/fe_step.cu differ '
            f'from sailfish_tpu_torch.lattice / multigrid.fe_weights in '
            f'{", ".join(bad)}')


def kernel_function(lib, grid_name):
    """The C entry ``fe_step_<grid>`` of a loaded ``csrc/fe_step.cu``
    library, typed for ``ctypes``, after checking that the library's
    parameter block matches ``_Params`` and, for D3Q19, that the 3D
    kernel's compile-time tables match the lattice (``check_tables``)."""
    lib.fe_params_size.restype = ctypes.c_int
    if lib.fe_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError('FEParams layout differs between '
                           'csrc/fe_step.cu and ops/fe_step.py')
    fn = getattr(lib, f'fe_step_{grid_name.lower()}')
    args = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.POINTER(_Params)]
    if grid_name == 'D3Q19':
        lib.fe_tables_size.restype = ctypes.c_int
        if lib.fe_tables_size() != ctypes.sizeof(_Tables):
            raise RuntimeError('FETables layout differs between '
                               'csrc/fe_step.cu and ops/fe_step.py')
        tables = _Tables()
        lib.fe_d3q19_tables.argtypes = [ctypes.POINTER(_Tables)]
        lib.fe_d3q19_tables.restype = None
        lib.fe_d3q19_tables(ctypes.byref(tables))
        check_tables(tables, lattice.D3Q19)
        args.append(ctypes.POINTER(sm._Tile))
    fn.argtypes = args + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class FEStep(sm.BufferedMultiStep):
    """The kernel engine for one free-energy scene: the A and B buffers
    (one (2, Q, *S) tensor each, swapped every step), the (*S) phi
    buffer, the uint8 mask, the uint8 orientation map of the dry nodes
    (None without walls), and ``launches``, this object's kernel launches
    by kernel name."""

    def __init__(self, builder):
        reasons = kernel_ineligibility(builder)
        if reasons:
            raise NotImplementedError(
                'the CUDA free-energy kernel cannot run this scene: '
                + '; '.join(reasons))
        self.builder = builder
        self.K = 2
        self.grid = builder.grid
        self.mrt = builder.fe_model == 'mrt'
        mask_np = ls.classify_nodes(builder.maps)[0]
        self.shape = mask_np.shape
        self.device = builder.device
        self.mask = torch.as_tensor(mask_np, device=self.device)
        self.orient = None
        if builder._has_dry_nodes:
            self.orient = builder._dry_orient.to(torch.uint8)
        full = (2, self.grid.Q) + self.shape
        self.a = torch.empty(full, dtype=torch.float32, device=self.device)
        self.b = torch.empty_like(self.a)
        self.phi = torch.empty(self.shape, dtype=torch.float32,
                               device=self.device)
        self.rho_params = sm.kernel_params(self.grid, self.shape, [1.0], {},
                                           'linear')
        self.params = kernel_params(builder, self.shape,
                                    self.orient is not None)
        self.tile = None
        self._tile_args = ()
        if self.grid.name == 'D3Q19':
            self.set_tile(TILE_3D)
        g = self.grid.name.lower()
        self.rho_name = f'rho_poststream_{g}'
        self.name = f'fe_step_{g}'
        self.launches = {self.rho_name: 0, self.name: 0}
        self._fns = None

    def set_tile(self, tile):
        """Launch the 3D kernel with the tile (tx, ty, kz) from now on."""
        self.tile = tile_geometry(self.shape, self.orient is not None, tile)
        self._tile_params = self.tile.params()
        self._tile_args = (ctypes.byref(self._tile_params),)

    def _kernels(self):
        if self._fns is None:
            from sailfish_tpu_torch.ops import build
            libs = build.load_all(['sc_multi', 'fe_step'])
            rho_fn = sm.kernel_functions(libs['sc_multi'].lib,
                                         self.grid.name)[0]
            self._fns = (rho_fn, kernel_function(libs['fe_step'].lib,
                                                 self.grid.name))
        return self._fns

    def _stream(self):
        return torch.cuda.current_stream(self.device).cuda_stream

    def phi_into(self, src, phi):
        """Post-stream order parameter of the (2, Q, *S) state ``src``
        into the (*S) buffer ``phi``: the ``rho_poststream`` kernel on
        component 1 of a CUDA tensor, ``sc_multi.torch_density`` on a CPU
        tensor."""
        self._check((src, self.a.shape), (phi, self.phi.shape))
        if src.device.type == 'cpu':
            phi.copy_(sm.torch_density(src[1], self.grid))
            return
        if src.device.type != 'cuda':
            raise ValueError(f'no kernel for device {src.device}')
        rc = self._kernels()[0](src[1].data_ptr(), phi.data_ptr(), 1,
                                ctypes.byref(self.rho_params),
                                self._stream())
        if rc != 0:
            raise RuntimeError(f'{self.rho_name} launch failed: CUDA error '
                               f'{rc}')
        self.launches[self.rho_name] += 1
        sm.LAUNCHES[self.rho_name] += 1

    def collide_into(self, src, phi, dst):
        """One free-energy step from ``src`` into ``dst`` (distinct (2, Q,
        *S) buffers) given the pre-pass order parameter ``phi``: the
        ``fe_step`` kernel on a CUDA tensor, ``fe_step_reference`` on a
        CPU tensor."""
        self._check((src, self.a.shape), (phi, self.phi.shape),
                    (dst, self.a.shape))
        if src.data_ptr() == dst.data_ptr():
            raise ValueError('the pull step cannot run in place')
        if src.device.type == 'cpu':
            out = fe_step_reference(src.unbind(0), phi, self.mask,
                                    self.orient, self.builder)
            for k in range(2):
                dst[k].copy_(out[k])
            return
        if src.device.type != 'cuda':
            raise ValueError(f'no kernel for device {src.device}')
        orient = 0 if self.orient is None else self.orient.data_ptr()
        rc = self._kernels()[1](src.data_ptr(), phi.data_ptr(),
                                dst.data_ptr(), self.mask.data_ptr(), orient,
                                int(self.mrt), ctypes.byref(self.params),
                                *self._tile_args, self._stream())
        if rc != 0:
            raise RuntimeError(f'{self.name} launch failed: CUDA error {rc}')
        self.launches[self.name] += 1
        LAUNCHES[self.name] += 1

    def step_into(self, src, dst):
        """One step: the order-parameter pre-pass into ``self.phi``, then
        the free-energy step from ``src`` into ``dst``."""
        self.phi_into(src, self.phi)
        self.collide_into(src, self.phi, dst)
