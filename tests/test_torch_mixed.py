"""--precision=mixed on the port: int16 fixed-point storage, fp32 math
(``sailfish_tpu_torch/ops/mixed.py``), on the CPU.

* ``MixedScales``: ``w``, ``ws`` and ``inv_ws`` bitwise equal to the JAX
  package's for D2Q9 and D3Q19 at two ranges; ``quant`` / ``dequant`` of
  the same seeded arrays bitwise equal to JAX's; every one of the 65,536
  codes of every direction round-trips (tests/test_mixed.py:17-32).
* The torch engine with ``storage='int16'`` against JAX's
  ``StepBuilder(storage='int16')`` (the XLA engine, which the JAX package
  holds bitwise to its Pallas mixed kernel, tests/test_mixed.py:35-55),
  20 steps from one quantized state: wet max |dq_i| <= 2 codes, rho and u
  within 3e-5 (two code steps of the heaviest distribution,
  regtest/engine_equivalence.py:127-141). The two fp32 engines differ by
  ulps, and an ulp can cross a rounding boundary, so they are not bitwise
  equal.
* The kernel engine's plain version (``KernelStep`` on the CPU, int16 A/B
  buffers) against the torch engine on the same scenes, within the same
  code bound.
* Chunk independence, bitwise: 12 steps in one chunk equal 3 chunks of 4,
  on both engines (tests/test_mixed.py:58-72).
* Shear-wave decay: the measured viscosity within 1.5 %
  (tests/test_mixed.py:141-176).
* Refusals, each naming its reason; checkpoints (an fp32 one restored into
  a mixed run is snapped to the grid, a mixed one round-trips exactly).
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu import lattice as jlattice
from sailfish_tpu.ops.mixed import MixedScales as JaxMixedScales
from sailfish_tpu.ops.step import StepBuilder as JaxStepBuilder
from sailfish_tpu_torch import lattice
from sailfish_tpu_torch.ops import lbm_step as ls
from sailfish_tpu_torch.ops.mixed import DEFAULT_RANGE, QMAX, MixedScales
from sailfish_tpu_torch.ops.step import StepBuilder
from sailfish_tpu_torch.state import state_to_numpy
from torch_scenes import (ACCEL, WALLS, box_cfg, box_sim, binary_twin,
                          channel_sim, cpu_runner, forced, periodic_box,
                          random_feq, run, shear_wave_viscosity, twin,
                          wet_map)

torch.set_num_threads(1)

STEPS = 20
#: wet max |dq_i| between two fp32 engines after STEPS steps
CODE_TOL = 2
#: rho and u between them (regtest/engine_equivalence.py:127-141)
MACRO_TOL = 3e-5


@pytest.mark.parametrize('range_', [0.5, 1.0])
@pytest.mark.parametrize('name', ['D2Q9', 'D3Q19'])
def test_scales_equal_jax_bitwise(name, range_):
    mt = MixedScales(lattice.get_grid(name), range_)
    mj = JaxMixedScales(jlattice.get_grid(name), range_)
    for attr in ('w', 'ws', 'inv_ws'):
        a = np.asarray(getattr(mt, attr), np.float32)
        b = np.asarray(getattr(mj, attr), np.float32)
        assert a.tobytes() == b.tobytes(), attr
    assert (QMAX, DEFAULT_RANGE) == (32767.0, 0.5)


@pytest.mark.parametrize('name', ['D2Q9', 'D3Q19'])
def test_quant_and_dequant_equal_jax_bitwise(name):
    grid = lattice.get_grid(name)
    mt = MixedScales(grid)
    mj = JaxMixedScales(jlattice.get_grid(name))
    rng = np.random.default_rng(11)
    w = np.asarray(grid.weights, np.float32).reshape(-1, 1, 1)
    # deviations across the whole range and past it (clipping), ties
    f = (w * (1.0 + rng.uniform(-0.7, 0.7, (grid.Q, 16, 24)))).astype(
        np.float32)
    q = rng.integers(-32768, 32768, (grid.Q, 16, 24)).astype(np.int16)
    qt = mt.quant(torch.from_numpy(f)).numpy()
    assert qt.dtype == np.int16
    assert np.array_equal(qt, np.asarray(mj.quant(jnp.asarray(f))))
    assert (qt == -32768).any() and (qt == 32767).any()
    ft = mt.dequant(torch.from_numpy(q)).numpy()
    assert ft.tobytes() == np.asarray(mj.dequant(jnp.asarray(q))).tobytes()
    for i in (0, 1, grid.Q - 1):
        assert np.array_equal(
            mt.quant_i(i, torch.from_numpy(f[i])).numpy(),
            np.asarray(mj.quant_i(i, jnp.asarray(f[i]))))
        assert mt.dequant_i(i, torch.from_numpy(q[i])).numpy().tobytes() \
            == np.asarray(mj.dequant_i(i, jnp.asarray(q[i]))).tobytes()


@pytest.mark.parametrize('name', ['D2Q9', 'D3Q19'])
def test_every_code_round_trips(name):
    """quant(dequant(q)) == q for every int16 code and every direction,
    one at a time and as a whole state."""
    grid = lattice.get_grid(name)
    mx = MixedScales(grid)
    codes = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    for i in range(grid.Q):
        assert torch.equal(mx.quant_i(i, mx.dequant_i(i, codes)), codes), i
    state = torch.stack([torch.roll(codes, 7 * i) for i in range(grid.Q)])
    assert torch.equal(mx.quant(mx.dequant(state)), state)


#: the scenes of the engine comparisons: name -> (sim class, flags)
SCENES = {
    'ldc_3d': (twin('ldc_3d'), dict(lat_nx=16, lat_ny=16, lat_nz=16)),
    'ldc_2d': (twin('ldc_2d'), dict(lat_nx=32, lat_ny=32)),
    'periodic_box_guo': (forced(periodic_box(3), ACCEL), dict(
        lat_nx=16, lat_ny=12, lat_nz=10, periodic_x=True, periodic_y=True,
        periodic_z=True)),
    'ldc_3d_mrt': (twin('ldc_3d'), dict(lat_nx=16, lat_ny=16, lat_nz=16,
                                        model='mrt', visc=0.05)),
    'halfbb_box_guo': (box_sim(WALLS['halfbb'], 3, (1,), ACCEL),
                       box_cfg(3, (1,))),
    'tms_box_2d': (box_sim(WALLS['tms'], 2, (0, 1)), box_cfg(2, (0, 1))),
    'channel_regularized': (channel_sim('regularized', 'z'), dict(
        lat_nx=12, lat_ny=12, lat_nz=16, periodic_x=True)),
}


def _mixed(scene):
    sim_cls, cfg = SCENES[scene]
    r = cpu_runner(sim_cls, precision='mixed', **cfg)
    assert r.engine == 'torch' and r.builder.mixed is not None
    return r


def _codes(mx, f):
    return mx.quant(f).numpy().astype(np.int32)


@pytest.mark.parametrize('scene', sorted(SCENES))
def test_torch_engine_matches_jax_int16_engine(scene):
    r = _mixed(scene)
    b = r.builder
    mx = b.mixed
    jb = JaxStepBuilder(r.sim.grid, r.maps, visc=r.config.visc,
                        dtype=jnp.float32, body_force=b.body_force,
                        model=r.config.model, storage='int16')
    assert list(jb.mixed.ws) == mx.ws
    jstep = jax.jit(jb.build())
    step = b.build()
    f0 = mx.snap(random_feq(r.sim.grid, r.maps.type_map.shape, 5, 'cpu'))
    ft, fj = f0, jnp.asarray(f0.numpy())
    for it in range(STEPS):
        ft, fj = step(ft, it), jstep(fj, it)
    fj = torch.from_numpy(np.asarray(fj).copy())
    wet = wet_map(r.maps)
    # the torch engine's state is on the int16 grid (JAX's is up to the
    # rounding of its fused dequantization, which quant undoes)
    assert torch.equal(mx.snap(ft), ft)
    dq = np.abs(_codes(mx, ft) - _codes(mx, fj))[:, wet]
    assert dq.max() <= CODE_TOL, dq.max()
    rho_j, u_j = jax.jit(jb.macro_fields)(jnp.asarray(fj.numpy()))
    rho_t, u_t = b.macro_fields(ft)
    assert np.abs(rho_t.numpy() - np.asarray(rho_j))[wet].max() \
        <= MACRO_TOL
    assert np.abs(u_t.numpy() - np.asarray(u_j))[:, wet].max() <= MACRO_TOL


@pytest.mark.parametrize('scene', sorted(SCENES))
def test_kernel_plain_version_matches_torch_engine(scene):
    """``KernelStep`` under --precision=mixed on the CPU: int16 A/B
    buffers, the mixed library and key, and its plain version (dequantize,
    ``step_reference``, quantize) within the code bound of the torch
    engine."""
    r = _mixed(scene)
    ks = ls.KernelStep(r.builder)
    g = ks.grid.name.lower()
    assert ks.name == ks.entry == f'lbm_step_mixed_{g}'
    assert ks.library == ls.MIXED_LIBRARIES[ks.params.coll.model]
    assert ks.a.dtype == ks.b.dtype == torch.int16
    assert ks.out.dtype == torch.float32
    mx = ks.mixed
    f0 = mx.snap(random_feq(ks.grid, ks.shape, 6, 'cpu'))
    step = r.builder.build()
    ft = f0
    for it in range(STEPS):
        ft = step(ft, it)
    fk = ks.run(f0, STEPS)
    assert fk is ks.out and torch.equal(mx.snap(fk), fk)
    wet = wet_map(r.maps)
    dq = np.abs(_codes(mx, fk) - _codes(mx, ft))[:, wet]
    assert dq.max() <= CODE_TOL, dq.max()
    # the plain version steps codes: int16 in, int16 out
    q = ks.reference(mx.quant(f0))
    assert q.dtype == torch.int16
    with pytest.raises(ValueError, match='torch.int16'):
        ks.step_into(f0, torch.empty_like(f0))


def test_chunks_add_no_rounding():
    """12 steps in one chunk equal 3 chunks of 4, bitwise, on the torch
    engine through the controller and on the kernel engine's ``run``
    (whose chunks quantize the fp32 state into A and dequantize the
    result)."""
    cfg = dict(lat_nx=16, lat_ny=16, lat_nz=16, precision='mixed')

    def controller(every):
        return run(twin('ldc_3d'), platform='cpu', max_iters=12,
                   every=every, **cfg).f

    assert torch.equal(controller(12), controller(4))
    r = cpu_runner(twin('ldc_3d'), **cfg)
    ks = ls.KernelStep(r.builder)
    one = ks.run(r.f, 12).clone()
    f = r.f
    for it0 in (0, 4, 8):
        f = ks.run(f.clone(), 4, it0)
    assert torch.equal(one, f)


def test_shear_wave_viscosity():
    """int16 storage keeps the shear-wave viscosity within 1.5 % (fp32
    gives ~0.1 %)."""
    n, visc = 64, 0.02
    r = cpu_runner(periodic_box(3), precision='mixed', periodic_x=True,
                   periodic_y=True, periodic_z=True, lat_nx=n, lat_ny=8,
                   lat_nz=8, visc=visc)
    step = r.builder.build()

    class Engine:
        @staticmethod
        def run(f, n_steps):
            for it in range(n_steps):
                f = step(f, it)
            return f

    nu = shear_wave_viscosity(Engine, r.builder, n, visc)
    assert abs(nu - visc) / visc < 0.015, nu


@pytest.mark.parametrize('case,match', [
    ('fp64', 'mixed 16-bit storage requires fp32 compute'),
    ('shan_chen', 'mixed 16-bit storage does not cover Shan-Chen'),
    ('shallow_water', 'mixed 16-bit storage covers the standard '
     'equilibrium only \\(got shallow_water\\)'),
    ('mixture', '--precision=mixed covers single-fluid scenes only'),
])
def test_refusals_name_their_reason(case, match):
    small = dict(lat_nx=16, lat_ny=16)
    with pytest.raises(NotImplementedError, match=match):
        if case == 'fp64':
            r = cpu_runner(twin('ldc_2d'), **small)
            StepBuilder(r.sim.grid, r.maps, visc=0.1, dtype=torch.float64,
                        storage='int16')
        elif case == 'shan_chen':
            cpu_runner(twin('sc_phase_separation'), precision='mixed',
                       **small)
        elif case == 'shallow_water':
            cpu_runner(twin('fs_gaussian'), precision='mixed', **small)
        else:
            cpu_runner(binary_twin('sc_separation_2d'), precision='mixed',
                       **small)


def test_kernel_ineligibility_names_the_storage_refusals():
    """``kernel_ineligibility`` names what the builder refuses under int16
    storage, for a builder made otherwise, and nothing for the scenes the
    mode takes."""
    r = _mixed('ldc_3d_mrt')
    assert ls.kernel_ineligibility(r.builder) == []
    r.builder.sc_coupling = -1.6
    r.builder.dtype = torch.float64
    reasons = ls.kernel_ineligibility(r.builder)
    assert 'mixed 16-bit storage requires fp32 compute' in reasons
    assert 'mixed 16-bit storage does not cover Shan-Chen' in reasons


def test_checkpoints_snap_and_round_trip(tmp_path):
    cfg = dict(lat_nx=16, lat_ny=16, lat_nz=16)
    base = str(tmp_path / 'fp32')
    fp32 = run(twin('ldc_3d'), platform='cpu', max_iters=10, every=10,
               checkpoint_file=base, final_checkpoint=True, **cfg)
    (cpoint,) = glob.glob(base + '*.cpoint.npz')
    mx = MixedScales(fp32.sim.grid)
    assert not torch.equal(mx.snap(fp32.f), fp32.f)
    # an fp32 checkpoint restored into a mixed run is snapped once
    restored = run(twin('ldc_3d'), platform='cpu', max_iters=10, every=10,
                   precision='mixed', restore_from=cpoint, **cfg)
    assert restored.sim.iteration == 10
    assert torch.equal(restored.f, mx.snap(fp32.f))
    # a mixed checkpoint round-trips exactly: 10 + 10 steps == 20 steps
    base = str(tmp_path / 'mixed')
    run(twin('ldc_3d'), platform='cpu', max_iters=10, every=10,
        precision='mixed', checkpoint_file=base, final_checkpoint=True,
        **cfg)
    (cpoint,) = glob.glob(base + '*.cpoint.npz')
    saved = np.load(cpoint)['dist0a']
    assert np.array_equal(saved, state_to_numpy(mx.snap(
        torch.from_numpy(saved))))
    again = run(twin('ldc_3d'), platform='cpu', max_iters=20, every=10,
                precision='mixed', restore_from=cpoint, **cfg)
    whole = run(twin('ldc_3d'), platform='cpu', max_iters=20, every=20,
                precision='mixed', **cfg)
    assert torch.equal(again.f, whole.f)


def test_instantiation_reads_the_storage_type():
    """``lbm_step.instantiation`` reads the storage type, this build's last
    template argument (``f`` float, ``s`` int16_t); an older build's name
    without it has no 'storage'."""
    sig = 'EvPKT6_PS0_PKh9LBMParamsPKfPKiS9_N8ScalesOfIS0_E4typeE'
    mixed = ls.instantiation(
        f'_Z15lbm_step_kernelILi3ELi19ELi1ELb1ELi1ELi1ELb0Es{sig}')
    assert mixed == dict(dim=3, q=19, force='guo', walls=True, model='mrt',
                         equilibrium='incompressible', sc=False,
                         storage='int16')
    assert ls.instantiation(
        f'_Z15lbm_step_kernelILi2ELi9ELi0ELb0ELi0ELi2ELb0Ef{sig}')[
            'storage'] == 'fp32'
    old = '_Z15lbm_step_kernelILi2ELi9ELi0ELb0ELi0ELi0ELb1EEvPKfPfPKh'
    assert 'storage' not in ls.instantiation(old)


def test_mixed_entry_checks_its_block_and_is_typed():
    """``kernel_function`` refuses a mixed library whose ``LBMMixed``
    differs from ``_Mixed`` and types the mixed entry with the int16
    grid's block after the parameter block; ``mixed_params`` carries the
    ``MixedScales`` constants to the bit."""
    import ctypes

    from test_torch_lbm_step import _FakeLib

    def lib(mixed_size):
        fake = _FakeLib()
        fake.lbm_mixed_size = lambda: mixed_size
        fake.lbm_step_mixed_d3q19 = _FakeLib.Entry()
        return fake

    with pytest.raises(RuntimeError, match='LBMMixed layout differs'):
        ls.kernel_function(lib(ctypes.sizeof(ls._Mixed) - 4),
                           'lbm_step_mixed_d3q19')
    fn = ls.kernel_function(lib(ctypes.sizeof(ls._Mixed)),
                            'lbm_step_mixed_d3q19')
    assert fn.argtypes[5:] == [ctypes.POINTER(ls._Params),
                               ctypes.POINTER(ls._Mixed), ctypes.c_void_p]
    assert ctypes.sizeof(ls._Mixed) == 2 * 4 * ls.MAX_Q
    mx = MixedScales(lattice.get_grid('D3Q19'), 1.0)
    m = ls.mixed_params(mx)
    assert np.asarray(m.ws[:19], np.float32).tobytes() \
        == np.asarray(mx.ws, np.float32).tobytes()
    assert np.asarray(m.inv_ws[:19], np.float32).tobytes() \
        == np.asarray(mx.inv_ws, np.float32).tobytes()
