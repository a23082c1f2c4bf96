"""The port's equilibrium and BGK collision against the JAX functions.

Same random D2Q9 / D3Q19 fields (numpy, fixed seed) through
``sailfish_tpu.equilibrium`` / ``ops.collide`` and their torch
counterparts. Tolerance: rtol 1e-6 with an atol of 1e-7 for entries that
are differences of O(0.1) terms (momenta, non-equilibrium moments), where
the two frameworks' summation and FMA order differ by a few fp32 ulps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu import equilibrium as jeq
from sailfish_tpu import lattice
from sailfish_tpu.ops import collide as jco
from sailfish_tpu_torch import equilibrium as teq
from sailfish_tpu_torch.ops import collide as tco

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-7
SHAPES = {'D2Q9': (12, 10), 'D3Q19': (6, 5, 4)}


def _fields(grid_name, seed=7):
    g = lattice.get_grid(grid_name)
    rng = np.random.default_rng(seed)
    shape = SHAPES[grid_name]
    rho = (1.0 + 0.05 * rng.standard_normal(shape)).astype(np.float32)
    u = (0.05 * rng.standard_normal((g.dim,) + shape)).astype(np.float32)
    feq = np.asarray(jeq.bgk_equilibrium(g, jnp.asarray(rho),
                                         jnp.asarray(u)))
    f = (feq * (1.0 + 0.02 * rng.standard_normal(feq.shape))).astype(
        np.float32)
    return g, rho, u, f


def _both(fn_jax, fn_torch, *arrays):
    out_j = fn_jax(*[jnp.asarray(a) for a in arrays])
    out_t = fn_torch(*[torch.tensor(a) for a in arrays])
    return out_j, out_t


def _close(out_j, out_t):
    if isinstance(out_j, tuple):
        for a, b in zip(out_j, out_t):
            _close(a, b)
        return
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('grid_name', ['D2Q9', 'D3Q19'])
@pytest.mark.parametrize('name', [
    'macroscopic', 'momentum', 'dot_cu', 'bgk_equilibrium',
    'bgk_equilibrium_incompressible', 'second_moment_noneq',
    'regularized_f', 'bgk_collide'])
def test_matches_jax(grid_name, name):
    g, rho, u, f = _fields(grid_name)
    feq = np.asarray(jeq.bgk_equilibrium(g, jnp.asarray(rho),
                                         jnp.asarray(u)))
    pi = np.asarray(jeq.second_moment_noneq(g, jnp.asarray(f),
                                            jnp.asarray(feq)))
    cases = {
        'macroscopic': (lambda m, x: m.macroscopic(g, x), (f,)),
        'momentum': (lambda m, x: m.momentum(g, x), (f,)),
        'dot_cu': (lambda m, x: m.dot_cu(g, x), (u,)),
        'bgk_equilibrium': (lambda m, r, v: m.bgk_equilibrium(g, r, v),
                            (rho, u)),
        'bgk_equilibrium_incompressible': (
            lambda m, r, v: m.bgk_equilibrium(g, r, v, incompressible=True),
            (rho, u)),
        'second_moment_noneq': (
            lambda m, x, y: m.second_moment_noneq(g, x, y), (f, feq)),
        'regularized_f': (lambda m, r, v, p: m.regularized_f(g, r, v, p),
                          (rho, u, pi)),
    }
    if name == 'bgk_collide':
        tau_inv = 1.0 / 0.8
        out_j, out_t = _both(
            lambda x, r, v: jco.bgk_collide(g, x, r, v, tau_inv),
            lambda x, r, v: tco.bgk_collide(g, x, r, v, tau_inv),
            f, rho, u)
    else:
        fn, args = cases[name]
        out_j, out_t = _both(lambda *a: fn(jeq, *a),
                             lambda *a: fn(teq, *a), *args)
    _close(out_j, out_t)


def test_signed_sum_skips_zero_terms():
    terms = [torch.tensor([1.0, 2.0]), torch.tensor([10.0, 20.0]),
             torch.tensor([100.0, 200.0])]
    out = teq.signed_sum([1, 0, -1], terms)
    assert out.tolist() == [-99.0, -198.0]
    assert teq.signed_sum([0, 0, 0], terms).tolist() == [0.0, 0.0]


@pytest.mark.parametrize('vec', [(1, 0, 0), (0, -1, 0), (0, 0, 1),
                                 (1, -1, 0), (-1, 0, 1), (0, 1, -1)])
def test_pull_and_sample_match_jax(vec):
    from sailfish_tpu.ops import step as jstep
    from sailfish_tpu_torch.ops import step as tstep
    arr = np.random.default_rng(1).standard_normal((3, 4, 5)).astype(
        np.float32)
    for name in ('pull', 'sample'):
        out_j = getattr(jstep, name)(jnp.asarray(arr), vec)
        out_t = getattr(tstep, name)(torch.tensor(arr), vec)
        np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
