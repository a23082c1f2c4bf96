"""Equilibrium distributions and macroscopic moments on torch tensors.

Port of ``sailfish_tpu/equilibrium.py:21-148``. Distributions have shape
(Q, *spatial), macroscopic fields (*spatial) or (dim, *spatial). Every
Q-axis contraction is an unrolled chain of +/- adds over the lattice's
{-1, 0, 1} components, never a matmul or einsum, so no TF32 path can touch
it and the operation order follows the JAX functions term by term.
"""

from __future__ import annotations

import numpy as np
import torch


def signed_sum(coeffs, terms):
    """sum_i coeffs[i] * terms[i] with coeffs small integers, emitted as
    unrolled +/- adds."""
    acc = None
    for w, t in zip(coeffs, terms):
        w = int(w)
        if w == 0:
            continue
        term = t if w == 1 else (-t if w == -1 else w * t)
        acc = term if acc is None else acc + term
    if acc is None:
        acc = torch.zeros_like(terms[0])
    return acc


def momentum(grid, f):
    """(dim, *S) momentum: mom_a = sum_i c_ia f_i."""
    fs = [f[i] for i in range(grid.Q)]
    return torch.stack([signed_sum(grid.basis[:, a], fs)
                        for a in range(grid.dim)])


def density(grid, f):
    """rho (*S) from distributions f (Q, *S)."""
    return torch.sum(f, dim=0)


def macroscopic(grid, f):
    """rho (*S), u (dim, *S) from distributions f (Q, *S)."""
    rho = density(grid, f)
    u = momentum(grid, f) / rho[None]
    return rho, u


def dot_cu(grid, u):
    """(Q, *S) array of c_i . u."""
    us = [u[a] for a in range(grid.dim)]
    return torch.stack([signed_sum(grid.basis[i], us)
                        for i in range(grid.Q)])


def _weights(grid, like):
    shape = (grid.Q,) + (1,) * (like.dim())
    return torch.as_tensor(grid.weights, dtype=like.dtype,
                           device=like.device).reshape(shape)


def bgk_equilibrium(grid, rho, u, *, incompressible=False):
    """Second-order Hermite equilibrium
    f_eq_i = w_i [rho + rho_m (3 c.u + 4.5 (c.u)^2 - 1.5 u.u)],
    rho_m = rho (compressible) or 1 (incompressible)."""
    cu = dot_cu(grid, u)
    usq = torch.sum(u * u, dim=0)
    poly = 3.0 * cu + 4.5 * cu * cu - 1.5 * usq[None]
    rho_m_poly = poly if incompressible else rho[None] * poly
    return _weights(grid, rho) * (rho[None] + rho_m_poly)


def shallow_water_equilibrium(grid, rho, u, gravity):
    """Shallow-water equilibrium on D2Q9, rho the water height h
    (``sailfish_tpu/equilibrium.py:87-104``):
      f0 = h - w0 h (15/8 g h - 3 u.u)
      fi = w_i h (3/2 g h + 3 c.u + 9/2 (c.u)^2 - 3/2 u.u)."""
    assert grid.dim == 2 and grid.Q == 9, \
        'shallow water equation requires the D2Q9 grid'
    cu = dot_cu(grid, u)
    usq = torch.sum(u * u, dim=0)
    w = [float(x) for x in grid.weights]
    out = [rho - w[0] * rho * ((15.0 / 8.0) * gravity * rho - 3.0 * usq)]
    for i in range(1, grid.Q):
        out.append(w[i] * rho * (
            1.5 * gravity * rho + 3.0 * cu[i] + 4.5 * cu[i] * cu[i]
            - 1.5 * usq))
    return torch.stack(out)


def second_moment_noneq(grid, f, feq):
    """Pi^(1)_ab = sum_i c_ia c_ib (f_i - feq_i), shape (dim, dim, *S)."""
    fneq = f - feq
    fs = [fneq[i] for i in range(grid.Q)]
    c = grid.basis
    return torch.stack([
        torch.stack([signed_sum(c[:, a] * c[:, b], fs)
                     for b in range(grid.dim)])
        for a in range(grid.dim)])


def regularized_f(grid, rho, u, pi_neq, *, incompressible=False):
    """feq + w_i / (2 cs^4) Q_i : Pi^(1), Q_i = c_i c_i - cs^2 I."""
    cs2 = grid.cs2
    feq = bgk_equilibrium(grid, rho, u, incompressible=incompressible)
    c = grid.basis.astype(np.float64)
    qpi_terms = []
    for i in range(grid.Q):
        acc = None
        for a in range(grid.dim):
            for b in range(grid.dim):
                coef = c[i, a] * c[i, b] - (cs2 if a == b else 0.0)
                if abs(coef) < 1e-14:
                    continue
                t = coef * pi_neq[a, b]
                acc = t if acc is None else acc + t
        if acc is None:
            acc = torch.zeros_like(rho)
        qpi_terms.append(acc)
    qpi = torch.stack(qpi_terms)
    return feq + _weights(grid, rho) * qpi / (2.0 * cs2 * cs2)
