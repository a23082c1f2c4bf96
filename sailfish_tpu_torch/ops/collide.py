"""Collision operators on torch tensors (port of
``sailfish_tpu/ops/collide.py``): BGK, multiple-relaxation-time (MRT; TRT
is MRT with the same rate vector), the Smagorinsky subgrid tau field, the
Guo and exact-difference forcing terms and the Shan-Chen pseudopotential
force. The entropic (ELBM) collision is in ``ops/entropic.py``."""

from __future__ import annotations

import functools

import numpy as np
import torch

from sailfish_tpu_torch import equilibrium as eq


def bgk_collide(grid, f, rho, u, tau_inv, *, incompressible=False):
    """f + (feq - f) / tau; ``tau_inv`` a scalar or a per-node field."""
    feq = eq.bgk_equilibrium(grid, rho, u, incompressible=incompressible)
    return f + tau_inv * (feq - f)


def mrt_operator(grid, rates):
    """R = M^-1 diag(s) M in float64 for the (Q,) rate vector ``rates``
    (``Grid.mrt_relaxation_rates``), with the round-off entries of the
    product (below 1e-12) set to 0."""
    r = grid.mrt_inv @ np.diag(np.asarray(rates, dtype=np.float64)) \
        @ grid.mrt_matrix
    r[np.abs(r) < 1e-12] = 0.0
    return r


@functools.lru_cache(maxsize=32)
def mrt_columns(grid, rates, dtype, device):
    """The columns j of ``mrt_operator(grid, rates)`` that hold a nonzero
    entry, as (j, (Q,) tensor of ``dtype`` on ``device``); ``rates`` a
    tuple. Built once per rate vector, dtype and device, so a step copies
    nothing from the host."""
    r = mrt_operator(grid, rates)
    return tuple((j, torch.as_tensor(r[:, j], dtype=dtype, device=device))
                 for j in range(grid.Q) if r[:, j].any())


def mrt_collide(grid, f, rho, u, rates, *, incompressible=False):
    """Multiple-relaxation-time collision in its dense moment-space form
    f + R (feq - f), R = M^-1 diag(s) M (``sailfish_tpu/ops/collide.py
    :27-45``): equal to BGK when every rate is 1/tau. The Q-axis contraction
    is an unrolled sum over the columns of R that hold a nonzero entry
    (``mrt_columns``), each column times one (feq - f)_j plane (no matmul
    or einsum, so no TF32 path touches it)."""
    feq = eq.bgk_equilibrium(grid, rho, u, incompressible=incompressible)
    dneq = feq - f
    shape = (grid.Q,) + (1,) * (f.dim() - 1)
    acc = None
    for j, col in mrt_columns(grid, tuple(float(s) for s in rates),
                              f.dtype, f.device):
        term = col.reshape(shape) * dneq[j]
        acc = term if acc is None else acc + term
    return f if acc is None else f + acc


def smagorinsky_tau_inv(grid, f, feq, rho, tau, cs_smag):
    """Effective 1/tau field of the Smagorinsky subgrid model
    (``sailfish_tpu/ops/collide.py:48-61``; Yu, Girimaji & Luo 2005):
    strain = sum_ab Pi_ab^2 over the non-equilibrium stress (off-diagonal
    entries counted twice), tau_eff = tau + (sqrt(tau^2 + 36 C^2
    sqrt(strain)) - tau) / 2. Returns (*S)."""
    pi = eq.second_moment_noneq(grid, f, feq)
    strain = torch.sum(pi * pi, dim=(0, 1))
    tau_t = 0.5 * (torch.sqrt(tau * tau + 36.0 * (cs_smag ** 2)
                              * torch.sqrt(strain)) - tau)
    return 1.0 / (tau + tau_t)


def guo_force_terms(grid, u, accel, tau_inv, rho=None):
    """Guo (2002) forcing increment
    S_i = w_i (1 - 1/(2 tau)) rho [3 (c_i - u) + 9 (c_i . u) c_i] . a
    (``sailfish_tpu/ops/collide.py:65-86``). ``accel`` is an acceleration,
    (dim, *S) or broadcastable; ``tau_inv`` a scalar or a per-node field.
    Returns the (Q, *S) post-collision increment."""
    cu = eq.dot_cu(grid, u)
    cF = eq.dot_cu(grid, accel)
    uF = torch.sum(u * accel, dim=0)
    wq = torch.as_tensor(grid.weights, dtype=u.dtype, device=u.device)
    wq = wq.reshape((grid.Q,) + (1,) * (cu.dim() - 1))
    pref = 1.0 - 0.5 * tau_inv
    out = pref * wq * (3.0 * (cF - uF[None]) + 9.0 * cu * cF)
    if rho is not None:
        out = out * rho[None]
    return out


def edm_shift(grid, rho, u, accel, *, incompressible=False):
    """Exact-difference-method forcing increment
    feq(rho, u + a) - feq(rho, u) with the bare velocity ``u``
    (``sailfish_tpu/ops/collide.py:115-123``). ``accel`` is an
    acceleration, (dim, *S) or broadcastable. Returns (Q, *S)."""
    return (eq.bgk_equilibrium(grid, rho, u + accel,
                               incompressible=incompressible)
            - eq.bgk_equilibrium(grid, rho, u, incompressible=incompressible))


SHAN_CHEN_POTENTIALS = {
    'linear': lambda rho: rho,
    'classic': lambda rho: 1.0 - torch.exp(-rho),
}


def shan_chen_force(grid, rho_self, rho_other, coupling, potential='linear'):
    """Pseudopotential interaction force
    F(x) = -G psi(rho_self(x)) sum_i w_i psi(rho_other(x + c_i)) c_i
    (``sailfish_tpu/ops/collide.py:95-112``, same accumulation order:
    directions 1..Q-1, then axis). Returns (dim, *S)."""
    from sailfish_tpu_torch.ops.step import sample
    psi_fn = SHAN_CHEN_POTENTIALS[potential]
    psi_other = psi_fn(rho_other)
    acc = [torch.zeros_like(rho_self) for _ in range(grid.dim)]
    for i in range(1, grid.Q):
        psi_n = sample(psi_other, grid.basis[i])
        w = float(grid.weights[i])
        for a in range(grid.dim):
            c = int(grid.basis[i][a])
            if c:
                acc[a] = acc[a] + (w * c) * psi_n
    psi_self = psi_fn(rho_self)
    return torch.stack([-coupling * psi_self * a for a in acc])
