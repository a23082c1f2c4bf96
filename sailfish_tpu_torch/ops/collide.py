"""Collision operators on torch tensors (port of
``sailfish_tpu/ops/collide.py``; BGK, the Guo and exact-difference
forcing terms and the Shan-Chen pseudopotential force so far -- MRT/TRT,
ELBM and LES are still to be ported)."""

from __future__ import annotations

import torch

from sailfish_tpu_torch import equilibrium as eq


def bgk_collide(grid, f, rho, u, tau_inv, *, incompressible=False):
    """f + (feq - f) / tau; ``tau_inv`` a scalar or a per-node field."""
    feq = eq.bgk_equilibrium(grid, rho, u, incompressible=incompressible)
    return f + tau_inv * (feq - f)


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
