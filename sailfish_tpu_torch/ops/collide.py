"""Collision operators on torch tensors (port of
``sailfish_tpu/ops/collide.py``; BGK only so far -- MRT/TRT, ELBM, LES and
the forcing terms are still to be ported)."""

from __future__ import annotations

from sailfish_tpu_torch import equilibrium as eq


def bgk_collide(grid, f, rho, u, tau_inv, *, incompressible=False):
    """f + (feq - f) / tau; ``tau_inv`` a scalar or a per-node field."""
    feq = eq.bgk_equilibrium(grid, rho, u, incompressible=incompressible)
    return f + tau_inv * (feq - f)
