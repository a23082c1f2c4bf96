"""Entropic LBM (ELBM) on torch tensors: the product-form equilibrium, the
per-node alpha of the entropy equality and the entropic collision.

Port of ``sailfish_tpu/ops/entropic.py`` (:26-232), operation for operation:
every Q-reduction is an unrolled sequential chain with scalar per-direction
constants (``w_i`` and ``ln w_i`` rounded from float64 to the state's
dtype, as the JAX trace captures them), the same ``1e-12`` floors, the
max-alpha positivity bound, the two Newton stops, the ``isfinite -> 1.1``
and final ``-> 2.0`` guards and the series seed for alpha_0 in (1, 4).

The Newton solve is a loop over all lanes with convergence masking: a lane
that has converged keeps its alpha, and each step of a frozen lane
recomputes exactly what froze it, so the loop may stop as soon as every
lane is done (``all(done)``) and still return what a fixed 20-step loop
returns. ``skip`` marks lanes whose result the caller discards (dry nodes):
they count as converged from the start.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: the fp32 stand-in for +inf in the positivity bound (JAX's 3.4e38)
BIG = float(np.float32(3.4e38))
#: Newton steps at most
NEWTON_ITERS = 20
#: the dispatch thresholds on dev = max_i |fneq_i| / f_i: below the first
#: alpha is 2, below the second the series estimate, else Newton
TINY_DEV = 1e-6
SERIES_DEV = 0.01


def _const(x, like):
    """The float64 constant ``x`` rounded to ``like``'s dtype, as a 0-d
    tensor on its device (a captured scalar of the JAX trace)."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def elbm_equilibrium(grid, rho, u):
    """Product-form entropic equilibrium (Ansumali & Karlin, EPL 63 (2003)
    798):

      feq_i = rho w_i prod_a (2 - sqrt(1+3 u_a^2)) B_a^{c_ia},
      B_a = (2 u_a + sqrt(1 + 3 u_a^2)) / (1 - u_a)
    """
    pref = rho
    bs = []
    for a in range(grid.dim):
        ua = u[a]
        s = torch.sqrt(1.0 + 3.0 * ua * ua)
        pref = pref * (2.0 - s)
        bs.append((2.0 * ua + s) / (1.0 - ua))
    out = []
    for i in range(grid.Q):
        t = pref * _const(float(grid.weights[i]), rho)
        for a in range(grid.dim):
            c = int(grid.basis[i][a])
            if c == 1:
                t = t * bs[a]
            elif c == -1:
                t = t / bs[a]
        out.append(t)
    return torch.stack(out)


def _log_weights(grid, like):
    """ln w_i in float64, each rounded to ``like``'s dtype."""
    return [_const(math.log(float(w)), like) for w in grid.weights]


def _entropy(grid, f):
    """H(f) = sum_i f_i (ln f_i - ln w_i)."""
    acc = None
    for i, logw in enumerate(_log_weights(grid, f)):
        t = f[i] * (torch.log(f[i]) - logw)
        acc = t if acc is None else acc + t
    return acc


def alpha_series(grid, f, fneq):
    """Asymptotic expansion of the entropy equality in powers of fneq / f
    (PRL 97, 010201 (2006) Eq. 12)."""
    a1 = a2 = a3 = a4 = None
    for i in range(grid.Q):
        inv = 1.0 / f[i]
        t = fneq[i] * inv
        p = fneq[i] * t
        a1 = p if a1 is None else a1 + p
        p = p * t
        a2 = p if a2 is None else a2 + p
        p = p * t
        a3 = p if a3 is None else a3 + p
        p = p * t
        a4 = p if a4 is None else a4 + p
    a1 = a1 * 0.5
    a2 = a2 * (-1.0 / 6.0)
    a3 = a3 * (1.0 / 12.0)
    a4 = a4 * (-1.0 / 20.0)
    ia1 = 1.0 / a1
    # a ** 3 as JAX's integer_pow computes it: a * (a * a)
    return (2.0
            - 4.0 * a2 * ia1
            + 16.0 * a2 * a2 * ia1 * ia1
            - 8.0 * a3 * ia1
            + 80.0 * a2 * a3 * ia1 * ia1
            - 80.0 * (a2 * (a2 * a2)) * (ia1 * (ia1 * ia1))
            - 16.0 * a4 * ia1)


def alpha_newton(grid, f, fneq, alpha0, iters=NEWTON_ITERS,
                 entropy_tol=1e-6, skip=None, alpha_tol=1e-10):
    """Newton iteration on H(f + alpha fneq) = H(f) over all lanes, with the
    max-alpha positivity safeguard. ``skip``: lanes whose result the caller
    discards; they start converged, and when every lane is skipped the
    solve is not entered (alpha0 comes back)."""
    if skip is not None and bool(skip.all()):
        return alpha0
    return _alpha_newton_loop(grid, f, fneq, alpha0, iters, entropy_tol,
                              skip, alpha_tol)


def _alpha_newton_loop(grid, f, fneq, alpha0, iters, entropy_tol, skip,
                       alpha_tol=1e-10):
    ent0 = _entropy(grid, f)
    logws = _log_weights(grid, f)
    big = _const(BIG, f)
    max_alpha = None
    for i in range(grid.Q):
        r = torch.where(fneq[i] < 0.0, -f[i] / fneq[i], big)
        max_alpha = r if max_alpha is None else torch.minimum(max_alpha, r)

    def step(alpha):
        ent = dent = None
        for i in range(grid.Q):
            t = torch.clamp_min(f[i] + alpha * fneq[i], 1e-12)
            h = torch.log(t) - logws[i]
            e = t * h
            d = fneq[i] * (h + 1.0)
            ent = e if ent is None else ent + e
            dent = d if dent is None else dent + d
        inc = ent - ent0
        new_alpha = alpha - inc / dent
        new_alpha = torch.where(new_alpha > max_alpha,
                                0.5 * (alpha + max_alpha), new_alpha)
        new_alpha = torch.where(torch.isfinite(new_alpha), new_alpha,
                                _const(1.1, f))
        # the entropy residual (--entropy_tolerance) and alpha stagnation
        # (--alpha_tolerance)
        done = (torch.abs(inc) < entropy_tol) \
            | (torch.abs(new_alpha - alpha) < alpha_tol)
        if skip is not None:
            done = done | skip
        return torch.where(done, alpha, new_alpha), done

    alpha = alpha0
    all_done = skip is not None and bool(skip.all())
    i = 0
    while i < iters and not all_done:
        alpha, done = step(alpha)
        all_done = bool(done.all())
        i += 1
    return alpha


def deviation(grid, f, fneq):
    """dev = max_i |fneq_i| / max(f_i, 1e-12), the quantity the dispatch
    thresholds read (NaN propagates through the max)."""
    dev = None
    for i in range(grid.Q):
        d = torch.abs(fneq[i]) / torch.clamp_min(f[i], 1e-12)
        dev = d if dev is None else torch.maximum(dev, d)
    return dev


def branches(grid, f, fneq):
    """The dispatch branch of each lane: 0 tiny deviation (alpha = 2), 1 the
    series, 2 Newton (int8, the lanes' shape)."""
    dev = deviation(grid, f, fneq)
    return torch.where(dev < TINY_DEV, 0,
                       torch.where(dev < SERIES_DEV, 1, 2)).to(torch.int8)


def entropic_alpha(grid, f, fneq, alpha0=None, skip=None,
                   entropy_tol=1e-6, alpha_tol=1e-10):
    """The dispatch: tiny deviation -> 2; small -> series; large -> Newton
    (seeded by the series estimate where it lies in (1, 4)), then a
    non-finite or sub-1 alpha -> 2. ``skip``: lanes whose collision result
    the caller discards, kept out of the Newton loop's convergence test."""
    dev = deviation(grid, f, fneq)
    a_series = alpha_series(grid, f, fneq)
    if alpha0 is None:
        alpha0 = torch.where(
            torch.isfinite(a_series) & (a_series > 1.0) & (a_series < 4.0),
            a_series, _const(2.0, f))
    newton_skip = dev < SERIES_DEV
    if skip is not None:
        newton_skip = newton_skip | skip
    a_newton = alpha_newton(grid, f, fneq, alpha0, skip=newton_skip,
                            entropy_tol=entropy_tol, alpha_tol=alpha_tol)
    two = _const(2.0, f)
    alpha = torch.where(dev < TINY_DEV, two,
                        torch.where(dev < SERIES_DEV, a_series, a_newton))
    return torch.where(torch.isfinite(alpha) & (alpha >= 1.0), alpha, two)


def elbm_collide(grid, f, rho, u, tau, alpha0=None, skip=None,
                 entropy_tol=1e-6, alpha_tol=1e-10):
    """ELBM collision f' = f + alpha beta (feq - f), beta = 1 / (2 tau)
    (alpha = 2 is BGK), with the product-form equilibrium at (rho, u).
    Returns (f', alpha)."""
    feq = elbm_equilibrium(grid, rho, u)
    fneq = feq - f
    alpha = entropic_alpha(grid, f, fneq, alpha0, skip=skip,
                           entropy_tol=entropy_tol, alpha_tol=alpha_tol)
    beta = 1.0 / (2.0 * tau)
    return f + (alpha * beta)[None] * fneq, alpha
