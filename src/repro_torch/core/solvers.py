"""Closed-form block-size solvers (Theorems 2 and 3 of the paper).

Copied from ``repro/core/solvers.py``, trimmed to ``solve_xt``/``solve_xf``
and their water-filling, and the stochastic projected subgradient method
(``spsg``, the paper's model only) with its simplex projection; the
realized-cost model and the brute-force solver are ROADMAP work.
``dist`` is anything with the order-statistic and sampling protocol: a
``StragglerDistribution`` or an ``Env``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .runtime import CostModel, DEFAULT_COST, subgradient_tau_hat, tau_hat_batch

__all__ = ["solve_xt", "solve_xf", "closed_form_x", "closed_form_x_capped",
           "project_block_simplex", "spsg", "SPSGResult"]


def closed_form_x(t_det: np.ndarray, total: float) -> np.ndarray:
    """Theorems 2/3 water-filling at a deterministic time vector t.

    t_det[k-1] = t_k (k-th smallest), nondecreasing.  Returns x >= 0 with
    sum(x) = total that equalizes all N max-terms of eq. (5):
        x_0 = m / t_N,
        x_n = (1/(n+1)) (1/t_{N-n} - 1/t_{N+1-n}) m,   n = 1..N-1,
        m   = L / ( sum_{n=1}^{N-1} 1/(n(n+1) t_{N+1-n}) + 1/(N t_1) ).
    """
    t = np.asarray(t_det, dtype=np.float64)
    n_workers = t.shape[0]
    if n_workers == 1:
        return np.array([float(total)])
    if not (t > 0).all():
        raise ValueError("deterministic times must be positive")
    n = np.arange(1, n_workers)  # 1..N-1
    denom = (1.0 / (n * (n + 1) * t[n_workers - n])).sum() + 1.0 / (n_workers * t[0])
    m = total / denom
    x = np.empty(n_workers, dtype=np.float64)
    x[0] = m / t[-1]
    # t_{N-n} -> t[N-n-1], t_{N+1-n} -> t[N-n]
    x[1:] = m / (n + 1.0) * (1.0 / t[n_workers - n - 1] - 1.0 / t[n_workers - n])
    # Order statistics are nondecreasing, so x >= 0 up to float noise.
    return np.maximum(x, 0.0)


def closed_form_x_capped(t_det: np.ndarray, total: float, s_cap: int) -> np.ndarray:
    """Water-filling restricted to levels 0..s_cap (x_i = 0 above).

    Equalizes t_{N-n} * S_n for n = 0..s_cap:
        x_0 = m/t_N,  x_n = m/(n+1) (1/t_{N-n} - 1/t_{N+1-n}),
    with the same m-normalization over the truncated term set.
    """
    t = np.asarray(t_det, dtype=np.float64)
    n_workers = t.shape[0]
    cap = int(min(max(s_cap, 0), n_workers - 1))
    if cap == n_workers - 1:
        return closed_form_x(t, total)
    n = np.arange(1, cap + 1)
    denom = (1.0 / (n * (n + 1) * t[n_workers - n])).sum() \
        + 1.0 / ((cap + 1) * t[n_workers - cap - 1])
    m = total / denom
    x = np.zeros(n_workers, dtype=np.float64)
    x[0] = m / t[-1]
    if cap >= 1:
        x[1:cap + 1] = m / (n + 1.0) * (1.0 / t[n_workers - n - 1]
                                        - 1.0 / t[n_workers - n])
    # x_cap collects the residual mass so that sum == total
    x[cap] += total - x.sum()
    return np.maximum(x, 0.0)


def solve_xt(dist, n_workers: int, total: float, rng=0, s_cap=None) -> np.ndarray:
    """Theorem 2: closed form at t = E[T_(n)] (optionally level-capped)."""
    t = dist.expected_order_stats(n_workers, rng)
    if s_cap is not None:
        return closed_form_x_capped(t, total, s_cap)
    return closed_form_x(t, total)


def solve_xf(dist, n_workers: int, total: float, rng=0, s_cap=None) -> np.ndarray:
    """Theorem 3: closed form at t' = 1/E[1/T_(n)] (optionally capped)."""
    t = dist.inv_expected_inv_order_stats(n_workers, rng)
    if s_cap is not None:
        return closed_form_x_capped(t, total, s_cap)
    return closed_form_x(t, total)


def project_block_simplex(v: np.ndarray, total: float) -> np.ndarray:
    """Euclidean projection onto {x >= 0, sum x = total} (exact, O(N log N)).

    x = max(v - lam, 0) with lam the root of sum max(v - lam, 0) = total,
    found by the sorted-prefix method.
    """
    v = np.asarray(v, dtype=np.float64)
    u = np.sort(v)[::-1]
    css = np.cumsum(u)
    k = np.arange(1, v.shape[0] + 1)
    lam_cand = (css - total) / k
    valid = u - lam_cand > 0
    k_star = int(np.max(np.nonzero(valid)[0])) + 1
    lam = (css[k_star - 1] - total) / k_star
    return np.maximum(v - lam, 0.0)


@dataclass
class SPSGResult:
    x: np.ndarray  # averaged iterate (continuous optimum of Problem 3)
    x_last: np.ndarray
    history: list = field(default_factory=list)  # (iter, eval MC objective)


def spsg(
    dist,
    n_workers: int,
    total: float,
    n_iters: int = 2_000,
    batch: int = 64,
    step0: float | None = None,
    rng=0,
    x0: np.ndarray | None = None,
    cost: CostModel = DEFAULT_COST,
    eval_every: int = 0,
    eval_samples: int = 20_000,
    warm_start: np.ndarray | None = None,
) -> SPSGResult:
    """Stochastic projected subgradient method on Problem 3 (eq. (5)).

    Diminishing steps a_k = step0 / sqrt(k+1), mini-batched noisy
    subgradients, Polyak averaging of the tail half.  step0 defaults to
    a scale-aware value.  ``warm_start`` seeds the iteration from a
    previous solution (the adaptive re-planning path), projected onto
    {x >= 0, sum = total} first; it takes precedence over ``x0``.
    """
    rng_np = np.random.default_rng(rng)
    if warm_start is not None:
        x0 = warm_start
    x = (
        np.full(n_workers, total / n_workers, dtype=np.float64)
        if x0 is None
        else project_block_simplex(np.asarray(x0, dtype=np.float64), total)
    )
    if step0 is None:
        g0 = subgradient_tau_hat(x, dist.sample(rng_np, (batch, n_workers)), cost)
        step0 = 0.5 * total / (np.linalg.norm(g0) + 1e-12)

    avg = np.zeros_like(x)
    n_avg = 0
    history: list = []
    eval_draws = (
        dist.sample(np.random.default_rng(12345), (eval_samples, n_workers))
        if eval_every
        else None
    )
    for k in range(n_iters):
        draws = dist.sample(rng_np, (batch, n_workers))
        g = subgradient_tau_hat(x, draws, cost)
        x = project_block_simplex(x - step0 / np.sqrt(k + 1.0) * g, total)
        if k >= n_iters // 2:
            avg += x
            n_avg += 1
        if eval_every and (k + 1) % eval_every == 0:
            point = avg / max(n_avg, 1) if n_avg else x
            history.append((k + 1, float(tau_hat_batch(point, eval_draws, cost).mean())))
    x_avg = avg / max(n_avg, 1) if n_avg else x
    return SPSGResult(x=x_avg, x_last=x, history=history)
