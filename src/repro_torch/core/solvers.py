"""Closed-form block-size solvers (Theorems 2 and 3 of the paper).

Copied from ``repro/core/solvers.py``, trimmed to ``solve_xt``/``solve_xf``
and their water-filling; SPSG and the brute-force solver are ROADMAP
work.  ``dist`` is anything with the order-statistic protocol: a
``StragglerDistribution`` or an ``Env``.
"""
from __future__ import annotations

import numpy as np

__all__ = ["solve_xt", "solve_xf", "closed_form_x", "closed_form_x_capped"]


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
