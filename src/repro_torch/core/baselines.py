"""Baseline schemes of the paper's §VI (all expressed as block solutions x),
copied from ``repro/core/baselines.py``.

  * single-BCGC          — Problem 2 with ||x||_0 = 1: one redundancy
                           level for the whole gradient; the optimized
                           version of Tandon et al.'s full-straggler code.
  * Tandon alpha-partial — the gradient coding of [1] with the level
                           picked by their alpha-partial-straggler rule,
                           alpha = E[T | T > median] / E[T | T <= median].
  * Ferdinand r=L, r=L/2 — hierarchical coded computation [8]: r equal
                           compute layers, per-layer (N, k_i) MDS codes
                           with k_i optimized under the deterministic-t
                           approximation of its own 1/k cost model, then
                           *evaluated* under the gradient-coding cost
                           (s+1)/N — the mismatch the paper's Fig. 4
                           attributes to "matrix-vector codes are no
                           longer effective for a general gradient".
"""
from __future__ import annotations

import math

import numpy as np

from .runtime import CostModel, DEFAULT_COST, expected_tau_hat
from .solvers import project_block_simplex

__all__ = [
    "single_bcgc",
    "tandon_alpha_level",
    "tandon_alpha_x",
    "ferdinand_x",
    "scheme_bank",
]


def scheme_bank(dist, n_workers: int, total: int, rng=0,
                cost: CostModel = DEFAULT_COST) -> dict:
    """The registry-backed bank of ``repro_torch.core.schemes`` (canonical
    keys, display metadata), under the reference's second name."""
    from .schemes import scheme_bank as _bank  # deferred: avoid import cycle

    return _bank(dist, n_workers, total, rng=rng, cost=cost)


def single_bcgc(
    dist, n_workers: int, total: int, n_samples: int = 50_000, rng=0, cost: CostModel = DEFAULT_COST
) -> np.ndarray:
    """argmin over s of E[tau_hat(L*e_s, T)] = (M/N) b (s+1) L E[T_(N-s)]."""
    draws = np.sort(dist.sample(np.random.default_rng(rng), (n_samples, n_workers)), axis=1)
    t_mean = draws.mean(axis=0)  # E[T_(k)], k = 1..N at index k-1
    s_grid = np.arange(n_workers)
    vals = (s_grid + 1.0) * t_mean[n_workers - s_grid - 1]
    s_star = int(np.argmin(vals))
    x = np.zeros(n_workers, dtype=np.int64)
    x[s_star] = total
    return x


def tandon_alpha_level(dist, n_workers: int, n_samples: int = 200_000, rng=0) -> int:
    """Level from Tandon et al.'s alpha-partial straggler rule.

    alpha is the slow/fast conditional-mean ratio split at the median
    (the paper's §VI instantiation gives alpha = 6 for its setup); a
    partial straggler does 1/alpha of the work of a healthy worker, so
    treating it as erasured costs (s+1)/N while waiting costs alpha/N:
    coding pays up to s* = ceil(alpha) - 1.
    """
    # marginal (worker-axis-free) draws: for an Env this is the pooled
    # mixture "a uniformly random worker", for a distribution itself.
    marginal = dist.pooled() if hasattr(dist, "pooled") else dist
    draws = marginal.sample(np.random.default_rng(rng), (n_samples,))
    med = np.median(draws)
    slow = draws[draws > med].mean()
    fast = draws[draws <= med].mean()
    alpha = float(slow / fast)
    return int(min(max(math.ceil(alpha) - 1, 0), n_workers - 1))


def tandon_alpha_x(dist, n_workers: int, total: int, n_samples: int = 200_000, rng=0) -> np.ndarray:
    x = np.zeros(n_workers, dtype=np.int64)
    x[tandon_alpha_level(dist, n_workers, n_samples, rng)] = total
    return x


def ferdinand_x(
    dist,
    n_workers: int,
    total: int,
    n_layers: int,
    rng=0,
) -> np.ndarray:
    """Hierarchical coded computation [8] mapped onto block sizes.

    Under [8]'s MDS model a layer with parameter k costs each worker 1/k
    of the layer's work and completes at T_(k).  Water-filling the
    deterministic-t approximation (same argument as Theorem 2, with
    per-unit work 1/k in place of s+1) gives the layer-count allocation
    y_v over k-values v = 1..N:

        equalize  t_v * S_v,  S_v = sum_{v' <= v} y_{v'} * (1/v') * (L/r)
        (layers are processed from the most-redundant k=1?  No: [8]
        processes the *least* redundant first; with k = N - s the level
        order matches our block order.)

    We then quantize y to r = n_layers equal-size layers and express the
    result as a gradient-coding block vector x (units of coordinates) so
    it can be evaluated under eq. (5)'s (s+1)-replication cost — the
    apples-to-apples comparison the paper plots.
    """
    t = dist.expected_order_stats(n_workers, rng)  # t[k-1] = E[T_(k)]
    # Allocation over redundancy levels s = 0..N-1 (k = N - s), equalizing
    # t_{N-s} * cumulative-work with per-unit work 1/k = 1/(N-s):
    #   S_s = sum_{i<=s} y_i / (N - i); equal terms m: t_{N-s} S_s = m.
    #   y_0 = (N) * m / t_N; y_s = (N-s) m (1/t_{N-s} - 1/t_{N+1-s}).
    n = np.arange(1, n_workers)
    y = np.empty(n_workers, dtype=np.float64)
    y[0] = n_workers / t[-1]
    y[1:] = (n_workers - n) * (1.0 / t[n_workers - n - 1] - 1.0 / t[n_workers - n])
    y = np.maximum(y, 0.0)
    y *= total / y.sum()
    # Quantize to r equal layers of L/r coordinates each: each layer takes
    # a single level; levels chosen by cumulative mass (largest remainder).
    r = int(n_layers)
    layer_size = total / r
    cum = np.cumsum(y)
    x = np.zeros(n_workers, dtype=np.float64)
    for j in range(r):
        mid = (j + 0.5) * layer_size
        lvl = int(np.searchsorted(cum, mid, side="left"))
        x[min(lvl, n_workers - 1)] += layer_size
    return x


