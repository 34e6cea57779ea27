"""Runtime cost model of the paper (eqs. 2 and 5) and its Monte-Carlo
estimators.

Copied from ``repro/core/runtime.py``: the ``CostModel``, the eq. (2) and
eq. (5) runtimes, their batched form (the adaptive re-planner's pricing),
the noisy subgradient SPSG descends, the per-coordinate completion
timeline (``completion_trace``), and the realized-cost model of a neural
gradient (one full backward pass per redundancy slot) that the
``single-real`` scheme minimizes.

Conventions: numpy arrays, 0-based.  ``T_(k)`` (k-th smallest of N) is
``np.sort(T)[k-1]``.  The scale factor (M/N)*b multiplies every runtime.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["CostModel", "DEFAULT_COST", "tau", "tau_hat", "tau_hat_batch",
           "expected_tau_hat", "subgradient_tau_hat", "completion_trace",
           "tau_hat_realized_batch", "expected_tau_hat_realized",
           "subgradient_tau_hat_realized"]


@dataclass(frozen=True)
class CostModel:
    """Scale constants of eq. (2): M samples, b cycles/partial-derivative."""

    m_samples: int = 50
    b_cycles: float = 1.0

    def scale(self, n_workers: int) -> float:
        return self.m_samples / n_workers * self.b_cycles


DEFAULT_COST = CostModel()


def tau(s: np.ndarray, times: np.ndarray, cost: CostModel = DEFAULT_COST) -> float:
    """Eq. (2): overall runtime of coordinate gradient coding with params s.

    s : (L,) ints in {0..N-1};  times : (N,) realized cycle times.
    """
    s = np.asarray(s, dtype=np.int64)
    times = np.asarray(times, dtype=np.float64)
    n_workers = times.shape[0]
    t_sorted = np.sort(times)
    # T_(N - s_l): 1-based order stat N - s_l -> 0-based index N - s_l - 1.
    t_term = t_sorted[n_workers - s - 1]
    work = np.cumsum(s + 1.0)  # sum_{i<=l} (s_i + 1)
    return float(cost.scale(n_workers) * np.max(t_term * work))


def tau_hat(x: np.ndarray, times: np.ndarray, cost: CostModel = DEFAULT_COST) -> float:
    """Eq. (5): block form.  x : (N,) nonneg block sizes (floats allowed)."""
    return float(tau_hat_batch(x, np.asarray(times, dtype=np.float64)[None, :], cost)[0])


def _terms(x: np.ndarray, times_sorted: np.ndarray, cost: CostModel) -> np.ndarray:
    """(S, N) matrix of the N max-terms of eq. (5) for S sorted samples."""
    n_workers = times_sorted.shape[1]
    x = np.asarray(x, dtype=np.float64)
    n = np.arange(n_workers)
    work = np.cumsum((n + 1.0) * x)  # sum_{i<=n} (i+1) x_i
    # T_(N-n) -> sorted index N - n - 1 for n = 0..N-1.
    t_term = times_sorted[:, ::-1]  # column n is T_(N-n)
    return cost.scale(n_workers) * t_term * work[None, :]


def tau_hat_batch(
    x: np.ndarray, times_batch: np.ndarray, cost: CostModel = DEFAULT_COST
) -> np.ndarray:
    """Vectorized eq. (5) over a batch of realizations (S, N) -> (S,)."""
    times_sorted = np.sort(np.asarray(times_batch, dtype=np.float64), axis=1)
    return _terms(x, times_sorted, cost).max(axis=1)


def expected_tau_hat(
    x: np.ndarray,
    dist,
    n_workers: int,
    n_samples: int = 100_000,
    rng=0,
    cost: CostModel = DEFAULT_COST,
) -> float:
    """Monte-Carlo E_T[tau_hat(x, T)]."""
    draws = dist.sample(np.random.default_rng(rng), (n_samples, n_workers))
    return float(tau_hat_batch(x, draws, cost).mean())


def subgradient_tau_hat(
    x: np.ndarray, times_batch: np.ndarray, cost: CostModel = DEFAULT_COST
) -> np.ndarray:
    """Unbiased noisy subgradient of E[tau_hat] at x, averaged over a batch.

    For one sample T with active index n* = argmax_n T_(N-n) sum_{i<=n}(i+1)x_i,
    d tau_hat / d x_i = (M/N) b T_(N-n*) (i+1)  for i <= n*, else 0.
    """
    times_sorted = np.sort(np.asarray(times_batch, dtype=np.float64), axis=1)
    terms = _terms(x, times_sorted, cost)  # (S, N)
    n_workers = times_sorted.shape[1]
    n_star = terms.argmax(axis=1)  # (S,)
    t_active = times_sorted[:, ::-1][np.arange(len(n_star)), n_star]  # T_(N-n*)
    i = np.arange(n_workers)
    mask = i[None, :] <= n_star[:, None]  # (S, N)
    g = cost.scale(n_workers) * t_active[:, None] * (i + 1.0)[None, :] * mask
    return g.mean(axis=0)


# ---------------------------------------------------------------------------
# REALIZED cost model of a neural gradient (beyond the paper).
#
# A neural gradient does not decompose per coordinate: each redundancy
# slot k is one FULL backward pass over shard k (cost L work units),
# and a leaf's gradient is emitted partway through that pass.  With the
# blocks laid out in backward-emission order (Lemma-1 monotone levels
# along the emission axis), block level n becomes decodable at
#     T_(N-n) * ( n*L  +  sum_{i<=n} x_i )
# — n full slots plus the cumulative emission inside slot n.  This
# replaces eq. (5)'s per-coordinate work sum_{i<=n}(i+1)x_i.
# ---------------------------------------------------------------------------
def _terms_realized(x: np.ndarray, times_sorted: np.ndarray, cost: CostModel):
    n_workers = times_sorted.shape[1]
    x = np.asarray(x, dtype=np.float64)
    total = x.sum()
    work = np.arange(n_workers) * total + np.cumsum(x)
    t_term = times_sorted[:, ::-1]
    return cost.scale(n_workers) * t_term * work[None, :]


def tau_hat_realized_batch(x, times_batch, cost: CostModel = DEFAULT_COST,
                           active_only: bool = True) -> np.ndarray:
    """Vectorized realized runtime over (S, N) samples -> (S,).

    active_only: levels with x_i == 0 cost nothing and impose no term
    (their slot still runs but nothing waits on it beyond later levels,
    which already include it in n*L)."""
    x = np.asarray(x, dtype=np.float64)
    times_sorted = np.sort(np.asarray(times_batch, dtype=np.float64), axis=1)
    terms = _terms_realized(x, times_sorted, cost)
    if active_only:
        mask = x > 0
        if not mask.any():
            return np.zeros(times_sorted.shape[0])
        terms = terms[:, mask]
    return terms.max(axis=1)


def expected_tau_hat_realized(x, dist, n_workers: int, n_samples: int = 100_000,
                              rng=0, cost: CostModel = DEFAULT_COST) -> float:
    draws = dist.sample(np.random.default_rng(rng), (n_samples, n_workers))
    return float(tau_hat_realized_batch(x, draws, cost).mean())


def subgradient_tau_hat_realized(x, times_batch,
                                 cost: CostModel = DEFAULT_COST) -> np.ndarray:
    """Noisy subgradient of E[tau_realized] (terms are linear in x:
    d term_n / d x_i = T_(N-n) * (n + [i <= n]))."""
    x = np.asarray(x, dtype=np.float64)
    times_sorted = np.sort(np.asarray(times_batch, dtype=np.float64), axis=1)
    terms = _terms_realized(x, times_sorted, cost)
    n_workers = times_sorted.shape[1]
    n_star = terms.argmax(axis=1)
    t_active = times_sorted[:, ::-1][np.arange(len(n_star)), n_star]
    i = np.arange(n_workers)
    g = (n_star[:, None] + (i[None, :] <= n_star[:, None])).astype(np.float64)
    g = cost.scale(n_workers) * t_active[:, None] * g
    return g.mean(axis=0)


def completion_trace(s: np.ndarray, times: np.ndarray, cost: CostModel = DEFAULT_COST):
    """Per-(worker, coordinate) completion + per-coordinate recovery times.

    Returns (worker_done, master_done):
      worker_done[n, l] = (M/N) b T_n  sum_{i<=l}(s_i+1)   — §III
      master_done[l]    = (M/N) b T_(N-s_l) sum_{i<=l}(s_i+1)
    Used by examples/quickstart.py to draw Fig. 1-style timelines.
    """
    s = np.asarray(s, dtype=np.int64)
    times = np.asarray(times, dtype=np.float64)
    n_workers = times.shape[0]
    work = np.cumsum(s + 1.0)
    worker_done = cost.scale(n_workers) * times[:, None] * work[None, :]
    t_sorted = np.sort(times)
    master_done = cost.scale(n_workers) * t_sorted[n_workers - s - 1] * work
    return worker_done, master_done
