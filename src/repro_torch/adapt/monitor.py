"""Online straggler estimation from the running cluster, copied from
``repro/adapt/monitor.py`` (numpy and scipy only).

``RuntimeMonitor`` ingests one (N,) row of per-worker completion times
per training round (``rec["times"]`` of the plan's simulator) into a
sliding window, and exposes on top of it:

* ``estimated_env()`` — the current regime as an ``Env``: the newest
  half of the window becomes a per-worker ``EmpiricalStraggler``
  population through ``Trace``/``Env.from_trace``;
* ``drift()`` — a two-sample test per worker between the older and newer
  halves of the window: the Kolmogorov-Smirnov statistic on each
  worker's marginal, OR a relative mean shift that is also z-significant;
  both Bonferroni-corrected across the N workers;
* ``shift_from(means)`` — the newest half against the per-worker means a
  reference model predicts (drift slower than the window).

``DeathWatch`` is the fast tripwire of the worker-death recovery path.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass

import numpy as np
from scipy.special import ndtri

from ..core.env import Env
from ..sim.trace import Trace

__all__ = ["DeathWatch", "DriftReport", "RuntimeMonitor", "ks_2sample",
           "ks_threshold"]


def ks_2sample(a: np.ndarray, b: np.ndarray) -> float:
    """Two-sample Kolmogorov-Smirnov statistic sup_t |F_a(t) - F_b(t)|
    (statistic only — the threshold below is the asymptotic band)."""
    a = np.sort(np.asarray(a, np.float64))
    b = np.sort(np.asarray(b, np.float64))
    grid = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, grid, side="right") / a.size
    cdf_b = np.searchsorted(b, grid, side="right") / b.size
    return float(np.abs(cdf_a - cdf_b).max())


def ks_threshold(n: int, m: int, alpha: float) -> float:
    """Asymptotic two-sample KS rejection threshold at level ``alpha``:
    c(alpha) * sqrt((n+m)/(n m)), c(alpha) = sqrt(-ln(alpha/2)/2)."""
    c = math.sqrt(-math.log(alpha / 2.0) / 2.0)
    return c * math.sqrt((n + m) / (n * m))


@dataclass(frozen=True)
class DriftReport:
    """One drift check: per-worker statistics + the fire decision."""

    fired: bool
    ks: np.ndarray            # (N,) per-worker two-sample KS statistics
    ks_threshold: float       # Bonferroni-corrected rejection band
    mean_shift: np.ndarray    # (N,) |mean_new/mean_old - 1|
    mean_threshold: float     # relative shift that fires
    worker: int               # argmax offender (reporting only)

    def __bool__(self) -> bool:  # `if monitor.drift():` reads naturally
        return self.fired


class RuntimeMonitor:
    """Sliding-window online ``Env`` estimate + drift detection.

    ``window`` rows are kept (one per training round); the newest half
    estimates the current regime, the older half is the drift
    reference.  ``min_rounds`` gates both — estimates from a near-empty
    window are noise.
    """

    def __init__(self, n_workers: int, *, window: int = 128,
                 min_rounds: int = 48, alpha: float = 0.002,
                 mean_shift: float = 0.5, mc_samples: int = 50_000):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        if window < 4:
            raise ValueError("window must be >= 4 (two non-trivial halves)")
        self.n_workers = int(n_workers)
        self.window = int(window)
        # a min_rounds above the window could never be reached (the
        # deque caps at `window` rows) — clamp so readiness is always
        # attainable, with at least 2 rows per half.
        self.min_rounds = max(min(int(min_rounds), self.window), 4)
        self.alpha = float(alpha)
        self.mean_shift = float(mean_shift)
        #: MC budget of the estimated Env's order statistics — the online
        #: loop favors re-plan latency over the offline default (200k).
        self.mc_samples = int(mc_samples)
        self.rounds_seen = 0
        self._rows: deque = deque(maxlen=self.window)

    # ------------------------------------------------------------ ingestion
    def observe(self, times) -> None:
        """Ingest one round's (N,) per-worker completion times."""
        t = np.asarray(times, np.float64).reshape(-1)
        if t.shape[0] != self.n_workers:
            raise ValueError(f"expected {self.n_workers} per-worker times, "
                             f"got shape {np.shape(times)}")
        if not np.isfinite(t).all() or (t <= 0).any():
            raise ValueError("completion times must be finite and positive")
        self._rows.append(t)
        self.rounds_seen += 1

    def reset(self) -> None:
        """Drop the window (a plan swap happened: the mix of pre/post
        rows would poison both the estimate and the next drift check)."""
        self._rows.clear()

    # ------------------------------------------------------------- windows
    def __len__(self) -> int:
        return len(self._rows)

    @property
    def ready(self) -> bool:
        """Enough rows for a meaningful estimate/drift check."""
        return len(self._rows) >= self.min_rounds

    def window_times(self) -> np.ndarray:
        """(rounds_in_window, N) copy of the current window."""
        if not self._rows:
            return np.empty((0, self.n_workers))
        return np.stack(self._rows)

    def _halves(self) -> tuple[np.ndarray, np.ndarray]:
        t = self.window_times()
        mid = t.shape[0] // 2
        return t[:mid], t[mid:]

    # ----------------------------------------------------------- estimation
    def trace(self, recent_only: bool = True):
        """The window as a ``Trace`` (newest half by default — the
        current regime; the older half may straddle a change)."""
        t = self._halves()[1] if recent_only else self.window_times()
        if t.shape[0] == 0:
            raise ValueError("monitor has no observations yet")
        return Trace.from_times(t, meta={"source": "RuntimeMonitor",
                                         "rounds_seen": self.rounds_seen})

    def estimated_env(self, recent_only: bool = True):
        """The live cluster as an ``Env``: per-worker
        ``EmpiricalStraggler`` bootstrap over the window (the
        ``Env.from_trace`` path), MC order-statistic budget
        ``self.mc_samples``."""
        return Env.from_trace(self.trace(recent_only), per_worker=True,
                              mc_samples=self.mc_samples)

    # --------------------------------------------------------------- drift
    def drift(self, alpha: float = None, mean_shift: float = None) -> DriftReport:
        """Windowed per-worker two-sample check, older half vs newer
        half: KS statistic against the Bonferroni-corrected asymptotic
        band, OR relative mean shift beyond ``mean_shift``.  Returns a
        falsy all-zeros report until ``ready``."""
        alpha = self.alpha if alpha is None else float(alpha)
        shift_thr = self.mean_shift if mean_shift is None else float(mean_shift)
        n = self.n_workers
        if not self.ready:
            return DriftReport(False, np.zeros(n), np.inf, np.zeros(n),
                               shift_thr, -1)
        old, new = self._halves()
        ks = np.array([ks_2sample(old[:, j], new[:, j]) for j in range(n)])
        thr = ks_threshold(old.shape[0], new.shape[0], alpha / n)
        m_old, m_new = old.mean(axis=0), new.mean(axis=0)
        shift = np.abs(m_new / m_old - 1.0)
        # the mean-shift arm must be BOTH large (> shift_thr, a real
        # operating-point move) and statistically significant (z-test on
        # the mean difference at the same Bonferroni level) — heavy-tail
        # sampling noise alone must not churn the plan.
        se = np.sqrt(old.var(axis=0, ddof=1) / old.shape[0]
                     + new.var(axis=0, ddof=1) / new.shape[0])
        z = ndtri(1.0 - (alpha / n) / 2.0)
        mean_fired = (shift > shift_thr) & (np.abs(m_new - m_old) > z * se)
        fired = bool((ks > thr).any() or mean_fired.any())
        worker = int(np.argmax(np.maximum(ks / thr, shift / shift_thr)))
        return DriftReport(fired, ks, thr, shift, shift_thr, worker)

    def shift_from(self, base_means, alpha: float = None,
                   mean_shift: float = None) -> DriftReport:
        """Cumulative drift: the newest half of the window against the
        per-worker means a *reference model* predicts (the env the
        current plan was solved for).  The split-window test above is
        blind to drift slower than the window — a worker that ramps 1x
        -> 3x over thousands of rounds never moves much between two
        adjacent half-windows, yet ends far from the planning-time
        model.  Same shape of decision: relative shift beyond
        ``mean_shift`` AND z-significant at the Bonferroni-corrected
        level (the reference means are treated as exact)."""
        alpha = self.alpha if alpha is None else float(alpha)
        shift_thr = self.mean_shift if mean_shift is None else float(mean_shift)
        n = self.n_workers
        base = np.asarray(base_means, np.float64).reshape(-1)
        if base.shape[0] != n:
            raise ValueError(f"expected {n} reference means, got {base.shape}")
        if not self.ready:
            return DriftReport(False, np.zeros(n), np.inf, np.zeros(n),
                               shift_thr, -1)
        new = self._halves()[1]
        m = new.mean(axis=0)
        shift = np.abs(m / base - 1.0)
        se = np.sqrt(new.var(axis=0, ddof=1) / new.shape[0])
        z = ndtri(1.0 - (alpha / n) / 2.0)
        fired_mask = (shift > shift_thr) & (np.abs(m - base) > z * se)
        worker = int(np.argmax(shift / shift_thr))
        return DriftReport(bool(fired_mask.any()), np.zeros(n), np.inf,
                           shift, shift_thr, worker)


class DeathWatch:
    """Declare a worker dead after sustained extreme slowdown.

    Worker ``j`` is declared dead once its completion time exceeds
    ``factor`` x the median of the other live workers for ``rounds``
    consecutive rounds: a single straggler draw is harmless, a true death
    realized as persistent degradation trips in ``rounds`` rounds flat.
    The dead set is monotone — the recovery (coded restore) is taken
    exactly once per death.
    """

    def __init__(self, n_workers: int, *, factor: float = 20.0,
                 rounds: int = 4):
        if n_workers < 2:
            raise ValueError("DeathWatch needs >= 2 workers (the median "
                             "of 'the others' must exist)")
        if factor <= 1.0 or rounds < 1:
            raise ValueError("need factor > 1 and rounds >= 1")
        self.n_workers = int(n_workers)
        self.factor = float(factor)
        self.rounds = int(rounds)
        self.dead: set[int] = set()
        self._streak = np.zeros(self.n_workers, np.int64)

    def observe(self, times) -> list[int]:
        """Ingest one (N,) row; returns workers newly declared dead this
        round (sorted; usually empty)."""
        t = np.asarray(times, np.float64).reshape(-1)
        if t.shape[0] != self.n_workers:
            raise ValueError(f"expected {self.n_workers} per-worker times, "
                             f"got shape {np.shape(times)}")
        newly = []
        for j in range(self.n_workers):
            if j in self.dead:
                continue
            others = np.delete(t, j)
            # median over live peers only: two simultaneous deaths must
            # not drag the reference up and mask each other
            live = np.delete(np.arange(self.n_workers), j)
            alive = [k for k in live if k not in self.dead]
            ref = float(np.median(t[alive])) if alive else float(np.median(others))
            if ref > 0 and t[j] > self.factor * ref:
                self._streak[j] += 1
            else:
                self._streak[j] = 0
            if self._streak[j] >= self.rounds:
                self.dead.add(j)
                newly.append(j)
        return newly
