"""``DeathWatch``, copied from ``repro/adapt/monitor.py`` (numpy only)."""
from __future__ import annotations

import numpy as np

__all__ = ["DeathWatch"]


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
