"""Fault realization for the event engine, copied from
``repro/sim/faults.py`` (``apply_faults`` only): maps the declarative
faults of an ``Env`` onto a drawn (rounds, N) cycle-time matrix, so a
faulted run stays a pure function of (schedule, times, faults)."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.env import DegradedWorker, WorkerDeath

__all__ = ["apply_faults"]


def apply_faults(times: np.ndarray, faults: Sequence):
    """(times, faults) -> (times', deaths).

    ``times'`` is a copy with degradations applied; ``deaths`` maps
    worker index -> (death_time, death_round) for the event engine
    (np.inf where the axis is unused).
    """
    times = np.array(times, np.float64, copy=True)
    rounds, n = times.shape
    deaths: dict = {}
    for f in faults:
        if isinstance(f, DegradedWorker):
            if not (0 <= f.worker < n):
                raise ValueError(f"DegradedWorker.worker {f.worker} out of range")
            times[f.from_round:, f.worker] *= f.factor
        elif isinstance(f, WorkerDeath):
            if not (0 <= f.worker < n):
                raise ValueError(f"WorkerDeath.worker {f.worker} out of range")
            at_t = np.inf if f.at_time is None else float(f.at_time)
            at_r = np.inf if f.at_round is None else int(f.at_round)
            prev = deaths.get(f.worker, (np.inf, np.inf))
            deaths[f.worker] = (min(prev[0], at_t), min(prev[1], at_r))
        else:
            raise TypeError(f"unknown fault {f!r}")
    return times, deaths
