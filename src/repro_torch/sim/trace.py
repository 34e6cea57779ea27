"""Cycle-time traces, copied from ``repro/sim/trace.py``: an immutable
(rounds, N) record of per-worker cycle times that bootstraps an
``EmpiricalStraggler`` population (the adaptive re-planner's estimate of
the live cluster).

Format (JSON-able, version-tagged)::

    {"version": 1,
     "times": [[t_00, ..., t_0{N-1}], ...],   # (rounds, N) cycle times
     "meta":  {...}}                           # free-form provenance
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.distributions import EmpiricalStraggler

__all__ = ["Trace"]

_VERSION = 1


@dataclass(frozen=True)
class Trace:
    """An immutable (rounds, N) record of per-worker cycle times."""

    times: np.ndarray
    meta: dict = field(default_factory=dict)

    @classmethod
    def from_times(cls, times, meta: Optional[dict] = None) -> "Trace":
        t = np.asarray(times, np.float64)
        if t.ndim != 2:
            raise ValueError(f"trace times must be (rounds, N), got {t.shape}")
        if not np.isfinite(t).all() or (t <= 0).any():
            raise ValueError("trace times must be finite and positive")
        return cls(times=t, meta=dict(meta or {}))

    @property
    def rounds(self) -> int:
        return int(self.times.shape[0])

    @property
    def n_workers(self) -> int:
        return int(self.times.shape[1])

    def to_empirical(self, per_worker: bool = False):
        """Bootstrap distribution(s) over the recorded cycle times: one
        ``EmpiricalStraggler`` over the pooled trace, or (``per_worker``)
        a length-N list, worker j resampling only its own column."""
        if per_worker:
            return [EmpiricalStraggler(trace=tuple(map(float, col)))
                    for col in self.times.T]
        return EmpiricalStraggler(trace=tuple(map(float, self.times.ravel())))

    def to_env(self, per_worker: bool = True):
        """The recorded cluster as an ``Env``:
        ``Env.from_trace(self, per_worker)``."""
        from ..core.env import Env

        return Env.from_trace(self, per_worker=per_worker)

    def to_dict(self) -> dict:
        return {"version": _VERSION, "times": self.times.tolist(),
                "meta": dict(self.meta)}

    @classmethod
    def from_dict(cls, blob: dict) -> "Trace":
        if blob.get("version") != _VERSION:
            raise ValueError(f"unknown trace version {blob.get('version')!r}")
        return cls.from_times(blob["times"], meta=blob.get("meta", {}))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls.from_dict(json.load(f))
