"""The worker-population model ``Env``.

Copied from ``repro/core/env.py`` and trimmed to what the training slice
calls: ``Env.iid``, ``with_faults``, ``coerce``, ``sample``,
``degradation_factors``, ``has_deaths``, the i.i.d. order statistics the
closed-form schemes read, and the exact ``to_dict``/``from_dict`` (an env
embeds bit-identically inside ``Plan.to_dict``).  The declarative faults
round-trip and fold into the simulator's draws as in the reference;
solving against a faulted or heterogeneous population (Monte-Carlo /
quadrature order statistics) is ROADMAP work and raises.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .distributions import (StragglerDistribution, _as_rng, dist_from_dict,
                            dist_to_dict)

__all__ = ["Env", "WorkerDeath", "DegradedWorker", "fault_to_dict",
           "fault_from_dict"]

_ENV_VERSION = 1


@dataclass(frozen=True)
class WorkerDeath:
    """Worker ``worker`` delivers nothing at/after ``at_time`` or from round
    ``at_round`` on."""

    worker: int
    at_time: Optional[float] = None
    at_round: Optional[int] = None

    def __post_init__(self):
        if self.at_time is None and self.at_round is None:
            raise ValueError("WorkerDeath needs at_time or at_round")


@dataclass(frozen=True)
class DegradedWorker:
    """Worker ``worker`` runs ``factor``x slower from round ``from_round``."""

    worker: int
    factor: float
    from_round: int = 0

    def __post_init__(self):
        if self.factor <= 0:
            raise ValueError("factor must be positive")


_FAULT_TYPES = {"WorkerDeath": WorkerDeath, "DegradedWorker": DegradedWorker}


def fault_to_dict(f) -> dict:
    """JSON-able snapshot {type, **fields} of a declarative fault."""
    name = type(f).__name__
    if _FAULT_TYPES.get(name) is not type(f):
        raise TypeError(f"unknown fault type {name!r}")
    return {"type": name, **dataclasses.asdict(f)}


def fault_from_dict(blob: dict):
    cls = _FAULT_TYPES.get(blob.get("type"))
    if cls is None:
        raise KeyError(f"unknown fault type {blob.get('type')!r}; "
                       f"known: {sorted(_FAULT_TYPES)}")
    return cls(**{k: v for k, v in blob.items() if k != "type"})


@dataclass(frozen=True)
class Env:
    """A worker population: per-worker cycle-time distributions plus
    declarative faults."""

    dists: tuple                 # length-N per-worker distributions
    faults: tuple = ()           # WorkerDeath / DegradedWorker, declarative
    mc_samples: int = 200_000

    def __post_init__(self):
        dists = tuple(self.dists)
        object.__setattr__(self, "dists", dists)
        object.__setattr__(self, "faults", tuple(self.faults))
        if not dists:
            raise ValueError("Env needs at least one worker distribution")
        for d in dists:
            if not isinstance(d, StragglerDistribution):
                raise TypeError(f"Env worker model {d!r} is not a "
                                "StragglerDistribution")
        n = len(dists)
        for f in self.faults:
            if type(f).__name__ not in _FAULT_TYPES:
                raise TypeError(f"unknown fault {f!r}")
            if not (0 <= f.worker < n):
                raise ValueError(f"fault worker {f.worker} out of range [0,{n})")

    # ------------------------------------------------------------- building
    @classmethod
    def iid(cls, dist: StragglerDistribution, n_workers: int, **kw) -> "Env":
        """Homogeneous population: N i.i.d. workers (the paper's §II)."""
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        return cls(dists=(dist,) * int(n_workers), **kw)

    def with_faults(self, *faults) -> "Env":
        """A copy of this env with declarative faults appended."""
        return dataclasses.replace(self, faults=self.faults + tuple(faults))

    @classmethod
    def coerce(cls, obj, n_workers: Optional[int] = None) -> "Env":
        """An ``Env`` passes through (validated against ``n_workers``), a
        bare distribution becomes ``Env.iid(dist, n_workers)``, a sequence
        of distributions becomes a per-worker population."""
        if isinstance(obj, cls):
            if n_workers is not None and obj.n_workers != int(n_workers):
                raise ValueError(f"env has {obj.n_workers} workers, caller "
                                 f"expects {n_workers}")
            return obj
        if isinstance(obj, StragglerDistribution):
            if n_workers is None:
                raise ValueError("coercing a bare distribution needs n_workers")
            return cls.iid(obj, n_workers)
        if isinstance(obj, (list, tuple)):
            env = cls(dists=tuple(obj))
            if n_workers is not None and env.n_workers != int(n_workers):
                raise ValueError(f"{env.n_workers} per-worker dists, caller "
                                 f"expects {n_workers}")
            return env
        raise TypeError(f"cannot coerce {type(obj).__name__} to Env")

    # -------------------------------------------------------------- queries
    @property
    def n_workers(self) -> int:
        return len(self.dists)

    @property
    def is_iid(self) -> bool:
        return not self.faults and all(d == self.dists[0] for d in self.dists)

    def has_deaths(self) -> bool:
        return any(isinstance(f, WorkerDeath) for f in self.faults)

    def degradation_factors(self, round_idx: int = 0) -> np.ndarray:
        """(N,) slowdown per worker in effect at round ``round_idx``."""
        fac = np.ones(self.n_workers)
        for f in self.faults:
            if isinstance(f, DegradedWorker) and f.from_round <= round_idx:
                fac[f.worker] *= f.factor
        return fac

    def solver_view(self) -> "Env":
        """The population the schemes solve against; fault-free envs pass
        through unchanged.  Folding faults in is ROADMAP work."""
        if self.faults:
            raise NotImplementedError(
                "solving against a faulted Env is not ported yet (ROADMAP)")
        return self

    # ------------------------------------------------------------- sampling
    def sample(self, rng, shape) -> np.ndarray:
        """Draw base cycle times (no faults); the i.i.d. path delegates to
        the wrapped distribution (identical stream to the bare one)."""
        rng = _as_rng(rng)
        if all(d == self.dists[0] for d in self.dists):
            return self.dists[0].sample(rng, shape)
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        if not shape or shape[-1] != self.n_workers:
            raise ValueError(
                f"heterogeneous Env.sample needs a (..., {self.n_workers}) "
                f"shape (one column per worker); got {shape}")
        cols = [d.sample(rng, shape[:-1]) for d in self.dists]
        return np.stack(cols, axis=-1).astype(np.float64)

    # ------------------------------------------------------ order statistics
    def _iid_dist(self, n_workers) -> StragglerDistribution:
        if n_workers is not None and int(n_workers) != self.n_workers:
            raise ValueError(f"env has {self.n_workers} workers, caller "
                             f"expects {n_workers}")
        if not self.is_iid:
            raise NotImplementedError(
                "order statistics of a non-i.i.d. Env are not ported yet "
                "(ROADMAP)")
        return self.dists[0]

    def expected_order_stats(self, n_workers: Optional[int] = None,
                             rng=0) -> np.ndarray:
        """t with t[k-1] = E[T_(k)] (i.i.d. populations)."""
        return self._iid_dist(n_workers).expected_order_stats(self.n_workers, rng)

    def inv_expected_inv_order_stats(self, n_workers: Optional[int] = None,
                                     rng=0) -> np.ndarray:
        """t' with t'[k-1] = 1 / E[1/T_(k)] (i.i.d. populations)."""
        return self._iid_dist(n_workers).inv_expected_inv_order_stats(
            self.n_workers, rng)

    # ------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        """Exact JSON-able snapshot (the reference's schema)."""
        return {
            "version": _ENV_VERSION,
            "n_workers": self.n_workers,
            "mc_samples": int(self.mc_samples),
            "dists": [dist_to_dict(d) for d in self.dists],
            "faults": [fault_to_dict(f) for f in self.faults],
        }

    @classmethod
    def from_dict(cls, blob: dict) -> "Env":
        if blob.get("version") != _ENV_VERSION:
            raise ValueError(f"unknown Env version {blob.get('version')!r}")
        env = cls(
            dists=tuple(dist_from_dict(d) for d in blob["dists"]),
            faults=tuple(fault_from_dict(f) for f in blob.get("faults", ())),
            mc_samples=int(blob.get("mc_samples", 200_000)),
        )
        if env.n_workers != int(blob["n_workers"]):
            raise ValueError("Env blob n_workers/dists length mismatch")
        return env
