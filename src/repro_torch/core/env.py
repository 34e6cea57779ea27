"""The worker-population model ``Env``.

Copied from ``repro/core/env.py`` and trimmed to what the port's slices
call: ``Env.iid``, ``heterogeneous``, ``with_faults``, ``from_trace``,
``coerce``, ``sample``, ``degradation_factors``, ``has_deaths``, the
solver view (static degradations folded in, transient faults dropped),
the per-worker means, ``subset`` (the replica group of the coded serving
tier), the order statistics the schemes read (delegated to the wrapped
distribution for an i.i.d. env; otherwise Monte-Carlo over
``mc_samples`` joint draws, in the reference's draw order, or
Poisson-binomial quadrature over the per-worker CDFs with
``method="quad"``), ``order_stat_quantile`` (the serving tier's
tail-latency primitive), and the exact ``to_dict``/``from_dict`` (an env
embeds bit-identically inside ``Plan.to_dict``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from .distributions import (ScaledStraggler, StragglerDistribution, _as_rng,
                            dist_from_dict, dist_to_dict)

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

    @classmethod
    def heterogeneous(cls, dists: Sequence[StragglerDistribution],
                      **kw) -> "Env":
        """Per-worker distribution list (mixed machine generations)."""
        return cls(dists=tuple(dists), **kw)

    def with_faults(self, *faults) -> "Env":
        """A copy of this env with declarative faults appended."""
        return dataclasses.replace(self, faults=self.faults + tuple(faults))

    @classmethod
    def from_trace(cls, trace_or_path, per_worker: bool = True, **kw) -> "Env":
        """Bootstrap an env from a recorded ``repro_torch.sim.Trace``
        (object or JSON path): worker j resamples column j
        (``per_worker=True``) or the pooled marginals."""
        from ..sim.trace import Trace  # deferred: sim imports core

        trace = (trace_or_path if isinstance(trace_or_path, Trace)
                 else Trace.load(trace_or_path))
        emp = trace.to_empirical(per_worker=per_worker)
        if per_worker:
            return cls.heterogeneous(emp, **kw)
        return cls.iid(emp, trace.n_workers, **kw)

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
            env = cls.heterogeneous(obj)
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

    def effective_dists(self) -> tuple:
        """Per-worker distributions as the solver should see them: static
        degradations (``from_round == 0``) folded in; deaths and mid-run
        throttling are event-level and excluded."""
        fac = self.degradation_factors(0)
        return tuple(d if fac[j] == 1.0 else ScaledStraggler(base=d, factor=float(fac[j]))
                     for j, d in enumerate(self.dists))

    def solver_view(self) -> "Env":
        """The population as the block-partition solvers see it: static
        degradations folded into the per-worker distributions, all other
        faults dropped.  Fault-free envs pass through unchanged (keeps
        the i.i.d. fast path bit-identical)."""
        if not self.faults:
            return self
        return Env(dists=self.effective_dists(), mc_samples=self.mc_samples)

    def subset(self, workers: Sequence[int]) -> "Env":
        """The sub-population of the selected workers (the replica group a
        coded serving step fans out to).  Faults follow their worker into
        the subset with re-indexed worker ids; faults on excluded workers
        are dropped."""
        idx = [int(w) for w in workers]
        if not idx:
            raise ValueError("subset needs at least one worker")
        for w in idx:
            if not (0 <= w < self.n_workers):
                raise ValueError(f"worker {w} out of range [0,{self.n_workers})")
        remap = {w: j for j, w in enumerate(idx)}
        faults = tuple(dataclasses.replace(f, worker=remap[f.worker])
                       for f in self.faults if f.worker in remap)
        return Env(dists=tuple(self.dists[w] for w in idx), faults=faults,
                   mc_samples=self.mc_samples)

    # ------------------------------------------------------------- sampling
    def sample(self, rng, shape) -> np.ndarray:
        """Draw base cycle times (no faults).  For a non-identical
        population the trailing axis must be ``n_workers`` (column j ~
        worker j); the i.i.d. path delegates to the wrapped distribution
        (identical stream to the bare one)."""
        return self._sample(rng, shape, self.dists)

    def sample_effective(self, rng, shape) -> np.ndarray:
        """Like ``sample`` but from ``effective_dists()``."""
        return self._sample(rng, shape, self.effective_dists())

    def _sample(self, rng, shape, dists) -> np.ndarray:
        rng = _as_rng(rng)
        if all(d == dists[0] for d in dists):
            return dists[0].sample(rng, shape)
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        if not shape or shape[-1] != self.n_workers:
            raise ValueError(
                f"heterogeneous Env.sample needs a (..., {self.n_workers}) "
                f"shape (one column per worker); got {shape}")
        cols = [d.sample(rng, shape[:-1]) for d in dists]
        return np.stack(cols, axis=-1).astype(np.float64)

    def mean(self) -> float:
        """Mean cycle time of a uniformly random worker."""
        return float(np.mean([d.mean() for d in self.effective_dists()]))

    def means(self) -> np.ndarray:
        """(N,) per-worker mean cycle times (solver view)."""
        return np.asarray([d.mean() for d in self.effective_dists()])

    def sample_sorted(self, rng, n_workers: Optional[int] = None,
                      n_draws: int = 0) -> np.ndarray:
        """(n_draws, N) of order statistics T_(1) <= ... <= T_(N) of the
        effective population."""
        self._check_n(n_workers)
        t = self.sample_effective(rng, (int(n_draws), self.n_workers))
        t.sort(axis=1)
        return t

    # ------------------------------------------------------ order statistics
    def _check_n(self, n_workers) -> int:
        if n_workers is not None and int(n_workers) != self.n_workers:
            raise ValueError(f"env has {self.n_workers} workers, caller "
                             f"expects {n_workers}")
        return self.n_workers

    def expected_order_stats(self, n_workers: Optional[int] = None, rng=0,
                             method: str = "auto") -> np.ndarray:
        """t with t[k-1] = E[T_(k)]: the wrapped distribution's for an
        i.i.d. env; otherwise Monte-Carlo over ``mc_samples`` joint draws
        (``method="auto"`` or ``"mc"``) or Poisson-binomial quadrature
        over the per-worker CDFs (``method="quad"``, deterministic)."""
        n = self._check_n(n_workers)
        if self.is_iid:
            return self.dists[0].expected_order_stats(n, rng)
        if method == "quad":
            return self._order_stats_quad("mean")
        return self.sample_sorted(rng, n, self.mc_samples).mean(axis=0)

    def inv_expected_inv_order_stats(self, n_workers: Optional[int] = None,
                                     rng=0, method: str = "auto") -> np.ndarray:
        """t' with t'[k-1] = 1 / E[1/T_(k)] (paper Lemma 2, generalized to
        non-identical populations; the same ``method`` choice as
        ``expected_order_stats``)."""
        n = self._check_n(n_workers)
        if self.is_iid:
            return self.dists[0].inv_expected_inv_order_stats(n, rng)
        if method == "quad":
            return 1.0 / self._order_stats_quad("inv")
        draws = self.sample_sorted(rng, n, self.mc_samples)
        return 1.0 / (1.0 / draws).mean(axis=0)

    def order_stat_quantile(self, k: int, q: float, *, rtol: float = 1e-6,
                            n_workers: Optional[int] = None) -> float:
        """The ``q``-quantile of T_(k), the k-th smallest of the (effective)
        population: a decode step fanned out to R workers and accepted at
        the (R-s)-th delivery has its p99 at ``order_stat_quantile(R - s,
        0.99)``.  Inverts P[T_(k) <= t] (the count DP of
        ``_order_stat_tails``) by bracketed bisection."""
        n = self._check_n(n_workers)
        if not (1 <= int(k) <= n):
            raise ValueError(f"order statistic k={k} out of range [1,{n}]")
        if not (0.0 < q < 1.0):
            raise ValueError(f"quantile q={q} must be in (0, 1)")
        k = int(k)
        tails = self._order_stat_tails()
        target = 1.0 - float(q)          # find t with P[T_(k) > t] <= target

        hi = max(d.mean() for d in self.effective_dists())
        hi = max(hi, 1e-12)
        for _ in range(200):
            if tails(hi)[k - 1] <= target:
                break
            hi *= 2.0
        else:
            raise RuntimeError("order_stat_quantile: bracket expansion failed")
        lo = 0.0
        while hi - lo > rtol * max(hi, 1.0):
            mid = 0.5 * (lo + hi)
            if tails(mid)[k - 1] <= target:
                hi = mid
            else:
                lo = mid
        return float(hi)

    def _order_stat_tails(self):
        """t -> (N,) tail P[T_(k) > t], k = 1..N, by the Poisson-binomial
        count DP (P[#{T_i <= t} = c] for independent non-identical
        workers, O(N^2) per t), memoized per t."""
        n = self.n_workers
        cdfs = [d.cdf for d in self.effective_dists()]
        cache: dict = {}

        def tails(t: float) -> np.ndarray:
            out = cache.get(t)
            if out is None:
                count = np.zeros(n + 1)
                count[0] = 1.0
                for c in cdfs:
                    pi = float(c(t))
                    count[1:] = count[1:] * (1.0 - pi) + count[:-1] * pi
                    count[0] *= 1.0 - pi
                below = np.cumsum(count)  # P[#{T_i <= t} <= c], c = 0..N
                out = cache[t] = below[:-1]  # P[T_(k) > t] = P[count <= k-1]
            return out

        return tails

    def _order_stats_quad(self, kind: str) -> np.ndarray:
        """E[T_(k)] ("mean") or E[1/T_(k)] ("inv") for every k by
        quadrature over the order-statistic tail."""
        from scipy import integrate

        n = self.n_workers
        tails = self._order_stat_tails()
        out = np.empty(n)
        for k in range(1, n + 1):
            if kind == "mean":
                # E[T_(k)] = int_0^inf P[T_(k) > t] dt   (T > 0)
                def integrand(t, k=k):
                    return float(tails(t)[k - 1])
            else:
                # E[1/T_(k)] = int_0^inf P[T_(k) < 1/u] du
                def integrand(u, k=k):
                    if u <= 0.0:
                        return 1.0
                    return 1.0 - float(tails(1.0 / u)[k - 1])
            val, _ = integrate.quad(integrand, 0.0, np.inf, limit=400)
            out[k - 1] = val
        return out

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
