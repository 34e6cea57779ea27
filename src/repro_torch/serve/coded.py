"""Coded decode tier: redundancy-replicated decode for tail-latency control,
copied from ``repro/serve/coded.py`` (the plan and the latency stream are
bit-identical to the reference's: tests/test_torch_serve.py).

The paper buys straggler tolerance in *training* by assigning each
gradient block to s+1 of N workers and decoding at the (N-s)-th
delivery, with the redundancy level priced against the straggler
distribution (eq. (5)).  The identical move applies to *inference*:
fan a decode step out to R replica workers drawn from an ``Env``, give
each replica an MDS-coded 1/(R-s) shard of the step (so per-replica
work is (s+1)/R of the uncoded step), and complete at the (R-s)-th
delivery.  Step latency becomes

    L(R, s) = (s+1)/R * c * T_(R-s : R)

— an *order statistic* of the replica population instead of a single
worker's draw, so the p99 is set by ``Env.order_stat_quantile(R-s, .99)``
rather than the distribution's own tail.  (R=1, s=0) recovers the
uncoded baseline L = c * T; (R, s=R-1) is classic whole-step
replication (Tandon et al., arXiv 1612.03301); interior points trade
per-replica work against the order-statistic index exactly like the
training-side block levels.

``solve_replication`` picks (R, s) by brute enumeration under a worker
budget — the space is tiny (budget^2/2 points) and each candidate is
priced with the same order-statistics machinery the training solvers
use, so the solve is exact for the chosen objective ("mean" expected
step latency or a "p<q>" latency quantile).

``CodedDecode`` is the runtime object the serving engine holds: it
draws per-step replica times from the env (seeded — the latency stream
replays exactly) and realizes first-(R-s) completion, which matches the
event order of a one-block ``ClusterSim`` schedule bit-for-bit (the
reference's tests).  It prices steps and calls no kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..core.env import Env

__all__ = ["ReplicationPlan", "CodedDecode", "solve_replication"]


# ---------------------------------------------------------------- the plan
@dataclass(frozen=True)
class ReplicationPlan:
    """A solved (R, s) replica assignment for one decode step."""

    r: int                       # replicas per step
    s: int                       # tolerated stragglers (complete at R - s)
    workers: Tuple[int, ...]     # env worker ids in the replica group
    objective: str               # "mean" or "p<q>" (e.g. "p99")
    expected_step: float         # E[L] under the env, work c = 1
    p99_step: float              # 0.99-quantile of L, work c = 1

    def __post_init__(self):
        if not (0 <= self.s < self.r):
            raise ValueError(f"need 0 <= s < R, got R={self.r} s={self.s}")
        if len(self.workers) != self.r:
            raise ValueError("replica group size must equal R")

    @property
    def work_factor(self) -> float:
        """Per-replica work as a fraction of the uncoded step."""
        return (self.s + 1) / self.r

    @property
    def need(self) -> int:
        """Deliveries required to complete a step."""
        return self.r - self.s

    def to_dict(self) -> dict:
        return {
            "r": self.r, "s": self.s, "workers": list(self.workers),
            "objective": self.objective,
            "expected_step": self.expected_step, "p99_step": self.p99_step,
        }

    @classmethod
    def from_dict(cls, blob: dict) -> "ReplicationPlan":
        return cls(r=int(blob["r"]), s=int(blob["s"]),
                   workers=tuple(int(w) for w in blob["workers"]),
                   objective=str(blob["objective"]),
                   expected_step=float(blob["expected_step"]),
                   p99_step=float(blob["p99_step"]))


# ----------------------------------------------------------------- solver
def _quantile_name(objective: str) -> Optional[float]:
    """"p99" -> 0.99, "p50" -> 0.5, ... (None for "mean")."""
    if objective == "mean":
        return None
    if objective.startswith("p") and objective[1:].isdigit():
        q = float(objective[1:]) / 100.0
        if 0.0 < q < 1.0:
            return q
    raise ValueError(f"unknown objective {objective!r}; use 'mean' or e.g. 'p99'")


def solve_replication(env, *, budget: Optional[int] = None,
                      objective: str = "p99", work: float = 1.0,
                      ) -> ReplicationPlan:
    """Exact (R, s) by enumeration under a replica ``budget``.

    The replica group for size R is the R fastest workers by solver-view
    mean (for an i.i.d. env: any R).  Each candidate is priced as
    (s+1)/R * work * <order statistic of the sub-population>, with the
    statistic's mean from ``expected_order_stats`` and its quantile from
    ``order_stat_quantile`` — the same machinery Theorems 2/3 price
    training blocks with.
    """
    env = Env.coerce(env)
    budget = env.n_workers if budget is None else int(budget)
    if not (1 <= budget <= env.n_workers):
        raise ValueError(f"budget {budget} out of range [1,{env.n_workers}]")
    q_obj = _quantile_name(objective)
    order = np.argsort(env.means(), kind="stable")

    best = None
    for r in range(1, budget + 1):
        group = tuple(int(w) for w in order[:r])
        sub = env.subset(group)
        means = sub.expected_order_stats()
        for s in range(r):
            factor = (s + 1) / r * work
            mean_lat = factor * float(means[r - s - 1])
            p99_lat = factor * sub.order_stat_quantile(r - s, 0.99)
            score = mean_lat if q_obj is None else (
                p99_lat if q_obj == 0.99
                else factor * sub.order_stat_quantile(r - s, q_obj))
            if best is None or score < best[0]:
                best = (score, ReplicationPlan(
                    r=r, s=s, workers=group, objective=objective,
                    expected_step=mean_lat, p99_step=p99_lat))
    return best[1]


# ---------------------------------------------------------------- runtime
class CodedDecode:
    """Realized coded decode: seeded replica-time draws, first-(R-s)
    completion.  ``work`` scales every latency (cycles per decode step,
    the serving analogue of the ``CostModel`` scale)."""

    def __init__(self, env, plan: ReplicationPlan, *, work: float = 1.0,
                 seed: int = 0):
        env = Env.coerce(env)
        self.env = env
        self.plan = plan
        self.work = float(work)
        self.seed = int(seed)
        self._sub = env.subset(plan.workers)
        self._rng = np.random.default_rng(self.seed)

    # ------------------------------------------------------------ building
    @classmethod
    def solve(cls, env, *, budget: Optional[int] = None,
              objective: str = "p99", work: float = 1.0,
              seed: int = 0) -> "CodedDecode":
        env = Env.coerce(env)
        plan = solve_replication(env, budget=budget, objective=objective,
                                 work=work)
        return cls(env, plan, work=work, seed=seed)

    @classmethod
    def uncoded(cls, env, *, work: float = 1.0, seed: int = 0) -> "CodedDecode":
        """The R=1 baseline: one worker per step, latency = work * T."""
        env = Env.coerce(env)
        order = np.argsort(env.means(), kind="stable")
        w = (int(order[0]),)
        sub = env.subset(w)
        plan = ReplicationPlan(
            r=1, s=0, workers=w, objective="baseline",
            expected_step=float(sub.expected_order_stats()[0]),
            p99_step=sub.order_stat_quantile(1, 0.99))
        return cls(env, plan, work=work, seed=seed)

    # ------------------------------------------------------------- latency
    def step_latency(self, times: np.ndarray) -> float:
        """Completion time of one step given realized replica times
        (R,): per-replica compute is (s+1)/R * work * T, the step
        completes at the (R-s)-th delivery."""
        t = np.sort(np.asarray(times, np.float64))
        if t.shape != (self.plan.r,):
            raise ValueError(f"need ({self.plan.r},) replica times, got {t.shape}")
        return float(self.plan.work_factor * self.work * t[self.plan.need - 1])

    def draw_step(self) -> float:
        """One step's latency from the engine's seeded stream."""
        return float(self.step_latencies(1, rng=self._rng)[0])

    def step_latencies(self, n_steps: int, *, seed: Optional[int] = None,
                       rng=None) -> np.ndarray:
        """(n_steps,) independent step latencies.  ``seed`` gives a
        fresh reproducible stream; default uses the instance stream."""
        if rng is None:
            rng = self._rng if seed is None else np.random.default_rng(seed)
        shape = (int(n_steps), self.plan.r)
        t = np.sort(self._sub.sample_effective(rng, shape), axis=1)
        return self.plan.work_factor * self.work * t[:, self.plan.need - 1]

    # ---------------------------------------------------------- prediction
    def predicted_mean(self) -> float:
        stats = self._sub.expected_order_stats()
        return float(self.plan.work_factor * self.work * stats[self.plan.need - 1])

    def predicted_quantile(self, q: float) -> float:
        return float(self.plan.work_factor * self.work
                     * self._sub.order_stat_quantile(self.plan.need, q))

    # ------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return {"plan": self.plan.to_dict(), "env": self.env.to_dict(),
                "work": self.work, "seed": self.seed}

    @classmethod
    def from_dict(cls, blob: dict) -> "CodedDecode":
        return cls(Env.from_dict(blob["env"]),
                   ReplicationPlan.from_dict(blob["plan"]),
                   work=float(blob.get("work", 1.0)),
                   seed=int(blob.get("seed", 0)))
