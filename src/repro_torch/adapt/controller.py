"""The re-plan decision loop, copied from ``repro/adapt/controller.py``:
drift -> re-solve -> hand back a ``Plan``.

``AdaptiveController`` owns a ``RuntimeMonitor`` and the re-planning
policy.  Each round the trainer feeds it the realized per-worker
completion times; when the drift detector fires (and the check cadence
and the predicted-gain gate agree), the controller

  1. cross-fits the newest half of the window: its even rounds become the
     solver's ``Env`` estimate (per-worker ``EmpiricalStraggler``), its
     odd rounds are held out to price the swap,
  2. re-solves the partition against that estimate — iterative schemes
     (``spsg``) warm-started from the current plan's x,
  3. prices both partitions on the held-out rounds (paired eq. (5)) and
     swaps only when the out-of-sample relative gain clears ``min_gain``
     AND a one-sided paired t-test,
  4. rebuilds the ``Plan`` (and its ``FlatLayout``) against the model's
     leaf shapes and returns it; the trainer hot-swaps it at a step
     boundary (``Trainer.swap_plan``).

``RecoveryEvent`` records a worker-death recovery, whose forced re-plan
is ``replan_now``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from scipy.stats import t as student_t

from ..core.env import Env
from ..core.plan import Plan
from ..core.runtime import CostModel, DEFAULT_COST, tau_hat_batch
from ..core.schemes import scheme_accepts_warm_start
from ..sim.trace import Trace
from .monitor import DriftReport, RuntimeMonitor

__all__ = ["AdaptConfig", "AdaptiveController", "RecoveryEvent", "SwapEvent"]


@dataclass(frozen=True)
class AdaptConfig:
    """Knobs of the adaptive re-planning loop.

    The defaults are deliberately conservative: a stationary cluster
    should essentially never swap (Bonferroni-corrected drift test +
    the ``min_gain`` gate), while a step-change is caught within about
    one window of rounds.
    """

    #: sliding-window length (rounds) of the runtime monitor
    window: int = 128
    #: observations required before estimates / drift checks activate
    min_rounds: int = 48
    #: run the drift check every this many observed rounds
    check_every: int = 8
    #: per-check KS significance (Bonferroni-corrected across workers)
    alpha: float = 0.002
    #: relative per-worker mean shift that also fires the detector
    mean_shift: float = 0.5
    #: out-of-sample predicted relative E[tau] improvement (priced on
    #: the held-out odd rounds of the window) required to actually swap
    min_gain: float = 0.02
    #: re-plan scheme (None -> the current plan's own scheme)
    scheme: Optional[str] = None
    #: redundancy-level cap for re-solves (Plan does not record the cap
    #: it was built under, so a capped deployment must restate it here
    #: — the SPMD work/tolerance co-design bound survives re-planning)
    s_cap: Optional[int] = None
    #: warm-start iterative schemes from the current plan's x
    warm_start: bool = True
    #: MC budget of the estimated Env's order statistics
    mc_samples: int = 50_000
    #: rng seed for re-solves (each re-plan advances it by one)
    rng: int = 0


@dataclass(frozen=True)
class SwapEvent:
    """One accepted re-plan: provenance for logs/benchmarks."""

    round_idx: int            # monitor.rounds_seen at swap time
    drift: DriftReport
    x_old: np.ndarray
    x_new: np.ndarray
    predicted_gain: float     # 1 - E[tau_new]/E[tau_old] under the estimate


@dataclass(frozen=True)
class RecoveryEvent:
    """One worker-death recovery: provenance for logs/benchmarks,
    symmetric to ``SwapEvent`` (which records *why the plan moved*;
    this records *why the state moved*).  Emitted by the trainer's
    recovery path: death detected -> forced re-plan -> coded restore
    from the survivors -> training continues from ``ckpt_step``.
    """

    step: int                  # trainer step at which death was detected
    dead_workers: tuple        # cumulative dead set at recovery time
    ckpt_step: int             # checkpoint step the state rewound to
    swap: Optional[SwapEvent]  # the forced re-plan (None: no controller
    #                            or too little signal to re-solve yet)


def _abstract_leaves(params_or_costs):
    """Plan.build inputs with storage stripped: each leaf becomes a
    meta-device tensor of its shape and dtype (no memory), so the
    controller does not pin the initial parameters on the card; a bare
    cost vector, and scalar-cost leaves, pass through unchanged.
    ``Plan.build`` reads only the shapes, so no torch dtype reaches a
    plan."""
    if getattr(params_or_costs, "ndim", None) == 1:
        return np.asarray(params_or_costs, np.float64)
    leaves = (params_or_costs.leaves() if hasattr(params_or_costs, "leaves")
              else params_or_costs)
    return [torch.empty(tuple(t.shape), device="meta") if hasattr(t, "shape") else t
            for t in leaves]


class AdaptiveController:
    """Drift-gated re-planner.  Feed it completion times; it hands back
    a fresh ``Plan`` when (and only when) re-planning pays."""

    def __init__(self, cfg: AdaptConfig, plan: Plan, params_or_costs, *,
                 cost: CostModel = DEFAULT_COST):
        self.cfg = cfg
        self.plan = plan
        #: what re-built plans bind to — leaf shapes as meta tensors (or
        #: the cost vector for solver-level scenarios).
        self.params_or_costs = _abstract_leaves(params_or_costs)
        self.cost = cost
        self.monitor = RuntimeMonitor(
            plan.n_workers, window=cfg.window, min_rounds=cfg.min_rounds,
            alpha=cfg.alpha, mean_shift=cfg.mean_shift,
            mc_samples=cfg.mc_samples)
        self.swaps: list[SwapEvent] = []
        self.checks = 0
        self._replan_count = 0
        self._cooldown_until = 0

    # ------------------------------------------------------------- the loop
    def observe(self, times, *, replan_ok: bool = True) -> Optional[Plan]:
        """Ingest one round's (N,) per-worker completion times; returns
        the new ``Plan`` when this round triggered an accepted re-plan,
        else ``None``.  The monitor window is cleared on an accepted
        swap (the refill time, >= ``min_rounds``, is the natural
        cooldown); a refused re-plan keeps the window and just backs
        off ``min_rounds`` before the next attempt.

        ``replan_ok=False`` feeds the monitor but suppresses the
        re-plan decision — the wave-pipelined loop uses it while
        draining in-flight rounds behind an already-accepted swap, so
        the drain's observations count without firing a second swap."""
        self.monitor.observe(times)
        if not replan_ok:
            return None
        if not self.monitor.ready:
            return None
        if self.monitor.rounds_seen < self._cooldown_until:
            return None
        if self.monitor.rounds_seen % self.cfg.check_every:
            return None
        self.checks += 1
        report = self.monitor.drift()
        if not report.fired and self.plan.env is not None:
            # in-window stationary, but possibly far from the model the
            # plan was solved for: the cumulative (slow-drift) arm.
            report = self.monitor.shift_from(self.plan.env.means())
        if not report.fired:
            return None
        return self._replan(report)

    def _replan(self, report: DriftReport) -> Optional[Plan]:
        cfg = self.cfg
        # Cross-fitted re-solve: the newest half of the window is the
        # current regime; its EVEN rounds feed the solver's Env estimate
        # and its ODD rounds price the swap decision.  A partition that
        # merely overfits estimation noise shows no gain on the held-out
        # rounds, so the gate stays honest at small windows (where a
        # same-sample "predicted gain" is systematically optimistic).
        recent = self.monitor.window_times()
        recent = recent[recent.shape[0] // 2:]
        env_fit = Env.from_trace(Trace.from_times(recent[0::2]),
                                 per_worker=True, mc_samples=cfg.mc_samples)
        price_times = recent[1::2]
        scheme = cfg.scheme or self.plan.scheme
        # thread the seed only where the scheme consumes it: closed
        # forms would discard it with a SchemeWarning otherwise
        warm = (np.asarray(self.plan.x, np.float64)
                if cfg.warm_start and scheme_accepts_warm_start(scheme)
                else None)
        # distinct seed per re-solve: the estimate changed, the solve
        # stream should too (still deterministic given the time stream)
        self._replan_count += 1
        new_plan = Plan.build(
            self.params_or_costs, env_fit, scheme=scheme,
            rng=cfg.rng + self._replan_count, cost=self.cost,
            total=int(self.plan.total_units), warm_start=warm,
            s_cap=cfg.s_cap,
            prefer_fractional=self.plan.codes.prefer_fractional)
        tau_cur, tau_new = self._price_rows(new_plan, price_times)
        gain = 1.0 - float(tau_new.mean()) / float(tau_cur.mean())
        if gain < cfg.min_gain or not _paired_significant(tau_cur - tau_new):
            # drift without a (yet-provable) better partition: keep the
            # plan AND the window — mid-transition rows keep sliding
            # out, so the next attempt prices on cleaner data — but
            # back off for min_rounds so a persistent borderline drift
            # (e.g. a uniform slowdown) costs one re-solve per cooldown
            # instead of one per check.
            self._cooldown_until = self.monitor.rounds_seen + cfg.min_rounds
            return None
        self.swaps.append(SwapEvent(
            round_idx=self.monitor.rounds_seen, drift=report,
            x_old=np.asarray(self.plan.x).copy(),
            x_new=np.asarray(new_plan.x).copy(), predicted_gain=gain))
        self.plan = new_plan
        self.monitor.reset()
        return new_plan

    def replan_now(self, report: Optional[DriftReport] = None) -> Optional[Plan]:
        """Forced re-plan, outside the drift/gain gates: the worker-death
        recovery path.  A death is not a statistical question — the
        partition *must* move off the dead worker — so the only gate
        kept is signal existence: with fewer than 4 observed rounds in
        the window there is nothing to estimate from and ``None`` comes
        back (the caller restores from survivors anyway and re-plans at
        the next opportunity).  The window is NOT cross-fit here (all
        recent rounds feed the estimate — post-death rows carry the
        degradation that steers work off the corpse) and the swap is
        accepted unconditionally; ``predicted_gain`` on the recent rows
        is recorded for provenance only.
        """
        recent = self.monitor.window_times()
        recent = recent[recent.shape[0] // 2:]
        if recent.shape[0] < 4:
            return None
        env_fit = Env.from_trace(Trace.from_times(recent), per_worker=True,
                                 mc_samples=self.cfg.mc_samples)
        scheme = self.cfg.scheme or self.plan.scheme
        self._replan_count += 1
        new_plan = Plan.build(
            self.params_or_costs, env_fit, scheme=scheme,
            rng=self.cfg.rng + self._replan_count, cost=self.cost,
            total=int(self.plan.total_units), warm_start=None,
            s_cap=self.cfg.s_cap,
            prefer_fractional=self.plan.codes.prefer_fractional)
        tau_cur, tau_new = self._price_rows(new_plan, recent)
        gain = 1.0 - float(tau_new.mean()) / float(tau_cur.mean())
        if report is None:
            report = DriftReport(True, np.zeros(self.plan.n_workers), np.inf,
                                 np.zeros(self.plan.n_workers), np.inf, -1)
        self.swaps.append(SwapEvent(
            round_idx=self.monitor.rounds_seen, drift=report,
            x_old=np.asarray(self.plan.x).copy(),
            x_new=np.asarray(new_plan.x).copy(), predicted_gain=gain))
        self.plan = new_plan
        self.monitor.reset()
        self._cooldown_until = 0
        return new_plan

    # ------------------------------------------------------------- pricing
    def _price_rows(self, candidate: Plan, price_times):
        """Per-round eq. (5) runtimes of (current, candidate) on the
        same held-out (rounds, N) times — the one pricing pass both
        gate arms derive from (paired comparison: draw noise cancels,
        only real partition differences survive)."""
        draws = np.asarray(price_times, np.float64)
        cur = tau_hat_batch(np.asarray(self.plan.x, np.float64), draws,
                            self.cost)
        new = tau_hat_batch(np.asarray(candidate.x, np.float64), draws,
                            self.cost)
        return cur, new


def _paired_significant(d: np.ndarray) -> bool:
    """One-sided paired t-test on the per-round improvements d: the
    mean must exceed the 95% Student-t quantile times its standard
    error.  At a handful of held-out rounds (tiny windows) the quantile
    is large, so a noisy configuration degrades to never-swap instead
    of thrashing on sampling artifacts."""
    if d.shape[0] < 2:
        return False
    se = float(d.std(ddof=1)) / np.sqrt(d.shape[0])
    if se == 0.0:  # every held-out round improved identically
        return bool(d.mean() > 0.0)
    return bool(d.mean() > student_t.ppf(0.95, d.shape[0] - 1) * se)
