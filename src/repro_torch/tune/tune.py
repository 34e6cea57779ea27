"""``autotune``: joint search over (scheme x redundancy x pipeline x
reduce mode x grad dtype) under a per-worker memory cap, copied from
``repro/tune/tune.py``.

  1. **Enumerate**: every registered scheme x ``s_cap`` in {0..N-1}
     solves one block vector; structurally identical solutions are
     deduplicated, then each surviving plan expands over pipeline
     (flat/tree) x reduce mode (psum/psum_scatter) x gradient dtype
     (fp32/bf16).
  2. **Price time**: expected per-step straggler runtime from
     ``Plan.simulate`` — eq. (2) for i.i.d. populations, the batched
     ``mc`` backend (torch, on ``device``) for heterogeneous ``Env``s —
     on one shared draw stream (paired comparison), plus a roofline
     overhead term (memory streaming + interconnect bytes at the
     ``launch.mesh.HW`` constants, one launch per collective) that
     differentiates the knobs the straggler model cannot see.
  3. **Price memory**: ``tune.memory.estimate_memory`` — shapes only, no
     device allocation — and prune candidates over the ``MemBudget``
     with a recorded reason.
  4. **Select**: argmin total time over admissible candidates
     (deterministic tie-break), returned as a ``TuneResult`` with the
     winning ``Plan`` and a JSON-serializable ``TuneReport``.

``autotune_plan`` is the shapes-only subset behind
``Plan.build(..., scheme="auto")`` — the same search over (scheme,
s_cap), runtime-priced, no model config required.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from ..core.env import Env
from ..core.plan import Plan, UNIT_RESOLUTION
from ..core.runtime import CostModel, DEFAULT_COST
from ..core.schemes import available_schemes

from .memory import MemBudget, MemEstimate, estimate_memory

__all__ = ["Candidate", "TuneError", "TuneReport", "TuneResult",
           "autotune", "autotune_plan", "COLLECTIVE_LAUNCH_S", "UNIT_S"]

#: wall-seconds one env time unit is worth when folding the roofline
#: overhead into the straggler objective (the reference's value; an
#: absolute calibration that waits for a measured step time on the card;
#: per-axis rankings are monotone in it).
UNIT_S = 1e-6

#: per-collective launch overhead (seconds) — what makes the flat
#: pipeline (one collective per level) beat the tree pipeline (one per
#: leaf) at equal payload.
COLLECTIVE_LAUNCH_S = 5e-6

#: schemes excluded from the default search space because their solve
#: is orders of magnitude slower than the closed forms (pass
#: ``schemes=[... , "spsg"]`` to include them explicitly).
EXPENSIVE_SCHEMES = ("spsg",)


class TuneError(ValueError):
    """No admissible candidate under the budget; ``.report`` has the
    full pruned table for diagnosis."""

    def __init__(self, message: str, report: "TuneReport"):
        super().__init__(message)
        self.report = report


@dataclass
class Candidate:
    """One priced point of the search space."""

    scheme: str
    s_cap: Optional[int]
    pipeline: str
    reduce_mode: str
    grad_dtype: str
    x: list = field(default_factory=list)
    s_max: int = 0
    straggler_time: float = float("nan")   # env time units (mean per step)
    overhead_time: float = 0.0             # env time units
    mem: Optional[MemEstimate] = None
    status: str = "ok"                     # 'ok' | 'pruned'
    prune_reason: str = ""
    plan: Optional[Plan] = field(default=None, repr=False)

    @property
    def time(self) -> float:
        return self.straggler_time + self.overhead_time

    def key(self) -> tuple:
        return (self.scheme, -1 if self.s_cap is None else int(self.s_cap),
                self.pipeline, self.reduce_mode, self.grad_dtype)

    def label(self) -> str:
        cap = "-" if self.s_cap is None else str(self.s_cap)
        return (f"{self.scheme}/s≤{cap}/{self.pipeline}/"
                f"{self.reduce_mode}/{self.grad_dtype}")

    def to_dict(self) -> dict:
        return {
            "scheme": self.scheme,
            "s_cap": self.s_cap,
            "pipeline": self.pipeline,
            "reduce_mode": self.reduce_mode,
            "grad_dtype": self.grad_dtype,
            "x": [int(v) for v in self.x],
            "s_max": int(self.s_max),
            "straggler_time": self.straggler_time,
            "overhead_time": self.overhead_time,
            "time": self.time,
            "mem": None if self.mem is None else self.mem.to_dict(),
            "status": self.status,
            "prune_reason": self.prune_reason,
        }


@dataclass
class TuneReport:
    """Ranked candidate table + search metadata; JSON round-trips."""

    candidates: list = field(default_factory=list)  # admissible, time asc
    pruned: list = field(default_factory=list)
    n_workers: int = 0
    budget: Optional[MemBudget] = None
    backend: str = "eq2"
    steps: int = 0
    seed: int = 0

    @property
    def best(self) -> Optional[Candidate]:
        return self.candidates[0] if self.candidates else None

    def to_dict(self) -> dict:
        return {
            "n_workers": int(self.n_workers),
            "budget_bytes": (None if self.budget is None
                             else float(self.budget.hbm_bytes)),
            "backend": self.backend,
            "steps": int(self.steps),
            "seed": int(self.seed),
            "n_candidates": len(self.candidates) + len(self.pruned),
            "n_admissible": len(self.candidates),
            "candidates": [c.to_dict() for c in self.candidates],
            "pruned": [c.to_dict() for c in self.pruned],
        }

    def to_json(self, path: Optional[str] = None, indent: int = 2) -> str:
        blob = json.dumps(self.to_dict(), indent=indent)
        if path is not None:
            with open(path, "w") as f:
                f.write(blob)
        return blob

    def table(self, limit: int = 12) -> str:
        """Human-readable ranked table (top ``limit`` + prune summary)."""
        lines = [f"{'rank':>4}  {'candidate':<40} {'time':>12} "
                 f"{'mem GiB':>8}  s_max"]
        for i, c in enumerate(self.candidates[:limit]):
            mem = "-" if c.mem is None else f"{c.mem.total / 2**30:8.2f}"
            lines.append(f"{i:>4}  {c.label():<40} {c.time:>12.4g} "
                         f"{mem:>8}  {c.s_max}")
        extra = len(self.candidates) - limit
        if extra > 0:
            lines.append(f"      ... {extra} more admissible")
        if self.pruned:
            reasons: dict[str, int] = {}
            for c in self.pruned:
                key = c.prune_reason.split(":")[0]
                reasons[key] = reasons.get(key, 0) + 1
            det = ", ".join(f"{k} x{v}" for k, v in sorted(reasons.items()))
            lines.append(f"      pruned {len(self.pruned)}: {det}")
        return "\n".join(lines)


@dataclass
class TuneResult:
    plan: Plan
    best: Candidate
    report: TuneReport


# --------------------------------------------------------------- internals
def _pick_backend(env: Env, backend: str) -> str:
    if backend != "auto":
        return backend
    return "eq2" if env.is_iid else "mc"


def _solve_plans(params_or_costs, env, schemes, s_caps, *, rng, cost, total,
                 prefer_fractional):
    """One ``Plan`` per structurally distinct (scheme, s_cap) solution,
    plus (scheme, s_cap, error) tuples for failed solves."""
    plans, failures, seen = [], [], set()
    for scheme in schemes:
        for s_cap in s_caps:
            try:
                plan = Plan.build(params_or_costs, env, scheme=scheme,
                                  rng=rng, cost=cost, s_cap=s_cap,
                                  total=total,
                                  prefer_fractional=prefer_fractional)
            except Exception as e:  # noqa: BLE001 — record, keep searching
                failures.append((scheme, s_cap, f"{type(e).__name__}: {e}"))
                continue
            key = (scheme, tuple(int(v) for v in plan.x))
            if key in seen:
                continue
            seen.add(key)
            # baselines ignore s_cap (registry contract: only the closed
            # forms honor it) — report those honestly as uncapped
            if s_cap is not None and plan.s_max > int(s_cap):
                s_cap = None
            plans.append((scheme, s_cap, plan))
    return plans, failures


def _straggler_time(plan: Plan, env: Env, *, steps: int, seed: int,
                    cost: CostModel, backend: str, device) -> float:
    sim = plan.simulate(env, steps, seed=seed, cost=cost, backend=backend,
                        device=device)
    return float(np.mean([r["tau_coded"] for r in sim.ledger]))


def _overhead_units(plan: Plan, pipeline: str, reduce_mode: str,
                    grad_dtype: str) -> float:
    """Roofline step overhead (env time units): stream K per-shard
    gradient stacks + the combine pass through device memory, move the packed
    payload over the interconnect (all-reduce ~2x payload,
    reduce-scatter 1x), pay one launch per collective (flat: one per
    level; tree: one per leaf)."""
    from ..launch.mesh import HW

    from .memory import GRAD_DTYPE_BYTES, _packed_elems

    gb = GRAD_DTYPE_BYTES[grad_dtype]
    raw, packed = _packed_elems(plan)
    payload = (packed if pipeline == "flat" else raw) * gb
    k = plan.s_max + 1
    hbm_s = (k * payload + 2 * payload) / HW.HBM_BW
    coll_s = payload * (2.0 if reduce_mode == "psum" else 1.0) / HW.ICI_BW
    n_coll = (len(plan.used_levels) if pipeline == "flat"
              else len(plan.leaf_levels))
    launch_s = n_coll * COLLECTIVE_LAUNCH_S
    return (hbm_s + coll_s + launch_s) / UNIT_S


def _search(params_or_costs, env, *, cfg=None, budget=None, schemes=None,
            s_caps=None, pipelines=("flat", "tree"),
            reduce_modes=("psum", "psum_scatter"),
            grad_dtypes=("fp32", "bf16"), steps=200, seed=0,
            cost=DEFAULT_COST, total=UNIT_RESOLUTION, backend="auto",
            prefer_fractional=False, global_batch=32, seq_len=512,
            hard_s_cap=None, device="cuda") -> TuneResult:
    env = Env.coerce(env, None)
    n = env.n_workers
    price_env = env.solver_view()   # deaths/transients out of the pricing
    backend = _pick_backend(price_env, backend)
    if schemes is None:
        schemes = [s for s in available_schemes()
                   if s not in EXPENSIVE_SCHEMES]
    if s_caps is None:
        s_caps = list(range(n))
    plans, failures = _solve_plans(params_or_costs, env, schemes, s_caps,
                                   rng=seed, cost=cost, total=total,
                                   prefer_fractional=prefer_fractional)
    report = TuneReport(n_workers=n, budget=budget, backend=backend,
                        steps=steps, seed=seed)
    for scheme, s_cap, err in failures:
        report.pruned.append(Candidate(
            scheme=scheme, s_cap=s_cap, pipeline="-", reduce_mode="-",
            grad_dtype="-", status="pruned",
            prune_reason=f"solve failed: {err}"))
    for scheme, s_cap, plan in plans:
        if hard_s_cap is not None and plan.s_max > int(hard_s_cap):
            # the scheme ignored the requested cap (only the closed
            # forms honor s_cap); an explicit user cap is a hard bound
            report.pruned.append(Candidate(
                scheme=scheme, s_cap=s_cap, pipeline="-", reduce_mode="-",
                grad_dtype="-", x=[int(v) for v in plan.x],
                s_max=plan.s_max, status="pruned",
                prune_reason=(f"s_cap: plan s_max {plan.s_max} exceeds the "
                              f"requested cap {int(hard_s_cap)} (scheme "
                              "does not honor s_cap)")))
            continue
        tau = _straggler_time(plan, price_env, steps=steps, seed=seed,
                              cost=cost, backend=backend, device=device)
        for pipeline in pipelines:
            for reduce_mode in reduce_modes:
                for grad_dtype in grad_dtypes:
                    cand = Candidate(
                        scheme=scheme, s_cap=s_cap, pipeline=pipeline,
                        reduce_mode=reduce_mode, grad_dtype=grad_dtype,
                        x=[int(v) for v in plan.x], s_max=plan.s_max,
                        straggler_time=tau,
                        overhead_time=_overhead_units(
                            plan, pipeline, reduce_mode, grad_dtype),
                        plan=plan)
                    cand.mem = estimate_memory(
                        plan, cfg=cfg, global_batch=global_batch,
                        seq_len=seq_len, grad_dtype=grad_dtype,
                        pipeline=pipeline, reduce_mode=reduce_mode)
                    if budget is not None \
                            and cand.mem.total > budget.hbm_bytes:
                        cand.status = "pruned"
                        cand.prune_reason = (
                            f"memory: {cand.mem.total / 2**30:.2f} GiB > "
                            f"budget {budget.hbm_bytes / 2**30:.2f} GiB")
                        report.pruned.append(cand)
                    else:
                        report.candidates.append(cand)
    report.candidates.sort(key=lambda c: (c.time, c.key()))
    best = report.best
    if best is None:
        raise TuneError(
            f"no admissible candidate under {budget}: "
            f"{len(report.pruned)} pruned (smallest footprint "
            f"{min((c.mem.total for c in report.pruned if c.mem is not None), default=float('nan')) / 2**30:.2f} GiB)",
            report)
    return TuneResult(plan=best.plan, best=best, report=report)


# ------------------------------------------------------------- public API
def autotune(cfg, env, budget: Optional[MemBudget] = None, *,
             n_workers: Optional[int] = None, global_batch: int = 32,
             seq_len: int = 512, schemes: Optional[Sequence[str]] = None,
             s_caps: Optional[Sequence[Optional[int]]] = None,
             pipelines: Sequence[str] = ("flat", "tree"),
             reduce_modes: Sequence[str] = ("psum", "psum_scatter"),
             grad_dtypes: Sequence[str] = ("fp32", "bf16"),
             steps: int = 200, seed: int = 0,
             cost: CostModel = DEFAULT_COST, total: int = UNIT_RESOLUTION,
             backend: str = "auto", device="cuda") -> TuneResult:
    """Search the full launch space for ``cfg`` on population ``env``.

    ``cfg`` is a ``ModelConfig``; its parameter shapes come from
    ``abstract_train_state`` (the model on the meta device — zero
    allocation).  ``env`` is anything ``Env.coerce`` accepts.
    ``device`` is where the ``mc`` backend runs (a non-i.i.d. env);
    nothing else reads it.  Returns a ``TuneResult`` whose ``.plan`` is
    the argmin candidate's plan and whose ``.best`` carries the winning
    (pipeline, reduce_mode, grad_dtype) knobs; raises ``TuneError`` when
    the budget prunes everything.
    """
    from ..train.state import abstract_train_state  # deferred: train imports core

    env = Env.coerce(env, n_workers)
    shapes = abstract_train_state(cfg)
    return _search(shapes.params, env, cfg=cfg, budget=budget,
                   schemes=schemes, s_caps=s_caps, pipelines=pipelines,
                   reduce_modes=reduce_modes, grad_dtypes=grad_dtypes,
                   steps=steps, seed=seed, cost=cost, total=total,
                   backend=backend, global_batch=global_batch,
                   seq_len=seq_len, device=device)


def autotune_plan(params_or_costs, env, n_workers: Optional[int] = None, *,
                  budget: Optional[MemBudget] = None,
                  schemes: Optional[Sequence[str]] = None,
                  s_caps: Optional[Sequence[Optional[int]]] = None,
                  rng: int = 0, cost: CostModel = DEFAULT_COST,
                  total: int = UNIT_RESOLUTION, steps: int = 120,
                  backend: str = "auto", s_cap=None,
                  prefer_fractional: bool = False, device="cuda") -> Plan:
    """The ``Plan.build(..., scheme="auto")`` path: runtime-priced
    search over (scheme x s_cap) only — the pipeline/reduce/dtype knobs
    live on the step builder, not the plan.  The winning plan carries
    its search record as ``plan.tune_report``.

    An explicit ``s_cap`` restricts the whole search at or below that
    level (matching ``Plan.build``'s meaning); memory pricing covers
    the state + gradient terms only (no model config here — use
    ``autotune(cfg, ...)`` for the activation-aware estimate).
    ``device`` is where the ``mc`` backend runs (a non-i.i.d. env).
    """
    env = Env.coerce(env, n_workers)
    if s_caps is None:
        top = env.n_workers if s_cap is None else int(s_cap) + 1
        s_caps = list(range(min(top, env.n_workers)))
    res = _search(params_or_costs, env, cfg=None, budget=budget,
                  schemes=schemes, s_caps=s_caps,
                  pipelines=("flat",), reduce_modes=("psum",),
                  grad_dtypes=("fp32",), steps=steps, seed=rng, cost=cost,
                  total=total, backend=backend,
                  prefer_fractional=prefer_fractional,
                  hard_s_cap=s_cap, device=device)
    plan = res.plan
    plan.tune_report = res.report
    return plan
