"""First-class coding ``Plan``: solve -> assign -> code, one object.

Copied from ``repro/core/plan.py``.  A plan binds a scheme's block
solution x to a model's leaves (per-leaf redundancy levels, per-level
cyclic codes, each worker's dense coding rows, the ``FlatLayout``) and
simulates per-step straggler realizations (the eq. (2) ledger).

The reference reads the leaves with ``jax.tree.leaves``; the port takes
them in that same order from the model (``GCLM.leaves()``), from a
sequence of shaped objects, or as a bare 1-D cost vector.  The same
model therefore binds the same plan in both packages, and ``to_dict``
is the reference's schema, field for field.

``Plan.simulate`` prices straggler realizations with three backends: the
closed-form ``eq2`` (numpy), the ``event`` engine (``repro_torch.sim``)
and the batched ``mc`` backend (torch, on the card by default), all on
one draw stream.  ``Plan.build(scheme="auto")`` searches the schemes
with the autotuner (``repro_torch.tune``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .assignment import assign_levels_to_layers
from .coding import GradientCode
from .env import Env
from .flat import FlatLayout
from .runtime import CostModel, DEFAULT_COST
from .schemes import solve_scheme

__all__ = ["Plan", "PlanSimulator", "UNIT_RESOLUTION", "leaf_costs_of",
           "leaf_shapes_of"]

# L: abstract coordinate-unit resolution for the block optimizer.
UNIT_RESOLUTION = 20_000


def _leaves_of(params_or_costs):
    if hasattr(params_or_costs, "leaves"):
        return list(params_or_costs.leaves())
    return list(params_or_costs)


def leaf_costs_of(params_or_costs) -> np.ndarray:
    """Per-leaf cost vector: leaves with a ``.shape`` (tensors, arrays, a
    model's ``leaves()``) are priced by element count; a 1-D array is
    taken as the costs themselves."""
    if getattr(params_or_costs, "ndim", None) == 1:
        return np.asarray(params_or_costs, np.float64)
    out = []
    for leaf in _leaves_of(params_or_costs):
        shape = getattr(leaf, "shape", None)
        out.append(float(np.prod(tuple(shape))) if shape is not None else float(leaf))
    if not out:
        raise ValueError("params_or_costs has no leaves")
    return np.asarray(out, np.float64)


def leaf_shapes_of(params_or_costs):
    """Per-leaf shapes, or ``None`` for a bare cost vector (no layout)."""
    if getattr(params_or_costs, "ndim", None) == 1:
        return None
    shapes = [getattr(leaf, "shape", None)
              for leaf in _leaves_of(params_or_costs)]
    if not shapes or any(s is None for s in shapes):
        return None
    return [tuple(int(d) for d in s) for s in shapes]


@dataclass
class Plan:
    """A solved, model-bound block coordinate gradient coding plan."""

    n_workers: int
    x: np.ndarray                 # (N,) integer block sizes over total_units
    leaf_levels: np.ndarray       # per-leaf redundancy level s_j (flat order)
    leaf_costs: np.ndarray        # per-leaf cost weights (normalized)
    used_levels: np.ndarray       # sorted unique levels actually in use
    s_max: int
    b_rows: np.ndarray            # (N, n_used, K) worker coding coeffs over its shards
    codes: GradientCode = field(repr=False, default=None)
    scheme: str = "xf"
    total_units: int = UNIT_RESOLUTION
    env: Optional[Env] = None
    flat_layout: Optional[FlatLayout] = field(repr=False, default=None)

    # ------------------------------------------------------------ construction
    @classmethod
    def build(cls, params_or_costs, env, n_workers: Optional[int] = None, *,
              scheme: str = "xf", rng: int = 0, cost: CostModel = DEFAULT_COST,
              prefer_fractional: bool = False, s_cap=None,
              total: int = UNIT_RESOLUTION, warm_start=None, budget=None,
              device="cuda") -> "Plan":
        """Optimize the partition and bind it to this model's leaves.
        ``warm_start`` seeds iterative schemes (``spsg``) from a previous
        block vector — the adaptive re-planning path; closed forms ignore
        it.  ``scheme="auto"`` searches (scheme x s_cap) with
        ``repro_torch.tune.autotune_plan``, runtime-priced through
        ``simulate`` and optionally pruned by a ``MemBudget`` passed as
        ``budget`` (only meaningful with ``"auto"``); the winner carries
        its search record as ``plan.tune_report``.  ``device`` is where
        that search runs the ``mc`` backend (a non-i.i.d. env)."""
        if scheme == "auto":
            from ..tune import autotune_plan  # deferred: tune imports this module

            return autotune_plan(
                params_or_costs, env, n_workers, budget=budget, rng=rng,
                cost=cost, total=total, s_cap=s_cap,
                prefer_fractional=prefer_fractional, device=device)
        if budget is not None:
            raise ValueError(
                "budget= is only meaningful with scheme='auto' — a fixed "
                "scheme solves one plan and has nothing to prune")
        env = Env.coerce(env, n_workers)
        n_workers = env.n_workers
        x = solve_scheme(scheme, env, n_workers, total, cost=cost, rng=rng,
                         s_cap=s_cap, warm_start=warm_start)
        costs = leaf_costs_of(params_or_costs)
        levels = assign_levels_to_layers(costs, x)
        used = np.unique(levels)
        s_max = int(used.max())
        codes = GradientCode(n_workers, rng_seed=rng,
                             prefer_fractional=prefer_fractional)
        b_rows = cls._pack_rows(codes, n_workers, used, s_max)
        shapes = leaf_shapes_of(params_or_costs)
        flat_layout = None
        if shapes is not None:
            lookup = {int(s): i for i, s in enumerate(used)}
            flat_layout = FlatLayout.build(
                shapes, [lookup[int(s)] for s in levels], n_workers)
        return cls(
            n_workers=n_workers, x=x, leaf_levels=levels,
            leaf_costs=costs / costs.sum(), used_levels=used, s_max=s_max,
            b_rows=b_rows, codes=codes, scheme=scheme, total_units=int(total),
            env=env, flat_layout=flat_layout,
        )

    @staticmethod
    def _pack_rows(codes: GradientCode, n_workers: int, used: np.ndarray,
                   s_max: int) -> np.ndarray:
        """Dense (N, n_used, K) rows: worker n's cyclic-window coeffs."""
        k = s_max + 1
        b_rows = np.zeros((n_workers, len(used), k))
        for n in range(n_workers):
            for i, s in enumerate(used):
                row = codes.b(int(s))[n]  # support {n..n+s} cyclic
                for slot in range(int(s) + 1):
                    b_rows[n, i, slot] = row[(n + slot) % n_workers]
        return b_rows

    # --------------------------------------------------------------- queries
    @property
    def k_shards(self) -> int:
        return self.s_max + 1

    @property
    def solver(self) -> str:
        """The reference's name for ``scheme`` (its legacy field name)."""
        return self.scheme

    def partition_key(self) -> tuple:
        """Hashable structural identity of the coded computation: two
        plans with equal keys produce bit-identical coded steps (same
        partition, same leaf levels, same code bank seed)."""
        return (
            int(self.n_workers),
            tuple(int(v) for v in np.asarray(self.x)),
            tuple(int(s) for s in self.leaf_levels),
            tuple(int(s) for s in self.used_levels),
            int(self.codes.rng_seed),
            bool(self.codes.prefer_fractional),
        )

    def level_index(self) -> np.ndarray:
        """Per-leaf index into ``used_levels``."""
        lookup = {int(s): i for i, s in enumerate(self.used_levels)}
        return np.asarray([lookup[int(s)] for s in self.leaf_levels], np.int64)

    def decode_weights(self, times: np.ndarray) -> np.ndarray:
        """(n_used, N) decode vectors for a realization T (zeros on the
        s slowest workers per level)."""
        out = np.zeros((len(self.used_levels), self.n_workers))
        for i, s in enumerate(self.used_levels):
            fastest = self.codes.fastest_set(int(s), times)
            out[i] = self.codes.decode(int(s), fastest)
        return out

    def full_decode_weights(self) -> np.ndarray:
        """Decode weights when nobody straggles (all workers kept)."""
        return self.decode_weights(np.arange(self.n_workers, dtype=np.float64))

    def tau(self, times: np.ndarray, cost: CostModel = DEFAULT_COST) -> float:
        """Eq. (2) on the leaf-block layout (per-leaf cost weights stand in
        for the unit coordinates)."""
        s = self.leaf_levels
        t_sorted = np.sort(np.asarray(times, np.float64))
        t_term = t_sorted[self.n_workers - s - 1]
        work = np.cumsum((s + 1.0) * self.leaf_costs) * self.total_units
        return float(cost.scale(self.n_workers) * np.max(t_term * work))

    def _env_of(self, env) -> Env:
        """The population to simulate against: the argument if given,
        else the env this plan was built for."""
        if env is None:
            if self.env is None:
                raise ValueError("plan has no bound env; pass one explicitly")
            return self.env
        return Env.coerce(env, self.n_workers)

    def simulator(self, env=None, seed: int = 0,
                  cost: CostModel = DEFAULT_COST) -> "PlanSimulator":
        """Per-step straggler sampler + runtime ledger (``env`` defaults to
        the plan's bound env)."""
        return PlanSimulator(self, self._env_of(env), seed=seed, cost=cost)

    def simulate(self, env=None, steps: int = 1, *, seed: int = 0,
                 cost: CostModel = DEFAULT_COST, backend: str = "eq2",
                 device="cuda") -> "PlanSimulator":
        """Run ``steps`` straggler realizations; returns the simulator
        with its ledger filled (``.ledger``, ``.summary()``).

        ``env`` is an ``Env`` / bare distribution / None (the plan's bound
        env).  ``backend`` selects how each round is priced:

        * ``"eq2"``  — eq. (2) on the leaf-block layout, one numpy
          evaluation per draw (the default);
        * ``"event"`` — the discrete-event engine of ``repro_torch.sim``
          runs the plan (barrier rounds, leaf-form schedule): the same
          draws, round durations equal to eq. (2) to float precision;
        * ``"mc"``  — ``repro_torch.sim.mc`` prices all ``steps``
          realizations in one batched fp32 call on ``device`` (the only
          backend that reads it): ~1e-4 relative to the fp64 backends.

        Every backend draws one (N,) base row per step from one stream and
        folds in the ``DegradedWorker`` factors, so the ledgers' times
        agree.  ``WorkerDeath`` is realizable only by the event engine
        (eq2 and mc raise), where an uncovered death prices a round at
        infinity; the uncoded ledger stalls from the round the death hits.
        """
        env = self._env_of(env)
        sim = PlanSimulator(self, env, seed=seed, cost=cost)
        if backend == "eq2":
            for _ in range(steps):
                sim.step()
            return sim
        if backend not in ("event", "mc"):
            raise ValueError(f"unknown backend {backend!r}; "
                             "expected 'eq2', 'event', or 'mc'")
        # identical draw stream to the eq2 path: one (N,) base row per step
        times = np.stack([env.sample(sim.rng, (self.n_workers,))
                          for _ in range(steps)])
        from ..sim import ClusterSim, mc, schedule_from_plan  # deferred: sim imports core
        from ..sim.faults import apply_faults

        eff_times, deaths = apply_faults(times, env.faults)
        if backend == "event":
            # ClusterSim absorbs the env's declarative faults itself
            res = ClusterSim(schedule_from_plan(self), env, self.n_workers,
                             cost=cost, wave=False).run(rounds=steps, times=times)
            tau_coded = res.round_durations()
        else:
            if deaths:
                raise ValueError("backend 'mc' cannot price WorkerDeath "
                                 "faults; use backend='event'")
            tau_coded = mc.runtime_batch(mc.as_schedule(self), eff_times, cost=cost,
                                         device=device)
        unc_scale = cost.scale(self.n_workers) * self.total_units
        tau_unc = unc_scale * eff_times.max(axis=1)
        if deaths:
            # uncoded data-parallel waits on every worker each round, so
            # a death stalls it from that round (at_round) / from the
            # round in flight when the death hits (at_time) onward.
            cum = np.cumsum(tau_unc)
            stall_from = steps
            for d_time, d_round in deaths.values():
                if np.isfinite(d_round):
                    stall_from = min(stall_from, int(d_round))
                if np.isfinite(d_time):
                    stall_from = min(stall_from, int(np.searchsorted(cum, d_time)))
            tau_unc[stall_from:] = np.inf
        for r in range(steps):
            sim.ledger.append({
                "times": eff_times[r],
                "tau_coded": float(tau_coded[r]),
                "tau_uncoded": float(tau_unc[r]),
            })
        return sim

    # --------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        """JSON-serializable snapshot (the reference's schema)."""
        bank = {str(int(s)): self.codes.b(int(s)).tolist()
                for s in self.used_levels}
        return {
            "version": 1,
            "scheme": self.scheme,
            "env": None if self.env is None else self.env.to_dict(),
            "flat": (None if self.flat_layout is None
                     else self.flat_layout.to_dict()),
            "n_workers": int(self.n_workers),
            "total_units": int(self.total_units),
            "x": np.asarray(self.x).astype(np.int64).tolist(),
            "leaf_levels": np.asarray(self.leaf_levels).astype(int).tolist(),
            "leaf_costs": np.asarray(self.leaf_costs, np.float64).tolist(),
            "used_levels": np.asarray(self.used_levels).astype(int).tolist(),
            "s_max": int(self.s_max),
            "b_rows": np.asarray(self.b_rows, np.float64).tolist(),
            "codes": {
                "rng_seed": int(self.codes.rng_seed),
                "prefer_fractional": bool(self.codes.prefer_fractional),
                "bank": bank,
            },
        }

    @classmethod
    def from_dict(cls, blob: dict) -> "Plan":
        codes_meta = blob["codes"]
        codes = GradientCode(
            n_workers=int(blob["n_workers"]),
            rng_seed=int(codes_meta["rng_seed"]),
            prefer_fractional=bool(codes_meta["prefer_fractional"]),
        )
        for s, mat in codes_meta["bank"].items():
            codes._bank[int(s)] = np.asarray(mat, np.float64)
        return cls(
            n_workers=int(blob["n_workers"]),
            x=np.asarray(blob["x"], np.int64),
            leaf_levels=np.asarray(blob["leaf_levels"], np.int64),
            leaf_costs=np.asarray(blob["leaf_costs"], np.float64),
            used_levels=np.asarray(blob["used_levels"], np.int64),
            s_max=int(blob["s_max"]),
            b_rows=np.asarray(blob["b_rows"], np.float64),
            codes=codes,
            scheme=blob["scheme"],
            total_units=int(blob.get("total_units", UNIT_RESOLUTION)),
            env=(Env.from_dict(blob["env"])
                 if blob.get("env") is not None else None),
            flat_layout=FlatLayout.from_dict(blob.get("flat")),
        )


class PlanSimulator:
    """Per-step straggler realization + eq. (2) runtime ledger.

    Per step the base population is sampled and the env's
    ``DegradedWorker`` factors in effect at that round are folded in;
    ``WorkerDeath`` cannot be priced by eq. (2) and raises (use
    ``plan.simulate(backend="event")``).
    """

    def __init__(self, plan: Plan, env, seed: int = 0,
                 cost: CostModel = DEFAULT_COST):
        self.plan, self.cost = plan, cost
        self.env = Env.coerce(env, plan.n_workers)
        self.rng = np.random.default_rng(seed)
        self.ledger: list[dict] = []

    def step(self):
        """Sample T ~ env; returns (decode weights (n_used, N) f32, ledger
        record) and appends to the ledger."""
        plan = self.plan
        if self.env.has_deaths():
            raise ValueError("eq.(2) cannot price WorkerDeath faults; "
                             "use plan.simulate(backend='event')")
        times = self.env.sample(self.rng, (plan.n_workers,))
        times = times * self.env.degradation_factors(len(self.ledger))
        dec_w = plan.decode_weights(times)
        t_coded = plan.tau(times, self.cost)
        # uncoded synchronous data-parallel: wait for the slowest worker
        t_uncoded = float(self.cost.scale(plan.n_workers)
                          * times.max() * plan.total_units)
        rec = {"times": times, "tau_coded": t_coded, "tau_uncoded": t_uncoded}
        self.ledger.append(rec)
        return np.asarray(dec_w, np.float32), rec

    def summary(self) -> dict:
        if not self.ledger:
            return {}
        coded = np.asarray([r["tau_coded"] for r in self.ledger])
        unc = np.asarray([r["tau_uncoded"] for r in self.ledger])
        return {
            "steps": len(self.ledger),
            "mean_tau_coded": float(coded.mean()),
            "mean_tau_uncoded": float(unc.mean()),
            "speedup": float(unc.mean() / coded.mean()),
        }
