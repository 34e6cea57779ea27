"""The wave-pipelined (async) coded training loop, after
``repro/train/wave.py``.

The barrier ``Trainer`` serializes every round: wait for the
(N - s_b)-th delivery of every block, decode, apply the update, start the
next round.  ``WaveRunner`` executes the event simulator's wave schedule
instead (``repro_torch.sim``, ``wave=True``):

1. draw the segment's per-round straggler times exactly as the barrier
   loop does (same ``Env`` and rng stream, same degradation factors) and
   run ``ClusterSim`` (level-form schedule, the configured staleness)
   over them;
2. normalize the run into a ``WaveTrace`` — dispatch / decode / update
   events with per-round parameter versions and per-level first-(N - s)
   deliverer sets;
3. execute the events in trace order: ``dispatch`` computes the round's
   per-shard gradient rows from the parameters of that instant,
   ``decode`` triggers that level's combine (``combine_level``: one
   grouped ``gc_fused`` launch on CUDA) the instant its block decodes,
   ``update`` applies the monitoring loss and AdamW to the current
   parameters.

The port's AdamW updates the parameters in place, so a round's
gradients are computed at its dispatch, from the parameters the engine's
version says it sees; nothing holds a reference to parameters that a
later update changes.

Strategies: staleness 0 (``barrier``) calls the trainer's own step
function at each update event, so a run is bit-identical to
``Trainer.run``; staleness >= 1 with the flat pipeline in sim mode
(``staged``) combines per level at the decode events; the tree pipeline
and spmd mode (``deferred``) combine the whole round at its update
event, through the step's ``CodedGrads`` (in spmd: this rank's rows at
the dispatch — on a ``model`` axis, of its shards — the combine and its
collectives at the update, in the trace's order on every rank).  In spmd a broadcast checks each round's
draw at its update, as the barrier loop checks each step's.

Hot-swap quiesce: when the adaptive controller accepts a re-plan
mid-wave, rounds already dispatched under the old plan drain to their
updates, no new round dispatches, the swap binds at the quiescent
boundary and the next segment re-traces under the new plan.  Raw draws
of undispatched rounds are requeued, so the time stream stays aligned
with the round index.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..data.pipeline import coded_worker_batches
from ..sim import ClusterConfig, ClusterSim, schedule_from_plan_levels
from .coded import _resolve_pipeline, combine_level, per_shard_grad_rows
from .trainer import coded_update

__all__ = ["WaveConfig", "WaveRunner"]


@dataclass(frozen=True)
class WaveConfig:
    """Knobs of the wave-pipelined training loop.

    Latency and cost fields are in simulated-time units, the axis of
    ``plan.tau``.
    """

    #: rounds of bounded parameter staleness: 0 = barrier semantics
    #: (bit-identical to the synchronous Trainer), k = round r may
    #: dispatch once round r-1-k's update is applied.  None = unbounded.
    staleness: Optional[int] = 1
    #: master-side serialized decode + optimizer-update time per round
    update_cost: float = 0.0
    #: master -> worker broadcast latency per dependency
    broadcast_latency: float = 0.0

    def __post_init__(self):
        if self.staleness is not None and int(self.staleness) < 0:
            raise ValueError("staleness must be >= 0 (or None = unbounded)")
        if min(self.update_cost, self.broadcast_latency) < 0:
            raise ValueError("latencies/update_cost must be >= 0")

    def cluster_config(self) -> ClusterConfig:
        return ClusterConfig(
            wave=True, staleness=self.staleness, update_cost=self.update_cost,
            broadcast_latency=self.broadcast_latency)


class _Round:
    """In-flight state of one dispatched round."""

    __slots__ = ("index", "version", "wb", "rows", "dec_w", "combined", "times",
                 "decoded")

    def __init__(self, index: int, version: int, wb, times, n_used: int, n_workers: int):
        self.index = index          # absolute round index (data key offset)
        self.version = version      # segment-relative params version
        self.wb = wb                # (N, K, rows, S+1) worker batches
        self.rows = None            # per-leaf (N·K, size) shard rows
        self.dec_w = np.zeros((n_used, n_workers))  # filled per decode
        self.combined = {}          # leaf id -> decoded grad (staged)
        self.times = times          # (N,) effective draw for the ledger
        self.decoded = 0            # decode events seen


class WaveRunner:
    """Executes ``Trainer`` rounds on the wave schedule.  Constructed by
    ``Trainer(..., wave=WaveConfig(...))``; ``Trainer.run`` delegates
    here."""

    def __init__(self, trainer, cfg_w: WaveConfig):
        if trainer.env.has_deaths():
            raise ValueError("the live wave loop prices WorkerDeath only "
                             "through the event simulator; drop death "
                             "faults from the env (degradations are fine)")
        self.tr = trainer
        self.cfg_w = cfg_w
        #: per-segment WaveTrace / executed-event log
        self.traces: list = []
        self.executed: list = []
        #: absolute round index where each accepted re-plan bound
        self.swap_rounds: list = []
        #: raw (undegraded) draws carried across a quiesce boundary
        self._raw_queue: list = []

    def _strategy(self, plan) -> str:
        """'barrier' (staleness 0: the trainer's step), 'staged' (sim-mode
        flat pipeline: per-level combines at decode events) or 'deferred'
        (spmd, or the tree pipeline: the whole round's combine at its
        update)."""
        if self.cfg_w.staleness == 0:
            return "barrier"
        if self.tr.mesh is None and _resolve_pipeline(self.tr.pipeline, plan) == "flat":
            return "staged"
        return "deferred"

    def run(self, n_steps: int, log_every: int = 10, log_fn=print):
        done = 0
        while done < n_steps:
            done += self._run_segment(n_steps - done, log_every, log_fn)
        return self.tr.state, self.tr.sim.summary()

    def _draw_segment(self, env, rounds: int, ledger_base: int):
        """Per-round draws, the barrier loop's ``PlanSimulator.step``
        stream (one (N,) sample per round, degradation factors by
        absolute round index); quiesce leftovers come first."""
        n = self.tr.n_workers
        raw = []
        while self._raw_queue and len(raw) < rounds:
            raw.append(self._raw_queue.pop(0))
        for _ in range(rounds - len(raw)):
            raw.append(np.asarray(env.sample(self.tr.sim.rng, (n,)), np.float64))
        eff = np.stack([r * env.degradation_factors(ledger_base + i)
                        for i, r in enumerate(raw)])
        return raw, eff

    def _run_segment(self, max_rounds: int, log_every, log_fn) -> int:
        tr, cfg_w = self.tr, self.cfg_w
        plan, env, sim_cost = tr.plan, tr.sim.env, tr.sim.cost
        ledger_base = len(tr.sim.ledger)
        data_base = int(tr.state.step)
        raw, eff = self._draw_segment(env, max_rounds, ledger_base)

        res = ClusterSim(schedule_from_plan_levels(plan), eff, tr.n_workers,
                         cost=sim_cost, config=cfg_w.cluster_config()).run(max_rounds)
        trace = res.wave_trace()
        log: list = []
        self.traces.append(trace)
        self.executed.append(log)

        strategy = self._strategy(plan)
        n_used = len(plan.used_levels)
        rounds: dict = {}                # segment-relative index -> _Round
        pending_swap = None              # plan accepted, waiting to bind
        last_dispatched = -1
        unc_scale = sim_cost.scale(plan.n_workers)

        for ev in trace.events:
            if ev.kind == "dispatch":
                if pending_swap is not None:
                    continue             # quiesce: no new round dispatches
                # the engine's version bookkeeping and the live state
                # must agree on how many updates the parameters have seen
                if int(tr.state.step) - data_base != ev.version + 1:
                    raise RuntimeError(f"wave engine and trainer disagree at {ev}: "
                                       f"step {tr.state.step}, segment base {data_base}")
                wb = coded_worker_batches(tr.data, data_base + ev.round,
                                          tr.n_workers, plan.s_max)
                rd = _Round(data_base + ev.round, ev.version, wb, eff[ev.round],
                            n_used, tr.n_workers)
                if strategy == "staged":
                    rd.rows = per_shard_grad_rows(tr.cfg, tr.state.params, wb)
                elif strategy == "deferred":
                    rd.rows = tr.step_fn.grad_fn.rows(tr.state.params, wb)
                rounds[ev.round] = rd
                last_dispatched = ev.round

            elif ev.kind == "decode":
                rd = rounds.get(ev.round)
                if rd is None:
                    continue             # round skipped by quiesce
                s = int(plan.used_levels[ev.pos])
                rd.dec_w[ev.pos] = plan.codes.decode(s, np.asarray(ev.workers, np.int64))
                rd.decoded += 1
                if strategy == "staged":
                    rd.combined.update(combine_level(plan, rd.rows, ev.pos,
                                                     rd.dec_w[ev.pos]))
                    if rd.decoded == n_used:
                        rd.rows = None   # every level combined

            elif ev.kind == "update":
                rd = rounds.pop(ev.round, None)
                if rd is None:
                    continue             # round skipped by quiesce
                if rd.decoded != n_used:
                    raise RuntimeError(f"update of round {ev.round} after "
                                       f"{rd.decoded} of {n_used} decodes")
                dec_w = np.asarray(rd.dec_w, np.float32)
                tr.check_draw(dec_w, rd.times)
                t0 = time.perf_counter()
                if strategy == "barrier":
                    # the synchronous Trainer's own step: the staleness-0
                    # bit-identity guarantee
                    tr.state, metrics = tr.step_fn(tr.state, rd.wb, dec_w)
                else:
                    if strategy == "staged":
                        grads = [rd.combined[j] for j in range(plan.flat_layout.n_leaves)]
                    else:
                        grads = [g.reshape(t.shape) for g, t in zip(
                            tr.step_fn.grad_fn.combine(rd.rows, dec_w),
                            tr.state.params.leaves())]
                    rd.rows = rd.combined = None
                    tr.state, metrics = coded_update(tr.cfg, tr.cfg_t, tr.state, grads,
                                                     rd.wb)
                metrics = {k: float(v) for k, v in metrics.items()}
                rec = {"times": rd.times,
                       "tau_coded": plan.tau(rd.times, sim_cost),
                       "tau_uncoded": float(unc_scale * rd.times.max()
                                            * plan.total_units)}
                tr.sim.ledger.append(rec)
                metrics.update(step=int(tr.state.step),
                               wall_s=time.perf_counter() - t0,
                               tau_coded=rec["tau_coded"],
                               tau_uncoded=rec["tau_uncoded"],
                               staleness=(ev.round - 1) - rd.version)
                if tr.controller is not None:
                    new_plan = tr.controller.observe(
                        rec["times"], replan_ok=pending_swap is None)
                    if new_plan is not None:
                        pending_swap = new_plan
                        metrics["plan_swap"] = 1
                        if log_every:
                            log_fn(f"step {metrics['step']:5d}  plan swap "
                                   "accepted; quiescing in-flight waves")
                tr.history.append(metrics)
                if log_every and (ev.round % log_every == 0
                                  or ev.round == max_rounds - 1):
                    log_fn(f"step {metrics['step']:5d}  "
                           f"loss {metrics['loss']:.4f}  "
                           f"tau_coded {metrics['tau_coded']:.3g}  "
                           f"tau_uncoded {metrics['tau_uncoded']:.3g}")

            log.append(ev)

        if pending_swap is None:
            return max_rounds
        executed = last_dispatched + 1
        self._raw_queue.extend(raw[executed:])
        self.swap_rounds.append(data_base + executed)
        tr.swap_plan(pending_swap)
        if log_every:
            log_fn(f"step {int(tr.state.step):5d}  wave quiesced after "
                   f"round {data_base + executed - 1}; plan swap -> "
                   f"x={pending_swap.x.tolist()}")
        return executed
