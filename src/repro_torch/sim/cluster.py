"""Deterministic event-driven coded-cluster simulator, copied from
``repro/sim/cluster.py``: the x-form, leaf-form and level-form schedules,
the engine (``ClusterSim.run``), the normalized, replayable ``WaveTrace``
it exports (the contract of ``repro_torch.train.wave``), and the
``simulate_plan``/``simulate_x`` conveniences.

Each worker n draws a cycle time T_n per round and computes its blocks in
the sequential order of §III, delivering each to the master as it
finishes; the master decodes block b (level s_b) at its (N - s_b)-th
distinct delivery.  Two event kinds flow through one time-ordered heap,
``finish`` (a worker completes a block's compute) and ``deliver`` (the
block reaches the master ``comm_delay`` later; a message in flight dies
with its sender).  Ties break by a monotone sequence number, so a run is
a pure function of (schedule, times, faults, config) and replays exactly
from a ``Trace``.  With ``wave=False`` and zero latencies a round lasts
``tau_hat(x, T)`` (x-form) or ``Plan.tau(T)`` (leaf- and level-form).

``wave=True`` lets a worker start block b of round r+1 as soon as it has
finished its own earlier round-(r+1) blocks and the master has decoded
round r's block b; ``staleness`` bounds the overlap (round r may start
only once round r - 1 - staleness's update is applied: 0 reproduces the
barrier schedule event for event, None is unbounded), and
``update_cost`` is the master's serialized decode + update time.
``wave=False`` inserts a full barrier between rounds.
``cancel_decoded`` lets a worker skip blocks already decoded.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from ..core.env import Env
from ..core.runtime import CostModel, DEFAULT_COST
from .faults import apply_faults

__all__ = [
    "Block",
    "ClusterConfig",
    "ClusterResult",
    "ClusterSim",
    "WaveEvent",
    "WaveTrace",
    "schedule_from_x",
    "schedule_from_plan",
    "schedule_from_plan_levels",
    "simulate_plan",
    "simulate_x",
    "draw_times",
]


# --------------------------------------------------------------- schedules
@dataclass(frozen=True)
class Block:
    """One decodable unit of a round, in sequential compute order.

    ``work`` is the *cumulative* per-worker work (abstract units, before
    the ``CostModel`` scale) through the end of this block; ``level`` is
    the number of stragglers the block's code tolerates (s_b), so the
    master needs ``N - level`` deliveries to decode it.
    """

    index: int
    level: int
    work: float


def schedule_from_x(x) -> tuple:
    """Block schedule of an eq.(5) block solution x (skips empty levels).

    Level n contributes (n+1) * x_n cumulative work units.  Skipping
    x_n == 0 blocks is exact: an empty block's max-term is dominated by
    its predecessor (same work, larger order statistic).
    """
    x = np.asarray(x, dtype=np.float64)
    blocks, cum, idx = [], 0.0, 0
    for n, xn in enumerate(x):
        if xn <= 0:
            continue
        cum += (n + 1.0) * float(xn)
        blocks.append(Block(index=idx, level=n, work=cum))
        idx += 1
    if not blocks:
        raise ValueError("schedule_from_x: x has no positive mass")
    return tuple(blocks)


def schedule_from_plan(plan) -> tuple:
    """Leaf-form schedule of a ``Plan``: one block per parameter leaf.

    Mirrors ``Plan.tau``: leaf j (level s_j, normalized cost w_j)
    contributes (s_j + 1) * w_j * total_units cumulative work, so the
    barrier round duration equals ``plan.tau(T)`` for the same draw.
    """
    levels = np.asarray(plan.leaf_levels, np.int64)
    costs = np.asarray(plan.leaf_costs, np.float64)
    cum = np.cumsum((levels + 1.0) * costs) * float(plan.total_units)
    return tuple(
        Block(index=j, level=int(levels[j]), work=float(cum[j]))
        for j in range(len(levels))
    )


def schedule_from_plan_levels(plan) -> tuple:
    """Level-form schedule of a ``Plan``: ONE block per used level.

    Position i corresponds to ``plan.used_levels[i]`` — exactly the row
    order of ``plan.decode_weights`` — so decode events map 1:1 onto the
    per-level combines of the live training loop.  The cumulative work
    of level block i is the leaf-form cumulative work through the last
    leaf of that level; within a level the last leaf dominates the
    eq. (2) max-term (same order statistic, largest cumulative work),
    so barrier round durations still equal ``plan.tau(T)``.
    """
    levels = np.asarray(plan.leaf_levels, np.int64)
    costs = np.asarray(plan.leaf_costs, np.float64)
    if np.any(np.diff(levels) < 0):
        raise ValueError("schedule_from_plan_levels: leaf levels must be "
                         "nondecreasing in flat leaf order (Lemma 1 "
                         "compute-and-stream order)")
    cum = np.cumsum((levels + 1.0) * costs) * float(plan.total_units)
    blocks = []
    for i, s in enumerate(plan.used_levels):
        j = int(np.where(levels == int(s))[0][-1])
        blocks.append(Block(index=i, level=int(s), work=float(cum[j])))
    return tuple(blocks)


def draw_times(dist, rng, rounds: int, n_workers: int) -> np.ndarray:
    """(rounds, N) cycle-time draws.

    ``dist`` is an ``Env`` (base population, column j ~ worker j), a
    single ``StragglerDistribution`` (i.i.d. workers), a length-N
    sequence of per-worker distributions (heterogeneous cluster), or a
    ready (rounds, N) array (trace replay).
    """
    if isinstance(dist, np.ndarray):
        t = np.asarray(dist, np.float64)
        if t.shape != (rounds, n_workers):
            raise ValueError(f"times shape {t.shape} != {(rounds, n_workers)}")
        return t
    if isinstance(dist, Env):
        if dist.n_workers != n_workers:
            raise ValueError(f"env has {dist.n_workers} workers, "
                             f"simulator expects {n_workers}")
        return np.asarray(dist.sample(rng, (rounds, n_workers)), np.float64)
    if isinstance(dist, (list, tuple)):
        if len(dist) != n_workers:
            raise ValueError(f"need {n_workers} per-worker dists, got {len(dist)}")
        cols = [d.sample(rng, (rounds,)) for d in dist]
        return np.stack(cols, axis=1).astype(np.float64)
    return np.asarray(dist.sample(rng, (rounds, n_workers)), np.float64)


# ----------------------------------------------------------- configuration
@dataclass(frozen=True)
class ClusterConfig:
    """Knobs of the event engine.

    The default enables wave pipelining (the simulator's reason to
    exist); for the analytical eq.(2)/(5) barrier regime — per-round
    durations equal to ``tau_hat`` — set ``wave=False`` and keep the
    zero-latency defaults.
    """

    #: pipeline rounds per decoded block (True) vs full round barrier.
    wave: bool = True
    #: wave only: bounded overlap — round r may start only once the
    #: master has APPLIED round (r - 1 - staleness)'s optimizer update.
    #: 0 reproduces barrier semantics event-for-event; None = unbounded.
    staleness: Optional[int] = None
    #: master-side serialized decode + optimizer-update time per round.
    #: The barrier pays it between every pair of rounds; waves overlap
    #: it with the next round's compute (subject to ``staleness``).
    update_cost: float = 0.0
    #: workers skip blocks the master has already decoded (jump ahead).
    #: Off by default: eq. (5) assumes every worker computes every block.
    cancel_decoded: bool = False
    #: master -> worker update latency added to every dependency.
    broadcast_latency: float = 0.0
    #: worker -> master delivery latency added to every completion.
    comm_delay: float = 0.0
    #: keep the full event log on the result (debugging / timelines).
    record_events: bool = False


class _Worker:
    __slots__ = ("idx", "free_at", "round", "pos", "dead_at", "dead_round",
                 "stopped", "busy", "running", "epoch", "cur_start")

    def __init__(self, idx: int):
        self.idx = idx
        self.free_at = 0.0
        self.round = 0
        self.pos = 0
        self.dead_at = np.inf
        self.dead_round = np.inf
        self.stopped = False
        self.busy = 0.0
        self.running = False     # a compute is in flight (finish event queued)
        self.epoch = 0           # bumps invalidate queued finish events
        self.cur_start = 0.0     # start time of the in-flight compute


# ------------------------------------------------------------- wave traces
#: deterministic tie-break rank of same-time wave events: decodes of a
#: round precede its update, which precedes any later round's dispatch.
_WAVE_KIND_RANK = {"decode": 0, "update": 1, "dispatch": 2}


@dataclass(frozen=True)
class WaveEvent:
    """One normalized master-side event of a wave schedule.

    ``dispatch`` — the master freezes round ``round``'s parameter
    snapshot (``version`` = the last round whose update it includes;
    -1 = the initial parameters) and the first worker starts computing.
    ``decode``  — level block ``pos`` (index into ``used_levels``)
    reached its (N - s)-th delivery; ``workers`` is that first-(N - s)
    deliverer set, sorted (the decode-weight support).
    ``update``  — the master finished applying round ``round``'s
    optimizer update (``update_cost`` after the round's last decode).
    """

    t: float
    kind: str                  # "dispatch" | "decode" | "update"
    round: int
    pos: int = -1              # decode only: level-block position
    version: int = -1          # dispatch only: params version
    workers: tuple = ()        # decode only: sorted deliverer set

    def sort_key(self):
        return (self.t, self.round, _WAVE_KIND_RANK[self.kind], self.pos)


@dataclass(frozen=True)
class WaveTrace:
    """Replayable wave schedule: time-ordered ``WaveEvent`` tuple.

    A pure function of (schedule, times, config) — the executable
    contract the live wave loop (``repro_torch.train.wave``) consumes, and
    what its realized event order is differentially tested against.
    JSON round-trips bit-identically via ``to_dict``/``from_dict``.
    """

    n_workers: int
    n_blocks: int
    staleness: Optional[int]
    update_cost: float
    events: tuple

    def rounds(self) -> int:
        return 1 + max((e.round for e in self.events), default=-1)

    def realized_staleness(self) -> np.ndarray:
        """Per-round parameter staleness delta_r = (r - 1) - version_r
        (0 on every round == barrier-fresh parameters)."""
        disp = sorted((e for e in self.events if e.kind == "dispatch"),
                      key=lambda e: e.round)
        return np.asarray([(e.round - 1) - e.version for e in disp], np.int64)

    def to_dict(self) -> dict:
        return {
            "version": 1,
            "n_workers": int(self.n_workers),
            "n_blocks": int(self.n_blocks),
            "staleness": (None if self.staleness is None
                          else int(self.staleness)),
            "update_cost": float(self.update_cost),
            "events": [
                {"t": float(e.t), "kind": e.kind, "round": int(e.round),
                 "pos": int(e.pos), "version": int(e.version),
                 "workers": [int(w) for w in e.workers]}
                for e in self.events
            ],
        }

    @classmethod
    def from_dict(cls, blob: dict) -> "WaveTrace":
        return cls(
            n_workers=int(blob["n_workers"]),
            n_blocks=int(blob["n_blocks"]),
            staleness=(None if blob["staleness"] is None
                       else int(blob["staleness"])),
            update_cost=float(blob["update_cost"]),
            events=tuple(
                WaveEvent(t=float(e["t"]), kind=str(e["kind"]),
                          round=int(e["round"]), pos=int(e["pos"]),
                          version=int(e["version"]),
                          workers=tuple(int(w) for w in e["workers"]))
                for e in blob["events"]
            ),
        )


# ----------------------------------------------------------------- results
@dataclass
class ClusterResult:
    """Timeline of one simulated run."""

    schedule: tuple
    times: np.ndarray          # (R, N) drawn cycle times
    decode_times: np.ndarray   # (R, n_blocks) absolute decode instants
    round_done: np.ndarray     # (R,) last decode of each round (inf if stalled)
    makespan: float            # last decode overall (inf if stalled)
    stalled: bool              # some block never reached N - s deliveries
    undecoded: list            # [(round, block_index), ...] when stalled
    worker_busy: np.ndarray    # (N,) per-worker total compute time
    config: ClusterConfig
    events: Optional[list] = field(default=None, repr=False)
    #: (R,) first compute-start instant of each round (the dispatch time:
    #: the master's round-r parameter snapshot is frozen here).
    round_start: Optional[np.ndarray] = field(default=None, repr=False)
    #: per (round, block): the first-(N - s) deliverer workers, in
    #: delivery order — the realized decode-weight support.
    deliver_sets: Optional[list] = field(default=None, repr=False)

    def round_durations(self) -> np.ndarray:
        """Per-round wall time against the previous round's completion.

        With ``wave=False`` this is exactly eq. (2)/(5) per round; with
        waves, rounds overlap and the durations are the *marginal* cost
        of each round (they sum to the makespan either way).
        """
        starts = np.concatenate([[0.0], self.round_done[:-1]])
        return self.round_done - starts

    def trace(self, meta: Optional[dict] = None):
        """Record the drawn per-(round, worker) times for replay."""
        from .trace import Trace

        return Trace.from_times(self.times, meta=meta)

    def wave_trace(self) -> WaveTrace:
        """Normalize this run into a replayable ``WaveTrace``.

        Per round: one ``dispatch`` (first compute start; ``version`` =
        number of master updates applied by then, minus one), one
        ``decode`` per block (with its first-(N - s) deliverer set,
        sorted), one ``update`` (``update_cost`` after the last decode).
        Same-time ties order as decode < update < dispatch within/across
        rounds (causally consistent, deterministic).
        """
        if self.stalled:
            raise ValueError(f"stalled run has no complete wave trace "
                             f"(undecoded blocks: {self.undecoded[:4]}...)")
        rounds, n_blocks = self.decode_times.shape
        upd = self.round_done + self.config.update_cost  # monotone in r
        events = []
        for r in range(rounds):
            version = int(np.searchsorted(upd, self.round_start[r],
                                          side="right")) - 1
            events.append(WaveEvent(t=float(self.round_start[r]),
                                    kind="dispatch", round=r,
                                    version=version))
            for pos in range(n_blocks):
                events.append(WaveEvent(
                    t=float(self.decode_times[r, pos]), kind="decode",
                    round=r, pos=pos,
                    workers=tuple(sorted(self.deliver_sets[r][pos]))))
            events.append(WaveEvent(t=float(upd[r]), kind="update", round=r))
        events.sort(key=WaveEvent.sort_key)
        return WaveTrace(
            n_workers=int(self.worker_busy.shape[0]), n_blocks=int(n_blocks),
            staleness=self.config.staleness,
            update_cost=float(self.config.update_cost),
            events=tuple(events))

    def summary(self) -> dict:
        dur = self.round_durations()
        finite = dur[np.isfinite(dur)]
        util = (self.worker_busy / self.makespan
                if np.isfinite(self.makespan) and self.makespan > 0
                else np.zeros_like(self.worker_busy))
        return {
            "rounds": int(len(self.round_done)),
            "makespan": float(self.makespan),
            "mean_round": float(finite.mean()) if finite.size else float("inf"),
            "stalled": bool(self.stalled),
            "mean_utilization": float(util.mean()),
            "wave": bool(self.config.wave),
        }


# ------------------------------------------------------------------ engine
class ClusterSim:
    """Event-driven master/worker cluster for a block schedule.

    Parameters
    ----------
    schedule : tuple[Block, ...] from ``schedule_from_x``/``schedule_from_plan``.
    dist     : straggler model — an ``Env`` (its declarative faults are
               absorbed into ``faults``), one distribution, a per-worker
               list, or a (rounds, N) array (see ``draw_times``).
    n_workers: cluster size N.
    faults   : iterable of fault objects from ``repro_torch.core.env`` /
               ``repro_torch.sim.faults`` (appended to any env faults).
    """

    def __init__(self, schedule, dist, n_workers: int, *,
                 cost: CostModel = DEFAULT_COST, seed: int = 0,
                 faults: Sequence = (), config: Optional[ClusterConfig] = None,
                 **config_kw):
        if config is not None and config_kw:
            raise ValueError("pass either config= or config keywords, not both")
        if isinstance(dist, Env):
            # one population object: the env's declarative faults ride
            # along so ClusterSim(sched, env, N) realizes all of it
            faults = tuple(dist.faults) + tuple(faults)
        self.schedule = tuple(schedule)
        if not self.schedule:
            raise ValueError("empty schedule")
        works = [b.work for b in self.schedule]
        if any(b.level >= n_workers or b.level < 0 for b in self.schedule):
            raise ValueError("block level must be in [0, N)")
        if any(b <= a for a, b in zip([0.0] + works[:-1], works)):
            raise ValueError("cumulative work must be strictly increasing")
        self.dist = dist
        self.n_workers = int(n_workers)
        self.cost = cost
        self.seed = int(seed)
        self.faults = tuple(faults)
        self.config = config if config is not None else ClusterConfig(**config_kw)
        if self.config.staleness is not None and self.config.staleness < 0:
            raise ValueError("staleness must be >= 0 (or None = unbounded)")
        if self.config.update_cost < 0 or self.config.broadcast_latency < 0 \
                or self.config.comm_delay < 0:
            raise ValueError("latencies/update_cost must be >= 0")

    # ------------------------------------------------------------- running
    def run(self, rounds: int = 1, times: Optional[np.ndarray] = None
            ) -> ClusterResult:
        """Simulate ``rounds`` rounds; ``times`` overrides the draws."""
        if rounds < 1:
            raise ValueError("rounds must be >= 1")
        cfg = self.config
        n, n_blocks = self.n_workers, len(self.schedule)
        rng = np.random.default_rng(self.seed)
        if times is None:
            times = draw_times(self.dist, rng, rounds, n)
        else:
            times = draw_times(times, rng, rounds, n)
        times, deaths = apply_faults(times, self.faults)
        scale = self.cost.scale(n)
        incr = np.diff([0.0] + [b.work for b in self.schedule])

        workers = [_Worker(i) for i in range(n)]
        for w, (at_time, at_round) in deaths.items():
            workers[w].dead_at = at_time
            workers[w].dead_round = at_round

        heap: list = []           # (time, seq, kind, *payload)
        seq = 0
        delivered = np.zeros((rounds, n_blocks), np.int64)
        decoded_at = np.full((rounds, n_blocks), np.inf)
        blocks_left = np.full(rounds, n_blocks, np.int64)
        round_done = np.full(rounds, np.inf)
        round_start = np.full(rounds, np.inf)
        deliver_sets = [[[] for _ in range(n_blocks)] for _ in range(rounds)]
        waiters: dict = {}        # dep key -> [worker, ...]
        events = [] if cfg.record_events else None

        def push(t, kind, *payload):
            nonlocal seq
            heapq.heappush(heap, (t, seq, kind, payload))
            seq += 1

        def dep_of(r: int, pos: int):
            """Dependency key + ready time for block ``pos`` of round ``r``."""
            if r == 0:
                return None, 0.0
            if cfg.wave:
                t_dep = decoded_at[r - 1, pos]
                if not np.isfinite(t_dep):
                    return (("blk", r - 1, pos), np.inf)
                ready = t_dep + cfg.broadcast_latency
                if cfg.staleness is not None:
                    rg = r - 1 - cfg.staleness
                    if rg >= 0:
                        # bounded overlap: the master must have APPLIED
                        # round rg's update before round r may start
                        t_gate = round_done[rg]
                        if not np.isfinite(t_gate):
                            return (("rnd", rg), np.inf)
                        ready = max(ready, t_gate + cfg.update_cost
                                    + cfg.broadcast_latency)
                return (("blk", r - 1, pos), ready)
            t_dep = round_done[r - 1]
            return (("rnd", r - 1),
                    t_dep + cfg.update_cost + cfg.broadcast_latency)

        def try_start(w: _Worker):
            """Advance ``w`` to its next runnable block (or park/stop it)."""
            if w.running:
                return
            while not w.stopped and w.round < rounds:
                r, pos = w.round, w.pos
                if r >= w.dead_round:
                    w.stopped = True
                    return
                if cfg.cancel_decoded and np.isfinite(decoded_at[r, pos]):
                    _advance(w)
                    continue
                key, ready = dep_of(r, pos)
                if not np.isfinite(ready):
                    waiters.setdefault(key, []).append(w)
                    return
                start = max(w.free_at, ready)
                dur = scale * times[r, w.idx] * incr[pos]
                finish = start + dur
                if finish >= w.dead_at:
                    w.stopped = True        # dies mid-compute: no delivery
                    w.busy += max(w.dead_at - start, 0.0)
                    if events is not None:
                        events.append((w.dead_at, "death", w.idx, r, pos))
                    return
                w.free_at = finish
                w.running = True
                w.cur_start = start
                round_start[r] = min(round_start[r], start)
                if events is not None:  # appended at schedule time, so the
                    # raw log is causal-order, not time-order (starts may
                    # carry future timestamps); wave_trace() re-sorts.
                    events.append((start, "start", w.idx, r, pos))
                push(finish, "finish", w.idx, r, pos, w.epoch)
                return

        def _advance(w: _Worker):
            w.pos += 1
            if w.pos == n_blocks:
                w.pos = 0
                w.round += 1

        def wake(key):
            for w in waiters.pop(key, []):
                try_start(w)

        def flush_round(r: int, t: float):
            """Round r fully decoded: remaining round-r work is stale.

            The master's broadcast makes every outstanding round-r block
            worthless, so workers still inside round r abandon it —
            preempting an in-flight compute — and move to round r + 1.
            This is what makes barrier rounds i.i.d. eq.(2) realizations
            (and what eq. (5) implicitly assumes between rounds).
            """
            for w in workers:
                if w.stopped or w.round != r:
                    continue
                if w.running:
                    w.epoch += 1            # invalidate the queued finish
                    w.running = False
                    w.busy += max(t - w.cur_start, 0.0)
                    w.free_at = t
                w.round, w.pos = r + 1, 0
                try_start(w)

        for w in workers:
            try_start(w)

        while heap:
            t, _, kind, payload = heapq.heappop(heap)
            if kind == "finish":
                widx, r, pos, epoch = payload
                w = workers[widx]
                if epoch != w.epoch:        # preempted by a round flush
                    continue
                if events is not None:
                    events.append((t, "finish", widx, r, pos))
                w.running = False
                w.busy += t - w.cur_start
                push(t + cfg.comm_delay, "deliver", widx, r, pos)
                _advance(w)
                try_start(w)
            else:  # deliver
                widx, r, pos = payload
                if t >= workers[widx].dead_at:
                    continue    # in-flight message dies with its sender
                if events is not None:
                    events.append((t, "deliver", widx, r, pos))
                delivered[r, pos] += 1
                need = n - self.schedule[pos].level
                if delivered[r, pos] <= need:
                    deliver_sets[r][pos].append(widx)
                if delivered[r, pos] == need:
                    decoded_at[r, pos] = t
                    if events is not None:
                        events.append((t, "decode", -1, r, pos))
                    blocks_left[r] -= 1
                    wake(("blk", r, pos))
                    if blocks_left[r] == 0:
                        round_done[r] = t
                        wake(("rnd", r))
                        flush_round(r, t)

        undecoded = [(int(r), int(b))
                     for r in range(rounds) for b in range(n_blocks)
                     if not np.isfinite(decoded_at[r, b])]
        makespan = float(round_done[-1]) if not undecoded else float("inf")
        return ClusterResult(
            schedule=self.schedule, times=times, decode_times=decoded_at,
            round_done=round_done, makespan=makespan,
            stalled=bool(undecoded), undecoded=undecoded,
            worker_busy=np.asarray([w.busy for w in workers]),
            config=cfg, events=events,
            round_start=round_start, deliver_sets=deliver_sets,
        )


# ------------------------------------------------------------ conveniences
def simulate_plan(plan, dist=None, rounds: int = 1, *, seed: int = 0,
                  cost: CostModel = DEFAULT_COST, faults: Sequence = (),
                  **config_kw) -> ClusterResult:
    """Run a ``Plan`` end-to-end on the event engine (leaf-form
    schedule).  ``dist=None`` uses the plan's bound env."""
    if dist is None:
        if plan.env is None:
            raise ValueError("plan has no bound env; pass dist/env explicitly")
        dist = plan.env
    sim = ClusterSim(schedule_from_plan(plan), dist, plan.n_workers,
                     cost=cost, seed=seed, faults=faults, **config_kw)
    return sim.run(rounds)


def simulate_x(x, dist, n_workers: int, rounds: int = 1, *, seed: int = 0,
               cost: CostModel = DEFAULT_COST, faults: Sequence = (),
               **config_kw) -> ClusterResult:
    """Run an eq.(5) block solution x on the event engine."""
    sim = ClusterSim(schedule_from_x(x), dist, n_workers,
                     cost=cost, seed=seed, faults=faults, **config_kw)
    return sim.run(rounds)
