"""The training steps and the ``Trainer``, after ``repro/train/trainer.py``.

``make_train_step`` — the uncoded step: the plain mean gradient of a
batch (in spmd each rank takes its rows, then one ``all_reduce``).
``make_coded_train_step`` — coded per-shard gradients, the coded
combine (sim mode, or spmd over a ``Mesh``), then clip, AdamW and the
cosine LR.  The decode weights (the straggler realization) are a
per-step input sampled host-side by the plan's numpy simulator, so the
ledger is the reference's, draw for draw.

``Trainer`` — the loop: data, straggler simulation, ledger, metrics,
adaptive re-planning with plan hot-swaps, the wave-pipelined schedule
(``train/wave.py``), checkpoints (plain or erasure-coded) and
worker-death recovery, in sim mode on one device or in spmd mode on N
data-parallel ranks — each, on a mesh with a ``model`` axis, a group of
tensor-parallel ranks holding its shards of the parameters and the
optimizer moments (``models.params.shard_model``).  In spmd every rank
builds the same plan and simulator from the same seed, so every rank
draws the same decode weights and takes the same decisions (swaps,
deaths, restores); a broadcast from rank 0 checks each draw.  ``scheme="auto"`` searches the
launch space with the autotuner (``repro_torch.tune``).
"""
from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..adapt import AdaptiveController, DeathWatch, RecoveryEvent
from ..checkpoint.manager import CheckpointManager
from ..core import Env, Plan
from ..data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
from ..dist.collectives import broadcast, check_replicated, psum
from ..models.model import has_source, train_loss
from ..models.params import GCLM, data_shard_of, gather_data
from ..optim.optim import adamw_update, clip_by_global_norm, cosine_schedule
from .coded import make_coded_grad_fn
from .state import TrainState, cut_leaf, init_train_state

__all__ = ["TrainConfig", "make_train_step", "make_coded_train_step", "Trainer"]


@dataclass
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.95


def _apply_update(cfg_t: TrainConfig, state: TrainState, grads, metrics):
    lr = cosine_schedule(state.step, cfg_t.lr, cfg_t.warmup, cfg_t.total_steps)
    tp, dims, fsdp = state.params.tp, state.params.shard_dims, state.params.fsdp
    groups = {}
    if tp is not None:
        groups.update(group=tp.model_group, split=[d is not None for d in dims])
    if fsdp is not None:
        groups.update(data_group=fsdp.data_group, data_split=[d is not None for d in fsdp.dims])
    grads, gnorm = clip_by_global_norm(grads, cfg_t.clip_norm, **groups)
    opt = adamw_update(grads, state.opt, state.params.leaves(), lr,
                       b1=cfg_t.b1, b2=cfg_t.b2, weight_decay=cfg_t.weight_decay)
    metrics = dict(metrics, grad_norm=gnorm, lr=lr)
    return TrainState(params=state.params, opt=opt, step=state.step + 1), metrics


def make_train_step(cfg, cfg_t: TrainConfig, *, mesh=None) -> Callable:
    """The uncoded step: step(state, batch) -> (state, metrics) on the
    plain mean gradient of ``batch["tokens"]`` (B, S+1), with the
    modality embeddings ``batch["aux_inputs"]`` (B, ...) of a model with
    a cross-attention source.  With a ``mesh`` each data-parallel replica
    (a (pod, data) index) takes its block of the rows, and an
    ``all_reduce`` over the data ranks, then one over the pod ranks,
    sums the gradients and the metrics before the mean: the plain
    data-parallel step.  On a ``model`` axis the state holds the rank's
    shards; a state cut over ``data`` (``fsdp``) is gathered into its
    working module first (``gather_data``), and the rank keeps its slice
    of each cut leaf's reduced gradient."""
    def step(state: TrainState, batch):
        work = gather_data(state.params)
        leaves = work.leaves()
        part = {k: batch[k] for k in ("tokens", "aux_inputs") if k in batch}
        if mesh is not None:
            n_rows, replicas = part["tokens"].shape[0], mesh.data * mesh.pod
            if n_rows % replicas:
                raise ValueError(f"{n_rows} rows do not split over {replicas} ranks")
            h, i = n_rows // replicas, mesh.pod_index * mesh.data + mesh.data_index
            part = {k: v[i * h:(i + 1) * h] for k, v in part.items()}
        loss, metrics = train_loss(cfg, work, part)
        grads = list(torch.autograd.grad(loss, leaves))
        del work, leaves
        keys = sorted(metrics)
        values = torch.stack([metrics[k].detach().float() for k in keys])
        if mesh is not None:
            flat = torch.cat([g.reshape(-1) for g in grads] + [values])
            psum([flat], mesh.data_group)
            if mesh.pod > 1:
                psum([flat], mesh.pod_group)
            flat = flat / (mesh.data * mesh.pod)
            parts = torch.split(flat, [g.numel() for g in grads] + [len(keys)])
            grads = [part.view_as(g) for part, g in zip(parts, grads)]
            values = parts[-1]
        if state.params.fsdp is not None:
            grads = [data_shard_of(g, d, mesh) for g, d in zip(grads, state.params.fsdp.dims)]
        return _apply_update(cfg_t, state, grads, dict(zip(keys, values)))

    return step


def make_coded_train_step(cfg, cfg_t: TrainConfig, plan: Plan, *,
                          mode: str = "sim", mesh=None, reduce_mode: str = "psum",
                          grad_dtype=None, pipeline: str = "auto") -> Callable:
    """step(state, worker_batches, dec_w, worker_aux=None) -> (state,
    metrics); the parameters and optimizer moments are updated in place.
    ``worker_aux`` (N, K, rows, ...) carries the modality embeddings of a
    model with a cross-attention source.  The keywords go to
    ``make_coded_grad_fn``, whose ``CodedGrads`` the step keeps as
    ``step.grad_fn``.  A state cut over ``data`` (``fsdp``) is gathered
    into its working module once a step (``gather_data``): the per-shard
    passes, the combine and the monitoring forward bind it, and it is
    let go before the update."""
    grad_fn = make_coded_grad_fn(cfg, plan, mode=mode, mesh=mesh, reduce_mode=reduce_mode,
                                 grad_dtype=grad_dtype, pipeline=pipeline)

    def step(state: TrainState, worker_batches, dec_w, worker_aux=None):
        work = gather_data(state.params)
        grads = grad_fn(state.params, worker_batches, dec_w, worker_aux, work=work)
        metrics = _monitor(cfg, work, worker_batches, worker_aux)
        del work
        return _apply_update(cfg_t, state, grads, metrics)

    step.grad_fn = grad_fn
    return step


def coded_update(cfg, cfg_t: TrainConfig, state: TrainState, grads, worker_batches,
                 worker_aux=None):
    """The coded step after its gradients: the monitoring loss on shard 0
    (``_monitor``) with the pre-update parameters (gathered into the
    working module when the state is cut over ``data``), then clip, AdamW
    and the cosine LR (in place).  Returns (state, metrics)."""
    metrics = _monitor(cfg, gather_data(state.params), worker_batches, worker_aux)
    return _apply_update(cfg_t, state, grads, metrics)


def _monitor(cfg, work, worker_batches, worker_aux=None) -> dict:
    """The monitoring metrics: ``train_loss`` of the module ``work`` on
    shard 0 (with ``worker_aux[0, 0]`` as its ``aux_inputs`` when given),
    without gradients.  Shard 0's tokens are copied to the device as they
    are, as the passes copy theirs, so their conversion runs there (an op
    counter sees the step the same on meta and on a card)."""
    mon = {"tokens": torch.as_tensor(worker_batches[0, 0], device=work.embed.tok.device)}
    if worker_aux is not None:
        mon["aux_inputs"] = worker_aux[0, 0]
    with torch.no_grad():
        return train_loss(cfg, work, mon)[1]


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes, flat: equal bytes, not equal values (NaN, -0.0)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


class Trainer:
    """The end-to-end coded-training loop.

    ``env`` is the worker population (an ``Env`` or a bare distribution
    with ``n_workers``).  ``pipeline`` is the coded combine: 'auto' (the
    fused flat one: the trainer's plans carry a ``FlatLayout``), 'flat'
    or 'tree'.  ``mode`` 'sim' simulates the N workers on one device;
    'spmd' runs them as the ``data`` ranks of ``mesh`` (a
    ``repro_torch.dist.mesh.Mesh``; the state lives on its device), with
    ``reduce_mode`` 'psum' or 'psum_scatter'.  ``grad_dtype`` (None or
    e.g. ``torch.bfloat16``) casts the coded gradients (in spmd, before
    the reduction).  ``params`` optionally carries initial parameters
    as a reference tree of numpy arrays; otherwise they are drawn from
    ``seed``.  ``seq_len`` defaults to the reference's
    ``min(cfg.max_seq, 512)``.  ``device`` defaults to CUDA and raises
    when CUDA is absent.

    ``ckpt`` is an optional ``repro_torch.checkpoint.CkptConfig``: the
    trainer then checkpoints every ``ckpt.every`` steps at step
    boundaries (erasure-coded across the workers when ``ckpt.coded`` is
    set; in spmd rank 0 writes while the others wait at a barrier),
    resumes from the newest intact checkpoint on construction
    (``ckpt.resume``; in spmd rank 0 reads and decodes it and broadcasts
    it leaf by leaf, and every rank checks its state against the data
    ranks of its model index), and arms
    worker-death recovery: a ``DeathWatch`` over the realized round times
    triggers a restore from the surviving shards, recorded as a
    ``RecoveryEvent`` in ``self.recoveries``; with a controller the
    recovery first forces a re-plan (``RecoveryEvent.swap``).

    ``adapt`` is an optional ``repro_torch.adapt.AdaptConfig``: every
    round's realized per-worker completion times feed an
    ``AdaptiveController``, which hands back a new plan when drift makes
    re-planning pay; ``swap_plan`` installs it at the step boundary
    (optimizer state, RNG stream and step count untouched).

    ``wave`` is an optional ``repro_torch.train.wave.WaveConfig``: ``run``
    then executes rounds on the wave-pipelined schedule of the event
    simulator (staleness 0 bit-identical to the barrier loop).

    On a mesh with a ``model`` axis the trainer holds this rank's shards
    of the initial parameters and their moments (``init_shards``: the
    full tree never lies on the device) and binds the plan — the
    tuner's, the controller's re-plans — to the full tree's shapes (a
    meta model); every model rank of a data index takes that worker's
    batches.  Checkpoints hold the reference's full tree there too, in
    the one format: saved from rank 0's model group's gathered leaves,
    restored from rank 0's broadcast of each full leaf, so a checkpoint
    written at one ``model`` size resumes at any other.

    ``scheme="auto"`` searches the joint launch space with
    ``repro_torch.tune.autotune`` (optionally under a ``budget=MemBudget``;
    the ``mc`` backend of a non-i.i.d. env runs on ``device``; in spmd
    every rank searches, and one broadcast checks that every rank's
    winner is rank 0's): the
    winning candidate sets the plan AND every step knob the caller left
    at its open default — ``pipeline`` ('auto'), ``reduce_mode`` ('psum'),
    ``grad_dtype`` (None; the tuner's 'fp32' or 'bf16') — and the search
    record lands on ``self.tune_report``.  ``budget`` without ``"auto"``
    raises ``ValueError``.
    """

    def __init__(self, cfg, cfg_t: TrainConfig, env, *, n_workers: int = None,
                 scheme: str = "xf", global_batch: int = 32, seed: int = 0,
                 mesh=None, mode: str = "sim", data_kind: str = "zipf",
                 pipeline: str = "auto", adapt=None, wave=None, ckpt=None,
                 budget=None, reduce_mode: str = "psum", grad_dtype=None,
                 device="cuda", params=None, seq_len: int = None):
        if mode == "spmd":
            if mesh is None:
                raise ValueError("mode='spmd' needs a mesh "
                                 "(repro_torch.launch.mesh.make_local_mesh)")
            if torch.device(device).type != mesh.device.type:
                raise ValueError(f"device={device!r}, but the mesh runs on {mesh.device}")
            device = mesh.device
        elif mode == "sim":
            mesh = None
        else:
            raise ValueError(f"unknown mode {mode!r}; expected 'sim' or 'spmd'")
        if n_workers is None:
            if isinstance(env, Env):
                n_workers = env.n_workers
            elif isinstance(env, (list, tuple)):
                n_workers = len(env)
            else:
                n_workers = 8  # bare distribution: the reference's default
        env = Env.coerce(env, n_workers)
        self.cfg, self.cfg_t = cfg, cfg_t
        self.env = env
        self.n_workers = n_workers
        self.mesh, self.mode, self.pipeline = mesh, mode, pipeline
        self.device = torch.device(device)
        self.reduce_mode, self.grad_dtype = reduce_mode, grad_dtype
        self.tune_report = None
        seq_len = min(cfg.max_seq, 512) if seq_len is None else seq_len
        self.state = init_train_state(cfg, device=device, seed=seed, params=params, mesh=mesh)
        # plans bind the full tree's leaves; a rank holds its shards
        sharded = self.state.params.tp is not None or self.state.params.fsdp is not None
        tree = GCLM(cfg, device="meta") if sharded else self.state.params
        if scheme == "auto":
            # model-aware search: the winner sets the plan AND the step
            # knobs (pipeline/reduce_mode/grad_dtype) the user left open
            from ..tune import autotune  # deferred: tune imports train.state

            res = autotune(cfg, env, budget, global_batch=global_batch,
                           seq_len=seq_len, seed=seed, device=device)
            self.plan = res.plan
            self.tune_report = res.report
            best = res.best
            if pipeline == "auto":
                self.pipeline = best.pipeline
            if reduce_mode == "psum":       # the open default
                self.reduce_mode = best.reduce_mode
            if grad_dtype is None:
                self.grad_dtype = best.grad_dtype
            if mesh is not None:  # a deterministic search: every rank's winner is rank 0's
                knobs = [self.pipeline, self.reduce_mode, str(self.grad_dtype)]
                check_replicated(hashlib.sha256(json.dumps(
                    [self.plan.to_dict(), knobs], sort_keys=True).encode()).digest(),
                    mesh.device, "the tuned plan", mesh.world_group)
        elif budget is not None:
            raise ValueError("budget= requires scheme='auto'")
        else:
            self.plan = Plan.build(tree, env, scheme=scheme, rng=seed)
        self.sim = self.plan.simulator(env, seed=seed)
        self.data = SyntheticTokens(DataConfig(
            vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch, seed=seed,
            kind=data_kind))
        self.step_fn = self._step_fn_for(self.plan)
        self.controller = None
        if adapt is not None:
            self.controller = AdaptiveController(adapt, self.plan, tree)
        self.history: list = []
        self.recoveries: list = []
        self.manager = self.deathwatch = None
        if ckpt is not None:
            self.manager = CheckpointManager(ckpt)
            if n_workers >= 2:
                self.deathwatch = DeathWatch(n_workers)
            if ckpt.resume and self.manager.latest() is not None:
                self.restore_checkpoint()
        self.wave = None
        if wave is not None:
            from .wave import WaveRunner  # wave.py imports this module

            self.wave = WaveRunner(self, wave)

    def _step_fn_for(self, plan: Plan) -> Callable:
        # the tuner names its gradient dtypes 'fp32' and 'bf16'
        grad_dtype = {"fp32": None, "bf16": torch.bfloat16}.get(self.grad_dtype, self.grad_dtype)
        return make_coded_train_step(self.cfg, self.cfg_t, plan, mode=self.mode, mesh=self.mesh,
                                     reduce_mode=self.reduce_mode, grad_dtype=grad_dtype,
                                     pipeline=self.pipeline)

    def check_draw(self, dec_w, times) -> None:
        """spmd: raise unless this rank's straggler draw (decode weights
        and round times) is rank 0's — one broadcast of a digest.  Every
        rank's plan, decisions and ledger rest on identical draws."""
        if self.mesh is not None:
            digest = hashlib.sha256(np.asarray(dec_w, np.float64).tobytes()
                                    + np.asarray(times, np.float64).tobytes()).digest()
            check_replicated(digest, self.mesh.device, "the straggler draw",
                             self.mesh.world_group)

    def restore_checkpoint(self, missing=()) -> int:
        """Restore the newest checkpoint into the state, treating the shards
        ``missing`` as lost (a coded checkpoint decodes from the survivors);
        returns its step.  One process — in spmd rank 0 alone — reads and
        decodes it (the survivors' encode on the state's device; the
        loader checks every crc32) and fills the state one full leaf at a
        time (``TrainState.fill_from_full``); in spmd rank 0 broadcasts
        each leaf and every rank keeps its shard.  The reader then checks
        its state against the decoded leaves, cut as it holds them, and in
        spmd every rank checks its state against the data ranks of its
        model index (``TrainState.replicated_digest``: what they hold
        alike, when the state is cut over ``data``) and the pod ranks of
        its (data, model) index."""
        mesh, arrays = self.mesh, None
        if mesh is None or mesh.rank == 0:
            arrays, _ = self.manager.load(missing=missing, device=self.device)

        def source(key, shape, dtype):
            if arrays is None:  # rank 0's leaf
                return broadcast(torch.empty(shape, dtype=dtype, device=self.device),
                                 mesh.world_group)
            # contiguous: a broadcast sends the storage in memory order, and a
            # leaf gathered on a later dimension is saved transposed (Fortran
            # order) and loads so
            value = torch.as_tensor(arrays[key]).to(dtype).contiguous()
            if tuple(value.shape) != shape:
                raise ValueError(f"{key}: checkpoint shape {tuple(value.shape)}, the state's "
                                 f"full leaf {shape}")
            return value if mesh is None else broadcast(value.to(self.device), mesh.world_group)

        self.state = self.state.fill_from_full(source)
        if arrays is not None:
            on = self.state._mesh()
            for key, leaf, dim, blocks, ddim in self.state._leaf_cuts():
                got = torch.as_tensor(leaf).detach().cpu()
                want = cut_leaf(torch.as_tensor(arrays.pop(key)).to(got.dtype), on, dim, blocks,
                                ddim)
                if not torch.equal(_bytes_of(got), _bytes_of(want)):
                    raise RuntimeError(f"{key}: the restored state differs from the decoded "
                                       "checkpoint")
            if arrays:
                raise ValueError(f"the checkpoint holds leaves the state lacks: {sorted(arrays)}")
        if mesh is not None:
            check_replicated(self.state.replicated_digest(), mesh.device, "the restored state",
                             mesh.data_group)
            if mesh.pod_group is not None:
                check_replicated(self.state.digest(), mesh.device, "the restored state",
                                 mesh.pod_group)
        return int(self.state.step)

    def save_checkpoint(self):
        """Checkpoint the state now, with the plan; returns the path.  The
        reference's full tree streams to the checkpoint one leaf at a time
        (``TrainState.full_leaves``).  In spmd rank 0 writes while the
        other ranks wait at a barrier (their path is ``None``): on a
        ``model`` axis its model group gathers each leaf to it (the other
        data replicas hold the same bytes); a state cut over ``data``
        gathers each cut leaf over the data groups of pod 0 first (the
        other pods hold the same slices)."""
        step, path, mesh = int(self.state.step), None, self.mesh
        over_data = self.state.params.fsdp is not None
        if mesh is None or (mesh.pod_index == 0 and (mesh.data_index == 0 or over_data)):
            writer = mesh is None or mesh.rank == 0
            leaves = self.state.full_leaves(host=writer)
            if writer:
                path = self.manager.save(step, leaves, extra={"plan": self.plan.to_dict()},
                                         device=self.device)
            else:  # rank 0's groups: their gathers pair up with rank 0's
                for _ in leaves:
                    pass
        if mesh is not None:
            if mesh.rank != 0:
                self.manager.last_saved = step
            dist.barrier()
        return path

    def _maybe_save(self) -> None:
        if self.manager is not None and self.manager.due(int(self.state.step)):
            self.save_checkpoint()

    def swap_plan(self, plan: Plan) -> None:
        """Hot-swap the coding plan at a step boundary: optimizer state,
        data stream, RNG stream and step count are untouched; only the
        plan the next step codes against changes (the simulator keeps
        its env, rng and ledger and prices future rounds with it).  A
        swap the controller did not initiate re-baselines the controller
        too.  The port runs eagerly: the new step function is built
        anew, with nothing to compile."""
        if plan.n_workers != self.n_workers:
            raise ValueError(f"plan has {plan.n_workers} workers, trainer "
                             f"runs {self.n_workers}")
        self.plan = plan
        self.sim.plan = plan
        if self.controller is not None and self.controller.plan is not plan:
            self.controller.plan = plan
            self.controller.monitor.reset()
        self.step_fn = self._step_fn_for(plan)

    def recover_from_deaths(self, newly_dead, log_fn=None):
        """Worker-death recovery: a forced re-plan when a controller runs
        (routes future work off the dead workers), then a restore from
        the surviving shards of the last checkpoint (the dead workers'
        shards count as lost), rewinding the state.  Returns the
        ``RecoveryEvent``, or ``None`` when there is no checkpoint
        (training continues on gradient-level redundancy).  The data
        stream is keyed by ``state.step``, so the rewound steps replay
        deterministically under the new plan.  ``run`` calls it when its
        ``DeathWatch`` trips, so every worker that watch holds dead counts
        as lost."""
        dead = tuple(sorted(self.deathwatch.dead))
        detected_at = int(self.state.step)
        swap = None
        if self.controller is not None:
            new_plan = self.controller.replan_now()
            if new_plan is not None:
                swap = self.controller.swaps[-1]
                self.swap_plan(new_plan)
        if self.manager.latest() is None:
            if log_fn:
                log_fn(f"step {detected_at:5d}  worker death {list(newly_dead)}"
                       " — no checkpoint to restore; continuing on redundancy")
            return None
        ckpt_step = self.restore_checkpoint(missing=dead)
        ev = RecoveryEvent(step=detected_at, dead_workers=dead,
                           ckpt_step=ckpt_step, swap=swap)
        self.recoveries.append(ev)
        if log_fn:
            log_fn(f"step {detected_at:5d}  worker death {list(newly_dead)} -> "
                   f"re-plan{' + swap' if swap else ' skipped'}, coded restore "
                   f"from survivors @ step {ckpt_step}")
        return ev

    def run(self, n_steps: int, log_every: int = 10, log_fn=print):
        """Run ``n_steps`` steps (barrier, or the wave schedule when the
        trainer has one); returns (state, ledger summary).  Like the
        reference's, the loop feeds tokens only, so a model with a
        cross-attention source raises: drive ``make_coded_train_step``
        with ``worker_aux`` instead."""
        if has_source(self.cfg):
            raise ValueError(f"{self.cfg.name} cross-attends to a source, and Trainer.run "
                             "feeds tokens only: call make_coded_train_step's step with "
                             "worker_aux")
        if self.wave is not None:
            return self.wave.run(n_steps, log_every, log_fn)
        for i in range(n_steps):
            wb = coded_worker_batches(self.data, int(self.state.step),
                                      self.n_workers, self.plan.s_max)
            dec_w, rec = self.sim.step()
            self.check_draw(dec_w, rec["times"])
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, wb, dec_w)
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics.update(step=int(self.state.step),
                           wall_s=time.perf_counter() - t0,
                           tau_coded=rec["tau_coded"],
                           tau_uncoded=rec["tau_uncoded"])
            if self.controller is not None:
                new_plan = self.controller.observe(rec["times"])
                if new_plan is not None:
                    self.swap_plan(new_plan)
                    metrics["plan_swap"] = 1
                    if log_every:
                        log_fn(f"step {metrics['step']:5d}  plan swap -> "
                               f"x={new_plan.x.tolist()} (predicted gain "
                               f"{self.controller.swaps[-1].predicted_gain:.1%})")
            if self.deathwatch is not None:
                newly = self.deathwatch.observe(rec["times"])
                if newly:
                    ev = self.recover_from_deaths(newly, log_fn if log_every else None)
                    if ev is not None:
                        metrics["recovery"] = 1
                        metrics["recovery_ckpt_step"] = ev.ckpt_step
            self._maybe_save()
            self.history.append(metrics)
            if log_every and (i % log_every == 0 or i == n_steps - 1):
                log_fn(f"step {metrics['step']:5d}  loss {metrics['loss']:.4f}  "
                       f"tau_coded {metrics['tau_coded']:.3g}  "
                       f"tau_uncoded {metrics['tau_uncoded']:.3g}")
        return self.state, self.sim.summary()
