"""The coded training step and the barrier ``Trainer``, after
``repro/train/trainer.py``.

``make_coded_train_step`` — coded per-shard gradients, the fused flat
combine, then clip, AdamW and the cosine LR.  The decode weights (the
straggler realization) are a per-step input sampled host-side by the
plan's numpy simulator, so the ledger is the reference's, draw for draw.

``Trainer`` — the loop: data, straggler simulation, ledger, metrics,
checkpoints (plain or erasure-coded) and worker-death recovery.
Adaptive re-planning, the wave-pipelined loop, spmd mode and
``scheme="auto"`` raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import torch

from ..adapt import DeathWatch, RecoveryEvent
from ..checkpoint.manager import CheckpointManager
from ..core import Env, Plan
from ..data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
from ..models.model import train_loss
from ..optim.optim import adamw_update, clip_by_global_norm, cosine_schedule
from .coded import make_coded_grad_fn
from .state import TrainState, init_train_state

__all__ = ["TrainConfig", "make_coded_train_step", "Trainer"]


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
    grads, gnorm = clip_by_global_norm(grads, cfg_t.clip_norm)
    opt = adamw_update(grads, state.opt, state.params.leaves(), lr,
                       b1=cfg_t.b1, b2=cfg_t.b2, weight_decay=cfg_t.weight_decay)
    metrics = dict(metrics, grad_norm=gnorm, lr=lr)
    return TrainState(params=state.params, opt=opt, step=state.step + 1), metrics


def make_coded_train_step(cfg, cfg_t: TrainConfig, plan: Plan, *,
                          mode: str = "sim", pipeline: str = "flat") -> Callable:
    """step(state, worker_batches, dec_w) -> (state, metrics); the
    parameters and optimizer moments are updated in place."""
    grad_fn = make_coded_grad_fn(cfg, plan, mode=mode, pipeline=pipeline)

    def step(state: TrainState, worker_batches, dec_w):
        grads = grad_fn(state.params, worker_batches, dec_w)
        # monitoring loss on shard 0 with the pre-update parameters
        with torch.no_grad():
            _, metrics = train_loss(cfg, state.params,
                                    {"tokens": worker_batches[0, 0]})
        return _apply_update(cfg_t, state, grads, metrics)

    return step


class Trainer:
    """End-to-end coded-training driver in sim mode (one device).

    ``env`` is the worker population (an ``Env`` or a bare distribution
    with ``n_workers``).  ``params`` optionally carries initial parameters
    as a reference tree of numpy arrays; otherwise they are drawn from
    ``seed``.  ``seq_len`` defaults to the reference's
    ``min(cfg.max_seq, 512)``.  ``device`` defaults to CUDA and raises
    when CUDA is absent.

    ``ckpt`` is an optional ``repro_torch.checkpoint.CkptConfig``: the
    trainer then checkpoints every ``ckpt.every`` steps at step
    boundaries (erasure-coded across the workers when ``ckpt.coded`` is
    set), resumes from the newest intact checkpoint on construction
    (``ckpt.resume``), and arms
    worker-death recovery: a ``DeathWatch`` over the realized round times
    triggers a restore from the surviving shards, recorded as a
    ``RecoveryEvent`` in ``self.recoveries``.  Without the adaptive
    controller (ROADMAP 1.8) recovery does no re-plan (``swap=None``),
    exactly as the reference does without one.
    """

    def __init__(self, cfg, cfg_t: TrainConfig, env, *, n_workers: int = None,
                 scheme: str = "xf", global_batch: int = 32, seed: int = 0,
                 mode: str = "sim", data_kind: str = "zipf",
                 pipeline: str = "flat", adapt=None, wave=None, ckpt=None,
                 budget=None, grad_dtype=None, device="cuda", params=None,
                 seq_len: int = None):
        for name, value, item in (("adapt", adapt, "1.8"), ("wave", wave, "1.8"),
                                  ("budget", budget, "1.11"),
                                  ("grad_dtype", grad_dtype, "1.6")):
            if value is not None:
                raise NotImplementedError(f"Trainer({name}=...) is not ported "
                                          f"yet (ROADMAP {item})")
        if scheme == "auto":
            raise NotImplementedError("scheme='auto' (the autotuner) is not "
                                      "ported yet (ROADMAP 1.11)")
        if mode != "sim":
            raise NotImplementedError(f"mode={mode!r} is not ported yet "
                                      "(ROADMAP 1.6)")
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
        self.state = init_train_state(cfg, device=device, seed=seed, params=params)
        self.plan = Plan.build(self.state.params, env, scheme=scheme, rng=seed)
        self.sim = self.plan.simulator(env, seed=seed)
        self.data = SyntheticTokens(DataConfig(
            vocab=cfg.vocab,
            seq_len=min(cfg.max_seq, 512) if seq_len is None else seq_len,
            global_batch=global_batch, seed=seed, kind=data_kind))
        self.step_fn = make_coded_train_step(cfg, cfg_t, self.plan, mode=mode,
                                             pipeline=pipeline)
        self.history: list = []
        self.recoveries: list = []
        self.manager = self.deathwatch = None
        if ckpt is not None:
            self.manager = CheckpointManager(ckpt)
            if n_workers >= 2:
                self.deathwatch = DeathWatch(n_workers)
            if ckpt.resume:
                restored = self.manager.restore_latest(self.state)
                if restored is not None:
                    self.state = restored[0]

    def recover_from_deaths(self, newly_dead, log_fn=None):
        """Worker-death recovery: restore from the surviving shards of the
        last checkpoint (the dead workers' shards count as lost), rewinding
        the state.  Returns the ``RecoveryEvent``, or ``None`` when there is
        no checkpoint (training continues on gradient-level redundancy).
        The data stream is keyed by ``state.step``, so the rewound steps
        replay deterministically.  ``run`` calls it when its ``DeathWatch``
        trips, so every worker that watch holds dead counts as lost."""
        dead = tuple(sorted(self.deathwatch.dead))
        detected_at = int(self.state.step)
        if self.manager.latest() is None:
            if log_fn:
                log_fn(f"step {detected_at:5d}  worker death {list(newly_dead)}"
                       " — no checkpoint to restore; continuing on redundancy")
            return None
        self.state, ckpt_step = self.manager.restore_from_survivors(
            self.state, missing=dead)
        ev = RecoveryEvent(step=detected_at, dead_workers=dead,
                           ckpt_step=ckpt_step, swap=None)
        self.recoveries.append(ev)
        if log_fn:
            log_fn(f"step {detected_at:5d}  worker death {list(newly_dead)} -> "
                   f"re-plan skipped, coded restore from survivors @ step {ckpt_step}")
        return ev

    def run(self, n_steps: int, log_every: int = 10, log_fn=print):
        """Run ``n_steps`` barrier steps; returns (state, ledger summary)."""
        for i in range(n_steps):
            wb = coded_worker_batches(self.data, int(self.state.step),
                                      self.n_workers, self.plan.s_max)
            dec_w, rec = self.sim.step()
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, wb, dec_w)
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics.update(step=int(self.state.step),
                           wall_s=time.perf_counter() - t0,
                           tau_coded=rec["tau_coded"],
                           tau_uncoded=rec["tau_uncoded"])
            if self.deathwatch is not None:
                newly = self.deathwatch.observe(rec["times"])
                if newly:
                    ev = self.recover_from_deaths(newly, log_fn if log_every else None)
                    if ev is not None:
                        metrics["recovery"] = 1
                        metrics["recovery_ckpt_step"] = ev.ckpt_step
            if self.manager is not None:
                self.manager.maybe_save(int(self.state.step), self.state,
                                        extra={"plan": self.plan.to_dict()})
            self.history.append(metrics)
            if log_every and (i % log_every == 0 or i == n_steps - 1):
                log_fn(f"step {metrics['step']:5d}  loss {metrics['loss']:.4f}  "
                       f"tau_coded {metrics['tau_coded']:.3g}  "
                       f"tau_uncoded {metrics['tau_uncoded']:.3g}")
        return self.state, self.sim.summary()
