"""Per-request serving state, copied from ``repro/serve/request.py``.

A ``Request`` is the unit the continuous-batching scheduler moves
through the engine: queued on ``ServeEngine.submit``, admitted into a
KV-slab slot when one frees up (prefill), decoded one token per engine
step alongside whatever else occupies the slab, and evicted at
``max_new`` tokens.

Timestamps are in the engine's *simulated* clock — the time stream the
coded decode tier prices from the ``Env`` straggler model (see
``repro_torch.serve.coded``), so queueing delay and tail latency are
measured in the same units eq. (5) prices training rounds in.

Determinism contract: a request's sampled token stream is a pure
function of (its prompt, its ``seed``, the shared params) — independent
of batch composition and slot.  The reference carries a ``jax.random``
key whose ``fold_in`` stream torch cannot reproduce; here token j is
sampled with Gumbel noise from a generator seeded by
``fold_seed(seed, j)`` (``repro_torch.serve.engine``).  Greedy decoding
(temperature <= 0) draws nothing and matches the reference.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

__all__ = ["Request", "QUEUED", "RUNNING", "DONE"]

QUEUED = "queued"
RUNNING = "running"
DONE = "done"

_ids = itertools.count()


@dataclass
class Request:
    """One generation request moving through the serving engine."""

    prompt: np.ndarray                 # (S,) int32 prompt tokens
    max_new: int
    temperature: float = 0.0
    seed: int = 0                      # sampling stream (temperature > 0)
    priority: int = 0                  # lower value = served first
    arrival: float = 0.0               # simulated arrival time

    # ---- lifecycle (engine-managed)
    uid: int = field(default_factory=lambda: next(_ids))
    state: str = QUEUED
    slot: Optional[int] = None         # KV-slab row while RUNNING
    tokens: list = field(default_factory=list)   # generated token ids
    t_admit: Optional[float] = None    # simulated admission (prefill) time
    t_first: Optional[float] = None    # simulated first-token time
    t_done: Optional[float] = None     # simulated completion time
    n_steps: int = 0                   # decode steps while this req was live

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new < 1:
            raise ValueError("max_new must be >= 1")

    # ------------------------------------------------------------- queries
    @property
    def done(self) -> bool:
        return self.state == DONE

    @property
    def output(self) -> np.ndarray:
        """(S + generated,) prompt followed by the generated tokens."""
        return np.concatenate([self.prompt, np.asarray(self.tokens, np.int32)])

    @property
    def queue_delay(self) -> Optional[float]:
        """Simulated time spent waiting for a slab slot."""
        return None if self.t_admit is None else self.t_admit - self.arrival

    @property
    def latency(self) -> Optional[float]:
        """Simulated submit-to-completion latency."""
        return None if self.t_done is None else self.t_done - self.arrival

    def summary(self) -> dict:
        return {
            "uid": self.uid,
            "state": self.state,
            "prompt_len": int(self.prompt.size),
            "generated": len(self.tokens),
            "priority": self.priority,
            "arrival": self.arrival,
            "queue_delay": self.queue_delay,
            "latency": self.latency,
        }
