"""Serving subsystem: continuous batching + coded decode tier, after
``repro.serve``.

Request flow: ``ServeEngine.submit`` -> priority/FIFO admission
(``Scheduler``) into a shared batched KV slab (``slab``), written in
place -> lockstep decode priced per step by a redundancy-replicated
``CodedDecode`` tier whose (R, s) is solved against an ``Env`` straggler
model (``solve_replication``).  The reference's ``trace_counts`` and
``clear_jit_cache`` count jit retraces; the port is eager and has none.
"""
from .coded import CodedDecode, ReplicationPlan, solve_replication
from .engine import (ServeConfig, ServeEngine, fold_seed, generate, make_serve_step,
                     restore_plan)
from .request import DONE, QUEUED, RUNNING, Request
from .scheduler import Scheduler
from .slab import caches_from_numpy, caches_to_numpy, insert_request, make_slab

__all__ = [
    "CodedDecode", "ReplicationPlan", "solve_replication",
    "ServeConfig", "ServeEngine", "fold_seed", "generate", "make_serve_step",
    "restore_plan", "Request", "QUEUED", "RUNNING", "DONE",
    "Scheduler", "caches_from_numpy", "caches_to_numpy", "insert_request", "make_slab",
]
