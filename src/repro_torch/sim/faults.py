"""Fault realization for the coded-cluster simulator, copied from
``repro/sim/faults.py``.

The declarative fault vocabulary (``WorkerDeath``, ``DegradedWorker``)
lives in ``repro_torch.core.env`` and is re-exported here.  This module
keeps the realizations: ``apply_faults`` maps (times, faults) onto a
drawn (rounds, N) cycle-time matrix before the event engine runs, so a
faulted run stays a pure function of (schedule, times, faults) and
replays exactly from a trace; ``torn_write``, ``flip_bit`` and
``drop_shard`` damage one file at rest the way a crash mid-write, silent
media corruption and a dead worker's lost disk would (the erasure-coded
checkpoint's fault injectors); ``heterogeneous`` builds a per-worker
distribution list (``Env.heterogeneous`` is the first-class way).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.env import DegradedWorker, WorkerDeath

__all__ = ["WorkerDeath", "DegradedWorker", "apply_faults", "drop_shard",
           "flip_bit", "heterogeneous", "torn_write"]


def apply_faults(times: np.ndarray, faults: Sequence):
    """(times, faults) -> (times', deaths).

    ``times'`` is a copy with degradations applied; ``deaths`` maps
    worker index -> (death_time, death_round) for the event engine
    (np.inf where the axis is unused).
    """
    times = np.array(times, np.float64, copy=True)
    rounds, n = times.shape
    deaths: dict = {}
    for f in faults:
        if isinstance(f, DegradedWorker):
            if not (0 <= f.worker < n):
                raise ValueError(f"DegradedWorker.worker {f.worker} out of range")
            times[f.from_round:, f.worker] *= f.factor
        elif isinstance(f, WorkerDeath):
            if not (0 <= f.worker < n):
                raise ValueError(f"WorkerDeath.worker {f.worker} out of range")
            at_t = np.inf if f.at_time is None else float(f.at_time)
            at_r = np.inf if f.at_round is None else int(f.at_round)
            prev = deaths.get(f.worker, (np.inf, np.inf))
            deaths[f.worker] = (min(prev[0], at_t), min(prev[1], at_r))
        else:
            raise TypeError(f"unknown fault {f!r}")
    return times, deaths


# ------------------------------------------------------- storage faults
# Filesystem-level fault injection for the erasure-coded checkpoint
# (repro_torch.checkpoint.coded): the same realize-the-fault philosophy as
# apply_faults, applied to bytes at rest instead of cycle times.  Each
# injector deterministically damages one file the way a real failure
# would — a crash mid-write tears the tail off, cosmic rays / bad DIMMs
# flip bits, a dead worker's disk simply vanishes — so tests and
# benchmarks can assert the decode path degrades exactly as designed
# (crc catches the flip, the torn/missing shard demotes to "lost", any
# N - s survivors still restore bit-exactly).

def torn_write(path: str, keep_fraction: float = 0.5) -> None:
    """Truncate ``path`` to ``keep_fraction`` of its bytes: a writer
    killed mid-write (the file exists, its tail never hit the disk)."""
    import os

    if not 0.0 <= keep_fraction < 1.0:
        raise ValueError("keep_fraction must be in [0, 1)")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(int(size * keep_fraction))


def flip_bit(path: str, byte_offset: int, bit: int = 0) -> None:
    """Flip one bit of ``path`` in place (silent media corruption —
    the shard stays readable, its crc32 no longer matches)."""
    if not 0 <= bit < 8:
        raise ValueError("bit must be in [0, 8)")
    with open(path, "r+b") as f:
        f.seek(byte_offset)
        b = f.read(1)
        if not b:
            raise ValueError(f"byte_offset {byte_offset} past end of {path}")
        f.seek(byte_offset)
        f.write(bytes([b[0] ^ (1 << bit)]))


def drop_shard(path: str) -> None:
    """Delete ``path``: the dead worker's local shard is simply gone."""
    import os

    os.remove(path)


def heterogeneous(dist, n_workers: int, slow_workers: dict):
    """Per-worker distribution list: ``dist`` everywhere, except worker
    j gets ``slow_workers[j]`` (a replacement distribution).

        dists = heterogeneous(fast, 8, {7: ShiftedExponential(mu=1e-4)})
        ClusterSim(schedule, dists, 8).run(...)

    Legacy helper — ``Env.heterogeneous(dists)`` is the first-class way
    to say this (and reaches the solvers, not just the simulator).
    """
    out = [dist] * n_workers
    for j, d in slow_workers.items():
        if not (0 <= j < n_workers):
            raise ValueError(f"slow worker {j} out of range")
        out[j] = d
    return out
