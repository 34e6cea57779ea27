"""Batched Monte-Carlo backend of the cluster simulator, in torch.

After ``repro/sim/mc.py``, which evaluates the decode-time model of the
event engine as a jitted ``vmap``.  Here the same model runs as a few
batched tensor operations, on the card by default: block b of a
realization decodes at ``scale * T_(N - s_b) * W_b`` (the (N - s_b)-th
fastest cycle time times the block's cumulative work), and a round lasts
as long as its slowest block.  The draws come from the simulator's numpy
stream (``draw_times``), so the realizations are the event engine's and
the ``eq2`` backend's; they are copied to the device, sorted along the
worker axis, gathered at ``T_(N-1-level)``, scaled, reduced by a max over
blocks and, for ``(S, R, N)`` input, summed over the R barrier rounds.

The arithmetic is fp32, as the reference's jitted function runs in jax's
default fp32: results agree with the fp64 backends to ~1e-4 relative,
not bitwise.  Wave pipelining and fault injection are event-driven — use
``ClusterSim`` for those.

Every entry point takes ``device`` (default ``"cuda"``, which raises
without CUDA; the tests pass ``"cpu"``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.runtime import CostModel, DEFAULT_COST
from ..device import resolve_device
from .cluster import Block, draw_times, schedule_from_plan, schedule_from_x

__all__ = ["runtime_batch", "decode_times_batch", "expected_runtime", "as_schedule"]


def as_schedule(target, n_workers: Optional[int] = None) -> tuple:
    """Normalize a schedule / Plan / eq.(5) x-vector to tuple[Block, ...]."""
    if isinstance(target, (tuple, list)) and target and isinstance(target[0], Block):
        return tuple(target)
    if hasattr(target, "leaf_levels"):  # a Plan
        return schedule_from_plan(target)
    return schedule_from_x(np.asarray(target, np.float64))


def _decode_times(schedule, times_batch, cost: CostModel, device) -> torch.Tensor:
    """(..., N) realizations -> (..., n_blocks) fp32 decode times on
    ``device``."""
    schedule = tuple(schedule)
    times_batch = np.asarray(times_batch, np.float64)
    n_workers = times_batch.shape[-1]
    levels = np.asarray([b.level for b in schedule], np.int64)
    if levels.size and int(levels.max()) >= n_workers:
        raise ValueError(
            f"block level {int(levels.max())} >= n_workers {n_workers}: "
            "schedule and realizations disagree on the cluster size")
    dev = resolve_device(device)
    t = torch.as_tensor(times_batch.astype(np.float32), device=dev)
    works = torch.as_tensor(np.asarray([b.work for b in schedule], np.float32), device=dev)
    idx = torch.as_tensor(n_workers - 1 - levels, device=dev)
    t_term = torch.sort(t, dim=-1).values.index_select(-1, idx)  # T_(N - s_b) per block
    # the reference's scale is a weakly typed python float: rounded to fp32
    return float(np.float32(cost.scale(n_workers))) * t_term * works


def decode_times_batch(schedule, times_batch, *, cost: CostModel = DEFAULT_COST,
                       device="cuda") -> np.ndarray:
    """(S, N) realizations -> (S, n_blocks) absolute decode times."""
    return _decode_times(schedule, times_batch, cost, device).cpu().numpy().astype(np.float64)


def runtime_batch(schedule, times_batch, *, cost: CostModel = DEFAULT_COST,
                  device="cuda") -> np.ndarray:
    """Per-realization round runtime (max decode time).

    ``times_batch``: (S, N) for single rounds -> (S,); (S, R, N) for
    R-round barrier totals -> (S,) sums of per-round maxima.
    """
    ndim = np.ndim(times_batch)
    if ndim not in (2, 3):
        raise ValueError(f"times_batch must be (S,N) or (S,R,N), "
                         f"got {np.shape(times_batch)}")
    out = _decode_times(schedule, times_batch, cost, device).amax(dim=-1)
    if ndim == 3:
        out = out.sum(dim=-1)
    return out.cpu().numpy().astype(np.float64)


def expected_runtime(target, dist, n_workers: int, *, n_samples: int = 20_000,
                     rounds: int = 1, seed: int = 0, cost: CostModel = DEFAULT_COST,
                     device="cuda") -> dict:
    """Monte-Carlo expected runtime of a Plan / x-vector / schedule.

    Returns mean, std, and the standard error of the mean so callers
    can assert statistical agreement (e.g. vs ``expected_tau_hat``)
    with an explicit tolerance.
    """
    schedule = as_schedule(target, n_workers)
    rng = np.random.default_rng(seed)
    if rounds == 1:
        times = draw_times(dist, rng, n_samples, n_workers)
    else:
        flat = draw_times(dist, rng, n_samples * rounds, n_workers)
        times = flat.reshape(n_samples, rounds, n_workers)
    samples = runtime_batch(schedule, times, cost=cost, device=device)
    mean = float(samples.mean())
    std = float(samples.std(ddof=1)) if n_samples > 1 else 0.0
    return {
        "mean": mean,
        "std": std,
        "sem": std / np.sqrt(n_samples),
        "n_samples": int(n_samples),
        "rounds": int(rounds),
    }
