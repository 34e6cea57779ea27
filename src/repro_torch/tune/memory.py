"""Per-candidate device-memory model of the autotuner, copied from
``repro/tune/memory.py``.

Pricing a (scheme, s_cap, pipeline, reduce_mode, grad_dtype) candidate
must not allocate device memory, so everything here is numpy on the
plan's ``FlatLayout`` and the model config:

  * parameters / optimizer state from the layout's leaf shapes (AdamW:
    two fp32 moments per parameter);
  * per-shard gradients from the packed level buffers — the coded step
    materializes ``K = s_max + 1`` per-shard gradient stacks, which is
    why redundancy costs memory and why a cap constrains ``s_max``;
  * the reduce buffer: ``psum`` holds the full packed gradient on every
    worker, ``psum_scatter`` holds the 1/N shard;
  * activations from the model config (rows x seq x d_model x layers in
    the compute dtype, with a remat discount and the fp32 logits
    buffer), one shard at a time.

The estimate is per worker, as the reference's is.

``analyze_memory`` is the counterpart of the reference's
``analyze_memory_from_hlo``: the bytes of a step's arguments and
outputs, from the call itself rather than from HLO, and on CUDA the
allocator's peak over the call.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["MemBudget", "MemEstimate", "estimate_memory", "analyze_memory", "tree_bytes"]

#: bytes/element of the two supported coded-gradient dtypes
GRAD_DTYPE_BYTES = {"fp32": 4, "bf16": 2}

#: activations kept per layer, as a multiple of the (rows, seq, d_model)
#: residual block, in compute dtype — attention + FFN intermediates.
ACT_FACTOR = 6.0

#: remat discount on stored activations ('dots' recomputes the matmul
#: outputs, 'full' recomputes whole layers backward-on-demand)
REMAT_FACTOR = {"none": 1.0, "dots": 0.5, "full": 0.25}


@dataclass(frozen=True)
class MemBudget:
    """Per-worker device-memory cap the autotuner prunes against."""

    hbm_bytes: float
    label: str = ""

    @classmethod
    def from_gb(cls, gb: float, label: str = "") -> "MemBudget":
        return cls(hbm_bytes=float(gb) * 2**30,
                   label=label or f"{gb:g} GiB")

    def __str__(self) -> str:
        return self.label or f"{self.hbm_bytes / 2**30:.2f} GiB"


@dataclass
class MemEstimate:
    """Analytic per-worker HBM breakdown of one tuning candidate."""

    params_bytes: float = 0.0
    opt_bytes: float = 0.0
    grad_bytes: float = 0.0       # K stacked per-shard packed gradients
    reduce_bytes: float = 0.0     # combine/reduction working buffer
    act_bytes: float = 0.0        # activations + logits, one shard live
    detail: dict = field(default_factory=dict)

    @property
    def total(self) -> float:
        return (self.params_bytes + self.opt_bytes + self.grad_bytes
                + self.reduce_bytes + self.act_bytes)

    def to_dict(self) -> dict:
        return {
            "params_bytes": self.params_bytes,
            "opt_bytes": self.opt_bytes,
            "grad_bytes": self.grad_bytes,
            "reduce_bytes": self.reduce_bytes,
            "act_bytes": self.act_bytes,
            "total_bytes": self.total,
            **({"detail": self.detail} if self.detail else {}),
        }


def _packed_elems(plan) -> tuple[float, float]:
    """(raw param elements, packed/padded buffer elements) of a plan.

    Prefers the ``FlatLayout`` level buffers (lane + N padding included);
    a plan built from a bare cost vector has no layout, so the raw leaf
    cost total stands in for both.
    """
    layout = getattr(plan, "flat_layout", None)
    if layout is not None:
        raw = float(sum(int(np.prod(s, dtype=np.int64))
                        for s in layout.leaf_shapes))
        packed = float(sum(layout.level_sizes))
        return raw, packed
    # cost-vector plan: leaf_costs are normalized fractions of the unit
    # resolution — no real element counts exist.
    raw = float(plan.total_units)
    return raw, raw


def estimate_memory(plan, *, cfg=None, global_batch: int = 32,
                    seq_len: int = 512, grad_dtype: str = "fp32",
                    pipeline: str = "flat",
                    reduce_mode: str = "psum") -> MemEstimate:
    """Per-worker HBM bytes for running ``plan`` with the given knobs.

    ``cfg`` (a ``ModelConfig``) prices the activation term; without it
    only the state + gradient terms are counted (the plan-level
    ``scheme="auto"`` path, where no model config exists).
    """
    if grad_dtype not in GRAD_DTYPE_BYTES:
        raise ValueError(f"unknown grad_dtype {grad_dtype!r}; "
                         f"expected one of {sorted(GRAD_DTYPE_BYTES)}")
    gb = GRAD_DTYPE_BYTES[grad_dtype]
    raw, packed = _packed_elems(plan)
    k = int(plan.s_max) + 1
    n = int(plan.n_workers)

    est = MemEstimate()
    est.params_bytes = raw * 4.0          # fp32 master params
    est.opt_bytes = 2.0 * raw * 4.0       # AdamW m + v, fp32
    # the tree pipeline combines leaf-by-leaf on unpacked leaves; the
    # flat pipeline streams the packed (padded) level buffers
    payload = packed if pipeline == "flat" else raw
    est.grad_bytes = float(k) * payload * gb
    est.reduce_bytes = payload * gb / (n if reduce_mode == "psum_scatter"
                                       else 1)
    if cfg is not None:
        rows = -(-int(global_batch) // n)  # ceil: rows per worker shard
        act_b = 2 if cfg.dtype in ("bfloat16", "float16") else 4
        remat = REMAT_FACTOR.get(cfg.remat, 1.0)
        act = (rows * seq_len * cfg.d_model * cfg.n_layers
               * ACT_FACTOR * act_b * remat)
        logits = rows * seq_len * cfg.vocab * 4.0
        est.act_bytes = act + logits
        est.detail = {"rows_per_worker": rows, "seq_len": int(seq_len),
                      "remat": cfg.remat, "k_shards": k}
    else:
        est.detail = {"k_shards": k}
    return est


def tree_bytes(obj) -> int:
    """Bytes of every array in ``obj``: tensors (numel × itemsize, so a
    view counts its own elements) and numpy arrays, through lists,
    tuples, dicts and dataclasses; a module's parameters and buffers; a
    train state as its checkpoint tree (``count`` and ``step`` as int32,
    the reference's ``TrainState``).  Each object counts once; Python
    scalars count nothing (the reference's are compile-time constants)."""
    seen: set = set()

    def walk(o) -> int:
        if id(o) in seen:
            return 0
        seen.add(id(o))
        if isinstance(o, torch.Tensor):
            return o.numel() * o.element_size()
        if isinstance(o, (np.ndarray, np.generic)):
            return int(o.nbytes)
        if hasattr(o, "checkpoint_tree"):
            return walk(o.checkpoint_tree())
        if isinstance(o, torch.nn.Module):
            return sum(walk(t) for t in (*o.parameters(), *o.buffers()))
        if isinstance(o, dict):
            return sum(walk(v) for v in o.values())
        if isinstance(o, (list, tuple)):
            return sum(walk(v) for v in o)
        if hasattr(o, "__dataclass_fields__"):
            return sum(walk(getattr(o, k)) for k in o.__dataclass_fields__)
        return 0

    return walk(obj)


def analyze_memory(fn, *args, device="cuda", **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once on ``device`` and return its
    footprint: ``argument_bytes`` (the arguments, the state a step keeps
    live), ``output_bytes`` (what it returns; a state updated in place
    counts again, as the reference's output state does) and
    ``total_bytes``, the reference's three figures.  On CUDA also
    ``peak_bytes``, ``torch.cuda.max_memory_allocated`` over the call
    after a reset, and ``temp_bytes``, the peak less what was allocated
    before the call.  On meta (shapes only; its loops take the op
    counter's shortcut) and the CPU the first three only."""
    from ..device import resolve_device
    from ..launch import op_analysis

    dev = resolve_device(device)
    arg_b = tree_bytes((args, kwargs))
    rec = {}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        out = fn(*args, **kwargs)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        rec = {"peak_bytes": int(peak), "temp_bytes": int(peak - before)}
    elif dev.type == "meta":
        out = op_analysis.analyze_ops(fn, *args, device=dev, **kwargs).output
    else:
        out = fn(*args, **kwargs)
    out_b = tree_bytes(out)
    return {"argument_bytes": int(arg_b), "output_bytes": int(out_b),
            "total_bytes": int(arg_b + out_b), **rec}
