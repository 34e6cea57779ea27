"""Coded gradients in sim mode: the redundant per-shard backward passes
and the coded combine, after ``repro/train/coded.py``
(``make_coded_grad_fn(mode="sim")``, ``combine_grads``, ``combine_level``,
``uncoded_grad_fn``).

Per step, for a plan over N workers with K = s_max + 1 shards each:

* one ``(N·K, size)`` buffer is allocated per leaf;
* N·K backward passes (``torch.autograd.grad`` of ``train_loss``) run in
  worker-major order, each copied into its row — the honest redundancy
  work eq. (2) prices;
* one ``ops.encode_decode_leaves(1/N, dec_w ⊙ b_rows, level, G)`` call
  for all leaves folds encode, decode weight, worker sum and the 1/N
  mean into a single streaming pass per leaf, each leaf with its level's
  weights — one launch of the hand-written ``gc_fused`` kernel per step
  on CUDA.

That is ``pipeline="flat"``.  ``combine_level`` is its unit for one
redundancy level — one grouped call over that level's leaves — which the
wave-pipelined loop fires at the level's decode event; the union over
the levels equals ``combine_rows`` bit for bit.  ``pipeline="tree"`` is
the reference's per-leaf baseline in plain torch ops: per worker and
leaf, encode its K shard rows with the coding row, scale by the decode
weight, then sum over workers and take the mean (the reference computes
it outside any Pallas kernel too).

For every straggler realization the result equals the plain
data-parallel mean gradient over the same global batch (tested).
The spmd mode over ``torch.distributed`` is ROADMAP 1.6.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core import Plan
from ..kernels import ops
from ..models.model import train_loss

__all__ = ["make_coded_grad_fn", "uncoded_grad_fn", "per_shard_grad_rows",
           "level_weights", "combine_rows", "combine_level", "combine_grads",
           "tree_combine"]


def _require_layout(plan: Plan):
    if plan.flat_layout is None:
        raise ValueError(
            "pipeline='flat' needs plan.flat_layout — build the plan from the "
            "model (Plan.build(model, env, ...)); plans built from bare cost "
            "vectors carry no leaf shapes (use pipeline='tree')")
    return plan.flat_layout


def _resolve_pipeline(pipeline: str, plan: Plan) -> str:
    if pipeline == "auto":
        return "flat" if plan.flat_layout is not None else "tree"
    if pipeline == "flat":
        _require_layout(plan)
        return "flat"
    if pipeline == "tree":
        return "tree"
    raise ValueError(f"unknown pipeline {pipeline!r}; "
                     "expected 'auto', 'flat', or 'tree'")


def per_shard_grad_rows(cfg, model, worker_batches) -> list:
    """Run the N·K per-shard backward passes; returns one ``(N·K, size)``
    tensor per leaf (row n·K + k: worker n's k-th shard)."""
    leaves = model.leaves()
    dev = leaves[0].device
    wb = torch.as_tensor(worker_batches, device=dev)  # (N, K, rows, S+1)
    n, k = wb.shape[0], wb.shape[1]
    rows = [torch.empty((n * k, t.numel()), dtype=t.dtype, device=dev)
            for t in leaves]
    for w in range(n):
        for s in range(k):
            loss, _ = train_loss(cfg, model, {"tokens": wb[w, s]})
            for buf, g in zip(rows, torch.autograd.grad(loss, leaves)):
                buf[w * k + s].copy_(g.reshape(-1))
    return rows


def level_weights(plan: Plan, dec_w, device, levels=None) -> torch.Tensor:
    """The fused combine's weight sets ``dec_w ⊙ b_rows``, one per level:
    ``w[i, 0, n·K + k] = dec_w[i, n] · b_rows[n, levels[i], k]``, shape
    (len(levels), 1, N·K).  ``levels`` (indices into ``plan.used_levels``)
    defaults to every level; row i of ``dec_w`` belongs to ``levels[i]``."""
    layout = _require_layout(plan)
    levels = list(range(layout.n_levels) if levels is None else levels)
    idx = torch.as_tensor(levels, dtype=torch.long, device=device)
    b_rows = torch.as_tensor(plan.b_rows, dtype=torch.float32, device=device)
    dec_w = torch.as_tensor(dec_w, dtype=torch.float32, device=device)
    return (dec_w[:len(levels), :, None] * b_rows[:, idx, :].transpose(0, 1)) \
        .reshape(len(levels), 1, -1)


def combine_rows(plan: Plan, g_rows, dec_w) -> list:
    """The fused combine of already-computed per-shard rows: one
    ``ops.encode_decode_leaves(1/N, w, level, G)`` call over every leaf's
    ``(N·K, size)`` rows, where ``w = level_weights(plan, dec_w)`` holds
    one weight set per level.  Returns the decoded mean gradient in leaf
    order."""
    layout = _require_layout(plan)
    dev = g_rows[0].device
    inv_n = torch.ones((1,), dtype=torch.float32, device=dev) / plan.n_workers
    ys = ops.encode_decode_leaves(inv_n, level_weights(plan, dec_w, dev),
                                  layout.leaf_level, list(g_rows))
    return [y[0].reshape(shape) for y, shape in zip(ys, layout.leaf_shapes)]


def combine_level(plan: Plan, g_rows, level_idx: int, dec_w_row) -> dict:
    """Decode ONE redundancy level of already-computed per-shard rows:
    one ``ops.encode_decode_leaves`` call over that level's leaves only
    (one ``gc_fused`` launch on CUDA) with that level's weight set
    (``level_weights``), callable the instant level ``level_idx`` (an
    index into ``plan.used_levels``) decodes.  ``g_rows``: every leaf's
    ``(N·K, size)`` rows; ``dec_w_row``: that level's (N,) decode weights.
    Returns ``{leaf id: decoded mean gradient}`` for the level's leaves;
    the union over the levels equals ``combine_rows`` bit for bit."""
    layout = _require_layout(plan)
    if not 0 <= level_idx < layout.n_levels:
        raise ValueError(f"level_idx {level_idx} out of range "
                         f"[0, {layout.n_levels})")
    dev = g_rows[0].device
    row = torch.as_tensor(dec_w_row, dtype=torch.float32, device=dev)
    inv_n = torch.ones((1,), dtype=torch.float32, device=dev) / plan.n_workers
    w = level_weights(plan, row[None], dev, levels=[level_idx])
    ids = layout.level_leaves[level_idx]
    ys = ops.encode_decode_leaves(inv_n, w, [0] * len(ids), [g_rows[j] for j in ids])
    return {j: y[0].reshape(layout.leaf_shapes[j]) for j, y in zip(ids, ys)}


def tree_combine(b_rows: torch.Tensor, dec_w: torch.Tensor, level_idx, g_rows) -> list:
    """The per-leaf tree combine on tensors: for leaf j at level
    l = level_idx[j], sum over workers n of dec_w[l, n] · (b_rows[n, l] @
    G_j[n]), over N, where G_j[n] is worker n's (K, size) block of the
    leaf's ``(N·K, size)`` rows.  Returns the flat (size,) means in leaf
    order."""
    n_workers = b_rows.shape[0]
    out = []
    for li, rows in zip(level_idx, g_rows):
        g = rows.reshape(n_workers, -1, rows.shape[1])
        total = None
        for n in range(n_workers):
            c = (b_rows[n, li].to(rows.dtype) @ g[n]) * dec_w[li, n].to(rows.dtype)
            total = c if total is None else total + c
        out.append(total / n_workers)
    return out


def combine_grads(plan: Plan, g_rows, dec_w, *, pipeline: str = "flat") -> list:
    """Decode-weighted mean combine of already-computed per-shard rows
    (``(N·K, size)`` per leaf; dec_w: (n_used, N)): the decoded mean
    gradient in leaf order, through the fused flat pipeline
    (``combine_rows``) or the per-leaf tree (``tree_combine``).  Leaves
    take the plan's leaf shapes; a tree combine of a plan without a
    layout returns flat (size,) leaves."""
    if _resolve_pipeline(pipeline, plan) == "flat":
        return combine_rows(plan, g_rows, dec_w)
    dev = g_rows[0].device
    ys = tree_combine(torch.as_tensor(plan.b_rows, dtype=torch.float32, device=dev),
                      torch.as_tensor(np.asarray(dec_w), dtype=torch.float32, device=dev),
                      plan.level_index().tolist(), g_rows)
    if plan.flat_layout is None:
        return ys
    return [y.reshape(shape) for y, shape in zip(ys, plan.flat_layout.leaf_shapes)]


def make_coded_grad_fn(cfg, plan: Plan, *, mode: str = "sim",
                       pipeline: str = "auto") -> Callable:
    """grad_fn(model, worker_batches, dec_w) -> decoded mean gradient,
    a list of tensors in leaf order.

    worker_batches: (N, K, rows, S+1) tokens from
    ``data.pipeline.coded_worker_batches``; dec_w: (n_used, N) decode
    weights of this step's straggler realization.  pipeline: 'flat' (the
    fused combine), 'tree' (the per-leaf baseline) or 'auto' (flat when
    the plan carries a ``FlatLayout``).
    """
    if mode != "sim":
        raise NotImplementedError(
            f"mode={mode!r}: the spmd mode over torch.distributed is not "
            "ported yet (ROADMAP 1.6)")
    pipeline = _resolve_pipeline(pipeline, plan)

    def grad_fn(model, worker_batches, dec_w):
        rows = per_shard_grad_rows(cfg, model, worker_batches)
        if pipeline == "flat":
            return combine_rows(plan, rows, dec_w)
        ys = combine_grads(plan, rows, dec_w, pipeline="tree")
        return [y.reshape(t.shape) for y, t in zip(ys, model.leaves())]

    return grad_fn


def uncoded_grad_fn(cfg, n_workers: int) -> Callable:
    """Plain data-parallel mean gradient over the same global batch
    (shards stacked (N, rows, S+1)); the reference for exactness tests."""

    def grad_fn(model, shards):
        leaves = model.leaves()
        shards = torch.as_tensor(shards, device=leaves[0].device)
        total = None
        for i in range(shards.shape[0]):
            loss, _ = train_loss(cfg, model, {"tokens": shards[i]})
            grads = torch.autograd.grad(loss, leaves)
            total = list(grads) if total is None else [a + g for a, g in zip(total, grads)]
        return [t / n_workers for t in total]

    return grad_fn
