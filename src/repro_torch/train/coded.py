"""Coded gradients in sim mode: the redundant per-shard backward passes
and the fused flat combine, after ``repro/train/coded.py``
(``make_coded_grad_fn(mode="sim", pipeline="flat")``, ``uncoded_grad_fn``).

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

For every straggler realization the result equals the plain
data-parallel mean gradient over the same global batch (tested).
The spmd mode over ``torch.distributed`` and the per-leaf ``tree``
pipeline are ROADMAP 1.6 and 1.4.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core import Plan
from ..kernels import ops
from ..models.model import train_loss

__all__ = ["make_coded_grad_fn", "uncoded_grad_fn", "per_shard_grad_rows",
           "combine_rows"]


def _require_layout(plan: Plan):
    if plan.flat_layout is None:
        raise ValueError(
            "pipeline='flat' needs plan.flat_layout — build the plan from the "
            "model (Plan.build(model, env, ...)); plans built from bare cost "
            "vectors carry no leaf shapes")
    return plan.flat_layout


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


def combine_rows(plan: Plan, g_rows, dec_w) -> list:
    """The fused combine of already-computed per-shard rows: one
    ``ops.encode_decode_leaves(1/N, w, level, G)`` call over every leaf's
    ``(N·K, size)`` rows, where ``w`` holds one weight set
    ``dec_w ⊙ b_rows`` per level, (n_levels, 1, N·K).  Returns the decoded
    mean gradient in leaf order."""
    layout = _require_layout(plan)
    dev = g_rows[0].device
    n_levels = layout.n_levels
    b_rows = torch.as_tensor(plan.b_rows, dtype=torch.float32, device=dev)
    dec_w = torch.as_tensor(dec_w, dtype=torch.float32, device=dev)
    inv_n = torch.ones((1,), dtype=torch.float32, device=dev) / plan.n_workers
    # w[li, 0, n*K + k] = dec_w[li, n] * b_rows[n, li, k]
    w = (dec_w[:n_levels, :, None] * b_rows[:, :n_levels, :].transpose(0, 1)) \
        .reshape(n_levels, 1, -1)
    ys = ops.encode_decode_leaves(inv_n, w, layout.leaf_level, list(g_rows))
    return [y[0].reshape(shape) for y, shape in zip(ys, layout.leaf_shapes)]


def make_coded_grad_fn(cfg, plan: Plan, *, mode: str = "sim",
                       pipeline: str = "flat") -> Callable:
    """grad_fn(model, worker_batches, dec_w) -> decoded mean gradient,
    a list of tensors in leaf order.

    worker_batches: (N, K, rows, S+1) tokens from
    ``data.pipeline.coded_worker_batches``; dec_w: (n_used, N) decode
    weights of this step's straggler realization.
    """
    if mode != "sim":
        raise NotImplementedError(
            f"mode={mode!r}: the spmd mode over torch.distributed is not "
            "ported yet (ROADMAP 1.6)")
    if pipeline not in ("flat", "auto"):
        raise NotImplementedError(
            f"pipeline={pipeline!r}: the per-leaf tree pipeline is not ported "
            "yet (ROADMAP 1.4); the port runs the fused flat pipeline")
    _require_layout(plan)

    def grad_fn(model, worker_batches, dec_w):
        return combine_rows(plan, per_shard_grad_rows(cfg, model, worker_batches),
                            dec_w)

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
