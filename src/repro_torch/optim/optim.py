"""AdamW, global-norm clipping and the cosine schedule, after
``repro/optim/optim.py`` (the same formulas, not ``torch.optim.AdamW``):
eps is added outside ``sqrt(v / bc2)`` and weight decay joins the step
inside the lr scaling.

States are lists in leaf order.  ``adamw_update`` updates the moments
and the parameters in place (it saves a full copy of the model and its
two moments per step); the arithmetic is the reference's, op for op.
On the ``model`` axis the clip's norm adds up the split leaves' squares
over the model group and counts each replicated leaf once, so every
rank clips by the same scale; on a state cut over ``data`` (the
``fsdp`` rule) the cut leaves' squares are added up over the data group
as well, so the norm counts every element once.
"""
from __future__ import annotations

import math

import torch

from ..dist.collectives import psum, reduce_from_model

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm", "global_norm",
           "cosine_schedule"]


def adamw_init(params) -> dict:
    return {"m": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "v": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "count": 0}


@torch.no_grad()
def adamw_update(grads, opt_state, params, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.0) -> dict:
    """One AdamW step over leaf lists: updates ``params`` and the moments
    in place, returns the new state (``count`` + 1)."""
    count = opt_state["count"] + 1
    c = torch.tensor(float(count), dtype=torch.float32)
    bc1 = (1.0 - b1 ** c).item()
    bc2 = (1.0 - b2 ** c).item()
    lr = float(lr)  # an fp32 value: scaling by it rounds as the fp32 product
    for g, m, v, p in zip(grads, opt_state["m"], opt_state["v"], params):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            step = step + weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))
    return {"m": opt_state["m"], "v": opt_state["v"], "count": count}


def global_norm(tensors, group=None, split=None, data_group=None,
                data_split=None) -> torch.Tensor:
    """The l2 norm of all ``tensors``.  With a model ``group``,
    ``split[j]`` says whether tensor j is this rank's shard of a split
    leaf: those squares are summed over the group (one all-reduce), the
    replicated ones added once.  With a ``data_group``, ``data_split[j]``
    says whether tensor j is this rank's slice of a leaf cut over
    ``data``: those squares are summed over the data group first (one
    all-reduce of two values: the leaves cut by both axes, and by
    ``data`` alone)."""
    squares = [torch.sum(torch.square(t.float())) for t in tensors]
    if group is None and data_group is None:
        return torch.sqrt(sum(squares))
    zero = torch.zeros((), dtype=torch.float32, device=squares[0].device)
    split = split or (False,) * len(squares)
    if data_group is None:
        shards = sum((q for q, s in zip(squares, split, strict=True) if s), zero)
        whole = sum((q for q, s in zip(squares, split) if not s), zero)
        return torch.sqrt(reduce_from_model(shards, group) + whole)
    kinds = list(zip(squares, split, data_split, strict=True))
    both, by_data = psum([torch.stack([
        sum((q for q, s, d in kinds if s and d), zero),
        sum((q for q, s, d in kinds if d and not s), zero)])], data_group)[0]
    whole = sum((q for q, s, d in kinds if not (s or d)), zero) + by_data
    if group is None:
        return torch.sqrt(whole)
    by_model = sum((q for q, s, d in kinds if s and not d), zero) + both
    return torch.sqrt(reduce_from_model(by_model, group) + whole)


def clip_by_global_norm(grads, max_norm, group=None, split=None, data_group=None,
                        data_split=None):
    """(grads * min(1, max_norm / norm), norm); the groups and splits as
    ``global_norm``'s."""
    norm = global_norm(grads, group, split, data_group, data_split)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return [g * scale.to(g.dtype) for g in grads], norm


def cosine_schedule(step, base_lr, warmup: int, total: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``base_lr``, then cosine decay to ``min_frac``."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)
