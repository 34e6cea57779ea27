"""Mixture-of-experts FFN, after ``repro/models/moe.py::_moe_core``: a
top-k router (softmax, or DeepSeek-V3's sigmoid normalized over the k
chosen), capacity-bounded dispatch into ``(E, C, d)`` expert buffers,
gated expert FFNs as batched products, the weighted combine, optional
always-on shared experts, and the switch-style load-balance loss
``aux_loss_coef · E · Σ_e f_e · P_e`` (f the top-1 assignment fraction,
P the mean router probability).

The reference's ``_apply_moe_manual`` is a ``shard_map`` over a mesh
that falls back to ``_moe_core`` without one; on one device the port
runs ``_moe_core``'s function (``cfg.moe_impl`` and ``shard_experts``
are kept and have no effect).

What must match the reference exactly:

* ``top_k`` is k successive ``argmax``es with ``-inf`` masking, as the
  reference's ``_top_k`` (not ``torch.topk``, whose tie order differs):
  both ``argmax``es return the first maximal index;
* the capacity ``C`` counts every token of the call (B·S in training and
  prefill, B in decode), rounded up to a multiple of 8, at least 8;
* an assignment's position in its expert is a cumulative count over the
  flattened (t·k) stream, token-major; an assignment at position >= C is
  dropped: it keeps a slot clamped to C - 1 and carries zero weight;
* the rounding points: router logits in the activations' dtype, then
  fp32; ``keep * gates`` promotes the expert outputs to fp32 and the
  combine casts them back to the activations' dtype, as the reference's
  ``.at[].add`` casts its updates to the operand's dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .layers import _act

__all__ = ["Routing", "capacity", "top_k", "route", "apply_moe"]


def capacity(n_tokens: int, moe) -> int:
    """Slots per expert for a call over ``n_tokens`` tokens."""
    cap = int(np.ceil(n_tokens * moe.top_k * moe.capacity_factor / moe.num_experts))
    return max(8, -(-cap // 8) * 8)


def top_k(x, k: int):
    """(values, indices) of the k largest entries of each row of x (t, E),
    as k successive argmaxes, each masking its pick with -inf: the
    reference's ``_top_k`` and ``jax.lax.top_k``'s tie order."""
    vals, idxs = [], []
    work = x
    for _ in range(k):
        i = torch.argmax(work, dim=-1, keepdim=True)
        vals.append(torch.gather(work, -1, i)[:, 0])
        idxs.append(i[:, 0])
        work = work.scatter(-1, i, float("-inf"))
    return torch.stack(vals, -1), torch.stack(idxs, -1)


class Routing(NamedTuple):
    idx: torch.Tensor    # (t, k) chosen experts, best first
    gates: torch.Tensor  # (t, k) fp32 combine weights
    probs: torch.Tensor  # (t, E) fp32 router probabilities
    keep: torch.Tensor   # (t·k,) 1 for an assignment inside capacity, 0 dropped
    dest: torch.Tensor   # (t·k,) slot e·C + position (clamped to C - 1)
    cap: int             # C, slots per expert


def route(p, xt, moe) -> Routing:
    """Route tokens xt (t, d) with the router ``p["router"]`` (d, E)."""
    t = xt.shape[0]
    e, k = moe.num_experts, moe.top_k
    logits = (xt @ p["router"].to(xt.dtype)).float()
    if moe.router == "sigmoid":
        scores = torch.sigmoid(logits)
        gate_vals, idx = top_k(scores, k)
        probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        gate_vals, idx = top_k(probs, k)
    gates = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    cap = capacity(t, moe)
    flat_e = idx.reshape(t * k)
    pos = torch.cumsum(F.one_hot(flat_e, e), dim=0) - 1  # position within expert
    pos = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    keep = (pos < cap).to(xt.dtype)
    dest = flat_e * cap + torch.clamp(pos, max=cap - 1)
    return Routing(idx, gates, probs, keep, dest, cap)


def apply_moe(cfg, p, x, spec):
    """x: (B, S, d) -> (out (B, S, d) in x's dtype, fp32 aux loss)."""
    moe = spec.moe
    b, s, d = x.shape
    dt = x.dtype
    t, e, k = b * s, moe.num_experts, moe.top_k
    xt = x.reshape(t, d)
    r = route(p, xt, moe)

    f_e = F.one_hot(r.idx[:, 0], e).float().mean(0)  # top-1 fraction
    p_e = r.probs.mean(0)
    aux = moe.aux_loss_coef * e * torch.sum(f_e * p_e)

    # dispatch: row j of the (t·k) stream is token j // k (token-major).
    # Kept assignments own distinct slots; a dropped one is a zero row
    # clamped onto an occupied slot.  So the only collisions add zeros,
    # and index_add_'s atomic adds on CUDA give the same bits in any order.
    gathered = xt[:, None, :].expand(t, k, d).reshape(t * k, d) * r.keep[:, None]
    buf = torch.zeros((e * r.cap, d), dtype=dt, device=x.device).index_add(0, r.dest, gathered)
    buf = buf.view(e, r.cap, d)

    # the gated expert FFNs: batched products over the experts
    h = torch.einsum("ecd,edf->ecf", buf, p["wi"].to(dt))
    g = torch.einsum("ecd,edf->ecf", buf, p["wg"].to(dt))
    h = _act(cfg, g) * h
    out_buf = torch.einsum("ecf,efd->ecd", h, p["wo"].to(dt)).reshape(e * r.cap, d)

    # combine: fp32 weighting, cast back, then each token's k rows summed
    # in index order from zeros — the reference's sequential scatter-add
    # over its sorted, contiguous token index, not an atomic scatter
    back = torch.index_select(out_buf, 0, r.dest) * (r.keep * r.gates.reshape(t * k))[:, None]
    back = back.to(dt).view(t, k, d)
    out = torch.zeros((t, d), dtype=dt, device=x.device)
    for j in range(k):
        out = out + back[:, j]
    out = out.view(b, s, d)

    if "shared" in p:
        sp = p["shared"]
        hs = torch.einsum("bsd,df->bsf", x, sp["wi"].to(dt))
        gs = torch.einsum("bsd,df->bsf", x, sp["wg"].to(dt))
        out = out + torch.einsum("bsf,fd->bsd", _act(cfg, gs) * hs, sp["wo"].to(dt))
    return out, aux
