"""Mixture-of-experts FFN, after ``repro/models/moe.py::_moe_core``: a
top-k router (softmax, or DeepSeek-V3's sigmoid normalized over the k
chosen), capacity-bounded dispatch into ``(E, C, d)`` expert buffers,
gated expert FFNs as batched products, the weighted combine, optional
always-on shared experts, and the switch-style load-balance loss
``aux_loss_coef · E · Σ_e f_e · P_e`` (f the top-1 assignment fraction,
P the mean router probability).

On the ``model`` axis (``tp``, a ``dist.sharding.ModelSplit``) the
experts split where the reference's GSPMD splits them
(``params.shard_dims``): (a) over ``experts`` — the router's columns and
dim 0 of ``wi``/``wg``/``wo`` — where ``shard_experts`` holds and E
divides the axis; else (b) over ``expert_mlp``, each expert's FFN width
(Mixtral's ``shard_experts=False``); else (c) nowhere: every rank holds
every expert and makes no collective.  Every rank of a model group holds
the same tokens and routes them alike, so the dispatch stays on the rank
(the port has no sequence split, so no all-to-all): in (a) a rank fills
the slots of its experts only, in (b) every slot with its share of the
width.  The collectives, per MoE layer: forward, one all-reduce of the
combined (t, d) output (``reduce_from_model``), and in (a) one
all-gather of the router's (t, E/m) logits (``gather_from_model``,
whose backward keeps the rank's slice: everything after it is
replicated); backward, the gates' (t, k) gradient all-reduced
(``copy_to_model``: they weight a rank's partial expert outputs) and the
expert input's (t, d) — in (a) that input is also the router's, whose
column shard gives a partial gradient too, so one ``copy_to_model``
serves both.  The load-balance loss reads the whole probabilities, so
its gradient is whole on every rank and summed once.  Shared experts
follow the dense MLP's ``mlp`` rule at their own width
(``layers.apply_mlp``).

Serving on data-parallel slots (``rows``: a ``dist.sharding.RowSplit``
whose axes split the call's rows over the data ranks) counts the
capacity over every rank's rows, as the reference's ``moe_impl="gspmd"``
counts it over the call's global batch: one all-gather of each row's k
expert ids over the data ranks (``collectives.gather_rows``), the
positions counted over the whole stream, and the rank keeping its rows'.
``moe_impl="manual"`` counts a rank's own rows, as the reference's
``_apply_moe_manual`` does under its ``shard_map`` over the batch axes.
Off a mesh the port runs ``_moe_core``'s function.

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

from ..dist.collectives import copy_to_model, gather_from_model, gather_rows, reduce_from_model
from .layers import _act, apply_mlp

__all__ = ["Routing", "capacity", "top_k", "route", "expert_split", "apply_moe"]


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


def expert_split(tp):
    """Which logical axis of the experts ``tp`` splits: ``"experts"``
    (case a), ``"expert_mlp"`` (case b), or None (no ``tp``, or case c)."""
    if tp is None:
        return None
    return next((a for a in ("experts", "expert_mlp") if a in tp.axes), None)


def _global_ids(flat_e, rows):
    """The (t·k,) expert ids of every rank's rows and where this rank's
    begin among them: ``flat_e`` itself and 0 unless ``rows`` splits the
    call's rows over the data ranks, then one all-gather of each row's
    ids."""
    if rows is None or not rows.axes:
        return flat_e, 0
    per_row = flat_e.view(len(rows.rows), -1)
    every = gather_rows(per_row.contiguous(), rows).reshape(-1)
    return every, rows.rows.start * per_row.shape[1]


def route(p, xt, moe, tp=None, rows=None) -> Routing:
    """Route tokens xt (t, d) with the router ``p["router"]`` (d, E): with
    ``tp`` in case (a), the rank's (d, E/m) columns and the logits
    all-gathered; with ``rows`` splitting the call's rows over the data
    ranks, the capacity and positions counted over every rank's
    rows."""
    t = xt.shape[0]
    e, k = moe.num_experts, moe.top_k
    logits = (xt @ p["router"].to(xt.dtype)).float()
    if expert_split(tp) == "experts":
        logits = gather_from_model(logits, tp.model_group, tp.model_index, dim=1)
    if moe.router == "sigmoid":
        scores = torch.sigmoid(logits)
        gate_vals, idx = top_k(scores, k)
        probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        gate_vals, idx = top_k(probs, k)
    gates = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    flat_e = idx.reshape(t * k)
    every, first = _global_ids(flat_e, rows)
    cap = capacity(every.shape[0] // k, moe)
    pos = torch.cumsum(F.one_hot(every, e), dim=0) - 1  # position within expert
    pos = torch.gather(pos, 1, every[:, None])[first:first + t * k, 0]
    keep = (pos < cap).to(xt.dtype)
    dest = flat_e * cap + torch.clamp(pos, max=cap - 1)
    return Routing(idx, gates, probs, keep, dest, cap)


def apply_moe(cfg, p, x, spec, tp=None, rows=None):
    """x: (B, S, d) -> (out (B, S, d) in x's dtype, fp32 aux loss).  ``tp``:
    the module's ``ModelSplit`` on a ``model`` axis; ``rows``: the
    ``RowSplit`` of the call's B rows over the data ranks (a serving
    engine's decode on data-parallel slots), for the capacity's count."""
    moe = spec.moe
    b, s, d = x.shape
    dt = x.dtype
    t, e, k = b * s, moe.num_experts, moe.top_k
    split = expert_split(tp)
    group = None if split is None else tp.model_group
    xt = x.reshape(t, d)
    if split == "experts":  # the router's columns and the rank's experts read it
        xt = copy_to_model(xt, group)
    if cfg.moe_impl == "manual":  # a data rank's own rows, as under the reference's shard_map
        rows = None
    r = route(p, xt, moe, tp, rows)
    gates = r.gates if group is None else copy_to_model(r.gates, group)

    f_e = F.one_hot(r.idx[:, 0], e).float().mean(0)  # top-1 fraction
    p_e = r.probs.mean(0)
    aux = moe.aux_loss_coef * e * torch.sum(f_e * p_e)

    # dispatch: row j of the (t·k) stream is token j // k (token-major).
    # Kept assignments own distinct slots; a dropped one is a zero row
    # clamped onto an occupied slot.  So the only collisions add zeros,
    # and index_add_'s atomic adds on CUDA give the same bits in any order.
    # Case (a): the rank's experts' slots only, another rank's assignment
    # a zero row on slot 0.
    keep, dest = r.keep, r.dest
    n_local = p["wi"].shape[0]
    if split == "experts":
        first = tp.model_index * n_local
        flat_e = r.idx.reshape(t * k)
        mine = (flat_e >= first) & (flat_e < first + n_local)
        keep = keep * mine.to(dt)
        dest = torch.where(mine, dest - first * r.cap, 0)
    x_in = copy_to_model(xt, group) if split == "expert_mlp" else xt
    gathered = x_in[:, None, :].expand(t, k, d).reshape(t * k, d) * keep[:, None]
    buf = torch.zeros((n_local * r.cap, d), dtype=dt, device=x.device).index_add(0, dest,
                                                                                  gathered)
    buf = buf.view(n_local, r.cap, d)

    # the gated expert FFNs: batched products over the experts
    h = torch.einsum("ecd,edf->ecf", buf, p["wi"].to(dt))
    g = torch.einsum("ecd,edf->ecf", buf, p["wg"].to(dt))
    h = _act(cfg, g) * h
    out_buf = torch.einsum("ecf,efd->ecd", h, p["wo"].to(dt)).reshape(n_local * r.cap, d)

    # combine: fp32 weighting, cast back, then each token's k rows summed
    # in index order from zeros — the reference's sequential scatter-add
    # over its sorted, contiguous token index, not an atomic scatter
    back = torch.index_select(out_buf, 0, dest) * (keep * gates.reshape(t * k))[:, None]
    back = back.to(dt).view(t, k, d)
    out = torch.zeros((t, d), dtype=dt, device=x.device)
    for j in range(k):
        out = out + back[:, j]
    if group is not None:  # a rank's experts, or its share of each one's width
        out = reduce_from_model(out, group)
    out = out.view(b, s, d)

    if "shared" in p:
        out = out + apply_mlp(cfg, p["shared"], x, tp, moe.d_ff * moe.num_shared)
    return out, aux
