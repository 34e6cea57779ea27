"""Multi-head latent attention (DeepSeek-V2/V3, arXiv:2412.19437 §2.1),
after ``repro/models/mla.py``.

Queries: a low-rank (``q_lora_rank``) down projection, an rms norm and
an up projection, split into a nope part and a RoPE part.  Keys and
values: one shared latent ``c_kv`` (``kv_lora_rank``, rms-normed) plus a
single RoPE key ``k_r`` that every head shares.  The decode cache holds
only ``{"c_kv", "k_r", "pos"}`` — 512 + 64 values per token and layer
for V3, against 2·128·128 for the same heads as plain multi-head
attention.

Training and prefill use the naive expansion: per-head keys and values
``c_kv @ wk_b`` and ``c_kv @ wv_b``, then the reference's online softmax
over KV chunks of ``attn_chunk`` (``attention.online_softmax``, the tail
padded): per chunk the nope and rope scores summed in the activations'
dtype, raised to fp32 and scaled (JAX promotes the product of a bf16
array and a numpy float to fp32), masked with -1e30 past the causal
edge and in the tail, then ``attention.softmax_update`` — the
unnormalized ``exp(s - max)`` cast to the activations' dtype for the
product with V, that product raised to fp32 — and at the end the fp32
accumulator over the fp32 row sum.  Like the reference's MLA scan, it
never rounds the probabilities to bf16 (``attn_probs_bf16`` is the
global attention's); ``attn_chunk_remat`` recomputes each chunk in the
backward, which changes no value.

Decode uses the **absorbed** form: ``W_uk`` folded into the query
(``q_eff = q_nope · W_uk``), scores taken against the latent cache plus
the rope term, an fp32 softmax over the valid slots (``j <= pos`` or a
full cache), the attention taken in latent space and expanded once
through ``W_uv``, then ``wo``.  ``pos`` is a scalar (the batch in
lockstep) or a ``(B,)`` row vector (the serving slab); the step writes
this token's ``c_kv``/``k_r`` **in place** at ``pos % cap`` per row and
advances ``pos`` in place, as ``attention.py`` does for K/V.

On the ``model`` axis (``tp``, a ``dist.sharding.ModelSplit`` that splits
``heads``) a rank holds its heads' ``wq_b``, ``wk_b``, ``wv_b`` and
``wo`` and the whole of ``wq_a``, ``q_a_norm``, ``wkv_a``, ``kv_a_norm``
and ``wk_rope``, as the reference's rules split them.  Every rank
computes the whole query latent ``cq``, the KV latent ``c_kv`` and the
shared RoPE key ``k_r`` and uses them for its own heads only, so their
gradients are partial: each passes through ``copy_to_model`` after its
norm or RoPE (three all-reduces backward), which leaves the gradients of
the input and of the replicated leaves whole on every rank with no
other collective.  The output projection's partial sums are all-reduced
once (``reduce_from_model``).  The decode cache stays whole on every
rank (the reference's ``mla_cache_axes`` split nothing), and the
absorbed decode runs the rank's heads against it, then the one
all-reduce.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..dist.collectives import copy_to_model, reduce_from_model
from .attention import kv_chunks, online_softmax, softmax_update
from .layers import rms_norm, rope

__all__ = ["mla_forward", "init_mla_cache"]

NEG_INF = -1e30


def _model_group(tp):
    """The model group when ``tp`` splits the heads, else None."""
    return tp.model_group if tp is not None and "heads" in tp.axes else None


def _to_heads(t, group):
    """``t``, every head's shared input, as a rank's heads read it: behind
    ``copy_to_model`` where the heads are split (its gradient summed over
    the model group)."""
    return t if group is None else copy_to_model(t, group)


def _queries(cfg, p, x, positions, group=None):
    """x: (B,S,d) -> q_nope (B,S,H,nope), q_rope (B,S,H,rope) with RoPE, of
    the heads ``p["wq_b"]`` holds."""
    m = cfg.mla
    dt = x.dtype
    cq = rms_norm(torch.einsum("bsd,dr->bsr", x, p["wq_a"].to(dt)), p["q_a_norm"])
    q = torch.einsum("bsr,rhx->bshx", _to_heads(cq, group), p["wq_b"].to(dt))
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_base)
    return q_nope, q_rope


def _latents(cfg, p, x, positions, group=None):
    """x: (B,S,d) -> c_kv (B,S,kv_lora_rank), k_r (B,S,rope) with RoPE."""
    dt = x.dtype
    c_kv = rms_norm(torch.einsum("bsd,dr->bsr", x, p["wkv_a"].to(dt)), p["kv_a_norm"])
    k_r = rope(torch.einsum("bsd,dx->bsx", x, p["wk_rope"].to(dt)), positions, cfg.rope_base)
    return _to_heads(c_kv, group), _to_heads(k_r, group)


def _scale(cfg) -> float:
    return 1.0 / np.sqrt(cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim)


def mla_forward(cfg, p, x, spec, *, mode="train", cache=None, target_len: int = 0,
                tp=None):
    """The MLA sublayer.  Returns (out, cache): ``None`` in training, the
    prefill's new cache of capacity ``max(target_len, S + 1)``, or the
    decode cache updated in place.  With ``tp``, this rank's heads, then
    the all-reduce; the cache holds the whole latent."""
    group = _model_group(tp)
    if mode == "decode":
        return _decode(cfg, p, x, cache, group), cache
    if mode not in ("train", "prefill"):
        raise ValueError(f"unknown mode {mode!r}")
    s = x.shape[1]
    dt = x.dtype
    positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope = _queries(cfg, p, x, positions, group)
    c_kv, k_r = _latents(cfg, p, x, positions, group)
    k_nope = torch.einsum("bsr,rhx->bshx", c_kv, p["wk_b"].to(dt))
    v = torch.einsum("bsr,rhx->bshx", c_kv, p["wv_b"].to(dt))
    chunk, n_chunks, pad = kv_chunks(cfg, s)
    k_r_p = k_r
    if pad:
        k_nope, v = F.pad(k_nope, (0, 0, 0, 0, 0, pad)), F.pad(v, (0, 0, 0, 0, 0, pad))
        k_r_p = F.pad(k_r, (0, 0, 0, pad))
    q_pos = torch.arange(s, device=x.device)

    def step(i, *carry):
        cut = slice(i * chunk, (i + 1) * chunk)
        kv_pos = torch.arange(i * chunk, (i + 1) * chunk, device=x.device)
        sc = torch.einsum("bqhd,bchd->bhqc", q_nope, k_nope[:, cut])
        sc = sc + torch.einsum("bqhd,bcd->bhqc", q_rope, k_r_p[:, cut])
        sc = sc.float() * _scale(cfg)
        valid = (kv_pos[None, :] <= q_pos[:, None]) & (kv_pos[None, :] < s)
        sc = sc + torch.where(valid, 0.0, NEG_INF)
        return softmax_update(carry or None, sc, v[:, cut], "bhqc,bchd->bhqd", dt)

    out = online_softmax(cfg, n_chunks, step).transpose(1, 2).to(dt)
    y = torch.einsum("bshx,hxd->bsd", out, p["wo"].to(dt))
    if group is not None:
        y = reduce_from_model(y, group)
    new_cache = None
    if mode == "prefill":
        pad = (0, 0, 0, max(target_len, s + 1) - s)
        new_cache = {"c_kv": F.pad(c_kv, pad), "k_r": F.pad(k_r, pad),
                     "pos": torch.full((), s, dtype=torch.int32, device=x.device)}
    return y, new_cache


def _decode(cfg, p, x, cache, group=None):
    """x: (B, 1, d) against the latent cache; writes this token's latent
    at ``pos % cap`` and advances ``pos``, both in place.  With the model
    ``group``, the rank's heads and the output projection's all-reduce."""
    b = x.shape[0]
    dt = x.dtype
    pos = cache["pos"]
    c_cache, kr_cache = cache["c_kv"], cache["k_r"]
    cap = c_cache.shape[1]
    pos_b = (pos.expand(b) if pos.ndim == 0 else pos).long()  # one position per row
    q_nope, q_rope = _queries(cfg, p, x, pos_b[:, None], group)
    c_new, kr_new = _latents(cfg, p, x, pos_b[:, None], group)
    rows = torch.arange(b, device=x.device)
    slot = torch.remainder(pos_b, cap)
    c_cache.index_put_((rows, slot), c_new[:, 0].to(c_cache.dtype))
    kr_cache.index_put_((rows, slot), kr_new[:, 0].to(kr_cache.dtype))
    c_lat = c_cache.to(dt)
    q_eff = torch.einsum("bqhx,rhx->bqhr", q_nope, p["wk_b"].to(dt))  # W_uk absorbed
    sc = torch.einsum("bqhr,bcr->bhqc", q_eff, c_lat)
    sc = sc + torch.einsum("bqhd,bcd->bhqc", q_rope, kr_cache.to(dt))
    sc = sc.float() * _scale(cfg)
    j = torch.arange(cap, device=x.device)
    valid = (j[None, :] <= pos_b[:, None]) | (pos_b[:, None] >= cap)  # (B, cap)
    sc = sc + torch.where(valid, 0.0, NEG_INF)[:, None, None]
    w = torch.softmax(sc, dim=-1).to(dt)
    lat = torch.einsum("bhqc,bcr->bqhr", w, c_lat)  # attention in latent space
    out = torch.einsum("bqhr,rhx->bqhx", lat, p["wv_b"].to(dt))
    pos.add_(1)
    y = torch.einsum("bshx,hxd->bsd", out, p["wo"].to(dt))
    return y if group is None else reduce_from_model(y, group)


def init_mla_cache(cfg, spec, batch: int, seq_len: int, dtype=torch.bfloat16,
                   device="cuda", tp=None):
    """An empty latent cache of capacity ``seq_len``; the same whole latent
    on every rank of a ``model`` axis (``tp``)."""
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, seq_len, m.kv_lora_rank), dtype=dtype, device=device),
        "k_r": torch.zeros((batch, seq_len, m.qk_rope_head_dim), dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }
