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
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .attention import kv_chunks, online_softmax, softmax_update
from .layers import rms_norm, rope

__all__ = ["mla_forward", "init_mla_cache"]

NEG_INF = -1e30


def _queries(cfg, p, x, positions):
    """x: (B,S,d) -> q_nope (B,S,H,nope), q_rope (B,S,H,rope) with RoPE."""
    m = cfg.mla
    dt = x.dtype
    cq = rms_norm(torch.einsum("bsd,dr->bsr", x, p["wq_a"].to(dt)), p["q_a_norm"])
    q = torch.einsum("bsr,rhx->bshx", cq, p["wq_b"].to(dt))
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_base)
    return q_nope, q_rope


def _latents(cfg, p, x, positions):
    """x: (B,S,d) -> c_kv (B,S,kv_lora_rank), k_r (B,S,rope) with RoPE."""
    dt = x.dtype
    c_kv = rms_norm(torch.einsum("bsd,dr->bsr", x, p["wkv_a"].to(dt)), p["kv_a_norm"])
    k_r = rope(torch.einsum("bsd,dx->bsx", x, p["wk_rope"].to(dt)), positions, cfg.rope_base)
    return c_kv, k_r


def _scale(cfg) -> float:
    return 1.0 / np.sqrt(cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim)


def mla_forward(cfg, p, x, spec, *, mode="train", cache=None, target_len: int = 0):
    """The MLA sublayer.  Returns (out, cache): ``None`` in training, the
    prefill's new cache of capacity ``max(target_len, S + 1)``, or the
    decode cache updated in place."""
    if mode == "decode":
        return _decode(cfg, p, x, cache), cache
    if mode not in ("train", "prefill"):
        raise ValueError(f"unknown mode {mode!r}")
    s = x.shape[1]
    dt = x.dtype
    positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope = _queries(cfg, p, x, positions)
    c_kv, k_r = _latents(cfg, p, x, positions)
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
    new_cache = None
    if mode == "prefill":
        pad = (0, 0, 0, max(target_len, s + 1) - s)
        new_cache = {"c_kv": F.pad(c_kv, pad), "k_r": F.pad(k_r, pad),
                     "pos": torch.full((), s, dtype=torch.int32, device=x.device)}
    return y, new_cache


def _decode(cfg, p, x, cache):
    """x: (B, 1, d) against the latent cache; writes this token's latent
    at ``pos % cap`` and advances ``pos``, both in place."""
    b = x.shape[0]
    dt = x.dtype
    pos = cache["pos"]
    c_cache, kr_cache = cache["c_kv"], cache["k_r"]
    cap = c_cache.shape[1]
    pos_b = (pos.expand(b) if pos.ndim == 0 else pos).long()  # one position per row
    q_nope, q_rope = _queries(cfg, p, x, pos_b[:, None])
    c_new, kr_new = _latents(cfg, p, x, pos_b[:, None])
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
    return torch.einsum("bshx,hxd->bsd", out, p["wo"].to(dt))


def init_mla_cache(cfg, spec, batch: int, seq_len: int, dtype=torch.bfloat16,
                   device="cuda"):
    """An empty latent cache of capacity ``seq_len``."""
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, seq_len, m.kv_lora_rank), dtype=dtype, device=device),
        "k_r": torch.zeros((batch, seq_len, m.qk_rope_head_dim), dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }
