"""Causal global self-attention of the dense path, after
``repro/models/attention.py``: training, prefill and decode.

The reference's ``chunked_attention`` is an online softmax over KV
chunks in jnp — plain math, not a Pallas kernel — so the port computes
the same function in plain PyTorch: fp32 scores masked with -1e30 past
the causal edge, an fp32 softmax, and the weighted sum of values.  GQA
groups query heads over the KV heads exactly as the reference does.

Decode: one query token against a KV cache ``{"k", "v", "pos"}`` of
capacity ``cap`` (``(B, cap, K, Dh)`` leaves).  ``pos`` is a scalar (the
whole batch in lockstep) or a ``(B,)`` row vector (the serving slab,
where every slot decodes at its own depth: RoPE positions, write slots
and validity masks are per row).  The step writes its K/V into the cache
**in place** at ``pos % cap`` and advances ``pos`` in place; the
reference's functional ``.at[].set`` returns a new cache instead.  K/V
are computed in the activations' dtype, cast to the cache's dtype when
written and cast back when read, at the reference's places.  Windowed
layers (a ring of ``min(window, S)``) are ROADMAP 1.9.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .layers import rope

__all__ = ["project_qkv", "causal_attention", "attn_forward", "init_attn_cache",
           "prefill_cache"]

NEG_INF = -1e30


def project_qkv(cfg, p, x, positions, rope_base):
    """x: (B,S,d) -> q:(B,S,H,Dh), k,v:(B,S,K,Dh) with RoPE on q and k."""
    dt = x.dtype
    q = torch.einsum("bsd,dhx->bshx", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dkx->bskx", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dkx->bskx", x, p["wv"].to(dt))
    if rope_base:
        q = rope(q, positions, rope_base)
        k = rope(k, positions, rope_base)
    return q, k, v


def causal_attention(cfg, q, k, v):
    """q: (B,S,H,Dh); k,v: (B,S,K,Dh) -> (B,S,H,Dh)."""
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, dh)
    scale = 1.0 / np.sqrt(cfg.head_dim)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, k) * scale
    q_pos = torch.arange(sq, device=q.device)
    kv_pos = torch.arange(skv, device=q.device)
    bias = torch.where(kv_pos[None, :] <= q_pos[:, None], 0.0, NEG_INF)
    w = torch.softmax(s.float() + bias, dim=-1)
    out = torch.einsum("bkgqc,bckd->bqkgd", w.to(q.dtype), v)
    return out.reshape(b, sq, h, dh)


def attn_forward(cfg, p, x, spec, *, mode="train", cache=None, target_len: int = 0):
    """Self-attention sublayer.  Returns (out, cache): ``None`` in training,
    the prefill's new cache, or the decode cache updated in place."""
    if mode in ("train", "prefill"):
        s = x.shape[1]
        positions = torch.arange(s, device=x.device)[None, :]
        q, k, v = project_qkv(cfg, p, x, positions, cfg.rope_base)
        out = causal_attention(cfg, q, k, v)
        new_cache = prefill_cache(cfg, spec, k, v, s, target_len) if mode == "prefill" else None
        return torch.einsum("bshx,hxd->bsd", out, p["wo"].to(x.dtype)), new_cache
    if mode != "decode":
        raise ValueError(f"unknown mode {mode!r}")
    return _decode(cfg, p, x, cache), cache


def _decode(cfg, p, x, cache):
    """x: (B, 1, d) against ``cache``; writes this token's K/V at
    ``pos % cap`` and advances ``pos``, both in place."""
    b = x.shape[0]
    pos = cache["pos"]
    k_cache, v_cache = cache["k"], cache["v"]
    cap = k_cache.shape[1]
    pos_b = (pos.expand(b) if pos.ndim == 0 else pos).long()  # one position per row
    q, k, v = project_qkv(cfg, p, x, pos_b[:, None], cfg.rope_base)
    rows = torch.arange(b, device=x.device)
    slot = torch.remainder(pos_b, cap)
    k_cache.index_put_((rows, slot), k[:, 0].to(k_cache.dtype))
    v_cache.index_put_((rows, slot), v[:, 0].to(v_cache.dtype))
    j = torch.arange(cap, device=x.device)
    valid = (j[None, :] <= pos_b[:, None]) | (pos_b[:, None] >= cap)  # (B, cap)
    bias = torch.where(valid, 0.0, NEG_INF)[:, None, None, None, :]
    kvh, dh = k.shape[2], k.shape[3]
    qg = q.reshape(b, 1, kvh, cfg.n_heads // kvh, dh)
    s_att = torch.einsum("bqkgd,bckd->bkgqc", qg, k_cache.to(q.dtype)) / np.sqrt(cfg.head_dim)
    w_att = torch.softmax(s_att.float() + bias, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqc,bckd->bqkgd", w_att, v_cache.to(q.dtype))
    out = out.reshape(b, 1, cfg.n_heads, dh)
    pos.add_(1)
    return torch.einsum("bshx,hxd->bsd", out, p["wo"].to(x.dtype))


def init_attn_cache(cfg, spec, batch: int, seq_len: int, dtype=torch.bfloat16,
                    device="cuda"):
    """An empty cache: capacity ``seq_len``, or ``min(window, seq_len)``
    for a windowed layer."""
    cap = seq_len if spec.window is None else min(spec.window, seq_len)
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, cap, kv, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, cap, kv, dh), dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def prefill_cache(cfg, spec, k, v, seq_len: int, target_len: int = 0):
    """Decode cache from prefill K/V (uncast), with capacity for future
    tokens: ``max(target_len, seq_len + 1)`` for a global layer, or
    ``min(window, ·)`` for a windowed one.  A prefill past the capacity
    keeps the last ``cap`` tokens ring-aligned (position p at slot
    p % cap); otherwise it is padded — positions p < seq_len already sit
    at slots p."""
    target_len = max(target_len, seq_len + 1)
    cap = target_len if spec.window is None else min(spec.window, target_len)
    if seq_len >= cap:
        shift = (seq_len - cap) % cap
        k = torch.roll(k[:, -cap:], shift, dims=1)
        v = torch.roll(v[:, -cap:], shift, dims=1)
    else:
        pad = (0, 0, 0, 0, 0, cap - seq_len)
        k = F.pad(k, pad)
        v = F.pad(v, pad)
    return {"k": k, "v": v,
            "pos": torch.full((), seq_len, dtype=torch.int32, device=k.device)}
