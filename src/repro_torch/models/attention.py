"""Causal global self-attention of the dense path, after
``repro/models/attention.py``.

The reference's ``chunked_attention`` is an online softmax over KV
chunks in jnp — plain math, not a Pallas kernel — so the port computes
the same function in plain PyTorch: fp32 scores masked with -1e30 past
the causal edge, an fp32 softmax, and the weighted sum of values.  GQA
groups query heads over the KV heads exactly as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from .layers import rope

__all__ = ["project_qkv", "causal_attention", "attn_forward"]

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


def attn_forward(cfg, p, x):
    """Self-attention sublayer in training mode: (B,S,d) -> (B,S,d)."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = project_qkv(cfg, p, x, positions, cfg.rope_base)
    out = causal_attention(cfg, q, k, v)
    return torch.einsum("bshx,hxd->bsd", out, p["wo"].to(x.dtype))
