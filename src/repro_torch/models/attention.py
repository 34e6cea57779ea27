"""Attention of the dense path, after ``repro/models/attention.py``:
causal self-attention — global and sliding-window layers, in training,
prefill and decode — and the gated cross-attention over a source
(``cross_attention``: Whisper's decoder over the encoder's output,
Llama-3.2-vision's image layers over the projected patches).

The reference's ``chunked_attention`` (an online softmax over KV
chunks) and ``local_attention`` (query chunks against a KV span of the
window) are plain jnp — not Pallas kernels — so the port computes the
same functions in plain PyTorch.  Global layers: ``chunked_attention``,
a Python loop over KV chunks of ``attn_chunk`` carrying the fp32 running
max, row sum and accumulator, with the reference's rounding points and
its two knobs (``attn_probs_bf16``: each chunk's probabilities rounded
to bf16; ``attn_chunk_remat``: each chunk recomputed in the backward),
so live memory is O(S·chunk), not O(S²); ``mla.py`` runs the same loop.
Windowed layers with ``window < S``: ``local_attention``, the
reference's schedule — query chunks of ``attn_chunk``, each against a
KV span of the window's history plus the chunk, masked per position —
so memory is O(S·window), not O(S²).  GQA groups query heads over the
KV heads exactly as the reference does.  Qwen's QKV biases are added
after the projections, in the activations' dtype, before QK-norm and
RoPE.  Gemma's extras sit at the reference's places: QK-norm
(``_rms_head``) before RoPE, the score softcap before the masks, and
``rope_base_local`` on windowed layers.  ``chunked_attention``,
``local_attention`` and the decode step scale the scores into fp32 as
the reference does (a bf16 array times a numpy float is an fp32 product
in JAX), then softcap and mask them in fp32; so does
``cross_attention``, whose scores the reference scales in ``_sdpa``.

Decode: one query token against a KV cache ``{"k", "v", "pos"}`` of
capacity ``cap`` (``(B, cap, K, Dh)`` leaves): the whole sequence for a
global layer, a ring of ``min(window, S)`` for a windowed one.  ``pos``
is a scalar (the whole batch in lockstep) or a ``(B,)`` row vector (the
serving slab, where every slot decodes at its own depth: RoPE positions,
write slots and validity masks are per row).  The step writes its K/V
into the cache **in place** at ``pos % cap`` and advances ``pos`` in
place; the reference's functional ``.at[].set`` returns a new cache
instead.  RoPE is applied before caching, so a ring that has wrapped
(``pos >= cap``) holds exactly the window and every slot is valid.  K/V
are computed in the activations' dtype, cast to the cache's dtype when
written and cast back when read, at the reference's places.

On the ``model`` axis (``tp``, a ``dist.sharding.ModelSplit``) a rank
runs its query heads in every mode, and the output projection's partial
sums are all-reduced once (``reduce_from_model``).  Its KV heads are its
share where the axis splits them; where it leaves them whole (gemma-2b's
one KV head) the rank computes and caches all of them and its query heads
read the ones they map to.  So a rank's cache holds ``tp.local(
"kv_heads", n_kv_heads)`` heads.  ``cross_attention`` splits alike, its
gate applied after the all-reduce.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..dist.collectives import copy_to_model, reduce_from_model
from .layers import rope, softcap

__all__ = ["project_qkv", "chunked_attention", "local_attention", "cross_attention",
           "attn_forward", "init_attn_cache", "prefill_cache"]

NEG_INF = -1e30


def _rms_head(x, scale, eps: float = 1e-6):
    """QK-norm: rms norm over the head dimension with an fp32 ``(1 + scale)``."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + scale)).to(x.dtype)


def _model_group(tp):
    """The model group when ``tp`` splits the heads, else None."""
    return tp.model_group if tp is not None and "heads" in tp.axes else None


def _shard_leaves(cfg, p, tp) -> dict:
    """The layer's leaves as this rank uses them: every replicated leaf —
    the QK-norm scales, and the KV leaves where the axis leaves the KV
    heads whole — behind ``copy_to_model``."""
    whole = ("q_norm", "k_norm") if "kv_heads" in tp.axes else (
        "q_norm", "k_norm", "wk", "wv", "bk", "bv")
    p = dict(p)
    for name in whole:
        if name in p:
            p[name] = copy_to_model(p[name], tp.model_group)
    return p


def _kv_select(cfg, tp, n_q: int):
    """Which K/V heads this rank's ``n_q`` query heads read where the
    ``model`` axis splits the query heads and leaves the KV heads whole:
    the one KV head they share, as a slice (gemma-2b's MQA), else the KV
    head of each query head; None where the K/V heads at hand line up
    with the query heads (no split, or both split)."""
    if _model_group(tp) is None or "kv_heads" in tp.axes:
        return None
    per_kv = cfg.n_heads // cfg.n_kv_heads
    first = tp.model_index * n_q
    lo, hi = first // per_kv, (first + n_q - 1) // per_kv
    if lo == hi:
        return slice(lo, lo + 1)
    return [(first + i) // per_kv for i in range(n_q)]


def _kv_heads(t, sel):
    """K/V ``t`` (B, S, K, Dh) at the heads ``sel`` (``_kv_select``)."""
    if sel is None:
        return t
    if isinstance(sel, slice):
        return t[:, :, sel]
    return t.index_select(2, torch.tensor(sel, device=t.device))


def project_qkv(cfg, p, x, positions, rope_base, tp=None):
    """x: (B,S,d) -> q:(B,S,H,Dh), k,v:(B,S,K,Dh), with the biases (when
    the layer has ``bq``/``bk``/``bv``), QK-norm (when it has
    ``q_norm``/``k_norm``) and then RoPE on q and k.  With ``tp`` and
    split heads, this rank's query heads and its KV heads: its share of
    them, or all of them where the axis leaves them whole."""
    if _model_group(tp) is not None:
        p = _shard_leaves(cfg, p, tp)
        x = copy_to_model(x, tp.model_group)
    dt = x.dtype
    q = torch.einsum("bsd,dhx->bshx", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dkx->bskx", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dkx->bskx", x, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if "q_norm" in p:
        q = _rms_head(q, p["q_norm"].float())
        k = _rms_head(k, p["k_norm"].float())
    if rope_base:
        q = rope(q, positions, rope_base)
        k = rope(k, positions, rope_base)
    return q, k, v


def kv_chunks(cfg, skv: int) -> tuple:
    """(chunk, n_chunks, pad) of the online softmax over ``skv`` keys:
    chunks of ``min(attn_chunk, skv)``, the tail padded."""
    chunk = min(cfg.attn_chunk, skv)
    n_chunks = -(-skv // chunk)
    return chunk, n_chunks, n_chunks * chunk - skv


def softmax_update(carry, s, v_i, pv: str, dtype, probs_bf16: bool = False):
    """One chunk of the online softmax: fp32 scores ``s`` (masked with
    -1e30) fold into ``carry``, the running max ``m``, row sum ``l`` and
    accumulator ``acc`` (all fp32); the probabilities are rounded to bf16
    when ``probs_bf16``, cast to ``dtype`` for the product ``pv`` with the
    chunk's values, and that product is raised back to fp32.  ``carry`` is
    None at the first chunk: the reference starts from m = -1e30 and
    l = acc = 0, so its rescaling there (by ``exp(-1e30 - m) = 0``) adds
    exact zeros — every row sees key 0 in the first chunk — and is
    skipped."""
    m_i = s.detach().amax(-1)  # a shift the result does not depend on: no gradient
    if carry is not None:
        m_i = torch.maximum(carry[0], m_i)
    p = torch.exp(s - m_i[..., None])
    if probs_bf16:
        p = p.to(torch.bfloat16)
    l_i = p.sum(-1, dtype=torch.float32)
    acc_i = torch.einsum(pv, p.to(dtype), v_i).float()
    if carry is not None:
        m, l, acc = carry
        alpha = torch.exp(m - m_i)
        l_i = l * alpha + l_i
        acc_i = acc * alpha[..., None] + acc_i
    return m_i, l_i, acc_i


def online_softmax(cfg, n_chunks: int, step):
    """``carry = step(i, *carry)`` over the KV chunks (no carry at the
    first), each under ``torch.utils.checkpoint`` (non-reentrant) when
    ``cfg.attn_chunk_remat`` and autograd records — the backward
    recomputes a chunk's scores and probabilities instead of keeping them,
    with the same ops on the same inputs, so the gradients are bit-equal.
    Returns ``acc / max(l, 1e-30)`` in fp32."""
    remat = cfg.attn_chunk_remat and torch.is_grad_enabled()
    carry = ()
    for i in range(n_chunks):
        carry = (checkpoint(step, i, *carry, use_reentrant=False) if remat
                 else step(i, *carry))
    _, l, acc = carry
    return acc / torch.clamp(l, min=1e-30)[..., None]


def chunked_attention(cfg, q, k, v, *, causal=True, cap: float = 0.0, q_offset: int = 0):
    """The reference's online softmax over KV chunks, O(S·chunk) live
    memory.  Each chunk's scores are taken in the activations' dtype,
    raised to fp32 by the scale (JAX promotes the product of a bf16 array
    and a numpy float to fp32), softcapped at ``cap`` (0: off) and masked
    with -1e30 past the causal edge (queries at ``q_offset + i``) and in
    the padded tail (a chunk with nothing to mask adds nothing, as adding
    the reference's zero bias changes no value); then ``softmax_update``.
    q: (B,S,H,Dh); k,v: (B,Skv,K,Dh) -> (B,S,H,Dh) in q's dtype."""
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    chunk, n_chunks, pad = kv_chunks(cfg, skv)
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qg = q.reshape(b, sq, kvh, h // kvh, dh)
    scale = 1.0 / np.sqrt(cfg.head_dim)
    q_pos = torch.arange(q_offset, q_offset + sq, device=q.device)

    def step(i, *carry):
        cut = slice(i * chunk, (i + 1) * chunk)
        s = torch.einsum("bqkgd,bckd->bkgqc", qg, k[:, cut])
        s = softcap(s.float() * scale, cap)
        kv_pos = torch.arange(i * chunk, (i + 1) * chunk, device=q.device)
        valid = kv_pos[None, :] <= q_pos[:, None] if causal else None
        if (i + 1) * chunk > skv:  # the padded tail
            tail = kv_pos[None, :] < skv
            valid = tail if valid is None else valid & tail
        if valid is not None:
            s = s + torch.where(valid, 0.0, NEG_INF)
        return softmax_update(carry or None, s, v[:, cut], "bkgqc,bckd->bkgqd", q.dtype,
                              cfg.attn_probs_bf16)

    out = online_softmax(cfg, n_chunks, step)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


def local_attention(cfg, q, k, v, *, window: int, cap: float = 0.0):
    """Causal sliding-window attention, O(S·window): query chunks of
    ``cq = min(attn_chunk, S)``, each against the KV span
    ``[chunk start - w_pad, chunk end)`` (``w_pad`` the window rounded up
    to whole chunks) of K/V padded with zeros, masked to the positions
    ``q - window < kv <= q`` inside the sequence.
    q: (B,S,H,Dh); k,v: (B,S,K,Dh) -> (B,S,H,Dh)."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    cq = min(cfg.attn_chunk, sq)
    n_chunks = -(-sq // cq)
    pad_q = n_chunks * cq - sq
    w_pad = -(-window // cq) * cq  # history length, whole chunks
    span = w_pad + cq
    q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    k_p = F.pad(k, (0, 0, 0, 0, w_pad, pad_q))
    v_p = F.pad(v, (0, 0, 0, 0, w_pad, pad_q))
    qg = q.reshape(b, n_chunks, cq, kvh, g, dh)
    scale = 1.0 / np.sqrt(cfg.head_dim)
    offs_q = torch.arange(cq, device=q.device)
    offs_kv = torch.arange(span, device=q.device) - w_pad
    outs = []
    for i in range(n_chunks):
        k_i = k_p[:, i * cq:i * cq + span]
        v_i = v_p[:, i * cq:i * cq + span]
        q_pos = i * cq + offs_q
        kv_pos = i * cq + offs_kv
        valid = ((kv_pos[None, :] <= q_pos[:, None])
                 & (kv_pos[None, :] > q_pos[:, None] - window)
                 & (kv_pos[None, :] >= 0) & (kv_pos[None, :] < sq))
        s = softcap(torch.einsum("bqkgd,bckd->bkgqc", qg[:, i], k_i).float() * scale, cap)
        w = torch.softmax(s + torch.where(valid, 0.0, NEG_INF), dim=-1)
        outs.append(torch.einsum("bkgqc,bckd->bqkgd", w.to(q.dtype), v_i))
    return torch.cat(outs, dim=1).reshape(b, n_chunks * cq, h, dh)[:, :sq]


def cross_attention(cfg, p, x, source, tp=None):
    """Bidirectional attention of x (B, S, d) over a ``source`` (B, Ssrc,
    d_src), gated: ``tanh(gate)`` — in fp32, cast to the activations'
    dtype — times the output projection.  ``p`` holds ``wq``, ``wk``,
    ``wv``, ``wo`` and the scalar ``gate`` (zero at init: the gate starts
    closed).  No mask, no RoPE, no biases; the scores are taken in the
    activations' dtype, then scaled in fp32 and put through an fp32
    softmax whose probabilities are cast back, as the reference's
    ``_sdpa`` rounds them.  With ``tp`` splitting the heads: x copied to
    the rank's query heads, its KV heads over the source (all of them,
    behind ``copy_to_model``, where the axis leaves them whole: the query
    heads read theirs by ``_kv_select``), ``wo``'s partial sums
    all-reduced, then the replicated gate, so its gradient is whole on
    every rank.  The source comes in whole: its gradient from this rank's
    K/V heads is a partial sum, which ``model.source_embeds``' copy sums
    once a pass."""
    dt = x.dtype
    group = _model_group(tp)
    if group is not None:
        p = _shard_leaves(cfg, p, tp)
        x = copy_to_model(x, group)
    src = source.to(dt)
    q = torch.einsum("bsd,dhx->bshx", x, p["wq"].to(dt))
    k = torch.einsum("bcd,dkx->bckx", src, p["wk"].to(dt))
    v = torch.einsum("bcd,dkx->bckx", src, p["wv"].to(dt))
    b, sq, h, dh = q.shape
    sel = _kv_select(cfg, tp, h)
    k, v = _kv_heads(k, sel), _kv_heads(v, sel)
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, dh)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, k).float() * (1.0 / np.sqrt(cfg.head_dim))
    w = torch.softmax(s, dim=-1).to(dt)
    out = torch.einsum("bkgqc,bckd->bqkgd", w, v).reshape(b, sq, h, dh)
    y = torch.einsum("bshx,hxd->bsd", out, p["wo"].to(dt))
    if group is not None:
        y = reduce_from_model(y, group)
    return torch.tanh(p["gate"].float()).to(dt) * y


def _rope_base(cfg, spec) -> float:
    """``rope_base_local`` on a windowed layer when the config sets one."""
    if spec.window is not None and cfg.rope_base_local:
        return cfg.rope_base_local
    return cfg.rope_base


def attn_forward(cfg, p, x, spec, *, mode="train", cache=None, target_len: int = 0,
                 tp=None):
    """Self-attention sublayer.  Returns (out, cache): ``None`` in training,
    the prefill's new cache, or the decode cache updated in place.  With
    ``tp``, this rank's heads, then the all-reduce; the caches hold this
    rank's KV heads."""
    rope_base = _rope_base(cfg, spec)
    group = _model_group(tp)
    if mode in ("train", "prefill"):
        s = x.shape[1]
        positions = torch.arange(s, device=x.device)[None, :]
        q, k, v = project_qkv(cfg, p, x, positions, rope_base, tp)
        sel = _kv_select(cfg, tp, q.shape[2])
        ka, va = _kv_heads(k, sel), _kv_heads(v, sel)
        if spec.window is not None and spec.window < s:
            out = local_attention(cfg, q, ka, va, window=spec.window, cap=cfg.attn_softcap)
        else:
            out = chunked_attention(cfg, q, ka, va, causal=True, cap=cfg.attn_softcap)
        new_cache = prefill_cache(cfg, spec, k, v, s, target_len) if mode == "prefill" else None
        y = torch.einsum("bshx,hxd->bsd", out, p["wo"].to(x.dtype))
        return (y if group is None else reduce_from_model(y, group)), new_cache
    if mode != "decode":
        raise ValueError(f"unknown mode {mode!r}")
    return _decode(cfg, p, x, cache, rope_base, tp), cache


def _decode(cfg, p, x, cache, rope_base, tp=None):
    """x: (B, 1, d) against ``cache``; writes this token's K/V at
    ``pos % cap`` and advances ``pos``, both in place.  With ``tp``, this
    rank's query heads against the KV heads they read, then the output
    projection's all-reduce."""
    b = x.shape[0]
    pos = cache["pos"]
    k_cache, v_cache = cache["k"], cache["v"]
    cap = k_cache.shape[1]
    pos_b = (pos.expand(b) if pos.ndim == 0 else pos).long()  # one position per row
    q, k, v = project_qkv(cfg, p, x, pos_b[:, None], rope_base, tp)
    rows = torch.arange(b, device=x.device)
    slot = torch.remainder(pos_b, cap)
    k_cache.index_put_((rows, slot), k[:, 0].to(k_cache.dtype))
    v_cache.index_put_((rows, slot), v[:, 0].to(v_cache.dtype))
    sel = _kv_select(cfg, tp, q.shape[2])
    k_read, v_read = _kv_heads(k_cache, sel), _kv_heads(v_cache, sel)
    j = torch.arange(cap, device=x.device)
    valid = (j[None, :] <= pos_b[:, None]) | (pos_b[:, None] >= cap)  # (B, cap)
    bias = torch.where(valid, 0.0, NEG_INF)[:, None, None, None, :]
    h, kvh, dh = q.shape[2], k_read.shape[2], q.shape[3]
    qg = q.reshape(b, 1, kvh, h // kvh, dh)
    s_att = torch.einsum("bqkgd,bckd->bkgqc", qg, k_read.to(q.dtype)).float()
    s_att = softcap(s_att / np.sqrt(cfg.head_dim), cfg.attn_softcap)
    w_att = torch.softmax(s_att + bias, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqc,bckd->bqkgd", w_att, v_read.to(q.dtype))
    out = out.reshape(b, 1, h, dh)
    pos.add_(1)
    y = torch.einsum("bshx,hxd->bsd", out, p["wo"].to(x.dtype))
    group = _model_group(tp)
    return y if group is None else reduce_from_model(y, group)


def init_attn_cache(cfg, spec, batch: int, seq_len: int, dtype=torch.bfloat16,
                    device="cuda", tp=None):
    """An empty cache: capacity ``seq_len``, or ``min(window, seq_len)``
    for a windowed layer; with ``tp``, this rank's KV heads (``ModelSplit.
    local``: a share where the axis splits them, else all)."""
    cap = seq_len if spec.window is None else min(spec.window, seq_len)
    kv = cfg.n_kv_heads if tp is None else tp.local("kv_heads", cfg.n_kv_heads)
    dh = cfg.head_dim
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
