"""Shared layer primitives of the dense path, after ``repro/models/layers.py``:
rms norm with ``(1 + scale)`` and Whisper's layer norm (``apply_norm``
picks layer norm when the norm node has a ``bias``, as the reference
does), the softcap, the half-split RoPE, the MLP — gated (SwiGLU or
GeGLU) when it has ``wg``, else Whisper's ungated GELU MLP — and the
embedding (scaled by sqrt(d_model) for the Gemma family) and
unembedding (tied, or Qwen's and Mixtral's untied ``embed.unembed``;
with the final softcap).

On the ``model`` axis (``tp``: the ``dist.sharding.ModelSplit`` of a
module from ``params.shard_model``) the MLP is Megatron's: ``wi`` and ``wg`` are
column shards and ``wo`` a row shard, so the rank's output is a partial
sum, all-reduced over the model group (``reduce_from_model``) while the
input's gradient is all-reduced backward (``copy_to_model``); an MLP
whose width the axis does not divide stays replicated and needs no
collective (decided per MLP, from its width).  The embedding is
vocab-parallel — ids outside the rank's rows looked up as row 0 and
zeroed, then all-reduced — and the head
gives the rank's slice of the logits (``model._xent`` reduces them in
training; serving all-gathers the rows it samples, ``gather_vocab``).
``tp.axes`` says which of the logical axes ``mlp`` and ``vocab`` are
split."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..dist.collectives import all_gather, copy_to_model, reduce_from_model

__all__ = ["rms_norm", "layer_norm", "apply_norm", "softcap", "rope", "apply_mlp",
           "embed_tokens", "unembed", "gather_vocab", "vocab_start"]


def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """Layer norm in fp32 (mean, biased variance, ``rsqrt(var + eps)``,
    then ``* scale + bias``), cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def apply_norm(p, x):
    """Layer norm when the norm node ``p`` has a ``bias``, else rms norm."""
    if "bias" in p:
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


def softcap(x, cap: float):
    """``tanh(x / cap) * cap`` in x's dtype; the identity when ``cap`` is 0."""
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


@functools.lru_cache(maxsize=16)
def _rope_freq(base: float, half: int, device: torch.device):
    """The (half,) fp32 frequencies, computed in numpy as the reference
    does and copied to ``device`` once: a decode step then makes no host
    to device copy (and can be captured in a CUDA graph)."""
    freq = base ** (-np.arange(0, half, dtype=np.float32) / half)
    return torch.from_numpy(freq).to(device)


def rope(x, positions, base: float = 10_000.0):
    """Rotary embedding.  x: (..., S, H, D) or (..., S, D); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = _rope_freq(float(base), half, x.device)
    ang = positions[..., None].float() * freq  # (..., S, half)
    if x.ndim == ang.ndim + 1:  # head axis present
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _act(cfg, x):
    """silu, or the tanh form of gelu (``jax.nn.gelu(approximate=True)``;
    torch's default gelu is the erf form)."""
    if cfg.activation == "silu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")


def apply_mlp(cfg, p, x, tp=None, width: int = 0):
    """The MLP: gated, (act(x @ wg) * (x @ wi)) @ wo with act silu
    (SwiGLU) or gelu (GeGLU), when ``p`` has ``wg``; else ungated,
    act(x @ wi) @ wo (``activation="gelu_mlp"``: tanh gelu).  With
    ``tp``, where the rank holds fewer columns than the MLP's ``width``
    (``cfg.d_ff`` when 0; a MoE's shared experts pass theirs), its
    columns, then the all-reduce: the reference splits each MLP where its
    own width divides the axis, so one model can split one and not
    another (DeepSeek's dense MLP and shared experts)."""
    split = tp is not None and p["wi"].shape[-1] != (width or cfg.d_ff)
    group = tp.model_group if split else None
    if group is not None:
        x = copy_to_model(x, group)
    h = torch.einsum("bsd,df->bsf", x, p["wi"].to(x.dtype))
    if "wg" in p:
        h = _act(cfg, torch.einsum("bsd,df->bsf", x, p["wg"].to(x.dtype))) * h
    else:
        h = _act(cfg, h)
    out = torch.einsum("bsf,fd->bsd", h, p["wo"].to(x.dtype))
    return out if group is None else reduce_from_model(out, group)


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


def vocab_start(n_local: int, tp) -> int:
    """The first vocabulary row of this rank's ``n_local`` rows, or None
    when the rows are the whole vocabulary (no ``tp``, or not split)."""
    if tp is None or "vocab" not in tp.axes:
        return None
    return tp.model_index * n_local


def embed_tokens(cfg, tok, tokens, tp=None):
    """Row lookup.  ``F.embedding``'s backward sums each vocabulary row's
    gradient in a fixed order on the CPU and on CUDA; the backward of
    ``tok[tokens]`` (an accumulating ``index_put_``) does not, and then
    two runs of the same step differ in their last bits.  With ``tp`` and
    split rows, the rank's rows only, summed over the model group (one
    rank holds each id: the sum is exact)."""
    start = vocab_start(tok.shape[0], tp)
    if start is None:
        x = F.embedding(tokens, tok)
    else:
        local = tokens - start
        inside = (local >= 0) & (local < tok.shape[0])
        x = F.embedding(torch.where(inside, local, 0), tok)
        x = reduce_from_model(torch.where(inside[..., None], x, 0.0), tp.model_group)
    x = x.to(_dtype(cfg))
    if cfg.scale_embed:
        x = x * _embed_scale(cfg.d_model, x.dtype)
    return x


@functools.lru_cache(maxsize=16)
def _embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """sqrt(d_model) rounded to the activations' dtype, as the reference
    rounds it (bf16: 45.25 for 2048, 73.5 for 5376), as a Python number:
    no device copy, so a decode step stays capturable in a CUDA graph."""
    return float(torch.tensor(np.sqrt(d_model), dtype=dtype))


def unembed(cfg, embed, x, tp=None):
    """logits = softcap(x @ W, final_softcap): W is ``embed["unembed"]``
    (d, vocab) for an untied head, else ``embed["tok"].T``.  With ``tp``
    and split rows, this rank's slice of the vocabulary."""
    rows = embed["unembed"].shape[1] if "unembed" in embed else embed["tok"].shape[0]
    if vocab_start(rows, tp) is not None:
        x = copy_to_model(x, tp.model_group)
    if "unembed" in embed:
        logits = torch.einsum("bsd,dv->bsv", x, embed["unembed"].to(x.dtype))
    else:
        logits = torch.einsum("bsd,vd->bsv", x, embed["tok"].to(x.dtype))
    return softcap(logits, cfg.final_softcap)


def gather_vocab(logits, tp=None):
    """The whole vocabulary's logits from this rank's slice of them: one
    all-gather over the model group, the slices in rank order (row
    ``start`` of rank r is ``r · n_local``); ``logits`` themselves where
    the vocabulary is not split."""
    if vocab_start(logits.shape[-1], tp) is None:
        return logits
    return all_gather(logits.contiguous(), tp.model_group, dim=logits.ndim - 1)
