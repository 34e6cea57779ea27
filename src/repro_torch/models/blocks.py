"""Decoder layer, after ``repro/models/blocks.py``: pre-norm mixer —
attention (global or a sliding window, ``attention.py``), gated
cross-attention over the source (``"cross_attn"``: Llama-3.2-vision's
image layers; it keeps no cache, since the source is static with respect
to the decoded tokens), multi-head latent attention (``"mla"``,
``mla.py``), Jamba's Mamba mixer (``"mamba"``, ``ssm.py``) or xLSTM's
``"mlstm"``/``"slstm"`` (``xlstm.py``) — the optional post-norm of the
sandwich (``post_norm``: Gemma 2 and 3), residual; then, when
``spec.cross_source`` (Whisper's decoder), the pre-norm cross-attention
sublayer ``cross`` over the source, residual; then, when the layer has
one, the pre-norm FFN — dense, or a mixture of experts (``spec.moe``,
``moe.py``) — its optional post-norm, residual — in training, prefill or
decode mode.  A norm is layer norm when its node has a ``bias``
(Whisper), else rms norm.  A layer has no FFN sublayer without
``use_ffn`` or with ``d_ff`` 0 and no experts (xLSTM), as the reference
decides."""
from __future__ import annotations

import torch

from .attention import attn_forward, cross_attention, init_attn_cache
from .layers import apply_mlp, apply_norm
from .mla import init_mla_cache, mla_forward
from .moe import apply_moe
from .ssm import init_mamba_cache, mamba_forward
from .xlstm import init_mlstm_cache, init_slstm_cache, mlstm_forward, slstm_forward

__all__ = ["apply_layer", "init_layer_cache", "has_ffn"]

#: the mixers the port runs: (forward, empty decode cache)
_MIXERS = {"attn": (attn_forward, init_attn_cache), "mla": (mla_forward, init_mla_cache),
           "mamba": (mamba_forward, init_mamba_cache),
           "mlstm": (mlstm_forward, init_mlstm_cache),
           "slstm": (slstm_forward, init_slstm_cache)}


def _mixer(spec):
    if spec.mixer not in _MIXERS:
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    return _MIXERS[spec.mixer]


def _cross(cfg, p, h, source, tp):
    if source is None:
        raise ValueError(f"{cfg.name}: a cross-attention layer needs its source: pass "
                         "aux_inputs (the stubbed frame or patch embeddings)")
    return cross_attention(cfg, p, h, source, tp)


def has_ffn(cfg, spec) -> bool:
    """Whether the layer has an FFN sublayer (the reference's test)."""
    return spec.use_ffn and bool(cfg.d_ff or spec.moe is not None)


def apply_layer(cfg, p, x, spec, *, mode="train", cache=None, source=None,
                target_len: int = 0, tp=None, rows=None):
    """One layer: p is the layer's parameter dict (mixer, ffn, norms);
    ``source`` (B, Ssrc, d) is what cross-attention attends to (None for
    a layer without it).  Returns (x, cache, aux): the cache as the
    mixer's forward gives it (None for a ``cross_attn`` mixer), aux the
    MoE load-balance loss (fp32), or None for a dense FFN or none (the
    reference's zero, which adds nothing to the sum).  ``tp`` is the
    ``dist.sharding.ModelSplit`` of a module on the ``model`` axis
    (``params.shard_model``): every mixer, the cross-attention, the dense
    MLP and the MoE FFN then run on this rank's shards.  ``rows``: the
    ``RowSplit`` of a serving decode's rows over the data ranks, which a
    MoE FFN's capacity counts (``moe.apply_moe``)."""
    h = apply_norm(p["norm_mix"], x)
    if spec.mixer == "cross_attn":
        h, new_cache = _cross(cfg, p["mixer"], h, source, tp), cache
    else:
        forward, _ = _mixer(spec)
        h, new_cache = forward(cfg, p["mixer"], h, spec, mode=mode, cache=cache,
                               target_len=target_len, tp=tp)
    if cfg.post_norm:
        h = apply_norm(p["norm_mix_post"], h)
    x = x + h
    if spec.cross_source:
        x = x + _cross(cfg, p["cross"], apply_norm(p["norm_cross"], x), source, tp)
    if "ffn" not in p:
        return x, new_cache, None
    h = apply_norm(p["norm_ffn"], x)
    if spec.moe is not None:
        h, aux = apply_moe(cfg, p["ffn"], h, spec, tp=tp, rows=rows)
    else:
        h, aux = apply_mlp(cfg, p["ffn"], h, tp), None
    if cfg.post_norm:
        h = apply_norm(p["norm_ffn_post"], h)
    return x + h, new_cache, aux


def init_layer_cache(cfg, spec, batch: int, seq_len: int, dtype=torch.bfloat16,
                     device="cuda", tp=None):
    """An empty decode cache of one layer: K/V for ``attn``, the latent
    ``c_kv``/``k_r`` for ``mla``, the ``conv``/``h`` state for ``mamba``,
    ``C``/``n``/``m``/``conv`` for ``mlstm``, ``h``/``c``/``n``/``m`` for
    ``slstm``; None for ``cross_attn`` (its K/V come from the source,
    recomputed each step).  ``tp``: a sharded module's ``ModelSplit``
    (attention then holds this rank's KV heads, MLA the whole latent,
    Mamba the rank's channels, the mLSTM and the sLSTM the rank's
    heads)."""
    if spec.mixer == "cross_attn":
        return None
    _, init_cache = _mixer(spec)
    return init_cache(cfg, spec, batch, seq_len, dtype, device, tp=tp)
