"""Decoder layer, after ``repro/models/blocks.py``: pre-norm attention
(global or a sliding window), the optional post-norm of the sandwich
(``post_norm``: Gemma 2 and 3), residual, pre-norm FFN — dense, or a
mixture of experts (``spec.moe``, ``moe.py``) — its optional post-norm,
residual — in training, prefill or decode mode.  Other mixers (MLA,
Mamba, xLSTM, cross-attention) are ROADMAP 1.9."""
from __future__ import annotations

import torch

from .attention import attn_forward, init_attn_cache
from .layers import apply_mlp, rms_norm
from .moe import apply_moe

__all__ = ["apply_layer", "init_layer_cache"]


def _check_spec(spec) -> None:
    if spec.mixer != "attn" or spec.cross_source:
        raise NotImplementedError(f"layer {spec} is not ported yet: the port runs "
                                  "attention + dense or MoE FFN layers (other mixers and "
                                  "cross-attention: ROADMAP 1.9)")


def apply_layer(cfg, p, x, spec, *, mode="train", cache=None, target_len: int = 0):
    """One layer: p is the layer's parameter dict (mixer, ffn, norms).
    Returns (x, cache, aux): the cache as ``attention.attn_forward`` gives
    it, aux the MoE load-balance loss (fp32), or None for a dense FFN (the
    reference's zero, which adds nothing to the sum)."""
    _check_spec(spec)
    h = rms_norm(x, p["norm_mix"]["scale"])
    h, new_cache = attn_forward(cfg, p["mixer"], h, spec, mode=mode, cache=cache,
                                target_len=target_len)
    if cfg.post_norm:
        h = rms_norm(h, p["norm_mix_post"]["scale"])
    x = x + h
    h = rms_norm(x, p["norm_ffn"]["scale"])
    if spec.moe is not None:
        h, aux = apply_moe(cfg, p["ffn"], h, spec)
    else:
        h, aux = apply_mlp(cfg, p["ffn"], h), None
    if cfg.post_norm:
        h = rms_norm(h, p["norm_ffn_post"]["scale"])
    return x + h, new_cache, aux


def init_layer_cache(cfg, spec, batch: int, seq_len: int, dtype=torch.bfloat16,
                     device="cuda"):
    """An empty decode cache of one layer (``attn`` mixers only)."""
    _check_spec(spec)
    return init_attn_cache(cfg, spec, batch, seq_len, dtype, device)
