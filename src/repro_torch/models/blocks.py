"""Decoder layer of the dense path, after ``repro/models/blocks.py``:
pre-norm attention (global or a sliding window), the optional post-norm
of the sandwich (``post_norm``: Gemma 2 and 3), residual, pre-norm dense
FFN, its optional post-norm, residual — in training, prefill or decode
mode.  Other mixers (MLA, Mamba, xLSTM, cross-attention) and MoE FFNs
are ROADMAP 1.9."""
from __future__ import annotations

import torch

from .attention import attn_forward, init_attn_cache
from .layers import apply_mlp, rms_norm

__all__ = ["apply_layer", "init_layer_cache"]


def _check_spec(spec) -> None:
    if spec.mixer != "attn" or spec.moe is not None or spec.cross_source:
        raise NotImplementedError(f"layer {spec} is not ported yet: the port runs "
                                  "attention + dense FFN layers (other mixers, MoE and "
                                  "cross-attention: ROADMAP 1.9)")


def apply_layer(cfg, p, x, spec, *, mode="train", cache=None, target_len: int = 0):
    """One layer: p is the layer's parameter dict (mixer, ffn, norms).
    Returns (x, cache) — see ``attention.attn_forward``."""
    _check_spec(spec)
    h = rms_norm(x, p["norm_mix"]["scale"])
    h, new_cache = attn_forward(cfg, p["mixer"], h, spec, mode=mode, cache=cache,
                                target_len=target_len)
    if cfg.post_norm:
        h = rms_norm(h, p["norm_mix_post"]["scale"])
    x = x + h
    h = apply_mlp(cfg, p["ffn"], rms_norm(x, p["norm_ffn"]["scale"]))
    if cfg.post_norm:
        h = rms_norm(h, p["norm_ffn_post"]["scale"])
    return x + h, new_cache


def init_layer_cache(cfg, spec, batch: int, seq_len: int, dtype=torch.bfloat16,
                     device="cuda"):
    """An empty decode cache of one layer (``attn`` mixers only)."""
    _check_spec(spec)
    return init_attn_cache(cfg, spec, batch, seq_len, dtype, device)
