"""Decoder layer of the dense path, after ``repro/models/blocks.py``:
pre-norm global attention, residual, pre-norm dense FFN, residual, in
training, prefill or decode mode.  Other mixers (MLA, Mamba, xLSTM,
cross-attention), MoE FFNs and post-norms are ROADMAP 1.9."""
from __future__ import annotations

import torch

from .attention import attn_forward, init_attn_cache
from .layers import apply_mlp, rms_norm

__all__ = ["apply_layer", "init_layer_cache"]


def _check_spec(spec) -> None:
    if spec.mixer != "attn" or spec.window is not None or spec.moe is not None \
            or spec.cross_source:
        raise NotImplementedError(f"layer {spec} is not ported yet (ROADMAP 1.9)")


def apply_layer(cfg, p, x, spec, *, mode="train", cache=None, target_len: int = 0):
    """One layer: p is the layer's parameter dict (mixer, ffn, norms).
    Returns (x, cache) — see ``attention.attn_forward``."""
    _check_spec(spec)
    h = rms_norm(x, p["norm_mix"]["scale"])
    h, new_cache = attn_forward(cfg, p["mixer"], h, spec, mode=mode, cache=cache,
                                target_len=target_len)
    x = x + h
    h = rms_norm(x, p["norm_ffn"]["scale"])
    return x + apply_mlp(cfg, p["ffn"], h), new_cache


def init_layer_cache(cfg, spec, batch: int, seq_len: int, dtype=torch.bfloat16,
                     device="cuda"):
    """An empty decode cache of one layer (``attn`` mixers only)."""
    _check_spec(spec)
    return init_attn_cache(cfg, spec, batch, seq_len, dtype, device)
