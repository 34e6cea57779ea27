"""Decoder layer, after ``repro/models/blocks.py``: pre-norm mixer —
attention (global or a sliding window, ``attention.py``), multi-head
latent attention (``spec.mixer == "mla"``, ``mla.py``) or Jamba's Mamba
mixer (``"mamba"``, ``ssm.py``) — the optional post-norm of the sandwich
(``post_norm``: Gemma 2 and 3), residual, pre-norm FFN — dense, or a
mixture of experts (``spec.moe``, ``moe.py``) — its optional post-norm,
residual — in training, prefill or decode mode.  The xLSTM mixers and
cross-attention are ROADMAP 1.9."""
from __future__ import annotations

import torch

from .attention import attn_forward, init_attn_cache
from .layers import apply_mlp, rms_norm
from .mla import init_mla_cache, mla_forward
from .moe import apply_moe
from .ssm import init_mamba_cache, mamba_forward

__all__ = ["apply_layer", "init_layer_cache"]

#: the mixers the port runs: (forward, empty decode cache)
_MIXERS = {"attn": (attn_forward, init_attn_cache), "mla": (mla_forward, init_mla_cache),
           "mamba": (mamba_forward, init_mamba_cache)}


def _mixer(spec):
    if spec.mixer not in _MIXERS or spec.cross_source:
        raise NotImplementedError(f"layer {spec} is not ported yet: the port runs "
                                  "attention, MLA or Mamba + dense or MoE FFN layers "
                                  "(the xLSTM mixers and cross-attention: ROADMAP 1.9)")
    return _MIXERS[spec.mixer]


def apply_layer(cfg, p, x, spec, *, mode="train", cache=None, target_len: int = 0):
    """One layer: p is the layer's parameter dict (mixer, ffn, norms).
    Returns (x, cache, aux): the cache as the mixer's forward gives it,
    aux the MoE load-balance loss (fp32), or None for a dense FFN (the
    reference's zero, which adds nothing to the sum)."""
    forward, _ = _mixer(spec)
    h = rms_norm(x, p["norm_mix"]["scale"])
    h, new_cache = forward(cfg, p["mixer"], h, spec, mode=mode, cache=cache,
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
    """An empty decode cache of one layer: K/V for ``attn``, the latent
    ``c_kv``/``k_r`` for ``mla``, the ``conv``/``h`` state for ``mamba``."""
    _, init_cache = _mixer(spec)
    return init_cache(cfg, spec, batch, seq_len, dtype, device)
