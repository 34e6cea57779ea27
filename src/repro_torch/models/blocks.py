"""Decoder layer, after ``repro/models/blocks.py``: pre-norm mixer —
attention (global or a sliding window, ``attention.py``), multi-head
latent attention (``spec.mixer == "mla"``, ``mla.py``), Jamba's Mamba
mixer (``"mamba"``, ``ssm.py``) or xLSTM's ``"mlstm"``/``"slstm"``
(``xlstm.py``) — the optional post-norm of the sandwich (``post_norm``:
Gemma 2 and 3), residual, then, when the layer has one, the pre-norm FFN
— dense, or a mixture of experts (``spec.moe``, ``moe.py``) — its
optional post-norm, residual — in training, prefill or decode mode.  A
layer has no FFN sublayer without ``use_ffn`` or with ``d_ff`` 0 and no
experts (xLSTM), as the reference decides.  Cross-attention is ROADMAP
1.9."""
from __future__ import annotations

import torch

from .attention import attn_forward, init_attn_cache
from .layers import apply_mlp, rms_norm
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
    if spec.mixer not in _MIXERS or spec.cross_source:
        raise NotImplementedError(f"layer {spec} is not ported yet: the port runs "
                                  "attention, MLA, Mamba, mLSTM or sLSTM mixers + dense or "
                                  "MoE FFN layers (cross-attention: ROADMAP 1.9)")
    return _MIXERS[spec.mixer]


def has_ffn(cfg, spec) -> bool:
    """Whether the layer has an FFN sublayer (the reference's test)."""
    return spec.use_ffn and bool(cfg.d_ff or spec.moe is not None)


def apply_layer(cfg, p, x, spec, *, mode="train", cache=None, target_len: int = 0):
    """One layer: p is the layer's parameter dict (mixer, ffn, norms).
    Returns (x, cache, aux): the cache as the mixer's forward gives it,
    aux the MoE load-balance loss (fp32), or None for a dense FFN or none
    (the reference's zero, which adds nothing to the sum)."""
    forward, _ = _mixer(spec)
    h = rms_norm(x, p["norm_mix"]["scale"])
    h, new_cache = forward(cfg, p["mixer"], h, spec, mode=mode, cache=cache,
                           target_len=target_len)
    if cfg.post_norm:
        h = rms_norm(h, p["norm_mix_post"]["scale"])
    x = x + h
    if "ffn" not in p:
        return x, new_cache, None
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
    ``c_kv``/``k_r`` for ``mla``, the ``conv``/``h`` state for ``mamba``,
    ``C``/``n``/``m``/``conv`` for ``mlstm``, ``h``/``c``/``n``/``m`` for
    ``slstm``."""
    _, init_cache = _mixer(spec)
    return init_cache(cfg, spec, batch, seq_len, dtype, device)
