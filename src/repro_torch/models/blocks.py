"""Decoder layer of the dense path, after ``repro/models/blocks.py::apply_layer``:
pre-norm global attention, residual, pre-norm dense FFN, residual.
Other mixers (MLA, Mamba, xLSTM, cross-attention), MoE FFNs and
post-norms are ROADMAP 1.9."""
from __future__ import annotations

from .attention import attn_forward
from .layers import apply_mlp, rms_norm

__all__ = ["apply_layer"]


def apply_layer(cfg, p, x, spec):
    """One layer: p is the layer's parameter dict (mixer, ffn, norms)."""
    if spec.mixer != "attn" or spec.window is not None or spec.moe is not None \
            or spec.cross_source:
        raise NotImplementedError(f"layer {spec} is not ported yet (ROADMAP 1.9)")
    h = rms_norm(x, p["norm_mix"]["scale"])
    x = x + attn_forward(cfg, p["mixer"], h)
    h = rms_norm(x, p["norm_ffn"]["scale"])
    return x + apply_mlp(cfg, p["ffn"], h)
