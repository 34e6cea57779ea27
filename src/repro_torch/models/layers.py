"""Shared layer primitives of the dense path, after ``repro/models/layers.py``:
rms norm with ``(1 + scale)``, the half-split RoPE, the gated-silu MLP,
and the tied embedding / unembedding."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rope", "apply_mlp", "embed_tokens", "unembed"]


def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


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


def apply_mlp(cfg, p, x):
    """Gated-silu MLP: (silu(x @ wg) * (x @ wi)) @ wo."""
    h = torch.einsum("bsd,df->bsf", x, p["wi"].to(x.dtype))
    h = F.silu(torch.einsum("bsd,df->bsf", x, p["wg"].to(x.dtype))) * h
    return torch.einsum("bsf,fd->bsd", h, p["wo"].to(x.dtype))


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


def embed_tokens(cfg, tok, tokens):
    """Row lookup.  ``F.embedding``'s backward sums each vocabulary row's
    gradient in a fixed order on the CPU and on CUDA; the backward of
    ``tok[tokens]`` (an accumulating ``index_put_``) does not, and then
    two runs of the same step differ in their last bits."""
    return F.embedding(tokens, tok).to(_dtype(cfg))


def unembed(cfg, tok, x):
    """Tied head: logits = x @ tok.T."""
    return torch.einsum("bsd,vd->bsv", x, tok.to(x.dtype))
