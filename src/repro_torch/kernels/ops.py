"""Public kernel entry points.

A CUDA tensor launches the hand-written kernel (a failure raises — there
is no fallback); a CPU tensor takes the plain PyTorch version, the same
math.  The choice follows the device of the tensor alone.
"""
from __future__ import annotations

import torch

from . import gc_fused, ref

__all__ = ["encode_decode"]


def encode_decode(a: torch.Tensor, b_code: torch.Tensor,
                  g: torch.Tensor) -> torch.Tensor:
    """Fused coded combine y = (a ⊙ B_code) @ G — encode and decode weight
    folded into one streaming pass.  a: (NB,), b_code: (NB, K),
    g: (K, D) -> (NB, D) in G's dtype."""
    if g.is_cuda:
        return gc_fused.encode_decode(a, b_code, g)
    if g.device.type == "cpu":
        return ref.encode_decode_ref(a, b_code, g)
    raise ValueError(f"encode_decode: unsupported device {g.device}")
