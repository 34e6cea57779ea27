"""Public kernel entry points.

A CUDA tensor launches the hand-written kernel (a failure raises — there
is no fallback); a CPU tensor takes the plain PyTorch version, the same
math.  The choice follows the device of the data tensor alone.
"""
from __future__ import annotations

import torch

from . import gc_decode, gc_encode, gc_fused, ref

__all__ = ["encode", "decode", "encode_decode", "encode_decode_leaves"]


def _route(data: torch.Tensor, kernel, plain):
    if data.is_cuda:
        return kernel
    if data.device.type == "cpu":
        return plain
    raise ValueError(f"unsupported device {data.device}")


def encode(b_code: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Coded blocks C = B_code @ G.  b_code: (NB, K), g: (K, D) -> (NB, D)
    in G's dtype."""
    return _route(g, gc_encode.encode, ref.encode_ref)(b_code, g)


def decode(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Decoded gradient y = a @ C.  a: (N,), c: (N, D) -> (D,) in C's dtype."""
    return _route(c, gc_decode.decode, ref.decode_ref)(a, c)


def encode_decode(a: torch.Tensor, b_code: torch.Tensor,
                  g: torch.Tensor) -> torch.Tensor:
    """Fused coded combine y = (a ⊙ B_code) @ G — encode and decode weight
    folded into one streaming pass.  a: (NB,), b_code: (NB, K),
    g: (K, D) -> (NB, D) in G's dtype."""
    return _route(g, gc_fused.encode_decode, ref.encode_decode_ref)(a, b_code, g)


def encode_decode_leaves(a: torch.Tensor, b_codes: torch.Tensor, which,
                         gs: list, out: list = None) -> list:
    """The fused coded combine of many leaves in one call:
    y_j = (a ⊙ B_code[which[j]]) @ G_j.  a: (NB,), b_codes: (n_w, NB, K),
    gs[j]: (K, D_j) on one device -> the (NB, D_j) outputs in leaf order,
    written into ``out`` (contiguous (NB, D_j) tensors or views of G's
    dtype and device) when it is given.  On CUDA one kernel launch covers
    up to 32 leaves."""
    if not gs:
        return []
    fn = _route(gs[0], gc_fused.encode_decode_leaves, ref.encode_decode_leaves_ref)
    return fn(a, b_codes, which, gs) if out is None else fn(a, b_codes, which, gs, out=out)
