"""Public kernel entry points.

A CUDA tensor launches the hand-written kernel (a failure raises — there
is no fallback); a CPU tensor takes the plain PyTorch version, the same
math; a meta tensor takes the plain version too, which there computes
shapes only (the dry run, ``repro_torch.launch.dryrun``).  The choice
follows the device of the data tensor alone.

Under an op counter (``repro_torch.launch.op_analysis``) each entry
point records the kernel's own work as one op per launch, on every route
alike — FLOPs 2·NB·K·D per leaf plus NB·K per weight set, bytes G read
and y written once plus the weights — and nothing of what implements it.
"""
from __future__ import annotations

import torch

from ..launch import op_analysis
from . import _pipe, gc_decode, gc_encode, gc_fused, ref

__all__ = ["encode", "decode", "encode_decode", "encode_decode_leaves"]


def _work(weights: torch.Tensor, gs: list, fold: int) -> tuple:
    """(FLOPs, bytes, launches) of y_j = (a ⊙ W) @ G_j over the leaves
    ``gs`` with weight sets ``weights`` (n_w, NB, K): 2·NB·K·D_j per leaf,
    plus the fold's NB·K per weight set when ``fold``; G read and y
    written once, the fp32 weights (and ``a``) read once; one launch per
    ``_pipe.MAX_LEAVES`` leaves."""
    n_w, nb, k = weights.shape
    widths = [int(g.shape[1]) for g in gs]
    flops = sum(2.0 * nb * k * d for d in widths) + fold * n_w * nb * k
    nbytes = sum((nb + k) * d for d in widths) * gs[0].element_size() + (n_w * nb * k + nb) * 4
    return flops, nbytes, len(_pipe.plan_launches(widths, 1))


def _route(data: torch.Tensor, kernel, plain):
    if data.is_cuda:
        return kernel
    if data.device.type in ("cpu", "meta"):
        return plain
    raise ValueError(f"unsupported device {data.device}")


def encode(b_code: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Coded blocks C = B_code @ G.  b_code: (NB, K), g: (K, D) -> (NB, D)
    in G's dtype."""
    with op_analysis.kernel("gc_encode", lambda: _work(b_code[None], [g], 0)):
        return _route(g, gc_encode.encode, ref.encode_ref)(b_code, g)


def decode(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Decoded gradient y = a @ C.  a: (N,), c: (N, D) -> (D,) in C's dtype."""
    with op_analysis.kernel("gc_decode", lambda: _work(a[None, None], [c], 0)):
        return _route(c, gc_decode.decode, ref.decode_ref)(a, c)


def encode_decode(a: torch.Tensor, b_code: torch.Tensor,
                  g: torch.Tensor) -> torch.Tensor:
    """Fused coded combine y = (a ⊙ B_code) @ G — encode and decode weight
    folded into one streaming pass.  a: (NB,), b_code: (NB, K),
    g: (K, D) -> (NB, D) in G's dtype."""
    with op_analysis.kernel("gc_fused", lambda: _work(b_code[None], [g], 1)):
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
    with op_analysis.kernel("gc_fused", lambda: _work(b_codes, gs, 1)):
        return fn(a, b_codes, which, gs) if out is None else fn(a, b_codes, which, gs, out=out)
