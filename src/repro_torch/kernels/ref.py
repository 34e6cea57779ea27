"""Plain PyTorch versions of the gradient-coding kernels.

Each follows ``repro/kernels/ref.py`` — the math ``repro.kernels.ops``
computes on every backend but a TPU — and its CUDA kernel follows this
file's order, so in fp32 the two agree up to summation order (exactly,
for integer operands inside the 2^24 budget) and in bf16 up to one
rounding of the output.  Products run in full fp32: TF32 is off
(``repro_torch/device.py``).

Fold order of the fused combine (ROADMAP 3.2): the decode weight is
folded on the coefficients in fp32 — ``w = a[:, None] * B_code`` — and
``w`` is then cast to G's dtype, as ``_encode_decode_math`` does.  (The
TPU kernel itself casts ``a`` and ``B`` to G's dtype first and folds in
that dtype.)
"""
from __future__ import annotations

import torch

from ._launch import check_outputs

__all__ = ["encode_ref", "decode_ref", "encode_decode_ref", "encode_decode_leaves_ref"]


def encode_ref(b_code: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """C = B_code @ G: B rounded to G's dtype, fp32 accumulation, C in
    G's dtype.  b_code: (NB, K), g: (K, D) -> (NB, D)."""
    return torch.matmul(b_code.to(g.dtype).float(), g.float()).to(g.dtype)


def decode_ref(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """y = a @ C: a rounded to C's dtype, fp32 accumulation, y in C's
    dtype.  a: (N,), c: (N, D) -> (D,)."""
    return torch.matmul(a.to(c.dtype).float()[None, :], c.float())[0].to(c.dtype)


def encode_decode_ref(a: torch.Tensor, b_code: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """y = (a ⊙ B_code) @ G with fp32 accumulation, returned in G's dtype.

    a: (NB,), b_code: (NB, K), g: (K, D) -> (NB, D).
    """
    w = (a.float()[:, None] * b_code.float()).to(g.dtype)
    return torch.matmul(w.float(), g.float()).to(g.dtype)


def encode_decode_leaves_ref(a: torch.Tensor, b_codes: torch.Tensor, which,
                             gs: list, out: list = None) -> list:
    """The grouped fused combine: ``encode_decode_ref(a, b_codes[which[j]],
    gs[j])`` for every leaf j, in leaf order.  a: (NB,), b_codes:
    (n_w, NB, K), gs[j]: (K, D_j) -> (NB, D_j) each, written into
    ``out[j]`` when ``out`` is given (the kernel's checks: shape, G's
    dtype and device, contiguous)."""
    ys = [encode_decode_ref(a, b_codes[i], g) for i, g in zip(which, gs)]
    if out is None:
        return ys
    check_outputs("encode_decode_leaves_ref", out, gs, a.shape[0])
    for o, y in zip(out, ys):
        o.copy_(y)
    return list(out)
