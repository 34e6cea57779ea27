"""Plain PyTorch version of the gradient-coding combine.

Fold order (ROADMAP 3.2): the decode weight is folded on the
coefficients in fp32 — ``w = a[:, None] * B_code`` — and ``w`` is then
cast to G's dtype, exactly as ``repro/kernels/ref.py::_encode_decode_math``
does, which is what ``repro.kernels.ops.encode_decode`` computes on every
backend but a TPU.  (The TPU kernel itself casts ``a`` and ``B`` to G's
dtype first and folds in that dtype.)  The CUDA kernel follows this
file's order, so for fp32 the two agree up to summation order and for
bf16 they agree to bf16 rounding.
"""
from __future__ import annotations

import torch

__all__ = ["encode_decode_ref"]


def encode_decode_ref(a: torch.Tensor, b_code: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """y = (a ⊙ B_code) @ G with fp32 accumulation, returned in G's dtype.

    a: (NB,), b_code: (NB, K), g: (K, D) -> (NB, D).
    """
    w = (a.float()[:, None] * b_code.float()).to(g.dtype)
    return torch.matmul(w.float(), g.float()).to(g.dtype)
