"""ctypes wrapper of the coded-block encode CUDA kernel (``csrc/gc_encode.cu``).

    C = B_code @ G      B_code: (NB, K), G: (K, D) -> (NB, D) in G's dtype

Replaces ``repro/kernels/gc_encode.py::encode_pallas``.  B is rounded to
G's dtype, the products accumulate in fp32 and C is rounded once, as in
``repro/kernels/ref.py::_encode_math``; with integer operands inside the
2^24 budget (the coded checkpoint's parity digits) C is exact.

One launch computes at most ``MAX_NB`` = 8 output rows; a larger NB (the
full (N, N) code of a round trip) is cut into blocks of 8 rows, one
launch — one pass over G — each.  ``launches`` counts every launch, so a
call adds ceil(NB / 8); a run resets it to 0 to show that its path went
through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ._launch import c_call, check_operands

__all__ = ["encode", "launches", "MAX_NB"]

#: most output rows one launch computes (the kernel's unrolled NB range)
MAX_NB = 8

#: kernel launches made by ``encode`` in this process
launches = 0

_ENTRY = {torch.float32: "gc_encode_f32", torch.bfloat16: "gc_encode_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                                     ctypes.c_void_p]


def encode(b_code: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: C = B_code @ G in G's dtype.  ``b_code`` is taken
    as fp32; G must be a contiguous fp32 or bf16 CUDA tensor.  Raises on
    any launch error."""
    global launches
    if b_code.ndim != 2 or g.ndim != 2 or b_code.shape[1] != g.shape[0] \
            or b_code.shape[0] < 1:
        raise ValueError(f"shapes b_code{tuple(b_code.shape)} g{tuple(g.shape)}: "
                         "want (NB, K), (K, D) with NB >= 1")
    nb, k = b_code.shape
    check_operands("gc_encode.encode", g, min(nb, MAX_NB) * k, b_code=b_code)
    d = g.shape[1]
    b32 = b_code.to(torch.float32).contiguous()
    out = torch.empty((nb, d), dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        for r0 in range(0, nb, MAX_NB):
            rows = min(MAX_NB, nb - r0)
            c_call("gc_encode", _ENTRY[g.dtype], _ARGTYPES,
                   b32.data_ptr() + 4 * r0 * k, g.data_ptr(),
                   out.data_ptr() + out.element_size() * r0 * d, rows, k, d, stream)
            launches += 1
    return out
