"""ctypes wrapper of the fused coded-combine CUDA kernel (``csrc/gc_fused.cu``).

    y = (a ⊙ B_code) @ G      a: (NB,), B_code: (NB, K), G: (K, D) -> (NB, D)

Replaces ``repro/kernels/gc_fused.py::encode_decode_pallas``.  The kernel
is memory-bound — it streams G once, (NB + K)·D·itemsize bytes — and its
source says what its design does about that bound.

``launches`` counts the kernel launches this wrapper has made (one per
call); a run resets it to 0 to show that its main path went through the
kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ._launch import c_call, check_operands

__all__ = ["encode_decode", "launches", "MAX_NB"]

#: most output rows one launch computes (the kernel's unrolled NB range)
MAX_NB = 8

#: kernel launches made by ``encode_decode`` in this process
launches = 0

_ENTRY = {torch.float32: "gc_fused_f32", torch.bfloat16: "gc_fused_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                                     ctypes.c_void_p]


def encode_decode(a: torch.Tensor, b_code: torch.Tensor,
                  g: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: y = (a ⊙ B_code) @ G in G's dtype.  ``a`` and
    ``b_code`` are taken as fp32; G must be a contiguous fp32 or bf16
    CUDA tensor.  Raises on any launch error."""
    global launches
    if b_code.ndim != 2 or a.ndim != 1 or g.ndim != 2 \
            or g.shape[0] != b_code.shape[1] or a.shape[0] != b_code.shape[0]:
        raise ValueError(f"shapes a{tuple(a.shape)} b_code{tuple(b_code.shape)} "
                         f"g{tuple(g.shape)}: want (NB,), (NB, K), (K, D)")
    nb, k = b_code.shape
    if not 1 <= nb <= MAX_NB:
        raise ValueError(f"NB={nb} outside the kernel's range 1..{MAX_NB}")
    check_operands("gc_fused.encode_decode", g, nb * k, a=a, b_code=b_code)
    d = g.shape[1]
    a32 = a.to(torch.float32).contiguous()
    b32 = b_code.to(torch.float32).contiguous()
    out = torch.empty((nb, d), dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        c_call("gc_fused", _ENTRY[g.dtype], _ARGTYPES, a32.data_ptr(),
               b32.data_ptr(), g.data_ptr(), out.data_ptr(), nb, k, d, stream)
    launches += 1
    return out
