"""ctypes wrapper of the decode CUDA kernel (``csrc/gc_decode.cu``).

    y = a @ C      a: (N,), C: (N, D) -> (D,) in C's dtype

Replaces ``repro/kernels/gc_decode.py::decode_pallas``.  ``a`` is rounded
to C's dtype, the products accumulate in fp32 and y is rounded once, as
in ``repro/kernels/ref.py::_decode_math``.  Zero weights drop the
stragglers' rows.  The kernel is ``csrc/gc_pipe.cuh``'s grouped kernel
with one leaf, NB = 1 and K = N.

``launches`` counts the kernel launches this wrapper has made (one per
call); a run resets it to 0 to show that its path went through the
kernel.
"""
from __future__ import annotations

import torch

from ._launch import as_f32, check_operands, launch_grouped

__all__ = ["decode", "launches"]

#: kernel launches made by ``decode`` in this process
launches = 0

_ENTRY = {torch.float32: "gc_decode_f32", torch.bfloat16: "gc_decode_bf16"}


def decode(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: y = a @ C in C's dtype.  ``a`` is taken as fp32;
    C must be a contiguous fp32 or bf16 CUDA tensor.  Raises on any
    launch error."""
    global launches
    if a.ndim != 1 or c.ndim != 2 or a.shape[0] != c.shape[0] or a.shape[0] < 1:
        raise ValueError(f"shapes a{tuple(a.shape)} c{tuple(c.shape)}: "
                         "want (N,), (N, D) with N >= 1")
    n, d = c.shape
    check_operands("gc_decode.decode", c, None, a=a)
    out = torch.empty((d,), dtype=c.dtype, device=c.device)
    launches += launch_grouped("gc_decode", _ENTRY[c.dtype], None, as_f32(a), 1, 1, n,
                               [c], [out], (0,))
    return out
