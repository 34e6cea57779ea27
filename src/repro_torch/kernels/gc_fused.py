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

from ._build import load_library

__all__ = ["encode_decode", "launches", "MAX_NB", "MAX_SMEM_FLOATS"]

#: most output rows one launch computes (the kernel's unrolled NB range)
MAX_NB = 8
#: folded weights live in dynamic shared memory, 48 KB without opt-in
MAX_SMEM_FLOATS = 48 * 1024 // 4

#: kernel launches made by ``encode_decode`` in this process
launches = 0

_ENTRY = {torch.float32: "gc_fused_f32", torch.bfloat16: "gc_fused_bf16"}
_LIB = None


def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    global _LIB
    if _LIB is None:
        lib = load_library("gc_fused")
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int64, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.gc_fused_error_string.argtypes = [ctypes.c_int]
        lib.gc_fused_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(a: torch.Tensor, b_code: torch.Tensor, g: torch.Tensor) -> None:
    if not g.is_cuda:
        raise ValueError("gc_fused.encode_decode needs CUDA tensors; the "
                         "plain version is repro_torch.kernels.ref")
    for name, t in (("a", a), ("b_code", b_code)):
        if t.device != g.device:
            raise ValueError(f"{name} is on {t.device}, g on {g.device}")
    if g.dtype not in _ENTRY:
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    if g.ndim != 2 or b_code.ndim != 2 or a.ndim != 1:
        raise ValueError(f"shapes a{tuple(a.shape)} b_code{tuple(b_code.shape)} "
                         f"g{tuple(g.shape)}: want (NB,), (NB, K), (K, D)")
    nb, k = b_code.shape
    if g.shape[0] != k or a.shape[0] != nb:
        raise ValueError(f"shape mismatch: a{tuple(a.shape)} "
                         f"b_code{tuple(b_code.shape)} g{tuple(g.shape)}")
    if not 1 <= nb <= MAX_NB:
        raise ValueError(f"NB={nb} outside the kernel's range 1..{MAX_NB}")
    if nb * k > MAX_SMEM_FLOATS:
        raise ValueError(f"NB*K={nb * k} folded weights exceed shared memory "
                         f"({MAX_SMEM_FLOATS} floats)")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")


def encode_decode(a: torch.Tensor, b_code: torch.Tensor,
                  g: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: y = (a ⊙ B_code) @ G in G's dtype.  ``a`` and
    ``b_code`` are taken as fp32; G must be a contiguous fp32 or bf16
    CUDA tensor.  Raises on any launch error."""
    global launches
    _check(a, b_code, g)
    nb, k = b_code.shape
    d = g.shape[1]
    a32 = a.to(torch.float32).contiguous()
    b32 = b_code.to(torch.float32).contiguous()
    out = torch.empty((nb, d), dtype=g.dtype, device=g.device)
    lib = _lib()
    fn = getattr(lib, _ENTRY[g.dtype])
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = fn(a32.data_ptr(), b32.data_ptr(), g.data_ptr(), out.data_ptr(),
                 nb, k, d, stream)
    if err != 0:
        msg = lib.gc_fused_error_string(err).decode()
        raise RuntimeError(f"gc_fused launch failed: {msg} (cudaError {err})")
    launches += 1
    return out
