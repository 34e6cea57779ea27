"""What the kernel wrappers share: operand checks and the ctypes call.

Every CUDA source ``csrc/<name>.cu`` exports plain C entry points that
launch one kernel on the stream they are given and return its
``cudaGetLastError()`` code, and ``<name>_error_string`` to name a code.
``c_call`` declares an entry's signature at first use, calls it and
raises when the code is not 0 — there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load_library

__all__ = ["c_call", "check_operands", "MAX_SMEM_FLOATS"]

#: per-block weights live in dynamic shared memory, 48 KB without opt-in
MAX_SMEM_FLOATS = 48 * 1024 // 4

_DTYPES = (torch.float32, torch.bfloat16)


def check_operands(kernel: str, data: torch.Tensor, n_weights: int,
                   **coeffs: torch.Tensor) -> None:
    """Raise unless ``data`` is a contiguous fp32/bf16 CUDA tensor,
    every coefficient tensor lies on its device and the kernel's
    ``n_weights`` per-block weights fit in shared memory."""
    if not data.is_cuda:
        raise ValueError(f"{kernel} needs CUDA tensors; the plain version is "
                         "repro_torch.kernels.ref")
    for name, t in coeffs.items():
        if t.device != data.device:
            raise ValueError(f"{name} is on {t.device}, the data on {data.device}")
    if data.dtype not in _DTYPES:
        raise TypeError(f"{kernel}: data must be float32 or bfloat16, got {data.dtype}")
    if not data.is_contiguous():
        raise ValueError(f"{kernel}: data must be contiguous")
    if n_weights > MAX_SMEM_FLOATS:
        raise ValueError(f"{kernel}: {n_weights} weights exceed shared memory "
                         f"({MAX_SMEM_FLOATS} floats)")


def c_call(name: str, entry: str, argtypes: list, *args) -> None:
    """Call ``entry`` of ``csrc/<name>.cu``'s library (built at first use)
    with ``args``; raise ``RuntimeError`` when it returns a CUDA error."""
    lib = load_library(name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        describe = getattr(lib, f"{name}_error_string")
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        raise RuntimeError(f"{name} launch failed: {describe(err).decode()} "
                           f"(cudaError {err})")
