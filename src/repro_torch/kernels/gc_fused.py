"""ctypes wrapper of the fused coded-combine CUDA kernel (``csrc/gc_fused.cu``).

    y = (a ⊙ B_code) @ G      a: (NB,), B_code: (NB, K), G: (K, D) -> (NB, D)

Replaces ``repro/kernels/gc_fused.py::encode_decode_pallas``.  The kernel
is memory-bound — it streams G once, (NB + K)·D·itemsize bytes — and
``csrc/gc_pipe.cuh`` says what its design does about that bound.

``encode_decode_leaves`` combines many leaves in one launch, each with
its own weight set: the training step's combine is one call.
``encode_decode`` is the same call with one leaf.

``launches`` counts the kernel launches this wrapper has made (one per
32 leaves of a call); a run resets it to 0 to show that its main path
went through the kernel.
"""
from __future__ import annotations

import torch

from ._launch import as_f32, check_operands, check_outputs, launch_grouped

__all__ = ["encode_decode", "encode_decode_leaves", "launches", "MAX_NB"]

#: most output rows one launch computes (the kernel's unrolled NB range)
MAX_NB = 8

#: kernel launches made by this wrapper in this process
launches = 0

_ENTRY = {torch.float32: "gc_fused_f32", torch.bfloat16: "gc_fused_bf16"}


def encode_decode_leaves(a: torch.Tensor, b_codes: torch.Tensor, which,
                         gs: list, out: list = None) -> list:
    """Launch the kernel over every leaf: y_j = (a ⊙ B_code[which[j]]) @ G_j
    in G's dtype.  a: (NB,), b_codes: (n_w, NB, K), taken as fp32;
    ``gs[j]``: (K, D_j), contiguous fp32 or bf16 CUDA tensors of one dtype
    on one card.  ``out``, when given, holds the (NB, D_j) outputs to
    write: contiguous tensors (views, such as slices of a level buffer,
    are fine) of G's dtype on G's card; anything else raises, nothing is
    copied.  Returns the (NB, D_j) outputs in leaf order; raises on any
    launch error."""
    global launches
    if a.ndim != 1 or b_codes.ndim != 3 or b_codes.shape[1] != a.shape[0] \
            or len(which) != len(gs):
        raise ValueError(f"shapes a{tuple(a.shape)} b_codes{tuple(b_codes.shape)}, "
                         f"{len(which)} weight indices for {len(gs)} leaves: want (NB,), "
                         "(n_w, NB, K), one index per leaf")
    n_w, nb, k = b_codes.shape
    if not 1 <= nb <= MAX_NB:
        raise ValueError(f"NB={nb} outside the kernel's range 1..{MAX_NB}")
    if not gs:
        return []
    g0 = gs[0]
    check_operands("gc_fused.encode_decode", g0, None, a=a, b_codes=b_codes)  # leaf 0
    for j, g in enumerate(gs):
        if g.ndim != 2 or g.shape[0] != k:
            raise ValueError(f"shapes b_codes{tuple(b_codes.shape)} g[{j}]{tuple(g.shape)}: "
                             "want (n_w, NB, K), (K, D)")
        if j and (g.device != g0.device or g.dtype != g0.dtype or not g.is_contiguous()):
            raise ValueError(f"gc_fused.encode_decode: leaf {j} is {g.dtype} on {g.device}"
                             f"{'' if g.is_contiguous() else ', not contiguous'}; want "
                             f"contiguous {g0.dtype} on {g0.device} like leaf 0")
        if not 0 <= which[j] < n_w:
            raise ValueError(f"weight index {which[j]} of leaf {j} outside 0..{n_w - 1}")
    if out is None:
        outs = [torch.empty((nb, g.shape[1]), dtype=g0.dtype, device=g0.device) for g in gs]
    else:
        outs = list(out)
        check_outputs("gc_fused.encode_decode", outs, gs, nb)
    launches += launch_grouped("gc_fused", _ENTRY[g0.dtype], as_f32(a), as_f32(b_codes),
                               n_w, nb, k, gs, outs, which)
    return outs


def encode_decode(a: torch.Tensor, b_code: torch.Tensor,
                  g: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: y = (a ⊙ B_code) @ G in G's dtype, the grouped
    launch with one leaf.  ``a`` and ``b_code`` are taken as fp32; G must
    be a contiguous fp32 or bf16 CUDA tensor.  Raises on any launch
    error."""
    if b_code.ndim != 2 or a.ndim != 1 or g.ndim != 2 \
            or g.shape[0] != b_code.shape[1] or a.shape[0] != b_code.shape[0]:
        raise ValueError(f"shapes a{tuple(a.shape)} b_code{tuple(b_code.shape)} "
                         f"g{tuple(g.shape)}: want (NB,), (NB, K), (K, D)")
    return encode_decode_leaves(a, b_code[None], (0,), [g])[0]
