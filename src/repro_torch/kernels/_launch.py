"""What the kernel wrappers share: operand checks, the ctypes call, and
the launch of ``csrc/gc_pipe.cuh``'s grouped kernel.

Every CUDA source ``csrc/<name>.cu`` exports plain C entry points that
launch one kernel on the stream they are given and return its
``cudaGetLastError()`` code, and ``<name>_error_string`` to name a code.
``c_call`` declares an entry's signature at first use, calls it and
raises when the code is not 0 — there is no fallback.

The host path of a call is kept short: conversions that would do nothing
are skipped (``as_f32``), the grouped kernel's packed launch arguments
are cached by widths and pointers (``pipe_launches``: a repeated call
finds them), and the device is switched only when the data is not on the
current one.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _pipe
from ._build import load_library

__all__ = ["c_call", "check_operands", "check_outputs", "as_f32", "launch_grouped", "pipe_launches",
           "smem_per_block", "MAX_SMEM_FLOATS", "PIPE_ARGTYPES"]

#: per-block weights live in dynamic shared memory, 48 KB without opt-in
MAX_SMEM_FLOATS = 48 * 1024 // 4

#: the grouped kernel's entry points (gc_fused.cu, gc_decode.cu): scale,
#: table, nb, n_w, k, tile_cols, stages, n_leaves, leaves, n_tiles, stream
PIPE_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [
    ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p]

_DTYPES = (torch.float32, torch.bfloat16)

#: {(library, device): the device's opt-in shared memory of one block, bytes}
_SMEM = {}


def check_operands(kernel: str, data: torch.Tensor, n_weights: int | None,
                   **coeffs: torch.Tensor) -> None:
    """Raise unless ``data`` is a contiguous fp32/bf16 CUDA tensor,
    every coefficient tensor lies on its device and the kernel's
    ``n_weights`` per-block weights fit in 48 KB of shared memory
    (``None``: the grouped kernel's planner checks them against the
    card's own)."""
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
    if n_weights is not None and n_weights > MAX_SMEM_FLOATS:
        raise ValueError(f"{kernel}: {n_weights} weights exceed shared memory "
                         f"({MAX_SMEM_FLOATS} floats)")


def check_outputs(kernel: str, outs: list, gs: list, nb: int) -> None:
    """Raise unless ``outs[j]`` can take leaf j's (NB, D_j) output as it
    is: that shape, contiguous, G's dtype, on G's device."""
    if len(outs) != len(gs):
        raise ValueError(f"{kernel}: {len(outs)} outputs for {len(gs)} leaves")
    for j, (o, g) in enumerate(zip(outs, gs)):
        if tuple(o.shape) != (nb, g.shape[1]) or o.dtype != g.dtype \
                or o.device != g.device or not o.is_contiguous():
            raise ValueError(f"{kernel}: output {j} is {o.dtype}{tuple(o.shape)} on {o.device}"
                             f"{'' if o.is_contiguous() else ', not contiguous'}; want "
                             f"contiguous {g.dtype}{(nb, g.shape[1])} on {g.device}")


def as_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous fp32 tensor, without a copy when it is one."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.to(torch.float32).contiguous()


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


def smem_per_block(name: str, dev: int) -> int:
    """The opt-in shared memory of one block of the current device
    ``dev``, in bytes, as ``csrc/<name>.cu`` reads it (once per device)."""
    got = _SMEM.get((name, dev))
    if got is None:
        out = ctypes.c_int(0)
        c_call(name, f"{name}_smem_per_block", [ctypes.POINTER(ctypes.c_int)],
               ctypes.byref(out))
        got = _SMEM[(name, dev)] = out.value
    return got


@functools.lru_cache(maxsize=256)
def pipe_launches(widths: tuple, k: int, itemsize: int, n_weights: int, smem: int,
                  g_ptrs: tuple, out_ptrs: tuple, which: tuple) -> tuple:
    """The grouped kernel's launches over these leaves, as the entry
    points take them: (tile_cols, stages, n_leaves, packed leaf
    descriptors, n_tiles) each (``_pipe``'s planner, cached: a training
    run repeats one list of widths every step, and the caching allocator
    often hands a repeated call the same pointers)."""
    tile_cols, stages = _pipe.tile_shape(k, itemsize, n_weights, smem)
    modes = [_pipe.leaf_mode(d, itemsize, gp, op, stages)
             for d, gp, op in zip(widths, g_ptrs, out_ptrs)]
    return tuple((tile_cols, stages, len(launch.leaves),
                  _pipe.descriptors(launch, g_ptrs, out_ptrs, widths, which, modes),
                  launch.n_tiles)
                 for launch in _pipe.plan_launches(widths, tile_cols))


def launch_grouped(name: str, entry: str, scale, table: torch.Tensor, n_w: int, nb: int,
                   k: int, gs: list, outs: list, which) -> int:
    """Launch ``csrc/<name>.cu``'s grouped kernel over the leaves ``gs``
    (checked contiguous (K, D_j) CUDA tensors of one dtype on one card)
    into ``outs``: out_j = w[which_j] @ G_j with w = scale ⊙ table, or
    the table alone when ``scale`` is None.  ``scale`` (NB,) and
    ``table`` (n_w, NB, K) are contiguous fp32.  The device is made
    current only when it is not already.  Returns the number of launches
    made: one per ``_pipe.MAX_LEAVES`` leaves."""
    dev = gs[0].device.index
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch_on_current(name, entry, scale, table, n_w, nb, k, gs, outs, which,
                                      dev)
    return _launch_on_current(name, entry, scale, table, n_w, nb, k, gs, outs, which, dev)


def _launch_on_current(name, entry, scale, table, n_w, nb, k, gs, outs, which, dev) -> int:
    launches = pipe_launches(tuple([g.shape[1] for g in gs]), k, gs[0].element_size(),
                             n_w * nb * k, smem_per_block(name, dev),
                             tuple([g.data_ptr() for g in gs]),
                             tuple([o.data_ptr() for o in outs]), tuple(map(int, which)))
    scale_ptr = None if scale is None else scale.data_ptr()
    table_ptr = table.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    for tile_cols, stages, n_leaves, leaves, n_tiles in launches:
        c_call(name, entry, PIPE_ARGTYPES, scale_ptr, table_ptr, nb, n_w, k, tile_cols, stages,
               n_leaves, leaves, n_tiles, stream)
    return len(launches)
