"""Device resolution for every entry point of the port.

Entry points take ``device="cuda"`` by default.  A CUDA request on a
host without CUDA raises — the port never drops to the CPU silently;
callers that want the CPU (the tests) say ``device="cpu"``.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]

# fp32 parity: the JAX reference computes every fp32 product in full fp32,
# and the coded combine must decode to the uncoded gradient to fp32
# tolerance (ROADMAP 3.3: TF32 keeps a 10-bit mantissa, which also breaks
# the exact integer-digit encode of coded checkpoints).  Set once, here.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` when it
    names CUDA and no CUDA device is available.  ``"meta"`` gives
    shapes without storage (plans and layouts of full-size models)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev
