"""Meshes of local ranks, after ``repro/launch/mesh.py::make_local_mesh``.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --data-par 4
    torchrun --nproc-per-node 8 -m repro_torch.launch.train --data-par 4 \
        --model-par 2 --backend gloo

``make_local_mesh`` joins the default process group — from
``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK``) unless ``dist.spawn`` already did — and
builds the ``(pod, data, model)`` mesh over it; a world of another size
than ``pod · data · model`` raises.  The backend is explicit: it
defaults from the device (``nccl`` for CUDA, ``gloo`` for the CPU) and
is never switched after a failure; ``backend="gloo"`` with CUDA tensors
rehearses several ranks on one card, which NCCL refuses.

``HW`` holds the card's constants the autotuner's roofline overhead term
reads (``repro_torch.tune.tune._overhead_units``) and the dry run's
roofline terms (``repro_torch.launch.dryrun``), under the reference's
names.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..dist.mesh import Mesh, build_mesh, check_backend, default_backend

__all__ = ["make_local_mesh", "HW"]


class HW:
    """NVIDIA H100 SXM5 80GB (700 W) constants for the autotuner's and the
    dry run's rooflines, per card, under the names of the reference's
    TPU v5e ``HW``.  They are the data sheet's figures, not measurements:
    no collective on the card has been timed over NVLink yet.  The fp32
    peak is the CUDA cores' (no tensor cores: the port turns TF32 off)."""

    PEAK_FLOPS_BF16 = 989.4e12  # FLOP/s, dense bf16 on the tensor cores
    PEAK_FLOPS_FP32 = 66.9e12   # FLOP/s, fp32 without tensor cores
    HBM_BW = 3.35e12   # B/s, HBM3
    ICI_BW = 450e9     # B/s per direction, NVLink 4 (the interconnect)
    HBM_BYTES = 80 * 10**9


def make_local_mesh(data: int = 1, model: int = 1, pod: int = 1, *, device="cuda",
                    backend: str = None, timeout: float = 1800.0) -> Mesh:
    """This rank's mesh of ``pod · data`` data-parallel replicas of
    ``model`` tensor-parallel ranks each.  ``device`` ``"cuda"`` takes
    card ``LOCAL_RANK`` modulo the cards of the host; ``timeout``
    (seconds) bounds every collective."""
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized()
                                    else 0))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()!r}, the mesh asks "
                             f"for {backend!r}")
        check_backend(backend, 0, dev)
    else:
        n_local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
        check_backend(backend, n_local, dev)
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world != data * pod * model:
            raise ValueError(f"a (pod={pod}, data={data}, model={model}) mesh needs "
                             f"{data * pod * model} ranks, the world has {world}")
        dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return build_mesh(data, pod, dev, model)
