"""The collectives of spmd coded training: the counterparts of
``lax.psum`` and ``lax.psum_scatter(tiled=True)`` inside the reference's
``shard_map``, plus the gather that rebuilds a scattered buffer for the
optimizer (GSPMD inserts the same gather for the replicated update that
follows ``psum_scatter`` in the reference) and a replication check.

``counts`` counts the calls by collective, as the kernel wrappers count
launches: a run resets them to show how many collectives its path made.
No call copies a tensor to another device: a backend that refuses a
tensor (gloo's reduce-scatter of CUDA tensors on some torch versions)
raises.

On a meta mesh (``dist.mesh.meta_mesh``: its groups are ``MetaGroup``s)
the collectives take meta tensors only, make no ``torch.distributed``
call and return what the real ones would in shape; a real tensor there
raises, and so does a meta tensor on a real group.  Under an op counter
(``repro_torch.launch.op_analysis``) every call records its kind and
bytes under the reference's names (``all-reduce``, ``reduce-scatter``,
``all-gather``), on either kind of mesh.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..launch import op_analysis
from .mesh import MetaGroup

__all__ = ["counts", "reset_counts", "psum", "psum_scatter", "all_gather",
           "check_replicated"]

#: collectives made by this module in this process, by kind
counts = {"psum": 0, "psum_scatter": 0, "all_gather": 0, "broadcast": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def _on_meta(group, *tensors) -> bool:
    """Whether ``group`` is a meta mesh's; raises when the tensors do not
    lie where the group reduces (meta on a meta mesh, else not meta)."""
    meta = isinstance(group, MetaGroup)
    for t in tensors:
        if (t.device.type == "meta") != meta:
            raise ValueError(f"a {t.device} tensor on a {'meta' if meta else 'real'} mesh: "
                             "a meta mesh reduces meta tensors only, a process group "
                             "real ones only")
    return meta


def _size(group) -> int:
    return group.size if isinstance(group, MetaGroup) else dist.get_world_size(group)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def psum(bufs: list, group) -> list:
    """Sum each buffer over ``group`` in place: one ``all_reduce`` per
    buffer.  Returns ``bufs``."""
    for b in bufs:
        meta = _on_meta(group, b)
        with op_analysis.collective("all-reduce", _nbytes(b), _nbytes(b)):
            if not meta:
                dist.all_reduce(b, group=group)
        counts["psum"] += 1
    return bufs


def _front(t: torch.Tensor, dim: int) -> torch.Tensor:
    return t if dim == 0 else t.movedim(dim, 0).contiguous()


def psum_scatter(buf: torch.Tensor, group, dim: int = 0,
                 out: torch.Tensor = None) -> torch.Tensor:
    """Sum ``buf`` over ``group`` and keep this rank's tile of it along
    ``dim`` (``tiled=True``: the rank-th of ``n`` equal slices): one
    reduce-scatter.  ``dim`` != 0 moves that axis to the front and back.
    ``out`` (dim 0 only) receives the tile."""
    meta = _on_meta(group, buf)
    n = _size(group)
    src = _front(buf, dim)
    if src.shape[0] % n:
        raise ValueError(f"psum_scatter: dim {dim} of size {src.shape[0]} does not split "
                         f"into {n} tiles")
    shape = (src.shape[0] // n,) + tuple(src.shape[1:])
    if out is None:
        out = torch.empty(shape, dtype=src.dtype, device=src.device)
    elif dim != 0 or tuple(out.shape) != shape:
        raise ValueError(f"psum_scatter: out{tuple(out.shape)} at dim {dim}, want {shape} "
                         "at dim 0")
    with op_analysis.collective("reduce-scatter", _nbytes(src), _nbytes(out)):
        if not meta:
            reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                              or dist.reduce_scatter_tensor)
            reduce_scatter(out, src, group=group)
    counts["psum_scatter"] += 1
    return out if dim == 0 else out.movedim(0, dim)


def all_gather(tile: torch.Tensor, group, dim: int = 0,
               out: torch.Tensor = None) -> torch.Tensor:
    """The inverse of ``psum_scatter``'s split: every rank's tile,
    concatenated along ``dim`` in rank order; one all-gather.  ``out``
    (dim 0 only) receives the result."""
    meta = _on_meta(group, tile)
    n = _size(group)
    src = _front(tile, dim)
    shape = (src.shape[0] * n,) + tuple(src.shape[1:])
    if out is None:
        out = torch.empty(shape, dtype=src.dtype, device=src.device)
    elif dim != 0 or tuple(out.shape) != shape:
        raise ValueError(f"all_gather: out{tuple(out.shape)} at dim {dim}, want {shape} "
                         "at dim 0")
    with op_analysis.collective("all-gather", _nbytes(src), _nbytes(out)):
        if not meta:
            gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
            gather(out, src, group=group)
    counts["all_gather"] += 1
    return out if dim == 0 else out.movedim(0, dim)


def check_replicated(digest: bytes, device: torch.device, what: str) -> None:
    """Raise unless ``digest`` equals rank 0's: one broadcast of its
    bytes from rank 0 over the default group, on ``device`` (the
    backend's device)."""
    mine = torch.frombuffer(bytearray(digest), dtype=torch.uint8).to(device)
    theirs = mine.clone()
    dist.broadcast(theirs, src=0)
    counts["broadcast"] += 1
    if not torch.equal(mine, theirs):
        raise RuntimeError(f"rank {dist.get_rank()}: {what} differs from rank 0's")
