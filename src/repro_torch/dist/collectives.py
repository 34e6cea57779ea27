"""The collectives of spmd coded training: the counterparts of
``lax.psum`` and ``lax.psum_scatter(tiled=True)`` inside the reference's
``shard_map``, plus the gather that rebuilds a scattered buffer for the
optimizer (GSPMD inserts the same gather for the replicated update that
follows ``psum_scatter`` in the reference) and a replication check.

The model group's collectives are autograd functions, Megatron's *f*
and *g* — what GSPMD inserts around the reference's ``model``-sharded
einsums: ``copy_to_model`` (the identity forward, the gradient
all-reduced over the model ranks backward: a replicated input, or a
replicated leaf, entering a sharded region) and ``reduce_from_model``
(an all-reduce forward, the identity backward: the partial sums of a
row-sharded product leaving it); ``copy_leaves_to_model`` (*f* of
several replicated leaves at once: one all-reduce of their gradients);
``gather_from_model`` (an all-gather
forward, the rank's slice of the gradient backward: a column-sharded
product whose gathered output every rank then uses whole, as the router
of experts split over ``model``); ``gather_reduce_scatter`` (an
all-gather forward, a reduce-scatter backward: a gathered tensor each
rank uses only in part, as a head's channels on the ranks that share
the head); and ``max_over_model``, the max
all-reduce of the vocab-parallel softmax (no gradient).

``counts`` counts the data-side calls by collective and
``model_counts`` the model group's all-reduces (``copy`` counts the
backward all-reduces of *f*), as the kernel wrappers count launches
(serving's gathers — a vocab-parallel head's logits over the model
group, a step's tokens and the MoE rows' expert ids over the data group
— and ``gather_from_model``'s and ``gather_reduce_scatter``'s count
as ``all_gather``, the latter's backward as ``psum_scatter``): a run
resets them to show how many collectives its path made; ``nbytes``
adds up each kind's payload, one rank's buffer per call.
No call copies a tensor to another device: a backend that refuses a
tensor (gloo's reduce-scatter of CUDA tensors on some torch versions)
raises.

On a meta mesh (``dist.mesh.meta_mesh``: its groups are ``MetaGroup``s)
the collectives take meta tensors only, make no ``torch.distributed``
call and return what the real ones would in shape; a real tensor there
raises, and so does a meta tensor on a real group.  On a solo mesh
(``dist.mesh.solo_mesh``: ``SoloGroup``s) they take real tensors, make
no call, and return this rank's own data in the real ones' shape.  Under an op counter
(``repro_torch.launch.op_analysis``) every call records its kind and
bytes under the reference's names (``all-reduce``, ``reduce-scatter``,
``all-gather``), on either kind of mesh.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..launch import op_analysis
from .mesh import MetaGroup, SoloGroup

__all__ = ["counts", "model_counts", "nbytes", "reset_counts", "psum", "psum_scatter",
           "all_gather", "gather_rows", "broadcast", "check_replicated", "copy_to_model",
           "reduce_from_model", "copy_leaves_to_model", "gather_from_model",
           "gather_reduce_scatter", "max_over_model"]

#: collectives made by this module in this process, by kind
counts = {"psum": 0, "psum_scatter": 0, "all_gather": 0, "broadcast": 0}
#: the model group's all-reduces: f's backward, g's forward, the softmax max
model_counts = {"copy": 0, "reduce": 0, "max": 0}
#: payload bytes of every kind above (one rank's buffer per call)
nbytes = dict.fromkeys([*counts, *model_counts], 0)


def reset_counts() -> None:
    for d in (counts, model_counts, nbytes):
        for k in d:
            d[k] = 0


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
    if isinstance(group, (MetaGroup, SoloGroup)):
        return group.size
    return dist.get_world_size(group)


def _solo(group) -> bool:
    return isinstance(group, SoloGroup)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def psum(bufs: list, group) -> list:
    """Sum each buffer over ``group`` in place: one ``all_reduce`` per
    buffer.  Returns ``bufs``."""
    for b in bufs:
        meta = _on_meta(group, b)
        with op_analysis.collective("all-reduce", _nbytes(b), _nbytes(b)):
            if not (meta or _solo(group)):
                dist.all_reduce(b, group=group)
        counts["psum"] += 1
        nbytes["psum"] += _nbytes(b)
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
        if _solo(group):
            out.copy_(src[:shape[0]])
        elif not meta:
            reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                              or dist.reduce_scatter_tensor)
            reduce_scatter(out, src, group=group)
    counts["psum_scatter"] += 1
    nbytes["psum_scatter"] += _nbytes(src)
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
        if _solo(group):
            out.view(n, *src.shape).copy_(src.expand(n, *src.shape))
        elif not meta:
            gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
            gather(out, src, group=group)
    counts["all_gather"] += 1
    nbytes["all_gather"] += _nbytes(out)
    return out if dim == 0 else out.movedim(0, dim)


def gather_rows(x: torch.Tensor, split) -> torch.Tensor:
    """Every rank's block of batch rows, in row order: ``x`` (this rank's
    rows of ``split``, a ``dist.sharding.RowSplit``) all-gathered over
    each axis of ``split.mesh`` that splits them, the minor axis first;
    ``x`` itself when no axis splits them."""
    for axis in reversed(split.axes):
        x = all_gather(x, getattr(split.mesh, f"{axis}_group"))
    return x


def _first_rank(group) -> int:
    """The global rank of ``group``'s first member (0 for the world and
    a meta mesh's group)."""
    if group is None or group is dist.group.WORLD or isinstance(group, (MetaGroup, SoloGroup)):
        return 0
    return dist.get_global_rank(group, 0)


def broadcast(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` of ``group``'s first rank (rank 0 over the default group)
    written into ``t`` on every rank of the group, in place: one
    broadcast.  Returns ``t``; raises on a non-contiguous ``t``, whose
    storage a process group would send and fill in memory order."""
    if not t.is_contiguous():
        raise ValueError(f"broadcast of a non-contiguous {tuple(t.shape)} tensor "
                         f"(strides {t.stride()})")
    if not (_on_meta(group, t) or _solo(group)):
        dist.broadcast(t, src=_first_rank(group), group=group)
    counts["broadcast"] += 1
    nbytes["broadcast"] += _nbytes(t)
    return t


def check_replicated(digest: bytes, device: torch.device, what: str, group=None) -> None:
    """Raise unless ``digest`` equals that of ``group``'s first rank
    (rank 0 over the default group): one ``broadcast`` of its bytes, on
    ``device`` (the backend's device).  A meta mesh's group (one rank's
    view) has nothing to compare."""
    mine = torch.frombuffer(bytearray(digest), dtype=torch.uint8).to(device)
    theirs = broadcast(mine.clone(), group)
    if mine.device.type != "meta" and not torch.equal(mine, theirs):
        raise RuntimeError(f"rank {dist.get_rank()}: {what} differs from rank "
                           f"{_first_rank(group)}'s")


def _model_all_reduce(x: torch.Tensor, group, kind: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """One all-reduce of a fresh contiguous copy of ``x`` over the model
    group, counted as ``kind``."""
    out = x.clone(memory_format=torch.contiguous_format)
    meta = _on_meta(group, out)
    with op_analysis.collective("all-reduce", _nbytes(out), _nbytes(out)):
        if not (meta or _solo(group)):
            dist.all_reduce(out, op=op, group=group)
    model_counts[kind] += 1
    nbytes[kind] += _nbytes(out)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _model_all_reduce(grad, ctx.group, "copy"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _model_all_reduce(x, group, "reduce")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *f*: ``x`` forward; backward, its gradient summed over
    the model group ``group`` — for a replicated tensor whose every model
    rank feeds only its own shards (each rank's gradient is a partial
    sum)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *g*: ``x`` summed over the model group ``group``
    forward (a new tensor, byte-equal on every model rank); backward, the
    gradient as it comes — for the partial sums of a product over
    sharded heads, widths or vocabulary rows."""
    return _ReduceFromModel.apply(x, group)


class _CopyLeavesToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *leaves):
        ctx.group = group
        ctx.shapes = [t.shape for t in leaves]
        return tuple(t.view_as(t) for t in leaves)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        summed = _model_all_reduce(flat, ctx.group, "copy").split(
            [g.numel() for g in grads])
        return (None, *(t.view(shape) for t, shape in zip(summed, ctx.shapes)))


def copy_leaves_to_model(leaves, group) -> list:
    """*f* of replicated ``leaves`` (one dtype) that each model rank uses
    only in part: the leaves forward; backward, their gradients summed
    over the model group ``group`` in one all-reduce of the gradients
    laid end to end (counted as one ``copy``)."""
    return list(_CopyLeavesToModel.apply(group, *leaves))


class _GatherReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x.contiguous(), group, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return psum_scatter(grad.contiguous(), ctx.group, dim=ctx.dim), None, None


def gather_reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every model rank's ``x`` concatenated along ``dim`` in rank order
    (one ``all_gather``); backward, the gradient summed over the group
    and this rank's slice kept (one ``psum_scatter``) — for a gathered
    tensor each rank uses only in part, so that each rank's gradient of
    it is a partial sum."""
    return _GatherReduceScatter.apply(x, group, dim)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, dim):
        ctx.index, ctx.dim, ctx.n = index, dim, x.shape[dim]
        return all_gather(x.contiguous(), group, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, None


def gather_from_model(x: torch.Tensor, group, index: int, dim: int) -> torch.Tensor:
    """Every model rank's ``x`` concatenated along ``dim`` in rank order
    (one ``all_gather``); backward, the slice of the gradient at this
    rank's ``index`` — for a column shard's output that every rank then
    uses whole, so each rank's gradient of it is already the whole one."""
    return _GatherFromModel.apply(x, group, index, dim)


def max_over_model(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over the model group, detached."""
    return _model_all_reduce(x.detach(), group, "max", dist.ReduceOp.MAX)
