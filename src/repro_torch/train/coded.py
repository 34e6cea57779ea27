"""Coded gradients in sim mode: the redundant per-shard backward passes
and the coded combine, after ``repro/train/coded.py``
(``make_coded_grad_fn(mode="sim")``, ``combine_grads``, ``combine_level``,
``uncoded_grad_fn``).

Per step, for a plan over N workers with K = s_max + 1 shards each:

* one ``(N·K, size)`` buffer is allocated per leaf;
* N·K backward passes (``torch.autograd.grad`` of ``train_loss``) run in
  worker-major order, each copied into its row — the honest redundancy
  work eq. (2) prices;
* one ``ops.encode_decode_leaves(1/N, dec_w ⊙ b_rows, level, G)`` call
  for all leaves folds encode, decode weight, worker sum and the 1/N
  mean into a single streaming pass per leaf, each leaf with its level's
  weights — one launch of the hand-written ``gc_fused`` kernel per step
  on CUDA.

That is ``pipeline="flat"``.  ``combine_level`` is its unit for one
redundancy level — one grouped call over that level's leaves — which the
wave-pipelined loop fires at the level's decode event; the union over
the levels equals ``combine_rows`` bit for bit.  ``pipeline="tree"`` is
the reference's per-leaf baseline in plain torch ops: per worker and
leaf, encode its K shard rows with the coding row, scale by the decode
weight, then sum over workers and take the mean (the reference computes
it outside any Pallas kernel too).

``mode="spmd"`` is the same system on N data-parallel ranks over
``torch.distributed`` (a ``repro_torch.dist.mesh.Mesh``), after the
reference's ``_make_flat_spmd_grad_fn`` and tree spmd path: each rank
runs only its own K per-shard passes, and

* ``pipeline="flat"``: one grouped ``ops.encode_decode_leaves`` call
  over all leaves (one ``gc_fused`` launch on CUDA), weight set ``li``
  the fp32 fold ``(dec_w[li, rank] / (N·P)) · b_rows[rank, li]``, each
  leaf written straight into its slice of the plan's per-level
  buffers, which are allocated once and reused every step; one bf16
  cast of the packed buffers when ``grad_dtype`` asks; one ``psum`` per
  level over the pod ranks when there are any, then one ``psum`` — or
  one reduce-scatter and one all-gather — per level over the data
  ranks; the leaves are views of the level buffers;
* ``pipeline="tree"``: the per-leaf encode and scale in plain torch,
  then one collective per leaf (the reduce-scatter along
  ``scatter_dims``' dimension of each leaf).

Every rank returns bit-identical gradients, so replicated optimizers
stay replicated.

On a mesh with a ``model`` axis each rank holds its shards
(``models.params.shard_model``), and every model rank of a data index
reads that worker's batches.  The plan is the full tree's, the same on
every rank; the rank's layout (``local_layout``) keeps the plan's leaf
levels over the local shapes, so the grouped launch writes the local
rows into local level buffers, the collectives run per level over the
data group, and the unpack gives the local leaves.  A plan built from
the shards' shapes would put leaves on other levels.  Every rank of a
model index returns the same bytes, and a replicated leaf's gradient is
byte-equal across the model ranks.

Where the config sets ``fsdp`` and the ``data`` axis cuts a leaf
(``models.params.data_dims``), the rank's state holds its data slice of
that leaf (``init_shards(..., over_data=True)``).  The passes then run
on the working module (``gather_data``: one all-gather per cut leaf,
once a step), the combine and the collectives run over the working
layout exactly as above, and the rank keeps its slice of each cut
leaf's decoded gradient; the tree pipeline's ``psum_scatter`` scatters a
cut leaf on that same dimension and keeps the tile (``scatter_dims``
prefers ``embed``), without the all-gather.  The gradients then take
the state's shapes, and the data ranks of a model index hold different
slices.

For every straggler realization the result equals the plain
data-parallel mean gradient over the same global batch (tested).

A model with a cross-attention source (Whisper, Llama-3.2-vision) takes
``worker_aux`` (N, K, rows, ...) beside the (N, K, rows, S+1) tokens:
the stubbed modality embeddings of each worker's shards, in the same
layout (the caller allocates them with the tokens' cyclic map; an spmd
rank slices its part as it slices its tokens).  Each per-shard pass then
trains on ``{"tokens", "aux_inputs"}``.  Without ``worker_aux`` such a
model raises.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core import Plan
from ..core.flat import FlatLayout
from ..dist.collectives import all_gather, psum, psum_scatter
from ..kernels import ops
from ..launch import op_analysis
from ..models.model import has_source, train_loss
from ..models.params import GCLM, data_dims, data_shard_of, gather_data, local_shapes

__all__ = ["make_coded_grad_fn", "uncoded_grad_fn", "per_shard_grad_rows",
           "level_weights", "combine_rows", "combine_level", "combine_grads",
           "tree_combine", "scatter_dims", "local_layout", "CodedGrads"]

REDUCE_MODES = ("psum", "psum_scatter")


def _require_layout(plan: Plan):
    if plan.flat_layout is None:
        raise ValueError(
            "pipeline='flat' needs plan.flat_layout — build the plan from the "
            "model (Plan.build(model, env, ...)); plans built from bare cost "
            "vectors carry no leaf shapes (use pipeline='tree')")
    return plan.flat_layout


def _resolve_pipeline(pipeline: str, plan: Plan) -> str:
    if pipeline == "auto":
        return "flat" if plan.flat_layout is not None else "tree"
    if pipeline == "flat":
        _require_layout(plan)
        return "flat"
    if pipeline == "tree":
        return "tree"
    raise ValueError(f"unknown pipeline {pipeline!r}; "
                     "expected 'auto', 'flat', or 'tree'")


def _check_aux(cfg, aux) -> None:
    if aux is None and has_source(cfg):
        raise ValueError(f"{cfg.name} cross-attends to a source: pass worker_aux "
                         "(N, K, rows, ...), the stubbed modality embeddings of every "
                         "shard, beside the tokens")


def _batch(tokens, aux):
    return {"tokens": tokens} if aux is None else {"tokens": tokens, "aux_inputs": aux}


def per_shard_grad_rows(cfg, model, worker_batches, worker_aux=None) -> list:
    """Run the N·K per-shard backward passes; returns one ``(N·K, size)``
    tensor per leaf (row n·K + k: worker n's k-th shard).  ``worker_aux``
    (N, K, rows, ...) gives each pass its ``aux_inputs``.  On meta under
    an op counter one pass runs, counted N·K times (``op_analysis.trips``)."""
    _check_aux(cfg, worker_aux)
    leaves = model.leaves()
    dev = leaves[0].device
    wb = torch.as_tensor(worker_batches, device=dev)  # (N, K, rows, S+1)
    wa = None if worker_aux is None else torch.as_tensor(worker_aux, device=dev)
    n, k = wb.shape[0], wb.shape[1]
    rows = [torch.empty((n * k, t.numel()), dtype=t.dtype, device=dev)
            for t in leaves]
    passes = [(w, s) for w in range(n) for s in range(k)]
    with op_analysis.trips(len(passes), wb) as run:
        for w, s in passes[:run]:
            loss, _ = train_loss(cfg, model, _batch(wb[w, s], None if wa is None else wa[w, s]))
            for buf, g in zip(rows, torch.autograd.grad(loss, leaves)):
                buf[w * k + s].copy_(g.reshape(-1))
    return rows


def level_weights(plan: Plan, dec_w, device, levels=None) -> torch.Tensor:
    """The fused combine's weight sets ``dec_w ⊙ b_rows``, one per level:
    ``w[i, 0, n·K + k] = dec_w[i, n] · b_rows[n, levels[i], k]``, shape
    (len(levels), 1, N·K).  ``levels`` (indices into ``plan.used_levels``)
    defaults to every level; row i of ``dec_w`` belongs to ``levels[i]``."""
    layout = _require_layout(plan)
    levels = list(range(layout.n_levels) if levels is None else levels)
    idx = torch.as_tensor(levels, dtype=torch.long, device=device)
    b_rows = torch.as_tensor(plan.b_rows, dtype=torch.float32, device=device)
    dec_w = torch.as_tensor(dec_w, dtype=torch.float32, device=device)
    return (dec_w[:len(levels), :, None] * b_rows[:, idx, :].transpose(0, 1)) \
        .reshape(len(levels), 1, -1)


def combine_rows(plan: Plan, g_rows, dec_w, *, grad_dtype=None) -> list:
    """The fused combine of already-computed per-shard rows: one
    ``ops.encode_decode_leaves(1/N, w, level, G)`` call over every leaf's
    ``(N·K, size)`` rows, where ``w = level_weights(plan, dec_w)`` holds
    one weight set per level.  Returns the decoded mean gradient in leaf
    order, cast to ``grad_dtype`` when one is given (the reference's
    sim-mode ``grad_dtype``)."""
    layout = _require_layout(plan)
    dev = g_rows[0].device
    inv_n = torch.ones((1,), dtype=torch.float32, device=dev) / plan.n_workers
    ys = ops.encode_decode_leaves(inv_n, level_weights(plan, dec_w, dev),
                                  layout.leaf_level, list(g_rows))
    ys = [y[0].reshape(shape) for y, shape in zip(ys, layout.leaf_shapes)]
    return ys if grad_dtype is None else [y.to(grad_dtype) for y in ys]


def combine_level(plan: Plan, g_rows, level_idx: int, dec_w_row) -> dict:
    """Decode ONE redundancy level of already-computed per-shard rows:
    one ``ops.encode_decode_leaves`` call over that level's leaves only
    (one ``gc_fused`` launch on CUDA) with that level's weight set
    (``level_weights``), callable the instant level ``level_idx`` (an
    index into ``plan.used_levels``) decodes.  ``g_rows``: every leaf's
    ``(N·K, size)`` rows; ``dec_w_row``: that level's (N,) decode weights.
    Returns ``{leaf id: decoded mean gradient}`` for the level's leaves;
    the union over the levels equals ``combine_rows`` bit for bit."""
    layout = _require_layout(plan)
    if not 0 <= level_idx < layout.n_levels:
        raise ValueError(f"level_idx {level_idx} out of range "
                         f"[0, {layout.n_levels})")
    dev = g_rows[0].device
    row = torch.as_tensor(dec_w_row, dtype=torch.float32, device=dev)
    inv_n = torch.ones((1,), dtype=torch.float32, device=dev) / plan.n_workers
    w = level_weights(plan, row[None], dev, levels=[level_idx])
    ids = layout.level_leaves[level_idx]
    ys = ops.encode_decode_leaves(inv_n, w, [0] * len(ids), [g_rows[j] for j in ids])
    return {j: y[0].reshape(layout.leaf_shapes[j]) for j, y in zip(ids, ys)}


def tree_combine(b_rows: torch.Tensor, dec_w: torch.Tensor, level_idx, g_rows,
                 grad_dtype=None) -> list:
    """The per-leaf tree combine on tensors: for leaf j at level
    l = level_idx[j], sum over workers n of dec_w[l, n] · (b_rows[n, l] @
    G_j[n]), over N, where G_j[n] is worker n's (K, size) block of the
    leaf's ``(N·K, size)`` rows; each worker's term is cast to
    ``grad_dtype`` before the sum, as the spmd reduce casts before it
    sums.  Returns the flat (size,) means in leaf order."""
    n_workers = b_rows.shape[0]
    out = []
    for li, rows in zip(level_idx, g_rows):
        g = rows.reshape(n_workers, -1, rows.shape[1])
        total = None
        for n in range(n_workers):
            c = (b_rows[n, li].to(rows.dtype) @ g[n]) * dec_w[li, n].to(rows.dtype)
            if grad_dtype is not None:
                c = c.to(grad_dtype)
            total = c if total is None else total + c
        out.append(total / n_workers)
    return out


def combine_grads(plan: Plan, g_rows, dec_w, *, pipeline: str = "flat",
                  grad_dtype=None) -> list:
    """Decode-weighted mean combine of already-computed per-shard rows
    (``(N·K, size)`` per leaf; dec_w: (n_used, N)): the decoded mean
    gradient in leaf order, through the fused flat pipeline
    (``combine_rows``) or the per-leaf tree (``tree_combine``), in
    ``grad_dtype`` when one is given.  Leaves take the plan's leaf
    shapes; a tree combine of a plan without a layout returns flat
    (size,) leaves."""
    if _resolve_pipeline(pipeline, plan) == "flat":
        return combine_rows(plan, g_rows, dec_w, grad_dtype=grad_dtype)
    dev = g_rows[0].device
    ys = tree_combine(torch.as_tensor(plan.b_rows, dtype=torch.float32, device=dev),
                      torch.as_tensor(np.asarray(dec_w), dtype=torch.float32, device=dev),
                      plan.level_index().tolist(), g_rows, grad_dtype)
    if plan.flat_layout is None:
        return ys
    return [y.reshape(shape) for y, shape in zip(ys, plan.flat_layout.leaf_shapes)]


def scatter_dims(leaf_shapes, n_workers: int, leaf_axes=None) -> list:
    """Per leaf, the dimension the tree pipeline's ``psum_scatter`` splits:
    the leaf's first ``embed`` dimension that N divides (``leaf_axes``,
    ``GCLM.leaf_axes()``: the ``fsdp`` dimension, whose tile is a rank's
    data slice), else the first one divisible by N (and at least N), else
    ``None`` (that leaf takes a plain ``psum``) — the reference's
    ``_scatter_dims``."""
    leaf_axes = [None] * len(leaf_shapes) if leaf_axes is None else leaf_axes
    out = []
    for shape, axes in zip(leaf_shapes, leaf_axes, strict=True):
        pick = next((i for i, (a, n) in enumerate(zip(axes or (), shape))
                     if a == "embed" and n % n_workers == 0), None)
        if pick is None:
            pick = next((i for i, n in enumerate(shape) if n % n_workers == 0
                         and n >= n_workers), None)
        out.append(pick)
    return out


def local_layout(cfg, plan: Plan, mesh) -> FlatLayout:
    """The plan's ``FlatLayout`` over one model rank's shards: the full
    tree's leaf levels (the plan's), the rank's shapes
    (``models.params.local_shapes``, which ``shard_model`` cuts by),
    every level padded as the plan pads it.  ``mesh.model`` 1 gives the
    plan's layout."""
    full = _require_layout(plan)
    if mesh.model == 1:
        return full
    shapes = [tuple(t.shape) for t in GCLM(cfg, device="meta").leaves()]
    if shapes != [tuple(s) for s in full.leaf_shapes]:
        raise ValueError(f"the plan's leaf shapes are not {cfg.name}'s full tree: build "
                         "the plan from the full model, not from a rank's shards")
    return FlatLayout.build(local_shapes(cfg, mesh), full.leaf_level, plan.n_workers,
                            lane=full.lane)


class CodedGrads:
    """A coded gradient function in its two stages:
    ``grad_fn(model, worker_batches, dec_w, worker_aux=None)`` is
    ``combine(rows(model, worker_batches, worker_aux), dec_w)`` with the
    leaves in the model's shapes.  ``rows`` runs the per-shard backward passes
    (all N·K in sim mode, this rank's K in spmd), ``combine`` the coded
    combine and, in spmd, the collectives.  The wave loop calls the two
    at a round's dispatch and at its update."""

    def __init__(self, rows: Callable, combine: Callable):
        self.rows, self.combine = rows, combine

    def __call__(self, model, worker_batches, dec_w, worker_aux=None, work=None) -> list:
        """``work``: ``model``'s working module when the caller gathered it
        already (``gather_data``); the gradients take ``model``'s shapes."""
        ys = self.combine(self.rows(model if work is None else work, worker_batches,
                                    worker_aux), dec_w)
        return [y.reshape(t.shape) for y, t in zip(ys, model.leaves())]


def make_coded_grad_fn(cfg, plan: Plan, *, mode: str = "sim", mesh=None,
                       reduce_mode: str = "psum", grad_dtype=None,
                       pipeline: str = "auto") -> CodedGrads:
    """grad_fn(model, worker_batches, dec_w, worker_aux=None) -> decoded
    mean gradient, a list of tensors in leaf order.

    worker_batches: the global (N, K, rows, S+1) tokens from
    ``data.pipeline.coded_worker_batches`` (in spmd every rank takes the
    same array and slices its part: its data index on axis 0, its pod's
    rows on axis 2), and ``worker_aux`` the (N, K, rows, ...) modality
    embeddings of a model with a cross-attention source, sliced alike;
    dec_w: (n_used, N) decode weights of this step's
    straggler realization.  pipeline: 'flat' (the fused combine), 'tree'
    (the per-leaf baseline) or 'auto' (flat when the plan carries a
    ``FlatLayout``).  ``grad_dtype`` (e.g. ``torch.bfloat16``) casts the
    decoded gradient — in spmd the coded contribution, before the
    reduction, halving its bytes.

    ``mode="spmd"`` needs ``mesh`` (a ``repro_torch.dist.mesh.Mesh``
    whose ``data`` axis has the plan's N ranks); ``reduce_mode``
    'psum_scatter' reduce-scatters each level buffer (or leaf) over the
    data ranks and all-gathers it back for the replicated optimizer.
    The flat spmd gradients are views of level buffers that the next
    call overwrites.  On a mesh with a ``model`` axis, ``grad_fn`` takes
    the rank's module (``shard_model``) and returns its shards'
    gradients; ``plan`` is still the full tree's.  Where ``cfg.fsdp``
    cuts leaves over the mesh's ``data`` axis (``data_dims``), it takes
    the rank's state module (``init_shards(..., over_data=True)``), or its
    working module, and returns the state's slices.
    """
    if reduce_mode not in REDUCE_MODES:
        raise ValueError(f"unknown reduce_mode {reduce_mode!r}; expected one of {REDUCE_MODES}")
    if grad_dtype is not None and not (isinstance(grad_dtype, torch.dtype)
                                       and grad_dtype.is_floating_point):
        raise ValueError(f"grad_dtype must be None or a floating torch dtype, got "
                         f"{grad_dtype!r}")
    pipeline = _resolve_pipeline(pipeline, plan)
    if mode == "sim":
        return CodedGrads(
            lambda model, wb, aux=None: per_shard_grad_rows(cfg, model, wb, aux),
            lambda rows, dec_w: combine_grads(plan, rows, dec_w, pipeline=pipeline,
                                              grad_dtype=grad_dtype))
    if mode != "spmd":
        raise ValueError(f"unknown mode {mode!r}; expected 'sim' or 'spmd'")
    if mesh is None:
        raise ValueError("mode='spmd' needs a mesh (repro_torch.launch.mesh.make_local_mesh)")
    if mesh.data != plan.n_workers:
        raise ValueError(f"the plan codes {plan.n_workers} workers, the mesh has "
                         f"{mesh.data} data ranks")
    d, p = mesh.data_index, mesh.pod_index
    cut = data_dims(cfg, mesh)
    cut = cut if any(dim is not None for dim in cut) else None

    def rows(model, worker_batches, worker_aux=None):
        n_rows = worker_batches.shape[2]
        if n_rows % mesh.pod:
            raise ValueError(f"{n_rows} rows per shard do not split over {mesh.pod} pods")
        if model.fsdp is not None and model.fsdp.dims != cut:
            raise ValueError("the module is cut over data otherwise than the config's "
                             "fsdp rule on this mesh")
        work = gather_data(model)
        h = n_rows // mesh.pod
        mine = (slice(d, d + 1), slice(None), slice(p * h, (p + 1) * h))
        return per_shard_grad_rows(cfg, work, worker_batches[mine],
                                   None if worker_aux is None else worker_aux[mine])

    layout = plan.flat_layout
    if mesh.model > 1:
        if layout is None:
            raise ValueError("a model axis needs the plan's leaf shapes (Plan.build(model, "
                             "...) on the full tree)")
        layout = local_layout(cfg, plan, mesh)
    if cut is not None and layout is None:
        raise ValueError(f"{cfg.name}'s fsdp cut needs the plan's leaf shapes (Plan.build("
                         "model, ...) on the full tree)")
    if pipeline == "flat":
        combine = _flat_spmd_combine(plan, layout, mesh, reduce_mode, grad_dtype, cut)
    else:
        axes = GCLM(cfg, device="meta").leaf_axes() if layout is not None else None
        combine = _tree_spmd_combine(plan, layout, mesh, reduce_mode, grad_dtype, cut, axes)
    return CodedGrads(rows, combine)


def _flat_spmd_combine(plan: Plan, layout, mesh, reduce_mode: str, grad_dtype,
                       cut=None) -> Callable:
    """The flat spmd combine over ``layout``'s level buffers (the plan's,
    or a model rank's ``local_layout``), allocated here, once: the
    grouped launch writes each leaf into its slice, so the launch's
    pointers stay put from step to step (the launch cache hits).  ``cut``
    (``data_dims``, or None): the rank keeps its slice of each cut leaf
    after the reduction."""
    dev, n = mesh.device, plan.n_workers
    bufs = [torch.zeros(size, dtype=torch.float32, device=dev) for size in layout.level_sizes]
    views = [None] * layout.n_leaves
    for j, li, off, size in layout.leaf_slices():
        views[j] = bufs[li][off:off + size].view(1, size)
    send = bufs if grad_dtype is None else [torch.zeros_like(b, dtype=grad_dtype) for b in bufs]
    tiles = [torch.empty(b.numel() // n, dtype=b.dtype, device=dev) for b in send] \
        if reduce_mode == "psum_scatter" else None
    b_rows = torch.as_tensor(plan.b_rows[mesh.data_index], dtype=torch.float32, device=dev)
    one = torch.ones((1,), dtype=torch.float32, device=dev)

    def combine(rows, dec_w):
        # (dec_w[li, rank] / (N·P)) · b_rows[rank, li], folded in fp32 once
        w = torch.as_tensor(np.asarray(dec_w, np.float32)[:, mesh.data_index],
                            device=dev) / (n * mesh.pod)
        ops.encode_decode_leaves(one, (w[:, None] * b_rows)[:, None, :], layout.leaf_level,
                                 rows, out=views)
        if grad_dtype is not None:
            for s, b in zip(send, bufs):
                s.copy_(b)
        if mesh.pod > 1:
            psum(send, mesh.pod_group)
        if tiles is None:
            psum(send, mesh.data_group)
        else:
            for s, t in zip(send, tiles):
                psum_scatter(s, mesh.data_group, out=t)
                all_gather(t, mesh.data_group, out=s)
        ys = layout.unpack(send)
        return ys if cut is None else [data_shard_of(y, dim, mesh) for y, dim in zip(ys, cut)]

    return combine


def _tree_spmd_combine(plan: Plan, layout, mesh, reduce_mode: str, grad_dtype, cut=None,
                       leaf_axes=None) -> Callable:
    """The tree spmd combine: per leaf, this rank's encode and decode
    weight in plain torch, the cast, then one collective per leaf
    (over the pod ranks first when there are any).  ``layout`` (the
    plan's, or a model rank's ``local_layout``) gives the leaves' shapes
    and ``leaf_axes`` their logical axes.  ``cut`` (``data_dims``, or
    None): the rank keeps its slice of each cut leaf — under
    ``psum_scatter`` the tile of a scatter on that dimension, gathered no
    further."""
    dev, n = mesh.device, plan.n_workers
    level_idx = plan.level_index().tolist()
    dims = [None] * len(level_idx)
    cut = [None] * len(level_idx) if cut is None else list(cut)
    if reduce_mode == "psum_scatter":
        if layout is None:
            raise ValueError("pipeline='tree' with reduce_mode='psum_scatter' needs the "
                             "plan's leaf shapes (Plan.build(model, ...))")
        dims = scatter_dims(layout.leaf_shapes, n, leaf_axes)
        assert all(c is None or c == d for c, d in zip(cut, dims)), (cut, dims)
    b_rows = torch.as_tensor(plan.b_rows[mesh.data_index], dtype=torch.float32, device=dev)
    denom = n * mesh.pod

    def combine(rows, dec_w):
        w = torch.as_tensor(np.asarray(dec_w, np.float32)[:, mesh.data_index], device=dev)
        out = []
        for j, (li, g) in enumerate(zip(level_idx, rows)):
            c = (b_rows[li].to(g.dtype) @ g) * w[li].to(g.dtype)
            if grad_dtype is not None:
                c = c.to(grad_dtype)
            if mesh.pod > 1:
                psum([c], mesh.pod_group)
            if dims[j] is None:
                psum([c], mesh.data_group)
                if cut[j] is not None:
                    c = data_shard_of(c.reshape(layout.leaf_shapes[j]), cut[j], mesh)
            else:
                c = psum_scatter(c.reshape(layout.leaf_shapes[j]), mesh.data_group, dim=dims[j])
                if cut[j] is None:
                    c = all_gather(c, mesh.data_group, dim=dims[j])
            out.append(c / denom)
        return out

    return combine


def uncoded_grad_fn(cfg, n_workers: int) -> Callable:
    """Plain data-parallel mean gradient over the same global batch
    (shards stacked (N, rows, S+1), and for a model with a cross-attention
    source their modality embeddings ``aux`` (N, rows, ...)); the
    reference for exactness tests.  Given a model rank's module
    (``shard_model``), its shards' gradients (the model group runs it
    together)."""

    def grad_fn(model, shards, aux=None):
        _check_aux(cfg, aux)
        leaves = model.leaves()
        shards = torch.as_tensor(shards, device=leaves[0].device)
        aux = None if aux is None else torch.as_tensor(aux, device=leaves[0].device)
        total = None
        for i in range(shards.shape[0]):
            loss, _ = train_loss(cfg, model, _batch(shards[i], None if aux is None else aux[i]))
            grads = torch.autograd.grad(loss, leaves)
            total = list(grads) if total is None else [a + g for a, g in zip(total, grads)]
        return [t / n_workers for t in total]

    return grad_fn
