"""Shared batched KV-cache slab for continuous batching, after
``repro/serve/slab.py``.

One cache tree of batch ``n_slots`` holds every live request: slot b is
row b of every cache leaf, and — because the decode path takes per-row
positions (``pos`` leaves with a batch axis, ``models/attention.py``) —
each slot decodes at its own depth.  A prefill runs per admitted request
at batch 1 and its cache row is written into the slab at the assigned
slot, in place; eviction is purely logical (the scheduler frees the
slot; the stale row is overwritten by the next insertion, and it never
leaks, because attention masks each row on the slot's own ``pos``).

Leaf layout (``models/stack.py``): a list of per-segment entries — a
dict for a single layer, a dict of leaves stacked over a leading layer
axis for a run, a list of p such stacked dicts for a pattern.  The batch
axis is axis 0 for a single layer and axis 1 for a stacked tree; ``pos``
carries one fewer axis on the prefill side (one scalar per layer) than
on the slab side (one entry per slot), which is how ``insert_request``
tells them apart, by ndim only, as the reference does.  A Mamba layer's
state (``conv``, ``h``) and an xLSTM layer's (the mLSTM's ``C``, ``n``,
``m``, ``conv``; the sLSTM's ``h``, ``c``, ``n``, ``m``) have no sequence
axis: a prefill row lands in the slot like a K/V row — ``C`` is 4-D like
K/V, with its batch axis where K/V's is — cast to the slab leaf's dtype,
so every state but ``conv`` stays fp32 in a bf16 slab.  A finished
slot's state goes on being advanced by the batched decode step until the
next admission overwrites every leaf; attention masks a stale K/V row on
the slot's own ``pos``.  A cross-attention mixer has no cache: its entry
is None on both sides and is skipped.

On a mesh (``serve.engine.ServeEngine(mesh=)``) a rank's slab holds its
block of the slots (``dist.sharding.batch_rows``) and, for a sharded
module, its KV heads, MLA's whole latent, its Mamba channels' state and
its mLSTM and sLSTM heads' state (``make_slab(tp=)``: the sLSTM's h, c,
n, m of d_model / model, where the reference's cache axes keep them
whole: a rank's recurrence reads only its heads'); the engine maps a
global slot to the local row it passes to ``insert_request``.

``caches_from_numpy`` / ``caches_to_numpy`` carry the reference's cache
trees (the same list of per-segment entries of arrays) across.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.model import init_decode_caches
from ..models.stack import Run, plan_segments

__all__ = ["make_slab", "insert_request", "caches_from_numpy", "caches_to_numpy"]


def make_slab(cfg, n_slots: int, max_len: int, dtype=torch.bfloat16, device="cuda",
              tp=None):
    """Empty shared cache slab: capacity ``max_len`` per slot, per-row
    ``pos`` leaves initialized to 0; ``tp`` (a sharded module's
    ``model.tp``): this rank's KV heads, Mamba channels and mLSTM and
    sLSTM heads (MLA's latent whole)."""
    return init_decode_caches(cfg, n_slots, max_len, dtype=dtype, filled=0,
                              row_pos=True, device=device, tp=tp)


@torch.no_grad()
def insert_request(cfg, slab, pref_caches, slot: int):
    """Write a batch-1 prefill's cache rows into slab row ``slot``, in
    place (K/V and ``conv`` cast to the slab's dtype, the Mamba and
    xLSTM states kept fp32); returns ``slab``."""
    for seg, s_seg, p_seg in zip(plan_segments(cfg.layers), slab, pref_caches):
        if isinstance(seg, Run):
            _insert_tree(s_seg, p_seg, slot, stacked=seg.count > 1)
        else:  # a pattern: p stacked trees
            for s_tree, p_tree in zip(s_seg, p_seg):
                _insert_tree(s_tree, p_tree, slot, stacked=True)
    return slab


def _insert_tree(s_tree, p_tree, slot: int, stacked: bool) -> None:
    if s_tree is None:  # a cross-attention mixer: no cache
        return
    for name, s_leaf in s_tree.items():
        p_leaf = p_tree[name]
        if p_leaf.ndim == s_leaf.ndim:  # k, v: take the prefill's row 0
            p_leaf = p_leaf[:, 0] if stacked else p_leaf[0]
        # else pos: prefill scalar / (L,) vs slab (B,) / (L, B)
        target = s_leaf[:, slot] if stacked else s_leaf[slot]
        target.copy_(p_leaf)


def _leaf_to_torch(a, device) -> torch.Tensor:
    """A reference array as a tensor of the same dtype; bf16 arrays (the
    reference's ``ml_dtypes`` type, which the port does not import) go by
    their 16-bit pattern."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def caches_from_numpy(cfg, tree, device="cuda"):
    """The reference's cache tree (a list of per-segment entries of arrays:
    prefill caches, ``init_decode_caches`` or a slab) in the port's layout,
    dtypes kept."""
    dev = resolve_device(device)
    segs = plan_segments(cfg.layers)
    if len(tree) != len(segs):
        raise ValueError(f"{len(tree)} cache segments for {len(segs)} layer segments")
    return _map_trees(tree, lambda v: _leaf_to_torch(v, dev))


def caches_to_numpy(caches):
    """The port's caches as the reference's tree of numpy arrays; bf16
    leaves come back widened to fp32 (exact), ``pos`` as int32."""
    return _map_trees(caches, lambda v: (v.float() if v.dtype == torch.bfloat16 else v)
                      .cpu().numpy())


def _map_trees(caches, fn):
    """``fn`` on every leaf of a per-segment cache list (dicts, or a
    pattern's list of dicts; None passes)."""
    def one(tree):
        return None if tree is None else {k: fn(v) for k, v in tree.items()}

    return [[one(t) for t in seg] if isinstance(seg, (list, tuple)) else one(seg)
            for seg in caches]
