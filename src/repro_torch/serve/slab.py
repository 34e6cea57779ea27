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

Leaf layout (``models/stack.py``): a list of per-segment dicts, leaves
stacked over a leading layer axis for a run.  The batch axis is axis 0
for a single layer and axis 1 for a run; ``pos`` carries one fewer axis
on the prefill side (one scalar per layer) than on the slab side (one
entry per slot), which is how ``insert_request`` tells them apart.

``caches_from_numpy`` / ``caches_to_numpy`` carry the reference's cache
trees (the same list of per-segment dicts of arrays) across.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.model import init_decode_caches
from ..models.stack import plan_segments

__all__ = ["make_slab", "insert_request", "caches_from_numpy", "caches_to_numpy"]


def make_slab(cfg, n_slots: int, max_len: int, dtype=torch.bfloat16, device="cuda"):
    """Empty shared cache slab: capacity ``max_len`` per slot, per-row
    ``pos`` leaves initialized to 0."""
    return init_decode_caches(cfg, n_slots, max_len, dtype=dtype, filled=0,
                              row_pos=True, device=device)


@torch.no_grad()
def insert_request(cfg, slab, pref_caches, slot: int):
    """Write a batch-1 prefill's cache rows into slab row ``slot``, in
    place (K/V cast to the slab's dtype); returns ``slab``."""
    for seg, s_tree, p_tree in zip(plan_segments(cfg.layers), slab, pref_caches):
        stacked = seg.count > 1
        for name, s_leaf in s_tree.items():
            p_leaf = p_tree[name]
            if p_leaf.ndim == s_leaf.ndim:  # k, v: take the prefill's row 0
                p_leaf = p_leaf[:, 0] if stacked else p_leaf[0]
            # else pos: prefill scalar / (L,) vs slab (B,) / (L, B)
            target = s_leaf[:, slot] if stacked else s_leaf[slot]
            target.copy_(p_leaf)
    return slab


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
    """The reference's cache tree (a list of per-segment dicts of arrays:
    prefill caches, ``init_decode_caches`` or a slab) in the port's layout,
    dtypes kept."""
    dev = resolve_device(device)
    segs = plan_segments(cfg.layers)
    if len(tree) != len(segs):
        raise ValueError(f"{len(tree)} cache segments for {len(segs)} layer runs")
    return [{k: _leaf_to_torch(v, dev) for k, v in seg_tree.items()} for seg_tree in tree]


def caches_to_numpy(caches):
    """The port's caches as the reference's tree of numpy arrays; bf16
    leaves come back widened to fp32 (exact), ``pos`` as int32."""
    out = []
    for seg_tree in caches:
        out.append({k: (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
                    for k, v in seg_tree.items()})
    return out
