"""Layer stack: runs of identical layers over stacked leaves.

The reference (``repro/models/stack.py``) scans each ``Run`` of identical
``LayerSpec``s over its stacked parameters; the port loops over the run
in Python.  Each stacked leaf is ``unbind``-ed once per forward, so the
backward assembles its gradient with one ``stack`` rather than one
full-size scatter per layer.  The reference's ``Pattern`` segments
(periodic interleaves of different layer kinds) are ROADMAP 1.9.

Decode caches keep the reference's layout: one tree per segment, a plain
``{"k", "v", "pos"}`` dict for a single layer and, for a run, leaves
stacked over the run — ``(L, B, cap, K, Dh)`` K/V and a ``(L,)`` or
``(L, B)`` ``pos``.  A decode step hands each layer views of its slice,
so every write lands in the stacked tensors in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .blocks import apply_layer, init_layer_cache

__all__ = ["Run", "group_runs", "plan_segments", "apply_stack", "init_stack_caches"]


class Run(NamedTuple):
    spec: object  # LayerSpec
    count: int
    start: int


def group_runs(layers, start: int = 0) -> list:
    runs: list = []
    for i, spec in enumerate(layers):
        if runs and runs[-1].spec == spec:
            runs[-1] = runs[-1]._replace(count=runs[-1].count + 1)
        else:
            runs.append(Run(spec, 1, start + i))
    return runs


def _find_pattern(layers) -> Optional[tuple]:
    """Smallest period p (repeats >= 2) of the layer list, as the reference
    finds it."""
    n = len(layers)
    for p in range(1, min(n // 2, 16) + 1):
        k = n // p
        if k < 2:
            break
        if all(layers[i] == layers[i % p] for i in range(k * p)):
            return p, k
    return None


def plan_segments(layers) -> list:
    """The reference's segmenting; raises where it would pick a Pattern."""
    runs = group_runs(layers)
    pat = _find_pattern(layers)
    if pat is not None:
        p, k = pat
        tail = group_runs(layers[p * k:], start=p * k)
        if 1 + len(tail) < len(runs):
            raise NotImplementedError(
                "periodic layer interleaves (Pattern segments) are not ported "
                "yet (ROADMAP 1.9)")
    return runs


def _tree(node, index=None):
    """Nested dict of a parameter node's tensors; ``index`` selects one
    layer of a stacked run from pre-unbound leaves."""
    out = {}
    for name, t in node._parameters.items():
        out[name] = t if index is None else index[id(t)]
    for name, child in node._modules.items():
        out[name] = _tree(child, index)
    return out


def apply_stack(cfg, stack, x, *, mode="train", caches=None, target_len: int = 0):
    """x: (B, S, d) through every layer of ``stack`` (the model's
    ``nn.ModuleList`` of run nodes).  Returns (x, caches): ``None`` in
    training, the prefill's new per-segment caches, or ``caches`` updated
    in place by a decode step."""
    new_caches = [] if mode == "prefill" else None
    for i, (seg, node) in enumerate(zip(plan_segments(cfg.layers), stack)):
        cache = caches[i] if caches is not None else None
        if seg.count == 1:
            x, c_new = apply_layer(cfg, _tree(node), x, seg.spec, mode=mode, cache=cache,
                                   target_len=target_len)
            if mode == "prefill":
                new_caches.append(c_new)
            continue
        unbound = {id(t): t.unbind(0) for t in node.parameters()}
        per_layer = []
        for j in range(seg.count):
            layer = {k: v[j] for k, v in unbound.items()}
            c_j = None if cache is None else {k: v[j] for k, v in cache.items()}
            x, c_new = apply_layer(cfg, _tree(node, layer), x, seg.spec, mode=mode,
                                   cache=c_j, target_len=target_len)
            per_layer.append(c_new)
        if mode == "prefill":
            new_caches.append({k: torch.stack([c[k] for c in per_layer])
                               for k in per_layer[0]})
    return x, (caches if mode == "decode" else new_caches)


def init_stack_caches(cfg, batch: int, seq_len: int, dtype=torch.bfloat16, device="cuda"):
    """Empty per-segment caches of capacity ``seq_len`` (leaves stacked
    along axis 0 for a run)."""
    out = []
    for seg in plan_segments(cfg.layers):
        per_layer = [init_layer_cache(cfg, seg.spec, batch, seq_len, dtype, device)
                     for _ in range(seg.count)]
        out.append(per_layer[0] if seg.count == 1 else
                   {k: torch.stack([c[k] for c in per_layer]) for k in per_layer[0]})
    return out
