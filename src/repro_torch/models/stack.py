"""Layer stack: runs of identical layers over stacked leaves.

The reference (``repro/models/stack.py``) scans each ``Run`` of identical
``LayerSpec``s over its stacked parameters; the port loops over the run
in Python.  Each stacked leaf is ``unbind``-ed once per forward, so the
backward assembles its gradient with one ``stack`` rather than one
full-size scatter per layer.  The reference's ``Pattern`` segments
(periodic interleaves of different layer kinds) are ROADMAP 1.9.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

from .blocks import apply_layer

__all__ = ["Run", "group_runs", "plan_segments", "apply_stack"]


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


def apply_stack(cfg, stack, x):
    """x: (B, S, d) through every layer of ``stack`` (the model's
    ``nn.ModuleList`` of run nodes)."""
    for seg, node in zip(plan_segments(cfg.layers), stack):
        if seg.count == 1:
            x = apply_layer(cfg, _tree(node), x, seg.spec)
            continue
        unbound = {id(t): t.unbind(0) for t in node.parameters()}
        for i in range(seg.count):
            layer = {k: v[i] for k, v in unbound.items()}
            x = apply_layer(cfg, _tree(node, layer), x, seg.spec)
    return x
