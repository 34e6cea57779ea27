"""Layer stack: runs of identical layers and periodic patterns, over
stacked leaves, after ``repro/models/stack.py``.

The reference scans each segment over its stacked parameters; the port
loops over it in Python, with the reference's segmenting:

* ``Run`` — a maximal run of identical ``LayerSpec``s, its leaves
  stacked along a leading ``(count,)`` axis (a single layer unstacked);
* ``Pattern`` — when the layer list is (almost) periodic with period p
  (gemma2's local/global p = 2, gemma3's 5:1 p = 6), ``repeats`` copies
  of a p-layer body: a list of p trees, each stacked over the repeats;
  a non-periodic tail falls back to runs (gemma3's 62 = 6·10 + 2).

Each stacked leaf is ``unbind``-ed once per forward, so the backward
assembles its gradient with one ``stack`` rather than one full-size
scatter per layer.

Remat (``cfg.remat``) wraps what the reference wraps — a single layer,
one layer of a run, one p-layer body of a pattern — in
``torch.utils.checkpoint`` (non-reentrant), in training only: ``"full"``
recomputes the whole forward in the backward; ``"dots"`` keeps the
matmul outputs (``mm``/``bmm``/``addmm``: einsum's products) through a
selective-checkpoint policy, as ``checkpoint_dots`` does, and recomputes
the elementwise rest.  The recomputation runs the same ops on the same
inputs, so the gradients are bit-equal to ``remat="none"``.

The MoE load-balance loss of every layer is summed in fp32 in layer
order, as the reference's scan carries it.

Decode caches keep the reference's layout: one entry per segment — a
plain dict for a single layer (``{"k", "v", "pos"}`` for attention,
``{"c_kv", "k_r", "pos"}`` for MLA, ``{"conv", "h", "pos"}`` for Mamba,
``{"C", "n", "m", "conv", "pos"}`` for an mLSTM and ``{"h", "c", "n",
"m", "pos"}`` for an sLSTM, whose states have no sequence axis); for a
run, leaves stacked over the run (``(L, B, cap, K, Dh)`` K/V,
``(L, B, d_conv-1, d_inner)`` conv, ``(L, B, nh, dh, dh)`` C and a
``(L,)`` or ``(L, B)`` ``pos``); for a pattern, a list of p such trees
stacked over the repeats, each position its own mixer's (Jamba's 32
layers: one pattern of 8 — seven Mamba trees and one attention tree —
over 4 repeats; xLSTM's 48: seven mLSTM trees and one sLSTM tree over
6).  A cross-attention mixer keeps no cache: its entry is None, also
as a position of a pattern (Llama-3.2-vision's 40 layers: one pattern
of 5 — four attention trees and None — over 8 repeats).  A decode step
hands each layer views of its slice, so every write lands in the
stacked tensors in place.

The cross-attention ``source`` (the encoder's output, or the projected
patches) reaches every layer, inside remat too.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .blocks import apply_layer, init_layer_cache

__all__ = ["Run", "Pattern", "group_runs", "plan_segments", "apply_stack",
           "init_stack_caches"]


class Run(NamedTuple):
    spec: object  # LayerSpec
    count: int
    start: int


class Pattern(NamedTuple):
    specs: tuple  # p LayerSpecs
    repeats: int
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
    """The reference's segmenting: a ``Pattern`` (plus a tail of runs)
    when that makes fewer segments than runs alone, else runs."""
    runs = group_runs(layers)
    pat = _find_pattern(layers)
    if pat is None:
        return runs
    p, k = pat
    tail = group_runs(layers[p * k:], start=p * k)
    if 1 + len(tail) < len(runs):
        return [Pattern(tuple(layers[:p]), k, 0), *tail]
    return runs


def _tree(node, index=None):
    """Nested dict of a parameter node's tensors; ``index`` selects one
    layer of a stacked segment from pre-unbound leaves."""
    out = {}
    for name, t in node._parameters.items():
        out[name] = t if index is None else index[id(t)]
    for name, child in node._modules.items():
        out[name] = _tree(child, index)
    return out


#: einsum's products as the dispatcher sees them
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg, mode, fn, *args):
    """``fn(*args)``, under the config's remat policy in training."""
    if cfg.remat == "none" or mode != "train" or not torch.is_grad_enabled():
        return fn(*args)
    if cfg.remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _dots_policy))
    if cfg.remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    raise ValueError(f"unknown remat {cfg.remat!r}; expected 'none', 'dots' or 'full'")


def _slice(cache, i):
    """Layer i's views of a stacked cache tree (``None`` passes)."""
    return None if cache is None else {k: v[i] for k, v in cache.items()}


def _stack(trees):
    """Cache trees stacked along a new axis 0 (None for a mixer without a
    cache)."""
    if trees[0] is None:
        return None
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def _add(total, aux):
    """The running fp32 aux sum (None: nothing added yet)."""
    if aux is None:
        return total
    return aux if total is None else total + aux


def apply_stack(cfg, stack, x, *, mode="train", caches=None, source=None,
                target_len: int = 0, tp=None, rows=None):
    """x: (B, S, d) through every layer of ``stack`` (the model's
    ``nn.ModuleList`` of segment nodes), ``source`` (B, Ssrc, d) the
    cross-attention source or None.  Returns (x, caches, aux):
    caches ``None`` in training, the prefill's new per-segment caches, or
    ``caches`` updated in place by a decode step; aux the summed MoE
    load-balance loss, or None when no layer is MoE.  ``tp``: the
    ``ModelSplit`` of a module on the ``model`` axis, ``rows`` a serving
    decode's ``RowSplit`` over the data ranks (``apply_layer``)."""
    new_caches = [] if mode == "prefill" else None
    aux = None

    def layer(spec, params, cache):
        return lambda x_, src: apply_layer(cfg, params, x_, spec, mode=mode, cache=cache,
                                           source=src, target_len=target_len, tp=tp,
                                           rows=rows)

    for i, (seg, node) in enumerate(zip(plan_segments(cfg.layers), stack)):
        cache = caches[i] if caches is not None else None
        if isinstance(seg, Run) and seg.count == 1:
            x, c_new, a = _remat(cfg, mode, layer(seg.spec, _tree(node), cache), x, source)
            aux = _add(aux, a)
            if mode == "prefill":
                new_caches.append(c_new)
            continue
        if isinstance(seg, Run):
            unbound = {id(t): t.unbind(0) for t in node.parameters()}
            per_layer = []
            for j in range(seg.count):
                params = _tree(node, {k: v[j] for k, v in unbound.items()})
                x, c_new, a = _remat(cfg, mode, layer(seg.spec, params, _slice(cache, j)), x,
                                     source)
                aux = _add(aux, a)
                per_layer.append(c_new)
            if mode == "prefill":
                new_caches.append(_stack(per_layer))
            continue
        # Pattern: ``repeats`` bodies of p layers; node[j] holds position j
        unbound = {id(t): t.unbind(0) for t in node.parameters()}
        per_rep = []
        for r in range(seg.repeats):
            index = {k: v[r] for k, v in unbound.items()}
            fns = [layer(spec, _tree(node[j], index),
                         None if cache is None else _slice(cache[j], r))
                   for j, spec in enumerate(seg.specs)]

            def body(x_, src, fns=fns):
                c_out, a_out = [], []
                for fn in fns:
                    x_, c_new, a = fn(x_, src)
                    c_out.append(c_new)
                    a_out.append(a)
                return x_, c_out, a_out

            x, c_out, a_out = _remat(cfg, mode, body, x, source)
            for a in a_out:
                aux = _add(aux, a)
            per_rep.append(c_out)
        if mode == "prefill":
            new_caches.append([_stack([c[j] for c in per_rep])
                               for j in range(len(seg.specs))])
    return x, (caches if mode == "decode" else new_caches), aux


def init_stack_caches(cfg, batch: int, seq_len: int, dtype=torch.bfloat16, device="cuda",
                      tp=None):
    """Empty per-segment caches of capacity ``seq_len`` (``min(window,
    seq_len)`` for a windowed layer; a Mamba or xLSTM layer's fixed-size
    state; None for a cross-attention mixer), leaves stacked along axis 0
    for a run and for each position of a pattern; ``tp``: a sharded
    module's ``ModelSplit`` (``init_layer_cache``)."""
    def one(spec):
        return init_layer_cache(cfg, spec, batch, seq_len, dtype, device, tp)

    out = []
    for seg in plan_segments(cfg.layers):
        if isinstance(seg, Run):
            out.append(one(seg.spec) if seg.count == 1 else
                       _stack([one(seg.spec) for _ in range(seg.count)]))
        else:
            out.append([_stack([one(spec) for _ in range(seg.repeats)])
                        for spec in seg.specs])
    return out
