"""The decoder LM, after ``repro/models/model.py``: ``forward`` in
training, prefill or decode mode, ``train_loss`` (cross-entropy, the
MoE load-balance loss and DeepSeek-V3's multi-token prediction loss),
and the serving entry points ``prefill``, ``decode_step`` and
``init_decode_caches`` — gc-lm-110m, the Gemma family, Qwen 1.5,
Mixtral, DeepSeek-V3, Jamba, xLSTM, Whisper and Llama-3.2-vision (the
embedding scale, the untied head and the final softcap live in
``layers.py``, the MoE FFN in ``moe.py``, MLA in ``mla.py``, the Mamba
mixer in ``ssm.py``, the mLSTM and sLSTM mixers in ``xlstm.py``).

A model with a cross-attention source takes ``aux_inputs``: Whisper's
stubbed frame embeddings (B, n_frames, d_model), which ``run_encoder``
turns into the source (sinusoid positions, non-causal attention layers
with QKV biases, no RoPE, layer norms), or Llama-3.2-vision's stubbed
patch embeddings (B, n_patches, d_vision), which ``vision_proj``
projects to d_model.  As in the reference, a decode step recomputes the
source from ``aux_inputs`` — the whole encoder, or the projector — and
each cross-attention layer its K/V; nothing of the source is cached.

A module on the ``model`` axis (``params.shard_model``: ``model.tp``)
trains and serves on its shards: the layers reduce over the model group,
``train_loss`` takes the vocab-parallel cross-entropy of its slice of
the logits (``_xent``), and ``prefill`` and ``decode_step`` all-gather
the logits they return over the vocabulary (``layers.gather_vocab``) —
with ``last_only``, the last position's alone, which is all a server
samples.  Its caches hold its KV heads, MLA's whole latent, its
Mamba channels' state and its mLSTM and sLSTM heads' state
(``init_decode_caches(tp=)``); DeepSeek-V3's multi-token prediction loss
runs on the shards too (``_mtp_loss``), and so do Whisper's encoder
(``run_encoder``) and the cross-attention layers over a source that is
whole on every rank (``source_embeds``)."""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .attention import chunked_attention, project_qkv
from .blocks import apply_layer
from ..dist.collectives import copy_to_model, max_over_model, reduce_from_model
from .layers import (apply_mlp, apply_norm, embed_tokens, gather_vocab, rms_norm, unembed,
                     vocab_start)
from .params import encoder_cfg
from .stack import _tree, apply_stack, init_stack_caches

__all__ = ["forward", "train_loss", "prefill", "decode_step", "init_decode_caches",
           "run_encoder", "source_embeds", "has_source"]


def has_source(cfg) -> bool:
    """Whether a layer of ``cfg`` cross-attends to a source (a
    ``cross_attn`` mixer or a ``cross_source`` sublayer)."""
    return any(l.mixer == "cross_attn" or l.cross_source for l in cfg.layers)


@functools.lru_cache(maxsize=8)
def _sinusoid(n_pos: int, d: int, device: torch.device):
    """The encoder's (n_pos, d) positions — sin of pos / 10000^(2i/d) in
    the first half, cos in the second — in float64 numpy, as the
    reference computes them, then fp32, copied to ``device`` once."""
    pos = np.arange(n_pos)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10_000.0, 2 * dim / d)
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)
    return torch.from_numpy(table).to(device)


def run_encoder(cfg, model, frames):
    """Whisper's encoder over ``frames`` (B, n_frames, d_model), the stubbed
    conv front end's output: the sinusoid positions added in the
    activations' dtype, then per layer a layer norm, non-causal attention
    with QKV biases and no RoPE (``chunked_attention``: chunks of
    ``attn_chunk``, the tail padded and masked), residual, a layer norm,
    the MLP, residual; the final layer norm.  Outside the stack: no
    remat, as in the reference.  A sharded module runs every layer on its
    heads and MLP columns, as the decoder's attention and MLP run theirs:
    per layer the two inputs copied, ``wo``'s and the MLP's partial sums
    all-reduced."""
    ecfg = encoder_cfg(cfg)
    tp = model_axis(model)
    group = tp.model_group if tp is not None and "heads" in tp.axes else None
    dt = getattr(torch, cfg.dtype)
    x = frames.to(dt) + _sinusoid(frames.shape[1], cfg.d_model, frames.device).to(dt)
    for node in model.encoder.layers:
        lp = _tree(node)
        h = apply_norm(lp["norm_mix"], x)
        q, k, v = project_qkv(ecfg, lp["mixer"], h, None, 0.0, tp)  # RoPE base 0: none
        out = chunked_attention(ecfg, q, k, v, causal=False)
        y = torch.einsum("bshx,hxd->bsd", out, lp["mixer"]["wo"].to(dt))
        x = x + (y if group is None else reduce_from_model(y, group))
        x = x + apply_mlp(ecfg, lp["ffn"], apply_norm(lp["norm_ffn"], x), tp)
    return apply_norm(_tree(model.encoder.final_norm), x)


def source_embeds(cfg, model, aux_inputs):
    """The cross-attention source from the stubbed modality embeddings:
    the projected patches (``aux_inputs @ vision_proj`` in the activations'
    dtype) for a vision config, the encoder's output for Whisper, else
    None (also when ``aux_inputs`` is None).  On a sharded module the
    source is whole on every rank and feeds only the rank's K/V heads of
    every cross layer: it goes through one ``copy_to_model`` a pass, so
    the gradient reaching the encoder or ``vision_proj`` is every rank's
    heads' sum."""
    if aux_inputs is None:
        return None
    aux = torch.as_tensor(aux_inputs, device=model.embed.tok.device)
    if cfg.vision is not None:
        dt = getattr(torch, cfg.dtype)
        source = torch.einsum("bpd,de->bpe", aux.to(dt), model.vision_proj.to(dt))
    elif cfg.encoder is not None:
        source = run_encoder(cfg, model, aux)
    else:
        return None
    tp = model_axis(model)
    if tp is not None and "heads" in tp.axes:
        source = copy_to_model(source, tp.model_group)
    return source


def forward(cfg, model, tokens, *, mode="train", caches=None, aux_inputs=None,
            target_len: int = 0, last_only: bool = False, rows=None):
    """tokens: (B, S) integer; ``aux_inputs`` the stubbed modality
    embeddings of a model with a cross-attention source.  Returns
    (logits, new_caches, aux, hidden); ``new_caches`` is None in
    training, and in decode mode it is ``caches``, updated in place;
    ``aux`` is the fp32 sum of the MoE layers' load-balance losses (zero
    without MoE layers).  ``last_only``: the last position's logits
    (B, 1, V) alone.  On the ``model`` axis the logits are the rank's
    vocabulary rows in training and the whole vocabulary when serving.
    ``rows``: the ``dist.sharding.RowSplit`` of the B rows over the data
    ranks when they are one call's block (a serving engine's decode on
    data-parallel slots): a MoE layer counts its capacity over them all."""
    tp = model_axis(model)
    tokens = _as_tokens(tokens, model.embed.tok.device)
    x = embed_tokens(cfg, model.embed.tok, tokens, tp)
    source = source_embeds(cfg, model, aux_inputs)
    x, new_caches, aux = apply_stack(cfg, model.stack, x, mode=mode, caches=caches,
                                     source=source, target_len=target_len, tp=tp,
                                     rows=rows)
    if aux is None:  # no MoE layer
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    hidden = apply_norm(_tree(model.final_norm), x)
    embed = dict(model.embed.named_parameters())
    logits = unembed(cfg, embed, hidden[:, -1:] if last_only else hidden, tp)
    if mode != "train":
        logits = gather_vocab(logits, tp)
    return logits, new_caches, aux, hidden


def model_axis(model):
    """Where ``shard_model`` cut ``model`` on a ``model`` axis (a
    ``dist.sharding.ModelSplit``), or None."""
    return model.tp


def _xent(logits, labels, mask=None, start=None, tp=None):
    """The mean (or ``mask``-weighted) cross-entropy in fp32.  ``start``
    and ``tp``: ``logits`` are the vocabulary rows ``start ...`` of a
    model rank, and the loss is vocab-parallel — a detached max
    all-reduced over the model group, an all-reduced sum of
    exponentials, an all-reduced target logit (held by one rank) — equal
    to the full logits' on every rank."""
    lf = logits.float()
    if start is None:
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels[..., None])[..., 0]
    else:
        group, n = tp.model_group, lf.shape[-1]
        top = max_over_model(lf.detach().amax(-1), group)
        lse = torch.log(reduce_from_model(torch.exp(lf - top[..., None]).sum(-1), group)) + top
        local = labels - start
        inside = (local >= 0) & (local < n)
        gold = torch.gather(lf, -1, torch.where(inside, local, 0)[..., None])[..., 0]
        gold = reduce_from_model(torch.where(inside, gold, 0.0), group)
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _as_tokens(tokens, device):
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.asarray(tokens))
    return tokens.to(device=device, dtype=torch.long)


def train_loss(cfg, model, batch):
    """batch: {"tokens": (B, S+1)} (+ optional "mask", and "aux_inputs"
    for a model with a cross-attention source).  Returns
    (loss, metrics) with the reference's metric names: ``xent``, ``aux``,
    ``mtp`` when the model predicts more tokens (``cfg.mtp_depth`` and
    more than 2 tokens per row), and ``loss`` = xent + 0.3 · mtp / depth
    + aux."""
    tokens = _as_tokens(batch["tokens"], model.embed.tok.device)
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    logits, _, aux, hidden = forward(cfg, model, inputs, aux_inputs=batch.get("aux_inputs"))
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=logits.device)[:, 1:].float()
    tp = model_axis(model)
    loss = _xent(logits, labels, mask, vocab_start(logits.shape[-1], tp), tp)
    metrics = {"xent": loss, "aux": aux}
    if cfg.mtp_depth and tokens.shape[1] > 2:
        metrics["mtp"] = _mtp_loss(cfg, model, tokens, hidden)
        loss = loss + 0.3 * metrics["mtp"] / cfg.mtp_depth
    loss = loss + aux
    metrics["loss"] = loss
    return loss, metrics


def _mtp_loss(cfg, model, tokens, hidden):
    """DeepSeek-V3 multi-token prediction: depth k predicts token t+1+k
    from ``[norm_h(h_t) ; norm_e(emb(t+k))]`` through ``proj``, one extra
    layer (the last layer's spec with a dense FFN; outside the stack, no
    remat) and the shared final norm and head; sequential over depth, the
    cross-entropies summed in fp32.  On the ``model`` axis the embedding,
    the layer, the head and the cross-entropy run on the rank's shards as
    ``forward`` and ``train_loss`` run theirs; ``proj`` is replicated, and
    its input's and output's gradients are whole on every rank."""
    spec = dataclasses.replace(cfg.layers[-1], moe=None)
    tp = model_axis(model)
    embed = dict(model.embed.named_parameters())
    h, total = hidden, torch.zeros((), dtype=torch.float32, device=hidden.device)
    for k, node in enumerate(model.mtp, start=1):
        mp = _tree(node)
        emb_next = embed_tokens(cfg, model.embed.tok, tokens[:, k:-1], tp)
        merged = torch.cat([rms_norm(h[:, :emb_next.shape[1]], mp["norm_h"]["scale"]),
                            rms_norm(emb_next, mp["norm_e"]["scale"])], dim=-1)
        h = torch.einsum("bsd,de->bse", merged, mp["proj"].to(merged.dtype))
        h, _, _ = apply_layer(cfg, mp["layer"], h, spec, tp=tp)
        logits = unembed(cfg, embed, rms_norm(h, model.final_norm.scale), tp)
        total = total + _xent(logits, tokens[:, 1 + k:], None,
                              vocab_start(logits.shape[-1], tp), tp)
    return total


# ---------------------------------------------------------------- serving
@torch.no_grad()
def prefill(cfg, model, tokens, aux_inputs=None, target_len: int = 0,
            last_only: bool = False):
    """tokens: (B, S).  Returns (logits, caches): every position's logits
    (B, S, V) — the last position's alone (B, 1, V) with ``last_only`` —
    and per-segment caches of capacity ``max(target_len, S + 1)`` holding
    the prompt's K/V uncast (the activations' dtype) with ``pos`` = S
    (None for a cross-attention mixer).  A sharded module gathers the
    logits over the model group: a server passes ``last_only``, so the
    prompt's other positions are neither projected nor gathered."""
    logits, caches, _, _ = forward(cfg, model, tokens, mode="prefill",
                                   aux_inputs=aux_inputs, target_len=target_len,
                                   last_only=last_only)
    return logits, caches


@torch.no_grad()
def decode_step(cfg, model, caches, token, aux_inputs=None, rows=None):
    """token: (B, 1).  Returns (logits, caches): ``caches`` (from
    ``prefill`` or ``init_decode_caches``) is updated in place — this
    token's K/V written at ``pos % cap`` (a Mamba or xLSTM layer's state
    overwritten), ``pos`` advanced by one.  A model with a
    cross-attention source recomputes it from ``aux_inputs``.  ``rows``:
    the rows' ``RowSplit`` over the data ranks (``forward``)."""
    logits, caches, _, _ = forward(cfg, model, token, mode="decode", caches=caches,
                                   aux_inputs=aux_inputs, rows=rows)
    return logits, caches


def init_decode_caches(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
                       filled: Optional[int] = None, row_pos: bool = False,
                       device="cuda", tp=None):
    """Decode caches of capacity ``seq_len`` marked as holding ``filled``
    tokens (default ``seq_len - 1``: a full-but-one cache).  ``row_pos``
    makes every ``pos`` leaf one entry per batch row — ``(B,)`` for a
    single layer, ``(L, B)`` for a run or a pattern's position, Mamba's
    and xLSTM's as attention's — the serving slab's layout, where each slot decodes
    at its own depth.  A cross-attention mixer's entry is None.  ``tp``
    (a sharded module's ``model.tp``): the caches of that rank's KV
    heads, Mamba channels and mLSTM and sLSTM heads (MLA's latent
    whole)."""
    dev = resolve_device(device)
    caches = init_stack_caches(cfg, batch, seq_len, dtype, dev, tp)
    fill = seq_len - 1 if filled is None else int(filled)
    for seg in caches:
        for tree in (seg if isinstance(seg, list) else [seg]):  # a pattern: p trees
            if tree is None:  # a cross-attention mixer: no cache
                continue
            pos = tree["pos"]
            shape = tuple(pos.shape) + ((batch,) if row_pos else ())
            tree["pos"] = torch.full(shape, fill, dtype=pos.dtype, device=dev)
    return caches
