"""The decoder LM, after ``repro/models/model.py``: ``forward`` in
training, prefill or decode mode, ``train_loss``, and the serving entry
points ``prefill``, ``decode_step`` and ``init_decode_caches`` — the
dense path only; MTP, encoders and vision are ROADMAP 1.9."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .layers import embed_tokens, rms_norm, unembed
from .stack import apply_stack, init_stack_caches

__all__ = ["forward", "train_loss", "prefill", "decode_step", "init_decode_caches"]


def forward(cfg, model, tokens, *, mode="train", caches=None, target_len: int = 0):
    """tokens: (B, S) integer.  Returns (logits, new_caches, aux, hidden);
    ``new_caches`` is None in training, and in decode mode it is
    ``caches``, updated in place."""
    tokens = _as_tokens(tokens, model.embed.tok.device)
    x = embed_tokens(cfg, model.embed.tok, tokens)
    x, new_caches = apply_stack(cfg, model.stack, x, mode=mode, caches=caches,
                                target_len=target_len)
    hidden = rms_norm(x, model.final_norm.scale)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(cfg, model.embed.tok, hidden), new_caches, aux, hidden


def _xent(logits, labels, mask=None):
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _as_tokens(tokens, device):
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.asarray(tokens))
    return tokens.to(device=device, dtype=torch.long)


def train_loss(cfg, model, batch):
    """batch: {"tokens": (B, S+1)} (+ optional "mask").  Returns
    (loss, metrics) with the reference's metric names."""
    tokens = _as_tokens(batch["tokens"], model.embed.tok.device)
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    logits, _, aux, _ = forward(cfg, model, inputs)
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=logits.device)[:, 1:].float()
    loss = _xent(logits, labels, mask)
    metrics = {"xent": loss, "aux": aux}
    loss = loss + aux
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------- serving
@torch.no_grad()
def prefill(cfg, model, tokens, target_len: int = 0):
    """tokens: (B, S).  Returns (logits, caches): every position's logits,
    and per-segment caches of capacity ``max(target_len, S + 1)`` holding
    the prompt's K/V uncast (the activations' dtype) with ``pos`` = S."""
    logits, caches, _, _ = forward(cfg, model, tokens, mode="prefill",
                                   target_len=target_len)
    return logits, caches


@torch.no_grad()
def decode_step(cfg, model, caches, token):
    """token: (B, 1).  Returns (logits, caches): ``caches`` (from
    ``prefill`` or ``init_decode_caches``) is updated in place — this
    token's K/V written at ``pos % cap``, ``pos`` advanced by one."""
    logits, caches, _, _ = forward(cfg, model, token, mode="decode", caches=caches)
    return logits, caches


def init_decode_caches(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
                       filled: Optional[int] = None, row_pos: bool = False,
                       device="cuda"):
    """Decode caches of capacity ``seq_len`` marked as holding ``filled``
    tokens (default ``seq_len - 1``: a full-but-one cache).  ``row_pos``
    makes every ``pos`` leaf one entry per batch row — ``(B,)`` for a
    single layer, ``(L, B)`` for a run — the serving slab's layout, where
    each slot decodes at its own depth."""
    dev = resolve_device(device)
    caches = init_stack_caches(cfg, batch, seq_len, dtype, dev)
    fill = seq_len - 1 if filled is None else int(filled)
    for tree in caches:
        pos = tree["pos"]
        shape = tuple(pos.shape) + ((batch,) if row_pos else ())
        tree["pos"] = torch.full(shape, fill, dtype=pos.dtype, device=dev)
    return caches
