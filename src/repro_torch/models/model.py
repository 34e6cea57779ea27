"""The decoder LM's forward pass and training loss, after
``repro/models/model.py`` (``forward``, ``_xent``, ``train_loss``) —
the dense path only; MTP, encoders and vision are ROADMAP 1.9."""
from __future__ import annotations

import torch

from .layers import embed_tokens, rms_norm, unembed
from .stack import apply_stack

__all__ = ["forward", "train_loss"]


def forward(cfg, model, tokens):
    """tokens: (B, S) integer.  Returns (logits, hidden)."""
    x = embed_tokens(cfg, model.embed.tok, tokens)
    x = apply_stack(cfg, model.stack, x)
    hidden = rms_norm(x, model.final_norm.scale)
    return unembed(cfg, model.embed.tok, hidden), hidden


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
        tokens = torch.from_numpy(tokens)
    return tokens.to(device=device, dtype=torch.long)


def train_loss(cfg, model, batch):
    """batch: {"tokens": (B, S+1)} (+ optional "mask").  Returns
    (loss, metrics) with the reference's metric names."""
    tokens = _as_tokens(batch["tokens"], model.embed.tok.device)
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    logits, _ = forward(cfg, model, inputs)
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=logits.device)[:, 1:].float()
    loss = _xent(logits, labels, mask)
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    metrics = {"xent": loss, "aux": aux}
    loss = loss + aux
    metrics["loss"] = loss
    return loss, metrics
