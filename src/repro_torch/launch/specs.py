"""``input_specs()``: meta-tensor stand-ins for every model input, per
(arch, input shape, step kind), after ``repro/launch/specs.py``.

A spec is a tensor on the meta device — the counterpart of
``jax.ShapeDtypeStruct``: a shape and a dtype, no storage.  The dry run
(``repro_torch.launch.dryrun``) runs the port's steps on these.  Axes are
tuples of the reference's logical names (``"workers"``, ``"batch"``,
``"frames"``, ``"patches"``, ``"kv_heads"``, ...; ``None`` for an axis
with no name), one per dimension.  Tokens are int64, the port's token
dtype (the reference's are int32).
"""
from __future__ import annotations

import torch

from ..configs.base import InputShape, ModelConfig
from ..models.model import init_decode_caches
from ..models.stack import Run, plan_segments

__all__ = ["input_specs", "input_axes", "step_kind"]

#: the reference's cache axes per mixer (``*_cache_axes``); a cross-
#: attention mixer has no cache
_CACHE_AXES = {
    "attn": {"k": ("batch", None, "kv_heads", None), "v": ("batch", None, "kv_heads", None),
             "pos": ()},
    "mla": {"c_kv": ("batch", None, None), "k_r": ("batch", None, None), "pos": ()},
    "mamba": {"conv": ("batch", None, "d_inner"), "h": ("batch", "d_inner", None), "pos": ()},
    "mlstm": {"C": ("batch", "heads", None, None), "n": ("batch", "heads", None),
              "m": ("batch", "heads"), "conv": ("batch", None, "d_inner"), "pos": ()},
    "slstm": {"h": ("batch", "embed"), "c": ("batch", "embed"), "n": ("batch", "embed"),
              "m": ("batch", "embed"), "pos": ()},
}


def step_kind(shape: InputShape) -> str:
    return {"train": "train", "prefill": "prefill", "decode": "serve"}[shape.kind]


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype, device="meta")


def _aux_specs(cfg: ModelConfig, batch: int):
    if cfg.vision is not None:
        return (_spec((batch, cfg.vision.n_patches, cfg.vision.d_vision), torch.float32),
                ("batch", "patches", None))
    if cfg.encoder is not None:
        return (_spec((batch, cfg.encoder.n_frames, cfg.d_model), torch.float32),
                ("batch", "frames", "embed"))
    return None, None


def _cache_axes(cfg: ModelConfig) -> list:
    """Axis trees matching ``init_decode_caches``: a stacked run's and a
    pattern's leaves lead with ``"layers"``."""
    def one(spec, stacked):
        axes = _CACHE_AXES.get(spec.mixer)
        if axes is None:
            return None
        return {k: (("layers",) if stacked else ()) + a for k, a in axes.items()}

    return [one(seg.spec, seg.count > 1) if isinstance(seg, Run)
            else [one(spec, True) for spec in seg.specs]
            for seg in plan_segments(cfg.layers)]


def input_specs(cfg: ModelConfig, shape: InputShape, *, coded: bool = False,
                n_workers: int = 16, s_max: int = 0, tp=None):
    """Returns (specs dict, axes dict) for the step's data inputs: a
    training step's tokens (B, S+1) — or, ``coded``, the workers' shards
    (N, K, B/N, S+1) with K = s_max + 1, and a ``dec_w`` the caller fills
    (it needs the plan's levels) — a prefill's tokens (B, S), or a decode
    step's caches of capacity S (bf16) and its token (B, 1); plus the
    modality embeddings ``aux_inputs`` of a model with a cross-attention
    source (vision patches, or encoder frames).  ``tp`` (a sharded
    module's ``model.tp``): the caches of that rank's KV heads and
    states (``init_decode_caches(tp=)``)."""
    b, s = shape.global_batch, shape.seq_len
    aux, aux_ax = _aux_specs(cfg, b)
    if shape.kind == "train":
        if coded:
            k = s_max + 1
            rows = b // n_workers
            specs = {"worker_batches": _spec((n_workers, k, rows, s + 1), torch.int64),
                     "dec_w": None}
            axes = {"worker_batches": ("workers", None, "batch", None), "dec_w": (None, None)}
        else:
            specs = {"tokens": _spec((b, s + 1), torch.int64)}
            axes = {"tokens": ("batch", None)}
    elif shape.kind == "prefill":
        specs = {"tokens": _spec((b, s), torch.int64)}
        axes = {"tokens": ("batch", None)}
    else:  # decode: one new token against a seq_len cache
        specs = {"caches": init_decode_caches(cfg, b, s, dtype=torch.bfloat16, device="meta",
                                              tp=tp),
                 "token": _spec((b, 1), torch.int64)}
        axes = {"caches": _cache_axes(cfg), "token": ("batch", None)}
    if aux is not None:
        specs["aux_inputs"] = aux
        axes["aux_inputs"] = aux_ax
    return specs, axes


def input_axes(cfg: ModelConfig, shape: InputShape, **kw) -> dict:
    """The axes half of ``input_specs``."""
    return input_specs(cfg, shape, **kw)[1]
