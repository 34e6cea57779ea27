"""The parameter tree of the decoder LM as an ``nn.Module``.

Parameter names are the reference's key paths (``embed.tok``,
``stack.0.mixer.wq``, ``mtp.0.proj``, ...): a run of identical layers holds its leaves
stacked along a leading ``(count, ...)`` axis, and a ``Pattern`` segment
is an ``nn.ModuleList`` of p layer nodes, each stacked over the repeats
(``stack.0.3.mixer.q_norm``), as ``repro/models/stack.py::init_stack``
builds them.  So one ``Plan`` and one ``FlatLayout`` bind to both
packages.

``GCLM.leaves()`` returns the parameters in ``jax.tree.leaves`` order —
dict keys sorted at every level, list entries in index order — which is
NOT ``nn.Module`` registration order (ROADMAP 3.4): ``embed.tok`` before
``embed.unembed`` (an untied head), a mixture-of-experts FFN's
``ffn.router`` before ``ffn.shared.*`` before ``ffn.wg``, ``ffn.wi``,
``ffn.wo``, and the QKV biases ``mixer.bk``/``bq``/``bv`` before the
projections.  For gc-lm-110m that is the 11 leaves ``embed.tok``,
``final_norm.scale``, ``stack.0.ffn.{wg,wi,wo}``,
``stack.0.mixer.{wk,wo,wq,wv}``, ``stack.0.norm_ffn.scale``,
``stack.0.norm_mix.scale``.  DeepSeek-V3's multi-token prediction
modules (``mtp``, a list of ``{layer, norm_e, norm_h, proj}``) sort
between ``final_norm`` and ``stack``; an MLA mixer's nine leaves sort as
``kv_a_norm``, ``q_a_norm``, ``wk_b``, ``wk_rope``, ``wkv_a``, ``wo``,
``wq_a``, ``wq_b``, ``wv_b``; a Mamba mixer's nine as ``a_log``,
``conv_b``, ``conv_w``, ``d_skip``, ``dt_bias``, ``dt_proj``,
``in_proj``, ``out_proj``, ``x_proj``; an mLSTM mixer's eleven as
``b_f``, ``b_i``, ``conv_b``, ``conv_w``, ``down``, ``gn_scale``, ``up``,
``w_if``, ``wk``, ``wq``, ``wv``, an sLSTM mixer's seven as ``b_gates``,
``down``, ``gn_scale``, ``r_gates``, ``up1``, ``up2``, ``w_gates``; a
layer without an FFN sublayer (xLSTM) has neither ``norm_ffn`` nor
``ffn``.  A cross-attention mixer or sublayer (``cross``, with
``norm_cross`` before it) holds ``gate`` (a scalar per layer),
``wk``, ``wo``, ``wq``, ``wv``; under ``norm="layer"`` (Whisper) every
norm node holds ``bias`` and ``scale``, and Whisper's ungated MLP has no
``wg``.  Whisper's ``encoder`` (``final_norm``, then ``layers``: a list
of unstacked layer nodes with QKV biases and layer norms) sorts between
``embed`` and ``final_norm``; Llama-3.2-vision's projector
``vision_proj`` (d_vision, d) sorts last.  whisper-base has 103 leaves,
llama-3.2-vision-11b 50.

Weights are drawn from a ``torch.Generator`` with the law of the
reference's ``dense_init`` (truncated normal on [-2, 2], std 1/sqrt(fan_in)
of the per-layer shape: E·d for an expert's ``wi``/``wg`` of shape
(E, d, f), E·f for its ``wo``); a layer norm's ``scale`` starts at one
and its ``bias`` and the cross-attention ``gate`` at zero, as the
reference's; ``torch`` cannot reproduce
``jax.random``, so parity tests carry the reference's arrays across
with ``params_from_numpy``.

Every leaf carries its logical axes as the reference's ``Param.axes``
names them (``GCLM.leaf_axes``; a stacked leaf's first is ``layers``),
which ``dist/sharding.py``'s rules map onto a mesh (``shard_dims``).
A leaf that fuses several outputs along one dimension says so where it
is declared (``GCLM.leaf_blocks``: Mamba's ``in_proj`` and the mLSTM's
``up``, the input and the gate z side by side; the sLSTM's ``w_gates``
and ``b_gates``, its four gates, each head-major); the axis cuts each of
those blocks, so a rank holds its slice of every one (``shard_blocks``),
as Megatron's merged column-parallel linear does.  ``shard_model`` gives
a rank of a ``model`` axis its shards (its heads, MLP columns or rows,
Mamba's and the mLSTM's channels, vocabulary rows, a MoE's experts or
their FFN columns or rows, an encoder's heads), ``init_shards`` draws
them without the full tree on the device, and ``gather_model``
all-gathers them back; ``shard_of`` and its inverse
``gather_leaf`` are the one cut and the one gather of a leaf, which the
checkpoint path uses too, so a gathered tree is the reference's layout
byte for byte.

A training state is cut once more where the config sets ``fsdp``: the
``data`` axis takes a leaf's ``embed`` dimension wherever it divides it
(``data_dims``, the reference's ``state_shardings``), and
``init_shards(..., over_data=True)`` keeps the rank's (data, model)
shard — a contiguous slice at its ``data_index`` (``data_shard_of``) of
its model shard.  Two shapes then differ: the *working* shapes
(``local_shapes``, the ``model`` cut alone), which the forward and
backward passes and a plan's rank layout bind, and the *state* shapes
(``state_shapes``), which the rank keeps between steps.
``gather_data`` all-gathers a state's cut leaves into the working
module, and ``gather_model`` gathers both cuts back into the full tree.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..configs.base import LayerSpec
from ..device import resolve_device
from ..dist.collectives import all_gather
from ..dist.sharding import DataSplit, ModelSplit, data_dim, make_rules, model_dim
from .blocks import has_ffn
from .ssm import a_log_init, dt_bias_init, mamba_dims
from .stack import Run, plan_segments
from .xlstm import mlstm_dims, slstm_dims

__all__ = ["ParamNode", "GCLM", "encoder_cfg", "params_from_numpy", "params_to_numpy",
           "count_params", "shard_dims", "shard_blocks", "local_shapes", "shard_of",
           "gather_leaf", "shard_model", "init_shards", "gather_model", "data_dims",
           "state_shapes", "data_shard_of", "gather_data_leaf", "gather_data"]


class ParamNode(nn.Module):
    """A dict node of the parameter tree: named parameters, given as
    ``(tensor, logical axes, blocks)`` triples, and children.
    ``axes[name]`` is the parameter's logical axes, the reference's
    ``Param.axes``; ``blocks[name]``, for a leaf that fuses several
    outputs, ``(dimension, count)``."""

    def __init__(self, params: dict = None, children: dict = None):
        super().__init__()
        self.axes, self.blocks = {}, {}
        for name, (value, axes, blocks) in (params or {}).items():
            self.register_parameter(name, nn.Parameter(value))
            self.axes[name] = tuple(axes)
            if blocks is not None:
                self.blocks[name] = blocks
        for name, child in (children or {}).items():
            self.add_module(name, child)


def _zeros(shape, device):
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _leaf_maker(device, count: int = 1):
    """``z(axes, *shape)`` -> a zero leaf, its logical axes and its blocks,
    with a leading ``(count,)`` axis named ``layers`` when a segment
    stacks more than one layer (the reference's ``stack_params``).  An
    entry of ``shape`` given as a tuple of widths is a dimension that
    fuses that many outputs side by side: its size is their sum, and the
    blocks ``(that dimension, their number)``."""
    lead, lead_axes = ((count,), ("layers",)) if count > 1 else ((), ())

    def z(axes, *shape):
        if len(axes) != len(shape):
            raise ValueError(f"axes {axes} for shape {shape}")
        blocks = next(((len(lead) + i, len(n)) for i, n in enumerate(shape)
                       if isinstance(n, tuple)), None)
        shape = tuple(sum(n) if isinstance(n, tuple) else n for n in shape)
        return _zeros(lead + shape, device), lead_axes + tuple(axes), blocks

    return z


def _layer_node(cfg, spec, count: int, device) -> ParamNode:
    """One layer's parameters; leaves carry a leading (count,) axis when
    the segment stacks more than one layer."""
    if spec.mixer not in _MIXER_LEAVES:
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    z = _leaf_maker(device, count)

    def norm():
        return _norm_node(cfg, z)

    children = {"norm_mix": norm(), "mixer": ParamNode(_MIXER_LEAVES[spec.mixer](cfg, z))}
    if spec.cross_source:
        children.update(cross=ParamNode(_cross_leaves(cfg, z)), norm_cross=norm())
    if cfg.post_norm:
        children["norm_mix_post"] = norm()
    if has_ffn(cfg, spec):
        children.update(norm_ffn=norm(), ffn=_ffn_node(cfg, spec, z))
        if cfg.post_norm:
            children["norm_ffn_post"] = norm()
    return ParamNode(children=children)


_E, _H, _KV, _DH = "embed", "heads", "kv_heads", "head_dim"


def _norm_node(cfg, z) -> ParamNode:
    """``scale`` (rms norm: scale - 1), and ``bias`` under layer norm."""
    d = cfg.d_model
    if cfg.norm == "layer":
        return ParamNode({"scale": z((_E,), d), "bias": z((_E,), d)})
    return ParamNode({"scale": z((_E,), d)})


def _attn_leaves(cfg, z) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mixer = {"wq": z((_E, _H, _DH), d, h, dh), "wk": z((_E, _KV, _DH), d, kv, dh),
             "wv": z((_E, _KV, _DH), d, kv, dh), "wo": z((_H, _DH, _E), h, dh, d)}
    if cfg.qkv_bias:
        mixer.update(bq=z((_H, _DH), h, dh), bk=z((_KV, _DH), kv, dh),
                     bv=z((_KV, _DH), kv, dh))
    if cfg.qk_norm:
        mixer.update(q_norm=z((_DH,), dh), k_norm=z((_DH,), dh))
    return mixer


def _cross_leaves(cfg, z) -> dict:
    """``repro/models/attention.py::init_cross_attention``'s leaves, the
    source of width d_model (the projector's output, or the encoder's):
    no biases, and the scalar tanh ``gate``."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": z((_E, _H, _DH), d, h, dh), "wk": z((_E, _KV, _DH), d, kv, dh),
            "wv": z((_E, _KV, _DH), d, kv, dh), "wo": z((_H, _DH, _E), h, dh, d),
            "gate": z(())}


def _mla_leaves(cfg, z) -> dict:
    """``repro/models/mla.py::init_mla``'s nine leaves."""
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {"wq_a": z((_E, "lora"), d, m.q_lora_rank), "q_a_norm": z(("lora",), m.q_lora_rank),
            "wq_b": z(("lora", _H, _DH), m.q_lora_rank, h, qk),
            "wkv_a": z((_E, "lora"), d, m.kv_lora_rank),
            "kv_a_norm": z(("lora",), m.kv_lora_rank),
            "wk_rope": z((_E, _DH), d, m.qk_rope_head_dim),
            "wk_b": z(("lora", _H, _DH), m.kv_lora_rank, h, m.qk_nope_head_dim),
            "wv_b": z(("lora", _H, _DH), m.kv_lora_rank, h, m.v_head_dim),
            "wo": z((_H, _DH, _E), h, m.v_head_dim, d)}


def _mamba_leaves(cfg, z) -> dict:
    """``repro/models/ssm.py::init_mamba``'s nine leaves."""
    m, d_inner, dt_rank = mamba_dims(cfg)
    d, di = cfg.d_model, "d_inner"
    return {"in_proj": z((_E, di), d, (d_inner, d_inner)),  # x and the gate z
            "conv_w": z(("conv", di), m.d_conv, d_inner),
            "conv_b": z((di,), d_inner),
            "x_proj": z((di, "state"), d_inner, dt_rank + 2 * m.d_state),
            "dt_proj": z(("lora", di), dt_rank, d_inner), "dt_bias": z((di,), d_inner),
            "a_log": z((di, "state"), d_inner, m.d_state), "d_skip": z((di,), d_inner),
            "out_proj": z((di, _E), d_inner, d)}


def _mlstm_leaves(cfg, z) -> dict:
    """``repro/models/xlstm.py::init_mlstm``'s eleven leaves: headwise
    (block-diagonal) ``wq``/``wk``/``wv`` (nh, dh, dh)."""
    spec, d_inner, nh, dh = mlstm_dims(cfg)
    d, di = cfg.d_model, "d_inner"
    return {"up": z((_E, di), d, (d_inner, d_inner)),  # x_m and the gate z
            "conv_w": z(("conv", di), spec.conv_kernel, d_inner),
            "conv_b": z((di,), d_inner), "wq": z((_H, None, _DH), nh, dh, dh),
            "wk": z((_H, None, _DH), nh, dh, dh), "wv": z((_H, None, _DH), nh, dh, dh),
            "w_if": z((di, _H), d_inner, 2 * nh), "b_i": z((_H,), nh), "b_f": z((_H,), nh),
            "gn_scale": z((di,), d_inner), "down": z((di, _E), d_inner, d)}


def _slstm_leaves(cfg, z) -> dict:
    """``repro/models/xlstm.py::init_slstm``'s seven leaves: the
    block-diagonal recurrence ``r_gates`` (nh, dh, 4·dh), the post-up
    GeGLU of width round(4/3·d)."""
    nh, dh, d_up = slstm_dims(cfg)
    d = cfg.d_model
    gates = (d, d, d, d)  # i, f, z, o, each head-major
    return {"w_gates": z((_E, "d_inner"), d, gates),
            "r_gates": z((_H, None, "d_inner"), nh, dh, 4 * dh),
            "b_gates": z(("d_inner",), gates), "gn_scale": z((_E,), d),
            "up1": z((_E, "mlp"), d, d_up), "up2": z((_E, "mlp"), d, d_up),
            "down": z(("mlp", _E), d_up, d)}


_MIXER_LEAVES = {"attn": _attn_leaves, "cross_attn": _cross_leaves, "mla": _mla_leaves,
                 "mamba": _mamba_leaves, "mlstm": _mlstm_leaves, "slstm": _slstm_leaves}


def encoder_cfg(cfg):
    """The config of Whisper's encoder layers: QKV biases and layer norms."""
    return cfg.replace(qkv_bias=True, norm="layer")


def _encoder_node(cfg, device) -> ParamNode:
    """Whisper's encoder: ``layers`` (a list of unstacked layer nodes, global
    attention with QKV biases, layer norms, the config's MLP) and
    ``final_norm`` (a layer norm)."""
    ecfg = encoder_cfg(cfg)
    spec = LayerSpec(mixer="attn")
    return ParamNode({}, {
        "layers": nn.ModuleList(_layer_node(ecfg, spec, 1, device)
                                for _ in range(cfg.encoder.n_layers)),
        "final_norm": _norm_node(ecfg, _leaf_maker(device))})


def _mtp_node(cfg, device) -> ParamNode:
    """One multi-token prediction module (``repro/models/model.py``):
    ``proj`` (2d, d), ``norm_h``, ``norm_e`` and one layer — the last
    layer's spec with a dense FFN."""
    d, z = cfg.d_model, _leaf_maker(device)
    spec = dataclasses.replace(cfg.layers[-1], moe=None)
    return ParamNode({"proj": z((_E, _E), 2 * d, d)},
                     {"layer": _layer_node(cfg, spec, 1, device),
                      "norm_h": _norm_node(cfg, z), "norm_e": _norm_node(cfg, z)})


def _ffn_node(cfg, spec, z) -> ParamNode:
    """A dense MLP (gated: ``wg`` beside ``wi``, ``wo``; or ungated), or
    ``repro/models/moe.py::init_moe``'s tree:
    ``router`` (d, E), experts ``wi``/``wg`` (E, d, f) and ``wo`` (E, f, d),
    and ``shared.{wi, wg, wo}`` of width f·num_shared when there are
    shared experts."""
    d = cfg.d_model
    if spec.moe is None:
        mlp = {"wi": z((_E, "mlp"), d, cfg.d_ff), "wo": z(("mlp", _E), cfg.d_ff, d)}
        if cfg.activation in ("silu", "gelu"):  # gated; Whisper's "gelu_mlp" is not
            mlp["wg"] = z((_E, "mlp"), d, cfg.d_ff)
        return ParamNode(mlp)
    e, f = spec.moe.num_experts, spec.moe.d_ff
    children = {}
    if spec.moe.num_shared:
        fs = f * spec.moe.num_shared
        children["shared"] = ParamNode({"wi": z((_E, "mlp"), d, fs),
                                        "wg": z((_E, "mlp"), d, fs),
                                        "wo": z(("mlp", _E), fs, d)})
    ex = ("experts", _E, "expert_mlp")
    return ParamNode({"router": z((_E, "experts"), d, e), "wi": z(ex, e, d, f),
                      "wg": z(ex, e, d, f), "wo": z(("experts", "expert_mlp", _E), e, f, d)},
                     children)


def _segment_node(cfg, seg, device) -> nn.Module:
    """A run's layer node, or a pattern's ``ModuleList`` of p layer nodes
    stacked over the repeats."""
    if isinstance(seg, Run):
        return _layer_node(cfg, seg.spec, seg.count, device)
    return nn.ModuleList(_layer_node(cfg, spec, seg.repeats, device) for spec in seg.specs)


#: leaves the reference initializes to zero: rms-norm scales (which store
#: scale - 1), the QK-norm and MLA-norm scales, the QKV biases, the
#: Mamba and mLSTM convs' bias, the mLSTM input gate's bias, the layer
#: norms' bias and the cross-attention gate (a layer norm's ``scale``,
#: beside a ``bias``, starts at one instead)
ZERO_INIT = ("scale", "q_norm", "k_norm", "q_a_norm", "kv_a_norm", "bq", "bk", "bv", "conv_b",
             "b_i", "bias", "gate")


def _slstm_b_gates(cfg) -> np.ndarray:
    """The sLSTM gate biases: 0 (i), 3 (f: forget-open), 0 (z), 0 (o)."""
    d = cfg.d_model
    return np.concatenate([np.zeros(d), np.full(d, 3.0), np.zeros(2 * d)]).astype(np.float32)


#: leaves with fixed values, the reference's bit for bit (every layer
#: alike), broadcast over a stacked leaf: Mamba's skip weight one,
#: ``a_log`` and ``dt_bias`` (``ssm.py``); the xLSTM group norms' scale
#: one, the mLSTM forget bias 3 and the sLSTM gate biases
FIXED_INIT = {"d_skip": lambda cfg: np.ones(mamba_dims(cfg)[1], np.float32),
              "a_log": a_log_init, "dt_bias": dt_bias_init,
              "gn_scale": lambda cfg: np.ones(1, np.float32),
              "b_f": lambda cfg: np.full(1, 3.0, np.float32), "b_gates": _slstm_b_gates}


class GCLM(nn.Module):
    """Decoder LM parameters: ``embed`` (``tok``, and ``unembed`` for an
    untied head), ``stack`` (one node per segment:
    a run of identical layers, or a pattern's list of p layer nodes),
    ``final_norm`` and, when ``cfg.mtp_depth``, ``mtp`` (a list of
    multi-token prediction modules), when ``cfg.encoder``, ``encoder``,
    and when ``cfg.vision``, ``vision_proj``, initialized from ``seed``."""

    def __init__(self, cfg, *, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.axes, self.blocks = {}, {}
        #: where ``shard_model`` cut this module on a ``model`` axis (a
        #: ``dist.sharding.ModelSplit``), each leaf's split dimension and
        #: the blocks that dimension is cut in (``shard_blocks``), or None
        #: and no splits; ``fsdp``: where ``init_shards(..., over_data=True)``
        #: cut it on a ``data`` axis (a ``dist.sharding.DataSplit``), or None
        self.tp, self.shard_dims, self.shard_blocks = None, None, None
        self.fsdp = None
        z = _leaf_maker(dev)
        embed = {"tok": z(("vocab", _E), cfg.vocab, cfg.d_model)}
        if not cfg.tie_embeddings:
            embed["unembed"] = z((_E, "vocab"), cfg.d_model, cfg.vocab)
        self.embed = ParamNode(embed)
        self.stack = nn.ModuleList(_segment_node(cfg, seg, dev)
                                   for seg in plan_segments(cfg.layers))
        self.final_norm = _norm_node(cfg, z)
        if cfg.encoder is not None:
            self.encoder = _encoder_node(cfg, dev)
        if cfg.vision is not None:
            self.vision_proj = nn.Parameter(_zeros((cfg.vision.d_vision, cfg.d_model), dev))
            self.axes = {"vision_proj": (_E, _E)}
        if cfg.mtp_depth:
            self.mtp = nn.ModuleList(_mtp_node(cfg, dev) for _ in range(cfg.mtp_depth))
        if dev.type != "meta":  # a meta model carries shapes only
            self.reset_parameters(seed)

    # ----------------------------------------------------------- leaf order
    def leaf_items(self) -> list:
        """[(path, parameter)] in ``jax.tree.leaves`` order."""
        return [(path, t) for path, t, _ in _walk(self, ())]

    def leaf_axes(self) -> list:
        """Every leaf's logical axes in leaf order, as the reference's
        ``Param.axes`` names them (``("layers", "embed", "heads",
        "head_dim")`` for a stacked ``wq``)."""
        return [node.axes[path[-1]] for path, _, node in _walk(self, ())]

    def leaf_blocks(self) -> list:
        """Every leaf's fused outputs in leaf order: ``(dimension,
        count)`` for a leaf whose dimension holds ``count`` outputs side
        by side (Mamba's ``in_proj`` and the mLSTM's ``up``: ``(1, 2)``, x
        then the gate z; the sLSTM's ``w_gates``: ``(1, 4)``), else
        None."""
        return [node.blocks.get(path[-1]) for path, _, node in _walk(self, ())]

    def leaf_paths(self) -> list:
        return [".".join(p) for p, _ in self.leaf_items()]

    def leaves(self) -> list:
        return [t for _, t in self.leaf_items()]

    def tree(self, leaves=None) -> dict:
        """The reference's parameter tree — nested dicts; ``stack``,
        ``mtp`` and ``encoder.layers`` lists — holding ``leaves`` (leaf
        order; default: the parameters) by reference, not copied."""
        leaves = self.leaves() if leaves is None else list(leaves)
        out = {"stack": [[{} for _ in node] if isinstance(node, nn.ModuleList) else {}
                         for node in self.stack]}
        if self.cfg.mtp_depth:
            out["mtp"] = [{} for _ in self.mtp]
        if self.cfg.encoder is not None:
            out["encoder"] = {"layers": [{} for _ in self.encoder.layers]}
        for (path, _), leaf in zip(self.leaf_items(), leaves, strict=True):
            node = out
            for key in path[:-1]:
                node = node[int(key)] if isinstance(node, list) else node.setdefault(key, {})
            node[path[-1]] = leaf
        return out

    # ----------------------------------------------------------------- init
    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """``dense_init`` law for matrices, zeros for the leaves the
        reference zero-inits (``ZERO_INIT``), one for a layer norm's
        ``scale``, the reference's fixed values for Mamba's ``d_skip``,
        ``a_log`` and ``dt_bias`` and xLSTM's ``gn_scale``, ``b_f`` and
        ``b_gates`` (``FIXED_INIT``)."""
        gen = torch.Generator(device=self.embed.tok.device).manual_seed(int(seed))
        items = self.leaf_items()
        for _ in _drawn(self.cfg, [p for p, _ in items], items, gen):
            pass


def _walk(node, prefix):
    """(path, parameter, the node holding it) in leaf order."""
    if isinstance(node, nn.ModuleList):
        for i, child in enumerate(node):
            yield from _walk(child, prefix + (str(i),))
        return
    items = {**node._parameters, **node._modules}
    for name in sorted(items):
        value = items[name]
        if isinstance(value, nn.Parameter):
            yield prefix + (name,), value, node
        elif value is not None:
            yield from _walk(value, prefix + (name,))


@torch.no_grad()
def _drawn(cfg, paths, items, gen):
    """Fill each ``(path, tensor)`` of ``items`` (every leaf, in leaf
    order; ``paths`` all their paths) by ``reset_parameters``' law from
    ``gen``, yielding each once it is filled."""
    stacked = {seg_i for seg_i, seg in enumerate(plan_segments(cfg.layers))
               if not isinstance(seg, Run) or seg.count > 1}
    paths = set(paths)
    for path, t in items:
        if path[-1] == "scale" and path[:-1] + ("bias",) in paths:  # a layer norm
            t.fill_(1.0)
        elif path[-1] in ZERO_INIT:
            t.zero_()
        elif path[-1] in FIXED_INIT:
            t.copy_(torch.from_numpy(FIXED_INIT[path[-1]](cfg)).expand_as(t))
        else:
            per_layer = tuple(t.shape[1:]) if (
                path[0] == "stack" and int(path[1]) in stacked) else tuple(t.shape)
            fan_in = per_layer[0] if len(per_layer) == 1 else int(np.prod(per_layer[:-1]))
            std = 1.0 / np.sqrt(max(fan_in, 1))
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
            t.mul_(std)
        yield path, t
        del t  # the caller lets the full leaf go before the next is made


def _set_leaf(model, path, value) -> None:
    node = model
    for key in path[:-1]:
        node = node[int(key)] if isinstance(node, nn.ModuleList) else getattr(node, key)
    setattr(node, path[-1], nn.Parameter(value))


def shard_dims(cfg, mesh) -> tuple:
    """Each leaf's dimension that ``mesh``'s ``model`` axis splits, or
    None, in leaf order: ``dist.sharding.model_dim`` under
    ``make_rules(cfg)`` — the one place the port decides a split."""
    meta, rules = GCLM(cfg, device="meta"), make_rules(cfg)
    return tuple(model_dim(axes, t.shape, mesh, rules)
                 for t, axes in zip(meta.leaves(), meta.leaf_axes(), strict=True))


def shard_blocks(cfg, mesh) -> tuple:
    """Beside ``shard_dims``: the blocks each leaf's split dimension is cut
    in, in leaf order — the number of outputs the leaf fuses along that
    dimension (``GCLM.leaf_blocks``: 2 for Mamba's ``in_proj`` and the
    mLSTM's ``up``, 4 for the sLSTM's ``w_gates`` and ``b_gates``), else 1
    (also for a leaf the axis leaves whole).  Raises ``ValueError`` where
    a block's width does not split over the axis."""
    meta = GCLM(cfg, device="meta")
    out = []
    for t, dim, fused in zip(meta.leaves(), shard_dims(cfg, mesh), meta.leaf_blocks(),
                             strict=True):
        n = fused[1] if dim is not None and fused is not None and fused[0] == dim else 1
        if dim is not None and t.shape[dim] % (n * mesh.model):
            raise ValueError(f"{cfg.name}: {n} blocks of dimension {dim} of a {tuple(t.shape)} "
                             f"leaf do not split over a model axis of {mesh.model}")
        out.append(n)
    return tuple(out)


def local_shapes(cfg, mesh) -> list:
    """One model rank's leaf shapes (``shard_dims``' splits)."""
    out = []
    for t, dim in zip(GCLM(cfg, device="meta").leaves(), shard_dims(cfg, mesh)):
        shape = tuple(t.shape)
        if dim is not None:
            shape = shape[:dim] + (shape[dim] // mesh.model,) + shape[dim + 1:]
        out.append(shape)
    return out


def data_dims(cfg, mesh) -> tuple:
    """Each leaf's dimension that ``mesh``'s ``data`` axis cuts in a
    training state, or None, in leaf order: ``dist.sharding.data_dim``
    under ``make_rules(cfg)`` — the ``embed`` dimension where ``cfg.fsdp``
    maps it onto ``data`` and ``data`` divides it.  It is never a
    dimension the ``model`` axis splits nor one that fuses several
    outputs (``GCLM.leaf_blocks``), so the cut is one contiguous slice."""
    meta, rules = GCLM(cfg, device="meta"), make_rules(cfg)
    out = []
    for t, axes, fused, mdim in zip(meta.leaves(), meta.leaf_axes(), meta.leaf_blocks(),
                                    shard_dims(cfg, mesh), strict=True):
        dim = data_dim(axes, t.shape, mesh, rules)
        assert dim is None or (dim != mdim and (fused is None or fused[0] != dim)), \
            (cfg.name, axes, dim, mdim, fused)
        out.append(dim)
    return tuple(out)


def state_shapes(cfg, mesh) -> list:
    """One rank's leaf shapes in a training state: ``local_shapes`` (the
    ``model`` cut), each ``data_dims`` dimension then cut by ``mesh.data``."""
    out = []
    for shape, dim in zip(local_shapes(cfg, mesh), data_dims(cfg, mesh), strict=True):
        if dim is not None:
            shape = shape[:dim] + (shape[dim] // mesh.data,) + shape[dim + 1:]
        out.append(shape)
    return out


def data_shard_of(t: torch.Tensor, dim, mesh) -> torch.Tensor:
    """This rank's slice of ``t`` on its ``data_dims`` dimension ``dim``:
    the ``data_index``-th of ``mesh.data`` equal contiguous slices (a
    view); ``t`` itself when ``dim`` is None."""
    if dim is None:
        return t
    n = t.shape[dim] // mesh.data
    return t.narrow(dim, mesh.data_index * n, n)


def gather_data_leaf(t: torch.Tensor, dim, group) -> torch.Tensor:
    """The inverse of ``data_shard_of``: every data rank's slice,
    concatenated on ``dim`` in rank order (one all-gather over ``group``,
    contiguous); ``t`` itself when ``dim`` is None."""
    if dim is None:
        return t
    return all_gather(t.detach().contiguous(), group, dim=dim).contiguous()


def shard_of(t: torch.Tensor, dim, mesh, blocks: int = 1) -> torch.Tensor:
    """This rank's shard of one full leaf ``t``: ``t`` cut on ``dim`` — the
    leaf's ``shard_dims`` entry — into ``blocks`` equal blocks
    (``shard_blocks``), each block narrowed to the rank's
    ``model_index``-th of ``mesh.model`` equal slices, the slices
    concatenated in block order: a view of ``t`` for one block, a copy
    for more; ``t`` itself when ``dim`` is None (a replicated leaf)."""
    t = t.detach()
    if dim is None:
        return t
    n = t.shape[dim] // (blocks * mesh.model)
    if blocks == 1:
        return t.narrow(dim, mesh.model_index * n, n)
    parts = t.unflatten(dim, (blocks, mesh.model * n)).narrow(dim + 1, mesh.model_index * n, n)
    return parts.flatten(dim, dim + 1)


def gather_leaf(t: torch.Tensor, dim, group, blocks: int = 1) -> torch.Tensor:
    """The inverse of ``shard_of``: the full leaf from every model rank's
    shard ``t`` — one all-gather over ``group`` on ``dim``, then, for more
    than one block, each block's slices put back side by side in rank
    order (a copy), the reference's layout; ``t`` itself when ``dim`` is
    None."""
    if dim is None:
        return t
    full = all_gather(t.detach().contiguous(), group, dim=dim)
    if blocks == 1:
        return full
    m, n = full.shape[dim] // t.shape[dim], t.shape[dim] // blocks
    return full.unflatten(dim, (m, blocks, n)).transpose(dim, dim + 1).flatten(dim, dim + 2)


def _check_split_axes(cfg, local, dims) -> set:
    """The logical axes ``dims`` split, after checking that each is split
    in every leaf that names it or in none — except ``mlp``, which the
    reference's rule splits where an MLP's own width divides the axis
    (DeepSeek's dense MLP and shared experts can differ): it must agree
    within each MLP node, and ``layers.apply_mlp`` reads it from the
    width.  A dimension after a leaf's split one says nothing: the
    reference's rule skips a mesh axis an earlier dimension took (the
    mLSTM's ``w_if`` splits on ``d_inner``, so its ``heads`` stay whole;
    the sLSTM's ``r_gates`` on ``heads``, so its ``d_inner`` stays
    whole)."""
    rules, seen = make_rules(cfg), {}
    for path, axes, dim in zip(local.leaf_paths(), local.leaf_axes(), dims, strict=True):
        node = path.rsplit(".", 1)[0]
        for d, a in enumerate(axes):
            if dim is not None and d > dim and "model" in rules.get(a, ()):
                continue  # the model axis is taken
            seen.setdefault((node if a == "mlp" else "", a), set()).add(d == dim)
    mixed = sorted({a for (_, a), split in seen.items() if len(split) > 1})
    if mixed:
        raise ValueError(f"{cfg.name}: the model axis splits {mixed} in some leaves but not "
                         "in others")
    return {a for (_, a), split in seen.items() if True in split}


def _data_cut(cfg, mesh, over_data: bool) -> tuple:
    """``data_dims`` when ``over_data``, else no cut."""
    return data_dims(cfg, mesh) if over_data else (None,) * len(shard_dims(cfg, mesh))


@torch.no_grad()
def _cut(cfg, mesh, items, over_data: bool = False) -> GCLM:
    """The rank's module from ``items`` — ``(path, full leaf)`` in leaf
    order, consumed one at a time: each leaf's shard (or the whole leaf)
    is copied and the full leaf let go; with ``over_data``, each shard
    cut once more on its ``data_dims`` dimension (``data_shard_of``)."""
    dims, blocks = shard_dims(cfg, mesh), shard_blocks(cfg, mesh)
    ddims = _data_cut(cfg, mesh, over_data)
    local = GCLM(cfg, device="meta")
    for (path, t), dim, n, ddim in zip(items, dims, blocks, ddims, strict=True):
        _set_leaf(local, path, data_shard_of(shard_of(t, dim, mesh, n), ddim, mesh).clone(
            memory_format=torch.contiguous_format))
        del t
    if mesh.model > 1:
        local.tp = ModelSplit(mesh, frozenset(_check_split_axes(cfg, local, dims)))
        local.shard_dims, local.shard_blocks = dims, blocks
    if any(d is not None for d in ddims):
        local.fsdp = DataSplit(mesh, ddims)
    return local


def shard_model(model: GCLM, mesh) -> GCLM:
    """This rank's module on ``mesh``'s ``model`` axis: every leaf cut on
    its ``shard_dims`` dimension at the rank's ``model_index``
    (``shard_of``, block by block where the leaf fuses several outputs),
    copied; replicated leaves copied whole.  The result's ``tp`` (a
    ``dist.sharding.ModelSplit``) and ``shard_dims`` tell the layers which
    of their products to reduce over the model group.  ``mesh.model`` 1
    returns ``model`` itself."""
    if mesh.model == 1:
        return model
    return _cut(model.cfg, mesh, model.leaf_items())


@torch.no_grad()
def init_shards(cfg, mesh, *, device="cuda", seed: int = 0, params=None,
                over_data: bool = False) -> GCLM:
    """``shard_model(GCLM(cfg, device=device, seed=seed), mesh)`` (or of
    the reference tree ``params``, numpy arrays, when given) without the
    full tree on ``device``: the leaves are drawn in order from the same
    generator, each cut to the rank's shard before the next, so at most
    one full leaf lies there besides the shards.  On the meta device,
    the shards' shapes alone.  ``over_data`` (a training state) cuts each
    shard on its ``data_dims`` dimension too, and records the cut as the
    module's ``fsdp``; serving leaves it whole along ``data``."""
    if mesh.model == 1 and not any(d is not None for d in _data_cut(cfg, mesh, over_data)):
        model = GCLM(cfg, device=device, seed=seed)
        return model if params is None else params_from_numpy(model, params)
    dev = resolve_device(device)
    meta = GCLM(cfg, device="meta")
    paths = [path for path, _ in meta.leaf_items()]
    if dev.type == "meta":
        items = meta.leaf_items()
    elif params is not None:
        items = ((path, torch.from_numpy(np.array(_lookup(params, path), np.float32)).to(dev))
                 for path in paths)
    else:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        items = _drawn(cfg, paths, ((path, torch.empty(t.shape, device=dev))
                                    for path, t in meta.leaf_items()), gen)
    return _cut(cfg, mesh, items, over_data)


@torch.no_grad()
def gather_model(local: GCLM, tensors=None) -> GCLM:
    """The inverse of ``shard_model`` and ``init_shards``: a full module
    whose leaves are the data group's slices gathered (``gather_data_leaf``,
    where the module is cut over ``data``), then the model group's
    shards (``gather_leaf``): one all-gather per cut.  ``tensors`` (leaf
    order, the module's shapes: gradients, moments) gathers those in
    place of the parameters."""
    tensors = local.leaves() if tensors is None else list(tensors)
    dims = local.shard_dims or (None,) * len(tensors)
    blocks = local.shard_blocks or (1,) * len(tensors)
    ddims = local.fsdp.dims if local.fsdp is not None else (None,) * len(tensors)
    dgroup = None if local.fsdp is None else local.fsdp.data_group
    full = GCLM(local.cfg, device="meta")
    group = None if local.tp is None else local.tp.model_group
    for (path, _), t, dim, n, ddim in zip(local.leaf_items(), tensors, dims, blocks, ddims,
                                          strict=True):
        t = gather_leaf(gather_data_leaf(t.detach(), ddim, dgroup), dim, group, n)
        _set_leaf(full, path, t.clone(memory_format=torch.contiguous_format))
    return full


@torch.no_grad()
def gather_data(model: GCLM) -> GCLM:
    """The working module of a state cut over ``data``: each cut leaf
    all-gathered over the data group on its dimension (one all-gather a
    leaf, ``gather_data_leaf``), every other leaf the state's own tensor,
    the ``model`` split kept — what the forward and backward passes
    bind.  ``model`` itself when it is not cut over ``data``."""
    if model.fsdp is None:
        return model
    work = GCLM(model.cfg, device="meta")
    for (path, t), dim in zip(model.leaf_items(), model.fsdp.dims, strict=True):
        _set_leaf(work, path, gather_data_leaf(t.detach(), dim, model.fsdp.data_group))
    work.tp, work.shard_dims, work.shard_blocks = model.tp, model.shard_dims, model.shard_blocks
    return work


def _lookup(tree, path):
    for key in path:
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else tree[key]
    return tree


@torch.no_grad()
def params_from_numpy(model: GCLM, tree) -> GCLM:
    """Copy a reference parameter tree (nested dicts/lists of arrays, the
    JAX keys and shapes) into ``model``; every leaf must match."""
    for path, t in model.leaf_items():
        value = np.array(_lookup(tree, path), dtype=np.float32)  # writable copy
        if tuple(value.shape) != tuple(t.shape):
            raise ValueError(f"{'.'.join(path)}: shape {value.shape} vs "
                             f"{tuple(t.shape)}")
        t.copy_(torch.from_numpy(value))
    return model


def params_to_numpy(model: GCLM) -> dict:
    """The reference's parameter tree (nested dicts/lists of fp32 arrays)."""
    def copy(node):
        if isinstance(node, dict):
            return {k: copy(v) for k, v in node.items()}
        if isinstance(node, list):
            return [copy(v) for v in node]
        return node.detach().cpu().numpy().copy()

    return copy(model.tree())


def count_params(model: GCLM) -> int:
    return int(sum(t.numel() for t in model.leaves()))
