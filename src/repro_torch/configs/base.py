"""Model configs: per-layer specs, ``ModelConfig``, ``reduced()`` and the
registry.

Copied from ``repro/configs/base.py`` and trimmed to what the port
runs: a layer is an attention mixer (global, or a sliding window),
DeepSeek's multi-head latent attention (``MLASpec``), Jamba's Mamba
mixer (``MambaSpec``), xLSTM's mLSTM and sLSTM mixers (``XLSTMSpec``,
layers without an FFN sublayer) or Llama-3.2-vision's gated
cross-attention over a source (``mixer="cross_attn"``) plus a dense or
mixture-of-experts FFN (``MoESpec``), with the Gemma family's softcaps,
QK-norm, sandwich norms, embedding scale and GeGLU, Qwen's QKV biases
and untied head, DeepSeek-V3's multi-token prediction (``mtp_depth``),
and Whisper's layer norm, ungated GELU MLP, audio encoder
(``EncoderSpec``) and cross-attention sublayer (``cross_source``).  The
cross-attention source comes from stubbed modality embeddings: frame
embeddings through the encoder, or patch embeddings through the
projector (``VisionSpec``).
``reduced()`` gives the reference's smoke-test shapes; ``InputShape``,
``INPUT_SHAPES`` and ``shape_supported`` are the dry run's shapes and
skips, the reference's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

__all__ = ["MoESpec", "MLASpec", "MambaSpec", "XLSTMSpec", "LayerSpec", "EncoderSpec",
           "VisionSpec", "ModelConfig", "InputShape", "INPUT_SHAPES", "register",
           "get_config", "list_archs", "shape_supported"]


@dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff: int  # per-expert hidden size
    num_shared: int = 0  # always-on shared experts (deepseek)
    capacity_factor: float = 1.25
    router: str = "softmax"  # 'softmax' | 'sigmoid' (deepseek-v3)
    aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class MLASpec:
    """DeepSeek multi-head latent attention."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MambaSpec:
    """Jamba's Mamba mixer."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMSpec:
    """xLSTM's mixers: ``kind`` 'mlstm' | 'slstm'."""

    kind: str = "mlstm"
    proj_factor: float = 2.0  # mLSTM up-projection
    conv_kernel: int = 4


@dataclass(frozen=True)
class LayerSpec:
    """One decoder layer = mixer + FFN; ``moe`` None is a dense FFN (d_ff
    from ``ModelConfig``), else an ``MoESpec``; no FFN sublayer without
    ``use_ffn`` or with ``d_ff`` 0 and no ``moe`` (xLSTM: the mixer holds
    the projections); ``cross_source`` adds a cross-attention sublayer
    after the mixer (Whisper's decoder)."""

    mixer: str = "attn"
    window: Optional[int] = None
    moe: Optional[MoESpec] = None
    use_ffn: bool = True
    cross_source: bool = False


@dataclass(frozen=True)
class EncoderSpec:
    """Whisper's encoder over stubbed frame embeddings."""

    n_layers: int = 6
    n_frames: int = 1500  # post-conv frames (30 s audio)


@dataclass(frozen=True)
class VisionSpec:
    """The vision source: stubbed patch embeddings, projected to d_model."""

    n_patches: int = 1601  # 1 tile x (224/14)^2 + cls
    d_vision: int = 7680  # pre-projector width


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str
    source: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    layers: tuple  # tuple[LayerSpec, ...], length n_layers
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    qk_norm: bool = False
    rope_base: float = 10_000.0
    rope_base_local: float = 0.0
    activation: str = "silu"
    norm: str = "rms"
    post_norm: bool = False
    tie_embeddings: bool = True
    scale_embed: bool = False
    mla: Optional[MLASpec] = None
    mamba: Optional[MambaSpec] = None
    xlstm_blocks: tuple = ()  # XLSTMSpec per mixer kind (xLSTM)
    encoder: Optional[EncoderSpec] = None
    vision: Optional[VisionSpec] = None
    mtp_depth: int = 0
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "none"  # 'none' | 'dots' | 'full'
    fsdp: bool = False  # the reference's param sharding over 'data'; no effect on one device
    # the reference's expert sharding over 'model' and its shard_map dispatch
    # (``_apply_moe_manual``, which falls back to ``_moe_core`` without a
    # mesh): kept, no effect on one device
    shard_experts: bool = True
    moe_impl: str = "gspmd"  # 'gspmd' | 'manual'
    attn_chunk: int = 1024  # KV chunk of the online-softmax attention
    attn_chunk_remat: bool = False  # recompute each chunk's scores in the backward
    attn_probs_bf16: bool = False  # round each chunk's probabilities to bf16
    scan_chunk: int = 256  # time chunk of the Mamba scan and the chunkwise mLSTM
    max_seq: int = 131_072

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if len(self.layers) != self.n_layers:
            raise ValueError(
                f"{self.name}: len(layers)={len(self.layers)} != n_layers={self.n_layers}"
            )
        if self.n_kv_heads and self.n_heads % self.n_kv_heads != 0:
            raise ValueError(f"{self.name}: n_heads % n_kv_heads != 0")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def sub_quadratic(self) -> bool:
        """True if a layer is recurrent or windowed: the dry run's
        ``long_500k`` eligibility (the reference's ``sub_quadratic``)."""
        kinds = {l.mixer for l in self.layers}
        if kinds & {"mamba", "mlstm", "slstm"}:
            return True
        windows = [l.window for l in self.layers if l.mixer in ("attn", "mla")]
        return any(w is not None for w in windows)

    def reduced(self, n_layers: int = 2, d_model: int = 256, seq_cap: int = 512) -> "ModelConfig":
        """Smoke-test variant: same family, tiny dims (the reference's
        ``reduced``)."""
        scale = d_model / self.d_model
        n_heads = max(2, min(4, self.n_heads))
        n_kv = 1 if self.n_kv_heads == 1 else max(1, min(2, self.n_kv_heads))
        while n_heads % n_kv:
            n_kv -= 1
        head_dim = max(16, d_model // n_heads)

        def shrink_layer(l: LayerSpec) -> LayerSpec:
            moe = None
            if l.moe is not None:
                moe = dataclasses.replace(
                    l.moe,
                    num_experts=min(4, l.moe.num_experts),
                    top_k=min(2, l.moe.top_k),
                    num_shared=min(1, l.moe.num_shared),
                    d_ff=max(32, int(l.moe.d_ff * scale)),
                    capacity_factor=8.0,  # no token drops -> exact decode checks
                )
            window = None if l.window is None else min(l.window, seq_cap // 2)
            return dataclasses.replace(l, moe=moe, window=window)

        layers = tuple(shrink_layer(l) for l in self.layers[:n_layers])
        kw = dict(
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=0 if self.d_ff == 0 else max(64, int(self.d_ff * scale)),
            vocab=512,
            layers=layers,
            max_seq=seq_cap * 2,
            attn_chunk=128,
            scan_chunk=64,
            remat="none",
            fsdp=False,
            dtype="float32",
            mtp_depth=min(self.mtp_depth, 1),
        )
        if self.mla is not None:
            kw["mla"] = MLASpec(
                q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=head_dim,
                qk_rope_head_dim=16, v_head_dim=head_dim,
            )
        if self.mamba is not None:
            kw["mamba"] = dataclasses.replace(self.mamba, d_state=8)
        if self.xlstm_blocks:
            kw["xlstm_blocks"] = self.xlstm_blocks[:n_layers]
        if self.encoder is not None:
            kw["encoder"] = EncoderSpec(n_layers=2, n_frames=64)
        if self.vision is not None:
            kw["vision"] = VisionSpec(n_patches=16, d_vision=64)
        return self.replace(**kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


#: the dry run's input shapes, the reference's
INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[arch_id] = fn
        return fn

    return deco


def get_config(arch_id: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)

    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)


def shape_supported(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Dry-run eligibility of (arch, shape) with the reference's skips."""
    if shape.name == "long_500k" and not cfg.sub_quadratic():
        return False, "long_500k needs sub-quadratic attention (skip, see DESIGN.md)"
    return True, ""
