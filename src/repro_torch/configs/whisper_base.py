"""whisper-base [audio] — enc-dec, 6L decoder (+6L encoder) d_model=512
8H d_ff=2048 vocab=51865; mel+conv frontend STUBBED (precomputed frame
embeddings (B, 1500, d) feed the encoder).  [arXiv:2212.04356]
Copied from ``repro/configs/whisper_base.py``: RoPE in place of learned
positions; cross-attention carries a (trainable, zero-init) tanh gate
shared with the VLM's."""
from .base import EncoderSpec, LayerSpec, ModelConfig, register


@register("whisper-base")
def whisper_base() -> ModelConfig:
    layers = tuple(
        LayerSpec(mixer="attn", cross_source=True) for _ in range(6)
    )
    return ModelConfig(
        name="whisper-base",
        arch_type="audio",
        source="[arXiv:2212.04356]",
        n_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab=51865,
        layers=layers,
        encoder=EncoderSpec(n_layers=6, n_frames=1500),
        norm="layer",
        qkv_bias=True,
        activation="gelu_mlp",  # plain (ungated) GELU MLP
        tie_embeddings=True,
        rope_base=10_000.0,
        remat="none",
    )
