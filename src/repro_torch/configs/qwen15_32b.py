"""qwen1.5-32b [dense] — 64L d_model=5120 40H (kv=40) d_ff=27392
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-0.5B family]
Copied from ``repro/configs/qwen15_32b.py``."""
from .base import LayerSpec, ModelConfig, register


@register("qwen1.5-32b")
def qwen15_32b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        arch_type="dense",
        source="[hf:Qwen/Qwen1.5-0.5B]",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=40,
        d_ff=27392,
        vocab=152_064,
        layers=tuple(LayerSpec(mixer="attn") for _ in range(64)),
        qkv_bias=True,
        activation="silu",
        tie_embeddings=False,
        rope_base=1_000_000.0,
        fsdp=True,
        remat="full",
    )
