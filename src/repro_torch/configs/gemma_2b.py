"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000, GeGLU, head_dim=256.  [arXiv:2403.08295]
Copied from ``repro/configs/gemma_2b.py``."""
from .base import LayerSpec, ModelConfig, register


@register("gemma-2b")
def gemma_2b() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        arch_type="dense",
        source="[arXiv:2403.08295]",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab=256_000,
        layers=tuple(LayerSpec(mixer="attn") for _ in range(18)),
        activation="gelu",  # GeGLU
        scale_embed=True,
        tie_embeddings=True,
        rope_base=10_000.0,
        remat="dots",
    )
