"""gemma2-27b [dense] — 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000, alternating local(4096)/global, attn softcap 50 / final
softcap 30, sandwich norms.  [arXiv:2408.00118]
Copied from ``repro/configs/gemma2_27b.py``."""
from .base import LayerSpec, ModelConfig, register


@register("gemma2-27b")
def gemma2_27b() -> ModelConfig:
    # even layers local (sliding window 4096), odd layers global
    layers = tuple(
        LayerSpec(mixer="attn", window=4096 if i % 2 == 0 else None)
        for i in range(46)
    )
    return ModelConfig(
        name="gemma2-27b",
        arch_type="dense",
        source="[arXiv:2408.00118]",
        n_layers=46,
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=36864,
        vocab=256_000,
        layers=layers,
        attn_softcap=50.0,
        final_softcap=30.0,
        post_norm=True,
        scale_embed=True,
        activation="gelu",
        tie_embeddings=True,
        rope_base=10_000.0,
        fsdp=True,
        remat="full",
    )
