"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=128256, gated cross-attn image layers every 5th
(indices 3,8,...,38); ViT frontend STUBBED (precomputed patch embeds).
[hf:meta-llama/Llama-3.2-11B-Vision]
Copied from ``repro/configs/llama32_vision_11b.py``."""
from .base import LayerSpec, ModelConfig, VisionSpec, register

_CROSS_IDX = {3, 8, 13, 18, 23, 28, 33, 38}


@register("llama-3.2-vision-11b")
def llama32_vision_11b() -> ModelConfig:
    layers = tuple(
        LayerSpec(mixer="cross_attn" if i in _CROSS_IDX else "attn")
        for i in range(40)
    )
    return ModelConfig(
        name="llama-3.2-vision-11b",
        arch_type="vlm",
        source="[hf:meta-llama/Llama-3.2-11B-Vision]",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=128_256,
        layers=layers,
        vision=VisionSpec(n_patches=1601, d_vision=7680),
        activation="silu",
        tie_embeddings=False,
        rope_base=500_000.0,
        fsdp=True,
        remat="dots",
    )
