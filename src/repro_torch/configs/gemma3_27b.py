"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144, 5:1 local(1024):global interleave, QK-norm, 128k ctx.
[hf:google/gemma-3-1b-pt family]
Copied from ``repro/configs/gemma3_27b.py``."""
from .base import LayerSpec, ModelConfig, register

_WINDOW = 1024


@register("gemma3-27b")
def gemma3_27b() -> ModelConfig:
    # pattern: 5 local then 1 global; layer i is global iff i % 6 == 5
    layers = tuple(
        LayerSpec(mixer="attn", window=None if i % 6 == 5 else _WINDOW)
        for i in range(62)
    )
    return ModelConfig(
        name="gemma3-27b",
        arch_type="dense",
        source="[hf:google/gemma-3-1b-pt]",
        n_layers=62,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab=262_144,
        layers=layers,
        qk_norm=True,
        post_norm=True,
        scale_embed=True,
        activation="gelu",
        tie_embeddings=True,
        rope_base=1_000_000.0,
        rope_base_local=10_000.0,
        max_seq=131_072,
        fsdp=True,
        remat="full",
    )
