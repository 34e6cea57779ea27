"""gc-lm-110m — the paper's own end-to-end demonstrator: a ~110M-param
dense LM trained with block coordinate gradient coding on simulated
straggler workers.  Copied from ``repro/configs/gc_lm_110m.py``."""
from .base import LayerSpec, ModelConfig, register


@register("gc-lm-110m")
def gc_lm_110m() -> ModelConfig:
    return ModelConfig(
        name="gc-lm-110m",
        arch_type="dense",
        source="[this paper, §VI scaled to an LM]",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab=32_000,
        layers=tuple(LayerSpec(mixer="attn") for _ in range(12)),
        activation="silu",
        tie_embeddings=True,
        rope_base=10_000.0,
        dtype="float32",
        remat="none",
    )
