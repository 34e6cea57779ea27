"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
(per expert), vocab=32768, 8 experts top-2 every layer, SWA 4096.
[arXiv:2401.04088]
Copied from ``repro/configs/mixtral_8x22b.py``.

8 experts do not divide the reference's 16-way 'model' axis, so its
expert weights shard the expert-FFN dim instead (``shard_experts=False``;
no effect on one device).
"""
from .base import LayerSpec, MoESpec, ModelConfig, register

_MOE = MoESpec(num_experts=8, top_k=2, d_ff=16384, capacity_factor=1.25)


@register("mixtral-8x22b")
def mixtral_8x22b() -> ModelConfig:
    layers = tuple(
        LayerSpec(mixer="attn", window=4096, moe=_MOE) for _ in range(56)
    )
    return ModelConfig(
        name="mixtral-8x22b",
        arch_type="moe",
        source="[arXiv:2401.04088]",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab=32768,
        layers=layers,
        activation="silu",
        tie_embeddings=False,
        rope_base=1_000_000.0,
        fsdp=True,
        shard_experts=False,
        remat="full",
    )
