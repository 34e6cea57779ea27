"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, Mamba:attn 7:1 (attn at offset 4 of each period-8 block),
MoE 16e top-2 on every other layer.  [arXiv:2403.19887]
Copied from ``repro/configs/jamba_v01_52b.py``.

``fsdp`` is kept; it has no effect on one device.
"""
from .base import LayerSpec, MambaSpec, MoESpec, ModelConfig, register

_MOE = MoESpec(num_experts=16, top_k=2, d_ff=14336, capacity_factor=1.25)


@register("jamba-v0.1-52b")
def jamba_v01_52b() -> ModelConfig:
    layers = []
    for i in range(32):
        mixer = "attn" if i % 8 == 4 else "mamba"
        moe = _MOE if i % 2 == 1 else None
        layers.append(LayerSpec(mixer=mixer, moe=moe))
    return ModelConfig(
        name="jamba-v0.1-52b",
        arch_type="hybrid",
        source="[arXiv:2403.19887]",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=65536,
        layers=tuple(layers),
        mamba=MambaSpec(d_state=16, d_conv=4, expand=2),
        activation="silu",
        tie_embeddings=False,
        rope_base=10_000.0,
        fsdp=True,
        remat="full",
    )
