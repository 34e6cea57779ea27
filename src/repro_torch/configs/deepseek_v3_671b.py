"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff=2048(expert)
vocab=129280, MLA, 1 shared + 256 routed top-8, MTP.  [arXiv:2412.19437]
Copied from ``repro/configs/deepseek_v3_671b.py``.

First 3 layers dense (d_ff 18432) per the V3 report; router is sigmoid
with top-8 over 256 routed experts + 1 shared expert; MLA with
q_lora 1536 / kv_lora 512 / nope 128 / rope 64 / v 128.
"""
from .base import LayerSpec, MLASpec, MoESpec, ModelConfig, register

_MOE = MoESpec(num_experts=256, top_k=8, d_ff=2048, num_shared=1,
               router="sigmoid", capacity_factor=1.25)


@register("deepseek-v3-671b")
def deepseek_v3_671b() -> ModelConfig:
    layers = tuple(
        LayerSpec(mixer="mla", moe=None if i < 3 else _MOE)
        for i in range(61)
    )
    return ModelConfig(
        name="deepseek-v3-671b",
        arch_type="moe",
        source="[arXiv:2412.19437]",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=18432,  # dense layers 0-2; experts use MoESpec.d_ff=2048
        vocab=129_280,
        layers=layers,
        mla=MLASpec(q_lora_rank=1536, kv_lora_rank=512,
                    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
        mtp_depth=1,
        activation="silu",
        tie_embeddings=False,
        rope_base=10_000.0,
        fsdp=True,
        remat="full",
    )
