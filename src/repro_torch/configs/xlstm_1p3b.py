"""xlstm-1.3b [ssm] — 48 blocks d_model=2048 4H, mLSTM:sLSTM 7:1
(sLSTM at offset 7 of each period-8 block), d_ff=0 (blocks own their
projections).  [arXiv:2405.04517]
Copied from ``repro/configs/xlstm_1p3b.py``."""
from .base import LayerSpec, ModelConfig, XLSTMSpec, register


@register("xlstm-1.3b")
def xlstm_1p3b() -> ModelConfig:
    layers = tuple(
        LayerSpec(mixer="slstm" if i % 8 == 7 else "mlstm", use_ffn=False)
        for i in range(48)
    )
    return ModelConfig(
        name="xlstm-1.3b",
        arch_type="ssm",
        source="[arXiv:2405.04517]",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        layers=layers,
        xlstm_blocks=(XLSTMSpec(kind="mlstm", proj_factor=2.0, conv_kernel=4),
                      XLSTMSpec(kind="slstm", proj_factor=4.0 / 3.0, conv_kernel=4)),
        activation="gelu",
        tie_embeddings=True,
        rope_base=0.0,  # recurrent blocks: no rotary
        remat="dots",
    )
