"""Model configs of the port: the registry holds every config the
reference registers — ``gc-lm-110m``, the Gemma family (``gemma-2b``,
``gemma2-27b``, ``gemma3-27b``), ``qwen1.5-32b``, ``mixtral-8x22b``,
``deepseek-v3-671b``, ``jamba-v0.1-52b``, ``xlstm-1.3b``,
``whisper-base`` and ``llama-3.2-vision-11b``."""
from . import (deepseek_v3_671b, gc_lm_110m, gemma2_27b,  # noqa: F401  (registers)
               gemma3_27b, gemma_2b, jamba_v01_52b, llama32_vision_11b, mixtral_8x22b,
               qwen15_32b, whisper_base, xlstm_1p3b)
from .base import (INPUT_SHAPES, EncoderSpec, InputShape, LayerSpec, MambaSpec, MLASpec,
                   ModelConfig, MoESpec, VisionSpec, XLSTMSpec, get_config, list_archs,
                   register, shape_supported)

__all__ = ["INPUT_SHAPES", "EncoderSpec", "InputShape", "LayerSpec", "MambaSpec", "MLASpec",
           "ModelConfig", "MoESpec", "VisionSpec", "XLSTMSpec", "get_config", "list_archs",
           "register", "shape_supported"]
