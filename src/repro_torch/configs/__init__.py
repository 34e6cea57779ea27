"""Model configs of the port (the registry holds ``gc-lm-110m``, the
Gemma family — ``gemma-2b``, ``gemma2-27b``, ``gemma3-27b`` — and
``qwen1.5-32b`` and ``mixtral-8x22b``)."""
from . import (gc_lm_110m, gemma2_27b, gemma3_27b, gemma_2b,  # noqa: F401  (registers)
               mixtral_8x22b, qwen15_32b)
from .base import LayerSpec, ModelConfig, MoESpec, get_config, list_archs, register

__all__ = ["LayerSpec", "ModelConfig", "MoESpec", "get_config", "list_archs", "register"]
