"""Model configs of the port (the registry holds ``gc-lm-110m`` and the
Gemma family: ``gemma-2b``, ``gemma2-27b``, ``gemma3-27b``)."""
from . import gc_lm_110m, gemma2_27b, gemma3_27b, gemma_2b  # noqa: F401  (registers)
from .base import LayerSpec, ModelConfig, get_config, list_archs, register

__all__ = ["LayerSpec", "ModelConfig", "get_config", "list_archs", "register"]
