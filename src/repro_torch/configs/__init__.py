"""Model configs of the port (the registry holds ``gc-lm-110m``)."""
from . import gc_lm_110m  # noqa: F401  (registers)
from .base import LayerSpec, ModelConfig, get_config, list_archs, register

__all__ = ["LayerSpec", "ModelConfig", "get_config", "list_archs", "register"]
