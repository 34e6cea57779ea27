"""PyTorch/CUDA port of the block coordinate gradient coding system.

A second package beside ``repro`` (the JAX reference).  It imports
``torch``, ``numpy`` and ``scipy`` only — never ``jax`` and never any
module of ``repro``; the numpy plan layer it needs is copied into
``repro_torch.core``.

The slice implemented so far is the main path: barrier coded training
of ``gc-lm-110m`` in sim mode (``repro_torch.train.trainer.Trainer``),
whose fused coded combine runs through the hand-written CUDA kernel
``repro_torch.kernels.gc_fused``.  Entry points default to
``device="cuda"`` and raise when CUDA is absent; tests pass
``device="cpu"`` explicitly.
"""
