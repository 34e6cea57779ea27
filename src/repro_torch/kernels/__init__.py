"""Hand-written Hopper kernels of the port, with their plain versions.

* ``gc_fused`` — the fused coded combine ``y = (a ⊙ B_code) @ G``
  (CUDA C++, ``csrc/gc_fused.cu``), replacing the TPU kernel
  ``repro/kernels/gc_fused.py::encode_decode_pallas``;
* ``ref`` — the plain PyTorch version of the same math;
* ``ops`` — the dispatcher: CUDA tensors launch the kernel, CPU tensors
  take the plain version.
"""
