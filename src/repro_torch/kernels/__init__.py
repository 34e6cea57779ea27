"""Hand-written Hopper kernels of the port, with their plain versions.

* ``gc_fused`` — the fused coded combine ``y = (a ⊙ B_code) @ G``
  (``csrc/gc_fused.cu``), replacing ``repro/kernels/gc_fused.py::
  encode_decode_pallas``; on the training path, all of a step's leaves
  in one launch (``encode_decode_leaves``);
* ``gc_encode`` — the encode ``C = B_code @ G`` (``csrc/gc_encode.cu``),
  replacing ``repro/kernels/gc_encode.py::encode_pallas``; on the
  erasure-coded checkpoint path (parity on save, survivors on restore);
* ``gc_decode`` — the decode ``y = a @ C`` (``csrc/gc_decode.cu``),
  replacing ``repro/kernels/gc_decode.py::decode_pallas``; the
  kernel-level coded round trip;
* ``ref`` — the plain PyTorch version of each;
* ``ops`` — the dispatcher: CUDA tensors launch the kernel, CPU tensors
  take the plain version.

``gc_fused`` and ``gc_decode`` run the persistent, TMA-pipelined, grouped
kernel of ``csrc/gc_pipe.cuh`` (launches planned by ``_pipe``: one launch
covers up to 32 leaves); ``gc_encode`` runs the per-leaf streaming loop
of ``csrc/gc_stream.cuh``.  All are built by ``_build`` (``nvcc``, one
process per source).
"""
