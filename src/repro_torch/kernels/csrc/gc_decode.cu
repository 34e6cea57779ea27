// Gradient-coding decode (decode-weighted combine) for Hopper (sm_90a):
//
//     y = a @ C      a : (N,) decode weights, fp32, rounded to C's dtype
//                    C : (N, D) coded gradients, fp32 or bf16
//                    y : (D,) in C's dtype, fp32 accumulation
//
// Replaces the TPU kernel repro/kernels/gc_decode.py::decode_pallas
// (bodies _decode_kernel and _decode_kernel_masked).  Straggler rows
// carry zero weight.  The JAX package runs it only in the kernel-level
// coded round trip (encode, strike s stragglers, decode) and in
// benchmarks/kernel_bench.py: (4, 2^20) fp32, (8, 2^22) fp32 and
// (4, 2^22) bf16.
//
// Bound: memory, (1 + N) · D · itemsize bytes; at (8, 2^22) fp32 that is
// 151 MB, 0.045 ms at 3.35 TB/s.  It is gc_pipe.cuh's grouped kernel with
// one leaf, NB = 1, K = N and the weight table w = a (no scale).

#include "gc_pipe.cuh"

namespace {

template <typename Tr>
int run(const void* scale, const void* a, int nb, int n_w, int n, int tile_cols, int stages,
        int n_leaves, const void* leaves, int64_t n_tiles, void* stream) {
  if (scale != nullptr || nb != 1 || n_w != 1) return static_cast<int>(cudaErrorInvalidValue);
  pipe::Params p;
  const int err = pipe::fill_params<Tr>(&p, nullptr, a, 1, 1, n, tile_cols, stages, n_leaves,
                                        leaves, n_tiles);
  if (err != 0) return err;
  return pipe::launch<Tr, 1>(p, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream` and returns
// cudaGetLastError().  The signature is gc_fused.cu's, with no scale, one
// row (nb = 1), one weight set (n_w = 1: the table is a) and K = N;
// `leaves` is a host array of leaf descriptors (gc_pipe.cuh's Leaf;
// kernels/_pipe.py packs them).
int gc_decode_f32(const void* scale, const void* a, int nb, int n_w, int n, int tile_cols,
                  int stages, int n_leaves, const void* leaves, int64_t n_tiles,
                  void* stream) {
  return run<F32>(scale, a, nb, n_w, n, tile_cols, stages, n_leaves, leaves, n_tiles, stream);
}

int gc_decode_bf16(const void* scale, const void* a, int nb, int n_w, int n, int tile_cols,
                   int stages, int n_leaves, const void* leaves, int64_t n_tiles,
                   void* stream) {
  return run<BF16>(scale, a, nb, n_w, n, tile_cols, stages, n_leaves, leaves, n_tiles, stream);
}

// The current device's opt-in shared memory of one block, in bytes.
int gc_decode_smem_per_block(int* bytes) { return pipe::smem_per_block(bytes); }

const char* gc_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
