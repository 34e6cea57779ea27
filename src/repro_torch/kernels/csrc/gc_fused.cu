// Fused gradient-coding combine for Hopper (sm_90a):
//
//     y = (a ⊙ B_code) @ G      a : (NB,)  decode weights, fp32
//                               B : (NB, K) coding rows, fp32
//                               G : (K, D)  per-shard gradients, fp32 or bf16
//                               y : (NB, D) in G's dtype, fp32 accumulation
//
// Replaces the TPU kernel repro/kernels/gc_fused.py::encode_decode_pallas.
// On the training main path NB = 1 and K = N·K' = 16 (N = 4 workers,
// K' = s_max + 1 = 4 shards each); D is a leaf size, up to 28.3M.
//
// Bound: memory (gc_stream.cuh).  At K = 16 fp32 the kernel must move
// 17 · 4 = 68 bytes per column, 1.93 GB for the largest leaf, 0.58 ms at
// 3.35 TB/s.  The streaming loop, its loads and its ragged-tail paths
// are gc_stream.cuh's.
//
// Fold order follows repro/kernels/ref.py (see repro_torch/kernels/ref.py):
// w = a ⊙ B is folded in fp32 and rounded to G's dtype before the products.

#include "gc_stream.cuh"

namespace {

struct FusedFold {
  __device__ __forceinline__ static float weight(const float* a, const float* b,
                                                 int r, int kk, int k) {
    return a[r] * b[r * k + kk];
  }
};

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream` and returns cudaGetLastError().
int gc_fused_f32(const void* a, const void* b, const void* g, void* out,
                 int nb, int k, int64_t d, void* stream) {
  return launch_rows<F32, FusedFold>(a, b, g, out, nb, k, d, stream);
}

int gc_fused_bf16(const void* a, const void* b, const void* g, void* out,
                  int nb, int k, int64_t d, void* stream) {
  return launch_rows<BF16, FusedFold>(a, b, g, out, nb, k, d, stream);
}

const char* gc_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
