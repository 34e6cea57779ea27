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
// 151 MB, 0.045 ms at 3.35 TB/s.  It is gc_stream.cuh's streaming
// product with one output row, NB = 1 and K = N.

#include "gc_stream.cuh"

namespace {

struct DecodeFold {
  __device__ __forceinline__ static float weight(const float* a, const float*,
                                                 int, int kk, int) {
    return a[kk];
  }
};

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream` and returns cudaGetLastError().
int gc_decode_f32(const void* a, const void* c, void* out, int n, int64_t d,
                  void* stream) {
  return launch_nb<F32, DecodeFold, 1>(a, nullptr, c, out, n, d, stream);
}

int gc_decode_bf16(const void* a, const void* c, void* out, int n, int64_t d,
                   void* stream) {
  return launch_nb<BF16, DecodeFold, 1>(a, nullptr, c, out, n, d, stream);
}

const char* gc_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
