// Gradient-coding encode for Hopper (sm_90a):
//
//     C = B_code @ G      B : (NB, K) coding rows, fp32, rounded to G's dtype
//                         G : (K, D) fp32 or bf16
//                         C : (NB, D) in G's dtype, fp32 accumulation
//
// Replaces the TPU kernel repro/kernels/gc_encode.py::encode_pallas
// (bodies _encode_kernel and _encode_kernel_masked).  Its caller on the
// port's path is the erasure-coded checkpoint
// (repro_torch/checkpoint/coded.py::_encode_digits): with
// CodedSpec(n_shards=4, parity=1) at gc-lm-110m's full width, NB = 1 and
// K = 3 on save (the parity stripe) and K = 2 on a restore after one lost
// data stripe, over D = 275,682,880 integer-valued fp32 digits.
//
// Exactness: every digit is an integer below 2^16 and every parity
// partial sum below 2^24, so the fp32 fmaf chain of gc_stream.cuh is
// exact in any order and C equals the reference's bit for bit.  No TF32,
// no tensor cores.
//
// Bound: memory, (NB + K) · D · 4 bytes; at NB = 1, K = 3 and
// D = 2.76e8 that is 4.4 GB, 1.32 ms at 3.35 TB/s.  One launch computes
// at most 8 rows; the wrapper (gc_encode.py) cuts a larger NB into blocks
// of 8 rows, one launch and one pass over G each.

#include "gc_stream.cuh"

namespace {

struct EncodeFold {
  __device__ __forceinline__ static float weight(const float*, const float* b,
                                                 int r, int kk, int k) {
    return b[r * k + kk];
  }
};

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream` and returns cudaGetLastError().
int gc_encode_f32(const void* b, const void* g, void* out, int nb, int k,
                  int64_t d, void* stream) {
  return launch_rows<F32, EncodeFold>(nullptr, b, g, out, nb, k, d, stream);
}

int gc_encode_bf16(const void* b, const void* g, void* out, int nb, int k,
                   int64_t d, void* stream) {
  return launch_rows<BF16, EncodeFold>(nullptr, b, g, out, nb, k, d, stream);
}

const char* gc_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
