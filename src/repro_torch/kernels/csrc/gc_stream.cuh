// Streaming coded-row products for Hopper (sm_90a), shared by the port's
// three gradient-coding kernels (gc_fused.cu, gc_encode.cu, gc_decode.cu):
//
//     out[r, :] = sum_kk w[r, kk] · G[kk, :]     r < NB, kk < K
//                 G : (K, D) fp32 or bf16, out : (NB, D) in G's dtype
//
// Each kernel forms its own (NB, K) weights w from its arguments (its
// Fold policy: a ⊙ B, B, or a) and rounds them to G's precision, as the
// reference's oracles do; the products are accumulated in fp32 with
// fmaf, and the output is rounded once.  No tensor cores and no TF32:
// with integer-valued operands whose partial sums stay below 2^24 (the
// coded checkpoint's parity digits) every step is exact, in any order.
//
// Bound: about one multiply-add per element of G, so the product is
// bound by memory: it must read G once and write out once,
// (NB + K) · D · itemsize bytes (plus the NB·K coefficients).
//
// What the design does about that bound:
//   * w (NB·K floats) is computed once per block and kept in shared
//     memory, so G is the only stream;
//   * each thread owns a group of consecutive columns and walks the K
//     rows of G with 16-byte streaming loads (4 fp32 or 8 bf16 per load,
//     evict-first, since G is read exactly once), accumulating all NB
//     outputs in fp32 registers — G is never re-read, out written once;
//   * the TPU's sequential grid over D becomes independent blocks with a
//     grid-stride loop; nothing is carried between blocks;
//   * the ragged tail needs no mask: the 16-byte path runs only when D is
//     a multiple of the vector width and both pointers are 16-byte
//     aligned, otherwise every thread takes one column per step;
//   * every offset is 64-bit: G reaches 3 × 2.76e8 fp32 (3.3 GB) on the
//     checkpoint path, past int32.
// Tensor cores, TMA and a persistent schedule are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNB = 8;
constexpr int kBlocksPerSM = 16;

struct F32 {
  using Storage = float;
  static constexpr int kVec = 4;

  __device__ __forceinline__ static float round(float x) { return x; }

  __device__ __forceinline__ static void load(const float* p, float (&v)[1]) {
    v[0] = __ldcs(p);
  }
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[1]) {
    p[0] = v[0];
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

struct BF16 {
  // bf16 values are handled as their 16-bit patterns: the high half of an
  // fp32 word, so widening is a shift and narrowing rounds to nearest even.
  using Storage = unsigned short;
  static constexpr int kVec = 8;

  __device__ __forceinline__ static unsigned int bits(float x) {
    return static_cast<unsigned int>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
  }
  __device__ __forceinline__ static float widen(unsigned int b16) {
    return __uint_as_float(b16 << 16);
  }
  __device__ __forceinline__ static float round(float x) { return widen(bits(x)); }

  __device__ __forceinline__ static void load(const unsigned short* p, float (&v)[1]) {
    v[0] = widen(static_cast<unsigned int>(p[0]));
  }
  __device__ __forceinline__ static void load(const unsigned short* p, float (&v)[8]) {
    const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
    const unsigned int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);            // element 2i: low half
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);  // element 2i+1: high half
    }
  }
  __device__ __forceinline__ static void store(unsigned short* p, const float (&v)[1]) {
    p[0] = static_cast<unsigned short>(bits(v[0]));
  }
  __device__ __forceinline__ static void store(unsigned short* p, const float (&v)[8]) {
    uint4 q;
    q.x = bits(v[0]) | (bits(v[1]) << 16);
    q.y = bits(v[2]) | (bits(v[3]) << 16);
    q.z = bits(v[4]) | (bits(v[5]) << 16);
    q.w = bits(v[6]) | (bits(v[7]) << 16);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

// Fold: static float weight(a, b, r, kk, k) -> the unrounded w[r, kk].
template <typename Tr, typename Fold, int NB, int V>
__global__ void __launch_bounds__(kThreads)
coded_rows_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const typename Tr::Storage* __restrict__ g,
                  typename Tr::Storage* __restrict__ out, int k, int64_t d) {
  extern __shared__ float w_s[];  // (NB, k) weights, G's precision
  for (int i = threadIdx.x; i < NB * k; i += blockDim.x) {
    w_s[i] = Tr::round(Fold::weight(a, b, i / k, i % k, k));
  }
  __syncthreads();

  const int64_t n_groups = d / V;  // V > 1 only when V divides d
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t grp = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       grp < n_groups; grp += stride) {
    const int64_t col = grp * V;
    float acc[NB][V];
#pragma unroll
    for (int r = 0; r < NB; ++r) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[r][v] = 0.0f;
    }
#pragma unroll 4
    for (int kk = 0; kk < k; ++kk) {
      float gv[V];
      Tr::load(g + kk * d + col, gv);
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        const float w = w_s[r * k + kk];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[r][v] = fmaf(w, gv[v], acc[r][v]);
      }
    }
#pragma unroll
    for (int r = 0; r < NB; ++r) Tr::store(out + r * d + col, acc[r]);
  }
}

int sm_count() {
  int dev = 0;
  int n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      n < 1) {
    n = 1;
  }
  return n;
}

template <typename Tr, typename Fold, int NB, int V>
void launch(const float* a, const float* b, const void* g, void* out, int k,
            int64_t d, cudaStream_t stream) {
  const int64_t groups = d / V;
  int64_t blocks = (groups + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * kBlocksPerSM;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const size_t smem = sizeof(float) * NB * static_cast<size_t>(k);
  coded_rows_kernel<Tr, Fold, NB, V>
      <<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
          a, b, static_cast<const typename Tr::Storage*>(g),
          static_cast<typename Tr::Storage*>(out), k, d);
}

// One launch for NB rows: the 16-byte path when D and both pointers allow.
template <typename Tr, typename Fold, int NB>
int launch_nb(const void* a, const void* b, const void* g, void* out, int k,
              int64_t d, void* stream_ptr) {
  if (k < 1 || d < 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool vec = (d % Tr::kVec == 0) &&
                   (reinterpret_cast<uintptr_t>(g) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (vec) {
    launch<Tr, Fold, NB, Tr::kVec>(af, bf, g, out, k, d, stream);
  } else {
    launch<Tr, Fold, NB, 1>(af, bf, g, out, k, d, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch for 1 <= nb <= kMaxNB rows (NB is a template parameter, so
// the NB accumulators stay in registers).
template <typename Tr, typename Fold>
int launch_rows(const void* a, const void* b, const void* g, void* out, int nb,
                int k, int64_t d, void* stream) {
  switch (nb) {
    case 1: return launch_nb<Tr, Fold, 1>(a, b, g, out, k, d, stream);
    case 2: return launch_nb<Tr, Fold, 2>(a, b, g, out, k, d, stream);
    case 3: return launch_nb<Tr, Fold, 3>(a, b, g, out, k, d, stream);
    case 4: return launch_nb<Tr, Fold, 4>(a, b, g, out, k, d, stream);
    case 5: return launch_nb<Tr, Fold, 5>(a, b, g, out, k, d, stream);
    case 6: return launch_nb<Tr, Fold, 6>(a, b, g, out, k, d, stream);
    case 7: return launch_nb<Tr, Fold, 7>(a, b, g, out, k, d, stream);
    case 8: return launch_nb<Tr, Fold, 8>(a, b, g, out, k, d, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
