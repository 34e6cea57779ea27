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
// Bound: this is a skinny matvec, about one multiply-add per element of
// G, so it is bound by memory: it must read G once and write y once,
// (NB + K) · D · itemsize bytes (plus NB·K + NB coefficients).  At K = 16
// fp32 that is 17 · 4 = 68 bytes per column, 1.93 GB for the largest
// leaf, 0.58 ms at 3.35 TB/s.
//
// What the design does about that bound:
//   * the folded weights w = a ⊙ B (NB·K floats) are computed once per
//     block and kept in shared memory, so G is the only stream;
//   * each thread owns a group of consecutive columns and walks the K
//     rows of G with 16-byte streaming loads (4 fp32 or 8 bf16 per load,
//     evict-first, since G is read exactly once), accumulating all NB
//     outputs in fp32 registers — G is never re-read, y written once;
//   * the TPU's sequential grid over D becomes independent blocks with a
//     grid-stride loop; nothing is carried between blocks;
//   * the ragged tail needs no mask: the 16-byte path runs only when D is
//     a multiple of the vector width and both pointers are 16-byte
//     aligned, otherwise every thread takes one column per step.
// Tensor cores, TMA and a persistent schedule are later work.
//
// Fold order follows repro/kernels/ref.py (see repro_torch/kernels/ref.py):
// w is folded in fp32 and rounded to G's dtype before the products.

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

template <typename Tr, int NB, int V>
__global__ void __launch_bounds__(kThreads)
gc_fused_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const typename Tr::Storage* __restrict__ g,
                typename Tr::Storage* __restrict__ out, int k, int64_t d) {
  extern __shared__ float w_s[];  // (NB, k) folded weights, G's precision
  for (int i = threadIdx.x; i < NB * k; i += blockDim.x) {
    w_s[i] = Tr::round(a[i / k] * b[i]);
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

template <typename Tr, int NB, int V>
void launch(const float* a, const float* b, const void* g, void* out, int k,
            int64_t d, cudaStream_t stream) {
  const int64_t groups = d / V;
  int64_t blocks = (groups + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * kBlocksPerSM;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const size_t smem = sizeof(float) * NB * static_cast<size_t>(k);
  gc_fused_kernel<Tr, NB, V><<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      a, b, static_cast<const typename Tr::Storage*>(g),
      static_cast<typename Tr::Storage*>(out), k, d);
}

template <typename Tr, int NB>
void launch_nb(const float* a, const float* b, const void* g, void* out, int k,
               int64_t d, cudaStream_t stream) {
  const bool vec = (d % Tr::kVec == 0) &&
                   (reinterpret_cast<uintptr_t>(g) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (vec) {
    launch<Tr, NB, Tr::kVec>(a, b, g, out, k, d, stream);
  } else {
    launch<Tr, NB, 1>(a, b, g, out, k, d, stream);
  }
}

template <typename Tr>
int gc_fused(const void* a, const void* b, const void* g, void* out, int nb,
             int k, int64_t d, void* stream_ptr) {
  if (nb < 1 || nb > kMaxNB || k < 1 || d < 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (nb) {
    case 1: launch_nb<Tr, 1>(af, bf, g, out, k, d, stream); break;
    case 2: launch_nb<Tr, 2>(af, bf, g, out, k, d, stream); break;
    case 3: launch_nb<Tr, 3>(af, bf, g, out, k, d, stream); break;
    case 4: launch_nb<Tr, 4>(af, bf, g, out, k, d, stream); break;
    case 5: launch_nb<Tr, 5>(af, bf, g, out, k, d, stream); break;
    case 6: launch_nb<Tr, 6>(af, bf, g, out, k, d, stream); break;
    case 7: launch_nb<Tr, 7>(af, bf, g, out, k, d, stream); break;
    default: launch_nb<Tr, 8>(af, bf, g, out, k, d, stream); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream` and returns cudaGetLastError().
int gc_fused_f32(const void* a, const void* b, const void* g, void* out,
                 int nb, int k, int64_t d, void* stream) {
  return gc_fused<F32>(a, b, g, out, nb, k, d, stream);
}

int gc_fused_bf16(const void* a, const void* b, const void* g, void* out,
                  int nb, int k, int64_t d, void* stream) {
  return gc_fused<BF16>(a, b, g, out, nb, k, d, stream);
}

const char* gc_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
