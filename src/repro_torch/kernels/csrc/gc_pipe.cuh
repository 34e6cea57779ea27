// Persistent, TMA-pipelined, grouped coded-row products for Hopper
// (sm_90a), shared by gc_fused.cu and gc_decode.cu.  For every leaf j of
// one launch:
//
//     out_j[r, :] = sum_kk w[widx_j, r, kk] · G_j[kk, :]     r < NB, kk < K
//                   G_j : (K, D_j) fp32 or bf16, out_j : (NB, D_j) in G's dtype
//
// All leaves of a launch share one dtype, one NB and one K.  The weights
// are a small fp32 table of weight sets, (n_w, NB, K), optionally scaled
// per row: w[i, r, kk] = scale[r] · table[i, r, kk] (the fused combine's
// a ⊙ B) or table[i, r, kk] (the decode's a).  Each CTA folds the table
// once into shared memory and rounds it to G's dtype, as the reference's
// oracles do.
//
// Bound: memory.  One multiply-add per element of G, and every leaf must
// read G once and write out once: (NB + K) · D · itemsize bytes.  fp32
// without TF32 has no tensor-core path on Hopper, and NB <= 8 rows is a
// matrix-vector product that stays below the card's ~20 operations per
// byte of fp32 FMA, so there are no tensor cores here and TF32 stays off
// (repro_torch/device.py).
//
// What the design does about that bound:
//   * a persistent grid: min(tiles, SMs · CTAs per SM) CTAs, each walking
//     a global tile index over the concatenated columns of every leaf of
//     the launch (round robin, so the whole grid streams neighbouring
//     columns of each row at once); a tile's leaf comes from per-leaf tile
//     prefix sums.  One launch covers up to kMaxLeaves leaves: the
//     training step's 11 leaves are one launch, and no leaf pays a launch
//     or a grid tail of its own;
//   * the leaf descriptors travel as a __grid_constant__ kernel parameter
//     (under 4 KB): no host-to-device copy per call;
//   * a ring of S shared-memory stages filled by TMA bulk copies: one
//     elected producer thread issues the K row segments of a tile
//     (cp.async.bulk) against
//     the stage's "full" mbarrier with expect_tx = K · T · itemsize; eight
//     consumer warps wait on it, read their 16-byte column group of every
//     row from shared memory, run the fp32 fmaf chain, and arrive on the
//     stage's "empty" mbarrier, which the producer waits on before it
//     refills the stage.  A ring is at most 96 KB, so two CTAs share an
//     SM: with K = 16 fp32 it is S = 3 stages of T = 512 columns (32 KB),
//     and up to four stages (128 KB per SM) are in flight while the
//     consumers read the others;
//   * the output is NB/(K + NB) of the traffic: written once from
//     registers with 16-byte stores, no TMA store;
//   * an operand larger than L2 (G, or the output) streams evict-first in
//     L2, since it is touched once; one that fits keeps the normal policy,
//     for its producer's or its consumer's sake;
//   * summation order kept: per column the fmaf chain runs over
//     kk = 0..K-1 in order from 0, exactly as gc_stream.cuh's loop does,
//     so in fp32 and in bf16 the result is bit-equal to that loop's;
//   * leaves that TMA cannot take (D · itemsize not a multiple of 16, or
//     a pointer not 16-byte aligned) are walked by the consumer warps in
//     the same launch, one column per thread with plain loads;
//   * any K: when two stages of the narrowest tile (32 columns of 16
//     bytes per row) do not fit the ring beside the weight table, the
//     launch has no ring (stages = 0) and the consumer warps load each
//     16-byte column group straight from global memory, as
//     gc_stream.cuh's loop does.  The weight table alone is bounded by
//     the card's opt-in shared memory of one block;
//   * 64-bit offsets: one leaf's G reaches 16 × 28.3M × 4 B = 1.8 GB;
//   * the consumers fold the weight table while the producer's first
//     tiles are in flight;
//   * the device facts (SM count, opt-in shared memory, L2 size), the
//     shared-memory opt-in and the occupancy of each instantiation are
//     cached in statics.
#pragma once

#include <string.h>

#include "gc_stream.cuh"  // the F32 / BF16 element traits

namespace pipe {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kMaxLeaves = 32;
constexpr int kMaxStages = 8;
constexpr int kMaxDevices = 64;
constexpr size_t kBarrierBytes = 2 * kMaxStages * sizeof(uint64_t);

// How the consumers reach a leaf's G (kernels/_pipe.py's leaf modes).
enum Mode : int32_t {
  kPerColumn = 0,  // rows not of whole 16-byte groups: one column per thread
  kRing = 1,       // TMA bulk copies into the shared-memory ring
  kDirect = 2,     // 16-byte groups loaded from global memory (no ring)
};

// One leaf of a launch; the layout is kernels/_pipe.py's LEAF struct.
struct Leaf {
  const void* g;    // (K, d) row-major
  void* out;        // (NB, d) row-major
  int64_t d;        // columns
  int64_t tile0;    // first global tile of this leaf
  int32_t widx;     // weight set
  int32_t mode;     // Mode
};
static_assert(sizeof(Leaf) == 40, "Leaf must match kernels/_pipe.py");

struct Params {
  const float* scale;  // (NB,) or null
  const float* table;  // (n_w, NB, K)
  int32_t n_w, k, tile_cols, stages, n_leaves;
  int16_t stream_g;    // G's loads marked evict-first in L2
  int16_t stream_out;  // the output written with evict-first stores
  int64_t n_tiles;
  Leaf leaves[kMaxLeaves];
};
static_assert(sizeof(Params) <= 4096, "kernel parameters must stay under 4 KB");

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// TMA bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`; with
// `hint`, under the L2 cache policy `policy`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, bool hint, uint64_t policy) {
  if (hint) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
        " [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  }
}

// ------------------------------------------------- element access by dtype
__device__ __forceinline__ void load_shared(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load_shared(const unsigned short* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 16-byte stores, evict-first in L2 (st.global.cs) when `streaming`.
__device__ __forceinline__ void store16(float* p, const float (&v)[4], bool streaming) {
  const float4 q = make_float4(v[0], v[1], v[2], v[3]);
  if (streaming) {
    __stcs(reinterpret_cast<float4*>(p), q);
  } else {
    *reinterpret_cast<float4*>(p) = q;
  }
}

__device__ __forceinline__ void store16(unsigned short* p, const float (&v)[8], bool streaming) {
  uint4 q;
  q.x = BF16::bits(v[0]) | (BF16::bits(v[1]) << 16);
  q.y = BF16::bits(v[2]) | (BF16::bits(v[3]) << 16);
  q.z = BF16::bits(v[4]) | (BF16::bits(v[5]) << 16);
  q.w = BF16::bits(v[6]) | (BF16::bits(v[7]) << 16);
  if (streaming) {
    __stcs(reinterpret_cast<uint4*>(p), q);
  } else {
    *reinterpret_cast<uint4*>(p) = q;
  }
}

// ------------------------------------------------------------------ kernel
// Walks this CTA's tiles (blockIdx.x, + gridDim.x, ...) and calls
// fn(leaf, first column, columns) for each; `j` is a cursor over the
// leaves, which only moves forward.
template <typename Fn>
__device__ __forceinline__ void for_each_tile(const Params& p, Fn fn) {
  int j = 0;
  for (int64_t t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
    while (j + 1 < p.n_leaves && t >= p.leaves[j + 1].tile0) ++j;
    const Leaf& leaf = p.leaves[j];
    const int64_t c0 = (t - leaf.tile0) * p.tile_cols;
    const int64_t left = leaf.d - c0;
    fn(leaf, c0, static_cast<int>(left < p.tile_cols ? left : p.tile_cols));
  }
}

// One tile of a leaf outside the ring: each consumer thread takes V
// consecutive columns per step (V = 1 for rows not of whole 16-byte
// groups) straight from global memory with evict-first loads, and runs
// the same in-order fmaf chain as the ring's consumers.
template <typename Tr, int NB, int V>
__device__ __forceinline__ void direct_tile(const Leaf& leaf, const float* w, int k,
                                            int64_t c0, int cols) {
  using S = typename Tr::Storage;
  const S* g = static_cast<const S*>(leaf.g) + c0;
  S* out = static_cast<S*>(leaf.out) + c0;
  for (int col = threadIdx.x * V; col < cols; col += kConsumers * V) {
    float acc[NB][V];
#pragma unroll
    for (int r = 0; r < NB; ++r) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[r][v] = 0.0f;
    }
#pragma unroll 4
    for (int kk = 0; kk < k; ++kk) {
      float gv[V];
      Tr::load(g + kk * leaf.d + col, gv);
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        const float wr = w[r * k + kk];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[r][v] = fmaf(wr, gv[v], acc[r][v]);
      }
    }
#pragma unroll
    for (int r = 0; r < NB; ++r) Tr::store(out + r * leaf.d + col, acc[r]);
  }
}

template <typename Tr, int NB>
__global__ void __launch_bounds__(kThreads, 1) pipe_kernel(const __grid_constant__ Params p) {
  using S = typename Tr::Storage;
  constexpr int V = Tr::kVec;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* w_s = reinterpret_cast<float*>(smem + kBarrierBytes);
  const int k = p.k;
  const int n_weights = p.n_w * NB * k;
  S* ring = reinterpret_cast<S*>(
      smem + ((kBarrierBytes + sizeof(float) * n_weights + 127) / 128) * 128);
  const int stage_elems = k * p.tile_cols;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  int stage = 0;
  uint32_t phase = 0;
  if (threadIdx.x >= kConsumers) {  // the producer warp: one thread issues
    if (threadIdx.x != kConsumers) return;
    const uint64_t policy = evict_first_policy();
    for_each_tile(p, [&](const Leaf& leaf, int64_t c0, int cols) {
      if (leaf.mode != kRing) return;
      const uint32_t row_bytes = static_cast<uint32_t>(cols) * sizeof(S);
      mbar_wait(&empty[stage], phase ^ 1);  // a fresh stage passes at once
      mbar_expect_tx(&full[stage], row_bytes * k);
      const S* src = static_cast<const S*>(leaf.g) + c0;
      S* dst = ring + static_cast<int64_t>(stage) * stage_elems;
      for (int kk = 0; kk < k; ++kk) {
        bulk_load(dst + kk * p.tile_cols, src + kk * leaf.d, row_bytes, &full[stage],
                  p.stream_g != 0, policy);
      }
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    });
    return;
  }

  // the consumers fold the weights while the first tiles are in flight,
  // then wait for one another only (named barrier 1, the consumer warps)
  const int tid = threadIdx.x;
  for (int i = tid; i < n_weights; i += kConsumers) {
    const float b = p.table[i];
    w_s[i] = Tr::round(p.scale != nullptr ? p.scale[(i / k) % NB] * b : b);
  }
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  for_each_tile(p, [&](const Leaf& leaf, int64_t c0, int cols) {
    const float* w = w_s + leaf.widx * NB * k;
    S* out = static_cast<S*>(leaf.out) + c0;
    if (leaf.mode == kRing) {
      mbar_wait(&full[stage], phase);
      const S* tile = ring + static_cast<int64_t>(stage) * stage_elems;
      for (int grp = tid; grp < cols / V; grp += kConsumers) {
        float acc[NB][V];
#pragma unroll
        for (int r = 0; r < NB; ++r) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[r][v] = 0.0f;
        }
#pragma unroll 4
        for (int kk = 0; kk < k; ++kk) {
          float gv[V];
          load_shared(tile + kk * p.tile_cols + grp * V, gv);
#pragma unroll
          for (int r = 0; r < NB; ++r) {
            const float wr = w[r * k + kk];
#pragma unroll
            for (int v = 0; v < V; ++v) acc[r][v] = fmaf(wr, gv[v], acc[r][v]);
          }
        }
#pragma unroll
        for (int r = 0; r < NB; ++r) {
          store16(out + r * leaf.d + grp * V, acc[r], p.stream_out != 0);
        }
      }
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(&empty[stage]);
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    } else if (leaf.mode == kDirect) {
      direct_tile<Tr, NB, V>(leaf, w, k, c0, cols);
    } else {
      direct_tile<Tr, NB, 1>(leaf, w, k, c0, cols);
    }
  });
}

// -------------------------------------------------------------------- host
struct DeviceFacts {
  int sms = 0;
  int smem_per_block = 0;  // the opt-in maximum of one block, bytes
  int l2_bytes = 0;        // L2 cache, bytes
};

// The current device (*dev) and its facts, queried once per device.
// Returns 0 or a CUDA error code.
inline int device_facts(int* dev, DeviceFacts* facts) {
  static DeviceFacts known[kMaxDevices];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*dev < 0 || *dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  DeviceFacts& f = known[*dev];
  if (f.sms == 0) {
    const struct {
      int* into;
      cudaDeviceAttr attr;
    } queries[] = {{&facts->smem_per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin},
                   {&facts->l2_bytes, cudaDevAttrL2CacheSize},
                   {&facts->sms, cudaDevAttrMultiProcessorCount}};
    for (const auto& q : queries) {
      err = cudaDeviceGetAttribute(q.into, q.attr, *dev);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (facts->sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
    f = *facts;
  }
  *facts = f;
  return 0;
}

// The current device's opt-in shared memory of one block, in bytes: the
// budget of kernels/_pipe.py's planner for the weight table and the
// ring.  Returns 0 or a CUDA error code.
inline int smem_per_block(int* bytes) {
  int dev = 0;
  DeviceFacts f;
  const int err = device_facts(&dev, &f);
  if (err == 0) *bytes = f.smem_per_block;
  return err;
}

// Shared memory of one CTA: the barriers, the weight table, the ring.
inline size_t smem_bytes(int itemsize, int nb, int n_w, int k, int tile_cols, int stages) {
  const size_t weights = sizeof(float) * static_cast<size_t>(n_w) * nb * k;
  const size_t ring = static_cast<size_t>(stages) * k * tile_cols * itemsize;
  return ((kBarrierBytes + weights + 127) / 128) * 128 + ring;
}

// Let every instantiation use the card's opt-in shared memory, once per
// device (a launch above 48 KB is refused without it).
template <typename Tr, int NB>
int opt_in(int dev, const DeviceFacts& f) {
  static bool done[kMaxDevices];  // per instantiation and device
  if (!done[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        pipe_kernel<Tr, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, f.smem_per_block);
    if (err != cudaSuccess) return static_cast<int>(err);
    done[dev] = true;
  }
  return 0;
}

// Launch one persistent grid on `stream`: as many CTAs as the current
// device holds at once (the occupancy of this instantiation with `smem`
// bytes each: shared memory, threads and registers), at most one per
// tile.
template <typename Tr, int NB>
int launch(Params& p, cudaStream_t stream) {
  int dev = 0;
  DeviceFacts f;
  int err = device_facts(&dev, &f);
  if (err != 0) return err;
  const int64_t item = sizeof(typename Tr::Storage);
  const size_t smem = smem_bytes(static_cast<int>(item), NB, p.n_w, p.k, p.tile_cols, p.stages);
  if (smem > static_cast<size_t>(f.smem_per_block)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((err = opt_in<Tr, NB>(dev, f)) != 0) return err;
  // the occupancy of the last shared-memory size, per instantiation and device
  static size_t known_smem[kMaxDevices];
  static int known_per_sm[kMaxDevices];
  if (known_smem[dev] != smem) {
    int per_sm = 0;
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pipe_kernel<Tr, NB>, kThreads, smem));
    if (err != 0) return err;
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    known_smem[dev] = smem;
    known_per_sm[dev] = per_sm;
  }
  // An operand larger than L2 cannot stay there: it streams evict-first,
  // so it does not flush the rest of L2.  One that fits keeps the normal
  // policy: G may be resident from its producer (the encode before a
  // decode), and the output is read next by its consumer.
  int64_t cols = 0;
  for (int j = 0; j < p.n_leaves; ++j) cols += p.leaves[j].d;
  p.stream_g = cols * p.k * item > f.l2_bytes;
  p.stream_out = cols * NB * item > f.l2_bytes;
  int64_t grid = static_cast<int64_t>(f.sms) * known_per_sm[dev];
  if (grid > p.n_tiles) grid = p.n_tiles;
  pipe_kernel<Tr, NB><<<static_cast<unsigned int>(grid), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Fill the parameters from the host's leaf descriptors and check them:
// the tile prefix sums, and that every leaf sent to the TMA ring (stages
// > 0) or to the 16-byte loads (no ring) has rows of whole 16-byte
// groups and 16-byte aligned pointers.  Returns 0 or a CUDA error code.
template <typename Tr>
int fill_params(Params* p, const void* scale, const void* table, int nb, int n_w, int k,
                int tile_cols, int stages, int n_leaves, const void* leaves,
                int64_t n_tiles) {
  constexpr int V = Tr::kVec;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (nb < 1 || nb > kMaxNB || n_w < 1 || k < 1 || n_leaves < 1 || n_leaves > kMaxLeaves ||
      stages < 0 || stages > kMaxStages || tile_cols < V || tile_cols % V != 0 ||
      table == nullptr || n_tiles < 1) {
    return bad;
  }
  p->scale = static_cast<const float*>(scale);
  p->table = static_cast<const float*>(table);
  p->n_w = n_w;
  p->k = k;
  p->tile_cols = tile_cols;
  p->stages = stages;
  p->n_leaves = n_leaves;
  p->stream_g = p->stream_out = 1;
  p->n_tiles = n_tiles;
  memcpy(p->leaves, leaves, sizeof(Leaf) * n_leaves);
  int64_t next = 0;
  for (int j = 0; j < n_leaves; ++j) {
    const Leaf& leaf = p->leaves[j];
    if (leaf.tile0 != next || leaf.d < 0 || leaf.widx < 0 || leaf.widx >= n_w) return bad;
    next += (leaf.d + tile_cols - 1) / tile_cols;
    if (leaf.mode == kPerColumn) continue;
    if ((leaf.mode != kRing && leaf.mode != kDirect) || (leaf.mode == kRing) != (stages > 0) ||
        leaf.d % V != 0 || reinterpret_cast<uintptr_t>(leaf.g) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(leaf.out) % 16 != 0) {
      return bad;
    }
  }
  return next == n_tiles ? 0 : bad;
}

}  // namespace pipe
