// Fused gradient-coding combine for Hopper (sm_90a), grouped over leaves:
//
//     y_j = (a ⊙ B_code[which_j]) @ G_j
//         a : (NB,) decode weights, fp32       B_code : (n_w, NB, K) coding rows, fp32
//         G_j : (K, D_j) per-shard gradients, fp32 or bf16
//         y_j : (NB, D_j) in G's dtype, fp32 accumulation
//
// Replaces the TPU kernel repro/kernels/gc_fused.py::encode_decode_pallas.
// On the training main path NB = 1 and K = N·K' = 16 (N = 4 workers,
// K' = s_max + 1 = 4 shards each), and one launch combines the step's 11
// leaves (D_j from 768 to 28.3M), each with its level's weight set.
//
// Bound: memory (gc_pipe.cuh).  At K = 16 fp32 the kernel must move
// 17 · 4 = 68 bytes per column: 9.37 GB for one training step, 2.80 ms at
// 3.35 TB/s.  The persistent grid, the TMA ring and the ragged-leaf path
// are gc_pipe.cuh's.
//
// Fold order follows repro/kernels/ref.py (see repro_torch/kernels/ref.py):
// w = a ⊙ B is folded in fp32 and rounded to G's dtype before the products.

#include "gc_pipe.cuh"

namespace {

template <typename Tr>
int run(const void* a, const void* b, int nb, int n_w, int k, int tile_cols, int stages,
        int n_leaves, const void* leaves, int64_t n_tiles, void* stream) {
  pipe::Params p;
  const int err = pipe::fill_params<Tr>(&p, a, b, nb, n_w, k, tile_cols, stages, n_leaves,
                                        leaves, n_tiles);
  if (err != 0 || a == nullptr) return err != 0 ? err : static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nb) {  // NB is a template parameter: the accumulators stay in registers
    case 1: return pipe::launch<Tr, 1>(p, s);
    case 2: return pipe::launch<Tr, 2>(p, s);
    case 3: return pipe::launch<Tr, 3>(p, s);
    case 4: return pipe::launch<Tr, 4>(p, s);
    case 5: return pipe::launch<Tr, 5>(p, s);
    case 6: return pipe::launch<Tr, 6>(p, s);
    case 7: return pipe::launch<Tr, 7>(p, s);
    case 8: return pipe::launch<Tr, 8>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream` over up to 32 leaves and
// returns cudaGetLastError().  `leaves` is a host array of n_leaves leaf
// descriptors (gc_pipe.cuh's Leaf; kernels/_pipe.py packs them).
int gc_fused_f32(const void* a, const void* b, int nb, int n_w, int k, int tile_cols,
                 int stages, int n_leaves, const void* leaves, int64_t n_tiles, void* stream) {
  return run<F32>(a, b, nb, n_w, k, tile_cols, stages, n_leaves, leaves, n_tiles, stream);
}

int gc_fused_bf16(const void* a, const void* b, int nb, int n_w, int k, int tile_cols,
                  int stages, int n_leaves, const void* leaves, int64_t n_tiles, void* stream) {
  return run<BF16>(a, b, nb, n_w, k, tile_cols, stages, n_leaves, leaves, n_tiles, stream);
}

// The current device's opt-in shared memory of one block, in bytes.
int gc_fused_smem_per_block(int* bytes) { return pipe::smem_per_block(bytes); }

const char* gc_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
