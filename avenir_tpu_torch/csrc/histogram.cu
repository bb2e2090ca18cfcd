// Forest level histogram on Hopper (sm_90a).
//
// Replaces the TPU kernel ops/pallas/histogram.py:40 `forest_level_counts`
// (per-tile body models/forest.py `_count_body`).  For every row n, every
// tree t whose node id is active and every candidate split s, add the row's
// weight for that tree to one cell of the level histogram:
//
//   out[t, node_ids[n,t], s, branches[n,s], cls[n]] += weights[n,t]
//
// out is (T, N, S, B, C) float32, zeroed by the wrapper.  Semantics of the
// reference's one-hot contraction: a row-tree pair adds nothing when its
// node id is outside [0, N) (pad -1, stopped leaf -2), its class is outside
// [0, C), or its weight is 0; a split adds nothing where the row's branch is
// outside [0, B).  Weights are read as uint8 or float32 (`WT`).
//
// Exactness: every weight is an integer and the callers keep a launch's
// weight mass below 2^24 (tree.level_chunk), so every partial sum is an
// integer below 2^24 that float32 holds exactly, and the result is
// bit-identical to the plain version and to `_count_body` whatever order
// the atomics land in.
//
// What bounds it on the H100: each row reads its T node ids, S branch codes,
// its class and T weights once — (4T + 4S + 4 + T) bytes a row with uint8
// weights, 160 B at the bench forest's T=16, S=19 (1.28 GB, 0.38 ms of HBM
// traffic at 3.35 TB/s for 8M rows) — against n*T*S shared-memory atomic
// adds (2.4 G at that shape), one per active (row, tree, split).
//
// Design (simple and right first): one thread per row over a grid-stride
// loop; each block keeps a private (T,N,S,B,C) float32 accumulator in
// dynamic shared memory (21,888 B at rafo width, 38,912 B at the bench's 16
// trees; above 48 KB the launch raises the block's dynamic shared memory
// limit), adds into it with shared-memory atomics, then adds its nonzero
// cells into the output with global atomics.  When the accumulator does not
// fit, the kernel adds straight into global memory, so any width runs.
// What it leaves on the table: at shallow levels all rows of a tree fall on
// a few cells (N*B*C per split), so the 32 lanes of a warp serialise on the
// same shared addresses; row reads are strided by T and S (one thread per
// row, not coalesced); and each thread loops over trees and splits serially.
// A faster form would give a warp a row tile with lanes over splits, keep
// per-warp sub-histograms for the shallow levels, and stage rows through
// shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename WT, bool SMEM>
__global__ void level_counts_kernel(const int* __restrict__ node_ids,
                                    const int* __restrict__ branches,
                                    const int* __restrict__ cls,
                                    const WT* __restrict__ weights,
                                    long long n, int T, int N, int S, int B,
                                    int C, float* __restrict__ out) {
  extern __shared__ __align__(16) float acc_smem[];
  const int cells = T * N * S * B * C;
  float* acc = SMEM ? acc_smem : out;
  if (SMEM) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) acc[i] = 0.0f;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += stride) {
    const int c = cls[row];
    if (c < 0 || c >= C) continue;
    const int* nid = node_ids + row * T;
    const WT* w = weights + row * T;
    const int* br = branches + row * S;
    for (int t = 0; t < T; ++t) {
      const int node = nid[t];
      const float wt = static_cast<float>(w[t]);
      if (node < 0 || node >= N || wt == 0.0f) continue;
      // cell (t, node, s, b, c) = ((t*N + node)*S + s)*B*C + b*C + c
      const int base = (t * N + node) * S;
      for (int s = 0; s < S; ++s) {
        const int b = br[s];
        if (b < 0 || b >= B) continue;
        atomicAdd(acc + (base + s) * B * C + b * C + c, wt);
      }
    }
  }
  if (SMEM) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      const float v = acc[i];
      if (v != 0.0f) atomicAdd(out + i, v);
    }
  }
}

template <typename WT>
cudaError_t launch(const int* node_ids, const int* branches, const int* cls,
                   const void* weights, long long n, int T, int N, int S,
                   int B, int C, float* out, bool use_smem, size_t smem_bytes,
                   cudaStream_t stream) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n + kThreads - 1) / kThreads;
  const WT* w = static_cast<const WT*>(weights);
  if (use_smem) {
    auto kernel = level_counts_kernel<WT, true>;
    if (smem_bytes > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem_bytes);
      if (err != cudaSuccess) return err;
    }
    int per_sm = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, smem_bytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long cap = (long long)sms * per_sm;
    const int blocks = (int)(want < cap ? want : cap);
    kernel<<<blocks, kThreads, smem_bytes, stream>>>(node_ids, branches, cls,
                                                     w, n, T, N, S, B, C, out);
  } else {
    const long long cap = (long long)sms * 16;
    const int blocks = (int)(want < cap ? want : cap);
    level_counts_kernel<WT, false><<<blocks, kThreads, 0, stream>>>(
        node_ids, branches, cls, w, n, T, N, S, B, C, out);
  }
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// weight_dtype: 0 = uint8, 1 = float32.  `use_smem` / `smem_bytes` come from
// the wrapper, which sizes the accumulator (T*N*S*B*C*4 bytes).  `out` must
// be zeroed.
extern "C" int avenir_forest_level_counts(
    const int* node_ids, const int* branches, const int* cls,
    const void* weights, int weight_dtype, long long n, int T, int N, int S,
    int B, int C, float* out, int use_smem, long long smem_bytes,
    void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sm = use_smem != 0;
  const size_t sb = sm ? (size_t)smem_bytes : 0;
  cudaError_t err;
  if (weight_dtype == 0) {
    err = launch<uint8_t>(node_ids, branches, cls, weights, n, T, N, S, B, C,
                          out, sm, sb, s);
  } else if (weight_dtype == 1) {
    err = launch<float>(node_ids, branches, cls, weights, n, T, N, S, B, C,
                        out, sm, sb, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
