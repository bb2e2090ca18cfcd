// Monitor bin counts on Hopper (sm_90a).
//
// Replaces the TPU kernel ops/pallas/histogram.py:94 `bin_counts` (XLA twin
// ops/histogram.py:109 `feature_bin_counts`).  For every row n and every
// monitored row r of the (n, R) int32 code matrix:
//
//   counts[r, codes[n, r]] += 1      when 0 <= codes[n, r] < B and mask[n]
//
// and then, per cell, out = float(count) or, accumulating, out = out +
// float(count): one float32 add a cell, the reference's `counts +
// feature_bin_counts(...)`.  A code outside [0, B) drops; a masked-out row
// (mask[n] == 0) adds nothing; no mask means every row counts.
//
// Exactness: counts are int32 sums, exact in any order; the wrapper gives a
// launch at most 2^24 rows, so each count converts to float32 exactly and
// the one add per cell rounds as the reference's does.
//
// What bounds it on the H100: each code is read once (4 B) with its row's
// mask byte and R*B floats are written: 20 B a row at the rafo baseline's
// R = 5, 0.006 ms of HBM traffic for a million rows at 3.35 TB/s.  The
// drift monitor calls it on blocks of 64 to 4,096 rows, where the bytes
// cost nothing and the call is one launch plus the wrapper's host work.
//
// Design (`avenir_bin_counts`): ONE launch a call.
//  * Loads: the (n, R) matrix is one contiguous range; a block walks tiles
//    of kThreads * kVec int4 (4,096 codes), every int4 on a 16-byte
//    boundary (the granules covering a slice that starts off one are read
//    whole; codes outside the range are ignored).  Each thread carries its
//    code's (row, r) as a running remainder advanced by constant steps the
//    host computes: no division in the loop.  The mask byte is read once
//    per row a thread meets.
//  * Counting: each warp owns a private R*B int32 sub-histogram in shared
//    memory while kWarps of them fit in 48 KB (35 cells at rafo width,
//    1,089 at the default 33 x 33), so only the lanes of one warp meet on
//    a cell; a lane adds its code with one shared atomic.  Wider layouts
//    share one block-wide accumulator (dynamic shared memory, opted in
//    above 48 KB once per process, up to kBlockSmemMax); wider still,
//    lanes add straight into the global accumulator.  (Grouping a warp's
//    lanes by cell with `__match_any_sync` and adding each group's
//    popcount once was slower on the H100 in an exploratory run at rafo
//    width, skewed codes included: the match costs more than the
//    serialised adds it saves.)
//  * Across blocks: each block adds its nonzero cells into a per-stream
//    int32 accumulator in global memory (the wrapper allocates it zeroed
//    once and keeps one per (device, stream)).  A ticket (`__threadfence`,
//    then `atomicAdd`) elects the last block to finish; it converts each
//    cell, writes (or adds into) `out`, and returns the accumulator and
//    the ticket to zero for the next call on that stream.  No zeroing
//    launch, no conversion launch.  (Per-block partial rows reduced by the
//    last block were the other choice: at the wide shape that block would
//    read grid x 16,384 partials alone.)
//
// `avenir_bin_counts_old` is the first port's design (a thread a code over
// a 64-bit grid-stride loop, a 64-bit division a code, one shared
// accumulator, a separate conversion launch), kept for timing only.
// `avenir_empty_launch` launches an empty kernel: the yardstick of a call
// whose bytes cost nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                      // int4 loads a thread a tile
constexpr int kTileCodes = kThreads * kVec * 4;
constexpr int kWarpSmemMax = 48 * 1024;      // per-warp sub-histograms
constexpr int kBlockSmemMax = 200 * 1024;    // one block-wide accumulator
constexpr int kMaxDevices = 64;
// resident blocks an SM the grid aims at (chosen among 1, 2, 4 and 8 in
// an exploratory H100 run at R, B = 5, 7 and 33, 33 over a million rows)
constexpr int kBlocksPerSm = 4;

enum { kAccWarp = 0, kAccBlock = 1, kAccGlobal = 2 };

// (row, r) of a flat code index, advanced by a constant step
struct Cursor {
  int i, row, r;
  __device__ __forceinline__ void advance(int di, int drow, int dr, int R) {
    i += di;
    row += drow;
    r += dr;
    if (r >= R) {
      r -= R;
      ++row;
    }
  }
};

template <int ACC, bool MASK>
__global__ void __launch_bounds__(kThreads)
bin_counts_kernel(const int4* __restrict__ base, int off0, int total,
                  const unsigned char* __restrict__ mask, int R, int B,
                  int step_i, int step_row, int step_r, int grid_i,
                  int grid_row, int grid_r, int* __restrict__ acc,
                  unsigned int* __restrict__ ticket, float* __restrict__ out,
                  int accumulate) {
  extern __shared__ __align__(16) int hist[];
  __shared__ bool last_block;
  const int cells = R * B;
  const int tid = threadIdx.x;
  int* dst = ACC == kAccWarp ? hist + (tid >> 5) * cells
                             : (ACC == kAccBlock ? hist : acc);
  if (ACC != kAccGlobal) {
    const int n_smem = ACC == kAccWarp ? kWarps * cells : cells;
    for (int c = tid; c < n_smem; c += kThreads) hist[c] = 0;
    __syncthreads();
  }

  // int4 v covers aligned codes 4v .. 4v+3, flat indices 4v - off0 + k
  const int n_vec = (off0 + total + 3) >> 2;
  const int first_v = blockIdx.x * (kThreads * kVec) + tid;
  Cursor cur;
  cur.i = 4 * first_v - off0;
  if (cur.i >= 0) {
    cur.row = cur.i / R;
    cur.r = cur.i - cur.row * R;
  } else {  // only the first int4 of a slice that starts off a boundary
    cur.row = -1 - (-cur.i - 1) / R;
    cur.r = cur.i - cur.row * R;
  }
  int mask_row = -1;
  bool mask_on = true;
  for (int tile = blockIdx.x * (kThreads * kVec); tile < n_vec;
       tile += gridDim.x * (kThreads * kVec)) {
    int4 q[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int v = tile + u * kThreads + tid;
      q[u] = v < n_vec ? __ldg(base + v) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int code4[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
      int row = cur.row, r = cur.r;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = cur.i + k;
        const int code = code4[k];
        bool ok = (unsigned)i < (unsigned)total &&
                  (unsigned)code < (unsigned)B;
        if (MASK && ok) {
          if (row != mask_row) {
            mask_row = row;
            mask_on = mask[row] != 0;
          }
          ok = mask_on;
        }
        if (ok) atomicAdd(dst + r * B + code, 1);
        if (++r == R) {
          r = 0;
          ++row;
        }
      }
      cur.advance(step_i, step_row, step_r, R);
    }
    // the unrolled steps moved kVec * kThreads int4; on to this thread's
    // int4 in the block's next tile
    cur.advance(grid_i, grid_row, grid_r, R);
  }

  if (ACC != kAccGlobal) {
    __syncthreads();
    for (int c = tid; c < cells; c += kThreads) {
      int v = hist[c];
      if (ACC == kAccWarp) {
#pragma unroll
        for (int w = 1; w < kWarps; ++w) v += hist[w * cells + c];
      }
      if (v != 0) atomicAdd(acc + c, v);
    }
  }

  // the last block to finish converts, writes and re-zeroes the accumulator
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int c = tid; c < cells; c += kThreads) {
    const float f = static_cast<float>(atomicExch(acc + c, 0));
    out[c] = accumulate ? out[c] + f : f;
  }
  if (tid == 0) *ticket = 0u;
}

template <int ACC>
cudaError_t launch_new(int blocks, size_t smem, cudaStream_t s,
                       const int4* base, int off0, int total,
                       const unsigned char* mask, int R, int B, int step_i,
                       int step_row, int step_r, int grid_i, int grid_row,
                       int grid_r, int* acc, unsigned int* ticket, float* out,
                       int accumulate) {
  if (mask != nullptr) {
    bin_counts_kernel<ACC, true><<<blocks, kThreads, smem, s>>>(
        base, off0, total, mask, R, B, step_i, step_row, step_r, grid_i,
        grid_row, grid_r, acc, ticket, out, accumulate);
  } else {
    bin_counts_kernel<ACC, false><<<blocks, kThreads, smem, s>>>(
        base, off0, total, mask, R, B, step_i, step_row, step_r, grid_i,
        grid_row, grid_r, acc, ticket, out, accumulate);
  }
  return cudaGetLastError();
}

// SMs of each device, read once a device; the opt-in above 48 KB of
// dynamic shared memory for the block-wide form, made once a device (the
// attribute holds per device context)
int g_sms[kMaxDevices];
bool g_block_smem_set[kMaxDevices];

int sm_count(int dev) {
  if (dev < 0 || dev >= kMaxDevices) return 132;
  if (g_sms[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    g_sms[dev] = sms > 0 ? sms : 132;
  }
  return g_sms[dev];
}

// ---- the first port's design, for timing only ----

template <bool SMEM, bool MASK>
__global__ void bin_counts_old_kernel(const int* __restrict__ codes,
                                      const unsigned char* __restrict__ mask,
                                      long long n, int R, int B,
                                      int* __restrict__ acc) {
  extern __shared__ __align__(16) int acc_smem[];
  const int cells = R * B;
  int* dst = SMEM ? acc_smem : acc;
  if (SMEM) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) acc_smem[i] = 0;
    __syncthreads();
  }
  const long long total = n * R;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int code = codes[i];
    if (code < 0 || code >= B) continue;
    const long long row = i / R;
    if (MASK && !mask[row]) continue;
    const int r = (int)(i - row * R);
    atomicAdd(dst + r * B + code, 1);
  }
  if (SMEM) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      const int v = acc_smem[i];
      if (v != 0) atomicAdd(acc + i, v);
    }
  }
}

__global__ void to_float_kernel(const int* __restrict__ acc,
                                float* __restrict__ out, int cells) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < cells) out[i] = static_cast<float>(acc[i]);
}

__global__ void empty_kernel() {}

}  // namespace

// One launch on `stream`; returns cudaGetLastError() after it (0 = ok).
// `codes` (n, R) int32, contiguous, any 4-byte alignment, n * R < 2^30;
// `mask` (n,) bytes or null; `acc` (R*B) int32 and `ticket` one uint32, both
// zero on entry and left zero on exit; `out` (R, B) float32, written, or
// added into when `accumulate`.  Runs on the device `dev`.
extern "C" int avenir_bin_counts(const int* codes,
                                 const unsigned char* mask, long long n,
                                 int R, int B, int* acc,
                                 unsigned int* ticket, float* out,
                                 int accumulate, int dev, void* stream) {
  const long long cells = (long long)R * B;
  if (cells <= 0) return 0;
  if (n < 0 || n * R >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  int prev = -1;
  cudaGetDevice(&prev);
  if (prev != dev) cudaSetDevice(dev);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned long long addr = reinterpret_cast<unsigned long long>(codes);
  const int off0 = (int)((addr & 15ull) >> 2);
  const int4* base = reinterpret_cast<const int4*>(addr & ~15ull);
  const int total = (int)(n * R);
  const int tiles = (off0 + total + kTileCodes - 1) / kTileCodes;
  int acc_form = kAccGlobal;
  size_t smem = 0;
  if ((long long)kWarps * cells * 4 <= kWarpSmemMax) {
    acc_form = kAccWarp;
    smem = (size_t)kWarps * cells * 4;
  } else if (cells * 4 <= kBlockSmemMax) {
    acc_form = kAccBlock;
    smem = (size_t)cells * 4;
  }
  // kBlocksPerSm blocks an SM at a million rows; the fewest that cover the
  // rows below that (one block per 4,096 codes); the block-wide form at
  // most as many as its shared memory lets an SM hold
  int per_sm = kBlocksPerSm;
  if (acc_form == kAccBlock) {
    const int fit = (int)((228 * 1024) / (smem + 1024));
    per_sm = fit < 1 ? 1 : (fit < per_sm ? fit : per_sm);
  }
  const int cap = per_sm * sm_count(dev);
  const int blocks = tiles < 1 ? 1 : (tiles < cap ? tiles : cap);
  // the cursor's steps: kThreads int4 (one unrolled step), and the rest of
  // the grid's stride after kVec of them
  const int step_i = 4 * kThreads;
  const int grid_i = 4 * kThreads * kVec * (blocks - 1);
  cudaError_t err = cudaSuccess;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (acc_form == kAccBlock && smem > 48 * 1024 &&
      !(known && g_block_smem_set[dev])) {
    err = cudaFuncSetAttribute(bin_counts_kernel<kAccBlock, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kBlockSmemMax);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bin_counts_kernel<kAccBlock, false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kBlockSmemMax);
    if (err == cudaSuccess && known) g_block_smem_set[dev] = true;
  }
  if (err == cudaSuccess) {
    auto go = acc_form == kAccWarp    ? launch_new<kAccWarp>
              : acc_form == kAccBlock ? launch_new<kAccBlock>
                                      : launch_new<kAccGlobal>;
    err = go(blocks, smem, s, base, off0, total, mask, R, B, step_i,
             step_i / R, step_i % R, grid_i, grid_i / R, grid_i % R, acc,
             ticket, out, accumulate);
  }
  if (prev != dev && prev >= 0) cudaSetDevice(prev);
  return (int)err;
}

// The first port's two launches, for timing only: `acc` (R, B) int32 must
// be zeroed; `out` (R, B) float32 is written.  `use_smem` comes from the
// wrapper (R*B*4 bytes within 48 KB).
extern "C" int avenir_bin_counts_old(const int* codes,
                                     const unsigned char* mask, long long n,
                                     int R, int B, int* acc, float* out,
                                     int use_smem, void* stream) {
  const int cells = R * B;
  if (cells <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long want = (n * R + kThreads - 1) / kThreads;
    const long long cap = (long long)sms * 8;
    const int blocks = (int)(want < cap ? want : cap);
    const size_t smem = use_smem ? (size_t)cells * sizeof(int) : 0;
    if (use_smem && mask != nullptr) {
      bin_counts_old_kernel<true, true><<<blocks, kThreads, smem, s>>>(
          codes, mask, n, R, B, acc);
    } else if (use_smem) {
      bin_counts_old_kernel<true, false><<<blocks, kThreads, smem, s>>>(
          codes, mask, n, R, B, acc);
    } else if (mask != nullptr) {
      bin_counts_old_kernel<false, true><<<blocks, kThreads, 0, s>>>(
          codes, mask, n, R, B, acc);
    } else {
      bin_counts_old_kernel<false, false><<<blocks, kThreads, 0, s>>>(
          codes, mask, n, R, B, acc);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  to_float_kernel<<<(cells + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      acc, out, cells);
  return (int)cudaGetLastError();
}

// One empty kernel on `stream`: the cost of a launch alone.
extern "C" int avenir_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
