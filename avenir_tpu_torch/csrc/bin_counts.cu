// Monitor bin counts on Hopper (sm_90a).
//
// Replaces the TPU kernel ops/pallas/histogram.py:94 `bin_counts` (XLA twin
// ops/histogram.py:109 `feature_bin_counts`).  For every row n and every
// monitored row r of the (n, R) int32 code matrix:
//
//   out[r, codes[n, r]] += 1      when 0 <= codes[n, r] < B and mask[n]
//
// out is (R, B) float32.  A code outside [0, B) drops; a masked-out row
// (mask[n] == 0) adds nothing; no mask means every row counts.
//
// Exactness: the kernel counts in int32 atomics, exact in any order, and
// converts to float32 at the end.  The wrapper gives a launch at most 2^24
// rows, so every count it converts is an integer float32 holds exactly and
// the result is bit-identical to the reference's float32 one-hot sum.
//
// What bounds it on the H100: each code is read once (4 B) with the row's
// mask byte, and R*B counts are written: 20 B a row at the rafo baseline's
// R = 5 (20 MB, 0.006 ms of HBM traffic at 3.35 TB/s for a million rows),
// against one shared-memory atomic add per valid code.
//
// Design (simple and right first): one thread per (row, r) code over a
// grid-stride loop, so a warp reads 32 consecutive codes (coalesced); each
// block adds into a private (R, B) int32 accumulator in shared memory (up to
// 48 KB), then adds its nonzero cells into a global int32 accumulator with
// global atomics; a second launch converts that to float32.  Wider
// accumulators are added straight into global memory.  What it leaves on the
// table: a baseline has few cells (35 at rafo width), so the lanes of a warp
// serialise on a handful of shared addresses; per-warp sub-histograms would
// spread them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool SMEM, bool MASK>
__global__ void bin_counts_kernel(const int* __restrict__ codes,
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

template <bool SMEM>
void launch_counts(int blocks, size_t smem_bytes, cudaStream_t stream,
                   const int* codes, const unsigned char* mask, long long n,
                   int R, int B, int* acc) {
  if (mask != nullptr) {
    bin_counts_kernel<SMEM, true><<<blocks, kThreads, smem_bytes, stream>>>(
        codes, mask, n, R, B, acc);
  } else {
    bin_counts_kernel<SMEM, false><<<blocks, kThreads, smem_bytes, stream>>>(
        codes, mask, n, R, B, acc);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launches (0 = ok).
// `mask` may be null (every row counts).  `acc` is an (R, B) int32 buffer
// that must be zeroed; `out` the (R, B) float32 result.  `use_smem` comes
// from the wrapper, which sizes the accumulator (R*B*4 bytes).
extern "C" int avenir_bin_counts(const int* codes, const unsigned char* mask,
                                 long long n, int R, int B, int* acc,
                                 float* out, int use_smem, void* stream) {
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
    if (use_smem) {
      launch_counts<true>(blocks, (size_t)cells * sizeof(int), s, codes, mask,
                          n, R, B, acc);
    } else {
      launch_counts<false>(blocks, 0, s, codes, mask, n, R, B, acc);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  to_float_kernel<<<(cells + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      acc, out, cells);
  return (int)cudaGetLastError();
}
