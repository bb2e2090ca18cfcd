// KNN distance + running top-k scan on Hopper (sm_90a): kernel B5.
//
// Replaces the TPU kernel ops/pallas/topk.py:39 `topk_scan` (XLA twin
// ops/distance.py `_topk_scan_kernel`).  For every test row t of a chunk and
// every train row r, in ascending r:
//
//   euclidean  d = floor(sqrt(max((max(sq, 0) + (n_cat - match)) / denom, 0))
//                        * fscale),  sq = (|t|^2 + |r|^2) - dot(2t, r)
//   manhattan  d = floor(((sum_f |t_f - r_f|) + (n_cat - match)) / denom
//                        * fscale)
//
// where match counts the one-hot positions set in both rows, and keeps the
// k smallest (d, r) pairs, ascending, ties to the lowest train index.  Output
// (nt, k) float32 distances and int32 train indices; slots past the train
// count stay (+inf, -1).
//
// Exactness: the result must equal the plain version (kernels/topk.py
// `topk_scan_torch`, body ops/distance.py), which reproduces the JAX
// package's float32 order.  So every op is one IEEE float32 op in that
// order: the norms and the dot accumulate with __fmaf_rn from 0 in feature
// order; every other add, subtract, multiply, divide and square root is an
// explicit _rn intrinsic, since nvcc would otherwise contract a*b+c into an
// FMA; no fast math.  The train norms are hoisted into a prep kernel with the
// same FMA loop.  The match count is an exact integer (popcount of packed
// one-hot words).
//
// Selection: one thread per test row keeps a sorted list of K >= k slots.  A
// candidate enters only when its distance is strictly below the last slot,
// and lands after any equal entries; train rows arrive in ascending order,
// so ties resolve to the lowest index with no index compare.  The first k of
// the K smallest pairs are the k smallest.  K is a template size (8, 16, 32,
// 64) held in registers; for k > 64 the list lives in the output rows in
// global memory, with no size refused.
//
// What bounds it on the H100: operations.  Per pair Fn FMAs plus about nine
// float32 ops (add, subtract, max, add, divide, square root, multiply,
// floor, compare) and a popcount per one-hot word; the bytes (the test and
// train rows once, the (nt, k) results) are small.  20,000 x 200,000
// e-learning rows (Fn = 4) is 4e9 pairs, about 1.6 ms at 33.5 T float32
// instructions/s.
//
// The train-sharded form (kernel B7, replacing ops/pallas/topk.py:128
// `topk_scan_sharded`) runs this scan once per shard of the train rows and
// merges the shards' lists with `avenir_topk_merge` below: one thread per
// test row walks S ascending lists with one cursor each and keeps k slots.
//
// Design (simple and right first): the block's test rows sit in registers
// (numeric features up to 8, one-hot words up to 2; wider rows are read from
// global memory); the block walks the train rows in tiles staged in shared
// memory (features, norm, one-hot words per row), every thread reading the
// same staged row at a time (a broadcast).  What it leaves on the table: a
// test chunk of 8,192 rows is 128 blocks of 64 threads, about 2 warps an SM,
// so the long divide / square-root chains are latency-bound; splitting the
// train axis over blocks and merging the partial lists would fill the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;        // test rows per block
constexpr int kTile = 256;          // train rows staged per tile, at most
constexpr int kRegFn = 8;           // numeric features held in registers
constexpr int kRegWords = 2;        // one-hot words held in registers
constexpr int kEuclid = 0;
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 227 * 1024;

// words[i, w] bit b = (oh[i, 32 w + b] != 0)
__global__ void pack_onehot(const int8_t* __restrict__ oh, long long n, int Fc,
                            int W, uint32_t* __restrict__ words) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * W) return;
  const long long row = i / W;
  const int c0 = (int)(i - row * W) * 32;
  const int8_t* src = oh + row * Fc;
  uint32_t bits = 0;
  for (int b = 0; b < 32 && c0 + b < Fc; ++b) {
    if (src[c0 + b] != 0) bits |= 1u << b;
  }
  words[i] = bits;
}

// out[i] = sum_f x[i, f]^2, by FMA from 0 in feature order
__global__ void row_norms(const float* __restrict__ x, long long n, int Fn,
                          float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int f = 0; f < Fn; ++f) {
    const float v = x[i * Fn + f];
    acc = __fmaf_rn(v, v, acc);
  }
  out[i] = acc;
}

// Insert (d, idx) into the ascending register list of K slots; the caller
// checked d < bd[K-1].  Slot j takes its left neighbour while that one is
// greater than d, d where the left neighbour is <= d < bd[j], else stays.
template <int K>
__device__ __forceinline__ void insert_reg(float (&bd)[K], int (&bi)[K],
                                           float d, int idx) {
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    const float prev = j > 0 ? bd[j > 0 ? j - 1 : 0] : -INFINITY;
    if (prev > d) {
      bd[j] = prev;
      bi[j] = bi[j > 0 ? j - 1 : 0];
    } else if (bd[j] > d) {
      bd[j] = d;
      bi[j] = idx;
    }
  }
}

// K > 0: register list of K slots; K == 0: the list is the row's k output
// slots in global memory.  REG: the test row's features and one-hot words in
// registers (Fn <= kRegFn, W <= kRegWords), else read from global memory.
template <int K, bool REG, int METRIC>
__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ tn, const uint32_t* __restrict__ tw,
            const float* __restrict__ rn, const uint32_t* __restrict__ rw,
            const float* __restrict__ rnorm, int nt, int nr, int Fn, int W,
            int k, int tile, float n_cat, float denom, float fscale,
            float* __restrict__ od, int* __restrict__ oi) {
  extern __shared__ __align__(16) uint32_t stage[];
  const int stride = Fn + 1 + W;             // features, norm, words
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = row < nt;
  const long long trow = active ? row : 0;
  const float* t_g = tn + trow * Fn;
  const uint32_t* tw_g = tw + trow * W;

  float t[REG ? kRegFn : 1];
  uint32_t twr[REG ? kRegWords : 1];
  if (REG) {
#pragma unroll
    for (int f = 0; f < (REG ? kRegFn : 1); ++f)
      t[f] = (active && f < Fn) ? t_g[f] : 0.f;
#pragma unroll
    for (int w = 0; w < (REG ? kRegWords : 1); ++w)
      twr[w] = (active && w < W) ? tw_g[w] : 0u;
  }
  float tnorm = 0.f;
  if (METRIC == kEuclid && active) {
    for (int f = 0; f < Fn; ++f) {
      const float v = t_g[f];
      tnorm = __fmaf_rn(v, v, tnorm);
    }
  }

  float bd[K > 0 ? K : 1];
  int bi[K > 0 ? K : 1];
#pragma unroll
  for (int j = 0; j < (K > 0 ? K : 1); ++j) {
    bd[j] = INFINITY;
    bi[j] = -1;
  }
  float* gd = od + trow * k;
  int* gi = oi + trow * k;
  float kth = INFINITY;                      // the global list's last slot
  if (K == 0 && active) {
    for (int j = 0; j < k; ++j) {
      gd[j] = INFINITY;
      gi[j] = -1;
    }
  }

  for (int base = 0; base < nr; base += tile) {
    const int cnt = min(tile, nr - base);
    __syncthreads();
    for (int i = threadIdx.x; i < cnt * stride; i += blockDim.x) {
      const int r = i / stride;
      const int c = i - r * stride;
      const long long g = (long long)base + r;
      uint32_t v;
      if (c < Fn) {
        v = __float_as_uint(rn[g * Fn + c]);
      } else if (c == Fn) {
        v = METRIC == kEuclid ? __float_as_uint(rnorm[g]) : 0u;
      } else {
        v = rw[g * W + (c - Fn - 1)];
      }
      stage[i] = v;
    }
    __syncthreads();
    if (!active) continue;
    for (int r = 0; r < cnt; ++r) {
      const uint32_t* s = stage + r * stride;
      int match = 0;
      if (REG) {
#pragma unroll
        for (int w = 0; w < (REG ? kRegWords : 1); ++w)
          if (w < W) match += __popc(twr[w] & s[Fn + 1 + w]);
      } else {
        for (int w = 0; w < W; ++w) match += __popc(tw_g[w] & s[Fn + 1 + w]);
      }
      const float mis = __fsub_rn(n_cat, (float)match);
      float d;
      if (METRIC == kEuclid) {
        float dot = 0.f;
        if (REG) {
#pragma unroll
          for (int f = 0; f < (REG ? kRegFn : 1); ++f)
            if (f < Fn)
              dot = __fmaf_rn(__fmul_rn(2.f, t[f]), __uint_as_float(s[f]),
                              dot);
        } else {
          for (int f = 0; f < Fn; ++f)
            dot = __fmaf_rn(__fmul_rn(2.f, t_g[f]), __uint_as_float(s[f]),
                            dot);
        }
        const float sq =
            __fsub_rn(__fadd_rn(tnorm, __uint_as_float(s[Fn])), dot);
        const float total = __fadd_rn(fmaxf(sq, 0.f), mis);
        const float mean = __fdiv_rn(total, denom);
        d = floorf(__fmul_rn(__fsqrt_rn(fmaxf(mean, 0.f)), fscale));
      } else {
        float num = 0.f;
        if (REG) {
#pragma unroll
          for (int f = 0; f < (REG ? kRegFn : 1); ++f)
            if (f < Fn)
              num = __fadd_rn(num,
                              fabsf(__fsub_rn(t[f], __uint_as_float(s[f]))));
        } else {
          for (int f = 0; f < Fn; ++f)
            num = __fadd_rn(num,
                            fabsf(__fsub_rn(t_g[f], __uint_as_float(s[f]))));
        }
        d = floorf(__fmul_rn(__fdiv_rn(__fadd_rn(num, mis), denom), fscale));
      }
      const int idx = base + r;
      if (K > 0) {
        if (d < bd[K > 0 ? K - 1 : 0]) insert_reg(bd, bi, d, idx);
      } else if (d < kth) {
        int j = k - 1;
        while (j > 0 && gd[j - 1] > d) {
          gd[j] = gd[j - 1];
          gi[j] = gi[j - 1];
          --j;
        }
        gd[j] = d;
        gi[j] = idx;
        kth = gd[k - 1];
      }
    }
  }
  if (K > 0 && active) {
#pragma unroll
    for (int j = 0; j < (K > 0 ? K : 1); ++j) {
      if (j < k) {
        gd[j] = bd[j];
        gi[j] = bi[j];
      }
    }
  }
}

template <int K, bool REG, int METRIC>
cudaError_t launch_topk(int blocks, int smem, cudaStream_t s, const float* tn,
                        const uint32_t* tw, const float* rn,
                        const uint32_t* rw, const float* rnorm, int nt, int nr,
                        int Fn, int W, int k, int tile, float n_cat,
                        float denom, float fscale, float* od, int* oi) {
  auto kern = topk_kernel<K, REG, METRIC>;
  if (smem > kSmemDefault) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<blocks, kThreads, smem, s>>>(tn, tw, rn, rw, rnorm, nt, nr, Fn, W, k,
                                      tile, n_cat, denom, fscale, od, oi);
  return cudaGetLastError();
}

template <bool REG, int METRIC>
cudaError_t launch_k(int kcap, int blocks, int smem, cudaStream_t s,
                     const float* tn, const uint32_t* tw, const float* rn,
                     const uint32_t* rw, const float* rnorm, int nt, int nr,
                     int Fn, int W, int k, int tile, float n_cat, float denom,
                     float fscale, float* od, int* oi) {
#define AVENIR_TOPK_LAUNCH(KK)                                              \
  return launch_topk<KK, REG, METRIC>(blocks, smem, s, tn, tw, rn, rw,      \
                                      rnorm, nt, nr, Fn, W, k, tile, n_cat, \
                                      denom, fscale, od, oi)
  switch (kcap) {
    case 8: AVENIR_TOPK_LAUNCH(8);
    case 16: AVENIR_TOPK_LAUNCH(16);
    case 32: AVENIR_TOPK_LAUNCH(32);
    case 64: AVENIR_TOPK_LAUNCH(64);
    default: AVENIR_TOPK_LAUNCH(0);
  }
#undef AVENIR_TOPK_LAUNCH
}

// The register list size a launch uses for k (0 = the global-memory list)
// and whether it holds the test rows in registers; kernels/topk.py
// `list_size` and `register_rows` mirror both for reporting.
int list_size(int k) {
  return k <= 8 ? 8 : k <= 16 ? 16 : k <= 32 ? 32 : k <= 64 ? 64 : 0;
}

bool register_rows(int Fn, int Fc) {
  return Fn <= kRegFn && (Fc + 31) / 32 <= kRegWords;
}

// The shards' (nt, k) lists, by value (a kernel parameter): distances,
// local train indices (-1 = dead slot) and each shard's first global row;
// at most parallel/mesh.py MAX_SHARDS shards, as a DeviceMesh holds.
constexpr int kMaxShards = 64;
struct ShardLists {
  const float* d[kMaxShards];
  const int* i[kMaxShards];
  int base[kMaxShards];
};

// Merge S lists, each ascending by (d, local index) with its dead slots
// last, into the row's k smallest (d, global index) pairs.  Shards are
// ascending contiguous train ranges, so on equal d the lower shard holds the
// lower global index: taking the first shard whose head is strictly
// smallest keeps the lexicographic order with no index compare.  A slot
// nothing fills, or whose distance is +inf, is (+inf, -1).
__global__ void topk_merge_kernel(ShardLists L, int S, int nt, int k,
                                  float* __restrict__ od,
                                  int* __restrict__ oi) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= nt) return;
  int cur[kMaxShards];
  for (int s = 0; s < S; ++s) cur[s] = 0;
  const long long off = (long long)row * k;
  for (int j = 0; j < k; ++j) {
    int best = -1;
    float bd = INFINITY;
    int bi = -1;
    for (int s = 0; s < S; ++s) {
      if (cur[s] >= k) continue;
      const int li = L.i[s][off + cur[s]];
      if (li < 0) continue;
      const float d = L.d[s][off + cur[s]];
      if (best < 0 || d < bd) {
        best = s;
        bd = d;
        bi = li;
      }
    }
    if (best < 0) {
      od[off + j] = INFINITY;
      oi[off + j] = -1;
    } else {
      od[off + j] = bd;
      oi[off + j] = isinf(bd) ? -1 : bi + L.base[best];
      ++cur[best];
    }
  }
}

}  // namespace

// The merge of the train-sharded scan.  `d` and `i` are host arrays of S
// device pointers to each shard's (nt, k) float32 distances and int32 local
// indices (a shard's `avenir_topk_scan` output, gathered onto the current
// device), `base` the S shards' first global train rows, 1 <= S <= 64.
// Outputs od (nt, k) float32, oi (nt, k) int32.  Launch on `stream`;
// returns cudaGetLastError() (0 = ok).
extern "C" int avenir_topk_merge(const float* const* d, const int* const* i,
                                 const int* base, int S, int nt, int k,
                                 float* od, int* oi, void* stream) {
  if (S < 1 || S > kMaxShards || k < 1) return (int)cudaErrorInvalidValue;
  if (nt <= 0) return 0;
  ShardLists L{};
  for (int s = 0; s < S; ++s) {
    L.d[s] = d[s];
    L.i[s] = i[s];
    L.base[s] = base[s];
  }
  const int threads = 128;
  topk_merge_kernel<<<(nt + threads - 1) / threads, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(L, S, nt, k, od,
                                                           oi);
  return (int)cudaGetLastError();
}

// Launch on `stream`; returns cudaGetLastError() after the launches (0 = ok).
// tn (nt, Fn) float32, toh (nt, Fc) int8 0/1, rn (nr, Fn) float32, roh
// (nr, Fc) int8 0/1, all contiguous; nt, nr, k >= 1.  Scratch from the
// wrapper: twords (nt, W) and rwords (nr, W) uint32 with W = ceil(Fc / 32)
// (null when Fc == 0), rnorm (nr,) float32 (euclidean only, else null).
// Outputs od (nt, k) float32, oi (nt, k) int32.  metric 0 = euclidean,
// 1 = manhattan.
extern "C" int avenir_topk_scan(const float* tn, const int8_t* toh,
                                const float* rn, const int8_t* roh, int nt,
                                int nr, int Fn, int Fc, int k, int metric,
                                float n_cat, float denom, float fscale,
                                uint32_t* twords, uint32_t* rwords,
                                float* rnorm, float* od, int* oi,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int W = (Fc + 31) / 32;
  const int prep = 256;
  if (W > 0) {
    pack_onehot<<<(int)(((long long)nt * W + prep - 1) / prep), prep, 0, s>>>(
        toh, nt, Fc, W, twords);
    pack_onehot<<<(int)(((long long)nr * W + prep - 1) / prep), prep, 0, s>>>(
        roh, nr, Fc, W, rwords);
  }
  if (metric == kEuclid) {
    row_norms<<<(nr + prep - 1) / prep, prep, 0, s>>>(rn, nr, Fn, rnorm);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int row_bytes = (Fn + 1 + W) * (int)sizeof(uint32_t);
  int tile = kSmemDefault / row_bytes;
  if (tile > kTile) tile = kTile;
  if (tile < 1) {
    if (row_bytes > kSmemMax) return (int)cudaErrorInvalidValue;
    tile = 1;
  }
  const int smem = tile * row_bytes;
  const int blocks = (nt + kThreads - 1) / kThreads;
  const int kcap = list_size(k);
  const bool reg = register_rows(Fn, Fc);
  if (metric == kEuclid) {
    err = reg ? launch_k<true, 0>(kcap, blocks, smem, s, tn, twords, rn,
                                  rwords, rnorm, nt, nr, Fn, W, k, tile,
                                  n_cat, denom, fscale, od, oi)
              : launch_k<false, 0>(kcap, blocks, smem, s, tn, twords, rn,
                                   rwords, rnorm, nt, nr, Fn, W, k, tile,
                                   n_cat, denom, fscale, od, oi);
  } else {
    err = reg ? launch_k<true, 1>(kcap, blocks, smem, s, tn, twords, rn,
                                  rwords, rnorm, nt, nr, Fn, W, k, tile,
                                  n_cat, denom, fscale, od, oi)
              : launch_k<false, 1>(kcap, blocks, smem, s, tn, twords, rn,
                                   rwords, rnorm, nt, nr, Fn, W, k, tile,
                                   n_cat, denom, fscale, od, oi);
  }
  return (int)err;
}
