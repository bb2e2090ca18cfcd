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
// global memory (its totals in a scratch row), with no size refused.
//
// What bounds it on the H100: operations.  Per pair Fn FMAs, the
// numerator's add, subtract, max and add (euclidean; manhattan: a
// subtract, absolute value and add per feature and one add), and an AND
// and a popcount per one-hot word; the bytes (the test and train rows
// once, the (nt, k) results) are small.  20,000 x 200,000 e-learning rows
// (Fn = 4) is 4e9 pairs, about 1 ms at 33.5 T float32 instructions/s.
//
// The train-sharded form (kernel B7, replacing ops/pallas/topk.py:128
// `topk_scan_sharded`) runs this scan once per shard of the train rows and
// merges the shards' lists with `avenir_topk_merge` below (a lane group a
// test row, one lane a list, k rounds of a shuffle argmin).
//
// Design, and what it does about that bound:
// - The block's 64 test rows sit in registers (numeric features up to 8,
//   one-hot words up to 2, zero-padded to 4 or 8 features and 0 or 2
//   words so every per-pair loop has a compile-time length; wider rows are
//   read from global memory); the block walks train rows in tiles staged
//   in shared memory (features, norm, one-hot words per row, padded
//   alike), every thread reading the same staged row at a time (a
//   broadcast).  A thread computes the totals of 4 pairs together.
// - The train axis is split over the grid's y dimension: block (x, s)
//   scans split s, a contiguous train range, and writes that range's
//   (nt, k) list (local indices, -1 dead) to scratch; one launch of
//   `avenir_topk_merge_stacked` below merges the splits.  The splits are ascending
//   contiguous ranges, which is the merge's tie rule, so the result equals
//   a single-range scan bit for bit.  One thread per test row alone gives
//   an 8,192-row chunk 128 blocks, about 2 warps an SM; kernels/topk.py
//   `split_ranges` picks enough splits for about 16 (from the SM count).
// - The tail (divide, square root, multiply, floor) runs only for pairs
//   that can enter the list.  Beside each slot the list keeps the raw
//   pre-division total (euclidean max(sq, 0) + mismatches, manhattan
//   sum + mismatches) of its entry; a pair whose total is >= the last
//   slot's total is skipped.  Exact: for denom > 0 and fscale >= 0 the
//   tail is monotone non-decreasing in the total (an IEEE divide by a
//   positive divisor, square root, multiply by fscale >= 0 and floor each
//   are), so such a pair's distance is >= the last slot's and the
//   strict-less insert would refuse it.  A NaN total fails the compare and
//   takes the full path.  The wrapper enables the skip only for those
//   constants.
// - The pairs that pass wait in a per-thread queue in shared memory; a
//   warp drains all its lanes' queues when one is nearly full, so the
//   rare tails and inserts run in few divergent sections instead of
//   stalling the warp at every pair where one lane needs them.
// - Measured on an H100 (PERF.md §6): about 14% of the operation bound at
//   20,000 x 200,000 rows.  Tried and slower: padding staged rows to
//   16-byte vector loads; 1, 2 or 8 pairs together instead of 4.  Left for
//   later: several test rows a thread (each staged train row reused) and
//   cp.async double-buffered tiles.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;        // test rows per block
constexpr int kTile = 256;          // train rows staged per tile, at most
constexpr int kRegFn = 8;           // numeric features held in registers
constexpr int kRegWords = 2;        // one-hot words held in registers
constexpr int kGroup = 4;           // pairs a thread takes together
constexpr int kQueue = 16;          // queued candidates a thread, at most
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

// Insert (d, idx, tot) into the ascending register list of K slots; the
// caller checked d < bd[K-1].  Slot j takes its left neighbour while that
// one is greater than d, the new entry where the left neighbour is <= d <
// bd[j], else stays.  bt holds each entry's pre-division total.
template <int K>
__device__ __forceinline__ void insert_reg(float (&bd)[K], int (&bi)[K],
                                           float (&bt)[K], float d, int idx,
                                           float tot) {
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    const int l = j > 0 ? j - 1 : 0;
    const float prev = j > 0 ? bd[l] : -INFINITY;
    if (prev > d) {
      bd[j] = prev;
      bi[j] = bi[l];
      bt[j] = bt[l];
    } else if (bd[j] > d) {
      bd[j] = d;
      bi[j] = idx;
      bt[j] = tot;
    }
  }
}

// K > 0: register list of K slots; K == 0: the list is the row's k slots of
// `od`/`oi` in global memory, with its totals in `ot`.  RF > 0: the test
// row's numeric features (RF of them, zero-padded) and one-hot words (RW,
// zero-padded) sit in registers and the staged train rows are padded
// alike, so the per-pair loops have compile-time lengths (a zero feature
// adds an exact 0 to the dot and to the manhattan sum, a zero word no
// match); RF == 0: widths at run time, the test row read from global
// memory.  Block (x, s) scans train rows [s * split_rows, min(nr, (s + 1)
// * split_rows)) and writes split s's list at od/oi + s * nt * k, indices
// local to the split.  skip: take the tail only for pairs whose total is
// below the last slot's.  Each thread computes the totals of kGroup pairs
// together (independent chains), then queues those that pass in train
// order; the dynamic shared memory holds the tile, then the queues.
template <int K, int RF, int RW, int METRIC>
__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ tn, const uint32_t* __restrict__ tw,
            const float* __restrict__ rn, const uint32_t* __restrict__ rw,
            const float* __restrict__ rnorm, int nt, int nr, int Fn, int W,
            int k, int tile, int split_rows, bool skip, float n_cat,
            float denom, float fscale, float* __restrict__ od,
            int* __restrict__ oi, float* __restrict__ ot) {
  extern __shared__ __align__(16) uint32_t stage[];
  constexpr bool REG = RF > 0;
  const int sF = REG ? RF : Fn;              // staged features a row
  const int sW = REG ? RW : W;               // staged one-hot words a row
  const int stride = sF + 1 + sW;            // features, norm, words
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = row < nt;
  const long long trow = active ? row : 0;
  const float* t_g = tn + trow * Fn;
  const uint32_t* tw_g = tw + trow * W;
  const int r0 = blockIdx.y * split_rows;
  const int r1 = min(nr, r0 + split_rows);
  const long long list_off = (long long)blockIdx.y * nt * k + trow * k;

  float t[REG ? RF : 1];                     // t, or 2t for euclidean
  uint32_t twr[RW > 0 ? RW : 1];
#pragma unroll
  for (int f = 0; f < (REG ? RF : 1); ++f) {
    const float v = (REG && active && f < Fn) ? t_g[f] : 0.f;
    t[f] = METRIC == kEuclid ? __fmul_rn(2.f, v) : v;
  }
#pragma unroll
  for (int w = 0; w < (RW > 0 ? RW : 1); ++w)
    twr[w] = (RW > 0 && active && w < W) ? tw_g[w] : 0u;
  float tnorm = 0.f;
  if (METRIC == kEuclid && active) {
    for (int f = 0; f < Fn; ++f) {
      const float v = t_g[f];
      tnorm = __fmaf_rn(v, v, tnorm);
    }
  }

  float bd[K > 0 ? K : 1];
  int bi[K > 0 ? K : 1];
  float bt[K > 0 ? K : 1];
#pragma unroll
  for (int j = 0; j < (K > 0 ? K : 1); ++j) {
    bd[j] = INFINITY;
    bi[j] = -1;
    bt[j] = INFINITY;
  }
  float* gd = od + list_off;
  int* gi = oi + list_off;
  float* gt = ot + list_off;
  float kth = INFINITY;                      // the global list's last slot
  float t_kth = INFINITY;                    // and its total
  if (K == 0 && active) {
    for (int j = 0; j < k; ++j) {
      gd[j] = INFINITY;
      gi[j] = -1;
      gt[j] = INFINITY;
    }
  }

  // the pre-division total of the test row and staged train row s, every
  // float32 op in the plain version's order
  auto pair_total = [&](const uint32_t* s) -> float {
    int match = 0;
    if (REG) {
#pragma unroll
      for (int w = 0; w < RW; ++w) match += __popc(twr[w] & s[RF + 1 + w]);
    } else {
      for (int w = 0; w < W; ++w) match += __popc(tw_g[w] & s[Fn + 1 + w]);
    }
    const float mis = __fsub_rn(n_cat, (float)match);
    if (METRIC == kEuclid) {
      float dot = 0.f;
      if (REG) {
#pragma unroll
        for (int f = 0; f < (REG ? RF : 1); ++f)
          dot = __fmaf_rn(t[f], __uint_as_float(s[f]), dot);
      } else {
        for (int f = 0; f < Fn; ++f)
          dot = __fmaf_rn(__fmul_rn(2.f, t_g[f]), __uint_as_float(s[f]),
                          dot);
      }
      const float sq = __fsub_rn(__fadd_rn(tnorm, __uint_as_float(s[sF])),
                                 dot);
      return __fadd_rn(fmaxf(sq, 0.f), mis);
    }
    float num = 0.f;
    if (REG) {
#pragma unroll
      for (int f = 0; f < (REG ? RF : 1); ++f)
        num = __fadd_rn(num, fabsf(__fsub_rn(t[f], __uint_as_float(s[f]))));
    } else {
      for (int f = 0; f < Fn; ++f)
        num = __fadd_rn(num, fabsf(__fsub_rn(t_g[f], __uint_as_float(s[f]))));
    }
    return __fadd_rn(num, mis);
  };

  // Candidates (pairs whose total is below the last slot's, or every pair
  // without the skip) wait in a per-thread queue in shared memory, in
  // train order; when one lane's queue is nearly full the warp drains all
  // its lanes' queues together, so the divide, square root and insert run
  // in few divergent sections.  A drain re-checks each total against the
  // list as it then stands.
  float* q_tot = reinterpret_cast<float*>(stage + tile * stride) +
                 threadIdx.x;
  int* q_idx = reinterpret_cast<int*>(q_tot - threadIdx.x +
                                      kQueue * kThreads) + threadIdx.x;
  int qn = 0;
  auto drain = [&]() {
    for (int j = 0; j < qn; ++j) {
      const float total = q_tot[j * kThreads];
      if (skip && total >= (K > 0 ? bt[K > 0 ? K - 1 : 0] : t_kth)) continue;
      const float mean = __fdiv_rn(total, denom);
      const float d =
          METRIC == kEuclid
              ? floorf(__fmul_rn(__fsqrt_rn(fmaxf(mean, 0.f)), fscale))
              : floorf(__fmul_rn(mean, fscale));
      const int idx = q_idx[j * kThreads];
      if (K > 0) {
        if (d < bd[K > 0 ? K - 1 : 0]) insert_reg(bd, bi, bt, d, idx, total);
      } else if (d < kth) {
        int q = k - 1;
        while (q > 0 && gd[q - 1] > d) {
          gd[q] = gd[q - 1];
          gi[q] = gi[q - 1];
          gt[q] = gt[q - 1];
          --q;
        }
        gd[q] = d;
        gi[q] = idx;
        gt[q] = total;
        kth = gd[k - 1];
        t_kth = gt[k - 1];
      }
    }
    qn = 0;
  };

  for (int base = r0; base < r1; base += tile) {
    const int cnt = min(tile, r1 - base);
    __syncthreads();
    for (int i = threadIdx.x; i < cnt * stride; i += blockDim.x) {
      const int r = i / stride;
      const int c = i - r * stride;
      const long long g = (long long)base + r;
      uint32_t v = 0u;
      if (c < sF) {
        if (c < Fn) v = __float_as_uint(rn[g * Fn + c]);
      } else if (c == sF) {
        v = METRIC == kEuclid ? __float_as_uint(rnorm[g]) : 0u;
      } else if (c - sF - 1 < W) {
        v = rw[g * W + (c - sF - 1)];
      }
      stage[i] = v;
    }
    __syncthreads();
    for (int r = 0; r < cnt; r += kGroup) {
      float tot[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        tot[j] = pair_total(stage + min(r + j, cnt - 1) * stride);
      const float last = K > 0 ? bt[K > 0 ? K - 1 : 0] : t_kth;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        // NaN totals fail the compare and are queued
        if (active && r + j < cnt && !(skip && tot[j] >= last)) {
          q_tot[qn * kThreads] = tot[j];
          q_idx[qn * kThreads] = base + r + j - r0;
          ++qn;
        }
      }
      if (__any_sync(0xffffffffu, qn > kQueue - kGroup)) drain();
    }
  }
  drain();
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

struct ScanArgs {
  const float* tn;
  const uint32_t* tw;
  const float* rn;
  const uint32_t* rw;
  const float* rnorm;
  int nt, nr, Fn, W, k, tile, split_rows;
  bool skip;
  float n_cat, denom, fscale;
  float* od;
  int* oi;
  float* ot;
};

template <int K, int RF, int RW, int METRIC>
cudaError_t launch_topk(dim3 grid, int smem, cudaStream_t s,
                        const ScanArgs& a) {
  auto kern = topk_kernel<K, RF, RW, METRIC>;
  if (smem > kSmemDefault) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, kThreads, smem, s>>>(a.tn, a.tw, a.rn, a.rw, a.rnorm, a.nt,
                                    a.nr, a.Fn, a.W, a.k, a.tile,
                                    a.split_rows, a.skip, a.n_cat, a.denom,
                                    a.fscale, a.od, a.oi, a.ot);
  return cudaGetLastError();
}

template <int RF, int RW, int METRIC>
cudaError_t launch_k(int kcap, dim3 grid, int smem, cudaStream_t s,
                     const ScanArgs& a) {
  switch (kcap) {
    case 8: return launch_topk<8, RF, RW, METRIC>(grid, smem, s, a);
    case 16: return launch_topk<16, RF, RW, METRIC>(grid, smem, s, a);
    case 32: return launch_topk<32, RF, RW, METRIC>(grid, smem, s, a);
    case 64: return launch_topk<64, RF, RW, METRIC>(grid, smem, s, a);
    default: return launch_topk<0, RF, RW, METRIC>(grid, smem, s, a);
  }
}

// The register-row widths (RF, RW) as launch_k's template arguments.
template <int METRIC>
cudaError_t launch_rows(int RF, int RW, int kcap, dim3 grid, int smem,
                        cudaStream_t s, const ScanArgs& a) {
  if (RF == 4) {
    return RW ? launch_k<4, kRegWords, METRIC>(kcap, grid, smem, s, a)
              : launch_k<4, 0, METRIC>(kcap, grid, smem, s, a);
  }
  if (RF == kRegFn) {
    return RW ? launch_k<kRegFn, kRegWords, METRIC>(kcap, grid, smem, s, a)
              : launch_k<kRegFn, 0, METRIC>(kcap, grid, smem, s, a);
  }
  return launch_k<0, 0, METRIC>(kcap, grid, smem, s, a);
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

// ---------------------------------------------------------------------------
// The top-k merge (kernel B7's merge, and the join of B5's train splits).
//
// Replaces the lexicographic k-selection of ops/pallas/topk.py:128
// `topk_scan_sharded` (its per-shard lists merged), and joins B5's split
// lists (`avenir_topk_scan` with splits > 1).  S lists a test row, each
// ascending by (d, local index) with its dead slots (index < 0) last, come
// from ascending contiguous train ranges; the merge keeps the row's k
// smallest (d, global index) pairs.  On equal d the lower list holds the
// lower global index, so taking the first list whose head is strictly
// smallest keeps the lexicographic order with no index compare.  A slot
// nothing fills, or whose distance is +inf, is (+inf, -1).
//
// What bounds it on the H100: bytes, S*k*8 read and k*8 written a row (4
// shards x 20,000 rows x k = 10: 8 MB, 0.0024 ms at 3.35 TB/s).
//
// Design (`topk_merge_warp_kernel`): a lane group of G = the next power of
// two >= S lanes a row (32 / G rows a warp; for S > 32 each lane holds two
// lists, s and s + 32).  Lane s keeps list s's cursor, its head (d, i) and
// the next entry, prefetched, in registers.  Each of the k rounds is a
// shuffle argmin over the key (d, s) inside the group: the distance's bits
// made order-preserving in the high word (-0 counted as +0, so equal
// distances tie), s in the low word, so the lower list wins a tie exactly
// as the first strictly smallest head does.  Lists whose cursor reached k,
// or whose head is dead, drop out with the largest key; a group with no
// live head writes (+inf, -1), and a +inf head writes index -1.  B5's lists
// hold no NaN (its insert is strict-less), and a NaN head would sort after
// +inf here.  The winning lane writes the slot and advances, loading the
// entry after its new head while the next rounds run.  Lists are read
// through two accessors: separate tensors (`ListArray`: the sharded path's
// lists gathered from shards) or one contiguous (S, nt, k) tensor
// (`ListStack`: B5's split lists, bases s * step).
//
// `topk_merge_kernel` below is the first port's merge (one thread a row,
// S dependent loads strided by k an output slot, cursors in local memory).
// It runs only when a caller forces it (`old`), to time the two designs
// against each other.
constexpr int kMaxShards = 64;

// Separate (nt, k) lists: distances, local train indices (-1 = dead slot)
// and each list's first global row; at most parallel/mesh.py MAX_SHARDS,
// as a DeviceMesh holds.  Passed by value (a kernel parameter).
struct ListArray {
  const float* d[kMaxShards];
  const int* i[kMaxShards];
  int base[kMaxShards];
  __device__ float dist(int s, long long at) const { return d[s][at]; }
  __device__ int index(int s, long long at) const { return i[s][at]; }
  __device__ int first(int s) const { return base[s]; }
};

// One contiguous (S, nt, k) pair of tensors; list s starts at global row
// s * step.
struct ListStack {
  const float* d;
  const int* i;
  long long plane;  // nt * k
  int step;
  __device__ float dist(int s, long long at) const {
    return d[s * plane + at];
  }
  __device__ int index(int s, long long at) const {
    return i[s * plane + at];
  }
  __device__ int first(int s) const { return s * step; }
};

constexpr unsigned long long kDeadKey = ~0ull;

// Order-preserving bits of a non-NaN float (-0 as +0).
__device__ __forceinline__ unsigned ordered(float d) {
  const unsigned u = __float_as_uint(d == 0.0f ? 0.0f : d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// One list's cursor a lane: the head (d, i) at `cur`, the next entry.
struct Head {
  float d, nd;
  int i, ni, cur;
};

template <class Lists>
__device__ __forceinline__ void head_init(Head& h, const Lists& L, int s,
                                          bool live, long long off, int k) {
  h.cur = 0;
  h.i = h.ni = -1;
  h.d = h.nd = INFINITY;
  if (!live) return;
  h.d = L.dist(s, off);
  h.i = L.index(s, off);
  if (k > 1) {
    h.nd = L.dist(s, off + 1);
    h.ni = L.index(s, off + 1);
  }
}

template <class Lists>
__device__ __forceinline__ void head_advance(Head& h, const Lists& L, int s,
                                             long long off, int k) {
  h.cur += 1;
  h.d = h.nd;
  h.i = h.ni;
  if (h.cur + 1 < k) {
    h.nd = L.dist(s, off + h.cur + 1);
    h.ni = L.index(s, off + h.cur + 1);
  } else {
    h.ni = -1;
  }
}

__device__ __forceinline__ unsigned long long head_key(const Head& h, int s) {
  return h.i >= 0 ? ((unsigned long long)ordered(h.d) << 32) | (unsigned)s
                  : kDeadKey;
}

// LG: log2 of the lanes a row (G = 1 << LG); for G = 32 a lane holds lists
// lane and lane + 32.
template <int LG, class Lists>
__global__ void topk_merge_warp_kernel(Lists L, int S, int nt, int k,
                                       float* __restrict__ od,
                                       int* __restrict__ oi) {
  constexpr int G = 1 << LG;
  constexpr int kRowsPerWarp = 32 / G;
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x)
                         >> 5;
  const long long row = warp * kRowsPerWarp + (lane >> LG);
  const int sub = lane & (G - 1);
  const bool row_ok = row < nt;
  const long long off = row * k;
  Head h0, h1;
  head_init(h0, L, sub, row_ok && sub < S, off, k);
  head_init(h1, L, sub + 32, G == 32 && row_ok && sub + 32 < S, off, k);
  for (int j = 0; j < k; ++j) {
    unsigned long long key = head_key(h0, sub);
    if (G == 32) key = min(key, head_key(h1, sub + 32));
#pragma unroll
    for (int o = G / 2; o >= 1; o >>= 1) {
      key = min(key, __shfl_xor_sync(0xffffffffu, key, o));
    }
    if (!row_ok) continue;
    if (key == kDeadKey) {
      if (sub == 0) {
        od[off + j] = INFINITY;
        oi[off + j] = -1;
      }
      continue;
    }
    const int ws = (int)(key & 0xffffffffu);
    if ((ws & 31) != sub) continue;
    const bool hi_list = G == 32 && ws >= 32;
    const float d = hi_list ? h1.d : h0.d;
    const int li = hi_list ? h1.i : h0.i;
    od[off + j] = d;
    oi[off + j] = isinf(d) ? -1 : li + L.first(ws);
    if (hi_list) {
      head_advance(h1, L, ws, off, k);
    } else {
      head_advance(h0, L, ws, off, k);
    }
  }
}

// The first port's merge, kept as a timing reference (see above).
template <class Lists>
__global__ void topk_merge_kernel(Lists L, int S, int nt, int k,
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
      const int li = L.index(s, off + cur[s]);
      if (li < 0) continue;
      const float d = L.dist(s, off + cur[s]);
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
      oi[off + j] = isinf(bd) ? -1 : bi + L.first(best);
      ++cur[best];
    }
  }
}

template <int LG, class Lists>
void launch_merge_warp(const Lists& L, int S, int nt, int k, float* od,
                       int* oi, cudaStream_t stream) {
  constexpr int kThreads = 256;
  constexpr int rows = (kThreads / 32) * (32 >> LG);
  topk_merge_warp_kernel<LG, Lists><<<(nt + rows - 1) / rows, kThreads, 0,
                                      stream>>>(L, S, nt, k, od, oi);
}

template <class Lists>
int launch_merge(const Lists& L, int S, int nt, int k, float* od, int* oi,
                 int old, void* stream) {
  if (S < 1 || S > kMaxShards || k < 1) return (int)cudaErrorInvalidValue;
  if (nt <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (old) {
    const int threads = 128;
    topk_merge_kernel<Lists><<<(nt + threads - 1) / threads, threads, 0, s>>>(
        L, S, nt, k, od, oi);
  } else if (S == 1) {
    launch_merge_warp<0>(L, S, nt, k, od, oi, s);
  } else if (S == 2) {
    launch_merge_warp<1>(L, S, nt, k, od, oi, s);
  } else if (S <= 4) {
    launch_merge_warp<2>(L, S, nt, k, od, oi, s);
  } else if (S <= 8) {
    launch_merge_warp<3>(L, S, nt, k, od, oi, s);
  } else if (S <= 16) {
    launch_merge_warp<4>(L, S, nt, k, od, oi, s);
  } else {
    launch_merge_warp<5>(L, S, nt, k, od, oi, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The top-k merge over separate lists (the train-sharded scan).  `d` and
// `i` are host arrays of S device pointers to each list's (nt, k) float32
// distances and int32 local indices (a shard's `avenir_topk_scan` output,
// gathered onto the current device), `base` the S lists' first global
// train rows, 1 <= S <= 64.  Outputs od (nt, k) float32, oi (nt, k) int32.
// old != 0 runs the first port's merge (timing only).  Launch on `stream`;
// returns cudaGetLastError() (0 = ok).
extern "C" int avenir_topk_merge(const float* const* d, const int* const* i,
                                 const int* base, int S, int nt, int k,
                                 float* od, int* oi, int old, void* stream) {
  if (S < 1 || S > kMaxShards) return (int)cudaErrorInvalidValue;
  ListArray L{};
  for (int s = 0; s < S; ++s) {
    L.d[s] = d[s];
    L.i[s] = i[s];
    L.base[s] = base[s];
  }
  return launch_merge(L, S, nt, k, od, oi, old, stream);
}

// The same merge over one contiguous (S, nt, k) pair (B5's split lists):
// list s's first global train row is s * step.
extern "C" int avenir_topk_merge_stacked(const float* d, const int* i,
                                         int step, int S, int nt, int k,
                                         float* od, int* oi, int old,
                                         void* stream) {
  ListStack L{d, i, (long long)nt * k, step};
  return launch_merge(L, S, nt, k, od, oi, old, stream);
}

// Launch on `stream`; returns cudaGetLastError() after the launches (0 = ok).
// tn (nt, Fn) float32, toh (nt, Fc) int8 0/1, rn (nr, Fn) float32, roh
// (nr, Fc) int8 0/1, all contiguous; nt, nr, k >= 1.  Scratch from the
// wrapper: twords (nt, W) and rwords (nr, W) uint32 with W = ceil(Fc / 32)
// (null when Fc == 0), rnorm (nr,) float32 (euclidean only, else null), ot
// (splits, nt, k) float32 when k > 64 (the global list's totals, else
// null).  The train rows are scanned in `splits` contiguous ranges of
// `split_rows` rows (the last shorter, none empty); outputs od (splits, nt,
// k) float32 and oi (splits, nt, k) int32, each split's list with indices
// local to its range (one split: the result itself).  metric 0 =
// euclidean, 1 = manhattan.  skip != 0 takes the tail only for pairs that
// can enter the list (exact for denom > 0 and fscale >= 0; the wrapper
// decides).
extern "C" int avenir_topk_scan(const float* tn, const int8_t* toh,
                                const float* rn, const int8_t* roh, int nt,
                                int nr, int Fn, int Fc, int k, int metric,
                                float n_cat, float denom, float fscale,
                                int splits, int split_rows, int skip,
                                uint32_t* twords, uint32_t* rwords,
                                float* rnorm, float* ot, float* od, int* oi,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > 65535 || split_rows < 1 ||
      (long long)(splits - 1) * split_rows >= nr)
    return (int)cudaErrorInvalidValue;
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

  // register rows: features padded to 4 or kRegFn, words to 0 or
  // kRegWords (staged alike); else the run-time widths
  const bool reg = register_rows(Fn, Fc);
  const int RF = reg ? (Fn <= 4 ? 4 : kRegFn) : 0;
  const int RW = reg && W > 0 ? kRegWords : 0;
  const int row_bytes =
      (reg ? RF + 1 + RW : Fn + 1 + W) * (int)sizeof(uint32_t);
  // the staged tile, then each thread's candidate queue (total, index)
  const int queue_bytes = kQueue * kThreads * 8;
  int tile = (kSmemDefault - queue_bytes) / row_bytes;
  if (tile > kTile) tile = kTile;
  if (tile < 1) {
    if (row_bytes + queue_bytes > kSmemMax) return (int)cudaErrorInvalidValue;
    tile = 1;
  }
  const int smem = tile * row_bytes + queue_bytes;
  const dim3 grid((nt + kThreads - 1) / kThreads, splits);
  const int kcap = list_size(k);
  const ScanArgs a{tn, twords, rn, rwords, rnorm, nt, nr, Fn, W, k, tile,
                   split_rows, skip != 0, n_cat, denom, fscale, od, oi, ot};
  err = metric == kEuclid
            ? launch_rows<kEuclid>(RF, RW, kcap, grid, smem, s, a)
            : launch_rows<1>(RF, RW, kcap, grid, smem, s, a);
  return (int)err;
}
