// Forest ensemble vote on Hopper (sm_90a): float, int8, and the tree-sharded
// form.
//
// Replaces three TPU kernels with one template over the value type:
//   ops/pallas/vote.py:119 `ensemble_vote` (body models/forest.py
//     `_ensemble_vote_body` = `_member_votes_body` + `_vote_finalize`):
//     float32 values and thresholds, int32 codes (`avenir_ensemble_vote`);
//   ops/pallas/vote.py:129 `quantized_vote` (body serving/quantized.py
//     `_quantized_vote_body`): int8-binned values and thresholds compared
//     as int32, int8 codes (`avenir_quantized_vote`);
//   ops/pallas/vote.py:73 `ensemble_partial_votes` (body
//     `_member_votes_body`): the float form over one tree shard, writing the
//     row's (K,) float32 tally instead of finalizing
//     (`avenir_ensemble_partial_votes`).  The tree-sharded serve's `psum` +
//     `_vote_finalize` (serving/predictor.py:437-438) is
//     `avenir_vote_merge_finalize`: the S shards' tallies, gathered onto one
//     device, summed in shard order, then the same finalize.
// For every row: per tree, the first of P stacked paths whose predicates
// all hold; add the tree's weight to that path's class; then the first-max
// argmax with the min-odds veto (index K).
//
// Predicate semantics (avenir_tpu/models/tree.py `_match_ok`):
//   numeric      lo < v <= hi, tested only where the num flag is set, so a
//                NaN fails a restricted feature and nothing else;
//   categorical  code >= 0 && mask[t,p,f,min(code, C-1)], tested only where
//                the cat flag is set (codes >= C take the last mask bit,
//                as the reference's clip does);
//   pad paths    lo = +inf with the num flag set: they never match.
// The int8 form keeps these through its grid's sentinels: a NaN or -inf
// value is -128, which no restricted interval admits (v > lo fails even
// against lo = -128); +inf clips to 127; a pad path has lo = 127, which no
// int8 value exceeds.
// A tree whose P paths all fail votes with path 0, as the reference's
// argmax over an all-false row does.  Stacked forests end every tree with
// an always-match sentinel, so that case only arises for hand-made inputs.
// A shard's pad members (zero weight, no class, never matching) add 0.
//
// Exactness: tallies are sums of integer-valued float32 weights below 2^24
// (EnsembleModel.stacked_host rejects anything else), so every summation
// order gives the same bits: the (n,) int32 result is bit-identical to the
// reference, a shard's tally to the plain version's, and the merged vote to
// the unsharded one.  The veto divides top / max(second, 1e-12f) with IEEE
// float32 division: build without --use_fast_math.
//
// What bounds it on the H100: each row reads its F values and F codes and
// writes one int32 — (8F + 4) bytes a row in float, 36 B at the published
// forest's F = 4, and (2F + 4) bytes in int8, 12 B (36 MB and 12 MB, ~11
// and ~3.6 us of HBM traffic at 3.35 TB/s for a million rows).  A shard's
// partial writes K floats a row instead of one int32; the merge reads S*K
// floats a row and writes one int32.  The work a row needs is small next
// to that only if the first-match search is; the path scan below runs up
// to T*P*F data-dependent tests a row (612 at T = 9, P = 17, F = 4), and a
// warp's lanes diverge on every tree.
//
// Design, two forms of one template, chosen by the wrapper from the shape
// (kernels/vote.py `vote_form`):
// - table: per-feature path-mask tables, built once per prepared model on
//   the host (kernels/vote.py `table_form`).  For feature f, u_f holds the
//   sorted distinct lo/hi thresholds of the slots whose numeric flag is set
//   (+inf padded to a power of two); a value's bin is b = #{u_f < v}, NaN
//   takes bin NB-1.  N[t, f, b] is a mask of the tree's paths (PW 32-bit
//   words): bit p set iff slot (t, p, f) is numerically unrestricted or
//   idx(lo) < b <= idx(hi), which is lo < v <= hi for every non-NaN v; the
//   NaN bin admits only unrestricted slots.  Cm[t, f, c] likewise for code
//   c (bin C: a code < 0; codes >= C use C-1).  A tree's first match is the
//   lowest set bit of AND_f N[t, f, b_f] & Cm[t, f, c_f], path 0 when none
//   is set.  A row costs one branch-free binary search per feature in
//   shared memory, T*F*PW table loads and ANDs and one __ffs a tree, with
//   no divergent scan; rows load as 16-byte vectors when F % 4 == 0, and
//   the row's features sit in 4, 8 or 16 registers (a compile-time count).
//   The int8 form bins its int8 values (exact in float) the same way.
//   Taken when the tables fit in 48 KB of shared memory and F <= kFMax:
//   the published forests (T = 9, P = 17, F = 4) need a few KB.  The grid
//   is one block per resident slot, so each block stages the tables once.
// - scan: each thread walks trees and paths with early exits, reading the
//   predicate tensors from shared memory when they fit in 48 KB, from
//   global memory (through L1/L2) when they do not, so a wide forest still
//   runs.
// Both keep the (K,) tally in registers (a compile-time KMAX loop with
// predicated adds, no runtime index) for K <= 32, in a global scratch row
// above; the finalize and the merge-finalize read it the same way.  One
// thread a row, grid-stride.  The sharded serve pays S partial launches and
// one merge launch a batch, and writes the (n,K) tallies through device
// memory between them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// parallel/mesh.py MAX_SHARDS: a DeviceMesh holds no more shards
constexpr int kMaxShards = 64;
constexpr unsigned char kNumFlag = 1;
constexpr unsigned char kCatFlag = 2;
// features a row the table form holds in registers (kernels/vote.py
// TABLE_MAX_F)
constexpr int kFMax = 16;
// the kernel's forms
constexpr int kScanGlobal = 0;  // path scan, predicates from global memory
constexpr int kScanSmem = 1;    // path scan, predicates staged in smem
constexpr int kTable = 2;       // path-mask tables staged in smem

template <typename V>
struct Preds {
  const V* lo;                // (T,P,F)
  const V* hi;                // (T,P,F)
  const unsigned int* catw;   // (T,P,F,W) allowed-code bitmask words
  const int* cls;             // (T,P) class index, -1 = votes nothing
  const float* w;             // (T,)
  const unsigned char* flags; // (T,P,F) kNumFlag | kCatFlag
};

// The table form's arrays (kernels/vote.py `table_form`).
struct Tables {
  const float* u;             // (F,L) sorted thresholds, +inf padded
  const unsigned int* ntab;   // (T,F,NB,PW) numeric path masks
  const unsigned int* ctab;   // (T,F,C+1,PW) categorical path masks
  int L, NB, PW;
};

// The shards' (n,K) float32 tallies, by value (a kernel parameter).
struct Partials {
  const float* p[kMaxShards];
};

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };
template <> struct Vec4<int8_t> { using type = char4; };

// First-max argmax of the (K,) tally, or K when the min-odds veto holds
// (`_vote_finalize`): the one finalize of the float, int8 and merged
// votes.  KMAX > 0: a register tally (constant indices only); KMAX == 0:
// the tally in a global scratch row.
template <int KMAX>
__device__ __forceinline__ int vote_finalize(const float* tally, int K,
                                             float min_odds) {
  int best = 0;
  float top = tally[0];
  float second = -INFINITY;
  if (KMAX > 0) {
#pragma unroll
    for (int k = 1; k < (KMAX > 0 ? KMAX : 1); ++k) {
      if (k < K && tally[k] > top) {
        top = tally[k];
        best = k;
      }
    }
#pragma unroll
    for (int k = 0; k < (KMAX > 0 ? KMAX : 1); ++k) {
      if (k < K && k != best) second = fmaxf(second, tally[k]);
    }
  } else {
    for (int k = 1; k < K; ++k) {
      if (tally[k] > top) {
        top = tally[k];
        best = k;
      }
    }
    for (int k = 0; k < K; ++k) {
      if (k != best) second = fmaxf(second, tally[k]);
    }
  }
  const bool veto =
      (min_odds > 1.0f) && (top / fmaxf(second, 1e-12f) <= min_odds);
  return veto ? K : best;
}

// tally[k] += w for 0 <= k < K, as KMAX predicated adds (a register tally
// keeps constant indices); k < 0 adds nothing.  Exact in any order: the
// tallies are integer-valued float32 below 2^24.
template <int KMAX>
__device__ __forceinline__ void tally_add(float (&tally)[KMAX], int k,
                                          float w) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) tally[j] += (j == k) ? w : 0.0f;
}

// The row's F values and codes into registers (f < F of FM), as 4-wide
// vector loads when `vec` (F % 4 == 0 and both rows aligned).
template <int FM, typename V, typename CT>
__device__ __forceinline__ void load_row(const V* __restrict__ vals,
                                         const CT* __restrict__ codes,
                                         long long row, int F, bool vec,
                                         float (&x)[FM], int (&c)[FM]) {
  const V* v = vals + row * F;
  const CT* cc = codes + row * F;
  if (vec) {
    using VV = typename Vec4<V>::type;
    using VC = typename Vec4<CT>::type;
#pragma unroll
    for (int q = 0; q < FM / 4; ++q) {
      if (4 * q < F) {
        const VV a = reinterpret_cast<const VV*>(v)[q];
        const VC b = reinterpret_cast<const VC*>(cc)[q];
        x[4 * q] = (float)a.x;
        x[4 * q + 1] = (float)a.y;
        x[4 * q + 2] = (float)a.z;
        x[4 * q + 3] = (float)a.w;
        c[4 * q] = (int)b.x;
        c[4 * q + 1] = (int)b.y;
        c[4 * q + 2] = (int)b.z;
        c[4 * q + 3] = (int)b.w;
      }
    }
  } else {
#pragma unroll
    for (int f = 0; f < FM; ++f) {
      if (f < F) {
        x[f] = (float)v[f];
        c[f] = (int)cc[f];
      }
    }
  }
}

// The table form's first matching path of every tree of one row: the
// row's table offsets from one binary search per feature, then per tree
// the AND of F numeric and F categorical masks, word by word, and the
// lowest set bit (path 0 when none is set).  Calls vote(t, hit) per tree.
// FM >= F: the features a row holds in registers (4, 8 or kFMax).
template <int FM, typename V, typename CT, typename Vote>
__device__ __forceinline__ void table_matches(
    const V* __restrict__ vals, const CT* __restrict__ codes, long long row,
    int F, bool vec, const Tables& tb, int T, int C, Vote vote) {
  float x[FM];
  int c[FM];
  load_row<FM>(vals, codes, row, F, vec, x, c);
  const int L = tb.L, NB = tb.NB, PW = tb.PW;
  int noff[FM], coff[FM];
#pragma unroll
  for (int f = 0; f < FM; ++f) {
    if (f < F) {
      const float v = x[f];
      int b = NB - 1;                      // the NaN bin
      if (v == v) {
        const float* uf = tb.u + f * L;
        b = 0;
        for (int step = L >> 1; step > 0; step >>= 1)
          b += (uf[b + step - 1] < v) ? step : 0;
      }
      noff[f] = (f * NB + b) * PW;
      const int code = c[f];
      coff[f] = (f * (C + 1) + (code < 0 ? C : min(code, C - 1))) * PW;
    }
  }
  const int nstride = F * NB * PW, cstride = F * (C + 1) * PW;
  for (int t = 0; t < T; ++t) {
    const unsigned int* nt = tb.ntab + t * nstride;
    const unsigned int* ct = tb.ctab + t * cstride;
    int hit = 0;
    for (int w = 0; w < PW; ++w) {
      unsigned int m = ~0u;
#pragma unroll
      for (int f = 0; f < FM; ++f)
        if (f < F) m &= nt[noff[f] + w] & ct[coff[f] + w];
      if (m) {
        hit = w * 32 + __ffs(m) - 1;
        break;
      }
    }
    vote(t, hit);
  }
}

// The scan form's first matching path of tree t (path 0 when none does).
// Predicate semantics (avenir_tpu/models/tree.py `_match_ok`) as in the
// note at the top.
template <typename V, typename CT>
__device__ __forceinline__ int scan_match(const V* __restrict__ v,
                                          const CT* __restrict__ c,
                                          const Preds<V>& p, int t, int P,
                                          int F, int C, int W) {
  for (int q = 0; q < P; ++q) {
    const int base = (t * P + q) * F;
    bool ok = true;
    for (int f = 0; f < F && ok; ++f) {
      const unsigned char fl = p.flags[base + f];
      if (fl & kNumFlag) {
        // int8 operands promote to int: the reference's int32 compare
        const V x = v[f];
        ok = (x > p.lo[base + f]) && (x <= p.hi[base + f]);
      }
      if (ok && (fl & kCatFlag)) {
        const int code = c[f];
        if (code < 0) {
          ok = false;
        } else {
          const int s = code < C ? code : C - 1;
          ok = (p.catw[(long long)(base + f) * W + (s >> 5)] >> (s & 31)) &
               1u;
        }
      }
    }
    if (ok) return q;
  }
  return 0;  // no match -> path 0, as argmax of an all-false row
}

// Blocks for n rows: one thread a row, at most `per_sm` blocks an SM of the
// current device (grid-stride beyond).
int row_blocks(long long n, int per_sm) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long want = (n + kThreads - 1) / kThreads;
  long long cap = (long long)sms * per_sm;
  return (int)(want < cap ? want : cap);
}

// V: value/threshold type (float or int8_t), CT: code type (int or int8_t).
// KMAX > 0: the tally lives in KMAX registers; KMAX == 0: in
// scratch[row*K .. row*K+K).  FORM: kTable stages the tables, class
// indices and weights (4-byte words: u, ntab, ctab, cls, w) into dynamic
// shared memory; kScanSmem stages the predicates (mask words, class
// indices, weights, then lo, hi and the flag bytes); kScanGlobal reads
// them from global memory.  PARTIAL: the tally is the result, written to
// scratch (n,K), no finalize.  FM: the table form's register features.
template <typename V, typename CT, int KMAX, int FORM, bool PARTIAL,
          int FM = kFMax>
__global__ void __launch_bounds__(kThreads)
vote_kernel(const V* __restrict__ vals, const CT* __restrict__ codes,
            long long n, int F, bool vec, Preds<V> g, Tables tb, int T,
            int P, int C, int W, int K, float min_odds,
            float* __restrict__ scratch, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Preds<V> p = g;
  if constexpr (FORM == kScanSmem) {
    const int tpf = T * P * F;
    unsigned int* s_cw = reinterpret_cast<unsigned int*>(smem);
    int* s_cls = reinterpret_cast<int*>(s_cw + (long long)tpf * W);
    float* s_w = reinterpret_cast<float*>(s_cls + T * P);
    V* s_lo = reinterpret_cast<V*>(s_w + T);
    V* s_hi = s_lo + tpf;
    unsigned char* s_fl = reinterpret_cast<unsigned char*>(s_hi + tpf);
    for (int i = threadIdx.x; i < tpf; i += blockDim.x) {
      s_lo[i] = g.lo[i];
      s_hi[i] = g.hi[i];
      s_fl[i] = g.flags[i];
    }
    for (int i = threadIdx.x; i < tpf * W; i += blockDim.x) s_cw[i] = g.catw[i];
    for (int i = threadIdx.x; i < T * P; i += blockDim.x) s_cls[i] = g.cls[i];
    for (int i = threadIdx.x; i < T; i += blockDim.x) s_w[i] = g.w[i];
    __syncthreads();
    p = Preds<V>{s_lo, s_hi, s_cw, s_cls, s_w, s_fl};
  }
  Tables tab = tb;
  if constexpr (FORM == kTable) {
    const int nu = F * tb.L;
    const int nn = T * F * tb.NB * tb.PW;
    const int nc = T * F * (C + 1) * tb.PW;
    float* s_u = reinterpret_cast<float*>(smem);
    unsigned int* s_n = reinterpret_cast<unsigned int*>(s_u + nu);
    unsigned int* s_c = s_n + nn;
    int* s_cls = reinterpret_cast<int*>(s_c + nc);
    float* s_w = reinterpret_cast<float*>(s_cls + T * P);
    for (int i = threadIdx.x; i < nu; i += blockDim.x) s_u[i] = tb.u[i];
    for (int i = threadIdx.x; i < nn; i += blockDim.x) s_n[i] = tb.ntab[i];
    for (int i = threadIdx.x; i < nc; i += blockDim.x) s_c[i] = tb.ctab[i];
    for (int i = threadIdx.x; i < T * P; i += blockDim.x) s_cls[i] = g.cls[i];
    for (int i = threadIdx.x; i < T; i += blockDim.x) s_w[i] = g.w[i];
    __syncthreads();
    tab.u = s_u;
    tab.ntab = s_n;
    tab.ctab = s_c;
    p.cls = s_cls;
    p.w = s_w;
  }

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += stride) {
    float local[KMAX > 0 ? KMAX : 1];
    float* gtally = scratch + row * K;
#pragma unroll
    for (int j = 0; j < (KMAX > 0 ? KMAX : 1); ++j) local[j] = 0.0f;
    if (KMAX == 0) {
      for (int k = 0; k < K; ++k) gtally[k] = 0.0f;
    }
    auto vote = [&](int t, int hit) {
      const int k = p.cls[t * P + hit];
      if (KMAX > 0) {
        tally_add(local, k, p.w[t]);
      } else if (k >= 0) {
        gtally[k] += p.w[t];
      }
    };
    if constexpr (FORM == kTable) {
      table_matches<FM>(vals, codes, row, F, vec, tab, T, C, vote);
    } else {
      const V* v = vals + row * F;
      const CT* c = codes + row * F;
      for (int t = 0; t < T; ++t) vote(t, scan_match(v, c, p, t, P, F, C, W));
    }
    if (PARTIAL) {
      if (KMAX > 0) {
#pragma unroll
        for (int j = 0; j < (KMAX > 0 ? KMAX : 1); ++j)
          if (j < K) scratch[row * K + j] = local[j];
      }
    } else {
      out[row] = KMAX > 0 ? vote_finalize<KMAX>(local, K, min_odds)
                          : vote_finalize<0>(gtally, K, min_odds);
    }
  }
}

// The table form over F <= FM features: one block per resident slot of
// the device (each stages the tables once, then walks rows grid-stride).
template <typename V, typename CT, int KMAX, bool PARTIAL, int FM>
cudaError_t launch_table(size_t smem_bytes, long long n, cudaStream_t stream,
                         const V* vals, const CT* codes, int F, bool vec,
                         Preds<V> g, Tables tb, int T, int P, int C, int W,
                         int K, float min_odds, float* scratch, int* out) {
  auto kern = vote_kernel<V, CT, KMAX, kTable, PARTIAL, FM>;
  int per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                smem_bytes);
  const int blocks = row_blocks(n, per_sm > 0 ? per_sm : 1);
  kern<<<blocks, kThreads, smem_bytes, stream>>>(
      vals, codes, n, F, vec, g, tb, T, P, C, W, K, min_odds, scratch, out);
  return cudaGetLastError();
}

template <typename V, typename CT, int KMAX, bool PARTIAL>
cudaError_t launch(int form, size_t smem_bytes, long long n,
                   cudaStream_t stream, const V* vals, const CT* codes,
                   int F, bool vec, Preds<V> g, Tables tb, int T, int P,
                   int C, int W, int K, float min_odds, float* scratch,
                   int* out) {
  if (form == kTable) {
    if (F <= 4)
      return launch_table<V, CT, KMAX, PARTIAL, 4>(
          smem_bytes, n, stream, vals, codes, F, vec, g, tb, T, P, C, W, K,
          min_odds, scratch, out);
    if (F <= 8)
      return launch_table<V, CT, KMAX, PARTIAL, 8>(
          smem_bytes, n, stream, vals, codes, F, vec, g, tb, T, P, C, W, K,
          min_odds, scratch, out);
    return launch_table<V, CT, KMAX, PARTIAL, kFMax>(
        smem_bytes, n, stream, vals, codes, F, vec, g, tb, T, P, C, W, K,
        min_odds, scratch, out);
  }
  const int blocks = row_blocks(n, 16);
  if (form == kScanSmem) {
    vote_kernel<V, CT, KMAX, kScanSmem, PARTIAL>
        <<<blocks, kThreads, smem_bytes, stream>>>(
            vals, codes, n, F, vec, g, tb, T, P, C, W, K, min_odds, scratch,
            out);
  } else {
    vote_kernel<V, CT, KMAX, kScanGlobal, PARTIAL>
        <<<blocks, kThreads, 0, stream>>>(vals, codes, n, F, vec, g, tb, T,
                                          P, C, W, K, min_odds, scratch, out);
  }
  return cudaGetLastError();
}

template <typename V, typename CT, bool PARTIAL>
int run_vote(const V* vals, const CT* codes, long long n, int F, const V* lo,
             const V* hi, const unsigned char* flags,
             const unsigned int* catw, const int* cls, const float* wvec,
             const float* u, const unsigned int* ntab,
             const unsigned int* ctab, int T, int P, int C, int W, int K,
             int L, int NB, int PW, float min_odds, float* scratch, int* out,
             int use_smem, long long smem_bytes, void* stream) {
  if (n <= 0) return 0;
  const bool table = ntab != nullptr;
  if (table && (F > kFMax || !use_smem || L < 1 || (L & (L - 1)) != 0 ||
                NB < 2 || PW < 1))
    return (int)cudaErrorInvalidValue;
  Preds<V> g{lo, hi, catw, cls, wvec, flags};
  Tables tb{u, ntab, ctab, L, NB, PW};
  const bool vec = F % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(vals) % (4 * sizeof(V)) == 0 &&
                   reinterpret_cast<uintptr_t>(codes) % (4 * sizeof(CT)) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int form = table ? kTable : use_smem ? kScanSmem : kScanGlobal;
  const size_t sb = (size_t)smem_bytes;
  cudaError_t err;
  if (K <= 8) {
    err = launch<V, CT, 8, PARTIAL>(form, sb, n, s, vals, codes, F,
                                    vec, g, tb, T, P, C, W, K, min_odds,
                                    scratch, out);
  } else if (K <= 32) {
    err = launch<V, CT, 32, PARTIAL>(form, sb, n, s, vals, codes, F,
                                     vec, g, tb, T, P, C, W, K, min_odds,
                                     scratch, out);
  } else {
    err = launch<V, CT, 0, PARTIAL>(form, sb, n, s, vals, codes, F,
                                    vec, g, tb, T, P, C, W, K, min_odds,
                                    scratch, out);
  }
  return (int)err;
}

// Sum the S shards' (K,) tallies of a row in shard order, then finalize.
// KMAX as in vote_kernel (KMAX == 0: the summed tally in scratch).
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
merge_finalize_kernel(Partials parts, int S, long long n, int K,
                      float min_odds, float* __restrict__ scratch,
                      int* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += stride) {
    if (KMAX > 0) {
      float tally[KMAX > 0 ? KMAX : 1];
#pragma unroll
      for (int k = 0; k < (KMAX > 0 ? KMAX : 1); ++k) {
        if (k < K) {
          float sum = parts.p[0][row * K + k];
          for (int q = 1; q < S; ++q) sum += parts.p[q][row * K + k];
          tally[k] = sum;
        } else {
          tally[k] = 0.0f;
        }
      }
      out[row] = vote_finalize<KMAX>(tally, K, min_odds);
    } else {
      float* tally = scratch + row * K;
      for (int k = 0; k < K; ++k) {
        float sum = parts.p[0][row * K + k];
        for (int q = 1; q < S; ++q) sum += parts.p[q][row * K + k];
        tally[k] = sum;
      }
      out[row] = vote_finalize<0>(tally, K, min_odds);
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// The predicate arguments come from the wrapper (kernels/vote.py
// `_model_args`): the scan form's lo, hi, flags, mask words, classes and
// weights, and the table form's u (F, L), ntab (T, F, NB, PW) and ctab (T,
// F, C+1, PW) — null ntab takes the scan form.  `use_smem` / `smem_bytes`
// size the staged predicates or tables (the table form needs them staged);
// `scratch` is an (n, K) float buffer when K > 32, else unused.
extern "C" int avenir_ensemble_vote(
    const float* vals, const int* codes, long long n, int F,
    const float* lo, const float* hi, const unsigned char* flags,
    const unsigned int* catw, const int* cls, const float* wvec,
    const float* u, const unsigned int* ntab, const unsigned int* ctab,
    int T, int P, int C, int W, int K, int L, int NB, int PW,
    float min_odds, float* scratch, int* out, int use_smem,
    long long smem_bytes, void* stream) {
  return run_vote<float, int, false>(
      vals, codes, n, F, lo, hi, flags, catw, cls, wvec, u, ntab, ctab, T, P,
      C, W, K, L, NB, PW, min_odds, scratch, out, use_smem, smem_bytes,
      stream);
}

// The int8 form: the same arguments with int8 values, codes and thresholds.
extern "C" int avenir_quantized_vote(
    const int8_t* qvals, const int8_t* qcodes, long long n, int F,
    const int8_t* q_lo, const int8_t* q_hi, const unsigned char* flags,
    const unsigned int* catw, const int* cls, const float* wvec,
    const float* u, const unsigned int* ntab, const unsigned int* ctab,
    int T, int P, int C, int W, int K, int L, int NB, int PW,
    float min_odds, float* scratch, int* out, int use_smem,
    long long smem_bytes, void* stream) {
  return run_vote<int8_t, int8_t, false>(
      qvals, qcodes, n, F, q_lo, q_hi, flags, catw, cls, wvec, u, ntab, ctab,
      T, P, C, W, K, L, NB, PW, min_odds, scratch, out, use_smem, smem_bytes,
      stream);
}

// One tree shard's partial tallies: the float form's arguments without
// min_odds, writing the (n, K) float32 `partial` (no finalize).
extern "C" int avenir_ensemble_partial_votes(
    const float* vals, const int* codes, long long n, int F,
    const float* lo, const float* hi, const unsigned char* flags,
    const unsigned int* catw, const int* cls, const float* wvec,
    const float* u, const unsigned int* ntab, const unsigned int* ctab,
    int T, int P, int C, int W, int K, int L, int NB, int PW,
    float* partial, int use_smem, long long smem_bytes, void* stream) {
  return run_vote<float, int, true>(
      vals, codes, n, F, lo, hi, flags, catw, cls, wvec, u, ntab, ctab, T, P,
      C, W, K, L, NB, PW, 1.0f, partial, nullptr, use_smem, smem_bytes,
      stream);
}

// The merge: `partials` is a host array of S device pointers to (n, K)
// float32 tallies on the current device, 1 <= S <= 64; `scratch` is an
// (n, K) float buffer when K > 32, else unused; `out` (n,) int32.
extern "C" int avenir_vote_merge_finalize(const float* const* partials,
                                          int S, long long n, int K,
                                          float min_odds, float* scratch,
                                          int* out, void* stream) {
  if (S < 1 || S > kMaxShards || K < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Partials parts{};
  for (int q = 0; q < S; ++q) parts.p[q] = partials[q];
  const int blocks = row_blocks(n, 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 8) {
    merge_finalize_kernel<8><<<blocks, kThreads, 0, s>>>(parts, S, n, K,
                                                         min_odds, scratch, out);
  } else if (K <= 32) {
    merge_finalize_kernel<32><<<blocks, kThreads, 0, s>>>(
        parts, S, n, K, min_odds, scratch, out);
  } else {
    merge_finalize_kernel<0><<<blocks, kThreads, 0, s>>>(parts, S, n, K,
                                                         min_odds, scratch, out);
  }
  return (int)cudaGetLastError();
}
