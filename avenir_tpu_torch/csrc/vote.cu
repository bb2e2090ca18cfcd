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
// forest's F = 4, and (2F + 4) bytes in int8, 12 B — against at most T*P*F
// predicate tests a row, fewer with the early exits (36 MB and 12 MB, ~11
// and ~3.6 us of HBM traffic at 3.35 TB/s for a million rows).  A shard's
// partial writes K floats a row instead of one int32; the merge reads S*K
// floats a row and writes one int32.  The predicate tensors are a few KB
// (thresholds take 4 bytes a slot in float, 1 in int8) and are read from
// shared memory when they fit in 48 KB, from global memory (through L1/L2)
// when they do not, so a wide forest still runs.
//
// Design (simple and right first): one thread per row, grid-stride over
// rows; each thread walks trees and paths with early exits and keeps its
// (K,) tally in local memory (K <= 32) or in a global scratch row.  What
// it leaves on the table: row loads are strided by F (not coalesced),
// threads of a warp diverge on the data-dependent path scans, and the
// tally sits in local memory instead of registers.  A faster form would
// stage row tiles through shared memory, give a warp one row and its
// lanes the paths of a tree, and keep the tally in registers.  The sharded
// serve pays S partial launches and one merge launch a batch, and writes
// the (n,K) tallies through device memory between them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// parallel/mesh.py MAX_SHARDS: a DeviceMesh holds no more shards
constexpr int kMaxShards = 64;
constexpr unsigned char kNumFlag = 1;
constexpr unsigned char kCatFlag = 2;

template <typename V>
struct Preds {
  const V* lo;                // (T,P,F)
  const V* hi;                // (T,P,F)
  const unsigned int* catw;   // (T,P,F,W) allowed-code bitmask words
  const int* cls;             // (T,P) class index, -1 = votes nothing
  const float* w;             // (T,)
  const unsigned char* flags; // (T,P,F) kNumFlag | kCatFlag
};

// The shards' (n,K) float32 tallies, by value (a kernel parameter).
struct Partials {
  const float* p[kMaxShards];
};

// First-max argmax of the (K,) tally, or K when the min-odds veto holds
// (`_vote_finalize`): the one finalize of the float, int8 and merged votes.
__device__ __forceinline__ int vote_finalize(const float* tally, int K,
                                             float min_odds) {
  int best = 0;
  float top = tally[0];
  for (int k = 1; k < K; ++k) {
    if (tally[k] > top) {
      top = tally[k];
      best = k;
    }
  }
  float second = -INFINITY;
  for (int k = 0; k < K; ++k) {
    if (k != best) second = fmaxf(second, tally[k]);
  }
  const bool veto = (min_odds > 1.0f) && (top / fmaxf(second, 1e-12f) <= min_odds);
  return veto ? K : best;
}

// V: value/threshold type (float or int8_t), CT: code type (int or int8_t).
// KMAX > 0: the tally lives in a per-thread array of KMAX floats;
// KMAX == 0: in scratch[row*K .. row*K+K).  SMEM: predicates staged into
// dynamic shared memory by every block before its rows, 4-byte words first
// (mask words, class indices, weights), then lo, hi and the flag bytes.
// PARTIAL: the tally is the result, written to scratch (n,K), no finalize.
template <typename V, typename CT, int KMAX, bool SMEM, bool PARTIAL>
__global__ void vote_kernel(const V* __restrict__ vals,
                            const CT* __restrict__ codes, long long n,
                            int F, Preds<V> g, int T, int P, int C, int W,
                            int K, float min_odds,
                            float* __restrict__ scratch,
                            int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Preds<V> p = g;
  if (SMEM) {
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

  float local[KMAX > 0 ? KMAX : 1];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += stride) {
    float* tally = KMAX > 0 ? local : scratch + row * K;
    for (int k = 0; k < K; ++k) tally[k] = 0.0f;
    const V* v = vals + row * F;
    const CT* c = codes + row * F;
    for (int t = 0; t < T; ++t) {
      int hit = 0;  // no match -> path 0, as argmax of an all-false row
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
              ok = (p.catw[(long long)(base + f) * W + (s >> 5)] >> (s & 31)) & 1u;
            }
          }
        }
        if (ok) {
          hit = q;
          break;
        }
      }
      const int k = p.cls[t * P + hit];
      if (k >= 0) tally[k] += p.w[t];
    }
    if (PARTIAL) {
      if (KMAX > 0) {
        for (int k = 0; k < K; ++k) scratch[row * K + k] = tally[k];
      }
    } else {
      out[row] = vote_finalize(tally, K, min_odds);
    }
  }
}

template <typename V, typename CT, int KMAX, bool PARTIAL>
cudaError_t launch(bool use_smem, size_t smem_bytes, int blocks,
                   cudaStream_t stream, const V* vals, const CT* codes,
                   long long n, int F, Preds<V> g, int T, int P, int C, int W,
                   int K, float min_odds, float* scratch, int* out) {
  if (use_smem) {
    vote_kernel<V, CT, KMAX, true, PARTIAL>
        <<<blocks, kThreads, smem_bytes, stream>>>(
            vals, codes, n, F, g, T, P, C, W, K, min_odds, scratch, out);
  } else {
    vote_kernel<V, CT, KMAX, false, PARTIAL><<<blocks, kThreads, 0, stream>>>(
        vals, codes, n, F, g, T, P, C, W, K, min_odds, scratch, out);
  }
  return cudaGetLastError();
}

// Blocks for n rows: one thread a row, at most 16 blocks an SM of the
// current device (grid-stride beyond).
int row_blocks(long long n) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long want = (n + kThreads - 1) / kThreads;
  long long cap = (long long)sms * 16;
  return (int)(want < cap ? want : cap);
}

template <typename V, typename CT, bool PARTIAL>
int run_vote(const V* vals, const CT* codes, long long n, int F, const V* lo,
             const V* hi, const unsigned char* flags,
             const unsigned int* catw, const int* cls, const float* wvec,
             int T, int P, int C, int W, int K, float min_odds,
             float* scratch, int* out, int use_smem, long long smem_bytes,
             void* stream) {
  if (n <= 0) return 0;
  const int blocks = row_blocks(n);
  Preds<V> g{lo, hi, catw, cls, wvec, flags};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sm = use_smem != 0;
  const size_t sb = (size_t)smem_bytes;
  cudaError_t err;
  if (K <= 8) {
    err = launch<V, CT, 8, PARTIAL>(sm, sb, blocks, s, vals, codes, n, F, g,
                                    T, P, C, W, K, min_odds, scratch, out);
  } else if (K <= 32) {
    err = launch<V, CT, 32, PARTIAL>(sm, sb, blocks, s, vals, codes, n, F, g,
                                     T, P, C, W, K, min_odds, scratch, out);
  } else {
    err = launch<V, CT, 0, PARTIAL>(sm, sb, blocks, s, vals, codes, n, F, g,
                                    T, P, C, W, K, min_odds, scratch, out);
  }
  return (int)err;
}

// Sum the S shards' (K,) tallies of a row in shard order, then finalize.
// KMAX as in vote_kernel (KMAX == 0: the summed tally in scratch).
template <int KMAX>
__global__ void merge_finalize_kernel(Partials parts, int S, long long n,
                                      int K, float min_odds,
                                      float* __restrict__ scratch,
                                      int* __restrict__ out) {
  float local[KMAX > 0 ? KMAX : 1];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += stride) {
    float* tally = KMAX > 0 ? local : scratch + row * K;
    for (int k = 0; k < K; ++k) {
      float sum = parts.p[0][row * K + k];
      for (int q = 1; q < S; ++q) sum += parts.p[q][row * K + k];
      tally[k] = sum;
    }
    out[row] = vote_finalize(tally, K, min_odds);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// `use_smem` / `smem_bytes` come from the wrapper, which sizes the staged
// predicate tensors; `scratch` is an (n, K) float buffer when K > 32, else
// unused.
extern "C" int avenir_ensemble_vote(
    const float* vals, const int* codes, long long n, int F,
    const float* lo, const float* hi, const unsigned char* flags,
    const unsigned int* catw, const int* cls, const float* wvec, int T,
    int P, int C, int W, int K, float min_odds, float* scratch, int* out,
    int use_smem, long long smem_bytes, void* stream) {
  return run_vote<float, int, false>(vals, codes, n, F, lo, hi, flags, catw,
                                     cls, wvec, T, P, C, W, K, min_odds,
                                     scratch, out, use_smem, smem_bytes,
                                     stream);
}

// The int8 form: the same arguments with int8 values, codes and thresholds.
extern "C" int avenir_quantized_vote(
    const int8_t* qvals, const int8_t* qcodes, long long n, int F,
    const int8_t* q_lo, const int8_t* q_hi, const unsigned char* flags,
    const unsigned int* catw, const int* cls, const float* wvec, int T,
    int P, int C, int W, int K, float min_odds, float* scratch, int* out,
    int use_smem, long long smem_bytes, void* stream) {
  return run_vote<int8_t, int8_t, false>(qvals, qcodes, n, F, q_lo, q_hi,
                                         flags, catw, cls, wvec, T, P, C, W,
                                         K, min_odds, scratch, out, use_smem,
                                         smem_bytes, stream);
}

// One tree shard's partial tallies: the float form's arguments without
// min_odds, writing the (n, K) float32 `partial` (no finalize).
extern "C" int avenir_ensemble_partial_votes(
    const float* vals, const int* codes, long long n, int F,
    const float* lo, const float* hi, const unsigned char* flags,
    const unsigned int* catw, const int* cls, const float* wvec, int T,
    int P, int C, int W, int K, float* partial, int use_smem,
    long long smem_bytes, void* stream) {
  return run_vote<float, int, true>(vals, codes, n, F, lo, hi, flags, catw,
                                    cls, wvec, T, P, C, W, K, 1.0f, partial,
                                    nullptr, use_smem, smem_bytes, stream);
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
  const int blocks = row_blocks(n);
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
