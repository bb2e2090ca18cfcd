// Forest level histogram on Hopper (sm_90a): kernel B1.
//
// Replaces the TPU kernel ops/pallas/histogram.py:40 `forest_level_counts`
// (per-tile body models/forest.py:99 `_count_body`).  For every row n, every
// tree t whose node id is active and every candidate split s, add the row's
// weight for that tree to one cell of the level histogram:
//
//   out[t, node_ids[n,t], s, branches[n,s], cls[n]] += weights[n,t]
//
// out is (T, N, S, B, C) float32, zeroed by the wrapper.  Semantics of the
// reference's one-hot contraction: a row-tree pair adds nothing when its
// node id is outside [0, N) (pad -1, stopped leaf -2), its class is outside
// [0, C), or its weight is 0; a split adds nothing where the row's branch is
// outside [0, B).
//
// Exactness: every weight is an integer and the callers keep a launch's
// weight mass below 2^24 (tree.level_chunk), so every partial sum is an
// integer below 2^24 that int32 and float32 both hold exactly, and the
// result is bit-identical to the plain version and to `_count_body` whatever
// order the blocks' partial sums land in.
//
// What bounds it on the H100: bytes.  Each row reads its T node ids, S
// branch codes, its class and T weights once: (4T + 4S + 4 + T) bytes a row
// with uint8 weights, 125 B at the rafo level (T=9, S=19; 0.037 ms for 1M
// rows at 3.35 TB/s) and 160 B at the bench forest's T=16 (0.38 ms for 8M
// rows).  The contraction itself is (T*N) x (C*S*B) x n int8 operations,
// 2 * 72 * 76 * 1M = 11 G at the rafo level: 0.006 ms at 1,979 T int8 op/s.
//
// Two forms; kernels/histogram.py `level_form` picks one per launch.
//
// The mma form (uint8 weights; `level_counts_mma_kernel`) does what the TPU
// kernel does on the MXU: the factored one-hot contraction
//
//   A[row, t*N + node] = w[row, t]    where node_ids[row, t] = node in [0, N)
//   Bm[row, c*S*B + s*B + b] = 1      where cls[row] = c in [0, C) and
//                                           branches[row, s] = b in [0, B)
//   P = A^T Bm,   out[t, node, s, b, c] = P[t*N + node, c*S*B + s*B + b]
//
// on the integer tensor cores (mma.sync m16n8k32 u8 x u8 -> s32; the class
// mask rides on Bm alone, which zeroes the row's whole contribution).
// - A block walks tiles of 128 rows (grid-stride).  Each tile's node ids,
//   weights, branch codes and classes are contiguous ranges: they are staged
//   into shared memory with 16-byte cp.async from the 16-byte granules that
//   cover each range (a range need not start aligned, as a chunked level's
//   slices do not: the kernel reads the granule's other bytes and ignores
//   them), double-buffered, so the next tiles load while this one is
//   counted.
// - The operands are built in shared memory by scatter, not by compare: a
//   zeroed operand buffer takes each active (row, tree)'s weight byte at
//   (t*N + node, row) and a 1 at (c*S*B + s*B + b, row) for each valid
//   (row, split): T + S byte stores a row instead of one-hot compares over
//   T*N + C*S*B columns.  An operand row holds one column's 128 bytes,
//   padded to 144 so the 8 rows an ldmatrix phase reads fall on 32 banks.
//   Two operand buffers: one is scattered while the last one's mma runs.
// - The 8 warps form a grid over the product's m16 x n8 tiles
//   (`mma_plan` picks it: fewest instructions a warp); each k-step a warp
//   loads each of its A and B fragments once (ldmatrix) before its mma.
//   Where a block's warps cannot hold the tiles' accumulators, the T*N
//   rows are cut into up to 4 slabs over the grid's y dimension (each
//   slab reads every row again).
// - Each block writes its int32 sums once, to its own row of scratch; a
//   second kernel adds the rows into `out` (contended atomics from every
//   block were slower).
// Measured on an H100 (PERF.md §6): 0.141 ms at the rafo level over
// 1M rows against 0.325 for the atomic form, 26% of the byte bound; 4.7x
// at the bench shape.  What holds it there: the mma instructions (about a
// third of the time at rafo, most of it at the bench shape; mma.sync runs
// far below the card's int8 peak) and the scatter, which is latency-bound;
// within a block the two run one after the other, between barriers
// (`kernels/b1_knockouts.py` times each part).
//
// The atomic form (`level_counts_kernel`, the design of the first port) still
// runs for float32 weights (w_max >= 256, which the u8 tensor-core operands
// cannot hold), for histograms whose product needs more than 4 slabs (the
// `wide` shape T=64, N=128, S=64, B=4, C=4: 1024 columns fill a whole block
// with one m16 row of tiles), and for operand tiles past the shared-memory
// limit.  One thread per row over a grid-stride loop; each block keeps a
// private (T,N,S,B,C) float32 accumulator in dynamic shared memory, adds
// into it with shared-memory atomics, then adds its nonzero cells into the
// output with global atomics; when the accumulator does not fit, it adds
// straight into global memory.  It serialises at shallow levels (all lanes
// of a warp on the N*B*C cells of one split), reads rows strided by T and
// S, and loops over trees and splits serially: at the rafo level about 9x
// its byte bound.

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


// ---------------------------------------------------------------------------
// The mma form: u8 one-hot operands on the integer tensor cores.
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 128;               // rows a staged tile: 4 k-steps
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;
// An operand row holds one column's kMmaRows bytes (row r of the tile at
// byte r), padded to 4 x an odd number of words, so the 8 row addresses of
// an ldmatrix phase fall on 32 distinct banks.
constexpr int kOpStride = kMmaRows + 16;

__device__ __forceinline__ int op_byte(int row, int r) {
  return row * kOpStride + r;
}

// The bytes one staging buffer gives each of a tile's four ranges: the
// range plus the partial granules at either end, in 16-byte units.
__host__ __device__ inline int round16(long long x) {
  return (int)((x + 15) & ~15LL);
}

struct StageSizes {
  int nid, w, br, cls, total;
};

__host__ __device__ inline StageSizes stage_sizes(int T, int S) {
  StageSizes z;
  z.nid = round16((long long)kMmaRows * T * 4 + 32);
  z.w = round16((long long)kMmaRows * T + 32);
  z.br = round16((long long)kMmaRows * S * 4 + 32);
  z.cls = round16(kMmaRows * 4 + 32);
  z.total = z.nid + z.w + z.br + z.cls;
  return z;
}

// One operand buffer: the slab's A rows (slab_tiles * 16) then Bm's rows
// (n_tiles * 8), kOpStride bytes each.
__host__ __device__ inline int operand_bytes(int slab_tiles, int n_tiles) {
  return (slab_tiles * 16 + n_tiles * 8) * kOpStride;
}

struct MmaArgs {
  const int* nid;
  const int* br;
  const int* cls;
  const uint8_t* w;
  long long n;
  int T, N, S, B, C;
  int m_tiles;     // m16 tiles of the whole (T*N) axis
  int n_tiles;     // n8 tiles of the (C*S*B) axis
  int slab_tiles;  // m16 tiles a slab (grid y)
  int wn;          // warps along the n axis (kMmaWarps / wn along m)
  int* partial;    // (gridDim.x, T*N*S*B*C) int32: each block's sums
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Copy the 16-byte granules that cover [src, src + len) to dst: the range
// itself starts at dst + (src & 15).  A granule holding one byte of the
// range lies inside the range's allocation, so the bytes around the range
// are readable; they are never used.
__device__ __forceinline__ void stage_range(uint8_t* dst, const void* src,
                                            long long len) {
  const uintptr_t a = (uintptr_t)src & ~(uintptr_t)15;
  const uintptr_t e = ((uintptr_t)src + (uintptr_t)len + 15) & ~(uintptr_t)15;
  const int granules = (int)((e - a) >> 4);
  for (int g = threadIdx.x; g < granules; g += blockDim.x) {
    cp_async16(dst + g * 16, (const void*)(a + (uintptr_t)g * 16));
  }
}

__device__ __forceinline__ int byte_offset(const void* p) {
  return (int)((uintptr_t)p & 15);
}

// Four 8x8 b16 matrices from shared memory (lanes 8q..8q+7 give matrix q's
// row addresses); lane t receives row t/4, 32-bit word t%4 of each.
__device__ __forceinline__ void ldmatrix_x4(unsigned addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// D += A * B over one m16 x n8 x k32 tile: A row-major u8, B column-major
// u8, D s32 (fragment layouts as in the PTX ISA's m16n8k32 .u8 figures).
__device__ __forceinline__ void mma_u8(int* d, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// floor(j / d) for 0 <= j < 2^32 / d: j * ceil(2^32 / d) >> 32.
__device__ __forceinline__ int div_magic(int j, unsigned long long magic) {
  return (int)(((unsigned long long)(unsigned)j * magic) >> 32);
}

// The warps form a wm x wn grid over the slab's m16 x n8 tiles: warp
// (i, j) takes m-tiles i, i + wm, ... (at most MT) and n-tiles j, j + wn,
// ... (at most NT), so each k-step it loads one A fragment an m-tile and
// one B fragment an n-tile, all before its MT x NT mma.
template <int MT, int NT>
__global__ void __launch_bounds__(kMmaThreads, 2)
    level_counts_mma_kernel(MmaArgs a) {
  static_assert(NT % 2 == 0, "B fragments load two n-tiles at a time");
  extern __shared__ __align__(16) uint8_t smem[];
  const StageSizes z = stage_sizes(a.T, a.S);
  const int T = a.T, N = a.N, S = a.S, B = a.B, C = a.C;
  const int SB = S * B;
  const int slab_first = blockIdx.y * a.slab_tiles;
  const int m_lo = slab_first * 16;
  const int slab_tiles = min(a.slab_tiles, a.m_tiles - slab_first);
  const int slab_rows = slab_tiles * 16;
  // operand buffer: A rows [0, a.slab_tiles * 16), then Bm rows
  const int ob = operand_bytes(a.slab_tiles, a.n_tiles);
  const int b_first = a.slab_tiles * 16 * kOpStride;
  uint8_t* const stage[2] = {smem, smem + z.total};
  uint8_t* const ops[2] = {smem + 2 * z.total, smem + 2 * z.total + ob};
  const long long tiles = (a.n + kMmaRows - 1) / kMmaRows;
  const unsigned long long magic_t = ((1ull << 32) + T - 1) / T;
  const unsigned long long magic_s = ((1ull << 32) + S - 1) / S;

  // this warp's tiles and each lane's ldmatrix row offsets within an
  // operand buffer (lanes 8q..8q+7 address matrix q)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = a.wn, wm = kMmaWarps / wn;
  const int wi = warp / wn, wj = warp - (warp / wn) * wn;
  bool m_ok[MT], n_ok[NT];
  int arow[MT], brow[NT / 2];  // the operand row this lane addresses
  int acc[MT][NT][4];
  // A: matrix lane/8 = (rows +8 if odd, k chunk +1 if >= 2); Bm: matrices
  // 0-1 n-tile 2 v2, 2-3 n-tile 2 v2 + 1, odd ones k chunk +1
  const int a_chunk = lane >> 4, b_chunk = (lane >> 3) & 1;
#pragma unroll
  for (int u = 0; u < MT; ++u) {
    const int mt = wi + wm * u;
    m_ok[u] = mt < slab_tiles;
    arow[u] = (m_ok[u] ? mt : 0) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
  }
#pragma unroll
  for (int v = 0; v < NT; ++v) n_ok[v] = wj + wn * v < a.n_tiles;
#pragma unroll
  for (int v2 = 0; v2 < NT / 2; ++v2) {
    const int nt = wj + wn * (2 * v2 + (lane >> 4));
    brow[v2] = (nt < a.n_tiles ? nt : 0) * 8 + (lane & 7);
  }
#pragma unroll
  for (int u = 0; u < MT; ++u) {
#pragma unroll
    for (int v = 0; v < NT; ++v) {
      acc[u][v][0] = acc[u][v][1] = acc[u][v][2] = acc[u][v][3] = 0;
    }
  }

  auto stage_tile = [&](long long tile, uint8_t* buf) {
    if (tile < tiles) {
      const long long r0 = tile * kMmaRows;
      const long long rows = min((long long)kMmaRows, a.n - r0);
      stage_range(buf, a.nid + r0 * T, rows * T * 4);
      stage_range(buf + z.nid, a.w + r0 * T, rows * T);
      stage_range(buf + z.nid + z.w, a.br + r0 * S, rows * S * 4);
      stage_range(buf + z.nid + z.w + z.br, a.cls + r0, rows * 4);
    }
    cp_async_commit();
  };

  auto zero_ops = [&](uint8_t* o) {
    uint4* const v = reinterpret_cast<uint4*>(o);
    for (int i = threadIdx.x; i < ob / 16; i += kMmaThreads) {
      v[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  };

  long long tile = blockIdx.x;
  zero_ops(ops[0]);
  stage_tile(tile, stage[0]);
  stage_tile(tile + gridDim.x, stage[1]);
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int p = it & 1;
    uint8_t* const buf = stage[p];
    uint8_t* const op = ops[p];
    cp_async_wait<1>();
    __syncthreads();  // tile staged, ops[p] zeroed, last mma done
    const long long r0 = tile * kMmaRows;
    const int rows = (int)min((long long)kMmaRows, a.n - r0);
    const int* snid =
        reinterpret_cast<const int*>(buf + byte_offset(a.nid + r0 * T));
    const uint8_t* sw = buf + z.nid + byte_offset(a.w + r0 * T);
    const int* sbr = reinterpret_cast<const int*>(
        buf + z.nid + z.w + byte_offset(a.br + r0 * S));
    const int* scls = reinterpret_cast<const int*>(
        buf + z.nid + z.w + z.br + byte_offset(a.cls + r0));
    // A: the weight byte of each active (row, tree) at row t*N + node
    for (int j = threadIdx.x; j < rows * T; j += kMmaThreads) {
      const int row = div_magic(j, magic_t);
      const int node = snid[j];
      const uint8_t wv = sw[j];
      const int m = (j - row * T) * N + node - m_lo;
      if ((unsigned)node < (unsigned)N && wv != 0 &&
          (unsigned)m < (unsigned)slab_rows) {
        op[op_byte(m, row)] = wv;
      }
    }
    // Bm: a 1 for each valid (row, split) at row c*S*B + s*B + b
    for (int j = threadIdx.x; j < rows * S; j += kMmaThreads) {
      const int row = div_magic(j, magic_s);
      const int b = sbr[j];
      const int c = scls[row];
      if ((unsigned)b < (unsigned)B && (unsigned)c < (unsigned)C) {
        op[b_first + op_byte(c * SB + (j - row * S) * B + b, row)] = 1;
      }
    }
    zero_ops(ops[p ^ 1]);  // the next tile's operands (the last mma's)
    __syncthreads();       // operands built; this staging buffer is free
    stage_tile(tile + 2LL * gridDim.x, buf);
    const unsigned base = smem_addr(op);
    const int ksteps = (rows + 31) >> 5;
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int u = 0; u < MT; ++u) {
        if (m_ok[u]) {
          ldmatrix_x4(base + op_byte(arow[u], (2 * ks + a_chunk) * 16),
                      af[u][0], af[u][1], af[u][2], af[u][3]);
        }
      }
#pragma unroll
      for (int v2 = 0; v2 < NT / 2; ++v2) {
        if (n_ok[2 * v2]) {
          ldmatrix_x4(base + b_first + op_byte(brow[v2],
                                               (2 * ks + b_chunk) * 16),
                      bf[2 * v2][0], bf[2 * v2][1], bf[2 * v2 + 1][0],
                      bf[2 * v2 + 1][1]);
        }
      }
#pragma unroll
      for (int u = 0; u < MT; ++u) {
#pragma unroll
        for (int v = 0; v < NT; ++v) {
          if (m_ok[u] && n_ok[v]) {
            mma_u8(acc[u][v], af[u][0], af[u][1], af[u][2], af[u][3],
                   bf[v][0], bf[v][1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // this block's sums, every cell of its slab (zeros too), into its row
  // of the partial sums: P[m, c*S*B + s*B + b] -> [m, s, b, c]
  const int g = lane >> 2, tig = lane & 3;
  const int M = T * N, cols = C * SB, cells_row = SB * C;
  int* const part = a.partial + (long long)blockIdx.x * M * cells_row;
#pragma unroll
  for (int u = 0; u < MT; ++u) {
#pragma unroll
    for (int v = 0; v < NT; ++v) {
      if (!(m_ok[u] && n_ok[v])) continue;
      const int mt = wi + wm * u, nt = wj + wn * v;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        // accumulator h: row g (+8 for h >= 2), column 2 tig (+1 if odd)
        const int m = m_lo + mt * 16 + g + (h >> 1) * 8;
        const int col = nt * 8 + tig * 2 + (h & 1);
        if (m < M && col < cols) {
          const int c = col / SB;
          part[m * cells_row + (col - c * SB) * C + c] = acc[u][v][h];
        }
      }
    }
  }
}

// out[cell] = the sum of the blocks' partial sums (exact: integers below
// 2^24, so the float32 result is the integer).
__global__ void sum_partials_kernel(const int* __restrict__ partial,
                                    int blocks, int cells,
                                    float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < cells;
       i += gridDim.x * blockDim.x) {
    int sum = 0;
    for (int b = 0; b < blocks; ++b) sum += partial[(long long)b * cells + i];
    out[i] = (float)sum;
  }
}

// Each kernel instance's shared-memory attribute and resident blocks an SM,
// a device at a time: set and queried once for each (device, smem) and
// remembered, so a launch makes no attribute or occupancy queries.
constexpr int kMaxDevices = 16;

template <int MT, int NT>
cudaError_t launch_mma(MmaArgs a, int slabs, int smem, int max_blocks,
                       float* out, cudaStream_t stream) {
  auto kernel = level_counts_mma_kernel<MT, NT>;
  static int known_smem[kMaxDevices], known_per_sm[kMaxDevices],
      known_sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (known_smem[dev] != smem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kMmaThreads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    known_per_sm[dev] = per_sm;
    known_sms[dev] = sms;
    known_smem[dev] = smem;
  }
  const int per_sm = known_per_sm[dev], sms = known_sms[dev];
  const long long tiles = (a.n + kMmaRows - 1) / kMmaRows;
  long long gx = (long long)sms * per_sm / slabs;
  if (gx > max_blocks) gx = max_blocks;
  if (gx > tiles) gx = tiles;
  if (gx < 1) gx = 1;
  kernel<<<dim3((unsigned)gx, (unsigned)slabs), kMmaThreads, smem, stream>>>(
      a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int cells = a.T * a.N * a.S * a.B * a.C;
  const int threads = 256;
  int grid = (cells + threads - 1) / threads;
  if (grid > sms * 4) grid = sms * 4;
  sum_partials_kernel<<<grid, threads, 0, stream>>>(a.partial, (int)gx,
                                                    cells, out);
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

// The warp tile shapes (MT m-tiles x NT n-tiles a warp) the kernel is
// built for; kernels/histogram.py MMA_WARP_TILES lists the same, in order.
constexpr int kWarpTiles[][2] = {{1, 4}, {1, 8}, {1, 12}, {1, 16},
                                 {2, 4}, {2, 8}, {4, 4}};

// The mma form (uint8 weights only).  The plan comes from the wrapper
// (kernels/histogram.py `mma_plan`) and is checked here against the shape:
// slab_tiles m16 tiles a slab, `slabs` = ceil(m_tiles / slab_tiles) slabs
// on the grid's y axis, wn warps along n (8 / wn along m), `shape` the
// index of the warp tile shape in kWarpTiles that holds a warp's share, and
// smem_bytes the kernel's dynamic shared memory (two staging buffers and
// two operand buffers).  `partial` is int32 scratch of max_blocks rows of
// T*N*S*B*C cells: the grid takes at most max_blocks blocks along x (as
// many as are resident, no more than the row tiles), each writes its sums
// there, and a second kernel adds them into `out` (which it overwrites).
// Launch on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int avenir_forest_level_counts_mma(
    const int* node_ids, const int* branches, const int* cls,
    const uint8_t* weights, long long n, int T, int N, int S, int B, int C,
    int slab_tiles, int slabs, int wn, int shape, long long smem_bytes,
    int* partial, int max_blocks, float* out, void* stream) {
  if (n <= 0) return 0;
  const int shapes = (int)(sizeof(kWarpTiles) / sizeof(kWarpTiles[0]));
  if (T < 1 || N < 1 || S < 1 || B < 1 || C < 1 || slab_tiles < 1 ||
      slabs < 1 || max_blocks < 1 || wn < 1 || kMmaWarps % wn != 0 ||
      shape < 0 ||
      shape >= shapes) {
    return (int)cudaErrorInvalidValue;
  }
  const int m_tiles = (T * N + 15) / 16;
  const int n_tiles = (C * S * B + 7) / 8;
  const int wm = kMmaWarps / wn;
  const long long smem = 2LL * stage_sizes(T, S).total +
                         2LL * operand_bytes(slab_tiles, n_tiles);
  if (slabs != (m_tiles + slab_tiles - 1) / slab_tiles ||
      (slab_tiles + wm - 1) / wm > kWarpTiles[shape][0] ||
      (n_tiles + wn - 1) / wn > kWarpTiles[shape][1] || smem != smem_bytes) {
    return (int)cudaErrorInvalidValue;
  }
  MmaArgs a{node_ids, branches, cls,     weights, n,          T,  N,      S,
            B,        C,        m_tiles, n_tiles, slab_tiles, wn, partial};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sm = (int)smem;
  switch (shape) {
    case 0: return (int)launch_mma<1, 4>(a, slabs, sm, max_blocks, out, s);
    case 1: return (int)launch_mma<1, 8>(a, slabs, sm, max_blocks, out, s);
    case 2: return (int)launch_mma<1, 12>(a, slabs, sm, max_blocks, out, s);
    case 3: return (int)launch_mma<1, 16>(a, slabs, sm, max_blocks, out, s);
    case 4: return (int)launch_mma<2, 4>(a, slabs, sm, max_blocks, out, s);
    case 5: return (int)launch_mma<2, 8>(a, slabs, sm, max_blocks, out, s);
    default: return (int)launch_mma<4, 4>(a, slabs, sm, max_blocks, out, s);
  }
}
