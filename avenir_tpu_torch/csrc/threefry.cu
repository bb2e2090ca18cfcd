// Threefry-2x32 (20 rounds) for Hopper: the counter hash under jax.random's
// default generator, bit for bit, so that the port draws the JAX package's
// random numbers (avenir_tpu_torch/utils/threefry.py).
//
// Replaces no Pallas kernel: the JAX package draws through jax.random, which
// XLA lowers to elementwise integer code.  Composed of torch ops the hash
// costs about 150 launches a call; one simulated-annealing step draws 3 to 5
// times, so this kernel does each draw in one launch.
//
// One thread an element: blockIdx.y strides over the B keys and a
// grid-stride loop over the n counters; element t = b * n + i hashes
// counter i under key b.  The counter is the
// flat index i itself (hi word i >> 32, lo word i & 0xffffffff: jax's
// iota_2x32_shape) or, when c0/c1 are given, the pair (c0[i], c1[i]).
// mode 0 writes bits1 ^ bits2 as one 32-bit word (random_bits at width 32);
// mode 1 writes the pair (bits1, bits2) as two int64 words (split, fold_in).
// Keys are int64 pairs holding unsigned 32-bit words, read from device
// memory, so a chain of draws never waits on the host.
//
// Bound: the larger of the output bytes (4 an element in mode 0) over the
// memory rate and the 41 operations an element that only the integer ALU
// pipe issues (20 rotates as SHF.L.W, 21 xors as LOP3) at its 64 lanes a
// clock an SM; the adds may issue as IMAD on the FMA pipe beside them
// (python -m avenir_tpu_torch.kernels.sass threefry prints the compiled
// loops' mix).  Everything stays in registers, and the key index comes
// from the grid, not a 64-bit division an element.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl32(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

#define TF_ROUND(r)          \
  x0 += x1;                  \
  x1 = rotl32(x1, r);        \
  x1 ^= x0;

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
}

__global__ void threefry_kernel(const long long* __restrict__ keys,
                                const long long* __restrict__ c0,
                                const long long* __restrict__ c1,
                                long long n, long long B, int mode,
                                void* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const uint32_t k0 = (uint32_t)keys[2 * b];
    const uint32_t k1 = (uint32_t)keys[2 * b + 1];
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
      uint32_t x0, x1;
      if (c0 != nullptr) {
        x0 = (uint32_t)c0[i];
        x1 = (uint32_t)c1[i];
      } else {
        x0 = (uint32_t)((unsigned long long)i >> 32);
        x1 = (uint32_t)((unsigned long long)i & 0xFFFFFFFFull);
      }
      threefry2x32(k0, k1, x0, x1);
      const long long t = b * n + i;
      if (mode == 0) {
        static_cast<uint32_t*>(out)[t] = x0 ^ x1;
      } else {
        long long* o = static_cast<long long*>(out);
        o[2 * t] = (long long)x0;
        o[2 * t + 1] = (long long)x1;
      }
    }
  }
}

}  // namespace

// keys: B int64 pairs; c0, c1: n int64 counters each, or both null for the
// flat index; out: B*n int32 words (mode 0) or B*n int64 pairs (mode 1).
// Returns the launch's cudaError_t.
extern "C" int avenir_threefry(const void* keys, const void* c0,
                               const void* c1, long long n, long long B,
                               int mode, void* out, void* stream) {
  const long long total = n * B;
  if (total <= 0) return 0;
  if ((c0 == nullptr) != (c1 == nullptr) || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // blockIdx.y walks the keys, blockIdx.x the counters: no division a value
  const long long gy = B < 65535 ? B : 65535;
  const long long want = (n + kThreads - 1) / kThreads;
  long long gx = ((long long)sms * 16 + gy - 1) / gy;
  gx = want < gx ? want : gx;
  const dim3 grid((unsigned)(gx > 0 ? gx : 1), (unsigned)gy);
  threefry_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys),
      static_cast<const long long*>(c0), static_cast<const long long*>(c1),
      n, B, mode, out);
  return (int)cudaGetLastError();
}
