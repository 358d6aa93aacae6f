// Dropout keep-mask pool: one launch fills a flat (n,) bool pool with
// P(True) = keep, for every decoder dropout site of a train step.
//
// Replaces the TPU kernel tpu_captioner/ops/dropout_mask.py:_mask_kernel,
// which drew its bits from the TPU's hardware PRNG.  Here the bits come from
// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11), written out below: ten rounds of a 32x32->64 multiply whose
// high and low halves are mixed with the other counter words, with the
// 64-bit key bumped by the Weyl constants between rounds.  The key is the
// two seed words; the counter is (element index / 4) in its low 64 bits, so
// one Philox call gives the four words of four neighbouring elements.  An
// element is kept when its word is below the threshold
// min(round(keep * 2^32), 2^32 - 1), the TPU kernel's rule.  The wrapper's
// plain version (ops/dropout_mask.py:_mask_plain) computes the same bits in
// PyTorch integer arithmetic.
//
// What bounds it: the integer multiplies.  At the flagship train step
// (batch 32, T 52, six layers) it writes 29,366,272 one-byte bools, 8.8 us
// at 3.35 TB/s, and makes 7.34 M Philox calls of 19 32x32 -> 64-bit
// products each (the first round's second product is of the counter's zero
// word), one IMAD.WIDE.U32 a product, two 32-bit results: at the 64 results
// a clock per SM of the CUDA C++ Programming Guide, 16.7 us on 132 SMs at
// 1.98 GHz (chip_smoke.py:pool_bound; the derivation is in PERF.md).  Each
// thread makes one Philox call per group of four outputs and writes the
// four bools as one aligned 4-byte store.  A grid-stride loop covers any n;
// only the last, ragged group stores byte by byte.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;  // golden ratio
constexpr uint32_t kW1 = 0xBB67AE85u;  // sqrt(3) - 1
constexpr int kThreads = 256;

struct U4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ U4 philox_round(U4 c, uint32_t k0, uint32_t k1) {
  const uint32_t lo0 = kM0 * c.x, hi0 = __umulhi(kM0, c.x);
  const uint32_t lo1 = kM1 * c.z, hi1 = __umulhi(kM1, c.z);
  return U4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
}

__device__ __forceinline__ U4 philox4x32_10(U4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 9; ++r) {
    c = philox_round(c, k0, k1);
    k0 += kW0;
    k1 += kW1;
  }
  return philox_round(c, k0, k1);
}

__global__ void __launch_bounds__(kThreads)
    mask_pool_kernel(uint32_t k0, uint32_t k1, uint32_t threshold, uint8_t* __restrict__ out,
                     long long n) {
  const long long groups = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    const U4 r = philox4x32_10(
        U4{static_cast<uint32_t>(g), static_cast<uint32_t>(static_cast<unsigned long long>(g) >> 32),
           0u, 0u},
        k0, k1);
    const uint32_t packed = static_cast<uint32_t>(r.x < threshold) |
                            static_cast<uint32_t>(r.y < threshold) << 8 |
                            static_cast<uint32_t>(r.z < threshold) << 16 |
                            static_cast<uint32_t>(r.w < threshold) << 24;
    const long long base = 4 * g;
    if (base + 4 <= n) {
      *reinterpret_cast<uint32_t*>(out + base) = packed;  // little-endian: byte j = element j
    } else {
      for (long long j = 0; base + j < n; ++j) out[base + j] = (packed >> (8 * j)) & 0xFFu;
    }
  }
}

}  // namespace

extern "C" {

const char* tc_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// out: (n,) one-byte bools, 4-byte aligned; sms: the card's SM count (the
// wrapper asks for it once per device).  Returns a cudaError_t code.
int tc_dropout_mask_pool(unsigned int seed0, unsigned int seed1, unsigned int threshold, void* out,
                         long long n, int sms, void* stream) {
  if (n <= 0) return 0;
  if (sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = (n + 3) / 4;
  const long long needed = (groups + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 8;  // 8 resident blocks of 256 per SM
  const int blocks = static_cast<int>(needed < cap ? needed : cap);
  mask_pool_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      seed0, seed1, threshold, static_cast<uint8_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
