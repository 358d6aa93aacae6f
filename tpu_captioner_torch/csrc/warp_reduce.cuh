// Warp-level sums and maxima shared by the port's kernels.  Included inside
// no namespace: the functions sit in this header's own anonymous namespace,
// so each kernel library keeps a private copy.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One halving step of a reduce-scatter across lanes: of 2*HALF partial sums
// a lane keeps the half its XOR partner does not, adding the partner's copy.
// The five steps <32, 16>, <16, 8>, <8, 4>, <4, 2>, <2, 1> over 64 partial
// sums leave lane j with the sums of flat outputs 2j and 2j + 1.
template <int HALF, int XOR>
__device__ __forceinline__ void reduce_half(float* v, int lane) {
  const bool upper = lane & XOR;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, XOR);
  }
}

__device__ __forceinline__ void reduce_scatter64(float* v, int lane) {
  reduce_half<32, 16>(v, lane);
  reduce_half<16, 8>(v, lane);
  reduce_half<8, 4>(v, lane);
  reduce_half<4, 2>(v, lane);
  reduce_half<2, 1>(v, lane);
}

// Sums over the warp's 32 lanes of 16 values each: lane j ends with the sum
// of value (j >> 1) & 15 in v[0] (lanes 2i and 2i + 1 hold the same sum).
__device__ __forceinline__ void reduce_scatter16(float* v, int lane) {
  reduce_half<8, 16>(v, lane);
  reduce_half<4, 8>(v, lane);
  reduce_half<2, 4>(v, lane);
  reduce_half<1, 2>(v, lane);
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
}

}  // namespace
