// The ConvNeXt block tail's two products on the 3xTF32 GEMM
// (tf32x3_gemm.cuh), shared by the two f32 paths that feed them LayerNorm
// rows as TF32 planes: the MLP tail's whole-tile path (mlp_block.cu, whose
// ln_rows normalises the depthwise conv's output) and the whole-block
// kernel (block_fused.cu, whose conv + LayerNorm launch writes the planes
// straight from the conv).  For rows m < n of the planes xs (N, C):
//
//     h   = gelu(xs W1^T + b1)                                (HiddenEpi)
//     out = res + sd[m / per] * ((h W2^T + b2) * gamma)      (OutEpi)
//
// with the exact erf GELU: per = 1 takes one scale a row (the MLP tail's
// sd), per = H * W one an image (the block's).  W1 is (4C, C) and W2 (C,
// 4C), the nn.Linear layouts.  The weights are split into their TF32
// planes at every call (the optimizer updates them in place).  Here h goes
// through device memory as two planes (N, 4C), because each product is a
// GEMM launch of 128 x 128 output tiles.  The MLP tail's sub-tiled path
// (mlp_block.cu: fused_kernel) keeps h on chip instead: one launch whose
// clusters share each hidden chunk through distributed shared memory.
// Rows with sd 0 return res bit for bit: res + 0 * (finite) is res.
// The epilogues serve the bf16 instances of both paths too, which run their
// products on bf16_gemm.cuh's x3::gemm (an f32 row in three exact bf16
// pieces times the bf16 weight as it lies): HiddenEpiF32 writes h as one f32
// plane, and OutEpi<bf16> reads the bf16 residual and rounds the f32 sum
// once.
#pragma once

#include <cuda_runtime.h>

#include "tf32x3_gemm.cuh"

namespace {

constexpr float kLnEps = 1e-6f;

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

struct HiddenEpi {  // h = gelu(v + b1) into h's planes (N, 4C)
  const float* b1;
  float* h;
  long long plane;
  int ld;
  __device__ void operator()(int m, int n, float2 v) const {
    const float2 b = *reinterpret_cast<const float2*>(b1 + n);
    tf32x3::store_split2(h, plane, (size_t)m * ld + n, gelu_exact(v.x + b.x), gelu_exact(v.y + b.y));
  }
};

struct HiddenEpiF32 {  // h = gelu(v + b1) into h (N, 4C), one f32 plane
  const float* b1;
  float* h;
  int ld;
  __device__ void operator()(int m, int n, float2 v) const {
    const float2 b = *reinterpret_cast<const float2*>(b1 + n);
    *reinterpret_cast<float2*>(h + (size_t)m * ld + n) = make_float2(gelu_exact(v.x + b.x), gelu_exact(v.y + b.y));
  }
};

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

template <class T = float>
struct OutEpi {  // out = res + sd[m / per] * ((v + b2) * gamma), res and out of T
  const T* res;
  const float* sd;
  int per;  // rows per scale
  const float* b2;
  const float* gamma;
  T* out;
  int ld;
  __device__ void operator()(int m, int n, float2 v) const {
    const size_t o = (size_t)m * ld + n;
    const float2 r = load2(res + o), b = *reinterpret_cast<const float2*>(b2 + n);
    const float2 g = *reinterpret_cast<const float2*>(gamma + n);
    const float s = sd[per == 1 ? m : m / per];
    store2(out + o, make_float2(r.x + s * ((v.x + b.x) * g.x), r.y + s * ((v.y + b.y) * g.y)));
  }
};

inline long long round32(long long v) { return (v + 31) / 32 * 32; }

// Where the planes start in the workspace (floats): the LayerNorm rows
// (2 N C), h (8 N C), W1's and W2's splits (8 C^2 each).
struct Plan {
  long long xs, h, w1s, w2s, total;
};

inline Plan make_plan(int n, int c) {
  Plan p;
  const long long nc = (long long)n * c, cc = (long long)c * c;
  p.xs = 0;
  p.h = p.xs + round32(2 * nc);
  p.w1s = p.h + round32(8 * nc);
  p.w2s = p.w1s + round32(8 * cc);
  p.total = p.w2s + round32(8 * cc);
  return p;
}

// W1's and W2's TF32 planes into the workspace of n rows.
template <int C>
cudaError_t split_weights(const float* w1, const float* w2, float* work, int n, cudaStream_t s) {
  const Plan p = make_plan(n, C);
  cudaError_t err = tf32x3::split(w1, 4 * C, C, work + p.w1s, nullptr, 0, s);
  if (err == cudaSuccess) err = tf32x3::split(w2, C, 4 * C, work + p.w2s, nullptr, 0, s);
  return err;
}

// The two products over the LayerNorm planes already in the workspace.
template <int C>
cudaError_t products(const float* res, const float* sd, int per, const float* b1, const float* b2,
                     const float* gamma, float* out, float* work, int n, cudaStream_t s) {
  using tf32x3::Operand;
  constexpr int C4 = 4 * C;
  const Plan p = make_plan(n, C);
  const long long nc = (long long)n * C;
  const Operand xo{work + p.xs, n, C, C, nc}, w1o{work + p.w1s, C4, C, C, 4LL * C * C};
  const Operand ho{work + p.h, n, C4, C4, 4 * nc}, w2o{work + p.w2s, C, C4, C4, 4LL * C * C};
  cudaError_t err = tf32x3::gemm(xo, w1o, HiddenEpi{b1, work + p.h, 4 * nc, C4}, s);
  if (err == cudaSuccess) err = tf32x3::gemm(ho, w2o, OutEpi<float>{res, sd, per, b2, gamma, out, C}, s);
  return err;
}

}  // namespace
