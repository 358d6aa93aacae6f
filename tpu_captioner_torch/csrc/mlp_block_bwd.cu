// Fused ConvNeXt block tail, backward, f32 and bf16, both precise arms, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_captioner/ops/mlp_block.py:275 _bwd_kernel
// (launched by _bwd_pallas -> _bwd_pallas_one under the custom VJP of
// fused_convnext_mlp).  For the cotangent g of
//
//     out = res + sd * ((gelu(LN(x) W1^T + b1) W2^T + b2) * gamma)
//
// it recomputes LN, a = xn W1^T + b1, h = gelu(a) and u = h W2^T + b2, and
// returns d_x and d_sd per row, and d_ln_w, d_ln_b, d_w1 (4C, C), d_b1,
// d_w2 (C, 4C), d_b2 and d_gamma summed over all rows.  W1 and W2 are the
// nn.Linear layouts; the gradients come back in the same layouts.
//
// What bounds it on the H100: arithmetic.  Per call 48*N*C^2 flops: 16 to
// recompute the two forward products, 8 each for d_h = d_u W2, d_xn = d_a W1,
// dW1 = d_a^T xn and dW2 = d_u^T h.  At both fine-tune stages at batch 32
// (N*C^2 = 2.1e9) that is 103 GFLOP: 0.62 ms at the 165 TFLOP/s of f32-
// accurate tensor-core products (3xTF32, tf32x3_gemm.cuh), against about
// 0.1 ms for its f32 bytes.  So the intermediates may live in device
// memory, and what matters is the rate of the six products.
//
// What the design does about it:
// - six launches of the 3xTF32 wgmma GEMM of tf32x3_gemm.cuh (P = A B^T,
//   both operands K-major, as two TF32 planes each), with fused epilogues:
//   bias + GELU + GELU' after the first, bias after the second, the product
//   with GELU' after the third.  Each operand's layout, fixed by the code
//   that produces it (TF32 wgmma reads K-major operands only):
//     1. a = xn W1^T: xn (N, C) and W1 (4C, C), K-major as they are;
//     2. u = h W2^T: h (N, 4C), from product 1's epilogue, and W2 (C, 4C);
//     3. d_h = d_u W2: d_u (N, C) and W2^T (4C, C), a transposed copy;
//     4. d_xn = d_a W1: d_a (N, 4C), from product 3's epilogue, and W1^T
//        (C, 4C), a transposed copy;
//     5. dW1 = d_a^T xn and 6. dW2 = d_u^T h reduce over the rows, so both
//        operands of each are stored row-contiguous: d_a^T and h^T (4C, N)
//        written by the epilogues of products 3 and 1 beside the plain
//        copies, xn^T and d_u^T (C, N) by `split`.
//   The epilogues' transposed stores cover 8 consecutive rows (32 bytes)
//   per column, so they waste no sector; one GEMM then serves all six
//   products, where mma.sync for products 3-6 would need a second kernel.
//   Each weight is split per call into its plain and transposed planes
//   (16 C^2 floats per weight), never cached: the optimizer updates the
//   weights in place every step.  Bytes beyond the f32 design's, per call:
//   the weights' planes, 160 C^2; xn's and d_u's planes, read once more and
//   written twice, 40 N C; h's and d_a's transposed planes, 64 N C, with
//   their plain planes twice the f32 copies, 32 N C more.  About 0.6 GB
//   per call at C = 512, N = 8192: 0.18 ms at 3.35 TB/s, against the
//   products' 0.26 ms at 165 TFLOP/s;
// - the TPU kernel carried the weight-gradient sums from one grid step to
//   the next; Hopper blocks run in no order, so the two weight-gradient
//   products split the row (reduction) dimension over enough blocks to fill
//   the SMs, write per-split partials, and a second pass adds them in a
//   fixed order; the five column sums are per-chunk partials plus a
//   fixed-order pass too.  No atomics, so a run repeats its bits;
// - row kernels (one warp per row) do LayerNorm and its backward, d_u and
//   d_sd;
// - any N: rows past N are never read (TMA zero-fills past the extents,
//   the row kernels mask: a padding row could hold NaN).  The transposed
//   planes' rows are padded to a multiple of 4 floats for TMA's 16-byte
//   strides; the padding is never read.
//
// The bf16 instance (tc_mlp_block_backward_bf16, backward_x3): the TPU
// kernel's arm on bf16 g, x, W1 and W2 with mxu_dtype=float32
// (_bwd_pallas_one, which the JAX bf16 encoder's custom VJP calls with
// precise=True, tpu_captioner/ops/mlp_block.py:497-515).  prep_rows widens
// bf16 x and g as it reads them and recomputes the forward in f32 from them
// (not from the forward's bf16 output); finish_rows rounds d_x to bf16
// once; the column sums read bf16 g.  Every gradient but d_x is written in
// f32; the caller rounds d_W1 and d_W2 to bf16 once, as JAX's
// `.astype(w1.dtype)` does (:476).  What bounds it on the H100: the
// products, 32 N C^2 flops of f32 rows times a bf16 weight at 329.67
// TFLOP/s (three exact bf16 pieces, 989 / 3) plus 16 N C^2 of f32
// activations at 165 (3xTF32), 12.5 ms per bs-32 fine-tune step.  The
// design:
// - the four products with a weight as B run x3::gemm (bf16_gemm.cuh): the
//   f32 A rows (xn, h, d_u, d_a: one f32 copy each, from prep_rows and the
//   epilogues of products 1 and 3) split into three bf16 pieces in
//   registers, three register-A wgmma a k16 step on the bf16 weight's box as
//   it lies: K-major for a = xn W1^T and u = h W2^T, MN-major (wgmma's
//   transposed B) for d_h = d_u W2 and d_xn = d_a W1, so no transposed or
//   widened copy of a weight is made: no weight split at all;
// - the two weight-gradient products, f32 times f32, stay on 3xTF32 with
//   the transposed planes of xn, d_u, h and d_a (six bf16 pieces would run
//   at the same 165 TFLOP/s);
// - d_a's column sum reads the f32 copy.
// Launches a call: prep_rows, the two transposed splits, four x3 GEMMs,
// finish_rows, two 3xTF32 GEMMs and their split sums, the column partials
// and their sum: 13.
// The precise=False arm (tc_mlp_block_backward_bf16_products, f32 or bf16
// data): the TPU kernel's mm with mxu_dtype=bfloat16 (:291-296), each of the
// six products on bf16 operands rounded where it rounds them, summed in f32
// on bf16 wgmma (bf16_gemm.cuh, backward_bf16 below); 48*N*C^2 flops at 989
// TFLOP/s, 3.13 ms per fine-tune step.
// Later PRs: the intermediates on chip, and a tuned GEMM (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_gemm.cuh"
#include "tf32x3_gemm.cuh"
#include "warp_reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kLnEps = 1e-6f;
constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {  // four bf16 (8 bytes), widened
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {  // four values rounded to bf16 once
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float at(float4 v, int e) { return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w; }
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }

// ------------------------------------------------------------- GEMM epilogues
// Each takes a row m and two consecutive columns n, n + 1 of the product.
// "Planes" are an operand's two TF32 planes (tf32x3_gemm.cuh), `plane`
// floats apart; a "transposed" copy holds element (m, n) at n * ld_t + m.

struct StoreEpi {  // out[m, n] = v (with blockIdx.z selecting a split's slab)
  float* out;
  int ld;
  long long slab;
  __device__ void operator()(int m, int n, float2 v) const {
    *reinterpret_cast<float2*>(out + blockIdx.z * slab + (size_t)m * ld + n) = v;
  }
};

// a = v + b1: h = gelu(a) as planes, plain and transposed, and
// gp = gelu'(a) = Phi(a) + a phi(a).
struct GeluEpi {
  const float* bias;
  float* h;
  float* ht;
  float* gp;
  long long plane, plane_t;
  int ld, ld_t;
  __device__ void operator()(int m, int n, float2 v) const {
    const float2 b = ld2(bias + n);
    float hv[2], gv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a = (e ? v.y : v.x) + (e ? b.y : b.x);
      const float cdf = 0.5f * (1.0f + erff(a * kInvSqrt2));
      hv[e] = a * cdf;
      gv[e] = cdf + a * (expf(-0.5f * a * a) * kInvSqrt2Pi);
    }
    const size_t o = (size_t)m * ld + n;
    tf32x3::store_split2(h, plane, o, hv[0], hv[1]);
    tf32x3::store_split(ht, plane_t, (size_t)n * ld_t + m, hv[0]);
    tf32x3::store_split(ht, plane_t, (size_t)(n + 1) * ld_t + m, hv[1]);
    *reinterpret_cast<float2*>(gp + o) = make_float2(gv[0], gv[1]);
  }
};

struct BiasEpi {  // out = v + bias
  const float* bias;
  float* out;
  int ld;
  __device__ void operator()(int m, int n, float2 v) const {
    const float2 b = ld2(bias + n);
    *reinterpret_cast<float2*>(out + (size_t)m * ld + n) = make_float2(v.x + b.x, v.y + b.y);
  }
};

// d_a = v * gp (elementwise, same layout) as planes, plain and transposed.
struct MulEpi {
  const float* gp;
  float* da;
  float* dat;
  long long plane, plane_t;
  int ld, ld_t;
  __device__ void operator()(int m, int n, float2 v) const {
    const size_t o = (size_t)m * ld + n;
    const float2 s = ld2(gp + o);
    const float d0 = v.x * s.x, d1 = v.y * s.y;
    tf32x3::store_split2(da, plane, o, d0, d1);
    tf32x3::store_split(dat, plane_t, (size_t)n * ld_t + m, d0);
    tf32x3::store_split(dat, plane_t, (size_t)(n + 1) * ld_t + m, d1);
  }
};

// The bf16 instance's: h and d_a as one f32 copy (the next x3 product's
// A) beside their transposed planes (the weight gradients' operands).
struct GeluEpiX3 {
  const float* bias;
  float* h;
  float* ht;
  float* gp;
  long long plane_t;
  int ld, ld_t;
  __device__ void operator()(int m, int n, float2 v) const {
    const float2 b = ld2(bias + n);
    float hv[2], gv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a = (e ? v.y : v.x) + (e ? b.y : b.x);
      const float cdf = 0.5f * (1.0f + erff(a * kInvSqrt2));
      hv[e] = a * cdf;
      gv[e] = cdf + a * (expf(-0.5f * a * a) * kInvSqrt2Pi);
    }
    const size_t o = (size_t)m * ld + n;
    *reinterpret_cast<float2*>(h + o) = make_float2(hv[0], hv[1]);
    tf32x3::store_split(ht, plane_t, (size_t)n * ld_t + m, hv[0]);
    tf32x3::store_split(ht, plane_t, (size_t)(n + 1) * ld_t + m, hv[1]);
    *reinterpret_cast<float2*>(gp + o) = make_float2(gv[0], gv[1]);
  }
};

struct MulEpiX3 {  // d_a = v * gp: f32, and transposed planes
  const float* gp;
  float* da;
  float* dat;
  long long plane_t;
  int ld, ld_t;
  __device__ void operator()(int m, int n, float2 v) const {
    const size_t o = (size_t)m * ld + n;
    const float2 s = ld2(gp + o);
    const float d0 = v.x * s.x, d1 = v.y * s.y;
    *reinterpret_cast<float2*>(da + o) = make_float2(d0, d1);
    tf32x3::store_split(dat, plane_t, (size_t)n * ld_t + m, d0);
    tf32x3::store_split(dat, plane_t, (size_t)(n + 1) * ld_t + m, d1);
  }
};

// The precise=False arm's epilogues: the products' bf16 operands, rounded
// once from the f32 values.
using bf16mm::bf16;
using bf16mm::pack2;

// a = v + b1: h = gelu(a) rounded to bf16, plain (N, 4C) and transposed,
// and gp = gelu'(a) in f32.
struct GeluEpiBf16 {
  const float* bias;
  bf16* h;
  bf16* ht;
  float* gp;
  int ld, ld_t;
  __device__ void operator()(int m, int n, float2 v) const {
    const float2 b = ld2(bias + n);
    float hv[2], gv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a = (e ? v.y : v.x) + (e ? b.y : b.x);
      const float cdf = 0.5f * (1.0f + erff(a * kInvSqrt2));
      hv[e] = a * cdf;
      gv[e] = cdf + a * (expf(-0.5f * a * a) * kInvSqrt2Pi);
    }
    const size_t o = (size_t)m * ld + n;
    *reinterpret_cast<uint32_t*>(h + o) = pack2(hv[0], hv[1]);
    ht[(size_t)n * ld_t + m] = __float2bfloat16_rn(hv[0]);
    ht[(size_t)(n + 1) * ld_t + m] = __float2bfloat16_rn(hv[1]);
    *reinterpret_cast<float2*>(gp + o) = make_float2(gv[0], gv[1]);
  }
};

// d_a = v * gp: in f32 over gp itself (the column sums read it), and
// rounded to bf16, plain and transposed.
struct MulEpiBf16 {
  float* gp;
  bf16* da;
  bf16* dat;
  int ld, ld_t;
  __device__ void operator()(int m, int n, float2 v) const {
    const size_t o = (size_t)m * ld + n;
    const float2 s = ld2(gp + o);
    const float d0 = v.x * s.x, d1 = v.y * s.y;
    *reinterpret_cast<float2*>(gp + o) = make_float2(d0, d1);
    *reinterpret_cast<uint32_t*>(da + o) = pack2(d0, d1);
    dat[(size_t)n * ld_t + m] = __float2bfloat16_rn(d0);
    dat[(size_t)(n + 1) * ld_t + m] = __float2bfloat16_rn(d1);
  }
};

// ----------------------------------------------------------------- row kernels
// One warp per row; lane l holds columns 4l + 128q .. +3.

// LayerNorm forward (the forward kernel's two passes over registers) and the
// cotangent of u: xhat, xn = xhat * ln_w + ln_b, d_u = (g * sd) * gamma, and
// 1 / sqrt(var + eps); x and g of T (f32, or bf16 widened as read).
template <int C, class T>
__global__ void __launch_bounds__(kThreads) prep_rows(
    const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ sd,
    const float* __restrict__ lnw, const float* __restrict__ lnb, const float* __restrict__ gamma,
    float* __restrict__ xhat, float* __restrict__ xn, float* __restrict__ du,
    float* __restrict__ rstd, int n) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= n) return;
  const size_t base = (size_t)row * C;
  float4 v[C / 128];
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < C / 128; ++q) {
    v[q] = ld4(x + base + 4 * lane + 128 * q);
    s += (v[q].x + v[q].y) + (v[q].z + v[q].w);
  }
  const float mu = warp_sum(s) * (1.0f / C);
  float ss = 0.f;
#pragma unroll
  for (int q = 0; q < C / 128; ++q) {
    const float a = v[q].x - mu, b = v[q].y - mu, c = v[q].z - mu, d = v[q].w - mu;
    ss += (a * a + b * b) + (c * c + d * d);
  }
  const float r = rsqrtf(warp_sum(ss) * (1.0f / C) + kLnEps);
  const float srow = sd[row];
#pragma unroll
  for (int q = 0; q < C / 128; ++q) {
    const int c = 4 * lane + 128 * q;
    const float4 w = ld4(lnw + c), b = ld4(lnb + c), gm = ld4(gamma + c), gv = ld4(g + base + c);
    float xh[4], xo[4], dv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      xh[e] = (at(v[q], e) - mu) * r;
      xo[e] = xh[e] * at(w, e) + at(b, e);
      dv[e] = (at(gv, e) * srow) * at(gm, e);
    }
    st4(xhat + base + c, make_float4(xh[0], xh[1], xh[2], xh[3]));
    st4(xn + base + c, make_float4(xo[0], xo[1], xo[2], xo[3]));
    st4(du + base + c, make_float4(dv[0], dv[1], dv[2], dv[3]));
  }
  if (lane == 0) rstd[row] = r;
}

// LayerNorm backward and d_sd: d_xhat = d_xn * ln_w,
// d_x = r * (d_xhat - mean(d_xhat) - xhat * mean(d_xhat * xhat)),
// d_sd = sum(g * (u * gamma)); g and d_x of T (bf16 d_x rounded once).
template <int C, class T>
__global__ void __launch_bounds__(kThreads) finish_rows(
    const float* __restrict__ dxn, const float* __restrict__ xhat, const float* __restrict__ rstd,
    const float* __restrict__ lnw, const T* __restrict__ g, const float* __restrict__ u,
    const float* __restrict__ gamma, T* __restrict__ dx, float* __restrict__ dsd, int n) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= n) return;
  const size_t base = (size_t)row * C;
  float4 d[C / 128], xh[C / 128];
  float s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int q = 0; q < C / 128; ++q) {
    const int c = 4 * lane + 128 * q;
    const float4 dn = ld4(dxn + base + c), w = ld4(lnw + c), gv = ld4(g + base + c);
    const float4 uv = ld4(u + base + c), gm = ld4(gamma + c);
    xh[q] = ld4(xhat + base + c);
    d[q] = make_float4(dn.x * w.x, dn.y * w.y, dn.z * w.z, dn.w * w.w);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s1 += at(d[q], e);
      s2 += at(d[q], e) * at(xh[q], e);
      s3 += at(gv, e) * (at(uv, e) * at(gm, e));
    }
  }
  const float m1 = warp_sum(s1) * (1.0f / C), m2 = warp_sum(s2) * (1.0f / C);
  const float r = rstd[row];
  s3 = warp_sum(s3);
#pragma unroll
  for (int q = 0; q < C / 128; ++q) {
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = r * (at(d[q], e) - m1 - at(xh[q], e) * m2);
    st4(dx + base + 4 * lane + 128 * q, make_float4(o[0], o[1], o[2], o[3]));
  }
  if (lane == 0) dsd[row] = s3;
}

// ----------------------------------------------------------- column sums
// Block b sums rows [b * rows, (b + 1) * rows) into part[b][0 : 8C):
// [0, C) d_ln_w = sum d_xn * xhat, [C, 2C) d_ln_b = sum d_xn,
// [2C, 6C) d_b1 = sum d_a, [6C, 7C) d_b2 = sum d_u,
// [7C, 8C) d_gamma = sum (g * sd) * u.  d_a is read as its two TF32
// planes, `da_plane` floats apart (kDaPlanes 2), or as f32 (1); g is of T.
template <class T, int kDaPlanes = 2>
__global__ void __launch_bounds__(kThreads) column_partials(
    const float* __restrict__ dxn, const float* __restrict__ xhat, const float* __restrict__ da,
    long long da_plane, const float* __restrict__ du, const T* __restrict__ g, const float* __restrict__ sd,
    const float* __restrict__ u, float* __restrict__ part, int n, int c, int rows) {
  const int r0 = blockIdx.x * rows, r1 = min(n, r0 + rows);
  float* out = part + (size_t)blockIdx.x * 8 * c;
  for (int col = threadIdx.x; col < c; col += kThreads) {
    float lw = 0.f, lb = 0.f, b2 = 0.f, gm = 0.f;
    for (int r = r0; r < r1; ++r) {
      const size_t o = (size_t)r * c + col;
      const float dn = dxn[o];
      lw += dn * xhat[o];
      lb += dn;
      b2 += du[o];
      gm += (to_f32(g[o]) * sd[r]) * u[o];
    }
    out[col] = lw;
    out[c + col] = lb;
    out[6 * c + col] = b2;
    out[7 * c + col] = gm;
  }
  for (int col = threadIdx.x; col < 4 * c; col += kThreads) {
    float s = 0.f;
    for (int r = r0; r < r1; ++r) {
      const size_t o = (size_t)r * 4 * c + col;
      s += kDaPlanes == 2 ? da[o] + da[da_plane + o] : da[o];
    }
    out[2 * c + col] = s;
  }
}

// Adds the partials of every chunk in order.
__global__ void __launch_bounds__(kThreads) column_finish(
    const float* __restrict__ part, int chunks, int c, float* __restrict__ dlnw,
    float* __restrict__ dlnb, float* __restrict__ db1, float* __restrict__ db2,
    float* __restrict__ dgamma) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= 8 * c) return;
  float s = 0.f;
  for (int b = 0; b < chunks; ++b) s += part[(size_t)b * 8 * c + col];
  if (col < c) dlnw[col] = s;
  else if (col < 2 * c) dlnb[col - c] = s;
  else if (col < 6 * c) db1[col - 2 * c] = s;
  else if (col < 7 * c) db2[col - 6 * c] = s;
  else dgamma[col - 7 * c] = s;
}

// out = sum of `splits` slabs of `count4` float4s, in slab order.
__global__ void __launch_bounds__(kThreads) sum_splits(
    const float* __restrict__ part, int splits, long long count4, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= count4) return;
  float4 s = ld4(part + 4 * i);
  for (int z = 1; z < splits; ++z) {
    const float4 p = ld4(part + (size_t)z * 4 * count4 + 4 * i);
    s = make_float4(s.x + p.x, s.y + p.y, s.z + p.z, s.w + p.w);
  }
  st4(out + 4 * i, s);
}

// ------------------------------------------------------------------- host side

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }
long long round32(long long v) { return (v + 31) / 32 * 32; }

// Where the workspace's arrays start (floats), and how the reductions split.
struct Plan {
  int splits, k_split;     // weight-gradient products: splits of the N rows
  int chunk_rows, chunks;  // column sums
  int ldn;                 // row stride of the transposed (., N) planes
  long long w1s, w1t, w2s, w2t, xhat, xn, du, u, dxn, xns, xnt, dus, dut, hs, ht, gp, das, dat, rstd,
      colpart, wpart, total;
};

// bf16: the bf16 instance's (backward_x3): no weight planes (the weights
// are read as they lie), no plain planes of xn and d_u (the x3 products
// read the f32 rows), h and d_a as one f32 copy each.
Plan make_plan(int n, int c, bool bf16) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  Plan p;
  // The weight-gradient products have (4C / 128) * (C / 128) output tiles,
  // one block per SM each.  Split their N-long reduction into the number of
  // parts that wastes the least of the last wave, keeping at least 256
  // rows per split.
  const long long tiles = (4LL * c / tf32x3::kBM) * (c / tf32x3::kBN);
  int best = 1;
  long long best_cost = -1;
  for (int s = 1; s <= max(1, n / 256); ++s) {
    const long long cost = (long long)ceil_div(tiles * s, sms) * ceil_div(n, s);
    if (best_cost < 0 || cost < best_cost) best = s, best_cost = cost;
  }
  p.k_split = (int)round32(ceil_div(n, best));
  p.splits = max(1, ceil_div(n, p.k_split));
  p.chunk_rows = max(16, ceil_div(n, 2 * sms));
  p.chunks = max(1, ceil_div(n, p.chunk_rows));
  p.ldn = (n + 3) / 4 * 4;
  const long long nc = (long long)n * c, n4c = 4 * nc, cc4 = 4LL * c * c, tc = (long long)c * p.ldn;
  long long off = 0;
  auto take = [&](long long floats) { const long long at_ = off; off += round32(floats); return at_; };
  const int planes = bf16 ? 0 : 2, hplanes = bf16 ? 1 : 2;
  p.w1s = take(planes * cc4);
  p.w1t = take(planes * cc4);
  p.w2s = take(planes * cc4);
  p.w2t = take(planes * cc4);
  p.xhat = take(nc);
  p.xn = take(nc);
  p.du = take(nc);
  p.u = take(nc);
  p.dxn = take(nc);
  p.xns = take(planes * nc);
  p.xnt = take(2 * tc);
  p.dus = take(planes * nc);
  p.dut = take(2 * tc);
  p.hs = take(hplanes * n4c);
  p.ht = take(8 * tc);
  p.gp = take(n4c);
  p.das = take(hplanes * n4c);
  p.dat = take(8 * tc);
  p.rstd = take(n);
  p.colpart = take((long long)p.chunks * 8 * c);
  p.wpart = take(p.splits > 1 ? (long long)p.splits * cc4 : 0);
  p.total = off;
  return p;
}

#define TC_TRY(expr)                          \
  do {                                        \
    const cudaError_t e_ = (expr);            \
    if (e_ != cudaSuccess) return (int)e_;    \
  } while (0)

// The f32 instance.
template <int C>
int backward(const float* g, const float* x, const float* sd, const float* lnw, const float* lnb,
             const float* w1, const float* b1, const float* w2, const float* b2,
             const float* gamma, float* dx, float* dsd, float* dlnw, float* dlnb, float* dw1,
             float* db1, float* dw2, float* db2, float* dgamma, float* work, int n,
             cudaStream_t s) {
  using tf32x3::Operand;
  using tf32x3::gemm;
  using tf32x3::split;
  constexpr int C4 = 4 * C;
  const Plan p = make_plan(n, C, false);
  const int ldn = p.ldn;
  float *w1s = work + p.w1s, *w1t = work + p.w1t, *w2s = work + p.w2s, *w2t = work + p.w2t;
  float *xhat = work + p.xhat, *xn = work + p.xn, *du = work + p.du, *u = work + p.u;
  float *dxn = work + p.dxn, *xns = work + p.xns, *xnt = work + p.xnt, *dus = work + p.dus;
  float *dut = work + p.dut, *hs = work + p.hs, *ht = work + p.ht, *gp = work + p.gp;
  float *das = work + p.das, *dat = work + p.dat, *rstd = work + p.rstd;
  float *colpart = work + p.colpart, *wpart = work + p.wpart;
  const int row_blocks = ceil_div(n, kThreads / 32);
  const long long nc = (long long)n * C, cc4 = 4LL * C * C, tc = (long long)C * ldn;

  // The weights' planes: W1 (4C, C) and W1^T (C, 4C), W2 (C, 4C) and W2^T (4C, C).
  TC_TRY(split(w1, C4, C, w1s, w1t, C4, s));
  TC_TRY(split(w2, C, C4, w2s, w2t, C, s));
  prep_rows<C, float><<<row_blocks, kThreads, 0, s>>>(x, g, sd, lnw, lnb, gamma, xhat, xn, du, rstd, n);
  TC_TRY(cudaGetLastError());
  TC_TRY(split(xn, n, C, xns, xnt, ldn, s));
  TC_TRY(split(du, n, C, dus, dut, ldn, s));

  const Operand xn_op{xns, n, C, C, nc}, w1_op{w1s, C4, C, C, cc4}, h_op{hs, n, C4, C4, 4 * nc};
  const Operand w2_op{w2s, C, C4, C4, cc4}, du_op{dus, n, C, C, nc}, w2t_op{w2t, C4, C, C, cc4};
  const Operand da_op{das, n, C4, C4, 4 * nc}, w1t_op{w1t, C, C4, C4, cc4};
  const Operand dat_op{dat, C4, n, ldn, 4 * tc}, xnt_op{xnt, C, n, ldn, tc};
  const Operand dut_op{dut, C, n, ldn, tc}, ht_op{ht, C4, n, ldn, 4 * tc};
  // a = xn W1^T + b1 -> h (planes, plain and transposed), gelu'(a)
  TC_TRY(gemm(xn_op, w1_op, GeluEpi{b1, hs, ht, gp, 4 * nc, 4 * tc, C4, ldn}, s));
  // u = h W2^T + b2
  TC_TRY(gemm(h_op, w2_op, BiasEpi{b2, u, C}, s));
  // d_a = (d_u W2) * gelu'(a) (planes, plain and transposed)
  TC_TRY(gemm(du_op, w2t_op, MulEpi{gp, das, dat, 4 * nc, 4 * tc, C4, ldn}, s));
  // d_xn = d_a W1
  TC_TRY(gemm(da_op, w1t_op, StoreEpi{dxn, C, 0}, s));
  finish_rows<C, float><<<row_blocks, kThreads, 0, s>>>(dxn, xhat, rstd, lnw, g, u, gamma, dx, dsd, n);
  TC_TRY(cudaGetLastError());

  // dW1 = d_a^T xn (4C, C) and dW2 = d_u^T h (C, 4C), reduced over the rows:
  // f32 activations on both sides, three TF32 products a k-step.
  const long long wsize = cc4;
  const int sum_blocks = ceil_div(wsize / 4, kThreads);
  float* out1 = p.splits > 1 ? wpart : dw1;
  TC_TRY(gemm(dat_op, xnt_op, p.splits, p.k_split, StoreEpi{out1, C, wsize}, s));
  if (p.splits > 1) {
    sum_splits<<<sum_blocks, kThreads, 0, s>>>(wpart, p.splits, wsize / 4, dw1);
    TC_TRY(cudaGetLastError());
  }
  float* out2 = p.splits > 1 ? wpart : dw2;
  TC_TRY(gemm(dut_op, ht_op, p.splits, p.k_split, StoreEpi{out2, C4, wsize}, s));
  if (p.splits > 1) {
    sum_splits<<<sum_blocks, kThreads, 0, s>>>(wpart, p.splits, wsize / 4, dw2);
    TC_TRY(cudaGetLastError());
  }

  column_partials<float><<<p.chunks, kThreads, 0, s>>>(dxn, xhat, das, 4 * nc, du, g, sd, u, colpart, n, C,
                                                 p.chunk_rows);
  TC_TRY(cudaGetLastError());
  column_finish<<<ceil_div(8 * C, kThreads), kThreads, 0, s>>>(colpart, p.chunks, C, dlnw, dlnb, db1, db2, dgamma);
  return (int)cudaGetLastError();
}

// The bf16 instance: bf16 g, x, weights and d_x (the notes above).
template <int C>
int backward_x3(const bf16* g, const bf16* x, const float* sd, const float* lnw, const float* lnb, const bf16* w1,
                const float* b1, const bf16* w2, const float* b2, const float* gamma, bf16* dx, float* dsd,
                float* dlnw, float* dlnb, float* dw1, float* db1, float* dw2, float* db2, float* dgamma, float* work,
                int n, cudaStream_t s) {
  using tf32x3::Operand;
  namespace x3 = bf16mm::x3;
  constexpr int C4 = 4 * C;
  const Plan p = make_plan(n, C, true);
  const int ldn = p.ldn;
  float *xhat = work + p.xhat, *xn = work + p.xn, *du = work + p.du, *u = work + p.u, *dxn = work + p.dxn;
  float *xnt = work + p.xnt, *dut = work + p.dut, *h = work + p.hs, *ht = work + p.ht, *gp = work + p.gp;
  float *da = work + p.das, *dat = work + p.dat, *rstd = work + p.rstd;
  float *colpart = work + p.colpart, *wpart = work + p.wpart;
  const int row_blocks = ceil_div(n, kThreads / 32);
  const long long cc4 = 4LL * C * C, tc = (long long)C * ldn;

  prep_rows<C, bf16><<<row_blocks, kThreads, 0, s>>>(x, g, sd, lnw, lnb, gamma, xhat, xn, du, rstd, n);
  TC_TRY(cudaGetLastError());
  TC_TRY(tf32x3::split(xn, n, C, nullptr, xnt, ldn, s));
  TC_TRY(tf32x3::split(du, n, C, nullptr, dut, ldn, s));

  // a = xn W1^T + b1 -> h (f32, and transposed planes), gelu'(a)
  TC_TRY(x3::gemm<0>(xn, w1, n, C, C4, x3::RowsA{}, GeluEpiX3{b1, h, ht, gp, 4 * tc, C4, ldn}, s));
  // u = h W2^T + b2
  TC_TRY(x3::gemm<0>(h, w2, n, C4, C, x3::RowsA{}, BiasEpi{b2, u, C}, s));
  // d_a = (d_u W2) * gelu'(a), W2 (C, 4C) read MN-major
  TC_TRY(x3::gemm<1>(du, w2, n, C, C4, x3::RowsA{}, MulEpiX3{gp, da, dat, 4 * tc, C4, ldn}, s));
  // d_xn = d_a W1, W1 (4C, C) read MN-major
  TC_TRY(x3::gemm<1>(da, w1, n, C4, C, x3::RowsA{}, StoreEpi{dxn, C, 0}, s));
  finish_rows<C, bf16><<<row_blocks, kThreads, 0, s>>>(dxn, xhat, rstd, lnw, g, u, gamma, dx, dsd, n);
  TC_TRY(cudaGetLastError());

  // dW1 = d_a^T xn (4C, C) and dW2 = d_u^T h (C, 4C), reduced over the rows
  // on 3xTF32, as the f32 instance's.
  const Operand dat_op{dat, C4, n, ldn, 4 * tc}, xnt_op{xnt, C, n, ldn, tc};
  const Operand dut_op{dut, C, n, ldn, tc}, ht_op{ht, C4, n, ldn, 4 * tc};
  const int sum_blocks = ceil_div(cc4 / 4, kThreads);
  float* out1 = p.splits > 1 ? wpart : dw1;
  TC_TRY(tf32x3::gemm(dat_op, xnt_op, p.splits, p.k_split, StoreEpi{out1, C, cc4}, s));
  if (p.splits > 1) {
    sum_splits<<<sum_blocks, kThreads, 0, s>>>(wpart, p.splits, cc4 / 4, dw1);
    TC_TRY(cudaGetLastError());
  }
  float* out2 = p.splits > 1 ? wpart : dw2;
  TC_TRY(tf32x3::gemm(dut_op, ht_op, p.splits, p.k_split, StoreEpi{out2, C4, cc4}, s));
  if (p.splits > 1) {
    sum_splits<<<sum_blocks, kThreads, 0, s>>>(wpart, p.splits, cc4 / 4, dw2);
    TC_TRY(cudaGetLastError());
  }

  column_partials<bf16, 1><<<p.chunks, kThreads, 0, s>>>(dxn, xhat, da, 0, du, g, sd, u, colpart, n, C, p.chunk_rows);
  TC_TRY(cudaGetLastError());
  column_finish<<<ceil_div(8 * C, kThreads), kThreads, 0, s>>>(colpart, p.chunks, C, dlnw, dlnb, db1, db2, dgamma);
  return (int)cudaGetLastError();
}

// ------------------------------------------- the precise=False arm (bf16 products)
// The TPU kernel _bwd_kernel with mxu_dtype=bfloat16: its mm (:291-296)
// rounds both operands of each of the six products to bf16 and sums in
// f32.  The structure is backward()'s, with the bf16 GEMM of bf16_gemm.cuh
// (P = A B^T, K-major bf16 operands, one exact product a k-step) and the
// operands rounded where the TPU kernel rounds them: xn and d_u by to_bf16
// (plain and transposed) from prep_rows' f32 rows; h and d_a by the
// epilogues of products 1 and 3; the weights by to_bf16 (a bf16 weight is
// read where it lies, its transpose made by to_bf16).  The f32 sums the
// TPU kernel takes of unrounded values stay f32: d_xn, u, gelu'(a), d_a
// for d_b1, and the row kernels.  d_W1 and d_W2 are f32; the caller
// rounds them to a bf16 weight's dtype once, as JAX's .astype(w1.dtype)
// (:476).

struct PlanBf16 {
  int splits, k_split, chunk_rows, chunks, ldn;
  long long w1b, w1t, w2b, w2t, xhat, xn, du, u, dxn, xnb, xnt, dub, dut, hb, ht, gp, dab, dat, rstd, colpart,
      wpart, total;
};

PlanBf16 make_plan_bf16(int n, int c) {
  const Plan q = make_plan(n, c, true);  // the splits and chunks of the f32 design
  PlanBf16 p;
  p.k_split = (q.k_split + bf16mm::kBK - 1) / bf16mm::kBK * bf16mm::kBK;
  p.splits = max(1, ceil_div(n, p.k_split));
  p.chunk_rows = q.chunk_rows;
  p.chunks = q.chunks;
  p.ldn = (n + 7) / 8 * 8;  // 16-byte rows of the transposed bf16 copies
  const long long nc = (long long)n * c, cc4 = 4LL * c * c, tc = (long long)c * p.ldn;
  long long off = 0;
  auto take = [&](long long floats) { const long long at_ = off; off += round32(floats); return at_; };
  p.w1b = take(cc4 / 2);
  p.w1t = take(cc4 / 2);
  p.w2b = take(cc4 / 2);
  p.w2t = take(cc4 / 2);
  p.xhat = take(nc);
  p.xn = take(nc);
  p.du = take(nc);
  p.u = take(nc);
  p.dxn = take(nc);
  p.xnb = take(nc / 2);
  p.xnt = take(tc / 2);
  p.dub = take(nc / 2);
  p.dut = take(tc / 2);
  p.hb = take(2 * nc);
  p.ht = take(2 * tc);
  p.gp = take(4 * nc);
  p.dab = take(2 * nc);
  p.dat = take(2 * tc);
  p.rstd = take(n);
  p.colpart = take((long long)p.chunks * 8 * c);
  p.wpart = take(p.splits > 1 ? (long long)p.splits * cc4 : 0);
  p.total = off;
  return p;
}

template <int C, class T>
int backward_bf16(const T* g, const T* x, const float* sd, const float* lnw, const float* lnb, const T* w1,
                  const float* b1, const T* w2, const float* b2, const float* gamma, T* dx, float* dsd, float* dlnw,
                  float* dlnb, float* dw1, float* db1, float* dw2, float* db2, float* dgamma, float* work, int n,
                  cudaStream_t s) {
  using bf16mm::Operand;
  using bf16mm::gemm;
  using bf16mm::to_bf16;
  constexpr int C4 = 4 * C;
  const PlanBf16 p = make_plan_bf16(n, C);
  const int ldn = p.ldn;
  auto arr = [&](long long at_) { return reinterpret_cast<bf16*>(work + at_); };  // a bf16 array of the workspace
  bf16 *w1t = arr(p.w1t), *w2t = arr(p.w2t), *xnb = arr(p.xnb), *xnt = arr(p.xnt), *dub = arr(p.dub);
  bf16 *dut = arr(p.dut), *hb = arr(p.hb), *ht = arr(p.ht), *dab = arr(p.dab), *dat = arr(p.dat);
  float *xhat = work + p.xhat, *xn = work + p.xn, *du = work + p.du, *u = work + p.u, *dxn = work + p.dxn;
  float *gp = work + p.gp, *rstd = work + p.rstd, *colpart = work + p.colpart, *wpart = work + p.wpart;
  const int row_blocks = ceil_div(n, kThreads / 32);
  const long long cc4 = 4LL * C * C;

  // The weights in bf16: W1 (4C, C) and W1^T (C, 4C), W2 (C, 4C) and W2^T
  // (4C, C); a bf16 weight's plain copy is itself.
  constexpr bool kBf16 = sizeof(T) == 2;
  const bf16* w1b = kBf16 ? reinterpret_cast<const bf16*>(w1) : arr(p.w1b);
  const bf16* w2b = kBf16 ? reinterpret_cast<const bf16*>(w2) : arr(p.w2b);
  TC_TRY(to_bf16(w1, C4, C, kBf16 ? nullptr : arr(p.w1b), w1t, C4, s));
  TC_TRY(to_bf16(w2, C, C4, kBf16 ? nullptr : arr(p.w2b), w2t, C, s));
  prep_rows<C, T><<<row_blocks, kThreads, 0, s>>>(x, g, sd, lnw, lnb, gamma, xhat, xn, du, rstd, n);
  TC_TRY(cudaGetLastError());
  TC_TRY(to_bf16(xn, n, C, xnb, xnt, ldn, s));
  TC_TRY(to_bf16(du, n, C, dub, dut, ldn, s));

  const Operand xn_op{xnb, n, C, C}, w1_op{w1b, C4, C, C}, h_op{hb, n, C4, C4}, w2_op{w2b, C, C4, C4};
  const Operand du_op{dub, n, C, C}, w2t_op{w2t, C4, C, C}, da_op{dab, n, C4, C4}, w1t_op{w1t, C, C4, C4};
  const Operand dat_op{dat, C4, n, ldn}, xnt_op{xnt, C, n, ldn}, dut_op{dut, C, n, ldn}, ht_op{ht, C4, n, ldn};
  // a = xn W1^T + b1 -> bf16(h) (plain and transposed), gelu'(a)
  TC_TRY(gemm(xn_op, w1_op, GeluEpiBf16{b1, hb, ht, gp, C4, ldn}, s));
  // u = h W2^T + b2
  TC_TRY(gemm(h_op, w2_op, BiasEpi{b2, u, C}, s));
  // d_a = (d_u W2) * gelu'(a): f32 over gp, bf16 plain and transposed
  TC_TRY(gemm(du_op, w2t_op, MulEpiBf16{gp, dab, dat, C4, ldn}, s));
  // d_xn = d_a W1
  TC_TRY(gemm(da_op, w1t_op, StoreEpi{dxn, C, 0}, s));
  finish_rows<C, T><<<row_blocks, kThreads, 0, s>>>(dxn, xhat, rstd, lnw, g, u, gamma, dx, dsd, n);
  TC_TRY(cudaGetLastError());

  // dW1 = d_a^T xn (4C, C) and dW2 = d_u^T h (C, 4C), reduced over the rows.
  const int sum_blocks = ceil_div(cc4 / 4, kThreads);
  float* out1 = p.splits > 1 ? wpart : dw1;
  TC_TRY(gemm(dat_op, xnt_op, p.splits, p.k_split, StoreEpi{out1, C, cc4}, s));
  if (p.splits > 1) {
    sum_splits<<<sum_blocks, kThreads, 0, s>>>(wpart, p.splits, cc4 / 4, dw1);
    TC_TRY(cudaGetLastError());
  }
  float* out2 = p.splits > 1 ? wpart : dw2;
  TC_TRY(gemm(dut_op, ht_op, p.splits, p.k_split, StoreEpi{out2, C4, cc4}, s));
  if (p.splits > 1) {
    sum_splits<<<sum_blocks, kThreads, 0, s>>>(wpart, p.splits, cc4 / 4, dw2);
    TC_TRY(cudaGetLastError());
  }

  column_partials<T, 1><<<p.chunks, kThreads, 0, s>>>(dxn, xhat, gp, 0, du, g, sd, u, colpart, n, C, p.chunk_rows);
  TC_TRY(cudaGetLastError());
  column_finish<<<ceil_div(8 * C, kThreads), kThreads, 0, s>>>(colpart, p.chunks, C, dlnw, dlnb, db1, db2, dgamma);
  return (int)cudaGetLastError();
}

// backward_bf16 at width c, on data of T.
template <class T>
int backward_bf16_any(const void* g, const void* x, const float* sd, const float* lnw, const float* lnb,
                      const void* w1, const float* b1, const void* w2, const float* b2, const float* gamma, void* dx,
                      float* dsd, float* dlnw, float* dlnb, float* dw1, float* db1, float* dw2, float* db2,
                      float* dgamma, float* work, int n, int c, cudaStream_t s) {
#define TC_ARGS static_cast<const T*>(g), static_cast<const T*>(x), sd, lnw, lnb, static_cast<const T*>(w1), b1, \
                static_cast<const T*>(w2), b2, gamma, static_cast<T*>(dx), dsd, dlnw, dlnb, dw1, db1, dw2, db2, \
                dgamma, work, n, s
  switch (c) {
    case 128: return backward_bf16<128>(TC_ARGS);
    case 256: return backward_bf16<256>(TC_ARGS);
    case 512: return backward_bf16<512>(TC_ARGS);
    case 1024: return backward_bf16<1024>(TC_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TC_ARGS
}

}  // namespace

extern "C" {

// Floats of workspace tc_mlp_block_backward needs for n rows of width c.
long long tc_mlp_block_backward_workspace(int n, int c) { return make_plan(n, c, false).total; }

// The same for tc_mlp_block_backward_bf16 (no weight planes; h and d_a in f32).
long long tc_mlp_block_backward_bf16_workspace(int n, int c) { return make_plan(n, c, true).total; }

int tc_mlp_block_backward(const float* g, const float* x, const float* sd, const float* lnw,
                          const float* lnb, const float* w1, const float* b1, const float* w2,
                          const float* b2, const float* gamma, float* dx, float* dsd,
                          float* dlnw, float* dlnb, float* dw1, float* db1, float* dw2,
                          float* db2, float* dgamma, float* work, int n, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaErrorInvalidValue;
#define TC_ARGS g, x, sd, lnw, lnb, w1, b1, w2, b2, gamma, dx, dsd, dlnw, dlnb, dw1, db1, dw2, db2, dgamma, work, n, s
  switch (c) {
    case 128: return backward<128>(TC_ARGS);
    case 256: return backward<256>(TC_ARGS);
    case 512: return backward<512>(TC_ARGS);
    case 1024: return backward<1024>(TC_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TC_ARGS
}

// The bf16 instance: g, x, w1, w2 and dx bf16, the rest (sd, the vectors,
// every other gradient and the workspace) f32, as tc_mlp_block_backward;
// the workspace is tc_mlp_block_backward_bf16_workspace floats.
int tc_mlp_block_backward_bf16(const void* g, const void* x, const float* sd, const float* lnw,
                               const float* lnb, const void* w1, const float* b1, const void* w2,
                               const float* b2, const float* gamma, void* dx, float* dsd,
                               float* dlnw, float* dlnb, float* dw1, float* db1, float* dw2,
                               float* db2, float* dgamma, float* work, int n, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaErrorInvalidValue;
#define TC_ARGS static_cast<const bf16*>(g), static_cast<const bf16*>(x), sd, lnw, lnb, static_cast<const bf16*>(w1), \
                b1, static_cast<const bf16*>(w2), b2, gamma, static_cast<bf16*>(dx), dsd, dlnw, dlnb, dw1, db1, dw2, \
                db2, dgamma, work, n, s
  switch (c) {
    case 128: return backward_x3<128>(TC_ARGS);
    case 256: return backward_x3<256>(TC_ARGS);
    case 512: return backward_x3<512>(TC_ARGS);
    case 1024: return backward_x3<1024>(TC_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TC_ARGS
}

// Floats of workspace tc_mlp_block_backward_bf16_products needs.
long long tc_mlp_block_backward_bf16_products_workspace(int n, int c) { return make_plan_bf16(n, c).total; }

// The precise=False arm (bf16 products): g, x, w1, w2 and dx f32
// (data_bf16 0) or bf16 (data_bf16 1), the rest f32 as
// tc_mlp_block_backward; the workspace
// tc_mlp_block_backward_bf16_products_workspace floats.
int tc_mlp_block_backward_bf16_products(const void* g, const void* x, const float* sd, const float* lnw,
                                        const float* lnb, const void* w1, const float* b1, const void* w2,
                                        const float* b2, const float* gamma, void* dx, float* dsd, float* dlnw,
                                        float* dlnb, float* dw1, float* db1, float* dw2, float* db2, float* dgamma,
                                        float* work, int n, int c, int data_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaErrorInvalidValue;
  return data_bf16 ? backward_bf16_any<__nv_bfloat16>(g, x, sd, lnw, lnb, w1, b1, w2, b2, gamma, dx, dsd, dlnw,
                                                       dlnb, dw1, db1, dw2, db2, dgamma, work, n, c, s)
                   : backward_bf16_any<float>(g, x, sd, lnw, lnb, w1, b1, w2, b2, gamma, dx, dsd, dlnw, dlnb, dw1,
                                              db1, dw2, db2, dgamma, work, n, c, s);
}

const char* tc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
