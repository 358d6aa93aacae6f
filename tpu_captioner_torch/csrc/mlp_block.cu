// Fused ConvNeXt block tail, forward, f32, for Hopper (sm_90a).
//
// Replaces the TPU kernels tpu_captioner/ops/mlp_block.py:_kernel (SUB = 0)
// and, as the SUB > 0 instances, _kernel_pipelined (both launched by
// _fused_pallas under fused_convnext_mlp).  Per row of the (N, C)
// depthwise-conv output it computes
//
//     out = res + sd * ((gelu(LN(x) W1^T + b1) W2^T + b2) * gamma)
//
// with LayerNorm eps 1e-6 and the exact erf GELU.  W1 is (4C, C) and W2 is
// (C, 4C): the nn.Linear weights as the reference checkpoint stores them.
//
// The whole-tile path (SUB = 0, the default).  What bounds it on the H100:
// the two products, 16*N*C^2 flops, at the f32-accurate tensor-core rate
// (3xTF32, tf32x3_gemm.cuh: 165 TFLOP/s); 7.50 ms per bs-32 encoder pass.
// The design: three launches and the weights' split per call.
// - ln_rows (here): LayerNorm, one warp per row, writes LN(x) as its two
//   TF32 planes (N, C);
// - gemm 1: h = gelu(LN(x) W1^T + b1), the GELU in the epilogue, which
//   writes h's two planes (N, 4C) to device memory;
// - gemm 2: out = res + sd * ((h W2^T + b2) * gamma), all in the epilogue.
// The two products, their epilogues, the workspace plan and the weights'
// split are mlp_products.cuh's, which the whole-block kernel
// (block_fused.cu) runs too.  The TPU kernel keeps h in VMEM.  Here it goes
// through device memory (and mostly L2): a wgmma accumulator covers 64
// rows, and a 64 x C f32 output tile of the second product (256 KB at C =
// 1024) outgrows a warpgroup's registers, so the two products are two
// launches of one GEMM, shared with the backward.  Extra bytes per launch:
// h's planes written and read, 64*N*C; the LN planes, 16*N*C; the weight
// planes, 64*C^2.  About 3.1 ms per bs-32 encoder pass at 3.35 TB/s.
//
// The sub-tiled instances (SUB > 0, TPU_CAPTIONER_MLP_SUB) run the f32
// FFMA tail of mlp_tail.cuh, which nothing else runs: this file holds their
// LayerNorm prologue, which reads the rows from device memory; the tail
// itself, what bounds it and its design are in that header.

#include "mlp_products.cuh"
#include "mlp_tail.cuh"

namespace {

template <class K>
__global__ void __launch_bounds__(kThreads) mlp_block_kernel(
    const float* __restrict__ x, const float* __restrict__ res,
    const float* __restrict__ sd, const float* __restrict__ lnw,
    const float* __restrict__ lnb, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ gamma,
    float* __restrict__ out, int n) {
  constexpr int C = K::C, BM = K::BM, BMP = K::BMP;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;  // (C, BMP) LN(x), k-major

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int q_rank = blockIdx.x % K::S;  // this block's share of the hidden dim
  const int row0 = (blockIdx.x / K::S) * BM;

  // LayerNorm, one warp per row, two passes over registers.  Rows past n
  // are normalised zeros and are never stored.
  for (int r = warp; r < BM; r += kThreads / 32) {
    const int g = row0 + r;
    float4 v[C / 128];
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < C / 128; ++q) {
      v[q] = g < n ? ld4(x + (size_t)g * C + 4 * lane + 128 * q) : make_float4(0.f, 0.f, 0.f, 0.f);
      s += (v[q].x + v[q].y) + (v[q].z + v[q].w);
    }
    const float mu = warp_sum(s) * (1.0f / C);
    float ss = 0.f;
#pragma unroll
    for (int q = 0; q < C / 128; ++q) {
      const float a = v[q].x - mu, b = v[q].y - mu, c = v[q].z - mu, d = v[q].w - mu;
      ss += (a * a + b * b) + (c * c + d * d);
    }
    const float rstd = rsqrtf(warp_sum(ss) * (1.0f / C) + kLnEps);
#pragma unroll
    for (int q = 0; q < C / 128; ++q) {
      const int c = 4 * lane + 128 * q;
      const float4 w = ld4(lnw + c), b = ld4(lnb + c);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xs[(c + e) * BMP + r] = (at(v[q], e) - mu) * rstd * at(w, e) + at(b, e);
    }
  }
  mlp_tail<K>(smem, res, sd, 1, w1, b1, w2, b2, gamma, out, n, row0, q_rank);
}

template <class K>
int launch(const float* x, const float* res, const float* sd, const float* lnw,
           const float* lnb, const float* w1, const float* b1, const float* w2,
           const float* b2, const float* gamma, float* out, int n, cudaStream_t stream) {
  return launch_tail<K>(mlp_block_kernel<K>, n, stream, x, res, sd, lnw, lnb, w1, b1, w2, b2,
                        gamma, out, n);
}

// ------------------------------------------------ the whole-tile path (SUB = 0)

// LayerNorm of each row into its two TF32 planes, xs (N, C) and xs + N*C.
template <int C>
__global__ void __launch_bounds__(kThreads) ln_rows(const float* __restrict__ x, const float* __restrict__ lnw,
                                                   const float* __restrict__ lnb, float* __restrict__ xs,
                                                   int n) {
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
  const float rstd = rsqrtf(warp_sum(ss) * (1.0f / C) + kLnEps);
  const long long plane = (long long)n * C;
#pragma unroll
  for (int q = 0; q < C / 128; ++q) {
    const int c = 4 * lane + 128 * q;
    const float4 w = ld4(lnw + c), b = ld4(lnb + c);
#pragma unroll
    for (int e = 0; e < 4; e += 2)
      tf32x3::store_split2(xs, plane, base + c + e, (at(v[q], e) - mu) * rstd * at(w, e) + at(b, e),
                           (at(v[q], e + 1) - mu) * rstd * at(w, e + 1) + at(b, e + 1));
  }
}

template <int C>
int whole_tile(const float* x, const float* res, const float* sd, const float* lnw, const float* lnb,
               const float* w1, const float* b1, const float* w2, const float* b2, const float* gamma,
               float* out, float* work, int n, cudaStream_t s) {
  cudaError_t err = split_weights<C>(w1, w2, work, n, s);
  if (err != cudaSuccess) return (int)err;
  ln_rows<C><<<(n + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, s>>>(x, lnw, lnb, work + make_plan(n, C).xs,
                                                                             n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)products<C>(res, sd, 1, b1, b2, gamma, out, work, n, s);
}

// The sub-tiled instances' tiles by width.  The narrow stages have rows to
// spare (bs 8: 32768 and 8192 rows) and take S = 1; the wide ones (2048 and
// 512 rows) split the hidden dimension over a cluster so that there are 128
// blocks to run.
template <int C, int BM, int S, int JC, int TM1, int TN1, int TM2, int TN2>
int launch_width(const float* x, const float* res, const float* sd, const float* lnw,
                 const float* lnb, const float* w1, const float* b1, const float* w2,
                 const float* b2, const float* gamma, float* out, float* work, int n, int sub,
                 cudaStream_t s) {
  if (sub == 0) return whole_tile<C>(x, res, sd, lnw, lnb, w1, b1, w2, b2, gamma, out, work, n, s);
#define TC_MLP_SUB(SUB)                                                                          \
  launch<Cfg<C, BM, S, JC, TM1, TN1, TM2, TN2, SUB>>(x, res, sd, lnw, lnb, w1, b1, w2, b2, gamma, \
                                                     out, n, s)
  // The sub-tile rows each width takes (ops/mlp_block.py:_pipeline_sub):
  // multiples of 4 that divide BM at least twice, with SUB * JC >= 1024 so
  // that each thread holds a 4 x TN1S tile.
  if constexpr (BM == 64) {
    if (sub == 32) return TC_MLP_SUB(32);
    if (sub == 16) return TC_MLP_SUB(16);
    if (sub == 8) return TC_MLP_SUB(8);
  } else if constexpr (BM == 32) {
    if (sub == 16) return TC_MLP_SUB(16);
    if (sub == 8) return TC_MLP_SUB(8);
    if (sub == 4) return TC_MLP_SUB(4);
  } else if constexpr (BM == 16) {
    if (sub == 8) return TC_MLP_SUB(8);
    if (sub == 4) return TC_MLP_SUB(4);
  }
#undef TC_MLP_SUB
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Floats of workspace tc_mlp_block_forward needs for n rows of width c:
// the whole-tile path's TF32 planes; the sub-tiled instances need none.
long long tc_mlp_block_forward_workspace(int n, int c, int sub) { return sub ? 0 : make_plan(n, c).total; }

// `sub` is 0 (the whole-tile path, on the tensor cores) or a sub-tile row
// count the width takes; any other value returns cudaErrorInvalidValue.
// `work` holds tc_mlp_block_forward_workspace(n, c, sub) floats.
int tc_mlp_block_forward(const float* x, const float* res, const float* sd,
                         const float* lnw, const float* lnb, const float* w1,
                         const float* b1, const float* w2, const float* b2,
                         const float* gamma, float* out, float* work, int n, int c, int sub,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaErrorInvalidValue;
#define TC_ARGS x, res, sd, lnw, lnb, w1, b1, w2, b2, gamma, out, work, n, sub, s
  switch (c) {
    case 128: return launch_width<128, 64, 1, 128, 8, 4, 8, 4>(TC_ARGS);
    case 256: return launch_width<256, 32, 1, 256, 8, 4, 8, 4>(TC_ARGS);
    case 512: return launch_width<512, 32, 2, 256, 8, 4, 8, 8>(TC_ARGS);
    case 1024: return launch_width<1024, 16, 4, 256, 4, 4, 8, 8>(TC_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TC_ARGS
}

const char* tc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
