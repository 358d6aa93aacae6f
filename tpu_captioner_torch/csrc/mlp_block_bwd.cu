// Fused ConvNeXt block tail, backward, f32, for Hopper (sm_90a).
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
// (N*C^2 = 2.1e9) that is 103 GFLOP, 1.54 ms at the 67 TFLOP/s f32 peak,
// against about 0.1 ms for its bytes even with the (N, 4C) intermediates
// written to device memory and read back.  So the intermediates may live in
// device memory, and what matters is the FFMA rate of the six products.
//
// What the design does about it:
// - six products, each a launch of one register-tiled FFMA GEMM (128 x 128
//   block tile, 8 x 8 per thread, k-slices of 8 double-buffered in shared
//   memory through registers), with fused epilogues: bias + GELU + GELU'
//   after the first, bias after the second, the product with GELU' after
//   the third.  Plain f32 FFMA: TF32 would lose the agreement with the f32
//   reference;
// - the TPU kernel carried the weight-gradient sums from one grid step to
//   the next; Hopper blocks run in no order, so the two weight-gradient
//   products split the row (reduction) dimension over enough blocks to fill
//   the SMs, write per-split partials, and a second pass adds them in a
//   fixed order; the five column sums are per-chunk partials plus a
//   fixed-order pass too.  No atomics, so a run repeats its bits;
// - row kernels (one warp per row) do LayerNorm and its backward, d_u and
//   d_sd;
// - any N: rows past N are never read (loads are masked, not scaled: a
//   padding row could hold NaN).
// Later PRs: wgmma/TMA, and keeping the intermediates on chip.

#include <cuda_runtime.h>

#include "warp_reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128, kBK = 8;
constexpr int kPad = kBM + 4;  // row stride of the k-major shared tiles
constexpr float kLnEps = 1e-6f;
constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float at(float4 v, int e) { return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w; }

// ------------------------------------------------------------- GEMM epilogues
// Each takes a row m and four consecutive columns n..n+3 of the product.

struct StoreEpi {  // out[m, n] = v (with blockIdx.z selecting a split's slab)
  float* out;
  int ld;
  long long slab;
  __device__ void operator()(int m, int n, float4 v) const {
    st4(out + blockIdx.z * slab + (size_t)m * ld + n, v);
  }
};

struct GeluEpi {  // a = v + b1: h = gelu(a), gp = gelu'(a) = Phi(a) + a phi(a)
  const float* bias;
  float* h;
  float* gp;
  int ld;
  __device__ void operator()(int m, int n, float4 v) const {
    const float4 b = ld4(bias + n);
    float hv[4], gv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a = at(v, e) + at(b, e);
      const float cdf = 0.5f * (1.0f + erff(a * kInvSqrt2));
      hv[e] = a * cdf;
      gv[e] = cdf + a * (expf(-0.5f * a * a) * kInvSqrt2Pi);
    }
    const size_t o = (size_t)m * ld + n;
    st4(h + o, make_float4(hv[0], hv[1], hv[2], hv[3]));
    st4(gp + o, make_float4(gv[0], gv[1], gv[2], gv[3]));
  }
};

struct BiasEpi {  // out = v + bias
  const float* bias;
  float* out;
  int ld;
  __device__ void operator()(int m, int n, float4 v) const {
    const float4 b = ld4(bias + n);
    st4(out + (size_t)m * ld + n, make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w));
  }
};

struct MulEpi {  // out = v * by (elementwise, same layout)
  const float* by;
  float* out;
  int ld;
  __device__ void operator()(int m, int n, float4 v) const {
    const size_t o = (size_t)m * ld + n;
    const float4 s = ld4(by + o);
    st4(out + o, make_float4(v.x * s.x, v.y * s.y, v.z * s.z, v.w * s.w));
  }
};

// -------------------------------------------------------------------- GEMM
// P[m, n] = sum over k in this block's split of A(m, k) * B(k, n), where
// A(m, k) = A[m * lda + k] if A_KM (k contiguous) else A[k * lda + m], and
// B(k, n) = B[n * ldb + k] if B_KM (k contiguous) else B[k * ldb + n].
// Contract (checked by the host): K % 8 == 0 when an operand is k-contiguous,
// M % 4 == 0 when A is m-contiguous, N % 4 == 0; M may be ragged when A is
// k-contiguous and K when both are not.  Block (x, y, z) owns columns
// [128x, 128x + 128), rows [128y, 128y + 128) and the k range of split z.
template <bool A_KM, bool B_KM, class Epi>
__global__ void __launch_bounds__(kThreads, 2) gemm_kernel(
    const float* __restrict__ A, const float* __restrict__ B, int M, int N, int K,
    int lda, int ldb, int k_split, Epi epi) {
  __shared__ __align__(16) float As[2][kBK][kPad];
  __shared__ __align__(16) float Bs[2][kBK][kPad];
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * k_split, ke = min(K, kb + k_split);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // One float4 of each operand per thread per k-slice of 8.
  float4 ra, rb;
  auto load = [&](int k0) {
    if (A_KM) {
      const int m = m0 + (t >> 1), k = k0 + (t & 1) * 4;
      ra = (m < M && k < ke) ? __ldg(reinterpret_cast<const float4*>(A + (size_t)m * lda + k)) : zero;
    } else {
      const int k = k0 + (t >> 5), m = m0 + (t & 31) * 4;
      ra = (k < ke && m < M) ? __ldg(reinterpret_cast<const float4*>(A + (size_t)k * lda + m)) : zero;
    }
    if (B_KM) {
      const int n = n0 + (t >> 1), k = k0 + (t & 1) * 4;
      rb = (n < N && k < ke) ? __ldg(reinterpret_cast<const float4*>(B + (size_t)n * ldb + k)) : zero;
    } else {
      const int k = k0 + (t >> 5), n = n0 + (t & 31) * 4;
      rb = (k < ke && n < N) ? __ldg(reinterpret_cast<const float4*>(B + (size_t)k * ldb + n)) : zero;
    }
  };
  auto store = [&](int buf) {
    if (A_KM) {
      const int m = t >> 1, kq = (t & 1) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) As[buf][kq + e][m] = at(ra, e);
    } else {
      st4(&As[buf][t >> 5][(t & 31) * 4], ra);
    }
    if (B_KM) {
      const int n = t >> 1, kq = (t & 1) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) Bs[buf][kq + e][n] = at(rb, e);
    } else {
      st4(&Bs[buf][t >> 5][(t & 31) * 4], rb);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (kb < ke) {
    load(kb);
    store(0);
    __syncthreads();
  }
  int buf = 0;
  for (int k0 = kb; k0 < ke; k0 += kBK) {
    const bool more = k0 + kBK < ke;
    if (more) load(k0 + kBK);  // in flight while this slice is multiplied
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = ld4(&As[buf][k][ty * 4]), a1 = ld4(&As[buf][k][64 + ty * 4]);
      const float4 b0 = ld4(&Bs[buf][k][tx * 4]), b1 = ld4(&Bs[buf][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // The other buffer was last read before the previous barrier.
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + half * 64 + tx * 4;
      if (n < N)
        epi(m, n, make_float4(acc[i][4 * half], acc[i][4 * half + 1], acc[i][4 * half + 2], acc[i][4 * half + 3]));
    }
  }
}

// ----------------------------------------------------------------- row kernels
// One warp per row; lane l holds columns 4l + 128q .. +3.

// LayerNorm forward (the forward kernel's two passes over registers) and the
// cotangent of u: xhat, xn = xhat * ln_w + ln_b, d_u = (g * sd) * gamma, and
// 1 / sqrt(var + eps).
template <int C>
__global__ void __launch_bounds__(kThreads) prep_rows(
    const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ sd,
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
// d_sd = sum(g * (u * gamma)).
template <int C>
__global__ void __launch_bounds__(kThreads) finish_rows(
    const float* __restrict__ dxn, const float* __restrict__ xhat, const float* __restrict__ rstd,
    const float* __restrict__ lnw, const float* __restrict__ g, const float* __restrict__ u,
    const float* __restrict__ gamma, float* __restrict__ dx, float* __restrict__ dsd, int n) {
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
// [7C, 8C) d_gamma = sum (g * sd) * u.
__global__ void __launch_bounds__(kThreads) column_partials(
    const float* __restrict__ dxn, const float* __restrict__ xhat, const float* __restrict__ da,
    const float* __restrict__ du, const float* __restrict__ g, const float* __restrict__ sd,
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
      gm += (g[o] * sd[r]) * u[o];
    }
    out[col] = lw;
    out[c + col] = lb;
    out[6 * c + col] = b2;
    out[7 * c + col] = gm;
  }
  for (int col = threadIdx.x; col < 4 * c; col += kThreads) {
    float s = 0.f;
    for (int r = r0; r < r1; ++r) s += da[(size_t)r * 4 * c + col];
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
long long round4(long long v) { return (v + 3) / 4 * 4; }

// Where the workspace's arrays start (floats), and how the reductions split.
struct Plan {
  int splits, k_split;     // weight-gradient products: splits of the N rows
  int chunk_rows, chunks;  // column sums
  long long xhat, xn, du, u, dxn, h, gp, da, rstd, colpart, wpart, total;
};

Plan make_plan(int n, int c) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  Plan p;
  // The weight-gradient products have (4C / 128) * (C / 128) output tiles;
  // split their N-long reduction until there are about two blocks per SM,
  // keeping at least 256 rows per split.
  const int tiles = (4 * c / kBM) * (c / kBN);
  int splits = ceil_div(2 * sms, tiles);
  splits = max(1, min(splits, n / 256));
  p.k_split = ceil_div(ceil_div(n, splits), kBK) * kBK;
  p.splits = max(1, ceil_div(n, p.k_split));
  p.chunk_rows = max(16, ceil_div(n, 2 * sms));
  p.chunks = max(1, ceil_div(n, p.chunk_rows));
  const long long nc = (long long)n * c, n4c = 4 * nc;
  long long off = 0;
  auto take = [&](long long floats) { const long long at_ = off; off += round4(floats); return at_; };
  p.xhat = take(nc);
  p.xn = take(nc);
  p.du = take(nc);
  p.u = take(nc);
  p.dxn = take(nc);
  p.h = take(n4c);
  p.gp = take(n4c);
  p.da = take(n4c);
  p.rstd = take(n);
  p.colpart = take((long long)p.chunks * 8 * c);
  p.wpart = take(p.splits > 1 ? (long long)p.splits * 4 * c * c : 0);
  p.total = off;
  return p;
}

template <bool A_KM, bool B_KM, class Epi>
cudaError_t gemm(const float* A, const float* B, int M, int N, int K, int lda, int ldb,
                 int splits, int k_split, Epi epi, cudaStream_t s) {
  const dim3 grid(ceil_div(N, kBN), ceil_div(M, kBM), splits);
  gemm_kernel<A_KM, B_KM, Epi><<<grid, kThreads, 0, s>>>(A, B, M, N, K, lda, ldb, k_split, epi);
  return cudaGetLastError();
}

#define TC_TRY(expr)                          \
  do {                                        \
    const cudaError_t e_ = (expr);            \
    if (e_ != cudaSuccess) return (int)e_;    \
  } while (0)

template <int C>
int backward(const float* g, const float* x, const float* sd, const float* lnw, const float* lnb,
             const float* w1, const float* b1, const float* w2, const float* b2,
             const float* gamma, float* dx, float* dsd, float* dlnw, float* dlnb, float* dw1,
             float* db1, float* dw2, float* db2, float* dgamma, float* work, int n,
             cudaStream_t s) {
  constexpr int C4 = 4 * C;
  const Plan p = make_plan(n, C);
  float *xhat = work + p.xhat, *xn = work + p.xn, *du = work + p.du, *u = work + p.u;
  float *dxn = work + p.dxn, *h = work + p.h, *gp = work + p.gp, *da = work + p.da;
  float *rstd = work + p.rstd, *colpart = work + p.colpart, *wpart = work + p.wpart;
  const int row_blocks = ceil_div(n, kThreads / 32);

  prep_rows<C><<<row_blocks, kThreads, 0, s>>>(x, g, sd, lnw, lnb, gamma, xhat, xn, du, rstd, n);
  TC_TRY(cudaGetLastError());
  // a = xn W1^T + b1 -> h, gelu'(a)
  TC_TRY((gemm<true, true>(xn, w1, n, C4, C, C, C, 1, C, GeluEpi{b1, h, gp, C4}, s)));
  // u = h W2^T + b2
  TC_TRY((gemm<true, true>(h, w2, n, C, C4, C4, C4, 1, C4, BiasEpi{b2, u, C}, s)));
  // d_a = (d_u W2) * gelu'(a)
  TC_TRY((gemm<true, false>(du, w2, n, C4, C, C, C4, 1, C, MulEpi{gp, da, C4}, s)));
  // d_xn = d_a W1
  TC_TRY((gemm<true, false>(da, w1, n, C, C4, C4, C, 1, C4, StoreEpi{dxn, C, 0}, s)));
  finish_rows<C><<<row_blocks, kThreads, 0, s>>>(dxn, xhat, rstd, lnw, g, u, gamma, dx, dsd, n);
  TC_TRY(cudaGetLastError());

  // dW1 = d_a^T xn (4C, C) and dW2 = d_u^T h (C, 4C), reduced over the rows.
  const long long wsize = (long long)C4 * C;
  const int sum_blocks = ceil_div(wsize / 4, kThreads);
  float* out1 = p.splits > 1 ? wpart : dw1;
  TC_TRY((gemm<false, false>(da, xn, C4, C, n, C4, C, p.splits, p.k_split, StoreEpi{out1, C, wsize}, s)));
  if (p.splits > 1) {
    sum_splits<<<sum_blocks, kThreads, 0, s>>>(wpart, p.splits, wsize / 4, dw1);
    TC_TRY(cudaGetLastError());
  }
  float* out2 = p.splits > 1 ? wpart : dw2;
  TC_TRY((gemm<false, false>(du, h, C, C4, n, C, C4, p.splits, p.k_split, StoreEpi{out2, C4, wsize}, s)));
  if (p.splits > 1) {
    sum_splits<<<sum_blocks, kThreads, 0, s>>>(wpart, p.splits, wsize / 4, dw2);
    TC_TRY(cudaGetLastError());
  }

  column_partials<<<p.chunks, kThreads, 0, s>>>(dxn, xhat, da, du, g, sd, u, colpart, n, C, p.chunk_rows);
  TC_TRY(cudaGetLastError());
  column_finish<<<ceil_div(8 * C, kThreads), kThreads, 0, s>>>(colpart, p.chunks, C, dlnw, dlnb, db1, db2, dgamma);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of workspace tc_mlp_block_backward needs for n rows of width c.
long long tc_mlp_block_backward_workspace(int n, int c) { return make_plan(n, c).total; }

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

const char* tc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
