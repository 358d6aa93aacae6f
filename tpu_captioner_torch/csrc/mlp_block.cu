// Fused ConvNeXt block tail, forward, f32, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_captioner/ops/mlp_block.py:_kernel (launched by
// _fused_pallas under fused_convnext_mlp).  Per row of the (N, C) depthwise-
// conv output it computes
//
//     out = res + sd * ((gelu(LN(x) W1^T + b1) W2^T + b2) * gamma)
//
// with LayerNorm eps 1e-6 and the exact erf GELU.  W1 is (4C, C) and W2 is
// (C, 4C): the nn.Linear weights as the reference checkpoint stores them.
//
// What bounds it on the H100: arithmetic.  The two products are 16*N*C^2
// flops per block (8.6 GFLOP at every ConvNeXt-Base stage at batch 8) against
// 3*N*C*4 bytes of row traffic, far above the f32 ridge.  In f32 without
// TF32 the only units are the FFMA pipes (67 TFLOP/s peak), fed from shared
// memory, so the kernel is bounded by the FFMA rate and by the shared-memory
// loads each FFMA needs.
//
// What the design does about it:
// - a block owns BM rows; their LayerNorm output stays in shared memory and
//   the (BM, 4C) hidden activation is produced and consumed in chunks of JC
//   hidden units, so it never reaches device memory (the point of the TPU
//   kernel too);
// - both products are register-tiled: each thread accumulates a TM x TN
//   tile as outer products of a TM-row column (one broadcast float4 load
//   per 4 rows, from k-major shared-memory tiles) and a TN-column row
//   (float4 loads, conflict-free), so a shared-memory load feeds 8-32 FFMAs;
// - the (BM, C) output stays in registers across all hidden chunks;
// - at C = 512 and 1024 a batch has too few row tiles to fill 132 SMs, so a
//   thread-block cluster of S blocks splits the hidden dimension; the S
//   partial outputs are summed through distributed shared memory, in a
//   fixed order, before the epilogue;
// - weight slices are staged through registers one slice ahead, so their
//   global loads overlap the multiply of the slice before, and are stored
//   transposed into padded or lane-ordered tiles whose stores hit distinct
//   banks;
// - plain FFMA in f32: no TF32 mma, which would lose the f32 agreement with
//   the JAX reference.
// Later PRs: wgmma, TMA-fed weight tiles and bf16.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 32;  // k-slice of W1 staged at a time
constexpr int kJS = 16;  // hidden units of W2 staged at a time
constexpr float kLnEps = 1e-6f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float at(float4 v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// Rows per block BM, cluster size S, hidden chunk JC, and the per-thread
// tiles (TM1 x TN1) of the first product and (TM2 x TN2) of the second.
template <int C_, int BM_, int S_, int JC_, int TM1_, int TN1_, int TM2_, int TN2_>
struct Cfg {
  static constexpr int C = C_, BM = BM_, S = S_, JC = JC_;
  static constexpr int TM1 = TM1_, TN1 = TN1_, TM2 = TM2_, TN2 = TN2_;
  static constexpr int HS = 4 * C / S;  // hidden units per block
  static constexpr int BMP = BM + 4;    // row stride of the k-major (., BM) tiles
  static constexpr int TX1 = JC / TN1, TY1 = BM / TM1;
  static constexpr int TX2 = C / TN2, TY2 = BM / TM2;
  static constexpr int JCP = JC + 4;     // row stride of the staged W1 slice
  static constexpr int kXs = C * BMP, kW1 = kKC * JCP, kHs = JC * BMP, kW2 = kJS * C;
  static constexpr int kW1Loads = JC * kKC / 4 / kThreads;  // float4s per thread per slice
  static constexpr int kW2Loads = C * kJS / 4 / kThreads;
  static constexpr int kSmemFloats = kXs + kW1 + kHs + kW2;
  static_assert(TX1 * TY1 == kThreads && TX2 * TY2 == kThreads, "one tile per thread");
  static_assert(TM1 % 4 == 0 && TN1 % 4 == 0 && TM2 % 4 == 0 && TN2 % 4 == 0, "float4 tiles");
  static_assert(HS % JC == 0 && C % kKC == 0 && JC % kJS == 0 && C % 128 == 0, "tiling");
  static_assert(kW1Loads * 4 * kThreads == JC * kKC && kW2Loads * 4 * kThreads == C * kJS, "staging");
  static_assert(kKC == 32, "the W1 staging map covers 8 float4s per row");
  static_assert(BM * C <= kSmemFloats, "the cluster reduction reuses shared memory");
};

// acc[TM][TN] += a (TM rows at `a`, k-major) x b (TN columns at `b`); the
// thread's rows are 4*ty + 4*TY*p + e, its columns 4*tx + 4*TX*q + f.
template <int TM, int TN, int TY, int TX>
__device__ __forceinline__ void outer(float (&acc)[TM][TN], const float* a, const float* b,
                                      int ty, int tx) {
  float4 av[TM / 4], bv[TN / 4];
#pragma unroll
  for (int p = 0; p < TM / 4; ++p) av[p] = ld4(a + 4 * ty + 4 * TY * p);
#pragma unroll
  for (int q = 0; q < TN / 4; ++q) bv[q] = ld4(b + 4 * tx + 4 * TX * q);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      acc[i][j] = fmaf(at(av[i / 4], i % 4), at(bv[j / 4], j % 4), acc[i][j]);
}

template <class K>
__global__ void __launch_bounds__(kThreads) mlp_block_kernel(
    const float* __restrict__ x, const float* __restrict__ res,
    const float* __restrict__ sd, const float* __restrict__ lnw,
    const float* __restrict__ lnb, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ gamma,
    float* __restrict__ out, int n) {
  constexpr int C = K::C, C4 = 4 * C, BM = K::BM, BMP = K::BMP, JC = K::JC;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;          // (C, BMP)   LN(x), k-major
  float* w1s = xs + K::kXs;  // (kKC, JCP) W1[h + j, c0 + k] at [k][j]
  float* hs = w1s + K::kW1;  // (JC, BMP)  gelu of the current chunk, k-major
  float* w2s = hs + K::kHs;  // (kJS, C)   W2[c, h + js + j] at [j][c]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int q_rank = blockIdx.x % K::S;  // this block's share of the hidden dim
  const int row0 = (blockIdx.x / K::S) * BM;
  const int hid0 = q_rank * K::HS;

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

  const int tx1 = t % K::TX1, ty1 = t / K::TX1;
  const int tx2 = t % K::TX2, ty2 = t / K::TX2;
  float acc[K::TM2][K::TN2];
#pragma unroll
  for (int i = 0; i < K::TM2; ++i)
#pragma unroll
    for (int j = 0; j < K::TN2; ++j) acc[i][j] = 0.f;

  // Weight slices are staged through registers one slice ahead: the loads
  // of slice i + 1 are in flight while slice i is multiplied.
  // W1: 4 lanes read 16 contiguous k values (64 bytes) of one row; with the
  // JCP padding the transposing stores of a warp meet at most 2 per bank.
  float4 pre1[K::kW1Loads], pre2[K::kW2Loads];
  auto load_w1 = [&](int j0, int c0) {
#pragma unroll
    for (int u = 0; u < K::kW1Loads; ++u) {
      const int i = t + u * kThreads, kq = i % 4 + 4 * (i / (4 * JC)), j = (i / 4) % JC;
      pre1[u] = __ldg(reinterpret_cast<const float4*>(w1 + (size_t)(j0 + j) * C + c0 + 4 * kq));
    }
  };
  auto store_w1 = [&]() {
#pragma unroll
    for (int u = 0; u < K::kW1Loads; ++u) {
      const int i = t + u * kThreads, kq = i % 4 + 4 * (i / (4 * JC)), j = (i / 4) % JC;
#pragma unroll
      for (int e = 0; e < 4; ++e) w1s[(4 * kq + e) * K::JCP + j] = at(pre1[u], e);
    }
  };
  // W2: lanes take consecutive rows c, so the transposing stores are
  // conflict-free.
  auto load_w2 = [&](int j) {
#pragma unroll
    for (int u = 0; u < K::kW2Loads; ++u) {
      const int i = t + u * kThreads, c = i % C, jq = i / C;
      pre2[u] = __ldg(reinterpret_cast<const float4*>(w2 + (size_t)c * C4 + j + 4 * jq));
    }
  };
  auto store_w2 = [&]() {
#pragma unroll
    for (int u = 0; u < K::kW2Loads; ++u) {
      const int i = t + u * kThreads, c = i % C, jq = i / C;
#pragma unroll
      for (int e = 0; e < 4; ++e) w2s[(4 * jq + e) * C + c] = at(pre2[u], e);
    }
  };

  load_w1(hid0, 0);
  for (int j0 = hid0; j0 < hid0 + K::HS; j0 += JC) {
    // First product: h = LN(x) . W1[j0 : j0 + JC]^T, a (BM, JC) tile.
    float h[K::TM1][K::TN1];
#pragma unroll
    for (int i = 0; i < K::TM1; ++i)
#pragma unroll
      for (int j = 0; j < K::TN1; ++j) h[i][j] = 0.f;
    for (int c0 = 0; c0 < C; c0 += kKC) {
      __syncthreads();
      store_w1();
      __syncthreads();
      if (c0 + kKC < C)
        load_w1(j0, c0 + kKC);
      else
        load_w2(j0);
#pragma unroll 4
      for (int k = 0; k < kKC; ++k)
        outer<K::TM1, K::TN1, K::TY1, K::TX1>(h, xs + (c0 + k) * BMP, w1s + k * K::JCP, ty1, tx1);
    }
    // GELU into the k-major hidden tile.
#pragma unroll
    for (int q = 0; q < K::TN1 / 4; ++q) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int col = 4 * tx1 + 4 * K::TX1 * q + f;
        const float bj = b1[j0 + col];
#pragma unroll
        for (int p = 0; p < K::TM1 / 4; ++p)
          st4(hs + col * BMP + 4 * ty1 + 4 * K::TY1 * p,
              make_float4(gelu_exact(h[4 * p][4 * q + f] + bj), gelu_exact(h[4 * p + 1][4 * q + f] + bj),
                          gelu_exact(h[4 * p + 2][4 * q + f] + bj), gelu_exact(h[4 * p + 3][4 * q + f] + bj)));
      }
    }

    // Second product: acc += gelu(h) . W2[:, j0 : j0 + JC]^T.
    for (int js = 0; js < JC; js += kJS) {
      __syncthreads();  // also publishes hs
      store_w2();
      __syncthreads();
      if (js + kJS < JC)
        load_w2(j0 + js + kJS);
      else if (j0 + JC < hid0 + K::HS)
        load_w1(j0 + JC, 0);
#pragma unroll 4
      for (int j = 0; j < kJS; ++j)
        outer<K::TM2, K::TN2, K::TY2, K::TX2>(acc, hs + (js + j) * BMP, w2s + j * C, ty2, tx2);
    }
  }

  // Epilogue: bias, layer scale, per-row stochastic-depth scale, residual.
  auto finish = [&](int g, int c, float4 y) {
    const size_t o = (size_t)g * C + c;
    const float4 rv = ld4(res + o), bv = ld4(b2 + c), gv = ld4(gamma + c);
    const float s = sd[g];
    st4(out + o, make_float4(rv.x + s * ((y.x + bv.x) * gv.x), rv.y + s * ((y.y + bv.y) * gv.y),
                             rv.z + s * ((y.z + bv.z) * gv.z), rv.w + s * ((y.w + bv.w) * gv.w)));
  };
  if constexpr (K::S == 1) {
#pragma unroll
    for (int i = 0; i < K::TM2; ++i) {
      const int g = row0 + 4 * ty2 + 4 * K::TY2 * (i / 4) + i % 4;
      if (g >= n) continue;
#pragma unroll
      for (int q = 0; q < K::TN2 / 4; ++q)
        finish(g, 4 * tx2 + 4 * K::TX2 * q,
               make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]));
    }
  } else {
    // Sum the cluster's partial (BM, C) outputs through distributed shared
    // memory; rank r finishes the r-th slice of the tile.
    cg::cluster_group cluster = cg::this_cluster();
    float* ys = smem;  // (BM, C) partial output, row-major
    __syncthreads();
#pragma unroll
    for (int i = 0; i < K::TM2; ++i) {
      const int r = 4 * ty2 + 4 * K::TY2 * (i / 4) + i % 4;
#pragma unroll
      for (int q = 0; q < K::TN2 / 4; ++q)
        st4(ys + r * C + 4 * tx2 + 4 * K::TX2 * q,
            make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]));
    }
    cluster.sync();
    constexpr int kSlice = BM * C / 4 / K::S;  // float4s per rank
    for (int i = q_rank * kSlice + t; i < (q_rank + 1) * kSlice; i += kThreads) {
      const int r = 4 * i / C, c = 4 * i % C, g = row0 + r;
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int src = 0; src < K::S; ++src) {
        const float4 p = ld4(cluster.map_shared_rank(ys, src) + 4 * i);
        y = make_float4(y.x + p.x, y.y + p.y, y.z + p.z, y.w + p.w);
      }
      if (g < n) finish(g, c, y);
    }
    cluster.sync();  // peers may still be reading this block's ys
  }
}

template <class K>
int launch(const float* x, const float* res, const float* sd, const float* lnw,
           const float* lnb, const float* w1, const float* b1, const float* w2,
           const float* b2, const float* gamma, float* out, int n, cudaStream_t stream) {
  const int smem = K::kSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_block_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + K::BM - 1) / K::BM * K::S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K::S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mlp_block_kernel<K>, x, res, sd, lnw, lnb, w1, b1, w2, b2,
                           gamma, out, n);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tiles by width.  The narrow stages have rows to spare (bs 8: 32768 and
// 8192 rows) and take S = 1; the wide ones (2048 and 512 rows) split the
// hidden dimension over a cluster so that there are 128 blocks to run.
int tc_mlp_block_forward(const float* x, const float* res, const float* sd,
                         const float* lnw, const float* lnb, const float* w1,
                         const float* b1, const float* w2, const float* b2,
                         const float* gamma, float* out, int n, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 128:
      return launch<Cfg<128, 64, 1, 128, 8, 4, 8, 4>>(x, res, sd, lnw, lnb, w1, b1, w2, b2, gamma, out, n, s);
    case 256:
      return launch<Cfg<256, 32, 1, 256, 8, 4, 8, 4>>(x, res, sd, lnw, lnb, w1, b1, w2, b2, gamma, out, n, s);
    case 512:
      return launch<Cfg<512, 32, 2, 256, 8, 4, 8, 8>>(x, res, sd, lnw, lnb, w1, b1, w2, b2, gamma, out, n, s);
    case 1024:
      return launch<Cfg<1024, 16, 4, 256, 4, 4, 8, 8>>(x, res, sd, lnw, lnb, w1, b1, w2, b2, gamma, out, n, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* tc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
