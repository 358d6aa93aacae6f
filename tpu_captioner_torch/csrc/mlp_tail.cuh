// The ConvNeXt block tail in f32 FFMA, for the MLP-tail kernel's sub-tiled
// instances (mlp_block.cu, SUB > 0: PERF.md row 2), for Hopper (sm_90a).
// The MLP-tail kernel's default whole-tile path (row 1) and the whole-block
// kernel (block_fused.cu: row 9) no longer run it: they take their products
// from the tensor cores (3xTF32, mlp_products.cuh on tf32x3_gemm.cuh).
//
// A block owns BM rows whose LayerNorm output its prologue has written into
// the k-major shared tile xs; `mlp_tail` then computes, for each row g,
//
//     out = res + sd[g / sd_div] * ((gelu(xs W1^T + b1) W2^T + b2) * gamma)
//
// with the exact erf GELU.  W1 is (4C, C) and W2 is (C, 4C): the nn.Linear
// weights as the reference checkpoint stores them.
//
// What bounds it on the H100: arithmetic.  The two products are 16*N*C^2
// flops per block against 3*N*C*4 bytes of row traffic, far above the f32
// ridge.  In f32 without TF32 the only units are the FFMA pipes (67 TFLOP/s
// peak), fed from shared memory, so the tail is bounded by the FFMA rate and
// by the shared-memory loads each FFMA needs.
//
// What the design does about it:
// - the (BM, 4C) hidden activation is produced and consumed in chunks of JC
//   hidden units, so it never reaches device memory;
// - both products are register-tiled: each thread accumulates a TM x TN
//   tile as outer products of a TM-row column (one broadcast float4 load
//   per 4 rows, from k-major shared-memory tiles) and a TN-column row, so a
//   shared-memory load feeds 4-32 FFMAs;
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
//
// The sub-tiled schedule (SUB > 0; the TPU kernel _kernel_pipelined,
// tpu_captioner/ops/mlp_block.py:145): the BM rows split into BM / SUB
// sub-tiles whose first products run one after the other within each hidden
// chunk, each on its own (SUB, JC) register tile.  The first k-slice of
// sub-tile i's first product is unrolled into one basic block together with
// the GELU of sub-tile i - 1's finished tile, with no barrier between them,
// so the scheduler can issue the erff sequences (ALU and SFU) of one
// sub-tile between the FFMAs of the next, as the TPU kernel skews GELU (VPU)
// beside the next sub-tile's product (MXU).  The last sub-tile's GELU runs
// alone, as the TPU schedule's drain.  LayerNorm, the second product and the
// epilogue stay over the whole tile: the accumulator spans its rows.  Each
// sub-tile stages W1 again (from L2): BM / SUB times the W1 traffic of the
// monolithic instance, and its 4 x TN1S thread tile feeds only 4-16 FFMAs per
// shared-memory load.  On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py
// phase 3, batch 32) SUB = BM / 2 took 1.16-1.23 times the whole-tile
// instance per launch and SUB = 8 1.19-1.61 times: the extra staging and the
// smaller tiles cost more than the interleave saves, so the instances stay
// an option, off by default, as in the JAX package.
// Later PRs: row 2 onto the tensor-core products of tf32x3_gemm.cuh, as
// rows 1 and 9 went; then bf16.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "mlp_products.cuh"  // gelu_exact, kLnEps
#include "warp_reduce.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 32;  // k-slice of W1 staged at a time
constexpr int kJS = 16;  // hidden units of W2 staged at a time

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float at(float4 v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Rows per block BM, cluster size S, hidden chunk JC, the per-thread tiles
// (TM1 x TN1) of the first product and (TM2 x TN2) of the second, and the
// sub-tile rows SUB (0: one chain over the whole tile).  With SUB > 0 the
// first product's thread tile is 4 x TN1S over the (SUB, JC) sub-tile.
template <int C_, int BM_, int S_, int JC_, int TM1_, int TN1_, int TM2_, int TN2_, int SUB_ = 0>
struct Cfg {
  static constexpr int C = C_, BM = BM_, S = S_, JC = JC_, SUB = SUB_;
  static constexpr int TM1 = TM1_, TN1 = TN1_, TM2 = TM2_, TN2 = TN2_;
  static constexpr int HS = 4 * C / S;  // hidden units per block
  static constexpr int BMP = BM + 4;    // row stride of the k-major (., BM) tiles
  static constexpr int TX1 = JC / TN1, TY1 = BM / TM1;
  static constexpr int TX2 = C / TN2, TY2 = BM / TM2;
  static constexpr int NSUB = SUB > 0 ? BM / SUB : 1;  // sub-tiles per tile
  static constexpr int TY1S = SUB > 0 ? SUB / 4 : 1;   // sub-tile first product: 4 x TN1S per thread
  static constexpr int TX1S = kThreads / TY1S, TN1S = JC / TX1S;
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
  static_assert(SUB == 0 || (SUB % 4 == 0 && BM % SUB == 0 && NSUB >= 2 && TX1S * TY1S == kThreads &&
                             TN1S >= 1 && TX1S * TN1S == JC && (TN1S < 4 || TN1S % 4 == 0)),
                "sub-tiles of 4-row groups, each thread a 4 x TN1S tile of the (SUB, JC) product");
};

// Column of element j of a thread's TN-wide row tile: float4 groups
// 4*tx + 4*TX*q + f when TN is a multiple of 4, else single columns tx + TX*j.
template <int TN, int TX>
__device__ __forceinline__ int col_of(int tx, int j) {
  return TN % 4 == 0 ? 4 * tx + 4 * TX * (j / 4) + j % 4 : tx + TX * j;
}

// acc[TM][TN] += a (TM rows at `a`, k-major) x b (TN columns at `b`); the
// thread's rows are 4*ty + 4*TY*p + e, its columns col_of<TN, TX>(tx, j).
template <int TM, int TN, int TY, int TX>
__device__ __forceinline__ void outer(float (&acc)[TM][TN], const float* a, const float* b,
                                      int ty, int tx) {
  float4 av[TM / 4];
#pragma unroll
  for (int p = 0; p < TM / 4; ++p) av[p] = ld4(a + 4 * ty + 4 * TY * p);
  if constexpr (TN % 4 == 0) {
    float4 bv[TN / 4];
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) bv[q] = ld4(b + 4 * tx + 4 * TX * q);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i][j] = fmaf(at(av[i / 4], i % 4), at(bv[j / 4], j % 4), acc[i][j]);
  } else {
    float bv[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = b[tx + TX * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i][j] = fmaf(at(av[i / 4], i % 4), bv[j], acc[i][j]);
  }
}

// gelu(h + b1[j0 + column]) of a thread's TM x TN tile into the k-major
// hidden tile at `hs` (rows 4*ty + 4*TY*p + e).
template <int TM, int TN, int TY, int TX>
__device__ __forceinline__ void gelu_store(const float (&h)[TM][TN], float* hs, int bmp,
                                           const float* __restrict__ b1, int ty, int tx) {
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = col_of<TN, TX>(tx, j);
    const float bj = b1[col];
#pragma unroll
    for (int p = 0; p < TM / 4; ++p)
      st4(hs + col * bmp + 4 * ty + 4 * TY * p,
          make_float4(gelu_exact(h[4 * p][j] + bj), gelu_exact(h[4 * p + 1][j] + bj),
                      gelu_exact(h[4 * p + 2][j] + bj), gelu_exact(h[4 * p + 3][j] + bj)));
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&a)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) a[i][j] = 0.f;
}

// The tail over rows row0 .. row0 + BM - 1 (those below n are stored) of a
// block whose prologue has written LN(x) into smem's xs tile and synchronised
// nothing yet.  q_rank is the block's rank in its cluster (its share of the
// hidden dimension).  The row scale of row g is sd[g / sd_div].
template <class K>
__device__ __forceinline__ void mlp_tail(
    float* smem, const float* __restrict__ res, const float* __restrict__ sd, int sd_div,
    const float* __restrict__ w1, const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ gamma, float* __restrict__ out,
    int n, int row0, int q_rank) {
  constexpr int C = K::C, C4 = 4 * C, BMP = K::BMP, JC = K::JC;
  float* xs = smem;          // (C, BMP)   LN(x), k-major
  float* w1s = xs + K::kXs;  // (kKC, JCP) W1[h + j, c0 + k] at [k][j]
  float* hs = w1s + K::kW1;  // (JC, BMP)  gelu of the current chunk, k-major
  float* w2s = hs + K::kHs;  // (kJS, C)   W2[c, h + js + j] at [j][c]

  const int t = threadIdx.x;
  const int hid0 = q_rank * K::HS;
  const int tx2 = t % K::TX2, ty2 = t / K::TX2;
  float acc[K::TM2][K::TN2];
  zero(acc);

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
    if constexpr (K::SUB == 0) {
      // First product: h = LN(x) . W1[j0 : j0 + JC]^T, a (BM, JC) tile.
      const int tx1 = t % K::TX1, ty1 = t / K::TX1;
      float h[K::TM1][K::TN1];
      zero(h);
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
      gelu_store<K::TM1, K::TN1, K::TY1, K::TX1>(h, hs, BMP, b1 + j0, ty1, tx1);
    } else {
      // The sub-tiles' first products in turn; sub-tile s's GELU is issued
      // in the unrolled first k-slice of sub-tile s + 1 (header note).
      constexpr int TN = K::TN1S, TY = K::TY1S, TX = K::TX1S;
      const int tx1 = t % TX, ty1 = t / TX;
      float prev[4][TN];
#pragma unroll
      for (int s = 0; s < K::NSUB; ++s) {
        const float* xsub = xs + s * K::SUB;
        float h[4][TN];
        zero(h);
        for (int c0 = 0; c0 < C; c0 += kKC) {
          __syncthreads();
          store_w1();
          __syncthreads();
          if (c0 + kKC < C)
            load_w1(j0, c0 + kKC);
          else if (s + 1 < K::NSUB)
            load_w1(j0, 0);
          else
            load_w2(j0);
          if (c0 == 0) {
#pragma unroll
            for (int k = 0; k < kKC; ++k)
              outer<4, TN, TY, TX>(h, xsub + k * BMP, w1s + k * K::JCP, ty1, tx1);
            if (s > 0) gelu_store<4, TN, TY, TX>(prev, hs + (s - 1) * K::SUB, BMP, b1 + j0, ty1, tx1);
          } else {
#pragma unroll 4
            for (int k = 0; k < kKC; ++k)
              outer<4, TN, TY, TX>(h, xsub + (c0 + k) * BMP, w1s + k * K::JCP, ty1, tx1);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) prev[i][j] = h[i][j];
      }
      gelu_store<4, TN, TY, TX>(prev, hs + (K::NSUB - 1) * K::SUB, BMP, b1 + j0, ty1, tx1);
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

  // Epilogue: bias, layer scale, the row's stochastic-depth scale, residual.
  auto finish = [&](int g, int c, float4 y) {
    const size_t o = (size_t)g * C + c;
    const float4 rv = ld4(res + o), bv = ld4(b2 + c), gv = ld4(gamma + c);
    const float s = sd[g / sd_div];
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
    constexpr int kSlice = K::BM * C / 4 / K::S;  // float4s per rank
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

// Launch `kernel` over ceil(n / BM) row tiles, S blocks (one cluster) each,
// with K's dynamic shared memory, on `stream`.  Returns a cudaError_t.
template <class K, class Kernel, class... Args>
int launch_tail(Kernel kernel, int n, cudaStream_t stream, Args... args) {
  const int smem = K::kSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
