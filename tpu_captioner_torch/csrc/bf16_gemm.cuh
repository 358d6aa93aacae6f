// Matrix products on Hopper's bf16 tensor cores (wgmma .bf16, f32 sums), for
// the MLP tail.  Two GEMMs share the building blocks below (the descriptors,
// the wgmma wrappers, the register-A form), which the sub-tiled forward
// (mlp_block.cu: fused_kernel) runs too.  sm_90a only (wgmma).
//
// 1. `gemm`, one product a k16 step, for the precise=False arm: the TPU
//    kernels' products with mxu_dtype=bfloat16 (tpu_captioner/ops/
//    mlp_block.py:126, 145 and 275), which round each operand to bf16 and
//    sum the exact products in f32.  The whole-tile forward (mlp_block.cu)
//    and the backward (mlp_block_bwd.cu) of that arm run it.  Operands are
//    K-major: P = A B^T with A (M, K) and B (N, K), both K-contiguous bf16,
//    stored so by the callers (`to_bf16` rounds f32, or copies bf16, into
//    the plain and/or the transposed layout).  tf32x3_gemm.cuh's kernel with
//    one plane: a block owns a 128 x 128 tile of P and the K range of its
//    split (blockIdx.z); warpgroups 0 and 1 each hold a 64 x 128 f32
//    accumulator and a wgmma partial, warpgroup 2 is the producer.  A stage
//    is 64 K-columns of both operands (32 KB), one 2-D TMA copy each with
//    128-byte swizzle.  What bounds it at the tail's shapes (one tile a
//    block, not persistent): the prologue, the epilogue and L2 (PERF.md).
//
// 2. `x3::gemm`, three products a k16 step, for the bf16 instances of the
//    precise=True arm: the TPU kernels _kernel (:126) and _bwd_kernel (:275)
//    with mxu_dtype=float32 on bf16 x, residual and weights, which the JAX
//    bf16 encoder runs (tpu_captioner/models/convnext.py:163-171).  Their
//    four products with a weight as B multiply an f32 row (LN(x), h, d_u,
//    d_a) by a bf16 weight, f32-accurate.  An f32 value v is three exact
//    bf16 pieces: hi, v's top 8 significant bits, mid, the next 8 of v - hi,
//    and lo, the last 8 (each cut off, not rounded: a mask; v - hi and
//    v - hi - mid are exact in f32), whose sum is v for every v whose lo
//    piece is a normal bf16 (|v| >= about 2^-103); a piece times a bf16
//    weight is exact in f32.  So each k16 step issues three register-A
//    wgmma on the same B tile, lo first, at 989 / 3 = 329.67 TFLOP/s of
//    f32-accurate product on an H100 SXM.  Pieces cut off rather than
//    rounded to nearest cost two masks and a byte permute a pair of values
//    where rounding costs three conversions and two widenings; both split v
//    exactly, and the cut ran the long-K products 5-10% faster (PERF.md).
//    - A: f32 rows by TMA (two 32-column boxes a stage, 128-byte swizzle),
//      or, under LayerNorm (LnA), the bf16 x rows (one 64-column box), which
//      the consumers normalise in f32 with the rows' statistics and ln_w,
//      ln_b staged in shared memory.  Each consumer thread reads its
//      fragment in f32 (a float2 or a bf16 pair at a time: the swizzle keeps
//      a warp's reads to two wavefronts) and splits it in registers.
//    - B: the bf16 weight as it lies, by TMA, never widened or split: K-major
//      (N, K) boxes of 64 columns, or, for d_h = d_u W2 and d_xn = d_a W1,
//      the weight (K, N) read MN-major (wgmma's transposed-B layout: two
//      64-wide boxes of 64 K rows, 128-byte swizzle).
//    - One block per SM walks the output tiles (128 x 128, row tiles
//      slowest) persistently: the producer warp keeps a ring of 4 stages of
//      64 K-columns full across tiles, so the next tile's loads overlap this
//      tile's epilogue; warpgroups 0 and 1 own 64 rows each.  Each stage's
//      12 wgmma go into a fresh accumulator, which is added into the f32
//      sum with round-to-nearest FADDs (the tensor cores truncate as they
//      add, a bias that grows with K: tf32x3_gemm.cuh's note).
//    - What bounds it, measured (PERF.md): the consumers, not the tensor
//      cores or L2.  Both warpgroups wait for the same stage, split it and
//      then wait for their wgmma: a long-K product runs at about half of
//      329.67 TFLOP/s; one product a k16 step instead of three, or no
//      split, took 17-32% off, and sharing A between two blocks of a
//      cluster by TMA multicast (half the L2 bytes) ran slower.  The
//      epilogues of the short-K products with GELU (forward) and with the
//      transposed TF32 planes (backward) cost as much again as their
//      products.
//      The tile plan (`tail_plan`: tiles and grid of the four products,
//      the forward's workspace) is what tc_mlp_block_bf16_plan reports and
//      ops/mlp_block.py:bf16_tail_plan mirrors.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace {
namespace bf16mm {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 4;
constexpr int kThreads = 384;  // two consumer warpgroups, one producer
constexpr int kConsumers = 256;
constexpr int kTileA = kBM * kBK, kTileB = kBN * kBK;  // bf16 elements of a stage's tiles
constexpr int kStageBytes = 2 * (kTileA + kTileB);
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + barriers, alignment

// Shared-memory matrix descriptor of a K-major bf16 tile with 128-byte
// swizzle (64 elements a row, 8-row groups 1024 bytes apart) or 64-byte
// swizzle (32 elements a row, 8-row groups 512 bytes apart).  A k16 step
// is 32 bytes: 2 in the address field.
__device__ __forceinline__ uint64_t desc128(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc64(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

// Two f32 values rounded to bf16 (nearest, ties to even) in one register,
// the first in the low half: one k-slot pair of a wgmma A fragment.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (64 x 128, f32) = A (64 x 16) B (128 x 16)^T + (accumulate ? d : 0),
// both operands bf16 in shared memory, K-major.
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x N, f32) = A (64 x 16) B (N x 16)^T + (accumulate ? d : 0), A from
// registers, B bf16 in shared memory, K-major.  The A fragment of a warp's
// 16 rows is mma.m16n8k16's for .bf16: with g = lane / 4 and q = lane % 4,
// a[0] holds (row g, k 2q and 2q + 1), a[1] (g + 8, the same k), a[2] (g,
// 2q + 8 and 2q + 9), a[3] (g + 8, those), the lower k in the low half;
// warp w of the warpgroup holds rows 16 w to 16 w + 15.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const bf16* p) { return __bfloat162float(*p); }

// src (R, Cc) f32 or bf16, row-major (Cc a multiple of 32), rounded to bf16
// into `plain` (R, Cc) and/or `trans` (Cc, ld_t), transposed; either may be
// null.  A block of 32 x 8 threads takes a 32 x 32 tile and transposes it
// through shared memory, so both stores are coalesced.
template <class S>
__global__ void __launch_bounds__(256) to_bf16_kernel(const S* __restrict__ src, int R, int Cc,
                                                      bf16* __restrict__ plain, bf16* __restrict__ trans,
                                                      int ld_t) {
  __shared__ unsigned short tile[32][34];  // bf16 bit patterns
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 8 * i, c = c0 + tx;
    if (r < R) {
      const bf16 v = __float2bfloat16_rn(load_f32(src + (size_t)r * Cc + c));
      if (plain) plain[(size_t)r * Cc + c] = v;
      tile[ty + 8 * i][tx] = __bfloat16_as_ushort(v);
    }
  }
  if (!trans) return;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty + 8 * i, r = r0 + tx;
    if (r < R) trans[(size_t)c * ld_t + r] = __ushort_as_bfloat16(tile[tx][ty + 8 * i]);
  }
}

// ------------------------------------------------------------------ the GEMM
// P[m, n] = sum over k in [kb, ke) of A(m, k) B(n, k), with kb = blockIdx.z
// * k_split and ke = min(K, kb + k_split); epi(m, n, {P[m, n], P[m, n + 1]})
// for every m < M (N is a multiple of 128).
template <class Epi>
__global__ void __launch_bounds__(kThreads, 1) gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                                                           const __grid_constant__ CUtensorMap map_b,
                                                           int M, int K, int k_split, Epi epi) {
  extern __shared__ uint8_t smem_raw[];
  // Stages start on a 1024-byte boundary of the shared window, where the
  // 128-byte swizzle pattern starts over (the descriptors' base offset 0).
  bf16* stages = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kStages * (kTileA + kTileB));
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * k_split, ke = min(K, kb + k_split);
  const int nk = (ke - kb + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // One big branch per role, never rejoined, so that setmaxnreg can move
  // registers from the producer to the consumers.
  if (wg == 2) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        bf16* a = stages + s * (kTileA + kTileB);
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load_2d(a, &map_a, kb + kt * kBK, m0, &full[s]);
        tma_load_2d(a + kTileA, &map_b, kb + kt * kBK, n0, &full[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    float acc[64], d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = d[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&full[s], (kt / kStages) & 1);
      const bf16* a = stages + s * (kTileA + kTileB) + wg * 64 * kBK;
      const bf16* b = stages + s * (kTileA + kTileB) + kTileA;
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) wgmma_ss128(d, desc128(a) + 2 * kk, desc128(b) + 2 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(d);
      mbar_arrive(&empty[s]);  // this warpgroup is done reading the stage
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += d[i];
    }

    // Fragment order of the m64n128 f32 accumulator: acc[4j + 2h + e] is
    // row 16 w + l / 4 + 8 h, column 8 j + 2 (l % 4) + e of the warpgroup's
    // tile.
    const int w = tid / 32, l = tid % 32;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wg * 64 + 16 * w + l / 4 + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        epi(m, n0 + 8 * j + 2 * (l % 4), make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
    }
  }
}

// ------------------------------------------------------------------ host side

// A K-major bf16 operand: element (r, k) at p[r * ld + k].  rows and k are
// the true extents (TMA zero-fills past them); ld a multiple of 8.
struct Operand {
  const bf16* p;
  int rows, k, ld;
};

// A 2-D map of a K-major bf16 operand in boxes of box_k x box_rows, with
// 128-byte swizzle (box_k 64) or 64-byte swizzle (box_k 32).
inline cudaError_t make_map(CUtensorMap* map, const Operand& o, int box_k, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)o.k, (cuuint64_t)o.rows};
  const cuuint64_t strides[1] = {(cuuint64_t)o.ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_k, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(o.p), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            box_k == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// P = A B^T over `splits` K ranges of k_split (a multiple of kBK), each
// block handing its tile to `epi`.  Returns a cudaError_t.
template <class Epi>
cudaError_t gemm(const Operand& a, const Operand& b, int splits, int k_split, Epi epi, cudaStream_t s) {
  if (b.rows % kBN || a.k != b.k || k_split % kBK || a.ld % 8 || b.ld % 8) return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  cudaError_t err = make_map(&ma, a, kBK, kBM);
  if (err == cudaSuccess) err = make_map(&mb, b, kBK, kBN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(b.rows / kBN, (a.rows + kBM - 1) / kBM, splits);
  gemm_kernel<Epi><<<grid, kThreads, kSmemBytes, s>>>(ma, mb, a.rows, a.k, k_split, epi);
  return cudaGetLastError();
}

// P = A B^T over all of K in one pass.
template <class Epi>
cudaError_t gemm(const Operand& a, const Operand& b, Epi epi, cudaStream_t s) {
  return gemm(a, b, 1, (a.k + kBK - 1) / kBK * kBK, epi, s);
}

// src (R, Cc) rounded to bf16 into plain (R, Cc) and/or trans (Cc, ld_t).
template <class S>
inline cudaError_t to_bf16(const S* src, int R, int Cc, bf16* plain, bf16* trans, int ld_t, cudaStream_t s) {
  const dim3 grid(Cc / 32, (R + 31) / 32);
  to_bf16_kernel<<<grid, dim3(32, 8), 0, s>>>(src, R, Cc, plain, trans, ld_t);
  return cudaGetLastError();
}


// ------------------------------------------------------ the three-piece GEMM
namespace x3 {

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 4;
constexpr int kThreads = 384;  // two consumer warpgroups, one producer
constexpr int kABytes = kBM * kBK * 4;  // a stage's A tile in f32: two 32-column boxes
constexpr int kBBytes = kBN * kBK * 2;  // a stage's B tile in bf16
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kMaxK = 1024;  // LnA: ln_w and ln_b staged whole (K = C)
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kMaxK * 4 + 2 * kStages * 8 + 1024;  // + barriers, alignment

// v = hi + mid + lo for two values: hi is v's sign, exponent and top 8
// significant bits (v with its low 16 bits cleared: a bf16 value), mid the
// next 8 of v - hi, lo the rest (at most 8 significant bits), each packed as
// a k-slot pair (the first value in the low half: __byte_perm takes the
// high halves).  Both subtractions are exact in f32, and so is every piece
// as a bf16 value.  Masks and byte permutes, where rounding each piece to
// nearest costs three conversions and two widenings a pair.
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  const float ra = a - __uint_as_float(ua & 0xffff0000u), rb = b - __uint_as_float(ub & 0xffff0000u);
  const uint32_t va = __float_as_uint(ra), vb = __float_as_uint(rb);
  const float la = ra - __uint_as_float(va & 0xffff0000u), lb = rb - __uint_as_float(vb & 0xffff0000u);
  hi = __byte_perm(ua, ub, 0x7632);
  mid = __byte_perm(va, vb, 0x7632);
  lo = __byte_perm(__float_as_uint(la), __float_as_uint(lb), 0x7632);
}

// Descriptor of an MN-major (transposed) bf16 B tile with 128-byte swizzle:
// boxes of 64 N-contiguous elements (128-byte rows) by K rows, 8-row groups
// 1024 bytes apart (the stride field), the next 64 N `lbo` bytes on (the
// leading field).
__device__ __forceinline__ uint64_t desc128_mn(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

// d (64 x 128, f32) = A (64 x 16) B^T + (accumulate ? d : 0), A from
// registers (wgmma_rs's fragment), B bf16 in shared memory: K-major (kTrans
// 0) or MN-major (1).
template <int kTrans>
__device__ __forceinline__ void wgmma_rs128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(kTrans));
}

// A's prologue.  RowsA: f32 rows as they lie.  LnA: bf16 x rows, A(m, k) =
// (x(m, k) - mu_m) rstd_m lnw[k] + lnb[k] in f32, with stats[m] = (mu_m,
// rstd_m); K <= kMaxK.
struct RowsA {
  static constexpr bool kLn = false;
};
struct LnA {
  static constexpr bool kLn = true;
  const float2* stats;
  const float* lnw;
  const float* lnb;
};

// The tile plan of the MLP tail's bf16 instances at n rows of width c on a
// card of `sms` SMs: the four products with a weight as B, in the order
// a = LN(x) W1^T (n x 4C), u = h W2^T (n x C), d_h = d_u W2 (n x 4C), d_xn =
// d_a W1 (n x C), each a grid of min(tiles, sms) persistent blocks; the
// forward's workspace (floats): the rows' (mu, rstd), then h (n x 4C f32).
struct TailPlan {
  int tiles[4], grid[4];
  long long stats, h, fwd_total;
};

inline long long round32(long long v) { return (v + 31) / 32 * 32; }

inline TailPlan tail_plan(int n, int c, int sms) {
  TailPlan p;
  const int rows = (n + kBM - 1) / kBM;
  const int cols[4] = {4 * c / kBN, c / kBN, 4 * c / kBN, c / kBN};
  for (int i = 0; i < 4; ++i) {
    p.tiles[i] = rows * cols[i];
    p.grid[i] = p.tiles[i] < sms ? p.tiles[i] : sms;
  }
  p.stats = 0;
  p.h = round32(2LL * n);
  p.fwd_total = p.h + round32(4LL * n * c);
  return p;
}

inline int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// P = A B^T over tiles t = blockIdx.x, blockIdx.x + gridDim.x, ... of
// `tiles` (tiles_n columns of tiles a row tile); epi(m, n, {P[m, n],
// P[m, n + 1]}) for every m < M.  K a multiple of kBK.
template <class Pro, class Epi, int kTrans>
__global__ void __launch_bounds__(kThreads, 1) gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                                                           const __grid_constant__ CUtensorMap map_b, int M, int K,
                                                           int tiles_n, int tiles, Pro pro, Epi epi) {
  extern __shared__ uint8_t smem_raw[];
  // Stages start on 1024-byte boundaries, where the 128-byte swizzle
  // pattern starts over.
  uint8_t* stages = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* vec = reinterpret_cast<float*>(stages + kStages * kStageBytes);  // LnA: ln_w, then ln_b
  uint64_t* full = reinterpret_cast<uint64_t*>(vec + 2 * kMaxK);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int nk = K / kBK;
  constexpr int kATx = Pro::kLn ? kBM * kBK * 2 : kABytes;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (Pro::kLn)
    for (int i = threadIdx.x; i < K; i += kThreads) {
      vec[i] = pro.lnw[i];
      vec[kMaxK + i] = pro.lnb[i];
    }
  __syncthreads();

  // One big branch per role, never rejoined, so that setmaxnreg can move
  // registers from the producer to the consumers.
  if (wg == 2) {  // the producer: the consumers' stage sequence, tile after tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * kBM, n0 = t % tiles_n * kBN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kStages, k0 = kt * kBK;
          if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          uint8_t* a = stages + s * kStageBytes;
          uint8_t* b = a + kABytes;
          mbar_expect_tx(&full[s], kATx + kBBytes);
          tma_load_2d(a, &map_a, k0, m0, &full[s]);
          if constexpr (!Pro::kLn) tma_load_2d(a + kABytes / 2, &map_a, k0 + 32, m0, &full[s]);
          if constexpr (kTrans) {
            tma_load_2d(b, &map_b, n0, k0, &full[s]);
            tma_load_2d(b + kBBytes / 2, &map_b, n0 + 64, k0, &full[s]);
          } else {
            tma_load_2d(b, &map_b, k0, n0, &full[s]);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int w = tid / 32, l = tid % 32, g = l / 4, q = l % 4;
    const int ra = wg * 64 + 16 * w + g;  // this thread's rows of the tile: ra and ra + 8 (both g mod 8)
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / tiles_n * kBM, n0 = t % tiles_n * kBN;
      float2 st[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
      if constexpr (Pro::kLn)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (m0 + ra + 8 * h < M) st[h] = pro.stats[m0 + ra + 8 * h];
      float acc[64], d[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = d[i] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        const uint8_t* a_s = stages + s * kStageBytes;
        const uint8_t* b_s = a_s + kABytes;
        // The stage's fragments: k16 step kk, piece (hi, mid, lo), register
        // h + 2 e = row ra + 8 h, k-slots 16 kk + 2 q + 8 e and the next.
        uint32_t a[4][3][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = ra + 8 * h;
              float2 v;
              if constexpr (Pro::kLn) {
                // A 64-column bf16 box: 16-byte chunk c of row r at c ^ (r % 8).
                const uint32_t u = *reinterpret_cast<const uint32_t*>(a_s + r * 128 + (((2 * kk + e) ^ g) << 4) + 4 * q);
                v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
                const int k = kt * kBK + 16 * kk + 2 * q + 8 * e;
                const float2 lw = *reinterpret_cast<const float2*>(vec + k);
                const float2 lb = *reinterpret_cast<const float2*>(vec + kMaxK + k);
                v.x = (v.x - st[h].x) * st[h].y * lw.x + lb.x;
                v.y = (v.y - st[h].x) * st[h].y * lw.y + lb.y;
              } else {
                // Two 32-column f32 boxes.
                const uint8_t* box = a_s + (kk >> 1) * (kABytes / 2);
                v = *reinterpret_cast<const float2*>(box + r * 128 + (((4 * (kk & 1) + 2 * e + (q >> 1)) ^ g) << 4) +
                                                     8 * (q & 1));
              }
              split3(v.x, v.y, a[kk][0][h + 2 * e], a[kk][1][h + 2 * e], a[kk][2][h + 2 * e]);
            }
        fence_regs(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // k16 step kk: 32 bytes along a K-major row (2 in the address
          // field), or 16 K rows of 128 bytes of an MN-major box.
          const uint64_t bd = kTrans ? desc128_mn(b_s, kBBytes / 2) + 128 * kk : desc128(b_s) + 2 * kk;
          wgmma_rs128<kTrans>(d, a[kk][2], bd, kk > 0);  // the stage's first product starts d afresh
          wgmma_rs128<kTrans>(d, a[kk][1], bd, 1);
          wgmma_rs128<kTrans>(d, a[kk][0], bd, 1);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(d);
        __syncwarp();
        if (l == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += d[i];
      }

      // Fragment order of the m64n128 f32 accumulator: acc[4j + 2h + e] is
      // row 16 w + l / 4 + 8 h, column 8 j + 2 (l % 4) + e of the
      // warpgroup's 64 rows.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + ra + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          epi(m, n0 + 8 * j + 2 * q, make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
      }
    }
  }
}

// A 2-D map of an f32 operand (rows, k) with row stride ld floats, in boxes
// of 32 x 128 with the 128-byte swizzle.
inline cudaError_t make_map_f32(CUtensorMap* map, const float* p, int rows, int k, int ld) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)kBM};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// P = A B^T with A of n rows by K: f32 (RowsA, `a` float*) or bf16 x under
// LayerNorm (LnA, `a` bf16*), row stride K; B the bf16 weight as it lies:
// K-major (kTrans 0: (N, K) rows) or MN-major (kTrans 1: (K, N) rows).
// `cols` = N, a multiple of kBN; K a multiple of kBK.
template <int kTrans, class Pro, class Epi>
cudaError_t gemm(const void* a, const bf16* b, int n, int K, int cols, Pro pro, Epi epi, cudaStream_t s) {
  if (cols % kBN || K % kBK || (Pro::kLn && K > kMaxK)) return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  cudaError_t err = Pro::kLn ? make_map(&ma, {static_cast<const bf16*>(a), n, K, K}, 64, kBM)
                             : make_map_f32(&ma, static_cast<const float*>(a), n, K, K);
  if (err == cudaSuccess)
    err = kTrans ? make_map(&mb, {b, K, cols, cols}, 64, 64)  // boxes of 64 N by 64 K rows
                 : make_map(&mb, {b, cols, K, K}, 64, kBN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_kernel<Pro, Epi, kTrans>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  if (err != cudaSuccess) return err;
  const int tiles_n = cols / kBN, tiles = (n + kBM - 1) / kBM * tiles_n;
  const int sms = sm_count(), grid = tiles < sms ? tiles : sms;
  gemm_kernel<Pro, Epi, kTrans><<<grid, kThreads, kSmemBytes, s>>>(ma, mb, n, K, tiles_n, tiles, pro, epi);
  return cudaGetLastError();
}

}  // namespace x3

}  // namespace bf16mm
}  // namespace
