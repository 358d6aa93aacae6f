// Matrix products on Hopper's bf16 tensor cores (wgmma .bf16, f32 sums), for
// the MLP tail's precise=False arm: the TPU kernels' products with
// mxu_dtype=bfloat16 (tpu_captioner/ops/mlp_block.py:126, 145 and 275),
// which round each operand to bf16 and sum the exact products in f32.  The
// whole-tile forward (mlp_block.cu) and the backward (mlp_block_bwd.cu) run
// the GEMM below; the sub-tiled forward (mlp_block.cu: fused_kernel) runs
// its building blocks (the descriptors, the wgmma wrappers, the register-A
// form among them).  sm_90a only (wgmma).
//
// One product a k-step: a bf16 value times a bf16 value is exact in f32, so
// the tensor cores compute exactly JAX's arithmetic, at 989 TFLOP/s on an
// H100 SXM (six times the 3xTF32 GEMM's 165) from half the operand bytes of
// f32.
//
// Layouts.  The operands are K-major, as tf32x3_gemm.cuh's: `gemm` computes
// P = A B^T with A (M, K) and B (N, K), both K-contiguous bf16, and the
// callers store what they need in that layout (mlp_block_bwd.cu's notes say
// which copy each product reads).  `to_bf16` rounds f32 (or copies bf16)
// into the plain and/or the transposed layout.
//
// The kernel is tf32x3_gemm.cuh's with one plane: a block owns a 128 x 128
// tile of P and the K range of its split (blockIdx.z); warpgroups 0 and 1
// each hold a 64 x 128 f32 accumulator and a wgmma partial, warpgroup 2 is
// the producer.  A stage is 64 K-columns (128 bytes a row) of both operands
// (32 KB), one 2-D TMA copy each with 128-byte swizzle; rows past M and K
// past the end arrive as zeros.  The truncation care of tf32x3_gemm.cuh
// holds: each stage's four m64n128k16 wgmmas go into a fresh accumulator,
// which is added into f32 registers with round-to-nearest FADDs.
//
// What bounds it: at the MLP tail's shapes (K = C or 4C, 128 x 128 tiles,
// one tile a block, not persistent) the prologue, the epilogue and L2, well
// before the tensor cores' rate (PERF.md).

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

}  // namespace bf16mm
}  // namespace
