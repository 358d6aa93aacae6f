// f32-accurate matrix products on Hopper's TF32 tensor cores (3xTF32), for
// the MLP-tail kernels' f32 instances: the whole-tile forward (mlp_block.cu,
// SUB = 0), the backward (mlp_block_bwd.cu; its bf16 instance's two
// weight-gradient products too) and the whole-block kernel's products run
// the GEMM below; the sub-tiled forward (mlp_block.cu: fused_kernel) runs its
// building blocks (the split, the descriptors, the wgmma wrappers, the
// register-A form among them).  sm_90a only (wgmma).
//
// The split.  A TF32 operand keeps 10 of f32's 23 mantissa bits, and one
// TF32 pass over the tail's products misses the f32 tolerance (1.6e-3 at
// C = 1024 against 1e-4).  So every f32 operand v is stored as two planes,
// hi = rna_tf32(v) and lo = rna_tf32(v - hi) (v - hi is exact in f32), and
// every tile accumulates hi.lo + lo.hi and then hi.hi into f32 registers:
// the small terms first.  Only lo.lo (2^-22 relative) is dropped, so the
// products keep f32 accuracy at a third of the TF32 rate: 495 / 3 = 165
// TFLOP/s on an H100 SXM, 2.5 times the 67 of f32 FFMA.  The TPU kernel's
// default is the same: f32 multiplicands on its matrix unit
// (tpu_captioner/ops/mlp_block.py:262, precise=True).
//
// Where the split happens.  TMA copies bytes and cannot convert, so the
// planes live in device memory: the kernel that produces an operand writes
// its two planes (the forward's LayerNorm rows, the GELU epilogues), and
// `split` makes them for the rest (the weights, per call, never cached:
// the optimizer updates them in place every step).  A plane pair costs
// 8 bytes per element where f32 costs 4.
//
// Layouts.  TF32 wgmma reads both operands K-major only: the transpose bits
// exist for 16-bit types alone.  So `gemm` computes P = A B^T with A
// (M, K) and B (N, K), both K-contiguous, and the callers store what they
// need in that layout (the notes of mlp_block_bwd.cu say which copy each
// product reads and why).
//
// The kernel.  A block owns a 128 x 128 tile of P and the K range of its
// split (blockIdx.z).  Warpgroups 0 and 1 each hold a 64 x 128 f32
// accumulator and a wgmma partial (128 registers a thread; setmaxnreg
// moves registers from the producer) and run wgmma m64n128k8 on shared-
// memory tiles; warpgroup 2 is the producer, one thread of which keeps
// kStages TMA loads in flight.  A stage is 32 K-columns of both planes of
// both operands (64 KB), loaded by one 3-D TMA copy per operand (box 32 x
// 128 x 2 planes) with 128-byte swizzle, which the wgmma descriptors read
// as is.  Rows past M and K past the end are zero-filled by TMA, never
// read, so a NaN in a padding row cannot leak in.  Full and empty mbarriers
// pace the ring.  The tensor cores add a wgmma's products into its
// accumulator with truncation, a bias that grows with K: one accumulator
// over all of K missed the tail's 1e-4 tolerance at C = 1024 (2e-4).  So a
// consumer runs each stage's 12 wgmmas (4 k-steps of 8, 3 products each)
// into a fresh accumulator, waits for them, releases the stage and adds
// the partial into f32 registers with round-to-nearest FADDs; the other
// consumer warpgroup's wgmmas keep the tensor cores busy meanwhile.  The
// epilogue hands each thread's pairs of adjacent columns to a functor, in
// the accumulator's fragment order.  No atomics: a split's partial tile
// goes to its own slab.
//
// What bounds it: the tensor cores, at 165 TFLOP/s of f32 product.  A
// 128 x 128 x 32 stage is 1 MFLOP against 64 KB of operand planes from L2;
// a 128 x 256 tile (two stages), which moves a quarter fewer bytes per
// product, was no faster on an H100, so L2 is not the limit at these
// shapes.  Short K (C = 128: 4 stages) leaves the prologue and epilogue
// exposed, and the epilogue does not overlap the next tile's loads (one
// tile per block, not persistent).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace {
namespace tf32x3 {

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3;
constexpr int kThreads = 384;    // two consumer warpgroups, one producer
constexpr int kConsumers = 256;
constexpr int kPlaneA = kBM * kBK, kPlaneB = kBN * kBK;  // floats per plane of a stage
constexpr int kStageFloats = 2 * (kPlaneA + kPlaneB);
constexpr int kStageBytes = kStageFloats * 4;
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + barriers, alignment

__device__ __forceinline__ float round_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// The two planes of an operand element: `at` in the hi plane, `at + plane`
// in the lo plane.
__device__ __forceinline__ void store_split(float* p, long long plane, size_t at, float v) {
  const float hi = round_tf32(v);
  p[at] = hi;
  p[at + plane] = round_tf32(v - hi);
}

__device__ __forceinline__ void store_split2(float* p, long long plane, size_t at, float v0, float v1) {
  const float h0 = round_tf32(v0), h1 = round_tf32(v1);
  *reinterpret_cast<float2*>(p + at) = make_float2(h0, h1);
  *reinterpret_cast<float2*>(p + at + plane) = make_float2(round_tf32(v0 - h0), round_tf32(v1 - h1));
}

// The split of src (R, Cc), row-major (Cc a multiple of 32), into `plain`
// (R, Cc) and/or `trans` (Cc, ld_t), transposed; either may be null.
// Planes: R * Cc floats apart in `plain`, Cc * ld_t in `trans`.  A block of
// 32 x 8 threads splits a 32 x 32 tile and transposes it through shared
// memory, so both stores are coalesced.
__global__ void __launch_bounds__(256) split_kernel(const float* __restrict__ src, int R, int Cc,
                                                    float* __restrict__ plain, float* __restrict__ trans,
                                                    int ld_t) {
  __shared__ float hi[32][33], lo[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  const long long plane_p = (long long)R * Cc, plane_t = (long long)Cc * ld_t;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 8 * i, c = c0 + tx;
    if (r < R) {
      const float v = src[(size_t)r * Cc + c], h = round_tf32(v), l = round_tf32(v - h);
      if (plain) {
        plain[(size_t)r * Cc + c] = h;
        plain[plane_p + (size_t)r * Cc + c] = l;
      }
      hi[ty + 8 * i][tx] = h;
      lo[ty + 8 * i][tx] = l;
    }
  }
  if (!trans) return;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty + 8 * i, r = r0 + tx;
    if (r < R) {
      trans[(size_t)c * ld_t + r] = hi[tx][ty + 8 * i];
      trans[plane_t + (size_t)c * ld_t + r] = lo[tx][ty + 8 * i];
    }
  }
}

// ------------------------------------------------------- PTX building blocks

// One 3-D TMA box (32 K-columns, rows, both planes) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int k, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k), "r"(row), "r"(0)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes (32 floats), 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) = A (64 x 8) B (128 x 8)^T + (accumulate ? d : 0),
// TF32 operands in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1;\n}\n"
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

// d (64 x N, f32) = A (64 x 8) B (N x 8)^T + (accumulate ? d : 0), A from
// registers (TF32 bit patterns), B in shared memory.  The A fragment of a
// warp's 16 rows is mma.m16n8k8's for .tf32: with g = lane / 4 and q =
// lane % 4, a[0] is (row g, k q), a[1] (g + 8, q), a[2] (g, q + 4) and
// a[3] (g + 8, q + 4); warp w of the warpgroup holds rows 16 w to 16 w + 15.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
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
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// fence_acc for any accumulator size.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
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
  float* stages = reinterpret_cast<float*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kStages * kStageFloats);
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
        float* a = stages + s * kStageFloats;
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load(a, &map_a, kb + kt * kBK, m0, &full[s]);
        tma_load(a + 2 * kPlaneA, &map_b, kb + kt * kBK, n0, &full[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    // The tensor cores sum each wgmma's products into the accumulator with
    // truncation, and that bias grows with K (2e-4 at C = 1024 against the
    // 1e-4 tolerance when one accumulator ran over all of K).  So each
    // stage's 32-deep product goes into a fresh wgmma accumulator d, and is
    // then added into acc with round-to-nearest FADDs.
    float acc[64], d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = d[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&full[s], (kt / kStages) & 1);
      const float* a_hi = stages + s * kStageFloats + wg * 64 * kBK;
      const float* a_lo = a_hi + kPlaneA;
      const float* b_hi = stages + s * kStageFloats + 2 * kPlaneA;
      const float* b_lo = b_hi + kPlaneB;
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        // 8 floats = 32 bytes = 2 in the descriptor's 16-byte address units.
        const uint64_t ah = smem_desc(a_hi) + 2 * kk, al = smem_desc(a_lo) + 2 * kk;
        const uint64_t bh = smem_desc(b_hi) + 2 * kk, bl = smem_desc(b_lo) + 2 * kk;
        wgmma_tf32(d, ah, bl, kk > 0);  // the stage's first product starts d afresh
        wgmma_tf32(d, al, bh, 1);
        wgmma_tf32(d, ah, bh, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(d);
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

// The two planes of a K-major operand: element (r, k) of the hi plane at
// p[r * ld + k], of the lo plane `plane` floats later.  rows and k are the
// true extents (TMA zero-fills past them); ld and plane multiples of 4.
struct Operand {
  const float* p;
  int rows, k, ld;
  long long plane;
};

inline cudaError_t make_map(CUtensorMap* map, const Operand& o, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)o.k, (cuuint64_t)o.rows, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)o.ld * 4, (cuuint64_t)o.plane * 4};
  const cuuint32_t box[3] = {kBK, (cuuint32_t)box_rows, 2};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(o.p), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// P = A B^T over `splits` K ranges of k_split (a multiple of kBK), each
// block handing its tile to `epi`.  Returns a cudaError_t.
template <class Epi>
cudaError_t gemm(const Operand& a, const Operand& b, int splits, int k_split, Epi epi, cudaStream_t s) {
  if (b.rows % kBN || a.k != b.k || k_split % kBK || a.ld % 4 || b.ld % 4 || a.plane % 4 || b.plane % 4)
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  cudaError_t err = make_map(&ma, a, kBM);
  if (err == cudaSuccess) err = make_map(&mb, b, kBN);
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

// The planes of src (R, Cc) into plain (R, Cc) and/or trans (Cc, ld_t).
inline cudaError_t split(const float* src, int R, int Cc, float* plain, float* trans, int ld_t, cudaStream_t s) {
  const dim3 grid(Cc / 32, (R + 31) / 32);
  split_kernel<<<grid, dim3(32, 8), 0, s>>>(src, R, Cc, plain, trans, ld_t);
  return cudaGetLastError();
}

}  // namespace tf32x3
}  // namespace
