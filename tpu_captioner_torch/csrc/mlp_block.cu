// Fused ConvNeXt block tail, forward, f32 and bf16, both precise arms, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels tpu_captioner/ops/mlp_block.py:_kernel (SUB = 0)
// and _kernel_pipelined (SUB = 64), both launched by _fused_pallas under
// fused_convnext_mlp.  Per row of the (N, C) depthwise-conv output it
// computes
//
//     out = res + sd * ((gelu(LN(x) W1^T + b1) W2^T + b2) * gamma)
//
// with LayerNorm eps 1e-6 and the exact erf GELU.  W1 is (4C, C) and W2 is
// (C, 4C): the nn.Linear weights as the reference checkpoint stores them.
// What bounds both paths on the H100: the two products, 16*N*C^2 flops, at
// the f32-accurate tensor-core rate (3xTF32, tf32x3_gemm.cuh: 165 TFLOP/s);
// 7.50 ms per bs-32 encoder pass.
//
// The whole-tile path (SUB = 0, the default; f32).  Three launches and the
// weights' split per call: ln_rows (here) writes LN(x) as its two TF32
// planes (N, C); gemm 1 writes h = gelu(LN(x) W1^T + b1) as two planes (N,
// 4C) to device memory; gemm 2 runs out = res + sd * (...) in its epilogue
// (mlp_products.cuh, which the whole-block kernel runs too).  h goes
// through device memory because the GEMM is one 128 x 128 output tile per
// block and a 64 x C f32 tile of the second product outgrows a warpgroup's
// registers.  Extra bytes per launch: h's planes written and read, 64*N*C;
// the LN planes, 16*N*C; about 3.1 ms per bs-32 encoder pass at 3.35 TB/s.
//
// The sub-tiled path (SUB = 64, TPU_CAPTIONER_MLP_SUB): fused_kernel, one
// launch after the weights' preparation, in which neither h nor LN(x) ever
// reaches device memory.  The TPU kernel splits its row tile into sub-tiles
// whose LN -> mm1 -> GELU -> mm2 chains are skewed, so that one sub-tile's
// GELU runs beside the next one's product.  Here:
// - A cluster of S blocks owns a row tile of two 64-row sub-tiles (the
//   wgmma M) and walks the tiles persistently; each block's two consumer
//   warpgroups take one sub-tile each, and its producer warp keeps TMA
//   loads of the weight planes and of raw x in flight through a ring of
//   32 KB slots on full / empty mbarriers (setmaxnreg moves registers from
//   the producer to the consumers).  Block r owns NC = C / S output
//   columns.
// - The hidden dimension runs in chunks of JC units; block r computes JCB
//   = JC / S of them: h_j = gelu(LN(x) W1[j]^T + b1[j]), a 64 x JCB
//   accumulator.  LayerNorm is the first product's prologue: the rows' mean
//   and rstd once per tile, then each thread normalises its A fragment from
//   the staged x slab into registers and splits it into TF32 hi/lo, the
//   first product taking A from registers.  ln_w is folded into W1's
//   columns and W1 ln_b into b1 when the weights are prepared (prep_w1),
//   and W1's columns are permuted within each 16-column group so that a
//   thread's fragment is one float4 of x.
// - GELU and the split of h_j run on the accumulator, and each block writes
//   its JCB columns of the hi/lo planes into every peer's shared memory
//   (distributed shared memory, in the 128-byte-swizzled layout the wgmma
//   descriptors read), signalling an mbarrier in each peer; the second
//   product then takes the whole chunk as its A operand from shared memory
//   for the block's NC output columns, 128 at a time.  No product is
//   computed twice.  A second mbarrier says when every peer has read the
//   chunk, so its buffer can be rewritten.
// - The skew is Hopper's: while one warpgroup runs its GELU epilogue (erff
//   on the ALUs) and the split, the other's wgmmas keep the tensor cores
//   busy; the ring paces the two within a few slots of each other.
// - Both products run the 3xTF32 split (hi.lo + lo.hi, then hi.hi).  The
//   tensor cores add into an accumulator with truncation, a bias that grows
//   with K, so the second product adds each chunk (K = JC) from a fresh
//   accumulator with round-to-nearest FADDs, and so does the first each
//   32-deep stage where a block owns 128 columns.
// The tiles (Fused<C, NC>), set by registers and shared memory: the output
// accumulator is NC / 2 registers a thread and a partial of the second
// product 64 more, so NC is 128 or 256; a per-stage partial of the first
// product fits beside NC = 128, or beside NC = 256 where JCB is 32.  The h buffers (2 sub-tiles x 2
// planes x 64 x JC floats) and the ring share the 227 KB: JC = 64 and 5
// slots where a cluster is one block, else JC = 128 and 3 slots.  So JCB,
// the first product's N, is 64 at S <= 2, 32 at S = 4 and 16 at S = 8;
// wgmma time is per instruction more than per operation at small N
// (PERF.md), which is why NC = 256 (S = C / 256) runs the wide
// widths at half the instructions where the card has rows enough for it
// (fused_columns).
// Filling the card: one block per SM; clusters as many as
// cudaOccupancyMaxActiveClusters says run at once, at most one per row
// tile; NC = 256 where it needs fewer rounds of them than NC = 128.  bs 32
// has 1024 / 256 / 64 / 16 tiles at C = 128 / 256 / 512 / 1024: single
// blocks at C <= 256 (8 and 2 rounds of 132), clusters of 2 at C = 512 (one
// round of 66), of 4 at C = 1024 (16 of them, one round; 64 SMs).  bs 8
// has 256 / 64 / 16 / 4 tiles and takes NC = 128: C = 256 fills 128 SMs
// (64 clusters of 2), C = 512 64 (clusters of 4) and C = 1024 32 (4
// clusters of 8), leaving 4, 68 and 100 of the 132 idle; the tile is the
// wgmma's 64 rows twice, so fewer rows cannot spread wider without
// splitting the hidden sum across clusters.
// What it reads again: x, once per chunk in every block of the cluster (S
// x 4C / JC times a tile), and the weight planes once per tile from L2.
//
// The bf16 instances (tc_mlp_block_forward_bf16): the TPU kernels _kernel
// and _kernel_pipelined with bf16 x, residual, W1 and W2 and
// mxu_dtype=float32, which the JAX bf16 encoder calls (precise=True,
// tpu_captioner/models/convnext.py:163-171; _pipeline_sub picks the
// sub-tiled body for any dtype).  LayerNorm, products, GELU and residual in
// f32, the f32 sum rounded to bf16 once.
// - The whole tile (SUB = 0, whole_tile_x3), which replaces _kernel on
//   this path: bf16 x, residual and weights, f32 products.  What bounds it
//   on the H100: the two products, 16*N*C^2 flops at 329.67 TFLOP/s (an f32
//   row split into three exact bf16 pieces times a bf16 weight, 989 / 3),
//   3.75 ms per bs-32 encoder pass, against 1.6 ms for the bf16 bytes and
//   h's f32 round trip.  The design (bf16_gemm.cuh: x3::gemm): three
//   launches, no weight split.  ln_stats writes each row's (mu, rstd);
//   the first product's consumers normalise their fragment of the bf16 x
//   box in f32 ((x - mu) rstd ln_w + ln_b, ln_w and ln_b staged in shared
//   memory), split it into three bf16 pieces in registers and run three
//   register-A wgmma a k16 step on W1's bf16 box as it lies; its epilogue
//   writes h = gelu(a + b1) as one f32 plane (N, 4C), 16*N*C bytes each
//   way; the second product reads h's f32 boxes and W2's bf16 boxes the same way
//   and runs OutEpi: the bf16 residual in, out rounded once.  Both GEMMs are
//   persistent (one block an SM walks the 128 x 128 tiles), so a tile's
//   epilogue overlaps the next tile's loads.
// - The sub-tiled path (SUB = 64): fused_kernel<C, NC, bf16, false, true>
//   (sub_tiled_x3), the three-piece instance: the TF32 instance's clusters,
//   persistent walk and exchange of h, on the bf16 tensor cores with the
//   bf16 weights read by TMA as they lie (no preparation launch, no
//   workspace).  x arrives as bf16 slabs (32 columns x 64 rows, 64-byte
//   rows with the 64-byte swizzle), the statistics read bf16 rows, and the
//   prologue normalises each thread's A fragment in f32, (x rstd - mu rstd)
//   ln_w + ln_b in two FMAs (W1 * ln_w is no bf16 value, so nothing is
//   folded; the stage's ln_w and ln_b are requested before its slot's
//   wait), reading it in the natural column order (two bf16 pairs a
//   register from the swizzled slab, free of bank conflicts: no permuted
//   copy of W1), and splits each value into three exact bf16 pieces: three
//   register-A m64nJCBk16 wgmmas a k16 step on W1's JCB x 32 bf16 box.  The
//   GELU epilogue splits h once and writes its three bf16 pieces (hi, mid,
//   lo planes, 6 bytes a value where the TF32 planes took 8) into every
//   peer; the second product runs three shared-memory-A m64n128k16 wgmmas a
//   k16 step on W2's 128 x 64 bf16 boxes, a fresh partial a 64-deep stage.
//   No consumer re-splits h.  Where the first product adds a partial a
//   stage (every tile but (256, 256) and (512, 256), whose registers hold no
//   second fragment set), its stages run in pairs, the next stage's
//   fragments computed while this stage's wgmmas run (kPipeA): the
//   fragments' ALU work, not the tensor cores, paces the first product
//   (PERF.md, row 2).  The plan (Fused<C, NC, true>, ops/
//   mlp_block.py:fused_x3_plan): the TF32 instance's S, JC and JCB; ring
//   slots of 16 KB (W2's 128 x 64 bf16 box; a first-product stage is W1's
//   box at the slot's start and the two bf16 x slabs from 4 KB on), as
//   many as fit beside both sub-tiles' h pieces (96 KB at JC = 128, 48 KB
//   at 64) and the statistics: 8 at JC = 128, 11 at 64, 231,584-231,632 B
//   of shared memory.  The epilogue reads the bf16 residual and rounds
//   once.  What bounds it: the products, 16*N*C^2 flops at 329.67 TFLOP/s
//   (3.75 ms per bs-32 pass); h never reaches device memory, so the bytes
//   (x twice, the residual and out in bf16) take 0.47 ms.
//
// The precise=False arm (tc_mlp_block_forward_bf16_products): the same TPU
// kernels with mxu_dtype=bfloat16, on f32 or bf16 data: each product's two
// operands rounded to bf16, bf16(LN(x) * ln_w + ln_b) . bf16(W1) and
// bf16(gelu(a)) . bf16(W2), the exact products summed in f32 on bf16 wgmma
// (bf16_gemm.cuh: one product a k16 step, 989 TFLOP/s, where 3xTF32 runs six
// at 165 on the same depth); LayerNorm, GELU and the residual in f32.
// What bounds it: the products, 16*N*C^2 flops at 989 TFLOP/s, 1.25 ms per
// bs-32 encoder pass (f32 data's bytes 0.80 ms).
// - The whole tile (SUB = 0, whole_tile_bf16): ln_rows_bf16 writes the
//   rounded LayerNorm rows as one bf16 (N, C) array, the first GEMM's
//   epilogue writes bf16(h) (N, 4C), the second runs OutEpi; f32 weights are
//   rounded once a call, bf16 ones read where they lie.  h's bytes through
//   device memory: 16*N*C, a quarter of the TF32 planes'.
// - The sub-tiled path (SUB = 64, sub_tiled_bf16): fused_kernel<C, NC, T,
//   true>.  W1 cannot take ln_w as prep_w1 folds it (the TPU kernel rounds
//   LN(x) * ln_w + ln_b and W1 apart; a folded W1 * ln_w rounds another
//   value), so the prologue applies ln_w and ln_b to its fragment in f32 and
//   rounds; W1 is rounded alone (prep_w1_bf16) with its columns permuted so
//   that a thread's k16 fragment is again one float4 of the x slab.  Its
//   32-column box has 64-byte rows, read with the 64-byte swizzle.  The
//   chunk of h is exchanged as one bf16 plane in 128-byte rows; the second
//   product reads W2's 64-column bf16 boxes.  A stage of the first product
//   is 2 wgmmas where the TF32 instance issues 12, of the second 4 a 64-deep
//   stage where it issues 24, and the consumers split nothing into planes.

#include <cooperative_groups.h>

#include "bf16_gemm.cuh"
#include "mlp_products.cuh"
#include "warp_reduce.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kLnThreads = 256;

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {  // four bf16 (8 bytes), widened
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float at(float4 v, int e) { return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w; }

// ------------------------------------------------ the whole-tile path (SUB = 0)

// LayerNorm of each row of x into its two TF32 planes, xs (N, C) and
// xs + N*C.
template <int C>
__global__ void __launch_bounds__(kLnThreads) ln_rows(const float* __restrict__ x, const float* __restrict__ lnw,
                                                     const float* __restrict__ lnb, float* __restrict__ xs,
                                                     int n) {
  const int row = (blockIdx.x * kLnThreads + threadIdx.x) >> 5, lane = threadIdx.x & 31;
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

// The f32 instance: f32 x, res, weights and out.
template <int C>
int whole_tile(const float* x, const float* res, const float* sd, const float* lnw, const float* lnb,
               const float* w1, const float* b1, const float* w2, const float* b2, const float* gamma,
               float* out, float* work, int n, cudaStream_t s) {
  cudaError_t err = split_weights<C>(w1, w2, work, n, s);
  if (err != cudaSuccess) return (int)err;
  ln_rows<C><<<(n + kLnThreads / 32 - 1) / (kLnThreads / 32), kLnThreads, 0, s>>>(
      x, lnw, lnb, work + make_plan(n, C).xs, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)products<C>(res, sd, 1, b1, b2, gamma, out, work, n, s);
}

// ------------------------ the bf16 whole tile: three bf16 pieces a product

// Each row's LayerNorm statistics (mu, rstd) of bf16 x, one warp a row, the
// two passes over registers of ln_rows.
template <int C>
__global__ void __launch_bounds__(kLnThreads) ln_stats(const __nv_bfloat16* __restrict__ x,
                                                      float2* __restrict__ stats, int n) {
  const int row = (blockIdx.x * kLnThreads + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= n) return;
  float4 v[C / 128];
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < C / 128; ++q) {
    v[q] = ld4(x + (size_t)row * C + 4 * lane + 128 * q);
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
  if (lane == 0) stats[row] = make_float2(mu, rstd);
}

// The bf16 instance's whole tile (the TPU kernel _kernel, mxu_dtype=float32,
// on bf16 x, res, W1 and W2): ln_stats, then a = LN(x) W1^T with LayerNorm
// in the product's prologue and h = gelu(a + b1) in its epilogue (f32, one
// plane), then out = res + sd * ((h W2^T + b2) * gamma) rounded once
// (OutEpi); both products on x3::gemm, the weights read as they lie.
template <int C>
int whole_tile_x3(const __nv_bfloat16* x, const __nv_bfloat16* res, const float* sd, const float* lnw,
                  const float* lnb, const __nv_bfloat16* w1, const float* b1, const __nv_bfloat16* w2,
                  const float* b2, const float* gamma, __nv_bfloat16* out, float* work, int n, cudaStream_t s) {
  const bf16mm::x3::TailPlan p = bf16mm::x3::tail_plan(n, C, bf16mm::x3::sm_count());
  float2* stats = reinterpret_cast<float2*>(work + p.stats);
  float* h = work + p.h;
  ln_stats<C><<<(n + kLnThreads / 32 - 1) / (kLnThreads / 32), kLnThreads, 0, s>>>(x, stats, n);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = bf16mm::x3::gemm<0>(x, w1, n, C, 4 * C, bf16mm::x3::LnA{stats, lnw, lnb}, HiddenEpiF32{b1, h, 4 * C}, s);
  if (err == cudaSuccess)
    err = bf16mm::x3::gemm<0>(h, w2, n, 4 * C, C, bf16mm::x3::RowsA{},
                              OutEpi<__nv_bfloat16>{res, sd, 1, b2, gamma, out, C}, s);
  return (int)err;
}

// ----------------------- the precise=False arm's whole tile (bf16 products)

using bf16mm::bf16;

// LayerNorm of each row of x (f32 or bf16) times ln_w plus ln_b, in f32,
// rounded to bf16 once: xb (N, C), the first product's A.
template <int C, class T>
__global__ void __launch_bounds__(kLnThreads) ln_rows_bf16(const T* __restrict__ x, const float* __restrict__ lnw,
                                                          const float* __restrict__ lnb, bf16* __restrict__ xb,
                                                          int n) {
  const int row = (blockIdx.x * kLnThreads + threadIdx.x) >> 5, lane = threadIdx.x & 31;
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
#pragma unroll
  for (int q = 0; q < C / 128; ++q) {
    const int c = 4 * lane + 128 * q;
    const float4 w = ld4(lnw + c), b = ld4(lnb + c);
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = (at(v[q], e) - mu) * rstd * at(w, e) + at(b, e);
    *reinterpret_cast<uint2*>(xb + base + c) = make_uint2(bf16mm::pack2(o[0], o[1]), bf16mm::pack2(o[2], o[3]));
  }
}

struct HiddenEpiBf16 {  // h = gelu(v + b1), rounded to bf16, into hb (N, 4C)
  const float* b1;
  bf16* hb;
  int ld;
  __device__ void operator()(int m, int n, float2 v) const {
    const float2 b = *reinterpret_cast<const float2*>(b1 + n);
    *reinterpret_cast<uint32_t*>(hb + (size_t)m * ld + n) = bf16mm::pack2(gelu_exact(v.x + b.x), gelu_exact(v.y + b.y));
  }
};

// Where the whole tile's bf16 arrays start in the workspace (floats): the
// LayerNorm rows (N C bf16), h (4 N C bf16), the rounded W1 and W2 (4 C^2
// bf16 each; a bf16 weight is read where it lies).
struct PlanBf16 {
  long long xb, hb, w1b, w2b, total;
};

inline PlanBf16 make_plan_bf16(int n, int c) {
  PlanBf16 p;
  const long long nc = (long long)n * c, cc = (long long)c * c;
  p.xb = 0;
  p.hb = p.xb + round32(nc / 2);
  p.w1b = p.hb + round32(2 * nc);
  p.w2b = p.w1b + round32(2 * cc);
  p.total = p.w2b + round32(2 * cc);
  return p;
}

// The weights as bf16: rounded into the workspace from f32, or themselves.
template <class T>
const bf16* weight_bf16(const T* w, int rows, int cols, float* dst, cudaStream_t s, cudaError_t* err) {
  if constexpr (sizeof(T) == 2) {
    return reinterpret_cast<const bf16*>(w);
  } else {
    bf16* out = reinterpret_cast<bf16*>(dst);
    if (*err == cudaSuccess) *err = bf16mm::to_bf16(w, rows, cols, out, (bf16*)nullptr, 0, s);
    return out;
  }
}

// The TPU kernel _kernel with mxu_dtype=bfloat16: x, res, the weights and
// out of T (f32, or bf16).  Three launches besides the weights' rounding:
// ln_rows_bf16; h = bf16(gelu(xb W1b^T + b1)) (N, 4C) through device
// memory; out = res + sd * ((hb W2b^T + b2) * gamma) (OutEpi, rounded once).
template <int C, class T>
int whole_tile_bf16(const T* x, const T* res, const float* sd, const float* lnw, const float* lnb, const T* w1,
                    const float* b1, const T* w2, const float* b2, const float* gamma, T* out, float* work, int n,
                    cudaStream_t s) {
  using bf16mm::Operand;
  const PlanBf16 p = make_plan_bf16(n, C);
  cudaError_t err = cudaSuccess;
  const bf16* w1b = weight_bf16(w1, 4 * C, C, work + p.w1b, s, &err);
  const bf16* w2b = weight_bf16(w2, C, 4 * C, work + p.w2b, s, &err);
  if (err != cudaSuccess) return (int)err;
  bf16* xb = reinterpret_cast<bf16*>(work + p.xb);
  bf16* hb = reinterpret_cast<bf16*>(work + p.hb);
  ln_rows_bf16<C, T><<<(n + kLnThreads / 32 - 1) / (kLnThreads / 32), kLnThreads, 0, s>>>(x, lnw, lnb, xb, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const Operand xo{xb, n, C, C}, w1o{w1b, 4 * C, C, C}, ho{hb, n, 4 * C, 4 * C}, w2o{w2b, C, 4 * C, 4 * C};
  err = bf16mm::gemm(xo, w1o, HiddenEpiBf16{b1, hb, 4 * C}, s);
  if (err == cudaSuccess) err = bf16mm::gemm(ho, w2o, OutEpi<T>{res, sd, 1, b2, gamma, out, C}, s);
  return (int)err;
}

// ------------------------------------------------ the sub-tiled path (SUB = 64)

constexpr int kSub = 64;                  // sub-tile rows: the wgmma M
constexpr int kFusedThreads = 384;        // two consumer warpgroups, one producer
constexpr int kXSlab = kSub * tf32x3::kBK;  // floats of one sub-tile's 32-column f32 x slab
constexpr int kSmemLimit = 232448;

// The tiles of width C with NC output columns a block (ops/mlp_block.py:
// FUSED_TILES holds the same numbers), for the TF32 and the bf16-product
// instances or (kX3) the three-piece one (ops/mlp_block.py:fused_x3_plan).
template <int C, int NC_, bool kX3 = false>
struct Fused {
  static constexpr int NC = NC_;                          // output columns a block
  static constexpr int S = C / NC;                        // cluster: blocks per row tile
  static constexpr int JC = S == 1 ? 64 : 128;            // hidden units per chunk
  static constexpr int JCB = JC / S;                      // hidden units a block per chunk
  static constexpr int kChunks = 4 * C / JC;
  // The first product adds each 32-deep stage from a fresh accumulator
  // where the registers allow it (128 output columns, or 32 hidden units a
  // block: C = 1024 with 256 columns); else it runs one accumulator over K
  // = C <= 512.
  static constexpr bool kStagePartial = NC == 128 || JCB <= 32;
  // A ring slot: 32 KB (a first-product stage of W1's JCB x 32 TF32 planes
  // beside both sub-tiles' x slabs, or a second-product stage of W2's 128
  // x 32 TF32 planes), or, for the three-piece instance, 16 KB (W1's JCB x
  // 32 bf16 box and two bf16 slabs, or W2's 128 x 64 bf16 box).
  static constexpr int kSlotFloats = kX3 ? 4096 : 8192;
  static constexpr int kXAt = kX3 ? 1024 : kSlotFloats / 2;  // floats: the first x slab's place in a slot
  static constexpr int kXStep = kX3 ? kXSlab / 2 : kXSlab;   // floats: the second slab's after the first
  static constexpr int kH = kSub * JC;  // floats of one f32 h plane of one sub-tile
  // Both sub-tiles' h buffers: two TF32 planes each, or three bf16 pieces
  // (hi, mid, lo: kH / 2 floats each).
  static constexpr int kHFloats = kX3 ? 3 * kH : 4 * kH;
  // The three-piece instance takes as many slots as fit beside h and the
  // statistics.
  static constexpr int kSlots =
      kX3 ? (kSmemLimit - 1024 - 4 * (kHFloats + 4 * kSub) - 8 * 4) / (4 * kSlotFloats + 16) : JC == 64 ? 5 : 3;
  static constexpr int kFloats = kSlots * kSlotFloats + kHFloats + 2 * 2 * kSub;  // ring, h, stats
  static constexpr int kSmem = 1024 + 4 * kFloats + 8 * (2 * kSlots + 4);        // + alignment, mbarriers
  static constexpr int kRowsAtOnce = 2048 / C;            // LayerNorm statistics: rows a warp loads at once
  static_assert(S * NC == C && (NC == 128 || NC == 256) && JC % tf32x3::kBK == 0 && 4 * C % JC == 0, "tiles");
  static_assert(kX3 ? 2 * tf32x3::kBK * JCB <= 4 * kXAt && 4 * (kXAt + kXStep) + 2 * kXSlab <= 4 * kSlotFloats &&
                          2 * 64 * 128 <= 4 * kSlotFloats
                    : 2 * tf32x3::kBK * JCB <= kSlotFloats / 2 && 2 * kXSlab <= kSlotFloats / 2 &&
                          2 * tf32x3::kBK * 128 <= kSlotFloats,
                "a slot holds a stage");
  static_assert(kSmem <= kSmemLimit, "shared memory");
};

// Workspace of the sub-tiled path (floats): W1's prepared planes (8 C^2),
// W2's planes (8 C^2), the folded b1 (4 C).
struct FusedPlan {
  long long w1p, w2p, b1f, total;
};

inline FusedPlan make_fused_plan(int c) {
  FusedPlan p;
  const long long cc = (long long)c * c;
  p.w1p = 0;
  p.w2p = round32(8 * cc);
  p.b1f = p.w2p + round32(8 * cc);
  p.total = p.b1f + round32(4LL * c);
  return p;
}

// W1' = W1 * ln_w (column by column) as its two TF32 planes (4C, C), the
// columns of each 16-group in the order the fused kernel's A fragments take
// them: column 16 G + 4 u + e goes to k-slot 16 G + u + 4 e.  b1' = b1 + W1
// ln_b.  One warp per row of W1.
template <int C>
__global__ void __launch_bounds__(256) prep_w1(const float* __restrict__ w1, const float* __restrict__ lnw,
                                              const float* __restrict__ lnb, const float* __restrict__ b1,
                                              float* __restrict__ w1p, float* __restrict__ b1f) {
  const int row = (blockIdx.x * 256 + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= 4 * C) return;
  const long long plane = 4LL * C * C;
  const size_t base = (size_t)row * C;
  float dot = 0.f;
#pragma unroll
  for (int q = 0; q < C / 128; ++q) {
    const int c = 4 * lane + 128 * q;
    const float4 v = ld4(w1 + base + c), lw = ld4(lnw + c), lb = ld4(lnb + c);
    const int slot = (c & ~15) + ((c & 15) >> 2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dot = fmaf(at(v, e), at(lb, e), dot);
      tf32x3::store_split(w1p, plane, base + slot + 4 * e, at(v, e) * at(lw, e));
    }
  }
  dot = warp_sum(dot);
  if (lane == 0) b1f[row] = b1[row] + dot;
}

// The precise=False arm's W1: rounded to bf16 (4C, C), nothing folded (the
// TPU kernel rounds LN(x) * ln_w + ln_b and W1 apart), the columns of each
// 16-group in the order the bf16 A fragments take them: column 16 G + 4 u
// + e goes to k-slot 16 G + 2 u + (e & 1) + 8 (e >> 1), so that a thread's
// fragment of a k16 step is again one float4 of x.  One thread an element.
template <int C, class T>
__global__ void __launch_bounds__(256) prep_w1_bf16(const T* __restrict__ w1, bf16* __restrict__ w1p) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= 4LL * C * C) return;
  const int c = (int)(i % C);
  const int slot = (c & ~15) | (((c & 15) >> 2) << 1) | (c & 1) | (((c >> 1) & 1) << 3);
  w1p[i - c + slot] = __float2bfloat16_rn(bf16mm::load_f32(w1 + i));
}

// ---------------------------------------------- cluster and barrier helpers

__device__ __forceinline__ void wg_sync(int id) { asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory"); }

// The shared::cluster address of `addr` (this block's shared window) in block `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Two floats to a shared address of this block (cluster false) or of any
// block of the cluster (a peer_addr).
template <bool cluster>
__device__ __forceinline__ void st_shared2(uint32_t addr, float a, float b) {
  if constexpr (cluster)
    asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(a), "f"(b) : "memory");
  else
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(a), "f"(b) : "memory");
}

// Two bf16 (one register) to a shared address, as st_shared2.
template <bool cluster>
__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  if constexpr (cluster)
    asm volatile("st.shared::cluster.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
  else
    asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(addr) : "memory");
}

__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Order this thread's shared-memory accesses of the generic proxy with the
// async proxy's (wgmma's operand reads): FENCE.VIEW.ASYNC.S alone, where the
// unqualified fence.proxy.async adds a GPU-wide MEMBAR.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }

// tf32x3::round_tf32 for finite v in two integer operations: half of the
// 13 dropped bits' unit added to the magnitude, then the bits cleared, which
// is round to nearest with ties away from zero, as cvt.rna.tf32.f32 rounds
// (ops/tf32.py:round_tf32).  ptxas expands cvt.rna.tf32.f32 into four
// instructions with a test for infinities and NaNs, and the splits of x and
// h are most of the consumers' ALU work.
__device__ __forceinline__ float round_tf32_finite(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ void split_reg(float v, uint32_t& hi, uint32_t& lo) {
  const float h = round_tf32_finite(v);
  hi = __float_as_uint(h);
  lo = __float_as_uint(round_tf32_finite(v - h));
}

// Where a consumer warpgroup's clocks go, for scripts/mlp_fused_probe.py
// (built with TC_MLP_PHASES defined): thread 0 of each consumer warpgroup
// of block 0 sums clock64 deltas by phase and leaves them here.
#ifdef TC_MLP_PHASES
constexpr int kPhases = 12;
__device__ unsigned long long phase_clocks[2][kPhases];
#define TC_PHASES_BEGIN long long tc_t0 = clock64(), tc_sum[kPhases] = {};
#define TC_PHASE(i)                           \
  {                                           \
    const long long tc_t = clock64();         \
    tc_sum[i] += tc_t - tc_t0;                \
    tc_t0 = tc_t;                             \
  }
#define TC_PHASES_END \
  if (blockIdx.x == 0 && tid == 0)  \
    for (int i = 0; i < kPhases; ++i) phase_clocks[w][i] = tc_sum[i];
#else
#define TC_PHASES_BEGIN
#define TC_PHASE(i)
#define TC_PHASES_END
#endif

// Where a thread's four x columns 16 G + 4 q .. + 3 of row r (r % 8 = g)
// sit in a staged slab of 32 columns: f32 rows of 128 bytes with the
// 128-byte swizzle (16-byte chunk c at c ^ (r % 8)); bf16 rows of 64 bytes
// with the 64-byte swizzle (chunk c of the 128-byte line r / 2 at c ^ (r /
// 2 % 4); the four columns are half a chunk).
__device__ __forceinline__ int slab_at(const float*, int r, int G, int q, int g) {
  return r * tf32x3::kBK + (((4 * G + q) ^ g) << 2);
}
__device__ __forceinline__ int slab_at(const __nv_bfloat16*, int r, int G, int q, int) {
  return r * tf32x3::kBK + ((((2 * G + (q >> 1)) ^ ((r >> 1) & 3)) << 3) | ((q & 1) << 2));
}

// Where bf16 columns k and k + 1 (k even) of row r sit in a bf16 slab: the
// natural order's half of an A fragment register.
__device__ __forceinline__ int slab_pair(int r, int k) {
  return r * tf32x3::kBK + ((((k >> 3) ^ ((r >> 1) & 3)) << 3) | (k & 7));
}

// The three-piece instance's first product, one 32-column stage (kX3 of
// fused_kernel).  x3_ln: the stage's ln_w and ln_b pairs at columns col0 +
// 16 G + 8 e + 2 q and the next.
__device__ __forceinline__ void x3_ln(const float* lnw, const float* lnb, int col0, int q, float2 (&lw)[2][2],
                                      float2 (&lb)[2][2]) {
#pragma unroll
  for (int G = 0; G < 2; ++G)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      lw[G][e] = *reinterpret_cast<const float2*>(lnw + col0 + 16 * G + 8 * e + 2 * q);
      lb[G][e] = *reinterpret_cast<const float2*>(lnb + col0 + 16 * G + 8 * e + 2 * q);
    }
}

// The A fragments of the stage's two k16 steps in the natural order: k16
// step G takes columns 16 G + 8 e + 2 q and the next (k-slots 2 q + 8 e, +
// 1) of rows ra (register hr + 2 e, hr = 0) and ra + 8 (hr = 1) of the bf16
// slab xs, LayerNorm'd in f32 with two FMAs a value (x rstd - mean rstd
// from the rows' st = (rstd, -mean rstd), then ln_w and ln_b, as the
// bf16-product instance), each value split into three exact bf16 pieces:
// a[G][piece: hi, mid, lo].
__device__ __forceinline__ void x3_frags(const __nv_bfloat16* xs, int ra, int q, float2 sa, float2 sb,
                                         const float2 (&lw)[2][2], const float2 (&lb)[2][2],
                                         uint32_t (&a)[2][3][4]) {
#pragma unroll
  for (int G = 0; G < 2; ++G)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float2 st = hr ? sb : sa, w = lw[G][e], b = lb[G][e];
        const uint32_t u = *reinterpret_cast<const uint32_t*>(xs + slab_pair(ra + 8 * hr, 16 * G + 8 * e + 2 * q));
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
        bf16mm::x3::split3(fmaf(fmaf(v.x, st.x, st.y), w.x, b.x), fmaf(fmaf(v.y, st.x, st.y), w.y, b.y),
                           a[G][0][hr + 2 * e], a[G][1][hr + 2 * e], a[G][2][hr + 2 * e]);
      }
}

// The stage's wgmmas: three a k16 step on W1's JCB x 32 bf16 box (64-byte
// rows) at `slot`, lo first, the first into a fresh d unless `acc`.
template <int JCB>
__device__ __forceinline__ void x3_first(float (&d)[JCB / 2], const uint32_t (&a)[2][3][4], const void* slot,
                                         bool acc) {
  const uint64_t bd = bf16mm::desc64(slot);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    bf16mm::wgmma_rs<JCB>(d, a[t][2], bd + 2 * t, acc || t > 0);
    bf16mm::wgmma_rs<JCB>(d, a[t][1], bd + 2 * t, 1);
    bf16mm::wgmma_rs<JCB>(d, a[t][0], bd + 2 * t, 1);
  }
}

// Keeps a stage's fragments in their registers until here: a register-A
// wgmma reads them after it issues, which the compiler does not see.
__device__ __forceinline__ void x3_hold(uint32_t (&a)[2][3][4]) {
#pragma unroll
  for (int i = 0; i < 24; ++i) asm volatile("" : "+r"(a[i / 12][i / 4 % 3][i % 4])::"memory");
}

// Stage i's fragments (x3_frags) into `a`: its ln_w and ln_b requested, its
// slot (i % slots) waited for; xs0 is the sub-tile's slab in slot 0.
__device__ __forceinline__ void x3_stage(const float* xs0, uint64_t* full, int i, int slots, int slot_floats,
                                         const float* lnw, const float* lnb, int col0, int ra, int q, float2 sa,
                                         float2 sb, uint32_t (&a)[2][3][4]) {
  float2 lw[2][2], lb[2][2];
  x3_ln(lnw, lnb, col0, q, lw, lb);
  mbar_wait(&full[i % slots], (i / slots) & 1);
  x3_frags(reinterpret_cast<const __nv_bfloat16*>(xs0 + i % slots * slot_floats), ra, q, sa, sb, lw, lb, a);
}

// grid: clusters x S blocks (clusters along x); pairs = ceil(n / 128) row
// tiles, cluster i taking tiles i, i + clusters, ...  x, res and out of T:
// f32 (the TF32 instance), or bf16 (kBP, kX3).  kBP: the
// precise=False arm (bf16 products; see the notes of sub_tiled_bf16), whose
// prologue applies lnw and lnb (b1f is then b1 itself); the other instances
// ignore lnw and lnb (folded into W1 and b1f).  kX3: the three-piece
// instance (bf16 T, precise=True; see the notes of sub_tiled_x3), whose
// prologue applies lnw and lnb too and whose W1 and W2 are the bf16 weights
// as they lie (b1f is b1).
template <int C, int NC, class T, bool kBP = false, bool kX3 = false>
__global__ void __launch_bounds__(kFusedThreads, 1)
    fused_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap w1map,
                 const __grid_constant__ CUtensorMap w2map, const T* __restrict__ x,
                 const T* __restrict__ res, const float* __restrict__ sd, const float* __restrict__ lnw,
                 const float* __restrict__ lnb, const float* __restrict__ b1f,
                 const float* __restrict__ b2, const float* __restrict__ gamma, T* __restrict__ out, int n,
                 int pairs) {
  using F = Fused<C, NC, kX3>;
  constexpr int S = F::S, JCB = F::JCB, JC = F::JC, kSlots = F::kSlots, kBK = tf32x3::kBK;
  constexpr int kSlotFloats = F::kSlotFloats;
  constexpr bool kBoxes16 = kBP || kX3;  // bf16 weight boxes and bf16 h planes
  // K columns of a W2 stage: 32 of f32 planes, or 64 of bf16 (128-byte rows
  // either way).
  constexpr int kW2K = kBoxes16 ? 64 : kBK;
  constexpr int kPiece = kSub * JC;  // bf16 elements of one h piece plane of one sub-tile (kX3)
  // kX3 where the first product adds a partial a stage (the registers of
  // the other tiles hold no second fragment set): its stages pipelined, the
  // next stage's fragments computed under this stage's wgmmas (PERF.md,
  // row 2).
  constexpr bool kPipeA = kX3 && F::kStagePartial;
  static_assert(!kPipeA || (F::kStagePartial && (C / kBK) % 2 == 0), "stages in pairs, each into hp");
  extern __shared__ uint8_t smem_raw[];
  // Slots and h planes start on 1024-byte boundaries, where the 128-byte
  // swizzle pattern starts over (the descriptors' base offset 0).
  float* ring = reinterpret_cast<float*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  // (2 sub-tiles, hi / lo, JC / 32, 64, 32), or (kX3) (2 sub-tiles, hi /
  // mid / lo, JC / 64, 64, 64) of bf16.
  float* hbuf = ring + kSlots * kSlotFloats;
  // (2 sub-tiles, 64 rows): rstd, -mean rstd.
  float2* stats = reinterpret_cast<float2*>(hbuf + F::kHFloats);
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + 2 * kSub);
  uint64_t* empty = full + kSlots;
  uint64_t* hfull = empty + kSlots;  // per sub-tile: every rank has written the chunk here
  uint64_t* hfree = hfull + 2;       // per sub-tile: every rank has read the chunk this block wrote
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  int rank = 0;
  if constexpr (S > 1) rank = (int)cg::this_cluster().block_rank();
  const int cluster_id = blockIdx.x / S, clusters = gridDim.x / S;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(&hfull[w], S);
      mbar_init(&hfree[w], S);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (S > 1)
    cg::this_cluster().sync();  // peers arrive on this block's barriers
  else
    __syncthreads();

  // One big branch per role, never rejoined, so that setmaxnreg can move
  // registers from the producer to the consumers.
  if (wg == 2) {  // the producer: the same slot sequence the consumers walk
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 0) {
      int it = 0;
      auto next = [&](uint32_t bytes) {
        const int s = it % kSlots;
        if (it >= kSlots) mbar_wait(&empty[s], ((it / kSlots) & 1) ^ 1);
        mbar_expect_tx(&full[s], bytes);
        ++it;
        return s;
      };
      for (int p = cluster_id; p < pairs; p += clusters)
        for (int j = 0; j < F::kChunks; ++j) {
          for (int kt = 0; kt < C / kBK; ++kt) {  // W1's rows of this block's units, both sub-tiles' x
            const int s = next((kBoxes16 ? 2 : 4 * 2) * kBK * JCB + (int)sizeof(T) * 2 * kXSlab);
            float* slot = ring + s * kSlotFloats;
            if constexpr (kBoxes16)
              tma_load_2d(slot, &w1map, kt * kBK, j * JC + rank * JCB, &full[s]);
            else
              tf32x3::tma_load(slot, &w1map, kt * kBK, j * JC + rank * JCB, &full[s]);
            tma_load_2d(slot + F::kXAt, &xmap, kt * kBK, p * 2 * kSub, &full[s]);
            tma_load_2d(slot + F::kXAt + F::kXStep, &xmap, kt * kBK, p * 2 * kSub + kSub, &full[s]);
          }
          for (int half = 0; half < F::NC / 128; ++half)
            for (int kt = 0; kt < JC / kW2K; ++kt) {  // W2's rows of this block's output columns
              if constexpr (kBoxes16) {
                const int s = next(2 * kW2K * 128);
                tma_load_2d(ring + s * kSlotFloats, &w2map, j * JC + kt * kW2K, rank * F::NC + half * 128, &full[s]);
              } else {
                const int s = next(4 * 2 * kBK * 128);
                tf32x3::tma_load(ring + s * kSlotFloats, &w2map, j * JC + kt * kBK, rank * F::NC + half * 128,
                                 &full[s]);
              }
            }
        }
    }
    __syncwarp();
    if constexpr (S > 1) cg::this_cluster().sync();  // peers may still write this block's buffers
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int w = wg, wi = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
    const int ra = 16 * wi + g;  // this thread's rows of the sub-tile: ra and ra + 8
    float* hh = hbuf + w * (F::kHFloats / 2);
    uint32_t hdst[S];  // this sub-tile's h buffer in every rank
#pragma unroll
    for (int r = 0; r < S; ++r) hdst[r] = S > 1 ? peer_addr(smem_u32(hh), r) : smem_u32(hh);
    // A slot is free again once every consumer warp is done with it: one
    // arrival a warp, not one a thread, each of which the barrier would
    // take in turn.
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    };
    int it = 0, chunk_no = 0;
    TC_PHASES_BEGIN
    for (int p = cluster_id; p < pairs; p += clusters) {
      const int row0 = p * 2 * kSub + w * kSub;

      // LayerNorm statistics, two passes over registers, kRowsAtOnce rows
      // of the warp's 16 in flight.  Rows past n are zeros (and TMA
      // zero-fills them in the slabs): never stored.
      for (int i0 = 0; i0 < 16; i0 += F::kRowsAtOnce) {
        float4 v[F::kRowsAtOnce][C / 128];
#pragma unroll
        for (int i = 0; i < F::kRowsAtOnce; ++i) {
          const int m = row0 + 16 * wi + i0 + i;
#pragma unroll
          for (int u = 0; u < C / 128; ++u)
            v[i][u] = m < n ? ld4(x + (size_t)m * C + 4 * lane + 128 * u) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < F::kRowsAtOnce; ++i) {
          float s = 0.f;
#pragma unroll
          for (int u = 0; u < C / 128; ++u) s += (v[i][u].x + v[i][u].y) + (v[i][u].z + v[i][u].w);
          const float mu = warp_sum(s) * (1.0f / C);
          float ss = 0.f;
#pragma unroll
          for (int u = 0; u < C / 128; ++u) {
            const float a = v[i][u].x - mu, b = v[i][u].y - mu, c = v[i][u].z - mu, d = v[i][u].w - mu;
            ss += (a * a + b * b) + (c * c + d * d);
          }
          const float rstd = rsqrtf(warp_sum(ss) * (1.0f / C) + kLnEps);
          if (lane == 0) stats[w * kSub + 16 * wi + i0 + i] = make_float2(rstd, -mu * rstd);
        }
      }
      __syncwarp();
      const float2 sa = stats[w * kSub + ra], sb = stats[w * kSub + ra + 8];
      TC_PHASE(0)  // statistics

      float acc[F::NC / 2];
#pragma unroll
      for (int i = 0; i < F::NC / 2; ++i) acc[i] = 0.f;
      for (int j = 0; j < F::kChunks; ++j, ++chunk_no) {
        // The first product: this block's JCB hidden units of the chunk.
        float h[JCB / 2], hp[JCB / 2];
#pragma unroll
        for (int i = 0; i < JCB / 2; ++i) h[i] = hp[i] = 0.f;
        if constexpr (kPipeA) {
          // The three-piece stages in pairs, the next stage's fragments
          // computed while this stage's wgmmas run (two fragment sets), each
          // stage into hp afresh, added into h once its wgmmas are done.
          uint32_t a0[2][3][4], a1[2][3][4];
          constexpr int nk = C / kBK;
          const float* xs0 = ring + F::kXAt + w * F::kXStep;  // this sub-tile's slab in slot 0
          x3_stage(xs0, full, it, kSlots, kSlotFloats, lnw, lnb, 0, ra, q, sa, sb, a0);
          for (int kt = 0; kt < nk; kt += 2) {
            const int s0 = (it + kt) % kSlots, s1 = (it + kt + 1) % kSlots;
            tf32x3::fence_regs(hp);
            bf16mm::wgmma_fence();
            x3_first<JCB>(hp, a0, ring + s0 * kSlotFloats, false);
            tf32x3::wgmma_commit();
            x3_stage(xs0, full, it + kt + 1, kSlots, kSlotFloats, lnw, lnb, (kt + 1) * kBK, ra, q, sa, sb, a1);
            tf32x3::wgmma_wait<0>();
            tf32x3::fence_regs(hp);
            x3_hold(a0);
            release(s0);
#pragma unroll
            for (int i = 0; i < JCB / 2; ++i) h[i] += hp[i];
            tf32x3::fence_regs(hp);
            bf16mm::wgmma_fence();
            x3_first<JCB>(hp, a1, ring + s1 * kSlotFloats, false);
            tf32x3::wgmma_commit();
            if (kt + 2 < nk)
              x3_stage(xs0, full, it + kt + 2, kSlots, kSlotFloats, lnw, lnb, (kt + 2) * kBK, ra, q, sa, sb, a0);
            tf32x3::wgmma_wait<0>();
            tf32x3::fence_regs(hp);
            x3_hold(a1);
            release(s1);
#pragma unroll
            for (int i = 0; i < JCB / 2; ++i) h[i] += hp[i];
          }
          it += C / kBK;
          TC_PHASE(3)  // the first product
        } else
        for (int kt = 0; kt < C / kBK; ++kt, ++it) {
          const int s = it % kSlots;
          float2 lw[2][2], lb[2][2];  // kX3: requested before the wait for the slot
          if constexpr (kX3) x3_ln(lnw, lnb, kt * kBK, q, lw, lb);
          mbar_wait(&full[s], (it / kSlots) & 1);
          TC_PHASE(1)  // the first product's slot
          const float* slot = ring + s * kSlotFloats;
          const T* xs = reinterpret_cast<const T*>(slot + F::kXAt + w * F::kXStep);
          // Into hp, which the stage starts afresh, or straight into h,
          // which the chunk's first stage starts afresh.
          float (&d)[JCB / 2] = F::kStagePartial ? hp : h;
          const int fresh = F::kStagePartial ? 0 : kt;
          if constexpr (kBP) {
            // A fragments of the two k16 steps: k-step G takes columns 16 G
            // + 4 q .. + 3 of rows ra and ra + 8, LayerNorm'd with ln_w and
            // ln_b and rounded to bf16 (k-slots 2 q, 2 q + 1, 2 q + 8, 2 q +
            // 9: W1's permutation, prep_w1_bf16).
            uint32_t a[2][4];
#pragma unroll
            for (int G = 0; G < 2; ++G) {
              const int col = kt * kBK + 16 * G + 4 * q;
              const float4 va = ld4(xs + slab_at(xs, ra, G, q, g)), vb = ld4(xs + slab_at(xs, ra + 8, G, q, g));
              const float4 lw = ld4(lnw + col), lb = ld4(lnb + col);
              float xa[4], xb[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                xa[e] = fmaf(fmaf(at(va, e), sa.x, sa.y), at(lw, e), at(lb, e));
                xb[e] = fmaf(fmaf(at(vb, e), sb.x, sb.y), at(lw, e), at(lb, e));
              }
              a[G][0] = bf16mm::pack2(xa[0], xa[1]);
              a[G][1] = bf16mm::pack2(xb[0], xb[1]);
              a[G][2] = bf16mm::pack2(xa[2], xa[3]);
              a[G][3] = bf16mm::pack2(xb[2], xb[3]);
            }
            tf32x3::fence_regs(d);
            TC_PHASE(2)  // A fragments
            bf16mm::wgmma_fence();
            const uint64_t bd = bf16mm::desc64(slot);
#pragma unroll
            for (int t = 0; t < 2; ++t) bf16mm::wgmma_rs<JCB>(d, a[t], bd + 2 * t, fresh > 0 || t > 0);
          } else if constexpr (kX3) {
            uint32_t a[2][3][4];
            x3_frags(xs, ra, q, sa, sb, lw, lb, a);
            tf32x3::fence_regs(d);
            TC_PHASE(2)  // A fragments
            bf16mm::wgmma_fence();
            x3_first<JCB>(d, a, slot, fresh > 0);  // into the stage's (or the chunk's) partial
          } else {
            // A fragments of the four k-steps: k-step 2 G + e2 takes columns
            // 16 G + 4 q + 2 e2 (k-slot q) and + 1 (k-slot q + 4), W1's
            // permutation (prep_w1); the slab is swizzled (slab_at).
            uint32_t ahi[4][4], alo[4][4];
#pragma unroll
            for (int G = 0; G < 2; ++G) {
              const float4 va = ld4(xs + slab_at(xs, ra, G, q, g)), vb = ld4(xs + slab_at(xs, ra + 8, G, q, g));
#pragma unroll
              for (int e2 = 0; e2 < 2; ++e2) {
                const int t = 2 * G + e2;
                split_reg(fmaf(at(va, 2 * e2), sa.x, sa.y), ahi[t][0], alo[t][0]);
                split_reg(fmaf(at(vb, 2 * e2), sb.x, sb.y), ahi[t][1], alo[t][1]);
                split_reg(fmaf(at(va, 2 * e2 + 1), sa.x, sa.y), ahi[t][2], alo[t][2]);
                split_reg(fmaf(at(vb, 2 * e2 + 1), sb.x, sb.y), ahi[t][3], alo[t][3]);
              }
            }
            tf32x3::fence_regs(d);
            TC_PHASE(2)  // A fragments
            tf32x3::wgmma_fence();
            const uint64_t bh = tf32x3::smem_desc(slot), bl = tf32x3::smem_desc(slot + kBK * JCB);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              tf32x3::wgmma_rs<JCB>(d, ahi[t], bl + 2 * t, fresh > 0 || t > 0);
              tf32x3::wgmma_rs<JCB>(d, alo[t], bh + 2 * t, 1);
              tf32x3::wgmma_rs<JCB>(d, ahi[t], bh + 2 * t, 1);
            }
          }
          tf32x3::wgmma_commit();
          tf32x3::wgmma_wait<0>();
          tf32x3::fence_regs(d);
          TC_PHASE(3)  // the first product's wgmmas
          release(s);
          if constexpr (F::kStagePartial) {
#pragma unroll
            for (int i = 0; i < JCB / 2; ++i) h[i] += hp[i];
          }
          TC_PHASE(4)  // release, partial added
        }

        // GELU and the split; the planes into every rank's buffer for this
        // sub-tile, once every rank has read the previous chunk there.
        if constexpr (S > 1)
          if (chunk_no > 0) mbar_wait_cluster(&hfree[w], (chunk_no - 1) & 1);
#pragma unroll
        for (int jj = 0; jj < JCB / 8; ++jj) {
          const int kk = rank * JCB + 8 * jj + 2 * q;  // hidden unit within the chunk
          const float2 b = *reinterpret_cast<const float2*>(b1f + j * JC + kk);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const float v0 = gelu_exact(h[4 * jj + 2 * hr] + b.x), v1 = gelu_exact(h[4 * jj + 2 * hr + 1] + b.y);
            const int row = ra + 8 * hr;
            if constexpr (kBP) {
              // One bf16 plane: 64-unit slabs of 128-byte rows, 128-byte swizzle.
              const uint32_t off = 2 * ((kk >> 6) * kSub * 64 + row * 64) + ((((kk & 63) >> 3) ^ g) << 4) +
                                   ((kk & 7) << 1);
              const uint32_t v = bf16mm::pack2(v0, v1);
#pragma unroll
              for (int r = 0; r < S; ++r) st_shared_b32<(S > 1)>(hdst[r] + off, v);
            } else if constexpr (kX3) {
              // Three bf16 planes, hi, mid and lo, each in kBP's layout.
              const uint32_t off = 2 * ((kk >> 6) * kSub * 64 + row * 64) + ((((kk & 63) >> 3) ^ g) << 4) +
                                   ((kk & 7) << 1);
              uint32_t hi, mid, lo;
              bf16mm::x3::split3(v0, v1, hi, mid, lo);
#pragma unroll
              for (int r = 0; r < S; ++r) {
                st_shared_b32<(S > 1)>(hdst[r] + off, hi);
                st_shared_b32<(S > 1)>(hdst[r] + off + 2 * kPiece, mid);
                st_shared_b32<(S > 1)>(hdst[r] + off + 4 * kPiece, lo);
              }
            } else {
              const float h0 = round_tf32_finite(v0), h1 = round_tf32_finite(v1);
              const float l0 = round_tf32_finite(v0 - h0), l1 = round_tf32_finite(v1 - h1);
              const uint32_t off = 4 * ((kk / kBK) * kSub * kBK + row * kBK + ((((kk % kBK) >> 2) ^ g) << 2) + (kk & 3));
#pragma unroll
              for (int r = 0; r < S; ++r) {
                st_shared2<(S > 1)>(hdst[r] + off, h0, h1);
                st_shared2<(S > 1)>(hdst[r] + off + 4 * F::kH, l0, l1);
              }
            }
          }
        }
        TC_PHASE(5)  // GELU, split, stores
        fence_proxy_async();  // the planes are read by wgmma, through the async proxy
        if constexpr (S > 1) {
          asm volatile("fence.acq_rel.cluster;" ::: "memory");
          wg_sync(1 + w);
          if (tid == 0)
            for (int r = 0; r < S; ++r) mbar_arrive_cluster(peer_addr(smem_u32(&hfull[w]), r));
          mbar_wait_cluster(&hfull[w], chunk_no & 1);
          fence_proxy_async();
        } else {
          wg_sync(1 + w);
        }

        // The second product: the chunk's h (64 x JC) against W2's rows of
        // this block's 128 output columns, into a fresh partial.
        TC_PHASE(6)  // the exchange of h
#pragma unroll
        for (int half = 0; half < F::NC / 128; ++half) {  // 128 output columns at a time
          float op[64];
          for (int kt = 0; kt < JC / kW2K; ++kt, ++it) {
            const int s = it % kSlots;
            mbar_wait(&full[s], (it / kSlots) & 1);
            TC_PHASE(7)  // the second product's slot
            const float* slot = ring + s * kSlotFloats;
            tf32x3::fence_acc(op);
            tf32x3::wgmma_fence();
            if constexpr (kBP) {
              const bf16* hb = reinterpret_cast<const bf16*>(hh) + kt * kSub * kW2K;
#pragma unroll
              for (int kk = 0; kk < kW2K / 16; ++kk)
                bf16mm::wgmma_ss128(op, bf16mm::desc128(hb) + 2 * kk, bf16mm::desc128(slot) + 2 * kk, kt > 0 || kk > 0);
            } else if constexpr (kX3) {
              // The stage's three products a k16 step, lo first, into a
              // fresh partial: the chunk's 64-unit slab kt of each piece
              // plane against W2's 128 x 64 bf16 box.
              const bf16* hb = reinterpret_cast<const bf16*>(hh) + kt * kSub * kW2K;
#pragma unroll
              for (int kk = 0; kk < kW2K / 16; ++kk) {
                const uint64_t bd = bf16mm::desc128(slot) + 2 * kk;
                bf16mm::wgmma_ss128(op, bf16mm::desc128(hb + 2 * kPiece) + 2 * kk, bd, kk > 0);
                bf16mm::wgmma_ss128(op, bf16mm::desc128(hb + kPiece) + 2 * kk, bd, 1);
                bf16mm::wgmma_ss128(op, bf16mm::desc128(hb) + 2 * kk, bd, 1);
              }
            } else {
              const uint64_t ah = tf32x3::smem_desc(hh + kt * kSub * kBK);
              const uint64_t al = tf32x3::smem_desc(hh + F::kH + kt * kSub * kBK);
              const uint64_t bh = tf32x3::smem_desc(slot), bl = tf32x3::smem_desc(slot + kBK * 128);
#pragma unroll
              for (int kk = 0; kk < kBK / 8; ++kk) {
                tf32x3::wgmma_tf32(op, ah + 2 * kk, bl + 2 * kk, kt > 0 || kk > 0);
                tf32x3::wgmma_tf32(op, al + 2 * kk, bh + 2 * kk, 1);
                tf32x3::wgmma_tf32(op, ah + 2 * kk, bh + 2 * kk, 1);
              }
            }
            tf32x3::wgmma_commit();
            tf32x3::wgmma_wait<0>();
            tf32x3::fence_acc(op);
            TC_PHASE(8)  // the second product's wgmmas
            release(s);
            if constexpr (kX3) {
#pragma unroll
              for (int i = 0; i < 64; ++i) acc[64 * half + i] += op[i];
            }
            TC_PHASE(9)  // release
          }
          if constexpr (!kX3) {
#pragma unroll
            for (int i = 0; i < 64; ++i) acc[64 * half + i] += op[i];
          }
        }
        if constexpr (S > 1) {
          wg_sync(1 + w);  // every warp's products have read the chunk
          if (tid == 0)
            for (int r = 0; r < S; ++r) mbar_arrive_cluster(peer_addr(smem_u32(&hfree[w]), r));
        }
        TC_PHASE(10)  // partial added, peers told
      }

      // out = res + sd * ((acc + b2) * gamma), as OutEpi: acc[64 half + 4j +
      // 2hr + e] is row ra + 8 hr, column 128 half + 8 j + 2 q + e of the
      // block's NC.
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = row0 + ra + 8 * hr;
        if (m >= n) continue;
        const float sm = sd[m];
#pragma unroll
        for (int half = 0; half < F::NC / 128; ++half) {
          const int col0 = rank * F::NC + 128 * half + 2 * q;
          float2 r[16];  // the residuals, all requested before the first is used
#pragma unroll
          for (int jj = 0; jj < 16; ++jj) r[jj] = load2(res + (size_t)m * C + col0 + 8 * jj);
#pragma unroll
          for (int jj = 0; jj < 16; ++jj) {
            const int col = col0 + 8 * jj, a = 64 * half + 4 * jj + 2 * hr;
            const float2 b = *reinterpret_cast<const float2*>(b2 + col);
            const float2 gm = *reinterpret_cast<const float2*>(gamma + col);
            store2(out + (size_t)m * C + col,
                   make_float2(r[jj].x + sm * ((acc[a] + b.x) * gm.x), r[jj].y + sm * ((acc[a + 1] + b.y) * gm.y)));
          }
        }
      }
      TC_PHASE(11)  // epilogue
    }
    TC_PHASES_END
    if constexpr (S > 1) cg::this_cluster().sync();
  }
}

// x (n, C) as 32-column x 64-row boxes: f32 rows of 128 bytes with the
// 128-byte swizzle, bf16 rows of 64 bytes with the 64-byte swizzle
// (slab_at); rows past n arrive as zeros.
template <class T>
inline cudaError_t x_map(CUtensorMap* map, const T* x, int n, int c) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  constexpr bool f32 = sizeof(T) == 4;
  const cuuint64_t dims[2] = {(cuuint64_t)c, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)c * sizeof(T)};
  const cuuint32_t box[2] = {tf32x3::kBK, kSub};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                            const_cast<T*>(x), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            f32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaLaunchConfig_t fused_config(int clusters, int S, int smem, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * S);
  cfg.blockDim = dim3(kFusedThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = S > 1 ? 1 : 0;
  return cfg;
}

// How many clusters of an instance the card runs at once (asked once).
template <int C, int NC, class T, bool kBP = false, bool kX3 = false>
cudaError_t active_clusters(int* out) {
  using F = Fused<C, NC, kX3>;
  static int cached = 0;
  if (cached > 0) {
    *out = cached;
    return cudaSuccess;
  }
  cudaError_t err =
      cudaFuncSetAttribute(fused_kernel<C, NC, T, kBP, kX3>, cudaFuncAttributeMaxDynamicSharedMemorySize, F::kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = fused_config(1, F::S, F::kSmem, nullptr, attr);
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, fused_kernel<C, NC, T, kBP, kX3>, &cfg);
  if (err != cudaSuccess) return err;
  if (n < 1) return cudaErrorInvalidConfiguration;
  *out = cached = n;
  return cudaSuccess;
}

// The output columns a block of the sub-tiled path takes for n rows of
// width C: 256 where that runs the row tiles in fewer rounds of the
// clusters the card holds at once, else 128 (twice the blocks to a tile).
// At 256 a block does twice the work with fewer, wider wgmmas and half the
// peers (PERF.md, row 2).
template <int C, class T = float, bool kBP = false, bool kX3 = false>
cudaError_t fused_columns(int n, int* nc) {
  *nc = 128;
  if constexpr (C > 128) {
    int c128 = 0, c256 = 0;
    cudaError_t err = active_clusters<C, 128, T, kBP, kX3>(&c128);
    if (err == cudaSuccess) err = active_clusters<C, 256, T, kBP, kX3>(&c256);
    if (err != cudaSuccess) return err;
    const int pairs = (n + 2 * kSub - 1) / (2 * kSub);
    if ((pairs + c256 - 1) / c256 < (pairs + c128 - 1) / c128) *nc = 256;
  }
  return cudaSuccess;
}

// The TF32 instance: f32 x, res, weights and out; W1 prepared (prep_w1),
// W2 split into its TF32 planes, each a call.
template <int C, int NC>
int sub_tiled(const float* x, const float* res, const float* sd, const float* lnw, const float* lnb,
              const float* w1, const float* b1, const float* w2, const float* b2, const float* gamma, float* out,
              float* work, int n, cudaStream_t s) {
  using F = Fused<C, NC>;
  const FusedPlan p = make_fused_plan(C);
  int clusters = 0;
  cudaError_t err = active_clusters<C, NC, float>(&clusters);
  if (err != cudaSuccess) return (int)err;
  prep_w1<C><<<C / 2, 256, 0, s>>>(w1, lnw, lnb, b1, work + p.w1p, work + p.b1f);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = tf32x3::split(w2, C, 4 * C, work + p.w2p, nullptr, 0, s)) != cudaSuccess) return (int)err;
  CUtensorMap xm, w1m, w2m;
  err = x_map(&xm, x, n, C);
  if (err == cudaSuccess) err = tf32x3::make_map(&w1m, {work + p.w1p, 4 * C, C, C, 4LL * C * C}, F::JCB);
  if (err == cudaSuccess)
    err = tf32x3::make_map(&w2m, {work + p.w2p, C, 4 * C, 4 * C, 4LL * C * C}, 128);
  if (err != cudaSuccess) return (int)err;
  const int pairs = (n + 2 * kSub - 1) / (2 * kSub);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fused_config(pairs < clusters ? pairs : clusters, F::S, F::kSmem, s, attr);
  err = cudaLaunchKernelEx(&cfg, fused_kernel<C, NC, float>, xm, w1m, w2m, x, res, sd, lnw, lnb,
                           (const float*)(work + p.b1f), b2, gamma, out, n, pairs);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Workspace of the precise=False arm's sub-tiled path (floats): W1 rounded
// and permuted (4 C^2 bf16), W2 rounded (4 C^2 bf16; a bf16 W2 is read
// where it lies).
struct FusedPlanBf16 {
  long long w1p, w2b, total;
};

inline FusedPlanBf16 make_fused_plan_bf16(int c) {
  FusedPlanBf16 p;
  const long long cc = (long long)c * c;
  p.w1p = 0;
  p.w2b = round32(2 * cc);
  p.total = p.w2b + round32(2 * cc);
  return p;
}

// The TPU kernel _kernel_pipelined with mxu_dtype=bfloat16:
// fused_kernel<C, NC, T, true>, the tiles, the ring, the clusters and the
// exchange of h of the other instances, with bf16 wgmma products:
// - W1 is rounded to bf16 apart from ln_w (prep_w1_bf16): the prologue
//   normalises its A fragment from the staged x slab, applies ln_w and
//   ln_b in f32 and rounds to bf16, the TPU kernel's rounding point; two
//   m64nJCBk16 wgmmas a 32-column stage, A from registers, W1's 32-column
//   box (64-byte rows) read with the 64-byte swizzle;
// - h_j = gelu(...) is rounded to bf16 and exchanged as one plane (a
//   quarter of the f32 planes' bytes) in 64-unit slabs of 128-byte rows;
// - the second product reads W2's 64-column bf16 boxes (128-byte rows) and
//   runs four m64n128k16 wgmmas a stage.
template <int C, int NC, class T>
int sub_tiled_bf16(const T* x, const T* res, const float* sd, const float* lnw, const float* lnb, const T* w1,
                   const float* b1, const T* w2, const float* b2, const float* gamma, T* out, float* work, int n,
                   cudaStream_t s) {
  using F = Fused<C, NC>;
  const FusedPlanBf16 p = make_fused_plan_bf16(C);
  int clusters = 0;
  cudaError_t err = active_clusters<C, NC, T, true>(&clusters);
  if (err != cudaSuccess) return (int)err;
  bf16* w1p = reinterpret_cast<bf16*>(work + p.w1p);
  prep_w1_bf16<C, T><<<C * C / 64, 256, 0, s>>>(w1, w1p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const bf16* w2b = weight_bf16(w2, C, 4 * C, work + p.w2b, s, &err);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xm, w1m, w2m;
  err = x_map(&xm, x, n, C);
  if (err == cudaSuccess) err = bf16mm::make_map(&w1m, {w1p, 4 * C, C, C}, 32, F::JCB);
  if (err == cudaSuccess) err = bf16mm::make_map(&w2m, {w2b, C, 4 * C, 4 * C}, 64, 128);
  if (err != cudaSuccess) return (int)err;
  const int pairs = (n + 2 * kSub - 1) / (2 * kSub);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fused_config(pairs < clusters ? pairs : clusters, F::S, F::kSmem, s, attr);
  err = cudaLaunchKernelEx(&cfg, fused_kernel<C, NC, T, true>, xm, w1m, w2m, x, res, sd, lnw, lnb, b1, b2, gamma,
                           out, n, pairs);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The TPU kernel _kernel_pipelined with mxu_dtype=float32 on bf16 x,
// residual, W1 and W2: fused_kernel<C, NC, bf16, false, true>, the
// clusters, the persistent walk and the exchange of h of the other
// instances, on the bf16 tensor cores with the weights as they lie (no
// preparation launch, no workspace):
// - the prologue normalises its A fragment from the staged bf16 x slab in
//   f32 with the rows' (mean, rstd), ln_w and ln_b (the natural column
//   order: two bf16 pairs a register, read from the 64-byte swizzle free
//   of bank conflicts) and splits each value into three exact bf16 pieces;
//   three register-A m64nJCBk16 wgmmas a k16 step on W1's JCB x 32 bf16
//   box as it lies;
// - h_j = gelu(...) is split once, in the epilogue, and exchanged as three
//   bf16 piece planes (6 bytes a value where the TF32 planes take 8);
// - the second product reads the pieces from shared memory: three
//   m64n128k16 wgmmas a k16 step on W2's 128 x 64 bf16 boxes, a fresh
//   partial a 64-deep stage added into the f32 sum.
template <int C, int NC>
int sub_tiled_x3(const bf16* x, const bf16* res, const float* sd, const float* lnw, const float* lnb,
                 const bf16* w1, const float* b1, const bf16* w2, const float* b2, const float* gamma, bf16* out,
                 int n, cudaStream_t s) {
  using F = Fused<C, NC, true>;
  int clusters = 0;
  cudaError_t err = active_clusters<C, NC, bf16, false, true>(&clusters);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xm, w1m, w2m;
  err = x_map(&xm, x, n, C);
  if (err == cudaSuccess) err = bf16mm::make_map(&w1m, {w1, 4 * C, C, C}, 32, F::JCB);
  if (err == cudaSuccess) err = bf16mm::make_map(&w2m, {w2, C, 4 * C, 4 * C}, 64, 128);
  if (err != cudaSuccess) return (int)err;
  const int pairs = (n + 2 * kSub - 1) / (2 * kSub);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fused_config(pairs < clusters ? pairs : clusters, F::S, F::kSmem, s, attr);
  err = cudaLaunchKernelEx(&cfg, fused_kernel<C, NC, bf16, false, true>, xm, w1m, w2m, x, res, sd, lnw, lnb, b1, b2,
                           gamma, out, n, pairs);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <int C, class T>
int forward(const T* x, const T* res, const float* sd, const float* lnw, const float* lnb, const T* w1,
            const float* b1, const T* w2, const float* b2, const float* gamma, T* out, float* work, int n, int sub,
            cudaStream_t s) {
  if (sub == 0) {
    if constexpr (sizeof(T) == 2)
      return whole_tile_x3<C>(x, res, sd, lnw, lnb, w1, b1, w2, b2, gamma, out, work, n, s);
    else
      return whole_tile<C>(x, res, sd, lnw, lnb, w1, b1, w2, b2, gamma, out, work, n, s);
  }
  if (sub != kSub) return (int)cudaErrorInvalidValue;
  int nc = 0;
  if constexpr (sizeof(T) == 2) {  // the three-piece instance
    const cudaError_t err = fused_columns<C, T, false, true>(n, &nc);
    if (err != cudaSuccess) return (int)err;
    if constexpr (C > 128)
      if (nc == 256) return sub_tiled_x3<C, 256>(x, res, sd, lnw, lnb, w1, b1, w2, b2, gamma, out, n, s);
    return sub_tiled_x3<C, 128>(x, res, sd, lnw, lnb, w1, b1, w2, b2, gamma, out, n, s);
  } else {
    const cudaError_t err = fused_columns<C, T>(n, &nc);
    if (err != cudaSuccess) return (int)err;
    if constexpr (C > 128)
      if (nc == 256) return sub_tiled<C, 256>(x, res, sd, lnw, lnb, w1, b1, w2, b2, gamma, out, work, n, s);
    return sub_tiled<C, 128>(x, res, sd, lnw, lnb, w1, b1, w2, b2, gamma, out, work, n, s);
  }
}

// The precise=False arm: the whole tile (sub 0) or the sub-tiled path (64).
template <int C, class T>
int forward_bf16(const T* x, const T* res, const float* sd, const float* lnw, const float* lnb, const T* w1,
                 const float* b1, const T* w2, const float* b2, const float* gamma, T* out, float* work, int n,
                 int sub, cudaStream_t s) {
  if (sub == 0) return whole_tile_bf16<C>(x, res, sd, lnw, lnb, w1, b1, w2, b2, gamma, out, work, n, s);
  if (sub != kSub) return (int)cudaErrorInvalidValue;
  int nc = 0;
  const cudaError_t err = fused_columns<C, T, true>(n, &nc);
  if (err != cudaSuccess) return (int)err;
  if constexpr (C > 128)
    if (nc == 256) return sub_tiled_bf16<C, 256>(x, res, sd, lnw, lnb, w1, b1, w2, b2, gamma, out, work, n, s);
  return sub_tiled_bf16<C, 128>(x, res, sd, lnw, lnb, w1, b1, w2, b2, gamma, out, work, n, s);
}

// forward_bf16 at width c, on data of T.
template <class T>
int forward_bf16_any(const void* x, const void* res, const float* sd, const float* lnw, const float* lnb,
                     const void* w1, const float* b1, const void* w2, const float* b2, const float* gamma, void* out,
                     float* work, int n, int c, int sub, cudaStream_t s) {
#define TC_ARGS static_cast<const T*>(x), static_cast<const T*>(res), sd, lnw, lnb, static_cast<const T*>(w1), b1, \
                static_cast<const T*>(w2), b2, gamma, static_cast<T*>(out), work, n, sub, s
  switch (c) {
    case 128: return forward_bf16<128>(TC_ARGS);
    case 256: return forward_bf16<256>(TC_ARGS);
    case 512: return forward_bf16<512>(TC_ARGS);
    case 1024: return forward_bf16<1024>(TC_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TC_ARGS
}

}  // namespace

extern "C" {

// Floats of workspace tc_mlp_block_forward needs for n rows of width c:
// the whole-tile path's TF32 planes, or the sub-tiled path's weight planes
// and folded bias.
long long tc_mlp_block_forward_workspace(int n, int c, int sub) {
  return sub ? make_fused_plan(c).total : make_plan(n, c).total;
}

// Floats of workspace tc_mlp_block_forward_bf16 needs: the whole tile's
// row statistics and h (x3::tail_plan), or none for the sub-tiled path
// (the weights read as they lie).
long long tc_mlp_block_forward_bf16_workspace(int n, int c, int sub) {
  return sub ? 0 : bf16mm::x3::tail_plan(n, c, bf16mm::x3::sm_count()).fwd_total;
}

// The bf16 instances' tile plan at n rows of width c on a card of `sms`
// SMs (sms <= 0: this card's) into out[0..13]: the tile's rows, columns and
// K-columns a stage, the ring's stages, the shared bytes a block; the tiles
// and the grid of the four products (a = LN(x) W1^T, u = h W2^T, d_h = d_u
// W2, d_xn = d_a W1); the forward's workspace floats.
int tc_mlp_block_bf16_plan(int n, int c, int sms, long long* out) {
  namespace x3 = bf16mm::x3;
  if (n <= 0 || c % x3::kBN || c > x3::kMaxK) return -1;
  const x3::TailPlan p = x3::tail_plan(n, c, sms > 0 ? sms : x3::sm_count());
  out[0] = x3::kBM, out[1] = x3::kBN, out[2] = x3::kBK, out[3] = x3::kStages, out[4] = x3::kSmemBytes;
  for (int i = 0; i < 4; ++i) out[5 + i] = p.tiles[i], out[9 + i] = p.grid[i];
  out[13] = p.fwd_total;
  return 0;
}

// The sub-tiled path's tiles at width c with nc output columns a block
// into out[0..5]: cluster size, hidden units a block per chunk, units per
// chunk, ring slots, shared bytes, sub-tile rows; -1 for an instance the
// library does not hold.
int tc_mlp_block_fused_plan(int c, int nc, int* out) {
#define TC_PLAN(W, N)                                                                                  \
  if (c == W && nc == N) {                                                                             \
    using F = Fused<W, N>;                                                                             \
    out[0] = F::S, out[1] = F::JCB, out[2] = F::JC, out[3] = F::kSlots, out[4] = F::kSmem, out[5] = kSub; \
    return 0;                                                                                          \
  }
  TC_PLAN(128, 128)
  TC_PLAN(256, 128)
  TC_PLAN(256, 256)
  TC_PLAN(512, 128)
  TC_PLAN(512, 256)
  TC_PLAN(1024, 128)
  TC_PLAN(1024, 256)
#undef TC_PLAN
  return -1;
}

// The three-piece instance's tiles at width c with nc output columns a
// block into out[0..7]: cluster size, hidden units a block per chunk, units
// per chunk, ring slots, shared bytes, sub-tile rows, bytes a slot, bytes
// of both sub-tiles' h pieces; -1 for an instance the library does not
// hold.
int tc_mlp_block_fused_x3_plan(int c, int nc, int* out) {
#define TC_PLAN(W, N)                                                                                  \
  if (c == W && nc == N) {                                                                             \
    using F = Fused<W, N, true>;                                                                       \
    out[0] = F::S, out[1] = F::JCB, out[2] = F::JC, out[3] = F::kSlots, out[4] = F::kSmem, out[5] = kSub; \
    out[6] = 4 * F::kSlotFloats, out[7] = 4 * F::kHFloats;                                             \
    return 0;                                                                                          \
  }
  TC_PLAN(128, 128)
  TC_PLAN(256, 128)
  TC_PLAN(256, 256)
  TC_PLAN(512, 128)
  TC_PLAN(512, 256)
  TC_PLAN(1024, 128)
  TC_PLAN(1024, 256)
#undef TC_PLAN
  return -1;
}

// The output columns a block the sub-tiled path takes for n rows of width
// c (fused_columns), or minus a cudaError_t.
int tc_mlp_block_fused_columns(int c, int n) {
  int nc = 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (c) {
    case 128: err = fused_columns<128>(n, &nc); break;
    case 256: err = fused_columns<256>(n, &nc); break;
    case 512: err = fused_columns<512>(n, &nc); break;
    case 1024: err = fused_columns<1024>(n, &nc); break;
  }
  return err == cudaSuccess ? nc : -(int)err;
}

// `sub` is 0 (the whole-tile path) or 64 (the sub-tiled path); any other
// value returns cudaErrorInvalidValue.  `work` holds
// tc_mlp_block_forward_workspace(n, c, sub) floats.
int tc_mlp_block_forward(const float* x, const float* res, const float* sd,
                         const float* lnw, const float* lnb, const float* w1,
                         const float* b1, const float* w2, const float* b2,
                         const float* gamma, float* out, float* work, int n, int c, int sub,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaErrorInvalidValue;
#define TC_ARGS x, res, sd, lnw, lnb, w1, b1, w2, b2, gamma, out, work, n, sub, s
  switch (c) {
    case 128: return forward<128>(TC_ARGS);
    case 256: return forward<256>(TC_ARGS);
    case 512: return forward<512>(TC_ARGS);
    case 1024: return forward<1024>(TC_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TC_ARGS
}

// Block 0's clocks by phase (TC_MLP_PHASES builds only; else -1).
int tc_mlp_phase_clocks(unsigned long long* out) {
#ifdef TC_MLP_PHASES
  return (int)cudaMemcpyFromSymbol(out, phase_clocks, sizeof(phase_clocks));
#else
  (void)out;
  return -1;
#endif
}

// The bf16 instances: x, res, w1, w2 and out bf16, the rest as
// tc_mlp_block_forward, `sub` 0 (the whole tile) or 64 (the sub-tiled
// path), the workspace tc_mlp_block_forward_bf16_workspace(n, c, sub)
// floats.
int tc_mlp_block_forward_bf16(const void* x, const void* res, const float* sd, const float* lnw,
                              const float* lnb, const void* w1, const float* b1, const void* w2, const float* b2,
                              const float* gamma, void* out, float* work, int n, int c, int sub, void* stream) {
  using bf = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaErrorInvalidValue;
#define TC_ARGS static_cast<const bf*>(x), static_cast<const bf*>(res), sd, lnw, lnb, static_cast<const bf*>(w1), \
                b1, static_cast<const bf*>(w2), b2, gamma, static_cast<bf*>(out), work, n, sub, s
  switch (c) {
    case 128: return forward<128>(TC_ARGS);
    case 256: return forward<256>(TC_ARGS);
    case 512: return forward<512>(TC_ARGS);
    case 1024: return forward<1024>(TC_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TC_ARGS
}

// Floats of workspace tc_mlp_block_forward_bf16_products needs.
long long tc_mlp_block_forward_bf16_products_workspace(int n, int c, int sub) {
  return sub ? make_fused_plan_bf16(c).total : make_plan_bf16(n, c).total;
}

// The precise=False arm (bf16 products): x, res, w1, w2 and out f32
// (data_bf16 0) or bf16 (data_bf16 1), the rest as tc_mlp_block_forward,
// `sub` 0 (the whole tile) or 64 (the sub-tiled path), the workspace
// tc_mlp_block_forward_bf16_products_workspace(n, c, sub) floats.
int tc_mlp_block_forward_bf16_products(const void* x, const void* res, const float* sd, const float* lnw,
                                       const float* lnb, const void* w1, const float* b1, const void* w2,
                                       const float* b2, const float* gamma, void* out, float* work, int n, int c,
                                       int sub, int data_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaErrorInvalidValue;
  return data_bf16 ? forward_bf16_any<__nv_bfloat16>(x, res, sd, lnw, lnb, w1, b1, w2, b2, gamma, out, work, n, c,
                                                      sub, s)
                   : forward_bf16_any<float>(x, res, sd, lnw, lnb, w1, b1, w2, b2, gamma, out, work, n, c, sub, s);
}

const char* tc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
