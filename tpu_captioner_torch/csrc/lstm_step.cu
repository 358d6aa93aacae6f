// The LSTM decoder's per-token step with additive attention, f32, for
// Hopper (sm_90a), in one cooperative launch.
//
// Replaces tpu_captioner/ops/lstm_step.py:_kernel (launched there by
// fused_lstm_step, here by ops/lstm_step.py:fused_lstm_step).  For each of R
// rows (images, or images x beams), with the encoder output enc (P, C) and
// its hoisted projection att1 (P, A) of the row:
//   att2  = h wd^T + bd                          (A)
//   score = relu(att1 + att2) . wfull + bfull    (P), a multiply-reduce
//   alpha = softmax_P(score)
//   ctx   = sigmoid(h wfb^T + bfb) * sum_p alpha_p enc_p       (C)
//   gates = emb w_ih_e^T + ctx w_ih_c^T + h w_hh^T + b  (4D; i, f, g, o)
//   c' = sigmoid(f) c + sigmoid(i) tanh(g);  h' = sigmoid(o) tanh(c')
// and writes h', c' (R, D) and alpha (R, P).  Weights are in nn.Linear's
// (out, in) layout: wd (A, D), wfb (C, D), w_ih_e (4D, E), w_ih_c (4D, C),
// w_hh (4D, D); b = b_ih + b_hh.
//
// What bounds it on the H100: bytes, at every row count the main path runs.
// At E = D = A = 512, C = 1024, P = 49 the weights are 19.9 MB and each row
// brings 301 KB of enc and att1: 32.4 MB at R = 40 (the bs-8 beam), 29.9 at
// R = 32 (the eval step), 69.8 at R = 160 (the bs-32 beam), 9.7 / 8.9 /
// 20.8 us at 3.35 TB/s; the five products (1.59 GFLOP at R = 160) take 9.6
// us at the 165 TFLOP/s of f32-accurate products on the tensor cores.
//
// What the design does about it (ops/lstm_step.py:lstm_plan sizes it; the C
// side recomputes the plan and refuses one that differs):
// - Each weight byte is read from memory once a launch, raw f32, by TMA.  A
//   launch is one block per SM.  The products run swap-AB on the 3xTF32
//   tensor cores (tf32x3_gemm.cuh): 64 weight rows are the wgmma's M and the
//   R rows (padded to an instance of NT = 16 .. 160) its N, so every row is
//   in one tile and no weight is read again for another row tile.  The
//   consumer warpgroup splits its weight fragments into TF32 hi / lo in
//   registers (A from registers, as mlp_block.cu:fused_kernel does); the
//   activations h, emb and the gated context are the B operand, as TF32
//   hi / lo planes with their K columns permuted within groups of 16, so
//   that a thread's fragment is one float4 of the weight tile.  The
//   [wd | wfb] tiles, first on the path to the attention, take h's planes
//   from their producer warpgroup, which splits h straight into the ring
//   slot; the gate tiles take the planes of h, emb and the context from
//   device memory by TMA (a few hundred KB, from L2), written by the launch
//   itself.
// - The tiles: 24 of [wd | wfb] (K = D) and 32 gate tiles (K = D + E, then
//   C), each split over K across blocks (up to 4 ways).  A gate tile holds
//   16 hidden units' four gates: its TMA box is 16 rows of each gate's
//   block of the weight (a 3-D box over (K, D, 4)), so no weight is
//   repacked.  The splits' partial tiles go to device memory.  The
//   attention sums an [wd | wfb] tile's partials, in split order, as it
//   loads att2 and fb; a gate tile's split blocks, once its counter says
//   all partials are there, each sum their slice of the rows in split
//   order (a reduce-scatter through L2) and apply the LSTM cell: no atomic
//   in any sum, so a second call repeats the first bit for bit.  (Clusters
//   would keep the partials in distributed shared memory, but the card runs
//   30 clusters of 4 at once, fewer than the 32 gate tiles, and the flags
//   below need every block co-resident, which a cooperative launch
//   guarantees.)
// - The h-side gates are off the attention's path: a block's warpgroups are
//   a producer (TMA), a consumer (wgmma) and an attention warpgroup.  The
//   consumers run the [wd | wfb] tiles first, then the h-side of their gate
//   tile while the attention warpgroups of all blocks run the scores and
//   the context; meanwhile the producer has prefetched the block's share of
//   w_ih_c (64 rows x C / 4: 64 KB) into shared memory.  The gate tile then
//   adds gctx w_ih_c^T from shared memory and applies the cell.
// - Release / acquire flags instead of grid barriers, in a buffer of their
//   own that the last block out zeroes for the next launch: the planes of h
//   and emb in device memory (split by every block's attention warpgroup
//   first, for the gate tiles), the [wd | wfb] partials (the scores wait
//   for all of them), a row's scores (the last of a row's score tasks
//   computes its softmax once), a row's alpha (the context tasks wait for
//   it), and each 128-channel chunk of the context (the producers of the
//   gate tiles wait for their chunks).
// - The attention: scores from float4 loads of att1, att2 and wfull, 7
//   pixels a warp task with all their loads in flight; the context from
//   float4 loads of enc, 16 pixels in flight a lane.
// Where the time goes (PERF.md, PR 14, scripts/lstm_probe.py timeline,
// median block): at R = 40 att2 and fb are seen at 9 us, the context is
// done at 23, the context stages at 29, the cells at 33; at R = 160 at 21,
// 62, 79 and 88.  The chain of dependent phases, not the bytes, sets the
// pace: a launch without its products and weight loads is 22% faster.
// Widths that TMA cannot address (D, E or C not a multiple of 4) load the
// weight tiles with plain loads by the producer warpgroup into the same
// swizzled layout; the B planes are the launch's own scratch and always
// take TMA.  Rows past R are zero-filled by TMA, and the planes' padding
// columns are written as zeros, so no NaN of a padding slot reaches a sum.
//
// Built with TC_LSTM_SKIP set (scripts/lstm_probe.py), the kernel leaves out
// parts of its work, for timing only: 1 the attention's loads and
// arithmetic, 2 the wgmmas, 4 the weight loads.  TC_LSTM_TIMELINE stamps
// each role's milestones (the probe's timeline).
//
// The bf16 instance (tc_lstm_step_bf16, lstm_step_kernel<NT, true>): _kernel
// with mxu_dtype=bfloat16 (tpu_captioner/ops/lstm_step.py:75-93, precise=
// False), the JAX package's arm on its own chip, on the weights of
// cast_lstm_weight_matrices(w, bfloat16) (wd, wfb, w_ih_e, w_ih_c, w_hh in
// bf16; wfull and the biases f32) with bf16 emb, enc and att1; h, c and the
// outputs f32.  Every product rounds its activation operand (h, emb, the
// gated context) to bf16 and sums the exact bf16 x bf16 products in f32: a
// bf16 value is exact in TF32, so the same tf32 wgmma runs with the bf16
// weight widened in registers as A and one B plane holding the rounded
// activation, one product a k-step where the f32 instance runs three.  The
// ring holds the weight boxes as stored (bf16, unswizzled: 4 KB a stage,
// half the f32 instance's bytes) and the gate blocks' share of w_ih_c
// likewise.  The attention widens enc and att1 as it reads them and keeps
// its sums, the softmax and alpha in f32.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "tf32x3_gemm.cuh"
#include "warp_reduce.cuh"

#ifndef TC_LSTM_SKIP
#define TC_LSTM_SKIP 0
#endif

namespace {

namespace tf32x3 {
template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24], const uint32_t (&a)[4], uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23},"
      " {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}
}  // namespace tf32x3

constexpr int kThreads = 384;         // producer, consumer and attention warpgroups
constexpr int kBK = 32;               // K columns a ring stage
constexpr int kTileM = 64;            // weight rows a tile: the wgmma's M
constexpr int kGateUnits = 16;        // hidden units a gate tile (x 4 gates)
constexpr int kAFloats = kTileM * kBK;  // a stage's weight box: 8 KB
constexpr int kMaxStages = 4;
constexpr int kMaxSplit = 4;
constexpr int kMaxRows = 160;
constexpr int kPix = 7;               // pixels a score task
constexpr int kCtxCh = 128;           // channels a context task (4 a lane)
constexpr int kCtxInFlight = 16;      // pixels of enc a lane has in flight
constexpr int kSmemLimit = 232448;
constexpr int kBarProducer = 1, kBarConsumer = 2, kBarAttention = 3;  // named barriers of 128 threads
// Flags (ints of their own buffer, which no launch's data overlaps, zero
// between launches): the split of h and emb, the [wd | wfb] partials
// stored, blocks out; then a counter per gate tile, a count of score tasks
// and a ready flag per row, a count of rows done per context chunk.
constexpr int kFlagSplit = 0, kFlagAf = 1, kFlagExit = 2, kFlagHead = 4;

// What an instance's ring stage holds: its weight box (kA floats: f32, or
// as many bf16 values in half the bytes) and kPlanes B planes of NT x 32
// floats (TF32 hi and lo, or the bf16-rounded activations alone).
template <bool BF>
struct Arm {
  static constexpr int kA = BF ? kAFloats / 2 : kAFloats;
  static constexpr int kPlanes = BF ? 1 : 2;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline long long round32(long long n) { return (n + 31) / 32 * 32; }

// The plan (ops/lstm_step.py:LstmPlan, in its field order).
struct Plan {
  int nt;         // rows of the products: R padded to an instance
  int grid;       // blocks: one per SM
  int s_af;       // K splits of an att2 / f_beta tile
  int s_g;        // K splits of a gate tile
  int stages;     // ring slots
  int wc_stages;  // w_ih_c stages a gate block keeps in shared memory
  int smem;       // dynamic shared memory, bytes
};

constexpr int kInstances[] = {16, 32, 48, 64, 96, 128, 160};

// ops/lstm_step.py:lstm_plan (esize 2 for the bf16 instance).  Returns 0,
// or 1 (rows), 2 (more tiles than blocks), 3 (shared memory), 4 (a width
// below 1).
inline int make_plan(int R, int E, int D, int A, int C, int P, int sms, bool bf16, Plan* p) {
  if (E < 1 || D < 1 || A < 1 || C < 1 || P < 1 || sms < 1) return 4;
  if (R < 1 || R > kMaxRows) return 1;
  int nt = 0;
  for (int v : kInstances)
    if (!nt && v >= R) nt = v;
  const int kD = cdiv(D, kBK), kE = cdiv(E, kBK), kC = cdiv(C, kBK);
  const int n_af = cdiv(A, kTileM) + cdiv(C, kTileM), n_g = cdiv(D, kGateUnits);
  if (n_af > sms || n_g > sms) return 2;
  const auto min2 = [](int a, int b) { return a < b ? a : b; };
  p->nt = nt;
  p->grid = sms;
  p->s_af = min2(min2(kMaxSplit, sms / n_af), kD);
  p->s_g = min2(min2(kMaxSplit, sms / n_g), min2(kC, kD + kE));
  p->wc_stages = cdiv(kC, p->s_g);
  const int a_floats = bf16 ? Arm<true>::kA : Arm<false>::kA, planes = bf16 ? Arm<true>::kPlanes : Arm<false>::kPlanes;
  const long long slot = 4LL * (a_floats + planes * nt * kBK);
  const long long fixed = 1024 + 4LL * a_floats * p->wc_stages + 8 * (2 * kMaxStages + 1) + 16;
  const long long fit = (kSmemLimit - fixed) / slot;
  p->stages = fit > kMaxStages ? kMaxStages : (int)(fit < 0 ? 0 : fit);
  if (p->stages < 2) return 3;
  p->smem = (int)(fixed + p->stages * slot);
  return 0;
}

// Widths and what follows from them.
struct Dims {
  int R, E, D, A, C, P;
  int Dp, Ep, Cp;      // widths of the B planes: 16-padded
  int kD, kE, kC;      // 32-column stages over D, E, C
  int n_att, n_af, n_g, nj;
  int n_flags;
};

inline Dims make_dims(int R, int E, int D, int A, int C, int P) {
  Dims d;
  d.R = R, d.E = E, d.D = D, d.A = A, d.C = C, d.P = P;
  d.Dp = cdiv(D, 16) * 16, d.Ep = cdiv(E, 16) * 16, d.Cp = cdiv(C, 16) * 16;
  d.kD = cdiv(D, kBK), d.kE = cdiv(E, kBK), d.kC = cdiv(C, kBK);
  d.n_att = cdiv(A, kTileM);
  d.n_af = d.n_att + cdiv(C, kTileM);
  d.n_g = cdiv(D, kGateUnits);
  d.nj = cdiv(C, kCtxCh);
  d.n_flags = kFlagHead + d.n_g + 2 * R + d.nj;
  return d;
}

// In the bf16 instance emb, enc, att1, wd, wfb, w_ih_e, w_ih_c and w_hh
// hold bf16 (the pointers are cast where they are read).
struct Args {
  const float *emb, *h, *c, *enc, *att1;
  const float *wd, *bd, *wfull, *bfull, *wfb, *bfb, *w_ih_e, *w_ih_c, *w_hh, *b;
  float *h_out, *c_out, *alpha;
  // workspace: partial tiles, the B planes (hi, then lo), scores
  float *part_af, *part_g, *hpl, *epl, *gpl, *score;
  int* flags;  // the flags (their own buffer)
  Dims d;
  Plan plan;
  int tma;  // weight tiles by TMA (else plain loads)
};

// The tensor maps: weights (unused without TMA) and the B planes.
struct Maps {
  CUtensorMap wd, wfb, whh, wie, wic, hpl, epl, gpl;
};

// What a block computes: an [wd | wfb] tile's K stages [af_k0, af_k1) (af
// < 0: none; the units from the last block down) and a gate tile's h-side
// stages [gh_k0, gh_k1) of [D | E] and context stages [gc_k0, gc_k1) (g <
// 0: none).  ops/lstm_step.py:lstm_units.
struct Work {
  int af, af_unit, af_k0, af_k1, g, gh_k0, gh_k1, gc_k0, gc_k1;
};

__host__ __device__ inline Work work_of(const Dims& d, const Plan& p, int b) {
  Work w{};
  w.af = w.g = -1;
  const int ua = p.grid - 1 - b;
  if (ua < d.n_af * p.s_af) {
    const int s = ua % p.s_af;
    w.af = ua / p.s_af, w.af_unit = ua;
    w.af_k0 = s * d.kD / p.s_af, w.af_k1 = (s + 1) * d.kD / p.s_af;
  }
  if (b < d.n_g * p.s_g) {
    const int s = b % p.s_g, kh = d.kD + d.kE;
    w.g = b / p.s_g;
    w.gh_k0 = s * kh / p.s_g, w.gh_k1 = (s + 1) * kh / p.s_g;
    w.gc_k0 = s * d.kC / p.s_g, w.gc_k1 = (s + 1) * d.kC / p.s_g;
  }
  return w;
}

// A ring stage: its weight (kind 0 wd, 1 wfb, 2 w_hh, 3 w_ih_e, 4 w_ih_c
// from shared memory) and its 32-column stage k of that weight's K.
struct Src {
  int kind, k;
};

__device__ __forceinline__ Src src_of(const Dims& d, const Work& w, int i) {
  const int naf = w.af_k1 - w.af_k0, nh = w.gh_k1 - w.gh_k0;
  if (i < naf) return Src{w.af < d.n_att ? 0 : 1, w.af_k0 + i};
  i -= naf;
  if (i < nh) {
    const int k = w.gh_k0 + i;
    return k < d.kD ? Src{2, k} : Src{3, k - d.kD};
  }
  return Src{4, w.gc_k0 + i - nh};
}

// ------------------------------------------------------------ sync helpers

__device__ __forceinline__ void wg_sync(int id) { asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory"); }

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// Built with TC_LSTM_TIMELINE defined (scripts/lstm_probe.py timeline), the
// first thread of each role stamps the global timer at its milestones.
#ifdef TC_LSTM_TIMELINE
constexpr int kMarks = 8;
__device__ unsigned long long g_timeline[1024 * 3 * kMarks];
#define TIMELINE(role, mark)                                                          \
  do {                                                                                \
    if ((threadIdx.x & 127) == 0) {                                                   \
      unsigned long long t_;                                                          \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                          \
      g_timeline[(blockIdx.x * 3 + (role)) * kMarks + (mark)] = t_;                   \
    }                                                                                 \
  } while (0)
#else
#define TIMELINE(role, mark)
#endif

__device__ __forceinline__ void wait_flag(const int* p, int target) {
  while (ld_acquire(p) < target) __nanosleep(20);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ldg4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
__device__ __forceinline__ float4 ldcg4(const float* p) { return __ldcg(reinterpret_cast<const float4*>(p)); }
__device__ __forceinline__ float at(float4 v, int e) { return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w; }

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ float4 widen4(uint2 u) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Elements i .. i + 3 (4 | i) and element i of an activation the
// instance stores as f32 or bf16 (BF), through the read-only path.
template <bool BF>
__device__ __forceinline__ float4 ldx4(const float* p, size_t i) {
  if constexpr (BF) return widen4(__ldg(reinterpret_cast<const uint2*>(reinterpret_cast<const __nv_bfloat16*>(p) + i)));
  else return ldg4(p + i);
}

template <bool BF>
__device__ __forceinline__ float ldx1(const float* p, size_t i) {
  if constexpr (BF) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
  else return __ldg(p + i);
}

// The K permutation of the B planes: within each group of 16 columns, slot
// 8 e2 + u + 4 e holds column 4 u + 2 e2 + e, so that the thread of
// fragment column q reads columns 4 q .. 4 q + 3 of its weight rows as one
// float4 and gives k-step 2 G + e2 the pair 4 q + 2 e2 (slot q) and + 1
// (slot q + 4) (ops/tf32.py:lstm_k_slots).  The slot of column col:
__device__ __forceinline__ int slot_of_col(int col) {
  const int c = col & 15;
  return (col & ~15) + 8 * ((c >> 1) & 1) + (c >> 2) + 4 * (c & 1);
}

// A B-operand value into its planes: TF32 hi and lo, or (BF) the value
// rounded to bf16 in the one plane.
template <bool BF>
__device__ __forceinline__ void store_split(float* plane, long long lo_off, size_t at, float v) {
  if constexpr (BF) {
    plane[at] = round_bf16(v);
  } else {
    const float hi = tf32x3::round_tf32(v);
    plane[at] = hi;
    plane[at + lo_off] = tf32x3::round_tf32(v - hi);
  }
}

// Columns c0 .. c0 + 15 of a row of K values (element `row` of x onward,
// f32 or, with XB, bf16; valid false: a row past R) as four float4,
// zeros past K.
template <bool XB>
__device__ __forceinline__ void load16(const float* x, size_t row, bool valid, int K, int c0, float4 (&v)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int c = c0 + 4 * u;
    if (valid && K % 4 == 0 && c + 3 < K) {
      v[u] = ldx4<XB>(x, row + c);
    } else {
      v[u].x = valid && c < K ? ldx1<XB>(x, row + c) : 0.f, v[u].y = valid && c + 1 < K ? ldx1<XB>(x, row + c + 1) : 0.f;
      v[u].z = valid && c + 2 < K ? ldx1<XB>(x, row + c + 2) : 0.f;
      v[u].w = valid && c + 3 < K ? ldx1<XB>(x, row + c + 3) : 0.f;
    }
  }
}

// Slots 4 kk .. 4 kk + 3 of a group of 16 in the B planes' order hold
// columns kk, kk + 4, kk + 8, kk + 12 (a 4 x 4 transpose of load16's
// float4s): their TF32 hi and lo parts, or (BF) their bf16 values in hi.
template <bool BF>
__device__ __forceinline__ void split4(const float4 (&v)[4], int kk, float4& hi, float4& lo) {
  float* const h4 = &hi.x;
  float* const l4 = &lo.x;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float e = at(v[u], kk);
    if constexpr (BF) {
      h4[u] = round_bf16(e);
      l4[u] = 0.f;
    } else {
      h4[u] = tf32x3::round_tf32(e);
      l4[u] = tf32x3::round_tf32(e - h4[u]);
    }
  }
}

// One row's group of 16 columns G of x (K wide, from element `row`, bf16
// with XB) into its B planes at dst (the lo plane lo_off floats after the
// hi plane; the bf16 instance, BF, writes the hi plane alone).
template <bool BF, bool XB>
__device__ __forceinline__ void split_group(const float* x, size_t row, int K, float* dst, long long lo_off, int G) {
  float4 v[4];
  load16<XB>(x, row, true, K, 16 * G, v);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    float4 hi, lo;
    split4<BF>(v, kk, hi, lo);
    *reinterpret_cast<float4*>(dst + 4 * kk) = hi;
    if constexpr (!BF) *reinterpret_cast<float4*>(dst + lo_off + 4 * kk) = lo;
  }
}

// ------------------------------------------------------------- producer

// A stage's weight box by TMA into dst (a 128-byte-swizzled 64 x 32 tile;
// a gate tile's rows gate-major, 16 units each).
__device__ __forceinline__ void issue_a(const Dims& d, const Maps& m, const Work& w, Src s, float* dst, uint64_t* bar) {
  switch (s.kind) {
    case 0: tma_load_2d(dst, &m.wd, s.k * kBK, w.af * kTileM, bar); break;
    case 1: tma_load_2d(dst, &m.wfb, s.k * kBK, (w.af - d.n_att) * kTileM, bar); break;
    case 2: tf32x3::tma_load(dst, &m.whh, s.k * kBK, w.g * kGateUnits, bar); break;
    case 3: tf32x3::tma_load(dst, &m.wie, s.k * kBK, w.g * kGateUnits, bar); break;
    default: tf32x3::tma_load(dst, &m.wic, s.k * kBK, w.g * kGateUnits, bar); break;
  }
}

// The same box by plain loads of the producer warpgroup's 128 threads (the
// bf16 instance's unswizzled, as its tensor maps write it).
template <bool BF>
__device__ void plain_a(const Args& a, const Work& w, Src s, float* dst, int tid) {
  const Dims& d = a.d;
  const float* src;
  int K, rows = 0, row0 = 0;
  switch (s.kind) {
    case 0: src = a.wd, K = d.D, rows = d.A, row0 = w.af * kTileM; break;
    case 1: src = a.wfb, K = d.D, rows = d.C, row0 = (w.af - d.n_att) * kTileM; break;
    case 2: src = a.w_hh, K = d.D; break;
    case 3: src = a.w_ih_e, K = d.E; break;
    default: src = a.w_ih_c, K = d.C; break;
  }
  const bool gate = s.kind >= 2;
  for (int idx = tid; idx < kAFloats; idx += 128) {
    const int r = idx >> 5, col = idx & 31, k = s.k * kBK + col;
    int row;
    bool ok;
    if (gate) {
      const int u = w.g * kGateUnits + (r & 15);
      ok = u < d.D, row = (r >> 4) * d.D + u;
    } else {
      row = row0 + r, ok = row < rows;
    }
    if constexpr (BF)
      reinterpret_cast<__nv_bfloat16*>(dst)[idx] =
          ok && k < K ? reinterpret_cast<const __nv_bfloat16*>(src)[(size_t)row * K + k] : __float2bfloat16(0.f);
    else
      dst[(r << 5) + (((col >> 2) ^ (r & 7)) << 2) + (col & 3)] = ok && k < K ? __ldg(src + (size_t)row * K + k) : 0.f;
  }
}

// A stage's B box: the planes of 32 K columns for the nt rows.
__device__ __forceinline__ void issue_b(const Maps& m, Src s, float* dst, uint64_t* bar) {
  const CUtensorMap* map = s.kind <= 2 ? &m.hpl : s.kind == 3 ? &m.epl : &m.gpl;
  tf32x3::tma_load(dst, map, s.k * kBK, 0, bar);
}

// mbarrier.expect_tx without an arrival: the stage's thread-written half
// arrives later.
__device__ __forceinline__ void mbar_expect_tx_only(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// The B operand of [wd | wfb] stages k0 .. k0 + n - 1 in ring slots 0 .. n
// - 1, written by the producer warpgroup straight from h (an input of the
// launch, so no flag to wait for): for each of the nt rows and a stage's
// two groups of 16 columns, both planes in the 128-byte-swizzled layout TMA
// would have written (the bf16 instance: the hi plane of the bf16-rounded
// values alone).  kBatch tasks a thread at once, their loads first.
constexpr int kBatch = 2;

template <bool BF>
__device__ void write_b(const Dims& d, const float* h, int k0, int n, float* ring, int slot_floats, int nt, int tid) {
  const int tasks = n * 2 * nt;
  for (int base = tid; base < tasks; base += 128 * kBatch) {
    float4 v[kBatch][4];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int idx = base + 128 * b, st = idx / (2 * nt), row = (idx >> 1) % nt, G = idx & 1;
      load16<false>(h, (size_t)row * d.D, idx < tasks && row < d.R, d.D, (k0 + st) * kBK + 16 * G, v[b]);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int idx = base + 128 * b, st = idx / (2 * nt), row = (idx >> 1) % nt, G = idx & 1;
      if (idx >= tasks) break;
      float* dst = ring + st * slot_floats + Arm<BF>::kA + row * kBK;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 hi, lo;
        split4<BF>(v[b], kk, hi, lo);
        float* at_ = dst + ((((4 * G + kk) ^ (row & 7))) << 2);
        *reinterpret_cast<float4*>(at_) = hi;
        if constexpr (!BF) *reinterpret_cast<float4*>(at_ + nt * kBK) = lo;
      }
    }
  }
}

template <bool BF>
__device__ void producer(const Args& a, const Maps& m, const Work& w, float* ring, float* wc, uint64_t* full,
                         uint64_t* empty, uint64_t* wc_full, int tid) {
  using Ar = Arm<BF>;
  const Plan& p = a.plan;
  const Dims& d = a.d;
  const bool lead = tid == 0, tma = a.tma;
  const int slot_floats = Ar::kA + Ar::kPlanes * p.nt * kBK;
  const uint32_t a_bytes = (TC_LSTM_SKIP & 4) ? 0 : 4 * Ar::kA, b_bytes = 4 * Ar::kPlanes * p.nt * kBK;
  const int naf = w.af_k1 - w.af_k0, nh = w.gh_k1 - w.gh_k0, nc = w.gc_k1 - w.gc_k0;
  const int total = naf + nh + nc;

  // The block's share of w_ih_c, for after the attention.
  if (nc > 0) {
    if (tma) {
      if (lead) {
        mbar_expect_tx(wc_full, nc * a_bytes);
        if (!(TC_LSTM_SKIP & 4))
          for (int j = 0; j < nc; ++j) issue_a(d, m, w, Src{4, w.gc_k0 + j}, wc + j * Ar::kA, wc_full);
      }
    } else {
      for (int j = 0; j < nc; ++j) plain_a<BF>(a, w, Src{4, w.gc_k0 + j}, wc + j * Ar::kA, tid);
      wg_sync(kBarProducer);
      if (lead) mbar_arrive(wc_full);
    }
  }

  // The [wd | wfb] stages whose slots are free now: weight boxes first,
  // then every B half at once.
  const int na = naf < p.stages ? naf : p.stages;
  if (na > 0) {
    if (tma) {
      if (lead)
        for (int i = 0; i < na; ++i) {
          mbar_expect_tx_only(&full[i], a_bytes);
          if (!(TC_LSTM_SKIP & 4)) issue_a(d, m, w, src_of(d, w, i), ring + i * slot_floats, &full[i]);
        }
    } else {
      for (int i = 0; i < na; ++i) plain_a<BF>(a, w, src_of(d, w, i), ring + i * slot_floats, tid);
    }
    write_b<BF>(d, a.h, w.af_k0, na, ring, slot_floats, p.nt, tid);
    fence_proxy_async_shared();  // wgmma reads the planes through the async proxy
    wg_sync(kBarProducer);
    if (lead)
      for (int i = 0; i < na; ++i) mbar_arrive(&full[i]);
  }

  bool planes_ready = false, ctx_ready = false;
  for (int i = na; i < total; ++i) {
    const int s = i % p.stages;
    float* slot = ring + s * slot_floats;
    const Src src = src_of(d, w, i);
    if (lead && i >= p.stages) mbar_wait(&empty[s], ((i / p.stages) & 1) ^ 1);
    if (src.kind <= 1) {  // [wd | wfb]: the weight box by TMA (or loads), B written here from h
      wg_sync(kBarProducer);  // the slot is free for every thread
      if (tma) {
        if (lead) {
          mbar_expect_tx_only(&full[s], a_bytes);
          if (!(TC_LSTM_SKIP & 4)) issue_a(d, m, w, src, slot, &full[s]);
        }
      } else {
        plain_a<BF>(a, w, src, slot, tid);
      }
      write_b<BF>(d, a.h, src.k, 1, slot, slot_floats, p.nt, tid);
      fence_proxy_async_shared();  // wgmma reads the planes through the async proxy
      wg_sync(kBarProducer);
      if (lead) mbar_arrive(&full[s]);
      continue;
    }
    if (src.kind == 4) {  // B only: the context planes of this block's channels, once written
      if (lead) {
        if (!ctx_ready) {
          const int j0 = w.gc_k0 * kBK / kCtxCh, j1 = cdiv(w.gc_k1 * kBK < d.C ? w.gc_k1 * kBK : d.C, kCtxCh);
          for (int j = j0; j < j1; ++j)
            wait_flag(a.flags + kFlagHead + d.n_g + 2 * d.R + j, d.R);
          fence_proxy_async_global();
          TIMELINE(0, 2);
          ctx_ready = true;
        }
        mbar_expect_tx(&full[s], b_bytes);
        issue_b(m, src, slot + Ar::kA, &full[s]);
      }
      continue;
    }
    // The gate's h-side: both halves by TMA (or the weights by loads), once every block has split h and emb.
    if (lead && !planes_ready) {
      wait_flag(a.flags + kFlagSplit, p.grid);
      fence_proxy_async_global();  // the planes were written through the generic proxy
      TIMELINE(0, 1);
      planes_ready = true;
    }
    if (tma) {
      if (lead) {
        mbar_expect_tx(&full[s], a_bytes + b_bytes);
        if (!(TC_LSTM_SKIP & 4)) issue_a(d, m, w, src, slot, &full[s]);
        issue_b(m, src, slot + Ar::kA, &full[s]);
      }
    } else {
      wg_sync(kBarProducer);  // the lead has seen the slot free
      plain_a<BF>(a, w, src, slot, tid);
      wg_sync(kBarProducer);
      if (lead) {
        mbar_expect_tx(&full[s], b_bytes);
        issue_b(m, src, slot + Ar::kA, &full[s]);
      }
    }
  }
}

// ------------------------------------------------------------- consumer

// The products' shape at NT rows: one wgmma of N = NT at NT <= 64, with a
// fresh partial per k-step (four independent chains of three wgmmas); else
// NT / 32 chunks of N = 32, a fresh partial per chunk (the chunks' chains
// interleaved).  Each stage's partials are added into f32 registers with
// round-to-nearest FADDs: the tensor cores truncate as they accumulate
// (tf32x3_gemm.cuh).
template <int NT>
struct Rows {
  static constexpr int kChunks = NT <= 64 ? 1 : NT / 32;
  static constexpr int kW = NT <= 64 ? NT : 32;
  static constexpr int kParts = NT <= 64 ? 4 : kChunks;
  static constexpr int kAcc = kW / 2;
  static_assert(NT % 16 == 0 && NT <= kMaxRows && (NT <= 64 || NT % 32 == 0), "rows");
};

// acc += this stage's products: the weight tile As (64 x 32, swizzled) from
// registers, split into TF32 hi / lo; the B planes at Bs (hi: NT x 32,
// then lo), swizzled.  The bf16 instance (BF): As holds bf16 (unswizzled),
// widened exactly into the hi registers, and Bs the one plane of bf16
// values: one wgmma a k-step, each product exact.
template <int NT, bool BF>
__device__ __forceinline__ void stage_mma(const float* As, const float* Bs, float (&acc)[Rows<NT>::kChunks][Rows<NT>::kAcc],
                                          int wi, int g, int q) {
  using K = Rows<NT>;
  uint32_t ahi[4][4], alo[4][4];
  const int ra = 16 * wi + g;
#pragma unroll
  for (int G = 0; G < 2; ++G) {
    float4 va, vb;
    if constexpr (BF) {
      const __nv_bfloat16* a16 = reinterpret_cast<const __nv_bfloat16*>(As) + 16 * G + 4 * q;
      va = widen4(*reinterpret_cast<const uint2*>(a16 + ra * kBK));
      vb = widen4(*reinterpret_cast<const uint2*>(a16 + (ra + 8) * kBK));
    } else {
      const int ch = ((4 * G + q) ^ g) << 2;
      va = ld4(As + ra * kBK + ch), vb = ld4(As + (ra + 8) * kBK + ch);
    }
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int t = 2 * G + e2;
      const float v[4] = {at(va, 2 * e2), at(vb, 2 * e2), at(va, 2 * e2 + 1), at(vb, 2 * e2 + 1)};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float hi = BF ? v[r] : tf32x3::round_tf32(v[r]);
        ahi[t][r] = __float_as_uint(hi);
        alo[t][r] = __float_as_uint(BF ? 0.f : tf32x3::round_tf32(v[r] - hi));
      }
    }
  }
  float d[K::kParts][K::kAcc];
#pragma unroll
  for (int i = 0; i < K::kParts; ++i) tf32x3::fence_regs(d[i]);
  tf32x3::wgmma_fence();
  const uint64_t bh = tf32x3::smem_desc(Bs), bl = tf32x3::smem_desc(Bs + NT * kBK);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int c = 0; c < K::kChunks; ++c) {
      float(&dd)[K::kAcc] = d[K::kChunks == 1 ? t : c];
      const uint64_t off = 2 * t + c * K::kW * 8;  // 32 bytes a k-step, 128 bytes a row, in 16-byte units
      const int fresh = K::kChunks == 1 || t == 0;
      if constexpr (BF) {
        tf32x3::wgmma_rs<K::kW>(dd, ahi[t], bh + off, fresh ? 0 : 1);
      } else {
        tf32x3::wgmma_rs<K::kW>(dd, ahi[t], bl + off, fresh ? 0 : 1);
        tf32x3::wgmma_rs<K::kW>(dd, alo[t], bh + off, 1);
        tf32x3::wgmma_rs<K::kW>(dd, ahi[t], bh + off, 1);
      }
    }
  }
  tf32x3::wgmma_commit();
  tf32x3::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < K::kParts; ++i) tf32x3::fence_regs(d[i]);
  if constexpr (K::kChunks == 1) {
#pragma unroll
    for (int i = 0; i < K::kAcc; ++i) acc[0][i] += ((d[0][i] + d[1][i]) + d[2][i]) + d[3][i];
  } else {
#pragma unroll
    for (int c = 0; c < K::kChunks; ++c)
#pragma unroll
      for (int i = 0; i < K::kAcc; ++i) acc[c][i] += d[c][i];
  }
}

// The consumer's partial tile into part (NT rows x 64 weight rows, the
// weight row fastest): acc[c][4 j + 2 h + e] is weight row 16 wi + g + 8 h,
// row n = c kW + 8 j + 2 q + e.
template <int NT>
__device__ __forceinline__ void store_partial(float* part, const float (&acc)[Rows<NT>::kChunks][Rows<NT>::kAcc], int wi,
                                              int g, int q) {
  using K = Rows<NT>;
#pragma unroll
  for (int c = 0; c < K::kChunks; ++c)
#pragma unroll
    for (int j = 0; j < K::kW / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          part[(c * K::kW + 8 * j + 2 * q + e) * kTileM + 16 * wi + g + 8 * h] = acc[c][4 * j + 2 * h + e];
}

// A tile's split blocks, once each has stored its partial, wait for all n
// of them, then each reduces its own slice of the rows: a reduce-scatter
// through L2, every sum in split order.
__device__ __forceinline__ void all_stored(int* counter, int n, int tid) {
  __threadfence();
  wg_sync(kBarConsumer);
  if (tid == 0) {
    red_release_add(counter, 1);
    wait_flag(counter, n);
  }
  wg_sync(kBarConsumer);
}

// The rows [n0, n1) of split s of n.
__device__ __forceinline__ void slice(int R, int s, int n, int& n0, int& n1) {
  n0 = s * R / n, n1 = (s + 1) * R / n;
}

template <int NT, bool BF>
__device__ void consumer(const Args& a, const Work& w, const float* ring, const float* wc, uint64_t* full,
                         uint64_t* empty, uint64_t* wc_full, int tid) {
  using K = Rows<NT>;
  using Ar = Arm<BF>;
  const Dims& d = a.d;
  const Plan& p = a.plan;
  const int wi = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int slot_floats = Ar::kA + Ar::kPlanes * NT * kBK, tile = NT * kTileM;
  float acc[K::kChunks][K::kAcc];
  int it = 0;
  const auto zero = [&]() {
#pragma unroll
    for (int c = 0; c < K::kChunks; ++c)
#pragma unroll
      for (int i = 0; i < K::kAcc; ++i) acc[c][i] = 0.f;
  };
  const auto run = [&](int n, const float* panels) {  // n ring stages; weights from panels, else the ring
    for (int j = 0; j < n; ++j, ++it) {
      const int s = it % p.stages;
      mbar_wait(&full[s], (it / p.stages) & 1);
      const float* slot = ring + s * slot_floats;
      if (!(TC_LSTM_SKIP & 2)) stage_mma<NT, BF>(panels ? panels + j * Ar::kA : slot, slot + Ar::kA, acc, wi, g, q);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  };

  if (w.af >= 0) {  // an [wd | wfb] tile's split: its partial, which the attention sums (att2_4, fb_4)
    zero();
    run(w.af_k1 - w.af_k0, nullptr);
    TIMELINE(1, 1);
    store_partial<NT>(a.part_af + (size_t)w.af_unit * tile, acc, wi, g, q);
    __threadfence();
    wg_sync(kBarConsumer);
    if (tid == 0) red_release_add(a.flags + kFlagAf, 1);
    TIMELINE(1, 2);
  }
  if (w.g >= 0) {  // a gate tile's split: h-side, then the context from shared memory; then its rows' cells
    zero();
    run(w.gh_k1 - w.gh_k0, nullptr);
    TIMELINE(1, 4);
    const int nc = w.gc_k1 - w.gc_k0;
    if (nc > 0) {
      mbar_wait(wc_full, 0);
      run(nc, wc);
    }
    TIMELINE(1, 5);
    store_partial<NT>(a.part_g + (size_t)blockIdx.x * tile, acc, wi, g, q);
    all_stored(a.flags + kFlagHead + w.g, p.s_g, tid);
    TIMELINE(1, 6);
    const float* part = a.part_g + (size_t)w.g * p.s_g * tile;
    int n0, n1;
    slice(d.R, blockIdx.x % p.s_g, p.s_g, n0, n1);
    for (int idx = n0 * 4 + tid; idx < n1 * 4; idx += 128) {  // 4 units a thread
      const int n = idx >> 2, i0 = 4 * (idx & 3);
      float4 u[kMaxSplit][4];  // every split's loads in flight at once
#pragma unroll
      for (int s = 0; s < kMaxSplit; ++s)
#pragma unroll
        for (int gi = 0; gi < 4; ++gi)
          u[s][gi] = s < p.s_g ? ldcg4(part + (size_t)s * tile + n * kTileM + gi * kGateUnits + i0)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 gv[4];
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) {
        gv[gi] = u[0][gi];
#pragma unroll
        for (int s = 1; s < kMaxSplit; ++s)
          if (s < p.s_g) gv[gi].x += u[s][gi].x, gv[gi].y += u[s][gi].y, gv[gi].z += u[s][gi].z, gv[gi].w += u[s][gi].w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = w.g * kGateUnits + i0 + e;
        if (u >= d.D) continue;
        const float gi_ = at(gv[0], e) + a.b[u], gf = at(gv[1], e) + a.b[d.D + u];
        const float gg = at(gv[2], e) + a.b[2 * d.D + u], go = at(gv[3], e) + a.b[3 * d.D + u];
        const size_t o = (size_t)n * d.D + u;
        const float c_new = sigmoid(gf) * a.c[o] + sigmoid(gi_) * tanhf(gg);
        a.c_out[o] = c_new;
        a.h_out[o] = sigmoid(go) * tanhf(c_new);
      }
    }
    TIMELINE(1, 7);
  }
}

// ------------------------------------------------------------- attention

// The B planes of h and emb, a group of 16 columns a thread (and zeros in
// the context planes' padding columns), grid-strided over every block's
// attention warpgroup.  The bf16 instance reads a bf16 emb.
template <bool BF>
__device__ void split_planes(const Args& a, int tid) {
  const Dims& d = a.d;
  const int R = d.R, gh = d.Dp / 16, ge = d.Ep / 16, th = R * gh, te = R * ge, pad = d.Cp - d.C;
  for (int idx = blockIdx.x * 128 + tid; idx < th + te + R * pad; idx += gridDim.x * 128) {
    if (idx < th) {
      const int n = idx / gh, G = idx % gh;
      split_group<BF, false>(a.h, (size_t)n * d.D, d.D, a.hpl + (size_t)n * d.Dp + 16 * G, (long long)R * d.Dp, G);
    } else if (idx < th + te) {
      const int i = idx - th, n = i / ge, G = i % ge;
      split_group<BF, BF>(a.emb, (size_t)n * d.E, d.E, a.epl + (size_t)n * d.Ep + 16 * G, (long long)R * d.Ep, G);
    } else {
      const int i = idx - th - te, n = i / pad, at_ = n * d.Cp + slot_of_col(d.C + i % pad);
      a.gpl[at_] = 0.f;
      a.gpl[(size_t)R * d.Cp + at_] = 0.f;
    }
  }
}

// Columns i .. i + 3 (4 | i, all in one tile) of row n of att2 (tile 0 ..
// n_att - 1) or f_beta (the tiles after): the tile's split partials summed
// in split order, then the bias, as a reduce of the tile would have.
__device__ __forceinline__ float4 af_4(const Args& a, int tile0, const float* bias, int n, int i) {
  const int tile = tile0 + (i >> 6), s_af = a.plan.s_af;
  const size_t stride = (size_t)a.plan.nt * kTileM;
  const float* p = a.part_af + (size_t)tile * s_af * stride + n * kTileM + (i & 63);
  float4 u[kMaxSplit];  // every split's load in flight at once
#pragma unroll
  for (int s = 0; s < kMaxSplit; ++s) u[s] = s < s_af ? ldcg4(p + s * stride) : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 v = u[0];
#pragma unroll
  for (int s = 1; s < kMaxSplit; ++s)
    if (s < s_af) v.x += u[s].x, v.y += u[s].y, v.z += u[s].z, v.w += u[s].w;
  const float4 b = ldg4(bias + i);
  return make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w);
}

// The same for one column.
__device__ __forceinline__ float af_1(const Args& a, int tile0, const float* bias, int n, int i) {
  const int tile = tile0 + (i >> 6), s_af = a.plan.s_af;
  const size_t stride = (size_t)a.plan.nt * kTileM;
  const float* p = a.part_af + (size_t)tile * s_af * stride + n * kTileM + (i & 63);
  float u[kMaxSplit];
#pragma unroll
  for (int s = 0; s < kMaxSplit; ++s) u[s] = s < s_af ? __ldcg(p + s * stride) : 0.f;
  float v = u[0];
#pragma unroll
  for (int s = 1; s < kMaxSplit; ++s)
    if (s < s_af) v += u[s];
  return v + bias[i];
}

// Scores of pixels p0 .. p0 + np - 1 of row r into s[] (every lane); att1
// f32, or bf16 widened (BF).
template <bool BF>
__device__ __forceinline__ void scores(const Args& a, int r, int p0, int np, int lane, float (&s)[kPix]) {
  const Dims& d = a.d;
#pragma unroll
  for (int j = 0; j < kPix; ++j) s[j] = 0.f;
  if (TC_LSTM_SKIP & 1) return;
  const size_t a1 = ((size_t)r * d.P + p0) * d.A;  // element of att1
  if (d.A % 4 == 0) {
    for (int i0 = 0; i0 < d.A; i0 += 512) {  // 4 float4 a lane
      float4 x2[4], wf[4], x1[kPix][4];
#pragma unroll
      for (int j = 0; j < kPix; ++j)  // att1 from memory first: the longest wait
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + 4 * (lane + 32 * u);
          x1[j][u] = j < np && i < d.A ? ldx4<BF>(a.att1, a1 + (size_t)j * d.A + i) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 4 * (lane + 32 * u);
        const bool ok = i < d.A;
        x2[u] = ok ? af_4(a, 0, a.bd, r, i) : make_float4(0.f, 0.f, 0.f, 0.f);
        wf[u] = ok ? ldg4(a.wfull + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < kPix; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          s[j] = fmaf(fmaxf(x1[j][u].x + x2[u].x, 0.f), wf[u].x, s[j]);
          s[j] = fmaf(fmaxf(x1[j][u].y + x2[u].y, 0.f), wf[u].y, s[j]);
          s[j] = fmaf(fmaxf(x1[j][u].z + x2[u].z, 0.f), wf[u].z, s[j]);
          s[j] = fmaf(fmaxf(x1[j][u].w + x2[u].w, 0.f), wf[u].w, s[j]);
        }
    }
  } else {
    for (int j = 0; j < np; ++j)
      for (int i = lane; i < d.A; i += 32)
        s[j] = fmaf(fmaxf(ldx1<BF>(a.att1, a1 + (size_t)j * d.A + i) + af_1(a, 0, a.bd, r, i), 0.f), __ldg(a.wfull + i),
                    s[j]);
  }
#pragma unroll
  for (int j = 0; j < kPix; ++j) s[j] = warp_sum(s[j]);
}

// alpha[r] = softmax(score[r]), by one warp.
__device__ void softmax_row(const Args& a, int r, int lane) {
  const int P = a.d.P;
  const float* sr = a.score + (size_t)r * P;
  float mx = -INFINITY;
  for (int p = lane; p < P; p += 32) mx = fmaxf(mx, __ldcg(sr + p));
  mx = warp_max(mx);
  float sum = 0.f;
  for (int p = lane; p < P; p += 32) sum += expf(__ldcg(sr + p) - mx);
  const float inv = 1.0f / warp_sum(sum);
  for (int p = lane; p < P; p += 32) a.alpha[(size_t)r * P + p] = expf(__ldcg(sr + p) - mx) * inv;
}

// gctx[r, c] = sigmoid(fb[r, c]) * sum_p alpha_p enc[r, p, c] for the
// context chunk j, into the context planes; enc f32, or bf16 widened (BF),
// the planes as store_split<BF> writes them.
template <bool BF>
__device__ void context(const Args& a, int r, int j, int lane) {
  const Dims& d = a.d;
  const float* al = a.alpha + (size_t)r * d.P;
  const long long lo = (long long)d.R * d.Cp;
  if (d.C % 4 == 0) {
    const int c = j * kCtxCh + 4 * lane;
    const bool on = c < d.C;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!(TC_LSTM_SKIP & 1))
      for (int p0 = 0; p0 < d.P; p0 += 32) {
        const float av = p0 + lane < d.P ? __ldcg(al + p0 + lane) : 0.f;
        const int pn = d.P - p0 < 32 ? d.P - p0 : 32;
        for (int pp = 0; pp < pn; pp += kCtxInFlight) {
          float4 e[kCtxInFlight];
#pragma unroll
          for (int u = 0; u < kCtxInFlight; ++u)
            e[u] = on && pp + u < pn ? ldx4<BF>(a.enc, ((size_t)r * d.P + p0 + pp + u) * d.C + c)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int u = 0; u < kCtxInFlight; ++u) {
            const float wgt = __shfl_sync(0xffffffffu, av, (pp + u) & 31);
            acc.x = fmaf(wgt, e[u].x, acc.x);
            acc.y = fmaf(wgt, e[u].y, acc.y);
            acc.z = fmaf(wgt, e[u].z, acc.z);
            acc.w = fmaf(wgt, e[u].w, acc.w);
          }
        }
      }
    if (on) {
      const float4 f = af_4(a, d.n_att, a.bfb, r, c);
      const float v[4] = {sigmoid(f.x) * acc.x, sigmoid(f.y) * acc.y, sigmoid(f.z) * acc.z, sigmoid(f.w) * acc.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) store_split<BF>(a.gpl, lo, (size_t)r * d.Cp + slot_of_col(c + e), v[e]);
    }
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = j * kCtxCh + lane + 32 * u;
      float acc = 0.f;
      if (!(TC_LSTM_SKIP & 1))
        for (int p = 0; p < d.P; ++p)
          acc = fmaf(__ldcg(al + p), c < d.C ? ldx1<BF>(a.enc, ((size_t)r * d.P + p) * d.C + c) : 0.f, acc);
      if (c < d.C)
        store_split<BF>(a.gpl, lo, (size_t)r * d.Cp + slot_of_col(c), sigmoid(af_1(a, d.n_att, a.bfb, r, c)) * acc);
    }
  }
}

template <bool BF>
__device__ void attention(const Args& a, int tid) {
  const Dims& d = a.d;
  const int lane = tid & 31, wi = tid >> 5;
  int* row_cnt = a.flags + kFlagHead + d.n_g;
  int* row_ready = row_cnt + d.R;
  int* ctx_cnt = row_ready + d.R;

  split_planes<BF>(a, tid);
  TIMELINE(2, 1);
  __threadfence();
  wg_sync(kBarAttention);
  if (tid == 0) {
    red_release_add(a.flags + kFlagSplit, 1);
    wait_flag(a.flags + kFlagAf, d.n_af * a.plan.s_af);  // every [wd | wfb] partial stored
  }
  wg_sync(kBarAttention);
  TIMELINE(2, 2);

  // Warp tasks, consecutive tasks on consecutive blocks.
  const int nwarps = gridDim.x * 4, gw = wi * gridDim.x + blockIdx.x;
  const int npg = cdiv(d.P, kPix);
  const float bfull = __ldg(a.bfull);
  for (int t = gw; t < d.R * npg; t += nwarps) {
    const int r = t / npg, p0 = (t % npg) * kPix, np = d.P - p0 < kPix ? d.P - p0 : kPix;
    float s[kPix];
    scores<BF>(a, r, p0, np, lane, s);
    int last = 0;
    if (lane == 0) {  // its own stores, released by the count itself
      for (int j = 0; j < np; ++j) a.score[(size_t)r * d.P + p0 + j] = s[j] + bfull;
      last = atom_add_acq_rel(row_cnt + r, 1) == npg - 1;
    }
    if (__shfl_sync(0xffffffffu, last, 0)) {  // the row's last task: its softmax, once
      __threadfence();
      softmax_row(a, r, lane);
      __threadfence();
      __syncwarp();
      if (lane == 0) red_release_add(row_ready + r, 1);
    }
  }
  TIMELINE(2, 3);
  for (int t = gw; t < d.R * d.nj; t += nwarps) {
    const int r = t / d.nj, j = t % d.nj;
    if (lane == 0) wait_flag(row_ready + r, 1);
    __syncwarp();
    context<BF>(a, r, j, lane);
    __threadfence();
    __syncwarp();
    if (lane == 0) red_release_add(ctx_cnt + j, 1);
  }
  TIMELINE(2, 4);
}

// ------------------------------------------------------------- the kernel

template <int NT, bool BF>
__global__ void __launch_bounds__(kThreads, 1) lstm_step_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Args a) {
  extern __shared__ uint8_t smem_raw[];
  // Slots and panels start on 1024-byte boundaries, where the 128-byte
  // swizzle pattern starts over (the descriptors' base offset 0).
  float* ring = reinterpret_cast<float*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  float* wc = ring + a.plan.stages * (Arm<BF>::kA + Arm<BF>::kPlanes * NT * kBK);
  uint64_t* full = reinterpret_cast<uint64_t*>(wc + a.plan.wc_stages * Arm<BF>::kA);
  uint64_t* empty = full + kMaxStages;
  uint64_t* wc_full = empty + kMaxStages;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const Work w = work_of(a.d, a.plan, blockIdx.x);

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.plan.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    mbar_init(wc_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // One branch per role, each with its own register budget (setmaxnreg).
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 64;");
    TIMELINE(0, 0);
    producer<BF>(a, maps, w, ring, wc, full, empty, wc_full, tid);
    TIMELINE(0, 3);
  } else if (wg == 1) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    TIMELINE(1, 0);
    consumer<NT, BF>(a, w, ring, wc, full, empty, wc_full, tid);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 208;");
    TIMELINE(2, 0);
    attention<BF>(a, tid);
  }

  // The last block out zeroes the flags for the next launch: every other
  // block has passed all its waits.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atom_add_acq_rel(a.flags + kFlagExit, 1) == (int)gridDim.x - 1) {
      for (int i = 0; i < a.d.n_flags; ++i) a.flags[i] = 0;
      __threadfence();
    }
  }
}

// ------------------------------------------------------------- host side

cudaError_t encode(CUtensorMap* map, const void* p, int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                   const cuuint32_t* box, bool bf16 = false) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                        const_cast<void*>(p), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        bf16 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A weight (rows, K) of f32 or bf16 elements as 32 x 64 boxes.
cudaError_t weight_map(CUtensorMap* map, const float* w, int rows, int K, bool bf16) {
  const cuuint64_t es = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * es};
  const cuuint32_t box[2] = {kBK, kTileM};
  return encode(map, w, 2, dims, strides, box, bf16);
}

// A gate weight (4D, K) as (K, D, 4): boxes of 32 columns x 16 units x 4 gates.
cudaError_t gate_map(CUtensorMap* map, const float* w, int D, int K, bool bf16) {
  const cuuint64_t es = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)D, 4};
  const cuuint64_t strides[2] = {(cuuint64_t)K * es, (cuuint64_t)K * D * es};
  const cuuint32_t box[3] = {kBK, kGateUnits, 4};
  return encode(map, w, 3, dims, strides, box, bf16);
}

// B planes (2, R, Kp) as boxes of 32 columns x nt rows x `planes` planes
// (both, or the bf16 instance's hi plane alone); rows past R arrive as
// zeros.
cudaError_t plane_map(CUtensorMap* map, const float* p, int R, int Kp, int nt, int planes) {
  const cuuint64_t dims[3] = {(cuuint64_t)Kp, (cuuint64_t)R, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)Kp * 4, (cuuint64_t)R * Kp * 4};
  const cuuint32_t box[3] = {kBK, (cuuint32_t)nt, (cuuint32_t)planes};
  return encode(map, p, 3, dims, strides, box);
}

// The workspace: the partial tiles, the planes and the scores, each
// 128-byte aligned.  Returns its floats.
long long carve(const Dims& d, const Plan& p, float* work, Args* a) {
  const long long tile = (long long)p.nt * kTileM;
  const long long sizes[6] = {d.n_af * p.s_af * tile, (long long)d.n_g * p.s_g * tile, 2LL * d.R * d.Dp,
                              2LL * d.R * d.Ep, 2LL * d.R * d.Cp, (long long)d.R * d.P};
  float** dst[6] = {&a->part_af, &a->part_g, &a->hpl, &a->epl, &a->gpl, &a->score};
  long long at = 0;
  for (int i = 0; i < 6; ++i) {
    *dst[i] = work + at;
    at += round32(sizes[i]);
  }
  return at;
}

template <int NT>
const void* kernel_of(bool bf16) {
  return bf16 ? reinterpret_cast<const void*>(lstm_step_kernel<NT, true>)
              : reinterpret_cast<const void*>(lstm_step_kernel<NT, false>);
}

const void* instance(int nt, bool bf16) {
  switch (nt) {
    case 16: return kernel_of<16>(bf16);
    case 32: return kernel_of<32>(bf16);
    case 48: return kernel_of<48>(bf16);
    case 64: return kernel_of<64>(bf16);
    case 96: return kernel_of<96>(bf16);
    case 128: return kernel_of<128>(bf16);
    case 160: return kernel_of<160>(bf16);
    default: return nullptr;
  }
}

constexpr int kMaxDevices = 16;
constexpr int kNumInstances = sizeof(kInstances) / sizeof(kInstances[0]);

// Per device, asked once: the SM count; per instance (f32, then bf16), the
// shared-memory attribute set and one block per SM confirmed.
struct DeviceState {
  int sms = 0;
  bool ready[2][kNumInstances] = {};
};
DeviceState g_state[kMaxDevices];

// Per device, the last launch's tensor maps and what they were made from.
struct MapCache {
  bool valid = false;
  const void* ptrs[6];
  int dims[9];
  Maps maps;
};
MapCache g_maps[kMaxDevices];

int instance_index(int nt) {
  for (int i = 0; i < kNumInstances; ++i)
    if (kInstances[i] == nt) return i;
  return -1;
}

// The device's SM count, and the instance i's attribute and occupancy,
// each asked once.
cudaError_t ready(int dev, int i, bool bf16) {
  DeviceState& st = g_state[dev];
  if (!st.sms) {
    cudaError_t err = cudaDeviceGetAttribute(&st.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  if (!st.ready[bf16][i]) {
    const void* k = instance(kInstances[i], bf16);
    cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, kSmemLimit);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    st.ready[bf16][i] = true;
  }
  return cudaSuccess;
}

cudaError_t maps_for(int dev, const Args& a, bool bf16, Maps* out) {
  MapCache& mc = g_maps[dev];
  const void* ptrs[6] = {a.wd, a.wfb, a.w_hh, a.w_ih_e, a.w_ih_c, a.hpl};
  const int dims[9] = {a.d.R, a.d.E, a.d.D, a.d.A, a.d.C, a.plan.nt, a.tma, (int)(a.gpl - a.hpl), bf16};
  if (mc.valid && !memcmp(mc.ptrs, ptrs, sizeof ptrs) && !memcmp(mc.dims, dims, sizeof dims)) {
    *out = mc.maps;
    return cudaSuccess;
  }
  Maps m;
  memset(&m, 0, sizeof m);
  const Dims& d = a.d;
  const int planes = bf16 ? Arm<true>::kPlanes : Arm<false>::kPlanes;
  cudaError_t err = cudaSuccess;
  if (a.tma) {
    if (err == cudaSuccess) err = weight_map(&m.wd, a.wd, d.A, d.D, bf16);
    if (err == cudaSuccess) err = weight_map(&m.wfb, a.wfb, d.C, d.D, bf16);
    if (err == cudaSuccess) err = gate_map(&m.whh, a.w_hh, d.D, d.D, bf16);
    if (err == cudaSuccess) err = gate_map(&m.wie, a.w_ih_e, d.D, d.E, bf16);
    if (err == cudaSuccess) err = gate_map(&m.wic, a.w_ih_c, d.D, d.C, bf16);
  }
  if (err == cudaSuccess) err = plane_map(&m.hpl, a.hpl, d.R, d.Dp, a.plan.nt, planes);
  if (err == cudaSuccess) err = plane_map(&m.epl, a.epl, d.R, d.Ep, a.plan.nt, planes);
  if (err == cudaSuccess) err = plane_map(&m.gpl, a.gpl, d.R, d.Cp, a.plan.nt, planes);
  if (err != cudaSuccess) return err;
  mc.valid = true;
  memcpy(mc.ptrs, ptrs, sizeof ptrs);
  memcpy(mc.dims, dims, sizeof dims);
  mc.maps = m;
  *out = m;
  return cudaSuccess;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// One step of either instance: check the plan and the workspace, make or
// reuse the tensor maps, launch.
int step_launch(Args& a, long long work_floats, int* flags, int n_flags, int R, int E, int D, int A, int C, int P,
                const int* plan, int dev, bool bf16, void* stream, float* work) {
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int cur = 0;
  cudaGetDevice(&cur);
  if (cur != dev) cudaSetDevice(dev);
  Plan want;
  memcpy(&a.plan, plan, sizeof a.plan);
  const int inst = instance_index(a.plan.nt);
  cudaError_t err = inst < 0 ? cudaErrorInvalidValue : ready(dev, inst, bf16);
  // The caller's plan must be this side's for the card, and the workspace hold it.
  if (err == cudaSuccess && (make_plan(R, E, D, A, C, P, g_state[dev].sms, bf16, &want) != 0 ||
                             memcmp(&want, &a.plan, sizeof want) ||
                             carve(make_dims(R, E, D, A, C, P), want, work, &a) > work_floats ||
                             make_dims(R, E, D, A, C, P).n_flags > n_flags))
    err = cudaErrorInvalidValue;
  a.flags = flags;
  if (err != cudaSuccess) {
    if (cur != dev) cudaSetDevice(cur);
    return (int)err;
  }
  a.d = make_dims(R, E, D, A, C, P);
  // TMA needs 16-byte rows of the weights: K % 4 f32 or K % 8 bf16 values.
  const int row = bf16 ? 8 : 4;
  a.tma = D % row == 0 && E % row == 0 && C % row == 0 && aligned16(a.wd) && aligned16(a.wfb) &&
          aligned16(a.w_hh) && aligned16(a.w_ih_e) && aligned16(a.w_ih_c);
  Maps maps;
  err = maps_for(dev, a, bf16, &maps);
  if (err == cudaSuccess) {
    void* params[] = {&maps, &a};
    err = cudaLaunchCooperativeKernel(instance(a.plan.nt, bf16), dim3(a.plan.grid), dim3(kThreads), params,
                                      (size_t)a.plan.smem, static_cast<cudaStream_t>(stream));
    if (err == cudaSuccess) err = cudaGetLastError();
  }
  if (cur != dev) cudaSetDevice(cur);
  return (int)err;
}

}  // namespace

extern "C" {

// One step.  `plan` is ops/lstm_step.py:lstm_plan's, which must equal this
// side's for the card; `work` (work_floats floats) is the workspace and
// `flags` (n_flags ints, zero, as every launch leaves them) the flags; `dev`
// the card of every pointer.
int tc_lstm_step(const float* emb, const float* h, const float* c, const float* enc, const float* att1,
                 const float* wd, const float* bd, const float* wfull, const float* bfull, const float* wfb,
                 const float* bfb, const float* w_ih_e, const float* w_ih_c, const float* w_hh, const float* b,
                 float* h_out, float* c_out, float* alpha, float* work, long long work_floats, int* flags,
                 int n_flags, int R, int E, int D, int A, int C, int P, const int* plan, int dev, void* stream) {
  Args a{emb, h, c, enc, att1, wd, bd, wfull, bfull, wfb, bfb, w_ih_e, w_ih_c, w_hh, b, h_out, c_out, alpha};
  return step_launch(a, work_floats, flags, n_flags, R, E, D, A, C, P, plan, dev, false, stream, work);
}

// The bf16 instance: the same arguments, with emb, enc, att1 and the five
// weight matrices (wd, wfb, w_ih_e, w_ih_c, w_hh) in bf16 and the rest f32;
// the plan is lstm_plan(..., esize=2).
int tc_lstm_step_bf16(const void* emb, const float* h, const float* c, const void* enc, const void* att1,
                      const void* wd, const float* bd, const float* wfull, const float* bfull, const void* wfb,
                      const float* bfb, const void* w_ih_e, const void* w_ih_c, const void* w_hh, const float* b,
                      float* h_out, float* c_out, float* alpha, float* work, long long work_floats, int* flags,
                      int n_flags, int R, int E, int D, int A, int C, int P, const int* plan, int dev, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };  // Args' pointer type (see Args)
  Args a{f(emb), h, c, f(enc), f(att1), f(wd), bd, wfull, bfull, f(wfb), bfb, f(w_ih_e), f(w_ih_c), f(w_hh), b,
         h_out, c_out, alpha};
  return step_launch(a, work_floats, flags, n_flags, R, E, D, A, C, P, plan, dev, true, stream, work);
}

#ifdef TC_LSTM_TIMELINE
// The last launch's stamps (ns), kMarks per (block, role), into out (n).
int tc_lstm_timeline(unsigned long long* out, int n) {
  const int k = n < 1024 * 3 * kMarks ? n : 1024 * 3 * kMarks;
  return (int)cudaMemcpyFromSymbol(out, g_timeline, k * sizeof(unsigned long long));
}
#endif


const char* tc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
