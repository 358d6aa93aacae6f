// The KV-cached Transformer decode body, f32, for Hopper (sm_90a): one
// decoder layer per launch, all L layers per launch, or a whole greedy
// rollout per launch.
//
// Replaces three TPU kernels of tpu_captioner/ops/decode_step.py:
// - _kernel (launched by fused_decode_step) -> decode_layer_kernel.  On the
//   TPU one kernel walks the L layers as a sequential grid axis with the
//   hidden state carried in VMEM scratch.  Hopper blocks run in no order, so
//   the layer axis becomes L launches of this kernel on one stream; the
//   hidden state is carried in x_out between launches;
// - _kernel_onecell (fused_decode_step(one_cell=True)) ->
//   decode_onecell_kernel: the same layer body looped over the L layers
//   inside one launch;
// - _mega_kernel (fused_full_rollout) -> decode_rollout_kernel: that loop
//   inside a loop over the tokens of a greedy rollout, with the embedding,
//   the vocab head, the argmax and the token feedback around it.
//
// Per row and layer the body computes, with post-norm LayerNorms (eps 1e-5):
//   1. the packed QKV projection (the new k and v rows are written out: for
//      the caller's cache update, or into the rollout's own cache);
//   2. causal self-attention over cache positions < pos plus the new k/v at
//      pos, merged without reading the cache slot at pos;
//   3. out-projection, residual, LN1;
//   4. cross-attention query, attention over the P memory rows, out-
//      projection, residual, LN2; alpha += mean over heads of the cross
//      probabilities / L;
//   5. ReLU FFN, residual, LN3.
//
// What bounds it on the H100: bytes and latency, not arithmetic.  At batch 8
// x beam 5 (R = 40 rows) a layer is eight matrix-vector-like products that
// read 8 MB of f32 weights for 2.1 M multiply-adds per row, two small
// attentions and three LayerNorms, each depending on the one before.  A
// rollout token adds the vocab head, E x V = 19.4 MB at V 9490.  The six
// layers' weights and the head (67 MB) outgrow the 50 MB L2 and the card's
// 30 MB of shared memory, so a rollout re-streams them every token: about
// 20 us a token from device memory, whatever the kernel does.
//
// What the design does about it.  Each launch is cooperative: one block per
// SM, 256 threads, phases separated by grid-wide barriers (cg::grid_group::
// sync, 1.2 us each on the H100; a release/acquire arrival counter measured
// 1.1, scripts/decode_barrier_probe.py).  Around the barriers:
// - Persistent column ownership.  Every product of a layer is cut into the
//   same column slices: block b owns output columns [b*ce, (b+1)*ce) of each
//   E-wide product (q, k and v of the QKV projection, the two out-
//   projections, the cross query, FFN2) and [b*cf, ...) of FFN1, for all of
//   the R rows (in chunks of rc rows).  So each weight is read once per
//   launch (per token in the rollout) and every SM multiplies in every
//   product phase.  The per-layer kernel at R >= 32 splits the grid into two
//   row groups that own the same columns, so each block stages half the
//   rows; the rollout's head gives each block cv vocab columns.
// - Weights staged ahead of the barriers.  A block's weight slice of one
//   product, in pieces of uc columns, is a ring unit: contiguous rows of
//   the nn.Linear (out, in) matrix, copied into shared memory by one bulk
//   copy (cp.async.bulk) that completes on the unit's mbarrier.  A ring of
//   `slots` units is kept full: when a product phase releases its units,
//   thread 0 issues the next ones, so a layer's weights (and the next
//   layer's, and in the rollout the head's in hc-column units) are in
//   flight during the barriers and attentions before them, and a phase
//   waits on its mbarrier, never on a load issued after the barrier.
// - Activation rows staged by the copy engine.  After a barrier a product
//   stages its input rows (rows other blocks wrote) with one bulk copy on a
//   staging mbarrier: 0.85 us for 40 rows x 512 where float4 loads from
//   every thread took 1.6 (2.2 and 6.1 us for 160 rows; the probe).  The
//   rollout's embedding rows are gathered by the threads instead: a bulk
//   copy would queue behind the weight copies in flight.
// - Fewer barriers.  LN1, LN2 and LN3 run in the staging prologue of the
//   product that consumes them: every block normalises the rows it staged,
//   and the row's owner block (Owners) also writes them out, where they
//   are needed later as a residual or as x_out.  Each product epilogue adds
//   its residual, so a LayerNorm stages one buffer.  The alpha mean runs in
//   FFN1's phase.  In the rollout the head's prologue is the last LN3; the
//   head's epilogue keeps each row's best (value, first column) of the
//   block's columns and merges it into a per-row 64-bit key with atomicMax
//   (the key orders by value, then by the smaller column: torch.argmax's
//   first maximum, whatever the order of the merges); the argmax, feedback
//   and embedding run in the next token's first prologue.  Barriers: 8 per
//   layer (after QKV, self-attention, out-projection, cross query, cross-
//   attention, cross-out, FFN1, FFN2), so 8 per per-layer launch (was 10),
//   8L per one-cell launch (was 11L - 1) and 8L + 1 per rollout token (was
//   11L + 4: 70 at L = 6; now 49).
// - Little code per phase.  Each phase's code runs once or twice and is
//   fetched anew (the kernels outgrow the instruction caches), so the
//   heavy parts are out-of-line functions shared by every phase: the
//   product's 16 x 4 warp tile (tile_dot), the attention, the stagings.
//   With one copy of the tile code a per-layer step at R = 40 took 13% less
//   time than with a copy per product (scripts/decode_timeline.py).
// Products: a warp multiplies a tile of 16 staged rows by 4 weight rows,
// lanes splitting the k axis in float4 steps, and a reduce-scatter of
// shuffles sums the lanes; an output's sum order depends only on K, so the
// one-cell and per-layer kernels sum alike (they agree within 1e-6).  Attention runs one
// warp per (row, head) at dh = E/H (the TPU kernel's 0/1 head-selector
// matmul is a lane-layout device and is not carried over); only positions
// t <= pos are ever read, so an uninitialised cache slot can never reach a
// sum.  Each kernel is instantiated twice and the launch picks by head
// width: float4 key loads when dh % 4 == 0, scalar loads otherwise (GloVe-
// 200: dh 25; word2vec-300: dh 50).
// Intermediates produced inside a launch live in scratch buffers that each
// phase writes and only later phases read; the grid barrier orders the
// writes before the reads (a proxy fence on both sides orders them before a
// bulk copy's reads).  The rollout keeps each row's token and finished flag
// in every block's shared memory, computed alike from the same keys, so
// every block branches alike; the launch stops once all rows have finished
// and counts the tokens it ran in state[2R].
//
// The bf16 arm (tc_decode_layer_forward_bf16, decode_layer_kernel<VEC,
// true>): _kernel with precise=False, the JAX kernel's arm on its own chip
// (tpu_captioner/ops/decode_step.py:233-237, 370-371), on the weight
// matrices of cast_weight_matrices(w, bfloat16) and bf16 caches and memory
// K/V.  The ring holds the weights as bf16 (half the bytes a launch
// streams, and twice the units a slot count holds).  Every product of the
// JAX layer rounds both operands to bf16 and sums their exact products in
// f32, which is what a bf16 tensor-core product with f32 accumulation
// computes:
// - Staged rows rounded once.  Each staging prologue puts a bf16 copy of
//   its rows where the products read them (xb, after the rest of shared
//   memory, rows of round_up(K, 16) + 8 values: the 16 bytes past a row's
//   end put the rows of an ldmatrix on different banks): the landed f32
//   input rows rounded, LayerNorm's output rounded as ln_rows writes it,
//   the embedding plus PE rounded as it is gathered, or, for the two
//   attention contexts and FFN1's hidden rows, which only a product reads,
//   the rows as their phase wrote them, rounded to bf16 there, one bulk
//   copy a row.  So a value is rounded once, whatever the number of column
//   tiles that read it; the hidden state, the residuals and x_out stay f32.
// - Products on mma.sync.  A warp task multiplies 16 staged bf16 rows by 8
//   weight rows of a ring unit (tile_mma: mma.sync m16n8k16 .row.col, bf16
//   in, f32 accumulators): A from xb through ldmatrix, B the nn.Linear (out,
//   in) rows as the ring holds them, which is the .col layout, so no
//   transposed copy.  In the per-layer kernel, where a unit has whole 8-row
//   tiles (the two-row-group plans), the ring holds its rows ring_row(K)
//   apart (one bulk copy a row, spread over warp 0's lanes), so that, as in
//   xb, the 8 rows an ldmatrix reads fall on different banks: rows 1 KB
//   apart would put all 8 on one (an 8-way conflict, 7 extra wavefronts a
//   matrix, which several warps' tiles then queue on).  Each tile's loads
//   run a k64 stage ahead of its products.  A block owns 4-16 columns of a
//   product for at most 64 staged rows, so wgmma's 64-row M would be
//   mostly padding.  Four accumulators take the k16 steps in turn and are
//   added in a fixed order at the end: an output's sum order depends on K
//   alone, as in the f32 tile, so the one-cell and per-layer instances (one
//   row group or two, padded ring rows or not) give the same bits.  When K
//   % 16 == 8 (E = 200) the last step's upper half of A and B is zeroed in
//   registers: no staged pad or weight tail (a slot's stale bytes) ever
//   enters a sum.
// - The attention sums bf16(k * q / sqrt(dh)) over each head's dims (the
//   head-selector product, :150, 165), two products rounded by one
//   cvt.rn.bf16x2 and summed into four partial sums added in a fixed order
//   (the new k at pos by the whole warp), and weights each value by bf16(p)
//   (:155, 169), with the new k and v at pos unrounded, as the JAX kernel
//   merges them; alpha averages the unrounded cross probabilities.  k_new
//   and v_new are written as bf16.
// The one-cell and rollout kernels have the same bf16 instances
// (decode_onecell_kernel<VEC, true>, decode_rollout_kernel<VEC, true>:
// _kernel_onecell and _mega_kernel with precise=False, the latter on
// storage_dtype=bf16 operands, tpu_captioner/models/transformer.py:391-395):
// the same layer body, so the one-cell instance's outputs equal L launches
// of the per-layer instance bit for bit.  The rollout's caches are bf16
// (each token's new k and v enter its own attention unrounded and are
// rounded as they are stored), its embedding table and vocab head bf16:
// x = embedding[tok] + pe in f32 (a bf16 row is exact), and the head rounds
// x to bf16 against the bf16 fc_w, sums in f32 and adds the f32 fc_b; the
// argmax runs on the f32 logits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mbarrier.cuh"
#include "warp_reduce.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRT = 16;        // rows of a warp tile
constexpr int kCG = 4;         // weight rows (output columns) of a warp tile
constexpr int kCGb = 8;        // ... of a bf16 warp tile (mma.sync's n)
constexpr int kLnVec = 8;      // float4s of a LayerNorm row per lane: E <= 32 * 4 * 8 = 1024
constexpr float kLnEps = 1e-5f;
constexpr int kMaxGroup = 16;  // ring units multiplied together

// How a launch divides its work; computed by the wrapper
// (tpu_captioner_torch/ops/decode_step.py:decode_plan), which sizes the
// shared memory with the same layout as smem_layout_bytes below.
struct Plan {
  int grid;         // blocks
  int row_groups;   // 1, or 2: blocks b and b + grid / 2 own the same columns, each half the rows
  int ce, cf;       // output columns a block owns of each E-wide and of the F-wide product
  int uc;           // of those, columns per ring unit
  int cv, hc;       // vocab columns a block owns (rollout), and per ring unit
  int rc;           // rows staged at once, a multiple of kRT
  int slots;        // ring units in shared memory
  int slot_floats;  // elements of a ring slot (floats, or bf16 in the bf16 arm), a multiple of 32
  int group;        // ring units multiplied together, at most slots and kMaxGroup
};
constexpr int kPlanInts = 11;

// In the bf16 arm the weight matrices, k_new / v_new, the caches and the
// memory K/V hold bf16 (the pointers are cast where they are read); the
// rest is f32 in every arm.
struct Args {
  const float* x_in;   // (R, E) input of the first layer of the launch
  float* x_out;        // (R, E) output of the last layer of the launch
  float* alpha;        // (R, P)
  float* k_new;        // new k row of (layer l, row r) at k_new + l * kv_ls + r * kv_rs
  float* v_new;        // likewise
  size_t kv_ls, kv_rs;
  const float *w_qkv, *b_qkv;  // (L, 3E, E), (L, 3E)
  const float *w_so, *b_so;    // (L, E, E), (L, E)
  const float *w_cq, *b_cq;    // (L, E, E), (L, E)
  const float *w_co, *b_co;    // (L, E, E), (L, E)
  const float *w_f1, *b_f1;    // (L, F, E), (L, F)
  const float *w_f2, *b_f2;    // (L, E, F), (L, E)
  const float *ln1_w, *ln1_b, *ln2_w, *ln2_b, *ln3_w, *ln3_b;  // (L, E)
  const float *cache_k, *cache_v;  // (L, R, T, E)
  const float *mem_k, *mem_v;      // (L, R, P, E)
  float* scratch;  // layer_scratch_floats: the buffers of decode_layer
  int layer, L, R, T, P, E, H, F, pos;
  // The rollout's tensors (null or 0 in the other kernels).  There x_in =
  // x_out = x, cache_k/v and k_new/v_new are both the rollout's own cache,
  // and pos is set per token.
  const float* embedding;            // (V, E)
  const float *fc_w, *fc_b;          // (V, E), (V)
  const float* pe;                   // (steps, E)
  const int *teacher, *use_teacher;  // (steps, R) each, or both null
  float* logits;                     // (R, steps, V), zeroed by the caller
  int* seqs;                         // (R, steps), zeroed
  float* alphas;                     // (R, steps, P), zeroed
  unsigned long long* best;          // (2, R) argmax keys, by token parity
  int* state;                        // tok (R), fin (R), tokens run (1)
  int V, steps, end_id;
  Plan plan;
  int l0, Lr;        // the launch's first layer and layers per token
  int ne, nf, upl;   // ring units per E-wide product, per FFN1 and per layer
  int upt, units;    // ring units per token and in the whole launch
  int wsize;         // bytes of a weight element: 4, or 2 in the bf16 arm
  int xb_off;        // bf16 arm: byte offset of the staged bf16 rows in shared memory
};

// The element type of the weights, caches and memory K/V of an arm.
template <bool BF>
struct Elem {
  using T = float;
};
template <>
struct Elem<true> {
  using T = __nv_bfloat16;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16(v)); }

// Four consecutive elements as a float4: one 16-byte load of floats, or
// one 8-byte load of bf16 widened.
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// One block's view of the launch: its shared memory and its ring.  Every
// thread keeps its own copy of the counters and updates it alike.
struct Blk {
  uint64_t* ubar;            // one mbarrier per ring slot
  uint64_t* xbar;            // the staging mbarrier
  unsigned char* ring;       // slots x slot_floats elements of the weights' type
  float* xs;                 // rc staged rows
  float* lnp;                // a LayerNorm's scale and shift, or the rollout's PE row (2E)
  float* sq;                 // this warp's attention scratch: query row (dh), probabilities
  unsigned long long* best;  // rollout: each row's best key over this block's head columns
  int *tok, *fin;            // rollout: each row's token and finished flag
  int issued, released;      // ring units issued, and released by their product phases
  uint32_t xphase;           // parity of the staging barrier's next phase
  int gc, bc, rpg, ra, rb;   // column blocks, this block's; rows per group, this block's [ra, rb)
  int stamps;                // timeline stamps taken (scripts/decode_timeline.py)
};

#ifdef TC_DECODE_TIMELINE
// Block 0's %globaltimer at the launch's start (what 0), a barrier's entry
// (1) and exit (2), each staged row chunk (3), warp 0's last product of a
// chunk (5), each released unit group (6), warp 0's weights ready for a
// task (7) and the end (4), for
// scripts/decode_timeline.py, which builds the library with this defined.
constexpr int kMaxStamps = 1 << 16;
__device__ unsigned long long tc_timeline[kMaxStamps];
__device__ long long tc_timeline_clock[kMaxStamps];  // the SM's cycle counter beside it
__device__ int tc_timeline_what[kMaxStamps];
__device__ __forceinline__ void stamp(Blk& k, int what) {
  if (blockIdx.x == 0 && threadIdx.x == 0 && k.stamps < kMaxStamps) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    tc_timeline[k.stamps] = t;
    tc_timeline_clock[k.stamps] = clock64();
    tc_timeline_what[k.stamps] = what;
  }
  ++k.stamps;
}
#else
__device__ __forceinline__ void stamp(Blk&, int) {}
#endif

struct Unit {
  const unsigned char* src;  // the block's weight rows, contiguous
  int cols, K;               // weight rows (output columns) and their length
  int col0;                  // output column of the first row
};

// Element `off` of the weights at w, whose elements are a.wsize bytes.
__device__ __forceinline__ const unsigned char* weight_at(const Args& a, const float* w, size_t off) {
  return reinterpret_cast<const unsigned char*>(w) + off * a.wsize;
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Warp-task numbering that puts consecutive tasks on different SMs, so a
// phase with fewer tasks than warps still spreads over the whole card.
__device__ __forceinline__ int global_warp() { return (threadIdx.x >> 5) * gridDim.x + blockIdx.x; }
__device__ __forceinline__ int grid_warps() { return gridDim.x * kWarps; }

__host__ __device__ __forceinline__ size_t round_up(size_t n, size_t m) { return (n + m - 1) / m * m; }

// Which rows a block writes out (LayerNorm outputs, alpha, seqs, alphas):
// row r's owner is block g * gc + (r - g * rpg) % gc of its row group g.
struct Owners {
  int rpg, gc;
  __device__ __forceinline__ bool mine(int r) const {
    const int g = r / rpg;
    return g * gc + (r - g * rpg) % gc == (int)blockIdx.x;
  }
};

__device__ __forceinline__ bool owns(const Blk& k, int r) { return Owners{k.rpg, k.gc}.mine(r); }

__device__ __forceinline__ int clamp_cols(int n, int per) { return n < 0 ? 0 : (n < per ? n : per); }

// Ring unit u: unit i = u % upt of its token.  A layer's units are q, k,
// v, self-out, cross query, cross-out (ne each), FFN1 (nf), FFN2 (ne), each
// product's in uc-column pieces of the block's slice; then the head's, in
// hc-column pieces.
__device__ Unit unit_of(const Args& a, const Blk& k, int u) {
  const int i = u % a.upt, E = a.E, F = a.F, uc = a.plan.uc;
  Unit t;
  t.K = E;
  if (i < a.upl * a.Lr) {
    const size_t l = a.l0 + i / a.upl;
    const int j = i % a.upl;
    int p, q;
    if (j < 6 * a.ne) {
      p = j / a.ne;
      q = j % a.ne;
    } else if (j < 6 * a.ne + a.nf) {
      p = 6;
      q = j - 6 * a.ne;
    } else {
      p = 7;
      q = j - 6 * a.ne - a.nf;
    }
    const int per = p == 6 ? a.plan.cf : a.plan.ce, n = p == 6 ? F : E;
    const int c0 = k.bc * per + q * uc;
    t.cols = clamp_cols(min(n, k.bc * per + per) - c0, uc);
    t.col0 = c0;
    if (p == 6) {  // FFN1, (F, E)
      t.src = weight_at(a, a.w_f1, (l * F + c0) * E);
      return t;
    }
    const float* w;
    size_t off;
    if (p < 3) {  // q, k or v: rows p*E + c0.. of the (3E, E) QKV weight
      w = a.w_qkv;
      off = (l * 3 + p) * E * E;
      t.col0 = p * E + c0;
    } else {
      w = p == 3 ? a.w_so : p == 4 ? a.w_cq : p == 5 ? a.w_co : a.w_f2;
      off = p == 7 ? l * E * F : l * E * E;
      if (p == 7) t.K = F;
    }
    t.src = weight_at(a, w, off + (size_t)c0 * t.K);
    return t;
  }
  const int v0 = blockIdx.x * a.plan.cv, v1 = min(a.V, v0 + a.plan.cv);
  t.col0 = v0 + (i - a.upl * a.Lr) * a.plan.hc;
  t.cols = clamp_cols(v1 - t.col0, a.plan.hc);
  t.src = weight_at(a, a.fc_w, (size_t)t.col0 * E);
  return t;
}

// Elements from one weight row of K to the next in a padded ring slot: K
// and 8 or 16 more, so that a row is an odd number of 16-byte granules and
// the 8 rows of an ldmatrix fall on different banks.  Only the per-layer
// kernel's bf16 instance pads, and only units of whole 8-row tiles (its
// two-row-group plans, uc = 8); other units lie as they are stored, one
// copy a unit: with uc = 4 the bank conflict is 4-way at most (the tile's
// rows past nc repeat the last, one address), and in the one-cell and
// rollout kernels a copy a row and its code cost more than they saved.
__host__ __device__ __forceinline__ int ring_row(int K) { return K + ((K / 8) % 2 ? 16 : 8); }
__host__ __device__ __forceinline__ bool padded_rows(const Plan& p, int wsize) {
  return wsize == 2 && p.uc >= kCGb;
}

// A unit's row stride in its slot, where the launch may pad (PAD).
__device__ __forceinline__ int unit_row(const Args& a, int K) {
  return padded_rows(a.plan, a.wsize) ? ring_row(K) : K;
}

// Thread 0: copy unit u into its slot.  A unit with no columns only
// arrives, so that every slot's barrier completes one phase per unit.
__device__ void ring_issue(const Args& a, const Blk& k, int u) {
  const int slot = u % a.plan.slots;
  const Unit t = unit_of(a, k, u);
  uint64_t* bar = k.ubar + slot;
  if (t.cols > 0) {
    const uint32_t bytes = (uint32_t)a.wsize * t.cols * t.K;
    mbar_expect_tx(bar, bytes);
    bulk_load(k.ring + (size_t)slot * a.plan.slot_floats * a.wsize, t.src, bytes, bar);
  } else {
    mbar_arrive(bar);
  }
}

__device__ __forceinline__ void ring_wait(const Args& a, const Blk& k, int u) {
  mbar_wait(k.ubar + u % a.plan.slots, (u / a.plan.slots) & 1);
}

// Warp 0, where the launch may pad: copy unit u into its slot, a weight row
// at a time where its rows are padded (unit_row), the rows' copies spread
// over the lanes; else as ring_issue.
__device__ void ring_issue_rows(const Args& a, const Blk& k, int u) {
  const int slot = u % a.plan.slots, lane = threadIdx.x & 31;
  const Unit t = unit_of(a, k, u);
  const int ld = unit_row(a, t.K);
  if (ld == t.K) {
    if (lane == 0) ring_issue(a, k, u);
    return;
  }
  uint64_t* bar = k.ubar + slot;
  if (lane == 0) mbar_expect_tx(bar, 2u * t.cols * t.K);  // a padded unit has rows
  __syncwarp();
  unsigned char* dst = k.ring + (size_t)slot * a.plan.slot_floats * 2;
  for (int i = lane; i < t.cols; i += 32)
    bulk_load(dst + (size_t)i * ld * 2, t.src + (size_t)i * t.K * 2, 2u * t.K, bar);
}

// Keep `slots` units issued ahead of the first unreleased one.  Called by
// all threads after a __syncthreads that ends the reads of the slots reused.
// PAD: the launch may pad its units' rows (ring_issue_rows).
template <bool PAD>
__device__ void ring_refill(const Args& a, Blk& k) {
  const int upto = min(a.units, k.released + a.plan.slots);
  if constexpr (PAD) {
    if (threadIdx.x < 32 && k.issued < upto) {
      fence_proxy_async_shared();  // the threads' reads of the reused slots come first
      for (int u = k.issued; u < upto; ++u) ring_issue_rows(a, k, u);
    }
  } else if (threadIdx.x == 0 && k.issued < upto) {
    fence_proxy_async_shared();  // the threads' reads of the reused slots come first
    for (int u = k.issued; u < upto; ++u) ring_issue(a, k, u);
  }
  if (upto > k.issued) k.issued = upto;
}

// The units before `end` are consumed: thread 0 makes sure their copies
// have landed (a block may own no rows of a product and never wait), then
// their slots take the next units.
template <bool PAD>
__device__ void ring_release(const Args& a, Blk& k, int end) {
  if (threadIdx.x == 0)
    for (int u = k.released; u < end; ++u) ring_wait(a, k, u);
  __syncthreads();
  k.released = end;
  ring_refill<PAD>(a, k);
}

// Before the block exits: no copy may still be writing its shared memory.
__device__ void ring_drain(const Args& a, const Blk& k) {
  if (threadIdx.x == 0)
    for (int u = k.released; u < k.issued; ++u) ring_wait(a, k, u);
}

// Floats of the layer body's scratch: qkv (R, 3E), eight (R, E) buffers,
// hid (R, F) and the cross probabilities (R, H, P).  (The bf16 arm keeps
// the two contexts and hid as bf16 in the first half of theirs.)
__host__ __device__ long long layer_scratch_floats(int R, int E, int H, int F, int P) {
  return (long long)R * (11LL * E + F + (long long)H * P);
}

// Dynamic shared memory of a launch: the mbarriers, the ring (of wsize-byte
// weight elements), the staged rows, a LayerNorm's parameters, each warp's
// attention scratch and, in the rollout, each row's key, token and flag;
// in the bf16 arm then, 16-byte aligned at xb_offset, the staged rows' bf16
// copy (rc rows of bf16_row_len values).
// ops/decode_step.py:decode_plan computes the same sum.
__host__ __device__ __forceinline__ int bf16_row_len(int E, int F) {
  return (int)round_up(E > F ? E : F, 16) + 8;
}

size_t xb_offset(const Plan& p, int R, int T, int P, int E, int H, int F, bool rollout, int wsize) {
  const int TP = T > P ? T : P;
  size_t bytes = round_up(8 * (size_t)(p.slots + 1), 128) + (size_t)wsize * p.slots * p.slot_floats +
                 4 * (size_t)p.rc * (E > F ? E : F) + 8 * (size_t)E +
                 4 * round_up((size_t)kWarps * (E / H + TP), 2);
  if (rollout) bytes += 16 * (size_t)R;
  return wsize == 2 ? round_up(bytes, 16) : bytes;
}

size_t smem_layout_bytes(const Plan& p, int R, int T, int P, int E, int H, int F, bool rollout, int wsize) {
  const size_t bytes = xb_offset(p, R, T, P, E, H, F, rollout, wsize);
  return wsize == 2 ? bytes + 2 * (size_t)p.rc * bf16_row_len(E, F) : bytes;
}

template <bool PAD>
__device__ void blk_init(Args& a, Blk& k, unsigned char* smem) {
  const Plan& p = a.plan;
  const int E = a.E, F = a.F, dh = a.E / a.H, TP = a.T > a.P ? a.T : a.P;
  k.ubar = reinterpret_cast<uint64_t*>(smem);
  k.xbar = k.ubar + p.slots;
  size_t off = round_up(8 * (size_t)(p.slots + 1), 128);
  k.ring = smem + off;
  off += (size_t)a.wsize * p.slots * p.slot_floats;
  k.xs = reinterpret_cast<float*>(smem + off);
  off += 4 * (size_t)p.rc * (E > F ? E : F);
  k.lnp = reinterpret_cast<float*>(smem + off);
  off += 8 * (size_t)E;
  k.sq = reinterpret_cast<float*>(smem + off) + (threadIdx.x >> 5) * (dh + TP);
  off += 4 * round_up((size_t)kWarps * (dh + TP), 2);
  k.best = reinterpret_cast<unsigned long long*>(smem + off);
  k.tok = reinterpret_cast<int*>(k.best + a.R);
  k.fin = k.tok + a.R;
  k.gc = p.grid / p.row_groups;
  k.bc = blockIdx.x % k.gc;
  k.rpg = (a.R + p.row_groups - 1) / p.row_groups;
  k.ra = min(a.R, (blockIdx.x / k.gc) * k.rpg);
  k.rb = min(a.R, k.ra + k.rpg);
  k.issued = k.released = 0;
  k.xphase = 0;
  k.stamps = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i <= p.slots; ++i) mbar_init(k.ubar + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  ring_refill<PAD>(a, k);
}

// A grid-wide barrier.  Each thread first orders its generic writes before
// the copy engine's reads of them after the barrier.
__device__ __forceinline__ void grid_barrier(cg::grid_group& grid, Blk& k) {
  stamp(k, 1);
  fence_proxy_async_global();
  grid.sync();
  stamp(k, 2);
}

// Staging runs out of line with its arguments by value (one copy of the
// code for every product; a reference to the block's state would put that
// state in local memory).  Each returns after the rows have landed.

// Rows r0..r0+rn of src (row length K, written by any block before the
// last grid barrier, or an input) into xs with one bulk copy on xbar,
// whose phase of parity `phase` this is.
__device__ __noinline__ void stage_copy(float* xs, uint64_t* xbar, uint32_t phase, const float* src, int r0,
                                        int rn, int K) {
  if (threadIdx.x == 0) {
    fence_proxy_async_global();
    fence_proxy_async_shared();
    const uint32_t bytes = 4u * rn * K;
    mbar_expect_tx(xbar, bytes);
    bulk_load(xs, src + (size_t)r0 * K, bytes, xbar);
  }
  mbar_wait(xbar, phase);
}

// Four values to dst: a float4, or (the bf16 arm's staged rows) four bf16
// rounded to nearest by two cvt.rn.bf16x2, one 8-byte store.
__device__ __forceinline__ void store4(float* p, float4 y) { *reinterpret_cast<float4*>(p) = y; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 y) {
  const __nv_bfloat162 lo = __float22bfloat162_rn(make_float2(y.x, y.y));
  const __nv_bfloat162 hi = __float22bfloat162_rn(make_float2(y.z, y.w));
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

// One warp: LayerNorm of NR rows of E values, src[n] (shared or device
// memory) with scale w and shift b, written to dst[n] (f32, or bf16 in the
// bf16 arm's staged copy) and, when set, to dst2[n] (f32).  A row is held in
// registers (E <= 32 * 4 * kLnVec) so that all its loads are in flight at
// once, and NR rows go together so that their reduction chains overlap (a
// warp issues in order); each row's arithmetic is the same whatever NR.
// src may equal dst.
template <int NR, class D>
__device__ __forceinline__ void ln_rows(const float* const* src, D* const* dst, float* const* dst2,
                                        const float* w, const float* b, int E) {
  const int lane = threadIdx.x & 31;
  float4 v[NR][kLnVec];
  float s[NR], mu[NR], ss[NR], rstd[NR];
#pragma unroll
  for (int n = 0; n < NR; ++n) {
    s[n] = 0.f;
#pragma unroll
    for (int j = 0; j < kLnVec; ++j) {
      const int c = 4 * lane + 128 * j;
      v[n][j] = c < E ? *reinterpret_cast<const float4*>(src[n] + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      s[n] += (v[n][j].x + v[n][j].y) + (v[n][j].z + v[n][j].w);
    }
  }
#pragma unroll
  for (int n = 0; n < NR; ++n) mu[n] = warp_sum(s[n]) / E;
#pragma unroll
  for (int n = 0; n < NR; ++n) {
    ss[n] = 0.f;
#pragma unroll
    for (int j = 0; j < kLnVec; ++j) {
      if (4 * lane + 128 * j < E) {
        const float dx = v[n][j].x - mu[n], dy = v[n][j].y - mu[n], dz = v[n][j].z - mu[n], dw = v[n][j].w - mu[n];
        ss[n] += (dx * dx + dy * dy) + (dz * dz + dw * dw);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NR; ++n) rstd[n] = rsqrtf(warp_sum(ss[n]) / E + kLnEps);
#pragma unroll
  for (int j = 0; j < kLnVec; ++j) {
    const int c = 4 * lane + 128 * j;
    if (c < E) {
      const float4 g = *reinterpret_cast<const float4*>(w + c);
      const float4 o = *reinterpret_cast<const float4*>(b + c);
#pragma unroll
      for (int n = 0; n < NR; ++n) {
        const float4 y = make_float4((v[n][j].x - mu[n]) * rstd[n] * g.x + o.x, (v[n][j].y - mu[n]) * rstd[n] * g.y + o.y,
                                     (v[n][j].z - mu[n]) * rstd[n] * g.z + o.z, (v[n][j].w - mu[n]) * rstd[n] * g.w + o.w);
        store4(dst[n] + c, y);
        if (dst2[n]) *reinterpret_cast<float4*>(dst2[n] + c) = y;
      }
    }
  }
}

// Stage rows r0..r0+rn of src (E wide) and the LayerNorm's w and b (into
// lnp) with one bulk copy each, and normalise the rows in place, two rows
// a warp at a time; the owner of a row also writes it to dst.
__device__ __noinline__ void stage_ln(float* xs, float* lnp, uint64_t* xbar, uint32_t phase, const float* src,
                                      const float* w, const float* b, float* dst, int r0, int rn, int E,
                                      Owners own) {
  if (threadIdx.x == 0) {
    fence_proxy_async_global();
    fence_proxy_async_shared();
    const uint32_t rows = 4u * rn * E, par = 4u * E;
    mbar_expect_tx(xbar, rows + 2 * par);
    bulk_load(xs, src + (size_t)r0 * E, rows, xbar);
    bulk_load(lnp, w, par, xbar);
    bulk_load(lnp + E, b, par, xbar);
  }
  mbar_wait(xbar, phase);
  auto row = [&](int i) { return xs + (size_t)i * E; };
  auto out = [&](int i) { return own.mine(r0 + i) ? dst + (size_t)(r0 + i) * E : nullptr; };
  int i = threadIdx.x >> 5;
  for (; i + kWarps < rn; i += 2 * kWarps) {
    float* const rows[2] = {row(i), row(i + kWarps)};
    float* const outs[2] = {out(i), out(i + kWarps)};
    ln_rows<2>(rows, rows, outs, lnp, lnp + E, E);
  }
  if (i < rn) {
    float* const rows[1] = {row(i)};
    float* const outs[1] = {out(i)};
    ln_rows<1>(rows, rows, outs, lnp, lnp + E, E);
  }
}

// The rollout's first prologue: x = embedding[tok] + pe for rows r0..r0+rn,
// gathered by the threads (a bulk copy would queue behind the ring's
// weight copies that the last product issued); the owner also writes x.
__device__ __noinline__ void stage_embed(float* xs, const float* embedding, const float* pe, const int* tok,
                                         float* x, int r0, int rn, int E, Owners own) {
  const int q = E / 4;  // float4s of a row
#pragma unroll 4
  for (int i = threadIdx.x; i < rn * q; i += kThreads) {
    const int r = i / q, c = 4 * (i % q);
    const float4 e = load4(embedding + (size_t)tok[r0 + r] * E + c);
    const float4 p = __ldg(reinterpret_cast<const float4*>(pe + c));
    const float4 y = make_float4(e.x + p.x, e.y + p.y, e.z + p.z, e.w + p.w);
    *reinterpret_cast<float4*>(xs + (size_t)r * E + c) = y;
    if (own.mine(r0 + r)) *reinterpret_cast<float4*>(x + (size_t)(r0 + r) * E + c) = y;
  }
}

// The bf16 arm's stagings: each also writes the rows' bf16 copy into xb
// (row length ldb), which the products read.

// stage_copy, then the landed rows rounded to bf16 into xb.
__device__ __noinline__ void stage_copy_bf16(float* xs, __nv_bfloat16* xb, int ldb, uint64_t* xbar, uint32_t phase,
                                             const float* src, int r0, int rn, int K) {
  stage_copy(xs, xbar, phase, src, r0, rn, K);
  const int q = K / 4;  // float4s of a row
#pragma unroll 4
  for (int i = threadIdx.x; i < rn * q; i += kThreads) {
    const int r = i / q, c = 4 * (i % q);
    store4(xb + (size_t)r * ldb + c, *reinterpret_cast<const float4*>(xs + (size_t)r * K + c));
  }
}

// Rows r0..r0+rn of src, bf16 rows of K values that an earlier phase wrote
// (a context, or FFN1's hidden rows), into xb at row length ldb: one bulk
// copy a row, issued by warp 0's lanes, on xbar.
__device__ __noinline__ void stage_rows_bf16(__nv_bfloat16* xb, int ldb, uint64_t* xbar, uint32_t phase,
                                             const __nv_bfloat16* src, int r0, int rn, int K) {
  if (threadIdx.x < 32) {
    fence_proxy_async_global();
    fence_proxy_async_shared();
    if (threadIdx.x == 0) mbar_expect_tx(xbar, 2u * rn * K);
    __syncwarp();
    for (int r = threadIdx.x; r < rn; r += 32)
      bulk_load(xb + (size_t)r * ldb, src + (size_t)(r0 + r) * K, 2u * K, xbar);
  }
  mbar_wait(xbar, phase);
}

// stage_ln with the normalised rows written as bf16 into xb (xs keeps the
// landed rows); the owner of a row writes it to dst in f32.
__device__ __noinline__ void stage_ln_bf16(float* xs, __nv_bfloat16* xb, int ldb, float* lnp, uint64_t* xbar,
                                           uint32_t phase, const float* src, const float* w, const float* b,
                                           float* dst, int r0, int rn, int E, Owners own) {
  if (threadIdx.x == 0) {
    fence_proxy_async_global();
    fence_proxy_async_shared();
    const uint32_t rows = 4u * rn * E, par = 4u * E;
    mbar_expect_tx(xbar, rows + 2 * par);
    bulk_load(xs, src + (size_t)r0 * E, rows, xbar);
    bulk_load(lnp, w, par, xbar);
    bulk_load(lnp + E, b, par, xbar);
  }
  mbar_wait(xbar, phase);
  auto row = [&](int i) { return xs + (size_t)i * E; };
  auto brow = [&](int i) { return xb + (size_t)i * ldb; };
  auto out = [&](int i) { return own.mine(r0 + i) ? dst + (size_t)(r0 + i) * E : nullptr; };
  int i = threadIdx.x >> 5;
  for (; i + kWarps < rn; i += 2 * kWarps) {
    const float* const rows[2] = {row(i), row(i + kWarps)};
    __nv_bfloat16* const copies[2] = {brow(i), brow(i + kWarps)};
    float* const outs[2] = {out(i), out(i + kWarps)};
    ln_rows<2>(rows, copies, outs, lnp, lnp + E, E);
  }
  if (i < rn) {
    const float* const rows[1] = {row(i)};
    __nv_bfloat16* const copies[1] = {brow(i)};
    float* const outs[1] = {out(i)};
    ln_rows<1>(rows, copies, outs, lnp, lnp + E, E);
  }
}

// stage_embed of the bf16 table: x = embedding[tok] + pe in f32 (the owner
// writes it), rounded to bf16 into xb.
__device__ __noinline__ void stage_embed_bf16(__nv_bfloat16* xb, int ldb, const __nv_bfloat16* embedding,
                                              const float* pe, const int* tok, float* x, int r0, int rn, int E,
                                              Owners own) {
  const int q = E / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < rn * q; i += kThreads) {
    const int r = i / q, c = 4 * (i % q);
    const float4 e = load4(embedding + (size_t)tok[r0 + r] * E + c);  // a bf16 row widened exactly
    const float4 p = __ldg(reinterpret_cast<const float4*>(pe + c));
    const float4 y = make_float4(e.x + p.x, e.y + p.y, e.z + p.z, e.w + p.w);
    store4(xb + (size_t)r * ldb + c, y);
    if (own.mine(r0 + r)) *reinterpret_cast<float4*>(x + (size_t)(r0 + r) * E + c) = y;
  }
}

// The staging functions for this block: each flips the staging barrier's
// parity.
__device__ __forceinline__ void stage_copy(Blk& k, const float* src, int r0, int rn, int K) {
  stage_copy(k.xs, k.xbar, k.xphase, src, r0, rn, K);
  k.xphase ^= 1;
}

__device__ __forceinline__ void stage_ln(const Args& a, Blk& k, const float* src, const float* w, const float* b,
                                         float* dst, int r0, int rn) {
  stage_ln(k.xs, k.lnp, k.xbar, k.xphase, src, w, b, dst, r0, rn, a.E, Owners{k.rpg, k.gc});
  k.xphase ^= 1;
}

__device__ __forceinline__ void stage_embed(const Args& a, Blk& k, int s, float* x, int r0, int rn) {
  stage_embed(k.xs, a.embedding, a.pe + (size_t)s * a.E, k.tok, x, r0, rn, a.E, Owners{k.rpg, k.gc});
}

// The bf16 arm's staged copy: its place in this block's shared memory (the
// base is the first mbarrier's) and its row length.
__device__ __forceinline__ __nv_bfloat16* xb_of(const Args& a, const Blk& k) {
  return reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<unsigned char*>(k.ubar) + a.xb_off);
}

// The stagings of either arm: BF also writes the bf16 copy.  stage_rows:
// f32 rows (the input x); stage_acts: rows a phase of this launch wrote in
// the arm's type (in the bf16 arm each value was rounded as it was written).
template <bool BF>
__device__ __forceinline__ void stage_rows(const Args& a, Blk& k, const float* src, int r0, int rn, int K) {
  if constexpr (BF) {
    stage_copy_bf16(k.xs, xb_of(a, k), bf16_row_len(a.E, a.F), k.xbar, k.xphase, src, r0, rn, K);
    k.xphase ^= 1;
  } else {
    stage_copy(k, src, r0, rn, K);
  }
}

template <bool BF>
__device__ __forceinline__ void stage_acts(const Args& a, Blk& k, const float* src, int r0, int rn, int K) {
  if constexpr (BF) {
    stage_rows_bf16(xb_of(a, k), bf16_row_len(a.E, a.F), k.xbar, k.xphase,
                    reinterpret_cast<const __nv_bfloat16*>(src), r0, rn, K);
    k.xphase ^= 1;
  } else {
    stage_copy(k, src, r0, rn, K);
  }
}

template <bool BF>
__device__ __forceinline__ void stage_norm(const Args& a, Blk& k, const float* src, const float* w, const float* b,
                                           float* dst, int r0, int rn) {
  if constexpr (BF) {
    stage_ln_bf16(k.xs, xb_of(a, k), bf16_row_len(a.E, a.F), k.lnp, k.xbar, k.xphase, src, w, b, dst, r0, rn, a.E,
                  Owners{k.rpg, k.gc});
    k.xphase ^= 1;
  } else {
    stage_ln(a, k, src, w, b, dst, r0, rn);
  }
}

template <bool BF>
__device__ __forceinline__ void stage_tokens(const Args& a, Blk& k, int s, float* x, int r0, int rn) {
  if constexpr (BF)
    stage_embed_bf16(xb_of(a, k), bf16_row_len(a.E, a.F), reinterpret_cast<const __nv_bfloat16*>(a.embedding),
                     a.pe + (size_t)s * a.E, k.tok, x, r0, rn, a.E, Owners{k.rpg, k.gc});
  else
    stage_embed(a, k, s, x, r0, rn);
}

// One warp's tile of 16 staged rows (xr, row length K) by 4 weight rows
// (ws; rows past nc repeat the last and their sums are dropped): this
// lane's sums of flat outputs 2 lane and 2 lane + 1 of the (row, column)
// tile.  One out-of-line copy serves every product: the decode kernels are
// bound by instruction fetch when each product carries its own unrolled
// copy.  All 20 loads of a k step go before its 256 multiply-adds, since a
// warp issues in order; lanes split k in float4 steps and a reduce-scatter
// of shuffles (five halving steps, 62 shuffles) sums the lanes.
__device__ __noinline__ float2 tile_dot(const float* ws, const float* xr, int K, int nc) {
  const int lane = threadIdx.x & 31;
  float v[kRT * kCG];  // flat (row, column) partial sums of this lane
#pragma unroll
  for (int i = 0; i < kRT * kCG; ++i) v[i] = 0.f;
  for (int kk = 4 * lane; kk < K; kk += 128) {
    float4 w[kCG], x[kRT];
#pragma unroll
    for (int c = 0; c < kCG; ++c) w[c] = load4(ws + (size_t)min(c, nc - 1) * K + kk);
#pragma unroll
    for (int r = 0; r < kRT; ++r) x[r] = *reinterpret_cast<const float4*>(xr + (size_t)r * K + kk);
#pragma unroll
    for (int r = 0; r < kRT; ++r)
#pragma unroll
      for (int c = 0; c < kCG; ++c) v[r * kCG + c] = dot4(v[r * kCG + c], x[r], w[c]);
  }
  reduce_scatter64(v, lane);
  static_assert(kRT * kCG == 64, "the reduce-scatter assumes 64 outputs per task");
  return make_float2(v[0], v[1]);
}

// ldmatrix of four or one 8 x 8 bf16 matrices (the lanes' row addresses at
// `addr`), and one bf16 mma.sync m16n8k16 with f32 accumulators d += a b.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];" : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x1(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];" : "=r"(r[0]) : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bf16 arm's warp tile: 16 staged bf16 rows (xb, row length ldb) by 8
// weight rows of a ring unit (ws, K values each, ldw apart; rows past nc
// repeat the last and their sums are dropped), on mma.sync m16n8k16 (bf16
// operands, f32 accumulators: the exact products of two bf16 values summed
// in f32).  A's 16 x 16 fragment comes from xb by ldmatrix (lane l gives
// row l % 16, k half l / 16), B's 16 x 8 from the weight rows as they lie,
// which is mma's .col layout (lane l gives weight row l % 8, k eighth l /
// 8: four k8 pieces, two k16 steps, a load).  xb's row stride, and a
// padded unit's (ldw = ring_row(K)), are odd numbers of 16-byte granules,
// so their ldmatrix loads meet no bank conflict.  A k64 stage's six loads
// go out a stage ahead of its four products (two register sets), since a
// warp issues in order.  k16 step s goes to accumulator s % 4; the four are
// added in a fixed order, so an output's sum order depends on K alone.
// When K % 16 == 8 the last step's upper k half of A and B is zeroed in
// registers, so that neither xb's pad nor what follows a weight row in the
// ring enters a sum.  Returns this lane's outputs (row lane / 4, columns
// 2 (lane % 4) and + 1), (row lane / 4 + 8, the same columns), as mma's
// accumulator fragment lies.  Out of line, as tile_dot.
struct Frag64 {
  uint32_t a[4][4], b[2][4];
};

__device__ __forceinline__ void load64(Frag64& f, uint32_t pa, uint32_t pb, int k0) {
#pragma unroll
  for (int s = 0; s < 4; ++s) ldsm_x4(pa + 2 * (k0 + 16 * s), f.a[s]);
#pragma unroll
  for (int h = 0; h < 2; ++h) ldsm_x4(pb + 2 * (k0 + 32 * h), f.b[h]);
}

__device__ __noinline__ float4 tile_mma(const __nv_bfloat16* ws, int ldw, const __nv_bfloat16* xb, int ldb, int K,
                                        int nc) {
  const int lane = threadIdx.x & 31;
  const uint32_t pa = smem_u32(xb + (size_t)(lane & 15) * ldb + 8 * (lane >> 4));
  const uint32_t pb = smem_u32(ws + (size_t)min(lane & 7, nc - 1) * ldw + 8 * (lane >> 3));
  float acc[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s) acc[s][0] = acc[s][1] = acc[s][2] = acc[s][3] = 0.f;
  const int stages = K / 64;
  Frag64 cur, next;
  if (stages > 0) load64(cur, pa, pb, 0);
#pragma unroll 1
  for (int i = 0; i < stages; ++i) {
    if (i + 1 < stages) load64(next, pa, pb, 64 * (i + 1));
#pragma unroll
    for (int s = 0; s < 4; ++s) mma_bf16(acc[s], cur.a[s], cur.b[s >> 1][2 * (s & 1)], cur.b[s >> 1][2 * (s & 1) + 1]);
    cur = next;
  }
  const int k0 = 64 * stages, whole = (K - k0) >> 4, half = (K - k0) & 15;  // up to three k16 steps, 0 or 8 values
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint32_t a[4], b[2];
    if (s < whole) {
      ldsm_x4(pa + 2 * (k0 + 16 * s), a);
      ldsm_x2(pb + 2 * (k0 + 16 * s), b);
      mma_bf16(acc[s], a, b[0], b[1]);
    } else if (s == whole && half) {
      ldsm_x4(pa + 2 * (k0 + 16 * s), a);
      ldsm_x1(pb + 2 * (k0 + 16 * s), b);
      a[2] = a[3] = 0u;
      mma_bf16(acc[s], a, b[0], 0u);
    }
  }
  float out[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = (acc[0][i] + acc[1][i]) + (acc[2][i] + acc[3][i]);
  return make_float4(out[0], out[1], out[2], out[3]);
}

// out[r, c] for the block's rows [ra, rb) and the columns of ring units
// u0..u0+nu-1 (K-long weight rows): stage(r0, rn) puts input rows
// r0..r0+rn in xs (and, in the bf16 arm, their bf16 copy in xb), then each
// warp task multiplies 16 staged rows by a unit's 4 weight rows (tile_dot)
// or, in the bf16 arm, 8 (tile_mma), and epi(r, c, sum, pre(r, c)) takes
// each output, where pre(r, c) gives its bias and residual from device
// memory.  Rows past rn of the last tile are computed from whatever xs (xb)
// holds and dropped.  W: the weights' type in the ring; PAD: the launch may
// pad its units' rows (unit_row).
template <class W, bool PAD, class Stage, class Pre, class Epi>
__device__ void product(const Args& a, Blk& k, int u0, int nu, int K, Stage stage, Pre pre, Epi epi) {
  constexpr bool kBf = sizeof(W) == 2;
  constexpr int CG = kBf ? kCGb : kCG;  // columns of a warp task
  constexpr int NV = kBf ? 4 : 2;       // outputs of a lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int cols[kMaxGroup], col0[kMaxGroup], ncg = 0;
  for (int j = 0; j < nu; ++j) {
    const Unit t = unit_of(a, k, u0 + j);
    cols[j] = t.cols;
    col0[j] = t.col0;
    ncg += (t.cols + CG - 1) / CG;
  }
  const int S = a.plan.slot_floats, NS = a.plan.slots;
  for (int r0 = k.ra; r0 < k.rb; r0 += a.plan.rc) {
    const int rn = min(a.plan.rc, k.rb - r0), nrt = (rn + kRT - 1) / kRT;
    __syncthreads();  // the readers of xs are done
    stage(r0, rn);
    __syncthreads();
    stamp(k, 3);
    for (int task = warp; task < nrt * ncg; task += kWarps) {
      const int rt = task % nrt;
      int cgi = task / nrt, j = 0;
      while (cgi >= (cols[j] + CG - 1) / CG) cgi -= (cols[j++] + CG - 1) / CG;
      const int u = u0 + j, nc = min(CG, cols[j] - cgi * CG);
      ring_wait(a, k, u);
      stamp(k, 7);
      const int ldw = PAD ? unit_row(a, K) : K;  // weight row to row in the slot
      const W* ws = reinterpret_cast<const W*>(k.ring) + (size_t)(u % NS) * S + (size_t)cgi * CG * ldw;
      float v[NV];
      // This lane's outputs: (row, column) of the tile.
      auto at = [&](int i) {
        return kBf ? make_int2((lane >> 2) + 8 * (i >> 1), 2 * (lane & 3) + (i & 1))
                   : make_int2((2 * lane + i) / kCG, (2 * lane + i) % kCG);
      };
      // The epilogue operands; indices clamped into range so that all the
      // loads issue together, unpredicated (in the bf16 arm before the
      // tile, whose few microseconds then hide their latency).
      float2 pv[NV];
      auto load_pre = [&]() {
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int r = rt * kRT + at(i).x, c = cgi * CG + at(i).y;
          pv[i] = pre(r0 + min(r, rn - 1), col0[j] + min(c, cols[j] - 1));
        }
      };
      if constexpr (kBf) {
        load_pre();
        const int ldb = bf16_row_len(a.E, a.F);
        const float4 sums = tile_mma(ws, ldw, xb_of(a, k) + (size_t)rt * kRT * ldb, ldb, K, nc);
        v[0] = sums.x, v[1] = sums.y, v[2] = sums.z, v[3] = sums.w;
      } else {
        const float2 sums = tile_dot(ws, k.xs + (size_t)rt * kRT * K, K, nc);
        v[0] = sums.x, v[1] = sums.y;
        load_pre();
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int r = rt * kRT + at(i).x, c = cgi * CG + at(i).y;
        if (r < rn && c < cols[j]) epi(r0 + r, col0[j] + c, v[i], pv[i]);
      }
    }
    stamp(k, 5);
  }
}

// A product phase over ring units ub..ue-1, `group` units at a time, each
// group's units released when it is done.  When the block's rows fit one
// chunk they are staged once for all the groups.
template <class W, bool PAD, class Stage, class Pre, class Epi>
__device__ void product_units(const Args& a, Blk& k, int ub, int ue, int K, Stage stage, Pre pre, Epi epi) {
  const bool one_chunk = k.rb - k.ra <= a.plan.rc;
  bool staged = false;
  for (int g0 = ub; g0 < ue; g0 += a.plan.group) {
    const int n = min(a.plan.group, ue - g0);
    product<W, PAD>(a, k, g0, n, K,
            [&](int r0, int rn) {
              if (!(staged && one_chunk)) stage(r0, rn);
              staged = true;
            },
            pre, epi);
    ring_release<PAD>(a, k, g0 + n);
    stamp(k, 6);
  }
}

// One query row per (row, head) over n_pos key/value rows, one warp per
// pair.  q and the probabilities sit in this warp's shared-memory slice.
// Key/value row t of the head is at kbase/vbase + t * stride for t < n_base,
// and, when kx is set, row n_base is kx/vx (the self-attention's new k/v at
// pos), so n_pos = n_base + (kx != null).  Writes the context (dh floats)
// and, when probs_out is set, the probabilities.  Out of line: one copy
// serves both attentions.  VEC is the width of the key and value loads: 4
// (float4) when dh % 4 == 0, so that every head offset h * dh is 16-byte
// aligned, else 1 (scalar loads, any head width: GloVe-200 gives dh = 25,
// word2vec-300 dh = 50).  The rows come from device memory, so the loops
// keep many loads in flight: a lane loads a whole key before it adds, and
// at VEC 4 the weighted sum takes two positions a step (the half-warps),
// each lane 4 dims, kAttT steps of loads before their multiply-adds; the
// halves are added at the end.
constexpr int kAttT = 8;

template <int VEC>
__device__ __noinline__ void warp_attention(const float* q_src, int dh, float scale, const float* kbase,
                                            const float* vbase, size_t stride, int n_base, const float* kx,
                                            const float* vx, float* sq, float* sp, float* ctx, float* probs_out) {
  const int lane = threadIdx.x & 31;
  const int n_pos = n_base + (kx != nullptr);
  auto key = [&](int t) { return t < n_base ? kbase + t * stride : kx; };
  auto val = [&](int t) { return t < n_base ? vbase + t * stride : vx; };
  for (int d = lane; d < dh; d += 32) sq[d] = q_src[d];
  __syncwarp();
  float mx = -INFINITY;
  for (int t = lane; t < n_pos; t += 32) {
    const float* k = key(t);
    float s = 0.f;
    if constexpr (VEC == 4) {
#pragma unroll 16
      for (int d = 0; d < dh; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(k + d);
        s = dot4(s, make_float4(sq[d], sq[d + 1], sq[d + 2], sq[d + 3]), kv);
      }
    } else {
#pragma unroll 8
      for (int d = 0; d < dh; ++d) s = fmaf(sq[d], k[d], s);
    }
    s *= scale;
    sp[t] = s;
    mx = fmaxf(mx, s);
  }
  mx = warp_max(mx);
  float sum = 0.f;
  for (int t = lane; t < n_pos; t += 32) {
    const float e = expf(sp[t] - mx);
    sp[t] = e;
    sum += e;
  }
  const float inv = 1.0f / warp_sum(sum);
  for (int t = lane; t < n_pos; t += 32) {
    sp[t] *= inv;
    if (probs_out) probs_out[t] = sp[t];
  }
  __syncwarp();
  if constexpr (VEC == 4) {
    const int half = lane >> 4;
    for (int d0 = 0; d0 < dh; d0 += 64) {  // the same trips in every lane: the shuffles below need all
      const int d = d0 + 4 * (lane & 15);
      const bool on = d < dh;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int t0 = half; t0 < n_pos; t0 += 2 * kAttT) {
        float4 vv[kAttT];
#pragma unroll
        for (int i = 0; i < kAttT; ++i) {
          const int t = t0 + 2 * i;
          vv[i] = on && t < n_pos ? *reinterpret_cast<const float4*>(val(t) + d) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < kAttT; ++i) {
          const float p = t0 + 2 * i < n_pos ? sp[t0 + 2 * i] : 0.f;
          acc.x = fmaf(p, vv[i].x, acc.x);
          acc.y = fmaf(p, vv[i].y, acc.y);
          acc.z = fmaf(p, vv[i].z, acc.z);
          acc.w = fmaf(p, vv[i].w, acc.w);
        }
      }
      acc.x += __shfl_xor_sync(0xffffffffu, acc.x, 16);
      acc.y += __shfl_xor_sync(0xffffffffu, acc.y, 16);
      acc.z += __shfl_xor_sync(0xffffffffu, acc.z, 16);
      acc.w += __shfl_xor_sync(0xffffffffu, acc.w, 16);
      if (on && half == 0) *reinterpret_cast<float4*>(ctx + d) = acc;
    }
  } else {
    for (int d = lane; d < dh; d += 32) {
      float a = 0.f;
#pragma unroll 8
      for (int t = 0; t < n_pos; ++t) a = fmaf(sp[t], val(t)[d], a);
      ctx[d] = a;
    }
  }
  __syncwarp();
}

// Two values rounded to bf16 by one cvt.rn.bf16x2, widened back.
__device__ __forceinline__ float2 round_bf16x2(float a, float b) {
  return __bfloat1622float2(__float22bfloat162_rn(make_float2(a, b)));
}

// One score of the bf16 arm: the sum over a head's dh dims of bf16(q[d] *
// k[d]), q already scaled by 1/sqrt(dh) (f32), k bf16 (the cache or the
// memory) or f32 (the new k at pos).  The products are rounded in pairs and
// summed into four partial sums (dims d % 4 at VEC 4; at VEC 1 each group of
// four dims likewise, a last pair into the first two, a last dim into the
// third), added in a fixed order: the sum order depends on dh alone.
template <int VEC, class P>
__device__ __forceinline__ float score_bf16(const float* sq, const P* k, int dh) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int d = 0;
  if constexpr (VEC == 4) {
#pragma unroll 16
    for (; d < dh; d += 4) {
      const float4 kv = load4(k + d);
      const float2 lo = round_bf16x2(sq[d] * kv.x, sq[d + 1] * kv.y);
      const float2 hi = round_bf16x2(sq[d + 2] * kv.z, sq[d + 3] * kv.w);
      s0 += lo.x, s1 += lo.y, s2 += hi.x, s3 += hi.y;
    }
  } else {
#pragma unroll 4
    for (; d + 4 <= dh; d += 4) {
      const float2 lo = round_bf16x2(sq[d] * to_f32(k[d]), sq[d + 1] * to_f32(k[d + 1]));
      const float2 hi = round_bf16x2(sq[d + 2] * to_f32(k[d + 2]), sq[d + 3] * to_f32(k[d + 3]));
      s0 += lo.x, s1 += lo.y, s2 += hi.x, s3 += hi.y;
    }
    if (d + 2 <= dh) {
      const float2 lo = round_bf16x2(sq[d] * to_f32(k[d]), sq[d + 1] * to_f32(k[d + 1]));
      s0 += lo.x, s1 += lo.y;
      d += 2;
    }
    if (d < dh) s2 += round_bf16(sq[d] * to_f32(k[d]));
  }
  return (s0 + s1) + (s2 + s3);
}

// warp_attention in the bf16 arm (the JAX kernel's precise=False rounding,
// the module note): keys and values below n_base in bf16 at kbase/vbase,
// the new k/v at pos in f32 (kx/vx); q scaled before the products, each
// product rounded to bf16 (score_bf16), the softmax in f32, probs_out
// unrounded and each probability rounded to bf16 before it weights its
// value.  The new k's score is the whole warp's (its dims in pairs over the
// lanes, then a butterfly) and the weighted sum loads the bf16 rows kAttT at
// a time and adds the new f32 v last, so that no lane or load picks its type
// per position.  The context is written rounded to bf16 (ctx), as the
// out-projection reads it.
template <int VEC>
__device__ __noinline__ void warp_attention_bf16(const float* q_src, int dh, float scale,
                                                 const __nv_bfloat16* kbase, const __nv_bfloat16* vbase,
                                                 size_t stride, int n_base, const float* kx, const float* vx,
                                                 float* sq, float* sp, __nv_bfloat16* ctx, float* probs_out) {
  const int lane = threadIdx.x & 31;
  const int n_pos = n_base + (kx != nullptr);
  for (int d = lane; d < dh; d += 32) sq[d] = q_src[d] * scale;
  __syncwarp();
  float mx = -INFINITY;
  if (kx) {  // the new f32 key at pos: the whole warp, a pair of dims a lane, summed by a butterfly
    float s = 0.f;
    for (int d = 2 * lane; d < dh; d += 64) {
      const float2 p = round_bf16x2(sq[d] * kx[d], d + 1 < dh ? sq[d + 1] * kx[d + 1] : 0.f);
      s += p.x + p.y;
    }
    mx = warp_sum(s);
    if (lane == 0) sp[n_base] = mx;
  }
  for (int t = lane; t < n_base; t += 32) {  // the bf16 keys, a lane each: no lane picks a type of its own
    const float s = score_bf16<VEC>(sq, kbase + t * stride, dh);
    sp[t] = s;
    mx = fmaxf(mx, s);
  }
  mx = warp_max(mx);
  __syncwarp();
  float sum = 0.f;
  for (int t = lane; t < n_pos; t += 32) {
    const float e = expf(sp[t] - mx);
    sp[t] = e;
    sum += e;
  }
  const float inv = 1.0f / warp_sum(sum);
  for (int t = lane; t < n_pos; t += 32) {
    const float p = sp[t] * inv;
    if (probs_out) probs_out[t] = p;
    sp[t] = round_bf16(p);
  }
  __syncwarp();
  if constexpr (VEC == 4) {
    const int half = lane >> 4;
    for (int d0 = 0; d0 < dh; d0 += 64) {  // the same trips in every lane: the shuffles below need all
      const int d = d0 + 4 * (lane & 15);
      const bool on = d < dh;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int t0 = half; t0 < n_base; t0 += 2 * kAttT) {  // the bf16 rows: one load of one type each
        float4 vv[kAttT];
#pragma unroll
        for (int i = 0; i < kAttT; ++i) {
          const int t = t0 + 2 * i;
          vv[i] = on && t < n_base ? load4(vbase + t * stride + d) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < kAttT; ++i) {
          const float p = t0 + 2 * i < n_base ? sp[t0 + 2 * i] : 0.f;
          acc.x = fmaf(p, vv[i].x, acc.x);
          acc.y = fmaf(p, vv[i].y, acc.y);
          acc.z = fmaf(p, vv[i].z, acc.z);
          acc.w = fmaf(p, vv[i].w, acc.w);
        }
      }
      if (vx && on && half == (n_base & 1)) {  // the new f32 v at pos, last in its half's order
        const float4 v = load4(vx + d);
        const float p = sp[n_base];
        acc = make_float4(fmaf(p, v.x, acc.x), fmaf(p, v.y, acc.y), fmaf(p, v.z, acc.z), fmaf(p, v.w, acc.w));
      }
      acc.x += __shfl_xor_sync(0xffffffffu, acc.x, 16);
      acc.y += __shfl_xor_sync(0xffffffffu, acc.y, 16);
      acc.z += __shfl_xor_sync(0xffffffffu, acc.z, 16);
      acc.w += __shfl_xor_sync(0xffffffffu, acc.w, 16);
      if (on && half == 0) store4(ctx + d, acc);
    }
  } else {
    for (int d = lane; d < dh; d += 32) {
      float a = 0.f;
#pragma unroll 8
      for (int t = 0; t < n_base; ++t) a = fmaf(sp[t], to_f32(vbase[t * stride + d]), a);
      if (vx) a = fmaf(sp[n_base], vx[d], a);
      ctx[d] = __float2bfloat16(a);
    }
  }
  __syncwarp();
}

__device__ __forceinline__ void store_elem(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// How decode_layer's QKV phase gets its input rows.
enum InKind { kInRows = 0, kInLn3 = 1, kInEmbed = 2 };

// One decoder layer l at position pos for all R rows: eight phases, each
// ended by a grid barrier.  The input rows are x_in (kInRows), the LN3 of
// the previous layer's h3 (kInLn3) or the rollout's embedding of token s
// (kInEmbed); in the last two the owners write them to x, the residual.
// The layer's units are u0..u0+upl-1.  h3 = x2 + FFN2 is left for the
// caller's LN3.  VEC is warp_attention's key load width; BF selects the
// bf16 arm (the module note); PAD lets the ring pad its units' rows.
template <int VEC, bool BF, bool PAD>
__device__ void decode_layer(const Args& a, Blk& k, cg::grid_group& grid, int l, int u0, int pos, InKind in,
                             float* x, int s) {
  using W = typename Elem<BF>::T;
  const int E = a.E, E3 = 3 * E, F = a.F, H = a.H, dh = E / H, R = a.R, P = a.P, T = a.T;
  const int lane = threadIdx.x & 31;
  const float scale = rsqrtf((float)dh);
  const size_t RE = (size_t)R * E;
  float* qkv = a.scratch;      // (R, 3E)
  float* ctx_s = qkv + 3 * RE;  // (R, E) self-attention context (bf16 in the bf16 arm, as are ctx_c and hid)
  float* h1 = ctx_s + RE;       // x + self-attention output
  float* x1 = h1 + RE;          // LN1
  float* q2 = x1 + RE;          // cross query
  float* ctx_c = q2 + RE;       // cross context
  float* h2 = ctx_c + RE;       // x1 + cross output
  float* x2 = h2 + RE;          // LN2
  float* h3 = x2 + RE;          // x2 + FFN output
  float* hid = h3 + RE;         // (R, F)
  float* pbuf = hid + (size_t)R * F;  // (R, H, P) cross probabilities
  const float* res = in == kInRows ? a.x_in : x;  // the residual of LN1
  float* sq = k.sq;
  float* sp = sq + dh;
  const int ne = a.ne, u_so = u0 + 3 * ne, u_cq = u_so + ne, u_co = u_cq + ne, u_f1 = u_co + ne,
            u_f2 = u_f1 + a.nf;

  // 1. QKV.
  const float* bq = a.b_qkv + (size_t)l * E3;
  product_units<W, PAD>(a, k, u0, u_so, E,
          [&](int r0, int rn) {
            if (in == kInRows)
              stage_rows<BF>(a, k, a.x_in, r0, rn, E);
            else if (in == kInLn3)
              stage_norm<BF>(a, k, h3, a.ln3_w + (size_t)(l - 1) * E, a.ln3_b + (size_t)(l - 1) * E, x, r0, rn);
            else
              stage_tokens<BF>(a, k, s, x, r0, rn);
          },
          [&](int, int c) { return make_float2(bq[c], 0.f); },
          [&](int r, int c, float y, float2 p) { qkv[(size_t)r * E3 + c] = y + p.x; });
  grid_barrier(grid, k);

  // 2. Self-attention over positions 0..pos; pos itself is the new k/v,
  //    which also goes out for the cache update.
  for (int task = global_warp(); task < R * H; task += grid_warps()) {
    const int r = task / H, h = task % H;
    const float* row = qkv + (size_t)r * E3;
    W* kd = reinterpret_cast<W*>(a.k_new) + l * a.kv_ls + r * a.kv_rs + h * dh;
    W* vd = reinterpret_cast<W*>(a.v_new) + l * a.kv_ls + r * a.kv_rs + h * dh;
    for (int d = lane; d < dh; d += 32) {
      store_elem(kd + d, row[E + h * dh + d]);
      store_elem(vd + d, row[2 * E + h * dh + d]);
    }
    const W* ck = reinterpret_cast<const W*>(a.cache_k) + ((size_t)l * R + r) * T * E + h * dh;
    const W* cv = reinterpret_cast<const W*>(a.cache_v) + ((size_t)l * R + r) * T * E + h * dh;
    const float* kn = row + E + h * dh;
    const float* vn = row + 2 * E + h * dh;
    if constexpr (BF)
      warp_attention_bf16<VEC>(row + h * dh, dh, scale, ck, cv, E, pos, kn, vn, sq, sp,
                               reinterpret_cast<W*>(ctx_s) + (size_t)r * E + h * dh, nullptr);
    else
      warp_attention<VEC>(row + h * dh, dh, scale, ck, cv, E, pos, kn, vn, sq, sp, ctx_s + (size_t)r * E + h * dh,
                          nullptr);
  }
  grid_barrier(grid, k);

  // 3. Out-projection and residual.
  const float* bso = a.b_so + (size_t)l * E;
  product_units<W, PAD>(a, k, u_so, u_cq, E, [&](int r0, int rn) { stage_acts<BF>(a, k, ctx_s, r0, rn, E); },
                [&](int r, int c) { return make_float2(bso[c], res[(size_t)r * E + c]); },
                [&](int r, int c, float y, float2 p) { h1[(size_t)r * E + c] = p.y + (y + p.x); });
  grid_barrier(grid, k);

  // 4. LN1 (prologue), cross query; then the cross-attention.
  const float* bcq = a.b_cq + (size_t)l * E;
  product_units<W, PAD>(a, k, u_cq, u_co, E,
                [&](int r0, int rn) {
                  stage_norm<BF>(a, k, h1, a.ln1_w + (size_t)l * E, a.ln1_b + (size_t)l * E, x1, r0, rn);
                },
                [&](int, int c) { return make_float2(bcq[c], 0.f); },
                [&](int r, int c, float y, float2 p) { q2[(size_t)r * E + c] = y + p.x; });
  grid_barrier(grid, k);
  for (int task = global_warp(); task < R * H; task += grid_warps()) {
    const int r = task / H, h = task % H;
    const W* mk = reinterpret_cast<const W*>(a.mem_k) + ((size_t)l * R + r) * P * E + h * dh;
    const W* mv = reinterpret_cast<const W*>(a.mem_v) + ((size_t)l * R + r) * P * E + h * dh;
    if constexpr (BF)
      warp_attention_bf16<VEC>(q2 + (size_t)r * E + h * dh, dh, scale, mk, mv, E, P, nullptr, nullptr, sq, sp,
                               reinterpret_cast<W*>(ctx_c) + (size_t)r * E + h * dh, pbuf + ((size_t)r * H + h) * P);
    else
      warp_attention<VEC>(q2 + (size_t)r * E + h * dh, dh, scale, mk, mv, E, P, nullptr, nullptr, sq, sp,
                          ctx_c + (size_t)r * E + h * dh, pbuf + ((size_t)r * H + h) * P);
  }
  grid_barrier(grid, k);
  const float* bco = a.b_co + (size_t)l * E;
  product_units<W, PAD>(a, k, u_co, u_f1, E, [&](int r0, int rn) { stage_acts<BF>(a, k, ctx_c, r0, rn, E); },
                [&](int r, int c) { return make_float2(bco[c], x1[(size_t)r * E + c]); },
                [&](int r, int c, float y, float2 p) { h2[(size_t)r * E + c] = p.y + (y + p.x); });
  grid_barrier(grid, k);

  // 5. LN2 (prologue) and the alpha mean, FFN1, FFN2 and residual.
  const float* bf1 = a.b_f1 + (size_t)l * F;
  product_units<W, PAD>(a, k, u_f1, u_f2, E,
                [&](int r0, int rn) {
                  stage_norm<BF>(a, k, h2, a.ln2_w + (size_t)l * E, a.ln2_b + (size_t)l * E, x2, r0, rn);
                },
                [&](int, int c) { return make_float2(bf1[c], 0.f); },
                [&](int r, int c, float y, float2 p) {
                  store_elem(reinterpret_cast<W*>(hid) + (size_t)r * F + c, fmaxf(y + p.x, 0.f));
                });
  for (int i = threadIdx.x; i < (k.rb - k.ra) * P; i += kThreads) {
    const int r = k.ra + i / P, p = i % P;
    if (!owns(k, r)) continue;
    float sum = 0.f;
    for (int h = 0; h < H; ++h) sum += pbuf[((size_t)r * H + h) * P + p];
    const float contrib = sum / H / a.L;
    a.alpha[(size_t)r * P + p] = l == 0 ? contrib : a.alpha[(size_t)r * P + p] + contrib;
  }
  grid_barrier(grid, k);
  const float* bf2 = a.b_f2 + (size_t)l * E;
  product_units<W, PAD>(a, k, u_f2, u_f2 + ne, F, [&](int r0, int rn) { stage_acts<BF>(a, k, hid, r0, rn, F); },
                [&](int r, int c) { return make_float2(bf2[c], x2[(size_t)r * E + c]); },
                [&](int r, int c, float y, float2 p) { h3[(size_t)r * E + c] = p.y + (y + p.x); });
  grid_barrier(grid, k);
}

// The owners' LN3 of layer l's h3 into x_out: the tail of the per-layer and
// one-cell kernels (ln_rows, as the next layer's prologue computes it).
__device__ void ln3_owned(const Args& a, const Blk& k, int l) {
  const float* h3 = a.scratch + 10 * (size_t)a.R * a.E;
  for (int r = k.ra + (threadIdx.x >> 5); r < k.rb; r += kWarps)
    if (owns(k, r)) {
      const float* const src[1] = {h3 + (size_t)r * a.E};
      float* const dst[1] = {a.x_out + (size_t)r * a.E};
      float* const none[1] = {nullptr};
      ln_rows<1>(src, dst, none, a.ln3_w + (size_t)l * a.E, a.ln3_b + (size_t)l * a.E, a.E);
    }
}

template <int VEC, bool BF>
__global__ void __launch_bounds__(kThreads, 1) decode_layer_kernel(const Args a0) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(128) unsigned char smem[];
  Args a = a0;
  Blk k;
  blk_init<BF>(a, k, smem);
  stamp(k, 0);
  decode_layer<VEC, BF, BF>(a, k, grid, a.layer, 0, a.pos, kInRows, nullptr, 0);
  ln3_owned(a, k, a.layer);
  stamp(k, 4);
  ring_drain(a, k);
}

template <int VEC, bool BF>
__global__ void __launch_bounds__(kThreads, 1) decode_onecell_kernel(const Args a0) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(128) unsigned char smem[];
  Args a = a0;
  Blk k;
  blk_init<false>(a, k, smem);
  stamp(k, 0);
  for (int l = 0; l < a.L; ++l)
    decode_layer<VEC, BF, false>(a, k, grid, l, a.upl * l, a.pos, l == 0 ? kInRows : kInLn3, a.x_out, 0);
  ln3_owned(a, k, a.L - 1);
  stamp(k, 4);
  ring_drain(a, k);
}

// The input token of row r at step s: the teacher's where the mix says so.
// Clamped into [0, V) so that no id can read outside the embedding.
__device__ __forceinline__ int input_token(const Args& a, int s, int r, int tok) {
  if (a.use_teacher && a.use_teacher[(size_t)s * a.R + r]) tok = a.teacher[(size_t)s * a.R + r];
  return min(max(tok, 0), a.V - 1);
}

// A key whose unsigned order is (value, then the smaller column): the map
// of a float onto an unsigned int that keeps its order (-0 as +0), then
// the column's complement.
__device__ __forceinline__ unsigned long long argmax_key(float v, int c) {
  if (v == 0.f) v = 0.f;
  unsigned u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (unsigned)c);
}

// Token t's argmax and feedback, in every block alike: for each row still
// running, pred from the merged key; its owner writes seqs[:, t] and
// alphas[:, t]; tok = pred and fin = pred == end_id.  A finished row keeps
// its post-mix input token.
__device__ void finish_token(const Args& a, Blk& k, int t) {
  for (int r = threadIdx.x; r < a.R; r += kThreads) {
    if (k.fin[r]) continue;
    const unsigned long long key = __ldcg(a.best + (size_t)(t & 1) * a.R + r);
    const int pred = (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull));
    if (owns(k, r)) {
      a.seqs[(size_t)r * a.steps + t] = pred;
      for (int p = 0; p < a.P; ++p)
        a.alphas[((size_t)r * a.steps + t) * a.P + p] = a.alpha[(size_t)r * a.P + p];
    }
    k.tok[r] = pred;
    k.fin[r] = pred == a.end_id;
  }
  __syncthreads();
}

template <int VEC, bool BF>
__global__ void __launch_bounds__(kThreads, 1) decode_rollout_kernel(const Args a0) {
  using W = typename Elem<BF>::T;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(128) unsigned char smem[];
  Args a = a0;
  Blk k;
  blk_init<false>(a, k, smem);
  stamp(k, 0);
  const int R = a.R, E = a.E, L = a.L, S = a.steps, V = a.V;
  W* cache_k = reinterpret_cast<W*>(a.k_new);  // the same buffers as a.cache_k/v
  W* cache_v = reinterpret_cast<W*>(a.v_new);
  float* x = a.x_out;
  const float* h3 = a.scratch + 10 * (size_t)R * E;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    k.tok[r] = a.state[r];
    k.fin[r] = a.state[R + r];
  }
  __syncthreads();

  int s = 0;
  for (; s < S; ++s) {
    if (s > 0) finish_token(a, k, s - 1);
    int running = 0;
    for (int r = threadIdx.x; r < R; r += kThreads) running |= !k.fin[r];
    if (!__syncthreads_or(running)) break;
    for (int r = threadIdx.x; r < R; r += kThreads) {
      k.tok[r] = input_token(a, s, r, k.tok[r]);
      if (owns(k, r)) a.best[(size_t)(s & 1) * R + r] = 0ull;
      k.best[r] = 0ull;
    }
    __syncthreads();

    // The L layers; layer l's new k/v rows go to the cache at position s.
    a.k_new = reinterpret_cast<float*>(cache_k + (size_t)s * E);
    a.v_new = reinterpret_cast<float*>(cache_v + (size_t)s * E);
    for (int l = 0; l < L; ++l)
      decode_layer<VEC, BF, false>(a, k, grid, l, s * a.upt + a.upl * l, s, l == 0 ? kInEmbed : kInLn3, x, s);

    // The head; its prologue is the last LN3.  Rows still running write
    // their logits and merge their keys.
    product_units<W, false>(a, k, s * a.upt + a.upl * L, (s + 1) * a.upt, E,
                  [&](int r0, int rn) {
                    stage_norm<BF>(a, k, h3, a.ln3_w + (size_t)(L - 1) * E, a.ln3_b + (size_t)(L - 1) * E, x, r0,
                                   rn);
                  },
                  [&](int, int c) { return make_float2(a.fc_b[c], 0.f); },
                  [&](int r, int c, float y, float2 p) {
                    if (k.fin[r]) return;
                    y += p.x;
                    a.logits[((size_t)r * S + s) * V + c] = y;
                    atomicMax(k.best + r, argmax_key(y, c));
                  });
    for (int r = threadIdx.x; r < R; r += kThreads)
      if (k.best[r]) atomicMax(a.best + (size_t)(s & 1) * R + r, k.best[r]);
    grid_barrier(grid, k);
  }
  if (s == S) finish_token(a, k, S - 1);
  if (blockIdx.x == 0) {
    for (int r = threadIdx.x; r < R; r += kThreads) {
      a.state[r] = k.tok[r];
      a.state[R + r] = k.fin[r];
    }
    if (threadIdx.x == 0) a.state[2 * R] = s;
  }
  stamp(k, 4);
  ring_drain(a, k);
}

// Any head width E / H; the products need E and F to be whole 16-byte
// rows of wsize-byte weights (float4 rows, 16-byte bulk copies: % 4, or %
// 8 in bf16), the LayerNorms E <= 1024 (a row in one warp's registers).
bool shapes_ok(int T, int E, int H, int F, int pos, int wsize) {
  const int row = 16 / wsize;
  return H > 0 && E % H == 0 && E % row == 0 && F % row == 0 && E <= 32 * 4 * kLnVec && pos >= 0 && pos < T;
}

// The plan covers every output column once and each unit fits its slot
// (in the per-layer kernel, `layer`, a padded plan's rows take ring_row(K)
// elements of it).
bool plan_ok(const Plan& p, int R, int E, int F, int V, int wsize, bool layer) {
  if (p.grid < 1 || (p.row_groups != 1 && p.row_groups != 2) || p.grid % p.row_groups) return false;
  const int gc = p.grid / p.row_groups, K = E > F ? E : F;
  const long long S = p.slot_floats;
  bool ok = (long long)p.ce * gc >= E && (long long)p.cf * gc >= F && p.uc >= 1 && p.rc >= kRT &&
            p.rc % kRT == 0 && p.slots >= 1 && S % 32 == 0 &&
            (long long)p.uc * (layer && padded_rows(p, wsize) ? ring_row(K) : K) <= S && p.group >= 1 &&
            p.group <= p.slots && p.group <= kMaxGroup && R >= 1;
  if (V > 0) ok = ok && p.row_groups == 1 && (long long)p.cv * p.grid >= V && p.hc >= 1 && (long long)p.hc * E <= S;
  return ok;
}

// The launch's ring units per product, layer, token and in all.
void set_units(Args& a, int tokens) {
  a.ne = (a.plan.ce + a.plan.uc - 1) / a.plan.uc;
  a.nf = (a.plan.cf + a.plan.uc - 1) / a.plan.uc;
  a.upl = 7 * a.ne + a.nf;
  a.upt = a.upl * a.Lr + (a.V > 0 ? (a.plan.cv + a.plan.hc - 1) / a.plan.hc : 0);
  a.units = a.upt * tokens;
}

Plan read_plan(const int* v) {
  return Plan{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9], v[10]};
}

// Which instance of a kernel template serves this head width: float4 key
// loads when dh % 4 == 0, scalar ones otherwise.
bool vec4_heads(int E, int H) { return (E / H) % 4 == 0; }

// A cooperative launch of `kernel` over the plan's blocks, all co-resident.
int launch(const void* kernel, Args& a, size_t smem, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if ((long long)per_sm * sms < a.plan.grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(a.plan.grid), dim3(kThreads), params, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

long long round4(long long n) { return (n + 3) / 4 * 4; }

// The layer and one-cell launches: check, fill the launch fields, launch.
// bf16: the kernels' bf16 instances.
int layer_launch(Args& a, const int* plan, int smem, bool one_cell, bool bf16, void* stream) {
  a.wsize = bf16 ? 2 : 4;
  if (!shapes_ok(a.T, a.E, a.H, a.F, a.pos, a.wsize)) return (int)cudaErrorInvalidValue;
  a.plan = read_plan(plan);
  if (!plan_ok(a.plan, a.R, a.E, a.F, 0, a.wsize, !one_cell) ||
      smem_layout_bytes(a.plan, a.R, a.T, a.P, a.E, a.H, a.F, false, a.wsize) != (size_t)smem)
    return (int)cudaErrorInvalidValue;
  a.xb_off = (int)xb_offset(a.plan, a.R, a.T, a.P, a.E, a.H, a.F, false, a.wsize);
  a.l0 = one_cell ? 0 : a.layer;
  a.Lr = one_cell ? a.L : 1;
  set_units(a, 1);
  const bool v4 = vec4_heads(a.E, a.H);
  const void* const kernels[2][2][2] = {  // [one_cell][bf16][v4]
      {{(const void*)decode_layer_kernel<1, false>, (const void*)decode_layer_kernel<4, false>},
       {(const void*)decode_layer_kernel<1, true>, (const void*)decode_layer_kernel<4, true>}},
      {{(const void*)decode_onecell_kernel<1, false>, (const void*)decode_onecell_kernel<4, false>},
       {(const void*)decode_onecell_kernel<1, true>, (const void*)decode_onecell_kernel<4, true>}}};
  return launch(kernels[one_cell][bf16][v4], a, smem, stream);
}

// The rollout launch of either instance: check, fill, launch.  The
// pointers of the bf16 instance's bf16 tensors are cast (see Args).
int rollout_launch(const float* embedding, const float* fc_w, const float* fc_b, const float* pe,
                   const int* teacher, const int* use_teacher, float* logits, int* seqs, float* alphas,
                   const float* const* w, const float* mem_k, const float* mem_v, float* cache_k, float* cache_v,
                   int* state, float* scratch, int L, int R, int P, int E, int H, int F, int V, int steps,
                   int end_id, const int* plan, int smem, bool bf16, void* stream) {
  const int wsize = bf16 ? 2 : 4;
  if (!shapes_ok(steps, E, H, F, 0, wsize) || V < 1 || (teacher == nullptr) != (use_teacher == nullptr))
    return (int)cudaErrorInvalidValue;
  const Plan p = read_plan(plan);
  if (!plan_ok(p, R, E, F, V, wsize, false) || smem_layout_bytes(p, R, steps, P, E, H, F, true, wsize) != (size_t)smem)
    return (int)cudaErrorInvalidValue;
  float* x = scratch + round4(layer_scratch_floats(R, E, H, F, P));
  float* alpha = x + round4((long long)R * E);
  auto* best = reinterpret_cast<unsigned long long*>(alpha + round4((long long)R * P));
  const size_t T = steps;
  Args a{x, x, alpha, cache_k, cache_v, (size_t)R * T * E, T * E, w[0], w[1], w[2], w[3],
         w[4], w[5], w[6], w[7], w[8], w[9], w[10], w[11], w[12], w[13], w[14], w[15], w[16],
         w[17], cache_k, cache_v, mem_k, mem_v, scratch, 0, L, R, steps, P, E, H, F, 0,
         embedding, fc_w, fc_b, pe, teacher, use_teacher, logits, seqs, alphas, best, state,
         V, steps, end_id, p, 0, L};
  a.wsize = wsize;
  a.xb_off = (int)xb_offset(p, R, steps, P, E, H, F, true, wsize);
  set_units(a, steps);
  const bool v4 = vec4_heads(E, H);
  const void* kernel = bf16 ? (v4 ? (const void*)decode_rollout_kernel<4, true> : (const void*)decode_rollout_kernel<1, true>)
                            : (v4 ? (const void*)decode_rollout_kernel<4, false> : (const void*)decode_rollout_kernel<1, false>);
  return launch(kernel, a, smem, stream);
}

}  // namespace

extern "C" {

// The shared-memory layout of a plan (11 ints, Plan's fields) for a launch
// of R rows of kind 0 (per-layer), 1 (one-cell) or 2 (rollout, T the
// steps) with wsize-byte weights, as the kernels take it: out[0] the total
// bytes, out[1] the byte offset of the bf16 arm's staged copy, out[2] its
// row length in values (0 and 0 in the f32 arm), out[3] plan_ok.  For the
// CPU-side plan's tests (ops/decode_step.py:decode_layout).
int tc_decode_smem_layout(const int* plan, int R, int T, int P, int E, int H, int F, int V, int kind, int wsize,
                          long long* out) {
  if ((wsize != 2 && wsize != 4) || H < 1 || E % H || kind < 0 || kind > 2) return -1;
  const Plan p = read_plan(plan);
  out[0] = (long long)smem_layout_bytes(p, R, T, P, E, H, F, kind == 2, wsize);
  out[1] = wsize == 2 ? (long long)xb_offset(p, R, T, P, E, H, F, kind == 2, wsize) : 0;
  out[2] = wsize == 2 ? bf16_row_len(E, F) : 0;
  out[3] = plan_ok(p, R, E, F, V, wsize, kind == 0);
  return 0;
}

// Floats of scratch the caller allocates for one layer or one-cell launch.
long long tc_decode_scratch_floats(int R, int E, int H, int F, int P) {
  return layer_scratch_floats(R, E, H, F, P);
}

// Floats of scratch for one rollout launch: the layer scratch, then x (R,
// E), alpha (R, P) and the (2, R) 64-bit argmax keys, each 16-byte aligned.
long long tc_rollout_scratch_floats(int R, int E, int H, int F, int P) {
  return round4(layer_scratch_floats(R, E, H, F, P)) + round4((long long)R * E) + round4((long long)R * P) +
         4LL * R;
}

// One decoder layer for all R rows; the caller launches layers 0..L-1 in
// order on one stream, layer l > 0 reading layer l-1's x_out.  plan holds
// 11 ints (Plan's fields, from decode_plan) and smem the dynamic
// shared memory they give.
int tc_decode_layer_forward(
    const float* x_in, float* x_out, float* alpha, float* k_new, float* v_new,
    const float* w_qkv, const float* b_qkv, const float* w_so, const float* b_so,
    const float* w_cq, const float* b_cq, const float* w_co, const float* b_co,
    const float* w_f1, const float* b_f1, const float* w_f2, const float* b_f2,
    const float* ln1_w, const float* ln1_b, const float* ln2_w, const float* ln2_b,
    const float* ln3_w, const float* ln3_b, const float* cache_k, const float* cache_v,
    const float* mem_k, const float* mem_v, float* scratch, int layer, int L, int R, int T,
    int P, int E, int H, int F, int pos, const int* plan, int smem, void* stream) {
  Args a{x_in, x_out, alpha, k_new, v_new, (size_t)R * E, (size_t)E, w_qkv, b_qkv, w_so, b_so,
         w_cq, b_cq, w_co, b_co, w_f1, b_f1, w_f2, b_f2, ln1_w, ln1_b, ln2_w, ln2_b, ln3_w,
         ln3_b, cache_k, cache_v, mem_k, mem_v, scratch, layer, L, R, T, P, E, H, F, pos};
  return layer_launch(a, plan, smem, false, false, stream);
}

// The bf16 arm of one decoder layer: the same arguments, with the six
// weight matrices, k_new / v_new, the caches and the memory K/V in bf16 and
// the rest (x_in, x_out, alpha, the biases, the LayerNorms, the scratch) in
// f32; the plan is decode_plan(..., esize=2).
int tc_decode_layer_forward_bf16(
    const float* x_in, float* x_out, float* alpha, void* k_new, void* v_new,
    const void* w_qkv, const float* b_qkv, const void* w_so, const float* b_so,
    const void* w_cq, const float* b_cq, const void* w_co, const float* b_co,
    const void* w_f1, const float* b_f1, const void* w_f2, const float* b_f2,
    const float* ln1_w, const float* ln1_b, const float* ln2_w, const float* ln2_b,
    const float* ln3_w, const float* ln3_b, const void* cache_k, const void* cache_v,
    const void* mem_k, const void* mem_v, float* scratch, int layer, int L, int R, int T,
    int P, int E, int H, int F, int pos, const int* plan, int smem, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };  // Args' pointer type (see Args)
  Args a{x_in, x_out, alpha, static_cast<float*>(k_new), static_cast<float*>(v_new), (size_t)R * E, (size_t)E,
         f(w_qkv), b_qkv, f(w_so), b_so, f(w_cq), b_cq, f(w_co), b_co, f(w_f1), b_f1, f(w_f2), b_f2,
         ln1_w, ln1_b, ln2_w, ln2_b, ln3_w, ln3_b, f(cache_k), f(cache_v), f(mem_k), f(mem_v), scratch,
         layer, L, R, T, P, E, H, F, pos};
  return layer_launch(a, plan, smem, false, true, stream);
}

// All L decoder layers for all R rows in one launch; the same arguments as
// tc_decode_layer_forward without the layer index.
int tc_decode_onecell_forward(
    const float* x_in, float* x_out, float* alpha, float* k_new, float* v_new,
    const float* w_qkv, const float* b_qkv, const float* w_so, const float* b_so,
    const float* w_cq, const float* b_cq, const float* w_co, const float* b_co,
    const float* w_f1, const float* b_f1, const float* w_f2, const float* b_f2,
    const float* ln1_w, const float* ln1_b, const float* ln2_w, const float* ln2_b,
    const float* ln3_w, const float* ln3_b, const float* cache_k, const float* cache_v,
    const float* mem_k, const float* mem_v, float* scratch, int L, int R, int T, int P, int E,
    int H, int F, int pos, const int* plan, int smem, void* stream) {
  Args a{x_in, x_out, alpha, k_new, v_new, (size_t)R * E, (size_t)E, w_qkv, b_qkv, w_so, b_so,
         w_cq, b_cq, w_co, b_co, w_f1, b_f1, w_f2, b_f2, ln1_w, ln1_b, ln2_w, ln2_b, ln3_w,
         ln3_b, cache_k, cache_v, mem_k, mem_v, scratch, 0, L, R, T, P, E, H, F, pos};
  return layer_launch(a, plan, smem, true, false, stream);
}

// The one-cell bf16 instance: tc_decode_onecell_forward's arguments with
// tc_decode_layer_forward_bf16's dtypes; the plan is decode_plan('onecell',
// ..., esize=2).
int tc_decode_onecell_forward_bf16(
    const float* x_in, float* x_out, float* alpha, void* k_new, void* v_new,
    const void* w_qkv, const float* b_qkv, const void* w_so, const float* b_so,
    const void* w_cq, const float* b_cq, const void* w_co, const float* b_co,
    const void* w_f1, const float* b_f1, const void* w_f2, const float* b_f2,
    const float* ln1_w, const float* ln1_b, const float* ln2_w, const float* ln2_b,
    const float* ln3_w, const float* ln3_b, const void* cache_k, const void* cache_v,
    const void* mem_k, const void* mem_v, float* scratch, int L, int R, int T, int P, int E,
    int H, int F, int pos, const int* plan, int smem, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };  // Args' pointer type (see Args)
  Args a{x_in, x_out, alpha, static_cast<float*>(k_new), static_cast<float*>(v_new), (size_t)R * E, (size_t)E,
         f(w_qkv), b_qkv, f(w_so), b_so, f(w_cq), b_cq, f(w_co), b_co, f(w_f1), b_f1, f(w_f2), b_f2,
         ln1_w, ln1_b, ln2_w, ln2_b, ln3_w, ln3_b, f(cache_k), f(cache_v), f(mem_k), f(mem_v), scratch,
         0, L, R, T, P, E, H, F, pos};
  return layer_launch(a, plan, smem, true, true, stream);
}

// A whole greedy rollout of `steps` tokens for R rows.  cache_k/v are
// (L, R, steps, E) scratch, state is tok (R) set to the start id, fin (R)
// zero and one int for the tokens run; logits, seqs and alphas are zeroed.
// teacher and use_teacher are (steps, R) or both null.
int tc_decode_rollout(
    const float* embedding, const float* fc_w, const float* fc_b, const float* pe,
    const int* teacher, const int* use_teacher, float* logits, int* seqs, float* alphas,
    const float* w_qkv, const float* b_qkv, const float* w_so, const float* b_so,
    const float* w_cq, const float* b_cq, const float* w_co, const float* b_co,
    const float* w_f1, const float* b_f1, const float* w_f2, const float* b_f2,
    const float* ln1_w, const float* ln1_b, const float* ln2_w, const float* ln2_b,
    const float* ln3_w, const float* ln3_b, const float* mem_k, const float* mem_v,
    float* cache_k, float* cache_v, int* state, float* scratch, int L, int R, int P, int E,
    int H, int F, int V, int steps, int end_id, const int* plan, int smem, void* stream) {
  const float* const w[18] = {w_qkv, b_qkv, w_so, b_so, w_cq, b_cq, w_co, b_co, w_f1, b_f1,
                              w_f2, b_f2, ln1_w, ln1_b, ln2_w, ln2_b, ln3_w, ln3_b};
  return rollout_launch(embedding, fc_w, fc_b, pe, teacher, use_teacher, logits, seqs, alphas, w, mem_k, mem_v,
                        cache_k, cache_v, state, scratch, L, R, P, E, H, F, V, steps, end_id, plan, smem, false,
                        stream);
}

// The rollout's bf16 instance: the same arguments, with the embedding
// table, fc_w, the six weight matrices, the memory K/V and the (L, R,
// steps, E) caches in bf16 and the rest f32; the plan is
// decode_plan('rollout', ..., esize=2).
int tc_decode_rollout_bf16(
    const void* embedding, const void* fc_w, const float* fc_b, const float* pe,
    const int* teacher, const int* use_teacher, float* logits, int* seqs, float* alphas,
    const void* w_qkv, const float* b_qkv, const void* w_so, const float* b_so,
    const void* w_cq, const float* b_cq, const void* w_co, const float* b_co,
    const void* w_f1, const float* b_f1, const void* w_f2, const float* b_f2,
    const float* ln1_w, const float* ln1_b, const float* ln2_w, const float* ln2_b,
    const float* ln3_w, const float* ln3_b, const void* mem_k, const void* mem_v,
    void* cache_k, void* cache_v, int* state, float* scratch, int L, int R, int P, int E,
    int H, int F, int V, int steps, int end_id, const int* plan, int smem, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };  // Args' pointer type (see Args)
  const float* const w[18] = {f(w_qkv), b_qkv, f(w_so), b_so, f(w_cq), b_cq, f(w_co), b_co, f(w_f1), b_f1,
                              f(w_f2), b_f2, ln1_w, ln1_b, ln2_w, ln2_b, ln3_w, ln3_b};
  return rollout_launch(f(embedding), f(fc_w), fc_b, pe, teacher, use_teacher, logits, seqs, alphas, w, f(mem_k),
                        f(mem_v), static_cast<float*>(cache_k), static_cast<float*>(cache_v), state, scratch, L, R,
                        P, E, H, F, V, steps, end_id, plan, smem, true, stream);
}

const char* tc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

#ifdef TC_DECODE_TIMELINE
// The first n stamps of the last launch, the SM cycle counter at each, and
// what each marks (scripts/decode_timeline.py).
int tc_decode_timeline(unsigned long long* t, long long* clock, int* what, int n) {
  cudaError_t err = cudaMemcpyFromSymbol(t, tc_timeline, sizeof(unsigned long long) * n);
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(clock, tc_timeline_clock, sizeof(long long) * n);
  return (int)(err != cudaSuccess ? err : cudaMemcpyFromSymbol(what, tc_timeline_what, sizeof(int) * n));
}
#endif

}  // extern "C"
