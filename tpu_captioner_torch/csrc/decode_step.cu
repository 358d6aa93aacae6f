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
//   inside one launch, with a grid barrier between layers;
// - _mega_kernel (fused_full_rollout) -> decode_rollout_kernel: that loop
//   inside a loop over the tokens of a greedy rollout, with an embedding
//   phase before it and vocab-head, argmax and feedback phases after it.
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
// x beam 5 (R = 40 rows) a layer is six matrix-vector-like products that
// read 8 MB of f32 weights for 2.1 M multiply-adds per row, two small
// attentions and three LayerNorms, each depending on the one before.  A
// rollout token adds the vocab head, E x V = 19.4 MB of f32 weights at V 9490.
//
// What the design does about it: each launch is cooperative and spans every
// SM; a layer runs as 11 phases separated by grid-wide barriers, and each
// phase spreads its work over all warps of the grid:
// - a product out = act(in W^T + b) is cut into block tasks of 16 rows x 32
//   output columns: the block stages its 16 input rows in shared memory,
//   each warp loads its 4 weight rows (the nn.Linear (out, in) layout, 512
//   contiguous bytes per row and warp) with all loads in flight, lanes split
//   the k axis in float4 steps and a reduce-scatter of shuffles sums the
//   lanes.  Each weight is read once per 16 rows;
// - attention runs one warp per (row, head) at dh = E/H (the TPU kernel's
//   0/1 head-selector matmul is a lane-layout device and is not carried
//   over); only positions t <= pos are ever read, so an uninitialised cache
//   slot can never reach a sum.  Each kernel is instantiated twice and the
//   launch picks by head width: float4 key loads when dh % 4 == 0, scalar
//   loads otherwise (GloVe-200: dh 25; word2vec-300: dh 50);
// - LayerNorm runs one warp per row.
// The product and LayerNorm bodies are not inlined, so the six products and
// three LayerNorms of a layer share one copy of code in the instruction
// cache (measured: 112 -> 101 us per layer at R = 40).
// Intermediates produced inside a launch live in scratch buffers that each
// phase writes and only later phases read; the grid barrier orders the
// writes before the reads and makes them visible to every SM.  The
// multi-layer kernels rewrite the same buffers for every layer and token.
// The rollout's control words (each row's token and finished flag, which
// every block branches on) are read past L1 (__ldcg) all the same, so that
// no block can act on a stale copy and leave the loop alone.
//
// The rollout kernel's extra phases, per token s:
// - embed: x = embedding[tok] + pe[s], tok after the teacher mix
//   (use_teacher[s] ? teacher[s] : tok), as the TPU kernel stores it.  A row
//   gather: the TPU kernel's one-hot matmul only stood in for one;
// - L layer bodies; layer l writes its new k/v rows into the (L, R, T, E)
//   cache at position s, so no cache update runs outside the kernel;
// - head: logits = x fc_w^T + fc_b for (R, V) with the product above;
// - chunk partials, one warp per (row, 256 columns): copies the logits of
//   rows still running to logits[:, s] and keeps the chunk's max and the
//   first column that holds it;
// - argmax and feedback, one warp per row: reduces the partials (on equal
//   values the smaller column wins, so the result is torch.argmax's first
//   maximum), writes seqs[:, s] and alphas[:, s] for rows still running,
//   then tok = running ? pred : tok and fin |= running && pred == end_id.
// Rows that finished earlier keep the zeros the caller allocated.  Every
// block checks the finished flags before a token and the launch stops once
// all rows have finished; it counts the tokens it ran in state[2R].

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRT = 16;  // rows per product task
constexpr int kCG = 4;   // output columns per warp in a product task
constexpr int kKChunk = 512;  // k values whose weights a warp loads at once
constexpr int kLnPerLane = 32;  // LayerNorm rows up to 32 * 32 = 1024 wide
constexpr float kLnEps = 1e-5f;
constexpr int kHeadChunk = 256;  // vocab columns per argmax partial

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
  float* scratch;  // 8 (R, E) buffers, (R, 3E), (R, F), (R, H, P)
  int layer, L, R, T, P, E, H, F, pos;
};

// The rollout's tensors beside the layers'.  In `a`, x_in = x_out = x,
// cache_k/v and k_new/v_new are both the rollout's own cache, and pos is
// set per token.
struct RolloutArgs {
  Args a;
  const float* embedding;  // (V, E)
  const float *fc_w, *fc_b;  // (V, E), (V)
  const float* pe;           // (steps, E)
  const int *teacher, *use_teacher;  // (steps, R) each, or both null
  float* logits;  // (R, steps, V), zeroed by the caller
  int* seqs;      // (R, steps), zeroed
  float* alphas;  // (R, steps, P), zeroed
  float* head;    // (R, V) scratch
  float* part_v;  // (R, chunks) scratch
  int* part_i;    // (R, chunks) scratch
  int* state;     // tok (R), fin (R), tokens run (1)
  int V, steps, end_id;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
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

// One halving step of a reduce-scatter across lanes: of 2*HALF partial sums
// a lane keeps the half its XOR partner does not, adding the partner's copy.
template <int HALF, int XOR>
__device__ __forceinline__ void reduce_half(float* v, int lane) {
  const bool upper = lane & XOR;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, XOR);
  }
}

// out[r, c] = act(in[r, :] . W[c, :] + b[c]); in (R, K) written earlier in
// this launch, W (N, K) read-only, K % 4 == 0.  A block task is a tile of
// kRT rows x (8 warps x kCG) columns: the block stages the input rows in
// shared memory (xs, kRT * K floats) with all its loads in flight, then each
// warp loads its kCG weight rows kKChunk floats at a time, all in flight,
// and multiplies them against the staged rows.
__device__ __noinline__ void grid_linear(const float* __restrict__ W, const float* __restrict__ b,
                            const float* in, float* out, int R, int K, int N, bool relu,
                            float* xs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ncb = (N + kCG * kWarps - 1) / (kCG * kWarps), nrt = (R + kRT - 1) / kRT;
  for (int task = blockIdx.x; task < ncb * nrt; task += gridDim.x) {
    const int r0 = (task / ncb) * kRT, c0 = (task % ncb) * kCG * kWarps + warp * kCG;
    __syncthreads();  // the previous task's readers of xs are done
    for (int i = 4 * threadIdx.x; i < kRT * K; i += 4 * kThreads) {
      const int r = r0 + i / K;
      *reinterpret_cast<float4*>(xs + i) =
          r < R ? *reinterpret_cast<const float4*>(in + (size_t)r * K + i % K)
                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    if (c0 >= N) continue;
    float v[kRT * kCG];  // flat (row, column) partial sums of this lane
#pragma unroll
    for (int i = 0; i < kRT * kCG; ++i) v[i] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kKChunk) {
      float4 w[kKChunk / 128][kCG];
#pragma unroll
      for (int j = 0; j < kKChunk / 128; ++j) {
        const int k = k0 + 128 * j + 4 * lane;
#pragma unroll
        for (int c = 0; c < kCG; ++c)
          w[j][c] = k < K && c0 + c < N
                        ? __ldg(reinterpret_cast<const float4*>(W + (size_t)(c0 + c) * K + k))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
#pragma unroll
        for (int j = 0; j < kKChunk / 128; ++j) {
          const int k = k0 + 128 * j + 4 * lane;
          if (k < K) {
            const float4 x = *reinterpret_cast<const float4*>(xs + r * K + k);
#pragma unroll
            for (int c = 0; c < kCG; ++c) v[r * kCG + c] = dot4(v[r * kCG + c], x, w[j][c]);
          }
        }
      }
    }
    // Reduce-scatter over the lanes: five halving steps (62 shuffles) leave
    // lane j with the sums of flat outputs 2j and 2j + 1.
    reduce_half<32, 16>(v, lane);
    reduce_half<16, 8>(v, lane);
    reduce_half<8, 4>(v, lane);
    reduce_half<4, 2>(v, lane);
    reduce_half<2, 1>(v, lane);
    static_assert(kRT * kCG == 64, "the reduce-scatter assumes 64 outputs per task");
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int flat = 2 * lane + i, r = r0 + flat / kCG, c = c0 + flat % kCG;
      if (r < R && c < N) {
        const float y = v[i] + b[c];
        out[(size_t)r * N + c] = relu ? fmaxf(y, 0.f) : y;
      }
    }
  }
}

// out[r] = LN(x[r] + add[r]) * w + b, one warp per row, the row held in
// registers (E <= 32 * kLnPerLane) so that all its loads are in flight at once.
__device__ __noinline__ void grid_add_ln(const float* x, const float* add, const float* __restrict__ w,
                            const float* __restrict__ b, float* out, int R, int E) {
  const int lane = threadIdx.x & 31;
  for (int r = global_warp(); r < R; r += grid_warps()) {
    const float* xr = x + (size_t)r * E;
    const float* ar = add + (size_t)r * E;
    float v[kLnPerLane];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kLnPerLane; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < E ? xr[c] + ar[c] : 0.f;
      s += v[i];
    }
    const float mu = warp_sum(s) / E;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kLnPerLane; ++i) {
      const float d = lane + 32 * i < E ? v[i] - mu : 0.f;
      ss += d * d;
    }
    const float rstd = rsqrtf(warp_sum(ss) / E + kLnEps);
#pragma unroll
    for (int i = 0; i < kLnPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < E) out[(size_t)r * E + c] = (v[i] - mu) * rstd * w[c] + b[c];
    }
  }
}

// One query row per (row, head) over n_pos key/value rows, one warp per
// pair.  q and the probabilities sit in this warp's shared-memory slice;
// key(t)/val(t) give the t-th key/value row of the head.  Writes the context
// (dh floats) and, when probs_out is set, the probabilities.  VEC is the
// width of the key loads: 4 (float4) when dh % 4 == 0, so that every head
// offset h * dh is 16-byte aligned, else 1 (scalar loads, any head width:
// GloVe-200 gives dh = 25, word2vec-300 dh = 50).
template <int VEC, class KeyFn, class ValFn>
__device__ void warp_attention(const float* q_src, int dh, float scale, int n_pos,
                               KeyFn key, ValFn val, float* sq, float* sp, float* ctx,
                               float* probs_out) {
  const int lane = threadIdx.x & 31;
  for (int d = lane; d < dh; d += 32) sq[d] = q_src[d];
  __syncwarp();
  float mx = -INFINITY;
  for (int t = lane; t < n_pos; t += 32) {
    const float* k = key(t);
    float s = 0.f;
    if constexpr (VEC == 4) {
#pragma unroll 8
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
  for (int d = lane; d < dh; d += 32) {
    float a = 0.f;
#pragma unroll 8
    for (int t = 0; t < n_pos; ++t) a = fmaf(sp[t], val(t)[d], a);
    ctx[d] = a;
  }
  __syncwarp();
}

// One decoder layer l at position pos for all R rows: the 11 phases, with a
// grid barrier between each two and none after the last.  x_in may equal
// x_out: x_in is last read three barriers before x_out is written.  VEC is
// warp_attention's key load width.  Every other read at a head offset is
// scalar (the query row into sq, the new k/v rows, the context writes), and
// the products read whole rows, 16-byte aligned since E % 4 == 0.
template <int VEC>
__device__ void decode_layer(const Args& a, cg::grid_group& grid, int l, int pos,
                             const float* x_in, float* x_out, float* sm) {
  const int E = a.E, E3 = 3 * E, F = a.F, H = a.H, dh = E / H, R = a.R, P = a.P;
  const int T = a.T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float scale = rsqrtf((float)dh);
  const size_t RE = (size_t)R * E;

  float* ctx_s = a.scratch;        // (R, E) self-attention context
  float* sa = ctx_s + RE;          // (R, E) self-attention output
  float* x1 = sa + RE;             // (R, E) after LN1
  float* q2 = x1 + RE;             // (R, E) cross query
  float* ctx_c = q2 + RE;          // (R, E) cross context
  float* ca = ctx_c + RE;          // (R, E) cross output
  float* x2 = ca + RE;             // (R, E) after LN2
  float* ff = x2 + RE;             // (R, E) FFN output
  float* qkv = ff + RE;            // (R, 3E)
  float* hid = qkv + 3 * RE;       // (R, F)
  float* pbuf = hid + (size_t)R * F;  // (R, H, P) cross probabilities

  const int TP = T > P ? T : P;
  float* xs = sm;                               // (kRT, max(E, F)) staged product rows
  float* sq = xs + kRT * (E > F ? E : F) + warp * (dh + TP);  // this warp's query row
  float* sp = sq + dh;                // and its probabilities

  // 1. QKV.
  grid_linear(a.w_qkv + (size_t)l * E3 * E, a.b_qkv + (size_t)l * E3, x_in, qkv, R, E, E3, false, xs);
  grid.sync();

  // 2. Self-attention over positions 0..pos; pos itself is the new k/v,
  //    which also goes out for the cache update.
  for (int task = global_warp(); task < R * H; task += grid_warps()) {
    const int r = task / H, h = task % H;
    const float* row = qkv + (size_t)r * E3;
    float* kd = a.k_new + l * a.kv_ls + r * a.kv_rs + h * dh;
    float* vd = a.v_new + l * a.kv_ls + r * a.kv_rs + h * dh;
    for (int d = lane; d < dh; d += 32) {
      kd[d] = row[E + h * dh + d];
      vd[d] = row[2 * E + h * dh + d];
    }
    const float* ck = a.cache_k + ((size_t)l * R + r) * T * E + h * dh;
    const float* cv = a.cache_v + ((size_t)l * R + r) * T * E + h * dh;
    const float* kn = row + E + h * dh;
    const float* vn = row + 2 * E + h * dh;
    warp_attention<VEC>(
        row + h * dh, dh, scale, pos + 1,
        [&](int t) { return t == pos ? kn : ck + (size_t)t * E; },
        [&](int t) { return t == pos ? vn : cv + (size_t)t * E; },
        sq, sp, ctx_s + (size_t)r * E + h * dh, nullptr);
  }
  grid.sync();

  // 3. Out-projection, residual, LN1.
  grid_linear(a.w_so + (size_t)l * E * E, a.b_so + (size_t)l * E, ctx_s, sa, R, E, E, false, xs);
  grid.sync();
  grid_add_ln(x_in, sa, a.ln1_w + (size_t)l * E, a.ln1_b + (size_t)l * E, x1, R, E);
  grid.sync();

  // 4. Cross-attention against the memory K/V.
  grid_linear(a.w_cq + (size_t)l * E * E, a.b_cq + (size_t)l * E, x1, q2, R, E, E, false, xs);
  grid.sync();
  for (int task = global_warp(); task < R * H; task += grid_warps()) {
    const int r = task / H, h = task % H;
    const float* mk = a.mem_k + ((size_t)l * R + r) * P * E + h * dh;
    const float* mv = a.mem_v + ((size_t)l * R + r) * P * E + h * dh;
    warp_attention<VEC>(
        q2 + (size_t)r * E + h * dh, dh, scale, P,
        [&](int t) { return mk + (size_t)t * E; },
        [&](int t) { return mv + (size_t)t * E; },
        sq, sp, ctx_c + (size_t)r * E + h * dh, pbuf + ((size_t)r * H + h) * P);
  }
  grid.sync();
  grid_linear(a.w_co + (size_t)l * E * E, a.b_co + (size_t)l * E, ctx_c, ca, R, E, E, false, xs);
  grid.sync();
  grid_add_ln(x1, ca, a.ln2_w + (size_t)l * E, a.ln2_b + (size_t)l * E, x2, R, E);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < R * P; i += gridDim.x * kThreads) {
    const int r = i / P, p = i % P;
    float s = 0.f;
    for (int h = 0; h < H; ++h) s += pbuf[((size_t)r * H + h) * P + p];
    const float contrib = s / H / a.L;
    a.alpha[i] = l == 0 ? contrib : a.alpha[i] + contrib;
  }
  grid.sync();

  // 5. FFN, residual, LN3.
  grid_linear(a.w_f1 + (size_t)l * F * E, a.b_f1 + (size_t)l * F, x2, hid, R, E, F, true, xs);
  grid.sync();
  grid_linear(a.w_f2 + (size_t)l * E * F, a.b_f2 + (size_t)l * E, hid, ff, R, F, E, false, xs);
  grid.sync();
  grid_add_ln(x2, ff, a.ln3_w + (size_t)l * E, a.ln3_b + (size_t)l * E, x_out, R, E);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) decode_layer_kernel(const Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float sm[];
  decode_layer<VEC>(a, grid, a.layer, a.pos, a.x_in, a.x_out, sm);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) decode_onecell_kernel(const Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float sm[];
  for (int l = 0; l < a.L; ++l) {
    if (l > 0) grid.sync();  // layer l - 1's x_out and alpha are complete
    decode_layer<VEC>(a, grid, l, a.pos, l == 0 ? a.x_in : a.x_out, a.x_out, sm);
  }
}

// The input token of row r at step s: the teacher's where the mix says so.
// Clamped into [0, V) so that no id can read outside the embedding.
__device__ __forceinline__ int input_token(const RolloutArgs& ra, int s, int r, int tok) {
  const int R = ra.a.R;
  if (ra.use_teacher && ra.use_teacher[(size_t)s * R + r]) tok = ra.teacher[(size_t)s * R + r];
  return min(max(tok, 0), ra.V - 1);
}

// Keep (v, i) if it beats (best, arg): a larger value, or an equal value at
// a smaller column.
__device__ __forceinline__ void argmax_merge(float& best, int& arg, float v, int i) {
  if (v > best || (v == best && i < arg)) {
    best = v;
    arg = i;
  }
}

__device__ __forceinline__ void warp_argmax(float& best, int& arg) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, best, o);
    const int i = __shfl_xor_sync(0xffffffffu, arg, o);
    argmax_merge(best, arg, v, i);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) decode_rollout_kernel(const RolloutArgs ra) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float sm[];
  __shared__ int all_done;
  Args a = ra.a;
  const int R = a.R, E = a.E, P = a.P, V = ra.V, S = ra.steps;
  const int lane = threadIdx.x & 31;
  const int chunks = (V + kHeadChunk - 1) / kHeadChunk;
  int* tok = ra.state;
  int* fin = ra.state + R;
  float* x = a.x_out;
  float* cache_k = a.k_new;  // the same buffers as a.cache_k/v
  float* cache_v = a.v_new;

  for (int s = 0; s < S; ++s) {
    // Every block reads the same flags, written before the last barrier, so
    // all blocks leave the loop together.
    if (threadIdx.x == 0) {
      int done = 1;
      for (int r = 0; r < R; ++r) done &= __ldcg(fin + r) != 0;
      all_done = done;
    }
    __syncthreads();
    if (all_done) break;

    // Embed.
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < R * E; i += gridDim.x * kThreads) {
      const int r = i / E, e = i % E;
      x[i] = ra.embedding[(size_t)input_token(ra, s, r, __ldcg(tok + r)) * E + e] +
             ra.pe[(size_t)s * E + e];
    }
    grid.sync();

    // The L layers; layer l's new k/v rows go to the cache at position s.
    a.k_new = cache_k + (size_t)s * E;
    a.v_new = cache_v + (size_t)s * E;
    for (int l = 0; l < a.L; ++l) {
      decode_layer<VEC>(a, grid, l, s, x, x, sm);
      grid.sync();
    }

    // Head.
    grid_linear(ra.fc_w, ra.fc_b, x, ra.head, R, E, V, false, sm);
    grid.sync();

    // Chunk partials; rows that finished earlier keep zero logits.
    for (int task = global_warp(); task < R * chunks; task += grid_warps()) {
      const int r = task / chunks, c0 = (task % chunks) * kHeadChunk;
      if (__ldcg(fin + r)) continue;
      const int c1 = min(V, c0 + kHeadChunk);
      float best = -INFINITY;
      int arg = V;
      for (int c = c0 + lane; c < c1; c += 32) {  // ascending columns: strict > keeps the first
        const float y = ra.head[(size_t)r * V + c];
        ra.logits[((size_t)r * S + s) * V + c] = y;
        if (y > best) {
          best = y;
          arg = c;
        }
      }
      warp_argmax(best, arg);
      if (lane == 0) {
        ra.part_v[task] = best;
        ra.part_i[task] = arg;
      }
    }
    grid.sync();

    // Argmax and feedback.
    for (int r = global_warp(); r < R; r += grid_warps()) {
      if (__ldcg(fin + r)) {  // frozen: keep the post-mix input token
        if (lane == 0) tok[r] = input_token(ra, s, r, __ldcg(tok + r));
        continue;
      }
      float best = -INFINITY;
      int arg = V;
      for (int c = lane; c < chunks; c += 32)
        argmax_merge(best, arg, ra.part_v[(size_t)r * chunks + c], ra.part_i[(size_t)r * chunks + c]);
      warp_argmax(best, arg);  // all lanes have read fin[r] before lane 0 writes it
      for (int p = lane; p < P; p += 32) ra.alphas[((size_t)r * S + s) * P + p] = a.alpha[(size_t)r * P + p];
      if (lane == 0) {
        ra.seqs[(size_t)r * S + s] = arg;
        tok[r] = arg;
        fin[r] = arg == ra.end_id;
      }
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) ra.state[2 * R] = s + 1;
    grid.sync();
  }
}

int grid_size(const void* kernel, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  return sms * (per_sm < 1 ? 1 : per_sm);  // all co-resident, as a cooperative launch needs
}

// Dynamic shared memory of a launch: the staged product rows and each
// warp's query row and probabilities.
size_t smem_bytes(int T, int P, int E, int H, int F) {
  const int TP = T > P ? T : P;
  return sizeof(float) * ((size_t)kRT * (E > F ? E : F) + (size_t)kWarps * (E / H + TP));
}

// Any head width E / H; the products need E % 4 == 0 and F % 4 == 0 (float4
// rows), the LayerNorms E <= 1024 (a row in one warp's registers).
bool shapes_ok(int T, int E, int H, int F, int pos) {
  return H > 0 && E % H == 0 && E % 4 == 0 && F % 4 == 0 && E <= 32 * kLnPerLane && pos >= 0 &&
         pos < T;
}

// Which instance of a kernel template serves this head width: float4 key
// loads when dh % 4 == 0, scalar ones otherwise.
bool vec4_heads(int E, int H) { return (E / H) % 4 == 0; }

// A cooperative launch of `kernel` over every co-resident block; `arg`
// points to its one argument struct.
int launch(const void* kernel, void* arg, size_t smem, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {arg};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid_size(kernel, smem)), dim3(kThreads), params,
                                    smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

long long round4(long long n) { return (n + 3) / 4 * 4; }

}  // namespace

extern "C" {

// Floats of scratch the caller allocates for one layer or one-cell launch.
long long tc_decode_scratch_floats(int R, int E, int H, int F, int P) {
  return (long long)R * (11LL * E + F + (long long)H * P);
}

// Floats of scratch for one rollout launch: the layer scratch, then x (R,
// E), alpha (R, P), the head's logits (R, V) and the argmax partials, each
// 16-byte aligned.
long long tc_rollout_scratch_floats(int R, int E, int H, int F, int P, int V) {
  const long long chunks = (V + kHeadChunk - 1) / kHeadChunk;
  return round4(tc_decode_scratch_floats(R, E, H, F, P)) + round4((long long)R * E) +
         round4((long long)R * P) + round4((long long)R * V) + 2 * round4((long long)R * chunks);
}

// One decoder layer for all R rows; the caller launches layers 0..L-1 in
// order on one stream, layer l > 0 reading layer l-1's x_out.
int tc_decode_layer_forward(
    const float* x_in, float* x_out, float* alpha, float* k_new, float* v_new,
    const float* w_qkv, const float* b_qkv, const float* w_so, const float* b_so,
    const float* w_cq, const float* b_cq, const float* w_co, const float* b_co,
    const float* w_f1, const float* b_f1, const float* w_f2, const float* b_f2,
    const float* ln1_w, const float* ln1_b, const float* ln2_w, const float* ln2_b,
    const float* ln3_w, const float* ln3_b, const float* cache_k, const float* cache_v,
    const float* mem_k, const float* mem_v, float* scratch, int layer, int L, int R, int T,
    int P, int E, int H, int F, int pos, void* stream) {
  if (!shapes_ok(T, E, H, F, pos)) return (int)cudaErrorInvalidValue;
  Args a{x_in, x_out, alpha, k_new, v_new, (size_t)R * E, (size_t)E, w_qkv, b_qkv, w_so, b_so,
         w_cq, b_cq, w_co, b_co, w_f1, b_f1, w_f2, b_f2, ln1_w, ln1_b, ln2_w, ln2_b, ln3_w,
         ln3_b, cache_k, cache_v, mem_k, mem_v, scratch, layer, L, R, T, P, E, H, F, pos};
  const void* kernel = vec4_heads(E, H) ? (const void*)decode_layer_kernel<4>
                                         : (const void*)decode_layer_kernel<1>;
  return launch(kernel, &a, smem_bytes(T, P, E, H, F), stream);
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
    int H, int F, int pos, void* stream) {
  if (!shapes_ok(T, E, H, F, pos)) return (int)cudaErrorInvalidValue;
  Args a{x_in, x_out, alpha, k_new, v_new, (size_t)R * E, (size_t)E, w_qkv, b_qkv, w_so, b_so,
         w_cq, b_cq, w_co, b_co, w_f1, b_f1, w_f2, b_f2, ln1_w, ln1_b, ln2_w, ln2_b, ln3_w,
         ln3_b, cache_k, cache_v, mem_k, mem_v, scratch, 0, L, R, T, P, E, H, F, pos};
  const void* kernel = vec4_heads(E, H) ? (const void*)decode_onecell_kernel<4>
                                         : (const void*)decode_onecell_kernel<1>;
  return launch(kernel, &a, smem_bytes(T, P, E, H, F), stream);
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
    int H, int F, int V, int steps, int end_id, void* stream) {
  if (!shapes_ok(steps, E, H, F, 0) || V < 1 || (teacher == nullptr) != (use_teacher == nullptr))
    return (int)cudaErrorInvalidValue;
  const int chunks = (V + kHeadChunk - 1) / kHeadChunk;
  float* x = scratch + round4(tc_decode_scratch_floats(R, E, H, F, P));
  float* alpha = x + round4((long long)R * E);
  float* head = alpha + round4((long long)R * P);
  float* part_v = head + round4((long long)R * V);
  int* part_i = reinterpret_cast<int*>(part_v + round4((long long)R * chunks));
  const size_t T = steps;
  RolloutArgs ra{
      Args{x, x, alpha, cache_k, cache_v, (size_t)R * T * E, T * E, w_qkv, b_qkv, w_so, b_so,
           w_cq, b_cq, w_co, b_co, w_f1, b_f1, w_f2, b_f2, ln1_w, ln1_b, ln2_w, ln2_b, ln3_w,
           ln3_b, cache_k, cache_v, mem_k, mem_v, scratch, 0, L, R, steps, P, E, H, F, 0},
      embedding, fc_w, fc_b, pe, teacher, use_teacher, logits, seqs, alphas, head, part_v,
      part_i, state, V, steps, end_id};
  const void* kernel = vec4_heads(E, H) ? (const void*)decode_rollout_kernel<4>
                                         : (const void*)decode_rollout_kernel<1>;
  return launch(kernel, &ra, smem_bytes(steps, P, E, H, F), stream);
}

const char* tc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
