// One layer of the KV-cached Transformer decode step, f32, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_captioner/ops/decode_step.py:_kernel (launched
// by fused_decode_step).  On the TPU one kernel walks the L layers as a
// sequential grid axis with the hidden state carried in VMEM scratch.  Hopper
// blocks run in no order, so the layer axis becomes L launches of this kernel
// on one stream; the hidden state is carried in x_out between launches.
// Per row and layer the launch computes, with post-norm LayerNorms (eps 1e-5):
//   1. the packed QKV projection (k_new, v_new are written out for the
//      caller's cache update);
//   2. causal self-attention over cache positions < pos plus the new k/v at
//      pos, merged without writing the cache (the caches are read-only);
//   3. out-projection, residual, LN1;
//   4. cross-attention query, attention over the P memory rows, out-
//      projection, residual, LN2; alpha += mean over heads of the cross
//      probabilities / L;
//   5. ReLU FFN, residual, LN3.
//
// What bounds it on the H100: bytes and latency, not arithmetic.  At batch 8
// x beam 5 (R = 40 rows) a layer is six matrix-vector-like products that
// read 8 MB of f32 weights for 2.1 M multiply-adds per row, two small
// attentions and three LayerNorms, each depending on the one before.
//
// What the design does about it: the launch is cooperative and spans every
// SM; the layer runs as 11 phases separated by grid-wide barriers, and each
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
//   slot can never reach a sum;
// - LayerNorm runs one warp per row.
// The product and LayerNorm bodies are not inlined, so the six products and
// three LayerNorms of a layer share one copy of code in the instruction
// cache (measured: 112 -> 101 us per layer at R = 40).
// Intermediates produced inside the launch live in separate scratch buffers,
// each written in one phase only and read only in later phases: the grid
// barrier orders the writes before the reads (it invalidates L1), and no SM
// can hold an older copy of a line it has not read before, so plain cached
// loads are safe and let the warps of an SM share rows through L1.

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

struct Args {
  const float* x_in;   // (R, E) layer input
  float* x_out;        // (R, E) layer output
  float* alpha;        // (R, P)
  float* k_new;        // (L, R, E)
  float* v_new;        // (L, R, E)
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
// (dh floats) and, when probs_out is set, the probabilities.
template <class KeyFn, class ValFn>
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
#pragma unroll 8
    for (int d = 0; d < dh; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(k + d);
      s = dot4(s, make_float4(sq[d], sq[d + 1], sq[d + 2], sq[d + 3]), kv);
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

__global__ void __launch_bounds__(kThreads) decode_layer_kernel(const Args a) {
  cg::grid_group grid = cg::this_grid();
  const int E = a.E, E3 = 3 * E, F = a.F, H = a.H, dh = E / H, R = a.R, P = a.P;
  const int l = a.layer, pos = a.pos, T = a.T;
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

  extern __shared__ __align__(16) float sm[];
  const int TP = T > P ? T : P;
  float* xs = sm;                               // (kRT, max(E, F)) staged product rows
  float* sq = xs + kRT * (E > F ? E : F) + warp * (dh + TP);  // this warp's query row
  float* sp = sq + dh;                // and its probabilities

  // 1. QKV.
  grid_linear(a.w_qkv + (size_t)l * E3 * E, a.b_qkv + (size_t)l * E3, a.x_in, qkv, R, E, E3, false, xs);
  grid.sync();

  // 2. Self-attention over positions 0..pos; pos itself is the new k/v,
  //    which also goes out for the cache update.
  for (int task = global_warp(); task < R * H; task += grid_warps()) {
    const int r = task / H, h = task % H;
    const float* row = qkv + (size_t)r * E3;
    for (int d = lane; d < dh; d += 32) {
      a.k_new[((size_t)l * R + r) * E + h * dh + d] = row[E + h * dh + d];
      a.v_new[((size_t)l * R + r) * E + h * dh + d] = row[2 * E + h * dh + d];
    }
    const float* ck = a.cache_k + ((size_t)l * R + r) * T * E + h * dh;
    const float* cv = a.cache_v + ((size_t)l * R + r) * T * E + h * dh;
    const float* kn = row + E + h * dh;
    const float* vn = row + 2 * E + h * dh;
    warp_attention(
        row + h * dh, dh, scale, pos + 1,
        [&](int t) { return t == pos ? kn : ck + (size_t)t * E; },
        [&](int t) { return t == pos ? vn : cv + (size_t)t * E; },
        sq, sp, ctx_s + (size_t)r * E + h * dh, nullptr);
  }
  grid.sync();

  // 3. Out-projection, residual, LN1.
  grid_linear(a.w_so + (size_t)l * E * E, a.b_so + (size_t)l * E, ctx_s, sa, R, E, E, false, xs);
  grid.sync();
  grid_add_ln(a.x_in, sa, a.ln1_w + (size_t)l * E, a.ln1_b + (size_t)l * E, x1, R, E);
  grid.sync();

  // 4. Cross-attention against the memory K/V.
  grid_linear(a.w_cq + (size_t)l * E * E, a.b_cq + (size_t)l * E, x1, q2, R, E, E, false, xs);
  grid.sync();
  for (int task = global_warp(); task < R * H; task += grid_warps()) {
    const int r = task / H, h = task % H;
    const float* mk = a.mem_k + ((size_t)l * R + r) * P * E + h * dh;
    const float* mv = a.mem_v + ((size_t)l * R + r) * P * E + h * dh;
    warp_attention(
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
  grid_add_ln(x2, ff, a.ln3_w + (size_t)l * E, a.ln3_b + (size_t)l * E, a.x_out, R, E);
}

int grid_size(size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_layer_kernel, kThreads, smem);
  return sms * (per_sm < 1 ? 1 : per_sm);  // all co-resident, as a cooperative launch needs
}

}  // namespace

extern "C" {

// Floats of scratch the caller allocates for one launch.
long long tc_decode_scratch_floats(int R, int E, int H, int F, int P) {
  return (long long)R * (11LL * E + F + (long long)H * P);
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
  if (E % H != 0 || (E / H) % 4 != 0 || E % 4 != 0 || F % 4 != 0 || E > 32 * kLnPerLane ||
      pos < 0 || pos >= T)
    return (int)cudaErrorInvalidValue;
  Args a{x_in, x_out, alpha, k_new, v_new, w_qkv, b_qkv, w_so, b_so, w_cq, b_cq,
         w_co, b_co, w_f1, b_f1, w_f2, b_f2, ln1_w, ln1_b, ln2_w, ln2_b, ln3_w,
         ln3_b, cache_k, cache_v, mem_k, mem_v, scratch, layer, L, R, T, P, E, H, F, pos};
  const int TP = T > P ? T : P;
  const size_t smem =
      sizeof(float) * ((size_t)kRT * (E > F ? E : F) + (size_t)kWarps * (E / H + TP));
  cudaError_t err = cudaFuncSetAttribute(
      decode_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      (void*)decode_layer_kernel, dim3(grid_size(smem)), dim3(kThreads), params, smem,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* tc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
