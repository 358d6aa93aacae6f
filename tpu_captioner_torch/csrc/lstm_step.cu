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
// What bounds it on the H100: bytes.  At E = D = A = 512, C = 1024, P = 49
// the weights are 19.9 MB and each row brings 301 KB of enc and att1, for
// about 5.0 M multiply-adds per row: at R = 40 (8 images x beam 5) 32 MB
// against 0.41 GFLOP, 9.6 us of memory traffic against 6 us of f32 FMA.
//
// What the design does about it: the TPU kernel tiles rows with every
// weight resident in VMEM; here the whole step is one cooperative launch
// over every co-resident block, in four phases with a grid barrier between
// each two, each phase spreading its work over the whole card:
// 1. the products of h and emb: a block task is kRT rows x 32 output
//    columns of [wd | wfb | w_hh], the gate columns adding emb w_ih_e; the
//    block stages its rows of h and emb in shared memory, each warp loads
//    the weight rows of its 4 columns (contiguous k, lanes on consecutive
//    k) with all loads of a chunk in flight, and a reduce-scatter of
//    shuffles sums the lanes.  Each weight is read once per kRT rows;
// 2. the scores, one warp per (row, pixel), lanes over A;
// 3. per (row, 256 channels) block task: the softmax of the row's P scores
//    in shared memory, then one thread per channel for the context and its
//    gate (alpha is written by the first task of a row);
//    phases 2 and 3 keep kInFlight loads per lane in flight: a loop of
//    dependent loads waits out the memory latency once per element;
// 4. the products of the gated context with w_ih_c, each warp owning one
//    hidden unit d and its four gate rows d, D + d, 2D + d, 3D + d, so that
//    the LSTM cell runs in the same warp: partial gate sums from phase 1
//    added, c' and h' written.
// Two blocks of 256 threads per SM (at most 128 registers a thread), so
// that one block's products overlap the other's loads.
// Loads are scalar, so no width needs an alignment: E is free (300 for
// word2vec, 200 for GloVe) and so are D, A and C.  Scratch buffers written
// in one phase are read only in later ones, past L1 (__ldcg); the grid
// barrier orders the writes before the reads.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "warp_reduce.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRT = 16;        // rows per product task
constexpr int kCG = 4;         // output columns per warp in a product task
constexpr int kKChunk = 128;   // k values whose weights a warp loads at once
constexpr int kInFlight = 8;   // loads a lane keeps in flight in the attention phases
constexpr int kChannels = kThreads;  // context channels per phase-3 task
static_assert(kRT * kCG == 64, "the reduce-scatter sums 64 outputs per warp");

struct Args {
  const float *emb, *h, *c, *enc, *att1;  // (R, E), (R, D), (R, D), (R, P, C), (R, P, A)
  const float *wd, *bd;                   // (A, D), (A)
  const float *wfull, *bfull;             // (A), (1)
  const float *wfb, *bfb;                 // (C, D), (C)
  const float *w_ih_e, *w_ih_c, *w_hh, *b;  // (4D, E), (4D, C), (4D, D), (4D)
  float *h_out, *c_out, *alpha;           // (R, D), (R, D), (R, P)
  float *att2, *fb, *gates, *score, *gctx;  // scratch (R, A), (R, C), (R, 4D), (R, P), (R, C)
  int R, E, D, A, C, P;
};

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Rows r0 .. r0 + kRT - 1 of in (R, K) into xs (kRT x K), zeros past R.
// `in` may have been written earlier in this launch: read past L1.
__device__ void stage_rows(const float* in, int R, int K, int r0, float* xs) {
  for (int i = threadIdx.x; i < kRT * K; i += kThreads) {
    const int r = r0 + i / K;
    xs[i] = r < R ? __ldcg(in + (size_t)r * K + i % K) : 0.f;
  }
}

// v[r * kCG + j] += xs[r] . w[j] over k < K for the kRT staged rows xs
// (row stride K) and this warp's kCG weight rows w[j] (null: zero).  Lanes
// take consecutive k; each lane keeps its partial sums.
__device__ __forceinline__ void accumulate(const float* xs, int K, const float* const* w, float* v) {
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < K; k0 += kKChunk) {
    float wv[kKChunk / 32][kCG];
#pragma unroll
    for (int i = 0; i < kKChunk / 32; ++i) {
      const int k = k0 + 32 * i + lane;
#pragma unroll
      for (int j = 0; j < kCG; ++j) wv[i][j] = k < K && w[j] ? __ldg(w[j] + k) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
#pragma unroll
      for (int i = 0; i < kKChunk / 32; ++i) {
        const int k = k0 + 32 * i + lane;
        const float x = k < K ? xs[r * K + k] : 0.f;
#pragma unroll
        for (int j = 0; j < kCG; ++j) v[r * kCG + j] = fmaf(x, wv[i][j], v[r * kCG + j]);
      }
    }
  }
}

// Phase 1: att2 = h wd^T + bd, fb = h wfb^T + bfb and the gates' partial
// sums emb w_ih_e^T + h w_hh^T + b, over the joint column space
// [0, A) | [A, A + C) | [A + C, A + C + 4D).
__device__ __noinline__ void phase_h_products(const Args& a, float* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = 4 * a.D, N = a.A + a.C + G;
  const int ncb = (N + kCG * kWarps - 1) / (kCG * kWarps), nrt = (a.R + kRT - 1) / kRT;
  float* xh = smem;               // kRT x D
  float* xe = smem + kRT * a.D;   // kRT x E
  for (int task = blockIdx.x; task < ncb * nrt; task += gridDim.x) {
    const int r0 = (task / ncb) * kRT, c0 = (task % ncb) * kCG * kWarps + warp * kCG;
    __syncthreads();  // the previous task's readers of the staged rows are done
    stage_rows(a.h, a.R, a.D, r0, xh);
    stage_rows(a.emb, a.R, a.E, r0, xe);
    __syncthreads();
    if (c0 >= N) continue;
    const float* wh[kCG];
    const float* we[kCG];
    bool any_gate = false;
#pragma unroll
    for (int j = 0; j < kCG; ++j) {
      const int n = c0 + j, g = n - a.A - a.C;
      wh[j] = n >= N ? nullptr
              : n < a.A ? a.wd + (size_t)n * a.D
              : g < 0   ? a.wfb + (size_t)(n - a.A) * a.D
                        : a.w_hh + (size_t)g * a.D;
      we[j] = n < N && g >= 0 ? a.w_ih_e + (size_t)g * a.E : nullptr;
      any_gate |= we[j] != nullptr;
    }
    float v[kRT * kCG];
#pragma unroll
    for (int i = 0; i < kRT * kCG; ++i) v[i] = 0.f;
    accumulate(xh, a.D, wh, v);
    if (any_gate) accumulate(xe, a.E, we, v);  // the same for the whole warp
    reduce_scatter64(v, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int flat = 2 * lane + i, r = r0 + flat / kCG, n = c0 + flat % kCG;
      if (r >= a.R || n >= N) continue;
      if (n < a.A) {
        a.att2[(size_t)r * a.A + n] = v[i] + a.bd[n];
      } else if (n < a.A + a.C) {
        a.fb[(size_t)r * a.C + n - a.A] = v[i] + a.bfb[n - a.A];
      } else {
        const int g = n - a.A - a.C;
        a.gates[(size_t)r * G + g] = v[i] + a.b[g];
      }
    }
  }
}

// Phase 2: score[r, p] = relu(att1[r, p] + att2[r]) . wfull + bfull, one
// warp per (row, pixel); consecutive warps sit on different blocks.
__device__ __noinline__ void phase_scores(const Args& a) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kWarps;
  const float bfull = a.bfull[0];
  for (int pair = (threadIdx.x >> 5) * gridDim.x + blockIdx.x; pair < a.R * a.P; pair += warps) {
    const int r = pair / a.P;
    const float* e1 = a.att1 + (size_t)pair * a.A;
    const float* e2 = a.att2 + (size_t)r * a.A;
    float s = 0.f;
    for (int i0 = lane; i0 < a.A; i0 += 32 * kInFlight) {
      float x1[kInFlight], x2[kInFlight], wf[kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        const int i = i0 + 32 * j;
        x1[j] = i < a.A ? __ldg(e1 + i) : 0.f;
        x2[j] = i < a.A ? __ldcg(e2 + i) : 0.f;
        wf[j] = i < a.A ? __ldg(a.wfull + i) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) s = fmaf(fmaxf(x1[j] + x2[j], 0.f), wf[j], s);
    }
    s = warp_sum(s);
    if (lane == 0) a.score[pair] = s + bfull;
  }
}

// Phase 3: alpha = softmax(score[r]) and gctx[r, c] = sigmoid(fb[r, c]) *
// sum_p alpha_p enc[r, p, c], a block task per (row, kChannels channels).
__device__ __noinline__ void phase_context(const Args& a, float* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nch = (a.C + kChannels - 1) / kChannels;
  float* sa = smem;  // P probabilities
  for (int task = blockIdx.x; task < a.R * nch; task += gridDim.x) {
    const int r = task / nch, c = (task % nch) * kChannels + threadIdx.x;
    __syncthreads();  // the previous task's readers of sa are done
    if (warp == 0) {
      const float* sr = a.score + (size_t)r * a.P;
      float mx = -INFINITY;
      for (int p = lane; p < a.P; p += 32) mx = fmaxf(mx, __ldcg(sr + p));
      mx = warp_max(mx);
      float sum = 0.f;
      for (int p = lane; p < a.P; p += 32) {
        const float e = expf(__ldcg(sr + p) - mx);
        sa[p] = e;
        sum += e;
      }
      const float inv = 1.0f / warp_sum(sum);
      for (int p = lane; p < a.P; p += 32) sa[p] *= inv;
    }
    __syncthreads();
    if (task % nch == 0)
      for (int p = threadIdx.x; p < a.P; p += kThreads) a.alpha[(size_t)r * a.P + p] = sa[p];
    if (c < a.C) {
      const float* er = a.enc + (size_t)r * a.P * a.C + c;
      float ctx = 0.f;
      for (int p0 = 0; p0 < a.P; p0 += kInFlight) {
        float e[kInFlight];
#pragma unroll
        for (int j = 0; j < kInFlight; ++j) e[j] = p0 + j < a.P ? __ldg(er + (size_t)(p0 + j) * a.C) : 0.f;
#pragma unroll
        for (int j = 0; j < kInFlight; ++j)
          if (p0 + j < a.P) ctx = fmaf(sa[p0 + j], e[j], ctx);
      }
      a.gctx[(size_t)r * a.C + c] = sigmoid(__ldcg(a.fb + (size_t)r * a.C + c)) * ctx;
    }
  }
}

// Phase 4: gates += gctx w_ih_c^T, then the cell.  A block task is kRT rows
// x kWarps hidden units; warp w owns unit d and its gate rows g * D + d.
__device__ __noinline__ void phase_cell(const Args& a, float* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = a.D, ndb = (D + kWarps - 1) / kWarps, nrt = (a.R + kRT - 1) / kRT;
  float* xs = smem;                                          // kRT x C
  float* tile = smem + kRT * a.C + warp * kRT * kCG;        // this warp's kRT x 4 sums
  for (int task = blockIdx.x; task < ndb * nrt; task += gridDim.x) {
    const int r0 = (task / ndb) * kRT, d = (task % ndb) * kWarps + warp;
    __syncthreads();
    stage_rows(a.gctx, a.R, a.C, r0, xs);
    __syncthreads();
    if (d >= D) continue;
    const float* w[kCG];
#pragma unroll
    for (int j = 0; j < kCG; ++j) w[j] = a.w_ih_c + (size_t)(j * D + d) * a.C;
    float v[kRT * kCG];
#pragma unroll
    for (int i = 0; i < kRT * kCG; ++i) v[i] = 0.f;
    accumulate(xs, a.C, w, v);
    reduce_scatter64(v, lane);
    tile[2 * lane] = v[0];
    tile[2 * lane + 1] = v[1];
    __syncwarp();
    const int r = r0 + lane;
    if (lane < kRT && r < a.R) {
      const float* gp = a.gates + (size_t)r * 4 * D + d;
      const float gi = tile[lane * kCG + 0] + __ldcg(gp);
      const float gf = tile[lane * kCG + 1] + __ldcg(gp + D);
      const float gg = tile[lane * kCG + 2] + __ldcg(gp + 2 * D);
      const float go = tile[lane * kCG + 3] + __ldcg(gp + 3 * D);
      const float c_new = sigmoid(gf) * a.c[(size_t)r * D + d] + sigmoid(gi) * tanhf(gg);
      a.c_out[(size_t)r * D + d] = c_new;
      a.h_out[(size_t)r * D + d] = sigmoid(go) * tanhf(c_new);
    }
    __syncwarp();  // the tile's readers are done before the next task writes it
  }
}

__global__ void __launch_bounds__(kThreads, 2) lstm_step_kernel(Args a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  phase_h_products(a, smem);
  grid.sync();
  phase_scores(a);
  grid.sync();
  phase_context(a, smem);
  grid.sync();
  phase_cell(a, smem);
}

size_t smem_floats(int E, int D, int C, int P) {
  const size_t products = (size_t)kRT * (D + E);
  const size_t cell = (size_t)kRT * C + (size_t)kWarps * kRT * kCG;
  const size_t m = products > cell ? products : cell;
  return m > (size_t)P ? m : (size_t)P;
}

long long round4(long long n) { return (n + 3) / 4 * 4; }

}  // namespace

extern "C" {

// Floats of scratch the caller allocates for one launch.
long long tc_lstm_scratch_floats(int R, int D, int A, int C, int P) {
  return round4((long long)R * A) + 2 * round4((long long)R * C) + round4(4LL * R * D) +
         round4((long long)R * P);
}

// Dynamic shared memory of a launch, in bytes.
long long tc_lstm_smem_bytes(int E, int D, int C, int P) {
  return (long long)(sizeof(float) * smem_floats(E, D, C, P));
}

int tc_lstm_step(const float* emb, const float* h, const float* c, const float* enc,
                 const float* att1, const float* wd, const float* bd, const float* wfull,
                 const float* bfull, const float* wfb, const float* bfb, const float* w_ih_e,
                 const float* w_ih_c, const float* w_hh, const float* b, float* h_out,
                 float* c_out, float* alpha, float* scratch, int R, int E, int D, int A, int C,
                 int P, void* stream) {
  if (R < 1 || E < 1 || D < 1 || A < 1 || C < 1 || P < 1) return (int)cudaErrorInvalidValue;
  Args a{emb, h, c, enc, att1, wd, bd, wfull, bfull, wfb, bfb, w_ih_e, w_ih_c, w_hh, b,
         h_out, c_out, alpha, nullptr, nullptr, nullptr, nullptr, nullptr, R, E, D, A, C, P};
  float* s = scratch;
  a.att2 = s;
  s += round4((long long)R * A);
  a.fb = s;
  s += round4((long long)R * C);
  a.gates = s;
  s += round4(4LL * R * D);
  a.score = s;
  s += round4((long long)R * P);
  a.gctx = s;
  const void* kernel = reinterpret_cast<const void*>(lstm_step_kernel);
  const size_t smem = sizeof(float) * smem_floats(E, D, C, P);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(sms * per_sm), dim3(kThreads), params, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* tc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
