// A whole ConvNeXt block, forward, f32 and bf16, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_captioner/ops/block_fused.py:_kernel (launched
// by _fused_pallas under fused_convnext_block).  For x (B, H, W, C), NHWC,
// it computes
//
//     t   = dwconv7x7(x, dw_w) + dw_b         (stride 1, zero padding 3)
//     out = x + sd[b] * ((gelu(LN(t) W1^T + b1) W2^T + b2) * gamma)
//
// with LayerNorm eps 1e-6, the exact erf GELU, dw_w (7, 7, C), sd (B,) one
// stochastic-depth scale per image, W1 (4C, C) and W2 (C, 4C).
//
// What bounds it on the H100: the tail's two products, 16*N*C^2 flops at
// the f32-accurate tensor-core rate (3xTF32: 165 TFLOP/s), 7.61 ms per bs-32
// encoder pass; the conv adds 98*N*C flops, 98/(16*C) of them.  The TPU
// kernel exists to keep t out of device memory, and so does this one.
//
// The design: a sequence of launches on one stream, what the MLP-tail path
// runs (mlp_block.cu) with the conv folded into its LayerNorm launch.
// - conv_ln_kernel (here): t and LN(t) of every pixel, written straight
//   into the two TF32 planes (N, C) that the first product reads; t itself
//   never reaches device memory.  A pixel's LayerNorm needs all C channels,
//   a warp of the conv 32 channels of a 2 x 8 patch.  So a cluster of C /
//   128 blocks splits the channels: rank r convolves channels [128 r, 128 r
//   + 128) of every tile the cluster walks (th x 8 pixels of one image),
//   with the depthwise conv's consumers (dwconv_tile.cuh: 49 taps of the
//   lane's channel in registers, halo'd boxes by TMA through an mbarrier
//   ring, the padding zero-filled by the copy engine).  Each rank takes its
//   channels' mean and centred sum of squares of each pixel (two passes
//   over registers: warp sums, then the four channel groups in shared
//   memory), the ranks swap those two floats a pixel through distributed
//   shared memory, and each merges them as Chan et al. do (M2 = sum M2_r +
//   128 sum (mean_r - mean)^2): no one-pass sum of squares, which cancels
//   in f32, and no tile of t crosses the cluster.  The tile's values stay
//   in registers from the conv to the planes.
// - mlp_products.cuh: the weights' TF32 split and the two products on the
//   3xTF32 GEMM (tf32x3_gemm.cuh), as in the MLP-tail path: HiddenEpi
//   writes gelu(.) into h's planes, OutEpi adds x itself as the residual
//   with the image's scale sd[m / (H*W)].  Images with sd 0 come out as
//   their input bit for bit.
// Against the MLP-tail path plus the separate conv this saves t's write and
// read (8*N*C bytes a block, ~0.47 ms per bs-32 pass at 3.35 TB/s) and the
// LayerNorm launch.  The f32 FFMA tail (mlp_tail.cuh) that a single-launch
// version of this kernel ran is not used: its products ran at a third of
// the tensor cores' f32-accurate rate.
//
// The bf16 instance (tc_block_fused_forward_bf16): the TPU kernel on the
// operands the JAX bf16 encoder hands it (tpu_captioner/models/
// convnext.py:142-149): x, the taps, W1 and W2 bf16; the conv bias, the
// LayerNorm, b1, b2, the layer scale and sd f32; out bf16.  As the TPU
// kernel does (block_fused.py:64-71), the 49 products of bf16 values are
// summed in f32 and the f32 bias added, t is never rounded, and LayerNorm,
// products, GELU and residual run in f32; out is rounded to bf16 once.  So
// the ring holds bf16 boxes (half the bytes: the plan's slots are priced at
// 2 bytes an element), each value widened as the consumer reads it
// (dwconv_tile.cuh: conv_patch<bf16>), and the taps are widened once into
// registers.  Three launches, no weight split:
// - conv_ln_kernel<C, bf16> writes LN(t) * ln_w + ln_b as one f32 plane
//   (N, C): 6 N C bytes with x's bf16 read, where the TF32 planes took 10;
// - the MLP tail's bf16 whole tile's two products (mlp_block.cu:
//   whole_tile_x3) on bf16_gemm.cuh's x3::gemm: each f32 row value (the
//   plane, then h) split in registers into three exact bf16 pieces, three
//   register-A bf16 wgmma a k16 step on the bf16 weight read by TMA as it
//   lies, a fresh accumulator a 64-deep stage; HiddenEpiF32 writes h as one
//   f32 plane (N, 4C), OutEpi<bf16> reads x as the residual with the
//   image's scale sd[m / (H*W)] and rounds once.
// What bounds it: the products, 16*N*C^2 flops at the f32-accurate rate of
// a bf16 weight (three bf16 products per product, 989 / 3 = 329.67
// TFLOP/s), 3.81 ms per bs-32 encoder pass; the design's bytes (x read
// twice and out written in bf16, the plane's and h's f32 round trips, 46 N
// C a call) 2.7 ms.  The products run as the whole tile's do: the
// consumers split each A fragment and then wait for their wgmma (PERF.md,
// rows 1 and 9).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_gemm.cuh"
#include "dwconv_tile.cuh"
#include "mlp_products.cuh"
#include "warp_reduce.cuh"

namespace cg = cooperative_groups;

namespace {

// The plan's constants (ops/block_fused.py:block_plan; every number is
// re-checked here).
constexpr int kCc = 128;                // channels per block: four 32-channel groups
constexpr int kGroups = kCc / 32;
constexpr int kTw = kS;                 // tile columns: one warp patch across
constexpr int kBoxC = kTw + 2 * PAD;    // staged columns
constexpr int kMaxTh = 8;               // tile rows: at most 4 warp patches down
constexpr int kMaxP = kMaxTh * kTw;     // pixels a tile
constexpr int kMaxThreads = 32 * kGroups * (kMaxTh / kR);
constexpr int kMaxSlots = 4;
constexpr int kSmemMax = 232448;
constexpr int kHeader = 128 + 128;  // base alignment slack, then the mbarriers
// Shared floats beside the ring: the groups' sums, the rank's means, the
// swapped (mean, M2) pairs (two tiles' worth), the merged (mean, rstd).
constexpr int kSmall = kGroups * kMaxP + kMaxP + 2 * 2 * kMaxP + 2 * kMaxP;

struct Geom {
  int B, H, W, C;
  int th, slots, parts;
  int tiles_w, per_img, tiles;  // tiles across, per image, in all
  int per32, units;             // patches per 32 channels, consumer warps
  int slot_elems;               // elements (f32 or bf16) of a halo'd box
};

// A halo'd box of esize-byte elements.
__host__ __device__ inline int slot_bytes(int th, int esize) { return esize * (th + 2 * PAD) * kBoxC * kCc; }

// The plan's derived numbers for x of esize-byte elements; false if the
// plan breaks a rule of the kernel or disagrees with the shared memory it
// needs.
bool make_geom(Geom& g, int B, int H, int W, int C, int th, int tw, int cc, int cluster, int slots, int parts,
               int smem, int esize) {
  if (B < 1 || H < 1 || W < 1 || cc != kCc || tw != kTw || C % kCc || C / kCc != cluster || cluster > 8)
    return false;
  if (th < kR || th > kMaxTh || th % kR || slots < 2 || slots > kMaxSlots || parts < 1) return false;
  g.B = B, g.H = H, g.W = W, g.C = C, g.th = th, g.slots = slots, g.parts = parts;
  g.tiles_w = (W + kTw - 1) / kTw;
  g.per_img = (H + th - 1) / th * g.tiles_w;
  g.tiles = B * g.per_img;
  g.per32 = th / kR;
  g.units = kGroups * g.per32;
  g.slot_elems = slot_bytes(th, esize) / esize;
  const long long need = kHeader + 4LL * kSmall + (long long)slots * slot_bytes(th, esize);
  return need <= kSmemMax && need == smem && (long long)parts * cluster <= 65535;
}

// grid (parts x C / 128 blocks), clusters of C / 128 along x; 32 * units
// threads, every warp a consumer.  Thread 0 also issues the ring's copies.
// x and the taps of T: f32, with LN(t) written as its two TF32 planes
// (N, C) for the 3xTF32 products, or bf16 (widened as read), with LN(t)
// written as one f32 plane (N, C) for the three-piece products.
template <int C, class T>
__global__ void __launch_bounds__(kMaxThreads, 1)
    conv_ln_kernel(const __grid_constant__ CUtensorMap xmap, const T* __restrict__ dww,
                   const float* __restrict__ dwb, const float* __restrict__ lnw, const float* __restrict__ lnb,
                   float* __restrict__ planes, Geom g) {
  constexpr int S = C / kCc;
  float* base = smem_base();
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  float* red = base + 32;  // (kGroups, kMaxP)
  float* mean_l = red + kGroups * kMaxP;
  float2* xchg = reinterpret_cast<float2*>(mean_l + kMaxP);  // (2, kMaxP)
  float2* stats = xchg + 2 * kMaxP;
  T* ring = reinterpret_cast<T*>(stats + kMaxP);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int rank = 0;
  if constexpr (S > 1) rank = (int)cg::this_cluster().block_rank();
  const int part = blockIdx.x / S, c = rank * kCc + warp / g.per32 * 32 + lane;
  const int n_local = part < g.tiles ? (g.tiles - part + g.parts - 1) / g.parts : 0;
  const int pixels = g.th * kTw, box_bytes = slot_bytes(g.th, sizeof(T));
  const Unit u = unit_of(g.per32, 1, warp, lane);
  const long long plane = (long long)g.B * g.H * g.W * C;

  auto origin = [&](int i, int& b, int& h0, int& w0) {
    const int t = part + i * g.parts, r = t % g.per_img;
    b = t / g.per_img, h0 = r / g.tiles_w * g.th, w0 = r % g.tiles_w * kTw;
  };
  auto fetch = [&](int i) {  // tile i's halo'd box of this rank's channels into slot i % slots
    int b, h0, w0;
    origin(i, b, h0, w0);
    const int s = i % g.slots;
    mbar_expect_tx(&full[s], box_bytes);
    tma_load_4d(ring + s * g.slot_elems, &xmap, rank * kCc, w0 - PAD, h0 - PAD, b, &full[s]);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < g.slots; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < g.slots && i < n_local; ++i) fetch(i);

  float wr[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) wr[t] = to_f32(dww[t * C + c]);
  const float bias = __ldg(dwb + c), ln_w = __ldg(lnw + c), ln_b = __ldg(lnb + c);
  // The tile pixel of this lane's sums after reduce_scatter16: value (lane
  // >> 1) & 15 of the patch, row / kS down and % kS across.
  const int mine = (lane >> 1) & 15, my_pixel = (u.prow + mine / kS) * kTw + mine % kS;

  for (int i = 0; i < n_local; ++i) {
    const int s = i % g.slots;
    mbar_wait(&full[s], (i / g.slots) & 1);
    float acc[kR][kS];
    conv_patch(ring + s * g.slot_elems + u.prow * kBoxC * kCc + u.lc, kBoxC, kCc, wr, acc);
    float t[kR * kS], v[kR * kS];
#pragma unroll
    for (int k = 0; k < kR * kS; ++k) v[k] = t[k] = acc[k / kS][k % kS] + bias;

    // Pass 1: the mean of each pixel over this rank's 128 channels.
    reduce_scatter16(v, lane);
    if (!(lane & 1)) red[warp / g.per32 * kMaxP + my_pixel] = v[0];
    __syncthreads();  // the slot is consumed and the groups' sums are in
    if (threadIdx.x == 0 && i + g.slots < n_local) {
      fence_proxy_async_shared();  // the consumers' reads of the slot come before the copy's writes
      fetch(i + g.slots);
    }
    if (threadIdx.x < pixels) {
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < kGroups; ++q) sum += red[q * kMaxP + threadIdx.x];
      mean_l[threadIdx.x] = sum * (1.0f / kCc);
    }
    __syncthreads();

    // Pass 2: the centred sum of squares about that mean.
#pragma unroll
    for (int k = 0; k < kR * kS; ++k) {
      const float d = t[k] - mean_l[(u.prow + k / kS) * kTw + k % kS];
      v[k] = d * d;
    }
    reduce_scatter16(v, lane);
    if (!(lane & 1)) red[warp / g.per32 * kMaxP + my_pixel] = v[0];
    __syncthreads();
    float2* mine_x = xchg + (i & 1) * kMaxP;  // two tiles' buffers: see the barrier below
    if (threadIdx.x < pixels) {
      float m2 = 0.f;
#pragma unroll
      for (int q = 0; q < kGroups; ++q) m2 += red[q * kMaxP + threadIdx.x];
      mine_x[threadIdx.x] = make_float2(mean_l[threadIdx.x], m2);
    }
    // Every rank's pairs are in.  A rank writes buffer i & 1 again at tile
    // i + 2, after this barrier of tile i + 1, which no rank passes before
    // it has read tile i's pairs.
    if constexpr (S > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
    if (threadIdx.x < pixels) {
      float2 p[S];
#pragma unroll
      for (int r = 0; r < S; ++r) {
        if constexpr (S > 1)
          p[r] = cg::this_cluster().map_shared_rank(mine_x, r)[threadIdx.x];
        else
          p[r] = mine_x[threadIdx.x];
      }
      float mean = 0.f;
#pragma unroll
      for (int r = 0; r < S; ++r) mean += p[r].x;
      mean *= 1.0f / S;
      float m2 = 0.f;
#pragma unroll
      for (int r = 0; r < S; ++r) {
        const float d = p[r].x - mean;
        m2 += p[r].y + kCc * (d * d);
      }
      stats[threadIdx.x] = make_float2(mean, rsqrtf(m2 * (1.0f / C) + kLnEps));
    }
    __syncthreads();

    int b, h0, w0;
    origin(i, b, h0, w0);
#pragma unroll
    for (int k = 0; k < kR * kS; ++k) {
      const int h = h0 + u.prow + k / kS, w = w0 + k % kS;
      if (h >= g.H || w >= g.W) continue;
      const float2 st = stats[(u.prow + k / kS) * kTw + k % kS];
      const size_t at = (((size_t)b * g.H + h) * g.W + w) * C + c;
      const float v = (t[k] - st.x) * st.y * ln_w + ln_b;
      if constexpr (sizeof(T) == 2)
        planes[at] = v;
      else
        tf32x3::store_split(planes, plane, at, v);
    }
  }
  if constexpr (S > 1) cg::this_cluster().sync();  // peers may still be reading this block's pairs
}

bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

cudaLaunchConfig_t conv_ln_config(const Geom& g, int smem, int cluster, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.parts * cluster);
  cfg.blockDim = dim3(32 * g.units);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

template <int C, class T>
cudaError_t allow_smem() {
  static bool done = false;  // set once per instance, not at every launch
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(conv_ln_kernel<C, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kSmemMax);
  done = err == cudaSuccess;
  return err;
}

// The bf16 instance's workspace (floats): LN(t) * ln_w + ln_b as one f32
// plane (N C), then h (4 N C f32).
struct PlanX3 {
  long long xs, h, total;
};

inline PlanX3 make_plan_x3(int n, int c) {
  PlanX3 p;
  const long long nc = (long long)n * c;
  p.xs = 0;
  p.h = round32(nc);
  p.total = p.h + round32(4 * nc);
  return p;
}

// x, the taps, the weights and out of T (f32, or bf16: the bf16 instance).
template <int C, class T>
int forward(const T* x, const float* sd, const T* dww, const float* dwb, const float* lnw, const float* lnb,
            const T* w1, const float* b1, const T* w2, const float* b2, const float* gamma, T* out, float* work,
            const Geom& g, int smem, cudaStream_t s) {
  constexpr bool kX3 = sizeof(T) == 2;
  const int n = g.B * g.H * g.W;
  CUtensorMap xmap = {};
  cudaError_t err = bind_device(x);
  if (err == cudaSuccess) err = nhwc_map(&xmap, x, g.B, g.H, g.W, C, kCc, kBoxC, g.th + 2 * PAD, sizeof(T));
  if (err == cudaSuccess) err = allow_smem<C, T>();
  if constexpr (!kX3)
    if (err == cudaSuccess) err = split_weights<C>(w1, w2, work, n, s);
  if (err != cudaSuccess) return (int)err;
  float* planes = work + (kX3 ? make_plan_x3(n, C).xs : make_plan(n, C).xs);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = conv_ln_config(g, smem, C / kCc, s, attr);
  err = cudaLaunchKernelEx(&cfg, conv_ln_kernel<C, T>, xmap, dww, dwb, lnw, lnb, planes, g);
  if (err == cudaSuccess) err = cudaGetLastError();
  if constexpr (kX3) {
    // The tail's products on the bf16 weights as they lie: h = gelu(LN(t)
    // W1^T + b1) as one f32 plane, then out = x + sd[image] * (...).
    namespace x3 = bf16mm::x3;
    float* h = work + make_plan_x3(n, C).h;
    if (err == cudaSuccess) err = x3::gemm<0>(planes, w1, n, C, 4 * C, x3::RowsA{}, HiddenEpiF32{b1, h, 4 * C}, s);
    if (err == cudaSuccess)
      err = x3::gemm<0>(h, w2, n, 4 * C, C, x3::RowsA{}, OutEpi<T>{x, sd, g.H * g.W, b2, gamma, out, C}, s);
  } else {
    if (err == cudaSuccess) err = products<C>(x, sd, g.H * g.W, b1, b2, gamma, out, work, n, s);
  }
  return (int)err;
}

template <int C, class T>
int active_clusters(int units, int smem) {
  cudaError_t err = allow_smem<C, T>();
  if (err != cudaSuccess) return -(int)err;
  Geom g = {};
  g.parts = 1, g.units = units;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = conv_ln_config(g, smem, C / kCc, nullptr, attr);
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, conv_ln_kernel<C, T>, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

// The plan checked, then the instance of width C.
template <class T>
int dispatch(const T* x, const float* sd, const T* dww, const float* dwb, const float* lnw, const float* lnb,
             const T* w1, const float* b1, const T* w2, const float* b2, const float* gamma, T* out, float* work,
             int B, int H, int W, int C, int th, int tw, int cc, int cluster, int slots, int parts, int smem,
             void* stream) {
  Geom g;
  if (!make_geom(g, B, H, W, C, th, tw, cc, cluster, slots, parts, smem, sizeof(T)) || !aligned16(x))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TC_ARGS x, sd, dww, dwb, lnw, lnb, w1, b1, w2, b2, gamma, out, work, g, smem, s
  switch (C) {
    case 128: return forward<128>(TC_ARGS);
    case 256: return forward<256>(TC_ARGS);
    case 512: return forward<512>(TC_ARGS);
    case 1024: return forward<1024>(TC_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TC_ARGS
}

template <class T>
int clusters_of(int c, int units, int smem) {
  switch (c) {
    case 128: return active_clusters<128, T>(units, smem);
    case 256: return active_clusters<256, T>(units, smem);
    case 512: return active_clusters<512, T>(units, smem);
    case 1024: return active_clusters<1024, T>(units, smem);
    default: return -(int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Floats of workspace the forward needs for n = B*H*W pixels of width c
// and x of esize-byte elements: f32 (4), the LayerNorm's and h's TF32
// planes and the weights' splits; bf16 (2), the LayerNorm rows and h as one
// f32 plane each; -1 for another esize.
long long tc_block_fused_workspace(int n, int c, int esize) {
  return esize == 4 ? make_plan(n, c).total : esize == 2 ? make_plan_x3(n, c).total : -1;
}

// out = the block of x (B, H, W, C); work holds tc_block_fused_workspace(B
// * H * W, C, 4) floats.  (th, tw, cc, cluster, slots, parts, smem) is
// ops/block_fused.py:block_plan(B, H, W, C); a plan that breaks a rule, a
// width other than 128, 256, 512 or 1024, or an x off a 16-byte boundary
// returns cudaErrorInvalidValue without a launch.  Five launches on
// `stream`: the weights' two splits, the conv + LayerNorm, the two products.
int tc_block_fused_forward(const float* x, const float* sd, const float* dww, const float* dwb,
                           const float* lnw, const float* lnb, const float* w1, const float* b1,
                           const float* w2, const float* b2, const float* gamma, float* out, float* work,
                           int B, int H, int W, int C, int th, int tw, int cc, int cluster, int slots, int parts,
                           int smem, void* stream) {
  return dispatch(x, sd, dww, dwb, lnw, lnb, w1, b1, w2, b2, gamma, out, work, B, H, W, C, th, tw, cc, cluster,
                  slots, parts, smem, stream);
}

// The bf16 instance: x, dww, w1, w2 and out bf16, the rest f32, as
// tc_block_fused_forward; the plan is block_plan(..., esize=2), the
// workspace tc_block_fused_workspace(B * H * W, C, 2) floats.  Three
// launches: the conv + LayerNorm, the two three-piece products.
int tc_block_fused_forward_bf16(const void* x, const float* sd, const void* dww, const float* dwb,
                                const float* lnw, const float* lnb, const void* w1, const float* b1,
                                const void* w2, const float* b2, const float* gamma, void* out, float* work,
                                int B, int H, int W, int C, int th, int tw, int cc, int cluster, int slots, int parts,
                                int smem, void* stream) {
  using bf = __nv_bfloat16;
  return dispatch(static_cast<const bf*>(x), sd, static_cast<const bf*>(dww), dwb, lnw, lnb,
                  static_cast<const bf*>(w1), b1, static_cast<const bf*>(w2), b2, gamma, static_cast<bf*>(out), work,
                  B, H, W, C, th, tw, cc, cluster, slots, parts, smem, stream);
}

// How many clusters of C / 128 conv + LayerNorm blocks of `units` warps and
// smem bytes the card runs at once (cudaOccupancyMaxActiveClusters), for x
// of esize-byte elements (4: f32, 2: the bf16 instance), or minus a
// cudaError_t.
int tc_block_fused_clusters(int c, int units, int smem, int esize) {
  if (units < 1 || 32 * units > kMaxThreads || smem > kSmemMax || (esize != 2 && esize != 4))
    return -(int)cudaErrorInvalidValue;
  return esize == 2 ? clusters_of<__nv_bfloat16>(c, units, smem) : clusters_of<float>(c, units, smem);
}

const char* tc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
