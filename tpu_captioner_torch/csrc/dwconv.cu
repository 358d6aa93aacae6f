// The ConvNeXt block's 7x7 depthwise convolution, NHWC, stride 1, pad 3, f32,
// for Hopper (sm_90a): the forward (also the input gradient, with the filter
// flipped), with an optional bias, and the filter gradient, with an optional
// bias gradient; and both kernels' bf16 instances, for the bf16 encoder.
//
// Replaces two TPU kernels of tpu_captioner/ops/dwconv.py:
// - _dw_kernel (:37) -> dwconv_fwd_kernel:
//     y[b,h,w,c] = sum_{dy,dx} x_pad[b,h+dy,w+dx,c] * w[dy,dx,c] (+ bias[c])
//   With flip = 1 it reads w[6-dy, 6-dx]: the input gradient of the conv is
//   the same conv of the cotangent with the flipped filter
//   (ops/dwconv.py:_DepthwiseConv.backward); that launch takes no bias.
// - _dwg_kernel (:97) -> dwconv_wgrad_kernel:
//     dw[dy,dx,c] = sum_{b,h,w} x_pad[b,h+dy,w+dx,c] * g[b,h,w,c]
//     d_bias[c]   = sum_{b,h,w} g[b,h,w,c]              (when asked for)
//   _dw_kernel's bf16 arm (bf16 x and filter, f32 sums, a bf16 output) ->
//   dwconv_fwd_kernel<__nv_bfloat16, ...>: the same kernel with bf16 boxes
//   and filter in shared memory (TMA copies them as they are stored; C % 8
//   == 0), widened to f32 as the consumers read them, and the JAX block's
//   two roundings in the epilogue: y = bf16(bf16(sum) + bias)
//   (tpu_captioner/models/convnext.py:154-155).  Half the bytes of the f32
//   forward, and the same 49 multiply-adds.  With flip = 1 and no bias it
//   is the bf16 block's input gradient, conv(g, flipped w) rounded once
//   (tpu_captioner/ops/dwconv.py:174-181 on bf16 operands).
//   _dwg_kernel's bf16 arm (bf16 x and g, f32 sums, an f32 result that the
//   caller rounds to bf16 once, as `.astype(w.dtype)` at :180 does) ->
//   dwconv_wgrad_kernel<__nv_bfloat16, ...>: bf16 x and g boxes by TMA,
//   widened as the consumers read them, the same f32 sums in the same
//   fixed order, the bias gradient beside them; dw and db written in f32.
//   Half the bytes of the f32 gradient, the same FMAs: at stages 3 and 4
//   its 98 FLOP an output at 67 TFLOP/s outlast its bytes.
//
// What bounds them on the H100: bytes.  The forward moves each input and
// output value once and does 49 multiply-adds per output: a bs-32 encoder
// pass (36 convolutions) moves about 1.56 GB against 19 GFLOP, 0.47 ms at
// 3.35 TB/s against 0.29 ms at 67 TFLOP/s, so the FMAs are not free either:
// at stage 3 they take 70% of the time the bytes take.  The filter gradient
// reads x and g once, 0.96 GB per fine-tune step (30 convolutions; bf16 half
// of it, and then the FMAs, 0.175 ms a step, bound it).  On an
// H100 80GB HBM3 (700 W) at stage 3, bs 32, copies of these kernels that
// issue no tile copies ran 95% (forward) and 82% (filter gradient) as long
// as they do, copies with a seventh of the FMAs 66% (scripts/dwconv_probe.py
// split): the consumers' instruction issue, not the bytes, sets the pace.
//
// The design (the plan is ops/dwconv.py:dwconv_plan, re-checked here):
// - Tiles.  A tile is (image, th x tw output pixels, cc channels).  Images
//   of at most 16 x 16 (stages 3 and 4) are one tile, so the 3-pixel halo
//   lies outside the image; larger ones take 16 x 16 tiles (halo'd box 22 x
//   22: 1.89x the tile).  A block owns one channel chunk and walks its
//   tiles (part, part + parts, ...), so it reads its filter slice once.
// - TMA.  One producer thread fetches each tile's halo'd box with a 4-D
//   tensor map over NHWC (C, W, H, B) at signed start (c0, w0-3, h0-3, b):
//   the copy engine zero-fills the padding and the image edge and reads
//   none of it.  Boxes land in a ring of 2-4 slots on mbarriers ("full":
//   the box arrived; "empty": every consumer lane is done with it), so the
//   next tiles' copies overlap this tile's FMAs.  The filter slice (49 x cc)
//   comes once, by a 2-D map.  C % 4 != 0 or an unaligned pointer takes the
//   same kernel with the producer warp's own loads into the same ring
//   (kTma = false), chosen by the plan.
// - Consumers.  Each consumer warp owns one unit of every tile: 32 channels
//   (one per lane) x a 2 x 8 output patch.  The forward keeps the lane's 49
//   taps in registers for the whole block and reads each of the 8 x 14
//   staged inputs once per patch (7 FMAs per shared load); the gradient
//   keeps the 49 tap sums (and the bias sum) in registers and reads the
//   patch's 2 x 8 cotangents and 8 x 14 inputs once.  Up to 16 consumer
//   warps and the producer warp: 17 warps on an SM.
// - The filter gradient in one launch.  The tiles of a channel chunk are
//   split over a cluster of up to 8 blocks (the plan takes the largest size
//   whose clusters all run at once: a cluster's blocks share a GPC).  A
//   block sums its warps' registers through shared memory in a fixed order,
//   and rank r of the cluster sums the r-th slice of the blocks' (50, cc)
//   sums through distributed shared memory in rank order and writes it.  No
//   atomics and no scratch in device memory: the same bits on every run.
// - Instances.  The main path's (chunk, tile columns) get TMA instances of
//   their own, so that every shared-memory offset of the inner loop is an
//   immediate; other shapes take a TMA instance with both at run time, and
//   C % 4 != 0 (C % 8 in bf16) or an unaligned pointer the instance without
//   TMA.  Each kernel has them for f32 and for bf16 elements.
// - Shared.  The tensor map, the consumer warp's patch and bind_device sit
//   in dwconv_tile.cuh, which the whole-block kernel's conv + LayerNorm
//   launch (block_fused.cu) runs too.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dwconv_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = kTaps + 1;  // the filter gradient's rows: 49 taps, then the bias
constexpr int kMaxTile = 16;      // tile rows and columns: at most 16 (TMA boxes of at most 22)
constexpr int kMaxWarps = 16;     // consumer warps per block
constexpr int kMaxThreads = 32 * (kMaxWarps + 1);
constexpr int kMaxSlots = 4;
constexpr int kMaxCluster = 8;  // filter-gradient blocks per channel chunk: a portable cluster
constexpr int kSmemMax = 232448;
constexpr int kHeader = 128 + 256;  // base alignment slack, then the barriers

// Bytes of a shared-memory region holding n bytes: 128 bytes of slack (lanes
// past cc read, and ignore, up to 31 elements past the last pixel), rounded
// to 128 bytes (TMA destinations).
int region(long long n) { return (int)((n + 128 + 127) / 128 * 128); }

// The launch's shape, from the plan; the regions in elements of the staged
// type (floats, or bf16 in the bf16 instances) unless named.
struct Geom {
  int B, H, W, C;
  int th, tw, cc, slots, parts;
  int tiles_w, per_img, tiles;  // tiles across, per image, per channel chunk
  int cols, per32, units;       // column strips per tile, units per 32 channels, per tile
  int w_floats;                 // the filter region (forward)
  int x_floats;                 // a slot's x box region; the g box follows (gradient)
  int slot_floats;
};

// The plan's derived numbers and the shared memory it needs; false if the
// plan breaks a rule of these kernels or of TMA.  esize: the bytes of a
// staged element, 4, or 2 for the bf16 instances.
bool make_geom(Geom& g, int B, int H, int W, int C, int th, int tw, int cc, int slots, int parts, bool tma,
               bool wgrad, int smem, int esize = 4) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || cc < 1 || parts < 1 || slots < 2 || slots > kMaxSlots) return false;
  if (th % kR || tw % kS || th < kR || tw < kS || th > kMaxTile || tw > kMaxTile) return false;
  if (esize != 4 && esize != 2) return false;
  const int row = 16 / esize;  // elements of a 16-byte box row
  if (tma && (C % row || cc % row || cc > 256)) return false;
  if (wgrad && parts > kMaxCluster) return false;
  g.B = B, g.H = H, g.W = W, g.C = C, g.th = th, g.tw = tw, g.cc = cc, g.slots = slots, g.parts = parts;
  g.tiles_w = (W + tw - 1) / tw;
  g.per_img = (H + th - 1) / th * g.tiles_w;
  g.tiles = B * g.per_img;
  g.cols = tw / kS;
  g.per32 = th / kR * g.cols;
  g.units = (cc + 31) / 32 * g.per32;
  if (g.units > kMaxWarps) return false;
  const int x_bytes = region((long long)esize * (th + 2 * PAD) * (tw + 2 * PAD) * cc);
  const int g_bytes = wgrad ? region((long long)esize * th * tw * cc) : 0;
  const int w_bytes = wgrad ? 0 : region((long long)esize * kTaps * cc);
  g.w_floats = w_bytes / esize, g.x_floats = x_bytes / esize, g.slot_floats = (x_bytes + g_bytes) / esize;
  long long ring = (long long)slots * (x_bytes + g_bytes);
  if (wgrad) {  // the block's reduction reuses the ring
    const long long red = 4LL * kRows * (32 * g.units + cc);
    ring = ring > red ? ring : red;
  }
  const long long need = kHeader + w_bytes + ring;
  return need <= kSmemMax && need == smem;
}

__device__ __forceinline__ void tile_origin(const Geom& g, int t, int& b, int& h0, int& w0) {
  b = t / g.per_img;
  const int r = t % g.per_img;
  h0 = r / g.tiles_w * g.th;
  w0 = r % g.tiles_w * g.tw;
}

// The producer warp's own loads (kTma = false): rows [h0, h0 + rows) x
// columns [w0, w0 + cols) x channels [c0, c0 + cc) of image b into dst, as
// the tensor map's box would land; zeros outside the image and past C.
template <class T>
__device__ __forceinline__ void stage_box(const T* __restrict__ src, const Geom& g, int b, int h0, int w0,
                                          int c0, int rows, int cols, T* dst, int lane) {
  const int n = rows * cols * g.cc;
  for (int i = lane; i < n; i += 32) {
    const int c = i % g.cc, p = i / g.cc;
    const int h = h0 + p / cols, w = w0 + p % cols;
    T v = T(0.f);
    if (h >= 0 && h < g.H && w >= 0 && w < g.W && c0 + c < g.C)
      v = src[(((size_t)b * g.H + h) * g.W + w) * g.C + c0 + c];
    dst[i] = v;
  }
}

// An output of the forward: f32 sum + bias, or in bf16 the JAX block's two
// roundings, bf16(bf16(sum) + bias) (bv is the bf16 bias, 0 without one).
__device__ __forceinline__ void store_out(float* p, float acc, float bv) { *p = acc + bv; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float acc, float bv) {
  *p = __float2bfloat16(__bfloat162float(__float2bfloat16(acc)) + bv);
}

// grid (parts, channel chunks), 32 * (units + 1) threads: warps 0..units-1
// consume, warp `units` produces.  T: the element type of x, w, bias and y
// (float, or __nv_bfloat16), staged as it is stored.
template <class T, bool kTma, int kCc, int kTw>
__global__ void __launch_bounds__(kMaxThreads, 1)
    dwconv_fwd_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                      const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
                      T* __restrict__ y, int flip, Geom g) {
  float* base = smem_base();
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + kMaxSlots;
  uint64_t* wbar = empty + kMaxSlots;
  T* ws = reinterpret_cast<T*>(base + 64);  // (49, cc) filter slice
  T* ring = ws + g.w_floats;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cc = kCc ? kCc : g.cc, tw = kTw ? kTw : g.tw;  // compile-time where specialised
  const int c0 = blockIdx.y * cc, part = blockIdx.x;
  const int n_local = part < g.tiles ? (g.tiles - part + g.parts - 1) / g.parts : 0;
  const int box_r = g.th + 2 * PAD, box_c = tw + 2 * PAD;

  if (threadIdx.x == 0) {
    for (int s = 0; s < g.slots; ++s) {
      mbar_init(&full[s], kTma ? 1 : 32);
      mbar_init(&empty[s], 32 * g.units);
    }
    mbar_init(wbar, kTma ? 1 : 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == g.units) {  // the producer
    if (kTma) {
      if (lane == 0) {
        mbar_expect_tx(wbar, sizeof(T) * kTaps * cc);
        tma_load_2d(ws, &wmap, c0, 0, wbar);
        for (int i = 0; i < n_local; ++i) {
          const int s = i % g.slots;
          if (i >= g.slots) mbar_wait(&empty[s], (i / g.slots - 1) & 1);
          int b, h0, w0;
          tile_origin(g, part + i * g.parts, b, h0, w0);
          fence_proxy_async_shared();  // consumers' reads of the slot come before the copy's writes
          mbar_expect_tx(&full[s], sizeof(T) * box_r * box_c * cc);
          tma_load_4d(ring + s * g.slot_floats, &xmap, c0, w0 - PAD, h0 - PAD, b, &full[s]);
        }
      }
    } else {
      for (int i = lane; i < kTaps * g.cc; i += 32) {
        const int c = c0 + i % g.cc;
        ws[i] = c < g.C ? w[(size_t)(i / g.cc) * g.C + c] : T(0.f);
      }
      mbar_arrive(wbar);
      for (int i = 0; i < n_local; ++i) {
        const int s = i % g.slots;
        if (i >= g.slots) mbar_wait(&empty[s], (i / g.slots - 1) & 1);
        int b, h0, w0;
        tile_origin(g, part + i * g.parts, b, h0, w0);
        stage_box(x, g, b, h0 - PAD, w0 - PAD, c0, box_r, box_c, ring + s * g.slot_floats, lane);
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  const Unit u = unit_of(g.per32, g.cols, warp, lane);
  const int c = c0 + u.lc;
  const bool valid = u.lc < cc && c < g.C;
  mbar_wait(wbar, 0);
  float wr[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) wr[t] = to_f32(ws[(flip ? kTaps - 1 - t : t) * cc + u.lc]);
  const float bv = bias != nullptr && valid ? to_f32(bias[c]) : 0.f;

  for (int i = 0; i < n_local; ++i) {
    const int s = i % g.slots;
    mbar_wait(&full[s], (i / g.slots) & 1);
    const T* xs = ring + s * g.slot_floats + (u.prow * box_c + u.pcol) * cc + u.lc;
    float acc[kR][kS];
    conv_patch(xs, box_c, cc, wr, acc);
    mbar_arrive(&empty[s]);
    int b, h0, w0;
    tile_origin(g, part + i * g.parts, b, h0, w0);
    if (!valid) continue;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int h = h0 + u.prow + r;
      if (h >= g.H) break;
      T* out = y + (((size_t)b * g.H + h) * g.W + w0 + u.pcol) * g.C + c;
#pragma unroll
      for (int o = 0; o < kS; ++o)
        if (w0 + u.pcol + o < g.W) store_out(out + (size_t)o * g.C, acc[r][o], bv);
    }
  }
}

// grid (parts, channel chunks), clusters of `parts` blocks along x: the
// blocks of a cluster split one chunk's tiles.  Threads as the forward's.
// T: the element type of x and g (float, or __nv_bfloat16), staged as it
// is stored and widened as read; the sums, dw and db are f32.
template <class T, bool kTma, int kCc, int kTw>
__global__ void __launch_bounds__(kMaxThreads, 1)
    dwconv_wgrad_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap gmap,
                        const T* __restrict__ x, const T* __restrict__ gy, float* __restrict__ dw,
                        float* __restrict__ db, Geom g) {
  float* base = smem_base();
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + kMaxSlots;
  T* ring = reinterpret_cast<T*>(base + 64);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cc = kCc ? kCc : g.cc, tw = kTw ? kTw : g.tw;  // compile-time where specialised
  const int c0 = blockIdx.y * cc, part = blockIdx.x;
  const int n_local = part < g.tiles ? (g.tiles - part + g.parts - 1) / g.parts : 0;
  const int box_r = g.th + 2 * PAD, box_c = tw + 2 * PAD;

  if (threadIdx.x == 0) {
    for (int s = 0; s < g.slots; ++s) {
      mbar_init(&full[s], kTma ? 1 : 32);
      mbar_init(&empty[s], 32 * g.units);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  float acc[kRows];  // the 49 tap sums, then the bias sum, of the lane's channel
#pragma unroll
  for (int t = 0; t < kRows; ++t) acc[t] = 0.f;
  const Unit u = warp < g.units ? unit_of(g.per32, g.cols, warp, lane) : Unit{0, 0, 0};

  if (warp == g.units) {  // the producer
    for (int i = 0; i < n_local; ++i) {
      const int s = i % g.slots;
      if (i >= g.slots) mbar_wait(&empty[s], (i / g.slots - 1) & 1);
      int b, h0, w0;
      tile_origin(g, part + i * g.parts, b, h0, w0);
      T* xs = ring + s * g.slot_floats;
      if (kTma) {
        if (lane == 0) {
          fence_proxy_async_shared();
          mbar_expect_tx(&full[s], sizeof(T) * cc * (box_r * box_c + g.th * tw));
          tma_load_4d(xs, &xmap, c0, w0 - PAD, h0 - PAD, b, &full[s]);
          tma_load_4d(xs + g.x_floats, &gmap, c0, w0, h0, b, &full[s]);
        }
      } else {
        stage_box(x, g, b, h0 - PAD, w0 - PAD, c0, box_r, box_c, xs, lane);
        stage_box(gy, g, b, h0, w0, c0, g.th, g.tw, xs + g.x_floats, lane);
        mbar_arrive(&full[s]);
      }
    }
    __syncwarp();
  } else {
    for (int i = 0; i < n_local; ++i) {
      const int s = i % g.slots;
      mbar_wait(&full[s], (i / g.slots) & 1);
      const T* xs = ring + s * g.slot_floats + (u.prow * box_c + u.pcol) * cc + u.lc;
      const T* gs = ring + s * g.slot_floats + g.x_floats + (u.prow * tw + u.pcol) * cc + u.lc;
      float gv[kR][kS];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int o = 0; o < kS; ++o) {
          gv[r][o] = to_f32(gs[(r * tw + o) * cc]);
          acc[kTaps] += gv[r][o];
        }
#pragma unroll
      for (int ir = 0; ir < kR + K - 1; ++ir) {
        float v[kS + K - 1];
#pragma unroll
        for (int k = 0; k < kS + K - 1; ++k) v[k] = to_f32(xs[(ir * box_c + k) * cc]);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int dy = ir - r;
          if (dy < 0 || dy >= K) continue;
#pragma unroll
          for (int dx = 0; dx < K; ++dx)
#pragma unroll
            for (int o = 0; o < kS; ++o) acc[dy * K + dx] = fmaf(v[o + dx], gv[r][o], acc[dy * K + dx]);
        }
      }
      mbar_arrive(&empty[s]);
    }
  }

  // The block's sums: warps' registers to red (units, kRows, 32), then
  // part_sum[row, lc] = the sum over the units of lc's channel group, in
  // unit order.  Both reuse the ring (as floats): every box has been consumed.
  __syncthreads();
  float* red = base + 64;
  float* part_sum = red + kRows * 32 * g.units;  // (kRows, cc)
  if (warp < g.units) {
#pragma unroll
    for (int t = 0; t < kRows; ++t) red[(warp * kRows + t) * 32 + lane] = acc[t];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * cc; i += blockDim.x) {
    const int row = i / cc, lc = i % cc, q = lc / 32;
    float sum = 0.f;
    for (int v = q * g.per32; v < (q + 1) * g.per32; ++v) sum += red[(v * kRows + row) * 32 + lc % 32];
    part_sum[i] = sum;
  }

  // The cluster's sum: rank r adds the r-th slice of every rank's part_sum
  // in rank order and writes it.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n = kRows * cc, per = (n + g.parts - 1) / g.parts, rank = (int)cluster.block_rank();
  for (int i = rank * per + threadIdx.x; i < min(n, (rank + 1) * per); i += blockDim.x) {
    float sum = 0.f;
    for (int src = 0; src < g.parts; ++src) sum += cluster.map_shared_rank(part_sum, src)[i];
    const int row = i / cc, c = c0 + i % cc;
    if (c >= g.C) continue;
    if (row < kTaps)
      dw[(size_t)row * g.C + c] = sum;
    else if (db != nullptr)
      db[c] = sum;
  }
  cluster.sync();  // peers may still be reading this block's part_sum
}

bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

// Each kernel's instances (see the note at the top).
constexpr int kInstances = 4;

template <class T>
using FwdKernel = decltype(&dwconv_fwd_kernel<T, false, 0, 0>);
template <class T>
using WgradKernel = decltype(&dwconv_wgrad_kernel<T, false, 0, 0>);

// The forward at stages 1-3 (32 channels, 16 columns) and 4 (128, 8), in
// f32 and in bf16 alike.
template <class T>
FwdKernel<T> pick_fwd(bool tma, int cc, int tw) {
  if (!tma) return dwconv_fwd_kernel<T, false, 0, 0>;
  if (cc == 32 && tw == 16) return dwconv_fwd_kernel<T, true, 32, 16>;
  if (cc == 128 && tw == 8) return dwconv_fwd_kernel<T, true, 128, 8>;
  return dwconv_fwd_kernel<T, true, 0, 0>;
}

// The filter gradient at stages 1-3 (32 channels, 16 columns) and 4 (64, 8
// in f32; in bf16 a box of 128 channels fits and the plan takes it).
template <class T>
WgradKernel<T> pick_wgrad(bool tma, int cc, int tw) {
  constexpr int kStage4 = sizeof(T) == 4 ? 64 : 128;
  if (!tma) return dwconv_wgrad_kernel<T, false, 0, 0>;
  if (cc == 32 && tw == 16) return dwconv_wgrad_kernel<T, true, 32, 16>;
  if (cc == kStage4 && tw == 8) return dwconv_wgrad_kernel<T, true, kStage4, 8>;
  return dwconv_wgrad_kernel<T, true, 0, 0>;
}

// The filter (7, 7, C) of esize-byte elements as a 2-D map (C, 49) with
// boxes of (cc, 49).
cudaError_t filter_map(CUtensorMap* map, const void* w, const Geom& g, int esize) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)g.C, (cuuint64_t)kTaps};
  const cuuint64_t strides[1] = {(cuuint64_t)esize * g.C};
  const cuuint32_t box[2] = {(cuuint32_t)g.cc, (cuuint32_t)kTaps};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, map_type(esize), 2, const_cast<void*>(w), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launch `kernel` on grid with 32 * (units + 1) threads, smem bytes of
// dynamic shared memory and, when cluster > 1, clusters of `cluster` blocks
// along x; returns a cudaError_t, cudaGetLastError's after the launch.
template <class Kernel, class... Args>
int launch(Kernel kernel, dim3 grid, const Geom& g, int smem, int cluster, void* stream, Args... args) {
  // Every instance may take the most a block has: set once per instance,
  // not at every launch.
  static const void* ready[kInstances] = {};
  const void* key = reinterpret_cast<const void*>(kernel);
  int i = 0;
  while (i < kInstances && ready[i] != nullptr && ready[i] != key) ++i;
  if (i == kInstances) return (int)cudaErrorInvalidValue;
  if (ready[i] == nullptr) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return (int)err;
    ready[i] = key;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(32 * (g.units + 1));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The forward of T elements: check the plan, make the maps, launch.
template <class T>
int forward(const T* x, const T* w, const T* bias, T* y, int B, int H, int W, int C, int flip, int th, int tw,
            int cc, int slots, int parts, int tma, int smem, void* stream) {
  constexpr int esize = sizeof(T);
  Geom g;
  if (!make_geom(g, B, H, W, C, th, tw, cc, slots, parts, tma, false, smem, esize) ||
      (long long)((C + cc - 1) / cc) > 65535)
    return (int)cudaErrorInvalidValue;
  if (tma && !(aligned16(x) && aligned16(w))) return (int)cudaErrorInvalidValue;
  CUtensorMap xmap = {}, wmap = {};
  if (tma) {
    cudaError_t err = bind_device(x);
    if (err == cudaSuccess)
      err = nhwc_map(&xmap, x, g.B, g.H, g.W, g.C, g.cc, tw + 2 * PAD, th + 2 * PAD, esize);
    if (err == cudaSuccess) err = filter_map(&wmap, w, g, esize);
    if (err != cudaSuccess) return (int)err;
  }
  const FwdKernel<T> kernel = pick_fwd<T>(tma, cc, tw);
  return launch(kernel, dim3(parts, (C + cc - 1) / cc), g, smem, 1, stream, xmap, wmap, x, w, bias, y, flip, g);
}

// The filter gradient of T elements: check the plan, make the maps, launch.
template <class T>
int wgrad(const T* x, const T* gy, float* dw, float* db, int B, int H, int W, int C, int th, int tw, int cc,
          int slots, int parts, int tma, int smem, void* stream) {
  constexpr int esize = sizeof(T);
  Geom g;
  if (!make_geom(g, B, H, W, C, th, tw, cc, slots, parts, tma, true, smem, esize) ||
      (long long)((C + cc - 1) / cc) > 65535)
    return (int)cudaErrorInvalidValue;
  if (tma && !(aligned16(x) && aligned16(gy))) return (int)cudaErrorInvalidValue;
  CUtensorMap xmap = {}, gmap = {};
  if (tma) {
    cudaError_t err = bind_device(x);
    if (err == cudaSuccess)
      err = nhwc_map(&xmap, x, g.B, g.H, g.W, g.C, g.cc, tw + 2 * PAD, th + 2 * PAD, esize);
    if (err == cudaSuccess) err = nhwc_map(&gmap, gy, g.B, g.H, g.W, g.C, g.cc, tw, th, esize);
    if (err != cudaSuccess) return (int)err;
  }
  const WgradKernel<T> kernel = pick_wgrad<T>(tma, cc, tw);
  return launch(kernel, dim3(parts, (C + cc - 1) / cc), g, smem, parts, stream, xmap, gmap, x, gy, dw, db, g);
}

// Clusters of `parts` blocks of `kernel` the card runs at once.
template <class Kernel>
int active_clusters(Kernel kernel, int units, int parts, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(parts);
  cfg.blockDim = dim3(32 * (units + 1));
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

}  // namespace

extern "C" {

// y = the conv of x (B, H, W, C) with w (7, 7, C), pad 3, plus bias (C,)
// unless it is null; flip = 1 reads the filter flipped in both spatial axes
// (the input gradient for a cotangent x).  (th, tw, cc, slots, parts, tma,
// smem) is ops/dwconv.py:dwconv_plan(B, H, W, C, "forward", tma); a plan
// that breaks a rule, or TMA with an unaligned pointer, returns
// cudaErrorInvalidValue without a launch.
int tc_dwconv_forward(const float* x, const float* w, const float* bias, float* y, int B, int H, int W, int C,
                      int flip, int th, int tw, int cc, int slots, int parts, int tma, int smem, void* stream) {
  return forward(x, w, bias, y, B, H, W, C, flip, th, tw, cc, slots, parts, tma, smem, stream);
}

// The same of bf16 x, w, bias and y, the sums in f32, each output rounded
// twice (bf16(bf16(sum) + bias)); the plan is dwconv_plan(..., esize=2).
int tc_dwconv_forward_bf16(const void* x, const void* w, const void* bias, void* y, int B, int H, int W, int C,
                           int flip, int th, int tw, int cc, int slots, int parts, int tma, int smem,
                           void* stream) {
  using bf = __nv_bfloat16;
  return forward(static_cast<const bf*>(x), static_cast<const bf*>(w), static_cast<const bf*>(bias),
                 static_cast<bf*>(y), B, H, W, C, flip, th, tw, cc, slots, parts, tma, smem, stream);
}

// dw (7, 7, C) = the filter gradient of the conv for input x and cotangent g,
// both (B, H, W, C), and db (C,) = the sum of g over (B, H, W) unless db is
// null.  The plan is dwconv_plan(B, H, W, C, "wgrad", tma); parts is the
// cluster size, 8.  One launch: no scratch.
int tc_dwconv_wgrad(const float* x, const float* gy, float* dw, float* db, int B, int H, int W, int C, int th,
                    int tw, int cc, int slots, int parts, int tma, int smem, void* stream) {
  return wgrad(x, gy, dw, db, B, H, W, C, th, tw, cc, slots, parts, tma, smem, stream);
}

// The same of bf16 x and g, the sums and dw, db in f32; the plan is
// dwconv_plan(..., "wgrad", tma, esize=2).
int tc_dwconv_wgrad_bf16(const void* x, const void* gy, float* dw, float* db, int B, int H, int W, int C,
                         int th, int tw, int cc, int slots, int parts, int tma, int smem, void* stream) {
  using bf = __nv_bfloat16;
  return wgrad(static_cast<const bf*>(x), static_cast<const bf*>(gy), dw, db, B, H, W, C, th, tw, cc, slots,
               parts, tma, smem, stream);
}

// How many clusters of `parts` filter-gradient blocks of `units` consumer
// warps and smem bytes, of the instance for (tma, cc, tw) and esize-byte
// elements (4, or 2 for bf16), the card runs at once
// (cudaOccupancyMaxActiveClusters), or minus a cudaError_t.
int tc_dwconv_wgrad_clusters(int units, int parts, int smem, int tma, int cc, int tw, int esize) {
  if (units < 1 || units > kMaxWarps || parts < 1 || parts > kMaxCluster || smem > kSmemMax ||
      (esize != 4 && esize != 2))
    return -(int)cudaErrorInvalidValue;
  return esize == 4 ? active_clusters(pick_wgrad<float>(tma, cc, tw), units, parts, smem)
                    : active_clusters(pick_wgrad<__nv_bfloat16>(tma, cc, tw), units, parts, smem);
}

const char* tc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
