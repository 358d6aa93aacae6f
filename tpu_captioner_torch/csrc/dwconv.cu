// The ConvNeXt block's 7x7 depthwise convolution, NHWC, stride 1, pad 3, f32,
// for Hopper (sm_90a): the forward (also the input gradient, with the filter
// flipped) and the filter gradient.
//
// Replaces two TPU kernels of tpu_captioner/ops/dwconv.py:
// - _dw_kernel (:37) -> dwconv_fwd_kernel:
//     y[b,h,w,c] = sum_{dy,dx} x_pad[b,h+dy,w+dx,c] * w[dy,dx,c]
//   On the TPU one grid cell holds a whole zero-padded image, (H+6, W+6, C),
//   in VMEM.  That does not fit a Hopper block (a stage-1 image at C = 128 is
//   2 MB), so a block takes one (image, 8 x 8 output pixels, 16 channel
//   groups) tile: it stages the 14 x 14 halo'd input tile in shared memory
//   (zeros outside the image), and each thread computes one output row strip
//   of 8 pixels for one channel group, the 8 accumulators and one filter row
//   in registers, reading each staged input once per filter row.  With
//   flip = 1 it reads w[6-dy, 6-dx]: the input gradient of the conv is the
//   same conv of the cotangent with the flipped filter (ops/dwconv.py:174-180).
// - _dwg_kernel (:97) -> dwconv_wgrad_kernel + dwconv_wgrad_sum_kernel:
//     dw[dy,dx,c] = sum_{b,h,w} x_pad[b,h+dy,w+dx,c] * g[b,h,w,c]
//   The TPU kernel walks the batch in order and keeps one (7, 7, C)
//   accumulator across its grid ('arbitrary' semantics).  Hopper blocks run
//   in no order, so the (b, h) rows are split over blocks, 8 rows of one
//   image each: a block walks its rows' width in 8-column tiles (the halo'd
//   x tile and the g tile in shared memory) and keeps 7 filter taps per
//   thread in registers; it writes its 49 x Cc partial sums to a scratch
//   row, and a second kernel sums the rows in a fixed order.  No atomics, so
//   the result is the same bits from run to run.
//
// A channel group is 4 channels (float4 loads and stores) when C % 4 == 0
// and the pointers are 16-byte aligned, which holds for every ConvNeXt width;
// otherwise it is one channel (scalar code, any C).  Channels past C, and
// pixels outside the image, are masked: they read as zeros and are never
// written.
//
// What bounds it on the H100: bytes.  The forward moves each input and output
// value once and does 49 multiply-adds per output; at batch 32 an encoder pass
// (36 convolutions) moves about 1.56 GB against 19 GFLOP, 0.47 ms at 3.35 TB/s
// against 0.29 ms at 67 TFLOP/s.  The filter gradient reads x and g once, 0.96
// GB per fine-tune step (30 convolutions) against 11.7 GFLOP.  A forward
// block re-reads its 3-pixel halo from L2 (14 x 14 staged for 8 x 8 outputs);
// a filter-gradient block does too (14 x 14 for 8 x 8).  Shared memory (49 KB
// per forward block, 65 KB per gradient block) leaves room for four and three
// blocks per SM.

#include <cuda_runtime.h>

namespace {

constexpr int K = 7;    // filter size
constexpr int PAD = 3;  // zero padding on each side
constexpr int kTaps = K * K;

constexpr int kFwdGroups = 16;  // channel groups per forward block
constexpr int kFwdRows = 8;     // output rows per forward block, one per thread row
constexpr int kFwdCols = 8;     // output columns per forward block: one strip per thread
constexpr int kFwdThreads = kFwdGroups * kFwdRows;

constexpr int kGradGroups = 16;  // channel groups per gradient block
constexpr int kGradRows = 8;     // (b, h) rows per gradient block, of one image
constexpr int kGradCols = 8;     // columns per staged tile
constexpr int kGradParts = 2;    // column parts of a tile, one per thread
constexpr int kPartCols = kGradCols / kGradParts;
constexpr int kGradThreads = kGradGroups * K * kGradParts;  // (group, dy, part)

template <int VEC>
struct Vec;

template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ T fma(T a, T b, T c) {
    return make_float4(fmaf(a.x, b.x, c.x), fmaf(a.y, b.y, c.y), fmaf(a.z, b.z, c.z),
                       fmaf(a.w, b.w, c.w));
  }
  static __device__ __forceinline__ T add(T a, T b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
};

template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T fma(T a, T b, T c) { return fmaf(a, b, c); }
  static __device__ __forceinline__ T add(T a, T b) { return a + b; }
};

// Stage rows [h0, h0 + rows) x columns [w0, w0 + cols) of image `img`
// (NHWC, C channels) from channel c0 on, groups channel groups, into
// tile[(row * cols + col) * groups + group]; zeros outside the image and past
// channel C.
template <int VEC>
__device__ __forceinline__ void stage(const float* __restrict__ img, int H, int W, int C, int h0,
                                      int w0, int c0, int rows, int cols, int groups,
                                      typename Vec<VEC>::T* tile) {
  using T = typename Vec<VEC>::T;
  for (int i = threadIdx.x; i < rows * cols * groups; i += blockDim.x) {
    const int grp = i % groups, p = i / groups;
    const int h = h0 + p / cols, w = w0 + p % cols, c = c0 + grp * VEC;
    T v = Vec<VEC>::zero();
    if (h >= 0 && h < H && w >= 0 && w < W && c < C)
      v = __ldg(reinterpret_cast<const T*>(img + ((size_t)h * W + w) * C + c));
    tile[i] = v;
  }
}

// grid (tiles of 8 x 8 output pixels, channel chunks, images)
template <int VEC>
__global__ void __launch_bounds__(kFwdThreads)
    dwconv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      float* __restrict__ y, int H, int W, int C, int tiles_w, int flip) {
  using V = Vec<VEC>;
  using T = typename V::T;
  constexpr int TR = kFwdRows + 2 * PAD, TC = kFwdCols + 2 * PAD;
  extern __shared__ __align__(16) float sm[];
  T* tile = reinterpret_cast<T*>(sm);  // (TR, TC, kFwdGroups)
  const size_t img = (size_t)blockIdx.z * H * W * C;
  const int h0 = (blockIdx.x / tiles_w) * kFwdRows, w0 = (blockIdx.x % tiles_w) * kFwdCols;
  const int c0 = blockIdx.y * kFwdGroups * VEC;
  stage<VEC>(x + img, H, W, C, h0 - PAD, w0 - PAD, c0, TR, TC, kFwdGroups, tile);
  __syncthreads();

  const int grp = threadIdx.x % kFwdGroups, r = threadIdx.x / kFwdGroups;
  const int h = h0 + r, c = c0 + grp * VEC;
  if (h >= H || c >= C) return;
  T acc[kFwdCols];
#pragma unroll
  for (int o = 0; o < kFwdCols; ++o) acc[o] = V::zero();
  for (int dy = 0; dy < K; ++dy) {
    T wr[K];
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      const int tap = flip ? (K - 1 - dy) * K + (K - 1 - dx) : dy * K + dx;
      wr[dx] = __ldg(reinterpret_cast<const T*>(w + (size_t)tap * C + c));
    }
    const T* row = tile + (r + dy) * TC * kFwdGroups + grp;
#pragma unroll
    for (int i = 0; i < TC; ++i) {  // staged column i feeds outputs i - dx
      const T v = row[i * kFwdGroups];
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const int o = i - dx;
        if (o >= 0 && o < kFwdCols) acc[o] = V::fma(v, wr[dx], acc[o]);
      }
    }
  }
  float* out = y + img + ((size_t)h * W + w0) * C + c;
#pragma unroll
  for (int o = 0; o < kFwdCols; ++o)
    if (w0 + o < W) *reinterpret_cast<T*>(out + (size_t)o * C) = acc[o];
}

// grid (images x row slabs, channel chunks); block row k = b * slabs + slab
// writes partial[k, tap, c] for its channels.
template <int VEC>
__global__ void __launch_bounds__(kGradThreads)
    dwconv_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ g,
                        float* __restrict__ partial, int H, int W, int C, int slabs) {
  using V = Vec<VEC>;
  using T = typename V::T;
  constexpr int TR = kGradRows + 2 * PAD, TC = kGradCols + 2 * PAD;
  extern __shared__ __align__(16) float sm[];
  T* xt = reinterpret_cast<T*>(sm);       // (TR, TC, kGradGroups) halo'd x tile
  T* gt = xt + TR * TC * kGradGroups;     // (kGradRows, kGradCols, kGradGroups)
  const int b = blockIdx.x / slabs, h0 = (blockIdx.x % slabs) * kGradRows;
  const int c0 = blockIdx.y * kGradGroups * VEC;
  const size_t img = (size_t)b * H * W * C;
  const int grp = threadIdx.x % kGradGroups, dy = (threadIdx.x / kGradGroups) % K;
  const int part = threadIdx.x / (kGradGroups * K);

  T acc[K];  // taps (dy, 0..6) of this thread's channel group
#pragma unroll
  for (int dx = 0; dx < K; ++dx) acc[dx] = V::zero();
  for (int w0 = 0; w0 < W; w0 += kGradCols) {
    __syncthreads();  // the previous tile's readers are done
    stage<VEC>(x + img, H, W, C, h0 - PAD, w0 - PAD, c0, TR, TC, kGradGroups, xt);
    stage<VEC>(g + img, H, W, C, h0, w0, c0, kGradRows, kGradCols, kGradGroups, gt);
    __syncthreads();
    for (int r = 0; r < kGradRows; ++r) {  // rows past H hold zero cotangents
      const T* xr = xt + ((r + dy) * TC + part * kPartCols) * kGradGroups + grp;
      const T* gr = gt + (r * kGradCols + part * kPartCols) * kGradGroups + grp;
      T xv[kPartCols + K - 1];
#pragma unroll
      for (int i = 0; i < kPartCols + K - 1; ++i) xv[i] = xr[i * kGradGroups];
#pragma unroll
      for (int j = 0; j < kPartCols; ++j) {
        const T gv = gr[j * kGradGroups];
#pragma unroll
        for (int dx = 0; dx < K; ++dx) acc[dx] = V::fma(xv[j + dx], gv, acc[dx]);
      }
    }
  }

  // Sum the column parts in a fixed order and write the block's partials.
  __syncthreads();
  T* red = xt;  // (kGradParts, kTaps, kGradGroups), over the x tile
#pragma unroll
  for (int dx = 0; dx < K; ++dx) red[((part * K + dy) * K + dx) * kGradGroups + grp] = acc[dx];
  __syncthreads();
  for (int i = threadIdx.x; i < kTaps * kGradGroups; i += blockDim.x) {
    const int gg = i % kGradGroups, tap = i / kGradGroups, c = c0 + gg * VEC;
    T s = red[i];
#pragma unroll
    for (int p = 1; p < kGradParts; ++p) s = V::add(s, red[p * kTaps * kGradGroups + i]);
    if (c < C) *reinterpret_cast<T*>(partial + ((size_t)blockIdx.x * kTaps + tap) * C + c) = s;
  }
}

// dw[i] = sum over k = 0, 1, ..., rows - 1 of partial[k, i], in that order.
__global__ void dwconv_wgrad_sum_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                        int rows, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
#pragma unroll 8
  for (int k = 0; k < rows; ++k) s += __ldg(partial + (size_t)k * n + i);
  dw[i] = s;
}

bool vec4(int C, const void* a, const void* b, const void* c) {
  return C % 4 == 0 && (reinterpret_cast<size_t>(a) | reinterpret_cast<size_t>(b) |
                        reinterpret_cast<size_t>(c)) % 16 == 0;
}

int launch(const void* kernel, dim3 grid, int threads, size_t smem, void** args, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel(kernel, grid, dim3(threads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int slabs_of(int H) { return (H + kGradRows - 1) / kGradRows; }

}  // namespace

extern "C" {

// y = the conv of x (B, H, W, C) with w (7, 7, C), pad 3; flip = 1 reads the
// filter flipped in both spatial axes (the input gradient for a cotangent x).
int tc_dwconv_forward(const float* x, const float* w, float* y, int B, int H, int W, int C,
                      int flip, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const int tiles_w = (W + kFwdCols - 1) / kFwdCols, tiles_h = (H + kFwdRows - 1) / kFwdRows;
  const bool v4 = vec4(C, x, w, y);
  const int vec = v4 ? 4 : 1, per_block = kFwdGroups * vec;
  const dim3 grid(tiles_w * tiles_h, (C + per_block - 1) / per_block, B);
  const size_t smem = sizeof(float) * vec * kFwdGroups * (kFwdRows + 2 * PAD) * (kFwdCols + 2 * PAD);
  void* args[] = {&x, &w, &y, &H, &W, &C, (void*)&tiles_w, &flip};
  const void* kernel = v4 ? (const void*)dwconv_fwd_kernel<4> : (const void*)dwconv_fwd_kernel<1>;
  return launch(kernel, grid, kFwdThreads, smem, args, stream);
}

// Floats of scratch tc_dwconv_wgrad needs: one (49, C) row per 8 image rows.
long long tc_dwconv_wgrad_scratch_floats(int B, int H, int C) {
  return (long long)B * slabs_of(H) * kTaps * C;
}

// dw (7, 7, C) = the filter gradient of the conv for input x and cotangent g,
// both (B, H, W, C); partial is tc_dwconv_wgrad_scratch_floats of scratch.
int tc_dwconv_wgrad(const float* x, const float* g, float* partial, float* dw, int B, int H, int W,
                    int C, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1) return (int)cudaErrorInvalidValue;
  int slabs = slabs_of(H), rows = B * slabs, n = kTaps * C;
  const bool v4 = vec4(C, x, g, partial);
  const int vec = v4 ? 4 : 1, per_block = kGradGroups * vec;
  const dim3 grid(rows, (C + per_block - 1) / per_block);
  const size_t smem = sizeof(float) * vec * kGradGroups *
                      ((kGradRows + 2 * PAD) * (kGradCols + 2 * PAD) + kGradRows * kGradCols);
  void* args[] = {&x, &g, &partial, &H, &W, &C, &slabs};
  const void* kernel = v4 ? (const void*)dwconv_wgrad_kernel<4> : (const void*)dwconv_wgrad_kernel<1>;
  int err = launch(kernel, grid, kGradThreads, smem, args, stream);
  if (err != 0) return err;
  void* sum_args[] = {&partial, &dw, &rows, &n};
  return launch((const void*)dwconv_wgrad_sum_kernel, dim3((n + 255) / 256), 256, 0, sum_args,
                stream);
}

const char* tc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
