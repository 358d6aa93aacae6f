// A whole ConvNeXt block in one launch, forward, f32, for Hopper (sm_90a).
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
// What bounds it on the H100: the tail's arithmetic (16*N*C^2 FFMA flops,
// see mlp_tail.cuh); the conv adds 98*N*C flops, 98/(16*C) of the tail's:
// 4.8% at C = 128, 1.2% at C = 512.  Device memory sees x read and out
// written once, against five (N, C) transfers for the separate conv and
// tail kernels (x read, t written, t and the residual read, out written).
//
// The design, written for this card rather than from the Pallas body:
// - the TPU kernel's halo strips (_halo_strips, _pick_th) exist only to fit
//   its VMEM tiles.  Here a thread block owns BM consecutive NHWC rows
//   (pixels), as the MLP-tail kernel does, and its prologue computes each
//   row's 49-tap conv straight from x in device memory, zero outside the
//   image.  A thread takes kGW = 8 consecutive pixels of one channel, so
//   neighbouring threads read neighbouring channels (coalesced).  When W is
//   a multiple of 8 (every ConvNeXt-Base stage) the 8 pixels lie in one image
//   row and each of the 7 tap rows is read as 14 values held in registers:
//   12.25 loads per output instead of 49, which matters because with the
//   tail's shared memory in use little L1 is left and the taps come from
//   L2.  Other widths take a per-pixel path whose rows may cross image rows
//   and images (the ragged shapes of the tests);
// - the results go into the k-major shared tile xs, where the MLP-tail
//   kernel stages LN(x), as float4 stores: with the BMP padding the stores
//   of a warp are conflict-free;
// - at C = 512 and 1024 the tail runs over 2- and 4-block clusters and every
//   rank needs the whole LN row.  Each rank convolves C / S channels of the
//   tile and gathers the others' through distributed shared memory, between
//   two cluster barriers.  The simpler choice, every rank convolving the
//   whole tile (98/(16*C) of the tail's flops, 1.2% at C = 512), also reads
//   the taps S times from L2.  A first version that did so, with 4 pixels
//   per thread and 49 loads per output, took 2.43 ms a launch at
//   (32, 16, 16, 512) and 4.82 ms at (32, 8, 8, 1024); this one takes 1.39
//   and 3.51 ms, against 1.36 and 3.43 ms for the MLP-tail kernel alone
//   (chip_smoke.py phase 3 on an NVIDIA H100 80GB HBM3 at 700 W);
// - LayerNorm then runs in place: BM threads per channel group, two passes
//   (mean, then the centred sum of squares) with the partial sums reduced
//   through shared memory, and the tail runs exactly as in the MLP-tail
//   kernel (mlp_tail.cuh, shared with mlp_block.cu), with x's own rows as
//   the residual and the image's scale sd[g / (H*W)].

#include "mlp_tail.cuh"

namespace {

constexpr int kTaps = 7, kPad = 3;
constexpr int kGW = 8;  // pixels of one channel a thread convolves together

template <class K>
__global__ void __launch_bounds__(kThreads) block_fused_kernel(
    const float* __restrict__ x, const float* __restrict__ sd,
    const float* __restrict__ dww, const float* __restrict__ dwb,
    const float* __restrict__ lnw, const float* __restrict__ lnb,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ gamma, float* __restrict__ out, int n, int H, int W) {
  constexpr int C = K::C, BM = K::BM, BMP = K::BMP;
  static_assert(BM % kGW == 0 && kThreads % BM == 0, "kGW-row groups; whole channel groups of BM threads");
  constexpr int G = kThreads / BM;  // channel groups of the LayerNorm
  static_assert((G + 2) * BM <= K::kHs, "the LayerNorm's partial sums fit the hidden tile");
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                   // (C, BMP) conv output, then LN of it, k-major
  float* red = smem + K::kXs + K::kW1;  // the hidden tile, free until the tail

  const int t = threadIdx.x;
  const int q_rank = blockIdx.x % K::S;
  const int row0 = (blockIdx.x / K::S) * BM;
  const int hw = H * W;

  // Depthwise conv + bias of this rank's channels (all of them without a
  // cluster): item (group rg of kGW rows, channel c).
  constexpr int CS = C / K::S;
  for (int i = t; i < BM / kGW * CS; i += kThreads) {
    const int c = q_rank * CS + i % CS, rg = i / CS, g0 = row0 + kGW * rg;
    float acc[kGW];
    if (W % kGW == 0) {
      // The group is kGW pixels w0 .. w0 + kGW - 1 of one image row, all
      // below n or all past it (n = B*H*W): each tap row's kGW + 6 inputs
      // are read once for all of them.
      const int h = g0 % hw / W, w0 = g0 % W;
#pragma unroll
      for (int e = 0; e < kGW; ++e) acc[e] = g0 < n ? dwb[c] : 0.f;
      if (g0 < n) {
#pragma unroll
        for (int dy = 0; dy < kTaps; ++dy) {
          const int y = h + dy - kPad;
          if (y < 0 || y >= H) continue;
          const long long row = (long long)g0 + (long long)(dy - kPad) * W - w0;  // pixel (y, 0)
          float xv[kGW + kTaps - 1];
#pragma unroll
          for (int j = 0; j < kGW + kTaps - 1; ++j) {
            const int col = w0 + j - kPad;
            xv[j] = col >= 0 && col < W ? __ldg(x + (row + col) * C + c) : 0.f;
          }
#pragma unroll
          for (int dx = 0; dx < kTaps; ++dx) {
            const float wt = __ldg(dww + (dy * kTaps + dx) * C + c);
#pragma unroll
            for (int e = 0; e < kGW; ++e) acc[e] = fmaf(xv[e + dx], wt, acc[e]);
          }
        }
      }
    } else {
      // Other widths: each row finds its own (b, h, w); rows may cross image
      // rows and images inside the group.
#pragma unroll
      for (int e = 0; e < kGW; ++e) {
        const int g = g0 + e, h = g % hw / W, w = g % W;
        acc[e] = 0.f;
        if (g >= n) continue;
        acc[e] = dwb[c];
        for (int dy = 0; dy < kTaps; ++dy) {
          const int y = h + dy - kPad;
          if (y < 0 || y >= H) continue;
          for (int dx = 0; dx < kTaps; ++dx) {
            const int xw = w + dx - kPad;
            if (xw >= 0 && xw < W)
              acc[e] = fmaf(__ldg(x + ((long long)g + (long long)(dy - kPad) * W + (dx - kPad)) * C + c),
                            __ldg(dww + (dy * kTaps + dx) * C + c), acc[e]);
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kGW; e += 4)
      st4(xs + c * BMP + kGW * rg + e, make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]));
  }
  if constexpr (K::S > 1) {
    // Gather the other ranks' channels through distributed shared memory.
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every rank's channels are written
    for (int k = 1; k < K::S; ++k) {
      const int src = (q_rank + k) % K::S;
      const float* peer = cluster.map_shared_rank(xs, src);
      for (int i = t; i < CS * BM / 4; i += kThreads) {
        const int o = (src * CS + i / (BM / 4)) * BMP + 4 * (i % (BM / 4));
        st4(xs + o, ld4(peer + o));
      }
    }
    cluster.sync();  // no rank reuses its tile (the tail's epilogue) while a peer reads it
  } else {
    __syncthreads();
  }

  // LayerNorm in place: thread (r, grp) sums channels grp, grp + G, ...
  const int r = t % BM, grp = t / BM;
  float s = 0.f;
  for (int c = grp; c < C; c += G) s += xs[c * BMP + r];
  red[grp * BM + r] = s;
  __syncthreads();
  if (t < BM) {
    float tot = 0.f;
    for (int q = 0; q < G; ++q) tot += red[q * BM + t];
    red[G * BM + t] = tot * (1.0f / C);
  }
  __syncthreads();
  const float mu = red[G * BM + r];
  float ss = 0.f;
  for (int c = grp; c < C; c += G) {
    const float d = xs[c * BMP + r] - mu;
    ss += d * d;
  }
  red[grp * BM + r] = ss;
  __syncthreads();
  if (t < BM) {
    float tot = 0.f;
    for (int q = 0; q < G; ++q) tot += red[q * BM + t];
    red[(G + 1) * BM + t] = rsqrtf(tot * (1.0f / C) + kLnEps);
  }
  __syncthreads();
  const float rstd = red[(G + 1) * BM + r];
  for (int c = grp; c < C; c += G) xs[c * BMP + r] = (xs[c * BMP + r] - mu) * rstd * lnw[c] + lnb[c];

  mlp_tail<K>(smem, x, sd, hw, w1, b1, w2, b2, gamma, out, n, row0, q_rank);
}

template <class K>
int launch(const float* x, const float* sd, const float* dww, const float* dwb, const float* lnw,
           const float* lnb, const float* w1, const float* b1, const float* w2, const float* b2,
           const float* gamma, float* out, int n, int h, int w, cudaStream_t stream) {
  return launch_tail<K>(block_fused_kernel<K>, n, stream, x, sd, dww, dwb, lnw, lnb, w1, b1, w2, b2,
                        gamma, out, n, h, w);
}

}  // namespace

extern "C" {

// The tiles of mlp_block.cu's monolithic instances, by width.
int tc_block_fused_forward(const float* x, const float* sd, const float* dww, const float* dwb,
                           const float* lnw, const float* lnb, const float* w1, const float* b1,
                           const float* w2, const float* b2, const float* gamma, float* out,
                           int b, int h, int w, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = b * h * w;
  switch (c) {
    case 128:
      return launch<Cfg<128, 64, 1, 128, 8, 4, 8, 4>>(x, sd, dww, dwb, lnw, lnb, w1, b1, w2, b2, gamma, out, n, h, w, s);
    case 256:
      return launch<Cfg<256, 32, 1, 256, 8, 4, 8, 4>>(x, sd, dww, dwb, lnw, lnb, w1, b1, w2, b2, gamma, out, n, h, w, s);
    case 512:
      return launch<Cfg<512, 32, 2, 256, 8, 4, 8, 8>>(x, sd, dww, dwb, lnw, lnb, w1, b1, w2, b2, gamma, out, n, h, w, s);
    case 1024:
      return launch<Cfg<1024, 16, 4, 256, 4, 4, 8, 8>>(x, sd, dww, dwb, lnw, lnb, w1, b1, w2, b2, gamma, out, n, h, w, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* tc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
