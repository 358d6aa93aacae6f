#!/usr/bin/env python3
"""Measure the two designs for the whole-block kernel's conv + LayerNorm launch
against each other on one card.

    python3 scripts/block_design_probe.py

A pixel's LayerNorm needs all C channels; a depthwise-conv warp owns 32
channels of a 2 x 8 patch.  Two ways to bring them together:
- (b), the shipped one (``csrc/block_fused.cu:conv_ln_kernel``): a cluster
  of C / 128 blocks splits the channels of a th x 8 tile; each rank keeps
  its values in registers and the ranks swap two floats a pixel (mean and
  M2) through distributed shared memory;
- (a), built here only: a block owns a 2 x 8 tile and all C channels.  A
  producer warp brings 64-channel chunks of the halo'd box through a ring
  of TMA slots; each consumer warp pair takes every ``slots``-th chunk,
  with the chunk's 49 taps from device memory, and writes t into a (16, C)
  tile in shared memory; then each warp normalises whole pixels from that
  tile (two passes over C) and writes the TF32 planes.  t fills 64 KB at C
  = 1024, which bounds the ring beside it.
Both launch on x of the four ConvNeXt-Base stage shapes at batch 8 and 32
(random inputs from seed 0); the probe checks that their LN(t) (the sum of
the two planes) agree within 1e-5 of the largest magnitude and prints each
one's device ms per launch (CUDA-graph replay) and the bytes bound (x read,
the two planes written, at 3.35 TB/s), then each design's sum over an
encoder pass (36 launches) and that of the better one per stage, with the
card's name and power limit.  The build goes under ``build/block_probe/``;
this file's CUDA source includes ``csrc/block_fused.cu``, so (b) is the
shipped kernel itself.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = (128, 256, 512, 1024)

DESIGN_A = r"""
#include "block_fused.cu"

namespace {

constexpr int kAcc = 64;  // channels a chunk: two 32-channel warps
constexpr int kAth = 2;   // tile rows: one 2 x 8 patch
constexpr int kAslot = (kAth + 2 * PAD) * kBoxC * kAcc;  // floats a slot

__host__ __device__ constexpr int a_slots(int c) {
  // The t tile (16 x C floats) first, then as many slots as fit, at most one a chunk.
  return ((kSmemMax - 1024 - 16 * c * 4) / (kAslot * 4)) < c / kAcc ? (kSmemMax - 1024 - 16 * c * 4) / (kAslot * 4)
                                                                      : c / kAcc;
}

template <int C>
__global__ void __launch_bounds__(32 * (2 * a_slots(C) + 1), 1)
    conv_ln_a_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ dww,
                     const float* __restrict__ dwb, const float* __restrict__ lnw, const float* __restrict__ lnb,
                     float* __restrict__ planes, int B, int H, int W) {
  constexpr int S = a_slots(C), NCH = C / kAcc, P = kAth * kTw;
  float* base = smem_base();
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + 8;
  float* ts = base + 64;  // (P, C) t tile
  float* ring = ts + P * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles_w = (W + kTw - 1) / kTw, per_img = (H + kAth - 1) / kAth * tiles_w;
  const int b = blockIdx.x / per_img, r = blockIdx.x % per_img;
  const int h0 = r / tiles_w * kAth, w0 = r % tiles_w * kTw;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 64);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 2 * S) {  // the producer
    if (lane == 0) {
      for (int k = 0; k < NCH; ++k) {
        const int s = k % S;
        if (k >= S) mbar_wait(&empty[s], (k / S - 1) & 1);
        fence_proxy_async_shared();
        mbar_expect_tx(&full[s], 4 * kAslot);
        tma_load_4d(ring + s * kAslot, &xmap, k * kAcc, w0 - PAD, h0 - PAD, b, &full[s]);
      }
    }
  } else {
    const int pair = warp / 2, lc = warp % 2 * 32 + lane;
    for (int k = pair; k < NCH; k += S) {
      const int c = k * kAcc + lc;
      float wr[kTaps];
#pragma unroll
      for (int t = 0; t < kTaps; ++t) wr[t] = __ldg(dww + t * C + c);
      mbar_wait(&full[pair], (k / S) & 1);
      float acc[kR][kS];
      conv_patch(ring + pair * kAslot + lc, kBoxC, kAcc, wr, acc);
      mbar_arrive(&empty[pair]);
      const float bias = __ldg(dwb + c);
#pragma unroll
      for (int i = 0; i < kR * kS; ++i) ts[i * C + c] = acc[i / kS][i % kS] + bias;
    }
  }
  __syncthreads();
  const long long plane = (long long)B * H * W * C;
  for (int p = warp; p < P; p += 2 * S + 1) {
    const int h = h0 + p / kTw, w = w0 + p % kTw;
    if (h >= H || w >= W) continue;
    float v[C / 32], s = 0.f;
#pragma unroll
    for (int j = 0; j < C / 32; ++j) s += v[j] = ts[p * C + 32 * j + lane];
    const float mean = warp_sum(s) * (1.0f / C);
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < C / 32; ++j) ss += (v[j] - mean) * (v[j] - mean);
    const float rstd = rsqrtf(warp_sum(ss) * (1.0f / C) + kLnEps);
    const size_t row = (((size_t)b * H + h) * W + w) * C;
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      const int c = 32 * j + lane;
      tf32x3::store_split(planes, plane, row + c, (v[j] - mean) * rstd * __ldg(lnw + c) + __ldg(lnb + c));
    }
  }
}

template <int C>
int launch_a(const float* x, const float* dww, const float* dwb, const float* lnw, const float* lnb, float* planes,
             int B, int H, int W, cudaStream_t s) {
  CUtensorMap xmap = {};
  cudaError_t err = nhwc_map(&xmap, x, B, H, W, C, kAcc, kBoxC, kAth + 2 * PAD);
  const int smem = 1024 + 4 * (16 * C + a_slots(C) * kAslot);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv_ln_a_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = B * ((H + kAth - 1) / kAth) * ((W + kTw - 1) / kTw);
  conv_ln_a_kernel<C><<<tiles, 32 * (2 * a_slots(C) + 1), smem, s>>>(xmap, dww, dwb, lnw, lnb, planes, B, H, W);
  return (int)cudaGetLastError();
}

template <int C>
int launch_b(const float* x, const float* dww, const float* dwb, const float* lnw, const float* lnb, float* planes,
             const Geom& g, int smem, cudaStream_t s) {
  CUtensorMap xmap = {};
  cudaError_t err = nhwc_map(&xmap, x, g.B, g.H, g.W, C, kCc, kBoxC, g.th + 2 * PAD);
  if (err == cudaSuccess) err = allow_smem<C>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = conv_ln_config(g, smem, C / kCc, s, attr);
  err = cudaLaunchKernelEx(&cfg, conv_ln_kernel<C>, xmap, dww, dwb, lnw, lnb, planes, g);
  return (int)(err == cudaSuccess ? cudaGetLastError() : err);
}

}  // namespace

extern "C" {

int probe_slots(int c) { return a_slots(c); }

// design: 0 = (a), 1 = (b) with the plan (th, tw, cc, cluster, slots, parts, smem).
int probe_conv_ln(int design, const float* x, const float* dww, const float* dwb, const float* lnw,
                  const float* lnb, float* planes, int B, int H, int W, int C, int th, int tw, int cc, int cluster,
                  int slots, int parts, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geom g;
  if (design == 1 && !make_geom(g, B, H, W, C, th, tw, cc, cluster, slots, parts, smem))
    return (int)cudaErrorInvalidValue;
#define TC_CASE(CC)                                                                                 \
  case CC:                                                                                          \
    return design == 0 ? launch_a<CC>(x, dww, dwb, lnw, lnb, planes, B, H, W, s)                    \
                       : launch_b<CC>(x, dww, dwb, lnw, lnb, planes, g, smem, s);
  switch (C) {
    TC_CASE(128)
    TC_CASE(256)
    TC_CASE(512)
    TC_CASE(1024)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TC_CASE
}

}  // extern "C"
"""


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main():
    sys.path.insert(0, ROOT)
    import torch

    from tpu_captioner_torch.core.backend import pin_f32_precision, require_cuda
    from tpu_captioner_torch.ops import _build
    from tpu_captioner_torch.ops.block_fused import _plan_on

    dev = require_cuda()
    pin_f32_precision()
    out_dir = os.path.join(ROOT, "build", "block_probe")
    os.makedirs(out_dir, exist_ok=True)
    src, lib_path = os.path.join(out_dir, "design_a.cu"), os.path.join(out_dir, "libdesign_a.so")
    with open(src, "w") as f:
        f.write(DESIGN_A)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.probe_conv_ln.restype = ctypes.c_int
    lib.probe_conv_ln.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    g = torch.Generator().manual_seed(0)
    f = lambda *sh: torch.randn(*sh, generator=g).to(dev)  # noqa: E731

    def graph_ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(iters):
                fn()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    rows = []
    for s, c in enumerate(DIMS):
        dww, dwb, lnw, lnb = 0.1 * f(7, 7, c), 0.1 * f(c), 1 + 0.1 * f(c), 0.1 * f(c)
        for batch in (8, 32):
            shape = (batch, 64 >> s, 64 >> s, c)
            x = f(*shape)
            plan = _plan_on(0, *shape)
            planes = {d: torch.zeros(2 * x.numel(), device=dev) for d in (0, 1)}

            def run(design):
                err = lib.probe_conv_ln(design, x.data_ptr(), dww.data_ptr(), dwb.data_ptr(), lnw.data_ptr(),
                                        lnb.data_ptr(), planes[design].data_ptr(), *shape, *plan.args(),
                                        _build.raw_stream(0))
                if err:
                    raise RuntimeError(f"design {'ab'[design]} failed at {shape}: CUDA error {err}")

            run(0)
            run(1)
            torch.cuda.synchronize()
            ln = {d: p[: x.numel()] + p[x.numel():] for d, p in planes.items()}  # hi + lo: LN(t) itself
            err = (ln[0] - ln[1]).abs().max().item() / max(1.0, ln[1].abs().max().item())
            if not err < 1e-5:
                raise AssertionError(f"designs (a) and (b) disagree at {shape}: {err}")
            rows.append({"shape": shape, "a_ms": graph_ms(lambda: run(0)), "b_ms": graph_ms(lambda: run(1)),
                         "bound_ms": 4 * 3 * x.numel() / 3.35e12 * 1e3, "a_slots": lib.probe_slots(c),
                         "b_plan": plan.args(), "rel_diff": err})
            print(json.dumps(rows[-1]), flush=True)
    depths = dict(zip(DIMS, (3, 3, 27, 3)))  # blocks per stage in an encoder pass
    passes = {}
    for batch in (8, 32):
        mine = [r for r in rows if r["shape"][0] == batch]
        for key, pick in (("a", lambda r: r["a_ms"]), ("b", lambda r: r["b_ms"]),
                          ("better", lambda r: min(r["a_ms"], r["b_ms"]))):
            passes[f"pass_b{batch}_{key}"] = sum(depths[r["shape"][3]] * pick(r) for r in mine)
    print(json.dumps({"card": card(), "rows": rows, "passes_ms": passes}))


if __name__ == "__main__":
    main()
