#!/usr/bin/env python3
"""Split a cooperative decode kernel's per-phase cost into barrier and work.

    python3 scripts/decode_barrier_probe.py [--out results/barrier_probe.json]

Builds a throwaway CUDA kernel (the source is in this file) into
``build/probe/`` and launches it cooperatively over every SM, 256 threads a
block, as the decode kernels of ``tpu_captioner_torch/csrc/decode_step.cu``
are launched.  The kernel runs N phases; the cost of a phase is the time of
an N-phase launch less that of a 0-phase launch, over N (CUDA events).  A
phase is, in turn:

- ``sync``: a grid-wide barrier only, ``cg::grid_group::sync()``, at 1, 2
  and 3 blocks per SM;
- ``counter``: a grid-wide barrier only, one release/acquire arrival counter
  (an atomic add, then a spin on an acquire load), at 1 block per SM;
- ``stage-threads`` / ``stage-bulk``: each block writes its share of an
  (R, 512) f32 matrix, a barrier, then every block reads the whole matrix
  into shared memory, with float4 loads past L1 (``threads``) or with one
  bulk copy (``cp.async.bulk``) that completes on an mbarrier (``bulk``):
  what a product phase of the decode layer does before its first
  multiply-add, at R = 40 (8 images x beam 5), 160 (32 x 5) and 32.

Prints one JSON line per measurement and a last line with all of them and
the card's name and power limit (nvidia-smi).
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS, E = 256, 512

SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
namespace cg = cooperative_groups;

__device__ __forceinline__ uint32_t su32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void counter_barrier(unsigned* ctr, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(ctr) : "memory");
    while (ld_acquire(ctr) < target) {
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(256) probe(float* buf, unsigned* ctr, int n, int kind, int stage,
                                             int rows, int E, float* sink) {
  extern __shared__ __align__(128) float sm[];
  __shared__ __align__(8) uint64_t bar;
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, b = blockIdx.x;
  const int total = rows * E;
  const int window = 32768;  // floats of shared memory the reads land in (128 KB)
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(su32(&bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  float acc = 0.f;
  for (int i = 0; i < n; ++i) {
    float* cur = buf + (size_t)(i & 1) * total;
    if (stage)
      for (int j = b * 256 + threadIdx.x; j < total; j += G * 256) cur[j] = (float)(i + j);
    if (kind == 0)
      grid.sync();
    else
      counter_barrier(ctr, (unsigned)(i + 1) * G);
    if (stage == 1) {
      for (int j = 4 * threadIdx.x; j < total; j += 4 * 256)
        *reinterpret_cast<float4*>(sm + j % window) = __ldcg(reinterpret_cast<const float4*>(cur + j));
      __syncthreads();
      acc += sm[(threadIdx.x * 37) % window];
    } else if (stage == 2) {
      if (threadIdx.x == 0) {
        asm volatile("fence.proxy.async.global;" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(su32(&bar)),
                     "r"(total * 4) : "memory");
        for (int j = 0; j < total; j += 8192)  // 32 KB pieces
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
                  "r"(su32(sm + j % window)), "l"(cur + j), "r"(min(8192, total - j) * 4), "r"(su32(&bar))
              : "memory");
      }
      uint32_t done = 0;
      while (!done)
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(su32(&bar)), "r"(i & 1) : "memory");
      acc += sm[(threadIdx.x * 37) % window];
      __syncthreads();
    }
  }
  if (acc == 12345.f) sink[0] = acc;
}

extern "C" int probe_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

extern "C" int probe_launch(float* buf, unsigned* ctr, int n, int kind, int stage, int rows, int E,
                            float* sink, int grid, int smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&buf, &ctr, &n, &kind, &stage, &rows, &E, &sink};
  err = cudaLaunchCooperativeKernel((void*)probe, dim3(grid), dim3(256), args, (size_t)smem,
                                    (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
"""


def build():
    out_dir = os.path.join(ROOT, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    src, lib = os.path.join(out_dir, "barrier_probe.cu"), os.path.join(out_dir, "libbarrier_probe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib, src], check=True)
    return ctypes.CDLL(lib)


class Probe:
    """The built probe on the current card, with its buffers."""

    def __init__(self, phases=2000):
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("needs a CUDA device")
        self.torch, self.phases = torch, phases
        self.lib = lib = build()
        lib.probe_launch.restype = ctypes.c_int
        lib.probe_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        self.sms = lib.probe_sms()
        dev = torch.device("cuda", 0)
        self.buf = torch.zeros(2 * 160 * E, device=dev)
        self.ctr = torch.zeros(1, dtype=torch.int32, device=dev)
        self.sink = torch.zeros(1, device=dev)
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(self, n, kind, stage, rows, grid, smem):
        self.ctr.zero_()
        err = self.lib.probe_launch(self.buf.data_ptr(), self.ctr.data_ptr(), n, kind, stage, rows, E,
                                    self.sink.data_ptr(), grid, smem, self.stream)
        if err:
            raise RuntimeError(f"probe launch failed: CUDA error {err}")

    def per_phase_us(self, kind, stage, rows, grid, smem, reps=5):
        """(us per phase, us of a launch of no phases)."""
        torch, times = self.torch, {}
        for n in (0, self.phases):
            self.launch(n, kind, stage, rows, grid, smem)  # warm-up
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                self.launch(n, kind, stage, rows, grid, smem)
            end.record()
            torch.cuda.synchronize()
            times[n] = start.elapsed_time(end) / reps * 1e3
        return (times[self.phases] - times[0]) / self.phases, times[0]


def barrier_us(phases=2000):
    """us per ``grid.sync()`` of a cooperative launch of one 256-thread
    block per SM, as the decode kernels launch."""
    probe = Probe(phases)
    return probe.per_phase_us(0, 0, 0, probe.sms, 1024)[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    ap.add_argument("--phases", type=int, default=2000)
    args = ap.parse_args()
    probe = Probe(args.phases)
    sms = probe.sms
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    results = []
    cases = [("sync", 0, 0, 0, k) for k in (1, 2, 3)] + [("counter", 1, 0, 0, 1)]
    for rows in (32, 40, 160):
        for kind, kname in ((0, "sync"), (1, "counter")):
            cases += [(f"stage-threads {kname}", kind, 1, rows, 1), (f"stage-bulk {kname}", kind, 2, rows, 1)]
    for name, kind, stage, rows, per_sm in cases:
        smem = 128 * 1024 if stage else 1024
        if per_sm > 1:
            smem = 16 * 1024
        us, launch_us = probe.per_phase_us(kind, stage, rows, sms * per_sm, smem)
        res = {"phase": name, "rows": rows, "blocks": sms * per_sm, "us_per_phase": us,
               "empty_launch_us": launch_us}
        results.append(res)
        print(json.dumps(res), flush=True)
    final = {"card": card, "sms": sms, "phases": args.phases, "results": results}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(final, f, indent=1)
    print(json.dumps(final))


if __name__ == "__main__":
    sys.exit(main())
