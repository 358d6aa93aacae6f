#!/usr/bin/env python3
"""Probe the dropout pool kernel (``csrc/dropout_mask.cu``) on one card: its
instruction mix, what the card's integer units give, and its time.

    python3 scripts/pool_probe.py [sass] [rates] [times]   (all three by default)

- ``sass``: from ``cuobjdump -sass`` of the built library, the opcodes of
  ``mask_pool_kernel``'s grid-stride loop (the body between the loop's
  backward branch and its target), counted by class; the loop runs one
  Philox4x32-10 call (four pool elements) per thread per trip.  The whole
  listing goes to ``build/pool_probe/mask_pool.sass``.
- ``rates``: instructions and 32-bit results per clock per SM of the
  multiplies the loop issues, each alone (IMAD.WIDE.U32 from
  ``mad.wide.u32``, IMAD.HI.U32 from ``mul.hi.u32``), and Philox rounds
  (two IMAD.WIDE and two LOP3 each) per clock per SM, from ``clock64``
  around unrolled chains in 32 warps on every SM: clock cycles, so the SM
  clock does not enter.  The CUDA C++ Programming Guide's throughput table
  gives 64 results per clock per SM for 32-bit integer multiplies and
  multiply-adds, and for adds, compares and bitwise operations, at
  compute capability 9.0.
- ``times``: device ms (CUDA-graph replay) and eager ms of the pool kernel
  at the flagship step's 29,366,272 elements, and host us per wrapper call.
Every line names the card and its power limit; the build goes under
``build/pool_probe/``.
"""

import collections
import ctypes
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POOL_N = 29_366_272
RATE_SRC = r"""
#include <cstdint>
#define CHAINS 8
#define TRIPS 256
extern "C" __global__ void __launch_bounds__(1024) rate_kernel(int op, uint32_t seed, uint32_t* out,
                                                               long long* cycles) {
  uint32_t a[CHAINS], b[CHAINS];
  for (int i = 0; i < CHAINS; ++i) { a[i] = seed * (threadIdx.x + 3 * i + 1); b[i] = a[i] ^ 0x9E3779B9u; }
  const uint32_t m = 0xD2511F53u;
  __syncthreads();
  const long long t0 = clock64();
  if (op == 0) {  // IMAD.WIDE.U32: (b:a) = a * m + (b:a), both halves carried, so nothing folds
    for (int t = 0; t < TRIPS; ++t)
#pragma unroll
      for (int i = 0; i < CHAINS; ++i)
        asm volatile("{.reg .u64 p, q; mov.b64 q, {%0, %1}; mad.wide.u32 p, %0, %2, q; mov.b64 {%0, %1}, p;}"
                     : "+r"(a[i]), "+r"(b[i]) : "r"(m));
  } else if (op == 1) {  // IMAD.HI.U32: a = hi(a * m)
    for (int t = 0; t < TRIPS; ++t)
#pragma unroll
      for (int i = 0; i < CHAINS; ++i) asm volatile("mul.hi.u32 %0, %0, %1;" : "+r"(a[i]) : "r"(m));
  } else {  // one Philox round on CHAINS / 2 counters of two words each
    for (int t = 0; t < TRIPS; ++t)
#pragma unroll
      for (int i = 0; i < CHAINS; i += 2)
        asm volatile("{.reg .u64 p, q; .reg .u32 h0, l0, h1, l1;"
                     " mul.wide.u32 p, %0, %4; mul.wide.u32 q, %2, %5;"
                     " mov.b64 {l0, h0}, p; mov.b64 {l1, h1}, q;"
                     " lop3.b32 %0, h1, %1, %4, 0x96; mov.b32 %1, l1;"
                     " lop3.b32 %2, h0, %3, %5, 0x96; mov.b32 %3, l0;}"
                     : "+r"(a[i]), "+r"(b[i]), "+r"(a[i + 1]), "+r"(b[i + 1]) : "r"(m), "r"(seed));
  }
  const long long t1 = clock64();
  uint32_t acc = 0;
  for (int i = 0; i < CHAINS; ++i) acc ^= a[i] ^ b[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}
"""
LAUNCHER = r"""
extern "C" int launch_rate(int op, unsigned seed, void* out, void* cycles, int blocks) {
  rate_kernel<<<blocks, 1024>>>(op, seed, (uint32_t*)out, (long long*)cycles);
  return (int)cudaDeviceSynchronize();
}
"""
# (name, 32-bit results per instruction); the last row is the Philox round.
RATE_OPS = (("IMAD.WIDE.U32", 2), ("IMAD.HI.U32", 1), ("Philox round (2 IMAD.WIDE + 2 LOP3, per counter)", None))
# A chain of multiplies by one constant, of adds or of xors would be folded
# by the compiler (a * m * m = a * m^2): no row times those classes.


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def sass():
    sys.path.insert(0, ROOT)
    from chip_smoke import library_sass, loop_opcodes
    from tpu_captioner_torch.ops import _build

    text = library_sass("dropout_mask")
    counts = loop_opcodes(text, "mask_pool_kernel")
    os.makedirs(os.path.join(ROOT, "build", "pool_probe"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "pool_probe", "mask_pool.sass"), "w") as f:
        f.write(text)
    print(json.dumps({"probe": "sass", "library": os.path.relpath(_build.build("dropout_mask"), ROOT),
                      "loop_opcodes": dict(counts), "loop_instructions": sum(counts.values()),
                      "card": card()}), flush=True)


def rates():
    import torch

    out_dir = os.path.join(ROOT, "build", "pool_probe")
    os.makedirs(out_dir, exist_ok=True)
    src, lib_path = os.path.join(out_dir, "rate.cu"), os.path.join(out_dir, "librate.so")
    with open(src, "w") as f:
        f.write(RATE_SRC + LAUNCHER)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib_path, src], check=True)
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, check=True).stdout
    lib = ctypes.CDLL(lib_path)
    lib.launch_rate.argtypes = [ctypes.c_int, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 1024, dtype=torch.int32, device="cuda")
    cycles = torch.empty(sms, dtype=torch.int64, device="cuda")
    rows = []
    for op, (name, results) in enumerate(RATE_OPS):
        best = None
        for _ in range(3):
            err = lib.launch_rate(op, 12345, out.data_ptr(), cycles.data_ptr(), sms)
            if err:
                raise RuntimeError(f"rate kernel failed: CUDA error {err}")
            c = int(cycles.max().item())
            best = c if best is None else min(best, c)
        steps = 1024 * 256 * 8  # a block's lanes x trips x chains, one block (32 warps) per SM
        if results is None:  # the Philox round: per counter (two chains) per round
            rows.append({"class": name, "cycles": best, "rounds_per_clock_per_sm": steps / 2 / best})
        else:
            rows.append({"class": name, "cycles": best, "instructions_per_clock_per_sm": steps / best,
                         "results_per_clock_per_sm": steps * results / best})
    ops = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", m.group(1).strip()).split()[0]
                              for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", text))
    print(json.dumps({"probe": "rates", "rows": rows, "card": card(),
                      "sass": {k: v for k, v in ops.items() if k.startswith(("IMAD", "LOP3"))}}), flush=True)


def times():
    import torch

    sys.path.insert(0, ROOT)
    from chip_smoke import _graph_ms, _time_ms
    from tpu_captioner_torch.ops.dropout_mask import random_mask_pool

    seed, keep = (0x9E3779B9, 7), 0.5
    random_mask_pool(seed, POOL_N, keep, "cuda")
    graph = _graph_ms(lambda: random_mask_pool(seed, POOL_N, keep, "cuda"), iters=50)
    eager = _time_ms(lambda: random_mask_pool(seed, POOL_N, keep, "cuda"), iters=50)
    torch.cuda.synchronize()
    calls = 2000
    t0 = time.perf_counter()
    for _ in range(calls):
        random_mask_pool(seed, 4096, keep, "cuda")
    host_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    print(json.dumps({"probe": "times", "n": POOL_N, "graph_ms": graph, "eager_ms": eager,
                      "host_us_per_call": host_us, "card": card()}), flush=True)


def main():
    which = sys.argv[1:] or ["sass", "rates", "times"]
    for name in which:
        {"sass": sass, "rates": rates, "times": times}[name]()


if __name__ == "__main__":
    main()
