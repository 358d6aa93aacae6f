#!/usr/bin/env python3
"""Time the PyTorch port's whole-block kernel (``use_pallas='block'``) and its
dropout pool kernel for several checkouts on one card.

    python3 scripts/torch_block_ab.py [--pairs A B] ROOT [ROOT ...]
    python3 scripts/torch_block_ab.py --profile ROOT

Each ROOT is a checkout of the repository: this one, or another commit
unpacked with ``git archive`` into a git-ignored directory.  Each is timed in
a process of its own, in the order given, so that ``A B B A`` pairs two
commits on one card.  A process builds that checkout's ``block_fused.cu`` and
``dropout_mask.cu`` and prints one JSON line (random inputs from seed 0):
- ``block_s{s}_b{B}``: device ms per ``fused_convnext_block`` call (the
  calls captured in a CUDA graph and replayed, so that Python's dispatch
  does not count) at stage s (0-3: (64, 64, 128) .. (8, 8, 1024)) and batch
  B (8: serving, all-one scales; 32: train and eval, per-image scales, a
  third of the images dropped);
- ``eager_block_s{s}_b{B}``: the same calls issued one by one from Python,
  as the encoder issues them (host dispatch included where it is the
  slower side);
- ``pass_b8``, ``pass_b32`` and their ``eager_`` forms: one encoder pass,
  36 blocks (3, 3, 27, 3 per stage);
- ``bf16_block_s{s}_b{B}`` and ``bf16_pass_b{B}``: the same device ms of
  the bf16 instance (x, the taps, W1 and W2 bf16, the rest f32, as the
  bf16 encoder calls it in ``'block'``), asserting that each call ran it;
- ``pool_ms``: device ms of the flagship train step's dropout pool
  (29,366,272 bits); ``pool_host_us``: host us per pool wrapper call (a
  4096-bit pool, 2000 calls, no synchronise inside the loop).
With ``--profile`` it prints instead, for the one checkout, the device ms
per call of each kernel a block call launches (torch.profiler kernel rows
over 10 calls) at each stage and batch, grouped by kernel name, beside the
conv + LayerNorm launch's bytes bound, and their sums over an encoder pass.
The last line is a table of each checkout's median per key, with the card's
name and power limit; with ``--pairs A B``, where the roots were given as A
B B A ..., it also gives per key the median of the differences A - B of the
pairs (run i of A against run i of B), their spread (max - min) and how many
pairs B won.
"""

import json
import os
import statistics
import subprocess
import sys
import time

DEPTHS, DIMS = (3, 3, 27, 3), (128, 256, 512, 1024)
POOL_N = 29_366_272


def measure(root):
    """One checkout's times, in this process."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from tpu_captioner_torch.core.backend import pin_f32_precision, require_cuda
    from tpu_captioner_torch.ops.block_fused import fused_convnext_block
    from tpu_captioner_torch.ops.dropout_mask import random_mask_pool

    dev = require_cuda()
    pin_f32_precision()
    g = torch.Generator().manual_seed(0)
    f = lambda *sh: torch.randn(*sh, generator=g).to(dev)  # noqa: E731

    def time_ms(fn, iters=10, warmup=3, eager=False):
        """Device ms per call: ``iters`` calls captured in one CUDA graph
        and replayed; with ``eager``, the calls issued one by one."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        if not eager:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="relaxed"):
                for _ in range(iters):
                    fn()
            graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        if eager:
            for _ in range(iters):
                fn()
        else:
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    out = {}
    with torch.no_grad():
        for s, c in enumerate(DIMS):
            side = 64 >> s
            params = (0.1 * f(7, 7, c), 0.1 * f(c), 1 + 0.1 * f(c), 0.1 * f(c), 0.02 * f(4 * c, c),
                      0.1 * f(4 * c), 0.02 * f(c, 4 * c), 0.1 * f(c), 0.5 * f(c))
            for batch in (8, 32):
                x = f(batch, side, side, c)
                sd = torch.ones(batch, device=dev) if batch == 8 else (torch.arange(batch, device=dev) % 3 != 0) * 1.5
                args = (x, sd.float(), *params)
                out[f"block_s{s}_b{batch}"] = time_ms(lambda: fused_convnext_block(*args))
                out[f"eager_block_s{s}_b{batch}"] = time_ms(lambda: fused_convnext_block(*args), eager=True)
                a16 = tuple(a.to(torch.bfloat16) if i in (0, 2, 6, 8) else a for i, a in enumerate(args))
                before = fused_convnext_block.bf16_launches
                out[f"bf16_block_s{s}_b{batch}"] = time_ms(lambda: fused_convnext_block(*a16))
                if fused_convnext_block.bf16_launches == before:
                    raise SystemExit(f"{root}: the bf16 call at stage {s} did not launch the bf16 instance")
        for batch in (8, 32):
            for pre in ("", "eager_", "bf16_"):
                out[f"{pre}pass_b{batch}"] = sum(d * out[f"{pre}block_s{s}_b{batch}"] for s, d in enumerate(DEPTHS))
        seed = (0x9E3779B9, 7)
        out["pool_ms"] = time_ms(lambda: random_mask_pool(seed, POOL_N, 0.5, dev), iters=50)
        for _ in range(50):
            random_mask_pool(seed, 4096, 0.5, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            random_mask_pool(seed, 4096, 0.5, dev)
        out["pool_host_us"] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    return out


def profile(root):
    """Device ms per block call of each kernel it launches, by name."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    from tpu_captioner_torch.core.backend import pin_f32_precision, require_cuda
    from tpu_captioner_torch.ops.block_fused import fused_convnext_block

    dev = require_cuda()
    pin_f32_precision()
    g = torch.Generator().manual_seed(0)
    f = lambda *sh: torch.randn(*sh, generator=g).to(dev)  # noqa: E731
    calls, out = 10, {}
    with torch.no_grad():
        for s, c in enumerate(DIMS):
            params = (0.1 * f(7, 7, c), 0.1 * f(c), 1 + 0.1 * f(c), 0.1 * f(c), 0.02 * f(4 * c, c),
                      0.1 * f(4 * c), 0.02 * f(c, 4 * c), 0.1 * f(c), 0.5 * f(c))
            for batch in (8, 32):
                args = (f(batch, 64 >> s, 64 >> s, c), torch.ones(batch, device=dev), *params)
                for _ in range(3):
                    fused_convnext_block(*args)
                torch.cuda.synchronize()
                with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(calls):
                        fused_convnext_block(*args)
                    torch.cuda.synchronize()
                rows = {}
                for e in prof.key_averages():
                    if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
                        continue
                    name = next((k for k in ("conv_ln_kernel", "HiddenEpi", "OutEpi", "split_kernel",
                                             "block_fused_kernel") if k in e.key), e.key[:60])
                    rows[name] = rows.get(name, 0.0) + e.self_device_time_total / 1e3 / calls
                # The conv + LayerNorm launch's least time: x read, the two
                # planes written, the taps, conv bias and LayerNorm weights
                # read, at 3.35 TB/s (its 98 N C flops take less at 67 TFLOP/s).
                n = batch * (64 >> s) ** 2
                rows["conv_ln bound"] = 4 * (3 * n * c + 52 * c) / 3.35e12 * 1e3
                out[f"s{s}_b{batch}"] = rows
    for batch in (8, 32):  # one encoder pass: 36 blocks
        total = {}
        for s, d in enumerate(DEPTHS):
            for name, ms in out[f"s{s}_b{batch}"].items():
                total[name] = total.get(name, 0.0) + d * ms
        out[f"pass_b{batch}"] = total
    return out


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--profile":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(json.dumps({"card": card, "ms_per_call_by_kernel": profile(sys.argv[2])}))
        return
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])))
        return
    roots, pairs = sys.argv[1:], None
    if roots[:1] == ["--pairs"]:
        pairs, roots = roots[1:3], roots[3:]
    if not roots:
        raise SystemExit(__doc__)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    runs = {}
    for root in roots:
        line = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[-1]
        print(f"{root}: {line}", flush=True)
        runs.setdefault(root, []).append(json.loads(line))
    table = {root: {k: statistics.median(r[k] for r in rs) for k in rs[0]} for root, rs in runs.items()}
    summary = {"card": card, "median_ms": table}
    if pairs:
        a, b = (runs[root] for root in pairs)
        summary["pairs"] = {}
        for k in a[0]:
            diffs = [x[k] - y[k] for x, y in zip(a, b)]
            summary["pairs"][k] = {"n": len(diffs), "median_a_minus_b": statistics.median(diffs),
                                   "spread": max(diffs) - min(diffs), "b_won": sum(d > 0 for d in diffs)}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
