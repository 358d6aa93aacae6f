#!/usr/bin/env python3
"""Time the PyTorch port's LSTM step kernel of several checkouts on one card.

    python3 scripts/torch_lstm_ab.py [--pairs A B] ROOT [ROOT ...]

Each ROOT is a checkout of the repository: this one, or another commit
unpacked with ``git archive`` into a git-ignored directory.  Each is timed in
a process of its own, in the order given, so that ``A B B A`` pairs two
commits on one card.  A process builds that checkout's ``lstm_step.cu`` and
prints one JSON line with, for each shape ``r{R}_e{E}`` (R rows at the
model's widths D = A = 512, C = 1024, P = 49, embedding width E: the bs-8
beam's 40 rows, the bs-32 beam's 160, the eval step's 32, and 40 at
word2vec's E = 300; seeded weights U(+-1/sqrt(fan-in)) and N(0, 1) inputs,
as ``chip_smoke.py:check_lstm`` draws them):
- ``r{R}_e{E}``: device ms per call, the calls captured in one CUDA graph
  and replayed, so that Python's dispatch does not count (the weights and
  inputs stay in the 50 MB L2 from call to call, as in a decode loop);
- ``eager_r{R}_e{E}``: ms per call issued one by one from Python, as the
  beam issues them (host dispatch included where it is the slower side);
- ``cold_r{R}_e{E}``: device ms per call with L2 emptied before each: a
  128 MiB buffer zeroed between the calls in the graph, less the zeroing's
  own time in a graph of its own;
- ``host_us_r{R}_e{E}``: host microseconds per wrapper call, from the
  host's clock around 200 calls issued back to back (no synchronise inside).
The last line is a table of each checkout's median per key, with the card's
name and power limit and the bound of each shape (``chip_smoke.py:
lstm_bound``); with ``--pairs A B``, where the roots
were given as A B B A ..., it also gives per key the median of the
differences A - B of the pairs (run i of A against run i of B), their
spread (max - min) and how many pairs B won.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((40, 512), (160, 512), (32, 512), (40, 300))  # (R, E)
D, A, C, P = 512, 512, 1024, 49
COLD_BYTES = 128 << 20  # more than twice the 50 MB L2


def measure(root):
    """One checkout's times, in this process."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from tpu_captioner_torch.core.backend import pin_f32_precision, require_cuda
    from tpu_captioner_torch.ops.lstm_step import LstmStepWeights, fused_lstm_step

    dev = require_cuda()
    pin_f32_precision()
    flush = torch.empty(COLD_BYTES // 4, device=dev)

    def graph_ms(fns, iters=50, warmup=3):
        """Device ms per round of ``fns``: ``iters`` rounds captured in one
        CUDA graph and replayed between CUDA events."""
        for _ in range(warmup):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(iters):
                for fn in fns:
                    fn()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def profiled_ms(fn, iters=20):
        """Device ms per call from torch.profiler's kernel rows, where a
        graph refuses to capture the launch."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if "lstm" in e.key]
        return sum(getattr(e, "device_time_total", 0) or e.cuda_time_total for e in rows) / 1e3 / iters

    def eager_ms(fn, iters=50, warmup=3):
        for _ in range(warmup):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def host_us(fn, iters=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / iters * 1e6

    out = {}
    with torch.inference_mode():
        zero_ms = graph_ms([flush.zero_], iters=20)
        for R, E in SHAPES:
            g = torch.Generator().manual_seed(R + E)
            u = lambda fan_in, *sh: ((torch.rand(*sh, generator=g) * 2 - 1) / math.sqrt(fan_in)).to(dev)  # noqa: E731
            f = lambda *sh: torch.randn(*sh, generator=g).to(dev)  # noqa: E731
            w = LstmStepWeights(u(D, A, D), u(D, A), u(A, A), u(A, 1), u(D, C, D), u(D, C),
                                u(D, 4 * D, E), u(D, 4 * D, C), u(D, 4 * D, D), u(D, 4 * D))
            args = (w, f(R, E), f(R, D), f(R, D), f(R, P, C), f(R, P, A))
            call = lambda: fused_lstm_step(*args)  # noqa: E731
            key = f"r{R}_e{E}"
            try:
                out[key] = graph_ms([call])
                out[f"cold_{key}"] = graph_ms([flush.zero_, call], iters=20) - zero_ms
            except RuntimeError as err:  # the launch did not capture: say so, time it by the profiler
                print(f"graph capture refused at {key}: {err}", file=sys.stderr)
                torch.cuda.synchronize()
                out[key] = profiled_ms(call)
                out[f"cold_{key}"] = profiled_ms(lambda: (flush.zero_(), call()))
            out[f"eager_{key}"] = eager_ms(call)
            out[f"host_us_{key}"] = host_us(call)
    return out


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])))
        return
    roots, pairs = sys.argv[1:], None
    if roots[:1] == ["--pairs"]:
        pairs, roots = roots[1:3], roots[3:]
    if not roots:
        raise SystemExit(__doc__)
    sys.path.insert(0, HERE)
    from chip_smoke import lstm_bound

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    runs = {}
    for root in roots:
        line = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[-1]
        print(f"{root}: {line}", flush=True)
        runs.setdefault(root, []).append(json.loads(line))
    table = {root: {k: statistics.median(r[k] for r in rs) for k in rs[0]} for root, rs in runs.items()}
    bounds = {f"r{R}_e{E}": lstm_bound(R, E, D, A, C, P) for R, E in SHAPES}
    summary = {"card": card, "bound_ms": bounds, "median_ms": table}
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
