#!/usr/bin/env python3
"""Time the PyTorch port's depthwise-conv kernels of several checkouts on one card.

    python3 scripts/torch_dwconv_ab.py [--pairs A B] ROOT [ROOT ...]

Each ROOT is a checkout of the repository: this one, or another commit
unpacked with ``git archive`` into a git-ignored directory.  Each is timed in
a process of its own, in the order given, so that ``A B B A`` pairs two
commits on one card.  A process builds that checkout's ``dwconv.cu`` and
prints one JSON line of CUDA-event ms per launch of device time (the calls
captured in a CUDA graph and replayed, so that Python's dispatch does not
count), each as that checkout's ConvNeXt-Base block runs it (random inputs
from seed 0):
- ``fwd_s{s}_b{B}``: the forward with the block's bias at stage s (0-3:
  (64, 64, 128) .. (8, 8, 1024)) and batch B (8 serving, 32 train and eval):
  the conv kernel followed by ``+ bias`` where the checkout's kernel takes no
  bias, the kernel with the bias in its epilogue where it does;
- ``bias_add_s{s}_b{B}``: the separate ``+ bias`` pass alone, on the same
  shapes (what a checkout without the fused bias pays on top of its kernel);
- ``dx_s{s}`` and ``dw_s{s}`` at the fine-tune step's trained stages (2 and
  3, batch 32): the input gradient (the flipped filter), and the filter
  gradient with the bias gradient, as the step needs both: autograd's
  separate sum of the cotangent where the kernel gives no bias gradient;
- ``eager_fwd_s{s}_b{B}``: the forward again, issued call by call from
  Python as the encoder issues it (host dispatch included where it is the
  slower side);
- the sums: ``pass_b8`` and ``pass_b32`` (36 forwards, one encoder pass;
  ``eager_pass_b8`` and ``eager_pass_b32`` of the eager times),
  ``step_fwd`` (36 forwards + 29 input gradients per fine-tune step at
  starting_layer 5) and ``step_dw`` (27 + 3 filter gradients);
- the same in bf16 (the bf16 encoder's instances; bf16 x, filter, bias and
  cotangent), each key with ``_bf16`` at its end: ``fwd_s{s}_b{B}_bf16``
  (the forward with the bias in its epilogue), ``dx_s{s}_bf16``,
  ``dw_s{s}_bf16`` (with the bias gradient), ``pass_b8_bf16``,
  ``pass_b32_bf16``, ``step_fwd_bf16`` and ``step_dw_bf16``.
The last line is a table of each checkout's median per key, with the card's
name and power limit; with ``--pairs A B``, where the roots were given as A
B B A ..., it also gives per key the median of the differences A - B of the
pairs (run i of A against run i of B), their spread (max - min) and how many
pairs B won.
"""

import inspect
import json
import os
import statistics
import subprocess
import sys

DEPTHS, DIMS = (3, 3, 27, 3), (128, 256, 512, 1024)
D_X = {2: 26, 3: 3}  # input gradients per fine-tune step: every trained block but child 5's first
D_W = {2: 27, 3: 3}  # filter gradients per fine-tune step


def measure(root):
    """One checkout's times, in this process."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from tpu_captioner_torch.core.backend import pin_f32_precision, require_cuda
    from tpu_captioner_torch.ops.dwconv import dwconv_filter_grad, dwconv_forward

    dev = require_cuda()
    pin_f32_precision()
    fused_bias = "bias" in inspect.signature(dwconv_forward).parameters
    fused_bias_grad = "bias_grad" in inspect.signature(dwconv_filter_grad).parameters
    g = torch.Generator().manual_seed(0)
    f = lambda *sh: torch.randn(*sh, generator=g).to(dev)  # noqa: E731

    def time_ms(fn, iters=50, warmup=5, eager=False):
        """Device ms per call: ``iters`` calls captured in one CUDA graph
        and replayed, so that the host's dispatch does not count; with
        ``eager``, the calls issued one by one from Python as a caller
        issues them."""
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

    def forward(x, w, b):
        return dwconv_forward(x, w, bias=b) if fused_bias else dwconv_forward(x, w) + b

    def filter_grad(x, cot):
        if fused_bias_grad:
            return dwconv_filter_grad(x, cot, bias_grad=True)
        return dwconv_filter_grad(x, cot), cot.sum(dim=(0, 1, 2))

    out = {}
    with torch.no_grad():
        for s, c in enumerate(DIMS):
            side = 64 >> s
            w, b = 0.1 * f(7, 7, c), f(c)
            for batch in (8, 32):
                x = f(batch, side, side, c)
                out[f"fwd_s{s}_b{batch}"] = time_ms(lambda: forward(x, w, b))
                out[f"eager_fwd_s{s}_b{batch}"] = time_ms(lambda: forward(x, w, b), eager=True)
                y = forward(x, w, b)
                out[f"bias_add_s{s}_b{batch}"] = time_ms(lambda: y + b)
            if s in D_X:
                cot = f(32, side, side, c)
                out[f"dx_s{s}"] = time_ms(lambda: dwconv_forward(cot, w, flip=True))
                out[f"dw_s{s}"] = time_ms(lambda: filter_grad(x, cot), iters=20)
        bf = torch.bfloat16
        for s, c in enumerate(DIMS):
            side = 64 >> s
            w, b = (0.1 * f(7, 7, c)).to(bf), (0.1 * f(c)).to(bf)
            for batch in (8, 32):
                x = f(batch, side, side, c).to(bf)
                out[f"fwd_s{s}_b{batch}_bf16"] = time_ms(lambda: dwconv_forward(x, w, bias=b))
            if s in D_X:
                cot = f(32, side, side, c).to(bf)
                out[f"dx_s{s}_bf16"] = time_ms(lambda: dwconv_forward(cot, w, flip=True))
                out[f"dw_s{s}_bf16"] = time_ms(lambda: dwconv_filter_grad(x, cot, bias_grad=True), iters=20)
    for end in ("", "_bf16"):
        for batch in (8, 32):
            for pre in ("", "eager_") if not end else ("",):
                out[f"{pre}pass_b{batch}{end}"] = sum(d * out[f"{pre}fwd_s{s}_b{batch}{end}"]
                                                      for s, d in enumerate(DEPTHS))
        out[f"step_fwd{end}"] = out[f"pass_b32{end}"] + sum(n * out[f"dx_s{s}{end}"] for s, n in D_X.items())
        out[f"step_dw{end}"] = sum(n * out[f"dw_s{s}{end}"] for s, n in D_W.items())
    out["fused_bias"] = float(fused_bias)
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
