#!/usr/bin/env python3
"""Time the PyTorch port's MLP-tail kernels of several checkouts on one card.

    python3 scripts/torch_mlp_ab.py [--pairs A B] ROOT [ROOT ...]

Each ROOT is a checkout of the repository: this one, or another commit
unpacked with ``git archive`` into a git-ignored directory.  Each is timed in
a process of its own, in the order given, so that ``A B B A`` pairs two
commits on one card.  A process builds that checkout's ``mlp_block.cu`` and
``mlp_block_bwd.cu`` and prints one JSON line of ms per launch (seeded
inputs, per-image stochastic-depth rows):

- ``C={c}``: CUDA-event ms of ``fused_convnext_mlp``'s whole-tile path
  (``TPU_CAPTIONER_MLP_SUB`` unset) at the four ConvNeXt-Base stage shapes
  at batch 32 (N = 32 x 64^2 .. 32 x 8^2 rows), launches issued one by one;
  ``encoder_pass``: their sum over one encoder pass (3, 3, 27 and 3
  launches);
- ``bwd C={c}``, ``finetune_step_bwd``: the same for
  ``fused_convnext_mlp_bwd`` at the fine-tune step's two trainable stages
  at batch 32 (C = 512 and 1024; 27 and 3 launches a step);
- ``sub``: the sub-tile rows this checkout's sub-tiled path ran at, the
  first of 64, 8, 16, 32 and 4 that its own ``_pipeline_sub`` takes at every
  width (the script asserts that each call raised ``pipelined_launches``: a
  value a checkout rejects would time its whole tile);
- ``sub C={c} bs{B}`` and ``whole C={c} bs{B}``: device ms of the
  sub-tiled and the whole-tile path (calls captured in a CUDA graph and
  replayed, so that Python's dispatch does not count) at each stage at
  batch 8 and 32; ``sub pass bs{B}`` and ``whole pass bs{B}``: their sums
  over one encoder pass; ``sub bf16 C={c} bs{B}`` and ``sub bf16 pass
  bs{B}``, where the checkout has the sub-tiled bf16 instance: the same
  on bf16 x, residual, W1 and W2 (asserting that
  ``pipelined_bf16_launches`` rose);
- ``bf16 C={c}`` and ``bf16 pass``, where the checkout has the bf16
  instance: the same device ms of ``fused_convnext_mlp`` on bf16 x,
  residual, W1 and W2 at batch 32, and their sum over one encoder pass;
  ``bf16 C={c} | {kernel}``: each kernel's device ms per call;
- ``bwd bf16 C={c}`` and ``finetune_step_bwd_bf16``, where the checkout has
  the bf16 backward: device ms of ``fused_convnext_mlp_bwd`` on bf16 g, x,
  W1 and W2 at the fine-tune step's two stages, and their sum over a step;
  ``bwd bf16 C={c} | {kernel}``: each kernel's device ms per call of it
  (``torch.profiler``, summed over the kernel's launches in the call).

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

DEPTHS, DIMS, BATCH = (3, 3, 27, 3), (128, 256, 512, 1024), 32
SUB_CANDIDATES = (64, 8, 16, 32, 4)


def measure(root):
    """One checkout's times, in this process."""
    sys.path.insert(0, os.path.abspath(root))
    os.environ.pop("TPU_CAPTIONER_MLP_SUB", None)
    import torch

    from tpu_captioner_torch.core.backend import pin_f32_precision, require_cuda
    from tpu_captioner_torch.ops import mlp_block
    from tpu_captioner_torch.ops.mlp_block import fused_convnext_mlp, fused_convnext_mlp_bwd

    dev = require_cuda()
    pin_f32_precision()

    def time_ms(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def graph_ms(fn, iters=10, warmup=3):
        for _ in range(warmup):
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

    def launch_ms(fn, prefix, calls=3):
        """Each kernel's device ms per call of ``fn``, by short name, after a
        warm-up call inside the profiler's schedule (a window that starts
        with the calls it counts loses the first call's kernels)."""
        from torch.profiler import ProfilerActivity, profile, schedule

        fn()
        torch.cuda.synchronize()
        windows = []  # the recorded window's averages, taken before the profiler clears them
        with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=calls, repeat=1),
                     on_trace_ready=lambda p: windows.append(p.key_averages())) as prof:
            for _ in range(calls + 1):
                fn()
                torch.cuda.synchronize()
                prof.step()
        got = {}
        for e in windows[-1]:
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            name = e.key.replace("void ", "").replace("(anonymous namespace)::", "")[:70]
            got[f"{prefix} | {name} x{e.count // calls}"] = e.self_device_time_total / 1e3 / calls
        return got

    def stage_args(s, c, batch):
        g = torch.Generator().manual_seed(c + batch)
        f = lambda *sh: torch.randn(*sh, generator=g)  # noqa: E731
        n = batch * (64 >> s) ** 2
        sd = ((torch.rand(batch, generator=g) < 0.8) / 0.8).repeat_interleave(n // batch)
        return tuple(a.to(dev) for a in (
            f(n, c), f(n, c), sd, 1 + 0.1 * f(c), 0.1 * f(c),
            0.02 * f(4 * c, c), 0.1 * f(4 * c), 0.02 * f(c, 4 * c), 0.1 * f(c), 0.5 * f(c),
        ))

    sub = next((v for v in SUB_CANDIDATES if all(_sub_takes(mlp_block, v, c) for c in DIMS)), None)
    if sub is None:
        raise SystemExit(f"{root}: no sub-tile rows of {SUB_CANDIDATES} valid at every width")
    out, total, step = {"sub": sub}, 0.0, 0.0
    sums = {}
    bf16 = hasattr(fused_convnext_mlp, "bf16_launches")
    with torch.inference_mode():
        for s, (depth, c) in enumerate(zip(DEPTHS, DIMS)):
            args = stage_args(s, c, BATCH)
            out[f"C={c}"] = time_ms(lambda: fused_convnext_mlp(*args))
            total += depth * out[f"C={c}"]
            if bf16:  # x, residual, W1 and W2 in bf16
                a16 = tuple(a.to(torch.bfloat16) if i in (0, 1, 5, 7) else a for i, a in enumerate(args))
                before = fused_convnext_mlp.bf16_launches
                out[f"bf16 C={c}"] = graph_ms(lambda: fused_convnext_mlp(*a16))
                if fused_convnext_mlp.bf16_launches == before:
                    raise SystemExit(f"{root}: the bf16 call at C={c} did not launch the bf16 instance")
                sums["bf16 pass"] = sums.get("bf16 pass", 0.0) + depth * out[f"bf16 C={c}"]
                out.update(launch_ms(lambda: fused_convnext_mlp(*a16), f"bf16 C={c}"))
            if s >= 2:  # a stage the fine-tune step trains: the cotangent in the residual's place
                out[f"bwd C={c}"] = time_ms(lambda: fused_convnext_mlp_bwd(args[1], args[0], *args[2:]), iters=10)
                step += depth * out[f"bwd C={c}"]
                if hasattr(fused_convnext_mlp_bwd, "bf16_launches"):
                    a16 = tuple(a.to(torch.bfloat16) if i in (0, 1, 5, 7) else a for i, a in enumerate(args))
                    bwd16 = lambda: fused_convnext_mlp_bwd(a16[1], a16[0], *a16[2:])  # noqa: E731
                    before = fused_convnext_mlp_bwd.bf16_launches
                    out[f"bwd bf16 C={c}"] = graph_ms(bwd16, iters=5)
                    if fused_convnext_mlp_bwd.bf16_launches == before:
                        raise SystemExit(f"{root}: the bf16 backward at C={c} did not launch the bf16 instance")
                    sums["finetune_step_bwd_bf16"] = sums.get("finetune_step_bwd_bf16", 0.0) + depth * out[
                        f"bwd bf16 C={c}"]
                    out.update(launch_ms(bwd16, f"bwd bf16 C={c}"))
            for batch in (8, BATCH):
                args = stage_args(s, c, batch)
                for path in ("whole", "sub"):
                    if path == "sub":
                        os.environ["TPU_CAPTIONER_MLP_SUB"] = str(sub)
                    before = fused_convnext_mlp.pipelined_launches
                    t = graph_ms(lambda: fused_convnext_mlp(*args))
                    ran_sub = fused_convnext_mlp.pipelined_launches > before
                    os.environ.pop("TPU_CAPTIONER_MLP_SUB", None)
                    if ran_sub != (path == "sub"):
                        raise SystemExit(f"{root}: SUB={sub} at C={c} did not run the {path} path")
                    out[f"{path} C={c} bs{batch}"] = t
                    sums[f"{path} pass bs{batch}"] = sums.get(f"{path} pass bs{batch}", 0.0) + depth * t
                if hasattr(fused_convnext_mlp, "pipelined_bf16_launches"):
                    a16 = tuple(a.to(torch.bfloat16) if i in (0, 1, 5, 7) else a for i, a in enumerate(args))
                    os.environ["TPU_CAPTIONER_MLP_SUB"] = str(sub)
                    before = fused_convnext_mlp.pipelined_bf16_launches
                    t = graph_ms(lambda: fused_convnext_mlp(*a16))
                    ran = fused_convnext_mlp.pipelined_bf16_launches > before
                    os.environ.pop("TPU_CAPTIONER_MLP_SUB", None)
                    if not ran:
                        raise SystemExit(f"{root}: SUB={sub} at C={c} did not run the sub-tiled bf16 instance")
                    out[f"sub bf16 C={c} bs{batch}"] = t
                    key = f"sub bf16 pass bs{batch}"
                    sums[key] = sums.get(key, 0.0) + depth * t
    out["encoder_pass"] = total
    out["finetune_step_bwd"] = step
    out.update(sums)
    return out


def _sub_takes(mlp_block, value, c):
    """Whether the checkout's ``_pipeline_sub`` selects ``value`` rows at width c."""
    os.environ["TPU_CAPTIONER_MLP_SUB"] = str(value)
    try:
        return mlp_block._pipeline_sub(BATCH * 64, c) == value
    finally:
        os.environ.pop("TPU_CAPTIONER_MLP_SUB", None)


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
    # A key a run lacks (a kernel the profiler saw in another run only) is left out.
    table = {root: {k: statistics.median(r[k] for r in rs) for k in rs[0] if all(k in r for r in rs)}
             for root, rs in runs.items()}
    summary = {"card": card, "median_ms": table}
    if pairs:
        a, b = (runs[root] for root in pairs)
        summary["pairs"] = {}
        for k in a[0]:
            if k == "sub" or not all(k in r for r in (*a, *b)):
                continue
            diffs = [x[k] - y[k] for x, y in zip(a, b)]
            summary["pairs"][k] = {"n": len(diffs), "median_a_minus_b": statistics.median(diffs),
                                   "spread": max(diffs) - min(diffs), "b_won": sum(d > 0 for d in diffs)}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
