#!/usr/bin/env python3
"""Time the PyTorch port's MLP-tail kernels of several checkouts on one card.

    python3 scripts/torch_mlp_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository: this one, or another commit
unpacked with ``git archive`` into a git-ignored directory.  Each is timed in
a process of its own, in the order given, so that ``A B B A`` pairs two
commits on one card.  A process builds that checkout's ``mlp_block.cu`` and
``mlp_block_bwd.cu`` and prints one JSON line of CUDA-event ms per launch:
of ``fused_convnext_mlp`` (its whole-tile instance: ``TPU_CAPTIONER_MLP_SUB``
unset) at the four ConvNeXt-Base stage shapes at batch 32 (N = 32 x 64^2 ..
32 x 8^2 rows), and the sum over one encoder pass (3, 3, 27 and 3
launches); of ``fused_convnext_mlp_bwd`` at the fine-tune step's two
trainable stages at batch 32 (C = 512 and 1024), and the sum over one
fine-tune step (27 and 3 launches).  Inputs are seeded, with per-image
stochastic-depth rows.  The last line is a table of each checkout's median,
with the card's name and power limit.
"""

import json
import os
import statistics
import subprocess
import sys

DEPTHS, DIMS, BATCH = (3, 3, 27, 3), (128, 256, 512, 1024), 32


def measure(root):
    """One checkout's times, in this process."""
    sys.path.insert(0, os.path.abspath(root))
    os.environ.pop("TPU_CAPTIONER_MLP_SUB", None)
    import torch

    from tpu_captioner_torch.core.backend import pin_f32_precision, require_cuda
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

    out, total, step = {}, 0.0, 0.0
    with torch.inference_mode():
        for s, (depth, c) in enumerate(zip(DEPTHS, DIMS)):
            g = torch.Generator().manual_seed(c)
            f = lambda *sh: torch.randn(*sh, generator=g)  # noqa: E731
            n = BATCH * (64 >> s) ** 2
            sd = ((torch.rand(BATCH, generator=g) < 0.8) / 0.8).repeat_interleave(n // BATCH)
            args = tuple(a.to(dev) for a in (
                f(n, c), f(n, c), sd, 1 + 0.1 * f(c), 0.1 * f(c),
                0.02 * f(4 * c, c), 0.1 * f(4 * c), 0.02 * f(c, 4 * c), 0.1 * f(c), 0.5 * f(c),
            ))
            out[f"C={c}"] = time_ms(lambda: fused_convnext_mlp(*args))
            total += depth * out[f"C={c}"]
            if s >= 2:  # a stage the fine-tune step trains: the cotangent in the residual's place
                out[f"bwd C={c}"] = time_ms(lambda: fused_convnext_mlp_bwd(args[1], args[0], *args[2:]), iters=10)
                step += depth * out[f"bwd C={c}"]
    out["encoder_pass"] = total
    out["finetune_step_bwd"] = step
    return out


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])))
        return
    roots = sys.argv[1:]
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
    print(json.dumps({"card": card, "median_ms": table}))


if __name__ == "__main__":
    main()
