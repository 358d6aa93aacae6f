#!/usr/bin/env python3
"""Time the PyTorch port's three decode kernels of several checkouts on one card.

    python3 scripts/torch_decode_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository: this one, or another commit
unpacked with ``git archive`` into a git-ignored directory.  Each is timed in
a process of its own, in the order given, so that ``A B B A`` pairs two
commits on one card.  A process builds that checkout's ``decode_step.cu``,
makes the flagship decoder (E=512, H=8, 6 layers, vocab 9490; random weights
from seed 0) and prints one JSON line of CUDA-event ms: the per-layer kernel
(6 launches, one token of the beam's 40 rows) and the one-cell kernel (one
launch, the greedy eval's 32 rows), each at cache length 52 and averaged over
positions 0, 25 and 51, and one 51-token greedy rollout of the rollout kernel
(32 rows).  The last line is a table of each checkout's median per kernel,
with the card's name and power limit.
"""

import json
import os
import statistics
import subprocess
import sys

POSITIONS = (0, 25, 51)
BEAM_ROWS, EVAL_ROWS, T, P, STEPS = 40, 32, 52, 49, 51


def measure(root):
    """One checkout's times, in this process."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from tpu_captioner_torch.core.backend import pin_f32_precision, require_cuda
    from tpu_captioner_torch.core.config import ModelConfig
    from tpu_captioner_torch.ops.decode_step import (
        fused_decode_step, fused_full_rollout, prepare_cross_memory, prepare_decode_weights,
    )
    from tpu_captioner_torch.train.model import CaptionModel

    dev = require_cuda()
    pin_f32_precision()
    cfg = ModelConfig(vocab_size=9490)
    dec = CaptionModel(cfg, device=dev, seed=0).decoder
    L, E, H = len(dec.layers), cfg.embed_dim, cfg.num_heads
    g = torch.Generator().manual_seed(1)
    f = lambda *sh: torch.randn(*sh, generator=g).to(dev)  # noqa: E731

    def time_ms(fn, iters=50, warmup=5):
        for _ in range(warmup):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    out = {}
    with torch.inference_mode():
        w = prepare_decode_weights(dec.layers, E)
        for name, rows, one_cell in (("decode_step", BEAM_ROWS, False), ("decode_onecell", EVAL_ROWS, True)):
            times = []
            for pos in POSITIONS:
                args = (w, f(rows, E), pos, f(L, rows, T, E), f(L, rows, T, E), f(L, rows, P, E),
                        f(L, rows, P, E), H)
                times.append(time_ms(lambda: fused_decode_step(*args, one_cell=one_cell)))
            out[name] = sum(times) / len(times)
        mem_k, mem_v = prepare_cross_memory(dec.layers, dec.project_memory(f(EVAL_ROWS, P, cfg.encoder_dim)), E)
        emb = dec.embedding.weight.contiguous()
        # An end id no row emits, so that every rollout runs all its steps.
        out["decode_rollout"] = time_ms(lambda: fused_full_rollout(
            w, emb, dec.fc_out.weight, dec.fc_out.bias, dec.pe, mem_k, mem_v, 1, cfg.vocab_size, STEPS, H,
        ), iters=10, warmup=2)
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
