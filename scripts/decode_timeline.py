#!/usr/bin/env python3
"""Where a decode launch spends its time: block 0's timeline, and device
time against the wrapper's time per call.

    python3 scripts/decode_timeline.py [--bf16] [--out results/decode_timeline.json]

Builds ``tpu_captioner_torch/csrc/decode_step.cu`` with
``TC_DECODE_TIMELINE`` defined (block 0's ``%globaltimer`` at the launch's
start, at each grid barrier's entry and exit, after each staged row chunk
and at the end) into ``build/timeline/``, and runs the flagship decoder
(E=512, H=8, 6 layers, vocab 9490; random weights from seed 0) through the
package's wrappers: the per-layer kernel at 40 and 160 rows (pos 25, cache
length 52), the one-cell kernel at 32 rows, one 51-token rollout at 32 rows.
For each it prints, from the last launch's stamps: the launch's span, the
time block 0 waited in barriers (entry to exit: the barrier and the slowest
block's lag), the time of the phases between them, and of those the part
before each product's rows were staged; and the same per phase of a layer
(QKV, self-attention, out-projection, LN1 + cross query, cross-attention,
cross-out, LN2 + FFN1, FFN2, then the per-layer kernel's LN3 tail), or of a
rollout token (the layers' phases, then the head), averaged.  Then, with the ordinary build, the
time per call from CUDA events around 50 calls, the device time of the
decode kernels per call from ``torch.profiler``, and the host time per call
without a synchronise: where the events exceed the device time, the host
sets the pace.  The last line holds all of it, with the card's name and
power limit.  ``--bf16`` runs the kernels' bf16 instances instead: the
weight matrices cast with ``cast_weight_matrices(w, bfloat16)``, x, the
caches and the memory K/V in bf16, and for the rollout the embedding table
and the vocab head in bf16 too.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build_timeline():
    from tpu_captioner_torch.ops import _build

    out_dir = os.path.join(ROOT, "build", "timeline")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libdecode_step_timeline.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DTC_DECODE_TIMELINE", "-o", lib,
                    str(_build.CSRC / "decode_step.cu")], check=True, capture_output=True)
    cdll = ctypes.CDLL(lib)
    cdll.tc_decode_timeline.restype = ctypes.c_int
    cdll.tc_decode_timeline.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    return cdll


def read_timeline(cdll, n=1 << 16):
    """The last launch's stamps as (ns, what), and the SM clock in MHz over
    the launch (block 0's cycle counter against the global timer)."""
    t = (ctypes.c_ulonglong * n)()
    clock = (ctypes.c_longlong * n)()
    what = (ctypes.c_int * n)()
    if cdll.tc_decode_timeline(t, clock, what, n):
        raise RuntimeError("reading the timeline failed")
    out = []
    for i in range(n):
        out.append((t[i], what[i]))
        if what[i] == 4:
            break
    mhz = (clock[len(out) - 1] - clock[0]) / max(1, t[len(out) - 1] - t[0]) * 1e3
    return out, mhz


def summarise(stamps, period, tail):
    """us: the launch's span; the time block 0 waited in barriers; the
    phases' time and their time to their first staged chunk; and per phase
    of a period (8 per layer, 8L + 1 per rollout token) the mean of each
    phase's time, its time to its first and last staged chunks (a product
    in several unit groups or row chunks marks each), to warp 0's last
    product, to the last release of ring units and to warp 0's first
    weights ready, and its barrier wait."""
    t0 = stamps[0][0]
    phases = []  # [work, to first staged, barrier, to last staged, to last product, to last release]
    start, marks = t0, {3: [], 5: [], 6: [], 7: []}
    for t, what in stamps[1:]:
        if what == 1 or what == 4:
            at = lambda w, i: (marks[w][i] - start) / 1e3 if marks[w] else None  # noqa: E731
            phases.append([(t - start) / 1e3, at(3, 0), 0.0, at(3, -1), at(5, -1), at(6, -1), at(7, 0)])
        elif what == 2:
            phases[-1][2] = (t - entry) / 1e3
            start, marks = t, {3: [], 5: [], 6: [], 7: []}
        elif what in marks:
            marks[what].append(t)
        if what == 1:
            entry = t
    body = phases[:-1] if tail else phases  # the per-layer and one-cell kernels end in an LN3 tail
    per = []
    for i in range(min(period, len(body))):
        rows = body[i::period]
        mean = lambda xs: sum(xs) / len(xs) if xs else None  # noqa: E731
        per.append({"work_us": mean([r[0] for r in rows]),
                    "to_staged_us": mean([r[1] for r in rows if r[1] is not None]),
                    "barrier_us": mean([r[2] for r in rows]),
                    "to_last_staged_us": mean([r[3] for r in rows if r[3] is not None]),
                    "to_last_product_us": mean([r[4] for r in rows if r[4] is not None]),
                    "to_last_release_us": mean([r[5] for r in rows if r[5] is not None]),
                    "to_first_weights_us": mean([r[6] for r in rows if r[6] is not None])})
    return {"span_us": (stamps[-1][0] - t0) / 1e3, "barriers": sum(1 for _, w in stamps if w == 2),
            "barrier_wait_us": sum(r[2] for r in phases), "phases_us": sum(r[0] for r in phases),
            "phases_to_first_staged_us": sum(r[1] for r in phases if r[1] is not None), "per_phase": per,
            "tail_us": phases[-1][0] if tail else None}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bf16", action="store_true", help="the kernels' bf16 instances")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    from tpu_captioner_torch.core.backend import pin_f32_precision, require_cuda
    from tpu_captioner_torch.core.config import ModelConfig
    from tpu_captioner_torch.ops import _build, decode_step
    from tpu_captioner_torch.train.model import CaptionModel

    dev = require_cuda()
    pin_f32_precision()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = ModelConfig(vocab_size=9490)
    dec = CaptionModel(cfg, device=dev, seed=0).decoder
    L, E, H = len(dec.layers), cfg.embed_dim, cfg.num_heads
    g = torch.Generator().manual_seed(1)
    dt = torch.bfloat16 if args.bf16 else torch.float32
    f = lambda *sh: torch.randn(*sh, generator=g).to(dev, dt)  # noqa: E731
    T, P, STEPS = 52, 49, 51
    with torch.inference_mode():
        w = decode_step.cast_weight_matrices(decode_step.prepare_decode_weights(dec.layers, E), dt)
        cases = {}
        for name, rows, one_cell in (("decode_step R=40", 40, False), ("decode_step R=160", 160, False),
                                     ("decode_onecell R=32", 32, True)):
            a = (w, f(rows, E), 25, f(L, rows, T, E), f(L, rows, T, E), f(L, rows, P, E), f(L, rows, P, E), H)
            cases[name] = (lambda a=a, o=one_cell: decode_step.fused_decode_step(*a, one_cell=o))
        mem = dec.project_memory(f(32, P, cfg.encoder_dim).float())
        mem_k, mem_v = (m.to(dt) for m in decode_step.prepare_cross_memory(dec.layers, mem, E))
        emb, fc_w = dec.embedding.weight.to(dt).contiguous(), dec.fc_out.weight.to(dt).contiguous()
        cases["decode_rollout R=32 x 51"] = lambda: decode_step.fused_full_rollout(
            w, emb, fc_w, dec.fc_out.bias, dec.pe, mem_k, mem_v, 1, cfg.vocab_size, STEPS, H)

        results = {}
        # The ordinary build: events, profiler device time and host time per call.
        for name, fn in cases.items():
            iters = 5 if "rollout" in name else 50
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t_host = time.perf_counter()
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            host_ms = (time.perf_counter() - t_host) * 1e3 / iters
            torch.cuda.synchronize()
            event_ms = start.elapsed_time(end) / iters
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            kernel_us = sum(e.self_device_time_total for e in prof.key_averages()
                            if e.device_type == torch.autograd.DeviceType.CUDA and "decode_" in e.key)
            launches = sum(e.count for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA and "decode_" in e.key)
            results[name] = {"event_ms_per_call": event_ms, "device_ms_per_call": kernel_us / 1e3 / iters,
                             "launches_per_call": launches / iters, "host_ms_per_call": host_ms}
            print(name, json.dumps(results[name]), flush=True)

        # The timeline build, through the same wrappers.
        cdll = build_timeline()
        load = _build.load
        _build.load = lambda name: cdll if name == "decode_step" else load(name)
        try:
            for name, fn in cases.items():
                fn()
                torch.cuda.synchronize()
                rollout = "rollout" in name
                stamps, mhz = read_timeline(cdll)
                results[name]["timeline"] = summarise(stamps, 8 * L + 1 if rollout else 8, not rollout)
                results[name]["timeline"]["sm_mhz"] = mhz
                print(name, "timeline of the last launch:", json.dumps(results[name]["timeline"]), flush=True)
        finally:
            _build.load = load
    final = {"card": card, "dtype": str(dt), "results": results}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(final, fh, indent=1)
    print(json.dumps(final))


if __name__ == "__main__":
    main()
