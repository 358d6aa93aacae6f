#!/usr/bin/env python3
"""Probe the LSTM step kernel on one card: what sets its pace.

    python3 scripts/lstm_probe.py [split] [host] [sass] [timeline]   (all four by default)

- ``split``: device us of a step at R = 40, 160 and 32 (E = D = A = 512, C =
  1024, P = 49) for this checkout and for copies made under ``build/``
  whose ``csrc/lstm_step.cu`` is built with ``TC_LSTM_SKIP`` set, each
  leaving one part of the work out: ``no-attention`` (1: the scores' and the
  context's loads and arithmetic), ``no-mma`` (2: the wgmmas),
  ``no-weights`` (4: the weight boxes' TMA loads and the w_ih_c share),
  ``no-mma-no-weights`` (6).  The flags, the planes, the ring and the
  partial tiles stay, so what is left is the launch's skeleton.  Results of
  the copies are wrong by design; only their times count.
- ``host``: host microseconds per call at R = 40 of the wrapper, of its
  tensor checks alone, and of the C entry point alone (200 calls back to
  back, no synchronise between them).
- ``sass``: per kernel instance of the built library, ptxas's registers and
  spills, and from ``cuobjdump -sass`` the counts of HGMMA, UTMALDG,
  local-memory accesses and floating-point atomics.
- ``timeline``: a copy built with ``TC_LSTM_TIMELINE`` stamps the global
  timer at each role's milestones in every block; per milestone, the
  earliest, median and latest block, in us from the launch's first stamp,
  at R = 40, 160 and 32.
Device times replay the calls from a CUDA graph, so that Python's dispatch
does not count.  Every line names the card and its power limit.
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKIPS = {"no-attention": 1, "no-mma": 2, "no-weights": 4, "no-mma-no-weights": 6}
ROWS = (40, 160, 32)
E = D = A = 512
C, P = 1024, 49


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def graph_us(fn, iters=50):
    import torch

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
    return start.elapsed_time(end) / iters * 1e3


def step_args(R, seed=0):
    """``fused_lstm_step``'s arguments at the model's widths, on the card."""
    import torch

    from tpu_captioner_torch.ops.lstm_step import LstmStepWeights

    g = torch.Generator().manual_seed(seed)
    u = lambda fan_in, *sh: ((torch.rand(*sh, generator=g) * 2 - 1) / math.sqrt(fan_in)).to("cuda")  # noqa: E731
    f = lambda *sh: torch.randn(*sh, generator=g).to("cuda")  # noqa: E731
    w = LstmStepWeights(u(D, A, D), u(D, A), u(A, A), u(A, 1), u(D, C, D), u(D, C),
                        u(D, 4 * D, E), u(D, 4 * D, C), u(D, 4 * D, D), u(D, 4 * D))
    return (w, f(R, E), f(R, D), f(R, D), f(R, P, C), f(R, P, A))


def split_one(root):
    """This process: device us of the checkout at ``root``."""
    sys.path.insert(0, root)
    import torch

    from tpu_captioner_torch.ops.lstm_step import fused_lstm_step

    out = {}
    with torch.inference_mode():
        for R in ROWS:
            args = step_args(R)
            out[f"r{R}"] = round(graph_us(lambda: fused_lstm_step(*args)), 2)
    print(json.dumps(out))


def split():
    runs = {"as built": ROOT}
    for name, bits in SKIPS.items():
        copy = os.path.join(ROOT, "build", f"lstm_probe_{name}")
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "tpu_captioner_torch"), os.path.join(copy, "tpu_captioner_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        path = os.path.join(copy, "tpu_captioner_torch", "csrc", "lstm_step.cu")
        text = open(path).read()
        open(path, "w").write(f"#define TC_LSTM_SKIP {bits}\n" + text)
        runs[name] = copy
    for name, root in runs.items():
        line = subprocess.run([sys.executable, os.path.abspath(__file__), "--split-one", root],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[-1]
        print(json.dumps({"probe": "split", "copy": name, "us": json.loads(line), "card": card()}), flush=True)


def host():
    import torch

    from tpu_captioner_torch.ops import _build
    from tpu_captioner_torch.ops import lstm_step as L

    args = step_args(40)
    w, emb, h, c, enc, att1 = args
    plan, plan_c, floats, flags = L._launch_plan(40, E, D, A, C, P, 0)
    work, flag = L._scratch(0, floats, flags)
    outs = (torch.empty_like(h), torch.empty_like(c), torch.empty(40, P, device="cuda"))
    ptrs = [t.data_ptr() for t in (emb, h, c, enc, att1, *w, *outs, work)]
    lib = L._lib()

    def entry():
        lib.tc_lstm_step(*ptrs, work.numel(), flag.data_ptr(), flag.numel(), 40, E, D, A, C, P, plan_c, 0,
                         _build.raw_stream(0))

    def us(fn, n=200):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return round((t1 - t0) / n * 1e6, 2)

    with torch.inference_mode():
        print(json.dumps({"probe": "host", "us per call at R=40": {
            "fused_lstm_step": us(lambda: L.fused_lstm_step(*args)),
            "its tensor checks": us(lambda: L._check(*args)),
            "tc_lstm_step alone": us(entry),
        }, "card": card()}), flush=True)


def sass():
    from tpu_captioner_torch.ops import _build

    lib = _build.build("lstm_step")
    ptxas, name = {}, None
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            ptxas.setdefault(name, {})["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            ptxas.setdefault(name, {})["spill bytes"] = int(m.group(1)) + int(m.group(2))
    dump = subprocess.run([os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    patterns = {"HGMMA": r"\bHGMMA\b", "UTMALDG": r"\bUTMALDG\b", "LDL/STL": r"\b(?:LDL|STL)\b",
                "float atomics": r"\b(?:RED|ATOM|ATOMG)\.\S*F32"}
    counts = {}
    for part in dump.split("Function : ")[1:]:
        fn = part.split()[0]
        counts[fn] = {k: len(re.findall(p, part)) for k, p in patterns.items()}
    print(json.dumps({"probe": "sass", "ptxas": ptxas, "sass": counts, "card": card()}), flush=True)


MARKS = {  # (role, mark) -> milestone, csrc/lstm_step.cu's TIMELINE calls
    (0, 0): "producer start", (0, 1): "producer sees the h / emb planes", (0, 2): "producer sees its context",
    (0, 3): "producer end",
    (1, 0): "consumer start", (1, 1): "att2/fb split's stages done", (1, 2): "att2/fb split's partial stored",
    (1, 4): "gate h-side stages done", (1, 5): "gate context stages done",
    (1, 6): "gate tile's partials all stored", (1, 7): "cells written",
    (2, 0): "attention start", (2, 1): "h / emb planes split", (2, 2): "att2 and fb seen", (2, 3): "scores done",
    (2, 4): "context done",
}


def timeline_one(root):
    """This process: the stamps of one launch per row count, from the copy at ``root``."""
    sys.path.insert(0, root)
    import ctypes
    import statistics

    import torch

    from tpu_captioner_torch.ops import _build
    from tpu_captioner_torch.ops import lstm_step as L

    lib = L._lib()
    lib.tc_lstm_timeline.restype = ctypes.c_int
    lib.tc_lstm_timeline.argtypes = [ctypes.c_void_p, ctypes.c_int]
    sms, marks = _build.sm_count(0), 8
    buf = (ctypes.c_ulonglong * (sms * 3 * marks))()
    out = {}
    with torch.inference_mode():
        for R in ROWS:
            args = step_args(R)
            for _ in range(3):
                L.fused_lstm_step(*args)
            torch.cuda.synchronize()
            if lib.tc_lstm_timeline(buf, len(buf)) != 0:
                raise RuntimeError("tc_lstm_timeline failed")
            stamps = {}
            for b in range(sms):
                for (role, mark) in MARKS:
                    t = buf[(b * 3 + role) * marks + mark]
                    if t:
                        stamps.setdefault((role, mark), []).append(t)
            # Stamps of earlier launches are older than this launch's first.
            t0 = max(buf[(b * 3 + role) * marks] for b in range(sms) for role in range(3))
            t0 = min(t for v in stamps.values() for t in v if t >= t0 - 10**6)
            out[f"r{R}"] = {MARKS[k]: [round((min(x for x in v if x >= t0) - t0) / 1e3, 2),
                                       round((statistics.median([x for x in v if x >= t0]) - t0) / 1e3, 2),
                                       round((max(v) - t0) / 1e3, 2), sum(x >= t0 for x in v)]
                            for k, v in sorted(stamps.items()) if max(v) >= t0}
    print(json.dumps(out))


def timeline():
    copy = os.path.join(ROOT, "build", "lstm_probe_timeline")
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "tpu_captioner_torch"), os.path.join(copy, "tpu_captioner_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(copy, "tpu_captioner_torch", "csrc", "lstm_step.cu")
    text = open(path).read()
    open(path, "w").write("#define TC_LSTM_TIMELINE 1\n" + text)
    line = subprocess.run([sys.executable, os.path.abspath(__file__), "--timeline-one", copy],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[-1]
    for key, rows in json.loads(line).items():
        print(json.dumps({"probe": "timeline", "rows": key, "us from the first stamp [earliest, median, "
                          "latest block, blocks]": rows, "card": card()}), flush=True)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--split-one":
        split_one(sys.argv[2])
        return
    if len(sys.argv) > 2 and sys.argv[1] == "--timeline-one":
        timeline_one(sys.argv[2])
        return
    sys.path.insert(0, ROOT)
    from tpu_captioner_torch.core.backend import pin_f32_precision, require_cuda

    require_cuda()
    pin_f32_precision()
    for mode in sys.argv[1:] or ["split", "host", "sass", "timeline"]:
        {"split": split, "host": host, "sass": sass, "timeline": timeline}[mode]()


if __name__ == "__main__":
    main()
