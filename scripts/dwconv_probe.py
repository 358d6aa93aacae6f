#!/usr/bin/env python3
"""Probe the depthwise-conv kernels on one card: what sets their pace.

    python3 scripts/dwconv_probe.py [clusters] [split] [host] [sass]   (all four by default)

- ``clusters``: the filter gradient at ConvNeXt-Base stages 3 and 4, batch
  32, with clusters of 1 to 8 blocks (``dwconv_plan(..., cluster=k)``): how
  many such clusters the card runs at once (cudaOccupancyMaxActiveClusters,
  through ``tc_dwconv_wgrad_clusters``), the device us of a launch, and the
  size ``fit_cluster`` picks.
- ``split``: device us of both kernels at stages 3 and 4, batch 32, for this
  checkout and two copies made under ``build/`` whose ``csrc/dwconv.cu`` is
  edited: one issues no tile copies (its consumers read stale shared
  memory), one keeps one tap in seven of each filter row (a seventh of the
  multiply-adds; the shared loads that only the others read go too).
  Results of the copies are wrong by design; only their times count.
- ``host``: host microseconds per call, on the card's machine, of the
  forward wrapper, of its C entry point alone, and of the two ways to get
  the current stream.
- ``sass``: per kernel instance of the built library, ptxas's registers
  and spills, and from ``cuobjdump -sass`` the count of TMA loads
  (``UTMALDG``), mbarrier waits, local-memory accesses, FMAs, shared loads
  and integer address instructions.
Device times replay the calls from a CUDA graph, so that Python's dispatch
does not count.  Every line names the card and its power limit.
"""

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = {"s3": (32, 16, 16, 512), "s4": (32, 8, 8, 1024)}
EDITS = {  # copy name -> [(original text, replacement)] in csrc/dwconv.cu
    "no_copies": [
        ("mbar_expect_tx(&full[s], 4 * box_r * box_c * cc);\n"
         "          tma_load_4d(ring + s * g.slot_floats, &xmap, c0, w0 - PAD, h0 - PAD, b, &full[s]);",
         "mbar_expect_tx(&full[s], 0);"),
        ("mbar_expect_tx(&full[s], 4 * cc * (box_r * box_c + g.th * tw));\n"
         "          tma_load_4d(xs, &xmap, c0, w0 - PAD, h0 - PAD, b, &full[s]);\n"
         "          tma_load_4d(xs + g.x_floats, &gmap, c0, w0, h0, b, &full[s]);",
         "mbar_expect_tx(&full[s], 0);"),
    ],
    "one_fma_per_row": [
        ("for (int o = 0; o < kS; ++o) acc[r][o] = fmaf(v[o + dx], wr[dy * K + dx], acc[r][o]);",
         "for (int o = 0; o < kS; ++o) if (dx == 0) acc[r][o] = fmaf(v[o], wr[dy * K], acc[r][o]);"),
        ("for (int o = 0; o < kS; ++o) acc[dy * K + dx] = fmaf(v[o + dx], gv[r][o], acc[dy * K + dx]);",
         "for (int o = 0; o < kS; ++o) if (dx == 0) acc[dy * K] = fmaf(v[o], gv[r][o], acc[dy * K]);"),
    ],
}


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def graph_us(fn, iters=30):
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


def inputs(shape):
    import torch

    g = torch.Generator().manual_seed(0)
    f = lambda *sh: torch.randn(*sh, generator=g).to("cuda")  # noqa: E731
    return f(*shape), f(*shape), 0.1 * f(7, 7, shape[-1]), f(shape[-1])


def clusters():
    from tpu_captioner_torch.ops import _build
    from tpu_captioner_torch.ops import dwconv as D

    lib = D._lib()
    for name, shape in STAGES.items():
        x, g, _, _ = inputs(shape)
        dw, db = x.new_empty(7, 7, shape[-1]), x.new_empty(shape[-1])

        def run(plan):  # on the current stream: the graph's while it captures
            err = lib.tc_dwconv_wgrad(x.data_ptr(), g.data_ptr(), dw.data_ptr(), db.data_ptr(), *shape,
                                      *plan.args(), D._stream(0))
            _build.check(lib, err, "dwconv_wgrad")

        rows = []
        for k in range(D.CLUSTER, 0, -1):
            plan = D.dwconv_plan(*shape, "wgrad", True, D._sms(0), k)
            rows.append({"cluster": k, "chunks": plan.chunks, "active": D._active_clusters(0, plan),
                         "us": round(graph_us(lambda: run(plan)), 2)})
        picked = D._wgrad_plan(0, *shape, True).parts
        print(json.dumps({"probe": "clusters", "stage": name, "shape": shape, "fit_cluster": picked,
                          "rows": rows, "card": card()}), flush=True)


def split_one(root):
    """This process: device us of both kernels of the checkout at ``root``."""
    sys.path.insert(0, root)
    from tpu_captioner_torch.ops.dwconv import dwconv_filter_grad, dwconv_forward

    out = {}
    for name, shape in STAGES.items():
        x, g, w, b = inputs(shape)
        out[f"fwd_{name}"] = round(graph_us(lambda: dwconv_forward(x, w, bias=b)), 2)
        out[f"wgrad_{name}"] = round(graph_us(lambda: dwconv_filter_grad(x, g, bias_grad=True)), 2)
    print(json.dumps(out))


def split():
    runs = {"as built": ROOT}
    for name, edits in EDITS.items():
        copy = os.path.join(ROOT, "build", f"probe_{name}")
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "tpu_captioner_torch"), os.path.join(copy, "tpu_captioner_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        path = os.path.join(copy, "tpu_captioner_torch", "csrc", "dwconv.cu")
        text = open(path).read()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: csrc/dwconv.cu no longer holds {old!r}")
            text = text.replace(old, new)
        open(path, "w").write(text)
        runs[name] = copy
    for name, root in runs.items():
        line = subprocess.run([sys.executable, os.path.abspath(__file__), "--split-one", root],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[-1]
        print(json.dumps({"probe": "split", "copy": name, "us": json.loads(line), "card": card()}), flush=True)


def host():
    import torch

    from tpu_captioner_torch.ops import dwconv as D

    x, _, w, b = inputs((8, 8, 8, 1024))
    y = torch.empty_like(x)
    plan, lib = D.dwconv_plan(8, 8, 8, 1024, "forward", True, D._sms(0)), D._lib()
    args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), 8, 8, 8, 1024, 0, *plan.args(),
            D._stream(0))

    def us(fn, n=2000):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return round((t1 - t0) / n * 1e6, 2)

    print(json.dumps({"probe": "host", "us per call": {
        "dwconv_forward with the bias": us(lambda: D.dwconv_forward(x, w, bias=b)),
        "tc_dwconv_forward alone": us(lambda: lib.tc_dwconv_forward(*args)),
        "torch.cuda.current_stream(dev).cuda_stream": us(lambda: torch.cuda.current_stream(x.device).cuda_stream),
        "torch._C._cuda_getCurrentRawStream": us(lambda: D._stream(0)),
    }, "card": card()}), flush=True)


def sass():
    import re

    from tpu_captioner_torch.ops import _build

    lib = _build.build("dwconv")
    ptxas = {}
    name = None
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
    nvcc = _build._nvcc()
    dump = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    patterns = {"UTMALDG": r"UTMALDG", "mbarrier waits": r"SYNCS\S*TRYWAIT", "LDL/STL": r"\b(?:LDL|STL)\b",
                "FFMA": r"\bFFMA\b", "LDS": r"\bLDS\b", "IADD3/LEA/IMAD": r"\b(?:IADD3|LEA|IMAD)\b"}
    for part in dump.split("Function : ")[1:]:
        fn = part.split()[0]
        counts = {k: len(re.findall(p, part)) for k, p in patterns.items()}
        short = re.sub(r"^_ZN\w*?(dwconv_(?:fwd|wgrad)_kernel)", r"\1", fn)
        print(json.dumps({"probe": "sass", "kernel": short, **ptxas.get(fn, {}), **counts}), flush=True)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--split-one":
        split_one(sys.argv[2])
        return
    sys.path.insert(0, ROOT)
    from tpu_captioner_torch.core.backend import pin_f32_precision, require_cuda

    require_cuda()
    pin_f32_precision()
    for probe in sys.argv[1:] or ["clusters", "split", "host", "sass"]:
        {"clusters": clusters, "split": split, "host": host, "sass": sass}[probe]()


if __name__ == "__main__":
    main()
