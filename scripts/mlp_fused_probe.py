#!/usr/bin/env python3
"""Where the sub-tiled MLP-tail kernel's time goes, on the card.

    python3 scripts/mlp_fused_probe.py [--bf16] [VARIANT ...]

Builds copies of the port's package under ``build/mlp_probe/<variant>/``,
each with one part of ``csrc/mlp_block.cu:fused_kernel`` edited out or
changed, and times the sub-tiled kernel (``TPU_CAPTIONER_MLP_SUB=64``) of
each, one process per variant, at the four ConvNeXt-Base stage shapes at
batch 8 and 32: device ms per launch by CUDA-graph replay; with ``--bf16``
on bf16 x, residual, W1 and W2, which run the three-piece instance
(``fused_kernel<C, NC, bf16, false, true>``).  The variants (all of the
dtype's by default):

- ``base``: the kernel as it is;
- ``slots-1``: one ring slot fewer at every width (how the ring's depth
  paces it);
- ``no-x``: no TMA load of the x slabs (the first product reads stale
  shared memory);
- ``no-w1``: no TMA load of W1's rows;
- ``no-w2``: no TMA load of W2's rows;
- ``no-x-w1``: neither (the first product's stages load nothing);
- ``arrive-thread``: every consumer thread arrives on a slot's empty
  barrier (256 arrivals a slot), not one thread a warp;
- ``p1-only`` / ``p2-only``: only the first / the second product's stages
  (loads and wgmmas) of every chunk;
- ``p1-wait1`` / ``p2-wait1``: a stage of the first / second product does
  not wait for its own wgmmas before the next (races: time only);
- ``no-convert``: x's A fragments not split into TF32 hi / lo;
- ``no-pfence`` / ``no-cfence``: no proxy fence / no cluster fence around
  the exchange of h; ``local-h``: every rank's h stores to its own buffer;
- ``cvt-rna``: the splits round with ``cvt.rna.tf32.f32`` (tf32x3_gemm.cuh)
  rather than the kernel's two integer operations (the same bits);
- ``no-stats``: no LayerNorm statistics pass;
- ``no-gelu``: the identity in place of the erf GELU;
- ``no-hwait``: the cluster's h barriers not waited on (wide widths);

and, for the three-piece instance only (``--bf16``):

- ``x3-one-piece``: one wgmma a k16 step in each product (the lo piece's in
  the first, the hi piece's in the second) instead of three: the tensor
  cores' share;
- ``x3-no-split``: x's A fragments not split into pieces (each register the
  value's top halves, one byte permute a pair);
- ``x3-no-hsplit``: h not split (the hi piece stored in all three planes);
- ``x3-no-norm``: x's A fragments not normalised (no LayerNorm arithmetic
  in the prologue);
- ``x3-store1``: the GELU epilogue stores the hi piece alone (one store a
  pair and peer instead of three);
- ``x3-pipe-none``: no tile's first product pipelined (each stage's
  fragments computed after the previous stage's wgmmas are done).
- ``phases``: the kernel as it is, built with ``TC_MLP_PHASES``: besides
  its times, block 0's consumer warpgroups' clocks by phase (``phases C=c
  bsB``: 12 sums a warpgroup, in the order of ``csrc/mlp_block.cu``'s
  ``TC_PHASE`` marks: statistics, the first product's slot wait, A
  fragments, its wgmmas, release and partial, the wait for the peers to
  free their buffers with GELU, split and stores, the exchange of h
  (fences, signals, the wait for the peers' h), the second product's slot
  wait, its wgmmas, release, partial and peers told, epilogue).

Every variant but ``base``, ``slots-1``, ``arrive-thread``,
``cvt-rna``, ``x3-pipe-none`` and ``phases`` computes
wrong values;
only its time means anything.  A variant whose build fails or whose process
takes over two minutes is reported as such and the rest go on.  The last line is one JSON object of ms by variant,
width and batch, with the card's name and power limit.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DIMS, BATCHES = (128, 256, 512, 1024), (8, 32)

_P1_BYTES = "next((kBoxes16 ? 2 : 4 * 2) * kBK * JCB + (int)sizeof(T) * 2 * kXSlab)"
_X3_SPLIT = "bf16mm::x3::split3(fmaf(fmaf(v.x, st.x, st.y), w.x, b.x), fmaf(fmaf(v.y, st.x, st.y), w.y, b.y),"

# variant: [(text in csrc/mlp_block.cu, its replacement)]
EDITS = {
    "base": [],
    "slots-1": [(": JC == 64 ? 5 : 3;", ": JC == 64 ? 4 : 2;")],
    "no-x": [
        (_P1_BYTES, "next((kBoxes16 ? 2 : 4 * 2) * kBK * JCB)"),
        ("tma_load_2d(slot + F::kXAt, &xmap", "if (0) tma_load_2d(slot + F::kXAt, &xmap"),
        ("tma_load_2d(slot + F::kXAt + F::kXStep, &xmap", "if (0) tma_load_2d(slot + F::kXAt + F::kXStep, &xmap"),
    ],
    "no-w1": [
        (_P1_BYTES, "next((int)sizeof(T) * 2 * kXSlab)"),
        ("tma_load_2d(slot, &w1map", "if (0) tma_load_2d(slot, &w1map"),
        ("tf32x3::tma_load(slot, &w1map", "if (0) tf32x3::tma_load(slot, &w1map"),
    ],
    "no-w2": [
        ("next(4 * 2 * kBK * 128)", "next(0)"),
        ("next(2 * kW2K * 128)", "next(0)"),
        ("tf32x3::tma_load(ring + s * kSlotFloats, &w2map", "if (0) tf32x3::tma_load(ring + s * kSlotFloats, &w2map"),
        ("tma_load_2d(ring + s * kSlotFloats, &w2map", "if (0) tma_load_2d(ring + s * kSlotFloats, &w2map"),
    ],
    "no-stats": [("for (int i0 = 0; i0 < 16; i0 += F::kRowsAtOnce)", "for (int i0 = 0; i0 < 0; i0 += F::kRowsAtOnce)")],
    "no-gelu": [
        ("gelu_exact(h[4 * jj + 2 * hr] + b.x)", "(h[4 * jj + 2 * hr] + b.x)"),
        ("gelu_exact(h[4 * jj + 2 * hr + 1] + b.y)", "(h[4 * jj + 2 * hr + 1] + b.y)"),
    ],
    "no-x-w1": [
        (_P1_BYTES, "next(0)"),
        ("tma_load_2d(slot, &w1map", "if (0) tma_load_2d(slot, &w1map"),
        ("tf32x3::tma_load(slot, &w1map", "if (0) tf32x3::tma_load(slot, &w1map"),
        ("tma_load_2d(slot + F::kXAt, &xmap", "if (0) tma_load_2d(slot + F::kXAt, &xmap"),
        ("tma_load_2d(slot + F::kXAt + F::kXStep, &xmap", "if (0) tma_load_2d(slot + F::kXAt + F::kXStep, &xmap"),
    ],
    "arrive-thread": [
        ("mbar_init(&empty[s], 8);", "mbar_init(&empty[s], 256);"),
        ("      __syncwarp();\n      if (lane == 0) mbar_arrive(&empty[s]);", "      mbar_arrive(&empty[s]);"),
    ],
    "p1-only": [
        ("for (int kt = 0; kt < JC / kW2K; ++kt) {  // W2's rows", "for (int kt = 0; kt < 0; ++kt) {  // W2's rows"),
        ("for (int kt = 0; kt < JC / kW2K; ++kt, ++it) {", "for (int kt = 0; kt < 0; ++kt, ++it) {"),
    ],
    "p2-only": [
        ("for (int kt = 0; kt < C / kBK; ++kt) {  // W1's rows", "for (int kt = 0; kt < 0; ++kt) {  // W1's rows"),
        ("for (int kt = 0; kt < C / kBK; ++kt, ++it) {", "for (int kt = 0; kt < 0; ++kt, ++it) {"),
    ],
    "p1-wait1": [("tf32x3::wgmma_wait<0>();\n          tf32x3::fence_regs(d);",
                  "tf32x3::wgmma_wait<1>();\n          tf32x3::fence_regs(d);")],
    "p2-wait1": [("tf32x3::wgmma_wait<0>();\n            tf32x3::fence_acc(op);",
                  "tf32x3::wgmma_wait<1>();\n            tf32x3::fence_acc(op);")],
    "no-convert": [("const float h = round_tf32_finite(v);\n  hi = __float_as_uint(h);\n"
                    "  lo = __float_as_uint(round_tf32_finite(v - h));", "hi = lo = __float_as_uint(v);")],
    "no-pfence": [('void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }',
                   "void fence_proxy_async() {}")],
    "no-cfence": [('asm volatile("fence.acq_rel.cluster;" ::: "memory");', ";")],
    "local-h": [("hdst[r] = S > 1 ? peer_addr(smem_u32(hh), r) : smem_u32(hh);",
                 "hdst[r] = S > 1 ? peer_addr(smem_u32(hh), rank) : smem_u32(hh);")],
    "phases": [("#include <cooperative_groups.h>", "#define TC_MLP_PHASES\n#include <cooperative_groups.h>")],
    "cvt-rna": [("return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);",
                 "return tf32x3::round_tf32(v);")],
    "no-hwait": [
        ("if (chunk_no > 0) mbar_wait_cluster(&hfree[w], (chunk_no - 1) & 1);", ";"),
        ("mbar_wait_cluster(&hfull[w], chunk_no & 1);", ";"),
    ],
    "x3-one-piece": [
        ("bf16mm::wgmma_rs<JCB>(d, a[t][1], bd + 2 * t, 1);\n"
         "    bf16mm::wgmma_rs<JCB>(d, a[t][0], bd + 2 * t, 1);", ""),
        ("bf16mm::wgmma_ss128(op, bf16mm::desc128(hb + 2 * kPiece) + 2 * kk, bd, kk > 0);\n"
         "                bf16mm::wgmma_ss128(op, bf16mm::desc128(hb + kPiece) + 2 * kk, bd, 1);\n"
         "                bf16mm::wgmma_ss128(op, bf16mm::desc128(hb) + 2 * kk, bd, 1);",
         "bf16mm::wgmma_ss128(op, bf16mm::desc128(hb) + 2 * kk, bd, kk > 0);"),
    ],
    "x3-no-split": [(_X3_SPLIT + "\n                           a[G][0][hr + 2 * e], a[G][1][hr + 2 * e], "
                     "a[G][2][hr + 2 * e]);",
                     "a[G][0][hr + 2 * e] = a[G][1][hr + 2 * e] = a[G][2][hr + 2 * e] = __byte_perm(__float_as_uint("
                     "fmaf(fmaf(v.x, st.x, st.y), w.x, b.x)), "
                     "__float_as_uint(fmaf(fmaf(v.y, st.x, st.y), w.y, b.y)), 0x7632);")],
    "x3-no-hsplit": [("bf16mm::x3::split3(v0, v1, hi, mid, lo);",
                      "hi = mid = lo = __byte_perm(__float_as_uint(v0), __float_as_uint(v1), 0x7632);")],
    "x3-no-norm": [(_X3_SPLIT, "bf16mm::x3::split3(v.x, v.y,")],
    "x3-store1": [("st_shared_b32<(S > 1)>(hdst[r] + off + 2 * kPiece, mid);\n"
                   "                st_shared_b32<(S > 1)>(hdst[r] + off + 4 * kPiece, lo);", "")],
    "x3-pipe-none": [("constexpr bool kPipeA = kX3 && F::kStagePartial;", "constexpr bool kPipeA = false;")],
}
F32_ONLY = ("no-convert", "cvt-rna")  # edits of the TF32 instances' split


def make(variant):
    """The variant's copy of the package, edited; its root."""
    root = os.path.join(ROOT, "build", "mlp_probe", variant)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "tpu_captioner_torch"), os.path.join(root, "tpu_captioner_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, "tpu_captioner_torch", "csrc", "mlp_block.cu")
    text = open(path).read()
    for old, new in EDITS[variant]:
        if old not in text:
            raise SystemExit(f"{variant}: {old!r} is not in mlp_block.cu")
        text = text.replace(old, new)
    open(path, "w").write(text)
    return root


def measure(root, bf16=False):
    """ms per launch of the sub-tiled kernel of the package under root
    (``bf16``: its three-piece instance)."""
    sys.path.insert(0, root)
    os.environ["TPU_CAPTIONER_MLP_SUB"] = "64"
    import torch

    from tpu_captioner_torch.core.backend import pin_f32_precision, require_cuda
    from tpu_captioner_torch.ops.mlp_block import _lib, fused_convnext_mlp

    dev = require_cuda()
    lib = _lib()
    lib.tc_mlp_phase_clocks.argtypes = [ctypes.c_void_p]
    clocks = (ctypes.c_ulonglong * 24)()
    pin_f32_precision()
    out = {}
    with torch.inference_mode():
        for s, c in enumerate(DIMS):
            for batch in BATCHES:
                g = torch.Generator().manual_seed(c)
                f = lambda *sh: torch.randn(*sh, generator=g)  # noqa: E731
                n = batch * (64 >> s) ** 2
                args = tuple(a.to(dev) for a in (
                    f(n, c), f(n, c), torch.ones(n), 1 + 0.1 * f(c), 0.1 * f(c),
                    0.02 * f(4 * c, c), 0.1 * f(4 * c), 0.02 * f(c, 4 * c), 0.1 * f(c), 0.5 * f(c),
                ))
                if bf16:
                    args = tuple(a.to(torch.bfloat16) if i in (0, 1, 5, 7) else a for i, a in enumerate(args))
                for _ in range(3):
                    fused_convnext_mlp(*args)
                torch.cuda.synchronize()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, capture_error_mode="relaxed"):
                    for _ in range(10):
                        fused_convnext_mlp(*args)
                graph.replay()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                graph.replay()
                end.record()
                torch.cuda.synchronize()
                out[f"C={c} bs{batch}"] = start.elapsed_time(end) / 10
                if lib.tc_mlp_phase_clocks(clocks) == 0:
                    out[f"phases C={c} bs{batch}"] = [list(clocks[:12]), list(clocks[12:])]
    return out


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2], bf16=sys.argv[3:] == ["--bf16"])))
        return
    args = sys.argv[1:]
    bf16 = args[:1] == ["--bf16"]
    if bf16:
        args = args[1:]
    variants = args or [v for v in EDITS if (v not in F32_ONLY if bf16 else not v.startswith("x3-"))]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    roots = {v: make(v) for v in variants}
    builds = {v: subprocess.Popen([sys.executable, "-c", "from tpu_captioner_torch.ops import _build; "
                                   "_build.build('mlp_block')"], cwd=root, stderr=subprocess.PIPE, text=True)
              for v, root in roots.items()}
    table = {}
    for v, proc in builds.items():
        if proc.wait() != 0:
            table[v] = "build failed: " + proc.stderr.read()[-2000:]
            print(f"{v}: {table[v]}", flush=True)
    for v, root in roots.items():
        if v in table:
            continue
        try:
            cmd = [sys.executable, os.path.abspath(__file__), "--one", root, *(["--bf16"] * bf16)]
            line = subprocess.run(cmd, capture_output=True, text=True, check=True,
                                  timeout=120).stdout.strip().splitlines()[-1]
            table[v] = json.loads(line)
        except subprocess.TimeoutExpired:
            table[v] = "timed out"
        except subprocess.CalledProcessError as e:
            table[v] = "failed: " + e.stderr[-2000:]
        print(f"{v}: {table[v]}", flush=True)
    print(json.dumps({"card": card, "dtype": "bf16" if bf16 else "f32", "ms": table}))


if __name__ == "__main__":
    main()
