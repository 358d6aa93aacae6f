#!/usr/bin/env python3
"""Time the kernel sources' nvcc builds: all seven started together (as
``chip_smoke.py`` phase 2 starts them), with ``ops/_build.py``'s flags and
with ``--split-compile=0`` added, then ``mlp_block.cu`` and
``mlp_block_bwd.cu`` alone.  (``--split-compile=0`` halves the build on an
8-core host but changes ``decode_step.cu``'s register allocation, with
spills, so the build does not take it: PERF.md section 7.)

    python3 scripts/build_times.py

Needs nvcc (the machine with the card); writes its libraries under
``build/build_times/`` and prints seconds per build and per group.
"""

import concurrent.futures
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpu_captioner_torch.ops import _build  # noqa: E402

NAMES = ("mlp_block", "mlp_block_bwd", "decode_step", "dropout_mask", "dwconv", "lstm_step", "block_fused")
SPLIT = "--split-compile=0"
BASE = _build.NVCC_FLAGS
OUT = os.path.join(ROOT, "build", "build_times")


def build(name, flags, tag):
    """(name, nvcc's exit code, seconds) of one build."""
    t0 = time.perf_counter()
    proc = subprocess.run([_build._nvcc(), *flags, "-o", os.path.join(OUT, f"{name}{tag}.so"),
                           str(_build.CSRC / f"{name}.cu")], capture_output=True, text=True)
    return name, proc.returncode, round(time.perf_counter() - t0, 1)


def main():
    os.makedirs(OUT, exist_ok=True)
    print(f"host cores: {os.cpu_count()}")
    for tag, flags in (("plain", BASE), ("split", (*BASE, SPLIT))):
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(NAMES)) as pool:
            results = list(pool.map(lambda n: build(n, flags, "_" + tag), NAMES))
        print(f"{tag}: all seven together {time.perf_counter() - t0:.1f} s; each {results}")
        if any(rc for _, rc, _ in results):
            sys.exit(f"a build failed: {results}")
    for name in ("mlp_block", "mlp_block_bwd"):
        print(f"alone: {build(name, BASE, '_alone')}, with {SPLIT}: {build(name, (*BASE, SPLIT), '_alone_split')}")


if __name__ == "__main__":
    main()
