#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 15 alone on one card, after the phase 10
it reads from.

    python3 scripts/smoke_phase15.py [a] [b] [c] [d]   (all four by default)

Builds the seven kernel sources at once (as phase 2), runs phase 10
(``training_phase``), which keeps its synthetic records and its ``BEST_``
checkpoint in a temporary directory, then the chosen parts of phase 15:
``a`` the native runtime (``native_phase``), ``b`` the one-image caption
(``one_image_phase``), ``c`` the Trainer's trace window (``trace_phase``),
``d`` the ``.npz`` backbone (``backbone_phase``), each with its time.  The
whole smoke's first 14 phases take minutes more; this reaches phase 15 in
about three.  The card's name and power limit come first, and each
reading names them, as in the smoke.
"""

import concurrent.futures
import importlib.util
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tpu_captioner_torch.core.backend import device_info, pin_f32_precision, require_cuda  # noqa: E402
from tpu_captioner_torch.ops import _build  # noqa: E402

PARTS = ("a", "b", "c", "d")


def main(parts):
    dev = require_cuda()
    card = device_info()
    print(card)
    print("host packages: " + ", ".join(
        f"{m} {'present' if importlib.util.find_spec(m) else 'missing'}" for m in cs.PACKAGES))
    pin_f32_precision()
    names = ("mlp_block", "mlp_block_bwd", "decode_step", "dropout_mask", "dwconv", "lstm_step", "block_fused")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))
    print(f"built {len(names)} kernels in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="phase15_") as keep:
        t0 = time.perf_counter()
        cs.training_phase(dev, card, 0, keep=keep)
        print(f"phase 10 took {time.perf_counter() - t0:.1f} s")
        ds = os.path.join(keep, "ds")
        t15 = time.perf_counter()
        for part in parts:
            t0 = time.perf_counter()
            if part == "a":
                cs.native_phase(card, ds)
            elif part == "b":
                cs.one_image_phase(dev, card, 0, cs.word_map_of(cs.VOCAB), keep, os.path.join(keep, "best"))
            elif part == "c":
                cs.trace_phase(dev, card, ds)
            else:
                cs.backbone_phase(dev, card, 0, ds)
            torch.cuda.empty_cache()
            print(f"phase 15{part} took {time.perf_counter() - t0:.1f} s")
        print(f"phase 15 took {time.perf_counter() - t15:.1f} s")


if __name__ == "__main__":
    chosen = sys.argv[1:] or list(PARTS)
    if not set(chosen) <= set(PARTS):
        sys.exit(f"parts are {', '.join(PARTS)}; got {chosen}")
    main(chosen)
