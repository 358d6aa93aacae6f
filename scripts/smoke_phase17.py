#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 17 (the MLP tail's precise=False arm) alone
on one card.

    python3 scripts/smoke_phase17.py [a] [b]   (both by default)

Builds the MLP tail's two sources at once, then runs ``a``, the four
forward instances against their plain version and the precise=True
instances (``bf16_products_forward``), and ``b``, the two backward
instances (``bf16_products_backward``), each with its times and bounds.
The card's name and power limit come first, as in the smoke.
"""

import concurrent.futures
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tpu_captioner_torch.core.backend import device_info, pin_f32_precision, require_cuda  # noqa: E402
from tpu_captioner_torch.ops import _build  # noqa: E402

PARTS = ("a", "b")


def main(parts):
    dev = require_cuda()
    card = device_info()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}")
    pin_f32_precision()
    names = ("mlp_block", "mlp_block_bwd")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))
    print(f"built {len(names)} kernels in {time.perf_counter() - t0:.1f} s")
    t17 = time.perf_counter()
    if "a" in parts:
        cs.bf16_products_forward(dev, card)
        torch.cuda.empty_cache()
    if "b" in parts:
        cs.bf16_products_backward(dev, card)
    print(f"phase 17 took {time.perf_counter() - t17:.1f} s")


if __name__ == "__main__":
    chosen = sys.argv[1:] or list(PARTS)
    if not set(chosen) <= set(PARTS):
        sys.exit(f"parts are {', '.join(PARTS)}; got {chosen}")
    main(chosen)
