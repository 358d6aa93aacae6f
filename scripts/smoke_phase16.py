#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 16 (data parallelism) alone on one card.

    python3 scripts/smoke_phase16.py [a] [b]   (both by default)

Builds the seven kernel sources at once (as phase 2), writes phase 10's
synthetic records (``TRAIN_DATA`` images at 256x256 with the 9490-entry word
map) without training on them, then runs ``a``, the five paths in a world
of one over NCCL against no group (``world_of_one_phase``), and ``b``, two
ranks on the one card over gloo against one process, and the two-rank
Trainer epoch and resume (``two_ranks_phase``), each with its time.  The
card's name and power limit come first, as in the smoke.
"""

import concurrent.futures
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tpu_captioner_torch.core.backend import device_info, pin_f32_precision, require_cuda  # noqa: E402
from tpu_captioner_torch.data.build import build_synthetic_dataset  # noqa: E402
from tpu_captioner_torch.ops import _build  # noqa: E402

PARTS = ("a", "b")


def main(parts):
    dev = require_cuda()
    card = device_info()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}")
    pin_f32_precision()
    names = ("mlp_block", "mlp_block_bwd", "decode_step", "dropout_mask", "dwconv", "lstm_step", "block_fused")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))
    print(f"built {len(names)} kernels in {time.perf_counter() - t0:.1f} s")
    t16 = time.perf_counter()
    if "a" in parts:
        cs.world_of_one_phase(dev, card, 0)
        torch.cuda.empty_cache()
    if "b" in parts:
        with tempfile.TemporaryDirectory(prefix="phase16_") as tmp:
            ds = os.path.join(tmp, "ds")
            t0 = time.perf_counter()
            build_synthetic_dataset(ds, num_images=dict(cs.TRAIN_DATA), vocab_words=cs.VOCAB - 4,
                                    max_len=cs.TRAIN_T - 2, image_size=256, learnable=True)
            print(f"phase 10a's records in {time.perf_counter() - t0:.1f} s")
            cs.two_ranks_phase(card, 0, ds)
    print(f"phase 16 took {time.perf_counter() - t16:.1f} s")


if __name__ == "__main__":
    chosen = sys.argv[1:] or list(PARTS)
    if not set(chosen) <= set(PARTS):
        sys.exit(f"parts are {', '.join(PARTS)}; got {chosen}")
    main(chosen)
