"""A batch's rows gathered by C++ threads (counterpart of
``tpu_captioner/native/gather.py``).

``CaptionDataset.gather`` over memmapped records: B image rows and their
captions and lengths are copied into contiguous batch buffers by a pool of
short-lived threads (``native/dataloader.cpp``), the part torch's DataLoader
workers play for the reference (train.py:155).  The result equals numpy's
fancy indexing bit for bit.  Indices are checked here (the C++ copies
without looking); a library that does not build raises (``native/lib.py``);
nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import numpy as np

from tpu_captioner_torch.native.lib import get_lib, ptr


def _indices(idx, n: int, what: str) -> np.ndarray:
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(f"{what} index out of range [0, {n}): {idx.min()} .. {idx.max()}")
    return idx


def gather_batch_native(
    images: np.ndarray,  # (N, H, W, 3) uint8, C-contiguous (a memmap is fine)
    captions: np.ndarray,  # (M, L) int32
    caplens: np.ndarray,  # (M,) int32
    img_indices: np.ndarray,
    cap_indices: np.ndarray,
    n_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(images[img_indices], captions[cap_indices], caplens[cap_indices])``,
    copied by ``n_threads`` threads (0: up to 8, one per core)."""
    if images.dtype != np.uint8 or images.ndim != 4 or images.shape[3] != 3 or not images.flags.c_contiguous:
        raise ValueError(f"images must be C-contiguous uint8 (N, H, W, 3), got {images.dtype} {images.shape}")
    lib = get_lib()
    c = ctypes
    img_idx = _indices(img_indices, images.shape[0], "image")
    cap_idx = _indices(cap_indices, len(captions), "caption")
    if len(img_idx) != len(cap_idx):
        raise ValueError(f"{len(img_idx)} image and {len(cap_idx)} caption indices")
    captions = np.ascontiguousarray(captions, dtype=np.int32)
    caplens = np.ascontiguousarray(caplens, dtype=np.int32)
    B, (H, W, _) = len(cap_idx), images.shape[1:]
    out_images = np.empty((B, H, W, 3), dtype=np.uint8)
    out_captions = np.empty((B, captions.shape[1]), dtype=np.int32)
    out_caplens = np.empty((B,), dtype=np.int32)
    lib.gather_batch(
        ptr(images, c.c_uint8), H * W * 3, ptr(captions, c.c_int32), ptr(caplens, c.c_int32), captions.shape[1],
        ptr(img_idx, c.c_int64), ptr(cap_idx, c.c_int64), B,
        ptr(out_images, c.c_uint8), ptr(out_captions, c.c_int32), ptr(out_caplens, c.c_int32),
        n_threads or min(8, os.cpu_count() or 1),
    )
    return out_images, out_captions, out_caplens
