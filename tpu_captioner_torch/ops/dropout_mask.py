"""Dropout keep-mask pool (counterpart of ``tpu_captioner/ops/dropout_mask.py``).

One call fills a flat ``(n,)`` bool pool with P(True) = ``keep`` for every
dropout site of a train step; the sites slice their ranges out of it
(``models/layers.py:MaskPool``).

The bits are Philox4x32-10 (Random123's counter-based generator) keyed by the
two seed words, with the counter ``element index // 4`` in its low 64 bits:
word ``j`` of the call at counter ``c`` decides element ``4c + j``.  An
element is kept when its word is below ``threshold(keep)`` =
min(round(keep * 2^32), 2^32 - 1), as in the TPU kernel.  Only the bits differ
from the TPU's: its hardware generator has no counterpart here.

``random_mask_pool`` launches ``csrc/dropout_mask.cu`` for CUDA and runs
``_mask_plain``, the same Philox in PyTorch int64 arithmetic, for the CPU;
the two give identical bits.  The wrapper asks for the card's SM count once
per device and passes the raw stream handle: no per-call device query.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from tpu_captioner_torch.ops import _build

MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # round multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # key bumps (Weyl sequence)


def threshold(keep: float) -> int:
    """The uint32 threshold of keep-rate ``keep``; raises unless 0 < keep < 1."""
    if not 0.0 < keep < 1.0:
        raise ValueError(f"keep must be in (0, 1), got {keep}")
    return min(int(round(keep * 2.0**32)), MASK32)


def _mulhilo(m: int, b: torch.Tensor):
    """(high, low) 32-bit halves of ``m * b`` for a uint32 constant ``m`` and
    int64 tensor ``b`` of uint32 values, in int64 arithmetic that never
    overflows: ``b`` is split into 16-bit halves."""
    p_lo = m * (b & 0xFFFF)  # < 2^48
    p_hi = m * (b >> 16)  # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2^49
    return (p_hi >> 16) + (mid >> 32), mid & MASK32


def philox4x32_10(counter: Sequence[torch.Tensor], key: Sequence[int]):
    """Philox4x32-10 on four int64 tensors of uint32 counter words and a
    two-word key; returns the four output words (int64, uint32 values)."""
    c0, c1, c2, c3 = counter
    k0, k1 = int(key[0]) & MASK32, int(key[1]) & MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & MASK32, (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _check(seed_words, n: int, keep: float) -> int:
    if len(seed_words) != 2 or not all(0 <= int(w) <= MASK32 for w in seed_words):
        raise ValueError(f"seed_words must be two uint32 values, got {seed_words!r}")
    if int(n) < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    return threshold(keep)


def _mask_plain(seed_words, n: int, keep: float, device="cpu") -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same bits, on any device."""
    thr = _check(seed_words, n, keep)
    g = torch.arange((int(n) + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(g)
    words = philox4x32_10((g & MASK32, g >> 32, zero, zero), seed_words)
    return (torch.stack(words, dim=1).reshape(-1)[: int(n)] < thr).contiguous()


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("dropout_mask")
    lib.tc_dropout_mask_pool.restype = ctypes.c_int
    lib.tc_dropout_mask_pool.argtypes = [
        ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p,
    ]
    return lib


def random_mask_pool(seed_words, n: int, keep: float, device="cuda") -> torch.Tensor:
    """(n,) bool keep-pool, P(True) = ``keep``, from the two uint32
    ``seed_words``.  A CUDA ``device`` launches the kernel on the current
    stream; ``cpu`` runs the plain version; any other device raises."""
    device = torch.device(device)
    if device.type == "cpu":
        return _mask_plain(seed_words, n, keep, device)
    if device.type != "cuda":
        raise ValueError(f"random_mask_pool runs on cpu or cuda, got {device}")
    thr = _check(seed_words, n, keep)
    out = torch.empty(int(n), dtype=torch.bool, device=device)
    _build.require_current_device("random_mask_pool", (out,))
    if n == 0:
        return out
    if out.data_ptr() % 4:
        raise ValueError("the pool must be 4-byte aligned")
    lib = _lib()
    index = out.get_device()
    with torch.cuda.device(index):
        err = lib.tc_dropout_mask_pool(
            int(seed_words[0]), int(seed_words[1]), thr, out.data_ptr(), int(n), _build.sm_count(index),
            _build.raw_stream(index),
        )
    _build.check(lib, err, "dropout_mask")
    random_mask_pool.launches += 1
    return out


random_mask_pool.launches = 0
