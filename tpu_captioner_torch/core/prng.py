"""Explicit seeds (counterpart of ``tpu_captioner/core/prng.py``).

One root seed per run, folded by (purpose, epoch, step, host) into a step
seed, so every train step draws fresh, reproducible randomness and nothing
reads global RNG state.  The fold is splitmix64 (Steele, Lea and Flood,
"Fast splittable pseudorandom number generators", OOPSLA'14): each fold
mixes ``seed + golden * (value + 1)`` through the splitmix64 finaliser, a
bijection of 64-bit words, so the result is deterministic and distinct seeds
are spread over all 64 bits.

A step seed becomes two uint32 words for the dropout mask pool
(``seed_words``) and a seeded ``torch.Generator`` for stochastic depth
(``generator``).  The JAX package's rbg switch has no counterpart: it chose
a TPU key implementation.
"""

from __future__ import annotations

from typing import Tuple

import torch

MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15

# Stable fold constants per purpose (the JAX package's table).
PURPOSES = {"dropout": 0, "stochastic_depth": 1, "init": 2, "data": 3, "rollout": 4}


def splitmix64(z: int) -> int:
    """The splitmix64 finaliser of a 64-bit word."""
    z &= MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def fold_in(seed: int, value: int) -> int:
    """A new 64-bit seed from ``seed`` and the integer ``value``."""
    return splitmix64(seed + _GOLDEN * (int(value) + 1))


def root_seed(seed: int = 42) -> int:
    """The run's root seed."""
    return splitmix64(int(seed))


def step_seed(root: int, purpose: str, epoch: int, step: int, host: int = 0) -> int:
    """The seed of one step: ``root`` folded by purpose, epoch, step and (if
    not 0) host, in the JAX package's order."""
    s = fold_in(fold_in(fold_in(root, PURPOSES[purpose]), epoch), step)
    return fold_in(s, host) if host else s


def seed_words(seed: int) -> Tuple[int, int]:
    """Two uint32 words of a 64-bit seed (low, high): the mask pool's key."""
    return seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF


def generator(seed: int, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from a 64-bit seed."""
    return torch.Generator(device=device).manual_seed(seed & MASK64)
