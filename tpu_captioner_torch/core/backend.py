"""CUDA probe (counterpart of ``tpu_captioner/core/backend.py``).

``require_cuda`` is the one place that decides whether a card is present; a
measurement or kernel path that finds none raises instead of falling back to
the CPU.
"""

from __future__ import annotations

import subprocess

import torch


def require_cuda() -> torch.device:
    """The first CUDA device; raises when PyTorch sees no card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is False "
            f"(torch {torch.__version__}, built for CUDA {torch.version.cuda})"
        )
    return torch.device("cuda", 0)


def device_info() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them (first card only)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()


def pin_f32_precision() -> None:
    """Full-f32 matmuls and convolutions: no TF32 in cuBLAS or cuDNN.  Without
    the cuDNN switch the stem, downsample and depthwise convs run in TF32 and
    the f32 comparison with the JAX package drifts."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
