"""CUDA probe (counterpart of ``tpu_captioner/core/backend.py``).

``require_cuda`` is the one place that decides whether a card is present; a
measurement or kernel path that finds none raises instead of falling back to
the CPU.
"""

from __future__ import annotations

import subprocess

import torch


def require_cuda() -> torch.device:
    """The current CUDA device: a data-parallel rank's own card
    (``parallel/mesh.py`` selects it), else the first; raises when PyTorch
    sees no card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is False "
            f"(torch {torch.__version__}, built for CUDA {torch.version.cuda})"
        )
    return torch.device("cuda", torch.cuda.current_device())


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
    the f32 comparison with the JAX package drifts.  bf16 products sum in
    f32, as XLA's do: cuBLAS may otherwise reduce a bf16 GEMM's partial sums
    in bf16 (its default)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
