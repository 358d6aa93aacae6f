"""Fused ConvNeXt block tail (counterpart of ``tpu_captioner/ops/mlp_block.py``).

Computes, for the rows of a ConvNeXt block after its depthwise conv:

    out = residual + sd * (gelu(LN(x) @ W1.T + b1) @ W2.T + b2) * gamma

with LayerNorm eps 1e-6 and the exact erf GELU.  ``W1`` (4C, C) and ``W2``
(C, 4C) are the ``nn.Linear`` weights as the reference checkpoint stores them
(the JAX package keeps their transposes).  ``sd`` is the per-row stochastic-
depth scale: all ones in eval.

``fused_convnext_mlp`` launches the CUDA kernel ``csrc/mlp_block.cu`` for CUDA
tensors; for CPU tensors it runs ``_mlp_plain``.  Forward only: the backward
kernel belongs to the fine-tune step and is not ported yet.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpu_captioner_torch.ops import _build

LN_EPS = 1e-6
SUPPORTED_C = (128, 256, 512, 1024)  # the widths the kernel is instantiated for


def _mlp_plain(x, residual, sd, ln_w, ln_b, w1, b1, w2, b2, gamma):
    """Plain PyTorch version of the fused tail; the kernel's definition."""
    xn = F.layer_norm(x, (x.shape[-1],), ln_w, ln_b, LN_EPS)
    h = F.gelu(F.linear(xn, w1, b1))  # exact erf GELU
    y = F.linear(h, w2, b2) * gamma
    return residual + sd[:, None] * y


def _check(x, residual, sd, ln_w, ln_b, w1, b1, w2, b2, gamma):
    n, c = x.shape
    want = {
        "x": (x, (n, c)), "residual": (residual, (n, c)), "sd": (sd, (n,)),
        "ln_w": (ln_w, (c,)), "ln_b": (ln_b, (c,)),
        "w1": (w1, (4 * c, c)), "b1": (b1, (4 * c,)),
        "w2": (w2, (c, 4 * c)), "b2": (b2, (c,)), "gamma": (gamma, (c,)),
    }
    for name, (t, shape) in want.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if c not in SUPPORTED_C:
        raise ValueError(f"fused_convnext_mlp kernel supports C in {SUPPORTED_C}, got {c}")


def _lib():
    lib = _build.load("mlp_block")
    lib.tc_mlp_block_forward.restype = ctypes.c_int
    lib.tc_mlp_block_forward.argtypes = [ctypes.c_void_p] * 11 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return lib


def fused_convnext_mlp(
    x: torch.Tensor,  # (N, C) depthwise-conv output rows
    residual: torch.Tensor,  # (N, C) block input rows
    sd: torch.Tensor,  # (N,) per-row stochastic-depth scale (ones in eval)
    ln_w: torch.Tensor, ln_b: torch.Tensor,  # (C,)
    w1: torch.Tensor, b1: torch.Tensor,  # (4C, C), (4C,)
    w2: torch.Tensor, b2: torch.Tensor,  # (C, 4C), (C,)
    gamma: torch.Tensor,  # (C,) layer scale
) -> torch.Tensor:
    """The fused tail: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors; any other device raises."""
    args = (x, residual, sd, ln_w, ln_b, w1, b1, w2, b2, gamma)
    if x.device.type == "cpu":
        return _mlp_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"fused_convnext_mlp runs on cpu or cuda tensors, got {x.device}")
    _check(*args)
    lib = _lib()
    out = torch.empty_like(x)
    n, c = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tc_mlp_block_forward(
            *(t.data_ptr() for t in args), out.data_ptr(), n, c, stream
        )
    _build.check(lib, err, "mlp_block")
    fused_convnext_mlp.launches += 1
    return out


fused_convnext_mlp.launches = 0
