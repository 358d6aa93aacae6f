"""A whole ConvNeXt block in one kernel (counterpart of
``tpu_captioner/ops/block_fused.py``).

    out = x + sd * gamma * MLP(LN(dwconv7x7(x) + dw_b))

x (B, H, W, C) NHWC, sd (B,) one stochastic-depth scale per image (ones in
eval), dw_w (7, 7, C), LayerNorm eps 1e-6, the exact erf GELU, and the
port's ``nn.Linear`` layouts: w1 (4C, C), w2 (C, 4C).

``fused_convnext_block`` is a ``torch.autograd.Function`` (the JAX package's
``custom_vjp``).  Its forward launches ``csrc/block_fused.cu`` for CUDA
tensors and runs ``_block_plain`` for CPU tensors; any other device raises.
The JAX backward differentiates its reference, the conv and the tail; this
one computes the same gradient from the port's own kernels, so that no plain
version runs on the card.  It saves x, sd and the parameters (never the conv
output, never the (N, 4C) hidden activation), recomputes the conv output t
(``dwconv_forward`` with the bias in its epilogue), takes the tail's
gradients from ``fused_convnext_mlp_bwd`` and then the conv's input and
filter gradients (``dwconv_forward`` with the flipped filter,
``dwconv_filter_grad``, whose launch also gives d_dw_b = the sum of d_t):
d_x = g + conv_input_grad(d_t).  On CPU tensors each of
these wrappers runs its plain version.
``fused_convnext_block.launches`` counts forward-kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpu_captioner_torch.ops import _build
from tpu_captioner_torch.ops.dwconv import PAD, dwconv_filter_grad, dwconv_forward
from tpu_captioner_torch.ops.mlp_block import LN_EPS, _check, _param_shapes, fused_convnext_mlp_bwd


def _block_plain(x, sd, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma):
    """Plain PyTorch version of the block kernel; its definition.  The JAX
    ``_reference_impl`` (tpu_captioner/ops/block_fused.py:36) with the port's
    weight layouts."""
    c = x.shape[-1]
    t = F.conv2d(x.permute(0, 3, 1, 2), dw_w.permute(2, 0, 1).unsqueeze(1), dw_b, padding=PAD, groups=c)
    t = t.permute(0, 2, 3, 1)
    tn = F.layer_norm(t, (c,), ln_w, ln_b, LN_EPS)
    y = F.linear(F.gelu(F.linear(tn, w1, b1)), w2, b2) * gamma
    return x + sd[:, None, None, None] * y


def _lib():
    lib = _build.load("block_fused")
    lib.tc_block_fused_forward.restype = ctypes.c_int
    lib.tc_block_fused_forward.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


def _check_block(x, sd, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, kernel=None):
    """Raise unless x is (B, H, W, C) on the CPU or a card and every tensor
    is a contiguous float32 tensor of its shape on x's device.  For the
    kernel (``kernel``; default: x is on a card) also 16-byte alignment and
    C in ``SUPPORTED_C`` (``ops/mlp_block.py:_check``); the plain version on
    the CPU takes any width."""
    what = "fused_convnext_block"
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be (B, H, W, C), got shape {tuple(x.shape)}")
    b, _, _, c = x.shape
    tensors = {
        "x": (x, tuple(x.shape)), "sd": (sd, (b,)), "dw_w": (dw_w, (7, 7, c)), "dw_b": (dw_b, (c,)),
        **_param_shapes(c, ln_w, ln_b, w1, b1, w2, b2, gamma),
    }
    if kernel if kernel is not None else x.device.type == "cuda":
        _check(what, c, tensors)
        return
    for name, (t, shape) in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {x.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous with shape {shape}, got {tuple(t.shape)}")


def _block_forward(x, sd, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma):
    """The forward: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    args = (x, sd, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma)
    if x.device.type == "cpu":
        return _block_plain(*args)
    b, h, w, c = x.shape
    lib = _lib()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tc_block_fused_forward(*(t.data_ptr() for t in args), out.data_ptr(), b, h, w, c, stream)
    _build.check(lib, err, "block_fused")
    fused_convnext_block.launches += 1
    return out


class _FusedBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sd, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma):
        ctx.save_for_backward(x, sd, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma)
        return _block_forward(x, sd, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma)

    @staticmethod
    def backward(ctx, g):
        x, sd, dw_w, dw_b, *tail = ctx.saved_tensors
        b, h, w, c = x.shape
        g = g.contiguous()
        t = dwconv_forward(x, dw_w, bias=dw_b)  # the conv output, recomputed
        d_t, d_sd_rows, *d_tail = fused_convnext_mlp_bwd(
            g.view(-1, c), t.view(-1, c), sd.repeat_interleave(h * w), *tail
        )
        d_t = d_t.view(b, h, w, c)
        need = ctx.needs_input_grad
        d_x = g + dwconv_forward(d_t, dw_w, flip=True) if need[0] else None
        d_sd = d_sd_rows.view(b, h * w).sum(1) if need[1] else None
        d_dw_w = d_dw_b = None
        if need[2] and need[3]:  # the bias gradient from the filter gradient's launch
            d_dw_w, d_dw_b = dwconv_filter_grad(x, d_t, bias_grad=True)
        elif need[2]:
            d_dw_w = dwconv_filter_grad(x, d_t)
        elif need[3]:
            d_dw_b = d_t.sum((0, 1, 2))
        return (d_x, d_sd, d_dw_w, d_dw_b, *(d if n else None for d, n in zip(d_tail, need[4:])))


def fused_convnext_block(
    x: torch.Tensor,  # (B, H, W, C) block input
    sd: torch.Tensor,  # (B,) per-image stochastic-depth scale (ones in eval)
    dw_w: torch.Tensor, dw_b: torch.Tensor,  # (7, 7, C), (C,)
    ln_w: torch.Tensor, ln_b: torch.Tensor,  # (C,)
    w1: torch.Tensor, b1: torch.Tensor,  # (4C, C), (4C,)
    w2: torch.Tensor, b2: torch.Tensor,  # (C, 4C), (C,)
    gamma: torch.Tensor,  # (C,) layer scale
) -> torch.Tensor:
    """The whole block, differentiable: the CUDA kernels for CUDA tensors,
    the plain versions for CPU tensors.  Raises a ``ValueError`` for another
    device, dtype, shape or layout, and, for CUDA tensors, a width the
    kernel is not built for (C not in ``ops/mlp_block.py:SUPPORTED_C``):
    never a fallback to the plain version."""
    _check_block(x, sd, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma)
    return _FusedBlock.apply(x, sd, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma)


fused_convnext_block.launches = 0
