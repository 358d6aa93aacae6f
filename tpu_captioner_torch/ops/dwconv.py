"""7x7 depthwise convolution, NHWC (counterpart of ``tpu_captioner/ops/dwconv.py``).

    y[b,h,w,c] = sum_{dy,dx} x_pad[b,h+dy,w+dx,c] * w[dy,dx,c]   (stride 1, pad 3)

Layouts are the JAX package's: x (B, H, W, C), w (7, 7, C); the ConvNeXt
block adds the bias.  ``depthwise_conv7x7_nhwc`` is a
``torch.autograd.Function`` (the JAX package's ``custom_vjp``):
- the forward, and the input gradient (the same conv of the cotangent with
  the filter flipped): with ``use_kernel``, ``dwconv_forward``, which
  launches ``csrc/dwconv.cu``'s forward kernel for CUDA tensors and runs
  ``_dw_plain`` for CPU tensors; without it, ``_dw_plain``
  (``F.conv2d(groups=C)``);
- the filter gradient: with ``grad_kernel``, ``dwconv_filter_grad``, which
  launches the gradient kernels for CUDA tensors and runs ``_dw_grad_plain``
  (the 49-tap reduction of the JAX ``_dw_grad_xla``) for CPU tensors;
  without it, ``_dw_grad_library``, the convolution's own weight gradient
  (``aten.convolution_backward``: cuDNN on the card).
The input gradient is skipped when x needs none.  Any other device raises.
``depthwise_conv7x7_nhwc.launches`` counts forward-kernel launches (forward
and input gradient), ``depthwise_conv7x7_nhwc.grad_launches`` filter-gradient
launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpu_captioner_torch.ops import _build

K = 7  # filter size
PAD = K // 2


def _dw_plain(x, w):
    """Plain PyTorch version of the forward kernel: the grouped conv on the
    NHWC tensor's NCHW view.  x (B, H, W, C), w (7, 7, C) -> (B, H, W, C)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(2, 0, 1).unsqueeze(1), padding=PAD, groups=x.shape[-1])
    return y.permute(0, 2, 3, 1).contiguous()


def _dw_grad_plain(x, g):
    """Plain PyTorch version of the filter-gradient kernels, the JAX
    ``_dw_grad_xla`` (tpu_captioner/ops/dwconv.py:140-154) written out:
    dw[dy,dx,c] = sum over (b, h, w) of x_pad[b,h+dy,w+dx,c] * g[b,h,w,c]."""
    h, w = x.shape[1:3]
    xp = F.pad(x, (0, 0, PAD, PAD, PAD, PAD))
    taps = [(xp[:, dy : dy + h, dx : dx + w] * g).sum(dim=(0, 1, 2)) for dy in range(K) for dx in range(K)]
    return torch.stack(taps).reshape(K, K, -1)


def _dw_grad_library(x, g, w):
    """The grouped conv's own weight gradient (cuDNN on the card), as
    autograd of ``F.conv2d`` computes it; returned in the (7, 7, C) layout."""
    c = x.shape[-1]
    _, dw, _ = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w.permute(2, 0, 1).unsqueeze(1), None,
        [1, 1], [PAD, PAD], [1, 1], False, [0, 0], c, [False, True, False],
    )
    return dw.reshape(c, K * K).t().reshape(K, K, c)


def _check(what, x, other, other_name, other_shape):
    """Raise unless x (B, H, W, C) and ``other`` are contiguous float32
    tensors on one device, ``other`` of ``other_shape``, on the CPU or a card."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be (B, H, W, C), got shape {tuple(x.shape)}")
    for name, t in (("x", x), (other_name, other)):
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {x.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if tuple(other.shape) != tuple(other_shape):
        raise ValueError(f"{what}: {other_name} must have shape {tuple(other_shape)}, got {tuple(other.shape)}")


def _lib():
    lib = _build.load("dwconv")
    lib.tc_dwconv_forward.restype = ctypes.c_int
    lib.tc_dwconv_forward.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.tc_dwconv_wgrad.restype = ctypes.c_int
    lib.tc_dwconv_wgrad.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.tc_dwconv_wgrad_scratch_floats.restype = ctypes.c_longlong
    lib.tc_dwconv_wgrad_scratch_floats.argtypes = [ctypes.c_int] * 3
    return lib


def dwconv_forward(x: torch.Tensor, w: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """The conv of x (B, H, W, C) with w (7, 7, C), or with w flipped in both
    spatial axes (``flip``: the input gradient for a cotangent x).  CUDA
    tensors launch the forward kernel on the current stream; CPU tensors run
    ``_dw_plain``; any other device raises."""
    _check("dwconv_forward", x, w, "w", (K, K, x.shape[-1]))
    if x.device.type == "cpu":
        return _dw_plain(x, w.flip(0, 1) if flip else w)
    b, h, wd, c = x.shape
    lib = _lib()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.tc_dwconv_forward(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h, wd, c, int(flip),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, err, "dwconv")
    depthwise_conv7x7_nhwc.launches += 1
    return y


def dwconv_filter_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The filter gradient (7, 7, C) of the conv for input x and cotangent g,
    both (B, H, W, C).  CUDA tensors launch the two gradient kernels (block
    partials, then their sum in a fixed order) on the current stream, with
    scratch from ``torch.empty``; CPU tensors run ``_dw_grad_plain``; any
    other device raises."""
    _check("dwconv_filter_grad", x, g, "g", tuple(x.shape))
    if x.device.type == "cpu":
        return _dw_grad_plain(x, g)
    b, h, w, c = x.shape
    lib = _lib()
    dw = x.new_empty(K, K, c)
    with torch.cuda.device(x.device):
        scratch = x.new_empty(lib.tc_dwconv_wgrad_scratch_floats(b, h, c))
        err = lib.tc_dwconv_wgrad(
            x.data_ptr(), g.data_ptr(), scratch.data_ptr(), dw.data_ptr(), b, h, w, c,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, err, "dwconv_wgrad")
    depthwise_conv7x7_nhwc.grad_launches += 1
    return dw


class _DepthwiseConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, use_kernel, grad_kernel):
        ctx.save_for_backward(x, w)
        ctx.use_kernel, ctx.grad_kernel = use_kernel, grad_kernel
        return dwconv_forward(x, w) if use_kernel else _dw_plain(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        d_x = d_w = None
        if ctx.needs_input_grad[0]:
            d_x = dwconv_forward(g, w, flip=True) if ctx.use_kernel else _dw_plain(g, w.flip(0, 1))
        if ctx.needs_input_grad[1]:
            d_w = dwconv_filter_grad(x, g) if ctx.grad_kernel else _dw_grad_library(x, g, w)
        return d_x, d_w, None, None


def depthwise_conv7x7_nhwc(
    x: torch.Tensor,  # (B, H, W, C)
    w: torch.Tensor,  # (7, 7, C)
    use_kernel: bool = True,
    grad_kernel: bool = False,
) -> torch.Tensor:
    """y[b,h,w,c] = sum_{dy,dx} x_pad[b,h+dy,w+dx,c] * w[dy,dx,c],
    differentiable.  ``use_kernel`` is the JAX ``use_pallas`` (forward and
    input gradient), ``grad_kernel`` the JAX ``TPU_CAPTIONER_DW_GRAD=pallas``
    (filter gradient).  Refuses tensors that are not contiguous float32 on one
    device."""
    _check("depthwise_conv7x7_nhwc", x, w, "w", (K, K, x.shape[-1]))
    return _DepthwiseConv.apply(x, w, bool(use_kernel), bool(grad_kernel))


depthwise_conv7x7_nhwc.launches = 0  # forward-kernel launches: forward and input gradient
depthwise_conv7x7_nhwc.grad_launches = 0  # filter-gradient launches (two kernels each)
