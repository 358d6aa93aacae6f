"""7x7 depthwise convolution, NHWC (counterpart of ``tpu_captioner/ops/dwconv.py``).

    y[b,h,w,c] = sum_{dy,dx} x_pad[b,h+dy,w+dx,c] * w[dy,dx,c] (+ bias[c])   (stride 1, pad 3)

Layouts are the JAX package's: x (B, H, W, C), w (7, 7, C), bias (C,).  The
JAX package adds the ConvNeXt block's bias outside its kernel; here the
forward kernel adds it in its epilogue, and the filter-gradient kernel gives
its gradient, the sum of the cotangent, from the tiles it already reads.
``depthwise_conv7x7_nhwc`` is a ``torch.autograd.Function`` (the JAX
package's ``custom_vjp``):
- the forward, and the input gradient (the same conv of the cotangent with
  the filter flipped, no bias): with ``use_kernel``, ``dwconv_forward``,
  which launches ``csrc/dwconv.cu``'s forward kernel for CUDA tensors and
  runs ``_dw_plain`` for CPU tensors; without it, ``_dw_plain``
  (``F.conv2d(groups=C)``);
- the filter (and bias) gradient: with ``grad_kernel``,
  ``dwconv_filter_grad``, which launches the gradient kernel for CUDA
  tensors and runs ``_dw_grad_plain`` (the 49-tap reduction of the JAX
  ``_dw_grad_xla``) for CPU tensors; without it, ``_dw_grad_library``, the
  convolution's own weight and bias gradient (``aten.convolution_backward``:
  cuDNN on the card).
The input gradient is skipped when x needs none.  Any other device raises.
Both kernels take their tile plan from ``dwconv_plan``; a shape or a card
the plan does not fit raises ``ValueError``, never a fallback.
``depthwise_conv7x7_nhwc.launches`` counts forward-kernel launches (forward
and input gradient), ``depthwise_conv7x7_nhwc.grad_launches`` filter-gradient
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from tpu_captioner_torch.ops import _build

K = 7  # filter size
PAD = K // 2

# The kernels' tile plan (csrc/dwconv.cu re-checks every number).
SMEM_LIMIT = 232_448  # dynamic shared memory a Hopper block may have
WHOLE = 16  # images up to WHOLE x WHOLE are one tile; larger ones take WHOLE x WHOLE tiles
PATCH_ROWS, PATCH_COLS = 2, 8  # a consumer warp's output patch, one channel per lane
MAX_WARPS = 16  # consumer warps per block (the producer warp is one more)
MAX_SLOTS = 4
CLUSTER = 8  # filter-gradient blocks per channel chunk, summed through distributed shared memory
_HEADER = 128 + 256  # base alignment slack, then the mbarriers
_ROWS = K * K + 1  # the filter gradient's rows: 49 taps, then the bias


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _region(n_bytes: int) -> int:
    """Shared bytes of a region holding n_bytes: 32 floats of slack (lanes
    past the chunk read, and ignore, up to 31 floats past its end), rounded
    up to 128 bytes (a TMA destination's alignment)."""
    return _ceil(n_bytes + 128, 128) * 128


class DwconvPlan(NamedTuple):
    """A launch's tiles: ``th`` x ``tw`` output pixels (multiples of the 2 x
    8 warp patch) x ``cc`` channels per tile, a ring of ``slots`` boxes,
    ``parts`` blocks per channel chunk, TMA boxes or the producer warp's own
    loads, and the dynamic shared memory the kernel needs."""

    th: int
    tw: int
    cc: int
    slots: int
    parts: int
    tma: bool
    smem: int
    units: int  # consumer warps per block: 32-channel groups x patches per tile
    chunks: int  # channel chunks (grid rows)
    tiles: int  # tiles per channel chunk

    def args(self):
        """The C entry points' plan arguments."""
        return self.th, self.tw, self.cc, self.slots, self.parts, int(self.tma), self.smem


@functools.lru_cache(maxsize=None)
def dwconv_plan(B: int, H: int, W: int, C: int, kind: str = "forward", tma: bool = True,
                sms: int = 132, cluster: int = CLUSTER) -> DwconvPlan:
    """The tile plan of a ``kind`` launch ('forward', also the input
    gradient, or 'wgrad') on a card with ``sms`` SMs.  An image of at most
    16 x 16 is one tile (its halo lies outside the image: TMA zero-fills it
    and reads nothing); a larger one takes 16 x 16 tiles (a 22 x 22 halo'd
    box: 1.89x the tile).  Each consumer warp owns one 32-channel x 2 x 8
    patch of every tile, so a tile has ``units`` of them, at most 16: the
    chunk takes the most 32-channel groups (1, 2 or 4) whose boxes leave room
    for a ring of two or more slots in shared memory, beside the filter
    slice (forward) or the cotangent box (wgrad).  The forward spreads the
    tiles of a chunk over ``sms // chunks`` blocks (at least one, at most one
    per tile); the filter gradient over a cluster of ``cluster`` blocks (at
    most 8, the portable size; ``fit_cluster`` picks it).  ``tma`` takes the
    copy engine's boxes, which need C % 4 == 0 (16-byte rows): the wrapper
    asks for it when the pointers are 16-byte aligned too, and otherwise
    takes the same kernel with the producer warp's own loads.  Raises
    ValueError for a shape it does not fit.  Cached: a wrapper asks for
    its plan at every launch."""
    if kind not in ("forward", "wgrad"):
        raise ValueError(f"dwconv_plan: kind must be 'forward' or 'wgrad', got {kind!r}")
    if min(B, H, W, C) < 1:
        raise ValueError(f"dwconv_plan: empty shape {(B, H, W, C)}")
    if tma and C % 4:
        raise ValueError(f"dwconv_plan: TMA boxes need C % 4 == 0 (16-byte rows), got C={C}")
    if not 1 <= cluster <= CLUSTER:
        raise ValueError(f"dwconv_plan: a cluster has 1 to {CLUSTER} blocks, got {cluster}")
    wgrad = kind == "wgrad"
    if H <= WHOLE and W <= WHOLE:
        th, tw = _ceil(H, PATCH_ROWS) * PATCH_ROWS, _ceil(W, PATCH_COLS) * PATCH_COLS
    else:
        th = tw = WHOLE
    per32 = (th // PATCH_ROWS) * (tw // PATCH_COLS)
    tiles = B * _ceil(H, th) * _ceil(W, tw)
    widest = _ceil(C, 4) * 4 if tma else C
    for groups in (4, 2, 1):
        cc = min(32 * groups, widest)
        units = _ceil(cc, 32) * per32
        if units > MAX_WARPS or (groups > 1 and cc <= 32 * (groups // 2)):
            continue  # too many warps, or no more channels than the next narrower chunk
        chunks = _ceil(C, cc)
        parts = cluster if wgrad else max(1, min(tiles, sms // chunks))
        x_box = _region(4 * (th + 2 * PAD) * (tw + 2 * PAD) * cc)
        slot = x_box + (_region(4 * th * tw * cc) if wgrad else 0)
        filt = 0 if wgrad else _region(4 * K * K * cc)
        fit = (SMEM_LIMIT - _HEADER - filt) // slot
        slots = min(MAX_SLOTS, fit, max(2, _ceil(tiles, parts)))
        if slots < 2:
            continue
        ring = max(slots * slot, 4 * _ROWS * (32 * units + cc)) if wgrad else slots * slot
        smem = _HEADER + filt + ring
        if smem <= SMEM_LIMIT and chunks <= 65535:
            return DwconvPlan(th, tw, cc, slots, parts, bool(tma), smem, units, chunks, tiles)
    raise ValueError(f"dwconv_plan: no {kind} plan fits {SMEM_LIMIT} bytes of shared memory for "
                     f"{(B, H, W, C)}")


def fit_cluster(plan_of, active) -> DwconvPlan:
    """The filter gradient's plan with the largest cluster, from 8 blocks
    down, whose channel chunks all run at once: ``plan_of(k)`` is the plan
    with clusters of k blocks, ``active(plan)`` how many such clusters the
    card holds together (cudaOccupancyMaxActiveClusters).  A cluster's
    blocks must share a GPC; on an H100 80GB HBM3 15 clusters of 8 (or 7)
    one-per-SM blocks fit against 17 of 6, so stages 3 and 4 (16 chunks
    each) take clusters of 6: 23.6 and 16.4 us against 32.7 and 24.1 in
    two waves of 8-block clusters (``scripts/dwconv_probe.py clusters``).
    When no size fits, clusters of 8."""
    for k in range(CLUSTER, 0, -1):
        plan = plan_of(k)
        if plan.chunks <= active(plan):
            return plan
    return plan_of(CLUSTER)


def _dw_plain(x, w, bias=None):
    """Plain PyTorch version of the forward kernel: the grouped conv on the
    NHWC tensor's NCHW view, with the bias when one is given.  x (B, H, W,
    C), w (7, 7, C), bias (C,) or None -> (B, H, W, C)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(2, 0, 1).unsqueeze(1), bias, padding=PAD, groups=x.shape[-1])
    return y.permute(0, 2, 3, 1).contiguous()


def _dw_grad_plain(x, g, bias_grad=False):
    """Plain PyTorch version of the filter-gradient kernel, the JAX
    ``_dw_grad_xla`` (tpu_captioner/ops/dwconv.py:140-154) written out:
    dw[dy,dx,c] = sum over (b, h, w) of x_pad[b,h+dy,w+dx,c] * g[b,h,w,c];
    with ``bias_grad``, (dw, the sum of g over (b, h, w))."""
    h, w = x.shape[1:3]
    xp = F.pad(x, (0, 0, PAD, PAD, PAD, PAD))
    taps = [(xp[:, dy : dy + h, dx : dx + w] * g).sum(dim=(0, 1, 2)) for dy in range(K) for dx in range(K)]
    dw = torch.stack(taps).reshape(K, K, -1)
    return (dw, g.sum(dim=(0, 1, 2))) if bias_grad else dw


def _dw_grad_library(x, g, w, bias_grad=False):
    """The grouped conv's own weight gradient (cuDNN on the card), as
    autograd of ``F.conv2d`` computes it; returned in the (7, 7, C) layout.
    With ``bias_grad``, (dw, the bias gradient from the same call)."""
    c = x.shape[-1]
    _, dw, db = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w.permute(2, 0, 1).unsqueeze(1),
        [c] if bias_grad else None, [1, 1], [PAD, PAD], [1, 1], False, [0, 0], c, [False, True, bias_grad],
    )
    dw = dw.reshape(c, K * K).t().reshape(K, K, c)
    return (dw, db) if bias_grad else dw


def _check(what, x, other, other_name, other_shape, bias=None):
    """Raise unless x (B, H, W, C), ``other`` and the bias (when given) are
    contiguous float32 tensors on one device, ``other`` of ``other_shape``
    and the bias of (C,), on the CPU or a card."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be (B, H, W, C), got shape {tuple(x.shape)}")
    named = [("x", x, x.shape), (other_name, other, other_shape)]
    if bias is not None:
        named.append(("bias", bias, (x.shape[-1],)))
    for name, t, shape in named:
        if t.dtype == torch.float32 and t.device == x.device and t.is_contiguous() and t.shape == shape:
            continue  # the common case, in one test (the check runs at every launch)
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {x.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} must have shape {tuple(shape)}, got {tuple(t.shape)}")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("dwconv")
    lib.tc_dwconv_forward.restype = ctypes.c_int
    lib.tc_dwconv_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    lib.tc_dwconv_wgrad.restype = ctypes.c_int
    lib.tc_dwconv_wgrad.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    lib.tc_dwconv_wgrad_clusters.restype = ctypes.c_int
    lib.tc_dwconv_wgrad_clusters.argtypes = [ctypes.c_int] * 6
    return lib


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _stream(device: int) -> int:
    """The current stream's handle on the card, through the raw accessor
    (0.2 us a call on the host of an H100 machine): ``torch.cuda.
    current_stream(...).cuda_stream`` took 5.6 us, as long as a bs-8
    stage-4 launch runs (``scripts/dwconv_probe.py host``)."""
    return torch._C._cuda_getCurrentRawStream(device)


@functools.lru_cache(maxsize=None)
def _active_clusters(device: int, plan: DwconvPlan) -> int:
    """Clusters of the plan's filter-gradient blocks the card runs at once."""
    lib = _lib()
    with torch.cuda.device(device):
        n = lib.tc_dwconv_wgrad_clusters(plan.units, plan.parts, plan.smem, int(plan.tma), plan.cc, plan.tw)
    _build.check(lib, max(0, -n), "dwconv_wgrad occupancy")
    return n


def _plan_for(kind, x, *others) -> DwconvPlan:
    """The plan of a launch on x's card: TMA when C % 4 == 0 and every
    pointer is 16-byte aligned, else the producer warp's own loads; the
    filter gradient's cluster size fitted to the card (``fit_cluster``)."""
    b, h, w, c = x.shape
    tma = c % 4 == 0 and _aligned(x, *others)
    if kind == "forward":
        return dwconv_plan(b, h, w, c, kind, tma, _sms(x.get_device()))
    return _wgrad_plan(x.get_device(), b, h, w, c, tma)


@functools.lru_cache(maxsize=None)
def _wgrad_plan(device, b, h, w, c, tma) -> DwconvPlan:
    return fit_cluster(lambda k: dwconv_plan(b, h, w, c, "wgrad", tma, _sms(device), k),
                       functools.partial(_active_clusters, device))


def dwconv_forward(x: torch.Tensor, w: torch.Tensor, flip: bool = False,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The conv of x (B, H, W, C) with w (7, 7, C), or with w flipped in both
    spatial axes (``flip``: the input gradient for a cotangent x), plus
    ``bias`` (C,) when given.  CUDA tensors launch the forward kernel on the
    current stream with ``dwconv_plan``'s tiles; CPU tensors run
    ``_dw_plain``; any other device raises."""
    _check("dwconv_forward", x, w, "w", (K, K, x.shape[-1]), bias)
    if x.device.type == "cpu":
        return _dw_plain(x, w.flip(0, 1) if flip else w, bias)
    b, h, wd, c = x.shape
    plan = _plan_for("forward", x, w)
    lib = _lib()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.tc_dwconv_forward(
            x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(),
            b, h, wd, c, int(flip), *plan.args(), _stream(x.get_device()),
        )
    _build.check(lib, err, "dwconv")
    depthwise_conv7x7_nhwc.launches += 1
    return y


def dwconv_filter_grad(x: torch.Tensor, g: torch.Tensor, bias_grad: bool = False):
    """The filter gradient (7, 7, C) of the conv for input x and cotangent g,
    both (B, H, W, C); with ``bias_grad``, (dw, the bias gradient (C,): the
    sum of g over (B, H, W)) from the same launch.  CUDA tensors launch the
    gradient kernel (one launch, a cluster of blocks per channel chunk, a
    fixed summation order) on the current stream; CPU tensors run
    ``_dw_grad_plain``; any other device raises."""
    _check("dwconv_filter_grad", x, g, "g", tuple(x.shape))
    if x.device.type == "cpu":
        return _dw_grad_plain(x, g, bias_grad)
    b, h, w, c = x.shape
    plan = _plan_for("wgrad", x, g)
    lib = _lib()
    dw = x.new_empty(K, K, c)
    db = x.new_empty(c) if bias_grad else None
    with torch.cuda.device(x.device):
        err = lib.tc_dwconv_wgrad(
            x.data_ptr(), g.data_ptr(), dw.data_ptr(), None if db is None else db.data_ptr(),
            b, h, w, c, *plan.args(), _stream(x.get_device()),
        )
    _build.check(lib, err, "dwconv_wgrad")
    depthwise_conv7x7_nhwc.grad_launches += 1
    return (dw, db) if bias_grad else dw


class _DepthwiseConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, use_kernel, grad_kernel, bias):
        ctx.save_for_backward(x, w)
        ctx.use_kernel, ctx.grad_kernel = use_kernel, grad_kernel
        return dwconv_forward(x, w, False, bias) if use_kernel else _dw_plain(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        need_x, need_w, _, _, need_b = ctx.needs_input_grad
        d_x = d_w = d_b = None
        if need_x:
            d_x = dwconv_forward(g, w, flip=True) if ctx.use_kernel else _dw_plain(g, w.flip(0, 1))
        if need_w:
            if ctx.grad_kernel:
                d_w = dwconv_filter_grad(x, g, bias_grad=need_b)
            else:
                d_w = _dw_grad_library(x, g, w, bias_grad=need_b)
            if need_b:
                d_w, d_b = d_w
        elif need_b:
            d_b = g.sum(dim=(0, 1, 2))
        return d_x, d_w, None, None, d_b


def depthwise_conv7x7_nhwc(
    x: torch.Tensor,  # (B, H, W, C)
    w: torch.Tensor,  # (7, 7, C)
    use_kernel: bool = True,
    grad_kernel: bool = False,
    bias: Optional[torch.Tensor] = None,  # (C,)
) -> torch.Tensor:
    """y[b,h,w,c] = sum_{dy,dx} x_pad[b,h+dy,w+dx,c] * w[dy,dx,c] (+ bias[c]),
    differentiable in x, w and the bias.  ``use_kernel`` is the JAX
    ``use_pallas`` (forward and input gradient), ``grad_kernel`` the JAX
    ``TPU_CAPTIONER_DW_GRAD=pallas`` (filter and bias gradient).  Refuses
    tensors that are not contiguous float32 on one device."""
    _check("depthwise_conv7x7_nhwc", x, w, "w", (K, K, x.shape[-1]), bias)
    return _DepthwiseConv.apply(x, w, bool(use_kernel), bool(grad_kernel), bias)


depthwise_conv7x7_nhwc.launches = 0  # forward-kernel launches: forward and input gradient
depthwise_conv7x7_nhwc.grad_launches = 0  # filter-gradient launches
