"""A whole ConvNeXt block (counterpart of ``tpu_captioner/ops/block_fused.py``).

    out = x + sd * gamma * MLP(LN(dwconv7x7(x) + dw_b))

x (B, H, W, C) NHWC, sd (B,) one stochastic-depth scale per image (ones in
eval), dw_w (7, 7, C), LayerNorm eps 1e-6, the exact erf GELU, and the
port's ``nn.Linear`` layouts: w1 (4C, C), w2 (C, 4C).

``fused_convnext_block`` is a ``torch.autograd.Function`` (the JAX package's
``custom_vjp``).  Its forward launches ``csrc/block_fused.cu`` for CUDA
tensors and runs ``_block_plain`` for CPU tensors; any other device raises.
On the card a forward is one call of the C entry point, which launches the
weights' TF32 split, the conv + LayerNorm kernel (tiles from
``block_plan``) that writes LN(t) as the two TF32 planes of the first
product, and the two 3xTF32 products; ``ops/tf32.py:block_forward`` models
that arithmetic on the CPU for the tests.
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
``fused_convnext_block.launches`` counts forward calls on the card, one per
block.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from tpu_captioner_torch.ops import _build
from tpu_captioner_torch.ops.dwconv import PAD, dwconv_filter_grad, dwconv_forward
from tpu_captioner_torch.ops.mlp_block import LN_EPS, SUPPORTED_C, _check, _param_shapes, fused_convnext_mlp_bwd

# The conv + LayerNorm kernel's tile plan (csrc/block_fused.cu re-checks every number).
CHUNK = 128  # channels a block convolves; a cluster of C / CHUNK blocks spans C
TILE_COLS = 8  # tile columns: one warp patch of 2 x 8 pixels across
TILE_ROWS = (8, 4, 2)  # tile rows, largest first: a warp patch is 2 rows
MAX_SLOTS = 4
SMEM_LIMIT = 232_448  # dynamic shared memory a Hopper block may have
_HEADER = 128 + 128  # base alignment slack, then the mbarriers
# Shared bytes beside the ring: per tile pixel the four channel groups' sums,
# the block's mean, two tiles' swapped (mean, M2) pairs, the merged (mean, rstd).
_SMALL = 4 * 64 * (CHUNK // 32 + 1 + 4 + 2)


class BlockPlan(NamedTuple):
    """A conv + LayerNorm launch: tiles of ``th`` x ``tw`` pixels of one
    image, ``cc`` channels a block, clusters of ``cluster`` blocks that
    together span C, a ring of ``slots`` halo'd boxes a block, ``parts``
    clusters walking the tiles, and the dynamic shared memory."""

    th: int
    tw: int
    cc: int
    cluster: int
    slots: int
    parts: int
    smem: int
    units: int  # warps a block: 32-channel groups x 2 x 8 patches of a tile
    tiles: int

    def args(self):
        """The C entry point's plan arguments."""
        return self.th, self.tw, self.cc, self.cluster, self.slots, self.parts, self.smem


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def block_plan(B: int, H: int, W: int, C: int, sms: int = 132, active: int = 0) -> BlockPlan:
    """The conv + LayerNorm kernel's tiles for x (B, H, W, C) on a card with
    ``sms`` SMs, of which ``active`` clusters of the plan's blocks run at
    once (0: one block an SM).  A pixel's LayerNorm needs all C channels,
    so a cluster of C / 128 blocks splits them (128 a block, four 32-channel
    warp groups) and its blocks swap two floats a pixel.  A tile is th x 8
    pixels of one image (TMA zero-fills the halo and the image's edge; a
    ragged last tile computes pixels it never stores): the tallest of 8, 4
    and 2 rows, at most the image's height rounded up to even, whose
    blocks fill at least half the SMs (a block's warps each take one 2 x 8
    patch of a tile, so shorter tiles spread a small batch over more SMs),
    else 2.  Each block holds a ring of 2-4 halo'd
    boxes ((th + 6) x 14 pixels x 128 channels) and the per-pixel sums.
    Raises ValueError for a width the kernels are not built for
    (``SUPPORTED_C``) or a plan that does not fit ``SMEM_LIMIT``.  Cached:
    the wrapper asks for it at every launch."""
    if C not in SUPPORTED_C:
        raise ValueError(f"block_plan: the kernel supports C in {SUPPORTED_C}, got {C}")
    if min(B, H, W) < 1:
        raise ValueError(f"block_plan: empty shape {(B, H, W, C)}")
    cluster = C // CHUNK
    rows = [th for th in TILE_ROWS if th <= _ceil(H, 2) * 2] or [TILE_ROWS[-1]]
    tiles_of = {th: B * _ceil(H, th) * _ceil(W, TILE_COLS) for th in rows}
    th = next((t for t in rows if 2 * tiles_of[t] * cluster >= sms), rows[-1])
    tiles = tiles_of[th]
    parts = max(1, min(tiles, active or sms // cluster))
    box = 4 * (th + 2 * PAD) * (TILE_COLS + 2 * PAD) * CHUNK
    slots = min(MAX_SLOTS, (SMEM_LIMIT - _HEADER - _SMALL) // box, max(2, _ceil(tiles, parts)))
    if slots < 2:
        raise ValueError(f"block_plan: no plan fits {SMEM_LIMIT} bytes of shared memory for {(B, H, W, C)}")
    units = CHUNK // 32 * (th // 2)
    return BlockPlan(th, TILE_COLS, CHUNK, cluster, slots, parts, _HEADER + _SMALL + slots * box, units, tiles)


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


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("block_fused")
    lib.tc_block_fused_forward.restype = ctypes.c_int
    lib.tc_block_fused_forward.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    lib.tc_block_fused_workspace.restype = ctypes.c_longlong
    lib.tc_block_fused_workspace.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.tc_block_fused_clusters.restype = ctypes.c_int
    lib.tc_block_fused_clusters.argtypes = [ctypes.c_int] * 3
    return lib


@functools.lru_cache(maxsize=None)
def _plan_on(device: int, b: int, h: int, w: int, c: int) -> BlockPlan:
    """``block_plan`` on the card: as many clusters as it runs at once
    (cudaOccupancyMaxActiveClusters; clusters share a GPC, so fewer than
    132 / (C / 128) may fit)."""
    plan = block_plan(b, h, w, c, _build.sm_count(device))
    if plan.cluster == 1:
        return plan
    lib = _lib()
    with torch.cuda.device(device):
        active = lib.tc_block_fused_clusters(c, plan.units, plan.smem)
    _build.check(lib, max(0, -active), "block_fused occupancy")
    return block_plan(b, h, w, c, _build.sm_count(device), active)


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
    """The forward: the CUDA kernels for CUDA tensors, the plain version for
    CPU tensors."""
    args = (x, sd, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma)
    if x.device.type == "cpu":
        return _block_plain(*args)
    b, h, w, c = x.shape
    device = x.get_device()
    plan = _plan_on(device, b, h, w, c)
    lib = _lib()
    out = torch.empty_like(x)
    with torch.cuda.device(device):
        work = x.new_empty(lib.tc_block_fused_workspace(b * h * w, c))
        err = lib.tc_block_fused_forward(*(t.data_ptr() for t in (*args, out, work)), b, h, w, c, *plan.args(),
                                         _build.raw_stream(device))
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
