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

bf16 (the bf16 encoder in ``'block'``): x, the taps, w1 and w2 bf16, the
rest f32, as the JAX bf16 block hands them to its kernel
(tpu_captioner/models/convnext.py:142-149); any other mix raises
``ValueError``, on the CPU too.  The forward is the JAX kernel's
arithmetic on those operands (tpu_captioner/ops/block_fused.py:53-83):
the conv's f32 sum of bf16 products plus the f32 bias, never rounded,
then LayerNorm, products, GELU and residual in f32, out rounded to bf16
once (``_block_plain_bf16``; ``csrc/block_fused.cu``'s bf16 instance,
counted also in ``fused_convnext_block.bf16_launches``).  On the card that
instance is three launches: the conv + LayerNorm kernel writes LN(t) as one
f32 plane, and the MLP tail's bf16 whole tile's two products (each f32 row
value in three exact bf16 pieces times the bf16 weight as it lies) run on
it, no weight split; its workspace is ``block_workspace(n, c, 2)``.  The JAX backward
is the VJP of its reference on those operands (:36-50, :181-183), and
this one rounds where that VJP rounds: t is recomputed as the bf16 conv
(``dwconv_forward``'s bf16 instance, rounded once) widened plus the f32
bias; the tail's gradients are f32 arithmetic on g, w1 and w2 widened
(``fused_convnext_mlp_bwd``'s f32 instance), d_w1 and d_w2 come back in
f32 and autograd rounds each once to bf16; the conv's cotangent d_t is
rounded to bf16 once for the conv's bf16 input and filter gradients
(d_dw_w rounded once by autograd), d_dw_b is the f32 sum of the unrounded
d_t (a PyTorch sum over the pixels: the filter-gradient launch's own
bias sum would read the rounded d_t), and d_x = bf16(g + the conv's input
gradient).
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
def block_plan(B: int, H: int, W: int, C: int, sms: int = 132, active: int = 0, esize: int = 4) -> BlockPlan:
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
    boxes ((th + 6) x 14 pixels x 128 channels of ``esize`` bytes: 4 for
    f32 x, 2 for the bf16 instance, whose boxes stay bf16) and the
    per-pixel sums.  Raises ValueError for a width the kernels are not built for
    (``SUPPORTED_C``) or a plan that does not fit ``SMEM_LIMIT``.  Cached:
    the wrapper asks for it at every launch."""
    if C not in SUPPORTED_C:
        raise ValueError(f"block_plan: the kernel supports C in {SUPPORTED_C}, got {C}")
    if min(B, H, W) < 1:
        raise ValueError(f"block_plan: empty shape {(B, H, W, C)}")
    if esize not in (2, 4):
        raise ValueError(f"block_plan: elements of 4 or 2 bytes, got {esize}")
    cluster = C // CHUNK
    rows = [th for th in TILE_ROWS if th <= _ceil(H, 2) * 2] or [TILE_ROWS[-1]]
    tiles_of = {th: B * _ceil(H, th) * _ceil(W, TILE_COLS) for th in rows}
    th = next((t for t in rows if 2 * tiles_of[t] * cluster >= sms), rows[-1])
    tiles = tiles_of[th]
    parts = max(1, min(tiles, active or sms // cluster))
    box = esize * (th + 2 * PAD) * (TILE_COLS + 2 * PAD) * CHUNK
    slots = min(MAX_SLOTS, (SMEM_LIMIT - _HEADER - _SMALL) // box, max(2, _ceil(tiles, parts)))
    if slots < 2:
        raise ValueError(f"block_plan: no plan fits {SMEM_LIMIT} bytes of shared memory for {(B, H, W, C)}")
    units = CHUNK // 32 * (th // 2)
    return BlockPlan(th, TILE_COLS, CHUNK, cluster, slots, parts, _HEADER + _SMALL + slots * box, units, tiles)


def _round32(v: int) -> int:
    return -(-v // 32) * 32


def block_workspace(n: int, c: int, esize: int = 4) -> int:
    """Floats of workspace a forward call on ``n`` = B*H*W pixels of width
    ``c`` needs, as ``tc_block_fused_workspace`` computes it: for f32 x
    (``esize`` 4) LN(t)'s two TF32 planes (2 N C), h's (8 N C) and the
    weights' splits (8 C^2 each); for the bf16 instance (2) LN(t) as one f32
    plane (N C) and h as one (4 N C), the weights read as they lie.  Each
    array starts on a 32-float boundary."""
    if esize == 4:
        return _round32(2 * n * c) + _round32(8 * n * c) + 2 * _round32(8 * c * c)
    if esize == 2:
        return _round32(n * c) + _round32(4 * n * c)
    raise ValueError(f"block_workspace: elements of 4 or 2 bytes, got {esize}")


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


def _block_plain_bf16(x, sd, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma):
    """Plain version of the bf16 instance: ``_block_plain`` on x, the taps,
    w1 and w2 widened to f32 (exactly), the result rounded to bf16 once, as
    the JAX kernel computes on bf16 operands (the conv's sum and its bias
    in f32, t never rounded)."""
    return _block_plain(x.float(), sd, dw_w.float(), dw_b, ln_w, ln_b, w1.float(), b1, w2.float(), b2,
                        gamma).to(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("block_fused")
    for fn in (lib.tc_block_fused_forward, lib.tc_block_fused_forward_bf16):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    lib.tc_block_fused_workspace.restype = ctypes.c_longlong
    lib.tc_block_fused_workspace.argtypes = [ctypes.c_int] * 3
    lib.tc_block_fused_clusters.restype = ctypes.c_int
    lib.tc_block_fused_clusters.argtypes = [ctypes.c_int] * 4
    return lib


@functools.lru_cache(maxsize=None)
def _plan_on(device: int, b: int, h: int, w: int, c: int, esize: int = 4) -> BlockPlan:
    """``block_plan`` on the card for x of ``esize``-byte elements: as many
    clusters as it runs at once (cudaOccupancyMaxActiveClusters; clusters
    share a GPC, so fewer than 132 / (C / 128) may fit)."""
    plan = block_plan(b, h, w, c, _build.sm_count(device), esize=esize)
    if plan.cluster == 1:
        return plan
    lib = _lib()
    with torch.cuda.device(device):
        active = lib.tc_block_fused_clusters(c, plan.units, plan.smem, esize)
    _build.check(lib, max(0, -active), "block_fused occupancy")
    return block_plan(b, h, w, c, _build.sm_count(device), active, esize)


_BF16_SET = ("x", "dw_w", "w1", "w2")  # the bf16 instance's bf16 operands; the output too


def _check_block(x, sd, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, kernel=None):
    """Raise unless x is (B, H, W, C) on the CPU or a card and every tensor
    is a contiguous tensor of its shape on x's device: all float32, or (x
    bf16) x, dw_w, w1 and w2 bfloat16 and the rest float32.  For the
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
    bf16 = _BF16_SET if x.dtype == torch.bfloat16 else ()
    if kernel if kernel is not None else x.device.type == "cuda":
        _check(what, c, tensors, bf16)
        return
    for name, (t, shape) in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {x.device}")
        want = torch.bfloat16 if name in bf16 else torch.float32
        if t.dtype != want:
            raise ValueError(f"{what}: {name} must be {str(want)[6:]}, got {t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous with shape {shape}, got {tuple(t.shape)}")


def _block_forward(x, sd, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma):
    """The forward: the CUDA kernels for CUDA tensors (the bf16 instance
    when x is bf16), the plain version for CPU tensors."""
    args = (x, sd, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma)
    bf16 = x.dtype == torch.bfloat16
    if x.device.type == "cpu":
        return _block_plain_bf16(*args) if bf16 else _block_plain(*args)
    _build.require_current_device("fused_convnext_block", args)
    b, h, w, c = x.shape
    device = x.get_device()
    plan = _plan_on(device, b, h, w, c, x.element_size())
    lib = _lib()
    out = torch.empty_like(x)
    launch = lib.tc_block_fused_forward_bf16 if bf16 else lib.tc_block_fused_forward
    with torch.cuda.device(device):
        work = sd.new_empty(lib.tc_block_fused_workspace(b * h * w, c, x.element_size()))
        err = launch(*(t.data_ptr() for t in (*args, out, work)), b, h, w, c, *plan.args(), _build.raw_stream(device))
    _build.check(lib, err, "block_fused")
    fused_convnext_block.launches += 1
    if bf16:
        fused_convnext_block.bf16_launches += 1
    return out


class _FusedBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sd, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma):
        ctx.save_for_backward(x, sd, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma)
        return _block_forward(x, sd, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma)

    @staticmethod
    def backward(ctx, g):
        x, sd, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma = ctx.saved_tensors
        b, h, w, c = x.shape
        g = g.contiguous()
        bf16 = x.dtype == torch.bfloat16
        need = ctx.needs_input_grad
        if bf16:  # the module note says where each gradient rounds
            t = dwconv_forward(x, dw_w).float() + dw_b  # bf16(conv) + f32 bias, as JAX's VJP recomputes it
            tail = (ln_w, ln_b, w1.float(), b1, w2.float(), b2, gamma)
            g_rows = g.float()
        else:
            t = dwconv_forward(x, dw_w, bias=dw_b)  # the conv output, recomputed
            tail, g_rows = (ln_w, ln_b, w1, b1, w2, b2, gamma), g
        d_t, d_sd_rows, *d_tail = fused_convnext_mlp_bwd(
            g_rows.view(-1, c), t.view(-1, c), sd.repeat_interleave(h * w), *tail
        )
        d_t = d_t.view(b, h, w, c)
        d_conv = d_t.to(torch.bfloat16) if bf16 else d_t  # the conv's cotangent
        d_x = g + dwconv_forward(d_conv, dw_w, flip=True) if need[0] else None
        d_sd = d_sd_rows.view(b, h * w).sum(1) if need[1] else None
        d_dw_w = d_dw_b = None
        if need[2] and need[3] and not bf16:  # the bias gradient from the filter gradient's launch
            d_dw_w, d_dw_b = dwconv_filter_grad(x, d_conv, bias_grad=True)
        else:
            d_dw_w = dwconv_filter_grad(x, d_conv) if need[2] else None
            d_dw_b = d_t.sum((0, 1, 2)) if need[3] else None
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
    the plain versions for CPU tensors; f32, or bf16 x, dw_w, w1 and w2
    with the rest f32 (a bf16 output; the module note says where bf16
    rounds).  Raises a ``ValueError`` for another device, dtype mix, shape
    or layout, and, for CUDA tensors, a width the kernel is not built for
    (C not in ``ops/mlp_block.py:SUPPORTED_C``): never a fallback to the
    plain version."""
    _check_block(x, sd, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma)
    return _FusedBlock.apply(x, sd, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma)


fused_convnext_block.launches = 0
fused_convnext_block.bf16_launches = 0  # of those, the bf16 instance's
