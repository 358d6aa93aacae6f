"""Fused ConvNeXt block tail (counterpart of ``tpu_captioner/ops/mlp_block.py``).

Computes, for the rows of a ConvNeXt block after its depthwise conv:

    out = residual + sd * (gelu(LN(x) @ W1.T + b1) @ W2.T + b2) * gamma

with LayerNorm eps 1e-6 and the exact erf GELU.  ``W1`` (4C, C) and ``W2``
(C, 4C) are the ``nn.Linear`` weights as the reference checkpoint stores them
(the JAX package keeps their transposes).  ``sd`` is the per-row stochastic-
depth scale: all ones in eval.

``fused_convnext_mlp`` is a ``torch.autograd.Function`` (the JAX package's
``custom_vjp``).  Its forward launches ``csrc/mlp_block.cu`` for CUDA tensors
and runs ``_mlp_plain`` for CPU tensors.  ``TPU_CAPTIONER_MLP_SUB``, read at
each call (``_pipeline_sub``), selects the sub-tiled kernel, the counterpart
of the JAX package's ``_kernel_pipelined``: one launch that keeps the hidden
activation on chip (``FUSED_TILES``); unset, the forward runs the
whole-tile path.  Both forwards and the backward take f32-accurate products
from TF32 tensor cores through the 3xTF32 split (``csrc/tf32x3_gemm.cuh``;
``ops/tf32.py`` models their rounding on the CPU for the tests).  Its backward
returns the cotangent itself as the residual's gradient and calls
``fused_convnext_mlp_bwd``, which launches ``csrc/mlp_block_bwd.cu`` for
CUDA tensors and runs ``_mlp_bwd_plain`` for CPU tensors.  The backward saves x (the dwconv
output), sd and the parameters, never the residual.

bf16 (the bf16 encoder, serving and training): x, the residual, the
output and the two matrices in bf16, the vectors in f32.  The forward's
bf16 instances, the whole tile and (``TPU_CAPTIONER_MLP_SUB``) the
sub-tiled kernel, are the JAX kernels' ``precise=True`` arm on bf16
operands (tpu_captioner/ops/mlp_block.py:126-189, called so by
models/convnext.py:163-171; JAX's ``_pipeline_sub`` picks the sub-tiled
body for any dtype): LayerNorm, products, GELU and residual in f32 (a bf16
weight's TF32 planes are itself and zero: the 3xTF32 products are exact on
it), the output rounded to bf16 once.  ``_mlp_plain_bf16`` is the plain
version of both.  Both forward instances and the backward's four products
with a weight as B run on bf16 tensor cores: each f32 row value split into
three exact bf16 pieces (``split_pieces`` models the split on the CPU),
three products a k16 step against the bf16 weight as it lies
(``csrc/bf16_gemm.cuh``, tiles per ``bf16_tail_plan``; the sub-tiled
kernel's three-piece instance in ``csrc/mlp_block.cu``, tiles per
``fused_x3_plan``, h exchanged between a cluster's blocks as its three
pieces).  The backward's bf16 instance is the JAX backward's arm on
bf16 g, x, W1 and W2 (:409-476, 497-515): the forward recomputed in f32
from bf16 x, d_x rounded to bf16 once, every other gradient f32; the
residual's gradient is g itself (bf16).  The weight gradients come back in
f32, and autograd rounds each once to the bf16 matrix it belongs to, as
JAX's ``.astype(w1.dtype)`` (:476) does, before the casts' backward widens
them to the f32 parameters.  ``_mlp_bwd_plain_bf16`` is its plain version.

``precise=False`` (the JAX op's keyword, tpu_captioner/ops/mlp_block.py:
252-268 and 497-505; no model path passes it): the TPU kernels with
``mxu_dtype=bfloat16``, for f32 or bf16 data.  Each product's two operands
are rounded to bf16 and the exact products summed in f32, the TPU
kernels' rounding points: bf16(LN(x) * ln_w + ln_b) . bf16(W1), then
bf16(gelu(a)) . bf16(W2) in the forward; in the backward the two
recomputed products, bf16(d_u) . bf16(W2), bf16(d_a) . bf16(W1), and the
weight gradients bf16(xn)^T bf16(d_a) and bf16(h)^T bf16(d_u); every other
step (LayerNorm and its backward, GELU and GELU', the bias, row and column
sums) in f32 on unrounded values.  CUDA tensors launch the arm's
instances in the same two libraries (the whole tile, the sub-tiled kernel
where ``_pipeline_sub`` selects it, the backward), on bf16 wgmma
(``csrc/bf16_gemm.cuh``); CPU tensors run ``_mlp_plain_bf16_products``
and ``_mlp_bwd_plain_bf16_products``.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch
import torch.nn.functional as F

from tpu_captioner_torch.ops import _build

LN_EPS = 1e-6
SUPPORTED_C = (128, 256, 512, 1024)  # the widths the kernels are instantiated for
# The sub-tiled path's tiles (csrc/mlp_block.cu: Fused<C, NC>, which
# tc_mlp_block_fused_plan reports), by width and output columns a block: a
# cluster of S = C / NC blocks owns a row tile of two SUB_ROWS-row
# sub-tiles, and each block computes JCB hidden units of every chunk of S *
# JCB and NC columns of the output.  The launch takes NC = 256 where that
# needs fewer rounds of the clusters the card runs at once
# (tc_mlp_block_fused_columns: the bs-32 stage shapes at C >= 256).
SUB_ROWS = 64  # the sub-tile rows: the wgmma's M
FUSED_TILES = {  # (c, nc): (S, JCB)
    (128, 128): (1, 64), (256, 128): (2, 64), (256, 256): (1, 64), (512, 128): (4, 32),
    (512, 256): (2, 64), (1024, 128): (8, 16), (1024, 256): (4, 32),
}
# The bf16 instances' three-piece GEMM (csrc/bf16_gemm.cuh: x3::gemm), which
# tc_mlp_block_bf16_plan reports: 128 x 128 output tiles, stages of 64
# K-columns, a ring of 4, one persistent block an SM.
X3_TILE = (128, 128, 64, 4)  # rows, columns, K-columns a stage, stages
X3_SMEM = 4 * (128 * 64 * 4 + 128 * 64 * 2) + 2 * 1024 * 4 + 2 * 4 * 8 + 1024
SMEM_LIMIT = 232_448  # dynamic shared memory a Hopper block may have
X3_SLOT_BYTES = 16_384  # a ring slot of the sub-tiled three-piece instance: W2's 128 x 64 bf16 box
_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _mlp_plain(x, residual, sd, ln_w, ln_b, w1, b1, w2, b2, gamma):
    """Plain PyTorch version of the fused tail; the kernel's definition."""
    xn = F.layer_norm(x, (x.shape[-1],), ln_w, ln_b, LN_EPS)
    h = F.gelu(F.linear(xn, w1, b1))  # exact erf GELU
    y = F.linear(h, w2, b2) * gamma
    return residual + sd[:, None] * y


def _mlp_plain_bf16(x, residual, sd, ln_w, ln_b, w1, b1, w2, b2, gamma):
    """Plain version of the bf16-I/O kernel: ``_mlp_plain`` on the operands
    upcast to f32 (exactly), the result rounded to bf16."""
    return _mlp_plain(x.float(), residual.float(), sd, ln_w, ln_b, w1.float(), b1, w2.float(), b2,
                      gamma).to(torch.bfloat16)


def _bf16_operand(t):
    """``t`` rounded to bf16 (nearest, ties to even) and widened back to
    f32 (f64 for an f64 ``t``) exactly: a product operand of the
    ``precise=False`` arm."""
    return t.to(torch.bfloat16).to(torch.float64 if t.dtype == torch.float64 else torch.float32)


def _widen(t):
    """bf16 widened to f32 (exactly); f32 or f64 as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _mlp_plain_bf16_products(x, residual, sd, ln_w, ln_b, w1, b1, w2, b2, gamma):
    """Plain version of the ``precise=False`` arm's forward
    (tpu_captioner/ops/mlp_block.py:126-142 with mxu_dtype=bfloat16), for
    f32 or bf16 x, residual, w1 and w2: LayerNorm in f32 with the TPU
    kernel's formula, each product's operands rounded to bf16 and the exact
    products summed in f32, the exact erf GELU, the output rounded to x's
    dtype once (f64 inputs: the same roundings, the sums in f64)."""
    x = _widen(x)
    mu = x.mean(-1, keepdim=True)
    xn = (x - mu) * torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + LN_EPS) * ln_w + ln_b
    h = F.gelu(F.linear(_bf16_operand(xn), _bf16_operand(w1), b1))
    u = F.linear(_bf16_operand(h), _bf16_operand(w2), b2)
    return (_widen(residual) + sd[:, None] * (u * gamma)).to(residual.dtype)


def _mlp_bwd_plain(g, x, sd, ln_w, ln_b, w1, b1, w2, b2, gamma, operand=None):
    """Plain PyTorch version of the backward kernel, written with the TPU
    kernel's formulas (tpu_captioner/ops/mlp_block.py:301-339).  ``g`` is the
    cotangent of the tail's output.  Returns (d_x, d_sd, d_ln_w, d_ln_b,
    d_w1 (4C, C), d_b1, d_w2 (C, 4C), d_b2, d_gamma): the weight gradients
    in the port's ``nn.Linear`` layouts.  ``operand``, where given, rounds
    each operand of the six products (the TPU kernel's ``mm``, :291-296)."""
    op = operand or (lambda t: t)
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    r = torch.rsqrt(var + LN_EPS)
    xhat = (x - mu) * r
    xn = xhat * ln_w + ln_b
    w1, w2, xn_op = op(w1), op(w2), op(xn)
    a = F.linear(xn_op, w1, b1)
    h = F.gelu(a)
    h_op = op(h)
    u = F.linear(h_op, w2, b2)
    d_y = g * sd[:, None]  # cotangent of u * gamma, rows scaled by stochastic depth
    d_sd = (g * (u * gamma)).sum(-1)
    d_u = d_y * gamma
    d_u_op = op(d_u)
    d_h = d_u_op @ w2  # (N, C) x (C, 4C)
    # gelu'(a) = Phi(a) + a * phi(a)
    d_a = d_h * (0.5 * (1.0 + torch.erf(a * _INV_SQRT2)) + a * torch.exp(-0.5 * a * a) * _INV_SQRT_2PI)
    d_a_op = op(d_a)
    d_xn = d_a_op @ w1  # (N, 4C) x (4C, C)
    d_xhat = d_xn * ln_w
    m1 = d_xhat.mean(-1, keepdim=True)
    m2 = (d_xhat * xhat).mean(-1, keepdim=True)
    d_x = r * (d_xhat - m1 - xhat * m2)
    return (
        d_x, d_sd, (d_xn * xhat).sum(0), d_xn.sum(0),
        d_a_op.T @ xn_op, d_a.sum(0), d_u_op.T @ h_op, d_u.sum(0), (d_y * u).sum(0),
    )


def _mlp_bwd_plain_bf16_products(g, x, sd, ln_w, ln_b, w1, b1, w2, b2, gamma):
    """Plain version of the ``precise=False`` arm's backward
    (tpu_captioner/ops/mlp_block.py:275-349 with mxu_dtype=bfloat16), for
    f32 or bf16 g, x, w1 and w2: ``_mlp_bwd_plain`` on them widened to f32
    with each product operand rounded to bf16, d_x rounded to x's dtype
    once; the other eight outputs f32."""
    d_x, *rest = _mlp_bwd_plain(_widen(g), _widen(x), sd, ln_w, ln_b, _widen(w1), b1, _widen(w2), b2, gamma,
                                operand=_bf16_operand)
    return (d_x.to(x.dtype), *rest)


def _mlp_bwd_plain_bf16(g, x, sd, ln_w, ln_b, w1, b1, w2, b2, gamma):
    """Plain version of the bf16 backward instance: ``_mlp_bwd_plain`` on
    g, x, w1 and w2 widened to f32 (exactly), d_x rounded to bf16; the other
    eight outputs f32."""
    d_x, *rest = _mlp_bwd_plain(g.float(), x.float(), sd, ln_w, ln_b, w1.float(), b1, w2.float(), b2, gamma)
    return (d_x.to(torch.bfloat16), *rest)


def split_pieces(v):
    """The bf16 instances' split of f32 values (csrc/bf16_gemm.cuh:
    x3::split3), for the tests: hi is v's sign, exponent and top 8
    significant bits (v with its low 16 bits cleared), mid the next 8 of
    v - hi, lo the rest, each returned as a bf16 tensor.  hi + mid + lo == v
    exactly wherever lo is a normal bf16 (|v| >= about 2^-103): the two
    subtractions are exact in f32."""
    def cut(t):  # the high 16 bits of each f32: a bf16 value, exactly
        return (t.view(torch.int32) & -65536).view(torch.float32)

    v = v.float().contiguous()
    hi = cut(v)
    r = v - hi
    mid = cut(r)
    return hi.to(torch.bfloat16), mid.to(torch.bfloat16), (r - mid).to(torch.bfloat16)


def _round32(v):
    return (v + 31) // 32 * 32


def bf16_tail_plan(n: int, c: int, sms: int = 132) -> dict:
    """The bf16 instances' tile plan at ``n`` rows of width ``c`` on a card
    of ``sms`` SMs, as ``tc_mlp_block_bf16_plan`` (csrc/bf16_gemm.cuh:
    x3::tail_plan) and ``tc_mlp_block_backward_bf16_workspace``
    (csrc/mlp_block_bwd.cu: make_plan) compute it.  ``tiles`` and ``grid``
    of the four products with a weight as B, in the order a = LN(x) W1^T,
    u = h W2^T, d_h = d_u W2, d_xn = d_a W1 (each a grid of min(tiles, sms)
    persistent blocks); the forward's and the backward's workspace floats."""
    bm, bn = X3_TILE[:2]
    rows = -(-n // bm)
    tiles = [rows * 4 * c // bn, rows * c // bn, rows * 4 * c // bn, rows * c // bn]
    fwd = _round32(2 * n) + _round32(4 * n * c)
    # The backward: the weight-gradient products' splits of the rows and the
    # column sums' chunks (make_plan), then its arrays in order.
    wtiles = (4 * c // 128) * (c // 128)
    best, best_cost = 1, None
    for s in range(1, max(1, n // 256) + 1):
        cost = -(-(wtiles * s) // sms) * -(-n // s)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    k_split = _round32(-(-n // best))
    splits = max(1, -(-n // k_split))
    chunk_rows = max(16, -(-n // (2 * sms)))
    chunks = max(1, -(-n // chunk_rows))
    ldn = (n + 3) // 4 * 4
    nc, tc = n * c, c * ldn
    arrays = [nc] * 5 + [2 * tc, 2 * tc, 4 * nc, 8 * tc, 4 * nc, 4 * nc, 8 * tc, n, chunks * 8 * c,
                         splits * 4 * c * c if splits > 1 else 0]
    return {
        "tile": X3_TILE, "smem": X3_SMEM, "tiles": tiles, "grid": [min(t, sms) for t in tiles],
        "forward_workspace": fwd, "backward_workspace": sum(_round32(a) for a in arrays),
    }


def fused_x3_plan(c: int, nc: int) -> dict:
    """The sub-tiled kernel's three-piece instance (bf16 operands,
    ``precise=True``) at width ``c`` with ``nc`` output columns a block, as
    ``tc_mlp_block_fused_x3_plan`` (csrc/mlp_block.cu: ``Fused<C, NC,
    true>``) computes it.  The cluster and the hidden chunks are the other
    instances' (``FUSED_TILES``: ``cluster`` blocks, ``jcb`` hidden units a
    block of each chunk of ``jc``).  A ring slot holds a stage of either
    product: W1's jcb x 32 bf16 box beside the two sub-tiles' 64 x 32 bf16
    x slabs, or W2's 128 x 64 bf16 box (``X3_SLOT_BYTES``).  h is exchanged
    as three bf16 piece planes (hi, mid, lo) of 64 x jc a sub-tile; the
    ring takes as many slots as fit in ``SMEM_LIMIT`` beside them, the rows'
    statistics (2 x 64 float pairs), two mbarriers a slot and four for h,
    and 1024 bytes of alignment slack.  Raises ValueError for a tile the
    library does not hold."""
    if (c, nc) not in FUSED_TILES:
        raise ValueError(f"fused_x3_plan: no sub-tiled instance at C={c} with {nc} columns a block")
    cluster, jcb = FUSED_TILES[c, nc]
    jc = cluster * jcb
    h_bytes = 2 * 3 * SUB_ROWS * jc * 2
    stats = 2 * SUB_ROWS * 8
    slots = (SMEM_LIMIT - 1024 - h_bytes - stats - 4 * 8) // (X3_SLOT_BYTES + 2 * 8)
    smem = 1024 + slots * X3_SLOT_BYTES + h_bytes + stats + 8 * (2 * slots + 4)
    return {"cluster": cluster, "jcb": jcb, "jc": jc, "slots": slots, "smem": smem, "sub_rows": SUB_ROWS,
            "slot_bytes": X3_SLOT_BYTES, "h_bytes": h_bytes}


def _pipeline_sub(n: int, c: int) -> int:
    """Sub-tile rows of the forward kernel at width ``c`` (the JAX package's
    ``_pipeline_sub``, tpu_captioner/ops/mlp_block.py:191); 0 selects the
    whole-tile path.  Reads ``TPU_CAPTIONER_MLP_SUB`` at each call (JAX
    reads it when it traces).  Returns 0 when the variable is unset, or set
    to a value the sub-tiled kernel does not take, as JAX falls back to its
    whole tile.  The sub-tiled kernel's sub-tiles are the wgmma's 64 rows,
    so the valid values are:

    - C = 128, 256, 512 and 1024: 64.

    ``n`` is unused: a partial last tile runs the same kernel (JAX needs n
    for its tile size)."""
    del n
    sub = int(os.environ.get("TPU_CAPTIONER_MLP_SUB", "0"))
    return sub if sub == SUB_ROWS and c in SUPPORTED_C else 0


def _check(what, c, tensors, bf16=()):
    """Raise unless every ``name: (tensor, shape)`` entry is a contiguous,
    16-byte-aligned tensor of that shape on the first one's device, bfloat16
    where its name is in ``bf16`` and float32 elsewhere, and ``c`` is a
    width the kernel is built for."""
    device = next(iter(tensors.values()))[0].device
    for name, (t, shape) in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {device}")
        want = torch.bfloat16 if name in bf16 else torch.float32
        if t.dtype != want:
            raise ValueError(f"{what}: {name} must be {str(want)[6:]}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")
    if c not in SUPPORTED_C:
        raise ValueError(f"{what} kernel supports C in {SUPPORTED_C}, got {c}")


def _param_shapes(c, ln_w, ln_b, w1, b1, w2, b2, gamma):
    return {
        "ln_w": (ln_w, (c,)), "ln_b": (ln_b, (c,)), "w1": (w1, (4 * c, c)), "b1": (b1, (4 * c,)),
        "w2": (w2, (c, 4 * c)), "b2": (b2, (c,)), "gamma": (gamma, (c,)),
    }


def _lib():
    lib = _build.load("mlp_block")
    for fn in (lib.tc_mlp_block_forward, lib.tc_mlp_block_forward_bf16):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.tc_mlp_block_forward_bf16_products.restype = ctypes.c_int
    lib.tc_mlp_block_forward_bf16_products.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    for fn in (lib.tc_mlp_block_forward_workspace, lib.tc_mlp_block_forward_bf16_workspace,
               lib.tc_mlp_block_forward_bf16_products_workspace):
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.tc_mlp_block_bf16_plan.restype = ctypes.c_int
    lib.tc_mlp_block_bf16_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
    for fn in (lib.tc_mlp_block_fused_plan, lib.tc_mlp_block_fused_x3_plan):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.tc_mlp_block_fused_columns.restype = ctypes.c_int
    lib.tc_mlp_block_fused_columns.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def _bwd_lib():
    lib = _build.load("mlp_block_bwd")
    for fn in (lib.tc_mlp_block_backward, lib.tc_mlp_block_backward_bf16):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.tc_mlp_block_backward_bf16_products.restype = ctypes.c_int
    lib.tc_mlp_block_backward_bf16_products.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    for fn in (lib.tc_mlp_block_backward_workspace, lib.tc_mlp_block_backward_bf16_workspace,
               lib.tc_mlp_block_backward_bf16_products_workspace):
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


_BF16_IO = ("x", "residual", "w1", "w2")  # the bf16 instance's bf16 operands; the output too
_BF16_BWD = ("g", "x", "w1", "w2")  # the bf16 backward's bf16 operands; d_x too


def _check_precise(what, precise):
    if not isinstance(precise, bool):
        raise TypeError(f"{what}: precise must be a bool, got {precise!r}")


def _mlp_forward(x, residual, sd, ln_w, ln_b, w1, b1, w2, b2, gamma, precise=True):
    """The forward: the CUDA kernel for CUDA tensors (the sub-tiled one when
    ``_pipeline_sub`` selects it; the bf16 instance when x is bf16; the
    bf16-product arm when ``precise`` is False), the plain version for CPU
    tensors; any other device raises."""
    args = (x, residual, sd, ln_w, ln_b, w1, b1, w2, b2, gamma)
    bf16 = x.dtype == torch.bfloat16
    if x.device.type == "cpu":
        if not precise:
            return _mlp_plain_bf16_products(*args)
        return _mlp_plain_bf16(*args) if bf16 else _mlp_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"fused_convnext_mlp runs on cpu or cuda tensors, got {x.device}")
    n, c = x.shape
    _check("fused_convnext_mlp", c, {
        "x": (x, (n, c)), "residual": (residual, (n, c)), "sd": (sd, (n,)),
        **_param_shapes(c, ln_w, ln_b, w1, b1, w2, b2, gamma),
    }, _BF16_IO if bf16 else ())
    _build.require_current_device("fused_convnext_mlp", args)
    lib = _lib()
    sub = _pipeline_sub(n, c)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if precise:
            launch, workspace = ((lib.tc_mlp_block_forward_bf16, lib.tc_mlp_block_forward_bf16_workspace) if bf16
                                 else (lib.tc_mlp_block_forward, lib.tc_mlp_block_forward_workspace))
            work = sd.new_empty(workspace(n, c, sub))
            err = launch(*(t.data_ptr() for t in (*args, out, work)), n, c, sub, stream)
        else:
            work = sd.new_empty(lib.tc_mlp_block_forward_bf16_products_workspace(n, c, sub))
            err = lib.tc_mlp_block_forward_bf16_products(
                *(t.data_ptr() for t in (*args, out, work)), n, c, sub, int(bf16), stream)
    _build.check(lib, err, "mlp_block")
    fused_convnext_mlp.launches += 1
    if not precise:
        fused_convnext_mlp.bf16_product_launches += 1
        fused_convnext_mlp.pipelined_bf16_product_launches += bool(sub)
        fused_convnext_mlp.bf16_product_bf16_launches += bf16
        fused_convnext_mlp.pipelined_bf16_product_bf16_launches += bool(sub) and bf16
        return out
    if sub:
        fused_convnext_mlp.pipelined_launches += 1
    if bf16:
        fused_convnext_mlp.bf16_launches += 1
        if sub:
            fused_convnext_mlp.pipelined_bf16_launches += 1
    return out


def fused_convnext_mlp_bwd(g, x, sd, ln_w, ln_b, w1, b1, w2, b2, gamma, precise=True):
    """Gradients of the tail without its residual, for the cotangent ``g``
    (N, C): the nine outputs of ``_mlp_bwd_plain``.  bf16 g, x, w1 and w2
    (the rest f32) take the bf16 instance: d_x bf16, the other eight f32
    (``_mlp_bwd_plain_bf16``).  ``precise`` False takes the bf16-product
    arm (``_mlp_bwd_plain_bf16_products``), for either dtype.  CUDA tensors
    launch ``csrc/mlp_block_bwd.cu`` on the current stream; CPU tensors take
    the plain version; any other device raises."""
    _check_precise("fused_convnext_mlp_bwd", precise)
    args = (g, x, sd, ln_w, ln_b, w1, b1, w2, b2, gamma)
    bf16 = x.dtype == torch.bfloat16
    if x.device.type == "cpu":
        if not precise:
            return _mlp_bwd_plain_bf16_products(*args)
        return _mlp_bwd_plain_bf16(*args) if bf16 else _mlp_bwd_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"fused_convnext_mlp_bwd runs on cpu or cuda tensors, got {x.device}")
    n, c = x.shape
    _check("fused_convnext_mlp_bwd", c, {
        "g": (g, (n, c)), "x": (x, (n, c)), "sd": (sd, (n,)),
        **_param_shapes(c, ln_w, ln_b, w1, b1, w2, b2, gamma),
    }, _BF16_BWD if bf16 else ())
    _build.require_current_device("fused_convnext_mlp_bwd", args)
    lib = _bwd_lib()
    f32 = sd.new_empty
    outs = (
        torch.empty_like(x), f32(n), f32(c), f32(c), f32(4 * c, c), f32(4 * c), f32(c, 4 * c), f32(c), f32(c),
    )
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if precise:
            launch, workspace = ((lib.tc_mlp_block_backward_bf16, lib.tc_mlp_block_backward_bf16_workspace) if bf16
                                 else (lib.tc_mlp_block_backward, lib.tc_mlp_block_backward_workspace))
            work = f32(workspace(n, c))
            err = launch(*(t.data_ptr() for t in (*args, *outs, work)), n, c, stream)
        else:
            work = f32(lib.tc_mlp_block_backward_bf16_products_workspace(n, c))
            err = lib.tc_mlp_block_backward_bf16_products(
                *(t.data_ptr() for t in (*args, *outs, work)), n, c, int(bf16), stream)
    _build.check(lib, err, "mlp_block_bwd")
    fused_convnext_mlp_bwd.launches += 1
    if not precise:
        fused_convnext_mlp_bwd.bf16_product_launches += 1
        fused_convnext_mlp_bwd.bf16_product_bf16_launches += bf16
    elif bf16:
        fused_convnext_mlp_bwd.bf16_launches += 1
    return outs


fused_convnext_mlp_bwd.launches = 0
fused_convnext_mlp_bwd.bf16_launches = 0  # of those, the bf16 instance's
fused_convnext_mlp_bwd.bf16_product_launches = 0  # of those, the precise=False arm's
fused_convnext_mlp_bwd.bf16_product_bf16_launches = 0  # of the arm's, on bf16 data


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, sd, ln_w, ln_b, w1, b1, w2, b2, gamma, precise):
        ctx.save_for_backward(x, sd, ln_w, ln_b, w1, b1, w2, b2, gamma)
        ctx.precise = precise
        return _mlp_forward(x, residual, sd, ln_w, ln_b, w1, b1, w2, b2, gamma, precise=precise)

    @staticmethod
    def backward(ctx, g):
        # bf16: d_x and the residual's g are bf16; d_w1 and d_w2 come back in
        # f32, and autograd rounds each once to its bf16 input's dtype.
        d_x, d_sd, *d_params = fused_convnext_mlp_bwd(g.contiguous(), *ctx.saved_tensors, precise=ctx.precise)
        grads = (d_x, g, d_sd, *d_params)
        return (*(d if need else None for d, need in zip(grads, ctx.needs_input_grad)), None)


def fused_convnext_mlp(
    x: torch.Tensor,  # (N, C) depthwise-conv output rows
    residual: torch.Tensor,  # (N, C) block input rows
    sd: torch.Tensor,  # (N,) per-row stochastic-depth scale (ones in eval)
    ln_w: torch.Tensor, ln_b: torch.Tensor,  # (C,)
    w1: torch.Tensor, b1: torch.Tensor,  # (4C, C), (4C,)
    w2: torch.Tensor, b2: torch.Tensor,  # (C, 4C), (C,)
    gamma: torch.Tensor,  # (C,) layer scale
    precise: bool = True,  # False: the bf16-product arm (module note)
) -> torch.Tensor:
    """The fused tail, differentiable: the CUDA kernels for CUDA tensors,
    the plain versions for CPU tensors; any other device raises.  bf16 x,
    residual, w1 and w2 (the rest f32) give a bf16 output, and a backward
    through the bf16 instances (the module note says where they round).
    ``fused_convnext_mlp.launches`` counts forward kernel launches, of which
    ``fused_convnext_mlp.pipelined_launches`` ran the sub-tiled kernel,
    ``.bf16_launches`` a bf16 instance and ``.pipelined_bf16_launches`` the
    sub-tiled kernel's bf16 instance;
    ``fused_convnext_mlp_bwd.launches`` counts backward ones, of which
    ``.bf16_launches`` ran the bf16 instance.  ``precise`` False (a bool,
    else TypeError) runs the bf16-product arm: its launches count in
    ``.launches`` and in ``.bf16_product_launches`` alone (not in the
    counters above), of which ``.pipelined_bf16_product_launches`` ran the
    sub-tiled kernel and ``.bf16_product_bf16_launches`` (and
    ``.pipelined_bf16_product_bf16_launches``) took bf16 data; the
    backward's in ``fused_convnext_mlp_bwd.launches``,
    ``.bf16_product_launches`` and ``.bf16_product_bf16_launches``."""
    _check_precise("fused_convnext_mlp", precise)
    return _FusedMLP.apply(x, residual, sd, ln_w, ln_b, w1, b1, w2, b2, gamma, precise)


fused_convnext_mlp.launches = 0
fused_convnext_mlp.pipelined_launches = 0
fused_convnext_mlp.bf16_launches = 0
fused_convnext_mlp.pipelined_bf16_launches = 0
fused_convnext_mlp.bf16_product_launches = 0
fused_convnext_mlp.pipelined_bf16_product_launches = 0
fused_convnext_mlp.bf16_product_bf16_launches = 0
fused_convnext_mlp.pipelined_bf16_product_bf16_launches = 0
