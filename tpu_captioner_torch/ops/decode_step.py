"""Fused KV-cached Transformer decode (counterpart of
``tpu_captioner/ops/decode_step.py``).

``fused_decode_step`` runs the whole L-layer decode body for one generated
token over R rows (R = batch, or batch x beams): per layer the packed QKV
projection, causal self-attention against the cache with the new k/v merged
in, cross-attention against precomputed memory K/V, the ReLU FFN, and three
post-norm LayerNorms (eps 1e-5).  ``fused_full_rollout`` runs a whole greedy
rollout: per token the embedding lookup plus PE, that body, the vocab head,
the argmax and the token feedback.

Layouts (merged heads):
- x:               (R, E)
- cache k/v:       (L, R, T, E)   read-only here; ``apply_cache_update`` writes
- memory k/v:      (L, R, P, E)   from ``prepare_cross_memory``, once per image
- weights:         ``DecodeWeights`` — matrices (L, out, in) as nn.Linear
                   keeps them, vectors (L, D)

Both launch ``csrc/decode_step.cu`` for CUDA tensors, cooperative launches
of one block per SM on the current stream: ``fused_decode_step`` one per
layer, or one per token with ``one_cell=True`` (the TPU's ``_kernel_onecell``);
``fused_full_rollout`` one per rollout (the TPU's ``_mega_kernel``).
``decode_plan`` divides a launch's work (the output columns each block owns,
the rows it stages at once, the ring of weight slices in its shared memory)
and sizes its shared memory.  For CPU tensors they run their plain versions,
``_decode_step_plain`` and ``_full_rollout_plain``.  Eval only: no dropout.

The weight matrices' dtype picks ``fused_decode_step``'s instance, each
an arm of the JAX package's ``precise`` keyword
(tpu_captioner/ops/decode_step.py:370-371): f32 weights, JAX's
``precise=True``, multiply f32 operands in f32; bf16 weights
(``cast_weight_matrices(w, bfloat16)``) with bf16 x, caches and memory K/V,
JAX's ``precise=False``, round both operands of every product to bf16 and
sum in f32 (JAX's ``mxu_dtype=bfloat16``, :233-237), the head-selector sums
included (:150, 155, 165, 169): each q.k product and each softmax
probability is rounded to bf16 before it is summed per head; its k_new and
v_new are bf16 and x_out and alpha f32, as the JAX kernel's.  Its plain
version is ``_decode_step_plain_bf16``; its kernels, the bf16 instances of
``decode_layer_kernel`` and (``one_cell``) ``decode_onecell_kernel``, whose
outputs are the same bits.  Their products run on the bf16 tensor cores
(``mma.sync`` m16n8k16 on a bf16 copy of the staged rows, rounded once a
product phase; ``decode_layout`` places it), with the same JAX arithmetic:
exact products of bf16 values summed in f32.  The wrapper accepts JAX's
``precise`` only as a check of the weights' dtype (a mismatch raises
``ValueError``).
``fused_full_rollout`` takes the same two arms by the weights' dtype: the
bf16 one on the operands JAX's ``storage_dtype=bfloat16`` casts (the six
matrices, memory K/V, embedding table and ``fc_w``; ``fc_b`` and the PE
table f32), with bf16 caches, the vocab head's products rounded like the
layers', f32 logits; its plain version is ``_full_rollout_plain_bf16``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from tpu_captioner_torch.models.layers import attention_one_query, layer_norm, split_heads
from tpu_captioner_torch.ops import _build

LN_EPS = 1e-5
MAX_E = 1024  # csrc/decode_step.cu: 32 lanes x 4 x kLnVec LayerNorm values
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on sm_90
# csrc/decode_step.cu: warps of a block, rows of a warp tile, ring units a
# product multiplies together, the largest row chunk, the ring's length.
_WARPS, _ROW_TILE, _MAX_GROUP, _MAX_ROWS, _MAX_SLOTS = 8, 16, 16, 64, 32


class DecodePlan(NamedTuple):
    """How a decode launch divides its work (``csrc/decode_step.cu:Plan``,
    in that order), and its dynamic shared memory."""

    grid: int  # blocks, one per SM
    row_groups: int  # 1, or 2: blocks b and b + grid/2 own the same columns, each half the rows
    ce: int  # output columns a block owns of each E-wide product
    cf: int  # ... of the F-wide product (FFN1)
    uc: int  # of those, columns per ring unit
    cv: int  # vocab columns a block owns in the rollout's head (else 0)
    hc: int  # vocab columns per ring unit (else 0)
    rc: int  # rows staged at once, a multiple of 16
    slots: int  # ring units (a block's weight rows of one product) in shared memory
    slot_floats: int  # elements of a ring unit: floats, or bf16 values in the bf16 arm
    group: int  # ring units multiplied together
    smem_bytes: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def decode_plan(kind: str, R: int, T: int, P: int, E: int, H: int, F: int, sms: int, V: int = 0,
                esize: int = 4) -> DecodePlan:
    """The plan of a ``kind`` launch ('layer', 'onecell' or 'rollout') on a
    card with ``sms`` SMs: each block owns ``ce`` (``cf``) columns of every
    product and ``cv`` vocab columns; the per-layer kernel at R >= 32 splits
    the grid into two row groups where that fits.  It takes the largest row
    chunk (up to 64), then the widest ring units, that leave room for a ring
    of 8 units (a layer's, at one unit per product; else 2, else 1), then as
    many units as fit (all of the layer's in the per-layer kernel).
    ``esize`` is the bytes of a weight element, 4, or 2 for the kernels'
    bf16 instances: the ring holds the weights (and the rollout's head) as
    they are stored, so ``slot_floats`` counts elements of that size; the
    per-layer kernel's bf16 instance keeps the rows of a unit of 8 rows or
    more ``ring_row(K)`` apart in its slot,
    the staged rows also have a bf16 copy (``decode_layout``) that the bf16
    tiles of 8 columns read, and ring units are whole tiles of 8 columns or
    the block's whole slice.  Raises ValueError when the shapes do not fit
    a block's shared memory."""
    rollout = kind == "rollout"
    if esize not in (2, 4):
        raise ValueError(f"decode_plan: weights of 4 or 2 bytes, got {esize} for {kind!r}")
    for need in (8, 2, 1):
        for gr in (2, 1) if kind == "layer" and R >= 2 * _ROW_TILE and sms >= 2 else (1,):
            plan = _fit_plan(kind, gr, need, R, T, P, E, H, F, sms, V if rollout else 0, esize)
            if plan is not None:
                return plan
    raise ValueError(f"decode kernel: R={R}, E={E}, F={F}, H={H}, T={T}, P={P} do not fit "
                     f"{SMEM_LIMIT} bytes of shared memory per block")


def bf16_row_len(E: int, F: int) -> int:
    """Values of a staged row's bf16 copy (``csrc/decode_step.cu:
    bf16_row_len``): the longest product input rounded up to the mma's k16
    steps, and 8 more, so that the 16 rows of an ldmatrix fall on
    different banks."""
    return _ceil(max(E, F), 16) * 16 + 8


def ring_row(K: int) -> int:
    """Elements from one weight row of length ``K`` to the next in a padded
    ring slot (``csrc/decode_step.cu:ring_row``: the per-layer kernel's
    bf16 units of whole 8-row tiles): an odd number of 16-byte granules, so
    that the 8 rows of an ldmatrix fall on different banks."""
    return K + (16 if (K // 8) % 2 else 8)


def decode_layout(plan: DecodePlan, R: int, T: int, P: int, E: int, H: int, F: int, V: int = 0,
                  esize: int = 4) -> dict:
    """The shared memory of a plan, region by region, as
    ``csrc/decode_step.cu:blk_init`` lays it out: the mbarriers, the ring,
    the staged f32 rows, a LayerNorm's parameters, the warps' attention
    scratch, the rollout's per-row state (``V`` > 0), then in the bf16 arm
    (``esize`` 2) the staged rows' bf16 copy, 16-byte aligned.  Byte
    offsets and sizes by name, and ``total``; ``xb_offset`` and
    ``xb_row`` are what ``tc_decode_smem_layout`` reports (0 in f32)."""
    sizes = {
        "mbarriers": _ceil(8 * (plan.slots + 1), 128) * 128,
        "ring": esize * plan.slots * plan.slot_floats,
        "rows": 4 * plan.rc * max(E, F),
        "ln": 8 * E,
        "attention": 4 * _ceil(_WARPS * (E // H + max(T, P)), 2) * 2,
        "state": 16 * R if V else 0,
    }
    out, at = {}, 0
    for name, n in sizes.items():
        out[name] = (at, n)
        at += n
    xb_offset, xb_row = 0, 0
    if esize == 2:
        xb_offset, xb_row = _ceil(at, 16) * 16, bf16_row_len(E, F)
        out["bf16_rows"] = (xb_offset, 2 * plan.rc * xb_row)
        at = xb_offset + 2 * plan.rc * xb_row
    out.update(total=at, xb_offset=xb_offset, xb_row=xb_row)
    return out


def _fit_plan(kind, gr, need, R, T, P, E, H, F, sms, V, esize):
    """``decode_plan`` at ``gr`` row groups with at least ``need`` ring
    units; None when nothing fits."""
    gc = sms // gr
    ce, cf = _ceil(E, gc), _ceil(F, gc)
    cv = _ceil(V, gc)
    top = max(ce, cf)  # then whole warp tiles of 4 columns (bf16: 8), then (f32) 3, 2, 1
    tiles = (lambda u: u % 8 == 0) if esize == 2 else (lambda u: u % 4 == 0 or u < 4)
    padded = kind == "layer" and esize == 2  # the per-layer bf16 kernel pads units of 8 rows
    row = lambda u, K: ring_row(K) if padded and u >= 8 else K  # noqa: E731 (a weight row in a slot)
    for rc in range(min(_ceil(_ceil(R, gr), _ROW_TILE) * _ROW_TILE, _MAX_ROWS), 0, -_ROW_TILE):
        for uc in (u for u in range(top, 0, -1) if u == top or tiles(u)):
            slot = _ceil(uc * row(uc, max(E, F)), 32) * 32
            upl = 7 * _ceil(ce, uc) + _ceil(cf, uc)
            want = upl if kind == "layer" else _MAX_SLOTS
            for slots in range(want, need - 1, -1):
                plan = DecodePlan(gc * gr, gr, ce, cf, uc, cv, 0, rc, slots, slot, 1, 0)
                smem = decode_layout(plan, R, T, P, E, H, F, V, esize)["total"]
                if smem <= SMEM_LIMIT:
                    hc = min(cv, slot // E) if V else 0
                    group = max(1, min(slots // 2, _MAX_GROUP))
                    return DecodePlan(gc * gr, gr, ce, cf, uc, cv, hc, rc, slots, slot, group, smem)
    return None


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class DecodeWeights(NamedTuple):
    """Stacked decoder-layer weights in the kernel layout."""

    w_qkv: torch.Tensor  # (L, 3E, E)
    b_qkv: torch.Tensor  # (L, 3E)
    w_so: torch.Tensor  # (L, E, E) self-attn out
    b_so: torch.Tensor  # (L, E)
    w_cq: torch.Tensor  # (L, E, E) cross-attn query
    b_cq: torch.Tensor  # (L, E)
    w_co: torch.Tensor  # (L, E, E) cross-attn out
    b_co: torch.Tensor  # (L, E)
    w_f1: torch.Tensor  # (L, F, E)
    b_f1: torch.Tensor  # (L, F)
    w_f2: torch.Tensor  # (L, E, F)
    b_f2: torch.Tensor  # (L, E)
    ln1_s: torch.Tensor  # (L, E)
    ln1_b: torch.Tensor
    ln2_s: torch.Tensor
    ln2_b: torch.Tensor
    ln3_s: torch.Tensor
    ln3_b: torch.Tensor


@torch.no_grad()
def prepare_decode_weights(layers: Sequence[torch.nn.Module], embed_dim: int) -> DecodeWeights:
    """Stack the decoder layers' weights (``models.transformer.DecoderLayer``,
    reference parameter names) into the kernel layout.  Run once per decode
    call, outside the token loop."""
    e = embed_dim

    def st(fn):
        return torch.stack([fn(lyr) for lyr in layers]).contiguous()

    return DecodeWeights(
        w_qkv=st(lambda l: l.self_attn.in_proj_weight),
        b_qkv=st(lambda l: l.self_attn.in_proj_bias),
        w_so=st(lambda l: l.self_attn.out_proj.weight),
        b_so=st(lambda l: l.self_attn.out_proj.bias),
        w_cq=st(lambda l: l.multihead_attn.in_proj_weight[:e]),
        b_cq=st(lambda l: l.multihead_attn.in_proj_bias[:e]),
        w_co=st(lambda l: l.multihead_attn.out_proj.weight),
        b_co=st(lambda l: l.multihead_attn.out_proj.bias),
        w_f1=st(lambda l: l.linear1.weight),
        b_f1=st(lambda l: l.linear1.bias),
        w_f2=st(lambda l: l.linear2.weight),
        b_f2=st(lambda l: l.linear2.bias),
        ln1_s=st(lambda l: l.norm1.weight),
        ln1_b=st(lambda l: l.norm1.bias),
        ln2_s=st(lambda l: l.norm2.weight),
        ln2_b=st(lambda l: l.norm2.bias),
        ln3_s=st(lambda l: l.norm3.weight),
        ln3_b=st(lambda l: l.norm3.bias),
    )


@torch.no_grad()
def prepare_cross_memory(
    layers: Sequence[torch.nn.Module], mem: torch.Tensor, embed_dim: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Projected memory (R, P, E) -> merged-head cross K/V, each (L, R, P, E)."""
    e = embed_dim
    ks, vs = [], []
    for lyr in layers:
        w, b = lyr.multihead_attn.in_proj_weight, lyr.multihead_attn.in_proj_bias
        ks.append(F.linear(mem, w[e : 2 * e], b[e : 2 * e]))
        vs.append(F.linear(mem, w[2 * e :], b[2 * e :]))
    return torch.stack(ks).contiguous(), torch.stack(vs).contiguous()


def _decode_step_plain(
    w: DecodeWeights, x, pos: int, cache_k, cache_v, mem_k, mem_v, num_heads: int
):
    """Plain PyTorch version of the fused step; the kernel's definition.
    Reads cache positions < ``pos`` only and attends to the new k/v at
    ``pos`` without writing the cache."""
    L = cache_k.shape[0]
    alpha = x.new_zeros(x.shape[0], mem_k.shape[2])
    k_news, v_news = [], []
    for l in range(L):
        qkv = F.linear(x, w.w_qkv[l], w.b_qkv[l])
        q, k_new, v_new = qkv.chunk(3, dim=-1)
        keys = torch.cat([cache_k[l, :, :pos], k_new[:, None]], dim=1)  # (R, pos+1, E)
        vals = torch.cat([cache_v[l, :, :pos], v_new[:, None]], dim=1)
        ctx, _ = attention_one_query(
            split_heads(q[:, None], num_heads)[:, :, 0],
            split_heads(keys, num_heads), split_heads(vals, num_heads),
        )
        x = layer_norm(x + F.linear(ctx.flatten(1), w.w_so[l], w.b_so[l]), w.ln1_s[l], w.ln1_b[l], LN_EPS)
        q2 = F.linear(x, w.w_cq[l], w.b_cq[l])
        ctx2, probs2 = attention_one_query(
            split_heads(q2[:, None], num_heads)[:, :, 0],
            split_heads(mem_k[l], num_heads), split_heads(mem_v[l], num_heads),
        )
        alpha = alpha + probs2.mean(dim=1) / L
        x = layer_norm(x + F.linear(ctx2.flatten(1), w.w_co[l], w.b_co[l]), w.ln2_s[l], w.ln2_b[l], LN_EPS)
        h = torch.relu(F.linear(x, w.w_f1[l], w.b_f1[l]))
        x = layer_norm(x + F.linear(h, w.w_f2[l], w.b_f2[l]), w.ln3_s[l], w.ln3_b[l], LN_EPS)
        k_news.append(k_new)
        v_news.append(v_new)
    return x, alpha, torch.stack(k_news), torch.stack(v_news)


_MATRICES = ("w_qkv", "w_so", "w_cq", "w_co", "w_f1", "w_f2")


def cast_weight_matrices(w: DecodeWeights, dtype: torch.dtype) -> DecodeWeights:
    """The six weight matrices in ``dtype``, the biases and LayerNorm
    parameters as they are (tpu_captioner/ops/decode_step.py:552)."""
    return w._replace(**{f: getattr(w, f).to(dtype).contiguous() for f in _MATRICES})


def _decode_step_plain_bf16(
    w: DecodeWeights, x, pos: int, cache_k, cache_v, mem_k, mem_v, num_heads: int, sums=torch.float32
):
    """Plain PyTorch version of the bf16 arm: the JAX kernel's
    ``_layer_step`` with bf16 multiplicands (tpu_captioner/ops/decode_step.py:
    125-182), on bf16 x, matrices, caches and memory K/V.  The hidden state
    stays f32 between products; every product rounds both operands to bf16;
    the scores sum bf16(k q / sqrt(dh)) over each head's dims (the new k at
    ``pos`` unrounded, in f32), the context sums v times bf16(p); alpha
    averages the unrounded cross probabilities.  Returns x_out and alpha in
    f32, k_new and v_new in the caches' dtype.  ``sums`` is the dtype the
    sums run in: float64 gives the same roundings to bf16 with other f32
    sums, the noise floor another correct implementation lands within
    (``chip_smoke.py`` phase 11)."""
    L, R, _, E = cache_k.shape
    P, H = mem_k.shape[2], num_heads
    dh = E // H
    scale = 1.0 / math.sqrt(dh)
    x = x.to(sums)
    alpha = x.new_zeros(R, P)
    k_news, v_news = [], []

    def bf(t):  # rounded to bf16, then summed in `sums`
        return t.to(torch.bfloat16).to(sums)

    def mm(a, m):  # a (..., K) times the (N, K) matrix m transposed: JAX's ``mm`` with bf16 multiplicands
        return F.linear(bf(a), m.to(sums))

    def vec(v):
        return v.to(sums)

    def ln(v, s, b):
        return F.layer_norm(v, (E,), vec(s), vec(b), LN_EPS)

    def attend(q, keys, vals):  # q (R, E) scaled; keys, vals (R, n, E)
        n = keys.shape[1]
        scores = bf(keys * q[:, None, :]).view(R, n, H, dh).sum(-1)
        probs = torch.softmax(scores, dim=1)  # (R, n, H)
        ctx = (vals.view(R, n, H, dh) * bf(probs)[..., None]).sum(1)
        return ctx.reshape(R, E), probs

    for l in range(L):
        qkv = mm(x, w.w_qkv[l]) + vec(w.b_qkv[l])
        q, k_new, v_new = qkv[:, :E] * scale, qkv[:, E : 2 * E], qkv[:, 2 * E :]
        ctx, _ = attend(q, torch.cat([cache_k[l, :, :pos].to(sums), k_new[:, None]], 1),
                        torch.cat([cache_v[l, :, :pos].to(sums), v_new[:, None]], 1))
        x = ln(x + mm(ctx, w.w_so[l]) + vec(w.b_so[l]), w.ln1_s[l], w.ln1_b[l])
        q2 = (mm(x, w.w_cq[l]) + vec(w.b_cq[l])) * scale
        ctx2, probs2 = attend(q2, mem_k[l].to(sums), mem_v[l].to(sums))
        alpha = alpha + probs2.mean(dim=2) / L
        x = ln(x + (mm(ctx2, w.w_co[l]) + vec(w.b_co[l])), w.ln2_s[l], w.ln2_b[l])
        h = torch.relu(mm(x, w.w_f1[l]) + vec(w.b_f1[l]))
        x = ln(x + (mm(h, w.w_f2[l]) + vec(w.b_f2[l])), w.ln3_s[l], w.ln3_b[l])
        k_news.append(k_new.to(cache_k.dtype))
        v_news.append(v_new.to(cache_v.dtype))
    f32 = torch.float32
    return x.to(f32), alpha.to(f32), torch.stack(k_news), torch.stack(v_news)


def _check_tensors(device, shapes) -> None:
    """Each ``name: (tensor, shape)`` on ``device``, of its dtype and shape,
    contiguous and 16-byte aligned: what the kernels read."""
    for name, (t, shape, dtype) in shapes.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _weight_shapes(w: DecodeWeights, L: int, E: int, num_heads: int, mat=torch.float32):
    """The weights' shapes and dtypes: the matrices of dtype ``mat``, the
    vectors f32."""
    Fd = w.w_f1.shape[1]
    f32 = torch.float32
    shapes = {
        "w_qkv": (w.w_qkv, (L, 3 * E, E), mat), "b_qkv": (w.b_qkv, (L, 3 * E), f32),
        "w_f1": (w.w_f1, (L, Fd, E), mat), "b_f1": (w.b_f1, (L, Fd), f32),
        "w_f2": (w.w_f2, (L, E, Fd), mat),
    }
    for name in ("w_so", "w_cq", "w_co"):
        shapes[name] = (getattr(w, name), (L, E, E), mat)
    for name in ("b_so", "b_cq", "b_co", "b_f2", "ln1_s", "ln1_b", "ln2_s", "ln2_b", "ln3_s", "ln3_b"):
        shapes[name] = (getattr(w, name), (L, E), f32)
    # Any head width: the kernels load keys as float4 when E/H % 4 == 0 and
    # as scalars otherwise.  What stays: whole heads, float4 rows in the
    # products (E and F % 4) and a LayerNorm row in one warp (E <= 1024).
    if num_heads < 1 or E % num_heads:
        raise ValueError(f"kernel needs E divisible by the heads (E={E}, H={num_heads})")
    row = 4 if mat == f32 else 8  # elements of a 16-byte bulk-copy granule
    if E % row or Fd % row:
        raise ValueError(f"kernel needs E and F divisible by {row} for its 16-byte rows (E={E}, F={Fd})")
    if E > MAX_E:
        raise ValueError(f"kernel holds a LayerNorm row in one warp: E <= {MAX_E}, got {E}")
    return shapes


def _check(w: DecodeWeights, x, pos, cache_k, cache_v, mem_k, mem_v, num_heads, dt=torch.float32):
    """The kernel's operands: the matrices, x, caches and memory K/V of
    storage dtype ``dt``, the vectors f32."""
    L, R, T, E = cache_k.shape
    P = mem_k.shape[2]
    shapes = _weight_shapes(w, L, E, num_heads, dt)
    shapes.update({
        "x": (x, (R, E), dt), "cache_k": (cache_k, (L, R, T, E), dt),
        "cache_v": (cache_v, (L, R, T, E), dt),
        "mem_k": (mem_k, (L, R, P, E), dt), "mem_v": (mem_v, (L, R, P, E), dt),
    })
    _check_tensors(x.device, shapes)
    if not 0 <= pos < T:
        raise ValueError(f"pos {pos} outside the cache length {T}")


def _lib():
    lib = _build.load("decode_step")
    plan = [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]  # plan, smem bytes, stream
    for fn in (lib.tc_decode_layer_forward, lib.tc_decode_layer_forward_bf16):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 28 + [ctypes.c_int] * 9 + plan
    for fn in (lib.tc_decode_onecell_forward, lib.tc_decode_onecell_forward_bf16):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 28 + [ctypes.c_int] * 8 + plan
    for fn in (lib.tc_decode_rollout, lib.tc_decode_rollout_bf16):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 33 + [ctypes.c_int] * 9 + plan
    lib.tc_decode_scratch_floats.restype = ctypes.c_longlong
    lib.tc_decode_scratch_floats.argtypes = [ctypes.c_int] * 5
    lib.tc_rollout_scratch_floats.restype = ctypes.c_longlong
    lib.tc_rollout_scratch_floats.argtypes = [ctypes.c_int] * 5
    lib.tc_decode_smem_layout.restype = ctypes.c_int
    lib.tc_decode_smem_layout.argtypes = ([ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 9
                                          + [ctypes.POINTER(ctypes.c_longlong)])
    return lib


def _plan_args(plan: DecodePlan):
    """The plan as the C entry points take it: Plan's ints, the smem bytes."""
    return (ctypes.c_int * 11)(*plan[:11]), plan.smem_bytes


def fused_decode_step(
    w: DecodeWeights,
    x: torch.Tensor,  # (R, E) embedded token (+PE) at `pos`
    pos: int,
    cache_k: torch.Tensor,  # (L, R, T, E)
    cache_v: torch.Tensor,  # (L, R, T, E)
    mem_k: torch.Tensor,  # (L, R, P, E)
    mem_v: torch.Tensor,  # (L, R, P, E)
    num_heads: int,
    *,
    one_cell: bool = False,
    precise: bool = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (x_out (R, E), alpha (R, P) — cross-attention probabilities
    averaged over heads and layers, k_new (L, R, E), v_new (L, R, E)).  The
    caches are read-only here; persist the new rows with
    ``apply_cache_update``.  CUDA tensors launch the kernel once per layer,
    or once for all layers with ``one_cell``; CPU tensors take the plain
    version (the same function either way); any other device raises.
    The weights' dtype picks the instance, f32 or the bf16 arm (the module
    docstring); ``precise``, when given, must be that arm's (True for f32,
    False for bf16) or ValueError is raised, as it is for weights of
    another dtype.  Forward only: raises on every device when autograd
    would need its gradient."""
    _build.refuse_autograd(
        "fused_decode_step", (*w, x, cache_k, cache_v, mem_k, mem_v),
        "not planned (decoding runs under torch.inference_mode)",
    )
    pos = int(pos)
    dt = w.w_qkv.dtype
    if dt not in (torch.float32, torch.bfloat16) or precise not in (None, dt == torch.float32):
        raise ValueError(f"fused_decode_step has no instance for {dt} weights with precise={precise}: "
                         "float32 with precise=True, or bfloat16 with precise=False")
    bf16 = dt == torch.bfloat16
    if x.device.type == "cpu":
        plain = _decode_step_plain_bf16 if bf16 else _decode_step_plain
        return plain(w, x, pos, cache_k, cache_v, mem_k, mem_v, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_decode_step runs on cpu or cuda tensors, got {x.device}")
    _check(w, x, pos, cache_k, cache_v, mem_k, mem_v, num_heads, dt)
    _build.require_current_device("fused_decode_step", (x, cache_k, cache_v, mem_k, mem_v))
    L, R, T, E = cache_k.shape
    P = mem_k.shape[2]
    Fd = w.w_f1.shape[1]
    lib = _lib()
    if bf16:
        x = x.float()  # the kernels carry the hidden state in f32 (x_out) from layer to layer
    x_out = torch.empty_like(x)
    alpha = torch.empty(R, P, device=x.device, dtype=torch.float32)
    k_new = torch.empty(L, R, E, device=x.device, dtype=dt)
    v_new = torch.empty_like(k_new)
    scratch = torch.empty(
        lib.tc_decode_scratch_floats(R, E, num_heads, Fd, P), device=x.device, dtype=torch.float32
    )
    rest = [t.data_ptr() for t in (x_out, alpha, k_new, v_new, *w, cache_k, cache_v, mem_k, mem_v, scratch)]
    plan = _plan_args(decode_plan("onecell" if one_cell else "layer", R, T, P, E, num_heads, Fd, _sms(x.device),
                                  esize=k_new.element_size()))
    layer_forward = lib.tc_decode_layer_forward_bf16 if bf16 else lib.tc_decode_layer_forward
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if one_cell:
            onecell = lib.tc_decode_onecell_forward_bf16 if bf16 else lib.tc_decode_onecell_forward
            err = onecell(x.data_ptr(), *rest, L, R, T, P, E, num_heads, Fd, pos, *plan, stream)
            _build.check(lib, err, "decode_onecell")
            fused_decode_step.onecell_launches += 1
            if bf16:
                fused_decode_step.onecell_bf16_launches += 1
            return x_out, alpha, k_new, v_new
        for layer in range(L):
            layer_in = x if layer == 0 else x_out  # the hidden state carries in x_out
            err = layer_forward(
                layer_in.data_ptr(), *rest, layer, L, R, T, P, E, num_heads, Fd, pos, *plan, stream
            )
            _build.check(lib, err, "decode_step")
            fused_decode_step.launches += 1
            if bf16:
                fused_decode_step.bf16_launches += 1
    return x_out, alpha, k_new, v_new


fused_decode_step.launches = 0  # per-layer kernel launches
fused_decode_step.onecell_launches = 0  # one-cell kernel launches
fused_decode_step.bf16_launches = 0  # per-layer launches of the bf16 arm
fused_decode_step.onecell_bf16_launches = 0  # one-cell launches of the bf16 arm (also in .onecell_launches)


def apply_cache_update(cache_k, cache_v, k_new, v_new, pos: int):
    """Write the step's per-layer K/V rows (L, R, E) at position ``pos`` of
    the (L, R, T, E) caches.  Updates the caches IN PLACE and returns them."""
    cache_k[:, :, pos] = k_new
    cache_v[:, :, pos] = v_new
    return cache_k, cache_v


def _full_rollout_plain(
    w: DecodeWeights, embedding, fc_w, fc_b, pe, mem_k, mem_v, start_id: int, end_id: int,
    steps: int, num_heads: int, *, teacher=None, use_teacher=None,
):
    """Plain PyTorch version of the rollout kernel; its definition.  Per step
    s: the input token (the teacher's where ``use_teacher[s]``), its
    embedding row plus ``pe[s]``, ``_decode_step_plain`` with the cache
    written at s, logits ``x fc_w^T + fc_b``, the first argmax; rows that
    finished earlier emit zeros and keep their input token.  Stops once
    every row has finished (the steps left would only emit zeros)."""
    L, R, P, E = mem_k.shape
    V = fc_w.shape[0]
    dev = mem_k.device
    cache_k = mem_k.new_zeros(L, R, steps, E)
    cache_v = torch.zeros_like(cache_k)
    tok = torch.full((R,), start_id, dtype=torch.long, device=dev)
    fin = torch.zeros(R, dtype=torch.bool, device=dev)
    logits = mem_k.new_zeros(R, steps, V)
    seqs = torch.zeros(R, steps, dtype=torch.int32, device=dev)
    alphas = mem_k.new_zeros(R, steps, P)
    for s in range(steps):
        if bool(fin.all()):
            break
        if use_teacher is not None:
            tok = torch.where(use_teacher[s].bool(), teacher[s].long(), tok)
        x = embedding[tok] + pe[s]
        x, alpha, k_new, v_new = _decode_step_plain(w, x, s, cache_k, cache_v, mem_k, mem_v, num_heads)
        apply_cache_update(cache_k, cache_v, k_new, v_new, s)
        logits_s = F.linear(x, fc_w, fc_b)
        pred = logits_s.argmax(dim=-1)
        act = ~fin
        logits[:, s] = torch.where(act[:, None], logits_s, 0.0)
        seqs[:, s] = torch.where(act, pred, 0).to(torch.int32)
        alphas[:, s] = torch.where(act[:, None], alpha, 0.0)
        tok = torch.where(act, pred, tok)
        fin = fin | (act & (pred == end_id))
    return logits, seqs, alphas


def _full_rollout_plain_bf16(
    w: DecodeWeights, embedding, fc_w, fc_b, pe, mem_k, mem_v, start_id: int, end_id: int,
    steps: int, num_heads: int, *, teacher=None, use_teacher=None, sums=torch.float32,
):
    """Plain PyTorch version of the rollout kernel's bf16 instance: JAX's
    ``_mega_kernel`` with ``mxu_dtype=bfloat16`` on ``storage_dtype=bf16``
    operands (tpu_captioner/ops/decode_step.py:570-735): per token, x =
    embedding[tok] + pe[s] in f32 (the bf16 row is exact, x not rounded),
    ``_decode_step_plain_bf16`` with the caches in bf16 (the new k and v
    rounded as they are stored), logits ``bf16(x) fc_w^T + fc_b`` in f32,
    the first argmax; the rest as ``_full_rollout_plain``.  ``sums`` as in
    ``_decode_step_plain_bf16``."""
    L, R, P, E = mem_k.shape
    V = fc_w.shape[0]
    dev = mem_k.device
    f32 = torch.float32
    cache_k = mem_k.new_zeros(L, R, steps, E)
    cache_v = torch.zeros_like(cache_k)
    tok = torch.full((R,), start_id, dtype=torch.long, device=dev)
    fin = torch.zeros(R, dtype=torch.bool, device=dev)
    logits = torch.zeros(R, steps, V, device=dev, dtype=f32)
    seqs = torch.zeros(R, steps, dtype=torch.int32, device=dev)
    alphas = torch.zeros(R, steps, P, device=dev, dtype=f32)
    for s in range(steps):
        if bool(fin.all()):
            break
        if use_teacher is not None:
            tok = torch.where(use_teacher[s].bool(), teacher[s].long(), tok)
        x = embedding[tok].to(sums) + pe[s].to(sums)
        x, alpha, k_new, v_new = _decode_step_plain_bf16(w, x, s, cache_k, cache_v, mem_k, mem_v, num_heads, sums)
        apply_cache_update(cache_k, cache_v, k_new, v_new, s)
        logits_s = (F.linear(x.to(torch.bfloat16).to(sums), fc_w.to(sums)) + fc_b.to(sums)).to(f32)
        pred = logits_s.argmax(dim=-1)
        act = ~fin
        logits[:, s] = torch.where(act[:, None], logits_s, 0.0)
        seqs[:, s] = torch.where(act, pred, 0).to(torch.int32)
        alphas[:, s] = torch.where(act[:, None], alpha, 0.0)
        tok = torch.where(act, pred, tok)
        fin = fin | (act & (pred == end_id))
    return logits, seqs, alphas


def fused_full_rollout(
    w: DecodeWeights,
    embedding: torch.Tensor,  # (V, E), the pad row already zeroed where the model pins it
    fc_w: torch.Tensor,  # (V, E), nn.Linear layout
    fc_b: torch.Tensor,  # (V,)
    pe: torch.Tensor,  # (>= steps, E) positional table
    mem_k: torch.Tensor,  # (L, R, P, E)
    mem_v: torch.Tensor,  # (L, R, P, E)
    start_id: int,
    end_id: int,
    steps: int,
    num_heads: int,
    *,
    teacher: torch.Tensor = None,  # (steps, R) token ids
    use_teacher: torch.Tensor = None,  # (steps, R) bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A whole greedy rollout of ``steps`` tokens from ``start_id``: returns
    (logits (R, steps, V), seqs (R, steps) int32, alphas (R, steps, P)), with
    the steps of rows that emitted ``end_id`` earlier zeroed.  ``teacher``
    and ``use_teacher`` mix ground-truth input tokens in (scheduled
    sampling).  CUDA tensors launch the kernel once, which also stops once
    every row has finished and leaves the tokens it ran in
    ``fused_full_rollout.steps_run`` (a 0-d tensor on the card); CPU tensors
    take the plain version; any other device raises.  The weight matrices'
    dtype picks the arm (the module docstring): f32, or bf16 with
    ``embedding``, ``fc_w``, ``mem_k`` and ``mem_v`` in bf16; another dtype
    raises ValueError.  Forward only."""
    _build.refuse_autograd(
        "fused_full_rollout", (*w, embedding, fc_w, fc_b, pe, mem_k, mem_v),
        "not planned (decoding runs under torch.inference_mode)",
    )
    if (teacher is None) != (use_teacher is None):
        raise ValueError("teacher and use_teacher go together")
    steps = int(steps)
    dt = w.w_qkv.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_full_rollout has no instance for {dt} weights: float32, or bfloat16")
    bf16 = dt == torch.bfloat16
    if mem_k.device.type == "cpu":
        for name, t in (("embedding", embedding), ("fc_w", fc_w), ("mem_k", mem_k), ("mem_v", mem_v)):
            if t.dtype != dt:
                raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        return (_full_rollout_plain_bf16 if bf16 else _full_rollout_plain)(
            w, embedding, fc_w, fc_b, pe, mem_k, mem_v, start_id, end_id, steps, num_heads,
            teacher=teacher, use_teacher=use_teacher,
        )
    if mem_k.device.type != "cuda":
        raise ValueError(f"fused_full_rollout runs on cpu or cuda tensors, got {mem_k.device}")
    _build.require_current_device("fused_full_rollout", (embedding, fc_w, fc_b, pe, mem_k, mem_v))
    L, R, P, E = mem_k.shape
    V = fc_w.shape[0]
    Fd = w.w_f1.shape[1]
    dev = mem_k.device
    if steps < 1 or pe.shape[0] < steps:
        raise ValueError(f"steps must be in [1, {pe.shape[0]}] (the PE table's length), got {steps}")
    pe = pe[:steps].contiguous()
    if teacher is not None:
        teacher = teacher.to(dev, torch.int32).contiguous()
        use_teacher = use_teacher.to(dev, torch.int32).contiguous()
    f32 = torch.float32
    shapes = _weight_shapes(w, L, E, num_heads, dt)
    shapes.update({
        "embedding": (embedding, (V, E), dt), "fc_w": (fc_w, (V, E), dt), "fc_b": (fc_b, (V,), f32),
        "pe": (pe, (steps, E), f32),
        "mem_k": (mem_k, (L, R, P, E), dt), "mem_v": (mem_v, (L, R, P, E), dt),
    })
    if teacher is not None:
        shapes["teacher"] = (teacher, (steps, R), torch.int32)
        shapes["use_teacher"] = (use_teacher, (steps, R), torch.int32)
    _check_tensors(dev, shapes)
    lib = _lib()
    logits = torch.zeros(R, steps, V, device=dev, dtype=f32)
    seqs = torch.zeros(R, steps, device=dev, dtype=torch.int32)
    alphas = torch.zeros(R, steps, P, device=dev, dtype=f32)
    cache_k = torch.empty(L, R, steps, E, device=dev, dtype=dt)  # slot s is written before it is read
    cache_v = torch.empty_like(cache_k)
    state = torch.zeros(2 * R + 1, device=dev, dtype=torch.int32)  # tok, fin, tokens run
    state[:R] = start_id
    scratch = torch.empty(
        lib.tc_rollout_scratch_floats(R, E, num_heads, Fd, P), device=dev, dtype=f32
    )
    plan = _plan_args(decode_plan("rollout", R, steps, P, E, num_heads, Fd, _sms(dev), V, esize=dt.itemsize))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rollout = lib.tc_decode_rollout_bf16 if bf16 else lib.tc_decode_rollout
    with torch.cuda.device(dev):
        err = rollout(
            embedding.data_ptr(), fc_w.data_ptr(), fc_b.data_ptr(), pe.data_ptr(),
            ptr(teacher), ptr(use_teacher), logits.data_ptr(), seqs.data_ptr(), alphas.data_ptr(),
            *(t.data_ptr() for t in w), mem_k.data_ptr(), mem_v.data_ptr(),
            cache_k.data_ptr(), cache_v.data_ptr(), state.data_ptr(), scratch.data_ptr(),
            L, R, P, E, num_heads, Fd, V, steps, int(end_id), *plan,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, err, "decode_rollout")
    fused_full_rollout.launches += 1
    if bf16:
        fused_full_rollout.bf16_launches += 1
    fused_full_rollout.steps_run = state[2 * R]
    return logits, seqs, alphas


fused_full_rollout.launches = 0
fused_full_rollout.bf16_launches = 0  # launches of the bf16 instance (also in .launches)
fused_full_rollout.steps_run = None
