"""Fused LSTM + additive-attention decode step (counterpart of
``tpu_captioner/ops/lstm_step.py``).

``fused_lstm_step`` runs the per-token body of ``DecoderWithAttention`` for
R rows (batch, or batch x beams): the Bahdanau attention against the hoisted
encoder projection ``att1``, the sigmoid-gated context (``f_beta``) and the
LSTMCell, with the gate product split as ``emb w_ih_e^T + ctx w_ih_c^T``
instead of a concatenation and the (A -> 1) score projection as a
multiply-reduce.  The embedding lookup and the vocab head stay outside, as
in the JAX package.

Layouts: emb (R, E), h and c (R, D), enc (R, P, C), att1 (R, P, A);
weights from ``prepare_lstm_weights`` in nn.Linear's (out, in) layout.
For CUDA tensors one call is one cooperative launch of
``csrc/lstm_step.cu`` (one per 160 rows beyond 160), planned by
``lstm_plan``; for CPU tensors it runs ``_lstm_step_plain``, the same math in
PyTorch.  Eval only: no dropout, no gradient.

The weights' dtype picks the instance, each an arm of the JAX package's
``precise`` keyword (tpu_captioner/ops/lstm_step.py:148-157): f32 weights
(every tensor f32) multiply f32 operands in f32; the five matrices of
``cast_lstm_weight_matrices(w, bfloat16)`` with bf16 emb, enc and att1 (h,
c, wfull and the biases f32), JAX's ``precise=False``, round each product's
activation operand to bf16 and sum the exact bf16 products in f32 (JAX's
``mxu_dtype=bfloat16``), with enc and att1 consumed in f32 and the softmax,
alpha, h and c in f32.  Its plain version is ``_lstm_step_plain_bf16``; its
kernel, ``lstm_step_kernel``'s bf16 instance.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_captioner_torch.models.layers import lstm_update
from tpu_captioner_torch.ops import _build
from tpu_captioner_torch.ops.decode_step import _check_tensors

SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on the H100
MAX_ROWS = 160  # rows of one launch: the wgmma's N, padded to an instance
ROW_INSTANCES = (16, 32, 48, 64, 96, 128, 160)  # the kernel's instances of N
STAGE = 32  # K columns a ring stage
TILE = 64  # weight rows a tile (the wgmma's M)
GATE_UNITS = 16  # hidden units a gate tile, four gate rows each
MAX_STAGES = 4
MAX_SPLIT = 4
CTX_CHANNELS = 128  # channels a context task
FLAG_HEAD = 4  # the split, the [wd | wfb] partials stored, blocks out, a spare


class LstmStepWeights(NamedTuple):
    """One decode step's weights in the kernel layout (field order is the
    C entry point's argument order)."""

    wd: torch.Tensor  # (A, D) attention.decoder_att
    bd: torch.Tensor  # (A,)
    wfull: torch.Tensor  # (A,) attention.full_att, a multiply-reduce
    bfull: torch.Tensor  # (1,)
    wfb: torch.Tensor  # (C, D) f_beta
    bfb: torch.Tensor  # (C,)
    w_ih_e: torch.Tensor  # (4D, E) token-embedding columns of the cell's weight_ih
    w_ih_c: torch.Tensor  # (4D, C) context columns of weight_ih
    w_hh: torch.Tensor  # (4D, D)
    b: torch.Tensor  # (4D,) bias_ih + bias_hh


class LstmPlan(NamedTuple):
    """One launch's plan (``csrc/lstm_step.cu:Plan``, in its field order)."""

    rows: int  # the products' N: R padded to an instance
    grid: int  # blocks: one per SM
    af_split: int  # K splits of an att2 / f_beta tile
    gate_split: int  # K splits of a gate tile
    stages: int  # ring slots
    wc_stages: int  # w_ih_c stages a gate block holds in shared memory
    smem: int  # dynamic shared memory, bytes


class LstmWork(NamedTuple):
    """What one block computes: the [wd | wfb] tile ``af`` (None: none) over
    32-column K stages ``af_k`` of D, and the gate tile ``gate`` (None: none)
    over stages ``gate_hk`` of [D | E] (w_hh, then w_ih_e) and ``gate_ck`` of
    C (w_ih_c)."""

    af: Optional[int]
    af_k: range
    gate: Optional[int]
    gate_hk: range
    gate_ck: range


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def lstm_plan(R: int, E: int, D: int, A: int, C: int, P: int, sms: int, esize: int = 4) -> LstmPlan:
    """The plan of one launch on a card of ``sms`` SMs, one block each.
    Tiles: ceil(A / 64) of wd and ceil(C / 64) of f_beta, each split over K
    = D into ``af_split`` ranges of 32-column stages; ceil(D / 16) gate tiles
    (16 hidden units x 4 gates), each split over K = D + E and K = C into
    ``gate_split`` ranges.  A split is one block's; a gate block holds its
    ``wc_stages`` stages of w_ih_c in shared memory beside a ring of
    ``stages`` slots (a weight stage and the B planes of ``rows`` rows).
    Raises ValueError for R beyond ``MAX_ROWS``, for more tiles than SMs,
    and when the ring's two slots do not fit a block's shared memory.
    ``esize`` is the bytes of a weight element, 4, or 2 for the bf16
    instance: its ring stages and w_ih_c stages hold the weights as stored,
    and its stages one B plane (the bf16-rounded activations) where the f32
    instance's hold two (TF32 hi and lo)."""
    if esize not in (2, 4):
        raise ValueError(f"lstm_step: weights of 4 or 2 bytes, got {esize}")
    if min(E, D, A, C, P, sms) < 1:
        raise ValueError(f"lstm_step: every width must be positive, got E={E}, D={D}, A={A}, C={C}, P={P}")
    if not 1 <= R <= MAX_ROWS:
        raise ValueError(f"lstm_step: one launch takes 1 to {MAX_ROWS} rows, got {R}")
    rows = next(n for n in ROW_INSTANCES if n >= R)
    kd, ke, kc = _cdiv(D, STAGE), _cdiv(E, STAGE), _cdiv(C, STAGE)
    n_af, n_g = _cdiv(A, TILE) + _cdiv(C, TILE), _cdiv(D, GATE_UNITS)
    if n_af > sms or n_g > sms:
        raise ValueError(f"lstm_step: {n_af} attention and {n_g} gate tiles (A={A}, C={C}, D={D}) "
                         f"exceed the card's {sms} blocks")
    af_split = min(MAX_SPLIT, sms // n_af, kd)
    gate_split = min(MAX_SPLIT, sms // n_g, kc, kd + ke)
    wc_stages = _cdiv(kc, gate_split)
    planes = 2 if esize == 4 else 1
    slot = esize * TILE * STAGE + 4 * planes * rows * STAGE
    fixed = 1024 + esize * TILE * STAGE * wc_stages + 8 * (2 * MAX_STAGES + 1) + 16
    stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // slot)
    if stages < 2:
        raise ValueError(
            f"lstm_step keeps {wc_stages} stages of w_ih_c (C={C}, {gate_split} splits) and a ring of two "
            f"{slot}-byte slots ({rows} rows) in shared memory: {fixed + 2 * slot} bytes > {SMEM_LIMIT}")
    return LstmPlan(rows, sms, af_split, gate_split, stages, wc_stages, fixed + stages * slot)


def lstm_units(plan: LstmPlan, E: int, D: int, A: int, C: int) -> List[LstmWork]:
    """Each block's work (``csrc/lstm_step.cu:work_of``): the [wd | wfb]
    splits from the last block down, the gate splits from block 0 up."""
    kd, ke, kc = _cdiv(D, STAGE), _cdiv(E, STAGE), _cdiv(C, STAGE)
    n_af, n_g = _cdiv(A, TILE) + _cdiv(C, TILE), _cdiv(D, GATE_UNITS)
    out = []
    for b in range(plan.grid):
        ua, af, af_k = plan.grid - 1 - b, None, range(0)
        if ua < n_af * plan.af_split:
            s, af = ua % plan.af_split, ua // plan.af_split
            af_k = range(s * kd // plan.af_split, (s + 1) * kd // plan.af_split)
        gate, hk, ck = None, range(0), range(0)
        if b < n_g * plan.gate_split:
            s, gate = b % plan.gate_split, b // plan.gate_split
            hk = range(s * (kd + ke) // plan.gate_split, (s + 1) * (kd + ke) // plan.gate_split)
            ck = range(s * kc // plan.gate_split, (s + 1) * kc // plan.gate_split)
        out.append(LstmWork(af, af_k, gate, hk, ck))
    return out


def workspace_floats(plan: LstmPlan, R: int, E: int, D: int, A: int, C: int, P: int) -> int:
    """Floats of one launch's workspace (``csrc/lstm_step.cu:carve``): the
    partial tiles, the B planes of h, emb and the context and the scores,
    each rounded up to 32."""
    r32 = lambda n: _cdiv(n, 32) * 32  # noqa: E731
    p16 = lambda n: _cdiv(n, 16) * 16  # noqa: E731
    n_af, n_g = _cdiv(A, TILE) + _cdiv(C, TILE), _cdiv(D, GATE_UNITS)
    tile = plan.rows * TILE
    sizes = (n_af * plan.af_split * tile, n_g * plan.gate_split * tile, 2 * R * p16(D), 2 * R * p16(E),
             2 * R * p16(C), R * P)
    return sum(r32(n) for n in sizes)


def flag_count(R: int, D: int, C: int) -> int:
    """Ints of one launch's flags (``csrc/lstm_step.cu:Dims::n_flags``): four
    of the launch, one per gate tile, two per row, one per 128-channel
    context chunk."""
    return FLAG_HEAD + _cdiv(D, GATE_UNITS) + 2 * R + _cdiv(C, CTX_CHANNELS)


@torch.no_grad()
def prepare_lstm_weights(decoder) -> LstmStepWeights:
    """Repack a ``models.lstm.DecoderWithAttention``'s parameters into the
    kernel layout: two slices of ``weight_ih`` copied, the biases summed,
    the rest shared with the parameters, all detached.  Run once per rollout
    or beam call, outside the token loop.  The gate rows stay in the
    parameters' order: the kernel's TMA box takes a gate tile's 16 rows of
    each gate at once."""
    att, cell = decoder.attention, decoder.decode_step
    e = decoder.embedding.weight.shape[1]
    packed = LstmStepWeights(
        wd=att.decoder_att.weight,
        bd=att.decoder_att.bias,
        wfull=att.full_att.weight.reshape(-1),
        bfull=att.full_att.bias.reshape(1),
        wfb=decoder.f_beta.weight,
        bfb=decoder.f_beta.bias,
        w_ih_e=cell.weight_ih[:, :e],
        w_ih_c=cell.weight_ih[:, e:],
        w_hh=cell.weight_hh,
        b=cell.bias_ih + cell.bias_hh,
    )
    return LstmStepWeights(*(x.detach().contiguous() for x in packed))


def _lstm_step_plain(w: LstmStepWeights, emb, h, c, enc, att1):
    """Plain PyTorch version of the fused step; the kernel's definition."""
    att2 = F.linear(h, w.wd, w.bd)  # (R, A)
    score = (torch.relu(att1 + att2[:, None, :]) * w.wfull).sum(dim=-1) + w.bfull  # (R, P)
    alpha = torch.softmax(score, dim=1)
    ctx = torch.sigmoid(F.linear(h, w.wfb, w.bfb)) * (alpha[:, :, None] * enc).sum(dim=1)  # (R, C)
    gates = F.linear(emb, w.w_ih_e) + F.linear(ctx, w.w_ih_c) + F.linear(h, w.w_hh) + w.b
    return (*lstm_update(gates, c), alpha)


_MATRICES = ("wd", "wfb", "w_ih_e", "w_ih_c", "w_hh")


def cast_lstm_weight_matrices(w: LstmStepWeights, dtype: torch.dtype) -> LstmStepWeights:
    """The five weight matrices in ``dtype``; ``wfull`` (a multiply-reduce,
    not a product) and the biases as they are (tpu_captioner/ops/
    lstm_step.py:70)."""
    return w._replace(**{f: getattr(w, f).to(dtype).contiguous() for f in _MATRICES})


def _lstm_step_plain_bf16(w: LstmStepWeights, emb, h, c, enc, att1, sums=torch.float32):
    """Plain PyTorch version of the bf16 instance: the JAX kernel's
    ``_kernel`` with ``mxu_dtype=bfloat16`` (tpu_captioner/ops/
    lstm_step.py:81-126) on the bf16 matrices, emb, enc and att1.  Every
    product rounds its activation operand (h for att2, f_beta and w_hh;
    emb; the gated context for w_ih_c) to bf16 and sums exact products;
    att1 and enc are read in f32 (the score and context sums), the softmax
    runs in f32 and alpha is not rounded.  Returns h_new, c_new and alpha in
    f32.  ``sums`` is the dtype the sums run in: float64 gives the same
    roundings to bf16 with other sums, the noise floor another correct
    implementation lands within (``chip_smoke.py`` phase 13)."""

    def bf(t):  # rounded to bf16, then summed in `sums`
        return t.to(torch.bfloat16).to(sums)

    def mm(a, m):  # JAX's ``mm`` with bf16 multiplicands: exact products, sums in `sums`
        return F.linear(bf(a), m.to(sums))

    h, c = h.to(sums), c.to(sums)
    vec = {f: getattr(w, f).to(sums) for f in ("bd", "wfull", "bfull", "bfb", "b")}
    att2 = mm(h, w.wd) + vec["bd"]
    score = (torch.relu(att1.to(sums) + att2[:, None, :]) * vec["wfull"]).sum(dim=-1) + vec["bfull"]
    alpha = torch.softmax(score, dim=1)
    ctx = torch.sigmoid(mm(h, w.wfb) + vec["bfb"]) * (alpha[:, :, None] * enc.to(sums)).sum(dim=1)
    gates = mm(emb, w.w_ih_e) + mm(ctx, w.w_ih_c) + mm(h, w.w_hh) + vec["b"]
    h_new, c_new = lstm_update(gates, c)
    f32 = torch.float32
    return h_new.to(f32), c_new.to(f32), alpha.to(f32)


_CHECKED: "collections.OrderedDict" = collections.OrderedDict()  # id -> (weights, widths) checked, newest last


def _operands(w: LstmStepWeights, emb, h, c, enc, att1, dt):
    """(activations, weights): each ``name: (tensor, shape, dtype)`` of the
    instance of storage dtype ``dt``: the five matrices, emb, enc and att1
    in ``dt``, the rest f32."""
    R, E = emb.shape
    D = h.shape[1]
    _, P, C = enc.shape
    A = att1.shape[2]
    f32 = torch.float32
    activations = {
        "emb": (emb, (R, E), dt), "h": (h, (R, D), f32), "c": (c, (R, D), f32),
        "enc": (enc, (R, P, C), dt), "att1": (att1, (R, P, A), dt),
    }
    weights = {
        "wd": (w.wd, (A, D), dt), "bd": (w.bd, (A,), f32), "wfull": (w.wfull, (A,), f32),
        "bfull": (w.bfull, (1,), f32), "wfb": (w.wfb, (C, D), dt), "bfb": (w.bfb, (C,), f32),
        "w_ih_e": (w.w_ih_e, (4 * D, E), dt), "w_ih_c": (w.w_ih_c, (4 * D, C), dt),
        "w_hh": (w.w_hh, (4 * D, D), dt), "b": (w.b, (4 * D,), f32),
    }
    return activations, weights


def _check(w: LstmStepWeights, emb, h, c, enc, att1, dt=torch.float32) -> None:
    """Each tensor's device, dtype, shape, contiguity and alignment
    (``_operands``): the activations every call, the weights once per
    ``LstmStepWeights`` object and widths (a rollout's 51 steps share one;
    the two newest are remembered, and held, so an id is never mistaken for
    another's)."""
    activations, weights = _operands(w, emb, h, c, enc, att1, dt)
    _check_tensors(emb.device, activations)
    key = (emb.shape[1], h.shape[1], att1.shape[2], enc.shape[2], emb.device, dt)
    seen = _CHECKED.get(id(w))
    if seen is not None and seen[0] is w and seen[1] == key:
        return
    _check_tensors(emb.device, weights)
    _CHECKED[id(w)] = (w, key)
    while len(_CHECKED) > 2:
        _CHECKED.popitem(last=False)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its entry points declared, once per process."""
    lib = _build.load("lstm_step")
    for fn in (lib.tc_lstm_step, lib.tc_lstm_step_bf16):
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_longlong, ctypes.c_void_p]
                       + [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p])
    return lib


@functools.lru_cache(maxsize=None)
def _launch_plan(R, E, D, A, C, P, device: int, esize: int = 4):
    """The plan for the card ``device``, its ctypes copy, the workspace's
    floats and the flags' count, once per shape and instance."""
    plan = lstm_plan(R, E, D, A, C, P, _build.sm_count(device), esize)
    return (plan, (ctypes.c_int * len(plan))(*plan), workspace_floats(plan, R, E, D, A, C, P),
            flag_count(R, D, C))


_SCRATCH = {}  # device -> (workspace, flags)


def _scratch(device: int, floats: int, flags: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device's workspace and flags, each grown to at least ``floats``
    and ``flags``.  The flags are made zero and every launch leaves them
    zero; no launch's data overlaps them.  Calls on one card share both, so
    they run one after another on one stream."""
    work, flag = _SCRATCH.get(device, (None, None))
    if work is None or work.numel() < floats:
        work = torch.empty(floats, device=f"cuda:{device}", dtype=torch.float32)
    if flag is None or flag.numel() < flags:
        flag = torch.zeros(flags, device=f"cuda:{device}", dtype=torch.int32)
    _SCRATCH[device] = work, flag
    return work, flag


def fused_lstm_step(
    w: LstmStepWeights,
    emb: torch.Tensor,  # (R, E) token embeddings
    h: torch.Tensor,  # (R, D)
    c: torch.Tensor,  # (R, D)
    enc: torch.Tensor,  # (R, P, C) flattened encoder output
    att1: torch.Tensor,  # (R, P, A) hoisted encoder_att projection
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (h_new (R, D), c_new (R, D), alpha (R, P)), f32:
    ``DecoderWithAttention.step``.  CUDA tensors: one kernel launch per
    call of up to ``MAX_ROWS`` rows (one per ``MAX_ROWS`` rows beyond);
    CPU tensors: the plain version; any other device raises.  The weight
    matrices' dtype picks the instance (the module docstring): f32, or the
    bf16 arm; weights of another dtype raise ValueError, as do operands
    whose dtypes are not the instance's set.  Forward only: raises on every
    device when autograd would need its gradient."""
    _build.refuse_autograd(
        "fused_lstm_step", (*w, emb, h, c, enc, att1),
        "not planned (decoding runs under torch.inference_mode)",
    )
    dt = w.wd.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_lstm_step has no instance for {dt} weights: float32, or bfloat16 (precise=False)")
    bf16 = dt == torch.bfloat16
    if emb.device.type == "cpu":
        _check_dtypes(w, emb, h, c, enc, att1, dt)
        return (_lstm_step_plain_bf16 if bf16 else _lstm_step_plain)(w, emb, h, c, enc, att1)
    if emb.device.type != "cuda":
        raise ValueError(f"fused_lstm_step runs on cpu or cuda tensors, got {emb.device}")
    _check(w, emb, h, c, enc, att1, dt)
    _build.require_current_device("fused_lstm_step", (emb, h, c, enc, att1))
    R = emb.shape[0]
    if R > MAX_ROWS:  # row slices at multiples of 160 stay 16-byte aligned
        parts = [fused_lstm_step(w, *(x[i:i + MAX_ROWS] for x in (emb, h, c, enc, att1)))
                 for i in range(0, R, MAX_ROWS)]
        return tuple(torch.cat(p) for p in zip(*parts))
    E, D, (_, P, C), A = emb.shape[1], h.shape[1], enc.shape, att1.shape[2]
    dev = emb.device.index
    plan, plan_c, floats, flags = _launch_plan(R, E, D, A, C, P, dev, w.wd.element_size())
    work, flag = _scratch(dev, floats, flags)
    h_new, c_new = torch.empty_like(h), torch.empty_like(c)
    alpha = torch.empty(R, P, device=emb.device, dtype=torch.float32)
    lib = _lib()
    step = lib.tc_lstm_step_bf16 if bf16 else lib.tc_lstm_step
    err = step(*(t.data_ptr() for t in (emb, h, c, enc, att1, *w, h_new, c_new, alpha, work)),
               work.numel(), flag.data_ptr(), flag.numel(), R, E, D, A, C, P, plan_c, dev, _build.raw_stream(dev))
    _build.check(lib, err, "lstm_step")
    fused_lstm_step.launches += 1
    if bf16:
        fused_lstm_step.bf16_launches += 1
    return h_new, c_new, alpha


def _check_dtypes(w: LstmStepWeights, emb, h, c, enc, att1, dt) -> None:
    """The instance's dtype set on the CPU, where no layout matters."""
    for group in _operands(w, emb, h, c, enc, att1, dt):
        for name, (t, _, want) in group.items():
            if t.dtype != want:
                raise ValueError(f"{name} must be {want}, got {t.dtype}")


fused_lstm_step.launches = 0  # kernel launches, one per call of up to MAX_ROWS rows on CUDA tensors
fused_lstm_step.bf16_launches = 0  # launches of the bf16 instance (also in .launches)
