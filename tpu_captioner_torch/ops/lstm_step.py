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
``csrc/lstm_step.cu``; for CPU tensors it runs ``_lstm_step_plain``, the same
math in PyTorch.  Eval only: no dropout, no gradient.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from tpu_captioner_torch.models.layers import lstm_update
from tpu_captioner_torch.ops import _build
from tpu_captioner_torch.ops.decode_step import _check_tensors

SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on the H100


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


@torch.no_grad()
def prepare_lstm_weights(decoder) -> LstmStepWeights:
    """Repack a ``models.lstm.DecoderWithAttention``'s parameters into the
    kernel layout: two slices of ``weight_ih`` copied, the biases summed,
    the rest shared with the parameters, all detached.  Run once per rollout
    or beam call, outside the token loop."""
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


def _check(w: LstmStepWeights, emb, h, c, enc, att1) -> None:
    R, E = emb.shape
    D = h.shape[1]
    _, P, C = enc.shape
    A = att1.shape[2]
    f32 = torch.float32
    shapes = {
        "emb": (emb, (R, E), f32), "h": (h, (R, D), f32), "c": (c, (R, D), f32),
        "enc": (enc, (R, P, C), f32), "att1": (att1, (R, P, A), f32),
        "wd": (w.wd, (A, D), f32), "bd": (w.bd, (A,), f32), "wfull": (w.wfull, (A,), f32),
        "bfull": (w.bfull, (1,), f32), "wfb": (w.wfb, (C, D), f32), "bfb": (w.bfb, (C,), f32),
        "w_ih_e": (w.w_ih_e, (4 * D, E), f32), "w_ih_c": (w.w_ih_c, (4 * D, C), f32),
        "w_hh": (w.w_hh, (4 * D, D), f32), "b": (w.b, (4 * D,), f32),
    }
    _check_tensors(emb.device, shapes)
    smem = _lib().tc_lstm_smem_bytes(E, D, C, P)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"lstm_step stages 16 rows of h and emb (D + E = {D + E}) or of the context "
            f"(C = {C}) in shared memory: {smem} bytes > {SMEM_LIMIT}"
        )


def _lib():
    lib = _build.load("lstm_step")
    lib.tc_lstm_step.restype = ctypes.c_int
    lib.tc_lstm_step.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.tc_lstm_scratch_floats.restype = ctypes.c_longlong
    lib.tc_lstm_scratch_floats.argtypes = [ctypes.c_int] * 5
    lib.tc_lstm_smem_bytes.restype = ctypes.c_longlong
    lib.tc_lstm_smem_bytes.argtypes = [ctypes.c_int] * 4
    return lib


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
    call; CPU tensors: the plain version; any other device raises.  Forward
    only: raises on every device when autograd would need its gradient."""
    _build.refuse_autograd(
        "fused_lstm_step", (*w, emb, h, c, enc, att1),
        "not planned (decoding runs under torch.inference_mode)",
    )
    if emb.device.type == "cpu":
        return _lstm_step_plain(w, emb, h, c, enc, att1)
    if emb.device.type != "cuda":
        raise ValueError(f"fused_lstm_step runs on cpu or cuda tensors, got {emb.device}")
    _check(w, emb, h, c, enc, att1)
    R, E = emb.shape
    D, (_, P, C), A = h.shape[1], enc.shape, att1.shape[2]
    lib = _lib()
    h_new, c_new = torch.empty_like(h), torch.empty_like(c)
    alpha = torch.empty(R, P, device=emb.device, dtype=torch.float32)
    scratch = torch.empty(lib.tc_lstm_scratch_floats(R, D, A, C, P), device=emb.device, dtype=torch.float32)
    ptrs = [t.data_ptr() for t in (emb, h, c, enc, att1, *w, h_new, c_new, alpha, scratch)]
    with torch.cuda.device(emb.device):
        err = lib.tc_lstm_step(*ptrs, R, E, D, A, C, P, torch.cuda.current_stream(emb.device).cuda_stream)
    _build.check(lib, err, "lstm_step")
    fused_lstm_step.launches += 1
    return h_new, c_new, alpha


fused_lstm_step.launches = 0  # kernel launches, one per call on CUDA tensors
