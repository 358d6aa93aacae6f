"""Analytic model-FLOP accounting for MFU reporting, against the card's own
published peaks.

The counts are a copy of ``tpu_captioner/eval/flops.py``'s, with its names,
signatures, defaults and integer results: matmul/conv multiply-accumulate
FLOPs (2 * MACs, the standard MFU convention; elementwise/LN/softmax work is
not counted) for the ConvNeXt encoder and each decoder family.  They need
no ``torch``.

Backward convention: training FLOPs = forward + 2x forward for every
parameter that receives a gradient, PLUS 2x forward for frozen layers the
input gradient must still flow through (none here: the encoder is the first
layer, so fully-frozen stages contribute forward only).

The denominator differs from the JAX package's.  There a step's matrix
products run at the accelerator's reduced-precision rate unless a caller
asks for ``precision="highest"``, so its ``mfu`` takes a precision name.
The port's f32 products are always f32-accurate: cuBLAS and cuDNN run with
TF32 off (``core/backend.py:pin_f32_precision``) and the hand-written
kernels run three TF32 products per f32 one (``csrc/tf32x3_gemm.cuh``).  So
the denominator follows the step's compute dtype: ``"bfloat16"`` steps are
held to the card's dense bf16 tensor-core rate, ``"float32"`` steps to the
f32-accurate tensor-core rate, TF32 / 3 (the least time for f32 products,
whatever implements them; the FFMA rate would let a step whose products run
on the tensor cores read above 1).  A share is against the data sheet's
peak at the card's full power limit: print the card's limit beside it
(``core/backend.py:device_info``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from tpu_captioner_torch.core.config import COMPUTE_DTYPES

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), at its 700 W limit.
BF16_OPS_PER_S = 989e12  # bf16 products on the tensor cores
TF32_OPS_PER_S = 495e12  # TF32 products on the tensor cores
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores (FFMA)
HBM_BYTES_PER_S = 3.35e12
# Derived: an f32-accurate product on the tensor cores is three TF32 ones
# (hi*hi + hi*lo + lo*hi of each operand's TF32 split), as
# csrc/tf32x3_gemm.cuh runs it: the f32 denominator.
F32_PRODUCT_OPS_PER_S = TF32_OPS_PER_S / 3
# An f32 row times a bf16 weight, f32-accurate (the MLP tail's bf16
# instance), at the card's best: the row split into three bf16 pieces (hi,
# mid, lo: 24 bits), each product with the bf16 weight exact, summed in f32,
# i.e. three bf16 products per product (the kernel runs two TF32 ones, the
# row's hi and lo planes against the weight's only plane: 247.5 TFLOP/s).
BF16_BY_F32_OPS_PER_S = BF16_OPS_PER_S / 3

# Keyed by ``torch.cuda.get_device_name()``.  Only the SXM part's rates are
# published here; the PCIe and NVL parts (other clocks and power limits) and
# other cards have no entry until their data sheets' rates are entered.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {
        "bfloat16": BF16_OPS_PER_S,
        "tf32": TF32_OPS_PER_S,
        "float32_ffma": F32_OPS_PER_S,
        "float32": F32_PRODUCT_OPS_PER_S,
        "hbm_bytes_per_s": HBM_BYTES_PER_S,
    },
}


def peak_flops_per_chip(dtype: str = "float32", device_name: Optional[str] = None) -> Optional[float]:
    """The card's peak for a step computing in ``dtype`` ('float32' or
    'bfloat16'; else ValueError), FLOP/s.  ``device_name=None`` reads the
    current card's; None when there is no card or the table has no entry
    for it."""
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"dtype must be one of {COMPUTE_DTYPES}, got {dtype!r}")
    if device_name is None:
        import torch

        if not torch.cuda.is_available():
            return None
        device_name = torch.cuda.get_device_name()
    rates = PEAK_FLOPS.get(device_name)
    return None if rates is None else rates[dtype]


def convnext_forward_flops(
    image_size: int = 256,
    depths: Sequence[int] = (3, 3, 27, 3),
    dims: Sequence[int] = (128, 256, 512, 1024),
    per_stage: bool = False,
):
    """Forward matmul/conv FLOPs per image; per_stage=True returns a list of
    (stem+downsample, stage) contributions indexed like torchvision's 8
    feature children (reference models/encoder.py:19)."""
    h = w = image_size // 4
    children = [2 * h * w * dims[0] * (4 * 4 * 3)]  # features_0 stem conv
    for s, (n, d) in enumerate(zip(depths, dims)):
        if s > 0:
            h, w = h // 2, w // 2
            children.append(2 * h * w * d * (2 * 2 * dims[s - 1]))  # downsample
        # block: dwconv 7x7 (49*d MACs/px) + pw 4x expand + pw project
        block = 2 * h * w * (49 * d + 4 * d * d + 4 * d * d)
        children.append(n * block)
    return children if per_stage else sum(children)


def convnext_train_flops(
    image_size: int = 256,
    depths: Sequence[int] = (3, 3, 27, 3),
    dims: Sequence[int] = (128, 256, 512, 1024),
    train_encoder: bool = False,
    starting_layer: int = 5,
) -> int:
    """Per-image encoder FLOPs in one train step.  Frozen: forward only.
    Fine-tuning children >= starting_layer (reference encoder.py:29-34):
    those children add 2x forward for the backward pass."""
    children = convnext_forward_flops(image_size, depths, dims, per_stage=True)
    total = sum(children)
    if train_encoder:
        total += 2 * sum(children[starting_layer:])
    return total


@dataclass
class DecoderDims:
    vocab_size: int
    embed_dim: int = 512
    decoder_dim: int = 512  # ffn width (transformer) / LSTM hidden
    num_layers: int = 6
    seq_len: int = 52
    mem_len: int = 49
    encoder_dim: int = 1024
    attention_dim: int = 512  # LSTM additive-attention width


def transformer_forward_flops(d: DecoderDims) -> int:
    """Per-sequence forward FLOPs of the reference transformer decoder
    (models/transformerDecoder.py:82-108): encoder projection, 6 layers of
    self-attn + cross-attn + FFN, vocab head."""
    L, M, e, f, V = d.seq_len, d.mem_len, d.embed_dim, d.decoder_dim, d.vocab_size
    total = 2 * M * d.encoder_dim * e  # encoder_proj (per sequence)
    per_layer = (
        4 * 2 * L * e * e        # self-attn q,k,v,out projections
        + 2 * 2 * L * L * e      # self-attn scores + weighted values
        + 2 * 2 * L * e * e      # cross-attn q,out
        + 2 * 2 * M * e * e      # cross-attn k,v over memory
        + 2 * 2 * L * M * e      # cross-attn scores + weighted values
        + 2 * 2 * L * e * f      # FFN two matmuls
    )
    total += d.num_layers * per_layer
    total += 2 * L * e * V  # vocab head
    return total


def lstm_forward_flops(d: DecoderDims, attention: bool = True) -> int:
    """Per-sequence forward FLOPs of the LSTM decoders (models/decoder.py /
    lstmNoAttention.py): per step, LSTMCell (4 gates), additive attention
    over M pixels, f_beta gate, vocab head.  The attention's encoder-side
    projection is counted ONCE per sequence: the implementation hoists it
    out of the time loop (models/lstm.py), so the executed program does not
    repeat it per step."""
    L, M, e, hdim, V = d.seq_len, d.mem_len, d.embed_dim, d.decoder_dim, d.vocab_size
    enc = d.encoder_dim
    in_dim = e + (enc if attention else 0)
    per_step = 2 * 4 * hdim * (in_dim + hdim)  # LSTMCell
    if attention:
        att = d.attention_dim
        per_step += 2 * hdim * att  # decoder projection
        per_step += 2 * M * att  # scores
        per_step += 2 * M * enc  # attention-weighted context sum
        per_step += 2 * hdim * enc  # f_beta gate projection
        # (the elementwise sigmoid-gate multiply on the context is excluded,
        # matching the transformer path's matmul-only convention)
    per_step += 2 * hdim * V  # vocab head
    total = L * per_step
    if attention:
        total += 2 * M * enc * d.attention_dim  # hoisted encoder projection
        total += 2 * 2 * enc * hdim  # init_h / init_c from mean encoder out
    return total


def train_step_flops(
    batch_size: int,
    vocab_size: int,
    decoder: str = "transformer",
    image_size: int = 256,
    depths: Sequence[int] = (3, 3, 27, 3),
    dims: Sequence[int] = (128, 256, 512, 1024),
    train_encoder: bool = False,
    starting_layer: int = 5,
    seq_len: int = 52,
    embed_dim: int = 512,
    decoder_dim: int = 512,
    num_layers: int = 6,
    encoded_image_size: int = 7,
) -> int:
    """Model FLOPs of one TF train step (fwd + bwd where trained)."""
    enc = convnext_train_flops(
        image_size, depths, dims, train_encoder, starting_layer
    )
    dd = DecoderDims(
        vocab_size=vocab_size,
        embed_dim=embed_dim,
        decoder_dim=decoder_dim,
        num_layers=num_layers,
        seq_len=seq_len,
        mem_len=encoded_image_size * encoded_image_size,
        encoder_dim=dims[-1],
    )
    if decoder in ("transformer", "transformer_attvis"):
        dec = transformer_forward_flops(dd)
    else:
        dec = lstm_forward_flops(dd, attention=(decoder == "lstm"))
    return batch_size * (enc + 3 * dec)


def eval_step_flops(
    batch_size: int,
    vocab_size: int,
    decoder: str = "transformer",
    image_size: int = 256,
    depths: Sequence[int] = (3, 3, 27, 3),
    dims: Sequence[int] = (128, 256, 512, 1024),
    decode_len: int = 51,
    embed_dim: int = 512,
    decoder_dim: int = 512,
    num_layers: int = 6,
    encoded_image_size: int = 7,
) -> int:
    """Model FLOPs of one greedy KV-cached rollout eval batch (useful-math
    convention: each new token attends to its prefix, so attention scores are
    counted at L^2/2; projections/FFN once per generated token)."""
    enc = convnext_forward_flops(image_size, depths, dims)
    L, M, e, f, V = (
        decode_len,
        encoded_image_size * encoded_image_size,
        embed_dim,
        decoder_dim,
        vocab_size,
    )
    if decoder in ("transformer", "transformer_attvis"):
        dec = 2 * M * dims[-1] * e
        per_layer = (
            4 * 2 * L * e * e
            + 2 * L * L * e  # causal prefix: L^2/2 keys x2 (scores+values)
            + 2 * 2 * L * e * e
            + 2 * 2 * M * e * e
            + 2 * 2 * L * M * e
            + 2 * 2 * L * e * f
        )
        dec += num_layers * per_layer + 2 * L * e * V
    else:
        dd = DecoderDims(
            vocab_size=vocab_size, embed_dim=e, decoder_dim=f,
            seq_len=L, mem_len=M, encoder_dim=dims[-1],
        )
        dec = lstm_forward_flops(dd, attention=(decoder == "lstm"))
    return batch_size * (enc + dec)


def mfu(model_flops: int, sec: float, dtype: str = "float32", device_name: Optional[str] = None) -> Optional[float]:
    """Model-FLOPs utilization in [0,1] of a step computing in ``dtype``;
    None when the card's peak is unknown or ``sec <= 0``."""
    peak = peak_flops_per_chip(dtype, device_name)
    if not peak or sec <= 0:
        return None
    return model_flops / sec / peak
