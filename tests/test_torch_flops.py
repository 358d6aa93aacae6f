"""The port's model-FLOP counts and MFU (``tpu_captioner_torch/eval/flops.py``)
against the JAX package's ``eval/flops.py``.

- Every count equals the JAX module's exactly, as an integer, over a grid of
  decoder families, encoder training, image sizes, batches, vocabularies,
  decode lengths and memory sizes.
- The peak table is keyed by the card's name: the H100 SXM part's dense
  bf16 rate and the f32-accurate tensor-core rate (TF32 / 3) are the
  denominators; the PCIe and NVL parts, other cards and no card give None;
  a dtype with no denominator raises.
- ``mfu`` is None for an unknown card or a non-positive time, else the
  quotient.
- ``chip_smoke.py``'s rates are the table's.
"""

import itertools
import os
import sys

import pytest
import torch

from tpu_captioner.eval import flops as jax_flops
from tpu_captioner_torch.eval import flops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SXM = "NVIDIA H100 80GB HBM3"
FAMILIES = ("transformer", "transformer_attvis", "lstm", "lstm_no_attention")
IMAGE_SIZES, BATCHES, VOCABS = (224, 256), (1, 32), (2633, 9490)


def _same(got, want):
    assert type(got) is int and got == want, (got, want)


@pytest.mark.parametrize("decoder", FAMILIES)
def test_train_step_flops_equal_jax(decoder):
    for train_encoder, start, size, bs, vocab in itertools.product(
            (False, True), (0, 5, 7), IMAGE_SIZES, BATCHES, VOCABS):
        kw = dict(decoder=decoder, image_size=size, train_encoder=train_encoder, starting_layer=start)
        _same(flops.train_step_flops(bs, vocab, **kw), jax_flops.train_step_flops(bs, vocab, **kw))
    tiny = dict(decoder=decoder, image_size=32, depths=(1, 1, 1, 1), dims=(8, 12, 16, 24), seq_len=14,
                embed_dim=16, decoder_dim=20, num_layers=2, encoded_image_size=2, train_encoder=True)
    _same(flops.train_step_flops(8, 100, **tiny), jax_flops.train_step_flops(8, 100, **tiny))


@pytest.mark.parametrize("decoder", FAMILIES)
def test_eval_step_flops_equal_jax(decoder):
    for decode_len, mem, size, bs, vocab in itertools.product((1, 51), (7, 14), IMAGE_SIZES, BATCHES, VOCABS):
        kw = dict(decoder=decoder, image_size=size, decode_len=decode_len, encoded_image_size=mem)
        _same(flops.eval_step_flops(bs, vocab, **kw), jax_flops.eval_step_flops(bs, vocab, **kw))


@pytest.mark.parametrize("size", (32, 224, 256))
def test_convnext_flops_equal_jax(size):
    for depths, dims in (((3, 3, 27, 3), (128, 256, 512, 1024)), ((1, 2, 1, 1), (8, 12, 16, 24))):
        stages = flops.convnext_forward_flops(size, depths, dims, per_stage=True)
        assert stages == jax_flops.convnext_forward_flops(size, depths, dims, per_stage=True)
        assert len(stages) == 8 and all(type(s) is int and s > 0 for s in stages)
        _same(flops.convnext_forward_flops(size, depths, dims), jax_flops.convnext_forward_flops(size, depths, dims))
        for train_encoder, start in itertools.product((False, True), (0, 5, 7)):
            _same(flops.convnext_train_flops(size, depths, dims, train_encoder, start),
                  jax_flops.convnext_train_flops(size, depths, dims, train_encoder, start))


def test_decoder_forward_flops_equal_jax():
    for vocab, seq_len, mem, att in itertools.product(VOCABS, (1, 52), (49, 196), (256, 512)):
        kw = dict(vocab_size=vocab, seq_len=seq_len, mem_len=mem, attention_dim=att)
        ours, theirs = flops.DecoderDims(**kw), jax_flops.DecoderDims(**kw)
        _same(flops.transformer_forward_flops(ours), jax_flops.transformer_forward_flops(theirs))
        for attention in (False, True):
            _same(flops.lstm_forward_flops(ours, attention), jax_flops.lstm_forward_flops(theirs, attention))


def test_peaks_by_card_name():
    assert flops.peak_flops_per_chip("bfloat16", SXM) == 989e12
    assert flops.peak_flops_per_chip("float32", SXM) == 165e12 == 495e12 / 3
    assert flops.peak_flops_per_chip(device_name=SXM) == 165e12  # f32 by default
    rates = flops.PEAK_FLOPS[SXM]
    assert (rates["tf32"], rates["float32_ffma"], rates["hbm_bytes_per_s"]) == (495e12, 67e12, 3.35e12)
    for other in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL", "NVIDIA A100-SXM4-80GB", ""):
        for dtype in flops.COMPUTE_DTYPES:
            assert flops.peak_flops_per_chip(dtype, other) is None, other


def test_no_card_and_unknown_dtype(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dtype in flops.COMPUTE_DTYPES:
        assert flops.peak_flops_per_chip(dtype) is None
    assert flops.mfu(1e12, 0.01) is None
    for dtype in ("float16", "tf32", "highest", "default"):
        with pytest.raises(ValueError, match="dtype"):
            flops.peak_flops_per_chip(dtype, SXM)
        with pytest.raises(ValueError, match="dtype"):
            flops.mfu(1e12, 0.01, dtype, SXM)


def test_mfu():
    step = flops.train_step_flops(32, 9490)
    assert flops.mfu(step, 0.1, "float32", SXM) == step / 0.1 / 165e12
    assert flops.mfu(step, 0.1, "bfloat16", SXM) == step / 0.1 / 989e12
    for sec in (0.0, -1.0):
        assert flops.mfu(step, sec, "float32", SXM) is None
    assert flops.mfu(step, 0.1, "float32", "NVIDIA H100 PCIe") is None


def test_chip_smoke_rates_are_the_table():
    sys.path.insert(0, ROOT)
    import chip_smoke

    rates = flops.PEAK_FLOPS[SXM]
    assert chip_smoke.HBM_BYTES_PER_S == rates["hbm_bytes_per_s"] == 3.35e12
    assert chip_smoke.F32_OPS_PER_S == rates["float32_ffma"] == 67e12
    assert chip_smoke.TF32_OPS_PER_S == rates["tf32"] == 495e12
    assert chip_smoke.F32_PRODUCT_OPS_PER_S == rates["float32"] == 495e12 / 3
    assert chip_smoke.BF16_OPS_PER_S == rates["bfloat16"] == 989e12
    assert chip_smoke.BF16_BY_F32_OPS_PER_S == rates["bfloat16"] / 3 == 989e12 / 3
