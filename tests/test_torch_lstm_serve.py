"""The LSTM families' serving path against the JAX package, on the CPU:
batched beam search with both adapters, the reference-checkpoint round trip
through JAX ``port_reference_checkpoint``, and ``cli/caption.py``'s loader.

The model is ``tests/test_torch_helpers.py``'s ``SMALL`` with the decoder
family overridden and an attention width of 20.  Tolerances: sequences and
lengths exact, beam scores and maps 1e-4 (log-probs summed over up to 10
steps in two frameworks), weights bit for bit.
"""

import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_helpers import SMALL, images, jax_model_and_params, port_model, to_numpy
from tpu_captioner.infer.beam import beam_search_batch as jax_beam_search_batch
from tpu_captioner.models.port_torch import port_reference_checkpoint
from tpu_captioner_torch.core.config import ModelConfig
from tpu_captioner_torch.infer.beam import beam_search_batch
from tpu_captioner_torch.models.from_jax import (
    load_reference_checkpoint,
    save_reference_checkpoint,
    state_dict_from_jax,
)
from tpu_captioner_torch.train.model import CaptionModel

KINDS = ("lstm", "lstm_no_attention")
ATT = 20  # attention width
START, END = 55, 56  # of SMALL's vocab 57


def close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def small(kind):
    return dict(SMALL, decoder=kind, attention_dim=ATT)


@pytest.fixture(scope="module", params=KINDS)
def served(request):
    """JAX model and params of ``SMALL`` with the family, images, and JAX's
    beam results with the natural <end> and with an end id its beams emit."""
    kind = request.param
    jmodel, params = jax_model_and_params(seed=3, decoder=kind, attention_dim=ATT, decode_kernel="off",
                                          use_pallas="off")
    imgs = images(2, seed=9)
    run = lambda end_id: [np.asarray(x) for x in jax_beam_search_batch(  # noqa: E731
        jmodel, params, jnp.asarray(imgs), beam_size=3, max_steps=9, start_id=START, end_id=end_id)]
    natural = run(END)
    emitted = int(np.bincount(natural[0][:, 1:].ravel()).argmax())
    return kind, params, imgs, {END: natural, emitted: run(emitted)}


@pytest.mark.parametrize("decode_kernel", ["on", "off"])
def test_beam_matches_jax(served, decode_kernel):
    """Both adapters of the family ('on': ``fused_lstm_step``, its plain
    version on the CPU; 'off': the plain step) against JAX's batched beam
    (its plain step: ``tests/test_lstm_kernel.py`` holds its kernel path
    to it)."""
    kind, params, imgs, runs = served
    model = port_model(params, decoder=kind, attention_dim=ATT, decode_kernel=decode_kernel)
    for end_id, (seq, length, alphas, score) in runs.items():
        res = beam_search_batch(model, torch.from_numpy(imgs), beam_size=3, max_steps=9,
                                start_id=START, end_id=end_id)
        np.testing.assert_array_equal(res.sequence.numpy(), seq)
        np.testing.assert_array_equal(res.length.numpy(), length)
        close(res.score, score, 0, 1e-4)
        close(res.alphas, alphas, 0, 1e-4)
        if kind == "lstm_no_attention":
            assert not res.alphas.any()
    assert any((r[1] < 11).any() for r in runs.values())  # some beam completed before the cap


@pytest.mark.parametrize("kind", KINDS)
def test_reference_checkpoint_round_trip(tmp_path, kind):
    """The port's ``.pth.tar`` read by JAX ``port_reference_checkpoint`` gives
    params that bridge back unchanged; the port's loader reads it too."""
    cfg = ModelConfig(**small(kind))
    model = CaptionModel(cfg, device="cpu", seed=21)
    path = str(tmp_path / "BEST_checkpoint_lstm.pth.tar")
    save_reference_checkpoint(model, path, epoch=2)
    enc_p, dec_p, meta = port_reference_checkpoint(path, kind, depths=cfg.encoder_depths)
    assert meta["epoch"] == 2
    back = state_dict_from_jax(to_numpy({"encoder": enc_p, "decoder": dec_p}), cfg)
    want = model.state_dict()
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    other = CaptionModel(cfg, device="cpu", seed=22)
    load_reference_checkpoint(other, path)
    assert all(torch.equal(other.state_dict()[k], v) for k, v in want.items())


@pytest.mark.parametrize("flags", [dict(lstmDecoder=True, decoder=None),
                                   dict(lstmDecoder=False, decoder="lstm_no_attention")])
def test_cli_loader_builds_and_captions(tmp_path, monkeypatch, flags):
    """``cli/caption.py``'s loader builds the family its flags name from a
    reference checkpoint and captions a group of images on the CPU."""
    from tpu_captioner_torch.cli import caption
    from tpu_captioner_torch.core import config

    kind = flags["decoder"] or "lstm"
    widths = small(kind)
    model = CaptionModel(ModelConfig(**widths), device="cpu", seed=5)
    path = str(tmp_path / "BEST_checkpoint_cli.pth.tar")
    save_reference_checkpoint(model, path)
    # The loader builds ModelConfig's full widths; here the small ones.
    monkeypatch.setattr(config, "ModelConfig", lambda **kw: ModelConfig(**{**widths, **kw}))
    args = argparse.Namespace(checkpoint=path, embeddingName=None, device="cpu", seed=1, **flags)
    word_map = {f"w{i}": i for i in range(START)}
    word_map.update({"<start>": START, "<end>": END})
    loaded = caption.build_model_and_params(args, word_map)
    assert loaded.cfg.decoder == kind
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in model.state_dict().items())
    for cap, score, seq, alpha in caption.caption_batch(loaded, images(2, seed=4), word_map, 3):
        assert seq[0] == START and np.isfinite(score) and isinstance(cap, str)
        assert alpha.shape == (len(seq), widths["encoded_image_size"] ** 2)
