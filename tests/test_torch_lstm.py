"""The port's two LSTM decoders against the JAX package's, on the CPU:
teacher forcing, the plain and kernel-mode greedy rollouts, scheduled
sampling; and the family-aware decode-kernel choice.

The widths are ``tests/test_lstm_kernel.py``'s odd small ones
(``tests/test_torch_lstm_step.py:DECODER``).  Tolerances: logits 2e-5 (f32
sums of up to 96 products per step, carried through the recurrence), maps
rtol 2e-5 and atol 2e-6, sequences exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_helpers import t, to_numpy
from tests.test_torch_lstm_step import DECODER
from tpu_captioner.core.config import ModelConfig as JaxModelConfig
from tpu_captioner.models.lstm import DecoderWithAttention as JaxDecoderWithAttention
from tpu_captioner.models.lstm import DecoderWithoutAttention as JaxDecoderWithoutAttention
from tpu_captioner_torch.core.config import DECODE_KERNEL_MODES, ModelConfig
from tpu_captioner_torch.models import transformer
from tpu_captioner_torch.models.from_jax import _lstm_decoder_from_jax
from tpu_captioner_torch.models.lstm import DecoderWithAttention, DecoderWithoutAttention
from tpu_captioner_torch.train.model import decode_kernel_mode

KINDS = ("lstm", "lstm_no_attention")
B, STEPS = 4, 10
START, END = 59, 60  # of DECODER's vocab 61


def close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module", params=KINDS)
def decoders(request):
    """(kind, JAX decoder, its params as jnp arrays, the port's decoder on
    the same weights, an encoder output, an end id the rows emit)."""
    kind = request.param
    cfg = dict(DECODER, decoder=kind)
    jcls, cls = {"lstm": (JaxDecoderWithAttention, DecoderWithAttention),
                 "lstm_no_attention": (JaxDecoderWithoutAttention, DecoderWithoutAttention)}[kind]
    jdec = jcls(JaxModelConfig(**cfg))
    params = to_numpy(jdec.init_params(jax.random.PRNGKey(1)))
    dec = cls(ModelConfig(**cfg), device="cpu")
    dec.load_state_dict(_lstm_decoder_from_jax(params))
    enc = np.random.default_rng(9).standard_normal((B, 2, 2, DECODER["encoder_dim"])).astype(np.float32)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    seqs = jax_rollout(kind, jdec, p, enc, END, STEPS)[1]
    emitted = int(np.bincount(np.asarray(seqs).ravel()).argmax())
    return kind, jdec, p, dec, enc, emitted


def jax_rollout(kind, jdec, p, enc, end_id, steps, **kw):
    """JAX ``rollout(deterministic=True)`` as (logits, seqs, maps or None)."""
    out = jdec.rollout(p, jnp.asarray(enc), START, end_id, steps, deterministic=True, **kw)
    return (out[0], out[2], out[1]) if kind == "lstm" else (out[0], out[1], None)


def assert_rollouts_agree(got, want):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].dtype == torch.int32
    close(got[0], want[0], 2e-5, 2e-5)
    if want[2] is None:
        assert got[2] is None
    else:
        close(got[2], want[2], 2e-5, 2e-6)


def test_tf_forward_matches_jax(decoders):
    kind, jdec, p, dec, enc, _ = decoders
    caps = np.random.default_rng(3).integers(1, DECODER["vocab_size"], (B, 9)).astype(np.int32)
    want = jdec.tf_forward(p, jnp.asarray(enc), jnp.asarray(caps), deterministic=True)
    with torch.no_grad():
        logits, alphas = dec.tf_forward(t(enc), t(caps).long())
    if kind == "lstm":
        want, want_alphas = want
        close(alphas, want_alphas, 2e-5, 2e-6)
    else:
        assert alphas is None
    assert logits.shape == (B, 8, DECODER["vocab_size"])
    close(logits, want, 2e-5, 2e-5)


@pytest.mark.parametrize("end", ["natural", "emitted"])
@pytest.mark.parametrize("form", ["rollout", "fused_rollout"])
def test_rollouts_match_jax(decoders, form, end):
    """The plain rollout against JAX ``rollout``; the kernel rollout (its
    plain step on the CPU) against JAX ``fused_rollout``, interpreted with
    f32 products.  With the natural <end> and with one the rows emit."""
    kind, jdec, p, dec, enc, emitted = decoders
    if form == "fused_rollout" and kind != "lstm":
        assert not hasattr(dec, "fused_rollout")  # no kernel without attention
        return
    end_id = END if end == "natural" else emitted
    if form == "rollout":
        want = jax_rollout(kind, jdec, p, enc, end_id, STEPS)
    else:
        out = jdec.fused_rollout(p, jnp.asarray(enc), START, end_id, STEPS, interpret=True, precise=True)
        want = (out[0], out[2], out[1])
    with torch.inference_mode():
        got = getattr(dec, form)(t(enc), START, end_id, STEPS)
    assert_rollouts_agree(got, want)
    if end == "emitted":
        assert (np.asarray(want[1]) == 0).any()  # a row finished: its later steps are zeroed


@pytest.mark.parametrize("form", ["rollout", "fused_rollout"])
def test_teacher_mix_matches_jax(decoders, monkeypatch, form):
    """Scheduled sampling with JAX's per-step masks handed to the port."""
    kind, jdec, p, dec, enc, emitted = decoders
    if form == "fused_rollout" and kind != "lstm":
        return
    rng = jax.random.PRNGKey(11)
    teacher = np.random.default_rng(13).integers(1, DECODER["vocab_size"], (B, STEPS + 1)).astype(np.int32)
    rngs = jax.random.split(rng, STEPS)
    mask = np.array(jax.vmap(lambda k: jax.random.bernoulli(jax.random.fold_in(k, 1), 0.5, (B,)))(rngs))
    kw = dict(rng=rng, teacher_tokens=jnp.asarray(teacher), teacher_prob=0.5)
    if form == "rollout":
        want = jax_rollout(kind, jdec, p, enc, emitted, STEPS, **kw)
    else:
        out = jdec.fused_rollout(p, jnp.asarray(enc), START, emitted, STEPS, interpret=True, precise=True, **kw)
        want = (out[0], out[2], out[1])
    monkeypatch.setattr(transformer, "teacher_masks", lambda gen, n, b, prob, dev: t(mask[:n]).to(dev))
    with torch.inference_mode():
        got = getattr(dec, form)(t(enc), START, emitted, STEPS, generator=torch.Generator(),
                                 teacher_tokens=t(teacher), teacher_prob=0.5)
    assert_rollouts_agree(got, want)


def test_decode_kernel_mode_knows_the_family():
    """``'auto'`` is JAX's ``'off'`` for ``lstm``; every other mode but
    ``'off'`` selects its step kernel; ``lstm_no_attention`` has none."""
    lstm = {m: decode_kernel_mode(m, "lstm") for m in DECODE_KERNEL_MODES}
    assert lstm == {"auto": "off", "on": "step", "step": "step", "mega": "step", "off": "off"}
    assert {decode_kernel_mode(m, "lstm_no_attention") for m in DECODE_KERNEL_MODES} == {"off"}
    with pytest.raises(ValueError):
        decode_kernel_mode("onecell", "lstm")
