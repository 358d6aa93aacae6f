"""A bf16 ``CaptionModel`` (``compute_dtype='bfloat16'``) against the JAX
package's bf16 model, on the same weights (``tests/test_torch_helpers.py``'s
small configuration, order-one layer scales) and numpy-seeded images.

- The encoder: the port in ``'off'`` against JAX's bf16 encoder, whose
  ``'auto'`` is XLA's block on the CPU; the port in ``'mlp'`` (the fused
  tail's and the depthwise conv's plain versions on the CPU) against JAX's
  ``use_pallas='mlp'`` with its Pallas tail in interpret mode.  Both bf16
  (B, 2, 2, C), within 2^-6 x max(1, max |ref|), four bf16 ulps of the
  largest value: a one-ulp flip in an early block can carry through the
  residuals (measured: one ulp, 2^-9, in one element in ``'off'``; equal in
  ``'mlp'``).
- Beam 3 over 2 images through the decode kernel's bf16 arm (its plain
  version on the CPU) against the JAX package's own ``_beam_loop`` with the
  step of ``_transformer_beam_fused`` at ``dt = bfloat16`` (JAX takes that
  arm on its chip only): the same sequences, or a differing one only where
  the two candidates' prefix scores are within 1e-4; scores within 1e-3
  (measured: the sequences equal at both end ids, scores within 9.8e-4 and
  0).
- The greedy eval step in ``'step'`` (the bf16 arm) against JAX's
  ``fused_rollout(precise=False)`` behind JAX's own eval step, both on
  JAX's bf16 encoder output: loss within 1e-3 relative (measured 0), the
  token and top-5 counts, sequences and lengths equal.
Both model families build in bf16; what bf16 does not serve raises
(``tests/test_torch_no_jax_no_fallback.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_helpers import END, SMALL, START, images, jax_model_and_params, port_model, t
from tpu_captioner.infer.beam import _beam_loop as jax_beam_loop
from tpu_captioner.models.layers import linear as jax_linear
from tpu_captioner.ops.decode_step import (
    apply_cache_update as jax_apply_cache_update,
    cast_weight_matrices as jax_cast_weight_matrices,
    fused_decode_step as jax_fused_decode_step,
    prepare_cross_memory as jax_prepare_cross_memory,
    prepare_decode_weights as jax_prepare_decode_weights,
)
from tpu_captioner_torch.core.config import TrainConfig
from tpu_captioner_torch.infer.beam import beam_search_encoded
from tpu_captioner_torch.train.steps import make_eval_step

BF16 = dict(compute_dtype="bfloat16")
ENC_TOL = 2.0 ** -6
MAX_STEPS, K = 9, 3


def encoder_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want).astype(np.float32)
    return float(np.abs(got.float().numpy() - want).max() / max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("mode", ["off", "mlp"])
def test_bf16_encoder_matches_jax(mode):
    from jax.experimental.pallas import tpu as pltpu

    imgs = images(2, seed=3)
    # init_params runs the encoder too; the interpreted kernel's callbacks
    # do not pass through JAX's remat, which only the fine-tune backward needs.
    with pltpu.force_tpu_interpret_mode():
        jmodel, params = jax_model_and_params(seed=1, use_pallas=mode, encoder_remat="off", **BF16)
        want = jmodel.encode(params, jnp.asarray(imgs))
    assert want.dtype == jnp.bfloat16
    model = port_model(params, use_pallas=mode, **BF16)
    with torch.inference_mode():
        got = model.encode(torch.from_numpy(imgs))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert encoder_err(got, want) <= ENC_TOL


@pytest.fixture(scope="module")
def bf16_models():
    jmodel, params = jax_model_and_params(seed=2, use_pallas="off", **BF16)
    model = port_model(params, use_pallas="off", decode_kernel="on", **BF16)
    enc = jmodel.encode(params, jnp.asarray(images(2, seed=4)))  # bf16 (2, 2, 2, C)
    return jmodel, params, model, enc


def jax_bf16_beam(jmodel, params, enc, end_id):
    """The JAX package's beam loop over the step of its
    ``_transformer_beam_fused`` with the bf16 arm (``dt = bfloat16``,
    ``precise=False``), as it runs on its chip."""
    dec, p, c = jmodel.decoder, jax.tree_util.tree_map(jnp.asarray, params["decoder"]), jmodel.cfg
    B, V, P, E = enc.shape[0], c.vocab_size, c.num_pixels, c.embed_dim
    mem = jnp.repeat(dec._project_memory(p, enc), K, axis=0)
    dt = jnp.bfloat16
    kw = jax_cast_weight_matrices(jax_prepare_decode_weights(p["layers"], E), dt)
    mem_k, mem_v = (m.astype(dt) for m in jax_prepare_cross_memory(p["layers"], mem, E))
    ck0 = jnp.zeros((c.num_layers, B * K, MAX_STEPS + 2, E), dt)

    def step_fn(state, prev_words, pos):
        ck, cv = state
        x = dec._embed(p, prev_words.reshape(-1)[:, None], pos[None], None, True)[:, 0, :]
        x_out, alpha, k_new, v_new = jax_fused_decode_step(
            kw, x.astype(dt), pos, ck, cv, mem_k, mem_v, c.num_heads, interpret=True, precise=False)
        ck, cv = jax_apply_cache_update(ck, cv, k_new, v_new, pos)
        logits = jax_linear(p["fc_out"], x_out.astype(mem.dtype))
        return (ck, cv), logits.reshape(B, K, V), alpha.reshape(B, K, P)

    def gather_fn(state, rows):
        return state[0][:, rows], state[1][:, rows]

    return jax_beam_loop(step_fn, gather_fn, (ck0, jnp.zeros_like(ck0)), B, K, MAX_STEPS, MAX_STEPS + 2, P,
                         START, end_id, V)


def prefix_score(model, enc_1, seq) -> float:
    """A candidate's cumulative log-prob under the port's bf16 arm (the
    beam's own step), one image."""
    from tpu_captioner_torch.infer.beam import _transformer_beam_fused

    step_fn, _, state = _transformer_beam_fused(model, enc_1, 1, len(seq))
    total = 0.0
    for pos in range(len(seq) - 1):
        state, logits, _ = step_fn(state, seq[pos : pos + 1].view(1, 1), pos)
        total += torch.log_softmax(logits.float(), -1)[0, 0, seq[pos + 1]].item()
    return total


@pytest.mark.parametrize("end_id", [END, 50])
def test_bf16_beam_matches_jax_bf16_arm(bf16_models, end_id):
    jmodel, params, model, enc = bf16_models
    want = [np.asarray(v) for v in jax_bf16_beam(jmodel, params, enc, end_id)]
    with torch.inference_mode():
        enc_t = torch.from_numpy(np.asarray(enc).astype(np.float32)).to(torch.bfloat16)
        got = beam_search_encoded(model, enc_t, beam_size=K, max_steps=MAX_STEPS, start_id=START, end_id=end_id)
        for b in range(enc.shape[0]):
            gs, ws = got.sequence[b, : int(got.length[b])], want[0][b, : int(want[1][b])]
            if len(gs) == len(ws) and (gs.numpy() == ws).all():
                assert abs(float(got.score[b]) - float(want[3][b])) < 1e-3
                continue
            step = next(i for i in range(min(len(gs), len(ws))) if gs[i] != ws[i])
            gap = abs(prefix_score(model, enc_t[b : b + 1], gs[: step + 1])
                      - prefix_score(model, enc_t[b : b + 1], torch.from_numpy(ws[: step + 1]).long()))
            assert gap < 1e-4, (b, step, gap)


def test_bf16_eval_step_matches_jax_bf16_rollout(bf16_models, monkeypatch):
    """The eval step's decode in ``'step'``: both steps read JAX's bf16
    encoder output (the encoders are held together above; a one-ulp feature
    difference may flip a near-tie: 1.8e-4 of 2.1 at row 3, step 1, with the
    port's own encoder at this seed)."""
    from tpu_captioner.core.config import TrainConfig as JaxTrainConfig
    from tpu_captioner.train.steps import make_eval_step as jax_make_eval_step

    jmodel, params, _, _ = bf16_models
    jmodel = type(jmodel)(jmodel.cfg.__class__(**{**vars(jmodel.cfg), "decode_kernel": "step"}))
    dec = jmodel.decoder
    monkeypatch.setattr(dec, "fused_rollout", functools.partial(type(dec).fused_rollout, dec, precise=False))
    B, steps = 4, 10
    rng = np.random.default_rng(8)
    batch = {"images": images(B, seed=6),
             "captions": rng.integers(1, SMALL["vocab_size"] - 3, (B, steps + 1)).astype(np.int32),
             "valid": np.array([True, True, True, False])}
    batch["captions"][:, 0] = START
    word_ids = {"<pad>": 0, "<unk>": 54, "<start>": START, "<end>": END}
    want = jax_make_eval_step(jmodel, JaxTrainConfig(batch_size=B, max_decode_len=steps), word_ids)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    enc = np.asarray(jmodel.encode(params, jnp.asarray(batch["images"]))).astype(np.float32)
    model = port_model(params, use_pallas="off", decode_kernel="step", **BF16)
    monkeypatch.setattr(model, "encode", lambda images_u8: torch.from_numpy(enc).to(torch.bfloat16))
    got = make_eval_step(model, TrainConfig(batch_size=B, max_decode_len=steps), word_ids)(
        {k: t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-3)
    for key in ("tokens", "top5_correct", "sequences", "lengths"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("decoder", ["transformer", "transformer_attvis"])
def test_both_transformer_families_build_in_bf16(decoder):
    _, params = jax_model_and_params(seed=0)
    model = port_model(params, decoder=decoder, **BF16)
    assert model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())  # cast at use, as the JAX package
    with torch.inference_mode():
        enc = model.encode(torch.from_numpy(images(1)))
        assert enc.dtype == torch.bfloat16
        assert model.decoder.project_memory(enc).dtype == torch.float32
