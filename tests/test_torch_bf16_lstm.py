"""The LSTM families in bf16 (``compute_dtype='bfloat16'``) against the JAX
package's bf16 arms, on the CPU.

- The LSTM step's bf16 instance: its plain version
  (``_lstm_step_plain_bf16``) against JAX ``fused_lstm_step(interpret=True,
  precise=False)`` on ``cast_lstm_weight_matrices(w, bfloat16)`` with bf16
  emb, enc and att1, at ``tests/test_torch_lstm_step.py``'s odd widths, 1
  and 5 rows and 5 pixels: alpha within 1e-5, h and c within 2e-3 x max(1,
  max |JAX|) (a one-ulp flip of the bf16-rounded context, whose f32 value
  is summed in another order, moves a gate; measured 6.0e-8).  The
  wrapper takes exactly its two dtype sets; ``lstm_plan`` at 2 bytes an
  element.
- The models, both families, on the JAX bf16 model's weights and JAX's bf16
  encoder output (``tests/test_torch_helpers.py``'s small configuration,
  attention width 20): the teacher-forced logits and the greedy ``'off'``
  rollout, both plain f32 decoders on the bf16 features, within 1e-4 x
  max(1, max |JAX|) with equal sequences; for ``lstm`` the kernel-mode
  rollout (the bf16 instance's plain version) against JAX's
  ``fused_rollout(precise=False)``: sequences equal except after a
  near-tie, logits and maps within 2e-3 x max(1, max |JAX|) up to a row's
  first difference.
- The beam: the port's ``'off'`` beam against JAX's ``'off'`` beam on the
  same features (sequences and lengths equal, scores within 1e-4); the
  kernel-mode beam's per-step cell against JAX's
  ``fused_lstm_step(precise=False)`` on the beam's own states, as the step
  above.  JAX's LSTM beam on the CPU takes its kernel with bf16 storage and
  ``precise=True`` (tpu_captioner/infer/beam.py:209), neither of the
  port's arms, so the beam is held through its cell.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_helpers import images, jax_model_and_params, port_model, t
from tests.test_torch_lstm_plan import MODEL, ODD, SMS, assert_plan_covers
from tests.test_torch_lstm_step import DECODER, decoders  # noqa: F401 (a fixture)
from tpu_captioner.infer.beam import _beam_batched as jax_beam_batched
from tpu_captioner.models.layers import linear as jax_linear
from tpu_captioner.ops.lstm_step import cast_lstm_weight_matrices as jax_cast_lstm_weight_matrices
from tpu_captioner.ops.lstm_step import fused_lstm_step as jax_fused_lstm_step
from tpu_captioner.ops.lstm_step import prepare_lstm_weights as jax_prepare_lstm_weights
from tpu_captioner_torch.infer.beam import _lstm_attention_beam, beam_search_encoded
from tpu_captioner_torch.ops.lstm_step import (
    SMEM_LIMIT,
    STAGE,
    TILE,
    _lstm_step_plain_bf16,
    cast_lstm_weight_matrices,
    fused_lstm_step,
    lstm_plan,
    prepare_lstm_weights,
)

BF = torch.bfloat16
REL = 2e-3
ATT = 20
START, END = 55, 56  # of SMALL's vocab 57
STEPS = 10


def to_bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32))).to(BF)


def jnp_bf16(x: torch.Tensor):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


def rel_err(got, want) -> float:
    want = np.asarray(want, dtype=np.float32)
    return float(np.abs(np.asarray(got, dtype=np.float32) - want).max() / max(1.0, np.abs(want).max()))


def jax_bf16_step(params):
    """JAX's bf16 instance on its kernel-layout weights (interpret mode)."""
    jw = jax_cast_lstm_weight_matrices(
        jax_prepare_lstm_weights(jax.tree_util.tree_map(jnp.asarray, params), DECODER["embed_dim"]), jnp.bfloat16)
    return lambda emb, h, c, enc, att1: jax_fused_lstm_step(
        jw, jnp_bf16(emb), jnp.asarray(h.numpy()), jnp.asarray(c.numpy()), jnp_bf16(enc), jnp_bf16(att1),
        interpret=True, precise=False)


@pytest.mark.parametrize("rows", [1, 5])
def test_bf16_step_plain_matches_jax_kernel(decoders, rows):  # noqa: F811
    """Measured: alpha within 3.0e-8, h and c within 6.0e-8 of max(1,
    max |JAX|) at 1 and at 5 rows (no bf16 flip at these inputs)."""
    _, params, dec = decoders
    rng = np.random.default_rng(rows + 40)
    P, C, D = 5, DECODER["encoder_dim"], DECODER["decoder_dim"]
    enc = to_bf16(rng.standard_normal((rows, P, C)))
    att1 = to_bf16(jax_linear(params["attention"]["encoder_att"], jnp.asarray(enc.float().numpy())))
    emb = to_bf16(params["embedding"][rng.integers(1, DECODER["vocab_size"], rows)])
    h, c = (t((0.5 * rng.standard_normal((rows, D))).astype(np.float32)) for _ in range(2))
    want = jax_bf16_step(params)(emb, h, c, enc, att1)
    with torch.no_grad():
        w = cast_lstm_weight_matrices(prepare_lstm_weights(dec), BF)
        got = _lstm_step_plain_bf16(w, emb, h, c, enc, att1)
        before = fused_lstm_step.launches, fused_lstm_step.bf16_launches
        again = fused_lstm_step(w, emb, h, c, enc, att1)
    assert (fused_lstm_step.launches, fused_lstm_step.bf16_launches) == before
    assert all(g.dtype == torch.float32 and torch.equal(g, a) for g, a in zip(got, again))
    assert np.abs(got[2].numpy() - np.asarray(want[2])).max() < 1e-5
    for g, w_ in zip(got[:2], want[:2]):
        assert rel_err(g.numpy(), w_) <= REL


def test_bf16_weights_are_jax_casts(decoders):  # noqa: F811
    """``cast_lstm_weight_matrices``: the five matrices in bf16 (JAX's,
    transposed), wfull and the biases f32, unchanged."""
    _, params, dec = decoders
    jw = jax_cast_lstm_weight_matrices(
        jax_prepare_lstm_weights(jax.tree_util.tree_map(jnp.asarray, params), DECODER["embed_dim"]), jnp.bfloat16)
    w = cast_lstm_weight_matrices(prepare_lstm_weights(dec), BF)
    for name in ("wd", "wfb", "w_ih_e", "w_ih_c", "w_hh"):
        assert getattr(w, name).dtype == BF
        np.testing.assert_array_equal(getattr(w, name).float().numpy(),
                                      np.asarray(getattr(jw, name).astype(jnp.float32)).T, err_msg=name)
    for name in ("bd", "wfull", "bfull", "bfb", "b"):
        assert getattr(w, name).dtype == torch.float32 and getattr(jw, name).dtype == jnp.float32, name


def test_step_takes_exactly_two_dtype_sets(decoders):  # noqa: F811
    """f32 everything, or the bf16 set (the five matrices, emb, enc, att1 in
    bf16; h, c, wfull and the biases f32); anything else raises ValueError
    on the CPU as on the card."""
    _, _, dec = decoders
    R, P = 2, 4
    E, D, C, A = (DECODER[k] for k in ("embed_dim", "decoder_dim", "encoder_dim", "attention_dim"))
    w32 = prepare_lstm_weights(dec)
    act = (torch.zeros(R, E), torch.zeros(R, D), torch.zeros(R, D), torch.zeros(R, P, C), torch.zeros(R, P, A))
    with torch.no_grad():
        fused_lstm_step(w32, *act)
        wbf = cast_lstm_weight_matrices(w32, BF)
        bf_act = (act[0].to(BF), act[1], act[2], act[3].to(BF), act[4].to(BF))
        fused_lstm_step(wbf, *bf_act)
        with pytest.raises(ValueError, match="enc must be torch.bfloat16"):
            fused_lstm_step(wbf, bf_act[0], act[1], act[2], act[3], bf_act[4])
        with pytest.raises(ValueError, match="h must be torch.float32"):
            fused_lstm_step(wbf, bf_act[0], act[1].to(BF), *bf_act[2:])
        with pytest.raises(ValueError, match="emb must be torch.float32"):
            fused_lstm_step(w32, bf_act[0], *act[1:])
        with pytest.raises(ValueError, match="no instance"):
            fused_lstm_step(cast_lstm_weight_matrices(w32, torch.float16), *(a.half() for a in act))


@pytest.mark.parametrize("R", [1, 32, 40, 160])
@pytest.mark.parametrize("widths", [MODEL, *ODD])
def test_bf16_plan_covers_every_column_and_fits(R, widths):
    """``lstm_plan`` at 2 bytes an element: the f32 plan's rows, splits
    and work (every column and K stage owned once), its ring stages and
    w_ih_c share at half the bytes and one B plane, at least as many ring
    slots, within a block's shared memory."""
    E, D, A, C, P = widths
    plan, f32 = lstm_plan(R, E, D, A, C, P, SMS, esize=2), lstm_plan(R, E, D, A, C, P, SMS)
    assert_plan_covers(plan, R, E, D, A, C, P)
    assert plan[:4] == f32[:4] and plan.wc_stages == f32.wc_stages and plan.stages >= f32.stages
    slot = 2 * TILE * STAGE + 4 * plan.rows * STAGE
    assert plan.smem == 1024 + 2 * TILE * STAGE * plan.wc_stages + 8 * 9 + 16 + plan.stages * slot <= SMEM_LIMIT
    with pytest.raises(ValueError, match="4 or 2 bytes"):
        lstm_plan(R, E, D, A, C, P, SMS, esize=1)


# -- the models ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def bf16_model(kind):
    """(kind, JAX bf16 model, its params, JAX's bf16 encoder output of 3
    images)."""
    jmodel, params = jax_model_and_params(seed=6, decoder=kind, attention_dim=ATT, use_pallas="off",
                                          decode_kernel="off", compute_dtype="bfloat16")
    enc = jmodel.encode(params, jnp.asarray(images(3, seed=12)))
    assert enc.dtype == jnp.bfloat16
    return kind, jmodel, params, enc


@pytest.fixture(scope="module", params=["lstm", "lstm_no_attention"])
def bf16_lstm(request):
    return bf16_model(request.param)


def port(params, kind, mode):
    return port_model(params, decoder=kind, attention_dim=ATT, use_pallas="off", decode_kernel=mode,
                      compute_dtype="bfloat16")


def enc_t(enc) -> torch.Tensor:
    return to_bf16(np.asarray(enc.astype(jnp.float32)))


def assert_rollouts_agree(got, want, tol):
    """Per row: tokens equal up to the first difference, a near-tie of
    JAX's logits (within ``tol``); logits (and maps) within ``tol`` x
    max(1, max |JAX|) up to it."""
    (gl, gs, ga), (wl, ws, wa) = got, want
    wl, ws = np.asarray(wl), np.asarray(ws)
    scale = max(1.0, np.abs(wl).max())
    for r in range(ws.shape[0]):
        diff = np.nonzero(gs[r].numpy() != ws[r])[0]
        upto = ws.shape[1] if len(diff) == 0 else int(diff[0]) + 1
        if len(diff):
            s = upto - 1
            assert abs(wl[r, s, int(gs[r, s])] - wl[r, s, int(ws[r, s])]) < tol * scale, (r, s)
        assert np.abs(gl[r, :upto].numpy() - wl[r, :upto]).max() <= tol * scale, r
        if wa is not None:
            assert np.abs(ga[r, :upto].numpy() - np.asarray(wa)[r, :upto]).max() <= tol, r


def test_bf16_teacher_forced_logits_match_jax(bf16_lstm):
    """Measured: within 2.2e-8 (``lstm``; its maps 3.0e-8) and 2.6e-8 of
    max(1, max |JAX|)."""
    kind, jmodel, params, enc = bf16_lstm
    caps = np.random.default_rng(3).integers(1, 54, (3, 8)).astype(np.int32)
    caps[:, 0] = START
    want = jmodel.tf_forward(jax.tree_util.tree_map(jnp.asarray, params), enc, jnp.asarray(caps))
    model = port(params, kind, "off")
    with torch.no_grad():
        got = model.tf_forward(enc_t(enc), t(caps))
    assert got[0].dtype == torch.float32 and rel_err(got[0].numpy(), want[0]) <= 1e-4
    if kind == "lstm":
        assert np.abs(got[1].numpy() - np.asarray(want[1])).max() <= 1e-5


@pytest.mark.parametrize("mode", ["off", "on"])
def test_bf16_greedy_rollouts_match_jax(bf16_lstm, mode):
    """``'off'``: the plain decoders against JAX's ``rollout``, 1e-4.
    ``'on'`` (``lstm``: the bf16 instance; ``lstm_no_attention`` has no
    kernel, ``'off'`` again) against JAX's ``fused_rollout(precise=False)``,
    2e-3 and the near-tie rule.  Measured: equal sequences, logits within
    3.0e-8 of max(1, max |JAX|) in ``'off'`` and 2.6e-8 in ``'on'``, maps
    3.0e-8."""
    kind, jmodel, params, enc = bf16_lstm
    p = jax.tree_util.tree_map(jnp.asarray, params["decoder"])
    dec = jmodel.decoder
    fused = mode == "on" and kind == "lstm"
    if fused:
        out = dec.fused_rollout(p, enc, START, END, STEPS, precise=False)
    else:
        out = dec.rollout(p, enc, START, END, STEPS, deterministic=True)
    want = (out[0], out[2], out[1]) if kind == "lstm" else (out[0], out[1], None)
    model = port(params, kind, mode)
    before = fused_lstm_step.bf16_launches
    with torch.inference_mode():
        got = model.rollout(enc_t(enc), START, END, STEPS)
    assert fused_lstm_step.bf16_launches == before  # the plain version on the CPU
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert_rollouts_agree(got, want, REL if fused else 1e-4)
    if not fused:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_bf16_off_beam_matches_jax(bf16_lstm):
    """Beam 3 x 9 in ``'off'`` from the same bf16 features, with the
    natural <end> and with an end id the beams emit.  Measured: scores
    within 3.8e-6, maps 3.0e-8."""
    kind, jmodel, params, enc = bf16_lstm
    model = port(params, kind, "off")
    runs = {}
    for end_id in (END, None):
        if end_id is None:
            end_id = int(np.bincount(runs[END][0][:, 1:].ravel()).argmax())
        runs[end_id] = [np.asarray(x) for x in jax_beam_batched(
            jmodel, jax.tree_util.tree_map(jnp.asarray, params), enc, beam_size=3, max_steps=9, start_id=START,
            end_id=end_id)]
        with torch.inference_mode():
            got = beam_search_encoded(model, enc_t(enc), beam_size=3, max_steps=9, start_id=START, end_id=end_id)
        seq, length, alphas, score = runs[end_id]
        np.testing.assert_array_equal(got.sequence.numpy(), seq)
        np.testing.assert_array_equal(got.length.numpy(), length)
        np.testing.assert_allclose(got.score.numpy(), score, rtol=0, atol=1e-4)
        np.testing.assert_allclose(got.alphas.numpy(), alphas, rtol=0, atol=1e-4)


def test_bf16_kernel_beam_cell_matches_jax_step():
    """The kernel-mode beam (``lstm``; ``lstm_no_attention`` has no kernel)
    over all B x k rows: each step's new h and c against JAX's bf16
    instance on the beam's own previous state, its bf16 features and their
    bf16 projection, the step's tolerances.  Measured over three steps: h
    and c within 4.5e-8 of max(1, max |JAX|), alpha 3.0e-8."""
    kind, jmodel, params, enc = bf16_model("lstm")
    model = port(params, kind, "on")
    k, dec = 3, model.decoder
    jw = jax_cast_lstm_weight_matrices(
        jax_prepare_lstm_weights(jax.tree_util.tree_map(jnp.asarray, params["decoder"]), model.cfg.embed_dim),
        jnp.bfloat16)
    enc_k = jnp.repeat(enc.reshape(enc.shape[0], -1, enc.shape[-1]), k, axis=0)
    att1 = jax_linear(jax.tree_util.tree_map(jnp.asarray, params["decoder"]["attention"]["encoder_att"]), enc_k)
    rng = np.random.default_rng(2)
    with torch.inference_mode():
        step_fn, _, state = _lstm_attention_beam(model, enc_t(enc), k, 9)
        for pos in range(3):
            words = torch.from_numpy(rng.integers(1, 54, (enc.shape[0], k)))
            emb = dec.embedding(words.reshape(-1)).to(BF)
            want = jax_fused_lstm_step(jw, jnp_bf16(emb), jnp.asarray(state[0].numpy()),
                                       jnp.asarray(state[1].numpy()), enc_k, att1.astype(jnp.bfloat16),
                                       interpret=True, precise=False)
            state, _, alpha = step_fn(state, words, pos)
            for g, w_ in zip(state, want[:2]):
                assert rel_err(g.numpy(), w_) <= REL
            assert np.abs(alpha.reshape(-1, alpha.shape[-1]).numpy() - np.asarray(want[2])).max() < 1e-5
