"""The port's greedy eval step and its pieces against the JAX package, on the
same weights (``tests/test_torch_helpers.py``'s small configuration).

Tolerances, with their reasons:
- sequences, lengths, token and top-5 counts: exact (greedy argmax over
  logits that agree to 2e-5, with no near-ties at these seeds);
- logits rtol/atol 2e-5 and attention maps rtol 2e-5, atol 2e-6: f32 decode
  in two frameworks, the tolerances of tests/test_decode_kernel.py;
- the one-cell step's outputs rtol/atol 1e-5 and the caches' new rows the
  same: one f32 decode step;
- the eval loss rtol 1e-5: a mean of f32 token losses;
- BLEU exactly equal: both are the same pure-Python arithmetic.
Scheduled sampling: the port draws its masks from a ``torch.Generator`` and
JAX from threefry, so the test computes JAX's masks and hands them to the
port through ``teacher_masks``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_helpers import (
    END,
    SMALL,
    START,
    images,
    jax_model_and_params,
    port_model,
    t,
)
from tpu_captioner.core.loops import scan_early_exit as jax_scan_early_exit
from tpu_captioner.eval import bleu as jax_bleu
from tpu_captioner.eval.metrics import (
    decode_lengths_from_sequences as jax_lengths,
    rollout_token_mask as jax_rollout_token_mask,
)
from tpu_captioner.ops.decode_step import (
    fused_decode_step as jax_fused_decode_step,
    prepare_cross_memory as jax_prepare_cross_memory,
    prepare_decode_weights as jax_prepare_decode_weights,
)
from tpu_captioner_torch.core.config import TrainConfig
from tpu_captioner_torch.core.loops import scan_early_exit
from tpu_captioner_torch.eval import bleu
from tpu_captioner_torch.eval.metrics import decode_lengths_from_sequences, rollout_token_mask
from tpu_captioner_torch.models import transformer
from tpu_captioner_torch.ops.decode_step import (
    fused_decode_step,
    prepare_cross_memory,
    prepare_decode_weights,
)
from tpu_captioner_torch.train.steps import make_eval_step

B, STEPS = 4, 10
E, H, L = SMALL["embed_dim"], SMALL["num_heads"], SMALL["num_layers"]
WORD_IDS = {"<pad>": 0, "<unk>": 54, "<start>": START, "<end>": END}


def close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def models():
    """JAX and port models that return attention maps, on one set of weights,
    and an encoder output."""
    jmodel, params = jax_model_and_params(seed=5, decoder="transformer_attvis")
    model = port_model(params, decoder="transformer_attvis")
    enc = np.random.default_rng(9).standard_normal((B, 2, 2, SMALL["encoder_dim"])).astype(np.float32)
    p = jax.tree_util.tree_map(jnp.asarray, params["decoder"])
    # An end id the rows emit: the most frequent token of a natural rollout.
    _, seqs, _ = jmodel.decoder.rollout(p, jnp.asarray(enc), START, END, STEPS, deterministic=True)
    emitted = int(np.bincount(np.asarray(seqs).ravel()).argmax())
    return jmodel, p, model, enc, emitted


def jax_teacher(rng, steps, prob=0.5):
    """(teacher tokens (B, STEPS + 1), the (steps, B) masks JAX draws from
    ``rng``, as ``TransformerDecoder.mega_rollout`` computes them)."""
    teacher = np.random.default_rng(13).integers(1, SMALL["vocab_size"], (B, STEPS + 1)).astype(np.int32)
    mask = jax.vmap(lambda s: jax.random.bernoulli(
        jax.random.fold_in(jax.random.fold_in(rng, s), 777), prob, (B,)))(jnp.arange(steps))
    return teacher, np.array(mask)


@pytest.mark.parametrize("end", ["natural", "emitted"])
@pytest.mark.parametrize("form", ["rollout", "fused_rollout", "fused_rollout_one_cell", "mega_rollout"])
def test_rollouts_match_jax_rollout(models, form, end):
    """Each of the port's three rollouts (their plain versions on the CPU)
    against JAX ``rollout(deterministic=True)``, with and without rows that
    finish."""
    jmodel, p, model, enc, emitted = models
    end_id = END if end == "natural" else emitted
    want = jmodel.decoder.rollout(p, jnp.asarray(enc), START, end_id, STEPS, deterministic=True)
    dec = model.decoder
    kw = {"one_cell": True} if form.endswith("one_cell") else {}
    with torch.inference_mode():
        got = getattr(dec, form.replace("_one_cell", ""))(t(enc), START, end_id, STEPS, **kw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].dtype == torch.int32
    close(got[0], want[0], 2e-5, 2e-5)
    close(got[2], want[2], 2e-5, 2e-6)
    if end == "emitted":
        assert (np.asarray(want[1]) == emitted).any(axis=1).any()


@pytest.mark.parametrize("form", ["rollout", "mega_rollout"])
def test_teacher_mix_matches_jax(models, monkeypatch, form):
    """Scheduled sampling: the port's rollout and mega rollout against the
    same JAX form, with JAX's masks handed to the port."""
    jmodel, p, model, enc, emitted = models
    steps = 6
    rng = jax.random.PRNGKey(11)
    teacher, mask = jax_teacher(rng, steps)
    jkw = dict(rng=rng, teacher_tokens=jnp.asarray(teacher), teacher_prob=0.5)
    jdec = jmodel.decoder
    if form == "rollout":
        want = jdec.rollout(p, jnp.asarray(enc), START, emitted, steps, deterministic=True, **jkw)
    else:
        want = jdec.mega_rollout(p, jnp.asarray(enc), START, emitted, steps, interpret=True, **jkw)
    monkeypatch.setattr(transformer, "teacher_masks", lambda gen, n, b, prob, dev: t(mask[:n]).to(dev))
    with torch.inference_mode():
        got = getattr(model.decoder, form)(
            t(enc), START, emitted, steps, generator=torch.Generator(),
            teacher_tokens=t(teacher), teacher_prob=0.5,
        )
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    close(got[0], want[0], 2e-5, 2e-5)
    close(got[2], want[2], 2e-5, 2e-6)


def test_mega_rollout_matches_jax_mega_kernel(models):
    """The port's mega rollout (its plain version on the CPU) against JAX's
    mega kernel in interpret mode."""
    jmodel, p, model, enc, emitted = models
    want = jmodel.decoder.mega_rollout(p, jnp.asarray(enc), START, emitted, STEPS, interpret=True)
    with torch.inference_mode():
        got = model.decoder.mega_rollout(t(enc), START, emitted, STEPS)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    close(got[0], want[0], 2e-5, 2e-5)
    close(got[2], want[2], 2e-5, 2e-6)


@pytest.mark.parametrize("pos", [0, 4])
def test_one_cell_step_matches_jax_one_cell_kernel(models, pos):
    """``fused_decode_step(one_cell=True)`` on the CPU against JAX's one-cell
    kernel in interpret mode, over non-empty caches."""
    jmodel, p, model, enc, _ = models
    T = 6
    rng = np.random.default_rng(pos)
    ck, cv = (rng.standard_normal((L, B, T, E)).astype(np.float32) for _ in range(2))
    toks = rng.integers(1, SMALL["vocab_size"], B)
    jdec = jmodel.decoder
    jmem = jdec._project_memory(p, jnp.asarray(enc))
    jmk, jmv = jax_prepare_cross_memory(p["layers"], jmem, E)
    jx = jdec._embed(p, jnp.asarray(toks, jnp.int32)[:, None], jnp.int32(pos)[None], None, True)[:, 0, :]
    want = jax_fused_decode_step(
        jax_prepare_decode_weights(p["layers"], E), jx, jnp.int32(pos), jnp.asarray(ck), jnp.asarray(cv),
        jmk, jmv, H, interpret=True, one_cell=True,
    )
    dec = model.decoder
    with torch.inference_mode():
        mk, mv = prepare_cross_memory(dec.layers, dec.project_memory(t(enc)), E)
        got = fused_decode_step(
            prepare_decode_weights(dec.layers, E), dec.embed(t(toks), pos), pos, t(ck), t(cv), mk, mv, H,
            one_cell=True,
        )
    for a, b in zip(got, want):
        close(a, b, 1e-5, 1e-5)


def test_scan_early_exit_stops_and_zero_fills():
    def body(c, x):
        return c + 1, (torch.tensor(c + 10 * x),)

    carry, (outs,) = scan_early_exit(body, 0, range(6), lambda c: c >= 3)
    assert carry == 3  # exited after 3 steps, not 6
    assert outs.tolist() == [0, 11, 22, 0, 0, 0]
    _, (want,) = jax_scan_early_exit(
        lambda c, x: (c + 1, (c + 10 * x,)), jnp.int32(0), jnp.arange(6), lambda c: c >= 3
    )
    assert outs.tolist() == np.asarray(want).tolist()


def test_scan_early_exit_runs_full_length_when_never_done():
    carry, (outs,) = scan_early_exit(lambda c, x: (c + 1, (torch.tensor(c),)), 0, range(5), lambda c: False)
    assert carry == 5 and outs.tolist() == [0, 1, 2, 3, 4]
    carry, outs = scan_early_exit(lambda c, x: (c + 1, (torch.tensor(c),)), 0, range(5), lambda c: True)
    assert carry == 0 and outs is None  # no step ran: no shapes to fill


def test_lengths_and_token_mask_match_jax():
    rng = np.random.default_rng(3)
    T, end, pad = 9, 7, 0
    seqs = rng.integers(1, 12, (6, T)).astype(np.int32)
    seqs[0] = 3  # never ends
    caps = rng.integers(0, 12, (6, T + 3)).astype(np.int32)
    valid = np.array([True, True, False, True, True, True])
    np.testing.assert_array_equal(
        decode_lengths_from_sequences(t(seqs), end, T).numpy(), np.asarray(jax_lengths(jnp.asarray(seqs), end, T))
    )
    got = rollout_token_mask(t(seqs), t(caps), end, pad, T, t(valid))
    want = jax_rollout_token_mask(jnp.asarray(seqs), jnp.asarray(caps), end, pad, T, jnp.asarray(valid))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bleu_matches_jax():
    rng = np.random.default_rng(4)
    hyps = [list(rng.integers(1, 9, rng.integers(0, 14))) for _ in range(25)]
    refs = [[list(rng.integers(1, 9, rng.integers(1, 16))) for _ in range(rng.integers(1, 5))] for _ in range(25)]
    assert bleu.bleu_1_to_4(refs, hyps) == jax_bleu.bleu_1_to_4(refs, hyps)
    assert bleu.corpus_bleu(refs[:3], hyps[:3]) == jax_bleu.corpus_bleu(refs[:3], hyps[:3])


@pytest.fixture(scope="module")
def eval_batch():
    """Four images, captions of the configuration's length, the last row
    batch padding (valid False)."""
    rng = np.random.default_rng(21)
    n = SMALL["max_len"]
    caplens = np.array([6, n, 9, 11], np.int32)
    caps = np.zeros((B, n), np.int32)
    for i, k in enumerate(caplens):
        caps[i, 0], caps[i, k - 1] = START, END
        caps[i, 1 : k - 1] = rng.integers(1, 54, k - 2)
    return {"images": images(B, seed=22), "captions": caps, "caplens": caplens,
            "valid": np.array([True, True, True, False])}


@pytest.fixture(scope="module")
def jax_eval(eval_batch):
    """JAX ``make_eval_step`` on one batch, with the natural ``<end>`` and
    with an end id that rows emit, on the default model (no maps)."""
    from tpu_captioner.core.config import TrainConfig as JaxTrainConfig
    from tpu_captioner.train.steps import make_eval_step as jax_make_eval_step

    jmodel, params = jax_model_and_params(seed=6)
    tc = JaxTrainConfig(batch_size=B, max_decode_len=STEPS)
    jbatch = {k: jnp.asarray(v) for k, v in eval_batch.items()}
    first = jax_make_eval_step(jmodel, tc, WORD_IDS)(params, jbatch)
    emitted = int(np.bincount(np.asarray(first["sequences"]).ravel()).argmax())
    ids = dict(WORD_IDS, **{"<end>": emitted})
    second = jax_make_eval_step(jmodel, tc, ids)(params, jbatch)
    return params, {"natural": (WORD_IDS, first), "emitted": (ids, second)}


@pytest.mark.parametrize("end", ["natural", "emitted"])
@pytest.mark.parametrize("mode", ["off", "auto", "mega"])
def test_eval_step_matches_jax(eval_batch, jax_eval, mode, end):
    """The whole eval step in each decode mode (plain versions on the CPU)
    against JAX's, whose CPU default is the plain rollout."""
    params, runs = jax_eval
    word_ids, want = runs[end]
    model = port_model(params, decode_kernel=mode)
    got = make_eval_step(model, TrainConfig(batch_size=B, max_decode_len=STEPS), word_ids)(
        {k: t(v) for k, v in eval_batch.items()}
    )
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    for key in ("tokens", "top5_correct", "sequences", "lengths"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    if end == "emitted":
        assert (got["lengths"] < STEPS).any()  # some row finished early


def test_eval_step_after_a_fine_tune_train_step(eval_batch, jax_eval):
    """``make_train_step(train_encoder=True)`` sets ``requires_grad`` on the
    encoder's trained children; the eval step after it still runs (under
    inference mode) and gives the same metrics as on a fresh model."""
    from tpu_captioner_torch.train.steps import make_train_step

    params, runs = jax_eval
    word_ids, want = runs["natural"]
    model = port_model(params)
    tc = TrainConfig(batch_size=B, max_decode_len=STEPS)
    make_train_step(model, tc, word_ids, train_encoder=True)
    assert any(p.requires_grad for p in model.encoder.parameters())
    got = make_eval_step(model, tc, word_ids)({k: t(v) for k, v in eval_batch.items()})
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(got["sequences"].numpy(), np.asarray(want["sequences"]))


@pytest.mark.parametrize("mode", ["off", "auto", "mega"])
def test_eval_step_matches_jax_at_glove_width(eval_batch, mode):
    """The eval step at the GloVe-200 width (E=200, H=8: head width 25, which
    the decode kernels take with scalar key loads) against JAX's, with an end
    id that rows emit; the port's decode modes run their plain versions on
    the CPU."""
    from tpu_captioner.core.config import TrainConfig as JaxTrainConfig
    from tpu_captioner.train.steps import make_eval_step as jax_make_eval_step

    jmodel, params = jax_model_and_params(seed=6, embed_dim=200, num_heads=8)
    tc = JaxTrainConfig(batch_size=B, max_decode_len=STEPS)
    jbatch = {k: jnp.asarray(v) for k, v in eval_batch.items()}
    first = jax_make_eval_step(jmodel, tc, WORD_IDS)(params, jbatch)
    ids = dict(WORD_IDS, **{"<end>": int(np.bincount(np.asarray(first["sequences"]).ravel()).argmax())})
    want = jax_make_eval_step(jmodel, tc, ids)(params, jbatch)
    model = port_model(params, embed_dim=200, num_heads=8, decode_kernel=mode)
    got = make_eval_step(model, TrainConfig(batch_size=B, max_decode_len=STEPS), ids)(
        {k: t(v) for k, v in eval_batch.items()}
    )
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    for key in ("tokens", "top5_correct", "sequences", "lengths"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert (got["lengths"] < STEPS).any()
