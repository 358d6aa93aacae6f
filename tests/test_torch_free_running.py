"""Free-running training: the port's ``rollout_loss`` in its training form and
``make_train_step(teacher_forcing=False)`` against the JAX package's, on the
CPU, for the four decoder families (``tests/test_torch_helpers.py``'s small
configuration; the LSTM families with an attention width of 20).

Both encoders run deterministically through a test-local patch (stochastic
depth cannot be shared across the two generators; it is held in
``tests/test_torch_train_step.py``); the loss tests replace them with one
seeded feature map.  Scheduled sampling: JAX's per-step
teacher masks, recomputed from its own keys, are handed to the port through
``teacher_masks``, as ``tests/test_torch_eval_step.py`` does.  Dropout above
0: JAX's per-site ``bernoulli`` draws are recomputed from its key chain
(``fold_in(rng, t)`` then ``_rng_at``'s ids for the Transformer, the t-th key
of a split for the LSTM) and handed to the port through
``models.layers.draw_mask``, keyed by each draw's ``site``.
Tolerances:
- losses 1e-5: f32 means of 30-odd token losses;
- token and top-5 counts and sequences equal (greedy argmax over logits
  that agree to 1e-5, with no near-tie at these seeds);
- every decoder gradient within 1e-4 x max(1, max |g|) of JAX's: an f32
  backward through a 10-step rollout in two frameworks;
- after one train step, parameters within 1e-2 x lr of JAX's where the
  applied gradient is at least 1e-7 (below that Adam turns float noise into
  a step of +-lr), as the teacher-forced step tests hold them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_helpers import SMALL, jax_model_and_params, port_model, t
from tests.test_torch_train_step import WORD_IDS, decoder_sd, make_batch
from tpu_captioner_torch.core.config import LSTM_DECODERS
from tpu_captioner_torch.models import layers, transformer
from tpu_captioner_torch.train.model import CaptionModel
from tpu_captioner_torch.train.steps import rollout_loss

FAMILIES = ("transformer", "transformer_attvis", "lstm", "lstm_no_attention")
STEPS = 10
ATT = 20
B = 3  # make_batch's rows


def models(kind, seed, dropout=0.0, features=None, **kw):
    """JAX and port models on one set of weights, both encoders
    deterministic; with ``features`` (B, 2, 2, C) both encoders return them
    instead (the decoder's tests need no ConvNeXt pass)."""
    from tpu_captioner.train.model import CaptionModel as JaxCaptionModel

    extra = dict(attention_dim=ATT) if kind in LSTM_DECODERS else {}
    jmodel, params = jax_model_and_params(seed=seed, decoder=kind, use_pallas="off", dropout=dropout, **extra, **kw)
    model = port_model(params, decoder=kind, dropout=dropout, **extra, **kw)
    if features is not None:
        jmodel.encode = lambda p, images_u8, deterministic=True, rng=None: jnp.asarray(features)
        model.encode = lambda images_u8, train=False, generator=None: t(features)
        return jmodel, params, model
    jmodel.encode = lambda p, images_u8, deterministic=True, rng=None: (
        JaxCaptionModel.encode(jmodel, p, images_u8, deterministic=True)
    )
    model.encode = lambda images_u8, train=False, generator=None: CaptionModel.encode(model, images_u8)
    model.encode_fine_tune = lambda images_u8, starting_layer, generator=None: (
        CaptionModel.encode_fine_tune(model, images_u8, starting_layer)
    )
    return jmodel, params, model


def features(seed):
    return np.random.default_rng(seed).standard_normal((B, 2, 2, SMALL["encoder_dim"])).astype(np.float32)


def dec_key(rng):
    """The decoder's key of a JAX training loss (``rollout_loss`` splits its rng)."""
    return jax.random.split(rng)[1]


def jax_teacher_masks(kind, rng, prob):
    """(STEPS, B) bool: JAX's scheduled-sampling draws for the loss key ``rng``."""
    key = dec_key(rng)
    if kind in LSTM_DECODERS:
        keys = jax.random.split(key, STEPS)
        draw = lambda s: jax.random.bernoulli(jax.random.fold_in(keys[s], 1), prob, (B,))  # noqa: E731
    else:
        draw = lambda s: jax.random.bernoulli(  # noqa: E731
            jax.random.fold_in(jax.random.fold_in(key, s), 777), prob, (B,))
    return np.array(jax.vmap(draw)(jnp.arange(STEPS)))


def jax_dropout_draw(kind, rng, cfg, seen):
    """A ``draw_mask`` that returns JAX's mask for each site: the key chain
    of ``tpu_captioner/models/transformer.py:_rng_at`` after
    ``fold_in(rng, t)``, or the LSTM's t-th split key; JAX's mask shapes
    (B, 1, X) and (B, H, 1, Tk) mapped to the port's (B, X) and (B, H, Tk)."""
    key = dec_key(rng)
    keys = jax.random.split(key, STEPS) if kind in LSTM_DECODERS else None

    def draw(shape, keep, generator, device, site):
        seen.append(site)
        step, *ids = site
        if keys is not None:
            assert ids == []
            m = jax.random.bernoulli(keys[step], keep, tuple(shape))
        else:
            k = jax.random.fold_in(key, step)
            for i in ids:
                k = jax.random.fold_in(k, i)
            if ids[0] == 200 and ids[2] == 1:  # self-attention over the whole cache
                m = jax.random.bernoulli(k, keep, (B, cfg.num_heads, 1, STEPS + 1))[:, :, 0, : shape[-1]]
            elif ids[0] == 200 and ids[2] == 3:  # cross-attention over the pixels
                m = jax.random.bernoulli(k, keep, (B, cfg.num_heads, 1, shape[-1]))[:, :, 0]
            else:
                m = jax.random.bernoulli(k, keep, (B, 1, shape[-1]))[:, 0]
        assert tuple(m.shape) == tuple(shape), (site, m.shape, shape)
        return t(np.asarray(m)).to(device)

    return draw


def port_loss(model, batch, prob, seed=7):
    return rollout_loss(model, {k: t(v) for k, v in batch.items()}, WORD_IDS, 1.0, STEPS, train=True,
                        seed=seed, scheduled_sampling_prob=prob)


def jax_loss_and_grads(jmodel, params, batch, rng, prob):
    from tpu_captioner.train.steps import rollout_loss as jax_rollout_loss

    p = jax.tree_util.tree_map(jnp.asarray, params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(dec):
        return jax_rollout_loss(jmodel, {"encoder": p["encoder"], "decoder": dec}, jbatch, WORD_IDS, 1.0, STEPS,
                                rng, False, prob)

    (value, aux), grads = jax.value_and_grad(loss, has_aux=True)(p["decoder"])
    return value, aux, grads


def check_against_jax(model, params, got_loss, got_aux, want, cfg):
    value, aux, jgrads = want
    assert abs(float(got_loss) - float(value)) < 1e-5
    assert float(got_aux["tokens"]) == float(aux["tokens"]) > 0
    assert float(got_aux["top5_correct"]) == float(aux["top5_correct"])
    np.testing.assert_array_equal(got_aux["sequences"].numpy(), np.asarray(aux["sequences"]))
    got_loss.backward()
    want_grads = decoder_sd(params, jgrads, cfg)
    assert set(want_grads) == {k for k, _ in model.decoder.named_parameters()}
    for k, p in model.decoder.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        scale = max(1.0, want_grads[k].abs().max().item())
        np.testing.assert_allclose(g.numpy(), want_grads[k].numpy(), rtol=0, atol=1e-4 * scale, err_msg=k)


@pytest.mark.parametrize("prob", [0.0, 0.5])
@pytest.mark.parametrize("kind", FAMILIES)
def test_training_rollout_loss_matches_jax(monkeypatch, kind, prob):
    """``rollout_loss(train=True)`` without dropout, with and without
    scheduled sampling: loss, counts, sequences and every decoder gradient
    against JAX's ``rollout_loss(deterministic=False)``."""
    jmodel, params, model = models(kind, seed=3, features=features(3))
    batch = make_batch(seed=2)
    rng = jax.random.PRNGKey(5)
    if prob:
        mask = jax_teacher_masks(kind, rng, prob)
        monkeypatch.setattr(transformer, "teacher_masks", lambda gen, n, b, pr, dev: t(mask[:n]).to(dev))
    want = jax_loss_and_grads(jmodel, params, batch, rng, prob)
    loss, aux = port_loss(model, batch, prob)
    assert loss.requires_grad and not aux["loss"].requires_grad
    check_against_jax(model, params, loss, aux, want, model.cfg)


@pytest.mark.parametrize("kind", ["transformer", "lstm"])
def test_rollout_dropout_draws_are_fresh_per_token_and_site(kind):
    """The port's own draws (a generator, no patch): each site's mask keeps
    about half its elements, and the masks of two tokens, or of two layers
    at one site, differ; a second run from the same seed draws the same."""
    _, params, model = models(kind, seed=4, dropout=0.5, features=features(4))
    batch = make_batch(seed=6)
    runs = []
    for _ in range(2):
        drawn = {}
        orig = layers.draw_mask

        def record(shape, keep, generator, device, site):
            drawn[site] = orig(shape, keep, generator, device, site)
            return drawn[site]

        layers.draw_mask = record
        try:
            loss, _ = port_loss(model, batch, 0.0, seed=11)
        finally:
            layers.draw_mask = orig
        runs.append((float(loss), drawn))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(runs[0][1][s], runs[1][1][s]) for s in runs[0][1])
    drawn = runs[0][1]
    kept = torch.cat([m.flatten().float() for m in drawn.values()])
    assert abs(kept.mean().item() - 0.5) < 0.02, kept.mean()
    if kind == "lstm":
        pairs = [((0,), (1,)), ((3,), (7,))]
    else:
        pairs = [((0, 100), (1, 100)), ((2, 200, 0, 6), (2, 200, 1, 6)), ((4, 200, 2, 5, 0), (5, 200, 2, 5, 0))]
    for a, b in pairs:
        assert not torch.equal(drawn[a], drawn[b]), (a, b)


def test_scheduled_sampling_prob_one_is_teacher_forcing():
    """With every input the ground-truth token, the training rollout's
    logits equal the teacher-forced pass inside each caption
    (tests/test_train_loop.py's check, on the port), and gradients flow."""
    _, params, model = models("lstm", seed=2)
    batch = {k: t(v) for k, v in make_batch(seed=4).items()}
    enc = model.encode(batch["images"])
    caps = batch["captions"].long()
    tf_logits, _ = model.tf_forward(enc, caps)
    logits, seqs, _ = model.rollout(enc, 1, 2, STEPS, deterministic=False, generator=torch.Generator(),
                                    teacher_tokens=caps, teacher_prob=1.0)
    for i, n in enumerate(batch["caplens"].tolist()):
        k = min(n - 1, STEPS)
        torch.testing.assert_close(logits[i, :k], tf_logits[i, :k], rtol=0, atol=2e-5)
    logits.sum().backward()
    assert model.decoder.fc.weight.grad.abs().sum() > 0


def test_training_rollout_ignores_the_decode_kernels(monkeypatch):
    """``rollout(deterministic=False)`` takes the plain rollout in every
    decode mode (the kernels are forward only) and needs a generator."""
    import dataclasses

    _, params, model = models("transformer", seed=1, dropout=0.5)
    enc = torch.zeros(2, 4, SMALL["encoder_dim"])
    for mode in ("off", "step", "mega"):
        model.cfg = dataclasses.replace(model.cfg, decode_kernel=mode)
        for name in ("fused_rollout", "mega_rollout"):
            monkeypatch.setattr(model.decoder, name, lambda *a, **k: pytest.fail("kernel rollout in training"))
        logits, seqs, _ = model.rollout(enc, 1, 2, 3, deterministic=False, generator=torch.Generator())
        assert logits.shape == (2, 3, SMALL["vocab_size"]) and logits.requires_grad
        with pytest.raises(ValueError, match="generator"):
            model.rollout(enc, 1, 2, 3, deterministic=False)
