"""The port's frozen-encoder teacher-forced train step against the JAX
package's ``make_train_step``, and the pieces it runs.

The whole-step comparison feeds both packages the same dropout bits: the
JAX model draws with ``dropout_masks='pool'`` and its ``random_mask_pool``
is replaced, inside the test, by one returning a numpy bit array; the port's
pool returns the same bits.  Both encoders run in eval mode through a
test-local patch of each model's ``encode`` (stochastic-depth draws cannot
be shared across the two generators; it is held separately below).
Tolerances:
- loss and top-5 count 1e-5: f32 sums of 30-odd token losses;
- clamped gradients rtol 1e-4, atol 1e-6: f32 backward in two frameworks;
- Adam's first moment and the updated decoder parameters atol 1e-2 * lr,
  except where a gradient is below 1e-7: there Adam turns float noise into
  a step of +-lr, so no tolerance below 2 * lr would hold;
- the square root of Adam's second moment, on every element, at the
  gradients' rtol and their atol times sqrt(1 - b2^2): the bound that
  gradients within those tolerances imply;
- encoder parameters bit-identical to their start (frozen).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_helpers import (
    IMAGE_SIZE,
    SMALL,
    START,
    END,
    images,
    jax_model_and_params,
    port_model,
    t,
    to_numpy,
)
from tpu_captioner_torch.core import prng
from tpu_captioner_torch.core.config import TrainConfig
from tpu_captioner_torch.models.from_jax import state_dict_from_jax
from tpu_captioner_torch.train.model import CaptionModel
from tpu_captioner_torch.train.state import TrainState
from tpu_captioner_torch.train.steps import make_train_step, pool_demand

B = 3
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
WORD_IDS = {"<pad>": 0, "<unk>": 54, "<start>": START, "<end>": END}


def make_batch(seed=0):
    """Captions <start> words <end> <pad>...; the last row is batch padding
    (valid False) with a real caption."""
    rng = np.random.default_rng(seed)
    length = SMALL["max_len"]
    caplens = np.array([7, length, 10], np.int32)
    caps = np.zeros((B, length), np.int32)
    for i, n in enumerate(caplens):
        caps[i, 0], caps[i, n - 1] = START, END
        caps[i, 1 : n - 1] = rng.integers(1, 54, n - 2)
    return {
        "images": images(B, seed=seed + 1), "captions": caps, "caplens": caplens,
        "valid": np.array([True, True, False]),
    }


def adam_moments(opt_state):
    """(mu, nu) of the optax Adam inside an inject_hyperparams chain."""
    todo = [opt_state]
    while todo:
        s = todo.pop()
        if hasattr(s, "mu") and hasattr(s, "nu"):
            return s.mu, s.nu
        if hasattr(s, "inner_state"):
            todo.append(s.inner_state)
        elif isinstance(s, tuple):
            todo.extend(s)
    raise AssertionError("no Adam state found")


def decoder_sd(params, dec_tree, cfg):
    """A JAX decoder-shaped tree in the port's state-dict names and layouts."""
    sd = state_dict_from_jax({"encoder": params["encoder"], "decoder": to_numpy(dec_tree)}, cfg)
    return {k[len("decoder."):]: v for k, v in sd.items() if k.startswith("decoder.")}


def test_frozen_step_matches_jax(monkeypatch):
    from tpu_captioner.core.config import TrainConfig as JaxTrainConfig
    from tpu_captioner.train import steps as jax_steps
    from tpu_captioner.train.model import CaptionModel as JaxCaptionModel
    from tpu_captioner.train.state import TrainState as JaxTrainState
    from tpu_captioner.train.state import make_optimizer

    jmodel, params = jax_model_and_params(seed=4, dropout_masks="pool", use_pallas="off")
    model = port_model(params)
    cfg = model.cfg
    batch = make_batch()
    side = SMALL["encoded_image_size"]
    n = pool_demand(cfg, B, SMALL["max_len"], side * side)
    bits = np.random.default_rng(11).random(n) < 1.0 - cfg.dropout

    def jax_pool(key, count, keep, *, on_tpu):
        assert count == n and abs(keep - 0.5) < 1e-9
        return jnp.asarray(bits)

    monkeypatch.setattr("tpu_captioner.ops.dropout_mask.random_mask_pool", jax_pool)
    monkeypatch.setattr(
        "tpu_captioner_torch.ops.dropout_mask.random_mask_pool",
        lambda words, count, keep, device: t(bits[:count]).to(device),
    )
    jmodel.encode = lambda params, images_u8, deterministic=True, rng=None: (
        JaxCaptionModel.encode(jmodel, params, images_u8, deterministic=True)
    )
    model.encode = lambda images_u8, train=False, generator=None: CaptionModel.encode(
        model, images_u8
    )

    tc = TrainConfig(batch_size=B)
    lr = tc.decoder_lr
    jtc = JaxTrainConfig(batch_size=B)
    dec_opt, enc_opt = make_optimizer(jtc.decoder_lr, jtc.grad_clip), make_optimizer(jtc.encoder_lr, jtc.grad_clip)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params), dec_opt, enc_opt)
    jstep = jax_steps.make_train_step(jmodel, jtc, WORD_IDS, dec_opt, enc_opt)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    # The clamped gradients of the first step, computed apart (JAX's step
    # does not return them).
    def dec_loss(dec_params):
        p = {"encoder": jstate.params["encoder"], "decoder": dec_params}
        return jax_steps.tf_loss(jmodel, p, jbatch, jtc.alpha_c, jax.random.PRNGKey(0), False)

    jgrads, _ = jax.grad(dec_loss, has_aux=True)(jstate.params["decoder"])
    jgrads = decoder_sd(params, jax.tree_util.tree_map(lambda g: jnp.clip(g, -5.0, 5.0), jgrads), cfg)

    state = TrainState.create(model, tc)
    step = make_train_step(model, tc, WORD_IDS)
    pbatch = {k: t(v) for k, v in batch.items()}
    enc_before = {k: v.clone() for k, v in model.encoder.state_dict().items()}
    root = prng.root_seed(tc.seed)
    grads = []
    for i in range(2):
        jstate, jm = jstep(jstate, jbatch, jax.random.PRNGKey(i))
        state, m = step(state, pbatch, prng.step_seed(root, "dropout", 0, i))
        assert abs(float(m["loss"]) - float(jm["loss"])) < 1e-5
        assert float(m["top5_correct"]) == float(jm["top5_correct"])
        assert float(m["tokens"]) == float(jm["tokens"]) == 6 + 15
        grads.append({k: p.grad.clone() for k, p in model.decoder.named_parameters()})
    assert state.step == 2

    for k, g in grads[0].items():
        np.testing.assert_allclose(g.numpy(), jgrads[k].numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)

    jmu, jnu = (decoder_sd(params, tree, cfg) for tree in adam_moments(jstate.dec_opt_state))
    jparams = decoder_sd(params, jstate.params["decoder"], cfg)
    checked = total = 0
    for k, p in model.decoder.named_parameters():
        sure = (grads[0][k].abs() >= 1e-7) & (grads[1][k].abs() >= 1e-7)
        st = state.dec_opt.state[p]
        for got, want in ((st["exp_avg"], jmu[k]), (p.detach(), jparams[k])):
            err = (got - want).abs()[sure]
            assert err.numel() == 0 or err.max().item() <= 1e-2 * lr, k
        # The second moment is ~1e-3 g^2, far below 1e-2 * lr for most
        # elements.  sqrt(nu) = sqrt(1 - b2) * |(sqrt(b2) g1, g2)|, so the
        # gradients' tolerance carries over to it exactly.
        np.testing.assert_allclose(
            st["exp_avg_sq"].sqrt().numpy(), jnu[k].sqrt().numpy(),
            rtol=GRAD_RTOL, atol=np.sqrt(1 - 0.999**2) * GRAD_ATOL, err_msg=k,
        )
        checked, total = checked + int(sure.sum()), total + p.numel()
    assert checked > total // 4  # the unused embedding rows have no gradient
    for k, v in model.encoder.state_dict().items():
        assert torch.equal(v, enc_before[k]), k
    assert not any(p.requires_grad for p in model.encoder.parameters())


@pytest.mark.parametrize("dropout_masks", ["pool", "threefry"])
def test_step_is_reproducible_from_its_seed(dropout_masks):
    """Two models from one seed, stepped with one step seed, stay equal; a
    different step seed gives another loss (other masks)."""
    _, params = jax_model_and_params(seed=5)
    batch = {k: t(v) for k, v in make_batch(seed=3).items()}
    tc = TrainConfig(batch_size=B)
    losses = []
    for seed in (17, 17, 18):
        model = port_model(params, dropout_masks=dropout_masks)
        state, step = TrainState.create(model, tc), make_train_step(model, tc, WORD_IDS)
        state, m = step(state, batch, prng.step_seed(prng.root_seed(0), "dropout", 0, seed))
        assert np.isfinite(float(m["loss"]))
        losses.append((float(m["loss"]), model.decoder.fc_out.weight.detach().clone()))
    assert losses[0][0] == losses[1][0] and torch.equal(losses[0][1], losses[1][1])
    assert losses[0][0] != losses[2][0]


def test_frozen_pretrained_embedding_stays_fixed():
    _, params = jax_model_and_params(seed=6)
    model = port_model(params, embedding_path="unused.npz", fine_tune_embeddings=False)
    tc = TrainConfig(batch_size=B)
    state, step = TrainState.create(model, tc), make_train_step(model, tc, WORD_IDS)
    before = model.decoder.embedding.weight.detach().clone()
    step(state, {k: t(v) for k, v in make_batch().items()}, 99)
    assert torch.equal(model.decoder.embedding.weight.detach(), before)
    assert not torch.equal(model.decoder.fc_out.bias.detach(), t(params["decoder"]["fc_out"]["b"]))


# -- stochastic depth -----------------------------------------------------


def small_features():
    _, params = jax_model_and_params(seed=7)
    return params, port_model(params)


def test_stochastic_depth_survival_and_scale():
    _, model = small_features()
    feats = model.encoder.convnext
    probs = feats.sd_probs
    assert probs[0] == 0.0 and abs(probs[-1] - 0.5) < 1e-12 and len(probs) == 5
    gen = torch.Generator().manual_seed(0)
    draws = 4000
    rows = feats.draw_sd(draws, gen)
    for p, r in zip(probs, rows):
        survival = 1.0 - p
        kept = r != 0
        assert torch.allclose(r[kept], torch.full_like(r[kept], 1.0 / survival))
        freq = kept.double().mean().item()
        assert abs(freq - survival) <= 5 * np.sqrt(max(survival * p, 1e-12) / draws) + 1e-12


def test_block_with_zero_sd_returns_its_input():
    _, model = small_features()
    blk = model.encoder.convnext[1][0]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 8, 8, 8)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(blk(x, torch.zeros(2)), x)
        assert not torch.equal(blk(x, torch.ones(2)), x)


def test_training_encoder_matches_jax_block_math():
    """Stem, downsamples and pool through the JAX package's modules; each
    block through its plain math (tpu_captioner/models/convnext.py:174-180)
    with sd rows drawn from numpy and handed to both packages."""
    from tpu_captioner.models.convnext import Downsample, Stem, adaptive_avg_pool_nhwc
    from tpu_captioner.models.encoder import preprocess_images as jax_preprocess
    from tpu_captioner.models.layers import layer_norm as jax_ln
    from tpu_captioner.ops.dwconv import depthwise_conv7x7_nhwc
    from tpu_captioner_torch.models.encoder import preprocess_images

    params, model = small_features()
    f = params["encoder"]["convnext"]
    depths, dims = SMALL["encoder_depths"], SMALL["encoder_dims"]
    rng = np.random.default_rng(12)
    sd_rows = [
        np.where(rng.random(2) < 1 - p, 1.0 / (1 - p), 0.0).astype(np.float32)
        for p in model.encoder.convnext.sd_probs
    ]
    sd_rows[2][:] = [0.0, 1.0 / (1 - model.encoder.convnext.sd_probs[2])]  # one drop, one keep

    def jax_block(bp, x, sd):
        d = x.shape[-1]
        h = depthwise_conv7x7_nhwc(x, bp["dwconv"]["kernel"].reshape(7, 7, d), False) + bp["dwconv"]["bias"]
        y = jax_ln(bp["LayerNorm_0"], h, eps=1e-6)
        y = jax.nn.gelu(y @ bp["pw1"]["kernel"] + bp["pw1"]["bias"], approximate=False)
        y = (y @ bp["pw2"]["kernel"] + bp["pw2"]["bias"]) * bp["layer_scale"]
        return x + y * sd[:, None, None, None]

    imgs = images(2, seed=8)
    x = Stem(dims[0]).apply({"params": f["features_0"]}, jax_preprocess(imgs))
    k = 0
    for s, depth in enumerate(depths):
        if s:
            x = Downsample(dims[s]).apply({"params": f[f"features_{2 * s}"]}, x)
        blocks = f[f"features_{2 * s + 1}"]["blocks"]
        for b in range(depth):
            x = jax_block(jax.tree_util.tree_map(lambda a: jnp.asarray(a)[b], blocks), x, sd_rows[k])
            k += 1
    want = np.asarray(adaptive_avg_pool_nhwc(x, SMALL["encoded_image_size"]))
    with torch.no_grad():
        got = model.encoder(preprocess_images(t(imgs)), [t(r) for r in sd_rows]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# -- metrics, seeds, config -------------------------------------------------


def test_metrics_match_jax_with_ties():
    from tpu_captioner.eval.metrics import masked_cross_entropy as jax_ce
    from tpu_captioner.eval.metrics import topk_correct as jax_topk
    from tpu_captioner_torch.eval.metrics import masked_cross_entropy, topk_correct

    rng = np.random.default_rng(3)
    logits = rng.integers(-3, 4, (4, 6, 11)).astype(np.float32)  # many ties
    logits[0, 0] = 0.0  # a row of equal logits
    targets = rng.integers(0, 11, (4, 6)).astype(np.int32)
    mask = rng.random((4, 6)) < 0.7
    ce, n = masked_cross_entropy(t(logits), t(targets), t(mask))
    jce, jn = jax_ce(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask))
    assert abs(ce.item() - float(jce)) < 1e-4 and n.item() == float(jn)
    for k in (1, 5):
        for m in (None, mask):
            got = topk_correct(t(logits), t(targets), k, None if m is None else t(m)).item()
            want = int(jax_topk(jnp.asarray(logits), jnp.asarray(targets), k,
                                None if m is None else jnp.asarray(m)))
            assert got == want


def test_step_seed_is_deterministic_and_distinct():
    root = prng.root_seed(42)
    assert root == prng.root_seed(42) != prng.root_seed(43)
    seeds = {
        prng.step_seed(root, purpose, epoch, step)
        for purpose in prng.PURPOSES for epoch in range(3) for step in range(50)
    }
    assert len(seeds) == len(prng.PURPOSES) * 3 * 50
    assert prng.step_seed(root, "dropout", 1, 2) == prng.step_seed(root, "dropout", 1, 2)
    assert prng.step_seed(root, "dropout", 1, 2, host=1) != prng.step_seed(root, "dropout", 1, 2)
    w0, w1 = prng.seed_words(prng.step_seed(root, "dropout", 0, 0))
    assert 0 <= w0 < 2**32 and 0 <= w1 < 2**32
    g1, g2 = (prng.generator(root) for _ in range(2))
    assert torch.equal(torch.rand(5, generator=g1), torch.rand(5, generator=g2))


def test_train_config_defaults_match_jax():
    import dataclasses

    from tpu_captioner.core.config import TrainConfig as JaxTrainConfig

    ours = dataclasses.asdict(TrainConfig())
    assert ours == dataclasses.asdict(JaxTrainConfig())


def test_train_mode_encode_needs_a_generator():
    _, model = small_features()
    imgs = t(images(1))
    with pytest.raises(ValueError, match="generator"):
        model.encode(imgs, train=True)
    a = model.encode(imgs, train=True, generator=torch.Generator().manual_seed(1))
    b = model.encode(imgs, train=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.shape == (1, 2, 2, SMALL["encoder_dim"])
    assert IMAGE_SIZE == 64


@pytest.mark.parametrize("decoder,attvis_reg", [("transformer", False), ("transformer_attvis", True)])
def test_eval_loss_matches_jax(decoder, attvis_reg):
    """``tf_loss`` without dropout or stochastic depth, with the attention
    regulariser on the attvis family, against the JAX package's."""
    from tpu_captioner.train.steps import tf_loss as jax_tf_loss
    from tpu_captioner_torch.train.steps import tf_loss

    jmodel, params = jax_model_and_params(seed=8, decoder=decoder, use_pallas="off")
    model = port_model(params, decoder=decoder)
    batch = make_batch(seed=5)
    jloss, jm = jax_tf_loss(jmodel, params, {k: jnp.asarray(v) for k, v in batch.items()},
                            1.0, None, True, attvis_reg)
    with torch.no_grad():
        loss, m = tf_loss(model, {k: t(v) for k, v in batch.items()}, 1.0, False, None, attvis_reg)
    assert abs(loss.item() - float(jloss)) < 1e-5
    assert m["top5_correct"].item() == int(jm["top5_correct"]) and m["tokens"].item() == float(jm["tokens"])


def test_lr_helpers_and_zero_frozen():
    from tpu_captioner_torch.train.state import get_lr, scale_lr, zero_frozen

    _, model = small_features()
    state = TrainState.create(model, TrainConfig(decoder_lr=2e-4))
    assert get_lr(state.dec_opt) == 2e-4
    scale_lr(state.dec_opt, 0.8)
    assert abs(get_lr(state.dec_opt) - 1.6e-4) < 1e-12
    for p in model.decoder.parameters():
        p.grad = torch.ones_like(p)
    zero_frozen(model.decoder, {"fc_out.weight": False})
    assert not model.decoder.fc_out.weight.grad.any() and model.decoder.fc_out.bias.grad.all()
