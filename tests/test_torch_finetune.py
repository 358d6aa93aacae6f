"""The port's fine-tune train step (``train_encoder=True``) against the JAX
package's, and the pieces it adds: ``fine_tune_mask``, the encoder's
gradients through the fused tail's backward, and remat.

The whole-step comparison follows ``test_frozen_step_matches_jax``: both
packages take the same dropout bits (a numpy bit array as both pools), and
both encoders run deterministically (no stochastic-depth draw) through a
test-local patch that keeps their gradients flowing.  ``starting_layer`` is 5
(the reference's best-BLEU setting): features_5, 6 and 7 train.
Tolerances:
- loss and top-5 1e-5: f32 sums of 30-odd token losses;
- clamped gradients of step 1, decoder and encoder, rtol 1e-4, atol 1e-6:
  an f32 backward in two frameworks, through at most three ConvNeXt blocks;
  the encoder-only gradients back to the stem (five blocks, three
  downsamples) rtol 1e-4 and atol 1e-5 times each tensor's largest value;
- Adam's first moment and the updated parameters atol 1e-2 * lr where both
  steps' gradients are at least 1e-7 (below that Adam turns float noise into
  a step of +-lr); the square root of the second moment at the gradients'
  tolerances (its exact image of them);
- the children below ``starting_layer`` bit-identical to their start.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_helpers import (
    SMALL,
    images,
    jax_model_and_params,
    port_model,
    t,
    to_numpy,
)
from tests.test_torch_train_step import B, WORD_IDS, adam_moments, decoder_sd, make_batch
from tpu_captioner_torch.core import prng
from tpu_captioner_torch.core.config import ModelConfig, TrainConfig
from tpu_captioner_torch.models.encoder import fine_tune_mask, preprocess_images
from tpu_captioner_torch.models.from_jax import state_dict_from_jax
from tpu_captioner_torch.train.model import CaptionModel, finetune_encoder_remat
from tpu_captioner_torch.train.state import TrainState
from tpu_captioner_torch.train.steps import make_train_step, pool_demand

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
START = 5


def encoder_sd(params, enc_tree, cfg):
    """A JAX encoder-shaped tree in the port's encoder state-dict names and layouts."""
    sd = state_dict_from_jax({"encoder": to_numpy(enc_tree), "decoder": params["decoder"]}, cfg)
    return {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}


def child(name):
    return int(name.split(".")[1])


# -- fine_tune_mask -------------------------------------------------------------


@pytest.mark.parametrize("fine_tune,starting_layer", [(True, 0), (True, 5), (True, 7), (False, 5)])
def test_fine_tune_mask_matches_jax(fine_tune, starting_layer):
    from tpu_captioner.models.encoder import fine_tune_mask as jax_mask

    _, params = jax_model_and_params(seed=1)
    model = port_model(params)
    jm = jax_mask(params["encoder"], fine_tune, starting_layer)
    as_arrays = jax.tree_util.tree_map(
        lambda p, m: np.full(np.shape(p), float(m), np.float32), params["encoder"], jm
    )
    want = encoder_sd(params, as_arrays, model.cfg)
    got = fine_tune_mask(model.encoder, fine_tune, starting_layer)
    assert set(got) == set(want)
    for name, flag in got.items():
        assert torch.all(want[name] == float(flag)), name
    assert any(got.values()) == fine_tune


def test_fine_tune_mask_defaults_to_the_last_stage():
    model = port_model(jax_model_and_params(seed=1)[1])
    mask = fine_tune_mask(model.encoder)
    assert {child(n) for n, on in mask.items() if on} == {7}


# -- encoder gradients ------------------------------------------------------------


def test_encoder_gradients_match_jax_block_math():
    """Gradients of every encoder parameter through the stem, the fused
    tails' backward and the downsamples, with numpy-drawn sd rows (one image
    dropped and one kept at a block), against ``jax.grad`` of the JAX
    package's stem and downsample modules and its plain block math
    (tpu_captioner/models/convnext.py:174-180); then with ``grad_from=5``:
    only children 5-7 get gradients, the same ones."""
    from tpu_captioner.models.convnext import Downsample, Stem, adaptive_avg_pool_nhwc
    from tpu_captioner.models.encoder import preprocess_images as jax_preprocess
    from tpu_captioner.models.layers import layer_norm as jax_ln
    from tpu_captioner.ops.dwconv import depthwise_conv7x7_nhwc

    _, params = jax_model_and_params(seed=7)
    model = port_model(params)
    depths, dims = SMALL["encoder_depths"], SMALL["encoder_dims"]
    rng = np.random.default_rng(12)
    probs = model.encoder.convnext.sd_probs
    sd_rows = [np.where(rng.random(2) < 1 - p, 1.0 / (1 - p), 0.0).astype(np.float32) for p in probs]
    sd_rows[3][:] = [0.0, 1.0 / (1 - probs[3])]  # one drop, one keep in stage 3
    imgs = images(2, seed=8)
    cot = np.random.default_rng(13).standard_normal((2, 2, 2, SMALL["encoder_dim"])).astype(np.float32)

    def jax_block(bp, x, sd):
        d = x.shape[-1]
        h = depthwise_conv7x7_nhwc(x, bp["dwconv"]["kernel"].reshape(7, 7, d), False) + bp["dwconv"]["bias"]
        y = jax_ln(bp["LayerNorm_0"], h, eps=1e-6)
        y = jax.nn.gelu(y @ bp["pw1"]["kernel"] + bp["pw1"]["bias"], approximate=False)
        y = (y @ bp["pw2"]["kernel"] + bp["pw2"]["bias"]) * bp["layer_scale"]
        return x + y * sd[:, None, None, None]

    def jax_loss(f):
        x = Stem(dims[0]).apply({"params": f["features_0"]}, jax_preprocess(jnp.asarray(imgs)))
        k = 0
        for s, depth in enumerate(depths):
            if s:
                x = Downsample(dims[s]).apply({"params": f[f"features_{2 * s}"]}, x)
            for b in range(depth):
                bp = jax.tree_util.tree_map(lambda a: a[b], f[f"features_{2 * s + 1}"]["blocks"])
                x = jax_block(bp, x, jnp.asarray(sd_rows[k]))
                k += 1
        return jnp.sum(adaptive_avg_pool_nhwc(x, SMALL["encoded_image_size"]) * cot)

    jgrads = jax.grad(jax_loss)(jax.tree_util.tree_map(jnp.asarray, params["encoder"]["convnext"]))
    want = encoder_sd(params, {"convnext": jgrads}, model.cfg)

    x = preprocess_images(t(imgs))
    for grad_from in (None, START):
        model.encoder.zero_grad(set_to_none=True)
        out = model.encoder(x, [t(r) for r in sd_rows], grad_from=grad_from)
        out.backward(t(cot))
        for name, p in model.encoder.named_parameters():
            if grad_from is not None and child(name) < grad_from:
                assert p.grad is None, name
                continue
            # Back to the stem the gradients pass five blocks and three
            # downsamples: atol follows each tensor's own scale.
            scale = max(1.0, want[name].abs().max().item())
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                       rtol=GRAD_RTOL, atol=1e-5 * scale, err_msg=name)


# -- the whole step ---------------------------------------------------------------


def test_fine_tune_step_matches_jax(monkeypatch):
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

    monkeypatch.setattr("tpu_captioner.ops.dropout_mask.random_mask_pool",
                        lambda key, count, keep, *, on_tpu: jnp.asarray(bits))
    monkeypatch.setattr("tpu_captioner_torch.ops.dropout_mask.random_mask_pool",
                        lambda words, count, keep, device: t(bits[:count]).to(device))
    jmodel.encode = lambda params, images_u8, deterministic=True, rng=None: (
        JaxCaptionModel.encode(jmodel, params, images_u8, deterministic=True)
    )
    model.encode_fine_tune = lambda images_u8, starting_layer, generator=None: (
        CaptionModel.encode_fine_tune(model, images_u8, starting_layer)
    )

    tc = TrainConfig(batch_size=B)
    assert tc.starting_layer == START and tc.encoder_lr == tc.decoder_lr
    lr = tc.decoder_lr
    jtc = JaxTrainConfig(batch_size=B)
    dec_opt, enc_opt = make_optimizer(jtc.decoder_lr, jtc.grad_clip), make_optimizer(jtc.encoder_lr, jtc.grad_clip)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params), dec_opt, enc_opt)
    jstep = jax_steps.make_train_step(jmodel, jtc, WORD_IDS, dec_opt, enc_opt, train_encoder=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    # The clamped gradients of the first step, computed apart.
    def loss(p):
        return jax_steps.tf_loss(jmodel, p, jbatch, jtc.alpha_c, jax.random.PRNGKey(0), False)

    jgrads, _ = jax.grad(loss, has_aux=True)(jstate.params)
    jgrads = jax.tree_util.tree_map(lambda g: jnp.clip(g, -5.0, 5.0), jgrads)
    want_grads = {
        "encoder": encoder_sd(params, jgrads["encoder"], cfg),
        "decoder": decoder_sd(params, jgrads["decoder"], cfg),
    }

    state = TrainState.create(model, tc)
    step = make_train_step(model, tc, WORD_IDS, train_encoder=True)
    pbatch = {k: t(v) for k, v in batch.items()}
    enc_before = {k: v.clone() for k, v in model.encoder.state_dict().items()}
    root = prng.root_seed(tc.seed)
    parts = {"encoder": model.encoder, "decoder": model.decoder}
    grads = []
    for i in range(2):
        jstate, jm = jstep(jstate, jbatch, jax.random.PRNGKey(i))
        state, m = step(state, pbatch, prng.step_seed(root, "dropout", 0, i))
        assert abs(float(m["loss"]) - float(jm["loss"])) < 1e-5
        assert float(m["top5_correct"]) == float(jm["top5_correct"])
        assert float(m["tokens"]) == float(jm["tokens"]) == 6 + 15
        grads.append({part: {k: p.grad.clone() for k, p in mod.named_parameters() if p.grad is not None}
                      for part, mod in parts.items()})
    assert state.step == 2

    trained = {k for k in grads[0]["encoder"]}
    assert trained == {k for k, _ in model.encoder.named_parameters() if child(k) >= START}
    for part in parts:
        for k, g in grads[0][part].items():
            np.testing.assert_allclose(g.numpy(), want_grads[part][k].numpy(),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=f"{part}.{k}")

    jparams = {"encoder": encoder_sd(params, jstate.params["encoder"], cfg),
               "decoder": decoder_sd(params, jstate.params["decoder"], cfg)}
    moments = {"encoder": [encoder_sd(params, tr, cfg) for tr in adam_moments(jstate.enc_opt_state)],
               "decoder": [decoder_sd(params, tr, cfg) for tr in adam_moments(jstate.dec_opt_state)]}
    opts = {"encoder": state.enc_opt, "decoder": state.dec_opt}
    for part, mod in parts.items():
        jmu, jnu = moments[part]
        checked = total = 0
        for k, p in mod.named_parameters():
            if k not in grads[0][part]:
                continue
            sure = (grads[0][part][k].abs() >= 1e-7) & (grads[1][part][k].abs() >= 1e-7)
            st = opts[part].state[p]
            for got, want in ((st["exp_avg"], jmu[k]), (p.detach(), jparams[part][k])):
                err = (got - want).abs()[sure]
                assert err.numel() == 0 or err.max().item() <= 1e-2 * lr, f"{part}.{k}"
            np.testing.assert_allclose(
                st["exp_avg_sq"].sqrt().numpy(), jnu[k].sqrt().numpy(),
                rtol=GRAD_RTOL, atol=np.sqrt(1 - 0.999**2) * GRAD_ATOL, err_msg=f"{part}.{k}",
            )
            checked, total = checked + int(sure.sum()), total + p.numel()
        assert checked > total // 4, part

    for k, v in model.encoder.state_dict().items():
        if child(k) < START:
            assert torch.equal(v, enc_before[k]), k
            assert torch.equal(v, jparams["encoder"][k]), k
        else:
            assert not torch.equal(v, enc_before[k]), k


def small_step_run(encoder_remat, steps=2, seed=5):
    """Loss and parameters after ``steps`` fine-tune steps with stochastic
    depth and dropout drawn from the step seeds."""
    _, params = jax_model_and_params(seed=seed)
    model = port_model(params, encoder_remat=encoder_remat)
    tc = TrainConfig(batch_size=B)
    state, step = TrainState.create(model, tc), make_train_step(model, tc, WORD_IDS, train_encoder=True)
    batch = {k: t(v) for k, v in make_batch(seed=3).items()}
    losses = []
    for i in range(steps):
        state, m = step(state, batch, prng.step_seed(prng.root_seed(0), "dropout", 0, i))
        losses.append(float(m["loss"]))
    return losses, {k: v.clone() for k, v in model.state_dict().items()}


def test_remat_on_and_off_give_the_same_step():
    """Recomputing the blocks' forwards in the backward changes no bit."""
    on_losses, on_params = small_step_run("on")
    for mode in ("off", "save_mlp_in"):
        losses, params = small_step_run(mode)
        assert losses == on_losses and np.isfinite(losses).all()
        for k, v in params.items():
            assert torch.equal(v, on_params[k]), (mode, k)


def test_remat_policy_and_config():
    assert finetune_encoder_remat("auto", "float32") == "off"
    for mode in ("on", "off", "save_mlp_in"):
        assert finetune_encoder_remat(mode, "float32") == mode
    with pytest.raises(ValueError, match="encoder_remat"):
        ModelConfig(encoder_remat="sometimes")


def test_fine_tune_encode_stops_gradients_below_the_starting_layer():
    """``encode_fine_tune`` builds a graph only from the starting child on;
    plain ``encode`` builds none; stages under no_grad ignore remat."""
    model = port_model(jax_model_and_params(seed=2)[1], encoder_remat="on")
    imgs = t(images(2, seed=4))
    out = model.encode_fine_tune(imgs, START, generator=torch.Generator().manual_seed(0))
    out.sum().backward()
    for name, p in model.encoder.named_parameters():
        assert (p.grad is not None) == (child(name) >= START), name
    with torch.no_grad():
        same = model.encode_fine_tune(imgs, START)
    assert not model.encode(imgs).requires_grad and not same.requires_grad
    assert torch.equal(same, model.encode(imgs))
