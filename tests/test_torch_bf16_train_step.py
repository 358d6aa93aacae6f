"""bf16 training (``compute_dtype='bfloat16'``): the port's frozen,
fine-tune (``starting_layer`` 5) and free-running steps against the JAX
package's bf16 steps on the same weights (``tests/test_torch_helpers.py``'s
small configuration), with the same dropout bits and no stochastic depth,
as ``tests/test_torch_finetune.py`` holds the f32 step.

The references.  JAX's bf16 loss and gradients come from its own
``tf_loss`` / ``rollout_loss`` under ``jax.jit`` with
``xla_allow_excess_precision`` off: every bf16 op then rounds as written
(by default XLA keeps some fused bf16 intermediates in f32, which changes a
fifth of a bf16 GELU's outputs by an ulp: no port can follow that).  Its
``'mlp'`` blocks run the Pallas kernels in interpret mode.  The f32
reference is the same JAX step on the same weights in f32 (``'off'``).
``mode`` is a ``use_pallas`` value, one for every stage or one per stage
(``tests/test_torch_bf16_block.py`` runs ``'block'`` and a per-stage mix);
JAX's Pallas kernels (the tail, the whole block) run in interpret mode.

The rule: the port must be a bf16 port, not an f32 one.  For the loss
and each trained tensor's gradient (clamped to +-grad_clip), the port's
distance (norm) from the JAX bf16 step is at most half its distance from
the JAX f32 step.  Measured (the smallest ratio of the two distances
over the tensors the rule holds; the loss's): frozen 'off' 813 (the loss
equal to JAX bf16's); fine-tune 'mlp' 43.1 (56.5), 'off' 813 (equal);
free-running fine-tune 'mlp' 411 (equal).

The exception: a gradient that JAX takes by summing a bf16 cotangent over
rows (the transpose of a bf16 bias add or layer-scale product: every
conv's bias but a ``'block'`` block's, whose f32 bias JAX adds to the f32
conv sum; in ``'off'`` also each block's b1, b2 and layer scale).  XLA
on the CPU accumulates that sum in bf16, tens of ulps of the exact sum
apart (``tests/test_torch_bf16_train_ops.py``); the port sums in f32 and
rounds once, as PyTorch's sums and the kernels do.  Those tensors are held
to two things instead: every element is a bf16 value (the sum was rounded
to bf16 once, before the cast's backward widened it), and the port is no
farther from the JAX bf16 step than 1.5 times JAX bf16's own distance from
f32 (measured: at most 1.23 times, in the free-running step; 0.97 in
'off', 0.79 in 'mlp').  Every gradient of a tensor cast to bf16 at use
holds bf16 values.

After the step: Adam's first step moves a parameter by about lr * sign(g),
so the updated parameters are compared with the JAX bf16 gradients passed
through the JAX package's optimizer (clip, then optax's Adam) only where
|g| exceeds twice the largest |port - JAX bf16| of that tensor (the run's
own noise: below it the two signs may differ), within 1e-2 x lr; more than
a quarter of each part's elements are compared.  Children below
``starting_layer`` stay bit-identical.  Remat ``'on'`` and ``'off'`` give
the same bf16 step bit for bit.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_finetune import child, encoder_sd
from tests.test_torch_helpers import SMALL, jax_model_and_params, port_model, t
from tests.test_torch_train_step import B, WORD_IDS, decoder_sd, make_batch
from tpu_captioner_torch.core import prng
from tpu_captioner_torch.core.config import TrainConfig
from tpu_captioner_torch.train.model import CaptionModel
from tpu_captioner_torch.train.state import TrainState
from tpu_captioner_torch.train.steps import make_train_step, pool_demand

BF16 = dict(compute_dtype="bfloat16")
START = 5
STEPS = 10  # free-running rollout length
NO_EXCESS = {"xla_allow_excess_precision": False}
RATIO = 2.0
REDUCED_SLACK = 1.5
# The LSTM's score bias feeds a softmax over the pixels, which is shift
# invariant: its gradient is zero in exact arithmetic, both frameworks'
# values are rounding noise (1.3e-7 in JAX's bf16 fine-tune step), near
# Adam's eps of 1e-8, where a first step is not lr * sign(g).  Its gradient
# is held to the rule; its update is not compared.
ZERO_GRAD = ("attention.full_att.bias",)


def block_mode(name: str, mode) -> str:
    """The mode of the stage that holds the block tensor ``name``
    (``convnext.{child}.{block}...``; stage s is child 2 s + 1): ``mode``
    itself, or its entry for that stage."""
    return mode if isinstance(mode, str) else mode[(child(name) - 1) // 2]


def reduced_in_bf16(name: str, mode) -> bool:
    """Trained tensors whose JAX bf16 gradient is a bf16 sum over rows: the
    conv biases (each block's depthwise conv but in ``'block'``, child 6's
    downsample conv) and, in ``'off'``, each block's b1, b2 and layer
    scale."""
    if name.endswith("convnext.6.1.bias"):
        return True
    if name.endswith("block.0.bias"):
        return block_mode(name, mode) != "block"
    return name.endswith(("block.3.bias", "block.5.bias", "layer_scale")) and block_mode(name, mode) == "off"


def cast_at_use(name: str, mode) -> bool:
    """Trained encoder tensors the bf16 model casts to bf16 where it uses
    them: the convs' weights and biases (a ``'block'`` block's conv bias
    stays f32), the blocks' matrices and, in ``'off'``, their b1, b2 and
    layer scale."""
    if name.endswith(("block.0.weight", "block.3.weight", "block.5.weight", "convnext.6.1.weight")):
        return True
    return reduced_in_bf16(name, mode)


def setup(monkeypatch, mode, seed=4, dropout=0.5, **overrides):
    """JAX bf16 and f32 models and the port's bf16 model on one set of
    weights, both pools patched to the same numpy bits, both encoders
    deterministic.  The free-running step draws dropout per token from
    each package's own generator, so it runs with ``dropout`` 0.
    ``overrides`` change ``SMALL`` in all three (the decoder family)."""
    from jax.experimental.pallas import tpu as pltpu

    from tpu_captioner.core.config import ModelConfig as JaxModelConfig
    from tpu_captioner.train.model import CaptionModel as JaxCaptionModel

    with pltpu.force_tpu_interpret_mode():
        jbf, params = jax_model_and_params(seed=seed, dropout_masks="pool", use_pallas=mode, encoder_remat="off",
                                           dropout=dropout, **BF16, **overrides)
    jf32 = JaxCaptionModel(JaxModelConfig(**{**SMALL, "dropout_masks": "pool", "use_pallas": "off",
                                             "dropout": dropout, **overrides}))
    model = port_model(params, use_pallas=mode, dropout=dropout, **BF16, **overrides)
    cfg = model.cfg
    side = SMALL["encoded_image_size"]
    bits = np.random.default_rng(11).random(pool_demand(cfg, B, SMALL["max_len"], side * side)) < 1.0 - cfg.dropout
    monkeypatch.setattr("tpu_captioner.ops.dropout_mask.random_mask_pool",
                        lambda key, count, keep, *, on_tpu: jnp.asarray(bits))
    monkeypatch.setattr("tpu_captioner_torch.ops.dropout_mask.random_mask_pool",
                        lambda words, count, keep, device: t(bits[:count]).to(device))
    for jm in (jbf, jf32):
        jm.encode = (lambda m: lambda p, images_u8, deterministic=True, rng=None: JaxCaptionModel.encode(
            m, p, images_u8, deterministic=True))(jm)
    model.encode = lambda images_u8, train=False, generator=None: CaptionModel.encode(model, images_u8)
    model.encode_fine_tune = lambda images_u8, starting_layer, generator=None: (
        CaptionModel.encode_fine_tune(model, images_u8, starting_layer))
    return jbf, jf32, params, model


def jax_loss_and_grads(jm, params, batch, teacher_forcing, interpret):
    """JAX's training loss and its clamped gradients, jitted with every bf16
    op rounding; in the port's state-dict names."""
    from jax.experimental.pallas import tpu as pltpu

    from tpu_captioner.train import steps as jax_steps

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        if teacher_forcing:
            return jax_steps.tf_loss(jm, p, jbatch, 1.0, jax.random.PRNGKey(0), False)
        return jax_steps.rollout_loss(jm, p, jbatch, WORD_IDS, 1.0, STEPS, jax.random.PRNGKey(0), False, 0.0)

    fn = jax.jit(jax.value_and_grad(loss, has_aux=True), compiler_options=NO_EXCESS)
    with pltpu.force_tpu_interpret_mode() if interpret else contextlib.nullcontext():
        (value, aux), grads = fn(jax.tree_util.tree_map(jnp.asarray, params))
    grads = jax.tree_util.tree_map(lambda g: jnp.clip(g, -5.0, 5.0), grads)
    return float(value), aux, grads


def jax_adam_params(params, grads, cfg, train_encoder):
    """The parameters after one step of the JAX package's optimizers (clip,
    then Adam) on ``grads``, the frozen children's gradients zero."""
    from tpu_captioner.core.config import TrainConfig as JaxTrainConfig
    from tpu_captioner.models.encoder import fine_tune_mask as jax_mask
    from tpu_captioner.train.state import make_optimizer

    import optax

    jtc = JaxTrainConfig(batch_size=B)
    out = {}
    p = jax.tree_util.tree_map(jnp.asarray, params)
    for part, lr in (("decoder", jtc.decoder_lr), ("encoder", jtc.encoder_lr)):
        g = grads[part]
        if part == "encoder":
            mask = jax_mask(p["encoder"], train_encoder, START)
            g = jax.tree_util.tree_map(lambda a, m: a if m else jnp.zeros_like(a), g, mask)
        opt = make_optimizer(lr, jtc.grad_clip)
        updates, _ = opt.update(g, opt.init(p[part]), p[part])
        new = optax.apply_updates(p[part], updates)
        out[part] = (encoder_sd if part == "encoder" else decoder_sd)(params, new, cfg)
    return out


def port_step(model, batch, teacher_forcing, train_encoder):
    tc = TrainConfig(batch_size=B, max_decode_len=STEPS, teacher_forcing=teacher_forcing)
    state = TrainState.create(model, tc)
    step = make_train_step(model, tc, WORD_IDS, teacher_forcing=teacher_forcing, train_encoder=train_encoder)
    state, m = step(state, {k: t(v) for k, v in batch.items()}, prng.step_seed(prng.root_seed(0), "dropout", 0, 0))
    return state, m, tc


def check_step(monkeypatch, mode, teacher_forcing, train_encoder, **overrides):
    jbf, jf32, params, model = setup(monkeypatch, mode, dropout=0.5 if teacher_forcing else 0.0, **overrides)
    batch = make_batch()
    cfg = model.cfg
    enc_before = {k: v.clone() for k, v in model.encoder.state_dict().items()}
    loss_b, aux_b, g_b = jax_loss_and_grads(jbf, params, batch, teacher_forcing, mode != "off")
    loss_f, _, g_f = jax_loss_and_grads(jf32, params, batch, teacher_forcing, False)
    state, m, tc = port_step(model, batch, teacher_forcing, train_encoder)
    loss = float(m["loss"])
    assert abs(loss - loss_b) * RATIO <= abs(loss - loss_f), (loss, loss_b, loss_f)
    assert float(m["tokens"]) == float(aux_b["tokens"]) > 0
    assert float(m["top5_correct"]) == float(aux_b["top5_correct"])

    parts = {"encoder": model.encoder, "decoder": model.decoder}
    want_b = {part: (encoder_sd if part == "encoder" else decoder_sd)(params, g_b[part], cfg) for part in parts}
    want_f = {part: (encoder_sd if part == "encoder" else decoder_sd)(params, g_f[part], cfg) for part in parts}
    trained = {k for k, p in model.encoder.named_parameters() if p.grad is not None}
    assert trained == ({k for k, _ in model.encoder.named_parameters() if child(k) >= START}
                       if train_encoder else set())
    worst = worst_reduced = float("inf")
    noise = {}
    for part, mod in parts.items():
        for k, p in mod.named_parameters():
            if p.grad is None:
                continue
            g = p.grad
            d_b = (g - want_b[part][k]).norm().item()
            d_f = (g - want_f[part][k]).norm().item()
            noise[part, k] = (g - want_b[part][k]).abs().max().item()
            if part == "encoder" and cast_at_use(k, mode):
                assert torch.equal(g, g.to(torch.bfloat16).float()), k  # rounded to bf16 once
            if part == "encoder" and reduced_in_bf16(k, mode):
                own = (want_b[part][k] - want_f[part][k]).norm().item()
                assert d_b <= REDUCED_SLACK * own, (k, d_b, own)
                worst_reduced = min(worst_reduced, own / max(d_b, 1e-30))
                continue
            assert d_b * RATIO <= d_f, (part, k, d_b, d_f)
            worst = min(worst, d_f / max(d_b, 1e-30))

    # The update: JAX's optimizer on its bf16 gradients, where |g| is above the noise.
    want_p = jax_adam_params(params, g_b, cfg, train_encoder)
    lr = tc.decoder_lr
    assert tc.encoder_lr == lr
    for part, mod in parts.items():
        if part == "encoder" and not train_encoder:
            continue
        checked = total = 0
        for k, p in mod.named_parameters():
            if p.grad is None or k in ZERO_GRAD:
                continue
            sure = want_b[part][k].abs() > 2 * noise[part, k]
            err = (p.detach() - want_p[part][k]).abs()[sure]
            assert err.numel() == 0 or err.max().item() <= 1e-2 * lr, (part, k, err.max().item())
            checked, total = checked + int(sure.sum()), total + p.numel()
        assert checked > total // 4, (part, checked, total)
    for k, v in model.encoder.state_dict().items():
        if not train_encoder or child(k) < START:
            assert torch.equal(v, enc_before[k]), k
    return worst, worst_reduced, abs(loss - loss_f) / max(abs(loss - loss_b), 1e-30)


def test_bf16_frozen_step_matches_jax(monkeypatch):
    check_step(monkeypatch, "off", True, False)


@pytest.mark.parametrize("mode", ["mlp", "off"])
def test_bf16_fine_tune_step_matches_jax(monkeypatch, mode):
    """``'mlp'``: the kernels' plain versions on the CPU against JAX's
    Pallas tail (interpret mode); ``'off'``: the bf16 ops one by one."""
    check_step(monkeypatch, mode, True, True)
