"""Free-running training, continued from ``tests/test_torch_free_running.py``
(whose helpers and tolerances it shares): the training rollout with dropout
above 0, both packages taking JAX's masks once per token and site, and one
``make_train_step(teacher_forcing=False)`` step, frozen and fine-tune,
against JAX's.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_free_running import (
    B,
    FAMILIES,
    STEPS,
    check_against_jax,
    features,
    jax_dropout_draw,
    jax_loss_and_grads,
    jax_teacher_masks,
    models,
    port_loss,
)
from tests.test_torch_helpers import SMALL, t
from tests.test_torch_train_step import WORD_IDS, decoder_sd, make_batch
from tpu_captioner_torch.core import prng
from tpu_captioner_torch.core.config import LSTM_DECODERS, TrainConfig
from tpu_captioner_torch.models import layers, transformer
from tpu_captioner_torch.train.state import TrainState
from tpu_captioner_torch.train.steps import make_train_step


@pytest.mark.parametrize("kind", FAMILIES)
def test_training_rollout_dropout_matches_jax(monkeypatch, kind):
    """Dropout 0.5 and scheduled sampling 0.5: both packages take JAX's
    masks, once per token and site; every site of every token is drawn."""
    jmodel, params, model = models(kind, seed=4, dropout=0.5, features=features(4))
    batch = make_batch(seed=6)
    rng = jax.random.PRNGKey(8)
    mask = jax_teacher_masks(kind, rng, 0.5)
    monkeypatch.setattr(transformer, "teacher_masks", lambda gen, n, b, pr, dev: t(mask[:n]).to(dev))
    seen = []
    monkeypatch.setattr(layers, "draw_mask", jax_dropout_draw(kind, rng, model.cfg, seen))
    want = jax_loss_and_grads(jmodel, params, batch, rng, 0.5)
    loss, aux = port_loss(model, batch, 0.5)
    per_token = 1 if kind in LSTM_DECODERS else 1 + 6 * SMALL["num_layers"]
    assert len(seen) == len(set(seen)) == STEPS * per_token
    check_against_jax(model, params, loss, aux, want, model.cfg)


def adam_step_agree(model, jparams_dec, lr, grads):
    checked = total = 0
    for k, p in model.decoder.named_parameters():
        if p.grad is None:
            continue
        sure = grads[k].abs() >= 1e-7
        err = (p.detach() - jparams_dec[k]).abs()[sure]
        assert err.numel() == 0 or err.max().item() <= 1e-2 * lr, k
        checked, total = checked + int(sure.sum()), total + p.numel()
    assert checked > total // 4


@pytest.mark.parametrize("train_encoder", [False, True])
def test_free_running_step_matches_jax(train_encoder):
    """One ``make_train_step(teacher_forcing=False)`` step, frozen and
    fine-tune (``starting_layer`` 5), against JAX's: loss, counts, and the
    updated decoder (and encoder) parameters within 1e-2 x lr."""
    from tpu_captioner.core.config import TrainConfig as JaxTrainConfig
    from tpu_captioner.train import steps as jax_steps
    from tpu_captioner.train.state import TrainState as JaxTrainState
    from tpu_captioner.train.state import make_optimizer
    from tests.test_torch_finetune import encoder_sd

    jmodel, params, model = models("transformer", seed=9)
    batch = make_batch(seed=1)
    tc = TrainConfig(batch_size=B, max_decode_len=STEPS, teacher_forcing=False)
    jtc = JaxTrainConfig(batch_size=B, max_decode_len=STEPS, teacher_forcing=False)
    lr = tc.decoder_lr
    dec_opt, enc_opt = make_optimizer(jtc.decoder_lr, jtc.grad_clip), make_optimizer(jtc.encoder_lr, jtc.grad_clip)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params), dec_opt, enc_opt)
    jstep = jax_steps.make_train_step(jmodel, jtc, WORD_IDS, dec_opt, enc_opt, teacher_forcing=False,
                                      train_encoder=train_encoder)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))

    state = TrainState.create(model, tc)
    step = make_train_step(model, tc, WORD_IDS, teacher_forcing=False, train_encoder=train_encoder)
    enc_before = {k: v.clone() for k, v in model.encoder.state_dict().items()}
    state, m = step(state, {k: t(v) for k, v in batch.items()}, prng.step_seed(prng.root_seed(0), "dropout", 0, 0))
    assert set(m) == {"loss", "tokens", "top5_correct"} and state.step == 1
    assert abs(float(m["loss"]) - float(jm["loss"])) < 1e-5
    assert float(m["tokens"]) == float(jm["tokens"]) > 0
    assert float(m["top5_correct"]) == float(jm["top5_correct"])
    grads = {k: p.grad for k, p in model.decoder.named_parameters() if p.grad is not None}
    adam_step_agree(model, decoder_sd(params, jstate.params["decoder"], model.cfg), lr, grads)
    jenc = encoder_sd(params, jstate.params["encoder"], model.cfg)
    for k, v in model.encoder.state_dict().items():
        trained = train_encoder and int(k.split(".")[1]) >= tc.starting_layer
        if not trained:
            assert torch.equal(v, enc_before[k]) and torch.equal(v, jenc[k]), k
    if train_encoder:
        checked = 0
        for k, p in model.encoder.named_parameters():
            if p.grad is None:
                continue
            sure = p.grad.abs() >= 1e-7
            err = (p.detach() - jenc[k]).abs()[sure]
            assert err.numel() == 0 or err.max().item() <= 1e-2 * lr, k
            checked += int(sure.sum())
        assert checked > 0
