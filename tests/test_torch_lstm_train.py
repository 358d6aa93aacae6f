"""The LSTM families' frozen-encoder train step against the JAX package's,
on the CPU.

The model is ``tests/test_torch_helpers.py``'s ``SMALL`` with the decoder
family overridden and an attention width of 20; the batch is
``tests/test_torch_train_step.py:make_batch``'s.  As there, the train step
feeds both packages the same dropout bits (each package's
``random_mask_pool`` replaced by one returning a numpy bit array, whose
length JAX's counting trace must give as ``pool_demand`` does) and runs both
encoders in eval mode.  Tolerances: losses 1e-5 (f32 sums of 30-odd token
losses plus the doubly stochastic term), clamped gradients rtol 1e-4 and
atol 1e-6 (f32 backward through 15 recurrent steps in two frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_helpers import SMALL, jax_model_and_params, port_model, t
from tests.test_torch_train_step import GRAD_ATOL, GRAD_RTOL, WORD_IDS, decoder_sd, make_batch
from tpu_captioner_torch.core import prng
from tpu_captioner_torch.core.config import TrainConfig
from tpu_captioner_torch.train.model import CaptionModel
from tpu_captioner_torch.train.state import TrainState
from tpu_captioner_torch.train.steps import make_train_step, pool_demand

KINDS = ("lstm", "lstm_no_attention")
ATT = 20  # attention width
B = 3  # make_batch's rows


def models(kind, seed, **kw):
    jmodel, params = jax_model_and_params(seed=seed, decoder=kind, attention_dim=ATT, use_pallas="off", **kw)
    return jmodel, params, port_model(params, decoder=kind, attention_dim=ATT, **kw)


@pytest.mark.parametrize("kind", KINDS)
def test_frozen_step_matches_jax(monkeypatch, kind):
    """Two frozen-encoder train steps with the pooled dropout bits: losses,
    counts and the first step's clamped gradients against JAX's; the
    encoder unchanged."""
    from tpu_captioner.core.config import TrainConfig as JaxTrainConfig
    from tpu_captioner.train import steps as jax_steps
    from tpu_captioner.train.model import CaptionModel as JaxCaptionModel
    from tpu_captioner.train.state import TrainState as JaxTrainState
    from tpu_captioner.train.state import make_optimizer

    jmodel, params, model = models(kind, seed=4, dropout_masks="pool")
    cfg = model.cfg
    batch = make_batch()
    n = pool_demand(cfg, B, SMALL["max_len"], 4)
    assert n == B * (SMALL["max_len"] - 1) * cfg.decoder_dim
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
    model.encode = lambda images_u8, train=False, generator=None: CaptionModel.encode(model, images_u8)

    tc, jtc = TrainConfig(batch_size=B), JaxTrainConfig(batch_size=B)
    dec_opt, enc_opt = make_optimizer(jtc.decoder_lr, jtc.grad_clip), make_optimizer(jtc.encoder_lr, jtc.grad_clip)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params), dec_opt, enc_opt)
    jstep = jax_steps.make_train_step(jmodel, jtc, WORD_IDS, dec_opt, enc_opt)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def dec_loss(dec_params):
        p = {"encoder": jstate.params["encoder"], "decoder": dec_params}
        return jax_steps.tf_loss(jmodel, p, jbatch, jtc.alpha_c, jax.random.PRNGKey(0), False)

    jgrads, _ = jax.grad(dec_loss, has_aux=True)(jstate.params["decoder"])
    jgrads = decoder_sd(params, jax.tree_util.tree_map(lambda g: jnp.clip(g, -5.0, 5.0), jgrads), cfg)

    state, step = TrainState.create(model, tc), make_train_step(model, tc, WORD_IDS)
    pbatch = {k: t(v) for k, v in batch.items()}
    enc_before = {k: v.clone() for k, v in model.encoder.state_dict().items()}
    root = prng.root_seed(tc.seed)
    for i in range(2):
        jstate, jm = jstep(jstate, jbatch, jax.random.PRNGKey(i))
        state, m = step(state, pbatch, prng.step_seed(root, "dropout", 0, i))
        assert abs(float(m["loss"]) - float(jm["loss"])) < 1e-5
        assert float(m["top5_correct"]) == float(jm["top5_correct"])
        assert float(m["tokens"]) == float(jm["tokens"]) == 6 + 15
        if i == 0:
            for k, p in model.decoder.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), jgrads[k].numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                           err_msg=k)
    assert all(torch.equal(v, enc_before[k]) for k, v in model.encoder.state_dict().items())
