"""The LSTM families' teacher-forced loss and greedy eval step, each with
the doubly stochastic attention term, against the JAX package's, on the CPU.

The model is ``tests/test_torch_helpers.py``'s ``SMALL`` with the decoder
family overridden and an attention width of 20; the batch is
``tests/test_torch_train_step.py:make_batch``'s.  Tolerances: the
teacher-forced loss 1e-5 and the eval step's loss rtol 1e-5 (f32 sums of
30-odd token losses plus the term); counts, sequences and lengths exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_helpers import jax_model_and_params, port_model, t
from tests.test_torch_train_step import WORD_IDS, make_batch
from tpu_captioner_torch.core.config import TrainConfig
from tpu_captioner_torch.train.steps import make_eval_step, tf_loss

KINDS = ("lstm", "lstm_no_attention")
ATT = 20  # attention width
B = 3  # make_batch's rows
STEPS = 10  # the eval step's decode length


def models(kind, seed, **kw):
    jmodel, params = jax_model_and_params(seed=seed, decoder=kind, attention_dim=ATT, use_pallas="off", **kw)
    return jmodel, params, port_model(params, decoder=kind, attention_dim=ATT, **kw)


@pytest.mark.parametrize("kind", KINDS)
def test_tf_loss_matches_jax(kind):
    """``tf_loss`` without dropout or stochastic depth, with ``alpha_c`` 1:
    the doubly stochastic term is added for ``lstm`` only, as in the JAX
    package."""
    from tpu_captioner.train.steps import tf_loss as jax_tf_loss

    jmodel, params, model = models(kind, seed=8)
    batch = make_batch(seed=5)
    jloss, jm = jax_tf_loss(jmodel, params, {k: jnp.asarray(v) for k, v in batch.items()}, 1.0, None, True)
    with torch.no_grad():
        loss, m = tf_loss(model, {k: t(v) for k, v in batch.items()}, 1.0, False)
        base, _ = tf_loss(model, {k: t(v) for k, v in batch.items()}, 0.0, False)
    assert abs(loss.item() - float(jloss)) < 1e-5
    assert m["top5_correct"].item() == int(jm["top5_correct"]) and m["tokens"].item() == float(jm["tokens"])
    assert (loss.item() > base.item()) == (kind == "lstm")


@pytest.fixture(scope="module", params=KINDS)
def jax_eval(request):
    """JAX ``make_eval_step`` (its plain rollout on the CPU) with the natural
    ``<end>`` and with an end id that rows emit."""
    from tpu_captioner.core.config import TrainConfig as JaxTrainConfig
    from tpu_captioner.train.steps import make_eval_step as jax_make_eval_step

    kind = request.param
    jmodel, params = jax_model_and_params(seed=6, decoder=kind, attention_dim=ATT, use_pallas="off")
    batch = make_batch(seed=7)
    tc = JaxTrainConfig(batch_size=B, max_decode_len=STEPS)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    first = jax_make_eval_step(jmodel, tc, WORD_IDS)(params, jbatch)
    emitted = int(np.bincount(np.asarray(first["sequences"]).ravel()).argmax())
    ids = dict(WORD_IDS, **{"<end>": emitted})
    second = jax_make_eval_step(jmodel, tc, ids)(params, jbatch)
    return kind, params, batch, {"natural": (WORD_IDS, first), "emitted": (ids, second)}


@pytest.mark.parametrize("end", ["natural", "emitted"])
@pytest.mark.parametrize("mode", ["off", "on"])
def test_eval_step_matches_jax(jax_eval, mode, end):
    """The whole eval step, with ``alpha_c``'s term for ``lstm``, in both
    decode modes ('on': the kernel rollout, its plain step on the CPU)."""
    kind, params, batch, runs = jax_eval
    word_ids, want = runs[end]
    model = port_model(params, decoder=kind, attention_dim=ATT, decode_kernel=mode)
    got = make_eval_step(model, TrainConfig(batch_size=B, max_decode_len=STEPS), word_ids)(
        {k: t(v) for k, v in batch.items()}
    )
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    for key in ("tokens", "top5_correct", "sequences", "lengths"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    if end == "emitted":
        assert (got["lengths"] < STEPS).any()  # some row finished early
