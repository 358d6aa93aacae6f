"""Two data-parallel ranks of the port against the JAX package's
single-device step on the global batch: the frozen, fine-tune
(``starting_layer`` 5) and free-running steps of the Transformer (the
``lstm`` family in ``tests/test_torch_parallel_lstm.py``).

The JAX mesh step is one global program, so an N-way JAX run computes what
one device computes on the global batch; the port's ranks must too.  Both
packages start from the same weights (JAX's, bridged by
``models/from_jax.py``), with dropout 0 and stochastic depth off (both
encoders deterministic, as ``tests/test_torch_finetune.py`` runs them).
The global batch of 4 rows (its last row padding) is split over two gloo
processes on the CPU (``tests/torch_parallel_workers.py:steps_rank``), 2
rows each.  JAX's reference is ``jax.value_and_grad`` of its loss on all 4
rows, clamped to +-grad_clip.  Tolerances: loss 1e-5 relative; the
summed, clamped gradients within 1e-3 x max(1, the tensor's largest JAX
gradient); token and top-5 counts equal; the two ranks' weights and
gradients equal bit for bit after the step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_finetune import encoder_sd
from tests.test_torch_helpers import SMALL, images, jax_model_and_params, port_model
from tests.test_torch_train_step import WORD_IDS, decoder_sd
from tests.torch_parallel_workers import KINDS, steps_rank
from tpu_captioner_torch.core.config import TrainConfig
from tpu_captioner_torch.parallel.mesh import spawn

ROWS = 4  # the global batch; two ranks of two rows
STEPS = 10  # free-running tokens
START = 5  # the fine-tune step's starting_layer
ATT = 20  # the lstm family's attention width


def global_batch(seed=0):
    """Captions ``<start> words <end> <pad>...``; the last row padding."""
    rng = np.random.default_rng(seed)
    length = SMALL["max_len"]
    caplens = np.array([7, length, 10, 5], np.int32)
    caps = np.zeros((ROWS, length), np.int32)
    for i, n in enumerate(caplens):
        caps[i, 0], caps[i, n - 1] = WORD_IDS["<start>"], WORD_IDS["<end>"]
        caps[i, 1 : n - 1] = rng.integers(1, 54, n - 2)
    return {"images": images(ROWS, seed=seed + 1), "captions": caps, "caplens": caplens,
            "valid": np.array([True, True, True, False])}


def jax_reference(jmodel, params, batch, kind, tc):
    """(loss, metrics, clamped gradients in the port's names) of JAX's
    deterministic loss on the global batch: over the decoder, and for the
    fine-tune step the encoder children from ``START`` on too."""
    from tpu_captioner.train import steps as jax_steps

    p = jax.tree_util.tree_map(jnp.asarray, params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(tree):
        full = {"encoder": tree.get("encoder", p["encoder"]), "decoder": tree["decoder"]}
        if kind == "free_running":  # the training rollout (a scan), dropout 0
            return jax_steps.rollout_loss(jmodel, full, jbatch, WORD_IDS, tc.alpha_c, STEPS, jax.random.PRNGKey(0),
                                          False)
        return jax_steps.tf_loss(jmodel, full, jbatch, tc.alpha_c, None, True)

    tree = {"decoder": p["decoder"], **({"encoder": p["encoder"]} if kind == "fine_tune" else {})}
    (value, aux), grads = jax.value_and_grad(loss, has_aux=True)(tree)
    grads = jax.tree_util.tree_map(lambda g: jnp.clip(g, -tc.grad_clip, tc.grad_clip), grads)
    cfg = port_model(params, **model_overrides(jmodel.cfg.decoder)).cfg
    want = {"decoder." + k: v for k, v in decoder_sd(params, grads["decoder"], cfg).items()}
    if kind == "fine_tune":
        enc = encoder_sd(params, grads["encoder"], cfg)
        want.update({"encoder." + k: v for k, v in enc.items() if int(k.split(".")[1]) >= START})
    return float(value), {k: float(v) for k, v in aux.items() if k in ("loss", "tokens", "top5_correct")}, want


def model_overrides(decoder):
    return dict(decoder=decoder, dropout=0.0, **(dict(attention_dim=ATT) if decoder == "lstm" else {}))


def two_ranks(tmp_path, decoder, seed):
    """JAX's models, the global batch, the two ranks' results by kind."""
    from tpu_captioner.train.model import CaptionModel as JaxCaptionModel

    jmodel, params = jax_model_and_params(seed=seed, use_pallas="off", **model_overrides(decoder))
    jmodel.encode = lambda p, images_u8, deterministic=True, rng=None: (  # stochastic depth off
        JaxCaptionModel.encode(jmodel, p, images_u8, deterministic=True)
    )
    model = port_model(params, **model_overrides(decoder))
    batch = global_batch(seed)
    train = dict(batch_size=ROWS // 2, max_decode_len=STEPS, starting_layer=START)
    spec = {"cfg": {k: getattr(model.cfg, k) for k in model.cfg.__dataclass_fields__},
            "state_dict": model.state_dict(), "batch": batch, "kinds": KINDS, "steps": 1, "seed": seed,
            "stochastic_depth": False, "train": train, "word_ids": WORD_IDS}
    torch.save(spec, tmp_path / "spec.pt")
    spawn(steps_rank, 2, "cpu", args=(str(tmp_path / "spec.pt"), str(tmp_path / "out.pt")))
    return jmodel, params, batch, TrainConfig(**train), torch.load(tmp_path / "out.pt", weights_only=False)


def check_kind(run, kind):
    jmodel, params, batch, tc, got = run
    value, metrics, want = jax_reference(jmodel, params, batch, kind, tc)
    got = got[kind]
    (m,) = got["metrics"]
    assert abs(m["loss"] - value) <= 1e-5 * abs(value), (m["loss"], value)
    assert m["tokens"] == metrics["tokens"] > 0 and m["top5_correct"] == metrics["top5_correct"]
    assert got["agree"] == [True]
    (grads,) = got["grads"]
    assert set(grads) == set(want), set(grads) ^ set(want)
    for k, g in grads.items():
        w = want[k]
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-3 * max(1.0, w.abs().max().item()),
                                   err_msg=k)


@pytest.fixture(scope="module")
def transformer_run(tmp_path_factory):
    return two_ranks(tmp_path_factory.mktemp("ranks"), "transformer", seed=4)


@pytest.mark.parametrize("kind", KINDS)
def test_two_ranks_match_the_jax_step_on_the_global_batch(transformer_run, kind):
    check_kind(transformer_run, kind)
