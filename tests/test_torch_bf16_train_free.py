"""bf16 training, continued from ``tests/test_torch_bf16_train_step.py``
(whose references, rule and tolerances it shares): the free-running step,
and remat.
"""

import numpy as np
import torch

from tests.test_torch_bf16_train_step import BF16, check_step
from tests.test_torch_helpers import jax_model_and_params, port_model, t
from tests.test_torch_train_step import B, WORD_IDS, make_batch
from tpu_captioner_torch.core import prng
from tpu_captioner_torch.core.config import TrainConfig
from tpu_captioner_torch.train.state import TrainState
from tpu_captioner_torch.train.steps import make_train_step


def test_bf16_free_running_fine_tune_step_matches_jax(monkeypatch):
    """The free-running step, fine-tune, in ``'mlp'``: a 10-token greedy
    rollout without dropout from the bf16 features."""
    check_step(monkeypatch, "mlp", False, True)


def test_bf16_remat_on_and_off_give_the_same_step():
    """Recomputing the bf16 blocks' forwards in the backward changes no
    bit, in ``'mlp'`` and in ``'off'``, with stochastic depth and dropout
    drawn from the step seeds."""
    _, params = jax_model_and_params(seed=5)
    batch = {k: t(v) for k, v in make_batch(seed=3).items()}
    for mode in ("mlp", "off"):
        runs = {}
        for remat in ("on", "off", "save_mlp_in"):
            model = port_model(params, use_pallas=mode, encoder_remat=remat, **BF16)
            tc = TrainConfig(batch_size=B)
            state, step = TrainState.create(model, tc), make_train_step(model, tc, WORD_IDS, train_encoder=True)
            losses = []
            for i in range(2):
                state, m = step(state, batch, prng.step_seed(prng.root_seed(0), "dropout", 0, i))
                losses.append(float(m["loss"]))
            runs[remat] = losses, {k: v.clone() for k, v in model.state_dict().items()}
        on_losses, on_params = runs["on"]
        assert np.isfinite(on_losses).all()
        for remat in ("off", "save_mlp_in"):
            losses, got = runs[remat]
            assert losses == on_losses, (mode, remat)
            for k, v in got.items():
                assert torch.equal(v, on_params[k]), (mode, remat, k)
