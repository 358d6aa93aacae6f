"""bf16 training of the LSTM families (``compute_dtype='bfloat16'`` with
``lstm`` and ``lstm_no_attention``): the port's frozen, fine-tune and
free-running steps against the JAX package's bf16 steps on the same
weights, with ``tests/test_torch_bf16_train_step.py``'s references (JAX's
steps jitted without excess precision), rule (per trained tensor and for
the loss, the port at most half as far from JAX bf16 as from JAX f32) and
checks (the bf16-summed conv biases, Adam's first step, the frozen
children).  No new kernel: the decoder trains on the plain path in f32 on
the widened bf16 features, whose cotangent is rounded to bf16 at the
widening, as JAX's convert rounds it; the fine-tune step's encoder backward
runs in ``'off'`` (the bf16 encoder kernels' plain versions are held in
``'mlp'`` by the Transformer's tests).  Measured (the smallest ratio of
the two distances over the tensors the rule holds; the bf16-summed conv
biases' own distance over the port's, rule at least 1 / 1.5): frozen
``lstm`` 49.1, ``lstm_no_attention`` 95.8 (the losses equal to JAX
bf16's); fine-tune 4.26 (2.18) and 95.8 (0.94); free-running ``lstm``
2.22 (1.26), its loss 162 times closer to JAX bf16.
"""

import pytest

from tests.test_torch_bf16_train_step import check_step

ATT = 20  # the attention width of tests/test_torch_lstm_train.py
KINDS = ("lstm", "lstm_no_attention")


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_lstm_frozen_step_matches_jax(monkeypatch, kind):
    check_step(monkeypatch, "off", True, False, decoder=kind, attention_dim=ATT)


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_lstm_fine_tune_step_matches_jax(monkeypatch, kind):
    """``'off'``: the encoder's bf16 ops one by one (its kernels' bf16
    plain versions are held in ``'mlp'`` by the Transformer's tests)."""
    check_step(monkeypatch, "off", True, True, decoder=kind, attention_dim=ATT)


def test_bf16_lstm_free_running_step_matches_jax(monkeypatch):
    """The free-running fine-tune step of ``lstm``: a 10-token greedy
    rollout without dropout from the bf16 features."""
    check_step(monkeypatch, "off", False, True, decoder="lstm", attention_dim=ATT)
