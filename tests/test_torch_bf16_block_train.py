"""The bf16 frozen and fine-tune (``starting_layer`` 5) teacher-forced
steps of a model in ``use_pallas='block'`` and in the per-stage mix
``('mlp', 'mlp', 'block', 'block')`` against the JAX package's bf16 steps
on the same weights, by ``tests/test_torch_bf16_train_step.py``'s
per-tensor rule (``check_step``: the port closer to JAX bf16 than to JAX
f32 by 2x per tensor; JAX's Pallas kernels in interpret mode).  In
``'block'`` the conv bias is an f32 operand, so its gradient is held to
that rule, not to the bf16-sum exception.  The ops and the encoder:
``tests/test_torch_bf16_block.py``.
"""

import pytest

from tests.test_torch_bf16_block import MIX
from tests.test_torch_bf16_train_step import check_step


@pytest.mark.parametrize("mode", ["block", MIX], ids=str)
def test_bf16_block_fine_tune_step_matches_jax(monkeypatch, mode):
    check_step(monkeypatch, mode, True, True)


def test_bf16_block_frozen_step_matches_jax(monkeypatch):
    check_step(monkeypatch, "block", True, False)
