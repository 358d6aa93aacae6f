"""Two data-parallel ranks of the port's ``lstm`` family against the JAX
package's single-device step on the global batch: the frozen, fine-tune
and free-running steps, with the doubly stochastic term over the global
count of valid rows (set-up and tolerances of
``tests/test_torch_parallel_steps.py``)."""

import pytest

from tests.test_torch_parallel_steps import check_kind, two_ranks
from tests.torch_parallel_workers import KINDS


@pytest.fixture(scope="module")
def lstm_run(tmp_path_factory):
    return two_ranks(tmp_path_factory.mktemp("ranks"), "lstm", seed=6)


@pytest.mark.parametrize("kind", KINDS)
def test_two_lstm_ranks_match_the_jax_step_on_the_global_batch(lstm_run, kind):
    check_kind(lstm_run, kind)
