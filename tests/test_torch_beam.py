"""The whole serving slice: the port's ``beam_search_batch`` (B=2, k=3)
against JAX ``beam_search_batch`` with the decode kernel on (interpreted on
the CPU) and the encoder's Pallas tail off, on the same weights and images.
Sequences and lengths must be equal; scores and attention maps agree to 1e-4
(f32 log-probs summed over up to 10 steps in two frameworks).  Two end
tokens: 56, which no beam emits within the cap (the best-live fallback), and
50, which both images emit at different steps (harvest and frozen rows)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_helpers import END, START, images, jax_model_and_params, port_model
from tpu_captioner.infer.beam import beam_search_batch as jax_beam_search_batch
from tpu_captioner_torch.infer.beam import beam_search, beam_search_batch

MAX_STEPS = 9


@pytest.fixture(scope="module", params=[END, 50])
def reference(request):
    end_id = request.param
    jmodel, params = jax_model_and_params(seed=2, decode_kernel="on", use_pallas="off")
    imgs = images(2, seed=9)
    res = jax_beam_search_batch(
        jmodel, params, jnp.asarray(imgs),
        beam_size=3, max_steps=MAX_STEPS, start_id=START, end_id=end_id,
    )
    return params, imgs, end_id, [np.asarray(x) for x in res]


@pytest.mark.parametrize("decode_kernel", ["on", "off"])
def test_beam_batch_matches_jax(reference, decode_kernel):
    # 'on' = the fused-step adapter (plain version on CPU tensors);
    # 'off' = the head-split decode_step adapter.
    params, imgs, end_id, (seq, length, alphas, score) = reference
    model = port_model(params, decode_kernel=decode_kernel, use_pallas="on")
    res = beam_search_batch(
        model, torch.from_numpy(imgs), beam_size=3, max_steps=MAX_STEPS,
        start_id=START, end_id=end_id,
    )
    np.testing.assert_array_equal(res.sequence.numpy(), seq)
    np.testing.assert_array_equal(res.length.numpy(), length)
    np.testing.assert_allclose(res.score.numpy(), score, atol=1e-4, rtol=0)
    np.testing.assert_allclose(res.alphas.numpy(), alphas, atol=1e-4, rtol=0)


def test_single_image_matches_batch(reference):
    params, imgs, end_id, (seq, length, _, score) = reference
    model = port_model(params)
    for b in range(2):
        one = beam_search(
            model, torch.from_numpy(imgs[b]), beam_size=3, max_steps=MAX_STEPS,
            start_id=START, end_id=end_id,
        )
        np.testing.assert_array_equal(one.sequence.numpy(), seq[b])
        assert int(one.length) == int(length[b])
        np.testing.assert_allclose(float(one.score), float(score[b]), atol=1e-4)
