"""The port's dropout mask pool against its definition and the JAX package.

- ``_mask_plain`` (the CPU path of ``random_mask_pool`` and the definition
  of ``csrc/dropout_mask.cu``) is Philox4x32-10: Random123's known-answer
  vectors, determinism per seed, distinct streams, the keep rate within 5
  sigma, the threshold rule of the TPU kernel.
- ``pool_demand`` equals the JAX ``_CountingPool`` total of a traced forward.
- The pool layout: one numpy bit array fed to the JAX ``MaskPool`` and to the
  port's, both decoders' ``tf_forward`` in training mode on the same
  weights.  They drop the same elements, so logits and attention maps agree
  to 1e-5 (f32 through three post-norm layers in two frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_helpers import SMALL, START, jax_model_and_params, port_model, t
from tpu_captioner_torch.core.config import ModelConfig
from tpu_captioner_torch.ops.dropout_mask import (
    _mask_plain,
    philox4x32_10,
    random_mask_pool,
    threshold,
)
from tpu_captioner_torch.train.steps import pool_demand

# Random123 kat_vectors, philox4x32 with 10 rounds: (counter, key, output).
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    (
        (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
    ),
]


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_known_answers(ctr, key, want):
    words = philox4x32_10([torch.tensor([c], dtype=torch.int64) for c in ctr], key)
    assert tuple(int(w) for w in words) == want


def test_pool_bits_are_philox_words_below_threshold():
    seed, n, keep = (12345, 678), 37, 0.3  # ragged: 9 full groups and one of 1
    g = torch.arange(10, dtype=torch.int64)
    words = torch.stack(philox4x32_10((g, g * 0, g * 0, g * 0), seed), dim=1).reshape(-1)
    assert torch.equal(_mask_plain(seed, n, keep), (words < threshold(keep))[:n])


def test_mask_plain_is_deterministic_per_seed():
    a = _mask_plain((7, 9), 10_001, 0.5)
    assert a.dtype == torch.bool and a.shape == (10_001,)
    assert torch.equal(a, _mask_plain((7, 9), 10_001, 0.5))
    # A shorter pool is a prefix of a longer one: the counter is the index.
    assert torch.equal(a[:999], _mask_plain((7, 9), 999, 0.5))


def test_distinct_seeds_give_distinct_streams():
    pools = [_mask_plain(s, 4096, 0.5) for s in ((0, 0), (1, 0), (0, 1), (2**32 - 1, 5))]
    for i in range(len(pools)):
        for j in range(i):
            # Independent streams agree on about half the bits.
            agree = (pools[i] == pools[j]).float().mean().item()
            assert 0.45 < agree < 0.55, (i, j, agree)


@pytest.mark.parametrize("keep", [0.5, 0.9, 0.1])
def test_keep_rate_within_five_sigma(keep):
    n = 200_000
    rate = _mask_plain((2024, 11), n, keep).double().mean().item()
    assert abs(rate - keep) < 5 * np.sqrt(keep * (1 - keep) / n)


def test_threshold_rule_and_keep_bounds_match_jax():
    from tpu_captioner.ops.dropout_mask import random_mask_pool as jax_pool

    assert threshold(0.5) == 2**31
    assert threshold(0.25) == 2**30
    assert threshold(1 - 1e-12) == 2**32 - 1  # clamped, as the TPU kernel's
    for keep in (0.0, 1.0, -0.1, 1.5):
        with pytest.raises(ValueError, match="keep must be in"):
            jax_pool(jax.random.PRNGKey(0), 8, keep, on_tpu=False)
        with pytest.raises(ValueError, match="keep must be in"):
            random_mask_pool((0, 0), 8, keep, "cpu")


def test_cpu_pool_is_the_plain_version_and_launches_nothing():
    before = random_mask_pool.launches
    assert torch.equal(random_mask_pool((3, 4), 1000, 0.5, "cpu"), _mask_plain((3, 4), 1000, 0.5))
    assert random_mask_pool.launches == before
    with pytest.raises(ValueError, match="uint32"):
        random_mask_pool((2**32, 0), 8, 0.5, "cpu")


@pytest.mark.parametrize("num_layers", [2, 4])
def test_pool_demand_matches_jax_counting_pool(num_layers):
    from tpu_captioner.models.layers import mask_pool_scope as jax_scope
    from tpu_captioner.train.steps import _CountingPool

    jmodel, params = jax_model_and_params(seed=0, num_layers=num_layers)
    b, length, side = 2, 12, SMALL["encoded_image_size"]
    caps = jnp.ones((b, length), jnp.int32)
    enc_out = jnp.zeros((b, side, side, SMALL["encoder_dim"]))
    cp = _CountingPool()
    with jax_scope(cp):
        jmodel.decoder.tf_forward(
            params["decoder"], enc_out, caps, rng=jax.random.PRNGKey(1), deterministic=False
        )
    cfg = ModelConfig(**{**SMALL, "num_layers": num_layers})
    assert pool_demand(cfg, b, length, side * side) == cp.total


def test_flagship_pool_demand():
    # Batch 32, T 52, E 512, H 8, 7x7 pixels, FFN 512, 6 layers: the count
    # jax.eval_shape gives for the JAX package's flagship train step.
    assert pool_demand(ModelConfig(vocab_size=9490), 32, 52, 49) == 29_366_272


def test_pool_layout_matches_jax_stripes():
    from tpu_captioner.models.layers import MaskPool as JaxMaskPool
    from tpu_captioner.models.layers import mask_pool_scope as jax_scope
    from tpu_captioner_torch.models.layers import MaskPool, mask_pool_scope

    jmodel, params = jax_model_and_params(seed=2, decoder="transformer_attvis", dropout=0.3)
    model = port_model(params, decoder="transformer_attvis", dropout=0.3)
    rng = np.random.default_rng(9)
    b, length, side = 3, SMALL["max_len"], SMALL["encoded_image_size"]
    caps = rng.integers(1, START, (b, length)).astype(np.int32)
    caps[:, 0] = START
    caps[1, 9:] = 0  # padding, masked as keys
    enc_out = rng.standard_normal((b, side, side, SMALL["encoder_dim"])).astype(np.float32)
    n = pool_demand(model.cfg, b, length, side * side)
    bits = rng.random(n) < 0.7

    jpool = JaxMaskPool(jnp.asarray(bits), 0.7)
    with jax_scope(jpool):
        jl, ja = jmodel.decoder.tf_forward(
            params["decoder"], jnp.asarray(enc_out), jnp.asarray(caps),
            key_padding_mask=jnp.asarray(caps == 0), rng=jax.random.PRNGKey(0),
            deterministic=False,
        )
    pool = MaskPool(t(bits), 0.7)
    with mask_pool_scope(pool), torch.no_grad():
        pl, pa = model.decoder.tf_forward(
            t(enc_out), t(caps).long(), t(caps == 0), train=True
        )
    assert pool.offset == jpool.offset == n
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), atol=1e-5, rtol=0)
    # The masks matter: the deterministic pass differs.
    with torch.no_grad():
        dl, _ = model.decoder.tf_forward(t(enc_out), t(caps).long(), t(caps == 0))
    assert (dl - pl).abs().max().item() > 1e-2


def test_pool_overdraw_and_rate_mismatch_raise():
    from tpu_captioner_torch.models.layers import MaskPool

    pool = MaskPool(torch.ones(10, dtype=torch.bool), 0.5)
    with pytest.raises(ValueError, match="keep"):
        pool.take((2,), 0.6)
    pool.take((2, 4), 0.5)
    with pytest.raises(ValueError, match="exhausted"):
        pool.take((3,), 0.5)
