"""The port's decode step against the JAX package, on the same weights.

- The fused step's plain version (what the CPU wrapper runs) plus
  ``apply_cache_update``, over 3 positions, against JAX ``fused_decode_step``
  in interpret mode: logits to 2e-5 and alpha to 2e-6 (the tolerances of
  tests/test_decode_kernel.py), caches to 1e-5.
- The plain head-split ``TransformerDecoder.decode_step`` (the beam's
  kernel-off path) against JAX ``decode_step``, to the same tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_helpers import SMALL, jax_model_and_params, port_model, t
from tpu_captioner.models.layers import linear as jax_linear
from tpu_captioner.ops.decode_step import (
    apply_cache_update as jax_apply_cache_update,
    fused_decode_step as jax_fused_decode_step,
    prepare_cross_memory as jax_prepare_cross_memory,
    prepare_decode_weights as jax_prepare_decode_weights,
)
from tpu_captioner_torch.ops.decode_step import (
    apply_cache_update,
    fused_decode_step,
    prepare_cross_memory,
    prepare_decode_weights,
)

B, T, STEPS = 4, 8, 3
L, E, P = SMALL["num_layers"], SMALL["embed_dim"], SMALL["encoded_image_size"] ** 2


@pytest.fixture(scope="module")
def setup():
    jmodel, params = jax_model_and_params(seed=3)
    model = port_model(params)
    rng = np.random.default_rng(7)
    enc_out = rng.standard_normal((B, 2, 2, SMALL["encoder_dim"])).astype(np.float32)
    toks = rng.integers(1, SMALL["vocab_size"], (STEPS, B))
    return jmodel, params, model, enc_out, toks


def test_fused_step_matches_jax_kernel_over_positions(setup):
    jmodel, params, model, enc_out, toks = setup
    jdec, p = jmodel.decoder, jax_tree(params["decoder"])
    jmem = jdec._project_memory(p, jnp.asarray(enc_out))
    jw = jax_prepare_decode_weights(p["layers"], E)
    jmk, jmv = jax_prepare_cross_memory(p["layers"], jmem, E)
    jck = jnp.zeros((L, B, T, E))
    jcv = jnp.zeros_like(jck)

    dec = model.decoder
    with torch.inference_mode():
        mem = dec.project_memory(t(enc_out))
        w = prepare_decode_weights(dec.layers, E)
        mk, mv = prepare_cross_memory(dec.layers, mem, E)
        ck = torch.zeros(L, B, T, E)
        cv = torch.zeros_like(ck)
        for pos in range(STEPS):
            jt = jnp.asarray(toks[pos], jnp.int32)
            jx = jdec._embed(p, jt[:, None], jnp.int32(pos)[None], None, True)[:, 0, :]
            jx_out, jalpha, jk, jv = jax_fused_decode_step(
                jw, jx, jnp.int32(pos), jck, jcv, jmk, jmv, SMALL["num_heads"], interpret=True
            )
            jck, jcv = jax_apply_cache_update(jck, jcv, jk, jv, jnp.int32(pos))
            jlogits = jax_linear(p["fc_out"], jx_out)

            x = dec.embed(t(toks[pos]), pos)
            x_out, alpha, k_new, v_new = fused_decode_step(
                w, x, pos, ck, cv, mk, mv, SMALL["num_heads"]
            )
            ck, cv = apply_cache_update(ck, cv, k_new, v_new, pos)
            logits = dec.fc_out(x_out)

            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha), rtol=2e-5, atol=2e-6)
            np.testing.assert_allclose(ck.numpy(), np.asarray(jck), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(cv.numpy(), np.asarray(jcv), rtol=1e-5, atol=1e-5)


def test_plain_decode_step_matches_jax_decode_step(setup):
    jmodel, params, model, enc_out, toks = setup
    jdec, p = jmodel.decoder, jax_tree(params["decoder"])
    jmemory = jdec.precompute_memory(p, jnp.asarray(enc_out))
    jcache = jdec.init_cache(B, T)
    dec = model.decoder
    with torch.inference_mode():
        memory = dec.precompute_memory(t(enc_out))
        cache = dec.init_cache(B, T)
        np.testing.assert_allclose(memory.k.numpy(), np.asarray(jmemory.k), rtol=1e-5, atol=1e-5)
        for pos in range(STEPS):
            jlogits, jcache, jalpha = jdec.decode_step(
                p, jnp.asarray(toks[pos], jnp.int32), jnp.int32(pos), jcache, jmemory,
                deterministic=True,
            )
            logits, cache, alpha = dec.decode_step(t(toks[pos]), pos, cache, memory)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha), rtol=2e-5, atol=2e-6)
            np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), rtol=1e-5, atol=1e-5)


def jax_tree(tree):
    import jax

    return jax.tree_util.tree_map(jnp.asarray, tree)
