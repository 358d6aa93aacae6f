"""The port's decode step against the JAX package, on the same weights.

- The fused step's plain version (what the CPU wrapper runs) plus
  ``apply_cache_update``, over 3 positions, against JAX ``fused_decode_step``
  in interpret mode: logits to 2e-5 and alpha to 2e-6 (the tolerances of
  tests/test_decode_kernel.py), caches to 1e-5.
- The plain head-split ``TransformerDecoder.decode_step`` (the beam's
  kernel-off path) against JAX ``decode_step``, to the same tolerances.
Both at the small configuration's width (E=64, H=4) and at the reference's
pretrained-embedding widths, GloVe-200 (E=200, H=8: head width 25) and
word2vec-300 (E=300, H=6: head width 50), which the kernels take with scalar
key loads; the JAX Pallas kernel runs them in interpret mode as it is.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_helpers import SMALL, jax_model_and_params, port_model, t
from tpu_captioner_torch.core.config import ModelConfig
from tpu_captioner.models.layers import linear as jax_linear
from tpu_captioner.ops.decode_step import (
    apply_cache_update as jax_apply_cache_update,
    fused_decode_step as jax_fused_decode_step,
    prepare_cross_memory as jax_prepare_cross_memory,
    prepare_decode_weights as jax_prepare_decode_weights,
)
from tpu_captioner_torch.ops.decode_step import (
    _weight_shapes,
    apply_cache_update,
    fused_decode_step,
    prepare_cross_memory,
    prepare_decode_weights,
)

B, T, STEPS = 4, 8, 3
L, P = SMALL["num_layers"], SMALL["encoded_image_size"] ** 2
WIDTHS = [(SMALL["embed_dim"], SMALL["num_heads"]), (200, 8), (300, 6)]  # (E, H)


@pytest.fixture(scope="module", params=WIDTHS, ids=lambda eh: f"E{eh[0]}-H{eh[1]}")
def setup(request):
    E, H = request.param
    jmodel, params = jax_model_and_params(seed=3, embed_dim=E, num_heads=H)
    model = port_model(params, embed_dim=E, num_heads=H)
    rng = np.random.default_rng(7)
    enc_out = rng.standard_normal((B, 2, 2, SMALL["encoder_dim"])).astype(np.float32)
    toks = rng.integers(1, SMALL["vocab_size"], (STEPS, B))
    return jmodel, params, model, enc_out, toks, E, H


def test_fused_step_matches_jax_kernel_over_positions(setup):
    jmodel, params, model, enc_out, toks, E, H = setup
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
                jw, jx, jnp.int32(pos), jck, jcv, jmk, jmv, H, interpret=True
            )
            jck, jcv = jax_apply_cache_update(jck, jcv, jk, jv, jnp.int32(pos))
            jlogits = jax_linear(p["fc_out"], jx_out)

            x = dec.embed(t(toks[pos]), pos)
            x_out, alpha, k_new, v_new = fused_decode_step(
                w, x, pos, ck, cv, mk, mv, H
            )
            ck, cv = apply_cache_update(ck, cv, k_new, v_new, pos)
            logits = dec.fc_out(x_out)

            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha), rtol=2e-5, atol=2e-6)
            np.testing.assert_allclose(ck.numpy(), np.asarray(jck), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(cv.numpy(), np.asarray(jcv), rtol=1e-5, atol=1e-5)


def test_plain_decode_step_matches_jax_decode_step(setup):
    jmodel, params, model, enc_out, toks, E, H = setup
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


@pytest.mark.parametrize("E,H", [(200, 8), (300, 6), (512, 8)])
def test_kernel_shape_check_takes_any_head_width(E, H):
    """The kernels' shape check passes the reference's widths (head widths
    25, 50 and 64) and keeps only what the kernels still need."""
    from tpu_captioner_torch.ops.decode_step import DecodeWeights

    Fd, Ln = 512, 2
    shapes = {"w_qkv": (Ln, 3 * E, E), "b_qkv": (Ln, 3 * E), "w_f1": (Ln, Fd, E), "b_f1": (Ln, Fd),
              "w_f2": (Ln, E, Fd)}
    w = DecodeWeights(*(torch.zeros(shapes.get(f, (Ln, E, E) if f in ("w_so", "w_cq", "w_co") else (Ln, E)))
                        for f in DecodeWeights._fields))
    checked = _weight_shapes(w, Ln, E, H)
    assert set(checked) == set(DecodeWeights._fields)
    with pytest.raises(ValueError, match="heads"):
        _weight_shapes(w, Ln, E, 7)
    bad = w._replace(w_f1=torch.zeros(Ln, 510, E))
    with pytest.raises(ValueError, match="divisible by 4"):
        _weight_shapes(bad, Ln, E, H)


def test_embedding_presets_give_the_reference_heads():
    glove = ModelConfig(embedding_name="glove-wiki-gigaword-200")
    word2vec = ModelConfig(embedding_name="word2vec-google-news-300")
    assert (glove.embed_dim, glove.num_heads) == (200, 8)
    assert (word2vec.embed_dim, word2vec.num_heads) == (300, 6)


def jax_tree(tree):
    import jax

    return jax.tree_util.tree_map(jnp.asarray, tree)
