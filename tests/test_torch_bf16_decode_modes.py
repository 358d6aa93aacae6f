"""The Transformer's one-cell and ``'mega'`` decode modes in bf16
(``compute_dtype='bfloat16'``) against the JAX package's ``precise=False``
kernels in interpret mode, on the CPU, with ``tests/test_torch_helpers.py``'s
small configuration.

- One-cell: ``fused_decode_step(one_cell=True)`` with bf16 weights, caches
  and memory K/V (its plain version on the CPU) equals the per-layer bf16
  step bit for bit, and JAX's ``fused_decode_step(one_cell=True,
  precise=False)`` within the per-layer arm's limits
  (``tests/test_torch_bf16_ops.py``): x_out and alpha within 2e-3 x max(1,
  max |JAX|), k_new and v_new within one bf16 ulp.
- The whole rollout: ``_full_rollout_plain_bf16`` (the CPU wrapper) against
  JAX's ``fused_full_rollout(precise=False)`` on ``storage_dtype=bf16``
  operands (the six matrices, memory K/V, embedding table and fc_w in
  bf16; fc_b and the PE table f32), with and without a teacher mix (the
  same masks fed to both): the sequences equal except after a near-tie,
  logits and maps within 2e-3 x max(1, max |JAX|) up to a row's first
  difference; and a bf16 ``CaptionModel`` in ``'mega'`` against JAX's
  ``TransformerDecoder.mega_rollout(storage_dtype=bfloat16,
  precise=False)`` on the same bf16 features.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bf16_ops import assert_within_ulp, jnp_bf16, to_bf16
from tests.test_torch_helpers import SMALL, images, jax_model_and_params, port_model, t
from tpu_captioner.ops.decode_step import (
    cast_weight_matrices as jax_cast_weight_matrices,
    fused_decode_step as jax_fused_decode_step,
    fused_full_rollout as jax_fused_full_rollout,
    prepare_cross_memory as jax_prepare_cross_memory,
    prepare_decode_weights as jax_prepare_decode_weights,
)
from tpu_captioner_torch.ops.decode_step import (
    cast_weight_matrices,
    fused_decode_step,
    fused_full_rollout,
    prepare_cross_memory,
    prepare_decode_weights,
)

BF = torch.bfloat16
REL = 2e-3
B, T = 3, 8
L, P = SMALL["num_layers"], SMALL["encoded_image_size"] ** 2
E, H, V = SMALL["embed_dim"], SMALL["num_heads"], SMALL["vocab_size"]
START, END = 55, 56


def jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def rel_err(got, want) -> float:
    want = np.asarray(want, dtype=np.float32)
    return float(np.abs(np.asarray(got, dtype=np.float32) - want).max() / max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def setup():
    """JAX model and params, the port on the same weights, and the bf16
    operands of both packages' kernels for projected memory of B rows."""
    jmodel, params = jax_model_and_params(seed=7)
    model = port_model(params)
    dec = model.decoder
    rng = np.random.default_rng(7)
    with torch.inference_mode():
        mem = dec.project_memory(t(rng.standard_normal((B, 2, 2, SMALL["encoder_dim"])).astype(np.float32)))
        w = cast_weight_matrices(prepare_decode_weights(dec.layers, E), BF)
        mk, mv = (m.to(BF) for m in prepare_cross_memory(dec.layers, mem, E))
    p = params["decoder"]
    jw = jax_cast_weight_matrices(jax_prepare_decode_weights(jax_tree(p["layers"]), E), jnp.bfloat16)
    return jmodel, params, model, w, mk, mv, jw


@pytest.mark.parametrize("pos", [0, 5])
def test_onecell_bf16_equals_per_layer_and_matches_jax(setup, pos):
    """Measured: x_out within 2.6e-7 (pos 0) and 1.4e-7 (pos 5) of max(1,
    max |JAX|), alpha 3.0e-8; k_new and v_new equal."""
    _, _, _, w, mk, mv, jw = setup
    rng = np.random.default_rng(pos + 20)
    x = to_bf16(rng.standard_normal((B, E)))
    ck, cv = to_bf16(rng.standard_normal((L, B, T, E))), to_bf16(rng.standard_normal((L, B, T, E)))
    before = fused_decode_step.onecell_launches, fused_decode_step.onecell_bf16_launches
    with torch.inference_mode():
        got = fused_decode_step(w, x, pos, ck, cv, mk, mv, H, one_cell=True)
        per_layer = fused_decode_step(w, x, pos, ck, cv, mk, mv, H)
    assert (fused_decode_step.onecell_launches, fused_decode_step.onecell_bf16_launches) == before  # CPU: plain
    assert [g.dtype for g in got] == [torch.float32, torch.float32, BF, BF]
    assert all(torch.equal(a, b) for a, b in zip(got, per_layer))
    want = jax_fused_decode_step(jw, jnp_bf16(x), jnp.int32(pos), jnp_bf16(ck), jnp_bf16(cv), jnp_bf16(mk),
                                 jnp_bf16(mv), H, one_cell=True, interpret=True, precise=False)
    for a, b in zip(got[:2], want[:2]):
        assert rel_err(a.numpy(), b) < REL
    for a, b in zip(got[2:], want[2:]):
        assert_within_ulp(a, b)


def assert_rollouts_agree(got, want):
    """Per row: the tokens equal up to the first difference, a near-tie of
    JAX's logits (within REL x max(1, max |JAX|)); logits and maps within
    the same up to it.  Returns the largest logit and map errors."""
    (gl, gs, ga), (wl, ws, wa) = got, (np.asarray(x) for x in want)
    scale = max(1.0, np.abs(wl).max())
    worst = [0.0, 0.0]
    for r in range(ws.shape[0]):
        diff = np.nonzero(gs[r].numpy() != ws[r])[0]
        upto = ws.shape[1] if len(diff) == 0 else int(diff[0]) + 1
        if len(diff):
            s = upto - 1
            assert abs(wl[r, s, int(gs[r, s])] - wl[r, s, int(ws[r, s])]) < REL * scale, (r, s)
        worst[0] = max(worst[0], np.abs(gl[r, :upto].numpy() - wl[r, :upto]).max() / scale)
        worst[1] = max(worst[1], np.abs(ga[r, :upto].numpy() - wa[r, :upto]).max())
    assert worst[0] <= REL and worst[1] <= REL, worst
    return worst


@pytest.mark.parametrize("teacher", [False, True])
def test_bf16_rollout_plain_matches_jax_mega_kernel(setup, teacher):
    """Measured: the sequences equal; logits within 7.3e-4 (without the
    mix: a bf16 rounding flipped) and 1.3e-7 (with it) of max(1, max
    |JAX|), maps 3.0e-8."""
    _, params, model, w, mk, mv, jw = setup
    steps = T
    dec = model.decoder
    rng = np.random.default_rng(11)
    emb = dec.embedding.weight.detach().to(BF)
    fc_w, fc_b = dec.fc_out.weight.detach().to(BF), dec.fc_out.bias.detach()
    pe = dec.pe[:steps]
    mix = {}
    if teacher:
        mix = dict(teacher=t(rng.integers(1, 54, (steps, B)).astype(np.int32)),
                   use_teacher=t(rng.random((steps, B)) < 0.5))
    before = fused_full_rollout.launches, fused_full_rollout.bf16_launches
    with torch.inference_mode():
        got = fused_full_rollout(w, emb, fc_w, fc_b, pe, mk, mv, START, END, steps, H, **mix)
    assert (fused_full_rollout.launches, fused_full_rollout.bf16_launches) == before  # CPU: plain
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    jmix = {k: jnp.asarray(v.numpy()) for k, v in mix.items()}
    want = jax_fused_full_rollout(jw, jnp_bf16(emb), jnp_bf16(fc_w).T, jnp.asarray(fc_b.numpy()),
                                  jnp.asarray(pe.numpy()), jnp_bf16(mk), jnp_bf16(mv), START, END, steps, H,
                                  interpret=True, precise=False, **jmix)
    assert_rollouts_agree(got, want)


def test_bf16_mega_model_matches_jax_mega_rollout():
    """A bf16 ``CaptionModel`` with ``decode_kernel='mega'`` (the rollout's
    bf16 instance, its plain version on the CPU) against JAX's
    ``mega_rollout(storage_dtype=bfloat16, precise=False)`` on JAX's bf16
    encoder output; its one-cell ``'step'`` rollout equals the per-layer
    one.  JAX casts every layer weight to bf16 there, the biases and
    LayerNorm parameters too; so does the port's ``mega_rollout``.
    Measured: the sequences equal, logits within 1.4e-7 of max(1, max
    |JAX|), maps 3.0e-8."""
    jmodel, params = jax_model_and_params(seed=8, decoder="transformer_attvis", use_pallas="off",
                                          compute_dtype="bfloat16")
    enc = jmodel.encode(params, jnp.asarray(images(B, seed=5)))
    assert enc.dtype == jnp.bfloat16
    want = jmodel.decoder.mega_rollout(jax_tree(params["decoder"]), enc, START, END, T, interpret=True,
                                       precise=False, storage_dtype=jnp.bfloat16)
    enc_t = to_bf16(np.asarray(enc.astype(jnp.float32)))
    rolls = {}
    for mode, one_cell in (("mega", False), ("step", True), ("step", False)):
        model = port_model(params, decoder="transformer_attvis", use_pallas="off", decode_kernel=mode,
                           compute_dtype="bfloat16")
        with torch.inference_mode():
            rolls[mode, one_cell] = model.rollout(enc_t, START, END, T, one_cell=one_cell)
    assert_rollouts_agree(rolls["mega", False], want)
    assert all(torch.equal(a, b) for a, b in zip(rolls["step", True], rolls["step", False]))
