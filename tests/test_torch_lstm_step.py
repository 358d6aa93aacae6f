"""The port's LSTM decode step against the JAX package's, on the CPU, and the
build key of the kernel libraries.

Widths are ``tests/test_lstm_kernel.py``'s odd small ones (E 48, D 56, A 36,
C 40, vocab 61, 2x2 pixels), weights drawn by the JAX decoder and bridged
with ``state_dict_from_jax``'s LSTM bridge, inputs numpy-seeded.
Tolerances: h, c and alpha within 1e-5 (f32 products of up to E + C + D =
144 terms summed in another order); the packed kernel weights and the plain
cell exactly where only layouts differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_helpers import t, to_numpy
from tpu_captioner.core.config import ModelConfig as JaxModelConfig
from tpu_captioner.models.layers import linear as jax_linear
from tpu_captioner.models.layers import lstm_cell as jax_lstm_cell
from tpu_captioner.models.lstm import DecoderWithAttention as JaxDecoderWithAttention
from tpu_captioner.ops.lstm_step import fused_lstm_step as jax_fused_lstm_step
from tpu_captioner.ops.lstm_step import prepare_lstm_weights as jax_prepare_lstm_weights
from tpu_captioner_torch.core.config import ModelConfig
from tpu_captioner_torch.models.from_jax import _lstm_decoder_from_jax
from tpu_captioner_torch.models.layers import lstm_cell
from tpu_captioner_torch.models.lstm import DecoderWithAttention
from tpu_captioner_torch.ops import _build
from tpu_captioner_torch.ops.lstm_step import _lstm_step_plain, fused_lstm_step, prepare_lstm_weights

DECODER = dict(
    decoder="lstm", vocab_size=61, embed_dim=48, decoder_dim=56, encoder_dim=40, attention_dim=36,
    max_len=16, encoded_image_size=2, encoder_depths=(1, 1), encoder_dims=(8, 40),
)
P = 4
TOL = 1e-5


@pytest.fixture(scope="module")
def decoders():
    """(JAX decoder, its numpy params, the port's decoder on the same weights)."""
    jdec = JaxDecoderWithAttention(JaxModelConfig(**DECODER))
    params = to_numpy(jdec.init_params(jax.random.PRNGKey(0)))
    dec = DecoderWithAttention(ModelConfig(**DECODER), device="cpu")
    dec.load_state_dict(_lstm_decoder_from_jax(params))
    return jdec, params, dec


def step_inputs(params, rows, seed):
    """emb, h, c, enc, att1 for ``rows`` rows (numpy, f32)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    enc = f(rows, P, DECODER["encoder_dim"])
    att1 = np.asarray(jax_linear(params["attention"]["encoder_att"], jnp.asarray(enc)))
    toks = rng.integers(1, DECODER["vocab_size"], rows)
    emb = params["embedding"][toks]
    d = DECODER["decoder_dim"]
    return emb, 0.5 * f(rows, d), 0.5 * f(rows, d), enc, att1


@pytest.mark.parametrize("rows", [5, 37])  # 37: a ragged second tile of JAX's 32 rows
def test_plain_step_matches_jax_kernel(decoders, rows):
    """``_lstm_step_plain`` against JAX ``fused_lstm_step`` in interpret
    mode with f32 products; the wrapper on CPU tensors gives the plain
    version's result and counts no launch."""
    jdec, params, dec = decoders
    args = step_inputs(params, rows, seed=rows)
    jw = jax_prepare_lstm_weights(jax.tree_util.tree_map(jnp.asarray, params), DECODER["embed_dim"])
    want = jax_fused_lstm_step(jw, *map(jnp.asarray, args), interpret=True, precise=True)
    with torch.no_grad():
        w = prepare_lstm_weights(dec)
        got = _lstm_step_plain(w, *map(t, args))
        before = fused_lstm_step.launches
        again = fused_lstm_step(w, *map(t, args))
    assert fused_lstm_step.launches == before
    for name, g, a, b in zip(("h", "c", "alpha"), got, again, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(b), atol=TOL, rtol=0, err_msg=name)
        assert torch.equal(g, a), name
    np.testing.assert_allclose(got[2].sum(dim=1).numpy(), 1.0, atol=1e-6)


def test_decoder_step_matches_jax_step(decoders):
    """The plain ``DecoderWithAttention.step`` (concatenated cell input,
    matmul score head) against JAX's, over three evolving steps."""
    jdec, params, dec = decoders
    emb, h, c, enc, att1 = step_inputs(params, 6, seed=3)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    rng = np.random.default_rng(4)
    for _ in range(3):
        toks = rng.integers(1, DECODER["vocab_size"], 6)
        emb = params["embedding"][toks]
        want = jdec.step(jp, jnp.asarray(h), jnp.asarray(c), jnp.asarray(emb), jnp.asarray(enc), jnp.asarray(att1))
        with torch.no_grad():
            got = dec.step(t(h), t(c), t(emb), t(enc), t(att1))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)
        h, c = np.asarray(want[0]), np.asarray(want[1])


def test_packed_weights_are_the_jax_layout_transposed(decoders):
    """``prepare_lstm_weights`` holds nn.Linear's (out, in) layout of JAX's
    (in, out) kernel weights, bit for bit."""
    _, params, dec = decoders
    jw = jax_prepare_lstm_weights(jax.tree_util.tree_map(jnp.asarray, params), DECODER["embed_dim"])
    w = prepare_lstm_weights(dec)
    for name in ("wd", "wfb", "w_ih_e", "w_ih_c", "w_hh"):
        np.testing.assert_array_equal(getattr(w, name).numpy(), np.asarray(getattr(jw, name)).T, err_msg=name)
    for name in ("bd", "wfull", "bfull", "bfb", "b"):
        np.testing.assert_array_equal(getattr(w, name).numpy().ravel(), np.asarray(getattr(jw, name)).ravel())
    assert all(x.is_contiguous() and not x.requires_grad for x in w)


def test_lstm_cell_matches_jax(decoders):
    _, params, dec = decoders
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, DECODER["embed_dim"] + DECODER["encoder_dim"])).astype(np.float32)
    h, c = (rng.standard_normal((3, DECODER["decoder_dim"])).astype(np.float32) for _ in range(2))
    want = jax_lstm_cell(jax.tree_util.tree_map(jnp.asarray, params["lstm"]), jnp.asarray(x), jnp.asarray(h),
                         jnp.asarray(c))
    cell = dec.decode_step
    with torch.no_grad():
        got = lstm_cell(t(x), t(h), t(c), cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh)
        ref = cell(t(x), (t(h), t(c)))  # torch's own LSTMCell on the same weights
    for g, w, r in zip(got, want, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=TOL, rtol=0)


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """Editing a header that a kernel source includes (directly or through
    another header) changes the library it builds to; an unrelated file does
    not.  The repository's sources resolve their includes too."""
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// other\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    (tmp_path / "other.cuh").write_text("// other, edited\n")
    assert _build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = _build.library_path("k")
    assert second != first and second.name.startswith("libk-")
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// edited\n')
    assert _build.library_path("k") not in (first, second)
    monkeypatch.undo()
    # The MLP-tail and whole-block sources share the forward products'
    # header, and with the backward the tensor-core GEMM's, which includes
    # the mbarrier and bulk-copy helpers that the decode source includes too;
    # the whole-block source shares the depthwise conv's tile header; the
    # LSTM step takes the GEMM header's 3xTF32 building blocks; the two
    # MLP-tail sources take the bf16 GEMM's header too (precise=False), and
    # so does the whole-block source (its bf16 instance's products).
    bulk = {"mbarrier.cuh"}
    gemm = {"tf32x3_gemm.cuh"} | bulk
    products = {"mlp_products.cuh"} | gemm
    bf16 = {"bf16_gemm.cuh"}
    for name, extra in (("lstm_step", gemm), ("decode_step", bulk), ("mlp_block", products | bf16),
                        ("mlp_block_bwd", gemm | bf16), ("block_fused", products | bf16 | {"dwconv_tile.cuh"})):
        names = {p.name for p in _build._sources(_build.CSRC / f"{name}.cu", {})}
        assert names == {f"{name}.cu", "warp_reduce.cuh", *extra}, names
