"""bf16 in ``use_pallas='block'`` and in the sub-tiled MLP tail
(``TPU_CAPTIONER_MLP_SUB``): the plain versions that the CPU wrappers run
(and that the CUDA instances are held against on the card) and the bf16
block's gradients against the JAX package on numpy-seeded inputs, then a
bf16 model in ``'block'`` and in a per-stage mix against JAX's bf16 model.

- ``_block_plain_bf16`` against JAX ``fused_convnext_block`` on bf16 x,
  taps, w1 and w2 (the rest f32, as ``models/convnext.py:142-149`` passes
  them) through its Pallas kernel under ``pltpu.force_tpu_interpret_mode()``,
  and ``_mlp_plain_bf16`` against JAX ``fused_convnext_mlp`` with
  ``TPU_CAPTIONER_MLP_SUB=64`` (its ``_kernel_pipelined``) in interpret
  mode: within one bf16 ulp of the JAX value, at least 2^-8, elementwise
  (``tests/test_torch_bf16_ops.py:assert_within_ulp``): f32 sums in
  another order, and the Pallas GELU's erf 1.5e-7 off, may round to the
  neighbouring bf16 value, and no further.
- The block's gradients through the port's autograd function against
  ``jax.vjp`` of JAX's bf16 ``fused_convnext_block`` (the VJP of its
  reference): the bf16 ones (x, taps, w1, w2) within one bf16 ulp of
  max(1, max |JAX|), the f32 ones (sd, conv bias, LayerNorm, b1, b2, layer
  scale) within 1e-4 times the same, as the f32 block's gradient test.
- The encoder in ``'block'`` and in ``('mlp', 'mlp', 'block', 'block')``
  against JAX's bf16 encoder with its kernels in interpret mode: within
  2^-6 x max(1, max |ref|), as ``tests/test_torch_bf16_model.py``.
- The frozen and fine-tune steps: ``tests/test_torch_bf16_block_train.py``.
- The dtype sets the block refuses, on the CPU too; the bf16 plan.
- ``cli.caption``'s loader on a bf16 checkpoint directory whose
  ``use_pallas`` is a per-stage list holding ``'block'``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bf16_model import ENC_TOL, encoder_err
from tests.test_torch_bf16_ops import BF, assert_within_ulp, jnp_bf16, to_bf16
from tests.test_torch_helpers import images, jax_model_and_params, port_model, t
from tpu_captioner.ops.block_fused import fused_convnext_block as jax_block
from tpu_captioner.ops.mlp_block import _pipeline_sub as jax_pipeline_sub
from tpu_captioner.ops.mlp_block import fused_convnext_mlp as jax_mlp
from tpu_captioner_torch.models.convnext import CNBlock
from tpu_captioner_torch.ops import block_fused
from tpu_captioner_torch.ops.block_fused import _block_plain_bf16, block_plan, fused_convnext_block
from tpu_captioner_torch.ops.dwconv import PAD
from tpu_captioner_torch.ops.mlp_block import _mlp_plain_bf16, _pipeline_sub, fused_convnext_mlp

MIX = ("mlp", "mlp", "block", "block")
NAMES = ("x", "sd", "dw_w", "dw_b", "ln_w", "ln_b", "w1", "b1", "w2", "b2", "gamma")
BF16_GRADS = ("x", "dw_w", "w1", "w2")


def block_args(shape, sd, seed):
    """The block's operands as the JAX bf16 model hands them to its kernel:
    JAX layouts (w1 (C, 4C), w2 (4C, C)), x, taps, w1 and w2 rounded to
    bf16 (torch tensors), the rest f32 numpy."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (to_bf16(f(*shape)), np.asarray(sd, np.float32), to_bf16(0.1 * f(7, 7, c)), 0.1 * f(c),
            1.0 + 0.1 * f(c), 0.1 * f(c), to_bf16(0.05 * f(c, 4 * c)), 0.1 * f(4 * c),
            to_bf16(0.05 * f(4 * c, c)), 0.1 * f(c), 0.5 * f(c))


def jax_args(a):
    return tuple(jnp_bf16(v) if isinstance(v, torch.Tensor) else jnp.asarray(v) for v in a)


def port_args(a, requires_grad=False):
    out = [v if isinstance(v, torch.Tensor) else t(v) for v in a]
    out[6], out[8] = out[6].T.contiguous(), out[8].T.contiguous()  # the nn.Linear layouts
    return tuple(v.clone().requires_grad_(requires_grad) for v in out)


@pytest.mark.parametrize("shape,sd", [((2, 8, 8, 128), (1.0, 2.0)), ((2, 9, 7, 32), (0.0, 1.25))])
def test_block_bf16_plain_matches_jax_pallas_kernel(shape, sd):
    from jax.experimental.pallas import tpu as pltpu

    a = block_args(shape, sd, seed=shape[1] + shape[3])
    with pltpu.force_tpu_interpret_mode():
        want = jax_block(*jax_args(a), True)
    assert want.dtype == jnp.bfloat16
    args = port_args(a)
    got = _block_plain_bf16(*args)
    assert got.dtype == BF
    assert_within_ulp(got, want)
    assert torch.equal(got[args[1] == 0], args[0][args[1] == 0])  # sd 0: the input, bit for bit
    # The CPU wrapper runs the plain version and launches nothing.
    before = fused_convnext_block.launches, fused_convnext_block.bf16_launches
    with torch.no_grad():
        assert torch.equal(fused_convnext_block(*args), got)
    assert (fused_convnext_block.launches, fused_convnext_block.bf16_launches) == before


@pytest.mark.parametrize("c,n", [(128, 256), (256, 192)])
def test_mlp_bf16_plain_matches_jax_pipelined_kernel(monkeypatch, c, n):
    """JAX's sub-tiled body (``_kernel_pipelined``, 4 and 3 sub-tiles of 64
    rows) on bf16 operands; the port's ``_pipeline_sub`` takes the same
    value."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("TPU_CAPTIONER_MLP_SUB", "64")
    assert jax_pipeline_sub(n, n) == 64 and _pipeline_sub(n, c) == 64
    rng = np.random.default_rng(c + n)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, res = to_bf16(f(n, c)), to_bf16(f(n, c))
    w1, w2 = to_bf16(0.05 * f(c, 4 * c)), to_bf16(0.05 * f(4 * c, c))
    sd = np.where(rng.random(n) < 0.7, 2.0, 0.0).astype(np.float32)
    vec = (1.0 + 0.1 * f(c), 0.1 * f(c))
    b1, b2, gamma = 0.1 * f(4 * c), 0.1 * f(c), 0.5 * f(c)
    with pltpu.force_tpu_interpret_mode():
        want = jax_mlp(jnp_bf16(x), jnp_bf16(res), jnp.asarray(sd), *map(jnp.asarray, vec), jnp_bf16(w1),
                       jnp.asarray(b1), jnp_bf16(w2), jnp.asarray(b2), jnp.asarray(gamma), True, True)
    assert want.dtype == jnp.bfloat16
    args = (x, res, t(sd), *map(t, vec), w1.T.contiguous(), t(b1), w2.T.contiguous(), t(b2), t(gamma))
    got = _mlp_plain_bf16(*args)
    assert_within_ulp(got, want)
    before = fused_convnext_mlp.pipelined_launches, fused_convnext_mlp.pipelined_bf16_launches
    with torch.no_grad():
        assert torch.equal(fused_convnext_mlp(*args), got)  # the CPU wrapper's plain version
    assert (fused_convnext_mlp.pipelined_launches, fused_convnext_mlp.pipelined_bf16_launches) == before


@pytest.mark.parametrize("sd", [(1.0, 2.0), (0.0, 1.25)])
def test_block_bf16_gradients_match_jax_vjp(sd):
    """All 11 gradients through the port's backward (the bf16 conv
    recomputed and widened plus the f32 bias, the tail's f32 backward on
    the widened operands, d_t rounded for the bf16 conv gradients, the bias
    gradient from the unrounded d_t) against ``jax.vjp`` of JAX's bf16
    block."""
    a = block_args((2, 9, 7, 32), sd, seed=3)  # odd sides: every tap crosses an edge somewhere
    g = to_bf16(np.random.default_rng(4).standard_normal(a[0].shape))
    out, vjp = jax.vjp(lambda *v: jax_block(*v, False), *jax_args(a))
    assert out.dtype == jnp.bfloat16
    want = vjp(jnp_bf16(g))
    args = port_args(a, requires_grad=True)
    got_out = fused_convnext_block(*args)
    assert_within_ulp(got_out.detach(), out)
    got_out.backward(g)
    for name, arg, w in zip(NAMES, args, want):
        w = np.asarray(w.astype(jnp.float32) if w.dtype == jnp.bfloat16 else w)
        got = arg.grad
        assert got.dtype == arg.dtype, name
        got = got.float().numpy()
        if name in ("w1", "w2"):
            got = got.T
        scale = max(1.0, float(np.abs(w).max()))
        tol = 2.0 ** (np.floor(np.log2(scale)) - 7) if name in BF16_GRADS else 1e-4 * scale
        np.testing.assert_allclose(got, w, atol=tol, rtol=0, err_msg=name)


def test_block_bf16_refuses_other_dtype_sets():
    """Exactly one bf16 set (x, taps, w1, w2 bf16; the rest f32): a bf16 x
    with an f32 operand of that set, an f32 x with one of them bf16, or a
    bf16 vector raises ValueError, on the CPU too."""
    args = list(port_args(block_args((1, 8, 8, 16), (1.0,), seed=5)))
    with torch.no_grad():
        assert fused_convnext_block(*args).dtype == BF
    for i, name in enumerate(NAMES):
        bad = list(args)
        bad[i] = bad[i].float() if bad[i].dtype == BF else bad[i].to(BF)
        culprit = "dw_w" if name == "x" else name  # an f32 x asks for the f32 set: the bf16 taps break it
        with pytest.raises(ValueError, match=f"{culprit} must be"):
            fused_convnext_block(*bad)
    f32 = [v.float() for v in args]
    for i in (2, 6, 8):  # an f32 block with one bf16 matrix or the taps
        bad = list(f32)
        bad[i] = bad[i].to(BF)
        with pytest.raises(ValueError, match=f"{NAMES[i]} must be float32"):
            fused_convnext_block(*bad)


@pytest.mark.parametrize("shape", [(8, 64, 64, 128), (32, 64, 64, 128), (32, 32, 32, 256), (8, 16, 16, 512),
                                   (32, 8, 8, 1024), (3, 14, 14, 512), (2, 9, 7, 128)])
def test_block_plan_bf16_fits_and_covers(shape):
    """The bf16 instance's plan: boxes of 2-byte elements, so at least as
    many ring slots as the f32 plan's; the same tiles (coverage:
    ``tests/test_torch_block_plan.py``)."""
    plan, f32 = block_plan(*shape, esize=2), block_plan(*shape)
    box = 2 * (plan.th + 2 * PAD) * (plan.tw + 2 * PAD) * plan.cc
    assert plan._replace(slots=0, smem=0) == f32._replace(slots=0, smem=0)
    assert f32.slots <= plan.slots <= 4 and plan.smem <= block_fused.SMEM_LIMIT and box % 128 == 0
    assert plan.smem == block_fused._HEADER + block_fused._SMALL + plan.slots * box
    with pytest.raises(ValueError, match="4 or 2 bytes"):
        block_plan(*shape, esize=8)


@pytest.mark.parametrize("mode", ["block", MIX], ids=str)
def test_bf16_block_encoder_matches_jax(mode):
    from jax.experimental.pallas import tpu as pltpu

    imgs = images(2, seed=3)
    with pltpu.force_tpu_interpret_mode():
        jmodel, params = jax_model_and_params(seed=1, use_pallas=mode, encoder_remat="off", compute_dtype="bfloat16")
        want = jmodel.encode(params, jnp.asarray(imgs))
    assert want.dtype == jnp.bfloat16
    model = port_model(params, use_pallas=mode, compute_dtype="bfloat16")
    modes = [b.mode for b in model.modules() if isinstance(b, CNBlock)]
    assert "block" in modes and (mode == "block") == (set(modes) == {"block"})
    before = fused_convnext_block.launches
    with torch.inference_mode():
        got = model.encode(torch.from_numpy(imgs))
    assert fused_convnext_block.launches == before  # CPU tensors launch nothing
    assert got.dtype == BF and tuple(got.shape) == want.shape
    assert encoder_err(got, want) <= ENC_TOL


def test_cli_loader_rebuilds_a_bf16_block_checkpoint(tmp_path):
    """``cli.caption``'s loader on a ``save_checkpoint`` directory of a bf16
    model whose ``use_pallas`` is a per-stage list holding ``'block'``: the
    list and bfloat16 come back from ``meta.json`` with the weights, and the
    beams equal the saved model's; ``--usePallas block`` overrides the list."""
    import argparse
    import dataclasses

    from tests.test_torch_helpers import END, START
    from tpu_captioner_torch.cli import caption
    from tpu_captioner_torch.core.config import ExperimentConfig, ModelConfig, TrainConfig
    from tpu_captioner_torch.train.checkpoint import save_checkpoint
    from tpu_captioner_torch.train.model import CaptionModel
    from tpu_captioner_torch.train.state import TrainState

    tiny = dict(vocab_size=START + 2, embed_dim=16, decoder_dim=16, num_heads=2, num_layers=1, max_len=8,
                encoder_depths=(1, 1, 1, 1), encoder_dims=(8, 8, 8, 8), encoder_dim=8, compute_dtype="bfloat16",
                use_pallas=MIX)
    model = CaptionModel(ModelConfig(**tiny), device="cpu", seed=2)
    meta = {"epoch": 0, "epochs_since_improvement": 0, "bleu4": 0.0, "results": [],
            "config": dataclasses.asdict(ExperimentConfig(model=model.cfg, train=TrainConfig()))}
    path = save_checkpoint(str(tmp_path), "checkpoint_bf16_block", TrainState.create(model, TrainConfig()), meta)
    word_map = {f"w{i}": i for i in range(START)}
    word_map.update({"<start>": START, "<end>": END})
    stages = lambda m: [b.mode for b in m.modules() if isinstance(b, CNBlock)]  # noqa: E731
    for flag, want in ((None, list(MIX)), ("block", ["block"] * 4)):
        loaded = caption.build_model_and_params(
            argparse.Namespace(checkpoint=path, device="cpu", seed=3, usePallas=flag), word_map)
        assert loaded.dtype == BF and stages(loaded) == want
        assert all(torch.equal(v, model.state_dict()[k]) for k, v in loaded.state_dict().items())
    loaded = caption.build_model_and_params(argparse.Namespace(checkpoint=path, device="cpu", seed=3), word_map)
    imgs = images(2, seed=6)
    for (_, gs, gseq, _), (_, ws, wseq, _) in zip(caption.caption_batch(loaded, imgs, word_map, 2),
                                                  caption.caption_batch(model, imgs, word_map, 2)):
        assert np.array_equal(gseq, wseq) and gs == ws
