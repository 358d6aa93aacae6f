"""The port's whole-block kernel path (``ops/block_fused.py``, the encoder's
``'block'`` mode) against the JAX package, and the ``use_pallas`` values the
two packages share.

Tolerances:
- ``_block_plain`` against the JAX ``_reference_impl``: 1e-5 absolute, the
  same f32 math in another summation order;
- the CPU wrapper against the JAX Pallas kernel in interpret mode: 3e-4, the
  JAX package's own (tests/test_block_fused.py): its GELU uses the A&S erf;
- the 11 gradients against the JAX ``custom_vjp``: 1e-4 times max(1, the
  largest JAX value); sums over every pixel in two frameworks' orders;
- the encoder against the JAX encoder in ``'off'``: 1e-4 absolute, as
  tests/test_torch_encoder.py;
- the fine-tune step in ``'block'`` against itself in ``'on'``: the
  tolerances of ``chip_smoke.py`` phase 6 (losses 1e-4, top-5 equal, step-1
  gradients 1e-3 in relative norm, parameters 1e-2 * lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_helpers import SMALL, images, jax_model_and_params, port_model, t
from tests.test_torch_train_step import B, WORD_IDS, make_batch
from tpu_captioner.ops.block_fused import _reference_impl
from tpu_captioner.ops.block_fused import fused_convnext_block as jax_block
from tpu_captioner_torch.core import prng
from tpu_captioner_torch.core.config import KERNEL_MODES, ModelConfig, TrainConfig, stage_kernel_modes
from tpu_captioner_torch.models.convnext import CNBlock
from tpu_captioner_torch.ops.block_fused import _block_plain, fused_convnext_block
from tpu_captioner_torch.train.state import TrainState
from tpu_captioner_torch.train.steps import make_train_step

C = 128


def make_args(shape=(2, 8, 8, C), sd=(1.0, 2.0), seed=0):
    """JAX-layout numpy args: w1 (C, 4C), w2 (4C, C)."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (
        f(*shape), np.asarray(sd, np.float32), 0.05 * f(7, 7, c), 0.1 * f(c),
        1.0 + 0.1 * f(c), 0.1 * f(c), 0.05 * f(c, 4 * c), 0.1 * f(4 * c),
        0.05 * f(4 * c, c), 0.1 * f(c), 0.5 * f(c),
    )


def port_args(a, requires_grad=False):
    x, sd, dw_w, dw_b, lns, lnb, w1, b1, w2, b2, gamma = (t(v) for v in a)
    out = (x, sd, dw_w, dw_b, lns, lnb, w1.T.contiguous(), b1, w2.T.contiguous(), b2, gamma)
    return tuple(v.requires_grad_(requires_grad) for v in out)


@pytest.mark.parametrize("sd", [(1.0, 2.0), (0.0, 1.25)])
def test_plain_matches_jax_reference(sd):
    a = make_args(sd=sd)
    want = np.asarray(_reference_impl(*map(jnp.asarray, a)))
    got = _block_plain(*port_args(a)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(2, 8, 8, C), (2, 16, 64, C)])  # one tile; tiles with halo seams
@pytest.mark.parametrize("sd", [(1.0, 2.0), (1.0, 0.5)])
def test_cpu_wrapper_matches_pallas_kernel(shape, sd):
    from jax.experimental.pallas import tpu as pltpu

    a = make_args(shape, sd, seed=shape[2])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_block(*map(jnp.asarray, a), True))
    before = fused_convnext_block.launches
    got = fused_convnext_block(*port_args(a)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=0)
    assert fused_convnext_block.launches == before  # CPU tensors launch nothing


NAMES = ("x", "sd", "dw_w", "dw_b", "ln_w", "ln_b", "w1", "b1", "w2", "b2", "gamma")


@pytest.mark.parametrize("sd", [(1.0, 2.0), (0.0, 1.25)])
def test_gradients_match_jax_custom_vjp(sd):
    """All 11 gradients, through the port's backward composition (conv
    recomputed, the tail's backward, the conv's input and filter
    gradients), against ``jax.grad`` through the JAX ``custom_vjp``."""
    a = make_args((2, 9, 7, C), sd, seed=3)  # odd sides: every tap crosses an edge somewhere
    g = np.random.default_rng(4).standard_normal(a[0].shape).astype(np.float32)
    want = jax.grad(lambda *v: jnp.sum(jax_block(*v, False) * g), argnums=tuple(range(11)))(
        *map(jnp.asarray, a))
    args = port_args(a, requires_grad=True)
    (fused_convnext_block(*args) * t(g)).sum().backward()
    for name, arg, w in zip(NAMES, args, want):
        w = np.asarray(w)
        got = arg.grad.numpy()
        if name in ("w1", "w2"):
            got = got.T
        np.testing.assert_allclose(got, w, atol=1e-4 * max(1.0, np.abs(w).max()), rtol=0, err_msg=name)


def test_gradient_skips_what_needs_none():
    """With only the weights trained (the first block after a frozen child),
    the input gradient is not computed and x gets none."""
    args = port_args(make_args((2, 8, 8, C)))
    for v in args[2:]:
        v.requires_grad_(True)
    fused_convnext_block(*args).sum().backward()
    assert args[0].grad is None and args[1].grad is None
    assert all(v.grad is not None and torch.isfinite(v.grad).all() for v in args[2:])


@pytest.mark.parametrize("use_pallas", ["block", ("block", "mlp", "off", "block"), ("off", "block", "block", "mlp")])
def test_encoder_matches_jax(use_pallas):
    jmodel, params = jax_model_and_params(seed=1, use_pallas="off")
    model = port_model(params, use_pallas=use_pallas)
    modes = [blk.mode for blk in model.modules() if isinstance(blk, CNBlock)]
    depths = SMALL["encoder_depths"]
    assert modes == [m for m, d in zip(stage_kernel_modes(use_pallas, 4), depths) for _ in range(d)]
    imgs = images(2, seed=5)
    want = np.asarray(jmodel.encode(params, imgs))
    got = model.encode(torch.from_numpy(imgs)).numpy()
    assert got.shape == want.shape == (2, 2, 2, 32)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def fine_tune_run(use_pallas, encoder_remat="off", steps=2):
    """Losses, metrics, step-1 gradients and parameters after ``steps``
    fine-tune steps with stochastic depth and dropout from the step seeds."""
    _, params = jax_model_and_params(seed=6)
    model = port_model(params, use_pallas=use_pallas, encoder_remat=encoder_remat)
    tc = TrainConfig(batch_size=B)
    state, step = TrainState.create(model, tc), make_train_step(model, tc, WORD_IDS, train_encoder=True)
    batch = {k: t(v) for k, v in make_batch(seed=7).items()}
    metrics, grads = [], []
    for i in range(steps):
        state, m = step(state, batch, prng.step_seed(prng.root_seed(1), "dropout", 0, i))
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append({k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None})
    return metrics, grads, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("encoder_remat", ["off", "on"])
def test_fine_tune_step_block_matches_on(encoder_remat):
    got, got_grads, got_params = fine_tune_run("block", encoder_remat)
    want, want_grads, want_params = fine_tune_run("on")
    lr = TrainConfig().encoder_lr
    for a, b in zip(got, want):
        assert abs(a["loss"] - b["loss"]) <= 1e-4 and np.isfinite(a["loss"])
        assert a["top5_correct"] == b["top5_correct"] and a["tokens"] == b["tokens"]
    assert set(got_grads[0]) == set(want_grads[0])
    assert any(k.startswith("encoder.convnext.5.") for k in got_grads[0])
    for k, g in want_grads[0].items():
        assert ((got_grads[0][k] - g).norm() / g.norm().clamp_min(1e-30)).item() <= 1e-3, k
    for k, v in want_params.items():
        assert (got_params[k] - v).abs().max().item() <= 1e-2 * lr, k


JAX_VALUES = ("auto", "on", "mlp", "block", "off", True, False,
              ("mlp", "mlp", "mlp", "off"), ("block", "off", "mlp", "on"), ["auto", "block", "block", "off"])


@pytest.mark.parametrize("value", JAX_VALUES, ids=str)
def test_config_takes_every_jax_value(value):
    """Each value the JAX package's ``CaptionModel`` resolves builds in the
    port, with the same mode per stage; ``'auto'`` is the JAX package's
    choice on its own chip, ``'mlp'``."""
    from tpu_captioner.core.config import ModelConfig as JaxModelConfig
    from tpu_captioner.train.model import CaptionModel as JaxCaptionModel

    jmode = JaxCaptionModel(JaxModelConfig(**{**SMALL, "use_pallas": value})).encoder.pallas_mode
    jmodes = jmode if isinstance(jmode, tuple) else (jmode,) * 4
    port = stage_kernel_modes(value, 4)
    values = value if isinstance(value, (tuple, list)) else (value,) * 4
    assert port == tuple("mlp" if v == "auto" else j for v, j in zip(values, jmodes))
    model = port_model(jax_model_and_params(seed=2)[1], use_pallas=value)
    assert [b.mode for b in model.modules() if isinstance(b, CNBlock)] == [
        m for m, d in zip(port, SMALL["encoder_depths"]) for _ in range(d)]


@pytest.mark.parametrize("value", ["pallas", "ON", "", None, 1.0, ("mlp", "mlp", "mlp"), ("mlp",) * 5,
                                   ("mlp", "mlp", "mlp", "fused")], ids=str)
def test_config_refuses_other_values(value):
    with pytest.raises(ValueError, match="use_pallas"):
        ModelConfig(use_pallas=value)


def test_kernel_modes_are_the_jax_names():
    assert set(KERNEL_MODES) == {"auto", "on", "mlp", "block", "off"}


@pytest.mark.parametrize("flag", ["block", "mlp,mlp,block,off"])
def test_cli_loader_takes_use_pallas(tmp_path, monkeypatch, flag):
    """``cli/caption.py --usePallas`` builds the blocks in the modes it names
    and loads the checkpoint into them; the group captions as the default
    model does."""
    import argparse

    from tests.test_torch_helpers import END, START
    from tpu_captioner_torch.cli import caption
    from tpu_captioner_torch.core import config
    from tpu_captioner_torch.models.from_jax import save_reference_checkpoint

    model = port_model(jax_model_and_params(seed=3)[1])
    path = str(tmp_path / "BEST_checkpoint_cli.pth.tar")
    save_reference_checkpoint(model, path)
    small = {k: v for k, v in SMALL.items() if k not in ("decoder", "vocab_size")}
    monkeypatch.setattr(config, "ModelConfig", lambda **kw: ModelConfig(**{**small, **kw}))
    args = argparse.Namespace(checkpoint=path, embeddingName=None, device="cpu", seed=1, decoder=None,
                              lstmDecoder=False, usePallas=flag)
    word_map = {f"w{i}": i for i in range(START)}
    word_map.update({"<start>": START, "<end>": END})
    loaded = caption.build_model_and_params(args, word_map)
    modes = stage_kernel_modes(tuple(flag.split(",")) if "," in flag else flag, 4)
    assert [b.mode for b in loaded.modules() if isinstance(b, CNBlock)] == [
        m for m, d in zip(modes, SMALL["encoder_depths"]) for _ in range(d)]
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in model.state_dict().items())
    imgs = images(2, seed=9)
    got = caption.caption_batch(loaded, imgs, word_map, 3)
    want = caption.caption_batch(model, imgs, word_map, 3)
    for (_, gs, gseq, _), (_, ws, wseq, _) in zip(got, want):
        assert np.array_equal(gseq, wseq) and abs(gs - ws) < 1e-4
