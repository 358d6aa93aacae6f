"""The port's depthwise conv (``tpu_captioner_torch/ops/dwconv.py``) against
the JAX package's (``tpu_captioner/ops/dwconv.py``), on numpy-seeded inputs.

On the CPU the kernel wrappers run their plain versions: ``_dw_plain`` (the
grouped conv) for the forward and ``_dw_grad_plain`` (the 49-tap reduction)
for the filter gradient.  They are held against the JAX XLA paths
(``depthwise_conv7x7_nhwc(..., False)``, ``_dw_xla``, ``_dw_grad_xla``) and
against the Pallas kernels in interpret mode, as ``tests/test_dwconv.py``
runs them.  Shapes: the JAX tests' (2, 16, 16, 128) and (1, 8, 8, 256), a
ragged C = 24 (the CPU configs' width) and an odd batch.  With a bias, the
op (the kernel's epilogue, its plain version here) is held against the JAX
conv plus the bias, as the JAX block adds it, and its bias gradient against
``jax.grad``.

Tolerances are the JAX tests' own: the forward atol 1e-4; the filter
gradient rtol 1e-5, atol 1e-4 (f32 sums over B x H x W pixels in another
order); the bias gradient the same.  The input gradient is a forward of the
cotangent: atol 1e-4.

``dwconv_plan`` (the kernels' tiles) is checked against the kernels' and
TMA's rules at every ConvNeXt-Base stage shape at batch 1, 8 and 32 and at
ragged sides; its numbers reach the card only there
(``tests/test_torch_kernels_gpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_helpers import SMALL, images, jax_model_and_params, port_model, set_dw, t
from tests.test_torch_train_step import B as TRAIN_B
from tests.test_torch_train_step import WORD_IDS, make_batch
from tpu_captioner.ops.dwconv import _dw_grad_pallas, _dw_grad_xla, _dw_xla
from tpu_captioner.ops.dwconv import depthwise_conv7x7_nhwc as jax_dwconv
from tpu_captioner_torch.core import prng
from tpu_captioner_torch.core.config import TrainConfig
from tpu_captioner_torch.ops import dwconv
from tpu_captioner_torch.ops.dwconv import (
    MAX_WARPS,
    SMEM_LIMIT,
    _dw_grad_library,
    _dw_grad_plain,
    _dw_plain,
    depthwise_conv7x7_nhwc,
    dwconv_filter_grad,
    dwconv_forward,
    dwconv_plan,
    fit_cluster,
)
from tpu_captioner_torch.train.state import TrainState
from tpu_captioner_torch.train.steps import make_train_step

SHAPES = [(2, 16, 16, 128), (1, 8, 8, 256), (2, 16, 16, 24), (3, 9, 7, 24)]
FWD_ATOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4


def inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (0.1 * rng.standard_normal((7, 7, shape[-1]))).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, w, g


def bias_of(shape, seed):
    return np.random.default_rng(seed + 7).standard_normal(shape[-1]).astype(np.float32)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jax(shape, bias):
    """With ``bias`` the wrapper's bias (the kernel's epilogue) against the
    JAX conv plus the bias, as the JAX block adds it."""
    x, w, _ = inputs(shape, seed=shape[-1])
    b = bias_of(shape, shape[-1]) if bias else np.zeros(shape[-1], np.float32)
    tb = t(b) if bias else None
    got = dwconv_forward(t(x), t(w), bias=tb).numpy()
    np.testing.assert_array_equal(got, _dw_plain(t(x), t(w), tb).numpy())  # the CPU wrapper is the plain version
    np.testing.assert_allclose(got, np.asarray(jax_dwconv(jnp.asarray(x), jnp.asarray(w), False) + b),
                               atol=FWD_ATOL)
    np.testing.assert_allclose(got, np.asarray(_dw_xla(x, w) + b), atol=FWD_ATOL)
    with pltpu.force_tpu_interpret_mode():
        pallas = jax_dwconv(jnp.asarray(x), jnp.asarray(w), True)
    np.testing.assert_allclose(got, np.asarray(pallas + b), atol=FWD_ATOL)
    np.testing.assert_allclose(depthwise_conv7x7_nhwc(t(x), t(w), True, True, tb).numpy(), got, rtol=0, atol=0)


@pytest.mark.parametrize("bias_grad", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_filter_grad_matches_jax(shape, bias_grad):
    """With ``bias_grad`` the wrapper and the library arm also give the bias
    gradient, the sum of g, against numpy's."""
    x, _, g = inputs(shape, seed=shape[-1] + 1)
    got = dwconv_filter_grad(t(x), t(g), bias_grad=bias_grad)
    library = _dw_grad_library(t(x), t(g), t(inputs(shape)[1]), bias_grad=bias_grad)
    if bias_grad:
        (got, d_b), (library, lib_b) = got, library
        want_b = g.astype(np.float64).sum(axis=(0, 1, 2))
        np.testing.assert_allclose(d_b.numpy(), want_b, rtol=GRAD_RTOL, atol=GRAD_ATOL)
        np.testing.assert_allclose(lib_b.numpy(), want_b, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    got = got.numpy()
    assert got.shape == (7, 7, shape[-1])
    want = np.asarray(_dw_grad_xla(jnp.asarray(x), jnp.asarray(g)))
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    with pltpu.force_tpu_interpret_mode():
        pallas = _dw_grad_pallas(jnp.asarray(x), jnp.asarray(g))
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # The library path (the grouped conv's own weight gradient) in the same layout.
    np.testing.assert_allclose(library.numpy(), want, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("jax_dw_grad", ["default", "pallas"])
@pytest.mark.parametrize("use_kernel,grad_kernel", [(True, True), (True, False), (False, True), (False, False)])
def test_autograd_matches_jax_custom_vjp(monkeypatch, jax_dw_grad, use_kernel, grad_kernel, bias):
    """d_x and d_w (and, with ``bias``, d_bias) of the port's
    ``autograd.Function`` (plain versions on the CPU) against ``jax.grad``
    through the JAX custom VJP plus the bias, as the JAX block adds it, with
    its default filter gradient and with ``TPU_CAPTIONER_DW_GRAD=pallas`` in
    interpret mode."""
    x, w, g = inputs((3, 9, 7, 24), seed=5)
    b = bias_of(x.shape, 5)

    def loss(x, w, b):
        return jnp.sum((jax_dwconv(x, w, False) + (b if bias else 0.0)) * g)

    argnums = (0, 1, 2) if bias else (0, 1)
    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    if jax_dw_grad == "pallas":
        monkeypatch.setenv("TPU_CAPTIONER_DW_GRAD", "pallas")
        with pltpu.force_tpu_interpret_mode():
            want = jax.grad(loss, argnums=argnums)(*args)
    else:
        monkeypatch.delenv("TPU_CAPTIONER_DW_GRAD", raising=False)
        want = jax.grad(loss, argnums=argnums)(*args)
    tx, tw = t(x).requires_grad_(True), t(w).requires_grad_(True)
    tb = t(b).requires_grad_(True) if bias else None
    y = depthwise_conv7x7_nhwc(tx, tw, use_kernel, grad_kernel, tb)
    got = torch.autograd.grad(y, (tx, tw, tb) if bias else (tx, tw), t(g))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=FWD_ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    if bias:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_input_gradient_is_skipped_when_x_needs_none(monkeypatch):
    calls = []
    real = dwconv.dwconv_forward
    monkeypatch.setattr(dwconv, "dwconv_forward", lambda *a, **k: calls.append(k) or real(*a, **k))
    x, w, g = inputs((2, 8, 8, 24))
    tw = t(w).requires_grad_(True)
    y = depthwise_conv7x7_nhwc(t(x), tw, True, True)
    (d_w,) = torch.autograd.grad(y, (tw,), t(g))
    assert calls == [{}]  # the forward only: no flipped launch for x
    tx = t(x).requires_grad_(True)
    y = depthwise_conv7x7_nhwc(tx, tw, True, True)
    torch.autograd.grad(y, (tx, tw), t(g))
    assert calls == [{}, {}, {"flip": True}]


def test_cpu_wrappers_count_no_launches():
    """The counts move only where a kernel launches: never on the CPU."""
    before = (depthwise_conv7x7_nhwc.launches, depthwise_conv7x7_nhwc.grad_launches)
    x, w, g = inputs((1, 8, 8, 24))
    tx, tw = t(x).requires_grad_(True), t(w).requires_grad_(True)
    torch.autograd.grad(depthwise_conv7x7_nhwc(tx, tw, True, True), (tx, tw), t(g))
    assert (depthwise_conv7x7_nhwc.launches, depthwise_conv7x7_nhwc.grad_launches) == before


def _op_calls(monkeypatch, model, biases=None):
    """The (use_kernel, grad_kernel) of every call of the op in one encoder
    pass; the bias of each call is appended to ``biases`` when given."""
    from tpu_captioner_torch.models import convnext

    seen = []
    real = convnext.depthwise_conv7x7_nhwc

    def op(x, w, k, gk, bias=None):
        seen.append((k, gk))
        if biases is not None:
            biases.append(bias)
        return real(x, w, k, gk, bias)

    monkeypatch.setattr(convnext, "depthwise_conv7x7_nhwc", op)
    model.encode(t(images(1, seed=3)))
    return seen


@pytest.mark.parametrize("use_pallas", ["auto", "on", "off"])
def test_blocks_follow_use_pallas(monkeypatch, use_pallas):
    """Both depthwise-conv kernels run where the MLP tail's does; with
    ``use_pallas='off'`` the block runs the grouped conv and never the op."""
    model = port_model(jax_model_and_params(seed=1)[1], use_pallas=use_pallas)
    blocks = sum(SMALL["encoder_depths"])
    on = use_pallas != "off"
    assert [(b.use_kernel, b.dw_kernel, b.dw_grad_kernel) for b in model.modules() if hasattr(b, "dw_kernel")] \
        == [(on, on, on)] * blocks
    assert _op_calls(monkeypatch, model) == ([(True, True)] * blocks if on else [])


@pytest.mark.parametrize("use_pallas", ["auto", "on"])
def test_blocks_pass_their_conv_bias_to_the_op(monkeypatch, use_pallas):
    """Each block hands the op its conv's bias (the kernel's epilogue), and
    adds none of its own after it."""
    from tpu_captioner_torch.models.convnext import CNBlock

    model = port_model(jax_model_and_params(seed=1)[1], use_pallas=use_pallas)
    biases = []
    _op_calls(monkeypatch, model, biases)
    want = [blk.block[0].bias for blk in model.modules() if isinstance(blk, CNBlock)]
    assert len(biases) == len(want) == sum(SMALL["encoder_depths"])
    assert all(got is b for got, b in zip(biases, want))


@pytest.mark.parametrize("fields", [("off", "off"), ("on", "off"), ("off", "on"), ("on", "on")])
def test_blocks_take_the_op_only_when_a_field_is_on(monkeypatch, fields):
    """With both of a block's choices off it runs the grouped conv
    (``conv_nhwc``) and never the op; with either on it runs the op with the
    two choices (the paired A/B's arms)."""
    model = port_model(jax_model_and_params(seed=1)[1])
    set_dw(model, fields[0] == "on", fields[1] == "on")
    blocks = sum(SMALL["encoder_depths"])
    want = [] if fields == ("off", "off") else [(fields[0] == "on", fields[1] == "on")] * blocks
    assert _op_calls(monkeypatch, model) == want


def test_fine_tune_step_launch_pattern(monkeypatch):
    """The fine-tune step's forward and filter-gradient calls on the small
    config (depths 1, 1, 2, 1; starting_layer 5): a forward per block (5),
    an input gradient per trained block but the first of child 5, whose
    input comes from the frozen child 4 (2), and a filter gradient per
    trained block (3).  At ConvNeXt-Base depths the same rule gives 36 + 29
    and 30 per step.  Every filter-gradient call also gives the trained
    conv bias's gradient."""
    calls = {"forward": 0, "d_x": 0, "d_w": 0, "d_bias": 0}
    real_fwd, real_grad = dwconv.dwconv_forward, dwconv.dwconv_filter_grad

    def fwd(x, w, flip=False, bias=None):
        calls["d_x" if flip else "forward"] += 1
        assert (bias is None) == flip  # the forward adds the block's bias, the input gradient none
        return real_fwd(x, w, flip, bias)

    def grad(x, g, bias_grad=False):
        calls["d_w"] += 1
        calls["d_bias"] += bias_grad  # the trained bias's gradient from the same launch
        return real_grad(x, g, bias_grad)

    monkeypatch.setattr(dwconv, "dwconv_forward", fwd)
    monkeypatch.setattr(dwconv, "dwconv_filter_grad", grad)
    model = port_model(jax_model_and_params(seed=2)[1])
    tc = TrainConfig(batch_size=TRAIN_B)
    state, step = TrainState.create(model, tc), make_train_step(model, tc, WORD_IDS, train_encoder=True)
    state, m = step(state, {k: t(v) for k, v in make_batch(seed=3).items()},
                    prng.step_seed(prng.root_seed(0), "dropout", 0, 0))
    assert np.isfinite(float(m["loss"]))
    assert calls == {"forward": 5, "d_x": 2, "d_w": 3, "d_bias": 3}


# -- the kernels' tile plan ---------------------------------------------------------

STAGES = [(64 >> s, 64 >> s, 128 << s) for s in range(4)]  # ConvNeXt-Base (H, W, C) at 256 x 256 inputs
PLAN_SHAPES = [(b, *hwc) for b in (1, 8, 32) for hwc in STAGES] + [
    (3, 13, 11, 128), (5, 5, 3, 1024), (2, 17, 40, 64), (1, 100, 7, 96), (2, 9, 7, 12), (4, 16, 16, 24),
]


@pytest.mark.parametrize("kind", ["forward", "wgrad"])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_fits_the_card_and_tma(shape, kind):
    """Every plan fits a block's 227 KB of shared memory, TMA's box limits
    (at most 256 per dimension, an innermost box of a multiple of 16 bytes)
    and the kernel's 16 consumer warps, and covers the image and the
    channels: whole images up to 16 x 16, else 16 x 16 tiles whose halo'd
    box is at most 2x the tile."""
    b, h, w, c = shape
    p = dwconv_plan(b, h, w, c, kind)
    assert p.tma and p.smem <= SMEM_LIMIT == 227 * 1024
    assert p.th % 2 == 0 and p.tw % 8 == 0 and 2 <= p.slots <= 4
    boxes = [(p.cc, p.tw + 6, p.th + 6, 1), (p.cc, 49) if kind == "forward" else (p.cc, p.tw, p.th, 1)]
    assert all(1 <= d <= 256 for box in boxes for d in box) and (4 * p.cc) % 16 == 0
    x_box, other = 4 * p.cc * (p.th + 6) * (p.tw + 6), 4 * p.cc * (49 if kind == "forward" else p.th * p.tw)
    assert p.smem >= (p.slots if kind == "wgrad" else 1) * other + p.slots * x_box
    assert p.units == -(-p.cc // 32) * (p.th // 2) * (p.tw // 8) <= MAX_WARPS
    if h <= 16 and w <= 16:
        assert 0 <= p.th - h < 2 and 0 <= p.tw - w < 8  # one tile per image
    else:
        assert (p.th, p.tw) == (16, 16) and (p.th + 6) * (p.tw + 6) <= 2 * p.th * p.tw
    assert p.tiles == b * -(-h // p.th) * -(-w // p.tw)
    assert (p.chunks - 1) * p.cc < c <= p.chunks * p.cc
    if kind == "wgrad":
        assert p.parts == 8  # one cluster per channel chunk
    else:
        assert 1 <= p.parts <= p.tiles and p.parts * p.chunks <= max(132, p.chunks)


# Clusters of one-block-per-SM filter-gradient blocks an H100 80GB HBM3 runs at
# once, by cluster size (cudaOccupancyMaxActiveClusters on the card, through
# scripts/dwconv_probe.py clusters: a cluster's blocks share a GPC).
H100_ACTIVE = {8: 15, 7: 15, 6: 17, 5: 22, 4: 30, 3: 39, 2: 66, 1: 132}


@pytest.mark.parametrize("kind", ["forward", "wgrad"])
@pytest.mark.parametrize("batch", [8, 32])
def test_plan_fills_the_card_at_stage_three(kind, batch):
    """Stage 3, where most launches fall: whole 16 x 16 images, 16 consumer
    warps, and 128 blocks for the forward (one to four images each).  The
    filter gradient's 16 chunks in clusters of 8 would need 16 clusters at
    once, one more than the card holds: ``fit_cluster`` takes clusters of 6,
    96 blocks, all in one wave."""
    p = dwconv_plan(batch, 16, 16, 512, kind)
    assert (p.th, p.tw, p.cc, p.units) == (16, 16, 32, 16)
    assert p.chunks * p.parts == 128
    if kind == "wgrad":
        fitted = fit_cluster(lambda k: dwconv_plan(batch, 16, 16, 512, kind, cluster=k),
                             lambda plan: H100_ACTIVE[plan.parts])
        assert (fitted.parts, fitted.chunks * fitted.parts) == (6, 96)
        assert fitted.chunks <= H100_ACTIVE[fitted.parts] and fitted.smem == p.smem


@pytest.mark.parametrize("cluster", [1, 4, 7, 8])
def test_plan_takes_the_cluster_it_is_given(cluster):
    p = dwconv_plan(32, 8, 8, 1024, "wgrad", cluster=cluster)
    assert p.parts == cluster and p.smem <= SMEM_LIMIT


def test_fit_cluster_takes_the_largest_cluster_that_runs_at_once():
    plan_of = lambda k: dwconv_plan(32, 8, 8, 1024, "wgrad", cluster=k)  # noqa: E731  (16 chunks of 64)
    assert fit_cluster(plan_of, lambda plan: 16).parts == 8
    assert fit_cluster(plan_of, lambda plan: H100_ACTIVE[plan.parts]).parts == 6
    assert fit_cluster(plan_of, lambda plan: 0).parts == 8  # nothing fits: clusters of 8, in waves


@pytest.mark.parametrize("kind", ["forward", "wgrad"])
@pytest.mark.parametrize("shape", [(3, 13, 11, 130), (2, 9, 7, 10), (1, 8, 8, 1)])
def test_plan_refuses_tma_for_ragged_channels(shape, kind):
    """C % 4 != 0 has no 16-byte TMA rows: the TMA plan raises, and the
    plan of the producer warp's own loads (the kernel's other instance)
    takes the shape."""
    with pytest.raises(ValueError, match="C % 4"):
        dwconv_plan(*shape, kind)
    p = dwconv_plan(*shape, kind, tma=False)
    assert not p.tma and p.smem <= SMEM_LIMIT and p.units <= MAX_WARPS
    assert (p.chunks - 1) * p.cc < shape[-1] <= p.chunks * p.cc


def test_plan_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="kind"):
        dwconv_plan(1, 8, 8, 64, "backward")
    with pytest.raises(ValueError, match="cluster"):
        dwconv_plan(1, 8, 8, 64, "wgrad", cluster=9)
    with pytest.raises(ValueError, match="empty"):
        dwconv_plan(0, 8, 8, 64)
