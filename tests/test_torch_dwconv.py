"""The port's depthwise conv (``tpu_captioner_torch/ops/dwconv.py``) against
the JAX package's (``tpu_captioner/ops/dwconv.py``), on numpy-seeded inputs.

On the CPU the kernel wrappers run their plain versions: ``_dw_plain`` (the
grouped conv) for the forward and ``_dw_grad_plain`` (the 49-tap reduction)
for the filter gradient.  They are held against the JAX XLA paths
(``depthwise_conv7x7_nhwc(..., False)``, ``_dw_xla``, ``_dw_grad_xla``) and
against the Pallas kernels in interpret mode, as ``tests/test_dwconv.py``
runs them.  Shapes: the JAX tests' (2, 16, 16, 128) and (1, 8, 8, 256), a
ragged C = 24 (the CPU configs' width) and an odd batch.

Tolerances are the JAX tests' own: the forward atol 1e-4; the filter
gradient rtol 1e-5, atol 1e-4 (f32 sums over B x H x W pixels in another
order).  The input gradient is a forward of the cotangent: atol 1e-4.
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
    _dw_grad_library,
    _dw_grad_plain,
    _dw_plain,
    depthwise_conv7x7_nhwc,
    dwconv_filter_grad,
    dwconv_forward,
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


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jax(shape):
    x, w, _ = inputs(shape, seed=shape[-1])
    got = dwconv_forward(t(x), t(w)).numpy()
    np.testing.assert_array_equal(got, _dw_plain(t(x), t(w)).numpy())  # the CPU wrapper is the plain version
    np.testing.assert_allclose(got, np.asarray(jax_dwconv(jnp.asarray(x), jnp.asarray(w), False)), atol=FWD_ATOL)
    np.testing.assert_allclose(got, np.asarray(_dw_xla(x, w)), atol=FWD_ATOL)
    with pltpu.force_tpu_interpret_mode():
        pallas = jax_dwconv(jnp.asarray(x), jnp.asarray(w), True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=FWD_ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_filter_grad_matches_jax(shape):
    x, _, g = inputs(shape, seed=shape[-1] + 1)
    got = dwconv_filter_grad(t(x), t(g)).numpy()
    assert got.shape == (7, 7, shape[-1])
    want = np.asarray(_dw_grad_xla(jnp.asarray(x), jnp.asarray(g)))
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    with pltpu.force_tpu_interpret_mode():
        pallas = _dw_grad_pallas(jnp.asarray(x), jnp.asarray(g))
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # The library path (the grouped conv's own weight gradient) in the same layout.
    library = _dw_grad_library(t(x), t(g), t(inputs(shape)[1])).numpy()
    np.testing.assert_allclose(library, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("jax_dw_grad", ["default", "pallas"])
@pytest.mark.parametrize("use_kernel,grad_kernel", [(True, True), (True, False), (False, True), (False, False)])
def test_autograd_matches_jax_custom_vjp(monkeypatch, jax_dw_grad, use_kernel, grad_kernel):
    """d_x and d_w of the port's ``autograd.Function`` (plain versions on the
    CPU) against ``jax.grad`` through the JAX custom VJP, with its default
    filter gradient and with ``TPU_CAPTIONER_DW_GRAD=pallas`` in interpret
    mode."""
    x, w, g = inputs((3, 9, 7, 24), seed=5)

    def loss(x, w):
        return jnp.sum(jax_dwconv(x, w, False) * g)

    if jax_dw_grad == "pallas":
        monkeypatch.setenv("TPU_CAPTIONER_DW_GRAD", "pallas")
        with pltpu.force_tpu_interpret_mode():
            want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    else:
        monkeypatch.delenv("TPU_CAPTIONER_DW_GRAD", raising=False)
        want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = t(x).requires_grad_(True), t(w).requires_grad_(True)
    y = depthwise_conv7x7_nhwc(tx, tw, use_kernel, grad_kernel)
    d_x, d_w = torch.autograd.grad(y, (tx, tw), t(g))
    np.testing.assert_allclose(d_x.numpy(), np.asarray(want[0]), atol=FWD_ATOL)
    np.testing.assert_allclose(d_w.numpy(), np.asarray(want[1]), rtol=GRAD_RTOL, atol=GRAD_ATOL)


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


def _op_calls(monkeypatch, model):
    """The (use_kernel, grad_kernel) of every call of the op in one encoder pass."""
    from tpu_captioner_torch.models import convnext

    seen = []
    real = convnext.depthwise_conv7x7_nhwc
    monkeypatch.setattr(convnext, "depthwise_conv7x7_nhwc",
                        lambda x, w, k, gk: seen.append((k, gk)) or real(x, w, k, gk))
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
    and 30 per step."""
    calls = {"forward": 0, "d_x": 0, "d_w": 0}
    real_fwd, real_grad = dwconv.dwconv_forward, dwconv.dwconv_filter_grad

    def fwd(x, w, flip=False):
        calls["d_x" if flip else "forward"] += 1
        return real_fwd(x, w, flip)

    def grad(x, g):
        calls["d_w"] += 1
        return real_grad(x, g)

    monkeypatch.setattr(dwconv, "dwconv_forward", fwd)
    monkeypatch.setattr(dwconv, "dwconv_filter_grad", grad)
    model = port_model(jax_model_and_params(seed=2)[1])
    tc = TrainConfig(batch_size=TRAIN_B)
    state, step = TrainState.create(model, tc), make_train_step(model, tc, WORD_IDS, train_encoder=True)
    state, m = step(state, {k: t(v) for k, v in make_batch(seed=3).items()},
                    prng.step_seed(prng.root_seed(0), "dropout", 0, 0))
    assert np.isfinite(float(m["loss"]))
    assert calls == {"forward": 5, "d_x": 2, "d_w": 3}
