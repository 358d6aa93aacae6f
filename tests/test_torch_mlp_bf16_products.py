"""The MLP tail's ``precise=False`` arm (bf16 products): the port's plain
versions (``_mlp_plain_bf16_products``, ``_mlp_bwd_plain_bf16_products``,
what the CPU wrappers run and what the CUDA instances are held against on
the card) against JAX ``fused_convnext_mlp(*args, True, False)`` through
the Pallas kernels in interpret mode: the forward (``_kernel``, and
``_kernel_pipelined`` with ``TPU_CAPTIONER_MLP_SUB=64``) and the ten
gradients (``_bwd_kernel``) by ``jax.grad`` against
``torch.autograd.grad``, on f32 and on bf16 data.  Inputs are
numpy-seeded, in the JAX layouts (w1 (C, 4C), w2 (4C, C)); the port's
weight gradients are transposed back.

Tolerances.  On f32 data the two sides compute LayerNorm's mean and
variance in other orders, so an f32 value of LN(x) an ulp apart now and then
rounds to the neighbouring bf16 operand (as does h, whose GELU takes the
A&S erf in JAX's kernel): a flip moves every output of its row by up to
one bf16 ulp of the operand times a weight column.  So each output is held
twice:
- f32 data, the output: the mean |error| within MEAN_TOL (measured 2.3e-6
  and 1.5e-7 at N = C = 128) and the largest within FLIP_TOL (measured
  1.8e-3: one row with a flipped LN(x) element); the gradients, relative to
  max(1, max |JAX|): the mean within GRAD_MEAN_TOL (measured at most
  3.7e-5) and the largest within FLIP_TOL (measured at most 1.2e-3, d_w2);
- bf16 data (whose LN sums agree: no flips measured): the bf16 output, d_x,
  d_w1 and d_w2 (rounded once to the bf16 weights' dtype, as JAX's
  ``.astype(w1.dtype)``) within one bf16 ulp of the JAX value
  (2^(floor(log2 |ref|) - 7), at least 2^-8), the f32 gradients within
  GRAD_MEAN_TOL x max(1, max |JAX|) at their largest (measured 2.0e-5);
- the port's ``precise=True`` output lies more than SEPARATION x MEAN_TOL
  from JAX's ``precise=False`` in mean (measured 4.0e-4 and 4.3e-4: every
  output carries the bf16 products' rounding), so a version that ignores
  ``precise`` fails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_captioner.ops import mlp_block as jax_mlp_block
from tpu_captioner_torch.ops.mlp_block import (
    _check,
    _mlp_bwd_plain_bf16_products,
    _mlp_plain,
    _mlp_plain_bf16_products,
    _param_shapes,
    fused_convnext_mlp,
    fused_convnext_mlp_bwd,
)

N, C = 128, 128  # one JAX row tile of two 64-row sub-tiles under TPU_CAPTIONER_MLP_SUB=64
MEAN_TOL, GRAD_MEAN_TOL, FLIP_TOL, SEPARATION = 2e-5, 1e-4, 5e-3, 10
BF = torch.bfloat16
NAMES = ("x", "residual", "sd", "ln_w", "ln_b", "w1", "b1", "w2", "b2", "gamma")


def make_inputs(sd, seed, bf16):
    """JAX-layout numpy (x, residual, sd, ln_w, ln_b, w1, b1, w2, b2, gamma)
    and the cotangent g; x, residual, w1, w2 and g rounded to bf16 values
    where ``bf16``."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    rows = np.ones(N, np.float32) if sd == "ones" else np.where(rng.random(N) < 0.7, 1 / 0.7, 0.0).astype(np.float32)
    args = [f(N, C), f(N, C), rows, 1 + 0.1 * f(C), 0.1 * f(C),
            0.05 * f(C, 4 * C), 0.1 * f(4 * C), 0.05 * f(4 * C, C), 0.1 * f(C), 0.5 * f(C)]
    g = f(N, C)
    if bf16:
        for i in (0, 1, 5, 7):
            args[i] = torch.from_numpy(args[i]).to(BF).float().numpy()
        g = torch.from_numpy(g).to(BF).float().numpy()
    return args, g


def jax_arm(args, g, bf16, sub, grads=True):
    """JAX's precise=False output (and ten gradients) in interpret mode,
    as f32 numpy arrays."""
    from jax.experimental.pallas import tpu as pltpu

    dt = jnp.bfloat16 if bf16 else jnp.float32
    ja = [jnp.asarray(a).astype(dt) if i in (0, 1, 5, 7) else jnp.asarray(a) for i, a in enumerate(args)]
    jg = jnp.asarray(g).astype(dt)
    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        if sub:
            mp.setenv("TPU_CAPTIONER_MLP_SUB", "64")
            assert jax_mlp_block._pipeline_sub(N, N) == 64  # _kernel_pipelined runs
        out = jax_mlp_block.fused_convnext_mlp(*ja, True, False)
        assert out.dtype == dt
        if not grads:
            return np.asarray(out.astype(jnp.float32)), None
        loss = lambda *a: jnp.sum((jax_mlp_block.fused_convnext_mlp(*a, True, False) * jg).astype(jnp.float32))  # noqa: E731
        d = jax.grad(loss, argnums=tuple(range(10)))(*ja)
    return np.asarray(out.astype(jnp.float32)), [np.asarray(v.astype(jnp.float32)) for v in d]


def port_args(args, bf16):
    """The port's tensors (nn.Linear weight layouts), leaves that require grad."""
    out = []
    for i, a in enumerate(args):
        v = torch.from_numpy(np.ascontiguousarray(a.T if i in (5, 7) else a))
        out.append((v.to(BF) if bf16 and i in (0, 1, 5, 7) else v).requires_grad_())
    return out


def ulp_err(got, want):
    """Largest |got - want| in bf16 ulps of want (at least 2^-8)."""
    ulp = np.maximum(np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -8))) - 7), 2.0 ** -8)
    return float((np.abs(got - want) / ulp).max())


CASES = {  # (sd, bf16 data, TPU_CAPTIONER_MLP_SUB=64 on the JAX side)
    "f32-mixed": ("mixed", False, False),
    "f32-ones-sub": ("ones", False, True),
    "bf16-mixed": ("mixed", True, False),
    "bf16-mixed-sub": ("mixed", True, True),
}
_JAX = {}


def case(name):
    """The inputs and JAX's result of a case, computed once per module;
    the sub-tiled cases take the forward alone (the backward is the same
    _bwd_kernel)."""
    if name not in _JAX:
        sd, bf16, sub = CASES[name]
        args, g = make_inputs(sd, seed=len(_JAX) + 3, bf16=bf16)
        _JAX[name] = (args, g, *jax_arm(args, g, bf16, sub, grads=not sub))
    return _JAX[name]


@pytest.mark.parametrize("name", list(CASES))
def test_forward_plain_matches_jax_precise_false(name):
    args, g, want, _ = case(name)
    bf16 = CASES[name][1]
    pa = [a.detach() for a in port_args(args, bf16)]
    got = _mlp_plain_bf16_products(*pa)
    assert got.dtype == (BF if bf16 else torch.float32)
    if bf16:
        assert ulp_err(got.float().numpy(), want) <= 1.0
    else:
        err = np.abs(got.numpy() - want)
        assert err.mean() < MEAN_TOL and err.max() < FLIP_TOL, (err.mean(), err.max())
        # The other arm on the same inputs lies far outside the tolerance.
        assert np.abs(_mlp_plain(*pa).numpy() - want).mean() > SEPARATION * MEAN_TOL
    # The CPU wrapper runs the plain version and launches nothing.
    before = fused_convnext_mlp.launches, fused_convnext_mlp.bf16_product_launches
    with torch.no_grad():
        torch.testing.assert_close(fused_convnext_mlp(*pa, precise=False), got, rtol=0, atol=0)
    assert (fused_convnext_mlp.launches, fused_convnext_mlp.bf16_product_launches) == before


@pytest.mark.parametrize("name", [n for n, (_, _, sub) in CASES.items() if not sub])
def test_gradients_match_jax_precise_false(name):
    args, g, _, want = case(name)
    bf16 = CASES[name][1]
    pa = port_args(args, bf16)
    out = fused_convnext_mlp(*pa, precise=False)
    gt = torch.from_numpy(g).to(out.dtype)
    grads = torch.autograd.grad(out, pa, gt)
    for i, (a, b) in enumerate(zip(grads, want)):
        assert a.dtype == pa[i].dtype, NAMES[i]
        a = a.float().numpy()
        a = a.T if i in (5, 7) else a
        err = np.abs(a - b) / max(1.0, np.abs(b).max())
        if bf16 and i in (0, 1, 5, 7):
            assert ulp_err(a, b) <= 1.0, NAMES[i]
        elif bf16:
            assert err.max() < GRAD_MEAN_TOL, (NAMES[i], err.max())
        else:
            assert err.mean() < GRAD_MEAN_TOL and err.max() < FLIP_TOL, (NAMES[i], err.mean(), err.max())
    # The backward wrapper is the plain version, which rounds the weights'
    # products as the forward's autograd does.
    raw = [a.detach() for a in pa]
    d = fused_convnext_mlp_bwd(gt, raw[0], *raw[2:], precise=False)
    for got, want_ in zip(d, _mlp_bwd_plain_bf16_products(gt, raw[0], *raw[2:])):
        torch.testing.assert_close(got, want_, rtol=0, atol=0)


def test_precise_must_be_a_bool_and_widths_are_checked():
    args, g, _, _ = case("f32-mixed")
    pa = [a.detach() for a in port_args(args, False)]
    for bad in (0, 1, None, "False"):
        with pytest.raises(TypeError, match="precise must be a bool"):
            fused_convnext_mlp(*pa, precise=bad)
        with pytest.raises(TypeError, match="precise must be a bool"):
            fused_convnext_mlp_bwd(torch.from_numpy(g), pa[0], *pa[2:], precise=bad)
    # What a CUDA tensor of an unsupported width meets before any launch:
    # the same check as the precise=True instances, which raises.
    c = 192
    z = torch.zeros
    with pytest.raises(ValueError, match="supports C in"):
        _check("fused_convnext_mlp", c, {"x": (z(4, c), (4, c)), **_param_shapes(
            c, z(c), z(c), z(4 * c, c), z(4 * c), z(c, 4 * c), z(c), z(c))})
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        fused_convnext_mlp(*(a.to("meta") for a in pa), precise=False)

