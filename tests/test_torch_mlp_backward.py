"""The backward of the port's fused ConvNeXt MLP tail (``_mlp_bwd_plain``,
which the CPU wrapper runs, and the ``autograd.Function`` around the tail)
against the JAX package.  Inputs are numpy-seeded, in the JAX layouts
(w1 (C, 4C), w2 (4C, C)); the port's weight gradients are transposed back.

Tolerances:
- against ``jax.vjp`` of ``_core_impl`` (the XLA reference): rtol 1e-4,
  atol 1e-5 — the same exact-erf f32 math, summed in another order over up to
  600 rows;
- against the Pallas backward kernel in interpret mode: atol 2e-3, the JAX
  package's own tolerance for that kernel, whose GELU and GELU' use the A&S
  erf (tests/test_mlp_block.py:110);
- ``gradcheck`` in float64 at C=4: its default finite-difference tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_captioner.ops.mlp_block import _bwd_pallas, _core_impl
from tpu_captioner_torch.ops.mlp_block import (
    _mlp_bwd_plain,
    _mlp_plain,
    fused_convnext_mlp,
    fused_convnext_mlp_bwd,
)

C = 128
NAMES = ("d_x", "d_sd", "d_ln_w", "d_ln_b", "d_w1", "d_b1", "d_w2", "d_b2", "d_gamma")


def make_inputs(n, sd, seed, c=C):
    """JAX-layout numpy (g, x, sd, ln_w, ln_b, w1, b1, w2, b2, gamma)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sd_scale = (
        np.ones(n, np.float32) if sd == "ones"
        else np.where(rng.random(n) < 0.7, 1.0 / 0.7, 0.0).astype(np.float32)
    )
    return (
        f(n, c), f(n, c), sd_scale, 1.0 + 0.1 * f(c), 0.1 * f(c),
        0.05 * f(c, 4 * c), 0.1 * f(4 * c), 0.05 * f(4 * c, c), 0.1 * f(c), 0.5 * f(c),
    )


def port_inputs(a):
    g, x, sd, lns, lnb, w1, b1, w2, b2, gamma = (torch.from_numpy(np.ascontiguousarray(v)) for v in a)
    return g, x, sd, lns, lnb, w1.T.contiguous(), b1, w2.T.contiguous(), b2, gamma


def jax_layout(grads):
    """The port's nine gradients as numpy arrays in the JAX layouts."""
    out = [t.numpy() for t in grads]
    out[4], out[6] = out[4].T, out[6].T
    return out


CASES = [(192, "ones"), (192, "mixed"), (600, "mixed")]  # 600: not a multiple of any row tile


@pytest.mark.parametrize("n,sd", CASES)
def test_plain_backward_matches_jax_vjp(n, sd):
    a = make_inputs(n, sd, seed=n)
    _, vjp = jax.vjp(_core_impl, *map(jnp.asarray, a[1:]))
    want = vjp(jnp.asarray(a[0]))
    got = jax_layout(_mlp_bwd_plain(*port_inputs(a)))
    for name, w, g in zip(NAMES, want, got):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("n,sd", [(192, "ones"), (600, "mixed")])
def test_cpu_wrapper_matches_pallas_backward_kernel(n, sd):
    from jax.experimental.pallas import tpu as pltpu

    a = make_inputs(n, sd, seed=n + 1)
    with pltpu.force_tpu_interpret_mode():
        want = _bwd_pallas(*map(jnp.asarray, a))  # f32 multiplicands
    before = fused_convnext_mlp_bwd.launches
    got = jax_layout(fused_convnext_mlp_bwd(*port_inputs(a)))
    assert fused_convnext_mlp_bwd.launches == before  # CPU tensors launch nothing
    for name, w, g in zip(NAMES, want, got):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-3, err_msg=name)


def test_function_passes_gradcheck_in_float64():
    """Every input's gradient, sd's included, against finite differences."""
    rng = np.random.default_rng(3)
    n, c = 6, 4
    f = lambda *s, scale=1.0: torch.tensor(scale * rng.standard_normal(s), dtype=torch.float64)  # noqa: E731
    sd = torch.tensor([0.0, 2.0, 1.0, 0.0, 1.5, 1.0], dtype=torch.float64)
    args = [f(n, c), f(n, c), sd, 1.0 + f(c, scale=0.1), f(c, scale=0.1), f(4 * c, c, scale=0.4),
            f(4 * c, scale=0.1), f(c, 4 * c, scale=0.4), f(c, scale=0.1), f(c, scale=0.5)]
    assert torch.autograd.gradcheck(fused_convnext_mlp, [a.requires_grad_(True) for a in args])


def test_function_backward_matches_autograd_of_plain_tail():
    """Through ``torch.autograd``: the Function's gradients equal those of the
    plain tail's own autograd graph; the residual's is the cotangent; sd,
    which needs none, gets none."""
    a = port_inputs(make_inputs(64, "mixed", seed=9))
    g = a[0]
    args = [t.clone() for t in (a[1], torch.randn(64, C), *a[2:])]
    wanted = [i for i in range(10) if i != 2]
    for i in wanted:
        args[i].requires_grad_(True)
    got = torch.autograd.grad(fused_convnext_mlp(*args), [args[i] for i in wanted], g)
    want = torch.autograd.grad(_mlp_plain(*args), [args[i] for i in wanted], g)
    for i, x, y in zip(wanted, got, want):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5, msg=f"input {i}")
    assert torch.equal(got[1], g)  # d_residual is the cotangent itself
    out = fused_convnext_mlp(*args)
    assert out.grad_fn is not None and not args[2].requires_grad


def test_backward_wrapper_refuses_other_devices():
    meta = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_convnext_mlp_bwd(meta(4, C), meta(4, C), meta(4), meta(C), meta(C),
                               meta(4 * C, C), meta(4 * C), meta(C, 4 * C), meta(C), meta(C))
