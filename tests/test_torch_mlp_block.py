"""The port's fused ConvNeXt MLP tail (plain version, which the CPU wrapper
runs) against the JAX package: its XLA reference, and its Pallas kernel in
interpret mode.  Tolerances: 1e-5 against the XLA reference (same exact-erf
math, f32, other summation order); 2e-4 against the Pallas kernel, whose GELU
uses the A&S erf (abs error 1.5e-7 before the 4C-wide product), as
tests/test_mlp_block.py allows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_captioner.ops.mlp_block import _reference_impl, fused_convnext_mlp as jax_mlp
from tpu_captioner_torch.ops.mlp_block import _mlp_plain, fused_convnext_mlp

N, C = 192, 128


def make_args(sd: str, seed: int = 0):
    """JAX-layout numpy args: w1 (C, 4C), w2 (4C, C)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sd_scale = (
        np.ones(N, np.float32) if sd == "ones"
        else np.where(rng.random(N) < 0.7, 2.0, 0.0).astype(np.float32)
    )
    return (
        f(N, C), f(N, C), sd_scale,
        1.0 + 0.1 * f(C), 0.1 * f(C),
        0.05 * f(C, 4 * C), 0.1 * f(4 * C),
        0.05 * f(4 * C, C), 0.1 * f(C),
        0.5 * f(C),
    )


def port_args(a):
    x, res, sd, lns, lnb, w1, b1, w2, b2, gamma = (torch.from_numpy(np.ascontiguousarray(v)) for v in a)
    return x, res, sd, lns, lnb, w1.T.contiguous(), b1, w2.T.contiguous(), b2, gamma


@pytest.mark.parametrize("sd", ["ones", "mixed"])
def test_plain_matches_jax_reference(sd):
    a = make_args(sd)
    want = np.asarray(_reference_impl(*map(jnp.asarray, a)))
    got = _mlp_plain(*port_args(a)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("sd", ["ones", "mixed"])
def test_cpu_wrapper_matches_pallas_kernel(sd):
    from jax.experimental.pallas import tpu as pltpu

    a = make_args(sd, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_mlp(*map(jnp.asarray, a), True, True))  # f32 MXU
    before = fused_convnext_mlp.launches
    got = fused_convnext_mlp(*port_args(a)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    assert fused_convnext_mlp.launches == before  # CPU tensors launch nothing
