"""The port's fused ConvNeXt MLP tail (plain version, which the CPU wrapper
runs) against the JAX package: its XLA reference, and its Pallas kernel in
interpret mode, its whole-tile body and its sub-tiled ``_kernel_pipelined``
(``TPU_CAPTIONER_MLP_SUB``); the port's rule for the sub-tile rows; and the
sub-tiled CUDA kernel's arithmetic (``ops/tf32.py:fused_mlp_forward``)
against both and against the whole-tile kernel's.  Tolerances: 1e-5
against the XLA reference (same exact-erf math, f32, other summation order);
2e-4 against the Pallas kernels, whose GELU uses the A&S erf (abs error
1.5e-7 before the 4C-wide product), as tests/test_mlp_block.py allows; the
card's own for the kernel's arithmetic (1e-4 against the reference, 1e-5
times max(1, the largest magnitude) against the whole-tile path)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_captioner.ops.mlp_block import _reference_impl, fused_convnext_mlp as jax_mlp
from tpu_captioner_torch.ops.mlp_block import (
    FUSED_TILES,
    SUPPORTED_C,
    _mlp_plain,
    _pipeline_sub,
    fused_convnext_mlp,
)

N, C = 192, 128


def make_args(sd: str, seed: int = 0, n: int = N):
    """JAX-layout numpy args: w1 (C, 4C), w2 (4C, C)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sd_scale = (
        np.ones(n, np.float32) if sd == "ones"
        else np.where(rng.random(n) < 0.7, 2.0, 0.0).astype(np.float32)
    )
    return (
        f(n, C), f(n, C), sd_scale,
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


# The sub-tile rows each width's kernel takes (ops/mlp_block.py:_pipeline_sub):
# the wgmma's 64 rows.
VALID_SUB = {128: (64,), 256: (64,), 512: (64,), 1024: (64,)}


@pytest.mark.parametrize("value", [None, "-8", "0", "2", "4", "6", "8", "12", "16", "32", "64", "128"])
@pytest.mark.parametrize("c", SUPPORTED_C)
def test_pipeline_sub_rule(monkeypatch, c, value):
    if value is None:
        monkeypatch.delenv("TPU_CAPTIONER_MLP_SUB", raising=False)
    else:
        monkeypatch.setenv("TPU_CAPTIONER_MLP_SUB", value)
    want = int(value) if value is not None and int(value) in VALID_SUB[c] else 0
    assert _pipeline_sub(1003, c) == want
    assert 64 in VALID_SUB[c]  # one value selects the sub-tiled kernel at every width


@pytest.mark.parametrize("n", [512, 520])
def test_cpu_wrapper_matches_pipelined_pallas_kernel(monkeypatch, n):
    """With TPU_CAPTIONER_MLP_SUB=128 the JAX package runs its sub-tiled
    ``_kernel_pipelined`` (520 adds a partial last tile); the port's CPU
    wrapper runs the plain version, which the sub-tiled CUDA instances are
    held against on the card."""
    from jax.experimental.pallas import tpu as pltpu

    from tpu_captioner.ops import mlp_block as jax_mlp_block

    monkeypatch.setenv("TPU_CAPTIONER_MLP_SUB", "128")
    a = make_args("mixed", seed=n, n=n)
    assert jax_mlp_block._pipeline_sub(n, min(512, n)) == 128
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_mlp(*map(jnp.asarray, a), True, True))
    before = (fused_convnext_mlp.launches, fused_convnext_mlp.pipelined_launches)
    got = fused_convnext_mlp(*port_args(a)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    assert (fused_convnext_mlp.launches, fused_convnext_mlp.pipelined_launches) == before


def fused_jc(c, nc):
    """Hidden units per chunk of the sub-tiled kernel at width ``c`` with
    ``nc`` output columns a block."""
    s, jcb = FUSED_TILES[c, nc]
    return s * jcb


@pytest.mark.parametrize("c,nc", sorted(FUSED_TILES))
def test_fused_kernel_arithmetic_matches_jax_and_whole_tile(c, nc):
    """``ops/tf32.py:fused_mlp_forward`` (the sub-tiled kernel's arithmetic:
    ln_w and ln_b folded into W1 and b1, chunks of each of its tiles' width,
    3xTF32 partials per 32-deep stage and per chunk) against the JAX package's XLA
    reference within 1e-4 (the kernel's tolerance on the card) and against
    the whole-tile kernel's arithmetic within 1e-5 times max(1, its largest
    magnitude) (the card's tolerance between the two paths); rows with sd 0
    return the residual bit for bit."""
    from tpu_captioner_torch.ops.tf32 import fused_mlp_forward, mlp_forward

    rng = np.random.default_rng(c)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    n = 300
    sd = np.where(rng.random(n) < 0.8, 1.25, 0.0).astype(np.float32)
    sd[:2] = (0.0, 1.25)
    a = (f(n, c), f(n, c), sd, 1.0 + 0.1 * f(c), 0.1 * f(c), 0.02 * f(c, 4 * c), 0.1 * f(4 * c),
         0.02 * f(4 * c, c), 0.1 * f(c), 0.5 * f(c))
    want = np.asarray(_reference_impl(*map(jnp.asarray, a)))
    args = port_args(a)
    got = fused_mlp_forward(*args, jc=fused_jc(c, nc))
    whole = mlp_forward(*args)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    assert (got - whole).abs().max().item() <= 1e-5 * max(1.0, whole.abs().max().item())
    dropped = torch.from_numpy(sd == 0)
    assert torch.equal(got[dropped], args[1][dropped])


def test_fused_kernel_arithmetic_matches_pipelined_pallas_kernel(monkeypatch):
    """The same model against the JAX package's ``_kernel_pipelined`` in
    interpret mode (TPU_CAPTIONER_MLP_SUB=128, a partial last tile), within
    2e-4 (its GELU takes the A&S erf)."""
    from jax.experimental.pallas import tpu as pltpu

    from tpu_captioner_torch.ops.tf32 import fused_mlp_forward

    monkeypatch.setenv("TPU_CAPTIONER_MLP_SUB", "128")
    a = make_args("mixed", seed=13, n=520)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_mlp(*map(jnp.asarray, a), True, True))
    got = fused_mlp_forward(*port_args(a), jc=fused_jc(C, C)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
