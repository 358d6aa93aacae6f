"""The MLP-tail kernels' 3xTF32 arithmetic (``tpu_captioner_torch/ops/tf32.py``)
against the JAX package, on the CPU.

The whole-tile forward and the backward kernels take their products from
TF32 tensor cores through a hi/lo split of every f32 operand
(``csrc/tf32x3_gemm.cuh``).  No kernel runs here, so ``ops/tf32.py``
computes the same rounding and products on the CPU, and these tests hold
that model against the JAX package's ``fused_convnext_mlp`` on its plain
(XLA) path and against its VJP, with numpy inputs from a seed at the
kernels' weight scales (``chip_smoke.py``), a few hundred rows (not a
multiple of the kernels' 128-row tiles) and per-row ``sd`` of 0 and
1/survival.

Tolerances, the card's own (``chip_smoke.py``): the forward within
``MLP_TOL`` = 1e-4 absolute; the backward's nine outputs within
``MLP_BWD_TOL`` = 1e-4 times max(1, the output's largest magnitude).  One
TF32 pass misses the forward's at C = 1024, which is why the kernels split.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_captioner.ops.mlp_block import fused_convnext_mlp as jax_mlp
from tpu_captioner_torch.ops.tf32 import (
    matmul_1xtf32,
    matmul_3xtf32,
    mlp_backward,
    mlp_forward,
    round_tf32,
    split_tf32,
)

MLP_TOL = MLP_BWD_TOL = 1e-4
WIDTHS = (128, 512, 1024)
N = 300
SURVIVAL = 0.8
NAMES = ("d_x", "d_sd", "d_ln_w", "d_ln_b", "d_w1", "d_b1", "d_w2", "d_b2", "d_gamma")


def make_inputs(c, seed, n=N):
    """JAX-layout numpy (g, x, residual, sd, ln_w, ln_b, w1 (C, 4C), b1,
    w2 (4C, C), b2, gamma) at chip_smoke.py's scales."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sd = np.where(rng.random(n) < SURVIVAL, 1.0 / SURVIVAL, 0.0).astype(np.float32)
    sd[:2] = (0.0, 1.0 / SURVIVAL)  # both kinds of row, whatever the draw
    return (f(n, c), f(n, c), f(n, c), sd, 1.0 + 0.1 * f(c), 0.1 * f(c),
            0.02 * f(c, 4 * c), 0.1 * f(4 * c), 0.02 * f(4 * c, c), 0.1 * f(c), 0.5 * f(c))


def port_args(a):
    """The port's tensors (nn.Linear layouts) from the JAX-layout arrays."""
    t = [torch.from_numpy(np.ascontiguousarray(v)) for v in a]
    t[6], t[8] = t[6].T.contiguous(), t[8].T.contiguous()
    return t


def jax_forward(a):
    return np.asarray(jax_mlp(*map(jnp.asarray, a[1:]), False, True))


def test_round_tf32_is_round_to_nearest_ties_away():
    one_ulp = 2.0 ** -10  # TF32's unit in the last place at 1.0
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 2 * 0.99,
                      1.0 + 1.5 * one_ulp, 3.0e38, float("inf"), -0.0], dtype=torch.float32)
    want = [1.0, 1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 1.0 + 2 * one_ulp, None, float("inf"), -0.0]
    got = round_tf32(x)
    for i, w in enumerate(want):
        if w is not None:
            assert got[i].item() == w, (i, got[i].item(), w)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()  # the 13 dropped bits are clear
    assert torch.isnan(round_tf32(torch.tensor([float("nan")]))).all()


def test_split_keeps_f32_accuracy():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(100_000).astype(np.float32) * 1e3)
    hi, lo = split_tf32(x)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all() and (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((hi - x).abs() <= x.abs() * 2.0 ** -11).all()
    # hi + lo carries 21-22 of f32's 24 bits; 3xTF32 drops only lo.lo.
    assert ((hi.double() + lo.double() - x.double()).abs() <= x.abs().double() * 2.0 ** -21).all()
    a, b = x[:64 * 96].reshape(64, 96) / 1e3, x[-96 * 32:].reshape(96, 32) / 1e3
    exact = a.double() @ b.double()
    assert (matmul_3xtf32(a, b).double() - exact).abs().max() < 1e-5
    assert (matmul_1xtf32(a, b).double() - exact).abs().max() > 1e-4


@pytest.mark.parametrize("c", WIDTHS)
def test_forward_3xtf32_matches_jax(c):
    a = make_inputs(c, seed=c)
    want = jax_forward(a)
    got = mlp_forward(*port_args(a)[1:]).numpy()
    err = np.abs(got - want).max()
    assert err < MLP_TOL, f"C={c}: 3xTF32 forward off by {err:.3e}"
    dropped = a[3] == 0
    np.testing.assert_array_equal(got[dropped], a[2][dropped])  # sd 0: the residual, bit for bit


@pytest.mark.parametrize("c", WIDTHS)
def test_backward_3xtf32_matches_jax_vjp(c):
    a = make_inputs(c, seed=c + 1)
    g, rest = jnp.asarray(a[0]), [jnp.asarray(v) for v in a[1:]]
    _, vjp = jax.vjp(lambda *args: jax_mlp(*args, False, True), *rest)
    want = vjp(g)
    want = [np.asarray(w) for i, w in enumerate(want) if i != 1]  # drop d_residual, which is g
    want[4], want[6] = want[4].T, want[6].T  # the port's nn.Linear layouts
    t = port_args(a)
    got = mlp_backward(t[0], t[1], *t[3:])
    for name, gv, wv in zip(NAMES, got, want):
        err = np.abs(gv.numpy() - wv).max()
        assert err <= MLP_BWD_TOL * max(1.0, np.abs(wv).max()), f"C={c} {name}: off by {err:.3e}"
    dropped = torch.from_numpy(a[3] == 0)
    assert torch.equal(got[0][dropped], torch.zeros_like(got[0][dropped]))


def test_one_tf32_pass_misses_the_tolerance_at_c1024():
    """The reason for the split: one TF32 pass over the tail's products is
    off by more than MLP_TOL at C = 1024, where 3xTF32 is not."""
    a = make_inputs(1024, seed=7)
    want = jax_forward(a)
    args = port_args(a)[1:]
    one = np.abs(mlp_forward(*args, mm=matmul_1xtf32).numpy() - want).max()
    three = np.abs(mlp_forward(*args).numpy() - want).max()
    assert one > MLP_TOL, f"one TF32 pass: {one:.3e}, within {MLP_TOL} after all"
    assert three < MLP_TOL / 10, f"3xTF32: {three:.3e}"
    print(f"C=1024: one TF32 pass off by {one:.3e}, 3xTF32 by {three:.3e} (tol {MLP_TOL})")
