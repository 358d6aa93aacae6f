"""The MLP tail's bf16 instances on the CPU: the three-piece split of an f32
value and the tile plan (``csrc/bf16_gemm.cuh``: ``x3::split3`` and
``x3::tail_plan``, mirrored by ``ops/mlp_block.py:split_pieces`` and
``bf16_tail_plan``).

The kernels split each f32 operand value v of the four products with a bf16
weight into hi (v's top 8 significant bits), mid (the next 8 of v - hi) and
lo (the rest), three bf16 values, and sum the three exact bf16 products in
f32.  Held here: the pieces sum to
v exactly (in f64, which holds their sum without rounding) over LayerNorm-
and GELU-range values, exponents from 2^-100 to 2^100, zeros and both
signs; their products with a bf16 weight, summed in f64, equal the f64
product of v and the weight; the plan's tiles, grids and workspaces at the
ConvNeXt-Base widths for batch 1, 8 and 32 and at ragged rows.  The kernels
themselves run on the card only (``tests/test_torch_kernels_gpu.py``).
"""

import numpy as np
import pytest
import torch

from tpu_captioner_torch.ops.mlp_block import SUPPORTED_C, bf16_tail_plan, split_pieces


def values(kind, seed=0, n=20000):
    """Seeded f32 values of one kind, as a torch tensor."""
    rng = np.random.default_rng(seed)
    if kind == "layernorm":  # (x - mu) * rstd * ln_w + ln_b
        v = rng.standard_normal(n) * (1 + 0.1 * rng.standard_normal(n)) + 0.1 * rng.standard_normal(n)
    elif kind == "gelu":  # gelu(a) for pre-activations of a few units
        a = 3 * rng.standard_normal(n)
        v = 0.5 * a * (1 + np.vectorize(__import__("math").erf)(a / np.sqrt(2)))
    elif kind == "exponents":  # random mantissas at every exponent from -100 to 100, both signs
        e = rng.integers(-100, 101, n)
        v = rng.choice([-1.0, 1.0], n) * (1 + rng.random(n)) * np.exp2(e.astype(np.float64))
    else:  # zeros of both signs among values of both signs
        v = np.concatenate([[0.0, -0.0], rng.standard_normal(n - 2)])
    return torch.from_numpy(v.astype(np.float32))


KINDS = ["layernorm", "gelu", "exponents", "zeros"]


@pytest.mark.parametrize("kind", KINDS)
def test_three_pieces_sum_to_the_value(kind):
    v = values(kind, seed=KINDS.index(kind))
    hi, mid, lo = split_pieces(v)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, v.double())
    # Each piece is below one bf16 ulp of the one before it, and of its sign.
    assert bool(((mid.double().abs() < hi.double().abs() * 2.0 ** -7) | (mid == 0)).all())
    assert bool(((lo.double().abs() < mid.double().abs() * 2.0 ** -7) | (lo == 0)).all())
    assert bool(((mid.double() * v.double() >= 0) & (lo.double() * v.double() >= 0)).all())
    # Each piece as a bf16 value is exact: its f32 image has no low bits.
    for p in (hi, mid, lo):
        assert not bool((p.float().view(torch.int32) & 0xFFFF).any())
    zero = v == 0
    if zero.any():
        assert not hi[zero].any() and not mid[zero].any() and not lo[zero].any()


@pytest.mark.parametrize("kind", KINDS)
def test_pieces_times_a_bf16_weight_are_the_exact_product(kind):
    v = values(kind, seed=10 + KINDS.index(kind))
    rng = np.random.default_rng(20 + KINDS.index(kind))
    w = torch.from_numpy((0.02 * rng.standard_normal(v.numel())).astype(np.float32)).to(torch.bfloat16)
    hi, mid, lo = split_pieces(v)
    wd = w.double()
    # Each piece times the weight is exact in f32 (8 by 8 significant bits).
    for p in (hi, mid, lo):
        prod = p.double() * wd
        assert torch.equal(prod.float().double(), prod)
    assert torch.equal(hi.double() * wd + mid.double() * wd + lo.double() * wd, v.double() * wd)


def test_pieces_of_a_row_dot_a_bf16_weight_are_f32_accurate():
    """The pieces' products summed in f32, as the tensor cores sum them, keep
    an f32 dot product's accuracy where one bf16 piece (the rows rounded to
    bf16) loses two decimal digits."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((64, 512)).astype(np.float32))
    w = torch.from_numpy((0.02 * rng.standard_normal((512, 256))).astype(np.float32)).to(torch.bfloat16)
    exact = x.double() @ w.double()
    hi, mid, lo = split_pieces(x)
    three = (lo.float() @ w.float() + mid.float() @ w.float()) + hi.float() @ w.float()
    one = hi.float() @ w.float()
    scale = exact.abs().max().item()
    assert (three.double() - exact).abs().max().item() <= 1e-6 * scale
    assert (one.double() - exact).abs().max().item() > 1e-4 * scale


# ConvNeXt-Base stage rows at batch b: b x 64^2 .. b x 8^2 (256 x 256 images).
STAGE_ROWS = [(c, b * (64 >> s) ** 2) for s, c in enumerate(SUPPORTED_C) for b in (1, 8, 32)]


@pytest.mark.parametrize("c,n", STAGE_ROWS + [(c, 1003) for c in SUPPORTED_C])
def test_tail_plan_tiles_grid_and_workspace(c, n):
    plan = bf16_tail_plan(n, c)
    rows = -(-n // 128)
    assert plan["tile"] == (128, 128, 64, 4) and plan["smem"] <= 232448
    assert plan["tiles"] == [rows * 4 * c // 128, rows * c // 128, rows * 4 * c // 128, rows * c // 128]
    assert plan["grid"] == [min(t, 132) for t in plan["tiles"]]
    assert plan["forward_workspace"] == -(-2 * n // 32) * 32 + -(-4 * n * c // 32) * 32
    # The backward holds at least its f32 rows (xhat, xn, d_u, u, d_xn), h,
    # gelu'(a) and d_a in f32, and the four transposed TF32 plane pairs.
    ldn = (n + 3) // 4 * 4
    assert plan["backward_workspace"] >= 5 * n * c + 12 * n * c + 20 * c * ldn


def test_tail_plan_at_known_shapes():
    """Hand-computed plans: bs 32 at C = 128 (many waves of 132 blocks), bs 1
    at C = 1024 (one row tile: fewer tiles than SMs), a ragged 1003 rows at
    C = 256, and 7 rows at C = 1024 with the backward's whole workspace (one
    split of the rows, one chunk of the column sums)."""
    p = bf16_tail_plan(131072, 128)
    assert p["tiles"] == [4096, 1024, 4096, 1024] and p["grid"] == [132] * 4
    assert p["forward_workspace"] == 262144 + 67108864
    p = bf16_tail_plan(64, 1024)
    assert p["tiles"] == [32, 8, 32, 8] and p["grid"] == [32, 8, 32, 8]
    assert p["forward_workspace"] == 128 + 262144
    p = bf16_tail_plan(1003, 256)
    assert p["tiles"] == [64, 16, 64, 16] and p["grid"] == [64, 16, 64, 16]
    assert p["forward_workspace"] == 2016 + 1027072
    p = bf16_tail_plan(7, 1024)
    # xhat, xn, d_u, u, d_xn (7 x 1024 each); xn^T, d_u^T (2 planes of 1024 x
    # 8); h, gelu'(a), d_a (7 x 4096 each); h^T, d_a^T (2 planes of 4096 x 8);
    # 1/sqrt(var + eps) (7, padded to 32); one chunk of 8 x 1024 partials.
    assert p["backward_workspace"] == 5 * 7168 + 2 * 16384 + 3 * 28672 + 2 * 65536 + 32 + 8192
    assert bf16_tail_plan(7, 1024, sms=100)["grid"] == [32, 8, 32, 8]
    assert bf16_tail_plan(131072, 128, sms=100)["grid"] == [100] * 4
