"""The two CUDA kernels against their plain PyTorch versions, on the card.

The pytest form of ``chip_smoke.py``'s kernel phase.  Every test is marked
``gpu`` and skips without CUDA.  This file imports no JAX, so it also runs on
a machine without it (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Tolerances: 1e-4 absolute for outputs of order one, which sum up to 4C
(MLP) or E (decode) f32 products in another order than cuBLAS, with erff
against torch's erf; 1e-5 for the attention map, a mean of probabilities.
"""

import math

import pytest
import torch

from tpu_captioner_torch.ops.decode_step import (
    DecodeWeights,
    _decode_step_plain,
    fused_decode_step,
)
from tpu_captioner_torch.ops.mlp_block import _mlp_plain, fused_convnext_mlp

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def mlp_args(n, c, device, seed=0, sd="ones"):
    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    sd_scale = torch.ones(n) if sd == "ones" else (torch.rand(n, generator=g) < 0.7).float() * 2.0
    args = (
        f(n, c), f(n, c), sd_scale, 1.0 + 0.1 * f(c), 0.1 * f(c),
        0.02 * f(4 * c, c), 0.1 * f(4 * c), 0.02 * f(c, 4 * c), 0.1 * f(c), 0.5 * f(c),
    )
    return tuple(a.to(device) for a in args)


@pytest.mark.parametrize("c", [128, 256, 512, 1024])
@pytest.mark.parametrize("sd", ["ones", "mixed"])
def test_mlp_kernel_matches_plain(cuda, c, sd):
    args = mlp_args(1003, c, cuda, seed=c, sd=sd)  # ragged last row tile
    before = fused_convnext_mlp.launches
    got = fused_convnext_mlp(*args)
    torch.cuda.synchronize()
    assert fused_convnext_mlp.launches == before + 1
    want = _mlp_plain(*args)
    assert (got - want).abs().max().item() < 1e-4


def decode_args(L, R, T, P, E, H, Fd, pos, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    u = lambda fan_in, *s: (torch.rand(*s, generator=g) * 2 - 1) / math.sqrt(fan_in)  # noqa: E731
    w = DecodeWeights(  # matrices in (L, out, in) layout
        u(E, L, 3 * E, E), 0.1 * f(L, 3 * E), u(E, L, E, E), 0.1 * f(L, E),
        u(E, L, E, E), 0.1 * f(L, E), u(E, L, E, E), 0.1 * f(L, E),
        u(E, L, Fd, E), 0.1 * f(L, Fd), u(Fd, L, E, Fd), 0.1 * f(L, E),
        1 + 0.1 * f(L, E), 0.1 * f(L, E), 1 + 0.1 * f(L, E), 0.1 * f(L, E),
        1 + 0.1 * f(L, E), 0.1 * f(L, E),
    )
    ck, cv = f(L, R, T, E), f(L, R, T, E)
    # Slots at and past pos are unwritten in a real cache: NaN here, so any
    # read of them would show in the output.
    ck[:, :, pos:] = float("nan")
    cv[:, :, pos:] = float("nan")
    w = DecodeWeights(*(t.to(device) for t in w))
    return (w, f(R, E).to(device), pos, ck.to(device), cv.to(device),
            f(L, R, P, E).to(device), f(L, R, P, E).to(device), H)


@pytest.mark.parametrize(
    "shape",
    [
        dict(L=3, R=10, T=8, P=4, E=64, H=4, Fd=48),  # the CPU tests' config, ragged rows
        dict(L=6, R=40, T=52, P=49, E=512, H=8, Fd=512),  # beam 5 x batch 8, full width
    ],
)
@pytest.mark.parametrize("pos_at", ["first", "middle", "last"])
def test_decode_kernel_matches_plain(cuda, shape, pos_at):
    T = shape["T"]
    pos = {"first": 0, "middle": T // 2, "last": T - 1}[pos_at]
    args = decode_args(*shape.values(), pos=pos, device=cuda)
    before = fused_decode_step.launches
    got = fused_decode_step(*args)
    torch.cuda.synchronize()
    assert fused_decode_step.launches == before + shape["L"]
    want = _decode_step_plain(*args)
    for name, a, b, tol in zip(("x", "alpha", "k_new", "v_new"), got, want, (1e-4, 1e-5, 1e-4, 1e-4)):
        assert torch.isfinite(a).all(), name
        assert (a - b).abs().max().item() < tol, name
