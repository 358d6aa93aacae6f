"""The bf16 backward instances' plain versions (what the CPU wrappers run,
and what the CUDA instances are held against on the card) against the JAX
package's bf16 backward arms, on numpy-seeded inputs; the autograd
functions that call them; and their sources.

- The MLP tail's backward (``_mlp_bwd_plain_bf16``) against JAX's
  ``_bwd_pallas`` on bf16 g, x, w1 and w2 (the rest f32) under
  ``pltpu.force_tpu_interpret_mode()``, as ``tests/test_mlp_block.py`` runs
  it, with a ragged N (the last row tile partial):
  - the f32 outputs (d_sd, d_ln_w, d_ln_b, d_b1, d_b2, d_gamma) within
    1e-5 x max(1, max |JAX|): f32 sums of the same products in another
    order;
  - d_x and the weight gradients rounded to bf16 (JAX's
    ``.astype(w1.dtype)``) within one bf16 ulp of JAX's value, the ulp
    floored at 2^-16 x max |JAX| of the tensor: an f32 sum in another
    order rounds to the neighbouring bf16 value and no further, except
    where a weight gradient's terms cancel to far below the tensor's
    scale, where the f32 sum's own error (about 1e-6 of the largest
    element) is more than that element's ulp (measured: one ulp at most
    with the floor; 0.02-0.05% of the elements of d_x, d_w1 and d_w2 one
    ulp apart; without the floor up to 10 ulps of an element whose terms
    cancel; the f32 outputs within 7.4e-7).
- The depthwise conv's bf16 backward: the input gradient (the bf16 conv
  of the cotangent with the flipped filter) and ``_dw_grad_plain``'s
  filter gradient rounded to bf16 once against JAX's ``_bwd`` on bf16
  operands, its filter gradient both XLA's ``_dw_grad_xla`` and the
  Pallas ``_dwg_kernel`` (``TPU_CAPTIONER_DW_GRAD=pallas``, interpret
  mode): within one bf16 ulp (measured: equal).  The bias gradient, which
  JAX takes as the transpose of its bf16 bias add (a bf16 ``reduce_sum``,
  which XLA on the CPU accumulates in bf16), against the port's f32 sum
  rounded once: within (n - 1) 2^-9 x the sum of |g| over the channel's n
  rows, the error bound of a sum of n terms accumulated in bf16 (measured:
  at most 1.13 x 2^-8 of it, 0.05 of the bound, on 48 rows); the port's
  value equal to bf16 of the exact sum.
- The autograd functions on bf16 CPU tensors: each bf16 input's gradient
  is bf16, the f32 sums rounded once; the f32 vectors' gradients f32.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bf16_ops import jnp_bf16, to_bf16
from tests.test_torch_helpers import t
from tpu_captioner.ops import dwconv as jax_dwconv
from tpu_captioner.ops.mlp_block import _bwd_pallas
from tpu_captioner_torch.ops.dwconv import (
    _dw_grad_plain,
    _dw_plain,
    depthwise_conv7x7_nhwc,
    dwconv_filter_grad,
    dwconv_forward,
)
from tpu_captioner_torch.ops.mlp_block import (
    _mlp_bwd_plain_bf16,
    fused_convnext_mlp,
    fused_convnext_mlp_bwd,
)

BF = torch.bfloat16
F32_TOL = 1e-5
NAMES = ("d_x", "d_sd", "d_ln_w", "d_ln_b", "d_w1", "d_b1", "d_w2", "d_b2", "d_gamma")


def ulp_err(got, want, floor_rel=2.0 ** -16) -> float:
    """The largest |got - want| in bf16 ulps of ``want``, the ulp floored at
    ``floor_rel`` x max |want|."""
    want = np.asarray(want, dtype=np.float32)
    got = np.asarray(got, dtype=np.float32)
    floor = floor_rel * max(float(np.abs(want).max()), 1e-30)
    ulp = np.maximum(np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7), floor)
    return float((np.abs(got - want) / ulp).max())


def mlp_operands(n, c, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    g, x = to_bf16(f(n, c)), to_bf16(f(n, c))
    w1, w2 = to_bf16(0.05 * f(c, 4 * c)), to_bf16(0.05 * f(4 * c, c))  # the JAX layouts
    sd = np.where(rng.random(n) < 0.7, 2.0, 0.0).astype(np.float32)
    vec = dict(ln_w=1 + 0.1 * f(c), ln_b=0.1 * f(c), b1=0.1 * f(4 * c), b2=0.1 * f(c), gamma=0.5 * f(c))
    return g, x, w1, w2, sd, vec


@pytest.mark.parametrize("n,c", [(160, 128), (600, 128), (97, 256)])
def test_mlp_bwd_plain_bf16_matches_jax_pallas(n, c):
    """600 rows at C = 128 take JAX two row tiles of 512, the last partial;
    97 rows one partial tile."""
    from jax.experimental.pallas import tpu as pltpu

    g, x, w1, w2, sd, v = mlp_operands(n, c, seed=n + c)
    with pltpu.force_tpu_interpret_mode():
        want = _bwd_pallas(jnp_bf16(g), jnp_bf16(x), jnp.asarray(sd), jnp.asarray(v["ln_w"]), jnp.asarray(v["ln_b"]),
                           jnp_bf16(w1), jnp.asarray(v["b1"]), jnp_bf16(w2), jnp.asarray(v["b2"]),
                           jnp.asarray(v["gamma"]))
    assert [str(w.dtype) for w in want] == ["bfloat16"] + ["float32"] * 3 + ["bfloat16", "float32"] * 2 + ["float32"]
    args = (g, x, t(sd), t(v["ln_w"]), t(v["ln_b"]), w1.T.contiguous(), t(v["b1"]), w2.T.contiguous(), t(v["b2"]),
            t(v["gamma"]))
    got = _mlp_bwd_plain_bf16(*args)
    assert got[0].dtype == BF and all(a.dtype == torch.float32 for a in got[1:])
    for name, a, b in zip(NAMES, got, want):
        b = np.asarray(b.astype(jnp.float32))
        if name in ("d_w1", "d_w2"):  # the port's nn.Linear layouts, rounded once as JAX rounds them
            a = a.T.to(BF)
        if name in ("d_x", "d_w1", "d_w2"):
            assert ulp_err(a.float().numpy(), b) <= 1.0, name
        else:
            err = np.abs(a.numpy() - b).max() / max(1.0, np.abs(b).max())
            assert err <= F32_TOL, (name, err)
    # The CPU wrapper runs the plain version and counts no launch.
    before = fused_convnext_mlp_bwd.launches, fused_convnext_mlp_bwd.bf16_launches
    for a, b in zip(fused_convnext_mlp_bwd(*args), got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (fused_convnext_mlp_bwd.launches, fused_convnext_mlp_bwd.bf16_launches) == before


def test_mlp_tail_autograd_rounds_each_weight_gradient_once():
    """Autograd through ``fused_convnext_mlp`` on bf16 rows and matrices:
    d_x and the residual's gradient bf16 (the latter the cotangent
    itself), d_w1 and d_w2 bf16 of the plain version's f32 sums, the f32
    vectors' gradients those f32 sums."""
    n, c = 48, 16
    g, x, w1, w2, sd, v = mlp_operands(n, c, seed=3)
    res = to_bf16(np.random.default_rng(4).standard_normal((n, c)))
    x, res, w1t, w2t = (a.clone().requires_grad_() for a in (x, res, w1.T.contiguous(), w2.T.contiguous()))
    vec = {k: t(a).requires_grad_() for k, a in v.items()}
    out = fused_convnext_mlp(x, res, t(sd), vec["ln_w"], vec["ln_b"], w1t, vec["b1"], w2t, vec["b2"], vec["gamma"])
    assert out.dtype == BF
    out.backward(g)
    want = _mlp_bwd_plain_bf16(g, x.detach(), t(sd), *(vec[k].detach() for k in ("ln_w", "ln_b")), w1t.detach(),
                               vec["b1"].detach(), w2t.detach(), vec["b2"].detach(), vec["gamma"].detach())
    assert torch.equal(x.grad, want[0]) and torch.equal(res.grad, g)
    assert w1t.grad.dtype == w2t.grad.dtype == BF
    assert torch.equal(w1t.grad, want[4].to(BF)) and torch.equal(w2t.grad, want[6].to(BF))
    for k, i in (("ln_w", 2), ("ln_b", 3), ("b1", 5), ("b2", 7), ("gamma", 8)):
        assert vec[k].grad.dtype == torch.float32 and torch.equal(vec[k].grad, want[i]), k


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("shape", [(3, 4, 4, 24), (2, 9, 7, 16)])
def test_dwconv_bf16_backward_matches_jax(monkeypatch, shape, impl):
    """The input and filter gradients against JAX's custom VJP on bf16
    operands (its filter gradient XLA's or the Pallas kernel's), and the
    bias gradient against JAX's bf16 bias add."""
    import jax
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("TPU_CAPTIONER_DW_GRAD", impl)
    rng = np.random.default_rng(sum(shape))
    x, g = to_bf16(rng.standard_normal(shape)), to_bf16(rng.standard_normal(shape))
    w = to_bf16(0.1 * rng.standard_normal((7, 7, shape[-1])))
    bias = to_bf16(0.1 * rng.standard_normal(shape[-1]))

    def jax_block_conv(a, k, b):  # tpu_captioner/models/convnext.py:154-155 on bf16 operands
        return jax_dwconv.depthwise_conv7x7_nhwc(a, k, False) + b

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jax_block_conv, jnp_bf16(x), jnp_bf16(w), jnp_bf16(bias))
        jdx, jdw, jdb = vjp(jnp_bf16(g))
    assert jdx.dtype == jdw.dtype == jdb.dtype == jnp.bfloat16
    dx = dwconv_forward(g, w, flip=True)
    assert dx.dtype == BF and torch.equal(dx, _dw_plain(g, w.flip(0, 1)))
    assert ulp_err(dx.float().numpy(), jdx.astype(jnp.float32)) <= 1.0
    dw, db = dwconv_filter_grad(x, g, bias_grad=True)
    assert dw.dtype == db.dtype == torch.float32 and torch.equal(dw, _dw_grad_plain(x, g))
    assert ulp_err(dw.to(BF).float().numpy(), jdw.astype(jnp.float32)) <= 1.0
    exact = g.double().sum(dim=(0, 1, 2))
    assert torch.equal(db.to(BF), exact.to(BF))
    abs_sum = g.double().abs().sum(dim=(0, 1, 2)).numpy()
    bias_err = np.abs(db.to(BF).double().numpy() - np.asarray(jdb.astype(jnp.float32), np.float64)) / abs_sum
    rows = x.numel() // x.shape[-1]
    assert bias_err.max() <= (rows - 1) * 2.0 ** -9, bias_err.max()  # recursive summation in bf16

    # The autograd function: the bf16 inputs' gradients in bf16, each
    # f32 sum rounded once.
    xs, ws, bs = (a.clone().requires_grad_() for a in (x, w, bias))
    for use_kernel, grad_kernel in ((True, True), (False, True)):
        for a in (xs, ws, bs):
            a.grad = None
        depthwise_conv7x7_nhwc(xs, ws, use_kernel, grad_kernel, bs).backward(g)
        assert torch.equal(xs.grad, dx) and torch.equal(ws.grad, dw.to(BF)) and torch.equal(bs.grad, db.to(BF))


def test_bf16_dwconv_wrappers_take_only_their_dtypes():
    """The filter gradient takes float32 or bfloat16, x and g alike, and
    gives float32 on both; its CPU path counts no launch."""
    x = torch.zeros(1, 8, 8, 16)
    before = depthwise_conv7x7_nhwc.grad_launches, depthwise_conv7x7_nhwc.bf16_grad_launches
    for dt in (torch.float32, BF):
        dw, db = dwconv_filter_grad(x.to(dt), x.to(dt), bias_grad=True)
        assert dw.dtype == db.dtype == torch.float32 and dw.shape == (7, 7, 16)
    assert (depthwise_conv7x7_nhwc.grad_launches, depthwise_conv7x7_nhwc.bf16_grad_launches) == before
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        dwconv_filter_grad(x.half(), x.half())
    with pytest.raises(ValueError, match="as x"):
        dwconv_filter_grad(x, x.to(BF))


def test_bf16_backward_sources_have_no_fallback():
    """Both bf16 backward entry points exist in their sources and read
    ``__nv_bfloat16``; the MLP backward's four weight products run the
    three-piece bf16 GEMM (``x3::gemm``) on the bf16 weights as they lie,
    two of them MN-major, with no weight split, and its workspace keeps no
    weight plane; the filter gradient's kernel is instantiated on its
    element type; the wrappers widen none of g, x or the weights to f32
    copies, and catch no build or launch failure."""
    from tpu_captioner_torch.ops import _build, dwconv, mlp_block

    bwd = (_build.CSRC / "mlp_block_bwd.cu").read_text()
    assert "int tc_mlp_block_backward_bf16(" in bwd and "tc_mlp_block_backward_bf16_workspace" in bwd
    assert "static_cast<const bf16*>(g)" in bwd and "backward_x3<1024>(TC_ARGS)" in bwd
    body = bwd[bwd.index("int backward_x3("):bwd.index("// ------------------------------------------- the precise=False")]
    assert body.count("TC_TRY(x3::gemm<0>(") == 2 and body.count("TC_TRY(x3::gemm<1>(") == 2
    assert "x3::gemm<1>(du, w2," in body and "x3::gemm<1>(da, w1," in body
    assert "split(w1" not in body and "split(w2" not in body and "to_bf16" not in body
    assert "make_plan(n, C, true)" in body and "make_plan(n, c, true).total" in bwd
    dw = (_build.CSRC / "dwconv.cu").read_text()
    assert "int tc_dwconv_wgrad_bf16(" in dw and "template <class T, bool kTma, int kCc, int kTw>\n" \
        "__global__ void __launch_bounds__(kMaxThreads, 1)\n    dwconv_wgrad_kernel(" in dw
    assert "pick_wgrad<__nv_bfloat16>" in dw and "static_cast<const bf*>(gy)" in dw
    for fn in (mlp_block.fused_convnext_mlp_bwd, mlp_block._FusedMLP.backward, mlp_block._bwd_lib,
               dwconv.dwconv_filter_grad, dwconv._DepthwiseConv.backward, dwconv._lib, dwconv._wgrad_plan):
        src = inspect.getsource(fn)
        assert "except" not in src, fn.__qualname__
        for widen in (".float()", "torch.float32)", ".to(torch.float"):
            assert widen not in src, (fn.__qualname__, widen)
    assert "NotImplementedError" not in inspect.getsource(mlp_block._FusedMLP.backward)
    assert "NotImplementedError" not in inspect.getsource(dwconv._DepthwiseConv.backward)
