"""The CUDA kernels against their plain PyTorch versions, on the card.

The pytest form of ``chip_smoke.py``'s kernel phase.  Every test is marked
``gpu`` and skips without CUDA.  This file imports no JAX, so it also runs on
a machine without it (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Tolerances: 1e-4 absolute for outputs of order one, which sum up to 4C
(MLP) or E (decode) f32 products in another order than cuBLAS, with erff
against torch's erf; 1e-5 for the attention map, a mean of probabilities.
The MLP tail's whole-tile forward and its backward take their products from
TF32 tensor cores through a hi/lo split of each operand (3xTF32,
``csrc/tf32x3_gemm.cuh``) and are held to the same f32 tolerances: also at
row counts that leave their 128-row tiles ragged, one per width, and with
the inputs, weights and biases scaled by 1e3 (within 1e-4 times max(1, the
largest magnitude)); rows with sd 0 return the residual bit for bit.
The dropout pool's bits must be identical: both versions compute the same
Philox4x32-10 words in integer arithmetic.  The MLP-tail backward's nine
outputs agree within 1e-4 times each output's largest magnitude (sums over
up to 4C products and, for the parameter gradients, over all N rows, in
another order than cuBLAS); rows with sd 0 give d_x exactly 0.  The one-cell
decode kernel runs the per-layer kernel's arithmetic, so it agrees with it
within 1e-6.  The rollout kernel's sequences equal the plain rollout's except
at a near-tie (the plain logits of the two tokens within 1e-4 at the first
step where they differ); its logits agree within 1e-4 and its attention maps
within 1e-5 up to that step.  The decode kernels are also held at the
reference's pretrained-embedding widths, GloVe-200 (E=200, H=8: head width 25)
and word2vec-300 (E=300, H=6: head width 50), whose heads take the kernels'
scalar key loads.  The depthwise conv's forward kernel (and the input
gradient, the same kernel with the filter flipped) agrees with the grouped
conv within 1e-5 times max(1, its largest magnitude): 49 f32 products per
output, summed in another order than cuDNN's, with and without the bias in
its epilogue; the filter-gradient kernel, and the bias gradient from the
same launch, within 1e-4 times the same (sums over all B x H x W pixels),
with the same bits from run to run (a cluster's sums in a fixed order, no
atomics); both also through their instance without TMA (pointers off a
16-byte boundary, C % 4 != 0).  The
LSTM step kernel's h, c and attention map agree with its plain version within
1e-5 (sums of up to E + D + C products of order-one terms scaled by
1/sqrt(fan-in), in another order than cuBLAS's), at the serving (40 rows),
eval (32) and batch-32 beam (160) row counts and ragged ones, at E = 512, 300
(word2vec), 200 (GloVe, 160 rows) and 48, at 333 rows (three launches) and at
the JAX tests' odd small widths; it repeats bit for bit (no atomic in its
sums), and its library runs HGMMA and UTMALDG.  The whole-block kernel agrees with its plain version
within 1e-4 times max(1, its largest magnitude) (the conv's 49 products and
the tail's sums in another order than cuDNN's and cuBLAS's) at the four
ConvNeXt-Base stage shapes, at a batch whose rows do not fill the last tile
(3, 14, 14, 512) and at odd sides; its gradients (the dwconv and MLP-tail
backward kernels) agree with autograd of the plain version within 1e-4
times the same.  The MLP tail's sub-tiled kernel agrees with the
whole-tile path within 1e-5 times the same (the same 3xTF32 products, the
hidden chunks and the first product's stages in another grouping) and with
the plain version within 1e-4, at partial last row tiles and at the
cluster widths' bs-8 row counts, with sd-0 rows bit for bit and the same
bits from a second call.  The training loader's batches, copied from
pinned memory on a side stream, equal the host's arrays bit for bit.
The bf16 instances (``compute_dtype='bfloat16'`` serving): the depthwise
conv's forward (with and without the bias, and through its instance
without TMA) and the MLP tail's whole tile against their plain versions
within one bf16 ulp of the plain value (at least 2^-8): f32 sums in another
order may round to the neighbouring bf16 value; the decode arm's single
layer launch within 2e-3 times max(1, the largest magnitude) for x_out and
alpha and one ulp for k_new and v_new (one bf16 rounding of an operand that
another sum order can flip inside a product), at the beams' and the eval
step's rows.  A CUDA model pins cuBLAS's bf16 reductions to f32.  The bf16
backward instances (bf16 training): the MLP tail's backward on bf16 g, x
and weights, d_x within one bf16 ulp of its plain version (0 where sd is
0) and its eight f32 gradients within 1e-4 times max(1, the largest
magnitude), as the f32 instance's, the same bits twice; the depthwise
conv's bf16 filter and bias gradient within 1e-4 times the same, the same
bits twice, also through its instance without TMA, and its bf16 input
gradient (the forward instance with the filter flipped) within one ulp; a
bf16 block's backward through the autograd functions launches each bf16
instance and rounds each cast weight's gradient to bf16 once.  The bf16
decoder instances: the LSTM step's (bf16 weight matrices, emb, enc and
att1) with alpha within 1e-5 and h, c within the larger of 2e-3 times
max(1, the largest magnitude) and twice the noise floor (the plain bf16 arm
with f64 sums against itself: a one-ulp flip of a bf16-rounded activation
moves a gate), at the beams' and the eval step's rows and at widths that
take its loads without TMA, the same bits twice, and a dtype set that is
neither instance's refused; the one-cell decode instance equal to the
per-layer bf16 launches bit for bit; the rollout instance against its
plain version, sequences equal except at a near-tie and logits and maps
within the same bound up to a row's first difference.  The last bf16
instances: the whole block's (bf16 x, taps, w1, w2) within one bf16 ulp of
its plain version at the four stage shapes, a ragged batch and odd sides,
sd-0 images bit for bit, and its backward on the card against the same
composition on the CPU (bf16 gradients within one ulp of the largest,
f32 ones within 1e-4 times max(1, the largest)); the sub-tiled MLP tail's
within one ulp of its plain version and of the whole-tile bf16 instance,
sd-0 rows bit for bit, the same bits twice; both refuse an x off a
16-byte boundary.  The bf16 whole tile and backward on the three-piece
GEMM (``csrc/bf16_gemm.cuh``: x3::gemm) at 1, 7, 1003 and 8192 rows and
each stage's rows at batch 1, 8 and 32, under the same limits, both twice bit for bit;
their libraries' x3 instances issue bf16 HGMMA and UTMALDG and no TF32
HGMMA, no weight is split in a call, and the C side's tile plan and
workspaces are ``ops/mlp_block.py:bf16_tail_plan``'s.  The depthwise conv's
bf16 TMA instances at every ConvNeXt-Base stage and batch 1, 3, 8 and 32:
the forward with and without the bias within one ulp, the filter and bias
gradient within 1e-4 times max(1, the largest magnitude) and the same bits
twice, the flipped input gradient at the fine-tune stages within one ulp and
equal to the autograd function's.
"""

import math

import pytest
import torch

from tpu_captioner_torch.models.transformer import sinusoidal_pe
from tpu_captioner_torch.ops.block_fused import _block_plain, fused_convnext_block
from tpu_captioner_torch.ops.decode_step import (
    DecodeWeights,
    _decode_step_plain,
    _full_rollout_plain,
    fused_decode_step,
    fused_full_rollout,
)
from tpu_captioner_torch.ops.dropout_mask import _mask_plain, random_mask_pool
from tpu_captioner_torch.ops.dwconv import (
    _dw_grad_plain,
    _dw_plain,
    depthwise_conv7x7_nhwc,
    dwconv_filter_grad,
    dwconv_forward,
)
from tpu_captioner_torch.ops.lstm_step import LstmStepWeights, _lstm_step_plain, fused_lstm_step
from tpu_captioner_torch.ops.mlp_block import (
    FUSED_TILES,
    SUPPORTED_C,
    _mlp_bwd_plain,
    _mlp_bwd_plain_bf16_products,
    _mlp_plain,
    _mlp_plain_bf16_products,
    _pipeline_sub,
    fused_convnext_mlp,
    fused_convnext_mlp_bwd,
)

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


@pytest.mark.parametrize("n,c", [(1003, c) for c in SUPPORTED_C] + [(600, 128), (7, 1024)])
def test_mlp_backward_kernel_matches_plain(cuda, n, c):
    x, _, sd, *params = mlp_args(n, c, cuda, seed=n + c, sd="mixed")
    g = torch.randn(n, c, generator=torch.Generator().manual_seed(c)).to(cuda)
    before = fused_convnext_mlp_bwd.launches
    got = fused_convnext_mlp_bwd(g, x, sd, *params)
    torch.cuda.synchronize()
    assert fused_convnext_mlp_bwd.launches == before + 1
    want = _mlp_bwd_plain(g, x, sd, *params)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.isfinite(a).all(), i
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, b.abs().max().item()), i
    assert torch.equal(got[0][sd == 0], torch.zeros_like(got[0][sd == 0]))
    again = fused_convnext_mlp_bwd(g, x, sd, *params)  # no atomics: the same bits
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# Row counts that leave the tensor-core MLP kernels' 128-row tiles ragged,
# one per width (the whole-tile forward and the backward, csrc/tf32x3_gemm.cuh).
TC_ROWS = {128: 4133, 256: 1100, 512: 777, 1024: 300}


def scaled(args, scale, keep=()):
    """``args`` with every tensor but those at the indices in ``keep`` times ``scale``."""
    return tuple(a if i in keep else a * scale for i, a in enumerate(args))


@pytest.mark.parametrize("c", SUPPORTED_C)
@pytest.mark.parametrize("scale", [1.0, 1e3])
def test_tensor_core_mlp_forward_at_ragged_rows(cuda, monkeypatch, c, scale):
    monkeypatch.delenv("TPU_CAPTIONER_MLP_SUB", raising=False)
    args = mlp_args(TC_ROWS[c], c, cuda, seed=c + 11, sd="mixed")
    args = scaled(args, scale, keep=(2, 3, 4, 9))  # sd, ln_w, ln_b and gamma as they are
    before = (fused_convnext_mlp.launches, fused_convnext_mlp.pipelined_launches)
    got = fused_convnext_mlp(*args)
    torch.cuda.synchronize()
    assert (fused_convnext_mlp.launches, fused_convnext_mlp.pipelined_launches) == (before[0] + 1, before[1])
    want = _mlp_plain(*args)
    tol = 1e-4 * (1.0 if scale == 1.0 else max(1.0, want.abs().max().item()))
    assert torch.isfinite(got).all() and (got - want).abs().max().item() < tol
    dropped = args[2] == 0
    assert dropped.any() and torch.equal(got[dropped], args[1][dropped])  # sd 0: the residual, bit for bit


@pytest.mark.parametrize("c", SUPPORTED_C)
@pytest.mark.parametrize("scale", [1.0, 1e3])
def test_tensor_core_mlp_backward_at_ragged_rows(cuda, c, scale):
    n = TC_ROWS[c]
    x, _, sd, *params = mlp_args(n, c, cuda, seed=n + c, sd="mixed")
    g = torch.randn(n, c, generator=torch.Generator().manual_seed(c + 3)).to(cuda)
    args = scaled((g, x, sd, *params), scale, keep=(2, 3, 4, 9))
    got = fused_convnext_mlp_bwd(*args)
    torch.cuda.synchronize()
    want = _mlp_bwd_plain(*args)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.isfinite(a).all(), i
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, b.abs().max().item()), i
    assert (sd == 0).any() and torch.equal(got[0][sd == 0], torch.zeros_like(got[0][sd == 0]))
    again = fused_convnext_mlp_bwd(*args)  # no atomics: the same bits
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# The precise=False arm (bf16 products) against its plain versions.  Kernel
# and plain version compute LayerNorm's statistics and the products' f32
# sums in other orders, so an operand an f32 ulp apart now and then rounds to
# the neighbouring bf16 value, which moves its row's outputs by up to an
# operand ulp times a weight column.  So the forward on f32 data is held,
# over the rows with sd != 0, in mean to BF16P_MEAN_TOL times the mean
# magnitude of the MLP branch (|plain - residual|), and at its largest to
# BF16P_MAX_TOL x max(1, max |plain|); on bf16 data every element within one
# bf16 ulp of the plain value; rows with sd 0 the residual bit for bit.  It
# must lie more than 10 x BF16P_MEAN_TOL (same measure) from the
# precise=True kernel on the same inputs.  The backward's nine outputs
# within BF16P_BWD_TOL x max(1, max |plain|) at their largest (a bf16 d_x
# one ulp apart is up to 2^-7 of the largest value), and in mean within
# BF16P_BWD_MEAN_TOL of that (bf16 d_x aside: its own rounding is 2^-9
# relative).
BF16P_MEAN_TOL, BF16P_MAX_TOL, BF16P_BWD_TOL, BF16P_BWD_MEAN_TOL = 5e-5, 1e-2, 1e-2, 5e-5


def bf16_ulps(got, want):
    """Largest |got - want| in bf16 ulps of want (at least 2^-8)."""
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -8))) - 7).clamp_min(2.0 ** -8)
    return ((got - want).abs() / ulp).max().item()


def bf16_product_args(n, c, device, dtype, seed):
    args = list(mlp_args(n, c, device, seed=seed, sd="mixed"))
    if dtype == torch.bfloat16:
        for i in (0, 1, 5, 7):
            args[i] = args[i].to(dtype)
    return tuple(args)


@pytest.mark.parametrize("c", SUPPORTED_C)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sub", [0, 64])
def test_bf16_product_forward_matches_plain(cuda, monkeypatch, c, dtype, sub):
    if sub:
        monkeypatch.setenv("TPU_CAPTIONER_MLP_SUB", str(sub))
    else:
        monkeypatch.delenv("TPU_CAPTIONER_MLP_SUB", raising=False)
    args = bf16_product_args(TC_ROWS[c], c, cuda, dtype, seed=c + 5)
    names = ("launches", "bf16_product_launches", "pipelined_bf16_product_launches", "bf16_product_bf16_launches",
             "pipelined_bf16_product_bf16_launches", "pipelined_launches", "bf16_launches")
    before = [getattr(fused_convnext_mlp, k) for k in names]
    got = fused_convnext_mlp(*args, precise=False)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert [getattr(fused_convnext_mlp, k) - b for k, b in zip(names, before)] == [
        1, 1, int(bool(sub)), int(bf16), int(bool(sub) and bf16), 0, 0]
    want = _mlp_plain_bf16_products(*args)
    res, sd = args[1], args[2]
    kept = sd != 0
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert (~kept).any() and torch.equal(got[~kept], res[~kept])  # sd 0: the residual, bit for bit
    g, w, r = got[kept].float(), want[kept].float(), res[kept].float()
    branch = (w - r).abs().mean().item()
    if bf16:
        assert bf16_ulps(g, w) <= 1.0
    else:
        assert (g - w).abs().mean().item() <= BF16P_MEAN_TOL * branch
        assert (g - w).abs().max().item() <= BF16P_MAX_TOL * max(1.0, w.abs().max().item())
    precise = fused_convnext_mlp(*args)
    assert (g - precise[kept].float()).abs().mean().item() > 10 * BF16P_MEAN_TOL * branch


@pytest.mark.parametrize("c", SUPPORTED_C)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bf16_product_backward_matches_plain(cuda, c, dtype):
    n = TC_ROWS[c]
    x, _, sd, *params = bf16_product_args(n, c, cuda, dtype, seed=n + c)
    g = torch.randn(n, c, generator=torch.Generator().manual_seed(c + 7)).to(cuda).to(dtype)
    before = fused_convnext_mlp_bwd.launches, fused_convnext_mlp_bwd.bf16_product_launches
    got = fused_convnext_mlp_bwd(g, x, sd, *params, precise=False)
    torch.cuda.synchronize()
    assert (fused_convnext_mlp_bwd.launches, fused_convnext_mlp_bwd.bf16_product_launches) == (
        before[0] + 1, before[1] + 1)
    want = _mlp_bwd_plain_bf16_products(g, x, sd, *params)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.isfinite(a).all(), i
        err, scale = (a.float() - b.float()).abs(), max(1.0, b.abs().max().item())
        assert err.max().item() <= BF16P_BWD_TOL * scale, i
        if not (i == 0 and dtype == torch.bfloat16):
            assert err.mean().item() <= BF16P_BWD_MEAN_TOL * scale, i
    assert (sd == 0).any() and torch.equal(got[0][sd == 0], torch.zeros_like(got[0][sd == 0]))
    again = fused_convnext_mlp_bwd(g, x, sd, *params, precise=False)  # no atomics: the same bits
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_bf16_product_autograd_launches_the_arm(cuda):
    """Autograd through ``fused_convnext_mlp(..., precise=False)`` launches
    the arm's forward and backward instances and none of the others'."""
    c = 256
    leaves = [a.clone().requires_grad_() for a in bf16_product_args(300, c, cuda, torch.float32, seed=1)]
    counts = lambda: (fused_convnext_mlp.bf16_product_launches, fused_convnext_mlp_bwd.bf16_product_launches,  # noqa: E731
                      fused_convnext_mlp_bwd.launches)
    before = counts()
    out = fused_convnext_mlp(*leaves, precise=False)
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [1, 1, 1]
    want = _mlp_bwd_plain_bf16_products(torch.ones_like(out), leaves[0].detach(), *(a.detach() for a in leaves[2:]))
    assert (leaves[0].grad - want[0]).abs().max().item() <= BF16P_BWD_TOL * max(1.0, want[0].abs().max().item())


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
        dict(L=6, R=40, T=52, P=49, E=200, H=8, Fd=512),  # GloVe-200: head width 25
        dict(L=6, R=40, T=52, P=49, E=300, H=6, Fd=512),  # word2vec-300: head width 50
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


@pytest.mark.parametrize(
    "shape",
    [dict(L=3, R=10, T=8, P=4, E=64, H=4, Fd=48), dict(L=6, R=32, T=52, P=49, E=512, H=8, Fd=512),
     dict(L=6, R=32, T=52, P=49, E=200, H=8, Fd=512), dict(L=6, R=32, T=52, P=49, E=300, H=6, Fd=512)],
)
@pytest.mark.parametrize("pos_at", ["first", "middle", "last"])
def test_onecell_kernel_matches_layer_kernel_and_plain(cuda, shape, pos_at):
    T = shape["T"]
    pos = {"first": 0, "middle": T // 2, "last": T - 1}[pos_at]
    args = decode_args(*shape.values(), pos=pos, device=cuda)
    before = (fused_decode_step.launches, fused_decode_step.onecell_launches)
    got = fused_decode_step(*args, one_cell=True)
    torch.cuda.synchronize()
    assert (fused_decode_step.launches, fused_decode_step.onecell_launches) == (before[0], before[1] + 1)
    per_layer = fused_decode_step(*args)
    want = _decode_step_plain(*args)
    for name, a, b, c, tol in zip(("x", "alpha", "k_new", "v_new"), got, per_layer, want, (1e-4, 1e-5, 1e-4, 1e-4)):
        assert torch.isfinite(a).all(), name
        assert (a - b).abs().max().item() <= 1e-6, name
        assert (a - c).abs().max().item() < tol, name


def rollout_args(R, steps, device, teacher, L=6, P=49, E=512, H=8, Fd=512, V=9490, seed=0):
    """Full-width weights, memory K/V, tables and (steps, R) teacher tensors;
    the vocab head scaled x16 so that its argmax has clear winners."""
    w, _, _, _, _, mem_k, mem_v, _ = decode_args(L, R, steps, P, E, H, Fd, 0, device, seed)
    g = torch.Generator().manual_seed(seed + 1)
    tables = (
        torch.randn(V, E, generator=g),
        16 * (torch.rand(V, E, generator=g) * 2 - 1) / math.sqrt(E),
        0.1 * torch.randn(V, generator=g),
        sinusoidal_pe(steps, E),
    )
    mix = {}
    if teacher:
        mix = dict(teacher=torch.randint(0, V, (steps, R), generator=g),
                   use_teacher=torch.rand(steps, R, generator=g) < 0.5)
    return (w, *(t.to(device) for t in tables), mem_k, mem_v), {k: v.to(device) for k, v in mix.items()}


def assert_rollouts_agree(got, want, tie_gap=1e-4):
    """Per row: equal tokens up to the first step where they differ, which
    must be a near-tie of the plain logits; logits and maps agree up to it."""
    (gl, gs, ga), (wl, ws, wa) = got, want
    for r in range(ws.shape[0]):
        diff = (gs[r] != ws[r]).nonzero()
        upto = ws.shape[1] if len(diff) == 0 else int(diff[0]) + 1
        if len(diff):
            s, a, b = upto - 1, int(gs[r, upto - 1]), int(ws[r, upto - 1])
            assert abs(wl[r, s, a] - wl[r, s, b]).item() < tie_gap, (r, s)
        assert (gl[r, :upto] - wl[r, :upto]).abs().max().item() < 1e-4, r
        assert (ga[r, :upto] - wa[r, :upto]).abs().max().item() < 1e-5, r


@pytest.mark.parametrize("rows", [4, 32])
@pytest.mark.parametrize("steps", [1, 12, 51])
@pytest.mark.parametrize("teacher", [False, True])
@pytest.mark.parametrize("end", ["never", "emitted", "first"])
def test_rollout_kernel_matches_plain(cuda, rows, steps, teacher, end):
    """The whole-rollout kernel against ``_full_rollout_plain``: an end id no
    row emits, the most frequent token of that rollout (some rows finish),
    and one the head is biased to (every row finishes at step 0, so the
    kernel must stop after one token)."""
    args, mix = rollout_args(rows, steps, cuda, teacher, seed=rows + steps)
    V, start = args[1].shape[0], args[1].shape[0] - 2
    end_id = -1
    if end == "emitted":
        _, seqs, _ = _full_rollout_plain(*args, start, -1, steps, 8, **mix)
        end_id = int(torch.bincount(seqs.flatten().long()).argmax())
    elif end == "first":
        end_id = 7
        args[3][end_id] += 1e3
    want = _full_rollout_plain(*args, start, end_id, steps, 8, **mix)
    before = fused_full_rollout.launches
    got = fused_full_rollout(*args, start, end_id, steps, 8, **mix)
    torch.cuda.synchronize()
    assert fused_full_rollout.launches == before + 1
    assert got[1].dtype == torch.int32 and all(torch.isfinite(x).all() for x in (got[0], got[2]))
    assert_rollouts_agree(got, want)
    ends = want[1] == end_id
    lengths = torch.where(ends.any(1), ends.int().argmax(1) + 1, steps)
    assert int(fused_full_rollout.steps_run) == int(lengths.max())  # stopped once all rows finished
    if end == "first":
        assert int(fused_full_rollout.steps_run) == 1 and not got[0][:, 1:].any()


# The decode kernels at the beam's row counts: 1, 8, 40 (8 images x beam 5)
# and 160 (32 x 5), at the reference's widths.
DECODE_ROWS = [1, 8, 40, 160]
DECODE_WIDTHS = [(512, 8), (300, 6), (200, 8)]


@pytest.mark.parametrize("rows", DECODE_ROWS)
@pytest.mark.parametrize("E,H", DECODE_WIDTHS)
@pytest.mark.parametrize("pos", [0, 1, 51])
def test_decode_kernels_at_beam_rows(cuda, rows, E, H, pos):
    """The per-layer and one-cell kernels against the plain step at cache
    length 52, positions 0, 1 and T - 1, with NaN in every cache slot at or
    past pos; the one-cell kernel within 1e-6 of the per-layer one; each
    kernel gives the same bits when run again."""
    args = decode_args(6, rows, 52, 49, E, H, 512, pos, cuda, seed=rows + E + pos)
    before = (fused_decode_step.launches, fused_decode_step.onecell_launches)
    per_layer = fused_decode_step(*args)
    one_cell = fused_decode_step(*args, one_cell=True)
    torch.cuda.synchronize()
    assert (fused_decode_step.launches, fused_decode_step.onecell_launches) == (before[0] + 6, before[1] + 1)
    want = _decode_step_plain(*args)
    for name, a, b, c, tol in zip(("x", "alpha", "k_new", "v_new"), per_layer, one_cell, want,
                                  (1e-4, 1e-5, 1e-4, 1e-4)):
        assert torch.isfinite(a).all() and torch.isfinite(b).all(), name
        assert (a - c).abs().max().item() < tol, name
        assert (a - b).abs().max().item() <= 1e-6, name
    assert all(torch.equal(a, b) for a, b in zip(per_layer, fused_decode_step(*args)))
    assert all(torch.equal(a, b) for a, b in zip(one_cell, fused_decode_step(*args, one_cell=True)))


def staggered_end_id(seqs):
    """The token whose first occurrences end the rows at the most different
    steps (rows that never emit it run to the end)."""
    steps = seqs.shape[1]
    best, best_n = -1, 0
    for tok in torch.unique(seqs).tolist():
        hit = seqs == tok
        ends = torch.where(hit.any(1), hit.int().argmax(1), steps)
        n = len(set(ends.tolist()))
        if n > best_n:
            best, best_n = tok, n
    return best


@pytest.mark.parametrize("rows", DECODE_ROWS)
@pytest.mark.parametrize("E,H", DECODE_WIDTHS)
def test_rollout_kernel_at_beam_rows(cuda, rows, E, H):
    """The whole-rollout kernel at 1, 8, 40 and 160 rows and the three
    widths, 51 steps, with an end id that ends the rows at different
    tokens: against the plain rollout, stopping after the longest row, and
    the same bits when run again."""
    steps = 51
    args, _ = rollout_args(rows, steps, cuda, False, E=E, H=H, seed=rows + E)
    V, start = args[1].shape[0], args[1].shape[0] - 2
    _, seqs, _ = _full_rollout_plain(*args, start, -1, steps, H)
    end_id = staggered_end_id(seqs)
    want = _full_rollout_plain(*args, start, end_id, steps, H)
    got = fused_full_rollout(*args, start, end_id, steps, H)
    torch.cuda.synchronize()
    assert all(torch.isfinite(x).all() for x in (got[0], got[2]))
    assert_rollouts_agree(got, want)
    ends = want[1] == end_id
    lengths = torch.where(ends.any(1), ends.int().argmax(1) + 1, steps)
    if rows >= 8:
        assert len(set(lengths.tolist())) > 1  # rows end at different tokens
    assert int(fused_full_rollout.steps_run) == int(lengths.max())
    again = fused_full_rollout(*args, start, end_id, steps, H)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("n", [1, 4, 4099, 1_000_003])  # ragged tails of 1, 0, 3 and 3
@pytest.mark.parametrize("keep", [0.5, 0.9])
def test_dropout_kernel_matches_plain(cuda, n, keep):
    seed = (0xDEADBEEF, n)
    before = random_mask_pool.launches
    got = random_mask_pool(seed, n, keep, cuda)
    torch.cuda.synchronize()
    assert random_mask_pool.launches == before + 1
    assert got.dtype == torch.bool and got.shape == (n,)
    assert torch.equal(got, _mask_plain(seed, n, keep, cuda))


@pytest.mark.parametrize("E,H", [(200, 8), (300, 6)])
@pytest.mark.parametrize("end", ["never", "emitted"])
def test_rollout_kernel_matches_plain_at_embedding_widths(cuda, E, H, end):
    """The whole-rollout kernel at the GloVe-200 and word2vec-300 widths, 32
    rows, 51 steps, with an end id no row emits and with one rows emit."""
    steps = 51
    args, mix = rollout_args(32, steps, cuda, False, E=E, H=H, seed=E)
    V, start = args[1].shape[0], args[1].shape[0] - 2
    end_id = -1
    if end == "emitted":
        _, seqs, _ = _full_rollout_plain(*args, start, -1, steps, H)
        end_id = int(torch.bincount(seqs.flatten().long()).argmax())
    want = _full_rollout_plain(*args, start, end_id, steps, H)
    before = fused_full_rollout.launches
    got = fused_full_rollout(*args, start, end_id, steps, H)
    torch.cuda.synchronize()
    assert fused_full_rollout.launches == before + 1
    assert all(torch.isfinite(x).all() for x in (got[0], got[2]))
    assert_rollouts_agree(got, want)


# -- the depthwise conv -----------------------------------------------------------

# (B, H, W, C): the four ConvNeXt-Base stages at batch 8 (serving) and 32
# (train and eval), then a ragged C (not a multiple of 4: scalar code) and
# odd H and W (partial tiles).
DW_SHAPES = [(b, 64 >> s, 64 >> s, 128 << s) for b in (8, 32) for s in range(4)] + [
    (2, 16, 16, 24), (3, 13, 11, 130), (1, 9, 7, 10), (5, 5, 3, 1024),
]


def dw_inputs(shape, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, generator=g)
    w = 0.1 * torch.randn(7, 7, shape[-1], generator=g)
    return x.to(device), w.to(device)


def dw_bias(shape, device, seed=0):
    return torch.randn(shape[-1], generator=torch.Generator().manual_seed(seed + 3)).to(device)


def unaligned(t):
    """A contiguous copy of t whose data starts 4 bytes past a 16-byte
    boundary: the plan's instance without TMA."""
    buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    return buf[1:].view(t.shape).copy_(t)


def within(got, want, rel):
    return (got - want).abs().max().item() <= rel * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("shape", DW_SHAPES)
def test_dwconv_forward_kernel_matches_plain(cuda, shape, bias):
    x, w = dw_inputs(shape, cuda, seed=shape[-1] + shape[1])
    b = dw_bias(shape, cuda, seed=shape[-1]) if bias else None
    before = depthwise_conv7x7_nhwc.launches
    got = dwconv_forward(x, w, bias=b)
    torch.cuda.synchronize()
    assert depthwise_conv7x7_nhwc.launches == before + 1
    want = _dw_plain(x, w, b)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert within(got, want, 1e-5)
    flipped = dwconv_forward(x, w, flip=True)  # the input-gradient form
    assert within(flipped, _dw_plain(x, w.flip(0, 1)), 1e-5)


@pytest.mark.parametrize("bias_grad", [False, True])
@pytest.mark.parametrize("shape", [(32, 16, 16, 512), (32, 8, 8, 1024), (8, 64, 64, 128), (3, 13, 11, 130),
                                   (2, 9, 7, 10)])
def test_dwconv_filter_grad_kernel_matches_plain(cuda, shape, bias_grad):
    x, _ = dw_inputs(shape, cuda, seed=shape[-1])
    g = torch.randn(*shape, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = depthwise_conv7x7_nhwc.grad_launches
    got = dwconv_filter_grad(x, g, bias_grad=bias_grad)
    torch.cuda.synchronize()
    assert depthwise_conv7x7_nhwc.grad_launches == before + 1
    want = _dw_grad_plain(x, g, bias_grad)
    again = dwconv_filter_grad(x, g, bias_grad=bias_grad)
    if bias_grad:  # the bias gradient, the sum of g, from the same launch
        (got, d_b), (want, want_b), (again, again_b) = got, want, again
        assert d_b.shape == (shape[-1],) and within(d_b, want_b, 1e-4) and torch.equal(d_b, again_b)
    assert got.shape == (7, 7, shape[-1]) and torch.isfinite(got).all()
    assert within(got, want, 1e-4)
    assert torch.equal(got, again)  # a fixed summation order: the same bits


@pytest.mark.parametrize("shape", [(32, 16, 16, 512), (8, 8, 8, 1024), (4, 64, 64, 128), (2, 9, 7, 12)])
def test_dwconv_kernels_without_tma_match_plain(cuda, shape):
    """Pointers off a 16-byte boundary take the kernels' instance that
    stages its boxes with the producer warp's own loads (the plan's
    tma=False); it agrees with the plain versions as the TMA instance does."""
    x, w = dw_inputs(shape, cuda, seed=4)
    b, g = dw_bias(shape, cuda, seed=4), torch.randn(*shape, generator=torch.Generator().manual_seed(5)).to(cuda)
    ux, uw, ug = unaligned(x), unaligned(w), unaligned(g)
    assert ux.data_ptr() % 16 and ux.is_contiguous()
    assert within(dwconv_forward(ux, uw, bias=b), _dw_plain(x, w, b), 1e-5)
    assert within(dwconv_forward(ug, uw, flip=True), _dw_plain(g, w.flip(0, 1)), 1e-5)
    d_w, d_b = dwconv_filter_grad(ux, ug, bias_grad=True)
    want_w, want_b = _dw_grad_plain(x, g, True)
    assert within(d_w, want_w, 1e-4) and within(d_b, want_b, 1e-4)
    assert torch.equal(d_w, dwconv_filter_grad(x, g))  # the same sums in the same order as with TMA


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("shape", [(32, 16, 16, 512), (4, 8, 8, 1024), (2, 9, 7, 10)])
def test_dwconv_autograd_matches_grouped_conv(cuda, shape, bias):
    """The op with both kernels against autograd through the grouped conv:
    output, input gradient and filter gradient (and, with ``bias``, the
    bias's gradient from the filter gradient's launch), with one launch of
    each kernel per forward, input gradient and filter gradient."""
    x, w = dw_inputs(shape, cuda, seed=7)
    b = dw_bias(shape, cuda, seed=7).requires_grad_(True) if bias else None
    g = torch.randn(*shape, generator=torch.Generator().manual_seed(2)).to(cuda)
    x.requires_grad_(True)
    w.requires_grad_(True)
    leaves = (x, w, b) if bias else (x, w)
    before = (depthwise_conv7x7_nhwc.launches, depthwise_conv7x7_nhwc.grad_launches)
    y = depthwise_conv7x7_nhwc(x, w, True, True, b)
    got = torch.autograd.grad(y, leaves, g)
    torch.cuda.synchronize()
    assert (depthwise_conv7x7_nhwc.launches, depthwise_conv7x7_nhwc.grad_launches) == (
        before[0] + 2, before[1] + 1)
    y_ref = _dw_plain(x, w, b)
    want = torch.autograd.grad(y_ref, leaves, g)
    assert within(y, y_ref, 1e-5) and within(got[0], want[0], 1e-5) and within(got[1], want[1], 1e-4)
    if bias:
        assert within(got[2], want[2], 1e-4)


def lstm_args(R, E, D, A, C, P, device, seed=0):
    """``fused_lstm_step``'s arguments: weights U(+-1/sqrt(fan-in)) as the
    default Linear and LSTMCell draw them, inputs N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    u = lambda fan_in, *s: (torch.rand(*s, generator=g) * 2 - 1) / math.sqrt(fan_in)  # noqa: E731
    f = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    w = LstmStepWeights(u(D, A, D), u(D, A), u(A, A), u(A, 1), u(D, C, D), u(D, C),
                        u(D, 4 * D, E), u(D, 4 * D, C), u(D, 4 * D, D), 2 * u(D, 4 * D))
    return (LstmStepWeights(*(x.to(device) for x in w)),
            *(x.to(device) for x in (f(R, E), f(R, D), f(R, D), f(R, P, C), f(R, P, A))))


def assert_lstm_step_matches_plain(args):
    before = fused_lstm_step.launches
    got = fused_lstm_step(*args)
    torch.cuda.synchronize()
    assert fused_lstm_step.launches == before + 1
    want = _lstm_step_plain(*args)
    for name, a, b in zip(("h", "c", "alpha"), got, want):
        assert torch.isfinite(a).all(), name
        assert (a - b).abs().max().item() < 1e-5, name
    assert all(torch.equal(a, b) for a, b in zip(got, fused_lstm_step(*args)))


@pytest.mark.parametrize("rows", [1, 32, 37, 40, 160])
@pytest.mark.parametrize("E", [512, 300, 48])
def test_lstm_step_kernel_matches_plain(cuda, rows, E):
    """The model's widths D = A = 512, C = 1024, P = 49, with the
    embedding width free."""
    assert_lstm_step_matches_plain(lstm_args(rows, E, 512, 512, 1024, 49, cuda, seed=rows + E))


@pytest.mark.parametrize("rows", [1, 5, 37])
@pytest.mark.parametrize("widths", [(48, 56, 36, 40, 4), (7, 5, 3, 9, 3), (300, 33, 65, 130, 50)])
def test_lstm_step_kernel_at_odd_widths(cuda, rows, widths):
    """(E, D, A, C, P): ``tests/test_lstm_kernel.py``'s widths, widths that
    are no multiple of 4, and P beyond a warp."""
    assert_lstm_step_matches_plain(lstm_args(rows, *widths, cuda, seed=rows))


def test_lstm_step_refuses_widths_beyond_shared_memory(cuda):
    """A gate block keeps its share of w_ih_c in shared memory beside a ring
    of two slots (``lstm_plan``): at C = 8192 with D = 1000 (63 gate tiles,
    two K splits) the share alone is 1 MB, and the wrapper raises a
    ValueError, it does not fall back."""
    z = lambda *s: torch.zeros(*s, device=cuda)  # noqa: E731
    R, E, D, A, C, P = 2, 8, 1000, 8, 8192, 4
    w = LstmStepWeights(z(A, D), z(A), z(A), z(1), z(C, D), z(C), z(4 * D, E), z(4 * D, C), z(4 * D, D), z(4 * D))
    with pytest.raises(ValueError, match="shared memory"):
        fused_lstm_step(w, z(R, E), z(R, D), z(R, D), z(R, P, C), z(R, P, A))


def test_lstm_step_kernel_at_glove_width(cuda):
    """The bs-32 beam's 160 rows at GloVe-200's embedding width."""
    assert_lstm_step_matches_plain(lstm_args(160, 200, 512, 512, 1024, 49, cuda, seed=7))


def test_lstm_step_kernel_beyond_one_launch(cuda):
    """333 rows: three launches of at most 160 rows, each reading the
    weights once."""
    args = lstm_args(333, 512, 512, 512, 1024, 49, cuda, seed=11)
    before = fused_lstm_step.launches
    got = fused_lstm_step(*args)
    torch.cuda.synchronize()
    assert fused_lstm_step.launches == before + 3
    for name, a, b in zip(("h", "c", "alpha"), got, _lstm_step_plain(*args)):
        assert a.shape == b.shape and (a - b).abs().max().item() < 1e-5, name


def test_lstm_step_library_runs_tensor_cores_and_tma(cuda):
    """The built library issues the tensor cores' wgmma (HGMMA) and TMA
    loads (UTMALDG), and no floating-point atomic: its sums are in a fixed
    order."""
    import os
    import re
    import subprocess

    from tpu_captioner_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.build("lstm_step"))], capture_output=True, text=True,
                          check=True).stdout
    assert re.search(r"\bHGMMA\b", sass) and re.search(r"\bUTMALDG\b", sass)
    assert not re.search(r"\b(?:RED|ATOM|ATOMG)\.\S*F32", sass)


def cuda_sass(name):
    """``cuobjdump -sass`` of the built library ``name``, by function:
    {mangled name: its SASS}."""
    import os
    import re
    import subprocess

    from tpu_captioner_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.build(name))], capture_output=True, text=True,
                          check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", sass)
    return dict(zip(parts[1::2], parts[2::2]))


def recorded_kernels(call):
    """The device kernels' names of one ``call()`` (which synchronises),
    recorded by ``torch.profiler`` after a warm-up call (a window that
    starts with the call it records can lose that call's first kernels).
    A window that records no kernel at all is taken again, twice at most:
    the card's profiler now and then misses a whole window (PERF.md §7)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        windows = []
        with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: windows.append(p.key_averages())) as prof:
            for _ in range(2):
                call()
                prof.step()
        names = [e.key for e in windows[-1] if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


def test_mlp_bf16_instances_run_bf16_tensor_cores_on_tma(cuda, monkeypatch):
    """The bf16 instances' three-piece products issue bf16 HGMMA and UTMALDG
    and no TF32 HGMMA: the whole tile's and backward's GEMM
    (``x3::gemm_kernel`` instances: both forward products, the backward's
    four with a weight as B, two of them on the MN-major layout), the bf16
    block's two products (the whole tile's GEMM in ``block_fused``'s
    library; no 3xTF32 GEMM with a bf16 epilogue remains there) and the
    sub-tiled kernel's three-piece instances (``fused_kernel<C, NC, bf16,
    false, true>``, seven tiles).  No weight split or preparation runs in a
    bf16 call (no ``to_bf16``, ``split_kernel`` on a weight or ``prep_w1``:
    the profiler's kernels by name): the whole tile and backward launch six
    x3 GEMMs, the block its conv + LayerNorm and two x3 GEMMs, the
    sub-tiled path its one kernel."""
    import re

    from tpu_captioner_torch.ops.block_fused import _lib as block_lib
    from tpu_captioner_torch.ops.mlp_block import _bwd_lib, _lib

    _lib(), _bwd_lib(), block_lib()
    for name, count in (("mlp_block", 2), ("mlp_block_bwd", 4), ("block_fused", 2)):
        fns = {k: v for k, v in cuda_sass(name).items() if "bf16mm2x311gemm_kernel" in k}
        assert len(fns) == count, (name, sorted(fns))
        for fn, sass in fns.items():
            assert re.search(r"\bHGMMA\.\S*\.BF16", sass) and re.search(r"\bUTMALDG\b", sass), fn
            assert not re.search(r"\bHGMMA\.\S*TF32", sass), fn
    tf32_bf16 = [k for k in cuda_sass("block_fused") if "tf32x3" in k and "13__nv_bfloat16" in k]
    assert not tf32_bf16, tf32_bf16
    sub_x3 = {k: v for k, v in cuda_sass("mlp_block").items()
              if "12fused_kernel" in k and "13__nv_bfloat16Lb0ELb1E" in k}
    assert len(sub_x3) == len(FUSED_TILES), sorted(sub_x3)
    for fn, sass in sub_x3.items():
        assert re.search(r"\bHGMMA\.\S*\.BF16", sass) and re.search(r"\bUTMALDG\b", sass), fn
        assert not re.search(r"\bHGMMA\.\S*TF32", sass), fn
    n, c = 2048, 512
    args = bf16_mlp_args(n, c, cuda, seed=1)

    def call():
        fused_convnext_mlp(*args)
        fused_convnext_mlp_bwd(args[1], *(a for i, a in enumerate(args) if i != 1))
        torch.cuda.synchronize()

    names = recorded_kernels(call)
    assert sum("bf16mm::x3::gemm_kernel" in k for k in names) == 6, names
    # The backward's two transposed splits are of the f32 rows xn and d_u;
    # a bf16 weight's split would be split_kernel<__nv_bfloat16>.
    splits = [k for k in names if "split_kernel" in k]
    assert len(splits) == 1 and "bfloat16" not in splits[0], names
    assert not any("to_bf16" in k for k in names), names
    blk = bf16_block_args((8, 16, 16, 512), cuda, seed=2)
    names = recorded_kernels(lambda: (fused_convnext_block(*blk), torch.cuda.synchronize()))
    assert len(names) == 3 and sum("bf16mm::x3::gemm_kernel" in k for k in names) == 2, names
    assert any("conv_ln_kernel" in k for k in names) and not any("tf32x3" in k for k in names), names
    monkeypatch.setenv("TPU_CAPTIONER_MLP_SUB", "64")
    names = recorded_kernels(lambda: (fused_convnext_mlp(*args), torch.cuda.synchronize()))
    assert len(names) == 1 and "fused_kernel" in names[0] and "__nv_bfloat16, false, true" in names[0], names


def test_mlp_bf16_plan_is_the_packages(cuda):
    """The C side's tile plan (``tc_mlp_block_bf16_plan``) and both bf16
    workspaces are ``ops/mlp_block.py:bf16_tail_plan``'s, at every width for
    batch 1, 8 and 32 and at ragged rows, for this card's SM count and
    another."""
    import ctypes

    from tpu_captioner_torch.ops.mlp_block import _bwd_lib, _lib, bf16_tail_plan

    lib, bwd = _lib(), _bwd_lib()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for s, c in enumerate(SUPPORTED_C):
        for n in [b * (64 >> s) ** 2 for b in (1, 8, 32)] + [1, 7, 1003]:
            for count in (sms, 100, 0):
                out = (ctypes.c_longlong * 14)()
                assert lib.tc_mlp_block_bf16_plan(n, c, count, out) == 0
                plan = bf16_tail_plan(n, c, count or sms)
                assert list(out[:5]) == [*plan["tile"], plan["smem"]] and out[4] <= 232448
                assert list(out[5:9]) == plan["tiles"] and list(out[9:13]) == plan["grid"]
                assert out[13] == plan["forward_workspace"]
            plan = bf16_tail_plan(n, c, sms)
            assert lib.tc_mlp_block_forward_bf16_workspace(n, c, 0) == plan["forward_workspace"]
            assert bwd.tc_mlp_block_backward_bf16_workspace(n, c) == plan["backward_workspace"]
    assert lib.tc_mlp_block_bf16_plan(0, 128, 132, (ctypes.c_longlong * 14)()) == -1
    assert lib.tc_mlp_block_bf16_plan(64, 2048, 132, (ctypes.c_longlong * 14)()) == -1


# The sub-tile rows each width takes (ops/mlp_block.py:_pipeline_sub).
MLP_SUBS = [(128, 64), (256, 64), (512, 64), (1024, 64)]


def sub_tiled(args, monkeypatch, sub=64):
    """The forward through the sub-tiled kernel: one launch, counted as one."""
    monkeypatch.setenv("TPU_CAPTIONER_MLP_SUB", str(sub))
    assert _pipeline_sub(args[0].shape[0], args[0].shape[1]) == sub
    before = (fused_convnext_mlp.launches, fused_convnext_mlp.pipelined_launches)
    got = fused_convnext_mlp(*args)
    torch.cuda.synchronize()
    assert (fused_convnext_mlp.launches, fused_convnext_mlp.pipelined_launches) == (before[0] + 1, before[1] + 1)
    return got


@pytest.mark.parametrize("c,sub", MLP_SUBS)
@pytest.mark.parametrize("n", [1003, 4096])
def test_pipelined_mlp_kernel_matches_monolithic_and_plain(cuda, monkeypatch, c, sub, n):
    args = mlp_args(n, c, cuda, seed=c + sub, sd="mixed")
    monkeypatch.delenv("TPU_CAPTIONER_MLP_SUB", raising=False)
    whole = fused_convnext_mlp(*args)
    got = sub_tiled(args, monkeypatch, sub)
    want = _mlp_plain(*args)
    scale = max(1.0, want.abs().max().item())
    assert (got - whole).abs().max().item() <= 1e-5 * scale
    assert (got - want).abs().max().item() <= 1e-4 * scale


# Row counts of the sub-tiled kernel: a partial last row tile (and a last
# tile with one row of its second sub-tile, and one with no row there), the
# bs-8 stage shapes of the cluster widths (C = 512: 2048 rows, C = 1024:
# 512), one tile alone, and the bs-32 stage shapes of C >= 256 with a
# partial last tile, which take 256 output columns a block.
FUSED_ROWS = [(128, 65), (128, 1003), (256, 130), (256, 777), (512, 2048), (512, 1003), (1024, 512),
              (1024, 64), (1024, 1003), (256, 32767), (512, 8191), (1024, 2047)]


@pytest.mark.parametrize("c,n", FUSED_ROWS)
def test_fused_mlp_kernel_rows_and_repeats(cuda, monkeypatch, c, n):
    """Against the plain version (1e-4) and the whole-tile path (1e-5), both
    times max(1, the plain output's largest magnitude); rows with sd 0 come
    out as their residual bit for bit; a second call gives the same bits (the
    cluster's exchange of h has a fixed order)."""
    args = mlp_args(n, c, cuda, seed=3 * c + n, sd="mixed")
    monkeypatch.delenv("TPU_CAPTIONER_MLP_SUB", raising=False)
    whole = fused_convnext_mlp(*args)
    got = sub_tiled(args, monkeypatch)
    again = sub_tiled(args, monkeypatch)
    want = _mlp_plain(*args)
    scale = max(1.0, want.abs().max().item())
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4 * scale
    assert (got - whole).abs().max().item() <= 1e-5 * scale
    dropped = args[2] == 0
    assert dropped.any() and torch.equal(got[dropped], args[1][dropped])
    assert torch.equal(got, again)


def test_fused_mlp_plan_is_the_packages(cuda):
    """The C side's tiles (``tc_mlp_block_fused_plan``) are
    ``ops/mlp_block.py:FUSED_TILES``: the cluster covers every output column
    and hidden unit once and the shared memory fits a block; the launch
    takes 256 columns a block at the bs-32 stage shapes of C >= 256 and 128
    at bs 8 (``tc_mlp_block_fused_columns``)."""
    import ctypes

    from tpu_captioner_torch.ops.mlp_block import FUSED_TILES, SUB_ROWS, _lib

    lib = _lib()
    for (c, nc), (s, jcb) in FUSED_TILES.items():
        out = (ctypes.c_int * 6)()
        assert lib.tc_mlp_block_fused_plan(c, nc, out) == 0
        assert list(out)[:3] == [s, jcb, s * jcb] and out[5] == SUB_ROWS
        assert s * nc == c and 4 * c % (s * jcb) == 0 and out[4] <= 232448
    assert lib.tc_mlp_block_fused_plan(192, 128, (ctypes.c_int * 6)()) == -1
    assert lib.tc_mlp_block_fused_plan(128, 256, (ctypes.c_int * 6)()) == -1
    for s, c in enumerate(SUPPORTED_C):
        assert lib.tc_mlp_block_fused_columns(c, 32 * (64 >> s) ** 2) == (128 if c == 128 else 256)
        assert lib.tc_mlp_block_fused_columns(c, 8 * (64 >> s) ** 2) == 128


def test_bf16_x3_plans_are_the_packages(cuda):
    """The three-piece instances' plans on the C side are the package's
    mirrors: ``tc_mlp_block_fused_x3_plan`` is ``fused_x3_plan`` at every
    tile (and refuses another), ``tc_block_fused_workspace`` is
    ``block_workspace`` for both element sizes at the stage shapes and
    ragged pixel counts (and -1 for another size), and the bf16 sub-tiled
    call asks for no workspace."""
    import ctypes

    from tpu_captioner_torch.ops.block_fused import _lib as block_lib
    from tpu_captioner_torch.ops.block_fused import block_workspace
    from tpu_captioner_torch.ops.mlp_block import _lib, fused_x3_plan

    lib, blk = _lib(), block_lib()
    keys = ("cluster", "jcb", "jc", "slots", "smem", "sub_rows", "slot_bytes", "h_bytes")
    for c, nc in FUSED_TILES:
        out = (ctypes.c_int * 8)()
        assert lib.tc_mlp_block_fused_x3_plan(c, nc, out) == 0
        plan = fused_x3_plan(c, nc)
        assert list(out) == [plan[k] for k in keys], (c, nc)
    assert lib.tc_mlp_block_fused_x3_plan(192, 128, (ctypes.c_int * 8)()) == -1
    for s, c in enumerate(SUPPORTED_C):
        for n in [b * (64 >> s) ** 2 for b in (1, 8, 32)] + [7, 1003]:
            for esize in (4, 2):
                assert blk.tc_block_fused_workspace(n, c, esize) == block_workspace(n, c, esize), (n, c, esize)
            assert lib.tc_mlp_block_forward_bf16_workspace(n, c, 64) == 0
    assert blk.tc_block_fused_workspace(128, 512, 3) == -1


def test_fused_mlp_kernel_refuses_other_sub_rows(cuda):
    """The C entry point takes sub 0 or 64 only: any other value returns
    cudaErrorInvalidValue before a launch (the wrapper never passes one)."""
    from tpu_captioner_torch.ops import _build
    from tpu_captioner_torch.ops.mlp_block import _lib

    args = mlp_args(256, 128, cuda)
    lib = _lib()
    out, work = torch.empty_like(args[0]), args[0].new_empty(lib.tc_mlp_block_forward_workspace(256, 128, 64))
    for sub in (8, 32, 128):
        err = lib.tc_mlp_block_forward(*(t.data_ptr() for t in (*args, out, work)), 256, 128, sub,
                                       _build.raw_stream(0))
        assert err == 1  # cudaErrorInvalidValue


def block_args(shape, device, seed=0, sd="mixed"):
    b, _, _, c = shape
    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    sd_scale = torch.ones(b) if sd == "ones" else (torch.arange(b) % 3 != 0).float() * 1.25
    args = (f(*shape), sd_scale, 0.1 * f(7, 7, c), 0.1 * f(c), 1 + 0.1 * f(c), 0.1 * f(c),
            0.02 * f(4 * c, c), 0.1 * f(4 * c), 0.02 * f(c, 4 * c), 0.1 * f(c), 0.5 * f(c))
    return tuple(a.to(device) for a in args)


# The four stage shapes at batch 8 and 32, a batch whose tiles are ragged,
# and sides that are no multiple of the 8-column tile.
BLOCK_SHAPES = [(8, 64, 64, 128), (8, 32, 32, 256), (8, 16, 16, 512), (8, 8, 8, 1024), (32, 64, 64, 128),
                (32, 32, 32, 256), (32, 16, 16, 512), (32, 8, 8, 1024), (3, 14, 14, 512), (2, 9, 7, 128),
                (1, 5, 3, 1024)]


@pytest.mark.parametrize("shape", BLOCK_SHAPES)
@pytest.mark.parametrize("sd", ["ones", "mixed"])
def test_block_kernel_matches_plain(cuda, shape, sd):
    args = block_args(shape, cuda, seed=shape[1] + shape[3], sd=sd)
    before = fused_convnext_block.launches
    got = fused_convnext_block(*args)
    torch.cuda.synchronize()
    assert fused_convnext_block.launches == before + 1
    want = _block_plain(*args)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())
    dropped = args[1] == 0
    assert torch.equal(got[dropped], args[0][dropped])  # sd 0: the block is skipped


@pytest.mark.parametrize("shape", [(4, 16, 16, 512), (2, 8, 8, 1024), (2, 9, 7, 128)])
def test_block_autograd_matches_plain(cuda, shape):
    args = block_args(shape, cuda, seed=7)
    cot = torch.randn(*shape, generator=torch.Generator().manual_seed(8)).to(cuda)
    got = torch.autograd.grad((fused_convnext_block(*(a.requires_grad_() for a in args)) * cot).sum(), args)
    plain = [a.detach().clone().requires_grad_() for a in args]
    want = torch.autograd.grad((_block_plain(*plain) * cot).sum(), plain)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.isfinite(a).all(), i
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, b.abs().max().item()), i


def test_block_kernel_refuses_what_it_does_not_take(cuda):
    """A width without a kernel raises a ValueError on the card (no plain
    fallback); the C side refuses a plan whose shared memory disagrees with
    its own count, and ``_plan_on`` takes no more clusters than the card
    runs at once."""
    from tpu_captioner_torch.ops import _build
    from tpu_captioner_torch.ops.block_fused import _lib, _plan_on, block_plan

    with pytest.raises(ValueError, match="supports C in"):
        fused_convnext_block(*block_args((2, 8, 8, 192), cuda))
    args = block_args((2, 8, 8, 512), cuda)
    plan = block_plan(2, 8, 8, 512)
    lib = _lib()
    out, work = torch.empty_like(args[0]), args[0].new_empty(lib.tc_block_fused_workspace(128, 512, 4))
    bad = plan._replace(smem=plan.smem + 128)
    err = lib.tc_block_fused_forward(*(t.data_ptr() for t in (*args, out, work)), 2, 8, 8, 512, *bad.args(),
                                     _build.raw_stream(0))
    assert err == 1  # cudaErrorInvalidValue, before any launch
    big = _plan_on(0, 32, 8, 8, 1024)
    assert big.parts <= lib.tc_block_fused_clusters(1024, big.units, big.smem, 4)


def test_block_forward_reruns_on_the_backward_thread(cuda):
    """With activation checkpointing (the encoder's remat) the forward runs
    again on autograd's own thread, which starts with no CUDA context: the
    tensor maps must still encode."""
    from torch.utils.checkpoint import checkpoint

    args = [a.requires_grad_() for a in block_args((2, 16, 16, 512), cuda, seed=9)]
    out = checkpoint(fused_convnext_block, *args, use_reentrant=False)
    (g,) = torch.autograd.grad(out.square().sum(), args[0])
    plain = [a.detach().clone().requires_grad_() for a in args]
    (want,) = torch.autograd.grad(_block_plain(*plain).square().sum(), plain[0])
    assert (g - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


def test_loader_copies_the_host_batches_to_the_card(cuda, tmp_path):
    """``DeviceLoader`` on the card: every batch of an epoch, copied from
    pinned memory on its side stream and waited for by the consumer's
    stream, equals ``iterate_batches``' host arrays; a consumer that stops
    early leaves no thread behind."""
    import threading

    from tpu_captioner_torch.data.build import build_synthetic_dataset
    from tpu_captioner_torch.data.dataset import CaptionDataset, iterate_batches
    from tpu_captioner_torch.data.loader import DeviceLoader

    build_synthetic_dataset(str(tmp_path), num_images={"TRAIN": 9, "VAL": 2, "TEST": 2}, image_size=64)
    ds = CaptionDataset(str(tmp_path), "synthetic_5_cap_per_img_1_min_word_freq", "TRAIN")
    loader = DeviceLoader(ds, 8, device=cuda, seed=3)
    got = [{k: v.clone() for k, v in b.items()} for b in loader.epoch(2)]
    want = list(iterate_batches(ds, 8, epoch=2, seed=3))
    assert len(got) == len(want) == len(loader) == 6
    for g, w in zip(got, want):
        for k, v in w.as_dict().items():
            assert g[k].is_cuda and torch.equal(g[k].cpu(), torch.from_numpy(v)), k
    before = threading.active_count()
    it = loader.epoch(0)
    next(it)
    it.close()
    assert threading.active_count() == before


def within_bf16_ulp(got, want):
    """Within one bf16 ulp of the plain value, at least 2^-8, elementwise."""
    want = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -8))) - 7).clamp_min(2.0 ** -8)
    return bool(((got.float() - want).abs() <= ulp).all())


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("shape", [(8, 64, 64, 128), (32, 32, 32, 256), (32, 16, 16, 512), (8, 8, 8, 1024),
                                   (2, 9, 7, 24)])
def test_dwconv_bf16_kernel_matches_plain(cuda, shape, bias):
    g = torch.Generator().manual_seed(shape[-1] + shape[0])
    x = torch.randn(*shape, generator=g).to(cuda, torch.bfloat16)
    w = (0.1 * torch.randn(7, 7, shape[-1], generator=g)).to(cuda, torch.bfloat16)
    b = (0.1 * torch.randn(shape[-1], generator=g)).to(cuda, torch.bfloat16) if bias else None
    before = depthwise_conv7x7_nhwc.launches, depthwise_conv7x7_nhwc.bf16_launches
    got = dwconv_forward(x, w, bias=b)
    torch.cuda.synchronize()
    assert (depthwise_conv7x7_nhwc.launches, depthwise_conv7x7_nhwc.bf16_launches) == tuple(n + 1 for n in before)
    assert got.dtype == torch.bfloat16 and within_bf16_ulp(got, _dw_plain(x, w, b))
    # The instance without TMA: a pointer off a 16-byte boundary (held
    # against the plain version of the aligned copy: the grouped conv itself
    # faults on a bf16 tensor 2 bytes off).
    xu = unaligned(x)
    got_u = dwconv_forward(xu, w, bias=b)
    torch.cuda.synchronize()
    assert xu.data_ptr() % 16 and within_bf16_ulp(got_u, _dw_plain(x, w, b))


# The bf16 whole tile's and backward's rows: one row, a ragged 7 and 1003,
# 8192, and each ConvNeXt-Base stage's rows at batch 1, 8 and 32 (b x 64^2
# .. b x 8^2).
BF16_ROWS = sorted({(c, n) for c in SUPPORTED_C for n in (1, 7, 1003, 8192)} | {
    (c, b * (64 >> s) ** 2) for s, c in enumerate(SUPPORTED_C) for b in (1, 8, 32)})


@pytest.mark.parametrize("c,n", BF16_ROWS)
def test_mlp_bf16_kernel_matches_plain(cuda, c, n):
    """The bf16 whole tile (three bf16 pieces a product) within one bf16 ulp
    of its plain version; sd-0 rows the residual bit for bit; the same bits
    from a second call."""
    from tpu_captioner_torch.ops.mlp_block import _mlp_plain_bf16

    x, res, sd, lnw, lnb, w1, b1, w2, b2, gamma = mlp_args(n, c, cuda, seed=c + n, sd="mixed")
    sd[0] = 0.0  # at least one dropped row
    bf = torch.bfloat16
    args = (x.to(bf), res.to(bf), sd, lnw, lnb, w1.to(bf), b1, w2.to(bf), b2, gamma)
    before = fused_convnext_mlp.bf16_launches
    got = fused_convnext_mlp(*args)
    torch.cuda.synchronize()
    assert fused_convnext_mlp.bf16_launches == before + 1
    assert got.dtype == bf and within_bf16_ulp(got, _mlp_plain_bf16(*args))
    skipped = sd == 0
    assert torch.equal(got[skipped], args[1][skipped])  # sd 0: the residual, bit for bit
    assert torch.equal(fused_convnext_mlp(*args), got)


# The sub-tiled kernel's bf16 instance: each width at a ragged row count
# and at its bs-8 and bs-32 stage shapes (128 and 256 output columns a
# block), and one row tile alone.
FUSED_BF16_ROWS = [(128, 1003), (128, 32768), (128, 131072), (256, 777), (256, 8192), (256, 32767), (256, 32768),
                   (512, 2048), (512, 8191), (512, 8192), (1024, 512), (1024, 2047), (1024, 2048), (1024, 64)]


def bf16_mlp_args(n, c, device, seed):
    x, res, sd, lnw, lnb, w1, b1, w2, b2, gamma = mlp_args(n, c, device, seed=seed, sd="mixed")
    bf = torch.bfloat16
    return (x.to(bf), res.to(bf), sd, lnw, lnb, w1.to(bf), b1, w2.to(bf), b2, gamma)


@pytest.mark.parametrize("c,n", FUSED_BF16_ROWS)
def test_mlp_bf16_sub_tiled_kernel_matches_plain(cuda, monkeypatch, c, n):
    """``TPU_CAPTIONER_MLP_SUB=64`` on bf16 operands: one launch of the
    sub-tiled bf16 instance, within one bf16 ulp of the plain version and
    of the whole-tile bf16 instance, sd-0 rows the residual bit for bit,
    the same bits from a second call; an x off a 16-byte boundary is
    refused."""
    from tpu_captioner_torch.ops.mlp_block import _mlp_plain_bf16

    args = bf16_mlp_args(n, c, cuda, seed=5 * c + n)
    monkeypatch.delenv("TPU_CAPTIONER_MLP_SUB", raising=False)
    whole = fused_convnext_mlp(*args)
    before = fused_convnext_mlp.pipelined_bf16_launches
    got = sub_tiled(args, monkeypatch)
    again = sub_tiled(args, monkeypatch)
    assert fused_convnext_mlp.pipelined_bf16_launches == before + 2
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    assert within_bf16_ulp(got, _mlp_plain_bf16(*args)) and within_bf16_ulp(got, whole)
    dropped = args[2] == 0
    assert dropped.any() and torch.equal(got[dropped], args[1][dropped])
    assert torch.equal(got, again)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_convnext_mlp(unaligned(args[0]), *args[1:])


@pytest.mark.parametrize("rows", [40, 160, 32])
@pytest.mark.parametrize("pos", [0, 51])
def test_decode_bf16_layer_launch_matches_plain(cuda, rows, pos):
    from tpu_captioner_torch.ops.decode_step import _decode_step_plain_bf16, cast_weight_matrices

    E, H, Fd, P, T = 512, 8, 512, 49, 52
    g = torch.Generator().manual_seed(rows + pos)
    f = lambda *s, scale=1.0: (scale * torch.randn(*s, generator=g)).to(cuda)  # noqa: E731
    shapes = {"w_qkv": (1, 3 * E, E), "b_qkv": (1, 3 * E), "w_f1": (1, Fd, E), "b_f1": (1, Fd), "w_f2": (1, E, Fd)}
    w = DecodeWeights(*(f(*shapes.get(n, (1, E, E) if n in ("w_so", "w_cq", "w_co") else (1, E)),
                          scale=0.04 if n.startswith("w_") else 0.1) for n in DecodeWeights._fields))
    w = cast_weight_matrices(w._replace(ln1_s=1 + w.ln1_s, ln2_s=1 + w.ln2_s, ln3_s=1 + w.ln3_s), torch.bfloat16)
    bf = torch.bfloat16
    ck, cv = f(1, rows, T, E).to(bf), f(1, rows, T, E).to(bf)
    ck[:, :, pos:] = float("nan")
    cv[:, :, pos:] = float("nan")
    args = (w, f(rows, E).to(bf), pos, ck, cv, f(1, rows, P, E).to(bf), f(1, rows, P, E).to(bf), H)
    before = fused_decode_step.bf16_launches
    got = fused_decode_step(*args)
    torch.cuda.synchronize()
    assert fused_decode_step.bf16_launches == before + 1
    want = _decode_step_plain_bf16(*args)
    assert [t.dtype for t in got] == [torch.float32, torch.float32, bf, bf]
    for a, b in zip(got[:2], want[:2]):
        assert torch.isfinite(a).all() and within(a, b, 2e-3)
    for a, b in zip(got[2:], want[2:]):
        assert within_bf16_ulp(a, b)


def test_cuda_model_pins_bf16_reductions_to_f32(cuda):
    from tpu_captioner_torch.core.config import ModelConfig
    from tpu_captioner_torch.train.model import CaptionModel

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    CaptionModel(ModelConfig(vocab_size=11, encoder_depths=(1, 1, 1, 1), embed_dim=64, decoder_dim=64,
                             num_layers=1, compute_dtype="bfloat16"), device=cuda)
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False


# bf16 training: the backward instances.


@pytest.mark.parametrize("n,c", [(n, c) for c, n in BF16_ROWS])
def test_mlp_bf16_backward_kernel_matches_plain(cuda, n, c):
    """The bf16 backward on bf16 g, x, w1 and w2: d_x within one bf16 ulp of
    the plain version (0 on rows with sd 0), the eight f32 gradients within
    1e-4 x max(1, max |plain|), as the f32 instance's; the nine outputs bit
    for bit on a second call."""
    from tpu_captioner_torch.ops.mlp_block import _mlp_bwd_plain_bf16

    g, x, sd, lnw, lnb, w1, b1, w2, b2, gamma = mlp_args(n, c, cuda, seed=n + c, sd="mixed")
    sd[0] = 0.0  # at least one dropped row
    bf = torch.bfloat16
    args = (g.to(bf), x.to(bf), sd, lnw, lnb, w1.to(bf), b1, w2.to(bf), b2, gamma)
    before = fused_convnext_mlp_bwd.launches, fused_convnext_mlp_bwd.bf16_launches
    got = fused_convnext_mlp_bwd(*args)
    torch.cuda.synchronize()
    assert (fused_convnext_mlp_bwd.launches, fused_convnext_mlp_bwd.bf16_launches) == tuple(k + 1 for k in before)
    want = _mlp_bwd_plain_bf16(*args)
    assert got[0].dtype == bf and all(a.dtype == torch.float32 for a in got[1:])
    assert within_bf16_ulp(got[0], want[0])
    assert torch.equal(got[0][sd == 0], torch.zeros_like(got[0][sd == 0]))
    for a, b in zip(got[1:], want[1:]):
        assert torch.isfinite(a).all() and within(a, b, 1e-4)
    again = fused_convnext_mlp_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: the same bits


@pytest.mark.parametrize("bias_grad", [False, True])
@pytest.mark.parametrize("shape", [(32, 16, 16, 512), (32, 8, 8, 1024), (8, 64, 64, 128), (2, 9, 7, 24)])
def test_dwconv_bf16_filter_grad_kernel_matches_plain(cuda, shape, bias_grad):
    """The bf16 filter (and bias) gradient: f32 sums of bf16 x and g within
    1e-4 x max(1, max |plain|), the same bits twice, also through the
    instance without TMA; the input gradient (the bf16 forward with the
    filter flipped) within one bf16 ulp."""
    g = torch.Generator().manual_seed(sum(shape))
    bf = torch.bfloat16
    x = torch.randn(*shape, generator=g).to(cuda, bf)
    cot = torch.randn(*shape, generator=g).to(cuda, bf)
    w = (0.1 * torch.randn(7, 7, shape[-1], generator=g)).to(cuda, bf)
    before = depthwise_conv7x7_nhwc.grad_launches, depthwise_conv7x7_nhwc.bf16_grad_launches
    got = dwconv_filter_grad(x, cot, bias_grad)
    torch.cuda.synchronize()
    assert (depthwise_conv7x7_nhwc.grad_launches, depthwise_conv7x7_nhwc.bf16_grad_launches) == tuple(
        k + 1 for k in before)
    want = _dw_grad_plain(x, cot, bias_grad)
    got, want = (got, want) if bias_grad else ((got,), (want,))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and within(a, b, 1e-4)
    again = dwconv_filter_grad(x, cot, bias_grad)
    assert all(torch.equal(a, b) for a, b in zip(got, again if bias_grad else (again,)))
    xu, cu = unaligned(x), unaligned(cot)
    got_u = dwconv_filter_grad(xu, cu, bias_grad)
    got_u = got_u if bias_grad else (got_u,)
    for a, b in zip(got_u, want):
        assert within(a, b, 1e-4)
    dx = dwconv_forward(cot, w, flip=True)
    torch.cuda.synchronize()
    assert dx.dtype == bf and within_bf16_ulp(dx, _dw_plain(cot, w.flip(0, 1)))


# Every ConvNeXt-Base stage at batch 1, 3, 8 and 32.
BF16_DW_STAGES = [(b, 64 >> s, 64 >> s, 128 << s) for b in (1, 3, 8, 32) for s in range(4)]


def bf16_dw_inputs(shape, device, seed):
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    x, cot = (torch.randn(*shape, generator=g).to(device, bf) for _ in range(2))
    w = (0.1 * torch.randn(7, 7, shape[-1], generator=g)).to(device, bf)
    b = (0.1 * torch.randn(shape[-1], generator=g)).to(device, bf)
    return x, cot, w, b


@pytest.mark.parametrize("shape", BF16_DW_STAGES)
def test_dwconv_bf16_stages_match_plain(cuda, shape):
    """The bf16 TMA instances at every stage and batch: the forward with
    and without the bias within one bf16 ulp of the plain version; the
    filter and bias gradient within 1e-4 x max(1, max |plain|), the same
    bits twice."""
    from tpu_captioner_torch.ops import _build
    from tpu_captioner_torch.ops.dwconv import dwconv_plan

    x, cot, w, b = bf16_dw_inputs(shape, cuda, 11 + sum(shape))
    assert dwconv_plan(*shape, "forward", True, _build.sm_count(cuda.index or 0), esize=2).tma
    for bias in (None, b):
        got = dwconv_forward(x, w, bias=bias)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and within_bf16_ulp(got, _dw_plain(x, w, bias)), bias is None
    got = dwconv_filter_grad(x, cot, True)
    torch.cuda.synchronize()
    for a, want in zip(got, _dw_grad_plain(x, cot, True)):
        assert a.dtype == torch.float32 and torch.isfinite(a).all() and within(a, want, 1e-4)
    assert all(torch.equal(a, again) for a, again in zip(got, dwconv_filter_grad(x, cot, True)))


@pytest.mark.parametrize("batch", [1, 3, 8, 32])
@pytest.mark.parametrize("side, c", [(16, 512), (8, 1024)])
def test_dwconv_bf16_input_gradient_matches_plain(cuda, side, c, batch):
    """The flipped bf16 forward (the input gradient, rounded once) at the
    fine-tune step's stages, alone and through the autograd function."""
    shape = (batch, side, side, c)
    x, cot, w, _ = bf16_dw_inputs(shape, cuda, 17 + batch)
    dx = dwconv_forward(cot, w, flip=True)
    torch.cuda.synchronize()
    assert dx.dtype == torch.bfloat16 and within_bf16_ulp(dx, _dw_plain(cot, w.flip(0, 1)))
    xg = x.clone().requires_grad_(True)
    (d_x,) = torch.autograd.grad(depthwise_conv7x7_nhwc(xg, w, True, True), (xg,), cot)
    assert torch.equal(d_x, dx)


def test_bf16_autograd_runs_the_backward_instances(cuda):
    """A bf16 block's backward through the autograd functions on the card:
    one bf16 launch of each backward kernel and of the flipped conv, each
    bf16 input's gradient bf16, the f32 vectors' f32."""
    from tpu_captioner_torch.models.convnext import CNBlock

    blk = CNBlock(512, "mlp", device=cuda)
    blk.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        blk.layer_scale.fill_(0.5)
    x = torch.randn(4, 16, 16, 512, device=cuda).to(torch.bfloat16).requires_grad_()
    counts = lambda: (fused_convnext_mlp_bwd.bf16_launches, depthwise_conv7x7_nhwc.bf16_grad_launches,  # noqa: E731
                      depthwise_conv7x7_nhwc.bf16_launches)
    before = counts()
    out = blk(x)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 2)  # the forward and the input gradient
    assert out.dtype == x.grad.dtype == torch.bfloat16 and torch.isfinite(x.grad.float()).all()
    for name, p in blk.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all(), name
        if name in ("block.0.weight", "block.0.bias", "block.3.weight", "block.5.weight"):
            assert torch.equal(p.grad, p.grad.to(torch.bfloat16).float()), name  # rounded to bf16 once


# The whole-block kernel's bf16 instance.


def bf16_block_args(shape, device, seed, sd="mixed"):
    """x, the taps, w1 and w2 bf16, the rest f32: what the bf16 encoder
    passes in ``'block'``."""
    args = list(block_args(shape, device, seed=seed, sd=sd))
    for i in (0, 2, 6, 8):
        args[i] = args[i].to(torch.bfloat16)
    return tuple(args)


@pytest.mark.parametrize("shape", BLOCK_SHAPES)
@pytest.mark.parametrize("sd", ["ones", "mixed"])
def test_block_bf16_kernel_matches_plain(cuda, shape, sd):
    """Within one bf16 ulp of ``_block_plain_bf16`` at the four stage shapes
    at batch 8 and 32, a ragged batch and odd sides; sd-0 images are their
    input bit for bit; the same bits from a second call; one launch,
    counted as bf16; an x off a 16-byte boundary is refused."""
    from tpu_captioner_torch.ops.block_fused import _block_plain_bf16

    args = bf16_block_args(shape, cuda, seed=shape[1] + shape[3], sd=sd)
    before = fused_convnext_block.launches, fused_convnext_block.bf16_launches
    got = fused_convnext_block(*args)
    torch.cuda.synchronize()
    assert (fused_convnext_block.launches, fused_convnext_block.bf16_launches) == tuple(k + 1 for k in before)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    assert within_bf16_ulp(got, _block_plain_bf16(*args))
    dropped = args[1] == 0
    assert torch.equal(got[dropped], args[0][dropped])
    assert torch.equal(fused_convnext_block(*args), got)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_convnext_block(unaligned(args[0]), *args[1:])


@pytest.mark.parametrize("shape", [(4, 16, 16, 512), (2, 8, 8, 1024), (2, 9, 7, 128)])
def test_block_bf16_autograd_matches_the_cpu_composition(cuda, shape):
    """The bf16 block's backward on the card (the bf16 conv recomputed, the
    tail's f32 backward kernel, the bf16 input- and filter-gradient
    kernels) against the same composition on the CPU, where each wrapper
    runs its plain version: the bf16 gradients within one bf16 ulp of
    max(1, max |CPU|), the f32 ones within 1e-4 of the same; the launches
    of each kernel counted."""
    args = bf16_block_args(shape, cuda, seed=11)
    cot = torch.randn(*shape, generator=torch.Generator().manual_seed(12)).to(cuda, torch.bfloat16)
    counts = lambda: (fused_convnext_mlp_bwd.launches, fused_convnext_mlp_bwd.bf16_launches,  # noqa: E731
                      depthwise_conv7x7_nhwc.bf16_launches, depthwise_conv7x7_nhwc.bf16_grad_launches)
    ins = [a.detach().clone().requires_grad_() for a in args]
    before = counts()
    got = torch.autograd.grad(fused_convnext_block(*ins), ins, cot)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 0, 2, 1)
    cpu = [a.detach().cpu().clone().requires_grad_() for a in args]
    want = torch.autograd.grad(fused_convnext_block(*cpu), cpu, cot.cpu())
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype == args[i].dtype and torch.isfinite(a.float()).all(), i
        b, scale = b.float(), max(1.0, b.float().abs().max().item())
        tol = 2.0 ** (math.floor(math.log2(scale)) - 7) if a.dtype == torch.bfloat16 else 1e-4 * scale
        assert (a.float().cpu() - b).abs().max().item() <= tol, i


def test_block_bf16_plan_and_occupancy(cuda):
    """The bf16 instance's plan (2-byte boxes) on the card: no more clusters
    than its instance runs at once; the C side refuses a plan priced at the
    f32 box."""
    from tpu_captioner_torch.ops import _build
    from tpu_captioner_torch.ops.block_fused import _lib, _plan_on, block_plan

    lib = _lib()
    big = _plan_on(0, 32, 8, 8, 1024, 2)
    assert big.parts <= lib.tc_block_fused_clusters(1024, big.units, big.smem, 2)
    args = bf16_block_args((2, 8, 8, 512), cuda, seed=1)
    out, work = torch.empty_like(args[0]), args[1].new_empty(lib.tc_block_fused_workspace(128, 512, 2))
    wrong = block_plan(2, 8, 8, 512)  # the f32 plan
    assert wrong.smem != block_plan(2, 8, 8, 512, esize=2).smem
    err = lib.tc_block_fused_forward_bf16(*(t.data_ptr() for t in (*args, out, work)), 2, 8, 8, 512, *wrong.args(),
                                          _build.raw_stream(0))
    assert err == 1  # cudaErrorInvalidValue, before any launch


# The bf16 decoder instances.
def bf16_floor(got, want, ref, rel=2e-3):
    """got within the larger of rel x max(1, max |want|) and twice the noise
    floor |want - ref| (the plain version with f64 sums)."""
    floor = (want.double() - ref.double()).abs().max().item()
    tol = max(rel * max(1.0, want.abs().max().item()), 2 * floor)
    return (got.double() - want.double()).abs().max().item() <= tol


def lstm_bf16_args(*shape, device, seed=0):
    from tpu_captioner_torch.ops.lstm_step import cast_lstm_weight_matrices

    w, emb, h, c, enc, att1 = lstm_args(*shape, device=device, seed=seed)
    bf = torch.bfloat16
    return cast_lstm_weight_matrices(w, bf), emb.to(bf), h, c, enc.to(bf), att1.to(bf)


@pytest.mark.parametrize("rows", [1, 32, 37, 40, 160])
@pytest.mark.parametrize("widths", [(512, 512, 512, 1024, 49), (300, 512, 512, 1024, 49), (48, 56, 36, 40, 4),
                                    (7, 5, 3, 9, 3), (300, 33, 65, 130, 50)])
def test_lstm_step_bf16_kernel_matches_plain(cuda, rows, widths):
    """(E, D, A, C, P): the model's widths with E = 512 and 300, and the
    odd widths (D, E or C not a multiple of 8 load the weights without
    TMA)."""
    from tpu_captioner_torch.ops.lstm_step import _lstm_step_plain_bf16

    args = lstm_bf16_args(rows, *widths, device=cuda, seed=rows + widths[0])
    before = fused_lstm_step.launches, fused_lstm_step.bf16_launches
    got = fused_lstm_step(*args)
    torch.cuda.synchronize()
    assert (fused_lstm_step.launches, fused_lstm_step.bf16_launches) == (before[0] + 1, before[1] + 1)
    want, ref = _lstm_step_plain_bf16(*args), _lstm_step_plain_bf16(*args, sums=torch.float64)
    assert all(t.dtype == torch.float32 and torch.isfinite(t).all() for t in got)
    assert (got[2] - want[2]).abs().max().item() < 1e-5
    assert bf16_floor(got[0], want[0], ref[0]) and bf16_floor(got[1], want[1], ref[1])
    assert all(torch.equal(a, b) for a, b in zip(got, fused_lstm_step(*args)))


def test_lstm_step_bf16_kernel_beyond_one_launch(cuda):
    from tpu_captioner_torch.ops.lstm_step import _lstm_step_plain_bf16

    args = lstm_bf16_args(333, 512, 512, 512, 1024, 49, device=cuda, seed=5)
    before = fused_lstm_step.bf16_launches
    got = fused_lstm_step(*args)
    torch.cuda.synchronize()
    assert fused_lstm_step.bf16_launches == before + 3
    want, ref = _lstm_step_plain_bf16(*args), _lstm_step_plain_bf16(*args, sums=torch.float64)
    assert bf16_floor(got[0], want[0], ref[0]) and (got[2] - want[2]).abs().max().item() < 1e-5


def test_lstm_step_refuses_mixed_dtypes(cuda):
    """bf16 weights with an f32 enc, and f16 weights, have no instance."""
    from tpu_captioner_torch.ops.lstm_step import cast_lstm_weight_matrices

    w, emb, h, c, enc, att1 = lstm_bf16_args(8, 64, 64, 64, 128, 49, device=cuda)
    with pytest.raises(ValueError, match="enc must be torch.bfloat16"):
        fused_lstm_step(w, emb, h, c, enc.float(), att1)
    w32 = LstmStepWeights(*(t.float() for t in w))
    with pytest.raises(ValueError, match="no instance"):
        fused_lstm_step(cast_lstm_weight_matrices(w32, torch.float16), emb.half(), h, c, enc.half(), att1.half())


def decode_bf16(args):
    """``decode_args`` with the matrices, x, caches and memory K/V in bf16."""
    from tpu_captioner_torch.ops.decode_step import cast_weight_matrices

    w, x, pos, ck, cv, mk, mv, H = args
    bf = torch.bfloat16
    return (cast_weight_matrices(w, bf), x.to(bf), pos, ck.to(bf), cv.to(bf), mk.to(bf), mv.to(bf), H)


@pytest.mark.parametrize(
    "shape",
    [dict(L=3, R=10, T=8, P=4, E=64, H=4, Fd=48), dict(L=6, R=32, T=52, P=49, E=512, H=8, Fd=512),
     dict(L=6, R=40, T=52, P=49, E=200, H=8, Fd=512)],  # GloVe-200: head width 25, scalar key loads
)
@pytest.mark.parametrize("pos_at", ["first", "last"])
def test_onecell_bf16_kernel_equals_layer_launches(cuda, shape, pos_at):
    from tpu_captioner_torch.ops.decode_step import _decode_step_plain_bf16

    T = shape["T"]
    pos = {"first": 0, "last": T - 1}[pos_at]
    args = decode_bf16(decode_args(*shape.values(), pos=pos, device=cuda))
    before = fused_decode_step.onecell_launches, fused_decode_step.onecell_bf16_launches
    got = fused_decode_step(*args, one_cell=True)
    torch.cuda.synchronize()
    assert (fused_decode_step.onecell_launches, fused_decode_step.onecell_bf16_launches) == tuple(
        b + 1 for b in before)
    per_layer = fused_decode_step(*args)
    assert [t.dtype for t in got] == [t.dtype for t in per_layer]
    assert all(torch.equal(a, b) for a, b in zip(got, per_layer))
    want, ref = _decode_step_plain_bf16(*args), _decode_step_plain_bf16(*args, sums=torch.float64)
    assert bf16_floor(got[0], want[0], ref[0]) and bf16_floor(got[1], want[1], ref[1])


def assert_bf16_rollouts_agree(got, want, ref):
    """Per row: the tokens equal up to the first step where they differ,
    which must be a near-tie of the plain logits (within the logits'
    bound); logits and maps within their bound (``bf16_floor``'s, with the
    noise floor of the rows where all three agree) up to it."""
    (gl, gs, ga), (wl, ws, wa), (rl, rs, ra) = got, want, ref
    same = (ws == rs).all(1)
    floor_l = (wl[same] - rl[same]).abs().max().item() if same.any() else 0.0
    floor_a = (wa[same] - ra[same]).abs().max().item() if same.any() else 0.0
    tol_l = max(2e-3 * max(1.0, wl.abs().max().item()), 2 * floor_l)
    tol_a = max(2e-3, 2 * floor_a)
    for r in range(ws.shape[0]):
        diff = (gs[r] != ws[r]).nonzero()
        upto = ws.shape[1] if len(diff) == 0 else int(diff[0]) + 1
        if len(diff):
            s, a, b = upto - 1, int(gs[r, upto - 1]), int(ws[r, upto - 1])
            assert abs(wl[r, s, a] - wl[r, s, b]).item() < tol_l, (r, s)
        assert (gl[r, :upto] - wl[r, :upto]).abs().max().item() <= tol_l, r
        assert (ga[r, :upto] - wa[r, :upto]).abs().max().item() <= tol_a, r


@pytest.mark.parametrize("rows", [4, 32])
@pytest.mark.parametrize("steps", [1, 12, 51])
@pytest.mark.parametrize("teacher", [False, True])
def test_rollout_bf16_kernel_matches_plain(cuda, rows, steps, teacher):
    from tpu_captioner_torch.ops.decode_step import _full_rollout_plain_bf16, cast_weight_matrices

    (w, emb, fc_w, fc_b, pe, mk, mv), mix = rollout_args(rows, steps, cuda, teacher, seed=rows + steps)
    bf = torch.bfloat16
    args = (cast_weight_matrices(w, bf), emb.to(bf), fc_w.to(bf), fc_b, pe, mk.to(bf), mv.to(bf))
    V, start = emb.shape[0], emb.shape[0] - 2
    before = fused_full_rollout.launches, fused_full_rollout.bf16_launches
    got = fused_full_rollout(*args, start, -1, steps, 8, **mix)
    torch.cuda.synchronize()
    assert (fused_full_rollout.launches, fused_full_rollout.bf16_launches) == tuple(b + 1 for b in before)
    assert got[1].dtype == torch.int32 and all(x.dtype == torch.float32 and torch.isfinite(x).all()
                                               for x in (got[0], got[2]))
    want = _full_rollout_plain_bf16(*args, start, -1, steps, 8, **mix)
    ref = _full_rollout_plain_bf16(*args, start, -1, steps, 8, **mix, sums=torch.float64)
    assert_bf16_rollouts_agree(got, want, ref)
    assert int(fused_full_rollout.steps_run) == steps


def test_rollout_bf16_refuses_mixed_dtypes(cuda):
    from tpu_captioner_torch.ops.decode_step import cast_weight_matrices

    (w, emb, fc_w, fc_b, pe, mk, mv), _ = rollout_args(4, 3, cuda, False)
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="embedding must be torch.bfloat16"):
        fused_full_rollout(cast_weight_matrices(w, bf), emb, fc_w.to(bf), fc_b, pe, mk.to(bf), mv.to(bf),
                           1, 2, 3, 8)


# The bf16 arm's mma.sync body (rows 4-6, bf16 instances): the per-layer,
# one-cell and rollout instances at R = 5, 32, 40 and 160 rows, at E = 512
# (H 8) and E = 200 (dh 25: the scalar-load instance, and K % 16 == 8, the
# mma tile's half step), positions 0, 1, 25 and 51, under the rules above:
# one layer's launch x and alpha within 2e-3 of max(1, max |plain|) and
# k/v within one ulp; the six-layer step within that or twice the noise
# floor; the one-cell instance equal to six per-layer launches bit for bit;
# two calls bit for bit.
BF16_TILE_ROWS = [5, 32, 40, 160]
BF16_TILE_WIDTHS = [(512, 8), (200, 8)]


@pytest.mark.parametrize("rows", BF16_TILE_ROWS)
@pytest.mark.parametrize("E,H", BF16_TILE_WIDTHS)
@pytest.mark.parametrize("pos", [0, 1, 25, 51])
def test_decode_bf16_tile_instances_match_plain(cuda, rows, E, H, pos):
    from tpu_captioner_torch.ops.decode_step import _decode_step_plain_bf16

    args = decode_bf16(decode_args(6, rows, 52, 49, E, H, 512, pos, cuda, seed=3 * rows + E + pos))
    w, x, _, ck, cv, mk, mv, _ = args
    for l in range(6):
        one = (type(w)(*(t[l : l + 1].contiguous() for t in w)), x, pos,
               *(t[l : l + 1].contiguous() for t in (ck, cv, mk, mv)), H)
        got, want = fused_decode_step(*one), _decode_step_plain_bf16(*one)
        for a, b in zip(got[:2], want[:2]):
            assert torch.isfinite(a).all() and within(a, b, 2e-3), l
        for a, b in zip(got[2:], want[2:]):
            assert within_bf16_ulp(a, b), l
    before = (fused_decode_step.bf16_launches, fused_decode_step.onecell_bf16_launches)
    per_layer = fused_decode_step(*args)
    one_cell = fused_decode_step(*args, one_cell=True)
    torch.cuda.synchronize()
    assert (fused_decode_step.bf16_launches, fused_decode_step.onecell_bf16_launches) == (before[0] + 6,
                                                                                         before[1] + 1)
    want, ref = _decode_step_plain_bf16(*args), _decode_step_plain_bf16(*args, sums=torch.float64)
    assert bf16_floor(per_layer[0], want[0], ref[0]) and bf16_floor(per_layer[1], want[1], ref[1])
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(per_layer, one_cell))
    assert all(torch.equal(a, b) for a, b in zip(per_layer, fused_decode_step(*args)))
    assert all(torch.equal(a, b) for a, b in zip(one_cell, fused_decode_step(*args, one_cell=True)))


@pytest.mark.parametrize("rows", BF16_TILE_ROWS)
@pytest.mark.parametrize("E,H", BF16_TILE_WIDTHS)
def test_rollout_bf16_tile_instance_matches_plain(cuda, rows, E, H):
    """51 tokens that no row ends, against the plain bf16 rollout and its
    noise floor (``assert_bf16_rollouts_agree``); the same bits again."""
    from tpu_captioner_torch.ops.decode_step import _full_rollout_plain_bf16, cast_weight_matrices

    steps = 51
    (w, emb, fc_w, fc_b, pe, mk, mv), _ = rollout_args(rows, steps, cuda, False, E=E, H=H, seed=rows + E + 1)
    bf = torch.bfloat16
    args = (cast_weight_matrices(w, bf), emb.to(bf), fc_w.to(bf), fc_b, pe, mk.to(bf), mv.to(bf))
    start = emb.shape[0] - 2
    got = fused_full_rollout(*args, start, -1, steps, H)
    torch.cuda.synchronize()
    assert all(x.dtype == torch.float32 and torch.isfinite(x).all() for x in (got[0], got[2]))
    want = _full_rollout_plain_bf16(*args, start, -1, steps, H)
    ref = _full_rollout_plain_bf16(*args, start, -1, steps, H, sums=torch.float64)
    assert_bf16_rollouts_agree(got, want, ref)
    assert int(fused_full_rollout.steps_run) == steps
    assert all(torch.equal(a, b) for a, b in zip(got, fused_full_rollout(*args, start, -1, steps, H)))


def test_decode_layout_is_the_packages(cuda):
    """The C side's shared-memory layout (``tc_decode_smem_layout``: total,
    the bf16 copy's offset and row length, plan_ok) is
    ``ops/decode_step.py:decode_layout``'s for both arms' plans."""
    import ctypes

    from tpu_captioner_torch.ops.decode_step import _lib, decode_layout, decode_plan

    lib = _lib()
    out = (ctypes.c_longlong * 4)()
    for kind in ("layer", "onecell", "rollout"):
        for R, E, H, F in ((1, 512, 8, 512), (5, 512, 8, 512), (40, 512, 8, 512), (160, 512, 8, 512),
                           (40, 200, 8, 512), (160, 304, 8, 512), (32, 1024, 16, 1024)):
            V, T = (9490, 51) if kind == "rollout" else (0, 52)
            for esize in (4, 2):
                plan = decode_plan(kind, R, T, 49, E, H, F, 132, V, esize=esize)
                lay = decode_layout(plan, R, T, 49, E, H, F, V, esize)
                assert lib.tc_decode_smem_layout((ctypes.c_int * 11)(*plan[:11]), R, T, 49, E, H, F, V,
                                                 ("layer", "onecell", "rollout").index(kind), esize, out) == 0
                assert list(out) == [lay["total"], lay["xb_offset"], lay["xb_row"], 1], (kind, R, E, esize)


def test_decode_bf16_instances_run_bf16_mma(cuda):
    """The bf16 body's products are bf16 HMMA (mma.sync m16n8k16 with f32
    accumulators) in the bf16 instances of the per-layer, one-cell and
    rollout kernels (in the out-of-line tile they call, where the SASS
    lists it apart); the f32 instances and every other function hold no
    HMMA."""
    import re

    sass = cuda_sass("decode_step")
    hmma = {k for k, v in sass.items() if re.search(r"\bHMMA\.16816\.F32\.BF16\b", v)}
    assert hmma, sorted(sass)
    kernels = {k: v for k, v in sass.items() if re.search(r"decode_(layer|onecell|rollout)_kernel", k)}
    assert len(kernels) == 12, sorted(kernels)  # three kernels x (f32, bf16) x (VEC 4, 1)
    for name, code in kernels.items():
        bf16 = "Lb1E" in name
        if name in hmma:
            assert bf16, name
        elif bf16:  # the tile out of line: the instance calls it
            assert re.search(r"\bCALL\b", code) and all("tile_mma" in k for k in hmma), (name, sorted(hmma))
    assert all(("Lb1E" in k) or ("tile_mma" in k) for k in hmma), sorted(hmma)
    assert not any(re.search(r"\bHMMA\b", v) for k, v in sass.items() if k not in hmma)
