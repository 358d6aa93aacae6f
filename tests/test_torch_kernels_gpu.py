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
    SUPPORTED_C,
    _mlp_bwd_plain,
    _mlp_plain,
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
    out, work = torch.empty_like(args[0]), args[0].new_empty(lib.tc_block_fused_workspace(128, 512))
    bad = plan._replace(smem=plan.smem + 128)
    err = lib.tc_block_fused_forward(*(t.data_ptr() for t in (*args, out, work)), 2, 8, 8, 512, *bad.args(),
                                     _build.raw_stream(0))
    assert err == 1  # cudaErrorInvalidValue, before any launch
    big = _plan_on(0, 32, 8, 8, 1024)
    assert big.parts <= lib.tc_block_fused_clusters(1024, big.units, big.smem)


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
