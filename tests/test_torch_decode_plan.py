"""The decode kernels' launch plan (``ops/decode_step.py:decode_plan``), on the CPU.

The plan says which output columns of every product each block owns, how
many rows it stages at once and how many weight slices its ring holds, and
sizes the block's shared memory; ``csrc/decode_step.cu`` checks the same
sum and refuses a launch whose plan disagrees.  Here, for the reference's
widths (E/H = 512/8, 300/6 and 200/8, F = 512; the flagship's vocabulary
9490) and every row count up to the bs-32 beam's 160: the plan fits the
232,448 bytes a block may use, every output column of every product (and of
the vocab head) is owned by exactly one block of each row group, every row
by exactly one row group and one owner, and each block's slice of a product
fits one ring slot.  Also on cards with other SM counts, and at E = F =
1024, the widest the kernels take.  The bf16 instances' plans
(``esize=2``) likewise, with their staged rows' bf16 copy: rows of
round_up(max(E, F), 16) + 8 values (E = 200 pads 8 values to the mma's
k16 steps), 16-byte aligned after the rest of the block's shared memory,
ring units of whole 8-column tiles or a block's whole slice, and weight
rows ``ring_row(K)`` apart in a slot (E % 8 == 0: 512, 304, 200, 1024).  And the
sources: the bf16 body's products run the ``mma.sync`` tile, with no
per-value rounding in the product loop and no fallback.
"""

import inspect

import pytest

from tpu_captioner_torch.ops import _build
from tpu_captioner_torch.ops import decode_step as ds
from tpu_captioner_torch.ops.decode_step import SMEM_LIMIT, bf16_row_len, decode_layout, decode_plan, ring_row

WIDTHS = [(512, 8), (300, 6), (200, 8)]
H100_SMS, P, T, V, FFN = 132, 49, 52, 9490, 512


def check_plan(plan, kind, R, E, F, sms):
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.grid <= sms and plan.grid % plan.row_groups == 0
    gc = plan.grid // plan.row_groups
    assert plan.rc % 16 == 0 and plan.rc >= 16 and plan.slots >= 1
    assert plan.slot_floats % 32 == 0 and 1 <= plan.group <= min(16, plan.slots)
    # Each block's slice of a product, in ring units of uc columns: every
    # column of every product has exactly one owner in each row group, and
    # a unit's weight rows fit a slot.
    assert plan.uc * max(E, F) <= plan.slot_floats
    for n, per in ((E, plan.ce), (F, plan.cf)):
        units = [range(c, min(n, b * per + per, c + plan.uc)) for b in range(gc)
                 for c in range(b * per, min(n, b * per + per), plan.uc)]
        assert sorted(c for u in units for c in u) == list(range(n)), (n, per, plan.uc)
    # Rows: row group g stages [g * rpg, (g + 1) * rpg), in chunks of rc.
    rpg = -(-R // plan.row_groups)
    groups = [range(min(R, g * rpg), min(R, (g + 1) * rpg)) for g in range(plan.row_groups)]
    assert sorted(r for g in groups for r in g) == list(range(R))
    if kind == "rollout":
        assert plan.row_groups == 1
        units = [range(c, min(V, b * plan.cv + plan.cv, c + plan.hc)) for b in range(plan.grid)
                 for c in range(b * plan.cv, min(V, b * plan.cv + plan.cv), plan.hc)]
        assert sorted(c for u in units for c in u) == list(range(V))
        assert 1 <= plan.hc and plan.hc * E <= plan.slot_floats
    else:
        assert plan.cv == plan.hc == 0


@pytest.mark.parametrize("kind", ["layer", "onecell", "rollout"])
@pytest.mark.parametrize("E,H", WIDTHS)
def test_plan_fits_and_covers_every_column_once(kind, E, H):
    for R in range(1, 161):
        steps = T - 1 if kind == "rollout" else T
        plan = decode_plan(kind, R, steps, P, E, H, FFN, H100_SMS, V if kind == "rollout" else 0)
        check_plan(plan, kind, R, E, FFN, H100_SMS)
        # At least 8 weight slices in flight, each whole warp tiles of 4
        # columns (or a block's whole slice).
        assert plan.slots >= 8 and (plan.uc % 4 == 0 or plan.uc == max(plan.ce, plan.cf)), R
        if kind == "layer":  # two row groups from 32 rows on, each staging half
            assert plan.row_groups == (2 if R >= 32 else 1), R


@pytest.mark.parametrize("sms", [114, 78, 7, 1])
@pytest.mark.parametrize("kind", ["layer", "onecell", "rollout"])
def test_plan_on_other_cards_and_the_widest_shapes(sms, kind):
    for R, E, H, F in ((1, 512, 8, 512), (40, 512, 8, 512), (160, 300, 6, 512), (40, 1024, 8, 1024),
                       (160, 1024, 16, 1024)):
        plan = decode_plan(kind, R, T, P, E, H, F, sms, V if kind == "rollout" else 0)
        check_plan(plan, kind, R, E, F, sms)


def test_plan_refuses_what_does_not_fit():
    # 16 staged rows of 4000 floats alone take 256,000 bytes.
    with pytest.raises(ValueError, match="shared memory"):
        decode_plan("layer", 40, T, P, 512, 8, 4000, H100_SMS)


def check_layout(plan, kind, R, T, E, H, F, esize):
    """``decode_layout`` sums to the plan's shared memory, its regions follow
    one another, and (bf16) the staged copy holds rc rows of whole k16 steps
    plus the 8-value pad, 16-byte aligned (ldmatrix's rows), each row on
    other banks than the next (an odd number of 16-byte granules)."""
    V = V_HEAD if kind == "rollout" else 0
    lay = decode_layout(plan, R, T, P, E, H, F, V, esize)
    assert lay["total"] == plan.smem_bytes <= SMEM_LIMIT
    at = 0
    for name in ("mbarriers", "ring", "rows", "ln", "attention", "state"):
        assert lay[name][0] == at
        at += lay[name][1]
    if esize == 4:
        assert "bf16_rows" not in lay and lay["xb_offset"] == lay["xb_row"] == 0 and at == lay["total"]
        return
    row = lay["xb_row"]
    assert row == bf16_row_len(E, F) and row % 16 == 8 and row >= max(E, F) + 8 and (2 * row // 16) % 2 == 1
    assert lay["xb_offset"] % 16 == 0 and 0 <= lay["xb_offset"] - at < 16
    assert lay["bf16_rows"] == (lay["xb_offset"], 2 * plan.rc * row)
    assert lay["xb_offset"] + 2 * plan.rc * row == lay["total"]


V_HEAD = V


def check_bf16_rows(plan, kind, E, F):
    """The per-layer kernel's padded units (8 rows or more), their rows
    ``ring_row(K)`` apart, fit a slot; each stride is an odd number of
    16-byte granules (the 8 rows of an ldmatrix on different banks) and
    leaves room for the mma's last half step past K.  Other units lie as
    stored (``check_plan``)."""
    for K in {E, F}:
        assert ring_row(K) % 8 == 0 and (ring_row(K) // 8) % 2 == 1 and ring_row(K) >= K + 8, K
    if kind == "layer" and plan.uc >= 8:
        assert plan.uc * ring_row(max(E, F)) <= plan.slot_floats
BF16_WIDTHS = [(512, 8), (304, 8), (200, 8), (1024, 16)]  # bf16 rows: E % 8 == 0


@pytest.mark.parametrize("kind", ["layer", "onecell", "rollout"])
@pytest.mark.parametrize("E,H", BF16_WIDTHS)
def test_bf16_plan_fits_and_covers_every_column_once(kind, E, H):
    """The bf16 instances' plans at every row count up to 160: coverage,
    fit and layout, ring units of whole 8-column tiles (the mma tile's n)
    or the block's whole slice, and at the reference's widths at least 8
    units in flight; E = 200 (K % 16 == 8) included, and E = F = 1024."""
    F = max(FFN, E)
    for R in range(1, 161):
        steps = T - 1 if kind == "rollout" else T
        plan = decode_plan(kind, R, steps, P, E, H, F, H100_SMS, V if kind == "rollout" else 0, esize=2)
        check_plan(plan, kind, R, E, F, H100_SMS)
        check_layout(plan, kind, R, steps, E, H, F, 2)
        assert plan.uc % 8 == 0 or plan.uc == max(plan.ce, plan.cf), R
        check_bf16_rows(plan, kind, E, F)
        assert plan.slots >= (8 if E <= 512 else 1), R
        if kind == "layer" and E <= 512:  # two row groups from 32 rows on, as in f32
            assert plan.row_groups == (2 if R >= 32 else 1), R


@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("kind", ["layer", "onecell", "rollout"])
def test_layout_is_the_plans_shared_memory(esize, kind):
    """The f32 plans lay out as before (no bf16 copy); every plan's layout
    sums to its shared memory."""
    for R, E, H, F in ((1, 512, 8, 512), (40, 512, 8, 512), (160, 512, 8, 512), (32, 200, 8, 512),
                       (40, 304 if esize == 2 else 300, 8 if esize == 2 else 6, 512), (160, 1024, 16, 1024),
                       (5, 200, 8, 200)):
        steps = T - 1 if kind == "rollout" else T
        plan = decode_plan(kind, R, steps, P, E, H, F, H100_SMS, V if kind == "rollout" else 0, esize=esize)
        check_layout(plan, kind, R, steps, E, H, F, esize)


@pytest.mark.parametrize("sms", [114, 78, 7, 1])
@pytest.mark.parametrize("kind", ["layer", "onecell", "rollout"])
def test_bf16_plan_on_other_cards_and_the_widest_shapes(sms, kind):
    for R, E, H, F in ((1, 512, 8, 512), (40, 512, 8, 512), (160, 304, 8, 512), (40, 200, 8, 512),
                       (40, 1024, 8, 1024), (160, 1024, 16, 1024)):
        plan = decode_plan(kind, R, T, P, E, H, F, sms, V if kind == "rollout" else 0, esize=2)
        check_plan(plan, kind, R, E, F, sms)
        check_layout(plan, kind, R, T, E, H, F, 2)
        assert plan.uc % 8 == 0 or plan.uc == max(plan.ce, plan.cf)
        check_bf16_rows(plan, kind, E, F)


def test_bf16_plan_refuses_what_does_not_fit():
    # 16 staged rows of 4000 floats and their bf16 copy alone take 384,256 bytes.
    with pytest.raises(ValueError, match="shared memory"):
        decode_plan("layer", 40, T, P, 512, 8, 4000, H100_SMS, esize=2)
    with pytest.raises(ValueError, match="4 or 2 bytes"):
        decode_plan("layer", 40, T, P, 512, 8, 512, H100_SMS, esize=1)


def _body(src, start, end):
    return src[src.index(start):src.index(end, src.index(start))]


def test_bf16_sources_run_the_mma_tile_and_have_no_fallback():
    """The bf16 body's products go through ``tile_mma`` (ldmatrix and
    mma.sync m16n8k16 bf16 with f32 accumulators), the f32 tile no longer
    rounds, no ``round_bf16`` is left in the product loop or the tiles, the
    stagings write the bf16 copy once, the scores round in pairs, and the
    wrappers catch no build or launch failure."""
    cu = (_build.CSRC / "decode_step.cu").read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in cu
    tile = (_body(cu, "__device__ __noinline__ float4 tile_mma(", "\n}\n")
            + _body(cu, "__device__ __forceinline__ void load64(", "\n}\n"))
    assert tile.count("mma_bf16(") == 3 and tile.count("ldsm_x4(") == 4 and "round_bf16" not in tile
    assert "a[2] = a[3] = 0u;" in tile and "mma_bf16(acc[s], a, b[0], 0u);" in tile  # K % 16 == 8 masked
    dot = _body(cu, "__device__ __noinline__ float2 tile_dot(", "\n}\n")
    assert "round_bf16" not in dot and "template" not in dot
    prod = _body(cu, "__device__ void product(", "\n}\n")
    assert "tile_mma(ws, ldw, xb_of(a, k)" in prod and "tile_dot(ws, k.xs" in prod and "round_bf16" not in prod
    assert "const int ldw = PAD ? unit_row(a, K) : K;" in prod  # the per-layer bf16 ring's padded rows
    assert "constexpr int CG = kBf ? kCGb : kCG;" in prod
    for fn in ("stage_copy_bf16", "stage_ln_bf16", "stage_embed_bf16", "stage_rows_bf16"):
        body = _body(cu, f"__device__ __noinline__ void {fn}(", "\n}\n")
        assert "store4(xb" in body or "ln_rows<2>(rows, copies" in body or "bulk_load(xb" in body, fn
    layer = _body(cu, "__device__ void decode_layer(", "\n}\n")
    for stage in ("stage_copy(k,", "stage_ln(a, k,", "stage_embed<"):
        assert stage not in layer, stage
    assert layer.count("stage_rows<BF>(") == 1 and layer.count("stage_acts<BF>(") == 3
    assert layer.count("stage_norm<BF>(") == 3
    score = _body(cu, "__device__ __forceinline__ float score_bf16(", "\n}\n")
    assert score.count("round_bf16x2(") == 5 and score.count("round_bf16(") == 1
    assert "return (s0 + s1) + (s2 + s3);" in score
    for fn in (ds.fused_decode_step, ds.fused_full_rollout, ds._lib, ds.decode_plan, ds._fit_plan):
        src = inspect.getsource(fn)
        assert "except" not in src, fn.__qualname__
