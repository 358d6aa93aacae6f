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
1024, the widest the kernels take.
"""

import pytest

from tpu_captioner_torch.ops.decode_step import SMEM_LIMIT, decode_plan

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
