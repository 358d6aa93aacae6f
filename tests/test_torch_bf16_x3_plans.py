"""The plans of the bf16 instances that run three-piece products (an f32 row
value in three exact bf16 pieces times the bf16 weight as it lies): the
sub-tiled MLP tail's ``fused_x3_plan`` and the whole block's
``block_workspace``, each the package's mirror of what ``csrc/mlp_block.cu``
and ``csrc/block_fused.cu`` compute (``tests/test_torch_kernels_gpu.py:
test_bf16_x3_plans_are_the_packages`` holds them to the library on the
card).  Here each mirror is held to the rules its kernel relies on: the
shared memory of a Hopper block, a ring slot that holds a stage of either
product, the swizzle's alignment, the cluster's cover of C, and a workspace
that holds the arrays the launches write."""

import pytest

from tpu_captioner_torch.ops.block_fused import block_workspace
from tpu_captioner_torch.ops.mlp_block import FUSED_TILES, SMEM_LIMIT, SUB_ROWS, SUPPORTED_C, fused_x3_plan

X3_TILES = sorted(FUSED_TILES)
STAGES = [(b * (64 >> s) ** 2, c) for s, c in enumerate(SUPPORTED_C) for b in (1, 8, 32)]


@pytest.mark.parametrize("c,nc", X3_TILES)
def test_fused_x3_plan_fits_a_block(c, nc):
    """The ring, the h pieces, the statistics and the mbarriers fit the
    block's shared memory with the alignment slack, and the ring is as deep
    as fits: one slot more would not."""
    p = fused_x3_plan(c, nc)
    assert p["smem"] <= SMEM_LIMIT
    assert p["slots"] >= 2
    more = p["smem"] + p["slot_bytes"] + 2 * 8
    assert more > SMEM_LIMIT


@pytest.mark.parametrize("c,nc", X3_TILES)
def test_fused_x3_slot_holds_a_stage(c, nc):
    """A first-product stage (W1's jcb x 32 bf16 box at the slot's start,
    the two sub-tiles' 64 x 32 bf16 x slabs from 4 KB on) and a
    second-product stage (W2's 128 x 64 bf16 box) each fit a slot; slots,
    slabs and the h piece planes start on the 1024-byte boundaries where
    the 128-byte swizzle starts over."""
    p = fused_x3_plan(c, nc)
    w1_box, x_slab, x_at = 2 * 32 * p["jcb"], 2 * SUB_ROWS * 32, 4096
    assert w1_box <= x_at and x_at + 2 * x_slab <= p["slot_bytes"]
    assert 2 * 128 * 64 <= p["slot_bytes"]
    piece = 2 * SUB_ROWS * p["jc"]  # one bf16 piece plane of one sub-tile
    assert p["h_bytes"] == 2 * 3 * piece
    assert p["slot_bytes"] % 1024 == 0 and x_at % 1024 == 0 and piece % 1024 == 0


@pytest.mark.parametrize("c,nc", X3_TILES)
def test_fused_x3_plan_keeps_the_cluster_layout(c, nc):
    """The cluster and the hidden chunks are the other instances': the
    cluster's blocks cover C's output columns once, its chunk of hidden
    units is the blocks' shares, a whole number of 64-deep second-product
    stages, and the chunks cover 4C."""
    p = fused_x3_plan(c, nc)
    assert (p["cluster"], p["jcb"]) == FUSED_TILES[c, nc]
    assert p["cluster"] * nc == c and p["cluster"] * p["jcb"] == p["jc"]
    assert p["jc"] % 64 == 0 and 4 * c % p["jc"] == 0 and p["sub_rows"] == SUB_ROWS


def test_fused_x3_plan_refuses_other_tiles():
    for c, nc in ((192, 128), (128, 256), (2048, 256)):
        with pytest.raises(ValueError, match="no sub-tiled instance"):
            fused_x3_plan(c, nc)


@pytest.mark.parametrize("n,c", STAGES + [(7, 128), (1003, 512)])
def test_block_workspace_holds_the_bf16_launches_arrays(n, c):
    """The bf16 block's workspace holds LN(t) as one f32 plane (N, C) and h
    as one (N, 4C), each from a 32-float boundary (TMA's 16-byte rule), and
    nothing for the weights: it grows with the pixels alone, and is under
    half of the f32 instance's TF32 planes and weight splits."""
    got = block_workspace(n, c, 2)
    plane = -(-n * c // 32) * 32
    assert got == plane + -(-4 * n * c // 32) * 32 and plane % 32 == 0
    assert got - block_workspace(0, c, 2) == got  # no weight term
    assert 2 * got <= block_workspace(n, c, 4)


@pytest.mark.parametrize("n,c", STAGES)
def test_block_workspace_f32_is_the_tf32_plan(n, c):
    """The f32 instance keeps its plan: LN(t)'s two TF32 planes, h's two
    planes of 4C, and the two weights' splits (2 x 4C^2 floats each)."""
    assert block_workspace(n, c, 4) == 2 * n * c + 8 * n * c + 16 * c * c


def test_block_workspace_refuses_other_sizes():
    with pytest.raises(ValueError, match="4 or 2 bytes"):
        block_workspace(128, 512, 3)
