"""The LSTM step kernel's plan and arithmetic, on the CPU.

``lstm_plan`` at the main paths' row counts and at the tests' odd widths:
every output column (att2, f_beta, the four gates of every hidden unit) and
every K stage of every tile belongs to exactly one block, so each weight is
read once a launch; the rows fit one launch; the ring fits a block's shared
memory, and widths that do not fit raise ``ValueError``.  Then
``ops/tf32.py:lstm_step_forward``, the launch's arithmetic (3xTF32 products
in the B planes' slot order, the split-K partials summed in split order,
the gate tiles' permuted rows, the cell), against JAX's ``fused_lstm_step``
in interpret mode within 1e-5, with ``tests/test_torch_lstm_step.py``'s
widths, weights and inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_helpers import t
from tests.test_torch_lstm_step import DECODER, TOL, decoders, step_inputs  # noqa: F401 (a fixture)
from tpu_captioner.ops.lstm_step import fused_lstm_step as jax_fused_lstm_step
from tpu_captioner.ops.lstm_step import prepare_lstm_weights as jax_prepare_lstm_weights
from tpu_captioner_torch.ops.lstm_step import (
    GATE_UNITS,
    MAX_ROWS,
    SMEM_LIMIT,
    STAGE,
    TILE,
    lstm_plan,
    lstm_units,
    prepare_lstm_weights,
    workspace_floats,
)
from tpu_captioner_torch.ops.tf32 import lstm_k_slots, lstm_step_forward

SMS = 132  # the H100 SXM
MODEL = (512, 512, 512, 1024, 49)  # E, D, A, C, P
ODD = [(48, 56, 36, 40, 4), (7, 5, 3, 9, 3), (300, 33, 65, 130, 50), (300, 512, 512, 1024, 49),
       (200, 512, 512, 1024, 49)]


def cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("R", [1, 5, 32, 37, 40, 160])
@pytest.mark.parametrize("widths", [MODEL, *ODD])
def test_plan_covers_every_column_and_stage_once(R, widths):
    E, D, A, C, P = widths
    assert_plan_covers(lstm_plan(R, E, D, A, C, P, SMS), R, E, D, A, C, P)


def assert_plan_covers(plan, R, E, D, A, C, P):
    """Rows in one launch, the ring within shared memory, and every (tile,
    K stage) pair and output column owned by exactly one block."""
    assert plan.rows >= R and plan.rows % 16 == 0 and plan.rows <= MAX_ROWS  # one launch: every row in the tile
    assert plan.grid == SMS and 2 <= plan.stages and plan.smem <= SMEM_LIMIT
    kd, ke, kc = cdiv(D, STAGE), cdiv(E, STAGE), cdiv(C, STAGE)
    n_att, n_fb, n_g = cdiv(A, TILE), cdiv(C, TILE), cdiv(D, GATE_UNITS)
    af, gate_h, gate_c = {}, {}, {}  # (tile, K stage) -> blocks
    for b, u in enumerate(lstm_units(plan, E, D, A, C)):
        for k in u.af_k:
            af.setdefault((u.af, k), []).append(b)
        for k in u.gate_hk:
            gate_h.setdefault((u.gate, k), []).append(b)
        for k in u.gate_ck:
            gate_c.setdefault((u.gate, k), []).append(b)
        assert len(u.gate_ck) <= plan.wc_stages  # the block's w_ih_c share fits its panels
    # Every (tile, stage) pair exactly once: no weight byte read twice.
    assert sorted(af) == [(tile, k) for tile in range(n_att + n_fb) for k in range(kd)]
    assert sorted(gate_h) == [(tile, k) for tile in range(n_g) for k in range(kd + ke)]
    assert sorted(gate_c) == [(tile, k) for tile in range(n_g) for k in range(kc)]
    assert all(len(v) == 1 for d in (af, gate_h, gate_c) for v in d.values())
    # The tiles' rows cover each output column once: att2's A, f_beta's C, 4D gates.
    att_cols = [c for tile in range(n_att) for c in range(tile * TILE, tile * TILE + TILE) if c < A]
    fb_cols = [c for tile in range(n_fb) for c in range(tile * TILE, tile * TILE + TILE) if c < C]
    gate_rows = sorted(g * D + tile * GATE_UNITS + i for tile in range(n_g) for g in range(4)
                       for i in range(GATE_UNITS) if tile * GATE_UNITS + i < D)
    assert att_cols == list(range(A)) and fb_cols == list(range(C)) and gate_rows == list(range(4 * D))
    # The K stages cover each weight's columns: 32 * stages >= K > 32 * (stages - 1).
    for K, k in ((D, kd), (E, ke), (C, kc)):
        assert STAGE * (k - 1) < K <= STAGE * k
    assert workspace_floats(plan, R, E, D, A, C, P) > 0


def test_plan_at_the_main_paths_splits_every_tile():
    """The model's widths: 24 [wd | wfb] tiles in 4 K splits and 32 gate
    tiles in 4, 128 of the 132 blocks on the gates, a 64 KB w_ih_c share."""
    for R, rows, stages in ((40, 48, 4), (32, 32, 4), (160, 160, 3)):
        plan = lstm_plan(R, *MODEL, SMS)
        assert (plan.rows, plan.af_split, plan.gate_split, plan.wc_stages, plan.stages) == (rows, 4, 4, 8, stages)
        units = lstm_units(plan, 512, 512, 512, 1024)
        assert sum(u.gate is not None for u in units) == 128 and sum(u.af is not None for u in units) == 96


@pytest.mark.parametrize("bad", [
    dict(R=0), dict(R=MAX_ROWS + 1),  # rows of one launch
    dict(C=8192, D=1000),  # the w_ih_c share and the ring outgrow shared memory
    dict(D=16 * SMS + 1),  # more gate tiles than blocks
    dict(A=0),
])
def test_plan_refuses_what_does_not_fit(bad):
    args = dict(R=2, E=8, D=16, A=8, C=16, P=4)
    args.update(bad)
    with pytest.raises(ValueError):
        lstm_plan(args["R"], args["E"], args["D"], args["A"], args["C"], args["P"], SMS)


def test_k_slots_are_a_permutation_within_groups_of_16():
    order = lstm_k_slots(40)
    assert order.shape == (48,)
    for g in range(3):
        assert sorted(order[16 * g:16 * g + 16].tolist()) == list(range(16 * g, 16 * g + 16))
    # A thread's float4 of columns 4q..4q+3 feeds k-steps 2G (slots q, q+4) and 2G+1 (slots 8+q, 12+q).
    for q in range(4):
        assert [order[q].item(), order[q + 4].item(), order[8 + q].item(), order[12 + q].item()] == [
            4 * q, 4 * q + 1, 4 * q + 2, 4 * q + 3]


@pytest.mark.parametrize("rows", [5, 37, 70])  # 70: the instance of 96 rows, three chunks of 32
@pytest.mark.parametrize("sms", [SMS, 8])  # 8: fewer blocks, fewer splits
def test_launch_arithmetic_matches_jax_kernel(decoders, rows, sms):  # noqa: F811
    """The launch's arithmetic on the CPU against JAX ``fused_lstm_step``
    in interpret mode with f32 products, within 1e-5."""
    _, params, dec = decoders
    args = step_inputs(params, rows, seed=rows + 100)
    jw = jax_prepare_lstm_weights(jax.tree_util.tree_map(jnp.asarray, params), DECODER["embed_dim"])
    want = jax_fused_lstm_step(jw, *map(jnp.asarray, args), interpret=True, precise=True)
    E, D, A, C = (DECODER[k] for k in ("embed_dim", "decoder_dim", "attention_dim", "encoder_dim"))
    plan = lstm_plan(rows, E, D, A, C, args[3].shape[1], sms)
    with torch.no_grad():
        got = lstm_step_forward(prepare_lstm_weights(dec), *map(t, args), plan)
    for name, g, b in zip(("h", "c", "alpha"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(b), atol=TOL, rtol=0, err_msg=name)
