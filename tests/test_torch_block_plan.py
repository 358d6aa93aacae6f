"""The whole-block kernel's conv + LayerNorm plan and its arithmetic, on the
CPU.

- ``ops/block_fused.py:block_plan`` (re-checked by ``csrc/block_fused.cu``):
  at the four ConvNeXt-Base stage shapes at batch 8 and 32, at the smoke's
  ragged (3, 14, 14, 512) and at sides that are no multiple of the tile,
  walking the tiles as the kernel's clusters do covers every pixel once and
  every channel once, and the ring fits a block's shared memory; widths the
  kernels are not built for and plans that do not fit raise ``ValueError``.
- ``ops/tf32.py:block_forward``, the launches' arithmetic (the conv, the
  LayerNorm from per-chunk moments merged as the cluster merges them, LN(t)
  in TF32 hi/lo planes, the two 3xTF32 products and their epilogues),
  against the JAX ``fused_convnext_block`` in Pallas interpret mode, within
  1e-5 times max(1, the largest JAX value): f32 sums in other orders and a
  dropped lo x lo term (2^-22 relative) per product.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_captioner.ops.block_fused import fused_convnext_block as jax_block
from tpu_captioner_torch.ops import block_fused
from tpu_captioner_torch.ops.block_fused import CHUNK, SMEM_LIMIT, _block_plain, block_plan
from tpu_captioner_torch.ops.dwconv import PAD
from tpu_captioner_torch.ops.tf32 import block_forward

STAGES = [(b, 64 >> s, 64 >> s, 128 << s) for s in range(4) for b in (8, 32)]
OTHERS = [(3, 14, 14, 512), (2, 9, 7, 128), (1, 5, 3, 1024), (2, 17, 12, 256)]


@pytest.mark.parametrize("shape", STAGES + OTHERS)
def test_plan_covers_every_pixel_and_channel_once(shape):
    B, H, W, C = shape
    plan = block_plan(*shape)
    assert plan.cc == CHUNK and plan.cluster * plan.cc == C and plan.cluster <= 8
    assert plan.th % 2 == 0 and 2 <= plan.th <= 8 and plan.tw == 8
    assert plan.units == (plan.cc // 32) * (plan.th // 2) and 32 * plan.units <= 512
    tiles_w, tiles_h = -(-W // plan.tw), -(-H // plan.th)
    assert plan.tiles == B * tiles_h * tiles_w and 1 <= plan.parts <= plan.tiles
    seen = np.zeros((B, H, W), np.int64)
    for part in range(plan.parts):
        for t in range(part, plan.tiles, plan.parts):  # the kernel's walk: part, part + parts, ...
            b, r = divmod(t, tiles_h * tiles_w)
            h0, w0 = r // tiles_w * plan.th, r % tiles_w * plan.tw
            seen[b, h0:h0 + plan.th, w0:w0 + plan.tw] += 1  # pixels past the image are never stored
    assert (seen == 1).all()
    channels = np.zeros(C, np.int64)
    for rank in range(plan.cluster):
        channels[rank * plan.cc:(rank + 1) * plan.cc] += 1
    assert (channels == 1).all()


@pytest.mark.parametrize("shape", STAGES + OTHERS)
def test_plan_fits_shared_memory(shape):
    plan = block_plan(*shape)
    box = 4 * (plan.th + 2 * PAD) * (plan.tw + 2 * PAD) * plan.cc
    assert 2 <= plan.slots <= 4 and plan.smem <= SMEM_LIMIT
    assert plan.smem == block_fused._HEADER + block_fused._SMALL + plan.slots * box
    assert box % 128 == 0  # every slot starts on a TMA destination's alignment


@pytest.mark.parametrize("active", [15, 33, 1])
def test_plan_takes_the_clusters_the_card_runs(active):
    plan = block_plan(32, 8, 8, 1024, 132, active)
    assert plan.parts == min(active, plan.tiles)


@pytest.mark.parametrize("c", [64, 96, 2048, 130])
def test_plan_refuses_widths_without_a_kernel(c):
    with pytest.raises(ValueError, match="supports C in"):
        block_plan(2, 8, 8, c)


def test_plan_that_does_not_fit_raises(monkeypatch):
    with pytest.raises(ValueError, match="empty shape"):
        block_plan(0, 8, 8, 128)
    monkeypatch.setattr(block_fused, "SMEM_LIMIT", 100_000)
    block_plan.cache_clear()
    try:
        with pytest.raises(ValueError, match="shared memory"):
            block_plan(2, 8, 8, 128)
    finally:
        block_plan.cache_clear()


def make_args(shape, seed):
    """JAX-layout numpy args at chip_smoke.py's scales, one image dropped."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sd = np.full(shape[0], 1.25, np.float32)
    sd[0] = 0.0
    return (f(*shape), sd, 0.1 * f(7, 7, c), 0.1 * f(c), 1.0 + 0.1 * f(c), 0.1 * f(c),
            0.02 * f(c, 4 * c), 0.1 * f(4 * c), 0.02 * f(4 * c, c), 0.1 * f(c), 0.5 * f(c))


def port_args(a):
    t = [torch.from_numpy(np.ascontiguousarray(v)) for v in a]
    t[6], t[8] = t[6].T.contiguous(), t[8].T.contiguous()
    return t


@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (2, 9, 7, 256), (1, 5, 3, 512)])
def test_launch_arithmetic_matches_pallas_kernel(shape):
    """One chunk (C = 128), two and four merged by the cluster rule, odd sides."""
    from jax.experimental.pallas import tpu as pltpu

    a = make_args(shape, seed=shape[1] * shape[3])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_block(*map(jnp.asarray, a), True))
    got = block_forward(*port_args(a)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, np.abs(want).max()), rtol=0)
    np.testing.assert_array_equal(got[0], a[0][0])  # sd 0: the input, bit for bit


def test_launch_arithmetic_matches_plain_block_at_stage_width():
    a = port_args(make_args((1, 8, 8, 1024), seed=11))
    want = _block_plain(*a)
    got = block_forward(*a)
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())
