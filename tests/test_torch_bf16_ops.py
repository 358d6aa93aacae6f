"""The bf16 instances' plain versions (what the CPU wrappers run, and what
the CUDA instances are held against on the card) against the JAX package's
bf16 arms, on numpy-seeded inputs.

"Within one bf16 ulp" (``assert_within_ulp``): |port - JAX| at most one
bf16 ulp of the JAX value (2^(floor(log2 |ref|) - 7)), and at least 2^-8,
elementwise.  An f32 sum taken in another order, or an erf 1.5e-7 off
(the Pallas GELU), can round to the neighbouring bf16 value, and no
further.

- The depthwise conv (``ops/dwconv.py:_dw_plain`` in bf16, the bias added
  after the conv's rounding) against JAX ``depthwise_conv7x7_nhwc`` on
  bf16 x and filter plus ``bias.astype(bf16)``, both through the Pallas
  ``_dw_kernel`` under ``pltpu.force_tpu_interpret_mode()`` and through
  XLA's grouped conv: within one ulp (measured: the Pallas kernel equal
  everywhere, XLA half an ulp in one element of 36,864).
- The MLP tail's bf16-I/O plain version (``_mlp_plain_bf16``) against JAX
  ``fused_convnext_mlp`` on bf16 x, residual, w1 and w2 with
  ``precise=True`` in interpret mode: within one ulp (measured: equal at
  C = 128, one ulp in 0.022% of the elements at C = 256).
- The decode step's bf16 arm (``_decode_step_plain_bf16``) against JAX
  ``fused_decode_step(interpret=True, precise=False)`` on
  ``cast_weight_matrices(w, bf16)``, bf16 caches and bf16 memory K/V, at
  pos 0 and 5: x_out and alpha within 2e-3 x max(1, max |ref|) (one bf16
  rounding of an operand, 2^-8, that a sum in another order can flip
  inside a product, and whose change feeds the next layers' roundings;
  measured 3.7e-7 and 1.5e-8 at pos 0, 1.2e-3 and 3.7e-5 at pos 5, three
  layers), k_new and v_new within one ulp (measured: equal at pos 0, one
  ulp in 4.9% of the elements at pos 5).  The wrapper's instances by
  storage dtype and ``precise``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_helpers import SMALL, jax_model_and_params, port_model, t
from tpu_captioner.ops.decode_step import (
    cast_weight_matrices as jax_cast_weight_matrices,
    fused_decode_step as jax_fused_decode_step,
    prepare_cross_memory as jax_prepare_cross_memory,
    prepare_decode_weights as jax_prepare_decode_weights,
)
from tpu_captioner.ops.dwconv import depthwise_conv7x7_nhwc as jax_dwconv
from tpu_captioner.ops.mlp_block import fused_convnext_mlp as jax_mlp
from tpu_captioner_torch.ops.decode_step import (
    _decode_step_plain_bf16,
    cast_weight_matrices,
    fused_decode_step,
    prepare_cross_memory,
    prepare_decode_weights,
)
from tpu_captioner_torch.ops.dwconv import _dw_plain, depthwise_conv7x7_nhwc, dwconv_forward
from tpu_captioner_torch.ops.mlp_block import _mlp_plain_bf16, fused_convnext_mlp

BF = torch.bfloat16


def to_bf16(a: np.ndarray) -> torch.Tensor:
    """A numpy f32 array rounded to bf16 (torch's round to nearest even)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(BF)


def jnp_bf16(x: torch.Tensor):
    """The same bf16 values as a JAX array (exact through f32)."""
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


def assert_within_ulp(got: torch.Tensor, want) -> float:
    """Within one bf16 ulp of ``want`` (at least 2^-8), elementwise; returns
    the largest error in ulps."""
    want = np.asarray(want).astype(np.float32)
    got = got.float().numpy()
    ulp = np.maximum(np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -8))) - 7), 2.0 ** -8)
    worst = float((np.abs(got - want) / ulp).max())
    assert worst <= 1.0, worst
    return worst


@pytest.mark.parametrize("shape", [(2, 12, 12, 128), (3, 7, 9, 16)])
def test_dwconv_bf16_plain_matches_jax_pallas_and_xla(shape):
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(sum(shape))
    b, h, w, c = shape
    x = to_bf16(rng.standard_normal(shape))
    taps = to_bf16(0.1 * rng.standard_normal((7, 7, c)))
    bias = to_bf16(0.1 * rng.standard_normal(c))
    got = _dw_plain(x, taps, bias)
    assert got.dtype == BF
    jx, jw, jb = jnp_bf16(x), jnp_bf16(taps), jnp_bf16(bias)
    xla = jax_dwconv(jx, jw, False) + jb
    with pltpu.force_tpu_interpret_mode():
        pallas = jax_dwconv(jx, jw, True) + jb
    assert xla.dtype == pallas.dtype == jnp.bfloat16
    assert_within_ulp(got, xla)
    assert_within_ulp(got, pallas)
    # The CPU wrappers run the plain version; the forward refuses what it
    # has no instance for.
    torch.testing.assert_close(dwconv_forward(x, taps, bias=bias), got, rtol=0, atol=0)
    before = depthwise_conv7x7_nhwc.launches, depthwise_conv7x7_nhwc.bf16_launches
    with torch.no_grad():
        torch.testing.assert_close(depthwise_conv7x7_nhwc(x, taps, True, False, bias), got, rtol=0, atol=0)
    assert (depthwise_conv7x7_nhwc.launches, depthwise_conv7x7_nhwc.bf16_launches) == before


@pytest.mark.parametrize("c", [128, 256])
def test_mlp_bf16_plain_matches_jax_pallas_kernel(c):
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(c)
    n = 160
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, res = to_bf16(f(n, c)), to_bf16(f(n, c))
    w1, w2 = to_bf16(0.05 * f(c, 4 * c)), to_bf16(0.05 * f(4 * c, c))  # the JAX layouts
    sd = np.where(rng.random(n) < 0.7, 2.0, 0.0).astype(np.float32)
    vec = (1.0 + 0.1 * f(c), 0.1 * f(c))
    b1, b2, gamma = 0.1 * f(4 * c), 0.1 * f(c), 0.5 * f(c)
    with pltpu.force_tpu_interpret_mode():
        want = jax_mlp(jnp_bf16(x), jnp_bf16(res), jnp.asarray(sd), *map(jnp.asarray, vec), jnp_bf16(w1),
                       jnp.asarray(b1), jnp_bf16(w2), jnp.asarray(b2), jnp.asarray(gamma), True, True)
    assert want.dtype == jnp.bfloat16
    args = (x, res, t(sd), *map(t, vec), w1.T.contiguous(), t(b1), w2.T.contiguous(), t(b2), t(gamma))
    got = _mlp_plain_bf16(*args)
    assert got.dtype == BF
    assert_within_ulp(got, want)
    before = fused_convnext_mlp.launches, fused_convnext_mlp.bf16_launches
    with torch.no_grad():
        torch.testing.assert_close(fused_convnext_mlp(*args), got, rtol=0, atol=0)  # the CPU wrapper's plain version
    assert (fused_convnext_mlp.launches, fused_convnext_mlp.bf16_launches) == before


B, T = 3, 8
L, P = SMALL["num_layers"], SMALL["encoded_image_size"] ** 2


@pytest.fixture(scope="module")
def decode_setup():
    jmodel, params = jax_model_and_params(seed=4)
    model = port_model(params)
    return jmodel, params, model


@pytest.mark.parametrize("pos", [0, 5])
def test_decode_bf16_arm_matches_jax_precise_false(decode_setup, pos):
    jmodel, params, model = decode_setup
    E, H = SMALL["embed_dim"], SMALL["num_heads"]
    rng = np.random.default_rng(pos)
    dec = model.decoder
    with torch.inference_mode():
        mem = dec.project_memory(t(rng.standard_normal((B, 2, 2, SMALL["encoder_dim"])).astype(np.float32)))
        w = cast_weight_matrices(prepare_decode_weights(dec.layers, E), BF)
        mk, mv = (m.to(BF) for m in prepare_cross_memory(dec.layers, mem, E))
        x = to_bf16(rng.standard_normal((B, E)))
        ck, cv = to_bf16(rng.standard_normal((L, B, T, E))), to_bf16(rng.standard_normal((L, B, T, E)))
        got = _decode_step_plain_bf16(w, x, pos, ck, cv, mk, mv, H)
        assert [g.dtype for g in got] == [torch.float32, torch.float32, BF, BF]
        p = params["decoder"]
        jw = jax_cast_weight_matrices(jax_prepare_decode_weights(jax_tree(p["layers"]), E), jnp.bfloat16)
        # The memory K/V rounded to bf16 by each package agree but where an
        # f32 projection lands within its last bits of a rounding boundary:
        # both arms take the same bf16 values.
        jmk, jmv = jax_prepare_cross_memory(jax_tree(p["layers"]), jnp.asarray(mem.numpy()), E)
        assert_within_ulp(mk, jmk.astype(jnp.bfloat16))
        want = jax_fused_decode_step(
            jw, jnp_bf16(x), jnp.int32(pos), jnp_bf16(ck), jnp_bf16(cv), jnp_bf16(mk), jnp_bf16(mv), H,
            interpret=True, precise=False,
        )
        assert [a.dtype for a in want] == [jnp.float32, jnp.float32, jnp.bfloat16, jnp.bfloat16]
        for name, a, b in zip(("x_out", "alpha"), got[:2], want[:2]):
            b = np.asarray(b)
            err = np.abs(a.numpy() - b).max() / max(1.0, np.abs(b).max())
            assert err < 2e-3, (name, err)
        for a, b in zip(got[2:], want[2:]):
            assert_within_ulp(a, b)
        # The CPU wrapper: the bf16 storage picks precise=False and its plain version.
        before = fused_decode_step.launches, fused_decode_step.bf16_launches
        for a, b in zip(fused_decode_step(w, x, pos, ck, cv, mk, mv, H), got):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert (fused_decode_step.launches, fused_decode_step.bf16_launches) == before


def test_decode_wrapper_takes_only_its_instances(decode_setup):
    """f32 storage with precise=True and bf16 storage with precise=False
    have instances; the other pairings raise ValueError.  The bf16 arm's
    one-cell form runs and equals the per-layer form bit for bit."""
    _, _, model = decode_setup
    E, H = SMALL["embed_dim"], SMALL["num_heads"]
    dec = model.decoder
    with torch.inference_mode():
        mem = dec.project_memory(torch.zeros(B, 2, 2, SMALL["encoder_dim"]))
        w32 = prepare_decode_weights(dec.layers, E)
        mk, mv = prepare_cross_memory(dec.layers, mem, E)
        ck = torch.zeros(L, B, T, E)
        x = torch.zeros(B, E)
        fused_decode_step(w32, x, 0, ck, ck, mk, mv, H, precise=True)
        with pytest.raises(ValueError, match="no instance"):
            fused_decode_step(w32, x, 0, ck, ck, mk, mv, H, precise=False)
        wbf = cast_weight_matrices(w32, BF)
        args = (wbf, x.to(BF), 0, ck.to(BF), ck.to(BF), mk.to(BF), mv.to(BF), H)
        fused_decode_step(*args, precise=False)
        with pytest.raises(ValueError, match="no instance"):
            fused_decode_step(*args, precise=True)
        for a, b in zip(fused_decode_step(*args, one_cell=True), fused_decode_step(*args)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        w16 = cast_weight_matrices(w32, torch.float16)
        with pytest.raises(ValueError, match="no instance"):
            fused_decode_step(w16, x.half(), 0, ck.half(), ck.half(), mk.half(), mv.half(), H)


def jax_tree(tree):
    import jax

    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("E,H", [(512, 8), (200, 8), (304, 8)])
def test_bf16_decode_plan_sizes_the_ring_by_element(E, H):
    """The bf16 arm's per-layer plan: ring units of bf16 weight rows (2 bytes
    an element, so the ring holds more weights than the f32 plan's), every
    column owned once, the shared memory within a block's; the one-cell and
    rollout kernels' bf16 plans likewise (at the greedy eval's 32 rows and
    the beams' 40 and 160; the rollout's head of vocab 9490 too)."""
    from tpu_captioner_torch.ops.decode_step import SMEM_LIMIT, decode_plan
    from tests.test_torch_decode_plan import check_plan

    for R in (1, 32, 40, 160):
        plan = decode_plan("layer", R, 52, 49, E, H, 512, 132, esize=2)
        check_plan(plan, "layer", R, E, 512, 132)
        f32 = decode_plan("layer", R, 52, 49, E, H, 512, 132)
        # At 2 bytes an element the ring holds more of a layer's weights.
        assert plan.slots * plan.slot_floats >= f32.slots * f32.slot_floats and plan.smem_bytes <= SMEM_LIMIT
    for kind in ("onecell", "rollout"):
        V = 9490 if kind == "rollout" else 0
        for R in (32, 40, 160):
            plan = decode_plan(kind, R, 52, 49, E, H, 512, 132, V, esize=2)
            check_plan(plan, kind, R, E, 512, 132)
            f32 = decode_plan(kind, R, 52, 49, E, H, 512, 132, V)
            assert plan.slots * plan.slot_floats >= f32.slots * f32.slot_floats and plan.smem_bytes <= SMEM_LIMIT
    with pytest.raises(ValueError, match="4 or 2 bytes"):
        decode_plan("layer", 32, 52, 49, E, H, 512, 132, esize=1)


@pytest.mark.parametrize("shape", [(8, 64, 64, 128), (32, 16, 16, 512), (32, 8, 8, 1024), (2, 9, 7, 24)])
def test_bf16_dwconv_plan(shape):
    """The bf16 plans: TMA boxes of bf16 rows need C % 8 == 0.  The
    forward's takes no more shared memory than the f32 plan; the filter
    gradient's bf16 boxes hold at least as many channels a chunk (128 at
    stage 4, against f32's 64) and at least as many ring slots, within a
    block's shared memory; elements of another size are refused."""
    from tpu_captioner_torch.ops.dwconv import SMEM_LIMIT, dwconv_plan

    for kind in ("forward", "wgrad"):
        plan, f32 = dwconv_plan(*shape, kind=kind, esize=2), dwconv_plan(*shape, kind=kind)
        assert plan.tma and plan.smem <= SMEM_LIMIT and (plan.th, plan.tw) == (f32.th, f32.tw)
        assert plan.cc >= f32.cc and plan.parts == f32.parts and plan.slots >= f32.slots
        if kind == "forward":
            assert plan.smem <= f32.smem
        with pytest.raises(ValueError, match="C % 8"):
            dwconv_plan(2, 9, 7, 20, kind=kind, esize=2)
    with pytest.raises(ValueError, match="4 or 2 bytes"):
        dwconv_plan(*shape, kind="wgrad", esize=1)
