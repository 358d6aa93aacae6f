"""A plain PyTorch model of the 3xTF32 products of the MLP-tail,
whole-block and LSTM step kernels.

The MLP tail's forward, whole-tile and sub-tiled, and its backward
(``csrc/mlp_block.cu``, ``csrc/mlp_block_bwd.cu``), the whole-block kernel
(``csrc/block_fused.cu``) and the LSTM step (``csrc/lstm_step.cu``) take
their matrix products from the card's TF32 tensor cores through
``csrc/tf32x3_gemm.cuh``:
each f32 operand ``v`` is split into ``hi = rna_tf32(v)`` and
``lo = rna_tf32(v - hi)``, and each product accumulates ``hi.lo + lo.hi``
and then ``hi.hi`` in f32.  This module computes the same on f32 tensors,
on any device, so that the tests can hold the kernels' arithmetic against
the JAX package on the CPU, where no kernel runs.  Nothing on the port's
main path calls it: the wrappers run the kernels on the card and
``_mlp_plain`` / ``_mlp_bwd_plain`` / ``_block_plain`` /
``_lstm_step_plain`` (full f32) on the CPU.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32's 10 explicit mantissa bits, to nearest
    with ties away from zero: PTX ``cvt.rna.tf32.f32``.  On the sign-magnitude
    bits that is adding half of the 13 dropped bits' unit and clearing them.
    Infinities and NaNs pass through."""
    if x.dtype != torch.float32:
        raise ValueError(f"round_tf32 takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def split_tf32(x: torch.Tensor):
    """``(hi, lo)``: the two TF32 planes the kernels store for ``x``."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernels compute it: the three TF32 products, each
    exact in f32, the small terms first."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (a_hi @ b_lo + a_lo @ b_hi) + a_hi @ b_hi


def matmul_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in one TF32 pass: what the split exists to avoid."""
    return round_tf32(a) @ round_tf32(b)


def mlp_forward(x, residual, sd, ln_w, ln_b, w1, b1, w2, b2, gamma, mm=matmul_3xtf32):
    """The tail's forward as the whole-tile kernel computes it (the
    arguments of ``ops/mlp_block.py:_mlp_plain``), with ``mm`` for its two
    products."""
    xn = F.layer_norm(x, (x.shape[-1],), ln_w, ln_b, LN_EPS)
    h = F.gelu(mm(xn, w1.T) + b1)
    return residual + sd[:, None] * ((mm(h, w2.T) + b2) * gamma)


def fused_mlp_forward(x, residual, sd, ln_w, ln_b, w1, b1, w2, b2, gamma, jc, stage=32):
    """The tail's forward as the sub-tiled kernel (``csrc/mlp_block.cu:
    fused_kernel``, ``TPU_CAPTIONER_MLP_SUB=64``) computes it: ln_w folded
    into W1's columns and W1 ln_b into b1 (``prep_w1``); each row's
    normalised x = x * rstd - mean * rstd; the hidden dimension in chunks
    of ``jc`` units; the first product's sum over C in ``stage``-deep
    partials added in f32; GELU and the split of each chunk, whose second
    product is one partial added into the output's f32 accumulator; then
    out = res + sd * ((acc + b2) * gamma).  Every product is 3xTF32."""
    mu = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + LN_EPS)
    xhat = x * rstd + (-mu * rstd)
    w1f, b1f = w1 * ln_w, b1 + w1 @ ln_b
    acc = torch.zeros_like(x)
    for j in range(0, w1.shape[0], jc):
        h = torch.zeros(x.shape[0], jc, dtype=x.dtype)
        for k in range(0, x.shape[1], stage):
            h = h + matmul_3xtf32(xhat[:, k:k + stage], w1f[j:j + jc, k:k + stage].T)
        acc = acc + matmul_3xtf32(F.gelu(h + b1f[j:j + jc]), w2[:, j:j + jc].T)
    return residual + sd[:, None] * ((acc + b2) * gamma)


def mlp_backward(g, x, sd, ln_w, ln_b, w1, b1, w2, b2, gamma, mm=matmul_3xtf32):
    """The backward kernel's nine outputs (those of
    ``ops/mlp_block.py:_mlp_bwd_plain``), with ``mm`` for its six products;
    d_b1 sums d_a's two planes, as the kernel does."""
    mu = x.mean(-1, keepdim=True)
    r = torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + LN_EPS)
    xhat = (x - mu) * r
    xn = xhat * ln_w + ln_b
    a = mm(xn, w1.T) + b1
    h = F.gelu(a)
    u = mm(h, w2.T) + b2
    d_y = g * sd[:, None]
    d_u = d_y * gamma
    gelu_grad = 0.5 * (1.0 + torch.erf(a * _INV_SQRT2)) + a * torch.exp(-0.5 * a * a) * _INV_SQRT_2PI
    d_a = mm(d_u, w2) * gelu_grad
    d_xn = mm(d_a, w1)
    d_xhat = d_xn * ln_w
    d_x = r * (d_xhat - d_xhat.mean(-1, keepdim=True) - xhat * (d_xhat * xhat).mean(-1, keepdim=True))
    d_a_hi, d_a_lo = split_tf32(d_a)
    return (
        d_x, (g * (u * gamma)).sum(-1), (d_xn * xhat).sum(0), d_xn.sum(0),
        mm(d_a.T, xn), (d_a_hi + d_a_lo).sum(0), mm(d_u.T, h), d_u.sum(0), (d_y * u).sum(0),
    )


def block_forward(x, sd, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, chunk=128, mm=matmul_3xtf32):
    """The whole-block kernel's forward as its launches compute it (the
    arguments of ``ops/block_fused.py:_block_plain``): the conv with its
    bias added after the 49 taps; each pixel's LayerNorm from the moments of
    its channels in chunks of ``chunk`` (a block's share of a cluster: mean
    and centred sum of squares M2), merged as the kernel merges them (the
    mean of the chunk means; M2 the sum of the chunks' M2 plus ``chunk``
    times the squared distance of each chunk's mean from the mean); then
    the two products over LN(t)'s planes as ``mlp_forward`` runs them, with
    x as the residual and one scale per image."""
    b, h, w, c = x.shape
    if c % chunk:
        raise ValueError(f"block_forward: C={c} is not a multiple of the chunk {chunk}")
    t = F.conv2d(x.permute(0, 3, 1, 2), dw_w.permute(2, 0, 1).unsqueeze(1), padding=dw_w.shape[0] // 2, groups=c)
    t = t.permute(0, 2, 3, 1).reshape(-1, c) + dw_b
    parts = t.reshape(-1, c // chunk, chunk)
    mean_r = parts.sum(-1) * (1.0 / chunk)
    m2_r = ((parts - mean_r[..., None]) ** 2).sum(-1)
    mean = mean_r.mean(-1, keepdim=True)
    rstd = torch.rsqrt((m2_r + chunk * (mean_r - mean) ** 2).sum(-1, keepdim=True) / c + LN_EPS)
    tn = (t - mean) * rstd * ln_w + ln_b
    hidden = F.gelu(mm(tn, w1.T) + b1)
    y = (mm(hidden, w2.T) + b2) * gamma
    return (x.reshape(-1, c) + sd.repeat_interleave(h * w)[:, None] * y).reshape(b, h, w, c)


def lstm_k_slots(k: int) -> torch.Tensor:
    """The column each slot of the LSTM kernel's B planes holds, over k
    columns padded to 16 (``csrc/lstm_step.cu:slot_of_col``): within each
    group of 16, slot 8 e2 + u + 4 e holds column 4 u + 2 e2 + e, so that a
    thread's weight fragment is one float4 and k-step 2 G + e2 of the wgmma
    takes columns 4 q + 2 e2 and 4 q + 2 e2 + 1 of group G."""
    sl = torch.arange(-(-k // 16) * 16)
    s, e2 = sl % 8, (sl // 8) % 2
    return (sl // 16) * 16 + 4 * (s % 4) + 2 * e2 + s // 4


def lstm_step_forward(w, emb, h, c, enc, att1, plan):
    """The LSTM step as ``csrc/lstm_step.cu`` computes it under ``plan``
    (``ops/lstm_step.py:lstm_plan``; the arguments of ``_lstm_step_plain``):
    every product 3xTF32 over 32-column stages whose columns are taken in
    the B planes' slot order (``lstm_k_slots``), a stage's partial the sum
    of its four 8-deep k-steps where the plan's rows are at most 64, else
    one; a block's split the f32 sum of its stages in order; a tile the sum
    of its splits in split order (``lstm_units``), then the bias.  A gate
    tile t holds rows g * D + 16 t + i of each gate g (16 units, gate-major)
    and adds the gated context's stages after the h-side ones; the cell
    follows its gates.  The attention in f32 as the plain version."""
    from tpu_captioner_torch.ops.lstm_step import GATE_UNITS, STAGE, TILE, lstm_units

    R, E = emb.shape
    D, (_, P, C), A = h.shape[1], enc.shape, att1.shape[2]
    kd = -(-D // STAGE)
    order = lstm_k_slots(STAGE)
    per_kstep = plan.rows <= 64

    def stage(x, wt, k):  # (R, M): stage k of x (R, K) against wt (M, K)
        cols = k * STAGE + order
        ok = cols < x.shape[1]
        xs = torch.where(ok, x[:, cols.clamp(max=x.shape[1] - 1)], 0.0)
        ws = torch.where(ok, wt[:, cols.clamp(max=wt.shape[1] - 1)], 0.0)
        if not per_kstep:
            return matmul_3xtf32(xs, ws.T)
        d = [matmul_3xtf32(xs[:, 8 * t:8 * t + 8], ws[:, 8 * t:8 * t + 8].T) for t in range(4)]
        return ((d[0] + d[1]) + d[2]) + d[3]

    def rows_of(wt, idx):  # wt's rows idx, zeros where idx is None
        out = torch.zeros(len(idx), wt.shape[1], dtype=wt.dtype)
        for m, r in enumerate(idx):
            if r is not None:
                out[m] = wt[r]
        return out

    af_parts, gate_parts = {}, {}
    for b, u in enumerate(lstm_units(plan, E, D, A, C)):
        if u.af is not None:
            af_parts.setdefault(u.af, {})[(plan.grid - 1 - b) % plan.af_split] = u.af_k
        if u.gate is not None:
            gate_parts.setdefault(u.gate, {})[b % plan.gate_split] = (u.gate_hk, u.gate_ck)

    n_att = -(-A // TILE)
    att2, fb = torch.empty(R, A), torch.empty(R, C)
    for t, splits in af_parts.items():
        wt, bias, out, width, row0 = ((w.wd, w.bd, att2, A, t * TILE) if t < n_att
                                      else (w.wfb, w.bfb, fb, C, (t - n_att) * TILE))
        tile = rows_of(wt, [r if r < width else None for r in range(row0, row0 + TILE)])
        v = torch.zeros(R, TILE)
        for s in range(plan.af_split):
            part = torch.zeros(R, TILE)
            for k in splits[s]:
                part = part + stage(h, tile, k)
            v = v + part
        n = min(TILE, width - row0)
        out[:, row0:row0 + n] = v[:, :n] + bias[row0:row0 + n]

    score = (torch.relu(att1 + att2[:, None, :]) * w.wfull).sum(dim=-1) + w.bfull
    alpha = torch.softmax(score, dim=1)
    gctx = torch.sigmoid(fb) * (alpha[:, :, None] * enc).sum(dim=1)

    gates = torch.empty(R, 4 * D)
    for t, splits in gate_parts.items():
        idx = [g * D + t * GATE_UNITS + i if t * GATE_UNITS + i < D else None
               for g in range(4) for i in range(GATE_UNITS)]
        whh, wie, wic = (rows_of(x, idx) for x in (w.w_hh, w.w_ih_e, w.w_ih_c))
        v = torch.zeros(R, TILE)
        for s in range(plan.gate_split):
            hk, ck = splits[s]
            part = torch.zeros(R, TILE)
            for k in hk:
                part = part + (stage(h, whh, k) if k < kd else stage(emb, wie, k - kd))
            for k in ck:
                part = part + stage(gctx, wic, k)
            v = v + part
        for m, r in enumerate(idx):
            if r is not None:
                gates[:, r] = v[:, m] + w.b[r]
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new, alpha
