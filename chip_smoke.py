#!/usr/bin/env python3
"""Drive the PyTorch port (``tpu_captioner_torch``) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the CUDA kernels from the five sources in
   ``tpu_captioner_torch/csrc`` (one nvcc per source, all started together;
   ``decode_step.cu`` holds three kernels, ``dwconv.cu`` two);
3. hold each kernel against its plain PyTorch version at the main paths'
   shapes, with CUDA-event times of both and the least time the card could
   take (``bound_ms``): the fused ConvNeXt MLP tail at the four
   ConvNeXt-Base stages at batch 8 (serving) and 32 (the train step), with
   all-one and with stochastic-depth row scales (0 and 1/survival); the
   per-layer decode step at 8 images x beam 5 = 40 rows and the one-cell
   step at the greedy eval's 32 rows, cache length 52, each also against
   the other; the dropout mask pool at the flagship train
   step's 29,366,272 bits for three seeds, whose bits must be identical,
   beside ``Tensor.bernoulli_`` as the library yardstick; the MLP-tail
   backward at the fine-tune step's shapes (N = 8192 at C = 512, N = 2048 at
   C = 1024, batch 32, stochastic-depth rows) and at a ragged N = 600; the
   depthwise conv's forward kernel at the four stage shapes at batch 8 and
   32, its input gradient (the flipped filter) and its filter-gradient
   kernels at the fine-tune step's trained stages, beside
   ``F.conv2d(groups=C)`` and ``aten.convolution_backward`` as the library
   yardsticks; then the three decode kernels at the reference's
   pretrained-embedding widths, GloVe-200 (E=200, H=8) and word2vec-300
   (E=300, H=6), whose head widths 25 and 50 take the scalar key loads;
4. the serving path at full width: ConvNeXt-Base + 6-layer E=512
   Transformer, vocab 9490, random weights from a seed, saved as a reference
   ``.pth.tar`` and loaded back through the CLI's loader; beam 5, 50 steps
   over 8 seeded 256x256 images with the kernels, checking that every kernel
   launched (36 MLP launches per encoder pass, L decode launches per token),
   then the same batch through the plain versions on the card, which must
   give the same captions; the same at E=300, H=6 (word2vec-300's width,
   random weights); then encoder ms, beam ms and captions/s at batch 8 and
   32;
5. the frozen-encoder teacher-forced train step at full width, batch 32,
   through ``make_train_step``: two steps from one state and one seed with
   the pool kernel (1 dropout_mask and 36 mlp_block launches per step), then
   the same two steps with the plain pool on the card, which must agree;
   a finite loss, an unchanged encoder; then ms per step, images/s and peak
   memory;
6. the fine-tune train step (``train_encoder=True``, ``starting_layer`` 5)
   at full width, batch 32, with every kernel, both depthwise-conv kernels
   among them (they follow ``use_pallas``, as the MLP tail does): two
   steps from one state and one seed with the kernels (1 dropout_mask, 36
   mlp_block, 30 mlp_block_bwd, 65 dwconv and 30 dwconv_grad launches per
   step), then the same two steps on a copy with every kernel off
   (``use_pallas`` 'off') on the card, which must agree; children 0-4
   unchanged and every trainable child changed; then ms per step, images/s and peak memory with remat 'off' and
   'on', the plain copy's ms per step, a profiler window's kernel time by
   group, and the paired A/B that decides whether the depthwise-conv
   kernels follow ``use_pallas``: fine-tune steps with each kernel against
   the library in turns, and encoder passes for the forward kernel;
7. the greedy eval step (``make_eval_step``) at full width, batch 32, 51
   steps, with phase 4's weights, in four decode modes: 'off' (plain),
   'step', 'step' with one_cell, and 'mega'.  Each mode's launches are
   counted (36 MLP launches, and L decode launches per token, one one-cell
   launch per token or one rollout launch), and each must agree with 'off':
   sequences equal except at a near-tie, logits and maps within 1e-4 and
   1e-5, the loss within 1e-4 relative and the counts equal.  Run twice:
   with the natural <end>, then with an end id the first run's rows emit,
   so that rows finish and every loop stops early; then encoder, rollout
   and eval-step ms per mode, and the rollout kernel against its plain
   version with CUDA-event times and its bound; then one eval step at
   E=200, H=8 (GloVe-200's width) in 'step' and 'mega' against 'off'.

The line before the last is a JSON object of the kernels (route, source, the
TPU kernel each replaces, launches on the main paths, max error, times and
bounds); the last line is ``{"ok": true, "device": {...}}``.  Needs the
repository beside it and one card; imports no JAX.
"""

import argparse
import concurrent.futures
import contextlib
import copy
import dataclasses
import itertools
import json
import math
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MLP_TOL = 1e-4  # order-one outputs of 4C-long f32 sums in another order; erff vs torch's erf
# The backward's nine outputs, relative to max(1, the plain output's largest
# magnitude): the parameter gradients are N-long f32 sums.
MLP_BWD_TOL = 1e-4
FT_START = 5  # the fine-tune step's starting_layer (TrainConfig's default)
DECODE_TOL = {"x": 1e-4, "alpha": 1e-5, "k_new": 1e-4, "v_new": 1e-4}
# The depthwise conv against its plain versions, relative to max(1, the plain
# output's largest magnitude): 49 f32 products per output (forward and input
# gradient); sums over every B x H x W pixel (filter gradient).
DW_TOL, DW_GRAD_TOL = 1e-5, 1e-4
WIDTHS = ((200, 8), (300, 6))  # (E, H) of GloVe-200 and word2vec-300
# The depthwise-conv kernels' paired A/B: pairs, and the calls of each arm in
# a pair, of which the fastest counts (a busy host only adds time).
AB_PAIRS, AB_REPS = 12, 3
# Every kernel switch off: the plain copies that the kernel paths are held against.
ALL_OFF = dict(use_pallas="off", decode_kernel="off")
SCORE_TOL = 1e-3  # beam scores, kernel path vs plain path
TIE_GAP = 1e-4  # a differing caption is accepted only at a near-tie of this size
VOCAB = 9490  # COCO vocab size (bench.py:92)
BEAM, MAX_STEPS = 5, 50
DECODE_ROWS, DECODE_T = 8 * BEAM, MAX_STEPS + 2
POOL_N = 29_366_272  # keep-bits of one flagship train step (batch 32, T 52, 6 layers)
POOL_SEEDS = ((0, 0), (0x9E3779B9, 7), (0xFFFFFFFF, 0x12345678))
TRAIN_BS, TRAIN_T = 32, 52
TRAIN_TIMED_STEPS = 12
# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores
# Integer operations of one Philox4x32-10 call: 10 rounds of two 32x32->64
# multiplies (high and low halves: 4) and four xors, 9 key bumps of two
# adds, and 4 threshold compares.
PHILOX_OPS = 10 * (4 + 4) + 9 * 2 + 4


def _time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _host_ms(fn, repeats=3):
    """Median host-clock time of ``repeats`` calls, each ending in a
    synchronise, in ms; and the last call's result."""
    import torch

    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2], out


def bound(n_bytes, n_ops, ops_per_s=F32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate and
    the operations over the peak rate."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_mlp(dev, card):
    """Kernel vs plain at the four stage shapes of both main paths: serving
    at batch 8 (N = 8*H*W rows) with all-one row scales and with
    stochastic-depth scales, and the train step at batch 32 with per-image
    scales (0 or 1/survival) drawn at each stage's ramped rate.  Returns the
    worst error and the batch-8 encoder pass's times and bound."""
    import torch

    from tpu_captioner_torch.models.convnext import BASE_DEPTHS, BASE_DIMS, sd_probs
    from tpu_captioner_torch.ops.mlp_block import _mlp_plain, fused_convnext_mlp

    side = 64
    probs = sd_probs(BASE_DEPTHS)
    worst, passes = 0.0, {}
    for s, (depth, c) in enumerate(zip(BASE_DEPTHS, BASE_DIMS)):
        g = torch.Generator().manual_seed(c)
        f = lambda *sh: torch.randn(*sh, generator=g)  # noqa: E731
        rest = tuple(a.to(dev) for a in (
            1 + 0.1 * f(c), 0.1 * f(c),
            0.02 * f(4 * c, c), 0.1 * f(4 * c), 0.02 * f(c, 4 * c), 0.1 * f(c), 0.5 * f(c),
        ))
        survival = 1.0 - probs[sum(BASE_DEPTHS[: s + 1]) - 1]  # the stage's last block
        for batch in (8, 32):
            n = batch * (side >> s) ** 2
            keep = torch.rand(batch, generator=g) < survival
            keep[0], keep[1] = False, True  # one image dropped, one kept
            sd_rows = (keep / survival).repeat_interleave(n // batch)
            x, res = f(n, c).to(dev), f(n, c).to(dev)
            args = (x, res, torch.ones(n, device=dev), *rest)
            err = (fused_convnext_mlp(*args) - _mlp_plain(*args)).abs().max().item()
            sd_args = (x, res, sd_rows.to(dev), *rest)
            got = fused_convnext_mlp(*sd_args)
            sd_err = (got - _mlp_plain(*sd_args)).abs().max().item()
            if not torch.equal(got[: n // batch], res[: n // batch]):  # sd 0: the block is skipped
                raise AssertionError(f"mlp_block with sd 0 changed its residual at C={c}, batch {batch}")
            timed = args if batch == 8 else sd_args  # as each path runs it
            t_plain = _time_ms(lambda: _mlp_plain(*timed))
            t_kernel = _time_ms(lambda: fused_convnext_mlp(*timed))
            print(f"mlp_block batch {batch} C={c} N={n}: max_abs_err {err:.3e}, with sd rows "
                  f"(survival {survival:.4f}) {sd_err:.3e} (tol {MLP_TOL:g}); kernel {t_kernel:.4f} ms, "
                  f"plain {t_plain:.4f} ms per launch [{card}]")
            if not max(err, sd_err) < MLP_TOL:
                raise AssertionError(
                    f"mlp_block kernel disagrees at C={c}, batch {batch}: {max(err, sd_err)} >= {MLP_TOL}")
            worst = max(worst, err, sd_err)
            ms, plain_ms, n_bytes, n_ops = passes.get(batch, (0.0, 0.0, 0, 0))
            # Per launch: x, residual and sd read, out written, weights read
            # once; two N x C x 4C products.
            passes[batch] = (ms + depth * t_kernel, plain_ms + depth * t_plain,
                             n_bytes + depth * 4 * (3 * n * c + n + 8 * c * c + 8 * c),
                             n_ops + depth * 16 * n * c * c)
    for batch, (ms, plain_ms, n_bytes, n_ops) in passes.items():
        bound_ms, bound_by = bound(n_bytes, n_ops)
        print(f"mlp_block per encoder pass at batch {batch} (36 blocks): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
    ms, plain_ms, n_bytes, n_ops = passes[8]
    return (worst, ms, plain_ms, *bound(n_bytes, n_ops))


def check_mlp_bwd(dev, card):
    """Backward kernel vs plain at the fine-tune step's two trainable stages
    at batch 32 (per-image sd rows of 0 and 1/survival at the stage's last
    ramped rate) and at a ragged N = 600, C = 128 (per-row sd): each of the
    nine outputs within MLP_BWD_TOL x max(1, max |plain|), and d_x exactly 0
    on rows with sd 0.  Returns the worst absolute error and one fine-tune
    step's (27 + 3 launches) kernel ms, plain ms and bound."""
    import torch

    from tpu_captioner_torch.models.convnext import BASE_DEPTHS, BASE_DIMS, sd_probs
    from tpu_captioner_torch.ops.mlp_block import _mlp_bwd_plain, fused_convnext_mlp_bwd

    probs = sd_probs(BASE_DEPTHS)
    worst, worst_abs, ms, plain_ms, n_bytes, n_ops = 0.0, 0.0, 0.0, 0.0, 0, 0
    for s, n in ((2, TRAIN_BS * 16 * 16), (3, TRAIN_BS * 8 * 8), (0, 600)):
        c = BASE_DIMS[s]
        g = torch.Generator().manual_seed(c + 1)
        f = lambda *sh: torch.randn(*sh, generator=g)  # noqa: E731
        params = tuple(a.to(dev) for a in (
            1 + 0.1 * f(c), 0.1 * f(c),
            0.02 * f(4 * c, c), 0.1 * f(4 * c), 0.02 * f(c, 4 * c), 0.1 * f(c), 0.5 * f(c),
        ))
        survival = 1.0 - probs[sum(BASE_DEPTHS[: s + 1]) - 1]
        units = TRAIN_BS if n % TRAIN_BS == 0 else n  # images, or rows for the ragged case
        keep = torch.rand(units, generator=g) < survival
        keep[0], keep[1] = False, True
        sd = (keep / survival).repeat_interleave(n // units).to(dev)
        args = (f(n, c).to(dev), f(n, c).to(dev), sd, *params)
        got, want = fused_convnext_mlp_bwd(*args), _mlp_bwd_plain(*args)
        abs_errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
        errs = [e / max(1.0, b.abs().max().item()) for e, b in zip(abs_errs, want)]
        if not torch.equal(got[0][sd == 0], torch.zeros_like(got[0][sd == 0])):
            raise AssertionError(f"mlp_block_bwd: rows with sd 0 have a nonzero d_x at C={c}")
        t_kernel = _time_ms(lambda: fused_convnext_mlp_bwd(*args), iters=10)
        t_plain = _time_ms(lambda: _mlp_bwd_plain(*args), iters=10)
        print(f"mlp_block_bwd C={c} N={n} (survival {survival:.4f}): max abs err {max(abs_errs):.3e}, "
              f"max err / max(1, max |plain|) {max(errs):.3e} "
              f"(tol {MLP_BWD_TOL:g}); kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms per launch [{card}]")
        if not max(errs) < MLP_BWD_TOL or not all(torch.isfinite(a).all() for a in got):
            raise AssertionError(f"mlp_block_bwd kernel disagrees at C={c}, N={n}: {errs}")
        worst, worst_abs = max(worst, *errs), max(worst_abs, *abs_errs)
        if n % TRAIN_BS == 0:  # a fine-tune stage: depth launches per step
            depth = BASE_DEPTHS[s]
            ms, plain_ms = ms + depth * t_kernel, plain_ms + depth * t_plain
            # g, x and sd read, d_x and d_sd written, the weights read and
            # their gradients written once; 48 N C^2 flops (module note).
            n_bytes += depth * 4 * (3 * n * c + 2 * n + 16 * c * c + 16 * c)
            n_ops += depth * 48 * n * c * c
    bound_ms, bound_by = bound(n_bytes, n_ops)
    print(f"mlp_block_bwd per fine-tune step (27 + 3 launches): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
    return worst_abs, ms, plain_ms, bound_ms, bound_by


def _rel_err(got, want):
    """(max abs error, max abs error / max(1, max |want|))."""
    err = (got - want).abs().max().item()
    return err, err / max(1.0, want.abs().max().item())


def check_dwconv(dev, card):
    """The depthwise conv's kernels against their plain versions at the
    ConvNeXt-Base stage shapes: the forward at batch 8 and 32; at the
    fine-tune step's trained stages (C = 512 and 1024, batch 32) the input
    gradient (the flipped filter) and the filter gradient, which must also
    repeat bit for bit.  CUDA-event times of each kernel, its plain version
    and the one PyTorch call computing the same function: ``F.conv2d(groups=
    C)`` for the forward and input gradient, ``aten.convolution_backward``
    with only the weight gradient for the filter gradient.  Returns, per
    kernel, one fine-tune step's launches summed (36 forwards and 29 input
    gradients; 30 filter gradients): (worst abs error, kernel ms, plain ms,
    library ms, bound ms, bound by)."""
    import torch
    import torch.nn.functional as F

    from tpu_captioner_torch.models.convnext import BASE_DEPTHS, BASE_DIMS
    from tpu_captioner_torch.ops.dwconv import _dw_grad_plain, _dw_plain, dwconv_filter_grad, dwconv_forward

    # Launches per fine-tune step at starting_layer 5: the input gradient of
    # every trained block but child 5's first (its input is the frozen child
    # 4's output), the filter gradient of every trained block.
    d_x = {2: BASE_DEPTHS[2] - 1, 3: BASE_DEPTHS[3]}
    d_w = {2: BASE_DEPTHS[2], 3: BASE_DEPTHS[3]}
    sums = {k: [0.0, 0.0, 0.0, 0.0, 0, 0] for k in ("dwconv", "dwconv_grad")}  # err, ms, plain, library, bytes, ops
    pass_ms = pass_bytes = pass_ops = 0

    def add(kernel, n, err, times, shape):
        b, h, w, c = shape
        acc = sums[kernel]
        acc[0] = max(acc[0], err)
        for i, t in enumerate(times):
            acc[1 + i] += n * t
        acc[4] += n * 4 * (2 * b * h * w * c + 49 * c)  # two (B, H, W, C) tensors and the filter, once each
        acc[5] += n * 2 * 49 * b * h * w * c

    for s, (depth, c) in enumerate(zip(BASE_DEPTHS, BASE_DIMS)):
        g = torch.Generator().manual_seed(100 + c)
        w = (0.1 * torch.randn(7, 7, c, generator=g)).to(dev)
        wc = w.permute(2, 0, 1).unsqueeze(1).contiguous()  # the (C, 1, 7, 7) layout of F.conv2d
        wc_flip = w.flip(0, 1).permute(2, 0, 1).unsqueeze(1).contiguous()
        for batch in (8, TRAIN_BS):
            side = 64 >> s
            shape = (batch, side, side, c)
            x = torch.randn(*shape, generator=g).to(dev)
            err, rel = _rel_err(dwconv_forward(x, w), _dw_plain(x, w))
            if not rel < DW_TOL:
                raise AssertionError(f"dwconv kernel disagrees at {shape}: {rel} >= {DW_TOL}")
            t_kernel = _time_ms(lambda: dwconv_forward(x, w))
            t_plain = _time_ms(lambda: _dw_plain(x, w))
            t_lib = _time_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2), wc, padding=3, groups=c))
            print(f"dwconv forward {shape}: max_abs_err {err:.3e} (relative {rel:.3e}, tol {DW_TOL:g}); "
                  f"kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms, F.conv2d {t_lib:.4f} ms per launch [{card}]")
            if batch != TRAIN_BS:
                continue
            add("dwconv", depth, err, (t_kernel, t_plain, t_lib), shape)
            pass_ms += depth * t_kernel
            pass_bytes += depth * 4 * (2 * x.numel() + 49 * c)
            pass_ops += depth * 2 * 49 * x.numel()
            if s not in d_x:
                continue
            cot = torch.randn(*shape, generator=g).to(dev)
            err, rel = _rel_err(dwconv_forward(cot, w, flip=True), _dw_plain(cot, w.flip(0, 1)))
            if not rel < DW_TOL:
                raise AssertionError(f"dwconv input gradient disagrees at {shape}: {rel} >= {DW_TOL}")
            times = (_time_ms(lambda: dwconv_forward(cot, w, flip=True)),
                     _time_ms(lambda: _dw_plain(cot, w.flip(0, 1))),
                     _time_ms(lambda: F.conv2d(cot.permute(0, 3, 1, 2), wc_flip, padding=3, groups=c)))
            add("dwconv", d_x[s], err, times, shape)
            print(f"dwconv input gradient {shape}: max_abs_err {err:.3e} (relative {rel:.3e}); kernel "
                  f"{times[0]:.4f} ms, plain {times[1]:.4f} ms, F.conv2d {times[2]:.4f} ms per launch [{card}]")
            got = dwconv_filter_grad(x, cot)
            err, rel = _rel_err(got, _dw_grad_plain(x, cot))
            repeat = torch.equal(got, dwconv_filter_grad(x, cot))
            if not (rel < DW_GRAD_TOL and repeat):
                raise AssertionError(f"dwconv_grad kernel at {shape}: relative error {rel} (tol {DW_GRAD_TOL}), "
                                     f"bitwise repeatable {repeat}")
            times = (_time_ms(lambda: dwconv_filter_grad(x, cot), iters=10),
                     _time_ms(lambda: _dw_grad_plain(x, cot), iters=3, warmup=1),
                     _time_ms(lambda: torch.ops.aten.convolution_backward(
                         cot.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), wc, None, [1, 1], [3, 3], [1, 1],
                         False, [0, 0], c, [False, True, False]), iters=10))
            add("dwconv_grad", d_w[s], err, times, shape)
            print(f"dwconv filter gradient {shape}: max_abs_err {err:.3e} (relative {rel:.3e}, tol "
                  f"{DW_GRAD_TOL:g}), the same bits on a second run: {repeat}; kernel {times[0]:.4f} ms, "
                  f"plain {times[1]:.4f} ms, convolution_backward (weight) {times[2]:.4f} ms per launch [{card}]")
    pass_bound, pass_by = bound(pass_bytes, pass_ops)
    print(f"dwconv forward per encoder pass at batch {TRAIN_BS} (36 launches): kernel {pass_ms:.4f} ms, "
          f"bound {pass_bound:.4f} ms ({pass_by}) [{card}]")
    out = {}
    for kernel, (err, ms, plain_ms, lib_ms, n_bytes, n_ops) in sums.items():
        bound_ms, bound_by = bound(n_bytes, n_ops)
        out[kernel] = (err, ms, plain_ms, lib_ms, bound_ms, bound_by)
        print(f"{kernel} per fine-tune step ({'36 + 29' if kernel == 'dwconv' else '27 + 3'} launches): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
    return out


def check_widths(dev, card, seed):
    """The three decode kernels at the reference's pretrained-embedding
    widths (``WIDTHS``): the per-layer and one-cell kernels at the beam's 40
    rows (``check_decode``), and the rollout kernel against its plain
    version at the eval step's 32 rows, 51 tokens, on memory projected from
    a seeded encoder output.  Returns the two models (random weights from
    the seed, ``flagship_model``) by E, for phases 4 and 7."""
    import torch

    from tpu_captioner_torch.core.config import ModelConfig, TrainConfig
    from tpu_captioner_torch.ops.decode_step import (
        _full_rollout_plain, fused_full_rollout, prepare_cross_memory, prepare_decode_weights,
    )

    models = {}
    steps = TrainConfig().max_decode_len
    for E, H in WIDTHS:
        cfg = ModelConfig(vocab_size=VOCAB, embed_dim=E, num_heads=H)
        model = flagship_model(cfg, dev, seed + E)
        dec = model.decoder
        res = check_decode(dev, card, dec.layers, DECODE_ROWS, heads=H)
        enc = torch.randn(TRAIN_BS, 7, 7, cfg.encoder_dim, generator=torch.Generator().manual_seed(E)).to(dev)
        with torch.inference_mode():
            mem = dec.project_memory(enc)
            mk, mv = prepare_cross_memory(dec.layers, mem, E)
            args = (prepare_decode_weights(dec.layers, E), dec.embedding.weight, dec.fc_out.weight,
                    dec.fc_out.bias, dec.pe, mk, mv, VOCAB - 2, VOCAB - 1, steps, H)
            logit_err, alpha_err, ties = compare_rollouts(
                f"decode_rollout E={E} H={H}", fused_full_rollout(*args), _full_rollout_plain(*args))
            t_kernel = _time_ms(lambda: fused_full_rollout(*args), iters=3, warmup=1)
        print(f"E={E} H={H} (head width {E // H}): decode_step {res['decode_step'][1]:.4f} ms, decode_onecell "
              f"{res['decode_onecell'][1]:.4f} ms per step at R={DECODE_ROWS} (plain {res['decode_step'][2]:.4f}); "
              f"decode_rollout R={TRAIN_BS} {steps} tokens: logits {logit_err:.3e}, maps {alpha_err:.3e}, "
              f"{len(ties)} rows differ at a near-tie; kernel {t_kernel:.4f} ms per rollout [{card}]")
        models[E] = model
    return models


def decode_bound(L, R, pos, P, E, Fd):
    """(bytes, ops) of one decode step at cache position ``pos``: per layer
    the six weight matrices and their biases, the pos cached self-attention
    rows of k and v, the P memory rows of k and v, k_new and v_new written;
    per step x in, x out and alpha.  Products: 2 flops per weight per row,
    and the two attentions' scores and weighted sums."""
    w_floats = 6 * E * E + 2 * E * Fd + 9 * E + Fd
    n_bytes = 4 * (L * (w_floats + R * (2 * pos + 2 * P + 2) * E) + R * (2 * E + P))
    n_ops = L * R * (2 * (6 * E * E + 2 * E * Fd) + 4 * E * (pos + 1 + P))
    return n_bytes, n_ops


def check_decode(dev, card, layers, rows, heads=8):
    """The per-layer and one-cell kernels against the plain step at ``rows``
    rows and ``heads`` heads, cache length 52, several positions, with NaN in
    every cache slot at or past ``pos``; the one-cell kernel also against the
    per-layer one (the same arithmetic: within 1e-6).  Returns {kernel: (max
    error, mean ms per step, mean plain ms, bound ms, bound by)}."""
    import torch

    from tpu_captioner_torch.ops.decode_step import (
        _decode_step_plain, fused_decode_step, prepare_decode_weights,
    )

    L, E, P = len(layers), layers[0].linear1.in_features, 49
    H = heads
    w = prepare_decode_weights(layers, E)
    g = torch.Generator().manual_seed(1)
    f = lambda *sh: torch.randn(*sh, generator=g).to(dev)  # noqa: E731
    worst = {"decode_step": 0.0, "decode_onecell": 0.0}
    times = {k: [] for k in worst}
    plain_times, n_bytes, n_ops = [], 0, 0
    Fd = layers[0].linear1.out_features
    for pos in (0, 1, 25, DECODE_T - 1):
        ck, cv = f(L, rows, DECODE_T, E), f(L, rows, DECODE_T, E)
        ck[:, :, pos:] = float("nan")
        cv[:, :, pos:] = float("nan")
        args = (w, f(rows, E), pos, ck, cv, f(L, rows, P, E), f(L, rows, P, E), H)
        want = _decode_step_plain(*args)
        got = {"decode_step": fused_decode_step(*args),
               "decode_onecell": fused_decode_step(*args, one_cell=True)}
        same = max((a - b).abs().max().item() for a, b in zip(*got.values()))
        line = []
        for kernel, outs in got.items():
            errs = {}
            for name, a, b in zip(DECODE_TOL, outs, want):
                if not torch.isfinite(a).all():
                    raise AssertionError(f"{kernel} kernel gave non-finite {name} at pos {pos}")
                errs[name] = (a - b).abs().max().item()
            for name, e in errs.items():
                if not e < DECODE_TOL[name]:
                    raise AssertionError(f"{kernel} kernel disagrees on {name} at R={rows}, pos {pos}: {e}")
            worst[kernel] = max(worst[kernel], *errs.values())
            one_cell = kernel == "decode_onecell"
            times[kernel].append(_time_ms(lambda: fused_decode_step(*args, one_cell=one_cell)))
            line.append(f"{kernel} " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                        + f", {times[kernel][-1]:.4f} ms")
        if not same <= 1e-6:
            raise AssertionError(f"the one-cell and per-layer kernels differ by {same} at R={rows}, pos {pos}")
        plain_times.append(_time_ms(lambda: _decode_step_plain(*args)))
        print(f"decode R={rows} T={DECODE_T} E={E} H={H} pos={pos}: max_abs_err vs plain: " + "; ".join(line)
              + f" per step ({L} layers); one-cell vs per-layer {same:.3e}; plain {plain_times[-1]:.4f} ms [{card}]")
        b, o = decode_bound(L, rows, pos, P, E, Fd)
        n_bytes, n_ops = n_bytes + b, n_ops + o
    bound_ms, bound_by = bound(n_bytes / 4, n_ops / 4)
    print(f"decode bound at R={rows}, E={E}, mean over the four positions: {bound_ms:.4f} ms ({bound_by})")
    return {k: (worst[k], sum(times[k]) / len(times[k]), sum(plain_times) / len(plain_times), bound_ms, bound_by)
            for k in worst}


def check_dropout(dev, card):
    """Kernel vs plain at the flagship pool size for three seeds: identical
    bits and a keep rate within 5 sigma of 0.5; CUDA-event times of the
    kernel, the plain version and ``Tensor.bernoulli_``."""
    import torch

    from tpu_captioner_torch.ops.dropout_mask import _mask_plain, random_mask_pool

    keep, mismatches = 0.5, 0
    for seed in POOL_SEEDS:
        got = random_mask_pool(seed, POOL_N, keep, dev)
        want = _mask_plain(seed, POOL_N, keep, dev)
        bad = int((got != want).sum().item())
        rate = got.double().mean().item()
        sigma = (keep * (1 - keep) / POOL_N) ** 0.5
        print(f"dropout_mask n={POOL_N} seed={seed}: {bad} bits differ from the plain version; "
              f"keep rate {rate:.6f} ({(rate - keep) / sigma:+.2f} sigma)")
        if bad or not abs(rate - keep) < 5 * sigma:
            raise AssertionError(f"dropout_mask kernel wrong at seed {seed}: {bad} bits differ, rate {rate}")
        mismatches += bad
    seed = POOL_SEEDS[1]
    t_kernel = _time_ms(lambda: random_mask_pool(seed, POOL_N, keep, dev), iters=50)
    t_plain = _time_ms(lambda: _mask_plain(seed, POOL_N, keep, dev), iters=5)
    t_lib = _time_ms(lambda: torch.empty(POOL_N, dtype=torch.bool, device=dev).bernoulli_(keep), iters=50)
    # Bytes: the bools written, nothing read.  Operations: integer Philox
    # work, over the 32-bit non-tensor rate (the data sheet gives no
    # integer rate; the f32 one is the closest).
    bound_ms, bound_by = bound(POOL_N, (POOL_N + 3) // 4 * PHILOX_OPS)
    print(f"dropout_mask n={POOL_N}: kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms, "
          f"bernoulli_ {t_lib:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
    return mismatches, t_kernel, t_plain, t_lib, bound_ms, bound_by


def train_batch(rng, word_map, vocab):
    """Seeded uint8 images and captions <start> words <end> <pad>... with
    caplens from 10 to 52; the last row is batch padding (valid False)."""
    import torch

    caplens = torch.randint(10, TRAIN_T + 1, (TRAIN_BS,), generator=rng)
    caplens[0], caplens[1] = 10, TRAIN_T
    caps = torch.randint(1, vocab - 3, (TRAIN_BS, TRAIN_T), generator=rng)
    pos = torch.arange(TRAIN_T)[None, :]
    caps = torch.where(pos < caplens[:, None] - 1, caps, torch.zeros_like(caps))
    caps[torch.arange(TRAIN_BS), caplens - 1] = word_map["<end>"]
    caps[:, 0] = word_map["<start>"]
    valid = torch.ones(TRAIN_BS, dtype=torch.bool)
    valid[-1] = False
    images = torch.randint(0, 256, (TRAIN_BS, 256, 256, 3), generator=rng, dtype=torch.uint8)
    return {"images": images, "captions": caps, "caplens": caplens, "valid": valid}


@contextlib.contextmanager
def plain_mask_pool():
    """Route the train step's pool through the plain version (on the card)."""
    from tpu_captioner_torch.ops import dropout_mask

    kernel = dropout_mask.random_mask_pool
    dropout_mask.random_mask_pool = dropout_mask._mask_plain
    try:
        yield
    finally:
        dropout_mask.random_mask_pool = kernel


def train_phase(dev, card, seed, word_map):
    """Phase 5: the frozen-encoder train step at full width, batch 32."""
    import torch

    from tpu_captioner_torch.core import prng
    from tpu_captioner_torch.core.config import ModelConfig, TrainConfig
    from tpu_captioner_torch.ops.dropout_mask import random_mask_pool
    from tpu_captioner_torch.ops.mlp_block import fused_convnext_mlp
    from tpu_captioner_torch.train.model import CaptionModel
    from tpu_captioner_torch.train.state import TrainState
    from tpu_captioner_torch.train.steps import make_train_step, pool_demand

    cfg, tc = ModelConfig(vocab_size=VOCAB), TrainConfig(batch_size=TRAIN_BS)
    if pool_demand(cfg, TRAIN_BS, TRAIN_T, cfg.num_pixels) != POOL_N:
        raise AssertionError("the flagship pool size changed")
    model = CaptionModel(cfg, device=dev, seed=seed)
    gen = torch.Generator().manual_seed(seed + 3)
    with torch.no_grad():  # order-one layer scales, as in phase 3
        for blk in (m for m in model.modules() if hasattr(m, "layer_scale")):
            blk.layer_scale.copy_(0.1 * torch.rand(blk.layer_scale.shape, generator=gen))
    start = copy.deepcopy(model.state_dict())
    batch = {k: v.to(dev) for k, v in train_batch(gen, word_map, VOCAB).items()}
    root = prng.root_seed(seed)
    seeds = [prng.step_seed(root, "dropout", 0, i) for i in range(2)]

    def two_steps(count):
        model.load_state_dict(start)
        state = TrainState.create(model, tc)
        step = make_train_step(model, tc, word_map)
        out, grads = [], []
        for s in seeds:
            random_mask_pool.launches = fused_convnext_mlp.launches = 0
            state, m = step(state, batch, s)
            torch.cuda.synchronize()
            out.append({k: float(v) for k, v in m.items()})
            grads.append({k: p.grad.clone() for k, p in model.decoder.named_parameters()})
            if count:
                launches.append((random_mask_pool.launches, fused_convnext_mlp.launches))
                print(f"train step: {launches[-1][0]} dropout_mask launches, "
                      f"{launches[-1][1]} mlp_block launches")
                if launches[-1] != (1, 36):
                    raise AssertionError(f"expected 1 dropout_mask and 36 mlp_block launches, got {launches[-1]}")
        return out, grads, {k: v.clone() for k, v in model.decoder.state_dict().items()}, state

    launches = []
    got, grads, params, state = two_steps(count=True)
    with plain_mask_pool():
        want, _, want_params, _ = two_steps(count=False)
    for i, (a, b) in enumerate(zip(got, want)):
        print(f"train step {i}: kernel pool {a}; plain pool {b}")
        if not all(abs(a[k] - b[k]) <= 1e-5 for k in a) or not math.isfinite(a["loss"]):
            raise AssertionError(f"train step {i}: kernel and plain pools disagree or the loss is not finite")
    worst = 0.0
    for k, p in params.items():
        sure = (grads[0][k].abs() >= 1e-7) & (grads[1][k].abs() >= 1e-7)
        err = (p - want_params[k]).abs()[sure]
        worst = max(worst, err.max().item() if err.numel() else 0.0)
    print(f"updated decoder parameters, kernel vs plain pool: max abs diff {worst:.3e} "
          f"(tol {1e-2 * tc.decoder_lr:g}, lr {tc.decoder_lr:g})")
    if not worst <= 1e-2 * tc.decoder_lr:
        raise AssertionError("updated decoder parameters disagree between the two pools")
    enc = model.encoder.state_dict()
    if not all(torch.equal(v, start[f"encoder.{k}"]) for k, v in enc.items()):
        raise AssertionError("the frozen encoder changed")

    # Steady-state time per step (host clock, each step synchronised).
    step = make_train_step(model, tc, word_map)
    for i in range(3):
        state, _ = step(state, batch, prng.step_seed(root, "dropout", 1, i))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(TRAIN_TIMED_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch, prng.step_seed(root, "dropout", 2, i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    enc_ms, _ = _host_ms(lambda: model.encode(
        batch["images"], train=True, generator=prng.generator(seeds[0], dev)), repeats=5)
    ms = sorted(times)[len(times) // 2]
    print(f"train step bs={TRAIN_BS} frozen encoder: median {ms:.2f} ms/step over {TRAIN_TIMED_STEPS} "
          f"steps (min {min(times):.2f}, max {max(times):.2f}), {TRAIN_BS / (ms / 1e3):.1f} images/s, "
          f"train-mode encoder {enc_ms:.2f} ms, peak memory {peak / 2**30:.2f} GiB; "
          f"loss {float(m['loss']):.4f} [{card}]")
    return launches[0]


# Kernel-name substrings of each group in a profiler window, first match wins.
KERNEL_GROUPS = (
    ("dwconv_grad", ("dwconv_wgrad",)),
    ("dwconv", ("dwconv_fwd_kernel",)),
    ("mlp_block_bwd", ("gemm_kernel", "prep_rows", "finish_rows", "column_partials",
                       "column_finish", "sum_splits")),
    ("mlp_block", ("mlp_block_kernel",)),
    ("dropout_mask", ("mask_pool_kernel",)),
    ("convolution backward", ("dgrad", "wgrad", "backward", "grad_weight", "grad_input")),
    ("convolution forward", ("conv", "cudnn", "fprop")),
    ("cuBLAS gemm", ("gemm", "sm90_xmma", "cutlass")),
)


def _kernel_ms_by_group(step, state, batch, seeds):
    """Device time of each kernel group, and of the eight longest kernels,
    over ``len(seeds)`` steps, from a ``torch.profiler`` window (kernel rows
    only), in ms per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for s in seeds:
            state, _ = step(state, batch, s)
        torch.cuda.synchronize()
    groups, kernels = {}, []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        name, ms = e.key.lower(), e.self_device_time_total / 1e3 / len(seeds)
        group = next((g for g, subs in KERNEL_GROUPS if any(x.lower() in name for x in subs)), "other")
        groups[group] = groups.get(group, 0.0) + ms
        kernels.append((ms, e.key[:90]))
    return state, groups, sorted(kernels, reverse=True)[:8]


def set_dw(model, dw_kernel, dw_grad_kernel):
    """Set every ConvNeXt block of ``model`` to the depthwise-conv kernels
    chosen (both False: the grouped conv and its autograd)."""
    from tpu_captioner_torch.models.convnext import CNBlock

    for blk in model.modules():
        if isinstance(blk, CNBlock):
            blk.dw_kernel, blk.dw_grad_kernel = dw_kernel, dw_grad_kernel


def dwconv_ab(dev, card, model, step, state, batch, seeds):
    """The paired A/B that decides whether each depthwise-conv kernel
    follows ``use_pallas``: for each kernel, AB_PAIRS pairs of fine-tune
    steps on one model and state, kernel and library in turns, the order
    within a pair alternating.  The filter gradient goes first, the forward
    on the library in both arms (the library arm is the grouped conv and its
    autograd); then the forward kernel (forward and input gradient), the
    filter gradient on its kernel in both arms, so that cuDNN's weight
    gradient (38 ms of the step, and the wider spread) is in neither.  For the forward kernel also AB_PAIRS pairs of eval encoder
    passes at batch 32 (no backward).  Each arm of a pair
    is the fastest of AB_REPS calls, host clock, each call synchronised.
    A kernel is favoured when the median of the pairs' differences (library
    - kernel) exceeds their spread (the largest difference less the
    smallest).  ``seeds`` is an iterator of dropout seeds.  Leaves the model
    on the library."""
    import statistics

    import torch

    def run(choice, fn):
        set_dw(model, *choice)
        times = []
        for _ in range(AB_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    state_box = [state]

    def one_step():
        state_box[0], _ = step(state_box[0], batch, next(seeds))

    arms = {  # label: ((forward, filter gradient) of the kernel arm, of the library arm, what runs)
        "filter-gradient kernel, fine-tune step": ((False, True), (False, False), one_step),
        "forward kernel, fine-tune step": ((True, True), (False, True), one_step),
        "forward kernel, encoder pass": ((True, False), (False, False), lambda: model.encode(batch["images"])),
    }
    favoured = {}
    for label, (kernel, library, fn) in arms.items():
        run(kernel, fn)  # warm-up of both arms
        run(library, fn)
        pairs = []
        for i in range(AB_PAIRS):
            order = (kernel, library) if i % 2 == 0 else (library, kernel)
            t = {c: run(c, fn) for c in order}
            pairs.append((t[kernel], t[library]))
        diffs = [lib - k for k, lib in pairs]
        gain, spread = statistics.median(diffs), max(diffs) - min(diffs)
        favoured[label] = gain > spread
        print(f"A/B {label}, {AB_PAIRS} pairs, fastest of {AB_REPS} calls per arm: kernel median "
              f"{statistics.median(k for k, _ in pairs):.2f} ms, library median "
              f"{statistics.median(lib for _, lib in pairs):.2f} ms; library - kernel per pair median "
              f"{gain:.2f}, min {min(diffs):.2f}, max {max(diffs):.2f}, spread {spread:.2f} ms; "
              f"kernel favoured (median > spread): {favoured[label]} [{card}]")
        print("  pairs (kernel, library) ms: " + ", ".join(f"({k:.2f}, {lib:.2f})" for k, lib in pairs))
    set_dw(model, False, False)
    return state_box[0], favoured


def finetune_phase(dev, card, seed, word_map):
    """Phase 6: the fine-tune step at full width, batch 32, starting_layer 5,
    with both depthwise-conv kernels selected."""
    import torch

    from tpu_captioner_torch.core import prng
    from tpu_captioner_torch.core.config import ModelConfig, TrainConfig
    from tpu_captioner_torch.ops.dropout_mask import random_mask_pool
    from tpu_captioner_torch.ops.dwconv import depthwise_conv7x7_nhwc as dwconv
    from tpu_captioner_torch.ops.mlp_block import fused_convnext_mlp, fused_convnext_mlp_bwd
    from tpu_captioner_torch.train.model import CaptionModel
    from tpu_captioner_torch.train.state import TrainState
    from tpu_captioner_torch.train.steps import make_train_step

    cfg = ModelConfig(vocab_size=VOCAB)
    tc = TrainConfig(batch_size=TRAIN_BS)
    if tc.starting_layer != FT_START:
        raise AssertionError("the fine-tune step's starting_layer changed")
    model = CaptionModel(cfg, device=dev, seed=seed)
    gen = torch.Generator().manual_seed(seed + 5)
    with torch.no_grad():  # order-one layer scales, as in phases 3 and 5
        for blk in (m for m in model.modules() if hasattr(m, "layer_scale")):
            blk.layer_scale.copy_(0.1 * torch.rand(blk.layer_scale.shape, generator=gen))
    start = copy.deepcopy(model.state_dict())
    plain = CaptionModel(dataclasses.replace(cfg, **ALL_OFF), device=dev)
    batch = {k: v.to(dev) for k, v in train_batch(gen, word_map, VOCAB).items()}
    root = prng.root_seed(seed + 1)
    seeds = [prng.step_seed(root, "dropout", 0, i) for i in range(2)]

    def counts():
        return (random_mask_pool.launches, fused_convnext_mlp.launches, fused_convnext_mlp_bwd.launches,
                dwconv.launches, dwconv.grad_launches)

    def zero_counts():
        random_mask_pool.launches = fused_convnext_mlp.launches = fused_convnext_mlp_bwd.launches = 0
        dwconv.launches = dwconv.grad_launches = 0

    def two_steps(m, expect):
        m.load_state_dict(start)
        state = TrainState.create(m, tc)
        step = make_train_step(m, tc, word_map, train_encoder=True)
        out, grads, seen = [], [], []
        for s in seeds:
            zero_counts()
            state, met = step(state, batch, s)
            torch.cuda.synchronize()
            seen.append(counts())
            out.append({k: float(v) for k, v in met.items()})
            grads.append({k: p.grad.clone() for k, p in m.named_parameters() if p.grad is not None})
        if any(c != expect for c in seen):
            raise AssertionError(f"expected (dropout_mask, mlp_block, mlp_block_bwd, dwconv, dwconv_grad) "
                                 f"launches {expect} per step, got {seen}")
        return out, grads, {k: v.clone() for k, v in m.state_dict().items()}, seen[0]

    got, grads, params, launches = two_steps(model, (1, 36, 30, 65, 30))
    print(f"fine-tune step: {launches[0]} dropout_mask, {launches[1]} mlp_block, "
          f"{launches[2]} mlp_block_bwd, {launches[3]} dwconv (36 forwards + 29 input gradients), "
          f"{launches[4]} dwconv_grad launches per step")
    want, want_grads, want_params, _ = two_steps(plain, (1, 0, 0, 0, 0))
    for i, (a, b) in enumerate(zip(got, want)):
        print(f"fine-tune step {i}: kernels {a}; plain {b}")
        if not (abs(a["loss"] - b["loss"]) <= 1e-4 and a["top5_correct"] == b["top5_correct"]
                and a["tokens"] == b["tokens"] and math.isfinite(a["loss"])):
            raise AssertionError(f"fine-tune step {i}: kernel and plain paths disagree")
    if set(grads[0]) != set(want_grads[0]):
        raise AssertionError("the two paths trained different parameters")
    grad_err = max(((grads[0][k] - g).norm() / g.norm().clamp_min(1e-30)).item()
                   for k, g in want_grads[0].items())
    param_err, lr = 0.0, tc.encoder_lr
    for k, g0 in want_grads[0].items():
        g1 = want_grads[1][k]
        sure = (g0.abs() >= 1e-3 * g0.abs().max()) & (g1.abs() >= 1e-3 * g1.abs().max())
        err = (params[k] - want_params[k]).abs()[sure]
        param_err = max(param_err, err.max().item() if err.numel() else 0.0)
    print(f"fine-tune step 1 gradients, kernels vs plain: worst |d|/|plain| {grad_err:.3e} (tol 1e-3); "
          f"updated parameters: max abs diff {param_err:.3e} (tol {1e-2 * lr:g}) over "
          f"{len(want_grads[0])} tensors")
    if not (grad_err <= 1e-3 and param_err <= 1e-2 * lr):
        raise AssertionError("fine-tune gradients or updated parameters disagree between the two paths")
    changed = {}  # ConvNeXt child -> (tensors changed, tensors)
    for k, v in start.items():
        if k.startswith("encoder.convnext."):
            i = int(k.split(".")[2])
            n_changed, n = changed.get(i, (0, 0))
            changed[i] = (n_changed + (not torch.equal(params[k], v)), n + 1)
    print("encoder tensors changed per child (changed, all): " + str(dict(sorted(changed.items()))))
    if any((i >= FT_START) != (c > 0) or (i < FT_START and c) for i, (c, _) in changed.items()):
        raise AssertionError(f"children below {FT_START} must stay bit-identical and every child "
                             "from it on must change")
    del plain, want_grads, grads
    torch.cuda.empty_cache()

    # Steady-state time per step for each remat mode, and the plain copy's.
    results = {}
    runs = (("off", model), ("on", model), ("plain, off", None))
    for label, m in runs:
        if m is None:
            m = CaptionModel(dataclasses.replace(cfg, **ALL_OFF), device=dev)
        m.cfg = dataclasses.replace(m.cfg, encoder_remat=label.split(", ")[-1])
        m.load_state_dict(start)
        state = TrainState.create(m, tc)
        step = make_train_step(m, tc, word_map, train_encoder=True)
        for i in range(3):
            state, _ = step(state, batch, prng.step_seed(root, "dropout", 1, i))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(TRAIN_TIMED_STEPS):
            zero_counts()
            t0 = time.perf_counter()
            state, met = step(state, batch, prng.step_seed(root, "dropout", 2, i))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        if label == "on" and counts() != (1, 66, 30, 95, 30):  # the 30 trained blocks' forwards run twice
            raise AssertionError(f"remat 'on': expected (1, 66, 30, 95, 30) launches per step, got {counts()}")
        ms = sorted(times)[len(times) // 2]
        results[label] = ms
        print(f"fine-tune step bs={TRAIN_BS} starting_layer {FT_START}, "
              f"{'all kernels off' if label.startswith('plain') else 'kernels'}, remat {label.split(', ')[-1]!r}: "
              f"median {ms:.2f} ms/step over {TRAIN_TIMED_STEPS} steps (min {min(times):.2f}, "
              f"max {max(times):.2f}), {TRAIN_BS / (ms / 1e3):.1f} images/s, peak memory "
              f"{peak / 2**30:.2f} GiB; launches per step {counts()}; loss {float(met['loss']):.4f} [{card}]")
        if label == "off":
            state, groups, top = _kernel_ms_by_group(
                step, state, batch, [prng.step_seed(root, "dropout", 3, i) for i in range(2)])
            total = sum(groups.values())
            print(f"fine-tune step kernel time by group (torch.profiler, kernel rows, ms per step; "
                  f"total {total:.2f}): " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
                      groups.items(), key=lambda kv: -kv[1])) + f" [{card}]")
            for ms_k, name in top:
                print(f"  {ms_k:8.2f} ms/step  {name}")
            state, favoured = dwconv_ab(dev, card, m, step, state, batch, (
                prng.step_seed(root, "dropout", 4, i) for i in itertools.count()))
            set_dw(m, True, True)
        del state, step
        torch.cuda.empty_cache()
    return launches, favoured


EVAL_MODES = (  # (label, ModelConfig.decode_kernel, one_cell)
    ("off", "off", False), ("step", "step", False), ("one_cell", "step", True), ("mega", "mega", False),
)
LOGIT_TOL, ALPHA_TOL = 1e-4, 1e-5  # as DECODE_TOL's x and alpha: f32 sums in another order


def flagship_model(cfg, dev, seed):
    """The served model of phases 3, 4 and 7: random weights from ``seed``,
    order-one layer scales so that every MLP tail shows in the features, and
    a vocab head scaled x16 (peaked, as a trained captioner's) so that beam
    and argmax ties are improbable."""
    import torch

    from tpu_captioner_torch.train.model import CaptionModel

    model = CaptionModel(cfg, device=dev, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for blk in (m for m in model.modules() if hasattr(m, "layer_scale")):
            blk.layer_scale.copy_(0.1 * torch.rand(blk.layer_scale.shape, generator=gen))
        model.decoder.fc_out.weight.mul_(16.0)
    return model


def compare_rollouts(label, got, want):
    """Greedy rollouts (logits, seqs, alphas) against the plain one: per row
    equal tokens up to the first step where they differ, which must be a
    near-tie (the plain logits of the two tokens within TIE_GAP); logits and
    maps within LOGIT_TOL and ALPHA_TOL up to that step.  Returns (max logit
    error, max map error, rows that differ)."""
    import torch

    (gl, gs, ga), (wl, ws, wa) = got, want
    diff = gs != ws
    first = diff.int().argmax(dim=1)
    upto = torch.where(diff.any(dim=1), first + 1, ws.shape[1])
    keep = torch.arange(ws.shape[1], device=ws.device)[None, :] < upto[:, None]
    logit_err = ((gl - wl).abs() * keep[..., None]).max().item()
    alpha_err = ((ga - wa).abs() * keep[..., None]).max().item()
    ties = diff.any(dim=1).nonzero().flatten().tolist()
    for r in ties:
        s = int(first[r])
        gap = abs(wl[r, s, int(gs[r, s])] - wl[r, s, int(ws[r, s])]).item()
        print(f"{label}: row {r} differs from the plain rollout from step {s}; logit gap {gap:.3e}")
        if not gap < TIE_GAP:
            raise AssertionError(f"{label}: row {r} differs from the plain rollout beyond a near-tie")
    if not (logit_err < LOGIT_TOL and alpha_err < ALPHA_TOL):
        raise AssertionError(f"{label}: logits {logit_err} or maps {alpha_err} disagree with the plain rollout")
    return logit_err, alpha_err, ties


def rollout_bound(lengths, L, P, E, Fd, V, steps):
    """(bytes, ops) of a whole rollout whose rows ran ``lengths`` tokens,
    each input read once and each output written once: the layer weights,
    the vocab head, the memory K/V, the embedding and PE rows used, the
    (R, steps) logits, maps and tokens.  Operations: 2 per weight per row
    and token (layers and head), and the two attentions' scores and weighted
    sums."""
    R, row_steps = len(lengths), sum(lengths)
    attn = sum(L * 4 * E * (s + 1 + P) for n in lengths for s in range(n))
    n_ops = row_steps * 2 * (L * (6 * E * E + 2 * E * Fd) + E * V) + attn
    n_bytes = 4 * (L * (6 * E * E + 2 * E * Fd + 9 * E + Fd) + V * E + V + 2 * L * R * P * E
                   + row_steps * E + max(lengths) * E + R * steps * (V + P + 1))
    return n_bytes, n_ops


def eval_phase(dev, card, seed, word_map):
    """Phase 7: the greedy eval step at full width, batch 32, 51 steps, in
    the four decode modes, with the natural <end> and with an end id that
    rows emit.  Returns the one-cell and rollout kernels' launches and the
    rollout kernel's error, times and bound."""
    import torch

    from tpu_captioner_torch.core.config import ModelConfig, TrainConfig
    from tpu_captioner_torch.ops.decode_step import (
        _full_rollout_plain, fused_decode_step, fused_full_rollout, prepare_cross_memory,
        prepare_decode_weights,
    )
    from tpu_captioner_torch.ops.mlp_block import fused_convnext_mlp
    from tpu_captioner_torch.train.steps import make_eval_step

    cfg, tc = ModelConfig(vocab_size=VOCAB), TrainConfig(batch_size=TRAIN_BS)
    steps, L, E = tc.max_decode_len, cfg.num_layers, cfg.embed_dim
    model = flagship_model(cfg, dev, seed)
    dec = model.decoder
    dec.capture_alphas = True  # so that the rollouts below return their maps
    batch = {k: v.to(dev) for k, v in train_batch(torch.Generator().manual_seed(seed + 9), word_map, VOCAB).items()}
    start = word_map["<start>"]
    tokens = [0]
    embed = dec.embed

    def counted_embed(*a):  # one lookup per token in the rollouts that embed outside a kernel
        tokens[0] += 1
        return embed(*a)

    def run(mode, one_cell, ids):
        model.cfg = dataclasses.replace(cfg, decode_kernel=mode)
        step = make_eval_step(model, tc, ids, one_cell=one_cell)
        fused_convnext_mlp.launches = fused_decode_step.launches = 0
        fused_decode_step.onecell_launches = fused_full_rollout.launches = 0
        tokens[0] = 0
        dec.embed = counted_embed
        aux = step(batch)
        torch.cuda.synchronize()
        seen = (fused_convnext_mlp.launches, fused_decode_step.launches,
                fused_decode_step.onecell_launches, fused_full_rollout.launches)
        del dec.embed
        ran = int(fused_full_rollout.steps_run) if mode == "mega" else tokens[0]
        with torch.inference_mode():
            roll = model.rollout(model.encode(batch["images"]), start, ids["<end>"], steps, one_cell=one_cell)
        return step, aux, seen, ran, roll

    out = {}
    ids = word_map
    for end_label in ("natural", "emitted"):
        runs = {label: run(mode, one_cell, ids) for label, mode, one_cell in EVAL_MODES}
        plain = runs["off"]
        lengths = plain[1]["lengths"]
        need = int(lengths.max())  # every loop stops once all rows have finished
        for label, (_, aux, seen, ran, roll) in runs.items():
            expect = {"off": (36, 0, 0, 0), "step": (36, L * need, 0, 0),
                      "one_cell": (36, 0, need, 0), "mega": (36, 0, 0, 1)}[label]
            print(f"eval ({end_label} <end> = {ids['<end>']}) {label}: launches (mlp_block, decode_step, "
                  f"decode_onecell, decode_rollout) {seen}, {ran} tokens run, "
                  f"{int((aux['lengths'] < steps).sum())} of {TRAIN_BS} rows finished before step {steps}; "
                  f"loss {float(aux['loss']):.6f}, tokens {int(aux['tokens'])}, top5 {int(aux['top5_correct'])}")
            if seen != expect or ran != need:
                raise AssertionError(f"{label}: expected launches {expect} and {need} tokens, got {seen}, {ran}")
            if not (torch.isfinite(roll[0]).all() and aux["sequences"].shape == (TRAIN_BS, steps)
                    and math.isfinite(float(aux["loss"]))):
                raise AssertionError(f"{label}: malformed eval output")
            if label == "off":
                continue
            logit_err, alpha_err, ties = compare_rollouts(label, roll, plain[4])
            print(f"  {label} vs off: logits {logit_err:.3e} (tol {LOGIT_TOL:g}), maps {alpha_err:.3e} "
                  f"(tol {ALPHA_TOL:g}), {len(ties)} rows differ at a near-tie")
            if ties:
                print(f"  {label}: loss and counts not compared (a near-tie changed a sequence)")
                continue
            rel = abs(float(aux["loss"]) - float(plain[1]["loss"])) / abs(float(plain[1]["loss"]))
            same = all(torch.equal(aux[k], plain[1][k]) for k in ("sequences", "lengths", "tokens", "top5_correct"))
            if not (rel < 1e-4 and same):
                raise AssertionError(f"{label}: eval metrics disagree with the plain mode (loss rel {rel})")
        if end_label == "natural":
            out["launches"] = {k: v[2] for k, v in runs.items()}
            for label, mode, one_cell in EVAL_MODES:
                step = runs[label][0]
                model.cfg = dataclasses.replace(cfg, decode_kernel=mode)
                with torch.inference_mode():
                    enc_ms, enc = _host_ms(lambda: model.encode(batch["images"]))
                    roll_ms, _ = _host_ms(lambda: model.rollout(enc, start, ids["<end>"], steps, one_cell=one_cell))
                eval_ms, _ = _host_ms(lambda: step(batch))
                print(f"eval bs={TRAIN_BS} {label}: encoder {enc_ms:.2f} ms, rollout {roll_ms:.2f} ms "
                      f"({runs[label][3]} tokens), eval step {eval_ms:.2f} ms [{card}]")
            # The next end id: one every row emits if there is one (of those,
            # the one whose rows finish at the most different steps), else
            # the most frequent token (never <pad>), so that rows finish early.
            seqs = plain[1]["sequences"].long()
            in_all = [v for v in range(1, VOCAB) if bool((seqs == v).any(dim=1).all())]
            if in_all:
                firsts = {v: (seqs == v).int().argmax(dim=1).tolist() for v in in_all}
                end_id = min(firsts, key=lambda v: (-len(set(firsts[v])), max(firsts[v])))
            else:
                end_id = int(torch.bincount(seqs.flatten(), minlength=VOCAB)[1:].argmax()) + 1
            ids = dict(word_map, **{"<end>": end_id})
        elif not bool((lengths < steps).any()):
            raise AssertionError(f"no row finished before step {steps} with <end> = {ids['<end>']}")

    # The rollout kernel against its plain version on this batch's memory,
    # with the natural <end>, and CUDA-event times of both.
    with torch.inference_mode():
        mem = dec.project_memory(model.encode(batch["images"]))
        w = prepare_decode_weights(dec.layers, E)
        mk, mv = prepare_cross_memory(dec.layers, mem, E)
        args = (w, dec.embedding.weight, dec.fc_out.weight, dec.fc_out.bias, dec.pe, mk, mv,
                start, word_map["<end>"], steps, cfg.num_heads)
        got, want = fused_full_rollout(*args), _full_rollout_plain(*args)
        logit_err, alpha_err, _ = compare_rollouts("decode_rollout kernel", got, want)
        ends = want[1] == word_map["<end>"]
        lengths = torch.where(ends.any(dim=1), ends.int().argmax(dim=1) + 1, steps).tolist()
        t_kernel = _time_ms(lambda: fused_full_rollout(*args), iters=5, warmup=1)
        t_plain = _time_ms(lambda: _full_rollout_plain(*args), iters=2, warmup=1)
    bound_ms, bound_by = bound(*rollout_bound(lengths, L, 49, E, cfg.decoder_dim, VOCAB, steps))
    print(f"decode_rollout R={TRAIN_BS} steps={steps} ({max(lengths)} run): max_abs_err logits {logit_err:.3e}, "
          f"maps {alpha_err:.3e}; kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms per rollout, "
          f"bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
    out["rollout"] = (max(logit_err, alpha_err), t_kernel, t_plain, bound_ms, bound_by)
    return out


def word_map_of(vocab):
    wm = {"<pad>": 0}
    wm.update({f"w{i}": i for i in range(1, vocab - 3)})
    wm.update({"<unk>": vocab - 3, "<start>": vocab - 2, "<end>": vocab - 1})
    return wm


def prefix_logprob(model, enc_out_1, seq):
    """Cumulative log-prob of token sequence ``seq`` (starting with <start>)
    under ``model``'s plain decode step: a beam candidate's score."""
    import torch

    dec = model.decoder
    memory = dec.precompute_memory(enc_out_1)
    cache = dec.init_cache(1, len(seq))
    total = 0.0
    for pos in range(len(seq) - 1):
        logits, cache, _ = dec.decode_step(seq[pos : pos + 1], pos, cache, memory)
        total += torch.log_softmax(logits.float(), -1)[0, seq[pos + 1]].item()
    return total


def compare_captions(got, want, plain_model, images):
    """Equal captions with scores within SCORE_TOL, or a near-tie: at the
    first differing token the two candidates' prefix scores differ by less
    than TIE_GAP.  ``got``/``want`` are ``caption_batch`` results."""
    import torch

    for j, ((_, ks, kseq, _), (_, ps, pseq, _)) in enumerate(zip(got, want)):
        if len(kseq) == len(pseq) and (kseq == pseq).all():
            if not abs(ks - ps) < SCORE_TOL:
                raise AssertionError(f"image {j}: equal captions, scores differ by {abs(ks - ps)}")
            continue
        n = min(len(kseq), len(pseq))
        step = next((i for i in range(n) if kseq[i] != pseq[i]), n)
        with torch.inference_mode():
            enc = plain_model.encode(images[j : j + 1])
            a = prefix_logprob(plain_model, enc, torch.as_tensor(kseq[: step + 1], device=enc.device))
            b = prefix_logprob(plain_model, enc, torch.as_tensor(pseq[: step + 1], device=enc.device))
        print(f"image {j}: captions differ from step {step}; candidate score gap {abs(a - b):.3e}")
        if not abs(a - b) < TIE_GAP:
            raise AssertionError(f"image {j}: kernel and plain captions differ beyond a near-tie")


def served_width(dev, model, images8, word_map):
    """Phase 4 at word2vec-300's width (E=300, H=6; ``check_widths``'s
    model): beam 5 over the 8 images with the kernels (36 MLP launches, L
    decode launches per token), then through the plain versions on the card;
    the captions must agree except at a near-tie."""
    import numpy as np
    import torch

    from tpu_captioner_torch.cli.caption import caption_batch
    from tpu_captioner_torch.ops.decode_step import fused_decode_step
    from tpu_captioner_torch.ops.mlp_block import fused_convnext_mlp
    from tpu_captioner_torch.train.model import CaptionModel

    cfg = model.cfg
    plain = CaptionModel(dataclasses.replace(cfg, **ALL_OFF), device=dev)
    plain.load_state_dict(model.state_dict())
    tokens = [0]
    embed = model.decoder.embed

    def counted_embed(*a):
        tokens[0] += 1
        return embed(*a)

    model.decoder.embed = counted_embed
    fused_convnext_mlp.launches = fused_decode_step.launches = 0
    got = caption_batch(model, images8.numpy(), word_map, BEAM)
    torch.cuda.synchronize()
    seen = (fused_convnext_mlp.launches, fused_decode_step.launches)
    del model.decoder.embed
    if seen != (36, cfg.num_layers * tokens[0]) or tokens[0] < 1:
        raise AssertionError(f"E={cfg.embed_dim}: expected 36 mlp_block and {cfg.num_layers} decode launches "
                             f"per token ({tokens[0]} tokens), got {seen}")
    want = caption_batch(plain, images8.numpy(), word_map, BEAM)
    for _, score, seq, alpha in got:
        if not (alpha.shape == (len(seq), cfg.num_pixels) and np.isfinite(alpha).all() and np.isfinite(score)):
            raise AssertionError("malformed caption output")
    compare_captions(got, want, plain, images8.to(dev))
    print(f"beam-{BEAM} at E={cfg.embed_dim}, H={cfg.num_heads}: {seen[1]} decode_step launches over "
          f"{tokens[0]} tokens; kernel vs plain captions agree on {len(got)} images")


def eval_width(dev, card, model, word_map):
    """Phase 7 at GloVe-200's width (E=200, H=8; ``check_widths``'s model):
    one eval step at batch 32 in 'step' and 'mega' against 'off', with an
    end id that the plain rollout's rows emit: launches counted, rollouts
    compared as in ``compare_rollouts``, and, without a near-tie, the loss
    within 1e-4 relative and the sequences, lengths and counts equal."""
    import torch

    from tpu_captioner_torch.core.config import TrainConfig
    from tpu_captioner_torch.ops.decode_step import fused_decode_step, fused_full_rollout
    from tpu_captioner_torch.train.steps import make_eval_step

    cfg, tc = model.cfg, TrainConfig(batch_size=TRAIN_BS)
    steps, L = tc.max_decode_len, cfg.num_layers
    model.decoder.capture_alphas = True  # so that the rollouts below return their maps
    batch = {k: v.to(dev) for k, v in train_batch(torch.Generator().manual_seed(cfg.embed_dim), word_map,
                                                   VOCAB).items()}
    model.cfg = dataclasses.replace(cfg, decode_kernel="off")
    first = make_eval_step(model, tc, word_map)(batch)
    end_id = int(torch.bincount(first["sequences"].flatten().long(), minlength=VOCAB)[1:].argmax()) + 1
    ids = dict(word_map, **{"<end>": end_id})
    runs = {}
    for mode in ("off", "step", "mega"):
        model.cfg = dataclasses.replace(cfg, decode_kernel=mode)
        fused_decode_step.launches = fused_full_rollout.launches = 0
        t0 = time.perf_counter()
        aux = make_eval_step(model, tc, ids)(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        seen = (fused_decode_step.launches, fused_full_rollout.launches)
        with torch.inference_mode():
            roll = model.rollout(model.encode(batch["images"]), word_map["<start>"], end_id, steps)
        runs[mode] = (aux, roll, seen)
        need = int(runs["off"][0]["lengths"].max())
        expect = {"off": (0, 0), "step": (L * need, 0), "mega": (0, 1)}[mode]
        print(f"eval E={cfg.embed_dim} H={cfg.num_heads} <end> = {end_id} {mode}: launches (decode_step, "
              f"decode_rollout) {runs[mode][2]}, {int((aux['lengths'] < steps).sum())} of {TRAIN_BS} rows "
              f"finished early; loss {float(aux['loss']):.6f}; eval step {ms:.2f} ms [{card}]")
        if runs[mode][2] != expect or not torch.isfinite(roll[0]).all():
            raise AssertionError(f"eval at E={cfg.embed_dim} {mode}: expected launches {expect}, "
                                 f"got {runs[mode][2]}, or non-finite logits")
        if mode == "off":
            continue
        logit_err, alpha_err, ties = compare_rollouts(f"eval E={cfg.embed_dim} {mode}", roll, runs["off"][1])
        print(f"  {mode} vs off: logits {logit_err:.3e}, maps {alpha_err:.3e}, {len(ties)} rows differ at a "
              f"near-tie")
        if ties:
            continue
        want = runs["off"][0]
        rel = abs(float(aux["loss"]) - float(want["loss"])) / abs(float(want["loss"]))
        same = all(torch.equal(aux[k], want[k]) for k in ("sequences", "lengths", "tokens", "top5_correct"))
        if not (rel < 1e-4 and same):
            raise AssertionError(f"eval at E={cfg.embed_dim} {mode}: metrics disagree with 'off' (loss rel {rel})")
    model.cfg = cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from tpu_captioner_torch.cli.caption import build_model_and_params, caption_batch
    from tpu_captioner_torch.core.backend import device_info, pin_f32_precision, require_cuda
    from tpu_captioner_torch.core.config import ModelConfig
    from tpu_captioner_torch.infer.beam import beam_search_encoded
    from tpu_captioner_torch.models.from_jax import save_reference_checkpoint
    from tpu_captioner_torch.ops import _build
    from tpu_captioner_torch.ops.decode_step import fused_decode_step
    from tpu_captioner_torch.ops.dwconv import depthwise_conv7x7_nhwc
    from tpu_captioner_torch.ops.mlp_block import fused_convnext_mlp
    from tpu_captioner_torch.train.model import CaptionModel

    # 1. The card.
    dev = require_cuda()
    card = device_info()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    pin_f32_precision()

    # 2. Build the kernels, one nvcc each, all at once.
    names = ("mlp_block", "mlp_block_bwd", "decode_step", "dropout_mask", "dwconv")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(_build.build, names)))
    print(f"built {len(names)} kernels in {time.perf_counter() - t0:.2f} s")
    for name, path in paths.items():
        _build.load(name)
        print(f"built {name}.cu -> {os.path.relpath(path, ROOT)}")
        log = path.with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else []:
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    # 3. Kernels against their plain versions.
    cfg = ModelConfig(vocab_size=VOCAB)
    model = flagship_model(cfg, dev, args.seed)
    mlp_err, mlp_ms, mlp_plain_ms, mlp_bound, mlp_by = check_mlp(dev, card)
    # The per-layer kernel at the beam's rows, the one-cell kernel at the
    # greedy eval's.
    dec_err, dec_ms, dec_plain_ms, dec_bound, dec_by = check_decode(
        dev, card, model.decoder.layers, DECODE_ROWS)["decode_step"]
    one_err, one_ms, one_plain_ms, one_bound, one_by = check_decode(
        dev, card, model.decoder.layers, TRAIN_BS)["decode_onecell"]
    pool_err, pool_ms, pool_plain_ms, pool_lib_ms, pool_bound, pool_by = check_dropout(dev, card)
    bwd_err, bwd_ms, bwd_plain_ms, bwd_bound, bwd_by = check_mlp_bwd(dev, card)
    dw = check_dwconv(dev, card)
    width_models = check_widths(dev, card, args.seed)

    # 4. The serving path through the CLI's loader, kernels on.
    word_map = word_map_of(VOCAB)
    rng = torch.Generator().manual_seed(args.seed + 1)
    images8 = torch.randint(0, 256, (8, 256, 256, 3), generator=rng, dtype=torch.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "BEST_checkpoint_smoke.pth.tar")
        save_reference_checkpoint(model, ckpt, epoch=0)
        cli = argparse.Namespace(checkpoint=ckpt, decoder=None, lstmDecoder=False,
                                 embeddingName=None, device="cuda", seed=args.seed + 7)
        served = build_model_and_params(cli, word_map)
    plain = CaptionModel(
        dataclasses.replace(served.cfg, **ALL_OFF), device=dev
    )
    plain.load_state_dict(served.state_dict())
    sd_want = model.state_dict()
    if not all(torch.equal(v, sd_want[k]) for k, v in served.state_dict().items()):
        raise AssertionError("checkpoint round trip changed the weights")

    steps = [0]
    embed = served.decoder.embed

    def counted_embed(*a):  # one embedding lookup per generated token
        steps[0] += 1
        return embed(*a)

    served.decoder.embed = counted_embed
    fused_convnext_mlp.launches = fused_decode_step.launches = depthwise_conv7x7_nhwc.launches = 0
    got = caption_batch(served, images8.numpy(), word_map, BEAM)
    torch.cuda.synchronize()
    mlp_launches, dec_launches = fused_convnext_mlp.launches, fused_decode_step.launches
    del served.decoder.embed
    print(f"main path: {mlp_launches} mlp_block and {depthwise_conv7x7_nhwc.launches} dwconv launches "
          f"(1 encoder pass), {dec_launches} decode_step launches over {steps[0]} tokens x {cfg.num_layers} layers")
    if (mlp_launches, depthwise_conv7x7_nhwc.launches) != (36, 36):
        raise AssertionError(f"expected 36 mlp_block and 36 dwconv launches per encoder pass, got "
                             f"{mlp_launches} and {depthwise_conv7x7_nhwc.launches}")
    if steps[0] < 1 or dec_launches != cfg.num_layers * steps[0]:
        raise AssertionError(f"expected {cfg.num_layers} decode launches per token")

    want = caption_batch(plain, images8.numpy(), word_map, BEAM)
    for cap, score, seq, alpha in got:
        if not (seq[0] == word_map["<start>"] and alpha.shape == (len(seq), cfg.num_pixels)
                and np.isfinite(alpha).all() and np.isfinite(score)):
            raise AssertionError("malformed caption output")
    compare_captions(got, want, plain, images8.to(dev))
    for j, (cap, score, seq, _) in enumerate(got[:2]):
        print(f"caption {j} (score {score:.4f}, {len(seq)} tokens): {cap[:80]}")
    print(f"beam-{BEAM} kernel vs plain on the card: captions agree on 8 images")
    served_width(dev, width_models[300], images8, word_map)

    # Serving times, kernels on and off.
    for bs in (8, 32):
        imgs = torch.randint(0, 256, (bs, 256, 256, 3), generator=rng, dtype=torch.uint8).to(dev)
        for label, m in (("kernels", served), ("plain", plain)):
            m.encode(imgs)  # warm-up
            enc_ms, enc = _host_ms(lambda: m.encode(imgs))
            beam_ms, _ = _host_ms(lambda: beam_search_encoded(
                m, enc, beam_size=BEAM, max_steps=MAX_STEPS,
                start_id=word_map["<start>"], end_id=word_map["<end>"]))
            print(f"serve bs={bs} {label}: encoder {enc_ms:.2f} ms, beam {beam_ms:.2f} ms, "
                  f"{bs / ((enc_ms + beam_ms) / 1e3):.2f} captions/s [{card}]")

    # 5. The frozen-encoder train step at full width.
    del served, plain, model, width_models[300]
    torch.cuda.empty_cache()
    pool_launches, _ = train_phase(dev, card, args.seed, word_map)

    # 6. The fine-tune train step at full width.
    torch.cuda.empty_cache()
    ft_launches, favoured = finetune_phase(dev, card, args.seed, word_map)
    bwd_launches, dw_launches, dw_grad_launches = ft_launches[2:]

    # 7. The greedy eval step at full width, in four decode modes.
    torch.cuda.empty_cache()
    ev = eval_phase(dev, card, args.seed, word_map)
    roll_err, roll_ms, roll_plain_ms, roll_bound, roll_by = ev["rollout"]
    eval_width(dev, card, width_models.pop(200), word_map)
    print("depthwise-conv A/B (kernel favoured: median gain > spread of the pairs): " + ", ".join(
        f"{k}: {v}" for k, v in favoured.items()))

    # mlp_block's launches: one serving encoder pass; the train and eval
    # paths' 36 per step were checked in phases 5 to 7.  dropout_mask's: one
    # per train step.  mlp_block_bwd's, dwconv's and dwconv_grad's: one
    # fine-tune step.  decode_onecell's and decode_rollout's: one eval step in
    # their modes, natural <end>.
    print(json.dumps({"kernels": [
        {"name": "mlp_block", "route": "cuda", "source": "tpu_captioner_torch/csrc/mlp_block.cu",
         "replaces": "tpu_captioner/ops/mlp_block.py:126", "launches": mlp_launches,
         "max_abs_err": mlp_err, "ms": mlp_ms, "plain_ms": mlp_plain_ms,
         "bound_ms": mlp_bound, "bound_by": mlp_by, "library_ms": None},
        {"name": "mlp_block_bwd", "route": "cuda", "source": "tpu_captioner_torch/csrc/mlp_block_bwd.cu",
         "replaces": "tpu_captioner/ops/mlp_block.py:275", "launches": bwd_launches,
         "max_abs_err": bwd_err, "ms": bwd_ms, "plain_ms": bwd_plain_ms,
         "bound_ms": bwd_bound, "bound_by": bwd_by, "library_ms": None},
        {"name": "decode_step", "route": "cuda", "source": "tpu_captioner_torch/csrc/decode_step.cu",
         "replaces": "tpu_captioner/ops/decode_step.py:185", "launches": dec_launches,
         "max_abs_err": dec_err, "ms": dec_ms, "plain_ms": dec_plain_ms,
         "bound_ms": dec_bound, "bound_by": dec_by, "library_ms": None},
        {"name": "dropout_mask", "route": "cuda", "source": "tpu_captioner_torch/csrc/dropout_mask.cu",
         "replaces": "tpu_captioner/ops/dropout_mask.py:39", "launches": pool_launches,
         "max_abs_err": pool_err, "ms": pool_ms, "plain_ms": pool_plain_ms,
         "bound_ms": pool_bound, "bound_by": pool_by, "library_ms": pool_lib_ms},
        {"name": "decode_onecell", "route": "cuda", "source": "tpu_captioner_torch/csrc/decode_step.cu",
         "replaces": "tpu_captioner/ops/decode_step.py:271", "launches": ev["launches"]["one_cell"][2],
         "max_abs_err": one_err, "ms": one_ms, "plain_ms": one_plain_ms,
         "bound_ms": one_bound, "bound_by": one_by, "library_ms": None},
        {"name": "decode_rollout", "route": "cuda", "source": "tpu_captioner_torch/csrc/decode_step.cu",
         "replaces": "tpu_captioner/ops/decode_step.py:570", "launches": ev["launches"]["mega"][3],
         "max_abs_err": roll_err, "ms": roll_ms, "plain_ms": roll_plain_ms,
         "bound_ms": roll_bound, "bound_by": roll_by, "library_ms": None},
        *({"name": name, "route": "cuda", "source": "tpu_captioner_torch/csrc/dwconv.cu",
           "replaces": replaces, "launches": launches, "max_abs_err": dw[name][0], "ms": dw[name][1],
           "plain_ms": dw[name][2], "bound_ms": dw[name][4], "bound_by": dw[name][5],
           "library_ms": dw[name][3]}
          for name, replaces, launches in (
              ("dwconv", "tpu_captioner/ops/dwconv.py:37", dw_launches),
              ("dwconv_grad", "tpu_captioner/ops/dwconv.py:97", dw_grad_launches))),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
