#!/usr/bin/env python3
"""Drive the PyTorch port (``tpu_captioner_torch``) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the CUDA kernels from the seven sources in
   ``tpu_captioner_torch/csrc`` (one nvcc per source, all started together;
   ``decode_step.cu`` holds three kernels, ``dwconv.cu`` two, ``mlp_block.cu``
   the whole-tile path and the sub-tiled fused kernel; ``mlp_block.cu``,
   ``mlp_block_bwd.cu`` and ``block_fused.cu`` take their products from
   the tensor cores through ``csrc/tf32x3_gemm.cuh``);
3. hold each kernel against its plain PyTorch version at the main paths'
   shapes, with CUDA-event times of both and the least time the card could
   take (``bound_ms``): the fused ConvNeXt MLP tail at the four
   ConvNeXt-Base stages at batch 8 (serving) and 32 (the train step), with
   all-one and with stochastic-depth row scales (0 and 1/survival); the
   per-layer decode step at 8 images x beam 5 = 40 rows and 32 x 5 = 160
   rows and the one-cell step at the greedy eval's 32 rows, cache length
   52, each also against the other, after the cost of one grid barrier of
   their cooperative launch (``scripts/decode_barrier_probe.py``); the
   dropout mask pool at the flagship train
   step's 29,366,272 bits for three seeds, whose bits must be identical,
   beside ``Tensor.bernoulli_`` as the library yardstick, timed by CUDA-graph
   replay, with a bound from the library's own instruction mix; the MLP-tail
   backward at the fine-tune step's shapes (N = 8192 at C = 512, N = 2048 at
   C = 1024, batch 32, stochastic-depth rows) and at a ragged N = 600; the
   depthwise conv's forward kernel at the four stage shapes at batch 8 and
   32, with the block's bias and without, its input gradient (the flipped
   filter) and its filter-gradient kernel, with the bias gradient and
   without, at the fine-tune step's trained stages, beside
   ``F.conv2d(groups=C)`` and ``aten.convolution_backward`` as the library
   yardsticks; the LSTM step at the bs-8 beam's 40 rows, the bs-32 beam's
   160 and the eval step's 32, at E = D = A = 512, C = 1024, and at E=300,
   a second call bit for bit, with device (CUDA-graph replay), eager,
   L2-cold and host times;
   then the three decode kernels at the reference's
   pretrained-embedding widths, GloVe-200 (E=200, H=8) and word2vec-300
   (E=300, H=6), whose head widths 25 and 50 take the scalar key loads; the
   whole-block kernel (``use_pallas='block'``: the conv + LayerNorm launch
   and the 3xTF32 products) at the four stage shapes at batch 8 and 32,
   with all-one and per-image scales, at a ragged (3, 14, 14, 512) and at
   (2, 9, 7, 128), timed by CUDA-graph replay, its library's SASS holding
   tensor-core (HGMMA) and TMA (UTMALDG) instructions; the MLP tail's
   sub-tiled kernel (``TPU_CAPTIONER_MLP_SUB=64``: one launch that keeps h
   on chip, whose library must hold HGMMA and UTMALDG too) at the four
   stage shapes at batch 8 and 32 against the whole-tile path and the plain
   version, rows with scale 0 bit for bit, two calls bit for bit, timed by
   CUDA-graph replay beside the whole-tile path;
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
   E=200, H=8 (GloVe-200's width) in 'step' and 'mega' against 'off';
8. the LSTM families at full width: ConvNeXt-Base + ``lstm`` with E = D = A
   = 512, vocab 9490, random weights from a seed (the vocab head scaled as
   in phase 4), ``decode_kernel='on'``.  (a) Beam 5, 50 steps, over phase
   4's 8 images through the CLI's loader (``--lstmDecoder``): 36 MLP and 36
   dwconv launches and one lstm_step launch per beam step; the captions must
   equal an every-kernel-off copy's, except at a near-tie; encoder ms, beam
   ms and captions/s at batch 8 and 32; then ``lstm_no_attention`` once
   through the loader, with no lstm_step launch.  (b) The greedy eval step at
   batch 32, 51 steps, kernel against 'off', as in phase 7, with the
   doubly stochastic term in the loss, with the natural <end> and with one
   the rows emit.  (c) The frozen train step of phase 5 on ``lstm`` (one
   pool launch of 835,584 bits).  (d) The paired A/B that decides whether
   ``'auto'`` takes the LSTM step kernel: bs-8 beam and bs-32 eval step.
9. ``use_pallas='block'`` on phase 4's flagship weights: (a) beam 5 x 50 at
   batch 8 through the CLI's loader (``--usePallas block``), 36 block
   launches and no MLP-forward or dwconv launch per encoder pass, captions
   equal to an every-kernel-off copy's (near-tie rule), serving times at
   batch 8 and 32; (b) the eval step at batch 32 in 'step' against 'off'
   (phase 7's rules); (c) two frozen steps against 'on' on the same pool
   bits, loss and top-5 within 1e-5; (d) two fine-tune steps (remat 'off')
   against an every-kernel-off copy (phase 6's rules), launches (1 pool, 36
   block, 30 MLP backward, 59 dwconv, 30 dwconv_grad) counted, ms per step
   and peak memory; (e) the default model with TPU_CAPTIONER_MLP_SUB=64:
   sub-tiled launches at all four widths, captions equal to the whole-tile
   run's; (f) recorded paired A/Bs of bs-32 encoder passes, 'block' against
   'on' and sub-tiled against whole-tile.
10. the training entry point at full width (``training_phase``): (a) a
   learnable synthetic dataset (``data/build.py``) at 256x256, TRAIN 64,
   VAL 32, TEST 32 images, whose word map has the 9490 entries of phase 4;
   (b) ``cli.train`` through ``main``, batch 32, one free-running epoch:
   36 mlp_block and 36 dwconv launches and no pool per step, L decode_step
   launches per token of validation; a finite loss, the checkpoint, its
   BEST_ copy and the CSV; (c) the Trainer over two teacher-forced epochs
   with ``fine_tune_epoch=1``: 1 pool launch per frozen step, (1, 36, 30,
   65, 30) per fine-tune step as phase 6, children 0-4 unchanged; then a
   resume from the epoch-0 checkpoint whose two Adam states equal the
   saved ones; (d) ``cli.test`` on (b)'s checkpoint; (e) two free-running
   frozen steps against an every-kernel-off copy: losses within 1e-4,
   parameters within 1e-2 x lr; (f) ms per free-running step, images/s,
   peak memory, the device's idle share of a step (a profiler window), the
   Trainer's batch and data times.  Validation in (b) and (c) raises the
   head's bias on one caption word by ``EVAL_MARGIN``, so each of its
   rollouts runs all 51 tokens (L x 51 decode_step launches an eval step)
   and its BLEU-1 must equal the one counted from the records
   (``one_word_bleu1``); (e) compares the rollouts under phase 7's near-tie
   rule.
11. ``compute_dtype='bfloat16'`` serving (``check_bf16_kernels``,
   ``bf16_phase``): (a) the three bf16 instances against their plain
   versions at the flagship's shapes, each bf16 output within one bf16 ulp
   of the plain value and the decode arm's f32 x_out and alpha within
   2e-3 x max(1, max |plain|): the depthwise conv's forward (with the
   block's bias and without) and the MLP tail at the four stages at batch 8
   and 32, timed by CUDA-graph replay beside ``F.conv2d(groups=C)`` in
   bf16; the per-layer decode step's bf16 arm at 40, 160, 32 and 5 rows,
   cache length 52, four positions, timed by CUDA-graph replay beside
   CUDA-event times of eager calls; (b) a bf16 flagship
   saved with ``save_checkpoint`` and loaded through ``cli.caption``'s
   loader, beam 5 x 50 at batch 8 and 32 through ``caption_batch``: the
   bf16 instances' launches (36 + 36 per encoder pass, L per token), the
   captions against the all-plain bf16 path's (``plain_versions``: every
   kernel wrapper replaced by its plain version on the card) at that
   path's noise floor (``bf16_agree``: the plain decode against itself with
   f64 sums), the share equal to the f32 model's reported; encoder ms, beam
   ms and captions/s beside the f32 model's, the weights' casts alone; (c)
   the eval step at batch 32, 51 tokens, 'step' against the all-plain path
   with phase 7's rules at the noise floor's tolerances, and against 'off'
   (the f32 plain decode) reported.  The decode arm's six-layer step is held
   to the same noise floor, each of its layer launches to 2e-3 and one ulp.
12. ``compute_dtype='bfloat16'`` training (``check_bf16_train_kernels``,
   ``bf16_train_phase``, ``bf16_entry_phase``): (a) the MLP tail's bf16
   backward at the fine-tune step's shapes (N = 8192 at C = 512, N = 2048
   at C = 1024, sd rows of 0 and 1/survival) and at a ragged N = 600, d_x
   within one bf16 ulp of the plain version and the f32 gradients within
   1e-4 x max(1, max |plain|); the depthwise conv's bf16 filter and bias
   gradient (1e-4, the same bits twice) and its bf16 input gradient (the
   forward instance with the filter flipped, one ulp) at stages 3 and 4,
   batch 32; device times by CUDA-graph replay beside the plain versions,
   the f32 instances on the widened inputs and ``aten.convolution_backward``
   / ``F.conv2d`` in bf16; (b) the full-width bf16 frozen and fine-tune
   steps at batch 32 against the same steps with every kernel wrapper
   replaced by its plain version (``plain_versions``) and against the f32
   steps on the same weights, pool bits and stochastic-depth rows: per
   trained tensor the kernels within a quarter of all-plain bf16's distance
   from f32 or within twice the noise floor (all-plain with the encoder's
   sums in f64 against all-plain), losses within 1e-3 relative, the
   parameters after Adam's first step within 1e-2 x lr above the noise,
   children 0-4 unchanged, launches
   (1, 36, 0, 36, 0) and (1, 36, 30, 65, 30) per step (pool, bf16 MLP
   forward, backward, dwconv, filter gradient); ms per step and peak memory
   beside f32's, a profiler window, and the paired remat A/B that decides
   ``finetune_encoder_remat('auto', 'bfloat16')``; (c) ``cli.train
   --computeDtype bfloat16`` (one free-running epoch) and the Trainer (two
   teacher-forced epochs, the unlock at 1) on phase 10's synthetic data,
   every step's launches and validation's bf16 decode launches counted,
   ``meta.json`` saying bfloat16, then ``cli.caption``'s loader and
   ``cli.test`` on the checkpoint.
13. bf16 in the decoders (``check_bf16_lstm``, ``check_bf16_decode_modes``,
   ``bf16_lstm_serve``, ``bf16_eval_modes``, ``bf16_lstm_train``): (a) the
   LSTM step's bf16 instance at 40, 160 and 32 rows (E = D = A = 512, C =
   1024, P = 49) and at 40 rows with E = 300 against its plain version
   (alpha within 1e-5, h and c within the larger of 2e-3 x max(1, max
   |plain|) and twice the noise floor, the plain version with f64 sums
   against it; a second call bit for bit), the one-cell bf16 instance at 32
   rows equal to the per-layer bf16 launches bit for bit, the rollout's
   bf16 instance at 32 rows over 51 tokens against its plain version under
   phase 11's noise-floor rules; device times and bounds; (b) bf16 ``lstm``
   (decode kernel on) and ``lstm_no_attention`` beams 5 x 50 at batch 8 and
   32, each bf16 instance's launches counted, the captions held to the
   all-plain bf16 path by phase 11's lock-step replay, captions/s beside
   the f32 models'; (c) the eval step at batch 32, 51 tokens, of a bf16
   Transformer in ``'mega'`` and one-cell and of a bf16 ``lstm`` in
   ``'on'``, against the all-plain bf16 path at its noise floor, reported
   against ``'off'``, eval-step ms beside f32's; (d) the bf16 ``lstm``
   frozen and fine-tune teacher-forced steps and its free-running frozen
   step against all-plain under phase 12b's rules, then ``cli.train
   --computeDtype bfloat16 --decoder lstm`` for one epoch, ``cli.caption``'s
   loader and ``cli.test`` on its checkpoint.
14. the last bf16 instances, ``use_pallas='block'`` and the sub-tiled MLP
   tail (``check_bf16_block_kernels``, ``bf16_block_serve``,
   ``bf16_block_train``): (a) the bf16 whole-block instance and the bf16
   sub-tiled tail against their plain versions at the four stages at batch
   8 and 32, within one bf16 ulp (the sub-tiled one also of the whole-tile
   bf16 instance), device times by CUDA-graph replay beside the plain
   versions and the f32 instances, per launch and per encoder pass; (b) a
   bf16 'block' flagship saved with ``save_checkpoint`` and served through
   ``cli.caption``'s loader, beam 5 x 50 at batch 8 and 32 beside the same
   checkpoint in 'mlp', 36 bf16 block launches a pass, the captions held to
   the all-plain bf16 'block' path by phase 11's lock-step rule; the eval
   step at batch 32 against all-plain; (c) the bf16 'block' frozen and
   fine-tune steps at batch 32 against all-plain by phase 12b's rules, ms
   per step, peak memory and launches per step; (d) a bf16 encoder pass and
   a fine-tune step with ``TPU_CAPTIONER_MLP_SUB=64`` (36 sub-tiled bf16
   launches each) and a bf16 per-stage mix ('mlp', 'mlp', 'block', 'block').
15. the rest of what a one-card user of the JAX package has, on phase 10's
   records and ``BEST_`` checkpoint (``native_phase``, ``one_image_phase``,
   ``trace_phase``, ``backbone_phase``): (a) the native host runtime
   (``native/``) built from the checkout, its BLEU equal to the pure-Python
   scorer's on a 25,000-hypothesis corpus and its gather equal to numpy's
   at batch 32 on the memmapped records, host times of both; (b) the
   one-image caption: the MLP tail and the depthwise conv at batch 1 per
   encoder pass (device times, bounds), a one-image beam 5 x 50 (R = 5 rows)
   of the flagship Transformer and of ``lstm`` with the LSTM step kernel
   through ``caption_batch``, each against all-plain (``plain_versions``) by
   phase 4's near-tie rule, launches counted, maps and their upsampled
   grids (``infer/visualize.py``) within 1e-5; the per-layer decode step and
   the LSTM step at R = 5 against their plain versions, device times by
   CUDA-graph replay and bounds; where PIL is present (the host packages
   are printed after the card), ``cli.caption`` on phase 10b's checkpoint
   for one seeded PNG (with ``--out`` where matplotlib is present too) and
   for a directory of 32, images/s with and without the checkpoint's load;
   (c) a Trainer with
   ``profile_dir`` over one teacher-forced frozen epoch: its trace of steps
   2-6 holds their kernels (5 dropout_mask, 180 dwconv, 180 mlp_block
   launches' kernels), and the validation corpora score the same natively;
   (d) a full-size torchvision-keyed ConvNeXt-Base ``.pth`` through
   ``cli.build_data port-backbone``: Trainers from the ``.pth`` and the
   ``.npz`` hold equal encoders.
16. data parallelism on ``torch.distributed`` (``world_of_one_phase``,
   ``two_ranks_phase``): (a) ``parallel/dryrun.py``'s five paths (the
   frozen, fine-tune and free-running steps, the eval step, beam 3) at full
   width, batch 32, in a world of one over NCCL, every count zeroed before
   and read after (the data-parallel main path), against the same function
   without a group: values and weights bit for bit; each step's ms with and
   without the group and the gradient all-reduce's own; (b) two ranks, two
   processes on the one card over gloo: three fine-tune steps at batch 16
   each with the dropout pool and stochastic depth, the ranks' weights bit
   for bit equal after each, against one process at batch 32 on the same
   global batch (losses 1e-5 relative, gradients 1e-3 x max(1, max |g|),
   parameters 1e-2 x lr), then a two-rank Trainer epoch on phase 10's
   records (one CSV row, one checkpoint tree, BLEU equal to the one-process
   corpus') and a resume that loads on both ranks; each rank's peak memory.
17. the MLP tail's ``precise=False`` arm, bf16 products on bf16 wgmma
   (``bf16_products_phase``), which no model path reaches: (a) its four
   forward instances (the whole tile and ``TPU_CAPTIONER_MLP_SUB=64``'s
   sub-tiled kernel, f32 and bf16 data) at the four ConvNeXt-Base stage
   shapes at batch 8 and 32 with per-image stochastic-depth scales, against
   the plain version (f32 data in mean and at its largest, bf16 data within
   one ulp, sd-0 rows the residual bit for bit) and more than ten times the
   tolerance apart from the precise=True instance, each launch on its own
   counter; (b) its two backward instances at the fine-tune step's shapes
   and at a ragged N = 600, all nine outputs against the plain version, d_x
   zero on sd-0 rows, two calls bit for bit; device times by CUDA-graph
   replay per bs-32 encoder pass and per fine-tune step beside the plain
   version and the precise=True instance.

Beside each step time of phases 5 and 8c (the frozen step of each family),
6 (the fine-tune step), 7 (the eval step in each decode mode, at the tokens
its loops ran), 12b (bf16 and f32, frozen and fine-tune) and 14c (bf16
'block'), a line gives the step's model FLOPs (``eval/flops.py``) as
``model_tflops_per_step`` and its ``mfu`` against the card's published
peak for the step's compute dtype, with the card's name and power limit; a
count of 0, a share above 1 or an H100 SXM part without a peak fails.

The line before the last is a JSON object of the kernels (route, source, the
TPU kernel each replaces, launches on the main paths (0 for the
``precise=False`` arm's six instances, ``*_bf16_products*``), on the training
path, phase 10's or for the bf16 instances phase 12c's, 13d's or 14's, and
on the data-parallel path, phase 16a's, max error,
times and bounds; the bf16 instances as entries of their own, ``*_bf16``);
the last line is ``{"ok": true, "device": {...}}``.  Needs the repository
beside it and one card; imports no JAX.
"""

import argparse
import concurrent.futures
import contextlib
import copy
import dataclasses
import importlib.util
import itertools
import json
import math
import os
import sys
import tempfile
import time

from tpu_captioner_torch.eval.flops import (
    BF16_BY_F32_OPS_PER_S, BF16_OPS_PER_S, F32_OPS_PER_S, F32_PRODUCT_OPS_PER_S, HBM_BYTES_PER_S, TF32_OPS_PER_S,
    eval_step_flops, mfu, peak_flops_per_chip, train_step_flops,
)

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
# The card's rates (NVIDIA H100 SXM data sheet, at 700 W) come from the one
# table of them, the port's eval/flops.py, which the MFU readings use too.
# F32_PRODUCT_OPS_PER_S, the least time for f32 products whatever
# implements them, bounds every kernel whose operations are matrix products
# (the MLP tail, forward, sub-tiled and backward; the block kernel; the
# whole-rollout decode kernel).
# The dropout pool's operations in the card's own terms (PERF.md section 6,
# "Bounds"; scripts/pool_probe.py).  One Philox4x32-10 call (four pool
# elements) needs 19 32x32 -> 64-bit products: two a round, less the first
# round's product of the counter's zero third word, which the compiler
# drops.  cuobjdump -sass of the built library shows each as one
# IMAD.WIDE.U32 giving both halves, two 32-bit results, beside one more
# for the loop's index (20 in the loop).  The rest the call needs: 20 LOP3
# (each two of a round's xors), 4 threshold compares, 4 to pack the bits
# and the 4-byte store, 48 instructions in all.  The CUDA C++ Programming
# Guide's throughput table gives compute capability 9.0 64 results per
# clock per SM for 32-bit integer multiply and multiply-add (also add,
# compare and bitwise), and an SM issues four warp instructions a clock.
# On an H100 80GB HBM3 (700 W) chains of IMAD.HI.U32 issued 31.8 and of
# IMAD.WIDE.U32 24.4 a clock per SM (pool_probe.py rates): a product's high
# half takes two of the 64 result slots.  The least time is the
# larger of the products' results at 64 a clock and the 48 instructions at
# the issue rate, at the card's SM count and top SM clock.
PHILOX_PRODUCTS = 19
PHILOX_ISSUED = 48
INT_RESULTS_PER_CLOCK_PER_SM = 64
ISSUE_PER_CLOCK_PER_SM = 4 * 32


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


def _graph_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms: ``iters`` calls captured in one CUDA
    graph and replayed between CUDA events, so that Python's dispatch, which
    takes longer than a depthwise-conv launch runs, does not count."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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


def step_flops(cfg, image_size, train_encoder=False, decode_len=None):
    """Model FLOPs (eval/flops.py) of one batch-TRAIN_BS step of ``cfg``'s
    model on ``image_size`` square images: the teacher-forced train step of
    TRAIN_T tokens (the encoder frozen, or its children from FT_START on
    trained), or, given ``decode_len``, the greedy eval step of that many
    tokens."""
    widths = dict(decoder=cfg.decoder, image_size=image_size, depths=cfg.encoder_depths, dims=cfg.encoder_dims,
                  embed_dim=cfg.embed_dim, decoder_dim=cfg.decoder_dim, num_layers=cfg.num_layers,
                  encoded_image_size=cfg.encoded_image_size)
    if decode_len is not None:
        return eval_step_flops(TRAIN_BS, cfg.vocab_size, decode_len=decode_len, **widths)
    return train_step_flops(TRAIN_BS, cfg.vocab_size, train_encoder=train_encoder, starting_layer=FT_START,
                            seq_len=TRAIN_T, **widths)


def mfu_line(label, flops, ms, dtype, card):
    """Print a step's ``model_tflops_per_step`` and ``mfu`` (``flops`` in
    ``ms``) against the card's published peak for the step's compute dtype
    (eval/flops.py), with the card's name and power limit.  Fails on a count
    of 0, on a share above 1 (a wrong count or a wrong peak) and on an H100
    SXM part that the table lacks; another card's share is not measured."""
    import torch

    name = torch.cuda.get_device_name(0)
    if flops <= 0:
        raise AssertionError(f"{label}: a model FLOP count of {flops}")
    peak = peak_flops_per_chip(dtype, name)
    if peak is None:
        if "H100" in name and not any(part in name for part in ("PCIe", "NVL")):
            raise AssertionError(f"{label}: eval/flops.py has no peak for the H100 SXM part {name!r}")
        reading = f"mfu: not measured (no published peak for {name})"
    else:
        share = mfu(flops, ms / 1e3, dtype, name)
        if not 0 < share <= 1.0:
            raise AssertionError(f"{label}: mfu {share} outside (0, 1]: a wrong count or a wrong peak")
        reading = f"mfu {share:.4f} of {peak / 1e12:.2f} TFLOP/s ({dtype})"
    print(f"{label}: model_tflops_per_step {flops / 1e12:.4f} in {ms:.2f} ms, {reading} [{card}]")


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
        bound_ms, bound_by = bound(n_bytes, n_ops, F32_PRODUCT_OPS_PER_S)
        print(f"mlp_block per encoder pass at batch {batch} (36 blocks): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
    ms, plain_ms, n_bytes, n_ops = passes[8]
    return (worst, ms, plain_ms, *bound(n_bytes, n_ops, F32_PRODUCT_OPS_PER_S))


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
    bound_ms, bound_by = bound(n_bytes, n_ops, F32_PRODUCT_OPS_PER_S)
    print(f"mlp_block_bwd per fine-tune step (27 + 3 launches): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
    return worst_abs, ms, plain_ms, bound_ms, bound_by


def _rel_err(got, want):
    """(max abs error, max abs error / max(1, max |want|))."""
    err = (got - want).abs().max().item()
    return err, err / max(1.0, want.abs().max().item())


def check_dwconv(dev, card):
    """The depthwise conv's kernels against their plain versions at the
    ConvNeXt-Base stage shapes: the forward at batch 8 and 32, with the
    block's bias in its epilogue, without, and with the flipped filter (the
    input-gradient form); at the fine-tune step's trained stages (C = 512
    and 1024, batch 32) the input gradient of a cotangent (timed) and the
    filter gradient, with the bias gradient from
    the same launch and without, which must also repeat bit for bit.
    Device times (``_graph_ms``: the calls replayed from a CUDA graph) of
    each kernel as the main path runs it (the forward with the bias, the
    filter gradient with the bias gradient), its plain version and the one
    PyTorch call computing the same function, and the kernel's eager time
    (``_time_ms``: calls issued one by one, host dispatch included):
    ``F.conv2d(groups=C)`` with the bias for the forward and without it for
    the input gradient, ``aten.convolution_backward`` with the weight and
    bias gradients for the filter gradient.  Returns, per kernel, one
    fine-tune step's launches summed (36 forwards and 29 input gradients;
    30 filter gradients): (worst abs error, kernel ms, plain ms, library ms,
    bound ms, bound by)."""
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

    def add(kernel, n, err, times, shape, bias):
        b, h, w, c = shape
        acc = sums[kernel]
        acc[0] = max(acc[0], err)
        for i, t in enumerate(times):
            acc[1 + i] += n * t
        # Two (B, H, W, C) tensors and the filter, once each, and the bias
        # (or its gradient) where the launch has one.
        acc[4] += n * 4 * (2 * b * h * w * c + 49 * c + (c if bias else 0))
        acc[5] += n * 2 * 49 * b * h * w * c

    for s, (depth, c) in enumerate(zip(BASE_DEPTHS, BASE_DIMS)):
        g = torch.Generator().manual_seed(100 + c)
        w = (0.1 * torch.randn(7, 7, c, generator=g)).to(dev)
        bias = torch.randn(c, generator=g).to(dev)
        wc = w.permute(2, 0, 1).unsqueeze(1).contiguous()  # the (C, 1, 7, 7) layout of F.conv2d
        wc_flip = w.flip(0, 1).permute(2, 0, 1).unsqueeze(1).contiguous()
        for batch in (8, TRAIN_BS):
            side = 64 >> s
            shape = (batch, side, side, c)
            x = torch.randn(*shape, generator=g).to(dev)
            err_nb, rel_nb = _rel_err(dwconv_forward(x, w), _dw_plain(x, w))
            err, rel = _rel_err(dwconv_forward(x, w, bias=bias), _dw_plain(x, w, bias))
            err_fl, rel_fl = _rel_err(dwconv_forward(x, w, flip=True), _dw_plain(x, w.flip(0, 1)))
            if not max(rel, rel_nb, rel_fl) < DW_TOL:
                raise AssertionError(f"dwconv kernel disagrees at {shape}: {rel_nb} without the bias, {rel} "
                                     f"with it, {rel_fl} with the flipped filter (tol {DW_TOL})")
            t_kernel = _graph_ms(lambda: dwconv_forward(x, w, bias=bias))
            t_plain = _graph_ms(lambda: _dw_plain(x, w, bias))
            t_lib = _graph_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2), wc, bias, padding=3, groups=c))
            t_eager = _time_ms(lambda: dwconv_forward(x, w, bias=bias))
            print(f"dwconv forward {shape}: max_abs_err {err_nb:.3e} without the bias, {err:.3e} with it, "
                  f"{err_fl:.3e} with the flipped filter (relative {rel_nb:.3e}, {rel:.3e}, {rel_fl:.3e}, tol "
                  f"{DW_TOL:g}); with the bias: kernel {t_kernel:.4f} ms "
                  f"(eager {t_eager:.4f}), plain {t_plain:.4f} ms, F.conv2d {t_lib:.4f} ms per launch [{card}]")
            if batch != TRAIN_BS:
                continue
            add("dwconv", depth, max(err, err_nb, err_fl), (t_kernel, t_plain, t_lib), shape, True)
            pass_ms += depth * t_kernel
            pass_bytes += depth * 4 * (2 * x.numel() + 49 * c + c)
            pass_ops += depth * 2 * 49 * x.numel()
            if s not in d_x:
                continue
            cot = torch.randn(*shape, generator=g).to(dev)
            err, rel = _rel_err(dwconv_forward(cot, w, flip=True), _dw_plain(cot, w.flip(0, 1)))
            if not rel < DW_TOL:
                raise AssertionError(f"dwconv input gradient disagrees at {shape}: {rel} >= {DW_TOL}")
            times = (_graph_ms(lambda: dwconv_forward(cot, w, flip=True)),
                     _graph_ms(lambda: _dw_plain(cot, w.flip(0, 1))),
                     _graph_ms(lambda: F.conv2d(cot.permute(0, 3, 1, 2), wc_flip, padding=3, groups=c)))
            add("dwconv", d_x[s], err, times, shape, False)
            print(f"dwconv input gradient {shape}: max_abs_err {err:.3e} (relative {rel:.3e}); kernel "
                  f"{times[0]:.4f} ms, plain {times[1]:.4f} ms, F.conv2d {times[2]:.4f} ms per launch [{card}]")
            got = dwconv_filter_grad(x, cot)
            err_nb, rel_nb = _rel_err(got, _dw_grad_plain(x, cot))
            repeat = torch.equal(got, dwconv_filter_grad(x, cot))
            got_w, got_b = dwconv_filter_grad(x, cot, bias_grad=True)
            want_w, want_b = _dw_grad_plain(x, cot, True)
            again_w, again_b = dwconv_filter_grad(x, cot, bias_grad=True)
            repeat = repeat and torch.equal(got_w, again_w) and torch.equal(got_b, again_b)
            (err_w, rel_w), (err_b, rel_b) = _rel_err(got_w, want_w), _rel_err(got_b, want_b)
            rel, err = max(rel_nb, rel_w, rel_b), max(err_nb, err_w, err_b)
            if not (rel < DW_GRAD_TOL and repeat):
                raise AssertionError(f"dwconv_grad kernel at {shape}: relative error {rel} (tol {DW_GRAD_TOL}), "
                                     f"bitwise repeatable {repeat}")
            times = (_graph_ms(lambda: dwconv_filter_grad(x, cot, bias_grad=True), iters=10),
                     _graph_ms(lambda: _dw_grad_plain(x, cot, True), iters=3, warmup=1),
                     _graph_ms(lambda: torch.ops.aten.convolution_backward(
                         cot.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), wc, [c], [1, 1], [3, 3], [1, 1],
                         False, [0, 0], c, [False, True, True]), iters=10))
            add("dwconv_grad", d_w[s], err, times, shape, True)
            print(f"dwconv filter gradient {shape}: max_abs_err {err_nb:.3e} without the bias gradient, "
                  f"{err_w:.3e} and {err_b:.3e} (d_bias) with it (relative {rel:.3e}, tol {DW_GRAD_TOL:g}), the "
                  f"same bits on a second run: {repeat}; with the bias gradient: kernel {times[0]:.4f} ms, plain "
                  f"{times[1]:.4f} ms, convolution_backward (weight, bias) {times[2]:.4f} ms per launch [{card}]")
    pass_bound, pass_by = bound(pass_bytes, pass_ops)
    print(f"dwconv forward (with the bias) per encoder pass at batch {TRAIN_BS} (36 launches): kernel "
          f"{pass_ms:.4f} ms, bound {pass_bound:.4f} ms ({pass_by}) [{card}]")
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


def check_decode(dev, card, layers, rows, heads=8, timer=None):
    """The per-layer and one-cell kernels against the plain step at ``rows``
    rows and ``heads`` heads, cache length 52, several positions, with NaN in
    every cache slot at or past ``pos``; the one-cell kernel also against the
    per-layer one (the same arithmetic: within 1e-6).  Times by ``timer``
    (default ``_time_ms``: CUDA events around eager calls; or ``_graph_ms``).
    Returns {kernel: (max error, mean ms per step, mean plain ms, bound ms,
    bound by)}."""
    import torch

    from tpu_captioner_torch.ops.decode_step import (
        _decode_step_plain, fused_decode_step, prepare_decode_weights,
    )

    L, E, P = len(layers), layers[0].linear1.in_features, 49
    H, timer = heads, timer or _time_ms
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
            times[kernel].append(timer(lambda: fused_decode_step(*args, one_cell=one_cell)))
            line.append(f"{kernel} " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                        + f", {times[kernel][-1]:.4f} ms")
        if not same <= 1e-6:
            raise AssertionError(f"the one-cell and per-layer kernels differ by {same} at R={rows}, pos {pos}")
        plain_times.append(timer(lambda: _decode_step_plain(*args)))
        print(f"decode R={rows} T={DECODE_T} E={E} H={H} pos={pos}: max_abs_err vs plain: " + "; ".join(line)
              + f" per step ({L} layers); one-cell vs per-layer {same:.3e}; plain {plain_times[-1]:.4f} ms [{card}]")
        b, o = decode_bound(L, rows, pos, P, E, Fd)
        n_bytes, n_ops = n_bytes + b, n_ops + o
    bound_ms, bound_by = bound(n_bytes / 4, n_ops / 4)
    print(f"decode bound at R={rows}, E={E}, mean over the four positions: {bound_ms:.4f} ms ({bound_by})")
    return {k: (worst[k], sum(times[k]) / len(times[k]), sum(plain_times) / len(plain_times), bound_ms, bound_by)
            for k in worst}


def barrier_probe(card):
    """us per ``grid.sync()`` of a cooperative launch of one 256-thread
    block per SM, as the decode kernels launch (a throwaway kernel built by
    ``scripts/decode_barrier_probe.py``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("decode_barrier_probe",
                                                  os.path.join(ROOT, "scripts", "decode_barrier_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    us = probe.barrier_us()
    print(f"grid barrier of the decode kernels' launch (cg::grid_group::sync, one 256-thread block per SM): "
          f"{us:.3f} us per barrier [{card}]")
    return us


def library_sass(name):
    """``cuobjdump -sass`` of ``csrc/<name>.cu``'s library (built if needed)."""
    import subprocess

    from tpu_captioner_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", str(_build.build(name))], capture_output=True, text=True,
                          check=True).stdout


def loop_opcodes(sass_text, kernel):
    """Opcode counts of ``kernel``'s longest loop in ``cuobjdump -sass``
    text: the instructions from a backward branch's target to the branch
    (targets as hex addresses or ``.L_x_n`` labels), predicates dropped."""
    import collections
    import re

    lines, labels, pending, inside = [], {}, [], False
    for line in sass_text.splitlines():
        if "Function" in line:
            inside = kernel in line
            continue
        if not inside:
            continue
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            addr = int(m.group(1), 16)
            labels.update((name, addr) for name in pending)
            pending = []
            lines.append((addr, m.group(2).strip()))
    loops = []
    for addr, ins in lines:
        b = re.search(r"\bBRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", ins)
        if b:
            target = labels.get(b.group(1)) if b.group(1) else int(b.group(2), 16)
            if target is not None and target < addr:
                loops.append((target, addr))
    if not loops:
        raise RuntimeError(f"no loop in {kernel}")
    start, end = max(loops, key=lambda r: r[1] - r[0])
    return collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]
                               for addr, ins in lines if start <= addr <= end)


def max_sm_clock_hz():
    """The card's top SM clock (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.splitlines()[0]) * 1e6


def pool_bound(n, sms, clock_hz):
    """(bound_ms, bound_by, multiply ms, issue ms) of an n-element pool: the
    larger of the bytes written and the Philox calls' operations priced at
    the card's rates (see PHILOX_PRODUCTS)."""
    calls = (n + 3) // 4
    mul_ms = calls * 2 * PHILOX_PRODUCTS / (INT_RESULTS_PER_CLOCK_PER_SM * sms * clock_hz) * 1e3
    issue_ms = calls * PHILOX_ISSUED / (ISSUE_PER_CLOCK_PER_SM * sms * clock_hz) * 1e3
    bound_ms, bound_by = bound(n, 0)
    if max(mul_ms, issue_ms) > bound_ms:
        bound_ms, bound_by = max(mul_ms, issue_ms), "operations"
    return bound_ms, bound_by, mul_ms, issue_ms


def check_dropout(dev, card):
    """Kernel vs plain at the flagship pool size for three seeds: identical
    bits and a keep rate within 5 sigma of 0.5.  Device times (``_graph_ms``)
    of the kernel, the plain version and ``Tensor.bernoulli_``, and the
    kernel's eager time (``_time_ms``, host dispatch included); the bound
    from the library's own instruction mix, whose loop must still issue the
    IMAD.WIDE.U32 that the bound prices (and the loop index's one)."""
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
    mix = loop_opcodes(library_sass("dropout_mask"), "mask_pool_kernel")
    if mix["IMAD.WIDE.U32"] != PHILOX_PRODUCTS + 1:
        raise AssertionError(f"the pool kernel's loop issues {mix['IMAD.WIDE.U32']} IMAD.WIDE.U32, not the "
                             f"{PHILOX_PRODUCTS} products its bound prices and the index's: {dict(mix)}")
    seed = POOL_SEEDS[1]
    t_kernel = _graph_ms(lambda: random_mask_pool(seed, POOL_N, keep, dev), iters=50)
    t_eager = _time_ms(lambda: random_mask_pool(seed, POOL_N, keep, dev), iters=50)
    t_plain = _graph_ms(lambda: _mask_plain(seed, POOL_N, keep, dev), iters=3, warmup=1)
    t_lib = _graph_ms(lambda: torch.empty(POOL_N, dtype=torch.bool, device=dev).bernoulli_(keep), iters=50)
    sms, clock = torch.cuda.get_device_properties(dev).multi_processor_count, max_sm_clock_hz()
    bound_ms, bound_by, mul_ms, issue_ms = pool_bound(POOL_N, sms, clock)
    print(f"dropout_mask n={POOL_N}: kernel {t_kernel:.4f} ms device (eager {t_eager:.4f}), plain "
          f"{t_plain:.4f} ms, bernoulli_ {t_lib:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}: multiplies "
          f"{mul_ms:.4f}, issue {issue_ms:.4f}, bytes {POOL_N / HBM_BYTES_PER_S * 1e3:.4f}; {sms} SMs at "
          f"{clock / 1e6:.0f} MHz), {bound_ms / t_kernel:.1%} of it [{card}]")
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


def train_phase(dev, card, seed, word_map, cfg=None, pool_n=POOL_N):
    """Phase 5 (and 8c for ``cfg``'s LSTM): the frozen-encoder train step at
    full width, batch 32, whose pool draws ``pool_n`` bits."""
    import torch

    from tpu_captioner_torch.core import prng
    from tpu_captioner_torch.core.config import ModelConfig, TrainConfig
    from tpu_captioner_torch.ops.dropout_mask import random_mask_pool
    from tpu_captioner_torch.ops.mlp_block import fused_convnext_mlp
    from tpu_captioner_torch.train.model import CaptionModel
    from tpu_captioner_torch.train.state import TrainState
    from tpu_captioner_torch.train.steps import make_train_step, pool_demand

    cfg, tc = cfg or ModelConfig(vocab_size=VOCAB), TrainConfig(batch_size=TRAIN_BS)
    if pool_demand(cfg, TRAIN_BS, TRAIN_T, cfg.num_pixels) != pool_n:
        raise AssertionError(f"the {cfg.decoder} train step's pool size changed")
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
                print(f"{cfg.decoder} train step: {launches[-1][0]} dropout_mask launches ({pool_n} bits), "
                      f"{launches[-1][1]} mlp_block launches")
                if launches[-1] != (1, 36):
                    raise AssertionError(f"expected 1 dropout_mask and 36 mlp_block launches, got {launches[-1]}")
        return out, grads, {k: v.clone() for k, v in model.decoder.state_dict().items()}, state

    launches = []
    got, grads, params, state = two_steps(count=True)
    with plain_mask_pool():
        want, _, want_params, _ = two_steps(count=False)
    for i, (a, b) in enumerate(zip(got, want)):
        print(f"{cfg.decoder} train step {i}: kernel pool {a}; plain pool {b}")
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
    print(f"{cfg.decoder} train step bs={TRAIN_BS} frozen encoder: median {ms:.2f} ms/step over {TRAIN_TIMED_STEPS} "
          f"steps (min {min(times):.2f}, max {max(times):.2f}), {TRAIN_BS / (ms / 1e3):.1f} images/s, "
          f"train-mode encoder {enc_ms:.2f} ms, peak memory {peak / 2**30:.2f} GiB; "
          f"loss {float(m['loss']):.4f} [{card}]")
    mfu_line(f"{cfg.decoder} train step bs={TRAIN_BS} frozen encoder", step_flops(cfg, batch["images"].shape[1]), ms,
             cfg.compute_dtype, card)
    return launches[0]


# Kernel-name substrings of each group in a profiler window, first match wins.
# The MLP tail's two libraries share the tensor-core GEMM (gemm_kernel<Epi>):
# the forward's instances are told apart by their epilogues, listed first;
# split_kernel, which both libraries run, has a group of its own.
KERNEL_GROUPS = (
    ("dwconv_grad", ("dwconv_wgrad",)),
    ("dwconv", ("dwconv_fwd_kernel",)),
    ("block_fused conv + LayerNorm", ("conv_ln_kernel",)),
    ("mlp_block", ("mlp_block_kernel", "ln_rows", "ln_stats", "HiddenEpi", "OutEpi")),
    ("mlp_block_bwd", ("gemm_kernel", "prep_rows", "finish_rows", "column_partials",
                       "column_finish", "sum_splits")),
    ("mlp tf32 split", ("split_kernel",)),
    ("dropout_mask", ("mask_pool_kernel",)),
    ("convolution backward", ("dgrad", "wgrad", "conv_depthwise2d_backward", "conv_depthwise2d_grad_weight")),
    ("convolution forward", ("fprop", "cudnn", "convolve", "conv2d", "conv_depthwise2d")),
    ("cuBLAS gemm", ("gemm", "sm90_xmma", "cutlass")),
)


def kernel_group(name):
    """The ``KERNEL_GROUPS`` group of a kernel's name ("other" if none)."""
    name = name.lower()
    return next((g for g, subs in KERNEL_GROUPS if any(x.lower() in name for x in subs)), "other")


def _kernel_ms_by_group(step, state, batch, seeds):
    """A ``torch.profiler`` window over ``len(seeds)`` steps, per step: the
    kernels' device time by ``KERNEL_GROUPS`` group (ms), the twelve longest
    kernels, the kernels' launches and the host clock's wall time (ms, the
    window synchronised).  Kernel rows only: a user annotation on the
    device's timeline (``Optimizer.step``) spans kernels already counted.
    It records the device's activity only: a step of tens of thousands of
    launches gives the host-side profile millions of events, whose summary
    took minutes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in seeds:
            state, _ = step(state, batch, s)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / len(seeds)
    groups, kernels, launches = {}, [], 0
    for e in prof.key_averages():
        if (getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        ms = e.self_device_time_total / 1e3 / len(seeds)
        group = kernel_group(e.key)
        groups[group] = groups.get(group, 0.0) + ms
        kernels.append((ms, e.key[:90]))
        launches += e.count
    return state, groups, sorted(kernels, reverse=True)[:12], launches // len(seeds), wall


def set_dw(model, dw_kernel, dw_grad_kernel):
    """Set every ConvNeXt block of ``model`` to the depthwise-conv kernels
    chosen (both False: the grouped conv and its autograd)."""
    from tpu_captioner_torch.models.convnext import CNBlock

    for blk in model.modules():
        if isinstance(blk, CNBlock):
            blk.dw_kernel, blk.dw_grad_kernel = dw_kernel, dw_grad_kernel


def paired_ab(label, card, fn, use_kernel, use_other, other="plain"):
    """AB_PAIRS pairs of calls of ``fn`` with the kernel (``use_kernel()``
    selects it) and with the other arm (``use_other()``), the order within a
    pair alternating; each arm of a pair is the fastest of AB_REPS calls,
    host clock, each call synchronised (a busy host only adds time).  The
    kernel is favoured when the median of the pairs' differences (other -
    kernel) exceeds their spread (the largest difference less the smallest).
    Returns (favoured, kernel median ms, other median ms, gain, spread)."""
    import statistics

    import torch

    def run(choose):
        choose()
        times = []
        for _ in range(AB_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    run(use_kernel)  # warm-up of both arms
    run(use_other)
    pairs = []
    for i in range(AB_PAIRS):
        order = (use_kernel, use_other) if i % 2 == 0 else (use_other, use_kernel)
        t = {choose: run(choose) for choose in order}
        pairs.append((t[use_kernel], t[use_other]))
    diffs = [o - k for k, o in pairs]
    gain, spread = statistics.median(diffs), max(diffs) - min(diffs)
    k_med, o_med = statistics.median(k for k, _ in pairs), statistics.median(o for _, o in pairs)
    print(f"A/B {label}, {AB_PAIRS} pairs, fastest of {AB_REPS} calls per arm: kernel median {k_med:.2f} ms, "
          f"{other} median {o_med:.2f} ms; {other} - kernel per pair median {gain:.2f}, min {min(diffs):.2f}, "
          f"max {max(diffs):.2f}, spread {spread:.2f} ms; kernel favoured (median > spread): {gain > spread} "
          f"[{card}]")
    print(f"  pairs (kernel, {other}) ms: " + ", ".join(f"({k:.2f}, {o:.2f})" for k, o in pairs))
    return gain > spread, k_med, o_med, gain, spread


def dwconv_ab(dev, card, model, step, state, batch, seeds):
    """The paired A/B (``paired_ab``) that decides whether each
    depthwise-conv kernel follows ``use_pallas``: fine-tune steps on one
    model and state, kernel and library in turns.  The filter gradient goes
    first, the forward on the library in both arms (the library arm is the
    grouped conv and its autograd); then the forward kernel (forward and
    input gradient), the filter gradient on its kernel in both arms, so that
    cuDNN's weight gradient (38 ms of the step, and the wider spread) is in
    neither.  For the forward kernel also eval encoder passes at batch 32 (no
    backward).  ``seeds`` is an iterator of dropout seeds.  Leaves the model
    on the library."""
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
        favoured[label] = paired_ab(label, card, fn, lambda: set_dw(model, *kernel),
                                    lambda: set_dw(model, *library), other="library")[0]
    set_dw(model, False, False)
    return state_box[0], favoured


def fine_tune_agree(label, got, want, grads, want_grads, params, want_params, start, lr):
    """Two fine-tune steps' metrics, step-1 gradients and updated parameters
    against the plain path's: losses within 1e-4, top-5 and token counts
    equal, gradients within 1e-3 in relative norm, parameters within 1e-2 x
    lr where both steps' gradients are at least 1e-3 of the tensor's
    largest; children below FT_START bit-identical to ``start``, every child
    from it on changed."""
    import torch

    for i, (a, b) in enumerate(zip(got, want)):
        print(f"{label} step {i}: kernels {a}; plain {b}")
        if not (abs(a["loss"] - b["loss"]) <= 1e-4 and a["top5_correct"] == b["top5_correct"]
                and a["tokens"] == b["tokens"] and math.isfinite(a["loss"])):
            raise AssertionError(f"{label} step {i}: kernel and plain paths disagree")
    if set(grads[0]) != set(want_grads[0]):
        raise AssertionError("the two paths trained different parameters")
    grad_err = max(((grads[0][k] - g).norm() / g.norm().clamp_min(1e-30)).item()
                   for k, g in want_grads[0].items())
    param_err = 0.0
    for k, g0 in want_grads[0].items():
        g1 = want_grads[1][k]
        sure = (g0.abs() >= 1e-3 * g0.abs().max()) & (g1.abs() >= 1e-3 * g1.abs().max())
        err = (params[k] - want_params[k]).abs()[sure]
        param_err = max(param_err, err.max().item() if err.numel() else 0.0)
    print(f"{label} step 1 gradients, kernels vs plain: worst |d|/|plain| {grad_err:.3e} (tol 1e-3); "
          f"updated parameters: max abs diff {param_err:.3e} (tol {1e-2 * lr:g}) over "
          f"{len(want_grads[0])} tensors")
    if not (grad_err <= 1e-3 and param_err <= 1e-2 * lr):
        raise AssertionError(f"{label} gradients or updated parameters disagree between the two paths")
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
    fine_tune_agree("fine-tune", got, want, grads, want_grads, params, want_params, start, tc.encoder_lr)
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
        mfu_line(f"fine-tune step bs={TRAIN_BS} starting_layer {FT_START}, remat {label!r}",
                 step_flops(cfg, batch["images"].shape[1], train_encoder=True), ms, cfg.compute_dtype, card)
        if label == "off":
            state, groups, top, _, _ = _kernel_ms_by_group(
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
# The LSTM step kernel against its plain version: h, c and alpha are f32 sums
# of up to E + D + C order-one products, in another order than cuBLAS's.
LSTM_TOL = 1e-5
LSTM_ROWS = (8 * BEAM, 32 * BEAM, TRAIN_BS)  # the bs-8 and bs-32 beams, the eval step
# The whole-block kernel against its plain version, relative to max(1, the
# plain output's largest magnitude): the conv's 49 products and the tail's
# 4C-long sums in another order than cuDNN's and cuBLAS's.
BLOCK_TOL = 1e-4
# The MLP tail's sub-tiled kernel against the whole-tile path, relative as
# above: the same 3xTF32 products, the hidden sum in chunks and the first
# product's k-stages added in another grouping, ln_w and ln_b folded into W1
# and b1.
PIPE_TOL = 1e-5
MLP_SUBS = {128: (64,), 256: (64,), 512: (64,), 1024: (64,)}  # ops/mlp_block.py:_pipeline_sub
PIPE_SUB = 64  # valid at every width: phase 9's serving run and A/B


def serve_times(card, prefix, models, rng, dev, word_map):
    """Encoder ms, beam ms (beam 5, MAX_STEPS) and captions/s of each of
    ``models`` ({label: model}) on seeded images at batch 8 and 32: medians
    of 3 host-clock calls after a warm-up encoder pass."""
    import torch

    from tpu_captioner_torch.infer.beam import beam_search_encoded

    for bs in (8, 32):
        imgs = torch.randint(0, 256, (bs, 256, 256, 3), generator=rng, dtype=torch.uint8).to(dev)
        for label, m in models.items():
            m.encode(imgs)  # warm-up
            enc_ms, enc = _host_ms(lambda: m.encode(imgs))
            beam_ms, _ = _host_ms(lambda: beam_search_encoded(
                m, enc, beam_size=BEAM, max_steps=MAX_STEPS,
                start_id=word_map["<start>"], end_id=word_map["<end>"]))
            print(f"{prefix} bs={bs} {label}: encoder {enc_ms:.2f} ms, beam {beam_ms:.2f} ms, "
                  f"{bs / ((enc_ms + beam_ms) / 1e3):.2f} captions/s [{card}]")


def flagship_model(cfg, dev, seed):
    """The served model of phases 3, 4, 7 and 8: random weights from ``seed``,
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
        head = model.decoder.fc if cfg.decoder in ("lstm", "lstm_no_attention") else model.decoder.fc_out
        head.weight.mul_(16.0)
    return model


def compare_rollouts(label, got, want, logit_tol=LOGIT_TOL, alpha_tol=ALPHA_TOL, tie_gap=TIE_GAP):
    """Greedy rollouts (logits, seqs, alphas) against the plain one: per row
    equal tokens up to the first step where they differ, which must be a
    near-tie (the plain logits of the two tokens within ``tie_gap``); logits and
    maps within ``logit_tol`` and ``alpha_tol`` up to that step.  Returns
    (max logit error, max map error, rows that differ)."""
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
        if not gap < tie_gap:
            raise AssertionError(f"{label}: row {r} differs from the plain rollout beyond a near-tie")
    if not (logit_err < logit_tol and alpha_err < alpha_tol):
        raise AssertionError(f"{label}: logits {logit_err} or maps {alpha_err} disagree with the plain rollout")
    return logit_err, alpha_err, ties


def rollout_bound(lengths, L, P, E, Fd, V, steps, esize=4):
    """(bytes, ops) of a whole rollout whose rows ran ``lengths`` tokens,
    each input read once and each output written once: the layer weights,
    the vocab head, the memory K/V, the embedding and PE rows used, the
    (R, steps) logits, maps and tokens; the weight matrices, the head, the
    memory K/V and the embedding rows at ``esize`` bytes (2 in the bf16
    instance), the rest at 4.  Operations: 2 per weight per row and token
    (layers and head), and the two attentions' scores and weighted sums."""
    R, row_steps = len(lengths), sum(lengths)
    attn = sum(L * 4 * E * (s + 1 + P) for n in lengths for s in range(n))
    n_ops = row_steps * 2 * (L * (6 * E * E + 2 * E * Fd) + E * V) + attn
    n_bytes = (esize * (L * (6 * E * E + 2 * E * Fd) + V * E + 2 * L * R * P * E + row_steps * E)
               + 4 * (L * (9 * E + Fd) + V + max(lengths) * E + R * steps * (V + P + 1)))
    return n_bytes, n_ops


def emitted_end_id(seqs):
    """An end id for a rerun in which rows finish early: one every row of
    ``seqs`` emits if there is one (of those, the one whose rows finish at
    the most different steps), else the most frequent token (never <pad>)."""
    import torch

    seqs = seqs.long()
    in_all = [v for v in range(1, VOCAB) if bool((seqs == v).any(dim=1).all())]
    if in_all:
        firsts = {v: (seqs == v).int().argmax(dim=1).tolist() for v in in_all}
        return min(firsts, key=lambda v: (-len(set(firsts[v])), max(firsts[v])))
    return int(torch.bincount(seqs.flatten(), minlength=VOCAB)[1:].argmax()) + 1


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
                mfu_line(f"eval step bs={TRAIN_BS} {label}, {runs[label][3]} tokens",
                         step_flops(cfg, batch["images"].shape[1], decode_len=runs[label][3]), eval_ms,
                         cfg.compute_dtype, card)
            ids = dict(word_map, **{"<end>": emitted_end_id(plain[1]["sequences"])})
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
    bound_ms, bound_by = bound(*rollout_bound(lengths, L, 49, E, cfg.decoder_dim, VOCAB, steps),
                               F32_PRODUCT_OPS_PER_S)
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
    under ``model``'s plain decode step (Transformer or LSTM with attention):
    a beam candidate's score."""
    import torch

    dec = model.decoder
    total = 0.0
    if model.cfg.decoder == "lstm":
        enc = enc_out_1.flatten(1, 2)
        att1 = dec.attention.encoder_att(enc)
        h, c = dec.init_hidden_state(enc)
        for pos in range(len(seq) - 1):
            h, c, _ = dec.step(h, c, dec.embedding(seq[pos : pos + 1]), enc, att1)
            total += torch.log_softmax(dec.fc(h), -1)[0, seq[pos + 1]].item()
        return total
    memory = dec.precompute_memory(enc_out_1)
    cache = dec.init_cache(1, len(seq))
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


def lstm_bound(R, E, D, A, C, P):
    """(bound_ms, bound_by) of one LSTM step over R rows: the larger of the
    bytes (the weights, emb, h, c, enc and att1 read once, h', c' and alpha
    written) over the memory rate and the operations over their rates: the
    five products, 2 operations per multiply-add, at the f32 product rate of
    the tensor cores (``F32_PRODUCT_OPS_PER_S``, as the MLP tail's and the
    block's products are priced), plus the attention's FFMA work, 4
    operations per (pixel, attention unit) of the scores (add, relu,
    multiply-add) and 2 per (pixel, channel) of the context, at the f32
    rate."""
    n_weights = A * D + 2 * A + 1 + C * D + C + 4 * D * (E + C + D + 1)
    n_bytes = 4 * (n_weights + R * (E + 2 * D + P * (C + A)) + R * (2 * D + P))
    products = 2 * R * (A * D + C * D + 4 * D * (E + C + D))
    attention = R * P * (4 * A + 2 * C)
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = (products / F32_PRODUCT_OPS_PER_S + attention / F32_OPS_PER_S) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _cold_ms(fn, iters=20):
    """Device ms of ``fn`` with L2 emptied before each call: a 128 MiB
    buffer (over twice the 50 MB L2) zeroed between the calls of a CUDA
    graph, less the zeroing's own time in a graph of its own."""
    import torch

    flush = torch.empty(32 << 20, device="cuda")

    def both():
        flush.zero_()
        fn()

    return _graph_ms(both, iters=iters) - _graph_ms(flush.zero_, iters=iters)


def _host_us(fn, iters=200):
    """Host microseconds a call of ``fn``: the host's clock around ``iters``
    calls issued back to back, no synchronise between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def check_lstm(dev, card, cases=None):
    """The LSTM step kernel against its plain version at the main paths'
    rows (``LSTM_ROWS``) at full width, E = D = A = 512, C = 1024, P = 49,
    and at the bs-8 beam's rows with E = 300 (word2vec-300's width), or at
    ``cases`` ((R, E) pairs); seeded
    weights U(+-1/sqrt(fan-in)), as the default Linear and LSTMCell draw
    them; a second call must repeat the first bit for bit.  Times of both:
    device (CUDA-graph replay; weights and inputs stay in the 50 MB L2 from
    call to call, as in a decode loop), eager (calls issued from Python),
    L2-cold (``_cold_ms``) and host µs per call; and the bound.  Returns
    (worst error, kernel ms, plain ms, bound ms, bound by) at the first
    case (the bs-8 beam's rows and E = 512), device times."""
    import torch

    from tpu_captioner_torch.ops.lstm_step import LstmStepWeights, _lstm_step_plain, fused_lstm_step

    D, A, C, P = 512, 512, 1024, 49
    worst, out = 0.0, None
    for R, E in cases or [(r, 512) for r in LSTM_ROWS] + [(LSTM_ROWS[0], 300)]:
        g = torch.Generator().manual_seed(R + E)
        u = lambda fan_in, *sh: ((torch.rand(*sh, generator=g) * 2 - 1) / math.sqrt(fan_in)).to(dev)  # noqa: E731
        f = lambda *sh: torch.randn(*sh, generator=g).to(dev)  # noqa: E731
        w = LstmStepWeights(u(D, A, D), u(D, A), u(A, A), u(A, 1), u(D, C, D), u(D, C),
                            u(D, 4 * D, E), u(D, 4 * D, C), u(D, 4 * D, D), u(D, 4 * D))
        args = (w, f(R, E), f(R, D), f(R, D), f(R, P, C), f(R, P, A))
        got, want = fused_lstm_step(*args), _lstm_step_plain(*args)
        errs = {k: (a - b).abs().max().item() for k, a, b in zip(("h", "c", "alpha"), got, want)}
        if not (all(torch.isfinite(a).all() for a in got) and max(errs.values()) < LSTM_TOL):
            raise AssertionError(f"lstm_step kernel disagrees at R={R}, E={E}: {errs} (tol {LSTM_TOL:g})")
        if not all(torch.equal(a, b) for a, b in zip(got, fused_lstm_step(*args))):
            raise AssertionError(f"lstm_step kernel: a second call differs at R={R}, E={E}")
        call = lambda: fused_lstm_step(*args)  # noqa: E731
        t_kernel, t_eager, t_cold, host = _graph_ms(call, iters=50), _time_ms(call, iters=50), _cold_ms(call), \
            _host_us(call)
        t_plain = _graph_ms(lambda: _lstm_step_plain(*args), iters=50)
        bound_ms, bound_by = lstm_bound(R, E, D, A, C, P)
        print(f"lstm_step R={R} E={E} D={D} A={A} C={C} P={P}: max_abs_err " +
              ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (tol {LSTM_TOL:g}), second call bit for "
              f"bit; kernel {t_kernel:.4f} ms device, {t_eager:.4f} eager, {t_cold:.4f} L2-cold, {host:.1f} us "
              f"host a call; plain {t_plain:.4f} ms device; bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
        worst = max(worst, *errs.values())
        if out is None:
            out = (t_kernel, t_plain, bound_ms, bound_by)
    return (worst, *out)


def lstm_serve(dev, card, seed, word_map, images8, rng):
    """Phase 8a: beam-5 serving of ``lstm`` through the CLI's loader, with
    the decode kernel on, against a copy with every kernel off; serving
    times at batch 8 and 32; then ``lstm_no_attention`` once through the
    loader.  Returns the served model and the main path's lstm_step
    launches."""
    import numpy as np
    import torch

    from tpu_captioner_torch.cli.caption import build_model_and_params, caption_batch
    from tpu_captioner_torch.core.config import ModelConfig
    from tpu_captioner_torch.models.from_jax import save_reference_checkpoint
    from tpu_captioner_torch.ops.dwconv import depthwise_conv7x7_nhwc
    from tpu_captioner_torch.ops.lstm_step import fused_lstm_step
    from tpu_captioner_torch.ops.mlp_block import fused_convnext_mlp
    from tpu_captioner_torch.train.model import CaptionModel

    def load(model, **flags):
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "BEST_checkpoint_lstm.pth.tar")
            save_reference_checkpoint(model, ckpt)
            cli = argparse.Namespace(checkpoint=ckpt, embeddingName=None, device=str(dev), seed=seed + 13, **flags)
            loaded = build_model_and_params(cli, word_map)
        want = model.state_dict()
        if not all(torch.equal(v, want[k]) for k, v in loaded.state_dict().items()):
            raise AssertionError("checkpoint round trip changed the weights")
        return loaded

    cfg = ModelConfig(decoder="lstm", vocab_size=VOCAB, decode_kernel="on")
    served = load(flagship_model(cfg, dev, seed + 11), decoder=None, lstmDecoder=True)
    served.cfg = dataclasses.replace(served.cfg, decode_kernel="on")
    plain = CaptionModel(dataclasses.replace(served.cfg, **ALL_OFF), device=dev)
    plain.load_state_dict(served.state_dict())
    steps = [0]  # one embedding lookup per beam step
    hook = served.decoder.embedding.register_forward_hook(lambda *a: steps.__setitem__(0, steps[0] + 1))
    fused_convnext_mlp.launches = depthwise_conv7x7_nhwc.launches = fused_lstm_step.launches = 0
    got = caption_batch(served, images8.numpy(), word_map, BEAM)
    torch.cuda.synchronize()
    seen = (fused_convnext_mlp.launches, depthwise_conv7x7_nhwc.launches, fused_lstm_step.launches)
    hook.remove()
    print(f"lstm main path: {seen[0]} mlp_block and {seen[1]} dwconv launches (1 encoder pass), {seen[2]} "
          f"lstm_step launches over {steps[0]} beam steps")
    if seen != (36, 36, steps[0]) or steps[0] < 1:
        raise AssertionError(f"expected 36 mlp_block, 36 dwconv and one lstm_step launch per beam step "
                             f"({steps[0]} steps), got {seen}")
    want = caption_batch(plain, images8.numpy(), word_map, BEAM)
    for _, score, seq, alpha in got:
        if not (seq[0] == word_map["<start>"] and alpha.shape == (len(seq), cfg.num_pixels)
                and np.isfinite(alpha).all() and np.isfinite(score)):
            raise AssertionError("malformed lstm caption output")
    compare_captions(got, want, plain, images8.to(dev))
    for j, (cap, score, seq, _) in enumerate(got[:2]):
        print(f"lstm caption {j} (score {score:.4f}, {len(seq)} tokens): {cap[:80]}")
    print(f"lstm beam-{BEAM} kernel vs plain on the card: captions agree on {len(got)} images")
    serve_times(card, "lstm serve", {"kernels": served, "plain": plain}, rng, dev, word_map)

    no_att = ModelConfig(decoder="lstm_no_attention", vocab_size=VOCAB)
    loaded = load(flagship_model(no_att, dev, seed + 14), decoder="lstm_no_attention", lstmDecoder=False)
    fused_lstm_step.launches = 0
    out = caption_batch(loaded, images8.numpy(), word_map, BEAM)
    torch.cuda.synchronize()
    for _, score, seq, alpha in out:
        if not (seq[0] == word_map["<start>"] and 1 < len(seq) <= MAX_STEPS + 2 and np.isfinite(score)
                and alpha.shape == (len(seq), no_att.num_pixels) and not alpha.any()):
            raise AssertionError("malformed lstm_no_attention caption output")
    if fused_lstm_step.launches:
        raise AssertionError("lstm_no_attention launched the LSTM step kernel")
    print(f"lstm_no_attention beam-{BEAM} through the CLI loader: {len(out)} captions, "
          f"{fused_lstm_step.launches} lstm_step launches; caption 0: {out[0][0][:60]}")
    del loaded, plain
    return served, seen[2]


def lstm_eval(dev, card, seed, model, word_map):
    """Phase 8b: the greedy eval step of ``lstm`` at batch 32, 51 steps,
    with the kernel ('on') against 'off': launches counted (36 MLP launches,
    one lstm_step launch per token run), rollouts compared as in
    ``compare_rollouts`` and, without a near-tie, the loss (with the
    alpha_c term) within 1e-4 relative and the sequences, lengths and counts
    equal.  With the natural <end>, then with one the rows emit, so that the
    early exit fires.  Returns the batch."""
    import torch

    from tpu_captioner_torch.core.config import TrainConfig
    from tpu_captioner_torch.ops.lstm_step import fused_lstm_step
    from tpu_captioner_torch.ops.mlp_block import fused_convnext_mlp
    from tpu_captioner_torch.train.steps import make_eval_step

    cfg, tc = model.cfg, TrainConfig(batch_size=TRAIN_BS)
    steps = tc.max_decode_len
    batch = {k: v.to(dev) for k, v in train_batch(torch.Generator().manual_seed(seed + 15), word_map,
                                                   VOCAB).items()}
    tokens = [0]
    hook = model.decoder.embedding.register_forward_hook(lambda *a: tokens.__setitem__(0, tokens[0] + 1))

    def run(mode, ids):
        model.cfg = dataclasses.replace(cfg, decode_kernel=mode)
        step = make_eval_step(model, tc, ids)
        fused_convnext_mlp.launches = fused_lstm_step.launches = tokens[0] = 0
        aux = step(batch)
        torch.cuda.synchronize()
        seen, ran = (fused_convnext_mlp.launches, fused_lstm_step.launches), tokens[0]
        with torch.inference_mode():
            roll = model.rollout(model.encode(batch["images"]), word_map["<start>"], ids["<end>"], steps)
        return step, aux, seen, ran, roll

    ids = word_map
    for end_label in ("natural", "emitted"):
        runs = {mode: run(mode, ids) for mode in ("off", "on")}
        want = runs["off"][1]
        need = int(want["lengths"].max())
        for mode, (step, aux, seen, ran, roll) in runs.items():
            expect = (36, 0 if mode == "off" else need)
            print(f"lstm eval ({end_label} <end> = {ids['<end>']}) {mode}: launches (mlp_block, lstm_step) {seen}, "
                  f"{ran} tokens run, {int((aux['lengths'] < steps).sum())} of {TRAIN_BS} rows finished before "
                  f"step {steps}; loss {float(aux['loss']):.6f}, tokens {int(aux['tokens'])}, "
                  f"top5 {int(aux['top5_correct'])}")
            if seen != expect or ran != need:
                raise AssertionError(f"lstm eval {mode}: expected launches {expect} and {need} tokens, got {seen}, {ran}")
            if not (torch.isfinite(roll[0]).all() and aux["sequences"].shape == (TRAIN_BS, steps)
                    and math.isfinite(float(aux["loss"]))):
                raise AssertionError(f"lstm eval {mode}: malformed output")
            if mode == "off":
                continue
            logit_err, alpha_err, ties = compare_rollouts(f"lstm eval {mode}", roll, runs["off"][4])
            print(f"  {mode} vs off: logits {logit_err:.3e} (tol {LOGIT_TOL:g}), maps {alpha_err:.3e} "
                  f"(tol {ALPHA_TOL:g}), {len(ties)} rows differ at a near-tie")
            if ties:
                print(f"  {mode}: loss and counts not compared (a near-tie changed a sequence)")
                continue
            rel = abs(float(aux["loss"]) - float(want["loss"])) / abs(float(want["loss"]))
            same = all(torch.equal(aux[k], want[k]) for k in ("sequences", "lengths", "tokens", "top5_correct"))
            if not (rel < 1e-4 and same):
                raise AssertionError(f"lstm eval {mode}: metrics disagree with 'off' (loss rel {rel})")
        if end_label == "natural":
            for mode, (step, *_rest) in runs.items():
                model.cfg = dataclasses.replace(cfg, decode_kernel=mode)
                eval_ms, _ = _host_ms(lambda: step(batch))
                print(f"lstm eval bs={TRAIN_BS} {mode}: eval step {eval_ms:.2f} ms ({runs[mode][3]} tokens) [{card}]")
            ids = dict(word_map, **{"<end>": emitted_end_id(want["sequences"])})
        elif not bool((want["lengths"] < steps).any()):
            raise AssertionError(f"no lstm row finished before step {steps} with <end> = {ids['<end>']}")
    hook.remove()
    model.cfg = cfg
    return batch


def lstm_ab(card, model, images8, batch, word_map):
    """Phase 8d: the paired A/B (``paired_ab``) that sets ``'auto'`` for
    ``lstm``: the kernel against the plain step in the bs-8 beam (encoder
    output computed once) and in the bs-32 eval step.  Returns whether each
    context favours the kernel."""
    import torch

    from tpu_captioner_torch.core.config import TrainConfig
    from tpu_captioner_torch.infer.beam import beam_search_encoded
    from tpu_captioner_torch.train.steps import make_eval_step

    cfg = model.cfg

    def use(mode):
        return lambda: setattr(model, "cfg", dataclasses.replace(cfg, decode_kernel=mode))

    with torch.inference_mode():
        enc8 = model.encode(images8)
    step = make_eval_step(model, TrainConfig(batch_size=TRAIN_BS), word_map)
    contexts = {
        "lstm decode kernel, beam-5 bs 8": lambda: beam_search_encoded(
            model, enc8, beam_size=BEAM, max_steps=MAX_STEPS,
            start_id=word_map["<start>"], end_id=word_map["<end>"]),
        "lstm decode kernel, eval step bs 32": lambda: step(batch),
    }
    favoured = {label: paired_ab(label, card, fn, use("on"), use("off"))[0] for label, fn in contexts.items()}
    model.cfg = cfg
    return favoured


@contextlib.contextmanager
def mlp_sub(value):
    """Run the MLP-tail kernel's sub-tiled path of ``value`` rows (None: the
    whole-tile path), as ``TPU_CAPTIONER_MLP_SUB`` selects it."""
    old = os.environ.pop("TPU_CAPTIONER_MLP_SUB", None)
    if value is not None:
        os.environ["TPU_CAPTIONER_MLP_SUB"] = str(value)
    try:
        yield
    finally:
        os.environ.pop("TPU_CAPTIONER_MLP_SUB", None)
        if old is not None:
            os.environ["TPU_CAPTIONER_MLP_SUB"] = old


def _stage_params(c, g, dev):
    """Seeded LayerNorm, W1, b1, W2, b2 and layer scale of width ``c`` (order
    one, as in ``check_mlp``)."""
    import torch

    f = lambda *sh: torch.randn(*sh, generator=g)  # noqa: E731
    return tuple(a.to(dev) for a in (
        1 + 0.1 * f(c), 0.1 * f(c), 0.02 * f(4 * c, c), 0.1 * f(4 * c), 0.02 * f(c, 4 * c), 0.1 * f(c), 0.5 * f(c),
    ))


def block_bound(b, h, w, c):
    """(bytes, ops) of one whole-block launch: x read and out written once,
    the per-image scales, the taps, conv bias and tail weights once; the
    tail's 16 N C^2 FLOP and the conv's 98 N C."""
    n = b * h * w
    return 4 * (2 * n * c + b + 49 * c + 8 * c * c + 9 * c), 16 * n * c * c + 98 * n * c


def check_block(dev, card):
    """The whole-block kernel against ``_block_plain`` at the four
    ConvNeXt-Base stage shapes at batch 8 and 32, with all-one scales and
    with per-image scales (0 and 1/survival at the stage's last ramped
    rate), at a ragged (3, 14, 14, 512) whose pixels do not fill the last
    tiles and at (2, 9, 7, 128), whose sides are no multiple of the tile:
    within BLOCK_TOL x max(1, max |plain|); images with scale 0 come out as
    their input bit for bit.  Device times (``_graph_ms``) of both, batch 8
    all-one and batch 32 with scales as each path runs them, the kernel's
    eager time beside (host dispatch of its five launches included), and
    the bound.  The library must run the tensor cores (HGMMA) and TMA loads
    (UTMALDG).  Returns the worst absolute error and the bs-32 encoder pass's (36
    launches) kernel ms, plain ms, bound ms and bound by."""
    import re

    import torch

    from tpu_captioner_torch.models.convnext import BASE_DEPTHS, BASE_DIMS, sd_probs
    from tpu_captioner_torch.ops import _build
    from tpu_captioner_torch.ops.block_fused import _block_plain, fused_convnext_block

    text = library_sass("block_fused")
    hgmma, utma = len(re.findall(r"\bHGMMA\b", text)), len(re.findall(r"\bUTMALDG\b", text))
    sources = sorted(p.name for p in _build._sources(_build.CSRC / "block_fused.cu", {}))
    print(f"block_fused library: {hgmma} HGMMA, {utma} UTMALDG; sources {', '.join(sources)}")
    if not (hgmma and utma):
        raise AssertionError("the block library must run HGMMA and UTMALDG")
    probs = sd_probs(BASE_DEPTHS)
    worst, passes = 0.0, {}
    cases = [(s, depth, (batch, 64 >> s, 64 >> s, c))
             for s, (depth, c) in enumerate(zip(BASE_DEPTHS, BASE_DIMS)) for batch in (8, TRAIN_BS)]
    for s, depth, shape in cases + [(None, 0, (3, 14, 14, 512)), (None, 0, (2, 9, 7, 128))]:
        batch, c = shape[0], shape[-1]
        g = torch.Generator().manual_seed(200 + c + batch)
        x = torch.randn(*shape, generator=g).to(dev)
        taps, dw_b = (0.1 * torch.randn(7, 7, c, generator=g)).to(dev), (0.1 * torch.randn(c, generator=g)).to(dev)
        params = _stage_params(c, g, dev)
        survival = 1.0 - probs[sum(BASE_DEPTHS[: s + 1]) - 1] if s is not None else 0.8
        keep = torch.rand(batch, generator=g) < survival
        keep[0], keep[1] = False, True
        errs, timed = [], None
        for sd in (torch.ones(batch), keep / survival):
            args = (x, sd.to(dev), taps, dw_b, *params)
            got, want = fused_convnext_block(*args), _block_plain(*args)
            err, rel = _rel_err(got, want)
            if not (rel < BLOCK_TOL and torch.isfinite(got).all()):
                raise AssertionError(f"block_fused kernel disagrees at {shape}: {rel} >= {BLOCK_TOL}")
            dropped = args[1] == 0
            if not torch.equal(got[dropped], x[dropped]):
                raise AssertionError(f"block_fused with sd 0 changed its input at {shape}")
            errs.append(err)
            if (batch == 8) == bool((sd == 1).all()):
                timed = args
        worst = max(worst, *errs)
        if s is None:
            print(f"block_fused {shape} (N={batch * shape[1] * shape[2]}): max_abs_err {max(errs):.3e}")
            continue
        t_kernel = _graph_ms(lambda: fused_convnext_block(*timed), iters=10)
        t_eager = _time_ms(lambda: fused_convnext_block(*timed), iters=10)
        t_plain = _graph_ms(lambda: _block_plain(*timed), iters=5)
        print(f"block_fused {shape}: max_abs_err {errs[0]:.3e}, with sd rows (survival {survival:.4f}) "
              f"{errs[1]:.3e} (tol {BLOCK_TOL:g} x max(1, max |plain|)); kernel {t_kernel:.4f} ms device "
              f"(eager {t_eager:.4f}), plain {t_plain:.4f} ms per launch [{card}]")
        ms, plain_ms, n_bytes, n_ops = passes.get(batch, (0.0, 0.0, 0, 0))
        b_bytes, b_ops = block_bound(*shape)
        passes[batch] = (ms + depth * t_kernel, plain_ms + depth * t_plain, n_bytes + depth * b_bytes,
                         n_ops + depth * b_ops)
    for batch, (ms, plain_ms, n_bytes, n_ops) in passes.items():
        bound_ms, bound_by = bound(n_bytes, n_ops, F32_PRODUCT_OPS_PER_S)
        print(f"block_fused per encoder pass at batch {batch} (36 blocks): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
    ms, plain_ms, n_bytes, n_ops = passes[TRAIN_BS]
    return (worst, ms, plain_ms, *bound(n_bytes, n_ops, F32_PRODUCT_OPS_PER_S))


def check_mlp_pipelined(dev, card):
    """The MLP tail's sub-tiled kernel (``TPU_CAPTIONER_MLP_SUB``), for each
    width's valid sub-tile rows (``MLP_SUBS``), against the whole-tile path
    (within PIPE_TOL x max(1, the plain output's largest magnitude)) and
    against ``_mlp_plain`` (MLP_TOL x the same) at the stage shapes at batch
    8 and 32, with per-image scales: rows with scale 0 come out as their
    residual bit for bit, and a second call gives the same bits (the
    cluster's exchange of h in a fixed order).  Device times
    (``_graph_ms``) of the kernel and of the whole-tile path at both batches
    and of the plain version at batch 32, per launch and per encoder pass
    (36 launches) beside the bound.  Its library must hold tensor-core
    (HGMMA) and TMA (UTMALDG) instructions.  Returns the worst absolute
    error against the plain version and the bs-32 encoder pass's kernel ms
    at PIPE_SUB (valid at every width), plain ms and bound."""
    import re

    import torch

    from tpu_captioner_torch.models.convnext import BASE_DEPTHS, BASE_DIMS
    from tpu_captioner_torch.ops.mlp_block import _mlp_plain, fused_convnext_mlp

    text = library_sass("mlp_block")
    hgmma, utma = len(re.findall(r"\bHGMMA\b", text)), len(re.findall(r"\bUTMALDG\b", text))
    print(f"mlp_block library: {hgmma} HGMMA, {utma} UTMALDG")
    if not (hgmma and utma and "fused_kernel" in text):
        raise AssertionError("the mlp_block library must hold the fused kernel, HGMMA and UTMALDG")
    worst, passes, plain_ms, n_bytes, n_ops = 0.0, {}, 0.0, {}, {}
    for s, (depth, c) in enumerate(zip(BASE_DEPTHS, BASE_DIMS)):
        g = torch.Generator().manual_seed(300 + c)
        params = _stage_params(c, g, dev)
        for batch in (8, TRAIN_BS):
            n = batch * (64 >> s) ** 2
            keep = (torch.rand(batch, generator=g) < 0.7).float()
            keep[0], keep[1] = 0.0, 1.0
            sd = (keep / 0.7).repeat_interleave(n // batch).to(dev)
            args = (torch.randn(n, c, generator=g).to(dev), torch.randn(n, c, generator=g).to(dev), sd, *params)
            with mlp_sub(None):
                whole = fused_convnext_mlp(*args)
                t_whole = _graph_ms(lambda: fused_convnext_mlp(*args), iters=10)
            want = _mlp_plain(*args)
            scale = max(1.0, want.abs().max().item())
            line = []
            for sub in MLP_SUBS[c]:
                with mlp_sub(sub):
                    before = fused_convnext_mlp.pipelined_launches
                    got = fused_convnext_mlp(*args)
                    again = fused_convnext_mlp(*args)
                    if fused_convnext_mlp.pipelined_launches != before + 2:
                        raise AssertionError(f"TPU_CAPTIONER_MLP_SUB={sub} did not select the sub-tiled "
                                             f"kernel at C={c}")
                    err_whole = (got - whole).abs().max().item()
                    err = (got - want).abs().max().item()
                    if not (err_whole < PIPE_TOL * scale and err < MLP_TOL * scale and torch.isfinite(got).all()):
                        raise AssertionError(f"mlp_block SUB={sub} at C={c}, N={n}: {err_whole} vs the whole-tile "
                                             f"path (tol {PIPE_TOL} x {scale:.3f}), {err} vs plain (tol {MLP_TOL} x)")
                    dropped = sd == 0
                    if not torch.equal(got[dropped], args[1][dropped]):
                        raise AssertionError(f"mlp_block SUB={sub} with sd 0 changed its residual at C={c}, N={n}")
                    if not torch.equal(got, again):
                        raise AssertionError(f"mlp_block SUB={sub} at C={c}, N={n}: two calls differ")
                    worst = max(worst, err)
                    t = _graph_ms(lambda: fused_convnext_mlp(*args), iters=10)
                    line.append(f"SUB={sub} {err_whole:.2e} / {err:.2e}, {t:.4f} ms")
                    if sub == PIPE_SUB:
                        ms, ms_whole = passes.get(batch, (0.0, 0.0))
                        passes[batch] = (ms + depth * t, ms_whole + depth * t_whole)
            if batch == TRAIN_BS:
                t_plain = _graph_ms(lambda: _mlp_plain(*args), iters=5)
                plain_ms += depth * t_plain
                line.append(f"plain {t_plain:.4f} ms")
            n_bytes[batch] = n_bytes.get(batch, 0) + depth * 4 * (3 * n * c + n + 8 * c * c + 8 * c)
            n_ops[batch] = n_ops.get(batch, 0) + depth * 16 * n * c * c
            print(f"mlp_block sub-tiled C={c} N={n} (vs whole tile / vs plain, abs; tol x {scale:.3f}): "
                  + "; ".join(line) + f"; whole tile {t_whole:.4f} ms, device [{card}]")
    for batch, (ms, ms_whole) in passes.items():
        bound_ms, bound_by = bound(n_bytes[batch], n_ops[batch], F32_PRODUCT_OPS_PER_S)
        print(f"mlp_block SUB={PIPE_SUB} per encoder pass at batch {batch} (36 launches): kernel {ms:.4f} ms, "
              f"whole tile {ms_whole:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, {bound_ms / ms:.1%} of it)"
              + (f", plain {plain_ms:.4f} ms" if batch == TRAIN_BS else "") + f" [{card}]")
    bound_ms, bound_by = bound(n_bytes[TRAIN_BS], n_ops[TRAIN_BS], F32_PRODUCT_OPS_PER_S)
    return worst, passes[TRAIN_BS][0], plain_ms, bound_ms, bound_by


def set_mode(model, mode):
    """Set every ConvNeXt block of ``model`` to ``mode`` (``'mlp'`` with both
    depthwise-conv kernels, or ``'block'``)."""
    from tpu_captioner_torch.models.convnext import CNBlock

    for blk in model.modules():
        if isinstance(blk, CNBlock):
            blk.mode = mode
            blk.use_kernel = blk.dw_kernel = blk.dw_grad_kernel = mode == "mlp"


def block_counts():
    """(block_fused, mlp_block forward, dwconv forward) launches."""
    from tpu_captioner_torch.ops.block_fused import fused_convnext_block
    from tpu_captioner_torch.ops.dwconv import depthwise_conv7x7_nhwc
    from tpu_captioner_torch.ops.mlp_block import fused_convnext_mlp

    return fused_convnext_block.launches, fused_convnext_mlp.launches, depthwise_conv7x7_nhwc.launches


def zero_block_counts():
    from tpu_captioner_torch.ops.block_fused import fused_convnext_block
    from tpu_captioner_torch.ops.dropout_mask import random_mask_pool
    from tpu_captioner_torch.ops.dwconv import depthwise_conv7x7_nhwc
    from tpu_captioner_torch.ops.mlp_block import fused_convnext_mlp, fused_convnext_mlp_bwd

    fused_convnext_block.launches = fused_convnext_mlp.launches = fused_convnext_mlp.pipelined_launches = 0
    fused_convnext_block.bf16_launches = fused_convnext_mlp.pipelined_bf16_launches = 0
    fused_convnext_mlp_bwd.launches = depthwise_conv7x7_nhwc.launches = depthwise_conv7x7_nhwc.grad_launches = 0
    random_mask_pool.launches = 0


def block_serve(dev, card, seed, word_map, images8, rng):
    """Phase 9a and 9e: beam 5 at batch 8 through the CLI's loader with
    ``--usePallas block`` (36 block launches, no MLP-forward or dwconv
    launch), against an every-kernel-off copy; serving times at batch 8 and
    32; then the default model with TPU_CAPTIONER_MLP_SUB=PIPE_SUB, whose
    sub-tiled launches are counted per width, against the whole-tile run.
    Returns the served models ('block', default) and the block and
    sub-tiled launches of one encoder pass."""
    import torch

    from tpu_captioner_torch.cli.caption import build_model_and_params, caption_batch
    from tpu_captioner_torch.core.config import ModelConfig
    from tpu_captioner_torch.models.convnext import CNBlock
    from tpu_captioner_torch.models.from_jax import save_reference_checkpoint
    from tpu_captioner_torch.ops.mlp_block import fused_convnext_mlp
    from tpu_captioner_torch.train.model import CaptionModel

    model = flagship_model(ModelConfig(vocab_size=VOCAB), dev, seed)  # phase 4's weights
    served = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "BEST_checkpoint_block.pth.tar")
        save_reference_checkpoint(model, ckpt, epoch=0)
        for flag in ("block", "auto"):
            cli = argparse.Namespace(checkpoint=ckpt, decoder=None, lstmDecoder=False, embeddingName=None,
                                     device=str(dev), seed=seed + 7, usePallas=flag)
            served[flag] = build_model_and_params(cli, word_map)
    want_sd = model.state_dict()
    for m in served.values():
        if not all(torch.equal(v, want_sd[k]) for k, v in m.state_dict().items()):
            raise AssertionError("checkpoint round trip changed the weights")
    del model
    block = served["block"]
    plain = CaptionModel(dataclasses.replace(block.cfg, **ALL_OFF), device=dev)
    plain.load_state_dict(block.state_dict())
    zero_block_counts()
    got = caption_batch(block, images8.numpy(), word_map, BEAM)
    torch.cuda.synchronize()
    seen = block_counts()
    depths = dict(zip(block.cfg.encoder_dims, block.cfg.encoder_depths))  # width -> blocks (36 in all)
    n_blocks = sum(depths.values())
    print(f"use_pallas 'block' beam-{BEAM} bs 8 via the CLI loader: launches (block_fused, mlp_block forward, "
          f"dwconv) {seen} per encoder pass")
    if seen != (n_blocks, 0, 0):
        raise AssertionError(f"'block': expected ({n_blocks}, 0, 0) launches per encoder pass, got {seen}")
    want = caption_batch(plain, images8.numpy(), word_map, BEAM)
    compare_captions(got, want, plain, images8.to(dev))
    print(f"'block' beam-{BEAM} vs every kernel off: captions agree on {len(got)} images")
    serve_times(card, "serve", {"'block'": block}, rng, dev, word_map)

    # 9e: the default ('auto' = 'mlp') model, whole tile, then sub-tiled.
    default = served["auto"]
    with mlp_sub(None):
        whole = caption_batch(default, images8.numpy(), word_map, BEAM)
    per_width = {}

    def count(blk, *_):
        per_width[blk.block[3].in_features] = per_width.get(blk.block[3].in_features, 0) + (
            fused_convnext_mlp.pipelined_launches - count.last)
        count.last = fused_convnext_mlp.pipelined_launches

    hooks = [blk.register_forward_hook(count) for blk in default.modules() if isinstance(blk, CNBlock)]
    with mlp_sub(PIPE_SUB):
        zero_block_counts()
        count.last = 0
        piped = caption_batch(default, images8.numpy(), word_map, BEAM)
        torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    pipelined = fused_convnext_mlp.pipelined_launches
    print(f"TPU_CAPTIONER_MLP_SUB={PIPE_SUB} beam-{BEAM} bs 8: {pipelined} sub-tiled of "
          f"{fused_convnext_mlp.launches} mlp_block launches; by width {dict(sorted(per_width.items()))}")
    if pipelined != n_blocks or fused_convnext_mlp.launches != n_blocks or per_width != depths:
        raise AssertionError(f"expected {depths} sub-tiled launches per width, got {per_width}")
    compare_captions(piped, whole, plain, images8.to(dev))
    print(f"sub-tiled vs whole-tile MLP tail: captions agree on {len(piped)} images")
    del plain
    return block, default, seen[0], pipelined


def block_eval(dev, card, seed, model, word_map):
    """Phase 9b: the eval step at batch 32 in 'step' on the 'block' model
    against an every-kernel-off copy, with phase 7's agreement rules (the
    natural <end>)."""
    import torch

    from tpu_captioner_torch.core.config import TrainConfig
    from tpu_captioner_torch.train.model import CaptionModel
    from tpu_captioner_torch.train.steps import make_eval_step

    tc = TrainConfig(batch_size=TRAIN_BS)
    steps = tc.max_decode_len
    plain = CaptionModel(dataclasses.replace(model.cfg, **ALL_OFF), device=dev)
    plain.load_state_dict(model.state_dict())
    batch = {k: v.to(dev) for k, v in train_batch(torch.Generator().manual_seed(seed + 9), word_map, VOCAB).items()}
    model.cfg = dataclasses.replace(model.cfg, decode_kernel="step")
    runs = {}
    for label, m in (("block", model), ("off", plain)):
        m.decoder.capture_alphas = True
        zero_block_counts()
        t0 = time.perf_counter()
        aux = make_eval_step(m, tc, word_map)(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        seen = block_counts()
        with torch.inference_mode():
            roll = m.rollout(m.encode(batch["images"]), word_map["<start>"], word_map["<end>"], steps)
        runs[label] = (aux, roll)
        print(f"eval 'block' phase, {label}: launches (block_fused, mlp_block, dwconv) {seen}; loss "
              f"{float(aux['loss']):.6f}, top5 {int(aux['top5_correct'])}; eval step {ms:.2f} ms [{card}]")
        n_blocks = sum(m.cfg.encoder_depths)
        if seen != ((n_blocks, 0, 0) if label == "block" else (0, 0, 0)) or not torch.isfinite(roll[0]).all():
            raise AssertionError(f"eval {label}: unexpected launches {seen} or non-finite logits")
    logit_err, alpha_err, ties = compare_rollouts("eval 'block'", runs["block"][1], runs["off"][1])
    print(f"  'block' vs off: logits {logit_err:.3e}, maps {alpha_err:.3e}, {len(ties)} rows differ at a near-tie")
    if not ties:
        got, want = runs["block"][0], runs["off"][0]
        rel = abs(float(got["loss"]) - float(want["loss"])) / abs(float(want["loss"]))
        same = all(torch.equal(got[k], want[k]) for k in ("sequences", "lengths", "tokens", "top5_correct"))
        if not (rel < 1e-4 and same):
            raise AssertionError(f"eval 'block': metrics disagree with 'off' (loss rel {rel})")
    del plain


def block_train(dev, card, seed, word_map):
    """Phase 9c and 9d: two frozen steps with 'block' against 'on' on the
    same pool bits (loss and top-5 within 1e-5); two fine-tune steps
    (starting_layer 5, remat 'off') with 'block' against an every-kernel-off
    copy, with phase 6's tolerances (``fine_tune_agree``), their launches
    counted; then ms per fine-tune step and peak memory.  Returns the
    fine-tune step's launches."""
    import torch

    from tpu_captioner_torch.core import prng
    from tpu_captioner_torch.core.config import ModelConfig, TrainConfig
    from tpu_captioner_torch.ops.dropout_mask import random_mask_pool
    from tpu_captioner_torch.ops.dwconv import depthwise_conv7x7_nhwc as dwconv
    from tpu_captioner_torch.ops.mlp_block import fused_convnext_mlp_bwd
    from tpu_captioner_torch.train.model import CaptionModel
    from tpu_captioner_torch.train.state import TrainState
    from tpu_captioner_torch.train.steps import make_train_step

    tc = TrainConfig(batch_size=TRAIN_BS)
    cfg = ModelConfig(vocab_size=VOCAB, use_pallas="block", encoder_remat="off")
    gen = torch.Generator().manual_seed(seed + 17)
    model = CaptionModel(cfg, device=dev, seed=seed + 17)
    with torch.no_grad():  # order-one layer scales, as in phases 3 and 5
        for blk in (m for m in model.modules() if hasattr(m, "layer_scale")):
            blk.layer_scale.copy_(0.1 * torch.rand(blk.layer_scale.shape, generator=gen))
    start = copy.deepcopy(model.state_dict())
    batch = {k: v.to(dev) for k, v in train_batch(gen, word_map, VOCAB).items()}
    root = prng.root_seed(seed + 17)
    seeds = [prng.step_seed(root, "dropout", 0, i) for i in range(2)]

    def counts():
        return (random_mask_pool.launches, *block_counts(), fused_convnext_mlp_bwd.launches, dwconv.grad_launches)

    def two_steps(m, train_encoder):
        m.load_state_dict(start)
        state = TrainState.create(m, tc)
        step = make_train_step(m, tc, word_map, train_encoder=train_encoder)
        out, grads, seen = [], [], []
        for s in seeds:
            zero_block_counts()
            state, met = step(state, batch, s)
            torch.cuda.synchronize()
            seen.append(counts())
            out.append({k: float(v) for k, v in met.items()})
            grads.append({k: p.grad.clone() for k, p in m.named_parameters() if p.grad is not None})
        return out, grads, {k: v.clone() for k, v in m.state_dict().items()}, seen

    names = "(dropout_mask, block_fused, mlp_block, dwconv, mlp_block_bwd, dwconv_grad)"
    n_blocks = sum(cfg.encoder_depths)  # 36; 30 of them train (stages at children 5 and 7)
    trained = sum(d for s, d in enumerate(cfg.encoder_depths) if 2 * s + 1 >= FT_START)
    # 9c: frozen steps, 'block' against 'on' (the same pool kernel's bits).
    on = CaptionModel(dataclasses.replace(cfg, use_pallas="on"), device=dev)
    got, _, _, seen = two_steps(model, False)
    want, _, _, seen_on = two_steps(on, False)
    print(f"frozen step 'block': launches {names} {seen[0]}; 'on': {seen_on[0]}")
    if any(c != (1, n_blocks, 0, 0, 0, 0) for c in seen) or any(c != (1, 0, n_blocks, n_blocks, 0, 0)
                                                                for c in seen_on):
        raise AssertionError(f"frozen step launches: 'block' {seen}, 'on' {seen_on}")
    for i, (a, b) in enumerate(zip(got, want)):
        print(f"frozen step {i}: 'block' {a}; 'on' {b}")
        if not (abs(a["loss"] - b["loss"]) <= 1e-5 and abs(a["top5_correct"] - b["top5_correct"]) <= 1e-5
                and math.isfinite(a["loss"])):
            raise AssertionError(f"frozen step {i}: 'block' and 'on' disagree")
    del on
    # 9d: fine-tune steps, 'block' against every kernel off.
    plain = CaptionModel(dataclasses.replace(cfg, **ALL_OFF), device=dev)
    got, grads, params, seen = two_steps(model, True)
    print(f"fine-tune step 'block': launches {names} {seen[0]} per step")
    # The trained blocks' conv recomputed, and their input gradients but the
    # first's (its input is the frozen child 4's output): 30 + 29.
    expect = (1, n_blocks, 0, 2 * trained - 1, trained, trained)
    if any(c != expect for c in seen):
        raise AssertionError(f"fine-tune step 'block': expected launches {expect}, got {seen}")
    want, want_grads, want_params, _ = two_steps(plain, True)
    fine_tune_agree("fine-tune 'block'", got, want, grads, want_grads, params, want_params, start, tc.encoder_lr)
    del plain, grads, want_grads
    torch.cuda.empty_cache()
    state = TrainState.create(model, tc)
    step = make_train_step(model, tc, word_map, train_encoder=True)
    for i in range(2):
        state, _ = step(state, batch, prng.step_seed(root, "dropout", 1, i))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(5):
        t0 = time.perf_counter()
        state, met = step(state, batch, prng.step_seed(root, "dropout", 2, i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = sorted(times)[len(times) // 2]
    print(f"fine-tune step 'block' bs={TRAIN_BS} starting_layer {FT_START}, remat 'off': median {ms:.2f} ms/step "
          f"over 5 steps (min {min(times):.2f}, max {max(times):.2f}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss {float(met['loss']):.4f} [{card}]")
    return seen[0]


def block_ab(card, block, default, rng, dev):
    """Phase 9f, recorded only: paired A/Bs (``paired_ab``) of bs-32 encoder
    passes on one model, 'block' against 'on', and the sub-tiled MLP tail
    (PIPE_SUB) against the whole-tile one.  ``'auto'`` does not change."""
    import torch

    imgs = torch.randint(0, 256, (TRAIN_BS, 256, 256, 3), generator=rng, dtype=torch.uint8).to(dev)
    with torch.inference_mode():
        paired_ab("'block' vs 'on', encoder pass bs 32", card, lambda: block.encode(imgs),
                  lambda: set_mode(block, "block"), lambda: set_mode(block, "mlp"), other="'on'")
        set_mode(block, "block")
        with mlp_sub(None):
            paired_ab(f"sub-tiled (SUB={PIPE_SUB}) vs whole-tile MLP tail, encoder pass bs 32", card,
                      lambda: default.encode(imgs),
                      lambda: os.environ.__setitem__("TPU_CAPTIONER_MLP_SUB", str(PIPE_SUB)),
                      lambda: os.environ.pop("TPU_CAPTIONER_MLP_SUB", None), other="whole tile")


TRAIN_DATA = {"TRAIN": 64, "VAL": 32, "TEST": 32}  # phase 10's synthetic images per split
TRAIN_DATA_NAME = "synthetic_5_cap_per_img_1_min_word_freq"
# Phase 10: validation raises the vocab head's bias on EVAL_WORD, a word of
# class 0's synthetic caption, by EVAL_MARGIN, so that word is every greedy
# argmax: each rollout runs max_decode_len tokens and the corpus BLEU-1 is
# known in advance.  A logit less its bias is a head row (norm ~0.58 at init,
# Adam moving each element by at most ~3 lr a step) times a LayerNorm'd row
# of norm sqrt(512): two logits' biases aside differ by under 40 in the
# phase's 30 steps.
EVAL_WORD, EVAL_MARGIN = "w0", 100.0
FREE_TIMED_STEPS = 5


def kernel_counts():
    """Every kernel's launch count, by the name of its ``kernels`` entry."""
    from tpu_captioner_torch.ops.block_fused import fused_convnext_block
    from tpu_captioner_torch.ops.decode_step import fused_decode_step, fused_full_rollout
    from tpu_captioner_torch.ops.dropout_mask import random_mask_pool
    from tpu_captioner_torch.ops.dwconv import depthwise_conv7x7_nhwc
    from tpu_captioner_torch.ops.lstm_step import fused_lstm_step
    from tpu_captioner_torch.ops.mlp_block import fused_convnext_mlp, fused_convnext_mlp_bwd

    return {
        "mlp_block": fused_convnext_mlp.launches, "mlp_block_bwd": fused_convnext_mlp_bwd.launches,
        "decode_step": fused_decode_step.launches, "dropout_mask": random_mask_pool.launches,
        "decode_onecell": fused_decode_step.onecell_launches, "decode_rollout": fused_full_rollout.launches,
        "dwconv": depthwise_conv7x7_nhwc.launches, "dwconv_grad": depthwise_conv7x7_nhwc.grad_launches,
        "lstm_step": fused_lstm_step.launches, "block_fused": fused_convnext_block.launches,
        "mlp_block_pipelined": fused_convnext_mlp.pipelined_launches,
        "mlp_block_bf16": fused_convnext_mlp.bf16_launches, "dwconv_bf16": depthwise_conv7x7_nhwc.bf16_launches,
        "decode_step_bf16": fused_decode_step.bf16_launches,
        "mlp_block_bwd_bf16": fused_convnext_mlp_bwd.bf16_launches,
        "dwconv_grad_bf16": depthwise_conv7x7_nhwc.bf16_grad_launches,
        "lstm_step_bf16": fused_lstm_step.bf16_launches,
        "decode_onecell_bf16": fused_decode_step.onecell_bf16_launches,
        "decode_rollout_bf16": fused_full_rollout.bf16_launches,
        "block_fused_bf16": fused_convnext_block.bf16_launches,
        "mlp_block_pipelined_bf16": fused_convnext_mlp.pipelined_bf16_launches,
        **bf16_products_counts(),
    }


def zero_kernel_counts():
    from tpu_captioner_torch.ops.decode_step import fused_decode_step, fused_full_rollout
    from tpu_captioner_torch.ops.lstm_step import fused_lstm_step

    from tpu_captioner_torch.ops.dwconv import depthwise_conv7x7_nhwc
    from tpu_captioner_torch.ops.mlp_block import fused_convnext_mlp, fused_convnext_mlp_bwd

    zero_block_counts()
    fused_decode_step.launches = fused_decode_step.onecell_launches = fused_full_rollout.launches = 0
    fused_lstm_step.launches = fused_lstm_step.bf16_launches = 0
    fused_decode_step.onecell_bf16_launches = fused_full_rollout.bf16_launches = 0
    fused_convnext_mlp.bf16_launches = depthwise_conv7x7_nhwc.bf16_launches = fused_decode_step.bf16_launches = 0
    fused_convnext_mlp_bwd.bf16_launches = depthwise_conv7x7_nhwc.bf16_grad_launches = 0
    zero_bf16_products_counts()


def count_delta(before, after, names=("dropout_mask", "mlp_block", "mlp_block_bwd", "dwconv", "dwconv_grad")):
    return tuple(after[k] - before[k] for k in names)


@contextlib.contextmanager
def counted_trainer_steps(record, eval_word):
    """Count each train step's and each eval step's launches of the Trainers
    built inside the ``with``: per train step (dropout_mask, mlp_block,
    mlp_block_bwd, dwconv, dwconv_grad) in ``record['train']`` with the
    step's kind; per eval step (mlp_block, decode_step launches, tokens run,
    the shortest row's length) in ``record['eval']``.  Counts are read
    around each call, not zeroed.  Each eval step runs with the head's
    bias on ``eval_word`` (an id) raised by ``EVAL_MARGIN`` and restored
    after it."""
    import torch

    from tpu_captioner_torch.train import loop

    make_train, make_eval = loop.make_train_step, loop.make_eval_step

    def train_step(model, cfg, word_ids, *, teacher_forcing=True, train_encoder=False, **kw):
        step = make_train(model, cfg, word_ids, teacher_forcing=teacher_forcing, train_encoder=train_encoder, **kw)
        kind = ("TF" if teacher_forcing else "free-running") + (", fine-tune" if train_encoder else ", frozen")

        def counted(state, batch, seed):
            before = kernel_counts()
            out = step(state, batch, seed)
            record["train"].append((kind, count_delta(before, kernel_counts())))
            return out

        return counted

    def eval_step(model, cfg, word_ids, **kw):
        step = make_eval(model, cfg, word_ids, **kw)
        dec, tokens = model.decoder, [0]
        embed = dec.embed

        def counted_embed(*a):  # one lookup per token of the per-token kernel rollout
            tokens[0] += 1
            return embed(*a)

        def counted(batch):
            before, tokens[0] = kernel_counts(), 0
            bias = dec.fc_out.bias
            kept = bias[eval_word].item()
            with torch.no_grad():
                bias[eval_word] = kept + EVAL_MARGIN
            dec.embed = counted_embed
            try:
                out = step(batch)
            finally:
                del dec.embed
                with torch.no_grad():
                    bias[eval_word] = kept
            after = kernel_counts()
            record["eval"].append((after["mlp_block"] - before["mlp_block"],
                                   after["decode_step"] - before["decode_step"], tokens[0],
                                   int(out["lengths"].min())))
            return out

        return counted

    loop.make_train_step, loop.make_eval_step = train_step, eval_step
    try:
        yield
    finally:
        loop.make_train_step, loop.make_eval_step = make_train, make_eval


def one_word_bleu1(dataset, word, steps, start, pad):
    """Corpus BLEU-1 of hypotheses that repeat ``word`` ``steps`` times, one
    per row of ``dataset`` (references: the row's image's captions without
    ``start`` and ``pad``), counted here from the records: the clipped
    count of ``word`` over the hypotheses' length, times the brevity
    penalty of the closest reference lengths."""
    from tpu_captioner_torch.data.dataset import iterate_batches

    clipped = ref_len = rows = 0
    for b in iterate_batches(dataset, TRAIN_BS, shuffle=False):
        for caps in b.all_captions[b.valid]:
            refs = [[w for w in cap if w not in (start, pad)] for cap in caps]
            clipped += min(steps, max(r.count(word) for r in refs))
            ref_len += min((len(r) for r in refs), key=lambda n: (abs(n - steps), n))
            rows += 1
    hyp_len = rows * steps
    return clipped / hyp_len * (1.0 if hyp_len > ref_len else math.exp(1 - ref_len / hyp_len))


def check_counts(label, record, expect_train, layers, steps):
    """Every train step of ``record`` launched as ``expect_train[kind]``
    says; every eval step 36 mlp_block launches and ``layers`` decode
    launches per token over ``steps`` tokens, every row of it that long.
    Returns the distinct per-step counts."""
    seen = {}
    for kind, c in record["train"]:
        seen.setdefault(kind, set()).add(c)
        if c != expect_train[kind]:
            raise AssertionError(f"{label}: a {kind} step launched (dropout_mask, mlp_block, mlp_block_bwd, "
                                 f"dwconv, dwconv_grad) {c}, expected {expect_train[kind]}")
    for mlp, dec, tokens, shortest in record["eval"]:
        if mlp != 36 or tokens != steps or shortest != steps or dec != layers * tokens:
            raise AssertionError(f"{label}: an eval step launched {mlp} mlp_block and {dec} decode_step over "
                                 f"{tokens} tokens, its shortest row {shortest} tokens long (expected 36, "
                                 f"{layers} per token, and {steps} tokens in every row)")
    print(f"{label}: per-step launches (dropout_mask, mlp_block, mlp_block_bwd, dwconv, dwconv_grad) "
          + "; ".join(f"{k} x{sum(1 for kk, _ in record['train'] if kk == k)}: {sorted(v)}" for k, v in seen.items())
          + f"; {len(record['eval'])} eval steps, decode_step launches per token {layers}, tokens "
          + str([t for _, _, t, _ in record["eval"]]) + ", every row that long")
    return seen


def training_phase(dev, card, seed, keep=None):
    """Phase 10: the training entry point on the card, at full width (the
    flagship: ConvNeXt-Base, 6-layer E=512 Transformer, f32).  (a) a
    learnable synthetic dataset at 256x256 whose word map has VOCAB
    entries; (b) ``cli.train`` through ``main``, batch 32, one free-running
    epoch, every step's and validation's launches counted; (c) the Trainer
    with ``fine_tune_epoch=1`` over two teacher-forced epochs, then a resume
    from the epoch-0 checkpoint; (d) ``cli.test`` on (b)'s checkpoint; (e)
    two free-running frozen steps with the kernels against an
    every-kernel-off copy; (f) ms per free-running step, images/s, peak
    memory, the device's idle share of a step under ``torch.profiler``, and
    the Trainer's batch and data times.  (b) and (c) are the
    main path: every count is zeroed before (b) and read after (c), and
    their totals are returned by kernel name.  With ``keep`` (a directory),
    (a)'s records and (b)'s ``BEST_`` checkpoint are moved there as ``ds``
    and ``best`` for phase 15; the rest is removed."""
    import csv as csv_module
    import shutil

    import torch

    from tpu_captioner_torch.cli import test as cli_test, train as cli_train
    from tpu_captioner_torch.core import prng
    from tpu_captioner_torch.core.config import ExperimentConfig, ModelConfig, TrainConfig
    from tpu_captioner_torch.data.build import build_synthetic_dataset
    from tpu_captioner_torch.data.dataset import CaptionDataset, iterate_batches
    from tpu_captioner_torch.train import loop
    from tpu_captioner_torch.train.model import CaptionModel
    from tpu_captioner_torch.train.state import TrainState
    from tpu_captioner_torch.train.steps import make_train_step

    t10 = time.perf_counter()
    cwd = os.getcwd()
    tmp = tempfile.mkdtemp(prefix="smoke_train_")
    try:
        # (a) The data.
        ds = os.path.join(tmp, "ds")
        word_map = build_synthetic_dataset(ds, num_images=dict(TRAIN_DATA), vocab_words=VOCAB - 4,
                                           max_len=TRAIN_T - 2, image_size=256, learnable=True)
        if len(word_map) != VOCAB:
            raise AssertionError(f"the synthetic word map has {len(word_map)} entries, not {VOCAB}")
        n_train = 5 * TRAIN_DATA["TRAIN"] // TRAIN_BS
        print(f"phase 10a: learnable synthetic dataset, {TRAIN_DATA} images at 256x256, 5 captions each, "
              f"word map {len(word_map)} entries ({time.perf_counter() - t10:.1f} s)")

        # (b) cli.train through main: free-running, batch 32, one epoch.
        os.chdir(tmp)
        zero_kernel_counts()
        record_b = {"train": [], "eval": []}
        with counted_trainer_steps(record_b, word_map[EVAL_WORD]):
            trainer_b = cli_train.main(["--dataFolder", ds, "--dataName", TRAIN_DATA_NAME, "--batchSize",
                                        str(TRAIN_BS), "--epochs", "1", "--device", dev.type])
        torch.cuda.synchronize()
        layers, steps = trainer_b.exp.model.num_layers, trainer_b.exp.train.max_decode_len
        check_counts("phase 10b cli.train (free-running)", record_b,
                     {"free-running, frozen": (0, 36, 0, 36, 0)}, layers, steps)
        bleu1 = one_word_bleu1(CaptionDataset(ds, TRAIN_DATA_NAME, "VAL"), word_map[EVAL_WORD], steps,
                               word_map["<start>"], word_map["<pad>"])
        if len(record_b["train"]) != n_train or len(record_b["eval"]) != 5 * TRAIN_DATA["VAL"] // TRAIN_BS:
            raise AssertionError(f"phase 10b ran {len(record_b['train'])} train and {len(record_b['eval'])} "
                                 "eval steps")
        (row_b,) = trainer_b.results
        name = trainer_b.checkpoint_name()
        ckpt_b = os.path.join(tmp, "checkpoints", name)
        best_b = os.path.join(tmp, "checkpoints", f"BEST_{name}")
        csv_b = os.path.join(tmp, "results", "metrics-transformer(trainingNoTF-inferenceNoTF-Finetuning5-None).csv")
        with open(csv_b) as f:
            rows = list(csv_module.DictReader(f))
        if not (all(math.isfinite(row_b[k]) for k in ("trainLoss", "valLoss")) and bleu1 > 0
                and abs(row_b["bleu1"] - bleu1) <= 1e-12 * bleu1 and os.path.isdir(best_b)
                and sorted(os.listdir(ckpt_b)) == sorted(os.listdir(best_b)) == ["meta.json", "state.pt"]
                and len(rows) == 1 and list(rows[0]) == list(loop.RESULT_KEYS)
                and float(rows[0]["trainLoss"]) == row_b["trainLoss"]):
            raise AssertionError(f"phase 10b: row {row_b}, checkpoint or CSV missing or malformed")
        print(f"phase 10b: row {row_b} (BLEU-1 of {steps} x {EVAL_WORD!r} counted from the records: {bleu1!r}); "
              f"checkpoint {sorted(os.listdir(ckpt_b))}, BEST_ copy, CSV "
              f"{os.path.basename(csv_b)} ({time.perf_counter() - t10:.1f} s)")
        del trainer_b
        torch.cuda.empty_cache()

        # (c) The Trainer directly: TF, the unlock at epoch 1, then a resume.
        saved = {}
        real_save = loop.save_checkpoint

        def save(directory, name, state, meta, is_best=False):
            base = real_save(directory, name, state, meta, is_best)
            if meta["epoch"] == 0:
                shutil.copytree(base, os.path.join(tmp, "epoch0"))
                saved["dec_opt"] = copy.deepcopy(state.dec_opt.state_dict())
                saved["enc_opt"] = copy.deepcopy(state.enc_opt.state_dict())
                saved["encoder"] = {k: v.clone() for k, v in state.model.encoder.state_dict().items()}
            return base

        def experiment(**kw):
            return ExperimentConfig(model=ModelConfig(), train=TrainConfig(
                batch_size=TRAIN_BS, epochs=2, fine_tune_epoch=1, teacher_forcing=True, print_freq=1000,
                checkpoint_dir=os.path.join(tmp, "c", "ckpt"), results_dir=os.path.join(tmp, "c", "results"), **kw))

        record_c = {"train": [], "eval": []}
        loop.save_checkpoint = save
        try:
            with counted_trainer_steps(record_c, word_map[EVAL_WORD]):
                trainer_c = loop.Trainer(experiment(), ds, TRAIN_DATA_NAME, device=dev, verbose=False)
                rows_c = trainer_c.run()
        finally:
            loop.save_checkpoint = real_save
        torch.cuda.synchronize()
        totals = kernel_counts()  # phase 10's main path: (b) and (c)
        check_counts("phase 10c Trainer (TF, unlock at epoch 1)", record_c,
                     {"TF, frozen": (1, 36, 0, 36, 0), "TF, fine-tune": (1, 36, 30, 65, 30)}, layers, steps)
        kinds = [k for k, _ in record_c["train"]]
        if kinds != ["TF, frozen"] * n_train + ["TF, fine-tune"] * n_train:
            raise AssertionError(f"phase 10c steps {kinds}")
        if not all(abs(r["bleu1"] - bleu1) <= 1e-12 * bleu1 and math.isfinite(r["trainLoss"]) for r in rows_c):
            raise AssertionError(f"phase 10c: rows {rows_c}, BLEU-1 counted from the records {bleu1!r}")
        encoder = trainer_c.model.encoder.state_dict()
        unchanged = {i: all(torch.equal(v, saved["encoder"][k]) for k, v in encoder.items()
                            if int(k.split(".")[1]) == i) for i in range(8)}
        if [i for i, same in unchanged.items() if same] != list(range(FT_START)):
            raise AssertionError(f"phase 10c: children unchanged by epoch 1: {unchanged}")
        print(f"phase 10c: rows {rows_c}; children unchanged by the fine-tune epoch {sorted(i for i, s in unchanged.items() if s)}")
        del trainer_c
        torch.cuda.empty_cache()
        resumed = loop.Trainer(experiment(checkpoint=os.path.join(tmp, "epoch0")), ds, TRAIN_DATA_NAME,
                               device=dev, verbose=False)

        def same(a, b):
            if isinstance(a, torch.Tensor):
                return torch.equal(a, b)
            if isinstance(a, dict):
                return set(a) == set(b) and all(same(a[k], b[k]) for k in a)
            if isinstance(a, (list, tuple)):
                return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
            return a == b

        if not (resumed.start_epoch == 1 and same(resumed.state.dec_opt.state_dict(), saved["dec_opt"])
                and same(resumed.state.enc_opt.state_dict(), saved["enc_opt"]) and saved["dec_opt"]["state"]):
            raise AssertionError("phase 10c: the resumed Adam states differ from the saved ones")
        print(f"phase 10c: resumed at epoch {resumed.start_epoch}: both Adam states equal the epoch-0 ones "
              f"({len(saved['dec_opt']['state'])} decoder tensors with state) ({time.perf_counter() - t10:.1f} s)")
        del resumed, saved
        torch.cuda.empty_cache()

        # (d) cli.test on (b)'s checkpoint.
        test_row = cli_test.main(["--dataFolder", ds, "--dataName", TRAIN_DATA_NAME, "--batchSize", str(TRAIN_BS),
                                  "--checkpoint", best_b, "--device", dev.type])
        test_csv = os.path.join(tmp, "results", "test-transformer-Finetuning5-None.csv")
        if not (all(math.isfinite(v) for v in test_row.values()) and os.path.exists(test_csv)):
            raise AssertionError(f"phase 10d: test row {test_row}")
        print(f"phase 10d: cli.test on the BEST_ checkpoint of 10b: {test_row}")

        # (e) Two free-running frozen steps, kernels against every kernel off.
        tc = TrainConfig(batch_size=TRAIN_BS, teacher_forcing=False)
        batch = next(iterate_batches(CaptionDataset(ds, TRAIN_DATA_NAME, "TRAIN"), TRAIN_BS, seed=tc.seed))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.as_dict().items()}
        cfg = ModelConfig(vocab_size=VOCAB)
        model = CaptionModel(cfg, device=dev, seed=seed + 21)
        gen = torch.Generator().manual_seed(seed + 21)
        with torch.no_grad():  # order-one layer scales, as in phase 5
            for blk in (m for m in model.modules() if hasattr(m, "layer_scale")):
                blk.layer_scale.copy_(0.1 * torch.rand(blk.layer_scale.shape, generator=gen))
        start = copy.deepcopy(model.state_dict())
        root = prng.root_seed(seed + 22)
        seeds = [prng.step_seed(root, "dropout", 0, i) for i in range(2)]

        def two_steps(m):
            """Two steps from ``start``: their metrics, decoder gradients and
            (logits, sequences) of their rollouts, and the parameters after."""
            m.load_state_dict(start)
            state = TrainState.create(m, tc)
            step = make_train_step(m, tc, word_map, teacher_forcing=False)
            out, grads, rolls = [], [], []

            def rollout(*a, **k):
                logits, seqs, alphas = CaptionModel.rollout(m, *a, **k)
                rolls.append((logits.detach(), seqs, torch.zeros(seqs.shape + (1,), device=seqs.device)))
                return logits, seqs, alphas

            m.rollout = rollout
            for s in seeds:
                state, met = step(state, batch, s)
                out.append({k: float(v) for k, v in met.items()})
                grads.append({k: p.grad.clone() for k, p in m.decoder.named_parameters() if p.grad is not None})
            del m.rollout
            return out, grads, rolls, {k: v.clone() for k, v in m.decoder.state_dict().items()}

        got, grads, rolls, params = two_steps(model)
        plain = CaptionModel(dataclasses.replace(cfg, **ALL_OFF), device=dev)
        want, want_grads, want_rolls, want_params = two_steps(plain)
        del plain
        forked = False
        for i, (a, b) in enumerate(zip(got, want)):
            print(f"phase 10e free-running step {i}: kernels {a}; plain {b}")
            if forked:
                print(f"  step {i}: not compared (a near-tie changed a sequence of an earlier step)")
                continue
            logit_err, _, ties = compare_rollouts(f"phase 10e step {i}", rolls[i], want_rolls[i])
            print(f"  rollout vs plain: logits {logit_err:.3e} (tol {LOGIT_TOL:g}), {len(ties)} rows differ at a "
                  f"near-tie, {int((want_rolls[i][1] != 0).sum())} tokens emitted, "
                  f"{len(torch.unique(want_rolls[i][1]))} distinct")
            if ties:
                forked = True
                print(f"  step {i}: loss, counts and parameters not compared (a near-tie changed a sequence)")
                continue
            if not (abs(a["loss"] - b["loss"]) <= 1e-4 and a["tokens"] == b["tokens"]
                    and a["top5_correct"] == b["top5_correct"] and math.isfinite(a["loss"])):
                raise AssertionError(f"phase 10e step {i}: kernels and plain disagree")
        if not forked:
            worst = 0.0
            for k, p in params.items():
                if k not in grads[0]:
                    continue
                sure = (want_grads[0][k].abs() >= 1e-7) & (want_grads[1][k].abs() >= 1e-7)
                err = (p - want_params[k]).abs()[sure]
                worst = max(worst, err.max().item() if err.numel() else 0.0)
            print(f"phase 10e: updated decoder parameters, kernels vs plain: max abs diff {worst:.3e} "
                  f"(tol {1e-2 * tc.decoder_lr:g})")
            if not worst <= 1e-2 * tc.decoder_lr:
                raise AssertionError("phase 10e: updated parameters disagree")
        del rolls, want_rolls

        # (f) Time per free-running step; the Trainer's batch and data times.
        state = TrainState.create(model, tc)
        step = make_train_step(model, tc, word_map, teacher_forcing=False)
        state, _ = step(state, batch, seeds[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(FREE_TIMED_STEPS):
            t0 = time.perf_counter()
            state, met = step(state, batch, prng.step_seed(root, "dropout", 1, i))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        ms = sorted(times)[len(times) // 2]
        print(f"phase 10f: free-running step bs={TRAIN_BS}, frozen encoder, 51 tokens: median {ms:.2f} ms/step "
              f"over {FREE_TIMED_STEPS} steps (min {min(times):.2f}, max {max(times):.2f}), "
              f"{TRAIN_BS / (ms / 1e3):.1f} images/s, peak memory {peak / 2**30:.2f} GiB, loss "
              f"{float(met['loss']):.4f} [{card}]")
        state, groups, top, launches, wall_ms = _kernel_ms_by_group(
            step, state, batch, [prng.step_seed(root, "dropout", 2, 0)])
        busy_ms = sum(groups.values())
        print(f"phase 10f: free-running step under torch.profiler: {wall_ms:.2f} ms wall, {busy_ms:.2f} ms of "
              f"kernels ({launches} launches) per step: the device idles {1 - busy_ms / wall_ms:.1%} of the step; "
              "kernel ms by group: " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(groups.items(), key=lambda kv: -kv[1]))
              + f" [{card}]")
        for ms_k, name in top:
            print(f"  {ms_k:8.2f} ms/step  {name}")
        for label, row in (("10b free-running", row_b), ("10c TF epoch 0", rows_c[0]), ("10c TF epoch 1 (fine-tune)",
                                                                                      rows_c[1])):
            print(f"phase 10f: Trainer {label}: batch_time {row['trainBatchTime'] * 1e3:.2f} ms, data_time "
                  f"{row['trainDataTime'] * 1e3:.3f} ms per batch (host clock, steps not synchronised) [{card}]")
        del model, state, step
        torch.cuda.empty_cache()
        if keep is not None:
            shutil.move(ds, os.path.join(keep, "ds"))
            shutil.move(best_b, os.path.join(keep, "best"))
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    missing = [k for k in ("mlp_block", "mlp_block_bwd", "decode_step", "dropout_mask", "dwconv", "dwconv_grad")
               if totals[k] == 0]
    if missing:
        raise AssertionError(f"phase 10: kernels of the training path never launched: {missing}")
    print(f"phase 10 launches over (b) and (c): {totals}; phase 10 took {time.perf_counter() - t10:.1f} s")
    return totals


# Phase 11: compute_dtype='bfloat16' serving.  A bf16 output against its
# plain version: one bf16 ulp of the plain value (2^(floor(log2 |plain|) -
# 7)), at least 2^-8 (the ulp of values in [0.5, 1)): sums of f32 terms in
# another order may round to the neighbouring bf16 value, and no further.
# The decode arm's f32 outputs of one launch (x_out, alpha):
# BF16_F32_TOL x max(1, the plain output's largest magnitude), the class of
# one bf16 rounding of an operand (2^-8) that another summation order can
# flip inside a product.  Over several layers and tokens such flips feed the
# next products' roundings, and two correct implementations part further:
# the plain version with its sums in f64 (``_decode_step_plain_bf16(...,
# sums=float64)``) parts from itself in f32 by 1.4e-3 to 3.0e-3 over six
# layers (NVIDIA H100 80GB HBM3, 700 W).  So the six-layer step, the
# beam's scores of its candidates (``beam_lockstep``; its decisions to a
# near-tie of twice that) and the eval step's rollouts are held to
# BF16_NOISE times that noise floor, measured in the same run on the same
# inputs (at least BF16_F32_TOL, and a differing greedy token to a
# near-tie of that size).
BF16_F32_TOL = 2e-3
BF16_NOISE = 2.0
BF16_SHAPES = tuple((b, 64 >> s, 64 >> s, c) for b in (8, 32) for s, c in enumerate((128, 256, 512, 1024)))


def bf16_ulp_err(got, want):
    """(max abs error, max error in units of the plain value's bf16 ulp,
    floored at 2^-8) of a bf16 output against its plain version."""
    import torch

    want = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -8))) - 7).clamp_min(2.0 ** -8)
    diff = (got.float() - want).abs()
    return diff.max().item(), (diff / ulp).max().item()


def bf16_rel(a, b):
    """max |a - b| over max(1, max |b|), in f64."""
    return (a.double() - b.double()).abs().max().item() / max(1.0, b.abs().max().item())


@contextlib.contextmanager
def plain_versions(decode_sums=None, encoder_sums=None, encoder=True):
    """The serving and training paths' kernel wrappers replaced by their
    plain versions on the card (as phase 5 swaps the pool for
    ``_mask_plain``): the MLP tail's forward and backward, the whole
    block's forward (its backward's wrappers with the others), the depthwise
    conv's forward (also the input gradient) and filter gradient, the
    per-token decode step (per-layer and one-cell), the whole-rollout
    decode and the LSTM step, each by dtype (the bf16 arm's own plain
    version in bf16, its sums in ``decode_sums`` when given: float64 for the
    noise floor).  ``encoder_sums=torch.float64`` takes the bf16 encoder's plain
    versions with their sums in f64 (each output rounded where the bf16
    instance rounds it): the bf16 steps' noise floor.  ``encoder=False``
    keeps the encoder's kernels, so that a decode is compared on the same
    features.  The kernels' path is held against what runs inside."""
    import torch

    from tpu_captioner_torch.infer import beam
    from tpu_captioner_torch.ops import block_fused, decode_step, dwconv, lstm_step, mlp_block

    saved = mlp_block._mlp_forward, dwconv.dwconv_forward, decode_step.fused_decode_step
    saved_bwd = mlp_block.fused_convnext_mlp_bwd, dwconv.dwconv_filter_grad
    saved_dec = decode_step.fused_full_rollout, lstm_step.fused_lstm_step
    saved_block = (block_fused._block_forward, block_fused.dwconv_forward, block_fused.dwconv_filter_grad,
                   block_fused.fused_convnext_mlp_bwd)
    bf = torch.bfloat16
    wide = encoder_sums is not None  # the bf16 plain versions with their sums in encoder_sums

    def mlp(*args, precise=True):
        if not precise:
            return mlp_block._mlp_plain_bf16_products(*args)
        if args[0].dtype != bf:
            return mlp_block._mlp_plain(*args)
        if not wide:
            return mlp_block._mlp_plain_bf16(*args)
        return mlp_block._mlp_plain(*(t.to(encoder_sums) for t in args)).to(bf)

    def mlp_bwd(*args, precise=True):
        if not precise:
            return mlp_block._mlp_bwd_plain_bf16_products(*args)
        if not wide:
            return (mlp_block._mlp_bwd_plain_bf16 if args[1].dtype == bf else mlp_block._mlp_bwd_plain)(*args)
        # bf16 x, or (the bf16 'block' backward) f32 x and weights widened from bf16.
        d_x, *rest = mlp_block._mlp_bwd_plain(*(t.to(encoder_sums) for t in args))
        return (d_x.to(args[1].dtype), *(t.float() for t in rest))

    def block(*args):
        if args[0].dtype != bf:
            return block_fused._block_plain(*args)
        if not wide:
            return block_fused._block_plain_bf16(*args)
        return block_fused._block_plain(*(t.to(encoder_sums) for t in args)).to(bf)

    def dw(x, w, flip=False, bias=None):
        w = w.flip(0, 1) if flip else w
        if x.dtype != bf or not wide:
            return dwconv._dw_plain(x, w, bias)
        y = dwconv._dw_plain(x.to(encoder_sums), w.to(encoder_sums)).to(bf)
        return y if bias is None else y + bias

    def dw_grad(x, g, bias_grad=False):
        if x.dtype != bf or not wide:
            return dwconv._dw_grad_plain(x, g, bias_grad)
        h, w_ = x.shape[1:3]
        xp = torch.nn.functional.pad(x.to(encoder_sums), (0, 0, 3, 3, 3, 3))
        g = g.to(encoder_sums)
        taps = [(xp[:, dy: dy + h, dx: dx + w_] * g).sum(dim=(0, 1, 2)) for dy in range(7) for dx in range(7)]
        dw_ = torch.stack(taps).reshape(7, 7, -1).float()
        return (dw_, g.sum(dim=(0, 1, 2)).float()) if bias_grad else dw_

    def dec(w, x, pos, ck, cv, mk, mv, heads, *, one_cell=False, precise=None):
        bf16 = w.w_qkv.dtype == torch.bfloat16
        if bf16:
            return decode_step._decode_step_plain_bf16(w, x, int(pos), ck, cv, mk, mv, heads,
                                                       decode_sums or torch.float32)
        return decode_step._decode_step_plain(w, x, int(pos), ck, cv, mk, mv, heads)

    def roll(w, *args, **kw):
        if w.w_qkv.dtype == torch.bfloat16:
            return decode_step._full_rollout_plain_bf16(w, *args, **kw, sums=decode_sums or torch.float32)
        return decode_step._full_rollout_plain(w, *args, **kw)

    def lstm(w, *args):
        if w.wd.dtype == torch.bfloat16:
            return lstm_step._lstm_step_plain_bf16(w, *args, sums=decode_sums or torch.float32)
        return lstm_step._lstm_step_plain(w, *args)

    if encoder:
        mlp_block._mlp_forward, dwconv.dwconv_forward = mlp, dw
        mlp_block.fused_convnext_mlp_bwd, dwconv.dwconv_filter_grad = mlp_bwd, dw_grad
        (block_fused._block_forward, block_fused.dwconv_forward, block_fused.dwconv_filter_grad,
         block_fused.fused_convnext_mlp_bwd) = block, dw, dw_grad, mlp_bwd
    decode_step.fused_decode_step = beam.fused_decode_step = dec
    decode_step.fused_full_rollout, lstm_step.fused_lstm_step = roll, lstm
    beam.fused_lstm_step = lstm
    try:
        yield
    finally:
        mlp_block._mlp_forward, dwconv.dwconv_forward, decode_step.fused_decode_step = saved
        mlp_block.fused_convnext_mlp_bwd, dwconv.dwconv_filter_grad = saved_bwd
        decode_step.fused_full_rollout, lstm_step.fused_lstm_step = saved_dec
        beam.fused_decode_step, beam.fused_lstm_step = saved[2], saved_dec[1]
        (block_fused._block_forward, block_fused.dwconv_forward, block_fused.dwconv_filter_grad,
         block_fused.fused_convnext_mlp_bwd) = saved_block


def check_bf16_kernels(dev, card, layers):
    """Phase 11a: the three bf16 instances against their plain versions on
    the card, at the flagship's shapes: the depthwise conv's forward (with
    the block's bias, and without) and the MLP tail at the four
    ConvNeXt-Base stages at batch 8 and 32, each output within one bf16 ulp,
    timed by CUDA-graph replay (the conv beside ``F.conv2d(groups=C)`` in
    bf16 with the bias); the per-layer decode step's bf16 arm on
    ``layers``' weights at the bs-8 and bs-32 beams' 40 and 160 rows, the
    eval step's 32 and a one-image beam's 5, cache length 52, four
    positions, with NaN in every cache slot at or past pos: x_out and alpha
    within BF16_F32_TOL, k_new and v_new within one ulp; device times by
    CUDA-graph replay, beside CUDA-event times of eager calls.
    Returns {kernel: (worst error, ms, plain ms, library ms, bound ms,
    bound by)}: per bs-32 encoder pass (36 launches) for the conv and the
    tail, per 6-layer step at R = 40 for the decode arm."""
    import torch
    import torch.nn.functional as F

    from tpu_captioner_torch.models.convnext import BASE_DEPTHS
    from tpu_captioner_torch.ops.decode_step import (
        _decode_step_plain_bf16, cast_weight_matrices, fused_decode_step, prepare_decode_weights,
    )
    from tpu_captioner_torch.ops.dwconv import _dw_plain, dwconv_forward
    from tpu_captioner_torch.ops.mlp_block import _mlp_plain_bf16, fused_convnext_mlp

    bf = torch.bfloat16
    sums = {"dwconv_bf16": [0.0, 0.0, 0.0, 0.0, 0, 0], "mlp_block_bf16": [0.0, 0.0, 0.0, None, 0, 0]}
    for b, h, w, c in BF16_SHAPES:
        depth = BASE_DEPTHS[(128, 256, 512, 1024).index(c)]
        g = torch.Generator().manual_seed(300 + c + b)
        f = lambda *sh: torch.randn(*sh, generator=g)  # noqa: E731
        x, res = f(b, h, w, c).to(dev, bf), f(b * h * w, c).to(dev, bf)
        taps, bias = (0.1 * f(7, 7, c)).to(dev, bf), (0.1 * f(c)).to(dev, bf)
        err, ulps = bf16_ulp_err(dwconv_forward(x, taps, bias=bias), _dw_plain(x, taps, bias))
        err_nb, ulps_nb = bf16_ulp_err(dwconv_forward(x, taps), _dw_plain(x, taps))
        if not max(ulps, ulps_nb) <= 1.0:
            raise AssertionError(f"dwconv bf16 kernel disagrees at {(b, h, w, c)}: {ulps} ulps with the bias, "
                                 f"{ulps_nb} without")
        wc = taps.permute(2, 0, 1).unsqueeze(1).contiguous()
        t_dw = (_graph_ms(lambda: dwconv_forward(x, taps, bias=bias)), _graph_ms(lambda: _dw_plain(x, taps, bias)),
                _graph_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2), wc, bias, padding=3, groups=c)))
        rows = x.view(-1, c)
        vec = tuple(v.to(dev) for v in (1 + 0.1 * f(c), 0.1 * f(c)))
        args = (rows, res, torch.ones(b * h * w, device=dev), *vec, (0.02 * f(4 * c, c)).to(dev, bf),
                (0.1 * f(4 * c)).to(dev), (0.02 * f(c, 4 * c)).to(dev, bf), (0.1 * f(c)).to(dev),
                (0.5 * f(c)).to(dev))
        m_err, m_ulps = bf16_ulp_err(fused_convnext_mlp(*args), _mlp_plain_bf16(*args))
        if not m_ulps <= 1.0:
            raise AssertionError(f"mlp_block bf16 kernel disagrees at N={b * h * w}, C={c}: {m_ulps} ulps")
        t_mlp = (_graph_ms(lambda: fused_convnext_mlp(*args)), _graph_ms(lambda: _mlp_plain_bf16(*args)))
        print(f"bf16 dwconv {(b, h, w, c)}: max_abs_err {err:.3e} with the bias ({ulps:.2f} ulp), {err_nb:.3e} "
              f"without ({ulps_nb:.2f} ulp); kernel {t_dw[0]:.4f} ms, plain {t_dw[1]:.4f}, F.conv2d bf16 "
              f"{t_dw[2]:.4f} per launch | bf16 mlp_block N={b * h * w}: max_abs_err {m_err:.3e} "
              f"({m_ulps:.2f} ulp); kernel {t_mlp[0]:.4f} ms, plain {t_mlp[1]:.4f} per launch [{card}]")
        if b != TRAIN_BS:
            continue
        n = b * h * w * c
        for name, e, times, n_bytes, n_ops in (
            # x in, y out, the filter and the bias: 2 bytes each; 49 FMAs an output.
            ("dwconv_bf16", max(err, err_nb), t_dw, 2 * (2 * n + 50 * c), 2 * 49 * n),
            # x, residual and out in bf16, the matrices in bf16, the vectors
            # f32 (LayerNorm, biases, gamma) and sd; two N x C x 4C products.
            ("mlp_block_bf16", m_err, t_mlp, 2 * (3 * n + 8 * c * c) + 4 * (8 * c + b * h * w),
             16 * b * h * w * c * c),
        ):
            acc = sums[name]
            acc[0] = max(acc[0], e)
            for i, t in enumerate(times):
                acc[1 + i] += depth * t
            acc[4] += depth * n_bytes
            acc[5] += depth * n_ops
            if name == "mlp_block_bf16":
                one, one_by = bound(n_bytes, n_ops, BF16_BY_F32_OPS_PER_S)
                print(f"bf16 mlp_block N={b * h * w} C={c}: kernel {times[0]:.4f} ms per launch ({depth} a pass), "
                      f"bound {one:.4f} ms ({one_by}), {one / times[0]:.1%} of it [{card}]")
    out = {}
    for name, (err, ms, plain_ms, lib_ms, n_bytes, n_ops) in sums.items():
        # The bf16 conv's products are bf16 x bf16, exact in f32 and summed in
        # f32: the tensor cores could do them, so the bf16 rate prices them.
        rate = BF16_BY_F32_OPS_PER_S if name == "mlp_block_bf16" else BF16_OPS_PER_S
        bound_ms, bound_by = bound(n_bytes, n_ops, rate)
        out[name] = (err, ms, plain_ms, lib_ms, bound_ms, bound_by)
        lib = "" if lib_ms is None else f", F.conv2d bf16 {lib_ms:.4f} ms"
        print(f"{name} per bs-{TRAIN_BS} encoder pass (36 launches): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
              f"{lib}, bound {bound_ms:.4f} ms ({bound_by}; bytes {n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms, "
              f"operations {n_ops / rate * 1e3:.4f} ms) [{card}]")

    # The decode arm: each layer's launch alone (one layer's weights, caches
    # and memory), then the six-layer step against the plain version and
    # against the noise floor (the plain version with its sums in f64).
    L, E, P, H = len(layers), layers[0].linear1.in_features, 49, 8
    Fd = layers[0].linear1.out_features
    w = cast_weight_matrices(prepare_decode_weights(layers, E), bf)
    g = torch.Generator().manual_seed(11)
    f = lambda *sh: torch.randn(*sh, generator=g).to(dev, bf)  # noqa: E731

    for rows in (DECODE_ROWS, BEAM * TRAIN_BS, TRAIN_BS, BEAM):
        worst, times, eager_times, plain_times, n_bytes, n_ops = 0.0, [], [], [], 0, 0
        for pos in (0, 1, 25, DECODE_T - 1):
            ck, cv = f(L, rows, DECODE_T, E), f(L, rows, DECODE_T, E)
            ck[:, :, pos:] = float("nan")
            cv[:, :, pos:] = float("nan")
            mk, mv, x = f(L, rows, P, E), f(L, rows, P, E), f(rows, E)
            args = (w, x, pos, ck, cv, mk, mv, H)
            launch = [0.0, 0.0, 0.0]  # worst x, alpha (relative), k/v ulps over the layers' launches
            for l in range(L):
                one = tuple(t[l : l + 1].contiguous() for t in (ck, cv, mk, mv))
                a1 = (type(w)(*(t[l : l + 1].contiguous() for t in w)), x, pos, *one, H)
                got, want = fused_decode_step(*a1), _decode_step_plain_bf16(*a1)
                if not (all(torch.isfinite(t.float()).all() for t in got)
                        and [t.dtype for t in got] == [torch.float32, torch.float32, bf, bf]):
                    raise AssertionError(f"decode bf16 arm: non-finite or mistyped outputs at R={rows}, pos {pos}")
                errs = (bf16_rel(got[0], want[0]), bf16_rel(got[1], want[1]),
                        max(bf16_ulp_err(got[2], want[2])[1], bf16_ulp_err(got[3], want[3])[1]))
                launch = [max(u, v) for u, v in zip(launch, errs)]
                worst = max(worst, *((got[i] - want[i]).float().abs().max().item() for i in range(4)))
            if not (launch[0] < BF16_F32_TOL and launch[1] < BF16_F32_TOL and launch[2] <= 1.0):
                raise AssertionError(f"decode bf16 arm, one layer's launch at R={rows}, pos {pos}: x {launch[0]}, "
                                     f"alpha {launch[1]} (tol {BF16_F32_TOL}), k/v {launch[2]} ulps")
            got, want = fused_decode_step(*args), _decode_step_plain_bf16(*args)
            ref = _decode_step_plain_bf16(*args, sums=torch.float64)
            step = (bf16_rel(got[0], want[0]), bf16_rel(got[1], want[1]))
            floor = (bf16_rel(want[0], ref[0]), bf16_rel(want[1], ref[1]))
            if not all(e <= max(BF16_F32_TOL, BF16_NOISE * n) for e, n in zip(step, floor)):
                raise AssertionError(f"decode bf16 arm, {L}-layer step at R={rows}, pos {pos}: x {step[0]}, alpha "
                                     f"{step[1]} against the noise floor {floor}")
            times.append(_graph_ms(lambda: fused_decode_step(*args)))
            eager_times.append(_time_ms(lambda: fused_decode_step(*args)))
            plain_times.append(_time_ms(lambda: _decode_step_plain_bf16(*args), iters=5, warmup=1))
            print(f"bf16 decode_step R={rows} pos={pos}: one layer's launch: x {launch[0]:.3e}, alpha {launch[1]:.3e} "
                  f"(relative, tol {BF16_F32_TOL:g}), k/v {launch[2]:.2f} ulp (tol 1); {L}-layer step: x "
                  f"{step[0]:.3e}, alpha {step[1]:.3e}, k/v {bf16_ulp_err(got[2], want[2])[1]:.2f} ulp; noise floor "
                  f"(plain, f32 vs f64 sums) x {floor[0]:.3e}, alpha {floor[1]:.3e}; kernel {times[-1]:.4f} ms "
                  f"device (graph replay), {eager_times[-1]:.4f} eager, plain {plain_times[-1]:.4f} ms per {L}-layer "
                  f"step [{card}]")
            # Per layer: the bf16 matrices, the f32 vectors, pos cached k/v
            # rows and P memory rows in bf16, k/v new out in bf16; x in (bf16)
            # and out (f32), alpha; the products at the bf16 rate.
            n_bytes += (L * (2 * (6 * E * E + 2 * E * Fd) + 4 * (9 * E + Fd) + 2 * rows * (2 * pos + 2 * P + 2) * E)
                        + rows * (6 * E + 4 * P))
            n_ops += L * rows * (2 * (6 * E * E + 2 * E * Fd) + 4 * E * (pos + 1 + P))
        bound_ms, bound_by = bound(n_bytes / 4, n_ops / 4, BF16_OPS_PER_S)
        ms, plain_ms = sum(times) / len(times), sum(plain_times) / len(plain_times)
        print(f"bf16 decode_step at R={rows}, mean over the four positions: kernel {ms:.4f} ms device (graph "
              f"replay), {sum(eager_times) / len(eager_times):.4f} eager, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of it, per step [{card}]")
        if rows == DECODE_ROWS:
            out["decode_step_bf16"] = (worst, ms, plain_ms, None, bound_ms, bound_by)
        else:
            out["decode_step_bf16"] = (max(worst, out["decode_step_bf16"][0]), *out["decode_step_bf16"][1:])
    return out


def kernel_beam(model):
    """The beam adapter of ``model``'s family with its decode kernel (the
    wrappers' plain versions inside ``plain_versions``)."""
    from tpu_captioner_torch.infer.beam import _lstm_attention_beam, _lstm_plain_beam, _transformer_beam_fused

    return {"lstm": _lstm_attention_beam, "lstm_no_attention": _lstm_plain_beam}.get(
        model.cfg.decoder, _transformer_beam_fused)


def tf_scores(model, enc, seqs):
    """Each token sequence's cumulative log-prob under the beam's step of
    ``model`` (``kernel_beam``, beam 1), teacher-forced: ``enc`` holds one
    encoder row per sequence.  Float64 sums of the steps."""
    import torch

    n, T = len(seqs), max(len(s) for s in seqs)
    toks = torch.zeros(n, T, dtype=torch.long, device=enc.device)
    for i, q in enumerate(seqs):
        toks[i, : len(q)] = torch.as_tensor(q, device=enc.device)
    lens = torch.as_tensor([len(q) for q in seqs], device=enc.device)
    with torch.inference_mode():
        step_fn, _, state = kernel_beam(model)(model, enc, 1, T)
        total = torch.zeros(n, dtype=torch.float64, device=enc.device)
        for pos in range(T - 1):
            state, logits, _ = step_fn(state, toks[:, pos : pos + 1], pos)
            logp = torch.log_softmax(logits[:, 0].float(), -1).gather(1, toks[:, pos + 1 : pos + 2])[:, 0]
            total += torch.where(pos + 1 < lens, logp, 0.0).double()
    return total


def beam_lockstep(model, enc, start_id, end_id):
    """The kernels' beam over ``enc`` (beam BEAM x MAX_STEPS by the rules of
    ``infer/beam.py:_beam_loop``, at its B x BEAM rows) run in lock step
    with the all-plain step (``plain_versions()``) and the all-plain step
    with f64 sums, both fed the kernels' beam's tokens and reshuffles, so
    that the three score the same candidates.  Returns (the kernels'
    sequences (B, MAX_STEPS + 2), their lengths, drift, noise, gap): drift
    is the largest difference between the kernels' and the plain step's
    cumulative scores of a candidate the beam kept; noise the same between
    the plain step and its f64 self, on the kept candidates and the best
    dropped one; gap the most by which the plain step ranks a candidate the
    beam dropped above one it kept at a step, or a completed caption above
    the one it picked."""
    import torch
    import torch.nn.functional as F

    B, k, V = enc.shape[0], BEAM, model.cfg.vocab_size
    dev, inf = enc.device, float("inf")
    arms = (contextlib.nullcontext, plain_versions, lambda: plain_versions(torch.float64))
    adapters = [kernel_beam(model)(model, enc, k, MAX_STEPS) for _ in arms]
    states = [a[2] for a in adapters]
    slots, ar = torch.arange(k, device=dev), torch.arange(B, device=dev)
    words = torch.full((B, k), start_id, dtype=torch.long, device=dev)
    cum = torch.zeros(len(arms), B, k, device=dev)
    alive = (slots == 0).expand(B, k).clone()
    live = torch.full((B,), k, dtype=torch.long, device=dev)
    seqs = torch.zeros(B, k, MAX_STEPS + 2, dtype=torch.long, device=dev)
    seqs[:, :, 0] = start_id
    best = torch.full((B,), -inf, device=dev)  # the kernels' best completed score
    best_seq, best_len = torch.zeros_like(seqs[:, 0]), torch.zeros_like(live)
    pick_p = torch.full((B,), -inf, device=dev)  # the plain score of the kernels' pick
    done_p = torch.full((B,), -inf, device=dev)  # the best plain score of a completed caption
    drift = noise = gap = 0.0
    t = 1
    while t <= MAX_STEPS + 1 and bool((live > 0).any()):
        frozen = live == 0
        cand = []
        for i, (arm, (step_fn, _, _)) in enumerate(zip(arms, adapters)):
            with arm():
                states[i], logits, _ = step_fn(states[i], words, t - 1)
            logp = F.log_softmax(logits.float(), dim=-1)
            cand.append(torch.where(alive[:, :, None], cum[i][:, :, None] + logp, -inf).view(B, k * V))
        top, idx = cand[0].topk(k, dim=1)
        kept = (slots[None, :] < live[:, None]) & ~frozen[:, None]
        act = kept.any(1)
        sel = [c.gather(1, idx) for c in cand]
        dropped = cand[1].scatter(1, idx, torch.where(kept, -inf, sel[1]))
        j = dropped.argmax(1, keepdim=True)
        best_dropped = dropped.gather(1, j)[:, 0]
        gap = max(gap, torch.where(act, best_dropped - torch.where(kept, sel[1], inf).amin(1), -inf).max().item())
        drift = max(drift, torch.where(kept, (sel[0] - sel[1]).abs(), 0.0).max().item())
        noise = max(noise, torch.where(kept, (sel[1] - sel[2]).abs(), 0.0).max().item(),
                    torch.where(act & torch.isfinite(best_dropped),
                                (cand[1] - cand[2]).gather(1, j)[:, 0].abs(), 0.0).max().item())

        nw, prev = idx % V, idx // V
        is_end = nw == end_id
        new_seqs = seqs.gather(1, prev[:, :, None].expand_as(seqs))
        new_seqs[:, :, t] = nw
        new_seqs = torch.where(frozen[:, None, None], seqs, new_seqs)
        comp = torch.where(kept & is_end, top, -inf)
        b = comp.argmax(1)
        improved = comp[ar, b] > best
        best = torch.where(improved, comp[ar, b], best)
        pick_p = torch.where(improved, sel[1][ar, b], pick_p)
        best_seq = torch.where(improved[:, None], new_seqs[ar, b], best_seq)
        best_len = torch.where(improved, torch.full_like(best_len, t + 1), best_len)
        done_p = torch.maximum(done_p, torch.where(kept & is_end, sel[1], -inf).amax(1))

        alive = kept & ~is_end
        rows = (ar[:, None] * k + prev).reshape(-1)
        words = torch.where(frozen[:, None], words, nw)
        for i, (_, gather_fn, _) in enumerate(adapters):
            cum[i] = torch.where(frozen[:, None], cum[i], torch.where(alive, sel[i], -inf))
            states[i] = gather_fn(states[i], rows)
        live = alive.sum(1)
        seqs = new_seqs
        t += 1
    none = torch.isneginf(best)  # no caption completed: the best live beam
    fb = cum[0].argmax(1)
    seq = torch.where(none[:, None], seqs[ar, fb], best_seq)
    length = torch.where(none, torch.full_like(best_len, t), best_len)
    final = torch.where(none, cum[1].amax(1), done_p) - torch.where(none, cum[1][ar, fb], pick_p)
    if not torch.isfinite(final).all():
        raise AssertionError("beam_lockstep: a picked caption without a finite plain score")
    return seq, length, drift, noise, max(gap, final.max().item())


def parted_at(a, b):
    """[(image, first differing token)] of two ``caption_batch`` results."""
    return [(j, next((i for i in range(min(len(x), len(y))) if x[i] != y[i]), min(len(x), len(y))))
            for j, ((_, _, x, _), (_, _, y, _)) in enumerate(zip(a, b))
            if not (len(x) == len(y) and (x == y).all())]


def prefix_gaps(model, enc, a, b, parts):
    """For each (image, token) of ``parts``: the gap between the all-plain
    step's scores of the two captions' prefixes up to that token."""
    import torch

    if not parts:
        return []
    seqs = [r[j][2][: s + 1] for r in (a, b) for j, s in parts]
    with plain_versions():
        sc = tf_scores(model, enc[[j for j, _ in parts] * 2], seqs)
    return [abs(sc[i] - sc[len(parts) + i]).item() for i in range(len(parts))]


def bf16_agree(model, dev, bs, imgs, word_map, got, want):
    """Phase 11b's agreement of the kernels' path with the all-plain path on
    a bf16 model.  The encoder features within 2^-6 x max(1, max |plain|)
    (four bf16 ulps of the largest value).  The captions: the kernels' beam
    replayed by ``beam_lockstep`` must end on ``got``'s captions; the plain
    step's scores of the candidates it kept within BF16_NOISE times the
    noise floor (the plain step against its f64 self on the same
    candidates; at least BF16_F32_TOL); and each of its decisions (the
    candidates kept at a step, the caption picked among the completed ones)
    the plain step's, except at a near-tie under twice that tolerance: phase
    4's near-tie rule in the beam's form, with the bf16 noise floor as the
    gap (two correct bf16 decodes part by tenths of a nat over 51 tokens).
    Reported beside it: which captions equal the all-plain path's
    (``want``), and the all-plain path with f64 sums against ``want`` as
    the witness of how often and how far two correct bf16 beams part, each
    with the plain prefix-score gap where a pair parts."""
    import torch

    from tpu_captioner_torch.cli.caption import caption_batch

    with torch.inference_mode():
        images = torch.from_numpy(imgs).to(dev)
        enc = model.encode(images)
        with plain_versions():
            enc_plain = model.encode(images)
    enc_err = (enc.float() - enc_plain.float()).abs().max().item() / max(1.0, enc_plain.float().abs().max().item())
    if not enc_err <= 2.0 ** -6:
        raise AssertionError(f"bf16 serving bs={bs}: encoder features off by {enc_err} of the largest")
    with torch.inference_mode():
        seq, length, drift, noise, gap = beam_lockstep(model, enc, word_map["<start>"], word_map["<end>"])
    seq, length = seq.cpu().numpy(), length.cpu().numpy()
    if not all(int(length[j]) == len(c[2]) and (seq[j, : len(c[2])] == c[2]).all() for j, c in enumerate(got)):
        raise AssertionError(f"bf16 serving bs={bs}: the lock-step replay did not end on the kernels' captions")
    with plain_versions(torch.float64):
        ref = caption_batch(model, imgs, word_map, BEAM)
    tol = max(BF16_F32_TOL, BF16_NOISE * noise)
    lines = []
    for label, a in (("kernels", got), ("all-plain with f64 sums", ref)):
        parts = parted_at(a, want)
        gaps = prefix_gaps(model, enc, a, want, parts)
        lines.append(f"{label} vs all-plain: {bs - len(parts)} of {bs} captions equal ("
                     + (", ".join(f"image {j} parts at token {s_}, prefix gap {g:.3e}"
                                  for (j, s_), g in zip(parts, gaps)) or "all") + ")")
    print(f"bf16 serving bs={bs}: encoder features {enc_err:.3e} of the largest (tol {2.0 ** -6:g}); the kernels' "
          f"beam in lock step at {bs * BEAM} rows: scores of the kept candidates, kernels vs all-plain {drift:.3e} "
          f"(tol {tol:.3e}; noise floor {noise:.3e}), the plain step's largest disagreement with a decision "
          f"{gap:.3e} (tol {2 * tol:.3e}); " + "; ".join(lines))
    if not (drift <= tol and gap < 2 * tol):
        raise AssertionError(f"bf16 serving bs={bs}: the kernels' beam scores its candidates {drift} off the "
                             f"all-plain step (tol {tol}) or decides {gap} against it (tol {2 * tol})")


def bf16_phase(dev, card, seed, word_map, images8, rng):
    """Phase 11b-d: a bf16 flagship (phase 4's weights) saved with
    ``save_checkpoint`` and loaded through ``cli.caption``'s loader (its
    ``meta.json`` says bfloat16); beam 5 x 50 at batch 8 and 32 through
    ``caption_batch``, counting the bf16 instances' launches (36 mlp_block
    and 36 dwconv per encoder pass, L decode_step per token), captions
    that agree with the all-plain bf16 path's (``plain_versions``) at its
    noise floor (``bf16_agree``), the share equal to the f32 model's
    reported; encoder ms, beam ms and captions/s beside the f32 model's, and
    the weights' casts per encoder pass; then the eval step at batch 32, 51
    tokens, in 'step' against the all-plain path with phase 7's rules at the
    noise floor's tolerances, and against the f32 plain decode ('off')
    reported.  Returns the bf16 instances' launches on the bs-8 serving
    run."""
    import torch

    from tpu_captioner_torch.cli.caption import build_model_and_params, caption_batch
    from tpu_captioner_torch.core.config import ExperimentConfig, ModelConfig, TrainConfig
    from tpu_captioner_torch.ops.decode_step import fused_decode_step
    from tpu_captioner_torch.ops.dwconv import depthwise_conv7x7_nhwc
    from tpu_captioner_torch.ops.mlp_block import fused_convnext_mlp
    from tpu_captioner_torch.train.checkpoint import save_checkpoint
    from tpu_captioner_torch.train.state import TrainState
    from tpu_captioner_torch.train.steps import make_eval_step

    t0 = time.perf_counter()
    cfg = ModelConfig(vocab_size=VOCAB, compute_dtype="bfloat16")
    with tempfile.TemporaryDirectory() as tmp:
        model = flagship_model(cfg, dev, seed)
        meta = {"epoch": 0, "epochs_since_improvement": 0, "bleu4": 0.0, "results": [],
                "config": dataclasses.asdict(ExperimentConfig(model=cfg, train=TrainConfig()))}
        path = save_checkpoint(tmp, "checkpoint_bf16_smoke", TrainState.create(model, TrainConfig()), meta)
        served = build_model_and_params(argparse.Namespace(checkpoint=path, device=str(dev), seed=seed + 7), word_map)
    want_sd = model.state_dict()
    if not (served.cfg.compute_dtype == "bfloat16" and served.dtype == torch.bfloat16
            and all(torch.equal(v, want_sd[k]) for k, v in served.state_dict().items())):
        raise AssertionError("the bf16 checkpoint did not load as the bf16 model it was saved from")
    del model
    f32 = flagship_model(ModelConfig(vocab_size=VOCAB), dev, seed)
    images = {8: images8.numpy(), TRAIN_BS: torch.randint(0, 256, (TRAIN_BS, 256, 256, 3), generator=rng,
                                                          dtype=torch.uint8).numpy()}
    launches = None
    for bs, imgs in images.items():
        steps = [0]
        embed = served.decoder.embed

        def counted_embed(*a):  # one lookup per generated token
            steps[0] += 1
            return embed(*a)

        served.decoder.embed = counted_embed
        fused_convnext_mlp.bf16_launches = depthwise_conv7x7_nhwc.bf16_launches = fused_decode_step.bf16_launches = 0
        got = caption_batch(served, imgs, word_map, BEAM)
        torch.cuda.synchronize()
        seen = (fused_convnext_mlp.bf16_launches, depthwise_conv7x7_nhwc.bf16_launches,
                fused_decode_step.bf16_launches)
        del served.decoder.embed
        print(f"bf16 serving bs={bs}: bf16 launches (mlp_block, dwconv, decode_step) {seen} over {steps[0]} tokens")
        if seen != (36, 36, served.cfg.num_layers * steps[0]) or steps[0] < 1:
            raise AssertionError(f"bf16 serving bs={bs}: expected (36, 36, L x tokens) bf16 launches, got {seen}")
        if launches is None:
            launches = {"mlp_block_bf16": seen[0], "dwconv_bf16": seen[1], "decode_step_bf16": seen[2]}
        for cap, score, seq, alpha in got:
            if not (seq[0] == word_map["<start>"] and alpha.shape == (len(seq), cfg.num_pixels)
                    and np_isfinite(alpha) and math.isfinite(score)):
                raise AssertionError("malformed bf16 caption output")
        with plain_versions():
            want = caption_batch(served, imgs, word_map, BEAM)
        bf16_agree(served, dev, bs, imgs, word_map, got, want)
        ref = caption_batch(f32, imgs, word_map, BEAM)
        same = sum(len(a[2]) == len(r[2]) and bool((a[2] == r[2]).all()) for a, r in zip(got, ref))
        print(f"bf16 serving bs={bs}: {same} of {bs} captions equal to the f32 model's ({same / bs:.4f}); "
              f"caption 0: {got[0][0][:60]!r} (f32: {ref[0][0][:60]!r})")
    serve_times(card, "serve bf16 phase", {"bf16": served, "f32": f32}, rng, dev, word_map)
    # The weights' casts to bf16 at use, alone: every conv's weight and bias
    # (stem, downsamples, the blocks' depthwise convs) and the blocks' two
    # matrices.
    params = [t for m in served.encoder.modules() for t in (
        (m.weight, m.bias) if isinstance(m, torch.nn.Conv2d) else (m.weight,) if isinstance(m, torch.nn.Linear)
        else ())]
    cast_ms = _time_ms(lambda: [p.to(torch.bfloat16) for p in params])
    print(f"bf16 encoder: the weights' casts alone {cast_ms:.4f} ms per encoder pass ({len(params)} casts of "
          f"{sum(p.numel() for p in params)} values) [{card}]")

    # 11c: the eval step, 'step' against the all-plain path (and that path
    # with the decode's sums in f64, the noise floor), and against 'off'.
    tc = TrainConfig(batch_size=TRAIN_BS)
    batch = {k: v.to(dev) for k, v in train_batch(torch.Generator().manual_seed(seed + 9), word_map, VOCAB).items()}
    served.decoder.capture_alphas = True
    start, end, steps = word_map["<start>"], word_map["<end>"], tc.max_decode_len
    runs = {}
    for label, mode, sums in (("step", "step", None), ("all-plain", "step", torch.float32),
                              ("all-plain f64", "step", torch.float64), ("off", "off", None)):
        served.cfg = dataclasses.replace(cfg, decode_kernel=mode)
        step = make_eval_step(served, tc, word_map)
        with plain_versions(sums) if sums is not None else contextlib.nullcontext():
            fused_convnext_mlp.bf16_launches = fused_decode_step.bf16_launches = 0
            aux = step(batch)
            torch.cuda.synchronize()
            seen = (fused_convnext_mlp.bf16_launches, fused_decode_step.bf16_launches)
            with torch.inference_mode():
                roll = served.rollout(served.encode(batch["images"]), start, end, steps)
        need = int(aux["lengths"].max())
        expect = {"step": (36, served.cfg.num_layers * need), "off": (36, 0)}.get(label, (0, 0))
        print(f"bf16 eval {label}: bf16 launches (mlp_block, decode_step) {seen}; loss {float(aux['loss']):.6f}, "
              f"tokens {int(aux['tokens'])}, top5 {int(aux['top5_correct'])}")
        if seen != expect or not (torch.isfinite(roll[0]).all() and math.isfinite(float(aux["loss"]))):
            raise AssertionError(f"bf16 eval {label}: expected launches {expect}, got {seen}, or a non-finite output")
        runs[label] = (step, aux, roll)
    served.cfg = dataclasses.replace(cfg, decode_kernel="step")
    inf = float("inf")
    noise_logit, noise_alpha, _ = compare_rollouts("noise floor", runs["all-plain f64"][2], runs["all-plain"][2],
                                                   inf, inf, inf)
    logit_tol = max(BF16_F32_TOL * max(1.0, runs["all-plain"][2][0].abs().max().item()), BF16_NOISE * noise_logit)
    alpha_tol = max(BF16_F32_TOL, BF16_NOISE * noise_alpha)
    logit_err, alpha_err, ties = compare_rollouts("bf16 eval 'step'", runs["step"][2], runs["all-plain"][2],
                                                  logit_tol, alpha_tol, logit_tol)
    loss, want_loss = float(runs["step"][1]["loss"]), float(runs["all-plain"][1]["loss"])
    loss_floor = abs(float(runs["all-plain f64"][1]["loss"]) - want_loss) / abs(want_loss)
    loss_err = abs(loss - want_loss) / abs(want_loss)
    print(f"bf16 eval 'step' vs all-plain: logits {logit_err:.3e} (tol {logit_tol:.3e}; noise floor "
          f"{noise_logit:.3e}), maps {alpha_err:.3e} (tol {alpha_tol:.3e}; floor {noise_alpha:.3e}), loss "
          f"{loss_err:.3e} relative (floor {loss_floor:.3e}), {len(ties)} rows differ at a near-tie")
    if not ties and not (loss_err <= max(BF16_F32_TOL, BF16_NOISE * loss_floor) and all(
            torch.equal(runs["step"][1][k], runs["all-plain"][1][k]) for k in ("sequences", "tokens"))):
        raise AssertionError(f"bf16 eval 'step' disagrees with the all-plain path: loss {loss} vs {want_loss}")
    gs, ws = runs["step"][2][1], runs["off"][2][1]
    print(f"bf16 eval 'step' vs 'off' (the f32 plain decode, reported): sequences equal in "
          f"{(gs == ws).all(dim=1).float().mean().item():.4f} of rows, logits differ by up to "
          f"{(runs['step'][2][0] - runs['off'][2][0]).abs().max().item():.3e}, loss {loss:.6f} vs "
          f"{float(runs['off'][1]['loss']):.6f}")
    eval_ms, _ = _host_ms(lambda: runs["step"][0](batch))
    print(f"bf16 eval bs={TRAIN_BS} 'step': eval step {eval_ms:.2f} ms [{card}]; phase 11 took "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


# Phase 12: compute_dtype='bfloat16' training.  (a) holds the two new bf16
# backward instances and the flipped bf16 conv against their plain versions
# at the fine-tune step's shapes: a bf16 output within one bf16 ulp (as
# phase 11), an f32 sum within BF16_TRAIN_TOL x max(1, max |plain|) (f32
# sums over every row or pixel in another order, as phase 3's f32 backward).
# (b) holds the full-width bf16 steps with the kernels against the same
# steps with every kernel wrapper replaced by its plain version
# (``plain_versions``) on the same pool bits and stochastic-depth rows.  The
# rule first written (PERF.md): per trained tensor, the kernels' step-1
# gradient within BF16_TRAIN_SHARE of the all-plain bf16 gradient's
# distance from the f32 step on the same weights.  On an NVIDIA H100 80GB
# HBM3 (700 W) that read 0.36 in the frozen step: one-ulp flips of the bf16
# features (each block's output within an ulp of the plain version's) carry
# through the 36 blocks' residuals, as two correct bf16 decodes part
# (phase 11).  So
# each gradient is also held to the noise floor measured in the same run:
# the all-plain step with the encoder's sums in f64 against the all-plain
# step, times BF16_NOISE (phase 11's factor); a tensor passes within the
# larger of the two bounds, and both readings are printed.  Losses within
# BF16_TRAIN_LOSS relative.
BF16_TRAIN_TOL = 1e-4
BF16_TRAIN_SHARE = 0.25
BF16_TRAIN_LOSS = 1e-3
# Adam's first step is lr * g / (|g| + 1e-8): within 1% of lr * sign(g) for
# |g| above 99 eps.  Gradients below that (run C, PR 18: the bf16 lstm's
# free-running step has elements near 1e-8) are held by the gradient rule
# alone; their updates are not lr * sign(g), so 1e-2 x lr cannot hold them.
ADAM_SIGN_FLOOR = 1e-6
FT_STAGES = ((2, TRAIN_BS * 16 * 16, 512), (3, TRAIN_BS * 8 * 8, 1024))  # (stage, N, C) of the trained blocks


def check_bf16_train_kernels(dev, card):
    """Phase 12a: the MLP tail's bf16 backward at the fine-tune step's two
    trained stages (N = 8192 at C = 512, N = 2048 at C = 1024, per-image sd
    rows of 0 and 1/survival) and at a ragged N = 600, C = 128; the
    depthwise conv's bf16 filter and bias gradient and its bf16 input
    gradient (the forward instance with the filter flipped) at stages 3 and
    4, batch 32.  Device times by CUDA-graph replay beside the plain
    versions, the f32 instances on the same inputs widened, and the library
    call (``aten.convolution_backward`` and ``F.conv2d`` in bf16; none for
    the tail).  Returns {name: (worst abs error, ms, plain ms, library ms,
    bound ms, bound by)} per fine-tune step: 27 + 3 backward and filter
    gradient launches, 26 + 3 input gradients."""
    import torch
    import torch.nn.functional as F

    from tpu_captioner_torch.models.convnext import BASE_DEPTHS, sd_probs
    from tpu_captioner_torch.ops.dwconv import _dw_grad_plain, _dw_plain, dwconv_filter_grad, dwconv_forward
    from tpu_captioner_torch.ops.mlp_block import _mlp_bwd_plain_bf16, fused_convnext_mlp_bwd

    bf = torch.bfloat16
    probs = sd_probs(BASE_DEPTHS)
    acc = {k: [0.0, 0.0, 0.0, 0.0, 0.0, 0, 0.0] for k in ("mlp_block_bwd_bf16", "dwconv_grad_bf16", "dwconv_bf16 input gradient")}
    f32_ms = {"mlp_block_bwd_bf16": 0.0, "dwconv_grad_bf16": 0.0}  # the f32 instances, same inputs widened
    for s, n, c in FT_STAGES + ((0, 600, 128),):
        depth = BASE_DEPTHS[s] if s else 0
        g = torch.Generator().manual_seed(c + 17)
        f = lambda *sh: torch.randn(*sh, generator=g)  # noqa: E731
        params = [a.to(dev) for a in (1 + 0.1 * f(c), 0.1 * f(c), 0.02 * f(4 * c, c), 0.1 * f(4 * c),
                                      0.02 * f(c, 4 * c), 0.1 * f(c), 0.5 * f(c))]
        params[2], params[4] = params[2].to(bf), params[4].to(bf)
        survival = 1.0 - probs[sum(BASE_DEPTHS[: s + 1]) - 1]
        units = TRAIN_BS if depth else n
        keep = torch.rand(units, generator=g) < survival
        keep[0], keep[1] = False, True
        sd = (keep / survival).repeat_interleave(n // units).to(dev)
        args = (f(n, c).to(dev, bf), f(n, c).to(dev, bf), sd, *params)
        got, want = fused_convnext_mlp_bwd(*args), _mlp_bwd_plain_bf16(*args)
        dx_err, dx_ulps = bf16_ulp_err(got[0], want[0])
        errs = [_rel_err(a, b) for a, b in zip(got[1:], want[1:])]
        if not (dx_ulps <= 1.0 and max(e[1] for e in errs) < BF16_TRAIN_TOL and got[0].dtype == bf
                and torch.equal(got[0][sd == 0], torch.zeros_like(got[0][sd == 0]))
                and all(torch.isfinite(a.float()).all() for a in got)):
            raise AssertionError(f"mlp_block_bwd bf16 kernel disagrees at N={n}, C={c}: d_x {dx_ulps} ulps, "
                                 f"f32 outputs {[e[1] for e in errs]}")
        worst = max(dx_err, *(e[0] for e in errs))
        wide = tuple(a.float() if a.dtype == bf else a for a in args)
        t = (_graph_ms(lambda: fused_convnext_mlp_bwd(*args), iters=10),
             _graph_ms(lambda: _mlp_bwd_plain_bf16(*args), iters=3, warmup=1))
        t_f32 = _graph_ms(lambda: fused_convnext_mlp_bwd(*wide), iters=10)
        again = fused_convnext_mlp_bwd(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"mlp_block_bwd bf16 kernel at N={n}, C={c}: a second call gave other bits")
        # 32 N C^2 flops with a bf16 weight, 16 N C^2 of f32 activations;
        # g, x, d_x in bf16, the weights in bf16 and their gradients in f32.
        one_ops = (32 * n * c * c / BF16_BY_F32_OPS_PER_S + 16 * n * c * c / F32_PRODUCT_OPS_PER_S) * 1e3
        one_bytes = (2 * 3 * n * c + 4 * 2 * n + 2 * 8 * c * c + 4 * 8 * c * c + 4 * 2 * 8 * c) / HBM_BYTES_PER_S * 1e3
        one = max(one_ops, one_bytes)
        print(f"bf16 mlp_block_bwd N={n} C={c}: d_x {dx_err:.3e} ({dx_ulps:.2f} ulp), f32 outputs max relative "
              f"{max(e[1] for e in errs):.3e} (tol {BF16_TRAIN_TOL:g}), the same bits twice; kernel {t[0]:.4f} ms, "
              f"plain {t[1]:.4f}, f32 instance {t_f32:.4f} per launch; bound {one:.4f} ms "
              f"({'operations' if one_ops >= one_bytes else 'bytes'}), {one / t[0]:.1%} of it [{card}]")
        if depth:
            print(f"bf16 mlp_block_bwd N={n} C={c}, each launch of a call (device ms per call, torch.profiler): "
                  + "; ".join(f"{name} x{k} {ms:.4f}" for name, k, ms in launch_breakdown(
                      lambda: fused_convnext_mlp_bwd(*args))) + f" [{card}]")
            a = acc["mlp_block_bwd_bf16"]
            a[0] = max(a[0], worst)
            a[1] += depth * t[0]
            a[2] += depth * t[1]
            # g, x in and d_x out in bf16, sd in and d_sd out, the bf16
            # matrices in and their f32 gradients out, the vectors and their
            # gradients; products: 32 N C^2 with a bf16 weight (329.67
            # TFLOP/s), 16 N C^2 of f32 activations (165).
            a[4] += depth * (2 * 3 * n * c + 4 * 2 * n + 2 * 8 * c * c + 4 * 8 * c * c + 4 * 2 * 8 * c)
            a[6] += depth * (32 * n * c * c / BF16_BY_F32_OPS_PER_S + 16 * n * c * c / F32_PRODUCT_OPS_PER_S) * 1e3
            f32_ms["mlp_block_bwd_bf16"] += depth * t_f32
            # The depthwise conv of this stage: filter and bias gradient,
            # input gradient (all but child 5's first block: 26 + 3).
            side = 16 if c == 512 else 8
            shape = (TRAIN_BS, side, side, c)
            x, cot = f(*shape).to(dev, bf), f(*shape).to(dev, bf)
            w = (0.1 * f(7, 7, c)).to(dev, bf)
            dw, db = dwconv_filter_grad(x, cot, bias_grad=True)
            again = dwconv_filter_grad(x, cot, bias_grad=True)
            pw, pb = _dw_grad_plain(x, cot, True)
            (ew, rw), (eb, rb) = _rel_err(dw, pw), _rel_err(db, pb)
            repeat = torch.equal(dw, again[0]) and torch.equal(db, again[1])
            if not (max(rw, rb) < BF16_TRAIN_TOL and repeat and dw.dtype == torch.float32):
                raise AssertionError(f"dwconv_grad bf16 kernel at {shape}: relative {rw}, {rb} (tol "
                                     f"{BF16_TRAIN_TOL}), the same bits twice: {repeat}")
            wc = w.permute(2, 0, 1).unsqueeze(1).contiguous()
            wc_flip = w.flip(0, 1).permute(2, 0, 1).unsqueeze(1).contiguous()
            xw, cw = x.float(), cot.float()
            tg = (_graph_ms(lambda: dwconv_filter_grad(x, cot, bias_grad=True), iters=10),
                  _graph_ms(lambda: _dw_grad_plain(x, cot, True), iters=3, warmup=1),
                  _graph_ms(lambda: torch.ops.aten.convolution_backward(
                      cot.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), wc, [c], [1, 1], [3, 3], [1, 1], False,
                      [0, 0], c, [False, True, True]), iters=10))
            tg_f32 = _graph_ms(lambda: dwconv_filter_grad(xw, cw, bias_grad=True), iters=10)
            dx = dwconv_forward(cot, w, flip=True)
            dx_err, dx_ulps = bf16_ulp_err(dx, _dw_plain(cot, w.flip(0, 1)))
            if not dx_ulps <= 1.0:
                raise AssertionError(f"dwconv bf16 input gradient at {shape}: {dx_ulps} ulps")
            ti = (_graph_ms(lambda: dwconv_forward(cot, w, flip=True)),
                  _graph_ms(lambda: _dw_plain(cot, w.flip(0, 1))),
                  _graph_ms(lambda: F.conv2d(cot.permute(0, 3, 1, 2), wc_flip, padding=3, groups=c)))
            print(f"bf16 dwconv_grad {shape}: dw {ew:.3e}, d_bias {eb:.3e} (relative {rw:.3e}, {rb:.3e}, tol "
                  f"{BF16_TRAIN_TOL:g}), the same bits twice: {repeat}; kernel {tg[0]:.4f} ms, plain {tg[1]:.4f}, "
                  f"convolution_backward bf16 {tg[2]:.4f}, f32 instance {tg_f32:.4f} per launch | bf16 input "
                  f"gradient: {dx_err:.3e} ({dx_ulps:.2f} ulp); kernel {ti[0]:.4f} ms, plain {ti[1]:.4f}, "
                  f"F.conv2d bf16 {ti[2]:.4f} per launch [{card}]")
            m = x.numel()
            for name, launches, e, times, n_bytes in (
                # x and g read in bf16, dw and the bias gradient written in f32.
                ("dwconv_grad_bf16", depth, max(ew, eb), tg, 2 * 2 * m + 4 * 50 * c),
                # g read, dx written in bf16, the filter in bf16.
                ("dwconv_bf16 input gradient", depth - 1 if c == 512 else depth, dx_err, ti, 2 * 2 * m + 2 * 49 * c),
            ):
                a = acc[name]
                a[0] = max(a[0], e)
                for i, tt in enumerate(times):
                    a[1 + i] += launches * tt
                a[4] += launches * n_bytes
                a[5] += launches * 2 * 49 * m
            f32_ms["dwconv_grad_bf16"] += depth * tg_f32
    out = {}
    for name, (err, ms, plain_ms, lib_ms, n_bytes, n_ops, ops_ms) in acc.items():
        by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        # The bf16 conv's gradients are bf16 x bf16 products, exact in f32 and
        # summed in f32: the tensor cores could do them, so the bf16 rate.
        by_ops = ops_ms if name == "mlp_block_bwd_bf16" else n_ops / BF16_OPS_PER_S * 1e3
        bound_ms, bound_by = (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
        lib = None if name == "mlp_block_bwd_bf16" else lib_ms
        out[name] = (err, ms, plain_ms, lib, bound_ms, bound_by)
        extra = f", the f32 instance {f32_ms[name]:.4f} ms" if name in f32_ms else ""
        print(f"{name} per bf16 fine-tune step: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
              + ("" if lib is None else f", library {lib:.4f} ms") + f", bound {bound_ms:.4f} ms ({bound_by}; "
              f"bytes {by_bytes:.4f}, operations {by_ops:.4f}){extra} [{card}]")
    return out


def launch_breakdown(fn, calls=3):
    """Each kernel of a call of ``fn``: (short name, launches a call, device
    ms a call), longest first, from a ``torch.profiler`` window of
    ``calls`` calls (the device's activity only) after a warm-up call
    inside the profiler's schedule: a window that starts with the calls it
    counts loses the first call's kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    windows = []  # the recorded window's averages, taken before the profiler clears them
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=calls, repeat=1),
                 on_trace_ready=lambda p: windows.append(p.key_averages())) as prof:
        for _ in range(calls + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    rows = []
    for e in windows[-1]:
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key.replace("void ", "").replace("(anonymous namespace)::", "")[:60]
        rows.append((name, e.count // calls, e.self_device_time_total / 1e3 / calls))
    return sorted(rows, key=lambda r: -r[2])


def launch_breakdown_seen(fn, windows=5):
    """``launch_breakdown``, taken again (up to ``windows`` times) while its
    window holds no device activity at all: on the card a scheduled
    profiler window of a few calls now and then records no kernel of them
    (seen in phase 14a for either the block or the sub-tiled call, in
    processes where other windows recorded both; cause not found).  If
    every such window is empty, one window without a schedule over the
    same calls (as ``_kernel_ms_by_group`` records) is read instead.  A
    window that records any kernel is returned as it is."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(windows):
        rows = launch_breakdown(fn)
        if rows:
            return rows
    calls = 3
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            name = e.key.replace("void ", "").replace("(anonymous namespace)::", "")[:60]
            rows.append((name, e.count // calls, e.self_device_time_total / 1e3 / calls))
    return sorted(rows, key=lambda r: -r[2])


def bf16_train_agree(label, got, want, grads, want_grads, floor_grads, f32_grads, params, want_params, start, after,
                     lr, min_share=0.25):
    """Phase 12b's rule on two bf16 steps, kernels (``got``) against
    all-plain (``want``): losses within BF16_TRAIN_LOSS relative, token and
    top-5 counts equal; per trained tensor the kernels' step-1 gradient
    within the larger of BF16_TRAIN_SHARE x all-plain's distance from the
    f32 step's gradient and BF16_NOISE x the noise floor (all-plain with
    f64 sums against all-plain, ``floor_grads``); the parameters after the
    first step (Adam's first step moves each by about lr * sign(g)) within
    1e-2 x lr where all-plain's gradient exceeds twice the tensor's largest
    kernel-vs-plain difference (the run's noise: below it the signs may
    differ) and ADAM_SIGN_FLOOR (below it the step lr * g / (|g| + eps) is
    not lr * sign(g)), on more than ``min_share`` of the elements.  Returns
    the count of encoder tensors changed per ConvNeXt child after both
    steps (``after``)."""
    import torch

    for i, (a, b) in enumerate(zip(got, want)):
        print(f"{label} step {i}: kernels {a}; all-plain {b}")
        if not (abs(a["loss"] - b["loss"]) <= BF16_TRAIN_LOSS * abs(b["loss"]) and a["tokens"] == b["tokens"]
                and a["top5_correct"] == b["top5_correct"] and math.isfinite(a["loss"])):
            raise AssertionError(f"{label} step {i}: the kernels' and the all-plain bf16 steps disagree")
    if set(grads) != set(want_grads) or set(grads) - set(f32_grads) or set(grads) - set(floor_grads):
        raise AssertionError(f"{label}: the paths trained different parameters")
    share = floor_share = 0.0
    failed, param_err, checked, total, worst = [], 0.0, 0, 0, None
    for k, g in want_grads.items():
        d_kern = (grads[k] - g).norm().item()
        d_f32 = (g - f32_grads[k]).norm().item()
        d_floor = (floor_grads[k] - g).norm().item()
        share = max(share, d_kern / max(d_f32, 1e-30))
        floor_share = max(floor_share, d_kern / max(d_floor, 1e-30))
        if d_kern > max(BF16_TRAIN_SHARE * d_f32, BF16_NOISE * d_floor):
            failed.append((k, d_kern, d_f32, d_floor))
        sure = (g.abs() > 2 * (grads[k] - g).abs().max()) & (g.abs() > ADAM_SIGN_FLOOR)
        err = (params[k] - want_params[k]).abs()[sure]
        if err.numel() and err.max().item() > param_err:
            param_err, worst = err.max().item(), k
        checked, total = checked + int(sure.sum()), total + g.numel()
    print(f"{label} step-1 gradients over {len(want_grads)} tensors: the kernels' distance from all-plain bf16 at "
          f"most {share:.3e} of all-plain's distance from the f32 step (rule {BF16_TRAIN_SHARE}) and at most "
          f"{floor_share:.3e} of the noise floor (all-plain with f64 sums; rule {BF16_NOISE}); parameters after the "
          f"first step within {param_err:.3e} of all-plain's (tol {1e-2 * lr:g}; worst {worst}) on {checked} of "
          f"{total} elements above the noise and {ADAM_SIGN_FLOOR:g}")
    if failed or not (param_err <= 1e-2 * lr and checked > min_share * total):
        raise AssertionError(f"{label}: gradients or parameters break the bf16 rule: {failed[:5]}")
    changed = {}  # ConvNeXt child -> tensors changed by the two steps
    for k, v in start.items():
        if k.startswith("encoder.convnext."):
            i = int(k.split(".")[2])
            changed[i] = changed.get(i, 0) + (not torch.equal(after[k], v))
    return changed


def remat_ab(card, model, tc, word_map, batch, root):
    """The paired A/B that decides the bf16 fine-tune step's remat 'auto':
    AB_PAIRS pairs, one step of each arm a pair ('off', 'on'; the order
    alternating), device time by CUDA events around the step beside the
    host clock.  'on' is taken only if the median of the pairs' device-time
    differences ('off' - 'on') exceeds their spread (the rule in PERF.md,
    written before the run).  Returns (choice, medians)."""
    import statistics

    import torch

    from tpu_captioner_torch.core import prng
    from tpu_captioner_torch.train.state import TrainState
    from tpu_captioner_torch.train.steps import make_train_step

    state = TrainState.create(model, tc)
    step = make_train_step(model, tc, word_map, train_encoder=True)
    seeds = (prng.step_seed(root, "dropout", 7, i) for i in itertools.count())

    def run(remat):
        nonlocal state
        model.cfg = dataclasses.replace(model.cfg, encoder_remat=remat)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        state, _ = step(state, batch, next(seeds))
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), (time.perf_counter() - t0) * 1e3

    for remat in ("off", "on", "off", "on"):  # warm-up of both arms
        run(remat)
    pairs = []
    for i in range(AB_PAIRS):
        order = ("off", "on") if i % 2 == 0 else ("on", "off")
        t = {r: run(r) for r in order}
        pairs.append((t["off"], t["on"]))
    diffs = [off[0] - on[0] for off, on in pairs]
    gain, spread = statistics.median(diffs), max(diffs) - min(diffs)
    med = {r: (statistics.median(p[j][0] for p in pairs), statistics.median(p[j][1] for p in pairs))
           for j, r in enumerate(("off", "on"))}
    choice = "on" if gain > spread else "off"
    print(f"bf16 remat A/B, {AB_PAIRS} pairs, one fine-tune step per arm at bs {TRAIN_BS}: 'off' median "
          f"{med['off'][0]:.2f} ms device ({med['off'][1]:.2f} host), 'on' {med['on'][0]:.2f} ({med['on'][1]:.2f}); "
          f"'off' - 'on' per pair median {gain:.2f}, min {min(diffs):.2f}, max {max(diffs):.2f}, spread "
          f"{spread:.2f} ms: 'auto' -> {choice!r} [{card}]")
    print("  pairs ('off', 'on') device ms: " + ", ".join(f"({a[0]:.2f}, {b[0]:.2f})" for a, b in pairs))
    model.cfg = dataclasses.replace(model.cfg, encoder_remat="auto")
    return choice, med


BF16_STEP_KERNELS = ("dropout_mask", "mlp_block_bf16", "mlp_block_bwd_bf16", "dwconv_bf16", "dwconv_grad_bf16")


def bf16_two_steps(m, start, tc, word_map, batch, seeds, train_encoder, teacher_forcing=True, plain=False,
                   sums=None, names=BF16_STEP_KERNELS):
    """Two train steps of ``m`` from the state dict ``start``, one per seed:
    metrics and the launches of ``names`` per step, step 1's
    gradients and parameters, the state after both; ``plain`` runs the
    plain versions (the encoder's sums in ``sums`` when given)."""
    import torch

    from tpu_captioner_torch.train.state import TrainState
    from tpu_captioner_torch.train.steps import make_train_step

    m.load_state_dict(start)
    state = TrainState.create(m, tc)
    step = make_train_step(m, tc, word_map, teacher_forcing=teacher_forcing, train_encoder=train_encoder)
    out, seen = [], []
    with plain_versions(encoder_sums=sums) if plain else contextlib.nullcontext():
        for i, s in enumerate(seeds):
            zero_kernel_counts()
            state, met = step(state, batch, s)
            torch.cuda.synchronize()
            counts = kernel_counts()
            seen.append(tuple(counts[k] for k in names))
            out.append({k: float(v) for k, v in met.items()})
            if i == 0:
                grads = {k: p.grad.clone() for k, p in m.named_parameters() if p.grad is not None}
                first = {k: m.state_dict()[k].clone() for k in grads}
    return out, grads, first, {k: v.clone() for k, v in m.state_dict().items()}, seen


def bf16_train_phase(dev, card, seed, word_map):
    """Phase 12b: the full-width bf16 frozen and fine-tune steps at batch 32
    against the all-plain bf16 steps (``plain_versions``), their f64-sum
    noise floor and the f32 steps on the same weights, pool bits and
    stochastic-depth rows (one seed per
    step, both paths); launches per fine-tune step; ms per step and peak
    memory beside f32's; the remat A/B.  Returns the bf16 launches of one
    fine-tune step and the remat choice."""
    import torch

    from tpu_captioner_torch.core import prng
    from tpu_captioner_torch.core.config import ModelConfig, TrainConfig
    from tpu_captioner_torch.train.model import CaptionModel, finetune_encoder_remat
    from tpu_captioner_torch.train.state import TrainState
    from tpu_captioner_torch.train.steps import make_train_step

    t12 = time.perf_counter()
    tc = TrainConfig(batch_size=TRAIN_BS)
    cfg = ModelConfig(vocab_size=VOCAB, compute_dtype="bfloat16")
    model = CaptionModel(cfg, device=dev, seed=seed + 30)
    gen = torch.Generator().manual_seed(seed + 30)
    with torch.no_grad():  # order-one layer scales, as in phase 6
        for blk in (m for m in model.modules() if hasattr(m, "layer_scale")):
            blk.layer_scale.copy_(0.1 * torch.rand(blk.layer_scale.shape, generator=gen))
    start = copy.deepcopy(model.state_dict())
    f32 = CaptionModel(ModelConfig(vocab_size=VOCAB), device=dev)
    f32.load_state_dict(start)
    batch = {k: v.to(dev) for k, v in train_batch(gen, word_map, VOCAB).items()}
    root = prng.root_seed(seed + 31)
    seeds = [prng.step_seed(root, "dropout", 0, i) for i in range(2)]
    names = BF16_STEP_KERNELS

    def two_steps(m, train_encoder, plain=False, sums=None):
        return bf16_two_steps(m, start, tc, word_map, batch, seeds, train_encoder, plain=plain, sums=sums)

    launches = {}
    for label, train_encoder, expect in (("frozen", False, (1, 36, 0, 36, 0)), ("fine-tune", True, (1, 36, 30, 65, 30))):
        got, grads, params, after, seen = two_steps(model, train_encoder)
        if any(c != expect for c in seen):
            raise AssertionError(f"bf16 {label} step: expected {names} launches {expect} per step, got {seen}")
        want, want_grads, want_params, _, plain_seen = two_steps(model, train_encoder, plain=True)
        _, floor_grads, _, _, floor_seen = two_steps(model, train_encoder, plain=True, sums=torch.float64)
        if any(c[1:] != (0, 0, 0, 0) for c in plain_seen + floor_seen):
            raise AssertionError(f"bf16 {label} step, all-plain: a bf16 kernel launched ({plain_seen}, {floor_seen})")
        _, f32_grads, _, _, _ = two_steps(f32, train_encoder)
        changed = bf16_train_agree(f"bf16 {label}", got, want, grads, want_grads, floor_grads, f32_grads, params,
                                   want_params, start, after, tc.encoder_lr)
        print(f"bf16 {label} step: launches per step {dict(zip(names, seen[0]))}; encoder tensors changed per "
              f"child {dict(sorted(changed.items()))}")
        if any((i >= FT_START and train_encoder) != (c > 0) for i, c in changed.items()):
            raise AssertionError(f"bf16 {label}: children below {FT_START} must stay bit-identical, the rest change")
        launches[label] = seen[0]
        del grads, want_grads, floor_grads, f32_grads, params, want_params, after
        torch.cuda.empty_cache()

    # ms per step and peak memory, bf16 beside f32, frozen and fine-tune.
    for label, train_encoder in (("frozen", False), ("fine-tune", True)):
        for m in (model, f32):
            m.load_state_dict(start)
            state = TrainState.create(m, tc)
            step = make_train_step(m, tc, word_map, train_encoder=train_encoder)
            for i in range(3):
                state, _ = step(state, batch, prng.step_seed(root, "dropout", 1, i))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for i in range(TRAIN_TIMED_STEPS):
                t0 = time.perf_counter()
                state, met = step(state, batch, prng.step_seed(root, "dropout", 2, i))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms = sorted(times)[len(times) // 2]
            print(f"{'bf16' if m is model else 'f32'} {label} step bs={TRAIN_BS}: median {ms:.2f} ms/step over "
                  f"{TRAIN_TIMED_STEPS} steps (min {min(times):.2f}, max {max(times):.2f}), "
                  f"{TRAIN_BS / (ms / 1e3):.1f} images/s, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                  f"GiB, loss {float(met['loss']):.4f} [{card}]")
            mfu_line(f"{'bf16' if m is model else 'f32'} {label} step bs={TRAIN_BS}",
                     step_flops(m.cfg, batch["images"].shape[1], train_encoder), ms, m.cfg.compute_dtype, card)
            if m is model and train_encoder:
                state, groups, top, n_launch, wall_ms = _kernel_ms_by_group(
                    step, state, batch, [prng.step_seed(root, "dropout", 3, i) for i in range(2)])
                busy = sum(groups.values())
                print(f"bf16 fine-tune step under torch.profiler: {wall_ms:.2f} ms wall, {busy:.2f} ms of kernels "
                      f"({n_launch} launches); kernel ms by group: " + ", ".join(
                          f"{k} {v:.2f}" for k, v in sorted(groups.items(), key=lambda kv: -kv[1])) + f" [{card}]")
                for ms_k, name in top:
                    print(f"  {ms_k:8.2f} ms/step  {name}")
            del state, step
            torch.cuda.empty_cache()
    del f32
    torch.cuda.empty_cache()
    model.load_state_dict(start)
    choice, _ = remat_ab(card, model, tc, word_map, batch, root)
    resolved = finetune_encoder_remat("auto", "bfloat16")
    print(f"bf16 remat: the A/B chose {choice!r}; finetune_encoder_remat('auto', 'bfloat16') is {resolved!r}; "
          f"phase 12b took {time.perf_counter() - t12:.1f} s")
    if resolved != choice:
        raise AssertionError(f"finetune_encoder_remat('auto', 'bfloat16') is {resolved!r}, the A/B chose {choice!r}")
    return launches["fine-tune"]


def bf16_entry_phase(dev, card, seed):
    """Phase 12c: the training entry point in bf16 on phase 10's synthetic
    data (rebuilt): ``cli.train --computeDtype bfloat16`` through ``main``,
    one free-running epoch; the Trainer over two teacher-forced epochs with
    the unlock at 1; both with validation through the bf16 eval step (its
    head's bias raised on one word, as in phase 10); every step's launches
    counted; finite losses; ``meta.json`` says bfloat16; ``cli.caption``'s
    loader and ``caption_batch`` and ``cli.test`` on the checkpoint.  Every
    count is zeroed before the first run and read after the second: the
    main path's totals, by kernel name."""
    import shutil

    import torch

    from tpu_captioner_torch.cli import test as cli_test, train as cli_train
    from tpu_captioner_torch.cli.caption import build_model_and_params, caption_batch
    from tpu_captioner_torch.core.config import ExperimentConfig, ModelConfig, TrainConfig
    from tpu_captioner_torch.data.build import build_synthetic_dataset
    from tpu_captioner_torch.data.dataset import CaptionDataset
    from tpu_captioner_torch.train import loop

    t0 = time.perf_counter()
    cwd = os.getcwd()
    tmp = tempfile.mkdtemp(prefix="smoke_bf16_train_")
    try:
        ds = os.path.join(tmp, "ds")
        word_map = build_synthetic_dataset(ds, num_images=dict(TRAIN_DATA), vocab_words=VOCAB - 4,
                                           max_len=TRAIN_T - 2, image_size=256, learnable=True)
        os.chdir(tmp)
        zero_kernel_counts()
        record = {"train": [], "eval": []}
        with counted_trainer_steps(record, word_map[EVAL_WORD]):
            free = cli_train.main(["--dataFolder", ds, "--dataName", TRAIN_DATA_NAME, "--batchSize", str(TRAIN_BS),
                                   "--epochs", "1", "--device", dev.type, "--computeDtype", "bfloat16"])
            exp = ExperimentConfig(model=ModelConfig(compute_dtype="bfloat16"), train=TrainConfig(
                batch_size=TRAIN_BS, epochs=2, fine_tune_epoch=1, teacher_forcing=True, print_freq=1000,
                checkpoint_dir=os.path.join(tmp, "c", "ckpt"), results_dir=os.path.join(tmp, "c", "results")))
            tf = loop.Trainer(exp, ds, TRAIN_DATA_NAME, device=dev, verbose=False)
            rows = tf.run()
        torch.cuda.synchronize()
        totals = kernel_counts()
        layers, steps = free.exp.model.num_layers, free.exp.train.max_decode_len
        check_counts("phase 12c bf16 cli.train + Trainer", record, {
            "free-running, frozen": (0, 36, 0, 36, 0), "TF, frozen": (1, 36, 0, 36, 0),
            "TF, fine-tune": (1, 36, 30, 65, 30)}, layers, steps)
        bleu1 = one_word_bleu1(CaptionDataset(ds, TRAIN_DATA_NAME, "VAL"), word_map[EVAL_WORD], steps,
                               word_map["<start>"], word_map["<pad>"])
        all_rows = free.results + rows
        if not (free.model.dtype == tf.model.dtype == torch.bfloat16 and len(all_rows) == 3 and all(
                math.isfinite(r["trainLoss"]) and math.isfinite(r["valLoss"])
                and abs(r["bleu1"] - bleu1) <= 1e-12 * bleu1 for r in all_rows)):
            raise AssertionError(f"phase 12c: rows {all_rows} (BLEU-1 counted from the records {bleu1!r})")
        ckpt = os.path.join(tmp, "checkpoints", free.checkpoint_name())
        metas = [os.path.join(ckpt, "meta.json"), os.path.join(exp.train.checkpoint_dir, tf.checkpoint_name(),
                                                               "meta.json")]
        for path in metas:
            with open(path) as f:
                if json.load(f)["config"]["model"]["compute_dtype"] != "bfloat16":
                    raise AssertionError(f"phase 12c: {path} does not say bfloat16")
        print(f"phase 12c: rows {all_rows}; meta.json says bfloat16 ({time.perf_counter() - t0:.1f} s)")
        del free, tf
        torch.cuda.empty_cache()

        best = os.path.join(tmp, "checkpoints", f"BEST_{os.path.basename(ckpt)}")
        served = build_model_and_params(argparse.Namespace(checkpoint=best, device=str(dev), seed=seed), word_map)
        images = torch.randint(0, 256, (8, 256, 256, 3), generator=torch.Generator().manual_seed(seed + 40),
                               dtype=torch.uint8).numpy()
        caps = caption_batch(served, images, word_map, BEAM)
        if not (served.dtype == torch.bfloat16 and len(caps) == 8 and all(
                seq[0] == word_map["<start>"] and math.isfinite(score) and np_isfinite(alpha)
                for _, score, seq, alpha in caps)):
            raise AssertionError("phase 12c: cli.caption's loader did not serve the bf16 checkpoint")
        del served
        row = cli_test.main(["--dataFolder", ds, "--dataName", TRAIN_DATA_NAME, "--batchSize", str(TRAIN_BS),
                             "--checkpoint", best, "--device", dev.type, "--computeDtype", "bfloat16"])
        if not all(math.isfinite(v) for v in row.values()):
            raise AssertionError(f"phase 12c: cli.test row {row}")
        print(f"phase 12c: cli.caption on the BEST_ checkpoint: {caps[0][0][:60]!r}; cli.test: {row} "
              f"({time.perf_counter() - t0:.1f} s)")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    missing = [k for k in ("dropout_mask", "mlp_block_bf16", "mlp_block_bwd_bf16", "dwconv_bf16", "dwconv_grad_bf16",
                           "decode_step_bf16") if totals[k] == 0]
    if missing or any(totals[k] != totals[k.replace("_bf16", "")] for k in (
            "mlp_block_bf16", "mlp_block_bwd_bf16", "dwconv_bf16", "dwconv_grad_bf16", "decode_step_bf16")):
        raise AssertionError(f"phase 12c: bf16 kernels never launched {missing}, or an f32 instance ran: {totals}")
    print(f"phase 12c launches: {totals}; phase 12c took {time.perf_counter() - t0:.1f} s")
    return totals


# Phase 13: bf16 in the decoders.  (a) holds the three new bf16 instances
# against their plain versions at full width (PERF.md, PR 18, rules written
# before the runs): the LSTM step's with alpha within LSTM_TOL and h and c
# within the larger of BF16_F32_TOL x max(1, max |plain|) and BF16_NOISE x
# the noise floor (the plain version with f64 sums against it); the
# one-cell instance equal to the per-layer bf16 launches bit for bit; the
# rollout instance against its plain version under phase 11's noise-floor
# rules.  (b)-(d) run the bf16 LSTM families and decode modes end to end.
def lstm_bf16_bound(R, E, D, A, C, P):
    """``lstm_bound`` of the bf16 instance: the five matrices, emb, enc and
    att1 at 2 bytes, the rest at 4; the products at the bf16 rate, the
    attention's FFMA work at the f32 rate."""
    n_mat = A * D + C * D + 4 * D * (E + C + D)
    n_bytes = 2 * (n_mat + R * (E + P * (C + A))) + 4 * (2 * A + 1 + C + 4 * D + R * 2 * D + R * (2 * D + P))
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = (2 * R * n_mat / BF16_OPS_PER_S + R * P * (4 * A + 2 * C) / F32_OPS_PER_S) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_bf16_lstm(dev, card):
    """Phase 13a: the LSTM step's bf16 instance at the rows of the bs-8 and
    bs-32 beams and the eval step (LSTM_ROWS) at E = D = A = 512, C = 1024,
    P = 49, and at the bs-8 beam's rows with E = 300; the same bits from a
    second call.  Device times (CUDA-graph replay) of the kernel and of its
    plain version, and the bound.  Returns (worst error, ms, plain ms,
    library ms, bound ms, bound by) at the bs-8 beam's rows, E = 512."""
    import torch

    from tpu_captioner_torch.ops.lstm_step import (
        LstmStepWeights, _lstm_step_plain_bf16, cast_lstm_weight_matrices, fused_lstm_step,
    )

    D, A, C, P = 512, 512, 1024, 49
    bf = torch.bfloat16
    worst, out = 0.0, None
    for R, E in [(r, 512) for r in LSTM_ROWS] + [(LSTM_ROWS[0], 300)]:
        g = torch.Generator().manual_seed(R + E + 1)
        u = lambda fan_in, *sh: ((torch.rand(*sh, generator=g) * 2 - 1) / math.sqrt(fan_in)).to(dev)  # noqa: E731
        f = lambda *sh: torch.randn(*sh, generator=g).to(dev)  # noqa: E731
        w = cast_lstm_weight_matrices(LstmStepWeights(
            u(D, A, D), u(D, A), u(A, A), u(A, 1), u(D, C, D), u(D, C), u(D, 4 * D, E), u(D, 4 * D, C),
            u(D, 4 * D, D), u(D, 4 * D)), bf)
        args = (w, f(R, E).to(bf), f(R, D), f(R, D), f(R, P, C).to(bf), f(R, P, A).to(bf))
        got, want = fused_lstm_step(*args), _lstm_step_plain_bf16(*args)
        ref = _lstm_step_plain_bf16(*args, sums=torch.float64)
        hc = [bf16_rel(a, b) for a, b in zip(got[:2], want[:2])]
        floor = [bf16_rel(a, b) for a, b in zip(ref[:2], want[:2])]
        alpha = (got[2] - want[2]).abs().max().item()
        tol = max(BF16_F32_TOL, BF16_NOISE * max(floor))
        if not (all(torch.isfinite(a).all() for a in got) and max(hc) <= tol and alpha < LSTM_TOL):
            raise AssertionError(f"lstm_step bf16 kernel disagrees at R={R}, E={E}: h, c {hc} (tol {tol}), alpha "
                                 f"{alpha} (tol {LSTM_TOL})")
        if not all(torch.equal(a, b) for a, b in zip(got, fused_lstm_step(*args))):
            raise AssertionError(f"lstm_step bf16 kernel: a second call differs at R={R}, E={E}")
        t_kernel = _graph_ms(lambda: fused_lstm_step(*args), iters=50)
        t_plain = _graph_ms(lambda: _lstm_step_plain_bf16(*args), iters=50)
        bound_ms, bound_by = lstm_bf16_bound(R, E, D, A, C, P)
        print(f"lstm_step bf16 R={R} E={E}: h {hc[0]:.3e}, c {hc[1]:.3e} of max(1, max |plain|) (tol {tol:.3e}; "
              f"noise floor {max(floor):.3e}), alpha {alpha:.3e} (tol {LSTM_TOL:g}), second call bit for bit; "
              f"kernel {t_kernel:.4f} ms device, plain {t_plain:.4f}; bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
        worst = max(worst, *((a - b).abs().max().item() for a, b in zip(got, want)))
        if out is None:
            out = (t_kernel, t_plain, None, bound_ms, bound_by)
    return (worst, *out)


def check_bf16_decode_modes(dev, card, model, word_map):
    """Phase 13a: the one-cell bf16 instance at the eval step's 32 rows on
    ``model``'s layers (cast to bf16), cache length 52, at three positions
    with NaN at and past pos: equal to the per-layer bf16 launches bit for
    bit, against the plain bf16 step reported; and the rollout's bf16
    instance at 32 rows over 51 tokens on ``model``'s bf16 operands (as
    ``mega_rollout`` casts them) against ``_full_rollout_plain_bf16`` under
    phase 11's rules (tolerances from the plain version with f64 sums).
    Device times by CUDA-graph replay (beside CUDA-event times of eager
    calls) and bounds.  Returns {kernel: (error, ms, plain ms,
    library ms, bound ms, bound by)}."""
    import torch

    from tpu_captioner_torch.core.config import TrainConfig
    from tpu_captioner_torch.ops.decode_step import (
        _decode_step_plain_bf16, _full_rollout_plain_bf16, cast_weight_matrices, fused_decode_step,
        fused_full_rollout, prepare_decode_weights,
    )

    bf = torch.bfloat16
    dec = model.decoder
    L, E, P, H = model.cfg.num_layers, model.cfg.embed_dim, 49, model.cfg.num_heads
    Fd, R = model.cfg.decoder_dim, TRAIN_BS
    w = cast_weight_matrices(prepare_decode_weights(dec.layers, E), bf)
    g = torch.Generator().manual_seed(13)
    f = lambda *sh: torch.randn(*sh, generator=g).to(dev, bf)  # noqa: E731
    out = {}
    worst, times, plain_times, n_bytes, n_ops = 0.0, [], [], 0, 0
    for pos in (0, 25, DECODE_T - 1):
        ck, cv = f(L, R, DECODE_T, E), f(L, R, DECODE_T, E)
        ck[:, :, pos:] = float("nan")
        cv[:, :, pos:] = float("nan")
        args = (w, f(R, E), pos, ck, cv, f(L, R, P, E), f(L, R, P, E), H)
        got, per_layer = fused_decode_step(*args, one_cell=True), fused_decode_step(*args)
        if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, per_layer)):
            raise AssertionError(f"decode_onecell bf16 differs from the per-layer bf16 launches at pos {pos}")
        want, ref = _decode_step_plain_bf16(*args), _decode_step_plain_bf16(*args, sums=torch.float64)
        errs = (bf16_rel(got[0], want[0]), bf16_rel(got[1], want[1]))
        floor = (bf16_rel(ref[0], want[0]), bf16_rel(ref[1], want[1]))
        worst = max(worst, *((a - b).float().abs().max().item() for a, b in zip(got, want)))
        times.append(_graph_ms(lambda: fused_decode_step(*args, one_cell=True)))
        eager = _time_ms(lambda: fused_decode_step(*args, one_cell=True))
        plain_times.append(_time_ms(lambda: _decode_step_plain_bf16(*args), iters=5, warmup=1))
        print(f"decode_onecell bf16 R={R} pos={pos}: equal to the {L} per-layer bf16 launches bit for bit; vs plain "
              f"x {errs[0]:.3e}, alpha {errs[1]:.3e} (noise floor {floor[0]:.3e}, {floor[1]:.3e}); kernel "
              f"{times[-1]:.4f} ms device (graph replay), {eager:.4f} eager, plain {plain_times[-1]:.4f} ms per "
              f"{L}-layer step [{card}]")
        n_bytes += (L * (2 * (6 * E * E + 2 * E * Fd) + 4 * (9 * E + Fd) + 2 * R * (2 * pos + 2 * P + 2) * E)
                    + R * (6 * E + 4 * P))
        n_ops += L * R * (2 * (6 * E * E + 2 * E * Fd) + 4 * E * (pos + 1 + P))
    bound_ms, bound_by = bound(n_bytes / 3, n_ops / 3, BF16_OPS_PER_S)
    out["decode_onecell_bf16"] = (worst, sum(times) / len(times), sum(plain_times) / len(plain_times), None,
                                  bound_ms, bound_by)

    # The rollout on a batch's bf16 operands, natural <end>.
    steps = TrainConfig().max_decode_len
    imgs = torch.randint(0, 256, (R, 256, 256, 3), generator=torch.Generator().manual_seed(14),
                         dtype=torch.uint8).to(dev)
    with torch.inference_mode():
        mem = dec.project_memory(model.encode(imgs))
        wr, mk, mv, _, _ = dec.kernel_operands(mem, 0, bf)
        wr = wr._replace(**{k: v.to(bf).float() for k, v in wr._asdict().items() if v.dtype == torch.float32})
        args = (wr, dec.embedding.weight.to(bf), dec.fc_out.weight.to(bf), dec.fc_out.bias, dec.pe, mk, mv,
                word_map["<start>"], word_map["<end>"], steps, H)
        got, want = fused_full_rollout(*args), _full_rollout_plain_bf16(*args)
        ref = _full_rollout_plain_bf16(*args, sums=torch.float64)
        inf = float("inf")
        noise_logit, noise_alpha, _ = compare_rollouts("decode_rollout bf16 noise floor", ref, want, inf, inf, inf)
        logit_tol = max(BF16_F32_TOL * max(1.0, want[0].abs().max().item()), BF16_NOISE * noise_logit)
        alpha_tol = max(BF16_F32_TOL, BF16_NOISE * noise_alpha)
        logit_err, alpha_err, ties = compare_rollouts("decode_rollout bf16", got, want, logit_tol, alpha_tol,
                                                      logit_tol)
        ends = want[1] == word_map["<end>"]
        lengths = torch.where(ends.any(dim=1), ends.int().argmax(dim=1) + 1, steps).tolist()
        t_kernel = _graph_ms(lambda: fused_full_rollout(*args), iters=5, warmup=1)
        t_eager = _time_ms(lambda: fused_full_rollout(*args), iters=5, warmup=1)
        t_plain = _time_ms(lambda: _full_rollout_plain_bf16(*args), iters=2, warmup=1)
    bound_ms, bound_by = bound(*rollout_bound(lengths, L, P, E, Fd, VOCAB, steps, esize=2), BF16_OPS_PER_S)
    print(f"decode_rollout bf16 R={R} steps={steps} ({max(lengths)} run): logits {logit_err:.3e} (tol "
          f"{logit_tol:.3e}; noise floor {noise_logit:.3e}), maps {alpha_err:.3e} (tol {alpha_tol:.3e}; floor "
          f"{noise_alpha:.3e}), {len(ties)} rows differ at a near-tie; kernel {t_kernel:.4f} ms device (graph "
          f"replay), {t_eager:.4f} eager, plain {t_plain:.4f} ms per rollout, bound {bound_ms:.4f} ms ({bound_by}) "
          f"[{card}]")
    out["decode_rollout_bf16"] = (max(logit_err, alpha_err), t_kernel, t_plain, None, bound_ms, bound_by)
    return out


def bf16_lstm_serve(dev, card, seed, word_map, images8, rng):
    """Phase 13b: a bf16 ``lstm`` flagship (phase 8's weights) with the
    decode kernel on, beam 5 x 50 at batch 8 and 32 through
    ``caption_batch``: the bf16 instances' launches (36 + 36 per encoder
    pass, one lstm_step per beam step), the captions held to the all-plain
    bf16 path by ``bf16_agree`` (the lock-step replay at the noise floor);
    ``lstm_no_attention`` in bf16 against its all-plain path the same way;
    captions/s beside the f32 models'.  Returns the lstm_step bf16
    launches of the bs-8 run."""
    import torch

    from tpu_captioner_torch.cli.caption import caption_batch
    from tpu_captioner_torch.core.config import ModelConfig
    from tpu_captioner_torch.ops.dwconv import depthwise_conv7x7_nhwc
    from tpu_captioner_torch.ops.lstm_step import fused_lstm_step
    from tpu_captioner_torch.ops.mlp_block import fused_convnext_mlp

    images = {8: images8.numpy(), TRAIN_BS: torch.randint(0, 256, (TRAIN_BS, 256, 256, 3), generator=rng,
                                                          dtype=torch.uint8).numpy()}
    launches = None
    for kind, s in (("lstm", seed + 11), ("lstm_no_attention", seed + 14)):
        cfg = ModelConfig(decoder=kind, vocab_size=VOCAB, decode_kernel="on", compute_dtype="bfloat16")
        model = flagship_model(cfg, dev, s)
        f32 = flagship_model(dataclasses.replace(cfg, compute_dtype="float32"), dev, s)
        for bs, imgs in images.items():
            steps = [0]  # one embedding lookup per beam step
            hook = model.decoder.embedding.register_forward_hook(lambda *a: steps.__setitem__(0, steps[0] + 1))
            zero_kernel_counts()
            got = caption_batch(model, imgs, word_map, BEAM)
            torch.cuda.synchronize()
            hook.remove()
            seen = (fused_convnext_mlp.bf16_launches, depthwise_conv7x7_nhwc.bf16_launches,
                    fused_lstm_step.bf16_launches, fused_lstm_step.launches)
            expect = (36, 36) + ((steps[0], steps[0]) if kind == "lstm" else (0, 0))
            print(f"bf16 {kind} serving bs={bs}: bf16 launches (mlp_block, dwconv, lstm_step), lstm_step launches "
                  f"{seen} over {steps[0]} beam steps")
            if seen != expect or steps[0] < 1:
                raise AssertionError(f"bf16 {kind} serving bs={bs}: expected launches {expect}, got {seen}")
            if launches is None:
                launches = seen[2]
            for _, score, seq, alpha in got:
                if not (seq[0] == word_map["<start>"] and alpha.shape == (len(seq), cfg.num_pixels)
                        and np_isfinite(alpha) and math.isfinite(score)):
                    raise AssertionError(f"malformed bf16 {kind} caption output")
            with plain_versions():
                want = caption_batch(model, imgs, word_map, BEAM)
            bf16_agree(model, dev, bs, imgs, word_map, got, want)
            ref = caption_batch(f32, imgs, word_map, BEAM)
            same = sum(len(a[2]) == len(r[2]) and bool((a[2] == r[2]).all()) for a, r in zip(got, ref))
            print(f"bf16 {kind} serving bs={bs}: {same} of {bs} captions equal to the f32 model's; caption 0: "
                  f"{got[0][0][:60]!r} (f32: {ref[0][0][:60]!r})")
        serve_times(card, f"{kind} serve bf16 phase", {"bf16": model, "f32": f32}, rng, dev, word_map)
        del model, f32
        torch.cuda.empty_cache()
    return launches


def bf16_eval_agree(label, runs, kernel, plain, floor):
    """Phase 11c's rule for the eval step's rollout in mode ``kernel``
    against its all-plain bf16 path ``plain`` (``runs[mode] = (step, aux,
    roll)``), the tolerances from ``floor`` (the all-plain path with f64
    sums): logits within the larger of BF16_F32_TOL x max(1, max |plain|)
    and BF16_NOISE x the floor, maps likewise, sequences equal except at a
    near-tie; without one, the loss within the larger of BF16_F32_TOL and
    BF16_NOISE x the floor relative, and equal sequences and counts."""
    import torch

    inf = float("inf")
    noise_logit, noise_alpha, _ = compare_rollouts(f"{label} noise floor", runs[floor][2], runs[plain][2],
                                                   inf, inf, inf)
    logit_tol = max(BF16_F32_TOL * max(1.0, runs[plain][2][0].abs().max().item()), BF16_NOISE * noise_logit)
    alpha_tol = max(BF16_F32_TOL, BF16_NOISE * noise_alpha)
    logit_err, alpha_err, ties = compare_rollouts(f"{label} {kernel}", runs[kernel][2], runs[plain][2],
                                                  logit_tol, alpha_tol, logit_tol)
    loss, want = float(runs[kernel][1]["loss"]), float(runs[plain][1]["loss"])
    loss_floor = abs(float(runs[floor][1]["loss"]) - want) / abs(want)
    loss_err = abs(loss - want) / abs(want)
    print(f"{label} {kernel} vs all-plain: logits {logit_err:.3e} (tol {logit_tol:.3e}; noise floor "
          f"{noise_logit:.3e}), maps {alpha_err:.3e} (tol {alpha_tol:.3e}; floor {noise_alpha:.3e}), loss "
          f"{loss_err:.3e} relative (floor {loss_floor:.3e}), {len(ties)} rows differ at a near-tie")
    if not ties and not (loss_err <= max(BF16_F32_TOL, BF16_NOISE * loss_floor) and all(
            torch.equal(runs[kernel][1][k], runs[plain][1][k]) for k in ("sequences", "tokens"))):
        raise AssertionError(f"{label} {kernel} disagrees with the all-plain path: loss {loss} vs {want}")


def bf16_eval_modes(dev, card, seed, word_map):
    """Phase 13c: the greedy eval step at batch 32, 51 tokens, of a bf16
    Transformer (phase 4's weights) in ``'mega'`` and one-cell and of a bf16
    ``lstm`` (phase 8's) in ``'on'``, each against its all-plain bf16 decode
    (``bf16_eval_agree``; ``plain_versions(encoder=False)``: the same bf16
    features, from the encoder's kernels, in every arm, so that the decode
    alone is compared and the noise floor is the decode's) and reported
    against ``'off'``; launches counted; eval-step ms per mode beside the
    f32 model's.  Returns the bf16 launches of the kernel modes' runs."""
    import torch

    from tpu_captioner_torch.core.config import ModelConfig, TrainConfig
    from tpu_captioner_torch.train.steps import make_eval_step

    tc = TrainConfig(batch_size=TRAIN_BS)
    batch = {k: v.to(dev) for k, v in train_batch(torch.Generator().manual_seed(seed + 9), word_map, VOCAB).items()}
    start, end, steps = word_map["<start>"], word_map["<end>"], tc.max_decode_len
    launches = {}
    for family, s, modes in (("transformer", seed, (("mega", "mega", False), ("one_cell", "step", True))),
                             ("lstm", seed + 11, (("on", "on", False),))):
        cfg = ModelConfig(decoder=family, vocab_size=VOCAB, compute_dtype="bfloat16")
        model = flagship_model(cfg, dev, s)
        f32 = flagship_model(dataclasses.replace(cfg, compute_dtype="float32"), dev, s)
        if family == "transformer":
            model.decoder.capture_alphas = f32.decoder.capture_alphas = True
        for label, mode, one_cell in modes:
            runs = {}
            for arm, m, mode_, sums in ((label, model, mode, None), ("all-plain", model, mode, torch.float32),
                                        ("all-plain f64", model, mode, torch.float64), ("off", model, "off", None),
                                        ("f32 " + label, f32, mode, None), ("f32 off", f32, "off", None)):
                m.cfg = dataclasses.replace(m.cfg, decode_kernel=mode_)
                step = make_eval_step(m, tc, word_map, one_cell=one_cell)
                with plain_versions(sums, encoder=False) if sums is not None else contextlib.nullcontext():
                    zero_kernel_counts()
                    aux = step(batch)
                    torch.cuda.synchronize()
                    counts = kernel_counts()
                    with torch.inference_mode():
                        roll = m.rollout(m.encode(batch["images"]), start, end, steps, one_cell=one_cell)
                need = int(aux["lengths"].max())
                seen = tuple(counts[k] for k in ("lstm_step_bf16", "decode_onecell_bf16", "decode_rollout_bf16",
                                                 "mlp_block_bf16"))
                if m is model and arm == label:
                    expect = {"mega": (0, 0, 1, 36), "one_cell": (0, need, 0, 36), "on": (need, 0, 0, 36)}[label]
                    launches[label] = seen
                else:
                    expect = (0, 0, 0, 36 if m is model else 0)
                print(f"bf16 eval {family} {arm}: bf16 launches (lstm_step, decode_onecell, decode_rollout, "
                      f"mlp_block) {seen}, {need} tokens; loss {float(aux['loss']):.6f}, tokens {int(aux['tokens'])}, "
                      f"top5 {int(aux['top5_correct'])}")
                if seen != expect or not (torch.isfinite(roll[0]).all() and math.isfinite(float(aux["loss"]))):
                    raise AssertionError(f"bf16 eval {family} {arm}: expected bf16 launches {expect}, got {seen}, "
                                         f"or a non-finite output")
                runs[arm] = (step, aux, roll)
            bf16_eval_agree(f"bf16 eval {family}", runs, label, "all-plain", "all-plain f64")
            gs, ws = runs[label][2][1], runs["off"][2][1]
            print(f"bf16 eval {family} {label} vs 'off' (the f32 plain decode on the bf16 features, reported): "
                  f"sequences equal in {(gs == ws).all(dim=1).float().mean().item():.4f} of rows, loss "
                  f"{float(runs[label][1]['loss']):.6f} vs {float(runs['off'][1]['loss']):.6f}")
            for arm, m, mode_ in ((label, model, mode), ("off", model, "off"), ("f32 " + label, f32, mode),
                                  ("f32 off", f32, "off")):
                m.cfg = dataclasses.replace(m.cfg, decode_kernel=mode_)
                eval_ms, _ = _host_ms(lambda: runs[arm][0](batch))
                print(f"bf16 eval {family} bs={TRAIN_BS} {arm}: eval step {eval_ms:.2f} ms [{card}]")
        del model, f32
        torch.cuda.empty_cache()
    return launches


def bf16_lstm_train(dev, card, seed, word_map):
    """Phase 13d: the full-width bf16 ``lstm`` frozen and fine-tune
    teacher-forced steps and its free-running frozen step at batch 32
    against the all-plain bf16 steps, their f64-sum noise floor and the f32
    steps on the same weights (``bf16_train_agree``: phase 12b's rules);
    launches per step; then ``cli.train --computeDtype bfloat16 --decoder
    lstm`` for one epoch on phase 10's synthetic data, ``cli.caption``'s
    loader and ``cli.test`` on its checkpoint, every count zeroed before and
    read after.  Returns those counts."""
    import shutil

    import torch

    from tpu_captioner_torch.cli import test as cli_test, train as cli_train
    from tpu_captioner_torch.cli.caption import build_model_and_params, caption_batch
    from tpu_captioner_torch.core import prng
    from tpu_captioner_torch.core.config import ModelConfig, TrainConfig
    from tpu_captioner_torch.data.build import build_synthetic_dataset
    from tpu_captioner_torch.train.model import CaptionModel

    t0 = time.perf_counter()
    tc = TrainConfig(batch_size=TRAIN_BS)
    cfg = ModelConfig(decoder="lstm", vocab_size=VOCAB, compute_dtype="bfloat16")
    model = flagship_model(cfg, dev, seed + 32)
    start = copy.deepcopy(model.state_dict())
    f32 = CaptionModel(dataclasses.replace(cfg, compute_dtype="float32"), device=dev)
    gen = torch.Generator().manual_seed(seed + 32)
    batch = {k: v.to(dev) for k, v in train_batch(gen, word_map, VOCAB).items()}
    root = prng.root_seed(seed + 33)
    seeds = [prng.step_seed(root, "dropout", 0, i) for i in range(2)]
    # A free-running step's greedy feedback makes its gradients
    # discontinuous in the features: where the kernels' and the all-plain
    # encoders' features (an ulp apart) part a token, the rows' losses and
    # the embedding and head gradients on them part too, and most of the
    # 4.9 M embedding and 4.9 M head elements stay under the noise (run D,
    # PR 18: 13.6% of the elements above it, against 34.7% in the frozen
    # teacher-forced step).  Its parameters are held where they are above
    # the noise, on more than an eighth of the elements.
    for label, tf, train_encoder, expect, share in (("frozen", True, False, (1, 36, 0, 36, 0), 0.25),
                                                    ("fine-tune", True, True, (1, 36, 30, 65, 30), 0.25),
                                                    ("free-running frozen", False, False, (0, 36, 0, 36, 0), 0.125)):
        run = lambda m, **kw: bf16_two_steps(m, start, tc, word_map, batch, seeds, train_encoder,  # noqa: E731
                                             teacher_forcing=tf, **kw)
        got, grads, params, after, seen = run(model)
        if any(c != expect for c in seen):
            raise AssertionError(f"bf16 lstm {label} step: expected {BF16_STEP_KERNELS} launches {expect}, got {seen}")
        want, want_grads, want_params, _, plain_seen = run(model, plain=True)
        _, floor_grads, _, _, _ = run(model, plain=True, sums=torch.float64)
        _, f32_grads, _, _, _ = run(f32)
        changed = bf16_train_agree(f"bf16 lstm {label}", got, want, grads, want_grads, floor_grads, f32_grads,
                                   params, want_params, start, after, tc.encoder_lr, share)
        print(f"bf16 lstm {label} step: launches per step {dict(zip(BF16_STEP_KERNELS, seen[0]))}; encoder tensors "
              f"changed per child {dict(sorted(changed.items()))}")
        if any((i >= FT_START and train_encoder) != (c > 0) for i, c in changed.items()):
            raise AssertionError(f"bf16 lstm {label}: children below {FT_START} must stay bit-identical")
        del grads, want_grads, floor_grads, f32_grads, params, want_params, after
        torch.cuda.empty_cache()
    del model, f32
    torch.cuda.empty_cache()
    print(f"phase 13d steps took {time.perf_counter() - t0:.1f} s")

    cwd = os.getcwd()
    tmp = tempfile.mkdtemp(prefix="smoke_bf16_lstm_")
    try:
        ds = os.path.join(tmp, "ds")
        wm = build_synthetic_dataset(ds, num_images=dict(TRAIN_DATA), vocab_words=VOCAB - 4, max_len=TRAIN_T - 2,
                                     image_size=256, learnable=True)
        os.chdir(tmp)
        zero_kernel_counts()
        free = cli_train.main(["--dataFolder", ds, "--dataName", TRAIN_DATA_NAME, "--batchSize", str(TRAIN_BS),
                               "--epochs", "1", "--device", dev.type, "--computeDtype", "bfloat16",
                               "--decoder", "lstm"])
        torch.cuda.synchronize()
        totals = kernel_counts()
        rows = free.results
        ckpt = os.path.join(tmp, "checkpoints", free.checkpoint_name())
        with open(os.path.join(ckpt, "meta.json")) as f:
            meta = json.load(f)["config"]["model"]
        if not (free.model.dtype == torch.bfloat16 and meta["compute_dtype"] == "bfloat16"
                and meta["decoder"] == "lstm" and len(rows) == 1
                and all(math.isfinite(r["trainLoss"]) and math.isfinite(r["valLoss"]) for r in rows)):
            raise AssertionError(f"phase 13d: cli.train rows {rows}, meta {meta}")
        del free
        torch.cuda.empty_cache()
        best = os.path.join(tmp, "checkpoints", f"BEST_{os.path.basename(ckpt)}")
        served = build_model_and_params(argparse.Namespace(checkpoint=best, device=str(dev), seed=seed), wm)
        images = torch.randint(0, 256, (8, 256, 256, 3), generator=torch.Generator().manual_seed(seed + 41),
                               dtype=torch.uint8).numpy()
        caps = caption_batch(served, images, wm, BEAM)
        if not (served.dtype == torch.bfloat16 and served.cfg.decoder == "lstm" and len(caps) == 8 and all(
                seq[0] == wm["<start>"] and math.isfinite(score) and np_isfinite(alpha)
                for _, score, seq, alpha in caps)):
            raise AssertionError("phase 13d: cli.caption's loader did not serve the bf16 lstm checkpoint")
        del served
        row = cli_test.main(["--dataFolder", ds, "--dataName", TRAIN_DATA_NAME, "--batchSize", str(TRAIN_BS),
                             "--checkpoint", best, "--device", dev.type, "--computeDtype", "bfloat16",
                             "--decoder", "lstm"])
        if not all(math.isfinite(v) for v in row.values()):
            raise AssertionError(f"phase 13d: cli.test row {row}")
        print(f"phase 13d: cli.train --computeDtype bfloat16 --decoder lstm rows {rows}; cli.caption on the BEST_ "
              f"checkpoint: {caps[0][0][:60]!r}; cli.test: {row}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    if any(totals[k] != totals[k.replace("_bf16", "")] for k in ("mlp_block_bf16", "dwconv_bf16")) or \
            totals["mlp_block_bf16"] == 0:
        raise AssertionError(f"phase 13d: the bf16 encoder never launched, or an f32 instance ran: {totals}")
    print(f"phase 13d launches (cli.train one free-running epoch with validation): {totals}; phase 13d took "
          f"{time.perf_counter() - t0:.1f} s")
    return totals


# Phase 14: the last bf16 instances, the whole block (``use_pallas='block'``)
# and the sub-tiled MLP tail (``TPU_CAPTIONER_MLP_SUB``).  (a) holds each
# against its plain version at the four stage shapes at batch 8 and 32:
# within one bf16 ulp (as phase 11), and the sub-tiled output within one
# ulp of the whole-tile bf16 instance.  (b) and (c) hold the bf16 'block'
# model's beam, eval step and train steps to the all-plain bf16 'block'
# path (``plain_versions``) by phase 11's and 12b's rules.  (d) runs the
# sub-tiled bf16 tail through an encoder pass and a fine-tune step, and a
# per-stage mix.  The rules were written in PERF.md before the run.
BF16_MIX = ("mlp", "mlp", "block", "block")
BF16_BLOCK_KERNELS = ("dropout_mask", "block_fused_bf16", "mlp_block_bwd", "mlp_block_bwd_bf16", "dwconv_bf16",
                      "dwconv_grad_bf16", "mlp_block")


def bf16_block_bound(b, h, w, c):
    """(bytes, ops) of one bf16 whole-block launch: x read and out written
    in bf16, the taps and the two matrices in bf16, the f32 vectors (conv
    bias, LayerNorm, b1, b2, layer scale) and the per-image scales; the
    tail's 16 N C^2 and the conv's 98 N C, all priced at the f32-accurate
    rate of a bf16 weight (``BF16_BY_F32_OPS_PER_S``), as row 1's bf16
    instance."""
    n = b * h * w
    return 2 * (2 * n * c + 49 * c + 8 * c * c) + 4 * (9 * c + b), 16 * n * c * c + 98 * n * c


def check_x3_kernels(kernels_blk, kernels_sub, c):
    """Phase 14a's kernel names (``launch_breakdown`` rows of one call):
    the bf16 block launches its conv + LayerNorm and two three-piece GEMMs,
    the sub-tiled bf16 path its one three-piece kernel, and neither a
    3xTF32 kernel, a weight split or a weight preparation.  A call whose
    windows recorded no kernel at all (``launch_breakdown_seen``) is
    reported as not recorded; ``check_x3_sass`` holds every instance to
    the same rule from the libraries' SASS."""
    names_blk, names_sub = [k for k, _, _ in kernels_blk], [k for k, _, _ in kernels_sub]
    ok_blk = not names_blk or (len(names_blk) == 3 and sum("x3::gemm_kernel" in k for k in names_blk) == 2
                               and any(k.startswith("conv_ln_kernel") for k in names_blk))
    ok_sub = not names_sub or (len(names_sub) == 1 and names_sub[0].startswith("fused_kernel")
                               and "bfloat16, false, true>" in names_sub[0])
    stray = [k for k in names_blk + names_sub if any(s in k for s in ("tf32x3", "split_kernel", "prep_w1", "to_bf16"))]
    if not (ok_blk and ok_sub) or stray:
        raise AssertionError(f"bf16 three-piece kernels at C={c}: block {names_blk}, sub-tiled {names_sub}")
    for what, names in (("block", names_blk), ("sub-tiled", names_sub)):
        if not names:
            print(f"bf16 kernels a call at C={c}: the profiler recorded no kernel of the {what} call in any window "
                  f"(not measured; check_x3_sass holds its instance)")


def check_x3_sass():
    """The bf16 instances' kernels in the built libraries: the block's
    library holds two three-piece GEMMs (``x3::gemm_kernel``) and no 3xTF32
    kernel with a bf16 type, the MLP tail's the seven sub-tiled
    three-piece instances (``fused_kernel<C, NC, bf16, false, true>``);
    each issues bf16 HGMMA and UTMALDG and no TF32 HGMMA.  Returns a
    summary."""
    import re

    found = {}
    for lib, pick, count in (("block_fused", lambda k: "bf16mm2x311gemm_kernel" in k, 2),
                             ("mlp_block", lambda k: "12fused_kernel" in k and "13__nv_bfloat16Lb0ELb1E" in k, 7)):
        parts = re.split(r"\n\s*Function : (\S+)\n", library_sass(lib))
        fns = dict(zip(parts[1::2], parts[2::2]))
        mine = {k: v for k, v in fns.items() if pick(k)}
        bad = [k for k, v in mine.items() if not (re.search(r"\bHGMMA\.\S*\.BF16", v) and re.search(r"\bUTMALDG\b", v))
               or re.search(r"\bHGMMA\.\S*TF32", v)]
        if lib == "block_fused":
            bad += [k for k in fns if "tf32x3" in k and "13__nv_bfloat16" in k]
        if len(mine) != count or bad:
            raise AssertionError(f"{lib}: {len(mine)} three-piece bf16 instances (want {count}); at fault {bad}")
        found[lib] = len(mine)
    return f"three-piece bf16 instances with bf16 HGMMA, UTMALDG and no TF32 HGMMA: {found}"


def check_bf16_block_kernels(dev, card):
    """Phase 14a: the bf16 whole-block instance against ``_block_plain_bf16``
    and the bf16 sub-tiled MLP tail against ``_mlp_plain_bf16`` and the
    whole-tile bf16 instance, at the four ConvNeXt-Base stage shapes at
    batch 8 and 32 with per-image scales (0 and 1/survival): each within one
    bf16 ulp, sd-0 images and rows their input bit for bit, both instances
    the same bits twice.  Device times by CUDA-graph replay per launch and
    per encoder pass (36 launches) beside the plain versions and the f32
    instances on the same inputs widened, and each instance's share of its
    bound per bs-32 pass.  At bs 32 each call's kernels by name and device
    ms (``launch_breakdown``): the block's conv + LayerNorm and two
    three-piece GEMMs (``x3::gemm_kernel``), the sub-tiled path's one
    three-piece ``fused_kernel<C, NC, bf16, false, true>``, and in neither a
    3xTF32 kernel (``tf32x3``), a weight split or a weight preparation.
    Returns {name: (worst abs error, ms, plain ms, None, bound ms, bound
    by)} per bs-32 pass."""
    import torch

    from tpu_captioner_torch.models.convnext import BASE_DEPTHS, BASE_DIMS
    from tpu_captioner_torch.ops.block_fused import _block_plain_bf16, fused_convnext_block
    from tpu_captioner_torch.ops.mlp_block import _mlp_plain_bf16, fused_convnext_mlp

    bf = torch.bfloat16
    print(f"phase 14a SASS: {check_x3_sass()} [{card}]")
    names = ("block_fused_bf16", "mlp_block_pipelined_bf16")
    acc = {(k, b): [0.0, 0.0, 0.0, 0.0, 0, 0] for k in names for b in (8, TRAIN_BS)}  # err, ms, plain, f32, bytes, ops
    for s, (depth, c) in enumerate(zip(BASE_DEPTHS, BASE_DIMS)):
        for b in (8, TRAIN_BS):
            h = w = 64 >> s
            n = b * h * w
            g = torch.Generator().manual_seed(400 + c + b)
            f = lambda *sh: torch.randn(*sh, generator=g)  # noqa: E731
            keep = (torch.rand(b, generator=g) < 0.8).float()
            keep[0], keep[1] = 0.0, 1.0
            sd = (keep / 0.8).to(dev)
            ln_w, ln_b, w1, b1, w2, b2, gamma = _stage_params(c, g, dev)
            x = f(b, h, w, c).to(dev, bf)
            taps, dw_b = (0.1 * f(7, 7, c)).to(dev, bf), (0.1 * f(c)).to(dev)
            blk = (x, sd, taps, dw_b, ln_w, ln_b, w1.to(bf), b1, w2.to(bf), b2, gamma)
            got, want = fused_convnext_block(*blk), _block_plain_bf16(*blk)
            err, ulps = bf16_ulp_err(got, want)
            dropped = sd == 0
            if not (ulps <= 1.0 and got.dtype == bf and torch.equal(got[dropped], x[dropped])
                    and torch.equal(fused_convnext_block(*blk), got)):
                raise AssertionError(f"block_fused bf16 kernel disagrees at {(b, h, w, c)}: {ulps} ulps")
            wide = tuple(a.float() for a in blk)
            t_blk = (_graph_ms(lambda: fused_convnext_block(*blk), iters=10),
                     _graph_ms(lambda: _block_plain_bf16(*blk), iters=3, warmup=1),
                     _graph_ms(lambda: fused_convnext_block(*wide), iters=10))
            rows = (x.view(n, c), f(n, c).to(dev, bf), sd.repeat_interleave(h * w), ln_w, ln_b, w1.to(bf), b1,
                    w2.to(bf), b2, gamma)
            with mlp_sub(None):
                whole = fused_convnext_mlp(*rows)
                t_whole = _graph_ms(lambda: fused_convnext_mlp(*rows), iters=10)
            with mlp_sub(PIPE_SUB):
                before = fused_convnext_mlp.pipelined_bf16_launches
                sub, again = fused_convnext_mlp(*rows), fused_convnext_mlp(*rows)
                if fused_convnext_mlp.pipelined_bf16_launches != before + 2:
                    raise AssertionError(f"TPU_CAPTIONER_MLP_SUB={PIPE_SUB} did not run the sub-tiled bf16 instance "
                                         f"at C={c}")
                t_sub = _graph_ms(lambda: fused_convnext_mlp(*rows), iters=10)
                wide_rows = tuple(a.float() for a in rows)
                t_sub_f32 = _graph_ms(lambda: fused_convnext_mlp(*wide_rows), iters=10)
            plain = _mlp_plain_bf16(*rows)
            m_err, m_ulps = bf16_ulp_err(sub, plain)
            _, w_ulps = bf16_ulp_err(sub, whole)
            dropped_rows = rows[2] == 0
            if not (m_ulps <= 1.0 and w_ulps <= 1.0 and torch.equal(sub, again)
                    and torch.equal(sub[dropped_rows], rows[1][dropped_rows])):
                raise AssertionError(f"mlp_block sub-tiled bf16 kernel at N={n}, C={c}: {m_ulps} ulps of the plain "
                                     f"version, {w_ulps} of the whole tile, the same bits twice: "
                                     f"{torch.equal(sub, again)}")
            t_plain = _graph_ms(lambda: _mlp_plain_bf16(*rows), iters=3, warmup=1)
            if b == TRAIN_BS:
                kernels_blk = launch_breakdown_seen(lambda: fused_convnext_block(*blk))
                with mlp_sub(PIPE_SUB):
                    kernels_sub = launch_breakdown_seen(lambda: fused_convnext_mlp(*rows))
                check_x3_kernels(kernels_blk, kernels_sub, c)
                print(f"bf16 kernels a call at {(b, h, w, c)} [{card}]: block " +
                      "; ".join(f"{k} x{n} {ms:.4f} ms" for k, n, ms in kernels_blk) + " | sub-tiled " +
                      "; ".join(f"{k} x{n} {ms:.4f} ms" for k, n, ms in kernels_sub))
            print(f"bf16 block_fused {(b, h, w, c)}: max_abs_err {err:.3e} ({ulps:.2f} ulp); kernel {t_blk[0]:.4f} ms, "
                  f"plain {t_blk[1]:.4f}, f32 instance {t_blk[2]:.4f} per launch | bf16 mlp_block SUB={PIPE_SUB} "
                  f"N={n}: {m_err:.3e} ({m_ulps:.2f} ulp of plain, {w_ulps:.2f} of the whole tile); kernel "
                  f"{t_sub:.4f} ms, plain {t_plain:.4f}, whole-tile bf16 {t_whole:.4f}, sub-tiled f32 {t_sub_f32:.4f} "
                  f"per launch [{card}]")
            nb, no = bf16_block_bound(b, h, w, c)
            for name, e, times, n_bytes, n_ops in (
                ("block_fused_bf16", err, (t_blk[0], t_blk[1], t_blk[2]), nb, no),
                # x, residual and out in bf16, the matrices in bf16, the
                # vectors and sd in f32; two N x C x 4C products.
                ("mlp_block_pipelined_bf16", m_err, (t_sub, t_plain, t_sub_f32),
                 2 * (3 * n * c + 8 * c * c) + 4 * (8 * c + n), 16 * n * c * c),
            ):
                a = acc[name, b]
                a[0] = max(a[0], e)
                for i, tt in enumerate(times):
                    a[1 + i] += depth * tt
                a[4] += depth * n_bytes
                a[5] += depth * n_ops
    out = {}
    for (name, b), (err, ms, plain_ms, f32_ms, n_bytes, n_ops) in acc.items():
        bound_ms, bound_by = bound(n_bytes, n_ops, BF16_BY_F32_OPS_PER_S)
        print(f"{name} per bs-{b} encoder pass (36 launches): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, f32 "
              f"instance {f32_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); the kernel at "
              f"{bound_ms / ms:.1%} of its bound [{card}]")
        if b == TRAIN_BS:
            out[name] = (max(err, acc[name, 8][0]), ms, plain_ms, None, bound_ms, bound_by)
    return out


def bf16_block_serve(dev, card, seed, word_map, images8, rng):
    """Phase 14b: a bf16 flagship in ``'block'`` (phase 4's weights) saved
    with ``save_checkpoint`` and loaded through ``cli.caption``'s loader,
    and the same checkpoint loaded with ``--usePallas mlp``; beam 5 x 50 at
    batch 8 and 32: 36 bf16 block launches and no MLP-forward or dwconv
    launch per encoder pass, L bf16 decode launches per token, captions held
    to the all-plain bf16 'block' path by ``bf16_agree`` (phase 11's
    noise-floor rule), the share equal to the bf16 'mlp' model's reported;
    serving times of both.  Then the eval step at batch 32 in 'block'
    against all-plain (``bf16_eval_agree``).  Returns the bf16 block
    launches of that eval step."""
    import torch

    from tpu_captioner_torch.cli.caption import build_model_and_params, caption_batch
    from tpu_captioner_torch.core.config import ExperimentConfig, ModelConfig, TrainConfig
    from tpu_captioner_torch.models.convnext import CNBlock
    from tpu_captioner_torch.train.checkpoint import save_checkpoint
    from tpu_captioner_torch.train.state import TrainState
    from tpu_captioner_torch.train.steps import make_eval_step

    t0 = time.perf_counter()
    cfg = ModelConfig(vocab_size=VOCAB, compute_dtype="bfloat16", use_pallas="block")
    with tempfile.TemporaryDirectory() as tmp:
        model = flagship_model(cfg, dev, seed)
        meta = {"epoch": 0, "epochs_since_improvement": 0, "bleu4": 0.0, "results": [],
                "config": dataclasses.asdict(ExperimentConfig(model=cfg, train=TrainConfig()))}
        path = save_checkpoint(tmp, "checkpoint_bf16_block_smoke", TrainState.create(model, TrainConfig()), meta)
        served = build_model_and_params(argparse.Namespace(checkpoint=path, device=str(dev), seed=seed + 7), word_map)
        mlp = build_model_and_params(argparse.Namespace(checkpoint=path, device=str(dev), seed=seed + 7,
                                                        usePallas="mlp"), word_map)
    want_sd = model.state_dict()
    modes = {m: {b.mode for b in m.modules() if isinstance(b, CNBlock)} for m in (served, mlp)}
    if not (served.dtype == mlp.dtype == torch.bfloat16 and modes[served] == {"block"} and modes[mlp] == {"mlp"}
            and all(torch.equal(v, want_sd[k]) for m in (served, mlp) for k, v in m.state_dict().items())):
        raise AssertionError(f"the bf16 'block' checkpoint did not load as saved ({modes[served]}, {modes[mlp]})")
    del model
    names = ("block_fused_bf16", "mlp_block_bf16", "dwconv_bf16", "decode_step_bf16")
    for bs, imgs in ((8, images8.numpy()), (TRAIN_BS, torch.randint(0, 256, (TRAIN_BS, 256, 256, 3), generator=rng,
                                                                      dtype=torch.uint8).numpy())):
        steps = [0]
        embed = served.decoder.embed

        def counted_embed(*a):  # one lookup per generated token
            steps[0] += 1
            return embed(*a)

        served.decoder.embed = counted_embed
        zero_kernel_counts()
        got = caption_batch(served, imgs, word_map, BEAM)
        torch.cuda.synchronize()
        counts = kernel_counts()
        seen = tuple(counts[k] for k in names)
        del served.decoder.embed
        print(f"bf16 'block' serving bs={bs}: bf16 launches {dict(zip(names, seen))} over {steps[0]} tokens")
        if seen != (36, 0, 0, served.cfg.num_layers * steps[0]) or steps[0] < 1:
            raise AssertionError(f"bf16 'block' serving bs={bs}: expected (36, 0, 0, L x tokens) launches, got {seen}")
        for cap, score, seq, alpha in got:
            if not (seq[0] == word_map["<start>"] and alpha.shape == (len(seq), cfg.num_pixels)
                    and np_isfinite(alpha) and math.isfinite(score)):
                raise AssertionError("malformed bf16 'block' caption output")
        with plain_versions():
            want = caption_batch(served, imgs, word_map, BEAM)
        bf16_agree(served, dev, bs, imgs, word_map, got, want)
        ref = caption_batch(mlp, imgs, word_map, BEAM)
        same = sum(len(a[2]) == len(r[2]) and bool((a[2] == r[2]).all()) for a, r in zip(got, ref))
        print(f"bf16 'block' serving bs={bs}: {same} of {bs} captions equal to the bf16 'mlp' model's "
              f"({same / bs:.4f}; the two round the conv differently)")
    serve_times(card, "serve bf16 phase 14", {"bf16 'block'": served, "bf16 'mlp'": mlp}, rng, dev, word_map)
    del mlp
    torch.cuda.empty_cache()

    # The eval step at batch 32 in 'block', against all-plain (and its f64 floor).
    tc = TrainConfig(batch_size=TRAIN_BS)
    batch = {k: v.to(dev) for k, v in train_batch(torch.Generator().manual_seed(seed + 9), word_map, VOCAB).items()}
    served.decoder.capture_alphas = True
    served.cfg = dataclasses.replace(served.cfg, decode_kernel="step")
    step = make_eval_step(served, tc, word_map)
    runs, launches = {}, None
    # The floor's sums in f64 in the encoder too: one-ulp flips of the 36
    # blocks' bf16 outputs reach the decode through the features.
    for arm, sums in (("'block'", None), ("all-plain", torch.float32), ("all-plain f64", torch.float64)):
        wide = sums if sums == torch.float64 else None
        with plain_versions(sums, encoder_sums=wide) if sums is not None else contextlib.nullcontext():
            zero_kernel_counts()
            aux = step(batch)
            torch.cuda.synchronize()
            counts = kernel_counts()
            with torch.inference_mode():
                roll = served.rollout(served.encode(batch["images"]), word_map["<start>"], word_map["<end>"],
                                      tc.max_decode_len)
        need = int(aux["lengths"].max())
        seen = tuple(counts[k] for k in names)
        expect = (36, 0, 0, served.cfg.num_layers * need) if sums is None else (0, 0, 0, 0)
        print(f"bf16 'block' eval {arm}: bf16 launches {dict(zip(names, seen))}; loss {float(aux['loss']):.6f}, "
              f"tokens {int(aux['tokens'])}, top5 {int(aux['top5_correct'])}")
        if seen != expect or not (torch.isfinite(roll[0]).all() and math.isfinite(float(aux["loss"]))):
            raise AssertionError(f"bf16 'block' eval {arm}: expected launches {expect}, got {seen}, or a non-finite "
                                 f"output")
        runs[arm] = (step, aux, roll)
        if sums is None:
            launches = seen[0]
    bf16_eval_agree("bf16 'block' eval", runs, "'block'", "all-plain", "all-plain f64")
    eval_ms, _ = _host_ms(lambda: step(batch))
    print(f"bf16 'block' eval bs={TRAIN_BS} 'step': eval step {eval_ms:.2f} ms [{card}]; phase 14b took "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def bf16_block_train(dev, card, seed, word_map, rng):
    """Phase 14c and 14d.  (c) The full-width bf16 frozen and fine-tune
    steps at batch 32 in 'block' against the all-plain bf16 'block' steps
    (``plain_versions``), their f64-sum noise floor and the f32 'block'
    steps on the same weights, pool bits and stochastic-depth rows
    (``bf16_train_agree``: phase 12b's rules); launches per step, ms per
    step and peak memory.  (d) On the same model: a bf16 encoder pass and a
    fine-tune step in 'mlp' with TPU_CAPTIONER_MLP_SUB=PIPE_SUB (36
    sub-tiled bf16 launches each, the features within 2^-6 of the
    whole-tile pass's, the step's loss within BF16_TRAIN_LOSS of the
    whole-tile step's), and a bf16 encoder pass and fine-tune step in the
    per-stage mix BF16_MIX (30 block and 6 MLP-tail bf16 launches a pass,
    the features within 2^-6 of all-plain's).  Returns the bf16 block
    launches of a fine-tune step and the sub-tiled ones of a pass and of a
    fine-tune step."""
    import torch

    from tpu_captioner_torch.core import prng
    from tpu_captioner_torch.core.config import ModelConfig, TrainConfig
    from tpu_captioner_torch.train.model import CaptionModel
    from tpu_captioner_torch.train.state import TrainState
    from tpu_captioner_torch.train.steps import make_train_step

    t0 = time.perf_counter()
    tc = TrainConfig(batch_size=TRAIN_BS)
    cfg = ModelConfig(vocab_size=VOCAB, compute_dtype="bfloat16", use_pallas="block")
    model = CaptionModel(cfg, device=dev, seed=seed + 40)
    gen = torch.Generator().manual_seed(seed + 40)
    with torch.no_grad():  # order-one layer scales, as in phase 12b
        for blk in (m for m in model.modules() if hasattr(m, "layer_scale")):
            blk.layer_scale.copy_(0.1 * torch.rand(blk.layer_scale.shape, generator=gen))
    start = copy.deepcopy(model.state_dict())
    f32 = CaptionModel(dataclasses.replace(cfg, compute_dtype="float32"), device=dev)
    f32.load_state_dict(start)
    batch = {k: v.to(dev) for k, v in train_batch(gen, word_map, VOCAB).items()}
    root = prng.root_seed(seed + 41)
    seeds = [prng.step_seed(root, "dropout", 0, i) for i in range(2)]
    names = BF16_BLOCK_KERNELS
    trained = 30  # the blocks of children 5 and 7 (starting_layer 5)

    def two_steps(m, train_encoder, plain=False, sums=None):
        return bf16_two_steps(m, start, tc, word_map, batch, seeds, train_encoder, plain=plain, sums=sums,
                              names=names)

    launches = {}
    for label, train_encoder, expect in (("frozen", False, (1, 36, 0, 0, 0, 0, 0)),
                                         ("fine-tune", True, (1, 36, trained, 0, 2 * trained - 1, trained, 0))):
        got, grads, params, after, seen = two_steps(model, train_encoder)
        if any(c != expect for c in seen):
            raise AssertionError(f"bf16 'block' {label} step: expected {names} launches {expect} per step, got {seen}")
        want, want_grads, want_params, _, plain_seen = two_steps(model, train_encoder, plain=True)
        _, floor_grads, _, _, floor_seen = two_steps(model, train_encoder, plain=True, sums=torch.float64)
        if any(c[1:] != (0,) * (len(names) - 1) for c in plain_seen + floor_seen):
            raise AssertionError(f"bf16 'block' {label} step, all-plain: a kernel launched ({plain_seen}, "
                                 f"{floor_seen})")
        _, f32_grads, _, _, _ = two_steps(f32, train_encoder)
        changed = bf16_train_agree(f"bf16 'block' {label}", got, want, grads, want_grads, floor_grads, f32_grads,
                                   params, want_params, start, after, tc.encoder_lr)
        print(f"bf16 'block' {label} step: launches per step {dict(zip(names, seen[0]))}; encoder tensors changed "
              f"per child {dict(sorted(changed.items()))}")
        if any((i >= FT_START and train_encoder) != (c > 0) for i, c in changed.items()):
            raise AssertionError(f"bf16 'block' {label}: children below {FT_START} must stay bit-identical, the rest "
                                 f"change")
        launches[label] = seen[0]
        del grads, want_grads, floor_grads, f32_grads, params, want_params, after
        torch.cuda.empty_cache()
    del f32
    torch.cuda.empty_cache()
    for label, train_encoder in (("frozen", False), ("fine-tune", True)):
        model.load_state_dict(start)
        state = TrainState.create(model, tc)
        step = make_train_step(model, tc, word_map, train_encoder=train_encoder)
        for i in range(2):
            state, _ = step(state, batch, prng.step_seed(root, "dropout", 1, i))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(5):
            t1 = time.perf_counter()
            state, met = step(state, batch, prng.step_seed(root, "dropout", 2, i))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        ms = sorted(times)[len(times) // 2]
        print(f"bf16 'block' {label} step bs={TRAIN_BS}: median {ms:.2f} ms/step over 5 steps (min {min(times):.2f}, "
              f"max {max(times):.2f}), {TRAIN_BS / (ms / 1e3):.1f} images/s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, {sum(launches[label]) } kernel launches "
              f"{dict(zip(names, launches[label]))} per step, loss {float(met['loss']):.4f} [{card}]")
        mfu_line(f"bf16 'block' {label} step bs={TRAIN_BS}", step_flops(cfg, batch["images"].shape[1], train_encoder),
                 ms, cfg.compute_dtype, card)
        del state, step
        torch.cuda.empty_cache()
    print(f"phase 14c took {time.perf_counter() - t0:.1f} s")

    # 14d: the sub-tiled bf16 tail ('mlp', TPU_CAPTIONER_MLP_SUB) and the per-stage mix.
    t0 = time.perf_counter()
    imgs = torch.randint(0, 256, (TRAIN_BS, 256, 256, 3), generator=rng, dtype=torch.uint8).to(dev)
    model.load_state_dict(start)
    set_mode(model, "mlp")
    with torch.inference_mode():
        with mlp_sub(None):
            whole = model.encode(imgs)
        with mlp_sub(PIPE_SUB):
            zero_kernel_counts()
            piped = model.encode(imgs)
            torch.cuda.synchronize()
            pass_counts = kernel_counts()
    sub_err = bf16_rel(piped.float(), whole.float())
    print(f"bf16 'mlp' encoder pass bs={TRAIN_BS} with TPU_CAPTIONER_MLP_SUB={PIPE_SUB}: "
          f"{pass_counts['mlp_block_pipelined_bf16']} sub-tiled bf16 of {pass_counts['mlp_block_bf16']} bf16 tail "
          f"launches; features {sub_err:.3e} of the largest from the whole-tile pass's (tol {2.0 ** -6:g})")
    if not (pass_counts["mlp_block_pipelined_bf16"] == pass_counts["mlp_block_bf16"] == 36 and sub_err <= 2.0 ** -6):
        raise AssertionError(f"the sub-tiled bf16 encoder pass: {pass_counts}, features {sub_err}")
    ft = {}
    for arm, sub in (("whole tile", None), ("sub-tiled", PIPE_SUB)):
        with mlp_sub(sub):
            out, _, _, _, seen = bf16_two_steps(model, start, tc, word_map, batch, seeds[:1], True,
                                                names=("mlp_block_bf16", "mlp_block_pipelined_bf16",
                                                       "mlp_block_bwd_bf16"))
        ft[arm] = (out[0], seen[0])
    loss_rel = abs(ft["sub-tiled"][0]["loss"] - ft["whole tile"][0]["loss"]) / abs(ft["whole tile"][0]["loss"])
    print(f"bf16 'mlp' fine-tune step: launches (mlp_block_bf16, mlp_block_pipelined_bf16, mlp_block_bwd_bf16) "
          f"sub-tiled {ft['sub-tiled'][1]}, whole tile {ft['whole tile'][1]}; loss {ft['sub-tiled'][0]['loss']:.6f} vs "
          f"{ft['whole tile'][0]['loss']:.6f} ({loss_rel:.3e} relative, tol {BF16_TRAIN_LOSS:g})")
    if not (ft["sub-tiled"][1] == (36, 36, 30) and ft["whole tile"][1] == (36, 0, 30)
            and loss_rel <= BF16_TRAIN_LOSS):
        raise AssertionError(f"the sub-tiled bf16 fine-tune step: {ft}")
    for s, mode in enumerate(BF16_MIX):  # stage s is the encoder's child 2 s + 1
        set_mode(model.encoder.convnext[2 * s + 1], mode)
    model.load_state_dict(start)
    with torch.inference_mode():
        zero_kernel_counts()
        mixed = model.encode(imgs)
        torch.cuda.synchronize()
        mix_counts = kernel_counts()
        with plain_versions():
            mixed_plain = model.encode(imgs)
    mix_err = bf16_rel(mixed.float(), mixed_plain.float())
    mix_seen = tuple(mix_counts[k] for k in ("block_fused_bf16", "mlp_block_bf16", "dwconv_bf16"))
    out, _, _, _, seen = bf16_two_steps(model, start, tc, word_map, batch, seeds[:1], True,
                                        names=("block_fused_bf16", "mlp_block_bf16", "mlp_block_bwd",
                                               "mlp_block_bwd_bf16", "dwconv_grad_bf16"))
    print(f"bf16 per-stage mix {BF16_MIX} encoder pass bs={TRAIN_BS}: launches (block_fused_bf16, mlp_block_bf16, "
          f"dwconv_bf16) {mix_seen}; features {mix_err:.3e} of the largest from all-plain's (tol {2.0 ** -6:g}); "
          f"fine-tune step launches (block_fused_bf16, mlp_block_bf16, mlp_block_bwd, mlp_block_bwd_bf16, "
          f"dwconv_grad_bf16) {seen[0]}, loss {out[0]['loss']:.6f}; phase 14d took {time.perf_counter() - t0:.1f} s")
    if not (mix_seen == (30, 6, 6) and mix_err <= 2.0 ** -6 and seen[0] == (30, 6, 30, 0, 30)
            and math.isfinite(out[0]["loss"])):
        raise AssertionError(f"the bf16 per-stage mix: launches {mix_seen}, {seen[0]}, features {mix_err}")
    del model
    torch.cuda.empty_cache()
    return launches["fine-tune"][1], pass_counts["mlp_block_pipelined_bf16"], ft["sub-tiled"][1][1]


# Phase 15: what a one-card user of the JAX package has besides the model's
# paths: the native host runtime, the attention visualiser on a one-image
# beam, the Trainer's trace window and the .npz backbone.
NATIVE_HYPS = 25_000  # COCO's validation images, 5 reference captions each (the reference's val split)
GATHER_REPEATS = 20
PACKAGES = ("PIL", "matplotlib", "pandas", "scipy")  # host packages phase 15 reports
CLI_IMAGES = 32  # the directory of images cli.caption captions in phase 15b


def bleu_corpus(rng, n, vocab):
    """``n`` hypotheses with 5 references each, 8 to 16 tokens, words drawn
    from a Zipf law (as caption words fall), each hypothesis its first
    reference with 30% of the words replaced: BLEU-4 well above 0."""
    import numpy as np

    def sentence(k):
        return [int(w) for w in np.minimum(rng.zipf(1.3, k), vocab - 4)]

    refs = [[sentence(rng.integers(8, 17)) for _ in range(5)] for _ in range(n)]
    hyps = []
    for r in refs:
        swap = rng.random(len(r[0])) < 0.3
        hyps.append([int(rng.integers(1, vocab - 4)) if s else w for w, s in zip(r[0], swap)])
    return refs, hyps


def check_bleu(label, refs, hyps):
    """The native BLEU-1..4 against the pure-Python scorer on one corpus,
    equal to the last bit; host ms of each (the native one the median of 3)."""
    from tpu_captioner_torch.eval.bleu import bleu_1_to_4 as plain_bleu
    from tpu_captioner_torch.native.bleu_native import bleu_1_to_4

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = bleu_1_to_4(refs, hyps)
        times.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    want = plain_bleu(refs, hyps)
    plain_ms = (time.perf_counter() - t0) * 1e3
    if got != want:
        raise AssertionError(f"{label}: native BLEU {got} != Python {want}")
    native_ms = sorted(times)[1]
    print(f"{label}: {len(hyps)} hypotheses, BLEU-1..4 {tuple(round(b, 6) for b in got)} native = Python bit for "
          f"bit; host ms native {native_ms:.2f}, Python {plain_ms:.2f} ({plain_ms / native_ms:.1f}x)")
    return native_ms, plain_ms


def native_phase(card, ds):
    """Phase 15a: the native host runtime built from the checkout; its BLEU
    against the pure-Python scorer on a COCO-validation-sized synthetic
    corpus; its batch gather (with its default threads and with one) against
    numpy's fancy indexing, bit for bit, on phase 10a's memmapped TRAIN
    records at batch 32, with host times."""
    import numpy as np

    from tpu_captioner_torch.data.dataset import CaptionDataset
    from tpu_captioner_torch.native import lib
    from tpu_captioner_torch.native.gather import gather_batch_native

    t0 = time.perf_counter()
    path = lib.build()
    lib.get_lib()
    print(f"phase 15a: native runtime {os.path.relpath(path, ROOT)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s ({' '.join((lib.COMPILER,) + lib.FLAGS)})")
    rng = np.random.default_rng(1520)
    check_bleu("phase 15a BLEU, synthetic corpus", *bleu_corpus(rng, NATIVE_HYPS, VOCAB))

    data = CaptionDataset(ds, TRAIN_DATA_NAME, "TRAIN")
    times = {"native": [], "native, 1 thread": [], "numpy": []}
    for _ in range(GATHER_REPEATS):
        idx = rng.permutation(len(data))[:TRAIN_BS]
        args = (data.images, data.captions, data.caplens, idx // data.cpi, idx)
        t0 = time.perf_counter()
        got = gather_batch_native(*args)
        t1 = time.perf_counter()
        one = gather_batch_native(*args, n_threads=1)
        t2 = time.perf_counter()
        want = (np.ascontiguousarray(data.images[idx // data.cpi]), data.captions[idx], data.caplens[idx])
        t3 = time.perf_counter()
        for k, t in zip(times, (t1 - t0, t2 - t1, t3 - t2)):
            times[k].append(t * 1e3)
        if not all(a.dtype == b.dtype == c.dtype and np.array_equal(a, b) and np.array_equal(c, b)
                   for a, b, c in zip(got, want, one)):
            raise AssertionError("phase 15a: the native gather differs from numpy's")
    print(f"phase 15a gather: batch {TRAIN_BS} of {data.images.shape[1:]} uint8 images from the memmapped "
          f"records, {GATHER_REPEATS} batches equal to numpy bit for bit; host ms median (min) "
          + ", ".join(f"{k} {sorted(v)[GATHER_REPEATS // 2]:.3f} ({min(v):.3f})" for k, v in times.items())
          + f" ({os.cpu_count()} cores seen)")


def encoder_pass_bs1(dev, card):
    """Rows 1 and 10 at the one-image caption's shapes: the MLP tail and the
    depthwise conv (with the block's bias) at the four ConvNeXt-Base stages
    at batch 1 against their plain versions, device times by CUDA-graph
    replay, summed over one encoder pass's 36 blocks with their bounds (as
    ``check_mlp`` and ``check_dwconv`` price them), and F.conv2d's."""
    import torch
    import torch.nn.functional as F

    from tpu_captioner_torch.models.convnext import BASE_DEPTHS, BASE_DIMS
    from tpu_captioner_torch.ops.dwconv import _dw_plain, dwconv_forward
    from tpu_captioner_torch.ops.mlp_block import _mlp_plain, fused_convnext_mlp

    sums = {k: [0.0, 0.0, 0.0, None, 0, 0] for k in ("mlp_block", "dwconv")}  # err, ms, plain, library, bytes, ops
    sums["dwconv"][3] = 0.0
    for s, (depth, c) in enumerate(zip(BASE_DEPTHS, BASE_DIMS)):
        g = torch.Generator().manual_seed(150 + c)
        f = lambda *sh: torch.randn(*sh, generator=g).to(dev)  # noqa: E731
        side = 64 >> s
        n = side * side
        args = (f(n, c), f(n, c), torch.ones(n, device=dev), 1 + 0.1 * f(c), 0.1 * f(c), 0.02 * f(4 * c, c),
                0.1 * f(4 * c), 0.02 * f(c, 4 * c), 0.1 * f(c), 0.5 * f(c))
        err = (fused_convnext_mlp(*args) - _mlp_plain(*args)).abs().max().item()
        if not err < MLP_TOL:
            raise AssertionError(f"phase 15b: mlp_block disagrees at batch 1, C={c}: {err}")
        t = (_graph_ms(lambda: fused_convnext_mlp(*args)), _graph_ms(lambda: _mlp_plain(*args)))
        acc = sums["mlp_block"]
        acc[0] = max(acc[0], err)
        acc[1] += depth * t[0]
        acc[2] += depth * t[1]
        acc[4] += depth * 4 * (3 * n * c + n + 8 * c * c + 8 * c)
        acc[5] += depth * 16 * n * c * c
        x, w, bias = f(1, side, side, c), 0.1 * f(7, 7, c), f(c)
        wc = w.permute(2, 0, 1).unsqueeze(1).contiguous()
        err, rel = _rel_err(dwconv_forward(x, w, bias=bias), _dw_plain(x, w, bias))
        if not rel < DW_TOL:
            raise AssertionError(f"phase 15b: dwconv disagrees at batch 1, C={c}: {rel}")
        td = (_graph_ms(lambda: dwconv_forward(x, w, bias=bias)), _graph_ms(lambda: _dw_plain(x, w, bias)),
              _graph_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2), wc, bias, padding=3, groups=c)))
        acc = sums["dwconv"]
        acc[0] = max(acc[0], err)
        for i, v in enumerate(td):
            acc[1 + i] += depth * v
        acc[4] += depth * 4 * (2 * n * c + 49 * c + c)
        acc[5] += depth * 2 * 49 * n * c
        print(f"phase 15b batch 1 C={c} ({side}x{side}): mlp_block {t[0]:.4f} ms (plain {t[1]:.4f}), dwconv "
              f"{td[0]:.4f} ms (plain {td[1]:.4f}, F.conv2d {td[2]:.4f}) per launch, device [{card}]")
    for k, (err, ms, plain_ms, lib_ms, n_bytes, n_ops) in sums.items():
        bound_ms, bound_by = bound(n_bytes, n_ops, F32_PRODUCT_OPS_PER_S if k == "mlp_block" else F32_OPS_PER_S)
        print(f"phase 15b {k} per batch-1 encoder pass (36 launches): kernel {ms:.4f} ms, plain {plain_ms:.4f}"
              + ("" if lib_ms is None else f", F.conv2d {lib_ms:.4f}")
              + f", bound {bound_ms:.4f} ms ({bound_by}), max abs err {err:.3e} [{card}]")


def one_image_beam(dev, card, family, model, image, word_map):
    """One image through ``caption_batch`` (the CLI's path) with the kernels,
    then with every kernel replaced by its plain version (``plain_versions``):
    launches counted (36 MLP-tail and 36 dwconv, and L decode_step or one
    lstm_step per beam step, R = 5 rows), captions held by the near-tie
    rule, scores within SCORE_TOL and, for equal captions, the maps and
    their upsampled grids (``infer/visualize.py:upsample_alpha``) within
    ALPHA_TOL; then the caption's host time."""
    import numpy as np
    import torch

    from tpu_captioner_torch.cli.caption import caption_batch
    from tpu_captioner_torch.infer.visualize import upsample_alpha

    lstm = family == "lstm"
    steps = [0]  # one embedding lookup per beam step
    hook = model.decoder.embedding.register_forward_hook(lambda *a: steps.__setitem__(0, steps[0] + 1))
    zero_kernel_counts()
    got = caption_batch(model, image, word_map, BEAM)
    torch.cuda.synchronize()
    hook.remove()
    counts = kernel_counts()
    dec = "lstm_step" if lstm else "decode_step"
    seen = (counts["mlp_block"], counts["dwconv"], counts[dec])
    want_launches = (36, 36, (1 if lstm else model.cfg.num_layers) * steps[0])
    if seen != want_launches or steps[0] < 1:
        raise AssertionError(f"phase 15b {family}: launches (mlp_block, dwconv, {dec}) {seen}, expected "
                             f"{want_launches} over {steps[0]} beam steps")
    with plain_versions():
        want = caption_batch(model, image, word_map, BEAM)
        compare_captions(got, want, model, torch.from_numpy(image).to(dev))
    (cap, score, seq, alpha), (_, plain_score, plain_seq, plain_alpha) = got[0], want[0]
    if not (seq[0] == word_map["<start>"] and alpha.dtype == np.float32
            and alpha.shape == (len(seq), model.cfg.num_pixels) and np.isfinite(alpha).all()):
        raise AssertionError(f"phase 15b {family}: malformed caption output")
    line = f"phase 15b {family} one-image beam {BEAM} x {MAX_STEPS} (R = {BEAM} rows): {len(seq)} tokens"
    if len(seq) == len(plain_seq) and (seq == plain_seq).all():
        e = model.cfg.encoded_image_size
        grid_err = max(np.abs(upsample_alpha(a.reshape(e, e)) - upsample_alpha(b.reshape(e, e))).max()
                       for a, b in zip(alpha, plain_alpha))
        alpha_err = np.abs(alpha - plain_alpha).max()
        if not (alpha_err < ALPHA_TOL and grid_err < ALPHA_TOL):
            raise AssertionError(f"phase 15b {family}: maps {alpha_err}, upsampled {grid_err} >= {ALPHA_TOL}")
        line += (f", caption equal to all-plain's, score {score:.4f} vs {plain_score:.4f}, maps within "
                 f"{alpha_err:.3e}, upsampled grids within {grid_err:.3e} (tol {ALPHA_TOL:g})")
    else:
        line += ", differs from all-plain's at a near-tie (maps not compared)"
    host_ms, _ = _host_ms(lambda: caption_batch(model, image, word_map, BEAM))
    print(line + f"; launches (mlp_block, dwconv, {dec}) {seen}; {host_ms:.2f} ms a caption from a uint8 "
          f"array ({1e3 / host_ms:.2f} images/s, host clock) [{card}]: {cap[:60]!r}")


def caption_cli(dev, card, keep, best):
    """Phase 15b's file path, where PIL is present: ``cli.caption.main`` on
    phase 10b's ``BEST_`` checkpoint for one seeded PNG (with ``--out``
    where matplotlib is present too: the grid written and read back), then
    for a directory of CLI_IMAGES PNGs; images/s of each call, the files'
    decode and the checkpoint's load included, and the load alone
    (``build_model_and_params``)."""
    import numpy as np

    if not importlib.util.find_spec("PIL"):
        print("phase 15b: cli.caption on image files not run: PIL is missing on this machine")
        return
    from PIL import Image

    from tpu_captioner_torch.cli import caption

    draw = importlib.util.find_spec("matplotlib") is not None
    folder = os.path.join(keep, "images")
    os.makedirs(folder)
    rng = np.random.default_rng(1530)
    for i in range(CLI_IMAGES):
        Image.fromarray(rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)).save(os.path.join(folder, f"{i:02d}.png"))
    wm = os.path.join(keep, "ds", f"WORDMAP_{TRAIN_DATA_NAME}.json")
    common = ["--checkpoint", best, "--wordMap", wm, "--device", dev.type]
    out = os.path.join(keep, "att.png")
    t0 = time.perf_counter()
    caption.main(["--img", os.path.join(folder, "00.png")] + (["--out", out] if draw else []) + common)
    one_s = time.perf_counter() - t0
    if draw:
        import matplotlib.image

        grid = matplotlib.image.imread(out)
        if not (grid.ndim == 3 and grid.shape[0] > 100 and grid.shape[1] > 100):
            raise AssertionError(f"phase 15b: the attention grid {out} has shape {grid.shape}")
    t0 = time.perf_counter()
    caption.main(["--img", folder, "--out", os.path.join(keep, "dir.png")] + common)
    dir_s = time.perf_counter() - t0
    if os.path.exists(os.path.join(keep, "dir.png")):
        raise AssertionError("phase 15b: cli.caption drew a grid for a directory")
    with open(wm) as f:
        word_map = json.load(f)
    load_s, _ = _host_ms(lambda: caption.build_model_and_params(argparse.Namespace(
        checkpoint=best, device=dev.type, seed=0), word_map), repeats=1)
    load_s /= 1e3
    print(f"phase 15b cli.caption on PNG files{' --out' if draw else ' (no --out: matplotlib is missing)'}: one "
          f"image {one_s:.2f} s a call ({1 / one_s:.3f} images/s); a directory of {CLI_IMAGES}: {dir_s:.2f} s "
          f"({CLI_IMAGES / dir_s:.2f} images/s); each call loads the checkpoint, {load_s:.2f} s alone: "
          f"{1 / (one_s - load_s):.2f} and {CLI_IMAGES / (dir_s - load_s):.2f} images/s without it (host clock, "
          f"the PNGs' decode included) [{card}]")


def one_image_phase(dev, card, seed, word_map, keep, best):
    """Phase 15b: the one-image caption at full width.  Rows 1 and 10 at
    batch 1 (``encoder_pass_bs1``); ConvNeXt-Base + the 6-layer E=512
    Transformer and ConvNeXt-Base + ``lstm`` with the LSTM step kernel on,
    each through ``one_image_beam`` against all-plain; rows 4 and 7 at R =
    5 rows against their plain versions, device times by CUDA-graph replay
    with their bounds; then ``caption_cli`` where PIL is present."""
    import numpy as np

    from tpu_captioner_torch.core.config import ModelConfig

    encoder_pass_bs1(dev, card)
    image = np.random.default_rng(seed + 1531).integers(0, 256, (1, 256, 256, 3), dtype=np.uint8)
    for family, cfg in (("transformer", ModelConfig(vocab_size=VOCAB)),
                        ("lstm", ModelConfig(decoder="lstm", vocab_size=VOCAB, decode_kernel="on"))):
        model = flagship_model(cfg, dev, seed + 31)
        one_image_beam(dev, card, family, model, image, word_map)
        if family == "transformer":
            err, *times = check_decode(dev, card, model.decoder.layers, BEAM, timer=_graph_ms)["decode_step"]
            print("phase 15b decode_step at R = {}: {:.4f} ms per 6-layer step device (CUDA-graph replay), plain "
                  "{:.4f}, bound {:.4f} ({}), max abs err {:.3e} [{}]".format(BEAM, *times, err, card))
        del model
    err, *times = check_lstm(dev, card, cases=((BEAM, 512),))
    print("phase 15b lstm_step at R = {}: {:.4f} ms device (CUDA-graph replay), plain {:.4f}, bound {:.4f} ({}), "
          "max abs err {:.3e} [{}]".format(BEAM, *times, err, card))
    caption_cli(dev, card, keep, best)


def trace_phase(dev, card, ds):
    """Phase 15c: a Trainer with ``profile_dir`` over one teacher-forced
    frozen epoch (batch 32) on phase 10a's records.  Its trace of steps 2-6
    parses and holds ProfilerStep#2-#6; its kernel events, grouped as
    ``_kernel_ms_by_group`` groups them, hold the launches the wrappers
    counted over those steps: 5 dropout_mask and 180 dwconv kernels, and
    the 180 mlp_block launches' kernels (a whole number of each).  The
    validation's BLEU corpora (phase 10a's VAL records) score the same with
    the native and the Python scorer."""
    import math
    import shutil

    import torch

    from tpu_captioner_torch.core.config import ExperimentConfig, ModelConfig, TrainConfig
    from tpu_captioner_torch.data.vocab import load_word_map
    from tpu_captioner_torch.train import loop

    tmp = tempfile.mkdtemp(prefix="smoke_trace_")
    try:
        word_map = load_word_map(os.path.join(ds, f"WORDMAP_{TRAIN_DATA_NAME}.json"))
        exp = ExperimentConfig(model=ModelConfig(), train=TrainConfig(
            batch_size=TRAIN_BS, epochs=1, teacher_forcing=True, print_freq=1000,
            checkpoint_dir=os.path.join(tmp, "ckpt"), results_dir=os.path.join(tmp, "results")))
        corpora, real_bleu = [], loop.bleu_1_to_4
        loop.bleu_1_to_4 = lambda refs, hyps: corpora.append((refs, hyps)) or real_bleu(refs, hyps)
        record = {"train": [], "eval": []}
        t0 = time.perf_counter()
        try:
            with counted_trainer_steps(record, word_map[EVAL_WORD]):
                trainer = loop.Trainer(exp, ds, TRAIN_DATA_NAME, device=dev, verbose=False,
                                       profile_dir=os.path.join(tmp, "trace"))
                (row,) = trainer.run()
        finally:
            loop.bleu_1_to_4 = real_bleu
        run_s = time.perf_counter() - t0
        del trainer
        torch.cuda.empty_cache()
        ((refs, hyps),) = corpora
        check_bleu("phase 15c BLEU, the validation corpora", refs, hyps)
        if row["bleu1"] != real_bleu(refs, hyps)[0]:
            raise AssertionError("phase 15c: the row's BLEU-1 is not the corpora's")
        traces = os.listdir(os.path.join(tmp, "trace"))
        if traces != ["trace_epoch0_steps2-6.pt.trace.json"] or not math.isfinite(row["trainLoss"]):
            raise AssertionError(f"phase 15c: traces {traces}, row {row}")
        path = os.path.join(tmp, "trace", traces[0])
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        # The host's spans (the card's timeline repeats them as gpu_user_annotation).
        steps = sorted(e["name"] for e in events
                       if e.get("cat") == "user_annotation" and e["name"].startswith("ProfilerStep#"))
        kernels = {}
        for e in events:
            if e.get("cat") == "kernel":
                kernels[kernel_group(e["name"])] = kernels.get(kernel_group(e["name"]), 0) + 1
        counted = [c for _, c in record["train"][2:7]]
        launches = dict(zip(("dropout_mask", "mlp_block", "mlp_block_bwd", "dwconv", "dwconv_grad"),
                            (sum(c[k] for c in counted) for k in range(5))))
        per_mlp = kernels.get("mlp_block", 0) / max(launches["mlp_block"], 1)
        print(f"phase 15c: Trainer(profile_dir=) one TF frozen epoch, {len(record['train'])} steps, "
              f"{run_s:.1f} s; trace {traces[0]} ({os.path.getsize(path) / 2**20:.1f} MiB, {len(events)} events), "
              f"steps {steps}; kernel events by group {dict(sorted(kernels.items()))}; wrapper launches over "
              f"steps 2-6 {launches}; {per_mlp:g} kernels per mlp_block launch [{card}]")
        if not (steps == [f"ProfilerStep#{i}" for i in range(2, 7)] and len(counted) == 5
                and (launches["dropout_mask"], launches["mlp_block"], launches["dwconv"]) == (5, 180, 180)
                and kernels.get("dropout_mask") == 5 and kernels.get("dwconv") == 180
                and per_mlp >= 1 and per_mlp == int(per_mlp)):
            raise AssertionError("phase 15c: the trace does not hold steps 2-6's kernels")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def backbone_phase(dev, card, seed, ds):
    """Phase 15d: a seeded full-size torchvision-keyed ConvNeXt-Base state
    dict (``features.*`` and the classifier) saved as a ``.pth``, turned into
    an ``.npz`` by ``cli.build_data port-backbone``; Trainers from either
    file hold equal encoder states, equal to the seeded weights."""
    import shutil

    import torch

    from tpu_captioner_torch.cli import build_data
    from tpu_captioner_torch.core.config import ExperimentConfig, ModelConfig, TrainConfig
    from tpu_captioner_torch.train import loop
    from tpu_captioner_torch.train.model import CaptionModel

    tmp = tempfile.mkdtemp(prefix="smoke_backbone_")
    try:
        donor = CaptionModel(ModelConfig(vocab_size=VOCAB), device=dev, seed=seed + 41).encoder.state_dict()
        sd = {"features." + k[len("convnext."):]: v.cpu() for k, v in donor.items()}
        g = torch.Generator().manual_seed(seed + 42)
        sd.update({"classifier.0.weight": torch.ones(1024), "classifier.0.bias": torch.zeros(1024),
                   "classifier.2.weight": torch.randn(1000, 1024, generator=g), "classifier.2.bias": torch.zeros(1000)})
        pth, npz = os.path.join(tmp, "convnext_base.pth"), os.path.join(tmp, "convnext_base.npz")
        torch.save(sd, pth)
        t0 = time.perf_counter()
        build_data.main(["port-backbone", "--src", pth, "--out", npz])
        convert_s = time.perf_counter() - t0
        states = {}
        for label, path in (("pth", pth), ("npz", npz)):
            exp = ExperimentConfig(model=ModelConfig(pretrained_encoder=path), train=TrainConfig(
                batch_size=TRAIN_BS, checkpoint_dir=os.path.join(tmp, "ckpt"), results_dir=os.path.join(tmp, "res")))
            t0 = time.perf_counter()
            trainer = loop.Trainer(exp, ds, TRAIN_DATA_NAME, device=dev, verbose=False)
            states[label] = ({k: v.cpu() for k, v in trainer.model.encoder.state_dict().items()},
                             time.perf_counter() - t0)
            del trainer
            torch.cuda.empty_cache()
        same = all(torch.equal(v, states["npz"][0][k]) and torch.equal(v, donor[k].cpu())
                   for k, v in states["pth"][0].items())
        if not (same and set(states["pth"][0]) == set(donor)):
            raise AssertionError("phase 15d: the encoders from the .pth and the .npz differ")
        print(f"phase 15d: port-backbone {os.path.getsize(pth) / 2**20:.1f} MiB .pth -> "
              f"{os.path.getsize(npz) / 2**20:.1f} MiB .npz in {convert_s:.2f} s; Trainers from each hold the "
              f"same {len(donor)} encoder tensors, bit for bit (start-up {states['pth'][1]:.2f} s / "
              f"{states['npz'][1]:.2f} s, host clock) [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Phase 16: data parallelism on torch.distributed.  16a: the five paths of
# parallel/dryrun.py in a world of one over NCCL, against the same functions
# without a group (bit for bit: an all-reduce over one rank is the
# identity), and the steps' times in both.  16b: two ranks on the one card
# over gloo (NCCL refuses two ranks on one GPU) against one process on the
# same global batch, then a two-rank Trainer epoch on phase 10's records.
DP_WARM, DP_TIMED = 2, 5  # 16a: untimed calls, then timed ones (the median counts)
DP_STEPS = 3  # 16b: fine-tune steps on two ranks against one process
DP_BS = TRAIN_BS // 2  # 16b: rows per rank


def _median_ms(fn, warm=DP_WARM, timed=DP_TIMED):
    """Median host-clock ms of ``timed`` synchronised calls of ``fn``, after
    ``warm`` calls."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def dp_step_times(dev, model, mesh, batch, seed):
    """16a's readings on ``mesh`` (with or without a group): ms of a frozen
    step, a fine-tune step and an eval step at batch 32, the all-reduce of a
    fine-tune step's gradients alone, and each step's launches."""
    import torch

    from tpu_captioner_torch.core import prng
    from tpu_captioner_torch.core.config import TrainConfig
    from tpu_captioner_torch.parallel.collectives import all_reduce_gradients
    from tpu_captioner_torch.parallel.dryrun import rank_rows, word_ids
    from tpu_captioner_torch.train.state import TrainState
    from tpu_captioner_torch.train.steps import make_eval_step, make_train_step

    rows, ids, tc = rank_rows(batch, mesh, dev), word_ids(VOCAB), TrainConfig(batch_size=TRAIN_BS)
    state = TrainState.create(model, tc, mesh)
    root, calls = prng.root_seed(seed), itertools.count()
    ms, launches = {}, {}
    for name, step in (("frozen", make_train_step(model, tc, ids, mesh=mesh)),
                       ("fine_tune", make_train_step(model, tc, ids, train_encoder=True, mesh=mesh))):
        def run(step=step):
            step(state, rows, prng.step_seed(root, "dropout", 1, next(calls)))

        before = kernel_counts()
        run()
        torch.cuda.synchronize()
        launches[name] = count_delta(before, kernel_counts())
        ms[name] = _median_ms(run)
    params = [p for p in model.parameters() if p.grad is not None]  # the last fine-tune step's
    ms["all_reduce"] = _median_ms(lambda: all_reduce_gradients(params, mesh))
    evaluate = make_eval_step(model, tc, ids, mesh=mesh)
    before = kernel_counts()
    evaluate(rows)
    torch.cuda.synchronize()
    after = kernel_counts()
    launches["eval"] = (after["mlp_block"] - before["mlp_block"], after["decode_step"] - before["decode_step"])
    ms["eval"] = _median_ms(lambda: evaluate(rows))
    return ms, launches


def world_of_one_phase(dev, card, seed):
    """Phase 16a: ``parallel/dryrun.py``'s five paths (frozen, fine-tune and
    free-running steps, the eval step, beam 3) at full width (the flagship,
    batch 32, 256x256, 51 tokens) inside a world of one over NCCL
    (``single_rank_group``, backend ``cpu:gloo,cuda:nccl``), with every
    count zeroed before and read after (the data-parallel main path), then
    the same function without a group from the same seed: the values and
    every weight after the steps must be equal bit for bit.  cuDNN is held
    to its deterministic algorithms in both arms (a backward-filter
    algorithm may sum with atomics), so a difference is the collectives'.
    Then the steps' times with and without the group and the all-reduce's
    own time.  Returns the launches of the main path by kernel name."""
    import torch

    from tpu_captioner_torch.core.config import ModelConfig
    from tpu_captioner_torch.parallel.dryrun import PATHS, global_batch, report, run_paths
    from tpu_captioner_torch.parallel.mesh import Mesh, single_rank_group

    t16 = time.perf_counter()
    cfg = ModelConfig(vocab_size=VOCAB)
    args = (cfg, TRAIN_BS, 256, TRAIN_T - 1, seed)
    batch = global_batch(TRAIN_BS, 256, TRAIN_T, VOCAB, seed + 2)
    alone = Mesh(1, 0, dev)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with single_rank_group("cuda") as mesh:
            zero_kernel_counts()
            got, model = run_paths(mesh, *args)
            torch.cuda.synchronize()
            launches = kernel_counts()
            report(1, got)
            weights = {k: v.clone() for k, v in model.state_dict().items()}
            grouped_ms, step_launches = dp_step_times(dev, model, mesh, batch, seed + 3)
        del model
        torch.cuda.empty_cache()
        want, model = run_paths(alone, *args)
        differ = [p for p in PATHS if got[p] != want[p]]
        differ += [k for k, v in model.state_dict().items() if not torch.equal(v, weights[k])]
        if differ:
            del model
            again, model = run_paths(alone, *args)
            repeat = [p for p in PATHS if again[p] != want[p]]
            raise AssertionError(f"phase 16a: a world of one over NCCL and no group differ in {differ[:8]} "
                                 f"({len(differ)} values and tensors): with the group {got}, without {want}; "
                                 f"without twice, these differ: {repeat}")
        print(f"phase 16a: the five paths in a world of one over NCCL equal the same functions without a group "
              f"bit for bit: {len(PATHS)} values and {len(weights)} weight tensors after the steps")
        alone_ms, _ = dp_step_times(dev, model, alone, batch, seed + 3)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del model, weights
    torch.cuda.empty_cache()
    print(f"phase 16a: launches per step on the data-parallel path, (dropout_mask, mlp_block, mlp_block_bwd, dwconv, "
          f"dwconv_grad): frozen {step_launches['frozen']}, fine-tune {step_launches['fine_tune']}; eval step "
          f"(mlp_block, decode_step) {step_launches['eval']}")
    if step_launches["frozen"] != (1, 36, 0, 36, 0) or step_launches["fine_tune"] != (1, 36, 30, 65, 30):
        raise AssertionError(f"phase 16a: per-step launches {step_launches}, expected phase 5's and 6's")
    for name in ("frozen", "fine_tune", "eval"):
        print(f"phase 16a: {name} step at batch {TRAIN_BS}: {grouped_ms[name]:.2f} ms in a world of one over NCCL, "
              f"{alone_ms[name]:.2f} ms without a group (host clock, synchronised, median of {DP_TIMED} after "
              f"{DP_WARM}) [{card}]")
    print(f"phase 16a: all_reduce_gradients of a fine-tune step's gradients alone: {grouped_ms['all_reduce']:.3f} ms "
          f"over NCCL (world of one), {alone_ms['all_reduce']:.4f} ms without a group [{card}]")
    missing = [k for k in ("mlp_block", "mlp_block_bwd", "decode_step", "dropout_mask", "dwconv", "dwconv_grad")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"phase 16a: kernels of the data-parallel path never launched: {missing}")
    print(f"phase 16a launches over the five paths: {launches}; phase 16a took {time.perf_counter() - t16:.1f} s")
    return launches


def say(text):
    """``text`` and its newline in one write: the ranks share stdout."""
    print(text + "\n", end="", flush=True)


def one_process_bleu(ds, word_id):
    """BLEU-1..4 of the one-process corpus of a validation whose every
    hypothesis is ``max_decode_len`` x ``word_id`` (the EVAL_MARGIN
    rollouts): the VAL split in one process's order, batch 32."""
    import numpy as np

    from tpu_captioner_torch.data.dataset import CaptionDataset, iterate_batches
    from tpu_captioner_torch.data.vocab import load_word_map
    from tpu_captioner_torch.native.bleu_native import bleu_1_to_4
    from tpu_captioner_torch.train.loop import build_references_and_hypotheses

    wm = load_word_map(os.path.join(ds, f"WORDMAP_{TRAIN_DATA_NAME}.json"))
    refs, hyps = [], []
    for b in iterate_batches(CaptionDataset(ds, TRAIN_DATA_NAME, "VAL"), TRAIN_BS, shuffle=False):
        seqs = np.full((TRAIN_BS, TRAIN_T - 1), word_id, np.int32)
        r, h = build_references_and_hypotheses(b.all_captions, seqs, np.full(TRAIN_BS, TRAIN_T - 1), b.valid,
                                               wm["<start>"], wm["<pad>"])
        refs += r
        hyps += h
    return bleu_1_to_4(refs, hyps)


def two_rank_rank(mesh, card, seed, ds, out_dir):
    """Phase 16b on one of two ranks, both on the one card over gloo: (a)
    three fine-tune steps at batch 16 a rank (dropout pool and stochastic
    depth on), the ranks' weights equal bit for bit after each, held on
    rank 0 against one process at batch 32 on the same global batch; (b) a
    two-rank Trainer epoch on phase 10's records, then a resume."""
    import torch

    from tpu_captioner_torch.core import prng
    from tpu_captioner_torch.core.config import ExperimentConfig, ModelConfig, TrainConfig
    from tpu_captioner_torch.data.vocab import load_word_map
    from tpu_captioner_torch.parallel.collectives import barrier
    from tpu_captioner_torch.parallel.dryrun import rank_rows, replicas_agree
    from tpu_captioner_torch.train import loop
    from tpu_captioner_torch.train.model import CaptionModel
    from tpu_captioner_torch.train.state import TrainState
    from tpu_captioner_torch.train.steps import make_train_step

    dev, rank = mesh.device, mesh.rank
    label = f"phase 16b rank {rank}"
    word_map = word_map_of(VOCAB)
    cfg = ModelConfig(vocab_size=VOCAB)
    root = prng.root_seed(seed + 41)
    seeds = [prng.step_seed(root, "dropout", 0, i) for i in range(DP_STEPS)]
    batch = train_batch(torch.Generator().manual_seed(seed + 42), word_map, VOCAB)

    def model():
        m = CaptionModel(cfg, device=dev, seed=seed + 40)
        gen = torch.Generator().manual_seed(seed + 43)
        with torch.no_grad():  # order-one layer scales, as in phase 6
            for blk in (b for b in m.modules() if hasattr(b, "layer_scale")):
                blk.layer_scale.copy_(0.1 * torch.rand(blk.layer_scale.shape, generator=gen))
        return m

    def steps(m, rows, bs, on):
        tc = TrainConfig(batch_size=bs)
        state = TrainState.create(m, tc, on)
        step = make_train_step(m, tc, word_map, train_encoder=True, mesh=on)
        metrics, grads, ms = [], [], []
        for i, s in enumerate(seeds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, rows, s)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in met.items()})
            grads.append({n: p.grad.clone() for n, p in m.named_parameters() if p.grad is not None})
            if on is not None and not replicas_agree(m.state_dict().values(), on):
                raise AssertionError(f"{label}: the ranks' weights differ after step {i}")
        return metrics, grads, {k: v.clone() for k, v in m.state_dict().items()}, ms, tc.decoder_lr

    # (a) Three fine-tune steps.
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    got, got_grads, got_params, ms, lr = steps(model(), rank_rows(batch, mesh, dev), DP_BS, mesh)
    launches = count_delta({k: 0 for k in kernel_counts()}, kernel_counts())
    say(f"{label}: {DP_STEPS} fine-tune steps at batch {DP_BS} a rank, global batch {TRAIN_BS}: ms per step "
          f"{[round(x, 2) for x in ms]} (host clock, synchronised; the two ranks share the card); launches "
          f"(dropout_mask, mlp_block, mlp_block_bwd, dwconv, dwconv_grad) {launches}; the ranks' weights equal "
          f"bit for bit after every step; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]",)
    if launches != tuple(DP_STEPS * n for n in (1, 36, 30, 65, 30)):
        raise AssertionError(f"{label}: launches {launches}, expected phase 6's per step")
    if rank == 0:
        want, want_grads, want_params, _, _ = steps(model(), {k: v.to(dev) for k, v in batch.items()}, TRAIN_BS,
                                                    None)
        loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(got, want))
        counts_equal = all(a["tokens"] == b["tokens"] and a["top5_correct"] == b["top5_correct"]
                           for a, b in zip(got, want))
        grad_err, worst = 0.0, ""
        for g, wg in zip(got_grads, want_grads):
            for k, w in wg.items():
                err = (g[k] - w).abs().max().item() / max(1.0, w.abs().max().item())
                grad_err, worst = max((grad_err, worst), (err, k))
        # Adam's step is scale-free: a gradient that differs by a fraction f
        # between the runs moves its parameter by at most ~f x lr a step, and
        # one near the two runs' summation noise up to 2 x lr.  The
        # parameters are compared where every step's two gradients agree
        # within 1/300 of the element's own (three steps: 1e-2 x lr), and
        # those elements must be at least a quarter of the trained ones.
        param_err, checked, total = 0.0, 0, 0
        for k in want_grads[0]:
            sure = torch.stack([(g[k] - wg[k]).abs() * 300 <= wg[k].abs()
                                for g, wg in zip(got_grads, want_grads)]).all(0)
            err = (got_params[k] - want_params[k]).abs()[sure]
            param_err = max(param_err, err.max().item() if err.numel() else 0.0)
            checked, total = checked + int(sure.sum()), total + sure.numel()
        say(f"{label}: two ranks against one process at batch {TRAIN_BS}, {DP_STEPS} steps: losses "
              f"{[a['loss'] for a in got]} vs {[b['loss'] for b in want]}, worst relative {loss_err:.3e} (tol 1e-5); "
              f"tokens and top-5 equal: {counts_equal}; gradients worst |d| / max(1, max |g|) {grad_err:.3e} "
              f"(tol 1e-3; {worst}) over {len(want_grads[0])} tensors; parameters max |d| {param_err:.3e} (tol "
              f"{1e-2 * lr:g}) over {checked} of {total} trained elements ({checked / total:.1%})")
        if not (loss_err <= 1e-5 and counts_equal and grad_err <= 1e-3 and param_err <= 1e-2 * lr
                and set(got_grads[0]) == set(want_grads[0]) and checked > total // 4):
            raise AssertionError(f"{label}: two ranks and one process disagree")
        del want_grads, want_params
    del got_grads, got_params
    torch.cuda.empty_cache()
    say(f"{label}: 16b(a) took {time.perf_counter() - t0:.1f} s")

    # (b) A two-rank Trainer epoch on phase 10's records, then a resume.
    t0 = time.perf_counter()
    ds_words = load_word_map(os.path.join(ds, f"WORDMAP_{TRAIN_DATA_NAME}.json"))

    def experiment(**kw):
        return ExperimentConfig(model=ModelConfig(), train=TrainConfig(
            batch_size=DP_BS, epochs=1, teacher_forcing=True, print_freq=1000,
            checkpoint_dir=os.path.join(out_dir, "ckpt"), results_dir=os.path.join(out_dir, "results"), **kw))

    record = {"train": [], "eval": []}
    with counted_trainer_steps(record, ds_words[EVAL_WORD]):
        trainer = loop.Trainer(experiment(), ds, TRAIN_DATA_NAME, device=dev, verbose=False, mesh=mesh)
        (row,) = trainer.run()
    torch.cuda.synchronize()
    check_counts(f"{label} Trainer (TF, frozen)", record, {"TF, frozen": (1, 36, 0, 36, 0)},
                 trainer.exp.model.num_layers, trainer.exp.train.max_decode_len)
    n_train, n_val = 5 * TRAIN_DATA["TRAIN"] // TRAIN_BS, 5 * TRAIN_DATA["VAL"] // TRAIN_BS
    if (len(record["train"]), len(record["eval"]), len(trainer.train_loader)) != (n_train, n_val, n_train):
        raise AssertionError(f"{label}: {len(record['train'])} train and {len(record['eval'])} eval steps")
    name = trainer.checkpoint_name()
    if rank == 0:
        want_bleu = one_process_bleu(ds, ds_words[EVAL_WORD])
        got_bleu = tuple(row[f"bleu{i}"] for i in range(1, 5))
        (csv_name,) = os.listdir(os.path.join(out_dir, "results"))
        with open(os.path.join(out_dir, "results", csv_name)) as f:
            csv_rows = f.read().splitlines()
        tree = {d: sorted(os.listdir(os.path.join(out_dir, "ckpt", d))) for d in os.listdir(os.path.join(out_dir,
                                                                                                         "ckpt"))}
        say(f"{label} Trainer: row {row}; BLEU-1..4 {got_bleu} against the one-process corpus' {want_bleu}; "
              f"CSV {csv_name} ({len(csv_rows) - 1} row); checkpoints {tree}; batch_time "
              f"{row['trainBatchTime'] * 1e3:.2f} ms, data_time {row['trainDataTime'] * 1e3:.3f} ms per batch "
              f"(rank 0's host clock) [{card}]")
        if not (got_bleu == tuple(want_bleu) and want_bleu[0] > 0 and len(csv_rows) == 2
                and set(tree) <= {name, f"BEST_{name}"} and name in tree
                and all(v == ["meta.json", "state.pt"] for v in tree.values())
                and all(math.isfinite(row[k]) for k in ("trainLoss", "valLoss"))):
            raise AssertionError(f"{label}: the two-rank Trainer's row, CSV or checkpoints are wrong")
    barrier(mesh)
    resumed = loop.Trainer(experiment(checkpoint=os.path.join(out_dir, "ckpt", name)), ds, TRAIN_DATA_NAME,
                           device=dev, verbose=False, mesh=mesh)
    kept = trainer.model.state_dict()
    same = all(torch.equal(v, kept[k]) for k, v in resumed.model.state_dict().items())
    if not (resumed.start_epoch == 1 and same and replicas_agree(resumed.model.state_dict().values(), mesh)):
        raise AssertionError(f"{label}: the resume did not load the epoch-0 checkpoint")
    say(f"{label}: resumed at epoch {resumed.start_epoch} with the saved weights, the ranks equal; 16b(b) took "
          f"{time.perf_counter() - t0:.1f} s; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"[{card}]")


def two_ranks_phase(card, seed, ds):
    """Phase 16b: ``two_rank_rank`` on two processes, both on cuda:0, over
    gloo; the kernels are built (phase 2) before they start."""
    from tpu_captioner_torch.parallel.mesh import spawn

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="smoke_ranks_") as out_dir:
        spawn(two_rank_rank, 2, "cuda:0", backend="gloo", args=(card, seed, ds, out_dir))
    print(f"phase 16b took {time.perf_counter() - t0:.1f} s")


# Phase 17: the MLP tail's precise=False arm (bf16 products: each product's
# operands rounded to bf16, the exact products summed in f32), the TPU
# kernels with mxu_dtype=bfloat16, against its plain versions.  Kernel and
# plain version compute LayerNorm's statistics and the f32 sums in other
# orders, so an operand an f32 ulp apart now and then rounds to the
# neighbouring bf16 value and moves its row's outputs by up to an operand
# ulp times a weight column (PERF.md section 6).  So, over the rows with sd !=
# 0, the forward on f32 data is held in mean to BF16P_MEAN_TOL times the
# mean magnitude of the MLP branch (|plain - residual|) and at its largest
# to BF16P_MAX_TOL x max(1, max |plain|); on bf16 data every element within
# one bf16 ulp of the plain value; rows with sd 0 the residual bit for bit.
# Each output must lie more than BF16P_SEPARATION x BF16P_MEAN_TOL (the same
# measure) from the precise=True kernel's output on the same inputs.  The
# backward's nine outputs within BF16P_BWD_TOL x max(1, max |plain|) at their
# largest (a bf16 d_x one ulp apart is up to 2^-7 of the largest value) and
# BF16P_BWD_MEAN_TOL of that in mean (bf16 d_x aside: its own rounding is
# 2^-9 relative).  tests/test_torch_kernels_gpu.py holds the
# same rules.
BF16P_MEAN_TOL, BF16P_MAX_TOL, BF16P_SEPARATION = 5e-5, 1e-2, 10
BF16P_BWD_TOL, BF16P_BWD_MEAN_TOL = 1e-2, 5e-5
BF16P_FORWARD = {  # kernels-line name: (TPU_CAPTIONER_MLP_SUB, bf16 data)
    "mlp_block_bf16_products": (None, False), "mlp_block_bf16_products_bf16": (None, True),
    "mlp_block_pipelined_bf16_products": (PIPE_SUB, False),
    "mlp_block_pipelined_bf16_products_bf16": (PIPE_SUB, True),
}
BF16P_BACKWARD = {"mlp_block_bwd_bf16_products": False, "mlp_block_bwd_bf16_products_bf16": True}


def bf16_products_counts():
    """The arm's launches by the name of its kernels-line entry."""
    from tpu_captioner_torch.ops.mlp_block import fused_convnext_mlp as f, fused_convnext_mlp_bwd as b

    whole_bf16 = f.bf16_product_bf16_launches - f.pipelined_bf16_product_bf16_launches
    return {
        "mlp_block_bf16_products": f.bf16_product_launches - f.pipelined_bf16_product_launches - whole_bf16,
        "mlp_block_bf16_products_bf16": whole_bf16,
        "mlp_block_pipelined_bf16_products": f.pipelined_bf16_product_launches - f.pipelined_bf16_product_bf16_launches,
        "mlp_block_pipelined_bf16_products_bf16": f.pipelined_bf16_product_bf16_launches,
        "mlp_block_bwd_bf16_products": b.bf16_product_launches - b.bf16_product_bf16_launches,
        "mlp_block_bwd_bf16_products_bf16": b.bf16_product_bf16_launches,
    }


def zero_bf16_products_counts():
    from tpu_captioner_torch.ops.mlp_block import fused_convnext_mlp as f, fused_convnext_mlp_bwd as b

    f.bf16_product_launches = f.pipelined_bf16_product_launches = 0
    f.bf16_product_bf16_launches = f.pipelined_bf16_product_bf16_launches = 0
    b.bf16_product_launches = b.bf16_product_bf16_launches = 0


def bf16_products_forward(dev, card):
    """Phase 17a: the arm's four forward instances (the whole tile and the
    sub-tiled kernel, f32 and bf16 data) against ``_mlp_plain_bf16_products``
    at the four ConvNeXt-Base stage shapes at batch 8 and 32, with each
    stage's per-image scales (0 or 1/survival at its last block's ramped
    rate, as ``check_mlp`` draws them), by the rules above; each call's
    launch counted on its instance's counter alone.  Device times by
    CUDA-graph replay per launch at batch 32, summed over a bs-32 encoder
    pass (36 launches), beside the plain version and the precise=True
    instance on the same inputs.  Returns {name: (worst abs error, ms,
    plain ms, None, bound ms, bound by)}."""
    import torch

    from tpu_captioner_torch.models.convnext import BASE_DEPTHS, BASE_DIMS, sd_probs
    from tpu_captioner_torch.ops.mlp_block import _mlp_plain_bf16_products, fused_convnext_mlp

    probs = sd_probs(BASE_DEPTHS)
    acc = {k: [0.0, 0.0, 0.0, 0.0, 0, 0] for k in BF16P_FORWARD}  # err, ms, plain, precise, bytes, ops
    plain_ms = {}
    for s, (depth, c) in enumerate(zip(BASE_DEPTHS, BASE_DIMS)):
        g = torch.Generator().manual_seed(1700 + c)
        params = _stage_params(c, g, dev)
        survival = 1.0 - probs[sum(BASE_DEPTHS[: s + 1]) - 1]  # the stage's last block
        for batch in (8, TRAIN_BS):
            n = batch * (64 >> s) ** 2
            keep = torch.rand(batch, generator=g) < survival
            keep[0], keep[1] = False, True  # one image dropped, one kept
            sd = (keep / survival).repeat_interleave(n // batch).to(dev)
            x, res = torch.randn(n, c, generator=g).to(dev), torch.randn(n, c, generator=g).to(dev)
            kept = sd != 0
            for name, (sub, bf16) in BF16P_FORWARD.items():
                dt = torch.bfloat16 if bf16 else torch.float32
                ln_w, ln_b, w1, b1, w2, b2, gamma = params
                args = (x.to(dt), res.to(dt), sd, ln_w, ln_b, w1.to(dt), b1, w2.to(dt), b2, gamma)
                want = _mlp_plain_bf16_products(*args)
                with mlp_sub(sub):
                    before = bf16_products_counts()
                    got = fused_convnext_mlp(*args, precise=False)
                    torch.cuda.synchronize()
                    delta = {k: v - before[k] for k, v in bf16_products_counts().items()}
                    precise = fused_convnext_mlp(*args)
                if delta != {k: int(k == name) for k in delta}:
                    raise AssertionError(f"phase 17a {name} at C={c}, N={n}: launches {delta}")
                g32, w32, r32 = got[kept].float(), want[kept].float(), args[1][kept].float()
                branch = (w32 - r32).abs().mean().item()
                diff = (g32 - w32).abs()
                err, mean_rel = diff.max().item(), diff.mean().item() / branch
                apart = (g32 - precise[kept].float()).abs().mean().item() / branch
                if bf16:
                    ok = bf16_ulp_err(got, want)[1] <= 1.0
                else:
                    ok = mean_rel <= BF16P_MEAN_TOL and err <= BF16P_MAX_TOL * max(1.0, w32.abs().max().item())
                if not (ok and got.dtype == dt and torch.isfinite(got).all()
                        and torch.equal(got[~kept], args[1][~kept]) and apart > BF16P_SEPARATION * BF16P_MEAN_TOL):
                    raise AssertionError(
                        f"phase 17a {name} at C={c}, N={n}: max abs err {err:.3e}, mean / branch {mean_rel:.3e} "
                        f"(tol {BF16P_MEAN_TOL:g}), {bf16_ulp_err(got, want)[1] if bf16 else 0:.2f} ulp, apart from "
                        f"precise=True by {apart:.3e} (must exceed {BF16P_SEPARATION * BF16P_MEAN_TOL:g})")
                line = (f"phase 17a {name} batch {batch} C={c} N={n}: max abs err {err:.3e}, mean err / branch "
                        f"{mean_rel:.3e}, precise=True apart by {apart:.3e} of the branch")
                a = acc[name]
                a[0] = max(a[0], err)
                if batch == TRAIN_BS:
                    with mlp_sub(sub):
                        t_kernel = _graph_ms(lambda: fused_convnext_mlp(*args, precise=False), iters=10)
                        t_precise = _graph_ms(lambda: fused_convnext_mlp(*args), iters=10)
                    if (c, bf16) not in plain_ms:
                        plain_ms[c, bf16] = _graph_ms(lambda: _mlp_plain_bf16_products(*args), iters=3, warmup=1)
                    t_plain = plain_ms[c, bf16]
                    esize = 2 if bf16 else 4
                    for i, t in enumerate((t_kernel, t_plain, t_precise)):
                        a[1 + i] += depth * t
                    # x, residual and out, the matrices in the data's dtype;
                    # sd and the vectors f32; two N x C x 4C products.
                    a[4] += depth * (esize * (3 * n * c + 8 * c * c) + 4 * (n + 8 * c))
                    a[5] += depth * 16 * n * c * c
                    line += f"; kernel {t_kernel:.4f} ms, plain {t_plain:.4f}, precise=True {t_precise:.4f} per launch"
                print(line + f" [{card}]")
    out = {}
    for name, (err, ms, plain, precise_ms, n_bytes, n_ops) in acc.items():
        bound_ms, bound_by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
        print(f"phase 17a {name} per bs-{TRAIN_BS} encoder pass (36 launches): kernel {ms:.4f} ms, plain {plain:.4f} "
              f"ms, precise=True instance {precise_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
              f"{bound_ms / ms:.1%} of it) [{card}]")
        out[name] = (err, ms, plain, None, bound_ms, bound_by)
    return out


def bf16_products_backward(dev, card):
    """Phase 17b: the arm's two backward instances (f32 and bf16 data)
    against ``_mlp_bwd_plain_bf16_products`` at the fine-tune step's two
    trainable stages at batch 32 (sd rows of 0 and 1/survival) and at a
    ragged N = 600, C = 128 (per-row sd), by the rules above; d_x zero on
    rows with sd 0, the same bits twice.  Times by CUDA-graph replay per
    fine-tune step (27 + 3 launches) beside the plain version and the
    precise=True instance.  Returns {name: (worst abs error, ms, plain ms,
    None, bound ms, bound by)}."""
    import torch

    from tpu_captioner_torch.models.convnext import BASE_DEPTHS, BASE_DIMS, sd_probs
    from tpu_captioner_torch.ops.mlp_block import _mlp_bwd_plain_bf16_products, fused_convnext_mlp_bwd

    probs = sd_probs(BASE_DEPTHS)
    out = {}
    for name, bf16 in BF16P_BACKWARD.items():
        dt = torch.bfloat16 if bf16 else torch.float32
        worst, ms, plain_ms, precise_ms, n_bytes, n_ops = 0.0, 0.0, 0.0, 0.0, 0, 0
        for s, n in ((2, TRAIN_BS * 16 * 16), (3, TRAIN_BS * 8 * 8), (0, 600)):
            c = BASE_DIMS[s]
            g = torch.Generator().manual_seed(1701 + c)
            ln_w, ln_b, w1, b1, w2, b2, gamma = _stage_params(c, g, dev)
            survival = 1.0 - probs[sum(BASE_DEPTHS[: s + 1]) - 1]
            units = TRAIN_BS if n % TRAIN_BS == 0 else n
            keep = torch.rand(units, generator=g) < survival
            keep[0], keep[1] = False, True
            sd = (keep / survival).repeat_interleave(n // units).to(dev)
            args = (torch.randn(n, c, generator=g).to(dev, dt), torch.randn(n, c, generator=g).to(dev, dt), sd,
                    ln_w, ln_b, w1.to(dt), b1, w2.to(dt), b2, gamma)
            before = bf16_products_counts()
            got = fused_convnext_mlp_bwd(*args, precise=False)
            again = fused_convnext_mlp_bwd(*args, precise=False)
            torch.cuda.synchronize()
            delta = {k: v - before[k] for k, v in bf16_products_counts().items()}
            if delta != {k: 2 * int(k == name) for k in delta}:
                raise AssertionError(f"phase 17b {name} at C={c}, N={n}: launches {delta}")
            want = _mlp_bwd_plain_bf16_products(*args)
            errs, rels = [], []
            for i, (a, b) in enumerate(zip(got, want)):
                diff, scale = (a.float() - b.float()).abs(), max(1.0, b.abs().max().item())
                errs.append(diff.max().item())
                rels.append(diff.max().item() / scale)
                mean_ok = (i == 0 and bf16) or diff.mean().item() <= BF16P_BWD_MEAN_TOL * scale
                if not (a.dtype == b.dtype and torch.isfinite(a).all() and rels[-1] <= BF16P_BWD_TOL and mean_ok):
                    raise AssertionError(f"phase 17b {name} output {i} at C={c}, N={n}: max err / max(1, max |plain|) "
                                         f"{rels[-1]:.3e}, mean {diff.mean().item() / scale:.3e}")
            if not (torch.equal(got[0][sd == 0], torch.zeros_like(got[0][sd == 0]))
                    and all(torch.equal(a, b) for a, b in zip(got, again))):
                raise AssertionError(f"phase 17b {name} at C={c}, N={n}: d_x nonzero on sd-0 rows, or two calls differ")
            worst = max(worst, *errs)
            line = (f"phase 17b {name} C={c} N={n}: max abs err {max(errs):.3e}, max err / max(1, max |plain|) "
                    f"{max(rels):.3e} (tol {BF16P_BWD_TOL:g}; by output " + " ".join(f"{r:.1e}" for r in rels) + ")")
            if n % TRAIN_BS == 0:  # a fine-tune stage: depth launches per step
                depth = BASE_DEPTHS[s]
                t = (_graph_ms(lambda: fused_convnext_mlp_bwd(*args, precise=False), iters=5),
                     _graph_ms(lambda: _mlp_bwd_plain_bf16_products(*args), iters=3, warmup=1),
                     _graph_ms(lambda: fused_convnext_mlp_bwd(*args), iters=5))
                ms, plain_ms, precise_ms = ms + depth * t[0], plain_ms + depth * t[1], precise_ms + depth * t[2]
                esize = 2 if bf16 else 4
                # g, x and d_x, the matrices in the data's dtype; sd, d_sd,
                # the vectors and the gradients of all seven parameters f32;
                # 48 N C^2 flops (csrc/mlp_block_bwd.cu).
                n_bytes += depth * (esize * (3 * n * c + 8 * c * c) + 4 * (2 * n + 8 * c * c + 16 * c))
                n_ops += depth * 48 * n * c * c
                line += f"; kernel {t[0]:.4f} ms, plain {t[1]:.4f}, precise=True {t[2]:.4f} per launch"
            print(line + f" [{card}]")
        bound_ms, bound_by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
        print(f"phase 17b {name} per fine-tune step (27 + 3 launches): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"precise=True instance {precise_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
              f"{bound_ms / ms:.1%} of it) [{card}]")
        out[name] = (worst, ms, plain_ms, None, bound_ms, bound_by)
    return out


def bf16_products_phase(dev, card):
    """Phase 17: 17a and 17b; {name: (worst abs error, ms, plain ms, None,
    bound ms, bound by)} of the six instances."""
    t17 = time.perf_counter()
    out = {**bf16_products_forward(dev, card), **bf16_products_backward(dev, card)}
    print(f"phase 17 took {time.perf_counter() - t17:.1f} s")
    return out


def np_isfinite(a):
    import numpy as np

    return bool(np.isfinite(a).all())



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
    print("host packages: " + ", ".join(
        f"{m} {'present' if importlib.util.find_spec(m) else 'missing'}" for m in PACKAGES))
    pin_f32_precision()

    # 2. Build the kernels, one nvcc each, all at once.
    names = ("mlp_block", "mlp_block_bwd", "decode_step", "dropout_mask", "dwconv", "lstm_step", "block_fused")
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
    # The per-layer kernel at the bs-8 and bs-32 beams' rows, the one-cell
    # kernel at the greedy eval's.
    barrier_probe(card)
    dec_err, dec_ms, dec_plain_ms, dec_bound, dec_by = check_decode(
        dev, card, model.decoder.layers, DECODE_ROWS)["decode_step"]
    r160 = check_decode(dev, card, model.decoder.layers, BEAM * TRAIN_BS)["decode_step"]
    print(f"decode_step at R={BEAM * TRAIN_BS} (bs-32 beam): {r160[1]:.4f} ms per 6-layer step, plain "
          f"{r160[2]:.4f}, bound {r160[3]:.4f} ({r160[4]}); at R={DECODE_ROWS}: {dec_ms:.4f} ms [{card}]")
    dec_err = max(dec_err, r160[0])
    one_err, one_ms, one_plain_ms, one_bound, one_by = check_decode(
        dev, card, model.decoder.layers, TRAIN_BS)["decode_onecell"]
    pool_err, pool_ms, pool_plain_ms, pool_lib_ms, pool_bound, pool_by = check_dropout(dev, card)
    bwd_err, bwd_ms, bwd_plain_ms, bwd_bound, bwd_by = check_mlp_bwd(dev, card)
    dw = check_dwconv(dev, card)
    lstm_err, lstm_ms, lstm_plain_ms, lstm_bound_ms, lstm_by = check_lstm(dev, card)
    block_err, block_ms, block_plain_ms, block_bound, block_by = check_block(dev, card)
    pipe_err, pipe_ms, pipe_plain_ms, pipe_bound, pipe_by = check_mlp_pipelined(dev, card)
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
    zero_bf16_products_counts()
    got = caption_batch(served, images8.numpy(), word_map, BEAM)
    torch.cuda.synchronize()
    mlp_launches, dec_launches = fused_convnext_mlp.launches, fused_decode_step.launches
    bf16p_launches = bf16_products_counts()  # the precise=False arm: no model path reaches it
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
    serve_times(card, "serve", {"kernels": served, "plain": plain}, rng, dev, word_map)

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

    # 8. The LSTM families at full width: serving, eval step, train step, A/B.
    torch.cuda.empty_cache()
    t8 = time.perf_counter()
    lstm_model, lstm_launches = lstm_serve(dev, card, args.seed, word_map, images8, rng)
    eval_batch = lstm_eval(dev, card, args.seed, lstm_model, word_map)
    lstm_favoured = lstm_ab(card, lstm_model, images8.to(dev), eval_batch, word_map)
    del lstm_model, eval_batch
    torch.cuda.empty_cache()
    lstm_pool = TRAIN_BS * (TRAIN_T - 1) * ModelConfig().decoder_dim
    train_phase(dev, card, args.seed + 16, word_map, ModelConfig(decoder="lstm", vocab_size=VOCAB), lstm_pool)
    print("lstm decode-kernel A/B (kernel favoured: median gain > spread of the pairs): " + ", ".join(
        f"{k}: {v}" for k, v in lstm_favoured.items()) + f"; 'auto' may take the kernel for lstm: "
          f"{all(lstm_favoured.values())}; phase 8 took {time.perf_counter() - t8:.1f} s")

    # 9. use_pallas='block' (and the sub-tiled MLP tail) on the flagship.
    torch.cuda.empty_cache()
    t9 = time.perf_counter()
    block_model, default_model, block_launches, pipe_launches = block_serve(
        dev, card, args.seed, word_map, images8, rng)
    block_eval(dev, card, args.seed, block_model, word_map)
    block_ab(card, block_model, default_model, rng, dev)
    del block_model, default_model
    torch.cuda.empty_cache()
    block_train(dev, card, args.seed, word_map)
    print(f"phase 9 took {time.perf_counter() - t9:.1f} s")

    # 10. The training entry point: data, cli.train, the Trainer, cli.test.
    # Its records and BEST_ checkpoint stay for phase 15 (removed at exit if
    # a phase between fails).
    torch.cuda.empty_cache()
    keep = tempfile.TemporaryDirectory(prefix="smoke_keep_")
    training = training_phase(dev, card, args.seed, keep=keep.name)

    # 11. compute_dtype='bfloat16' serving: the bf16 instances, the CLI's
    # loader and beam, the eval step.
    torch.cuda.empty_cache()
    bf16 = check_bf16_kernels(dev, card, flagship_model(cfg, dev, args.seed).decoder.layers)
    bf16_launches = bf16_phase(dev, card, args.seed, word_map, images8, rng)

    # 12. compute_dtype='bfloat16' training: the backward instances, the
    # full-width steps against all-plain and f32, the entry point.
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    bf16_train = check_bf16_train_kernels(dev, card)
    ft_bf16 = bf16_train_phase(dev, card, args.seed, word_map)
    torch.cuda.empty_cache()
    bf16_training = bf16_entry_phase(dev, card, args.seed)
    print(f"phase 12 took {time.perf_counter() - t12:.1f} s")

    # 13. bf16 in the decoders: the three new bf16 instances, the bf16 LSTM
    # families' serving, the bf16 eval modes, the bf16 LSTM training.
    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    dec_bf16 = {"lstm_step_bf16": check_bf16_lstm(dev, card),
                **check_bf16_decode_modes(dev, card, flagship_model(cfg, dev, args.seed), word_map)}
    torch.cuda.empty_cache()
    dec_bf16_launches = {"lstm_step_bf16": bf16_lstm_serve(dev, card, args.seed, word_map, images8, rng)}
    modes = bf16_eval_modes(dev, card, args.seed, word_map)
    dec_bf16_launches["decode_onecell_bf16"] = modes["one_cell"][1]
    dec_bf16_launches["decode_rollout_bf16"] = modes["mega"][2]
    torch.cuda.empty_cache()
    dec_bf16_training = bf16_lstm_train(dev, card, args.seed, word_map)
    print(f"phase 13 took {time.perf_counter() - t13:.1f} s")

    # 14. The last bf16 instances: the whole block and the sub-tiled MLP
    # tail, alone, through serving and the eval step, the train steps, the
    # sub-tiled bf16 pass and a per-stage mix.
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    last_bf16 = check_bf16_block_kernels(dev, card)
    block_bf16_launches = bf16_block_serve(dev, card, args.seed, word_map, images8, rng)
    torch.cuda.empty_cache()
    block_bf16_training, pipe_bf16_launches, pipe_bf16_training = bf16_block_train(dev, card, args.seed, word_map,
                                                                                     rng)
    print(f"phase 14 took {time.perf_counter() - t14:.1f} s")

    # 15. The rest of a one-card user's surfaces: the native host runtime,
    # the one-image beam (R = 5) and cli.caption --out, the Trainer's trace
    # window, the .npz backbone.
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    ds = os.path.join(keep.name, "ds")
    native_phase(card, ds)
    one_image_phase(dev, card, args.seed, word_map, keep.name, os.path.join(keep.name, "best"))
    torch.cuda.empty_cache()
    trace_phase(dev, card, ds)
    torch.cuda.empty_cache()
    backbone_phase(dev, card, args.seed, ds)
    print(f"phase 15 took {time.perf_counter() - t15:.1f} s")

    # 16. Data parallelism: the five paths in a world of one over NCCL at
    # full width, then two ranks on the one card over gloo, on phase 10's
    # records.
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    dp_launches = world_of_one_phase(dev, card, args.seed)
    torch.cuda.empty_cache()
    two_ranks_phase(card, args.seed, ds)
    keep.cleanup()
    print(f"phase 16 took {time.perf_counter() - t16:.1f} s")

    # 17. The MLP tail's precise=False arm (bf16 products): the six
    # instances against their plain versions and the precise=True ones.
    torch.cuda.empty_cache()
    bf16p = bf16_products_phase(dev, card)

    # mlp_block's launches: one serving encoder pass; the train and eval
    # paths' 36 per step were checked in phases 5 to 7.  dropout_mask's: one
    # per train step.  mlp_block_bwd's, dwconv's and dwconv_grad's: one
    # fine-tune step.  decode_onecell's and decode_rollout's: one eval step in
    # their modes, natural <end>.  lstm_step's: one lstm beam over 8 images.
    # block_fused's and the sub-tiled mlp_block's: one phase 9 serving
    # encoder pass; their times per bs-32 encoder pass.  launches_training:
    # phase 10's main path, cli.train's free-running epoch and the Trainer's
    # two teacher-forced epochs (the unlock at epoch 1), with validation.
    kernels = [
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
        {"name": "lstm_step", "route": "cuda", "source": "tpu_captioner_torch/csrc/lstm_step.cu",
         "replaces": "tpu_captioner/ops/lstm_step.py:81", "launches": lstm_launches,
         "max_abs_err": lstm_err, "ms": lstm_ms, "plain_ms": lstm_plain_ms,
         "bound_ms": lstm_bound_ms, "bound_by": lstm_by, "library_ms": None},
        {"name": "block_fused", "route": "cuda", "source": "tpu_captioner_torch/csrc/block_fused.cu",
         "replaces": "tpu_captioner/ops/block_fused.py:53", "launches": block_launches,
         "max_abs_err": block_err, "ms": block_ms, "plain_ms": block_plain_ms,
         "bound_ms": block_bound, "bound_by": block_by, "library_ms": None},
        {"name": "mlp_block_pipelined", "route": "cuda", "source": "tpu_captioner_torch/csrc/mlp_block.cu",
         "replaces": "tpu_captioner/ops/mlp_block.py:145", "launches": pipe_launches,
         "max_abs_err": pipe_err, "ms": pipe_ms, "plain_ms": pipe_plain_ms,
         "bound_ms": pipe_bound, "bound_by": pipe_by, "library_ms": None},
        # The bf16 instances (phase 11): launches on the bs-8 bf16 serving
        # run; times per bs-32 encoder pass (dwconv, mlp_block) and per
        # 6-layer step at R = 40 (decode_step).
        *({"name": name, "route": "cuda", "source": f"tpu_captioner_torch/csrc/{source}", "replaces": replaces,
           "launches": bf16_launches[name], "max_abs_err": bf16[name][0], "ms": bf16[name][1],
           "plain_ms": bf16[name][2], "bound_ms": bf16[name][4], "bound_by": bf16[name][5],
           "library_ms": bf16[name][3]}
          for name, source, replaces in (
              ("mlp_block_bf16", "mlp_block.cu", "tpu_captioner/ops/mlp_block.py:126"),
              ("dwconv_bf16", "dwconv.cu", "tpu_captioner/ops/dwconv.py:37"),
              ("decode_step_bf16", "decode_step.cu", "tpu_captioner/ops/decode_step.py:185"))),
        # The bf16 backward instances (phase 12): launches per bf16 fine-tune
        # step (12b), times per step (12a).
        *({"name": name, "route": "cuda", "source": f"tpu_captioner_torch/csrc/{source}", "replaces": replaces,
           "launches": launches, "max_abs_err": bf16_train[name][0], "ms": bf16_train[name][1],
           "plain_ms": bf16_train[name][2], "bound_ms": bf16_train[name][4], "bound_by": bf16_train[name][5],
           "library_ms": bf16_train[name][3]}
          for name, source, replaces, launches in (
              ("mlp_block_bwd_bf16", "mlp_block_bwd.cu", "tpu_captioner/ops/mlp_block.py:275", ft_bf16[2]),
              ("dwconv_grad_bf16", "dwconv.cu", "tpu_captioner/ops/dwconv.py:97", ft_bf16[4]))),
        # The bf16 decoder instances (phase 13): launches of the bf16 lstm
        # beam over 8 images (13b) and of one bf16 eval step in the one-cell
        # and 'mega' modes (13c); times at R = 40 (lstm_step), per 6-layer
        # step at R = 32 (one-cell) and per rollout at R = 32 (13a).
        *({"name": name, "route": "cuda", "source": f"tpu_captioner_torch/csrc/{source}", "replaces": replaces,
           "launches": dec_bf16_launches[name], "max_abs_err": dec_bf16[name][0], "ms": dec_bf16[name][1],
           "plain_ms": dec_bf16[name][2], "bound_ms": dec_bf16[name][4], "bound_by": dec_bf16[name][5],
           "library_ms": dec_bf16[name][3]}
          for name, source, replaces in (
              ("lstm_step_bf16", "lstm_step.cu", "tpu_captioner/ops/lstm_step.py:81"),
              ("decode_onecell_bf16", "decode_step.cu", "tpu_captioner/ops/decode_step.py:271"),
              ("decode_rollout_bf16", "decode_step.cu", "tpu_captioner/ops/decode_step.py:570"))),
        # The last bf16 instances (phase 14): launches of the bs-32 bf16
        # 'block' eval step's encoder pass (14b) and of the bs-32 bf16 encoder
        # pass with TPU_CAPTIONER_MLP_SUB set (14d); times per bs-32 encoder
        # pass (14a).
        *({"name": name, "route": "cuda", "source": f"tpu_captioner_torch/csrc/{source}", "replaces": replaces,
           "launches": launches, "max_abs_err": last_bf16[name][0], "ms": last_bf16[name][1],
           "plain_ms": last_bf16[name][2], "bound_ms": last_bf16[name][4], "bound_by": last_bf16[name][5],
           "library_ms": last_bf16[name][3]}
          for name, source, replaces, launches in (
              ("block_fused_bf16", "block_fused.cu", "tpu_captioner/ops/block_fused.py:53", block_bf16_launches),
              ("mlp_block_pipelined_bf16", "mlp_block.cu", "tpu_captioner/ops/mlp_block.py:145",
               pipe_bf16_launches))),
        # The precise=False arm (phase 17): launches on phase 4's serving
        # run (no model path passes precise=False: 0); times per bs-32
        # encoder pass (17a) and per fine-tune step (17b).
        *({"name": name, "route": "cuda", "source": f"tpu_captioner_torch/csrc/{source}", "replaces": replaces,
           "launches": bf16p_launches[name], "max_abs_err": bf16p[name][0], "ms": bf16p[name][1],
           "plain_ms": bf16p[name][2], "bound_ms": bf16p[name][4], "bound_by": bf16p[name][5],
           "library_ms": bf16p[name][3]}
          for name, source, replaces in (
              ("mlp_block_bf16_products", "mlp_block.cu", "tpu_captioner/ops/mlp_block.py:126"),
              ("mlp_block_bf16_products_bf16", "mlp_block.cu", "tpu_captioner/ops/mlp_block.py:126"),
              ("mlp_block_pipelined_bf16_products", "mlp_block.cu", "tpu_captioner/ops/mlp_block.py:145"),
              ("mlp_block_pipelined_bf16_products_bf16", "mlp_block.cu", "tpu_captioner/ops/mlp_block.py:145"),
              ("mlp_block_bwd_bf16_products", "mlp_block_bwd.cu", "tpu_captioner/ops/mlp_block.py:275"),
              ("mlp_block_bwd_bf16_products_bf16", "mlp_block_bwd.cu", "tpu_captioner/ops/mlp_block.py:275"))),
    ]
    # The training path of the bf16 instances of phases 11-12 is phase 12c's
    # (the bf16 Transformer), of the bf16 decoder instances phase 13d's
    # (cli.train of a bf16 lstm), where they launch none: the LSTM trains
    # its decoder on the plain path, its validation's decode_kernel 'auto'
    # is 'off' (train/model.py:decode_kernel_mode), and no Transformer
    # decodes there; the rest phase 10's.
    # The last bf16 instances' training path is phase 14's train steps:
    # the bf16 'block' fine-tune step (14c) and the bf16 fine-tune step
    # with TPU_CAPTIONER_MLP_SUB set (14d).
    last_training = {"block_fused_bf16": block_bf16_training, "mlp_block_pipelined_bf16": pipe_bf16_training}
    for k in kernels:
        paths = (last_training if k["name"] in last_training else dec_bf16_training if k["name"] in dec_bf16
                 else bf16_training if k["name"].endswith("_bf16") else training)
        k["launches_training"] = paths[k["name"]]
        k["launches_data_parallel"] = dp_launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
