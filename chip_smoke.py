#!/usr/bin/env python3
"""Drive the PyTorch port (``tpu_captioner_torch``) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build both CUDA kernels from ``tpu_captioner_torch/csrc`` (nvcc);
3. hold each kernel against its plain PyTorch version at the main path's
   shapes (fused ConvNeXt MLP tail at the four ConvNeXt-Base stages at batch
   8; decode step at 8 images x beam 5 = 40 rows, cache length 52), with
   CUDA-event times of both;
4. the serving path at full width: ConvNeXt-Base + 6-layer E=512
   Transformer, vocab 9490, random weights from a seed, saved as a reference
   ``.pth.tar`` and loaded back through the CLI's loader; beam 5, 50 steps
   over 8 seeded 256x256 images with the kernels, checking that every kernel
   launched (36 MLP launches per encoder pass, L decode launches per token),
   then the same batch through the plain versions on the card, which must
   give the same captions; then encoder ms, beam ms and captions/s at batch 8
   and 32.

The line before the last is a JSON object of the kernels (route, source, the
TPU kernel each replaces, launches on the main path, max error, times); the
last line is ``{"ok": true, "device": {...}}``.  Needs the repository beside
it and one card; imports no JAX.
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MLP_TOL = 1e-4  # order-one outputs of 4C-long f32 sums in another order; erff vs torch's erf
DECODE_TOL = {"x": 1e-4, "alpha": 1e-5, "k_new": 1e-4, "v_new": 1e-4}
SCORE_TOL = 1e-3  # beam scores, kernel path vs plain path
TIE_GAP = 1e-4  # a differing caption is accepted only at a near-tie of this size
VOCAB = 9490  # COCO vocab size (bench.py:92)
BEAM, MAX_STEPS = 5, 50
DECODE_ROWS, DECODE_T = 8 * BEAM, MAX_STEPS + 2


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


def check_mlp(dev, card):
    """Kernel vs plain at the four stage shapes at batch 8 (N = 8*H*W rows)."""
    import torch

    from tpu_captioner_torch.ops.mlp_block import _mlp_plain, fused_convnext_mlp

    depths, dims, side = (3, 3, 27, 3), (128, 256, 512, 1024), 64
    worst, ms, plain_ms = 0.0, 0.0, 0.0
    for s, (depth, c) in enumerate(zip(depths, dims)):
        n = 8 * (side >> s) ** 2
        g = torch.Generator().manual_seed(c)
        f = lambda *sh: torch.randn(*sh, generator=g)  # noqa: E731
        args = tuple(a.to(dev) for a in (
            f(n, c), f(n, c), torch.ones(n), 1 + 0.1 * f(c), 0.1 * f(c),
            0.02 * f(4 * c, c), 0.1 * f(4 * c), 0.02 * f(c, 4 * c), 0.1 * f(c), 0.5 * f(c),
        ))
        err = (fused_convnext_mlp(*args) - _mlp_plain(*args)).abs().max().item()
        t_plain = _time_ms(lambda: _mlp_plain(*args))
        t_kernel = _time_ms(lambda: fused_convnext_mlp(*args))
        print(f"mlp_block C={c} N={n}: max_abs_err {err:.3e} (tol {MLP_TOL:g}); "
              f"kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms per launch [{card}]")
        if not err < MLP_TOL:
            raise AssertionError(f"mlp_block kernel disagrees at C={c}: {err} >= {MLP_TOL}")
        worst = max(worst, err)
        ms += depth * t_kernel  # one encoder pass at batch 8
        plain_ms += depth * t_plain
    print(f"mlp_block per encoder pass at batch 8 (36 blocks): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms [{card}]")
    return worst, ms, plain_ms


def check_decode(dev, card, layers):
    """Kernel vs plain at 40 rows, cache length 52, several positions, with
    NaN in every cache slot at or past ``pos``."""
    import torch

    from tpu_captioner_torch.ops.decode_step import (
        _decode_step_plain, fused_decode_step, prepare_decode_weights,
    )

    L, E, P = len(layers), layers[0].linear1.in_features, 49
    H = 8
    w = prepare_decode_weights(layers, E)
    g = torch.Generator().manual_seed(1)
    f = lambda *sh: torch.randn(*sh, generator=g).to(dev)  # noqa: E731
    worst, times, plain_times = 0.0, [], []
    for pos in (0, 1, 25, DECODE_T - 1):
        ck, cv = f(L, DECODE_ROWS, DECODE_T, E), f(L, DECODE_ROWS, DECODE_T, E)
        ck[:, :, pos:] = float("nan")
        cv[:, :, pos:] = float("nan")
        args = (w, f(DECODE_ROWS, E), pos, ck, cv, f(L, DECODE_ROWS, P, E), f(L, DECODE_ROWS, P, E), H)
        got, want = fused_decode_step(*args), _decode_step_plain(*args)
        errs = {}
        for name, a, b in zip(DECODE_TOL, got, want):
            if not torch.isfinite(a).all():
                raise AssertionError(f"decode_step kernel gave non-finite {name} at pos {pos}")
            errs[name] = (a - b).abs().max().item()
        t_plain = _time_ms(lambda: _decode_step_plain(*args))
        t_kernel = _time_ms(lambda: fused_decode_step(*args))
        print(f"decode_step R={DECODE_ROWS} T={DECODE_T} pos={pos}: max_abs_err "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f"; kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms per step ({L} layers) [{card}]")
        for name, e in errs.items():
            if not e < DECODE_TOL[name]:
                raise AssertionError(f"decode_step kernel disagrees on {name} at pos {pos}: {e}")
        worst = max(worst, *errs.values())
        times.append(t_kernel)
        plain_times.append(t_plain)
    return worst, sum(times) / len(times), sum(plain_times) / len(plain_times)


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
    from tpu_captioner_torch.ops.mlp_block import fused_convnext_mlp
    from tpu_captioner_torch.train.model import CaptionModel

    # 1. The card.
    dev = require_cuda()
    card = device_info()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    pin_f32_precision()

    # 2. Build the kernels.
    for name in ("mlp_block", "decode_step"):
        t0 = time.perf_counter()
        path = _build.build(name)
        _build.load(name)
        print(f"built {name}.cu in {time.perf_counter() - t0:.2f} s -> {os.path.relpath(path, ROOT)}")
        log = path.with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else []:
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    # 3. Kernels against their plain versions.
    gen = torch.Generator().manual_seed(args.seed)
    cfg = ModelConfig(vocab_size=VOCAB)
    model = CaptionModel(cfg, device=dev, seed=args.seed)
    with torch.no_grad():
        # Order-one layer scales so every MLP tail shows in the features, and
        # a peaked vocab head (as a trained captioner's) so that beam ties
        # are improbable.
        for blk in (m for m in model.modules() if hasattr(m, "layer_scale")):
            blk.layer_scale.copy_(0.1 * torch.rand(blk.layer_scale.shape, generator=gen))
        model.decoder.fc_out.weight.mul_(16.0)
    mlp_err, mlp_ms, mlp_plain_ms = check_mlp(dev, card)
    dec_err, dec_ms, dec_plain_ms = check_decode(dev, card, model.decoder.layers)

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
        dataclasses.replace(served.cfg, use_pallas="off", decode_kernel="off"), device=dev
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
    fused_convnext_mlp.launches = 0
    fused_decode_step.launches = 0
    got = caption_batch(served, images8.numpy(), word_map, BEAM)
    torch.cuda.synchronize()
    mlp_launches, dec_launches = fused_convnext_mlp.launches, fused_decode_step.launches
    del served.decoder.embed
    print(f"main path: {mlp_launches} mlp_block launches (1 encoder pass), "
          f"{dec_launches} decode_step launches over {steps[0]} tokens x {cfg.num_layers} layers")
    if mlp_launches != 36:
        raise AssertionError(f"expected 36 mlp_block launches per encoder pass, got {mlp_launches}")
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

    print(json.dumps({"kernels": [
        {"name": "mlp_block", "route": "cuda", "source": "tpu_captioner_torch/csrc/mlp_block.cu",
         "replaces": "tpu_captioner/ops/mlp_block.py:126", "launches": mlp_launches,
         "max_abs_err": mlp_err, "ms": mlp_ms, "plain_ms": mlp_plain_ms},
        {"name": "decode_step", "route": "cuda", "source": "tpu_captioner_torch/csrc/decode_step.cu",
         "replaces": "tpu_captioner/ops/decode_step.py:185", "launches": dec_launches,
         "max_abs_err": dec_err, "ms": dec_ms, "plain_ms": dec_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
