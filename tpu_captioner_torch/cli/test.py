"""CLI: greedy evaluation of the TEST split (counterpart of
``tpu_captioner/cli/test.py``; reference test.py).

    python -m tpu_captioner_torch.cli.test --dataFolder inputFiles \
        --dataName coco_5_cap_per_img_5_min_word_freq \
        --checkpoint checkpoints/BEST_checkpoint_... --device cuda

Loads a checkpoint directory of ``train/checkpoint.py`` or a reference
``.pth.tar`` (through ``models/from_jax.py:load_reference_checkpoint``),
decodes the TEST split greedily with ``max_decode_len`` 51, prints loss,
top-5 and BLEU-1..4, and writes them as a one-row CSV (test.py:122-136)
with the ``csv`` module.  Data-parallel over ``--numDevices`` as
``cli.train``: each rank decodes its rows, rank 0 scores and writes.
"""

from __future__ import annotations

import argparse
import csv
import os


def _test(args, exp, mesh):
    from tpu_captioner_torch.data.dataset import CaptionDataset
    from tpu_captioner_torch.data.loader import DeviceLoader
    from tpu_captioner_torch.models.from_jax import load_reference_checkpoint
    from tpu_captioner_torch.train.loop import Trainer

    ref_ckpt = None
    if exp.train.checkpoint and exp.train.checkpoint.endswith(".pth.tar"):
        ref_ckpt, exp.train.checkpoint = exp.train.checkpoint, None
    trainer = Trainer(exp, args.dataFolder, args.dataName, device=args.device, mesh=mesh)
    if ref_ckpt is not None:
        meta = load_reference_checkpoint(trainer.model, ref_ckpt)
        if trainer.coordinator:
            print(f"Loaded reference checkpoint (epoch {meta['epoch']}, val BLEU-4 {meta['bleu4']})")
    loader = DeviceLoader(CaptionDataset(args.dataFolder, args.dataName, "TEST"), trainer.train_loader.batch_size,
                          shuffle=False, mesh=trainer.mesh)
    out = trainer.evaluate(loader)
    row = {"testLoss": out["loss"], "testTop5Acc": out["top5"], "bleu1": out["bleu1"], "bleu2": out["bleu2"],
           "bleu3": out["bleu3"], "bleu4": out["bleu4"]}
    if trainer.coordinator:
        os.makedirs(args.resultsDir, exist_ok=True)
        path = os.path.join(args.resultsDir, f"test-{exp.model.decoder}-Finetuning{args.startingLayer}-"
                                             f"{args.embeddingName}.csv")
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(row))
            writer.writeheader()
            writer.writerow(row)
        print(row)
    return row


def main(argv=None):
    """Returns the test row on this process's rank, or None when it spawned
    the ranks (``--numDevices``, as ``cli.train``)."""
    from tpu_captioner_torch.cli.common import add_common_args, config_from_args, run_data_parallel

    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--resultsDir", type=str, default="results")
    args = p.parse_args(argv)
    return run_data_parallel(_test, args, config_from_args(args))


if __name__ == "__main__":
    main()
