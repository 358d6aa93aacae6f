"""CLI: train a captioner (counterpart of ``tpu_captioner/cli/train.py``;
reference train.py and trainMultiGPU.py).

    python -m tpu_captioner_torch.cli.train --dataFolder inputFiles \
        --dataName coco_5_cap_per_img_5_min_word_freq \
        --teacherForcing --startingLayer 5 --encoderLr 1e-6 \
        --embeddingName glove-wiki-gigaword-200 --device cuda

Trains free-running unless ``--teacherForcing`` is given, as the reference
and the JAX package do.  Checkpoints go to ``checkpoints/`` and the results
CSV to ``results/`` under the working directory; ``--checkpoint`` resumes.

One entry point covers one card and many: ``--numDevices N`` (0, the default:
every visible card) trains data-parallel on N cards, one process each,
spawned here, with a global batch of N x ``--batchSize``; under
``torchrun --nproc_per_node N -m tpu_captioner_torch.cli.train ...`` each
launched process joins the group instead.  ``--device cpu --numDevices N``
runs N processes on the CPU.
"""

from __future__ import annotations

import argparse


def _train(args, exp, mesh):
    from tpu_captioner_torch.train.loop import Trainer

    trainer = Trainer(exp, args.dataFolder, args.dataName, device=args.device, mesh=mesh)
    trainer.run()
    return trainer


def main(argv=None):
    """Returns the Trainer of this process's rank, or None when it spawned
    the ranks."""
    from tpu_captioner_torch.cli.common import add_common_args, config_from_args, run_data_parallel

    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--teacherForcing", action="store_true", help="teacher-forcing training strategy")
    p.add_argument("--epochs", type=int, default=120)
    args = p.parse_args(argv)
    return run_data_parallel(_train, args, config_from_args(args))


if __name__ == "__main__":
    main()
