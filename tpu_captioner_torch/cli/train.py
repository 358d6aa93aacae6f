"""CLI: train a captioner (counterpart of ``tpu_captioner/cli/train.py``;
reference train.py).

    python -m tpu_captioner_torch.cli.train --dataFolder inputFiles \
        --dataName coco_5_cap_per_img_5_min_word_freq \
        --teacherForcing --startingLayer 5 --encoderLr 1e-6 \
        --embeddingName glove-wiki-gigaword-200 --device cuda

Trains free-running unless ``--teacherForcing`` is given, as the reference
and the JAX package do.  Checkpoints go to ``checkpoints/`` and the results
CSV to ``results/`` under the working directory; ``--checkpoint`` resumes.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from tpu_captioner_torch.cli.common import add_common_args, config_from_args
    from tpu_captioner_torch.train.loop import Trainer

    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--teacherForcing", action="store_true", help="teacher-forcing training strategy")
    p.add_argument("--epochs", type=int, default=120)
    args = p.parse_args(argv)
    exp = config_from_args(args)
    trainer = Trainer(exp, args.dataFolder, args.dataName, device=args.device)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
