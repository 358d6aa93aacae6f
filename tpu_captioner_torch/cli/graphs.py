"""Plots of the data and of training runs (counterpart of
``tpu_captioner/cli/graphs.py``; reference makingGraphs.py).

- word-frequency bar chart over the training captions, stop words left out
  (makingGraphs.py:11-55);
- caption-length histogram (makingGraphs.py:58-81);
- train/val loss curves from a results CSV (makingGraphs.py:86-104);
- validation BLEU-4 across runs (makingGraphs.py:107-151);
- the fine-tuning sweep's comparison (makingGraphs.py:154-202).

They read the port's own files: the ``.npy`` (or reference ``.json``)
captions and lengths that ``cli.build_data`` writes, and the results CSV of
the ``Trainer`` (``cli.train``).  matplotlib and pandas are imported inside
the functions, so importing the module needs neither.

    python -m tpu_captioner_torch.cli.graphs loss --csv results/metrics-*.csv --out loss.png
    python -m tpu_captioner_torch.cli.graphs wordfreq --captions inputFiles/TRAIN_CAPTIONS_....npy \
        --wordMap inputFiles/WORDMAP_....json --out words.png
"""

import argparse
import json
import os
from collections import Counter
from typing import List, Optional

# A minimal English stop-word list (the reference filtered stop words via
# nltk's corpus; keep it dependency-free).
STOP_WORDS = set(
    "a an the and or but of to in on at for with is are was were be been being "
    "this that these those it its as by from he she they them his her their "
    "there here has have had do does did not no nor so than too very s t can "
    "will just don should now i you we what which who whom".split()
)


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def word_frequency_chart(
    captions_json_or_npy: str, word_map_path: str, out: str, top_n: int = 30
):
    import numpy as np

    with open(word_map_path) as f:
        word_map = json.load(f)
    rev = {v: k for k, v in word_map.items()}
    if captions_json_or_npy.endswith(".npy"):
        caps = np.load(captions_json_or_npy)
        tokens = [rev[int(i)] for row in caps for i in row]
    else:
        with open(captions_json_or_npy) as f:
            caps = json.load(f)
        tokens = [rev[int(i)] for row in caps for i in row]
    counts = Counter(
        t for t in tokens
        if t not in STOP_WORDS and not t.startswith("<")
    )
    words, freqs = zip(*counts.most_common(top_n))
    plt = _plt()
    plt.figure(figsize=(12, 5))
    plt.bar(words, freqs)
    plt.xticks(rotation=60, ha="right")
    plt.ylabel("frequency")
    plt.title(f"Top {top_n} words (stop words removed)")
    plt.tight_layout()
    plt.savefig(out)
    plt.close()


def caption_length_histogram(caplens_path: str, out: str):
    import numpy as np

    if caplens_path.endswith(".npy"):
        lens = np.load(caplens_path)
    else:
        with open(caplens_path) as f:
            lens = np.asarray(json.load(f))
    plt = _plt()
    plt.figure(figsize=(8, 5))
    plt.hist(lens - 2, bins=range(0, int(lens.max()) + 1))  # words, sans start/end
    plt.xlabel("caption length (words)")
    plt.ylabel("count")
    plt.title("Caption length distribution")
    plt.tight_layout()
    plt.savefig(out)
    plt.close()


def loss_curves(csvs: List[str], labels: Optional[List[str]], out: str):
    import pandas as pd

    plt = _plt()
    plt.figure(figsize=(8, 5))
    labels = labels or [os.path.basename(c) for c in csvs]
    for path, label in zip(csvs, labels):
        df = pd.read_csv(path)
        plt.plot(df["epoch"], df["trainLoss"], label=f"{label} train")
        plt.plot(df["epoch"], df["valLoss"], "--", label=f"{label} val")
    plt.xlabel("epoch")
    plt.ylabel("loss")
    plt.legend()
    plt.title("Training / validation loss")
    plt.tight_layout()
    plt.savefig(out)
    plt.close()


def bleu_curves(csvs: List[str], labels: Optional[List[str]], out: str,
                column: str = "bleu4"):
    import pandas as pd

    plt = _plt()
    plt.figure(figsize=(8, 5))
    labels = labels or [os.path.basename(c) for c in csvs]
    for path, label in zip(csvs, labels):
        df = pd.read_csv(path)
        plt.plot(df["epoch"], df[column], label=label)
    plt.xlabel("epoch")
    plt.ylabel(column)
    plt.legend()
    plt.title(f"Validation {column} across runs")
    plt.tight_layout()
    plt.savefig(out)
    plt.close()


def finetune_sweep(csvs: List[str], labels: Optional[List[str]], out: str,
                   title: str = "Validation BLEU-4 Score Comparison of "
                                "Fine-tuning Strategies"):
    """Dedicated fine-tune-sweep comparison figure (makingGraphs.py:154-202
    plotFinetunedBleu4Scores): BLEU-4 x100 per epoch per run, epochs shifted
    +1 with a (0, 0) starting point, dashed styles cycling after the first
    run, legend upper-left."""
    import numpy as np
    import pandas as pd

    plt = _plt()
    plt.figure(figsize=(14, 8))
    labels = labels or [os.path.basename(c) for c in csvs]
    linestyles = ["-", "-", "-", "--", "-", "--"]
    max_epoch = 1
    for i, (path, label) in enumerate(zip(csvs, labels)):
        df = pd.read_csv(path)
        epochs = np.concatenate([[0], df["epoch"].to_numpy() + 1])
        bleu4 = np.concatenate([[0.0], df["bleu4"].to_numpy() * 100])
        plt.plot(
            epochs, bleu4, label=label,
            linestyle=linestyles[i % len(linestyles)], linewidth=2,
        )
        max_epoch = max(max_epoch, int(epochs.max()))
    plt.title(title, fontsize=18, fontweight="bold", pad=20)
    plt.xlabel("Epoch", fontsize=16, labelpad=15)
    plt.ylabel("BLEU-4 Score", fontsize=16, labelpad=15)
    plt.grid(True, linestyle="--", alpha=0.6)
    plt.legend(fontsize=12, loc="upper left")
    plt.tight_layout()
    plt.xticks(range(0, max_epoch + 1, max(1, max_epoch // 10)), fontsize=14)
    plt.savefig(out, dpi=300)
    plt.close()


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    wf = sub.add_parser("wordfreq")
    wf.add_argument("--captions", required=True)
    wf.add_argument("--wordMap", required=True)
    wf.add_argument("--out", required=True)
    wf.add_argument("--topN", type=int, default=30)

    cl = sub.add_parser("caplens")
    cl.add_argument("--caplens", required=True)
    cl.add_argument("--out", required=True)

    lo = sub.add_parser("loss")
    lo.add_argument("--csv", nargs="+", required=True)
    lo.add_argument("--labels", nargs="*", default=None)
    lo.add_argument("--out", required=True)

    bl = sub.add_parser("bleu")
    bl.add_argument("--csv", nargs="+", required=True)
    bl.add_argument("--labels", nargs="*", default=None)
    bl.add_argument("--out", required=True)
    bl.add_argument("--column", default="bleu4")

    ft = sub.add_parser("finetune-sweep")
    ft.add_argument("--csv", nargs="+", required=True)
    ft.add_argument("--labels", nargs="*", default=None)
    ft.add_argument("--out", required=True)
    ft.add_argument("--title", default="Validation BLEU-4 Score Comparison "
                                       "of Fine-tuning Strategies")

    args = p.parse_args(argv)
    if args.cmd == "wordfreq":
        word_frequency_chart(args.captions, args.wordMap, args.out, args.topN)
    elif args.cmd == "caplens":
        caption_length_histogram(args.caplens, args.out)
    elif args.cmd == "loss":
        loss_curves(args.csv, args.labels, args.out)
    elif args.cmd == "bleu":
        bleu_curves(args.csv, args.labels, args.out, args.column)
    elif args.cmd == "finetune-sweep":
        finetune_sweep(args.csv, args.labels, args.out, args.title)


if __name__ == "__main__":
    main()
