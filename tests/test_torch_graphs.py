"""``cli.graphs`` against the JAX package's, on the CPU: each of the five
plots, drawn through the port's subcommand from the port's own files (the
``.npy`` records of ``cli.build_data synthetic`` and their ``.json`` form,
results CSVs with the Trainer's columns), has the pixels
(``matplotlib.image.imread``) of the JAX function's plot of the same files;
``--help`` works, and importing the module pulls in neither matplotlib nor
pandas."""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tpu_captioner.cli import graphs as jax_graphs
from tpu_captioner_torch.cli import graphs
from tpu_captioner_torch.data.build import build_synthetic_dataset
from tpu_captioner_torch.train.loop import RESULT_KEYS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = "synthetic_5_cap_per_img_1_min_word_freq"


def imread(path):
    import matplotlib.image

    return matplotlib.image.imread(str(path))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("graphs")
    build_synthetic_dataset(str(d), num_images={"TRAIN": 12, "VAL": 2, "TEST": 2}, max_len=14, image_size=16,
                            vocab_words=80)
    caps = np.load(d / f"TRAIN_CAPTIONS_{BASE}.npy")
    with open(d / "caps.json", "w") as f:
        json.dump(caps.tolist(), f)
    with open(d / "lens.json", "w") as f:
        json.dump(np.load(d / f"TRAIN_CAPLENS_{BASE}.npy").tolist(), f)
    rng = np.random.default_rng(0)
    csvs = []
    for run in range(3):
        path = d / f"metrics-run{run}.csv"
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(RESULT_KEYS))
            writer.writeheader()
            for epoch in range(4 + run):
                row = dict(zip(RESULT_KEYS, [epoch, *rng.random(len(RESULT_KEYS) - 1)]))
                writer.writerow(row)
        csvs.append(str(path))
    return d, csvs


def plots(d, csvs):
    """(name, the port's subcommand, the JAX call) of each plot."""
    wm, caps, lens = str(d / f"WORDMAP_{BASE}.json"), str(d / f"TRAIN_CAPTIONS_{BASE}.npy"), str(
        d / f"TRAIN_CAPLENS_{BASE}.npy")
    return [
        ("wordfreq", ["wordfreq", "--captions", caps, "--wordMap", wm, "--topN", "12"],
         lambda out: jax_graphs.word_frequency_chart(caps, wm, out, 12)),
        ("wordfreq_json", ["wordfreq", "--captions", str(d / "caps.json"), "--wordMap", wm],
         lambda out: jax_graphs.word_frequency_chart(str(d / "caps.json"), wm, out)),
        ("caplens", ["caplens", "--caplens", lens], lambda out: jax_graphs.caption_length_histogram(lens, out)),
        ("caplens_json", ["caplens", "--caplens", str(d / "lens.json")],
         lambda out: jax_graphs.caption_length_histogram(str(d / "lens.json"), out)),
        ("loss", ["loss", "--csv", *csvs[:2]], lambda out: jax_graphs.loss_curves(csvs[:2], None, out)),
        ("bleu", ["bleu", "--csv", *csvs, "--labels", "a", "b", "c", "--column", "bleu2"],
         lambda out: jax_graphs.bleu_curves(csvs, ["a", "b", "c"], out, "bleu2")),
        ("finetune-sweep", ["finetune-sweep", "--csv", *csvs, "--labels", "none", "5-7", "6-7"],
         lambda out: jax_graphs.finetune_sweep(csvs, ["none", "5-7", "6-7"], out)),
    ]


@pytest.mark.parametrize("index", range(7))
def test_each_plot_has_jax_pixels(files, index):
    d, csvs = files
    name, argv, jax_call = plots(d, csvs)[index]
    graphs.main(argv + ["--out", str(d / f"{name}_port.png")])
    jax_call(str(d / f"{name}_jax.png"))
    got, want = imread(d / f"{name}_port.png"), imread(d / f"{name}_jax.png")
    assert got.shape == want.shape and got.shape[0] > 100
    np.testing.assert_array_equal(got, want)


def test_help_and_a_light_import():
    out = subprocess.run([sys.executable, "-m", "tpu_captioner_torch.cli.graphs", "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "usage" in out.stdout.lower(), out.stderr
    for cmd in ("wordfreq", "caplens", "loss", "bleu", "finetune-sweep"):
        assert cmd in out.stdout
    code = ("import sys, tpu_captioner_torch.cli.graphs, tpu_captioner_torch.infer.visualize; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('matplotlib', 'pandas', 'PIL', 'scipy')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stdout + out.stderr
