"""The port's training CLIs end to end on the CPU at tiny widths:
``build_data synthetic`` -> ``train --epochs 1 --device cpu`` (free-running,
the default, and ``--teacherForcing``) -> ``test`` on the checkpoint it wrote
and on a reference ``.pth.tar``.  Each writes its files; the card is the
default device, and a host without one refuses it; ``build_data
port-backbone`` writes a torchvision checkpoint's arrays as an ``.npz``."""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_captioner_torch.cli import build_data, test as cli_test, train as cli_train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "synthetic_5_cap_per_img_1_min_word_freq"
TINY = ["--embedDim", "16", "--attentionDim", "12", "--decoderDim", "20", "--numHeads", "4", "--numLayers", "2",
        "--maxLen", "14", "--imageSize", "32", "--encoderDepths", "1,1,1,1", "--encoderDims", "8,12,16,24",
        "--encodedImageSize", "2", "--batchSize", "8", "--dataFolder", "ds", "--dataName", NAME]
METRICS = ["epoch", "trainLoss", "trainTop5Acc", "trainBatchTime", "trainDataTime", "valLoss", "valTop5Acc",
           "bleu1", "bleu2", "bleu3", "bleu4"]


def read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "tpu_captioner_torch.cli.build_data", "synthetic", "--outputFolder", "ds",
         "--maxLen", "12", "--imageSize", "32", "--trainImages", "8", "--valImages", "4", "--testImages", "4",
         "--learnable"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": ROOT}, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert {f"{s}_{k}_{NAME}.{e}" for s in ("TRAIN", "VAL", "TEST") for k, e in (
        ("IMAGES", "npy"), ("CAPTIONS", "npy"), ("CAPLENS", "npy"), ("META", "json"))} | {
        f"WORDMAP_{NAME}.json"} == set(os.listdir(tmp_path / "ds"))
    return tmp_path


@pytest.mark.parametrize("strategy", ["trainingNoTF", "trainingTF"])
def test_build_train_test_on_the_cpu(workdir, strategy):
    flags = TINY + ["--device", "cpu"]
    trainer = cli_train.main(flags + ["--epochs", "1"] + (["--teacherForcing"] if strategy == "trainingTF" else []))
    assert trainer.exp.train.teacher_forcing == (strategy == "trainingTF")
    assert trainer.exp.model.vocab_size == 124 and trainer.model.device.type == "cpu"
    rows = read_csv(workdir / "results" / f"metrics-transformer({strategy}-inferenceNoTF-Finetuning5-None).csv")
    assert len(rows) == 1 and list(rows[0]) == METRICS
    assert float(rows[0]["trainLoss"]) > 0 and float(rows[0]["valLoss"]) > 0
    name = f"checkpoint_Transformer_Finetuning5_0.0001_None_{NAME}"
    for d in (name, f"BEST_{name}"):
        assert sorted(os.listdir(workdir / "checkpoints" / d)) == ["meta.json", "state.pt"]

    row = cli_test.main(flags + ["--checkpoint", f"checkpoints/BEST_{name}"])
    (written,) = read_csv(workdir / "results" / "test-transformer-Finetuning5-None.csv")
    assert list(written) == ["testLoss", "testTop5Acc", "bleu1", "bleu2", "bleu3", "bleu4"]
    assert float(written["testLoss"]) == row["testLoss"] > 0

    # A reference .pth.tar of the trained weights scores the same.
    from tpu_captioner_torch.models.from_jax import save_reference_checkpoint

    save_reference_checkpoint(trainer.model, str(workdir / "ref.pth.tar"), epoch=0, bleu4=0.0)
    assert cli_test.main(flags + ["--checkpoint", "ref.pth.tar"]) == row


def test_the_card_is_the_default_and_one_card_only(workdir):
    """The card is the default and a host without one refuses it.  More
    than one device (once refused as ROADMAP.md Queue 1 #9) runs one rank
    per device: run plainly, ``cli.train`` and ``cli.test`` spawn them (two
    gloo processes with ``--device cpu``), and rank 0 writes one results
    CSV and one checkpoint tree; under a group of two, ``--numDevices 2``
    trains on both ranks and 3 raises ValueError
    (``tests/torch_parallel_workers.py:cli_train_rank``)."""
    from tests.torch_parallel_workers import cli_train_rank
    from tpu_captioner_torch.parallel.mesh import spawn

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_train.main(TINY + ["--epochs", "1"])
    # port-backbone, once refused as Queue 1 #7: a wrapped torchvision-keyed
    # state dict becomes an .npz of its arrays, which trains nothing.
    sd = {"features.0.0.weight": torch.randn(8, 3, 4, 4), "classifier.2.bias": torch.arange(3.0)}
    torch.save({"model": sd}, workdir / "a.pth")
    build_data.main(["port-backbone", "--src", "a.pth", "--out", "b.npz"])
    with np.load(workdir / "b.npz") as arrays:
        assert arrays.files == list(sd) and all(np.array_equal(arrays[k], v.numpy()) for k, v in sd.items())
    assert not os.path.exists(workdir / "checkpoints")

    flags = TINY + ["--device", "cpu", "--numDevices", "2"]
    assert cli_train.main(flags + ["--epochs", "1"]) is None
    (row,) = read_csv(workdir / "results" / "metrics-transformer(trainingNoTF-inferenceNoTF-Finetuning5-None).csv")
    assert list(row) == METRICS and float(row["trainLoss"]) > 0 and float(row["bleu1"]) >= 0
    name = f"checkpoint_Transformer_Finetuning5_0.0001_None_{NAME}"
    assert sorted(os.listdir(workdir / "checkpoints")) == [f"BEST_{name}", name]
    assert cli_test.main(flags + ["--checkpoint", f"checkpoints/{name}"]) is None
    (tested,) = read_csv(workdir / "results" / "test-transformer-Finetuning5-None.csv")
    assert float(tested["testLoss"]) > 0
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="2 cards asked for"):
            cli_train.main(TINY + ["--epochs", "1", "--numDevices", "2"])
    spawn(cli_train_rank, 2, "cpu", args=(TINY + ["--device", "cpu", "--epochs", "1"],))
