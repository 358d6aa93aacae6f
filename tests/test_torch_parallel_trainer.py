"""The port's ``Trainer`` on two data-parallel ranks (two gloo processes on
the CPU, ``tests/torch_parallel_workers.py:trainer_rank``) against one
process at the global batch, at the tiny widths of
``tests/test_torch_trainer.py``: two epochs with the encoder unlock at
epoch 1, dropout and stochastic depth on.  Tolerances: losses and top-5
1e-4 relative (two epochs of Adam steps whose gradients are summed in
another order), BLEU equal (rank 0 scores every rank's gathered outputs).
The two-rank run writes one results CSV and one checkpoint tree, as the
one-process run does, and a two-rank resume from its checkpoint loads on
both ranks and continues with epoch 2."""

import os

import pytest
import torch

from tests.test_torch_trainer import BASE, TIMES, experiment
from tests.torch_parallel_workers import trainer_rank
from tpu_captioner_torch.data.build import build_synthetic_dataset
from tpu_captioner_torch.parallel.mesh import spawn
from tpu_captioner_torch.train import loop

BLEU = ("bleu1", "bleu2", "bleu3", "bleu4")
LR = 3e-3


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    build_synthetic_dataset(str(d), num_images={"TRAIN": 16, "VAL": 8, "TEST": 8}, max_len=12, image_size=32,
                            learnable=True)
    return str(d)


def files(exp):
    tc = exp.train
    tree = {d: sorted(os.listdir(os.path.join(tc.checkpoint_dir, d))) for d in os.listdir(tc.checkpoint_dir)}
    return tree, sorted(os.listdir(tc.results_dir))


def test_two_rank_trainer_matches_one_process_and_resumes(data_dir, tmp_path):
    one_exp = experiment(tmp_path, "one", batch_size=8, decoder_lr=LR)
    one = loop.Trainer(one_exp, data_dir, BASE, device="cpu", verbose=False)
    want = one.run()

    two_exp = experiment(tmp_path, "two", batch_size=4, decoder_lr=LR)
    spawn(trainer_rank, 2, "cpu", args=(two_exp, data_dir, BASE, str(tmp_path / "two.pt")))
    two = torch.load(tmp_path / "two.pt", weights_only=False)
    got = two["rows"]
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in ("trainLoss", "valLoss", "trainTop5Acc", "valTop5Acc"):
            assert g[k] == pytest.approx(w[k], rel=1e-4), (g["epoch"], k)
        assert [g[k] for k in BLEU] == [w[k] for k in BLEU] and g["bleu1"] > 0, g["epoch"]
        assert all(g[k] > 0 for k in TIMES)
    assert files(two_exp) == files(one_exp)
    tree, csvs = files(two_exp)
    assert len(csvs) == 1 and all(v == ["meta.json", "state.pt"] for v in tree.values())

    name = one.checkpoint_name()
    resume_exp = experiment(tmp_path, "two", batch_size=4, decoder_lr=LR, epochs=3,
                            checkpoint=os.path.join(two_exp.train.checkpoint_dir, name))
    spawn(trainer_rank, 2, "cpu", args=(resume_exp, data_dir, BASE, str(tmp_path / "resumed.pt")))
    resumed = torch.load(tmp_path / "resumed.pt", weights_only=False)
    assert resumed["start"] == torch.load(tmp_path / "resumed.pt.1", weights_only=False)["start"] == 2
    assert [r["epoch"] for r in resumed["rows"]] == [0, 1, 2] and resumed["rows"][:2] == got
