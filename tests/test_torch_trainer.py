"""The port's ``Trainer`` against the JAX package's, and its checkpoints, on the
CPU, over a synthetic dataset both build from one seed (the tiny widths of
``tests/test_train_loop.py``).

The comparison starts both trainers from the same weights (JAX's initial
parameters bridged with ``state_dict_from_jax``), with dropout at 0 and
stochastic depth off (both encoders patched to run deterministically, as
``tests/test_torch_finetune.py`` does), and runs two teacher-forced epochs
with ``fine_tune_epoch=1``, so the second epoch fine-tunes from
``starting_layer`` 5 with a fresh encoder Adam.  Tolerances: losses 1e-4
relative (two epochs of f32 Adam steps in two frameworks; Adam turns the
gradients' float noise below 1e-7 into steps of +-lr), top-5 and BLEU equal
(the sequences are equal at these seeds).  The port's resume is held to its
own uninterrupted run bit for bit, with dropout and stochastic depth on.
"""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_helpers import to_numpy
from tpu_captioner_torch.core.config import ExperimentConfig, ModelConfig, TrainConfig
from tpu_captioner_torch.data.build import build_synthetic_dataset
from tpu_captioner_torch.models.from_jax import _encoder_from_jax, state_dict_from_jax
from tpu_captioner_torch.train import loop
from tpu_captioner_torch.train.checkpoint import checkpoint_name, restore_checkpoint
from tpu_captioner_torch.train.model import CaptionModel
from tpu_captioner_torch.train.state import get_lr

BASE = "synthetic_5_cap_per_img_1_min_word_freq"
MAXLEN = 12
TIMES = ("trainBatchTime", "trainDataTime")
TINY = dict(embed_dim=16, attention_dim=12, decoder_dim=20, num_heads=4, num_layers=2, max_len=MAXLEN + 2,
            encoder_dim=24, encoder_depths=(1, 1, 1, 1), encoder_dims=(8, 12, 16, 24))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    build_synthetic_dataset(str(d), num_images={"TRAIN": 16, "VAL": 8, "TEST": 8}, max_len=MAXLEN, image_size=32)
    return str(d)


def experiment(tmp, package="port", model_kw=None, **train_kw):
    tkw = dict(epochs=2, batch_size=8, max_decode_len=MAXLEN + 1, fine_tune_epoch=1, print_freq=1000,
               checkpoint_dir=str(tmp / package / "ckpt"), results_dir=str(tmp / package / "results"))
    tkw.update(train_kw)
    mkw = {**TINY, **(model_kw or {})}
    if package == "port":
        return ExperimentConfig(model=ModelConfig(**mkw), train=TrainConfig(**tkw))
    from tpu_captioner.core import config as jc

    return jc.ExperimentConfig(data=jc.DataConfig(batch_size=8, image_size=32), model=jc.ModelConfig(**mkw),
                               train=jc.TrainConfig(**tkw))


def deterministic_encoders(trainer):
    """Stochastic depth off in the port's frozen and fine-tune encodes."""
    model = trainer.model
    model.encode = lambda images_u8, train=False, generator=None: CaptionModel.encode(model, images_u8)
    model.encode_fine_tune = lambda images_u8, starting_layer, generator=None: (
        CaptionModel.encode_fine_tune(model, images_u8, starting_layer)
    )


@pytest.fixture(scope="module")
def jax_run(data_dir, tmp_path_factory):
    """JAX's two epochs, its initial parameters, its CSV and its meta.json."""
    from tpu_captioner.train.loop import Trainer as JaxTrainer
    from tpu_captioner.train.model import CaptionModel as JaxCaptionModel

    tmp = tmp_path_factory.mktemp("jax")
    exp = experiment(tmp, "jax", dict(dropout=0.0, use_pallas="off"))
    trainer = JaxTrainer(exp, data_dir, BASE, verbose=False)
    for m in {id(m): m for m in (trainer.model, trainer.eval_model, trainer.ft_model)}.values():
        m.encode = lambda params, images_u8, deterministic=True, rng=None, _m=m: (
            JaxCaptionModel.encode(_m, params, images_u8, deterministic=True)
        )
    init = to_numpy(trainer.state.params)
    results = copy.deepcopy(trainer.run())
    csv_path = trainer.write_results_csv()
    name = checkpoint_name(BASE, False, 5, exp.train.encoder_lr, None)
    with open(os.path.join(exp.train.checkpoint_dir, name, "meta.json")) as f:
        meta = json.load(f)
    return init, results, csv_path, meta


def test_trainer_matches_jax(data_dir, jax_run, tmp_path):
    init, want, want_csv, want_meta = jax_run
    exp = experiment(tmp_path, model_kw=dict(dropout=0.0))
    trainer = loop.Trainer(exp, data_dir, BASE, device="cpu", verbose=False)
    trainer.model.load_state_dict(state_dict_from_jax(init, exp.model))
    deterministic_encoders(trainer)
    got = trainer.run()
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in ("trainLoss", "valLoss"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=f"epoch {g['epoch']} {k}")
        for k in ("trainTop5Acc", "valTop5Acc", "bleu1", "bleu2", "bleu3", "bleu4"):
            assert g[k] == pytest.approx(w[k], rel=1e-12, abs=0), (g["epoch"], k)
        assert all(g[k] > 0 for k in TIMES)
    assert trainer.fine_tune_encoder
    # The CSV: JAX's name and columns, the rows as written.
    got_csv = trainer.write_results_csv()
    assert os.path.basename(got_csv) == os.path.basename(want_csv)
    with open(got_csv) as f, open(want_csv) as g:
        assert f.readline() == g.readline()
        rows = f.read().splitlines()
    assert len(rows) == 2 and rows[1].startswith("1,")
    # The checkpoint: JAX's name, meta.json's top-level keys, the BEST_ copy.
    name = trainer.checkpoint_name()
    assert name == checkpoint_name(BASE, False, 5, 1e-4, None)
    with open(os.path.join(exp.train.checkpoint_dir, name, "meta.json")) as f:
        meta = json.load(f)
    assert set(meta) == set(want_meta)
    assert meta["epoch"] == want_meta["epoch"] == 1
    best = os.path.join(exp.train.checkpoint_dir, f"BEST_{name}")
    assert sorted(os.listdir(best)) == ["meta.json", "state.pt"]


def test_resume_reproduces_the_run_bit_for_bit(data_dir, tmp_path, monkeypatch):
    """Two epochs with dropout and stochastic depth, the unlock at epoch 1;
    then a new trainer from the epoch-0 checkpoint: its model and both Adam
    states equal the saved ones, and its epoch-1 row and final parameters
    and Adam states equal the uninterrupted run's, bit for bit."""
    saved = {}
    real_save = loop.save_checkpoint

    def save(directory, name, state, meta, is_best=False):
        base = real_save(directory, name, state, meta, is_best)
        if meta["epoch"] == 0:
            import shutil

            shutil.copytree(base, tmp_path / "epoch0")
            saved["model"] = copy.deepcopy(state.model.state_dict())
            saved["dec_opt"] = copy.deepcopy(state.dec_opt.state_dict())
            saved["enc_opt"] = copy.deepcopy(state.enc_opt.state_dict())
        return base

    monkeypatch.setattr(loop, "save_checkpoint", save)
    exp = experiment(tmp_path, "a")
    first = loop.Trainer(exp, data_dir, BASE, device="cpu", verbose=False)
    rows = copy.deepcopy(first.run())
    assert len(rows) == 2 and saved["dec_opt"]["state"] and not saved["enc_opt"]["state"]

    exp2 = experiment(tmp_path, "b", checkpoint=str(tmp_path / "epoch0"))
    second = loop.Trainer(exp2, data_dir, BASE, device="cpu", verbose=False)
    assert second.start_epoch == 1 and not second.fine_tune_encoder
    assert [r["epoch"] for r in second.results] == [0]
    assert_same(second.model.state_dict(), saved["model"])
    assert_same(second.state.dec_opt.state_dict(), saved["dec_opt"])
    assert_same(second.state.enc_opt.state_dict(), saved["enc_opt"])
    assert second.state.step == len(second.train_loader)
    rows2 = second.run()
    assert second.fine_tune_encoder and len(rows2) == 2
    strip = lambda r: {k: v for k, v in r.items() if k not in TIMES}  # noqa: E731
    assert strip(rows2[1]) == strip(rows[1])
    assert_same(second.model.state_dict(), first.model.state_dict())
    assert_same(second.state.dec_opt.state_dict(), first.state.dec_opt.state_dict())
    assert_same(second.state.enc_opt.state_dict(), first.state.enc_opt.state_dict())
    assert first.state.enc_opt.state_dict()["state"]  # the encoder trained in epoch 1


def assert_same(a, b):
    """Equal nested state dicts, tensors bit for bit."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        assert a == b


def test_restore_checkpoint_round_trip(data_dir, tmp_path):
    exp = experiment(tmp_path, epochs=1)
    trainer = loop.Trainer(exp, data_dir, BASE, device="cpu", verbose=False)
    trainer.run()
    path = os.path.join(exp.train.checkpoint_dir, trainer.checkpoint_name())
    other = loop.Trainer(experiment(tmp_path / "o"), data_dir, BASE, device="cpu", verbose=False)
    state, meta = restore_checkpoint(path, other.state)
    assert meta["epoch"] == 0 and meta["results"] == trainer.results
    assert_same(state.model.state_dict(), trainer.model.state_dict())
    assert_same(state.dec_opt.state_dict(), trainer.state.dec_opt.state_dict())
    assert ModelConfig(**meta["config"]["model"]).encoder_dims == [8, 12, 16, 24]


def stub_epochs(trainer, bleu4):
    trainer.train_epoch = lambda epoch: {"loss": 1.0, "top5": 2.0, "batch_time": 0.1, "data_time": 0.0}
    trainer.evaluate = lambda loader, epoch=0: {"loss": 1.0, "top5": 2.0, "bleu1": 0.0, "bleu2": 0.0,
                                                 "bleu3": 0.0, "bleu4": bleu4(epoch)}


def test_schedule_matches_jax(data_dir, tmp_path, monkeypatch):
    """The LR decay (x0.8 at 8 and 16 stagnant epochs: epochs 11 and 19),
    the encoder unlock with a fresh Adam at epoch 15 and the early stop at
    20 stagnant epochs, with the epochs' training and evaluation stubbed
    out (and JAX's checkpoint writes): the port's learning rates and rows
    against JAX's."""
    from tpu_captioner.train.loop import Trainer as JaxTrainer
    from tpu_captioner.train.state import get_lr as jax_get_lr

    monkeypatch.setattr("tpu_captioner.train.loop.save_checkpoint", lambda *a, **k: None)
    bleu4 = lambda epoch: 0.5 if epoch == 2 else 0.1  # noqa: E731 — improves at 0 and 2, then stalls
    kw = dict(epochs=60, fine_tune_epoch=15)
    jt = JaxTrainer(experiment(tmp_path, "jax", dict(use_pallas="off"), **kw), data_dir, BASE, verbose=False)
    pt = loop.Trainer(experiment(tmp_path, **kw), data_dir, BASE, device="cpu", verbose=False)
    for tr in (jt, pt):
        stub_epochs(tr, bleu4)
    want, got = jt.run(), pt.run()
    assert len(got) == len(want) == 23  # stalls after epoch 2: stops before epoch 23
    assert got == want
    assert get_lr(pt.state.dec_opt) == pytest.approx(jax_get_lr(jt.state.dec_opt_state)) == pytest.approx(1e-4 * 0.64)
    assert get_lr(pt.state.enc_opt) == pytest.approx(jax_get_lr(jt.state.enc_opt_state)) == pytest.approx(1e-4 * 0.8)
    assert os.path.exists(os.path.join(pt.exp.train.checkpoint_dir, f"BEST_{pt.checkpoint_name()}"))


def test_pretrained_encoder_loads_as_jax_and_checks_its_size(data_dir, tmp_path):
    """A torchvision ``convnext_base``-style state dict (``features.*`` and
    the classifier) initialises the backbone with the weights JAX's loader
    reads from it, and so does its .npz (``build_data port-backbone``); a
    file for other depths raises, in either form."""
    from tpu_captioner.models.port_torch import load_pretrained_backbone

    donor = CaptionModel(ModelConfig(vocab_size=5, **TINY), device="cpu", seed=9)
    sd = {"features." + k[len("convnext."):]: v for k, v in donor.encoder.state_dict().items()}
    sd["classifier.2.weight"] = torch.zeros(3, 24)
    torch.save({"state_dict": sd}, tmp_path / "convnext.pth")
    exp = experiment(tmp_path, model_kw=dict(pretrained_encoder=str(tmp_path / "convnext.pth")))
    trainer = loop.Trainer(exp, data_dir, BASE, device="cpu", verbose=False)
    assert_same(trainer.model.encoder.state_dict(), donor.encoder.state_dict())
    jax_tree = load_pretrained_backbone(str(tmp_path / "convnext.pth"), depths=TINY["encoder_depths"])
    want = _encoder_from_jax({"convnext": to_numpy(jax_tree)}, TINY["encoder_depths"])
    assert_same(trainer.model.encoder.state_dict(), want)

    deeper = dataclasses.replace(exp.model, encoder_depths=(1, 1, 2, 1))
    with pytest.raises(ValueError, match="does not match the configured backbone"):
        loop.Trainer(dataclasses.replace(exp, model=deeper), data_dir, BASE, device="cpu", verbose=False)
    # The .npz form (build_data port-backbone), once refused as Queue 1 #7,
    # loads the same weights, and a wrong-depth one raises as the .pth does.
    loop.convert_backbone_to_npz(str(tmp_path / "convnext.pth"), str(tmp_path / "convnext.npz"))
    npz = dataclasses.replace(exp.model, pretrained_encoder=str(tmp_path / "convnext.npz"))
    from_npz = loop.Trainer(dataclasses.replace(exp, model=npz), data_dir, BASE, device="cpu", verbose=False)
    assert_same(from_npz.model.encoder.state_dict(), donor.encoder.state_dict())
    with pytest.raises(ValueError, match="does not match the configured backbone"):
        loop.Trainer(dataclasses.replace(exp, model=dataclasses.replace(npz, encoder_depths=(1, 1, 2, 1))),
                     data_dir, BASE, device="cpu", verbose=False)


def test_corpora_and_meter_match_jax():
    from tpu_captioner.eval.metrics import AverageMeter as JaxMeter
    from tpu_captioner.train.loop import build_references_and_hypotheses as jax_build

    rng = np.random.default_rng(0)
    caps = rng.integers(0, 9, (4, 3, 7))
    caps[:, :, 0] = 7
    seqs = rng.integers(1, 9, (4, 5))
    lengths = np.array([5, 2, 3, 1])
    valid = np.array([True, False, True, True])
    assert loop.build_references_and_hypotheses(caps, seqs, lengths, valid, 7, 0) == jax_build(
        caps, seqs, lengths, valid, 7, 0)
    a, b = loop.AverageMeter(), JaxMeter()
    for val, n in ((2.0, 3), (5.0, 1), (0.5, 4)):
        a.update(val, n)
        b.update(val, n)
    assert (a.val, a.sum, a.count, a.avg) == (b.val, b.sum, b.count, b.avg)
