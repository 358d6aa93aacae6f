"""bf16 training through the entry point, on the CPU at tiny widths:
``cli.train --computeDtype bfloat16 --teacherForcing --device cpu`` over two
epochs with the encoder unlocked at the second (``fine_tune_epoch`` 1, the
reference's schedule moved up), on a learnable synthetic dataset, for the
Transformer and both LSTM families (``--decoder``).

- Every step is a bf16 step: the features are bf16, the frozen epoch's
  steps leave the encoder unchanged, the fine-tune epoch's train children 5
  to 7 (and only those) with a fresh encoder Adam; the parameters and both
  Adams stay f32; the losses are finite.
- ``meta.json`` of the checkpoint and of its ``BEST_`` copy says bfloat16.
- ``cli.caption`` on the ``BEST_`` directory prints the captions that
  ``beam_search_batch`` gives on the trainer's own model (a bf16 model
  rebuilt from ``meta.json``); ``cli.test --computeDtype bfloat16`` scores
  the checkpoint.
- A resume from the epoch-0 checkpoint restores the model and both Adam
  states bit for bit, and its epoch-1 row and final parameters equal the
  uninterrupted run's.
"""

import copy
import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch

from tests.test_torch_caption_checkpoint import write_images
from tests.test_torch_cli_train import NAME, TINY, workdir  # noqa: F401 — the dataset fixture
from tests.test_torch_trainer import TIMES, assert_same
from tpu_captioner_torch.cli import caption, common, test as cli_test, train as cli_train
from tpu_captioner_torch.core.config import TrainConfig
from tpu_captioner_torch.data.vocab import load_word_map
from tpu_captioner_torch.infer.beam import beam_search_batch
from tpu_captioner_torch.train import loop

FLAGS = TINY + ["--device", "cpu", "--computeDtype", "bfloat16"]
CKPT = f"checkpoint_Transformer_Finetuning5_0.0001_None_{NAME}"
CKPT_LSTM = f"checkpoint_LSTM_Finetuning5_0.0001_{NAME}"


@pytest.mark.parametrize("decoder", ["transformer", "lstm", "lstm_no_attention"])
def test_bf16_cli_train_unlock_caption_test_and_resume(workdir, monkeypatch, capsys, decoder):  # noqa: F811
    monkeypatch.setattr(common, "TrainConfig", functools.partial(TrainConfig, fine_tune_epoch=1))
    flags = FLAGS + ["--decoder", decoder]
    ckpt = CKPT if decoder == "transformer" else CKPT_LSTM
    saved, steps = {}, []
    real_save, real_make = loop.save_checkpoint, loop.make_train_step

    def save(directory, name, state, meta, is_best=False):
        base = real_save(directory, name, state, meta, is_best)
        if meta["epoch"] == 0 and "model" not in saved:
            shutil.copytree(base, workdir / "epoch0")
            saved["model"] = copy.deepcopy(state.model.state_dict())
            saved["dec_opt"] = copy.deepcopy(state.dec_opt.state_dict())
            saved["enc_opt"] = copy.deepcopy(state.enc_opt.state_dict())
        return base

    def make_train_step(model, cfg, word_ids, **kw):
        step = real_make(model, cfg, word_ids, **kw)

        def counted(state, batch, seed):
            before = {k: v.clone() for k, v in model.encoder.state_dict().items()}
            out = step(state, batch, seed)
            changed = {int(k.split(".")[1]) for k, v in model.encoder.state_dict().items()
                       if not torch.equal(v, before[k])}
            steps.append((kw["train_encoder"], changed, float(out[1]["loss"])))
            return out

        return counted

    monkeypatch.setattr(loop, "save_checkpoint", save)
    monkeypatch.setattr(loop, "make_train_step", make_train_step)
    trainer = cli_train.main(flags + ["--epochs", "2", "--teacherForcing"])
    model = trainer.model
    assert model.dtype == torch.bfloat16 and trainer.fine_tune_encoder and model.cfg.decoder == decoder
    assert all(p.dtype == torch.float32 for p in model.parameters())
    per_epoch = len(trainer.train_loader)
    assert [s[0] for s in steps] == [False] * per_epoch + [True] * per_epoch
    for train_encoder, changed, loss in steps:
        assert np.isfinite(loss) and changed == ({5, 6, 7} if train_encoder else set()), (train_encoder, changed)
    for opt in (trainer.state.dec_opt, trainer.state.enc_opt):
        assert all(v.dtype == torch.float32 for st in opt.state.values() for k, v in st.items() if k != "step")
    assert not saved["enc_opt"]["state"] and trainer.state.enc_opt.state_dict()["state"]
    rows = copy.deepcopy(trainer.results)
    assert len(rows) == 2 and all(np.isfinite(r["trainLoss"]) and np.isfinite(r["valLoss"]) for r in rows)
    with torch.inference_mode():
        assert model.encode(torch.zeros(1, 32, 32, 3, dtype=torch.uint8)).dtype == torch.bfloat16
    for d in (ckpt, f"BEST_{ckpt}"):
        with open(workdir / "checkpoints" / d / "meta.json") as f:
            assert json.load(f)["config"]["model"]["compute_dtype"] == "bfloat16", d

    # cli.caption on the BEST_ directory: the trainer's model's beam.
    best = workdir / "checkpoints" / f"BEST_{ckpt}"
    folder = write_images(workdir)
    word_map_path = workdir / "ds" / f"WORDMAP_{NAME}.json"
    capsys.readouterr()
    caption.main(["--img", str(folder), "--checkpoint", str(best), "--wordMap", str(word_map_path),
                  "--beamSize", "3", "--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()
    word_map = load_word_map(str(word_map_path))
    rev = {v: k for k, v in word_map.items()}
    paths = sorted(os.listdir(folder))
    imgs = torch.from_numpy(np.stack([caption.load_image(str(folder / p)) for p in paths]))
    with open(best / "meta.json") as f:
        best_epoch = json.load(f)["epoch"]
    ref = copy.deepcopy(model)  # the trainer's model, at the BEST_ copy's epoch
    ref.load_state_dict(saved["model"] if best_epoch == 0 else model.state_dict())
    res = beam_search_batch(ref, imgs, beam_size=3, max_steps=min(50, model.cfg.max_len - 2),
                            start_id=word_map["<start>"], end_id=word_map["<end>"])
    assert len(printed) == len(paths)
    for j, (path, line) in enumerate(zip(paths, printed)):
        words = [rev[int(i)] for i in res.sequence[j, : int(res.length[j])]]
        want = " ".join(w for w in words if w not in ("<start>", "<end>"))
        assert line == f"{path}: {want}  (score {float(res.score[j]):.3f})"
    row = cli_test.main(flags + ["--checkpoint", str(best)])
    assert np.isfinite(row["testLoss"]) and row["testLoss"] > 0

    # Resume from the epoch-0 checkpoint: both Adams bit for bit, then the same epoch 1.
    steps.clear()
    resumed = cli_train.main(flags + ["--epochs", "2", "--teacherForcing", "--checkpoint", str(workdir / "epoch0")])
    assert [s[0] for s in steps] == [True] * per_epoch
    strip = lambda r: {k: v for k, v in r.items() if k not in TIMES}  # noqa: E731
    assert strip(resumed.results[1]) == strip(rows[1]) and strip(resumed.results[0]) == strip(rows[0])
    assert_same(resumed.model.state_dict(), model.state_dict())
    assert_same(resumed.state.dec_opt.state_dict(), trainer.state.dec_opt.state_dict())
    assert_same(resumed.state.enc_opt.state_dict(), trainer.state.enc_opt.state_dict())


def test_bf16_resume_restores_both_adams(workdir, monkeypatch):  # noqa: F811
    """A Trainer built from the epoch-0 checkpoint of a bf16 run, before it
    runs: its model and both Adam states equal the saved ones, bit for bit."""
    monkeypatch.setattr(common, "TrainConfig", functools.partial(TrainConfig, fine_tune_epoch=0))
    saved = {}
    real_save = loop.save_checkpoint

    def save(directory, name, state, meta, is_best=False):
        base = real_save(directory, name, state, meta, is_best)
        shutil.copytree(base, workdir / "epoch0")
        saved.update(model=copy.deepcopy(state.model.state_dict()), dec_opt=copy.deepcopy(state.dec_opt.state_dict()),
                     enc_opt=copy.deepcopy(state.enc_opt.state_dict()))
        return base

    monkeypatch.setattr(loop, "save_checkpoint", save)
    cli_train.main(FLAGS + ["--epochs", "1", "--teacherForcing"])
    assert saved["enc_opt"]["state"] and saved["dec_opt"]["state"]  # the unlock at epoch 0: both Adams stepped
    monkeypatch.setattr(loop, "save_checkpoint", real_save)
    p = __import__("argparse").ArgumentParser()
    common.add_common_args(p)
    exp = common.config_from_args(p.parse_args(FLAGS + ["--checkpoint", str(workdir / "epoch0")]))
    resumed = loop.Trainer(exp, "ds", NAME, device="cpu", verbose=False)
    assert resumed.start_epoch == 1 and resumed.model.dtype == torch.bfloat16
    assert_same(resumed.model.state_dict(), saved["model"])
    assert_same(resumed.state.dec_opt.state_dict(), saved["dec_opt"])
    assert_same(resumed.state.enc_opt.state_dict(), saved["enc_opt"])
