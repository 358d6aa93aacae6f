"""``cli.caption`` on the port's own training checkpoints (the directories of
``train/checkpoint.py:save_checkpoint``), as the JAX CLI takes its own: a
tiny Transformer trained for one epoch by the ``Trainer`` on the CPU, then
``cli.caption.main(--device cpu)`` on its ``BEST_`` directory must print the
captions that ``beam_search_batch`` gives on the trainer's model (the same
weights, rebuilt from ``meta.json``).  A directory whose ``meta.json`` says
bfloat16 builds a bf16 model, as ``compute_dtype`` comes from the
checkpoint; ``--usePallas`` overrides the directory's kernel setting only
when it is given; anything else is refused."""

import argparse
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tpu_captioner_torch.cli import caption
from tpu_captioner_torch.core.config import ExperimentConfig, ModelConfig, TrainConfig
from tpu_captioner_torch.data.build import build_synthetic_dataset
from tpu_captioner_torch.data.vocab import load_word_map
from tpu_captioner_torch.infer.beam import beam_search_batch
from tpu_captioner_torch.train import loop
from tpu_captioner_torch.train.checkpoint import META_FILE, checkpoint_name, save_checkpoint
from tpu_captioner_torch.train.state import TrainState

BASE = "synthetic_5_cap_per_img_1_min_word_freq"
MAXLEN = 12
TINY = dict(embed_dim=16, decoder_dim=20, num_heads=4, num_layers=2, max_len=MAXLEN + 2, encoder_depths=(1, 1, 1, 1),
            encoder_dims=(8, 12, 16, 24), encoder_dim=24, encoded_image_size=2, use_pallas=("mlp", "mlp", "off", "mlp"))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("caption_ckpt")
    build_synthetic_dataset(str(d / "data"), num_images={"TRAIN": 8, "VAL": 4, "TEST": 4}, max_len=MAXLEN,
                            image_size=32, learnable=True)
    exp = ExperimentConfig(model=ModelConfig(**TINY), train=TrainConfig(
        epochs=1, batch_size=4, max_decode_len=MAXLEN + 1, print_freq=1000, checkpoint_dir=str(d / "ckpt"),
        results_dir=str(d / "results")))
    trainer = loop.Trainer(exp, str(d / "data"), BASE, device="cpu", verbose=False)
    trainer.run()
    best = d / "ckpt" / f"BEST_{checkpoint_name(BASE, False, 5, 1e-4, None)}"
    assert sorted(os.listdir(best)) == ["meta.json", "state.pt"]
    return d, trainer, best


def write_images(d, n=3):
    from PIL import Image

    folder = d / "images"
    folder.mkdir(exist_ok=True)
    rng = np.random.default_rng(5)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(folder / f"img{i}.png")
    return folder


def test_caption_cli_loads_a_training_checkpoint(trained, capsys):
    d, trainer, best = trained
    folder = write_images(d)
    word_map_path = d / "data" / f"WORDMAP_{BASE}.json"
    caption.main(["--img", str(folder), "--checkpoint", str(best), "--wordMap", str(word_map_path),
                  "--beamSize", "3", "--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()

    word_map = load_word_map(str(word_map_path))
    rev = {v: k for k, v in word_map.items()}
    paths = sorted(os.listdir(folder))
    imgs = torch.from_numpy(np.stack([caption.load_image(str(folder / p)) for p in paths]))
    model = trainer.model
    res = beam_search_batch(model, imgs, beam_size=3, max_steps=min(50, model.cfg.max_len - 2),
                            start_id=word_map["<start>"], end_id=word_map["<end>"])
    assert len(printed) == len(paths)
    for j, (path, line) in enumerate(zip(paths, printed)):
        words = [rev[int(i)] for i in res.sequence[j, : int(res.length[j])]]
        want = " ".join(w for w in words if w not in ("<start>", "<end>"))
        assert line == f"{path}: {want}  (score {float(res.score[j]):.3f})"


def test_the_checkpoint_gives_the_model_its_config(trained, tmp_path):
    d, trainer, best = trained
    word_map = load_word_map(str(d / "data" / f"WORDMAP_{BASE}.json"))
    args = argparse.Namespace(checkpoint=str(best), device="cpu", seed=3)
    model = caption.build_model_and_params(args, word_map)
    assert model.cfg.use_pallas == TINY["use_pallas"] and model.cfg.vocab_size == len(word_map)
    assert model.cfg.compute_dtype == "float32" and model.dtype == torch.float32
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    assert caption.build_model_and_params(argparse.Namespace(**vars(args), usePallas="off"), word_map).cfg \
        .use_pallas == "off"

    # A bf16 training run's directory captions in bf16.
    cfg = dataclasses.replace(trainer.exp.model, compute_dtype="bfloat16")
    meta = {"epoch": 0, "config": dataclasses.asdict(ExperimentConfig(model=cfg, train=TrainConfig()))}
    bf16_dir = save_checkpoint(str(tmp_path), "bf16", TrainState.create(trainer.model, TrainConfig()), meta)
    with open(os.path.join(bf16_dir, META_FILE)) as f:
        assert json.load(f)["config"]["model"]["compute_dtype"] == "bfloat16"
    bf16 = caption.build_model_and_params(argparse.Namespace(checkpoint=bf16_dir, device="cpu", seed=0), word_map)
    assert bf16.cfg.compute_dtype == "bfloat16" and bf16.dtype == torch.bfloat16
    with torch.inference_mode():
        assert bf16.encode(torch.zeros(1, 32, 32, 3, dtype=torch.uint8)).dtype == torch.bfloat16

    with pytest.raises(ValueError, match="neither a checkpoint directory"):
        caption.build_model_and_params(argparse.Namespace(checkpoint=str(tmp_path / "x.ckpt"), device="cpu",
                                                          seed=0), word_map)


def test_cli_test_evaluates_in_bf16_and_training_refuses(trained, tmp_path, monkeypatch, capsys):
    """``cli.test --computeDtype bfloat16`` builds a bf16 model through the
    ``Trainer`` and evaluates the TEST split greedily (the eval step's
    ``'step'`` mode, the decode kernel's bf16 arm).  The same Trainer, which
    refused to train before bf16 training was ported (ROADMAP.md Queue 1
    #5b), now trains: one bf16 epoch, a finite loss, a checkpoint whose
    ``meta.json`` says bfloat16."""
    from tpu_captioner_torch.cli import test as cli_test

    d, _, _ = trained
    monkeypatch.chdir(tmp_path)
    flags = ["--dataFolder", str(d / "data"), "--dataName", BASE, "--embedDim", "16", "--decoderDim", "20",
             "--numHeads", "4", "--numLayers", "2", "--maxLen", str(MAXLEN + 2), "--encoderDepths", "1,1,1,1",
             "--encoderDims", "8,12,16,24", "--encodedImageSize", "2", "--batchSize", "4", "--device", "cpu",
             "--computeDtype", "bfloat16"]
    row = cli_test.main(flags)
    assert row["testLoss"] > 0 and np.isfinite(row["testLoss"])
    assert os.path.exists(tmp_path / "results" / "test-transformer-Finetuning5-None.csv")
    from tpu_captioner_torch.cli.common import add_common_args, config_from_args

    p = argparse.ArgumentParser()
    add_common_args(p)
    exp = config_from_args(p.parse_args(flags))
    exp.train.epochs, exp.train.checkpoint_dir = 1, str(tmp_path / "ckpt")
    trainer = loop.Trainer(exp, str(d / "data"), BASE, device="cpu", verbose=False)
    assert trainer.model.dtype == torch.bfloat16
    (row,) = trainer.run()
    assert np.isfinite(row["trainLoss"]) and np.isfinite(row["valLoss"])
    with open(tmp_path / "ckpt" / trainer.checkpoint_name() / META_FILE) as f:
        assert json.load(f)["config"]["model"]["compute_dtype"] == "bfloat16"
