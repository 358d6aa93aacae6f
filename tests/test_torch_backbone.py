"""The ``.npz`` backbone on the CPU: ``build_data port-backbone`` against the
JAX package's ``convert_backbone_to_npz``, and the Trainer's
``pretrained_encoder`` from the ``.npz`` against the ``.pth`` it came from
and against JAX's ``load_pretrained_backbone`` bridged into the port.

A tiny torchvision-keyed state dict (``features.*`` from a seeded port
encoder, plus a classifier the loaders drop) wrapped under ``state_dict``,
as torchvision checkpoints often are.  Everything is held bit for bit: the
arrays are copied, never computed.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_helpers import to_numpy
from tpu_captioner.models.port_torch import convert_backbone_to_npz as jax_convert
from tpu_captioner.models.port_torch import load_pretrained_backbone
from tpu_captioner_torch.cli import build_data
from tpu_captioner_torch.core.config import ExperimentConfig, ModelConfig, TrainConfig
from tpu_captioner_torch.data.build import build_synthetic_dataset
from tpu_captioner_torch.models.from_jax import _encoder_from_jax
from tpu_captioner_torch.train import loop
from tpu_captioner_torch.train.model import CaptionModel

BASE = "synthetic_5_cap_per_img_1_min_word_freq"
TINY = dict(embed_dim=16, decoder_dim=20, num_heads=4, num_layers=1, max_len=12, encoder_dim=24,
            encoder_depths=(1, 1, 1, 1), encoder_dims=(8, 12, 16, 24))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("backbone")
    build_synthetic_dataset(str(d / "data"), num_images={"TRAIN": 4, "VAL": 2, "TEST": 2}, max_len=10,
                            image_size=32)
    donor = CaptionModel(ModelConfig(vocab_size=5, **TINY), device="cpu", seed=9)
    sd = {"features." + k[len("convnext."):]: v for k, v in donor.encoder.state_dict().items()}
    sd["classifier.2.weight"] = torch.arange(72, dtype=torch.float32).reshape(3, 24)
    torch.save({"state_dict": sd}, d / "convnext.pth")
    return d, donor


def trainer(d, pretrained, **model_kw):
    exp = ExperimentConfig(model=ModelConfig(pretrained_encoder=str(pretrained), **{**TINY, **model_kw}),
                           train=TrainConfig(batch_size=4, checkpoint_dir=str(d / "ckpt"), results_dir=str(d / "res")))
    return loop.Trainer(exp, str(d / "data"), BASE, device="cpu", verbose=False)


def test_port_backbone_writes_what_jax_writes(files):
    d, _ = files
    build_data.main(["port-backbone", "--src", str(d / "convnext.pth"), "--out", str(d / "port.npz")])
    jax_convert(str(d / "convnext.pth"), str(d / "jax.npz"))
    with np.load(d / "port.npz") as got, np.load(d / "jax.npz") as want:
        assert got.files == want.files and "classifier.2.weight" in got.files
        assert any(k.startswith("features.") for k in got.files)
        for k in got.files:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k])


def test_trainer_from_npz_equals_trainer_from_pth_and_jax(files):
    d, donor = files
    build_data.main(["port-backbone", "--src", str(d / "convnext.pth"), "--out", str(d / "backbone.npz")])
    from_npz = trainer(d, d / "backbone.npz").model.encoder.state_dict()
    from_pth = trainer(d, d / "convnext.pth").model.encoder.state_dict()
    want = donor.encoder.state_dict()
    jax_tree = load_pretrained_backbone(str(d / "backbone.npz"), depths=TINY["encoder_depths"])
    bridged = _encoder_from_jax({"convnext": to_numpy(jax_tree)}, TINY["encoder_depths"])
    assert set(from_npz) == set(from_pth) == set(want) == set(bridged)
    for k, v in from_npz.items():
        assert v.dtype == torch.float32
        assert torch.equal(v, from_pth[k]) and torch.equal(v, want[k]) and torch.equal(v, bridged[k]), k


def test_a_wrong_depth_npz_raises_at_start_up(files):
    d, _ = files
    build_data.main(["port-backbone", "--src", str(d / "convnext.pth"), "--out", str(d / "shallow.npz")])
    with pytest.raises(ValueError, match="does not match the configured backbone"):
        trainer(d, d / "shallow.npz", encoder_depths=(1, 1, 2, 1))
    with pytest.raises(ValueError, match="does not match the configured backbone"):
        trainer(d, d / "shallow.npz", encoder_dims=(8, 12, 16, 32), encoder_dim=32)
    np.savez(d / "bare.npz", **{k[len("features."):]: v for k, v in np.load(d / "shallow.npz").items()
                                if k.startswith("features.")})
    # A bare features dict, without the prefix, loads as the prefixed one.
    got = trainer(d, d / "bare.npz").model.encoder.state_dict()
    assert all(torch.equal(v, files[1].encoder.state_dict()[k]) for k, v in got.items())
