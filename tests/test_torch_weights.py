"""Weight bridge round trip: the port's reference-format checkpoint goes
through the JAX package's ``port_reference_checkpoint`` into JAX params, and
``state_dict_from_jax`` brings them back unchanged (exact: both directions
only transpose and restack).  The port's own loader reads the same file."""

import numpy as np
import torch

from tests.test_torch_helpers import SMALL, to_numpy
from tpu_captioner.models.port_torch import port_reference_checkpoint
from tpu_captioner_torch.core.config import ModelConfig
from tpu_captioner_torch.models.from_jax import (
    load_reference_checkpoint,
    save_reference_checkpoint,
    state_dict_from_jax,
)
from tpu_captioner_torch.train.model import CaptionModel


def test_reference_checkpoint_round_trip(tmp_path):
    cfg = ModelConfig(**SMALL)
    model = CaptionModel(cfg, device="cpu", seed=11)
    path = str(tmp_path / "BEST_checkpoint_small.pth.tar")
    save_reference_checkpoint(model, path, epoch=3, bleu4=0.25)

    enc_p, dec_p, meta = port_reference_checkpoint(
        path, "transformer", num_layers=cfg.num_layers, depths=cfg.encoder_depths
    )
    assert meta["epoch"] == 3
    back = state_dict_from_jax(to_numpy({"encoder": enc_p, "decoder": dec_p}), cfg)
    want = model.state_dict()
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)

    other = CaptionModel(cfg, device="cpu", seed=12)
    assert load_reference_checkpoint(other, path)["bleu4"] == 0.25
    for k, v in want.items():
        assert torch.equal(other.state_dict()[k], v), k


def test_loader_strips_ddp_prefix(tmp_path):
    cfg = ModelConfig(**SMALL)
    model = CaptionModel(cfg, device="cpu", seed=5)
    path = str(tmp_path / "ddp.pth.tar")
    torch.save(
        {
            "epoch": 1,
            "encoder": model.encoder.state_dict(),
            "decoder": {f"module.{k}": v for k, v in model.decoder.state_dict().items()},
        },
        path,
    )
    other = CaptionModel(cfg, device="cpu", seed=6)
    load_reference_checkpoint(other, path)
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
