"""Reference checkpoints of the attention-capture Transformer decoder
(``transformer_attvis``), whose layers the reference saves as
``decoder_layers.N.*`` instead of ``transformer_decoder.layers.N.*``.

A small model (``tests/test_torch_helpers.py``'s ``SMALL`` with the attvis
family) is saved as a reference ``.pth.tar`` with its layer keys renamed the
attvis way.  The JAX package's ``port_reference_checkpoint`` and the port's
``load_reference_checkpoint`` both read it; the two models give the same
teacher-forced logits and attention maps on numpy-seeded images and
captions (atol 1e-4: the same f32 encoder and decoder in two frameworks,
as ``tests/test_torch_train_step.py`` holds them).  The port's
``cli/caption.py --decoder transformer_attvis`` then captions an image
with it on the CPU.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_helpers import END, SMALL, START, images, jax_model_and_params, port_model, t
from tpu_captioner.core.config import ModelConfig as JaxModelConfig
from tpu_captioner.models.port_torch import port_reference_checkpoint
from tpu_captioner.train.model import CaptionModel as JaxCaptionModel
from tpu_captioner_torch.core.config import ModelConfig
from tpu_captioner_torch.models.from_jax import load_reference_checkpoint, save_reference_checkpoint
from tpu_captioner_torch.train.model import CaptionModel

ATTVIS = dict(SMALL, decoder="transformer_attvis")
ATOL = 1e-4


@pytest.fixture(scope="module")
def attvis_checkpoint(tmp_path_factory):
    """The path of a ``decoder_layers.N.*`` checkpoint and the port model
    whose weights it holds."""
    model = port_model(jax_model_and_params(seed=7, decoder="transformer_attvis")[1], decoder="transformer_attvis")
    path = str(tmp_path_factory.mktemp("attvis") / "BEST_checkpoint_attvis.pth.tar")
    save_reference_checkpoint(model, path, epoch=4)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    ckpt["decoder"] = {k.replace("transformer_decoder.layers.", "decoder_layers."): v
                       for k, v in ckpt["decoder"].items()}
    assert any(k.startswith("decoder_layers.0.") for k in ckpt["decoder"])
    assert not any(k.startswith("transformer_decoder.") for k in ckpt["decoder"])
    torch.save(ckpt, path)
    return path, model


def test_attvis_checkpoint_loads_in_both_packages_with_equal_logits(attvis_checkpoint):
    path, saved = attvis_checkpoint
    cfg = ModelConfig(**ATTVIS)
    loaded = CaptionModel(cfg, device="cpu", seed=99)
    assert load_reference_checkpoint(loaded, path)["epoch"] == 4
    for k, v in saved.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k

    enc_p, dec_p, meta = port_reference_checkpoint(path, "transformer_attvis", num_layers=cfg.num_layers,
                                                   depths=cfg.encoder_depths)
    assert meta["epoch"] == 4
    jmodel, params = JaxCaptionModel(JaxModelConfig(**ATTVIS)), {"encoder": enc_p, "decoder": dec_p}
    imgs = images(2, seed=11)
    rng = np.random.default_rng(12)
    caps = rng.integers(1, START, (2, 9)).astype(np.int32)
    caps[:, 0], caps[0, -3:] = START, 0  # <start>, and padding on one row
    caps[0, -4], caps[1, -1] = END, END

    enc = jmodel.encode(params, jnp.asarray(imgs))
    want_logits, want_alphas = jmodel.tf_forward(params, enc, jnp.asarray(caps))
    with torch.no_grad():
        got_logits, got_alphas = loaded.tf_forward(loaded.encode(t(imgs)), torch.from_numpy(caps).long())
    assert got_alphas is not None and want_alphas is not None
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=ATOL)
    np.testing.assert_allclose(got_alphas.numpy(), np.asarray(want_alphas), atol=ATOL)


def test_caption_cli_runs_on_an_attvis_checkpoint(attvis_checkpoint, tmp_path, monkeypatch, capsys):
    """``python -m tpu_captioner_torch.cli.caption --decoder transformer_attvis``
    on the CPU: the checkpoint loads and an image gets a caption."""
    from PIL import Image

    from tpu_captioner_torch.cli import caption
    from tpu_captioner_torch.core import config

    path, _ = attvis_checkpoint
    img = tmp_path / "one.png"
    Image.fromarray(images(1, seed=3)[0]).save(img)
    word_map = {f"w{i}": i for i in range(START)}
    word_map.update({"<start>": START, "<end>": END})
    wm = tmp_path / "wordmap.json"
    wm.write_text(json.dumps(word_map))
    # The CLI builds ModelConfig's full widths; here the small ones.
    monkeypatch.setattr(config, "ModelConfig", lambda **kw: ModelConfig(**{**ATTVIS, **kw}))
    out_csv = tmp_path / "captions.csv"
    caption.main(["--img", str(img), "--checkpoint", path, "--wordMap", str(wm), "--beamSize", "3",
                  "--decoder", "transformer_attvis", "--device", "cpu", "--csv", str(out_csv)])
    assert capsys.readouterr().out.startswith("one.png: ")
    rows = out_csv.read_text().splitlines()
    assert rows[0] == "imageFile,generatedCaption" and rows[1].startswith("one.png,")
