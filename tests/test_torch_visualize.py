"""The attention visualiser and ``cli.caption --out`` against the JAX
package, on the CPU.

- ``upsample_alpha`` equals JAX's bit for bit, smoothed and not.
- ``visualize_att`` returns JAX's words and writes a PNG whose pixels
  (``matplotlib.image.imread``) equal those of JAX's for the same image,
  sequence and maps, from an array and from a file, past the 50-word cap.
- ``cli.caption.main([..., "--out", ..., "--device", "cpu"])`` on a tiny
  ``save_checkpoint`` directory, whose weights are JAX's parameters bridged
  through ``models/from_jax.py``, and one PNG written with PIL, draws the
  grid of the one-image beam, for ``transformer`` and ``lstm``: its
  sequence equals JAX ``beam_search``'s on the same image (the JAX CLI's
  one-image path) and its maps are within 1e-5 (softmaxes after a ConvNeXt
  and a decoder in two frameworks, float noise ~1e-7).  The grid equals
  the one ``visualize_att`` draws of what the beam returned; ``--dont_smooth``
  draws another.  A directory of images draws nothing.
"""

import dataclasses
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_helpers import SMALL, jax_model_and_params, port_model
from tpu_captioner.infer.beam import beam_search as jax_beam_search
from tpu_captioner.infer.visualize import upsample_alpha as jax_upsample
from tpu_captioner.infer.visualize import visualize_att as jax_visualize
from tpu_captioner_torch.cli import caption
from tpu_captioner_torch.core.config import ExperimentConfig, TrainConfig
from tpu_captioner_torch.infer import visualize
from tpu_captioner_torch.train.checkpoint import save_checkpoint
from tpu_captioner_torch.train.state import TrainState

START, END = 55, 56  # of SMALL's vocab 57
REV = {**{i: f"w{i}" for i in range(55)}, START: "<start>", END: "<end>"}
# The CLI's word map: "<end>" on a token the random weights pick late (the
# Transformer's beam ends on it at 10 tokens, the LSTM's runs to the cap).
CLI_END = 30
CLI_REV = {**REV, CLI_END: "<end>", END: "w30"}
ALPHA_TOL = 1e-5


def imread(path):
    import matplotlib.image

    return matplotlib.image.imread(str(path))


def maps(rng, n, p=49):
    a = rng.random((n, p)).astype(np.float32)
    return a / a.sum(-1, keepdims=True)


@pytest.mark.parametrize("smooth", [True, False])
def test_upsample_alpha_is_jax_bit_for_bit(smooth):
    rng = np.random.default_rng(0)
    for shape in ((7, 7), (2, 2)):
        a = rng.random(shape).astype(np.float32)
        got, want = visualize.upsample_alpha(a, smooth=smooth), jax_upsample(a, smooth=smooth)
        assert got.dtype == want.dtype and got.shape == (24 * shape[0],) * 2
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_words,from_file", [(4, False), (9, True), (53, False)])
def test_visualize_att_draws_jax_pixels(tmp_path, n_words, from_file):
    from PIL import Image

    rng = np.random.default_rng(n_words)
    img = rng.integers(0, 256, (64, 48, 3), dtype=np.uint8)
    if from_file:
        Image.fromarray(img).save(tmp_path / "img.png")
        img = str(tmp_path / "img.png")
    seq = [START] + [int(w) for w in rng.integers(0, 55, n_words - 2)] + [END]
    alphas = maps(rng, n_words)
    got = visualize.visualize_att(img, seq, alphas, REV, out_path=str(tmp_path / "port.png"))
    want = jax_visualize(img, seq, alphas, REV, out_path=str(tmp_path / "jax.png"))
    assert got == want == [REV[w] for w in seq]
    a, b = imread(tmp_path / "port.png"), imread(tmp_path / "jax.png")
    assert a.shape == b.shape and a.shape[0] > 100
    np.testing.assert_array_equal(a, b)


def write_checkpoint(d, params, **kw):
    """A ``save_checkpoint`` directory of the port's model of SMALL with
    ``kw`` holding ``params``, and the word map of SMALL's vocabulary."""
    model = port_model(params, **kw)
    exp = ExperimentConfig(model=model.cfg, train=TrainConfig())
    save_checkpoint(str(d), "ckpt", TrainState.create(model, exp.train), {"config": dataclasses.asdict(exp)})
    with open(d / "wordmap.json", "w") as f:
        json.dump({w: i for i, w in CLI_REV.items()}, f)
    return d / "ckpt", d / "wordmap.json"


@pytest.fixture(scope="module", params=["transformer", "lstm"])
def one_image(request, tmp_path_factory):
    """JAX's weights of SMALL with the family at 7x7 maps, the port's
    checkpoint of them, one PNG written with PIL, and JAX ``beam_search``'s
    result on it."""
    from PIL import Image

    kind = request.param
    d = tmp_path_factory.mktemp(f"viz_{kind}")
    kw = dict(decoder=kind, attention_dim=20, encoded_image_size=7)
    jmodel, params = jax_model_and_params(seed=4, use_pallas="off", decode_kernel="off", **kw)
    ckpt, wm = write_checkpoint(d, params, **kw)
    Image.fromarray(np.random.default_rng(11).integers(0, 256, (90, 120, 3), dtype=np.uint8)).save(d / "one.png")
    image = caption.load_image(str(d / "one.png"))
    res = jax_beam_search(jmodel, params, jnp.asarray(image), beam_size=3, max_steps=min(50, SMALL["max_len"] - 2),
                          start_id=START, end_id=CLI_END)
    n = int(res.length)
    return d, ckpt, wm, image, np.asarray(res.sequence)[:n], np.asarray(res.alphas)[:n]


def test_caption_out_draws_the_one_image_beam_as_jax(one_image, monkeypatch, capsys):
    d, ckpt, wm, image, want_seq, want_alphas = one_image
    drawn = []
    real = visualize.visualize_att

    def recording(*a, **k):
        drawn.append((a, k))
        return real(*a, **k)

    monkeypatch.setattr(visualize, "visualize_att", recording)
    args = ["--img", str(d / "one.png"), "--checkpoint", str(ckpt), "--wordMap", str(wm), "--beamSize", "3",
            "--device", "cpu"]
    caption.main(args + ["--out", str(d / "att.png")])
    (((img, seq, alphas, rev), kw),) = drawn
    np.testing.assert_array_equal(img, image)
    assert kw == {"smooth": True, "enc_image_size": 7, "out_path": str(d / "att.png")} and rev == CLI_REV
    np.testing.assert_array_equal(seq, want_seq)
    assert alphas.dtype == np.float32 and alphas.shape == want_alphas.shape == (len(want_seq), 49)
    np.testing.assert_allclose(alphas, want_alphas, rtol=0, atol=ALPHA_TOL)
    assert len(want_seq) > 4
    assert "\nCaption: " + " ".join(CLI_REV[int(w)] for w in want_seq) + "\n" in capsys.readouterr().out

    real(image, seq, alphas, CLI_REV, out_path=str(d / "again.png"))
    grid = imread(d / "att.png")
    np.testing.assert_array_equal(grid, imread(d / "again.png"))
    rows = int(np.ceil(len(want_seq) / 5))
    assert grid.shape[0] > 150 * rows and grid.shape[1] > 600

    caption.main(args + ["--out", str(d / "sharp.png"), "--dont_smooth"])
    assert drawn[-1][1]["smooth"] is False
    assert not np.array_equal(imread(d / "sharp.png"), grid)


def test_a_directory_draws_nothing(one_image, monkeypatch):
    d, ckpt, wm, *_ = one_image
    folder = d / "dir"
    folder.mkdir(exist_ok=True)
    for name in ("a.png", "b.png"):
        shutil.copy(d / "one.png", folder / name)
    monkeypatch.setattr(visualize, "visualize_att", lambda *a, **k: pytest.fail("drew a directory"))
    caption.main(["--img", str(folder), "--checkpoint", str(ckpt), "--wordMap", str(wm), "--beamSize", "3",
                  "--device", "cpu", "--out", str(d / "dir.png")])
    assert not (d / "dir.png").exists()
