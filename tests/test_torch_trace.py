"""The Trainer's trace window (``Trainer(profile_dir=)``, the JAX Trainer's
``jax.profiler`` window) on the CPU, at tiny widths.

- With ``profile_dir`` set, steps 2-6 of the first epoch this Trainer runs
  are traced into one Chrome-trace JSON file: it parses, holds one
  ``ProfilerStep#i`` span per traced step and the host's operator events
  inside them (the decoder's ``Adam.step`` once a step), and nothing is
  traced in later epochs; without it nothing is written.
- A resumed Trainer traces its own first epoch (the one after the
  checkpoint's), as JAX's ``epoch == start_epoch``.
- An epoch shorter than the window is traced to its last step, and the
  trace is still stopped and written.
- Tracing leaves the results alone: the epoch rows of a traced run equal an
  untraced run's (losses, top-5 and BLEU within 1e-6; the host-clock times
  aside).
"""

import json
import os

import pytest

from tpu_captioner_torch.core.config import ExperimentConfig, ModelConfig, TrainConfig
from tpu_captioner_torch.data.build import build_synthetic_dataset
from tpu_captioner_torch.train import loop
from tpu_captioner_torch.train.checkpoint import checkpoint_name

BASE = "synthetic_5_cap_per_img_1_min_word_freq"
MAXLEN = 10
TINY = dict(embed_dim=16, decoder_dim=20, num_heads=4, num_layers=1, max_len=MAXLEN + 2, encoder_dim=24,
            encoder_depths=(1, 1, 1, 1), encoder_dims=(8, 12, 16, 24), encoded_image_size=2)
TIMES = ("trainBatchTime", "trainDataTime")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two datasets: 10 train steps an epoch at batch 8, and 5."""
    d = tmp_path_factory.mktemp("trace_data")
    for name, n in (("ten", 16), ("five", 8)):
        build_synthetic_dataset(str(d / name), num_images={"TRAIN": n, "VAL": 4, "TEST": 4}, max_len=MAXLEN,
                                image_size=32, learnable=True)
    return d


def run(data_dir, tmp, epochs=1, profile=True, checkpoint=None):
    exp = ExperimentConfig(model=ModelConfig(**TINY), train=TrainConfig(
        epochs=epochs, batch_size=8, max_decode_len=MAXLEN + 1, print_freq=1000, checkpoint=checkpoint,
        checkpoint_dir=str(tmp / "ckpt"), results_dir=str(tmp / "results")))
    trainer = loop.Trainer(exp, str(data_dir), BASE, device="cpu", verbose=False,
                           profile_dir=str(tmp / "trace") if profile else None)
    return trainer, trainer.run()


def read_trace(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation" and e["name"].startswith("ProfilerStep#")]
    steps = sorted(e["name"] for e in spans)
    lo, hi = min(e["ts"] for e in spans), max(e["ts"] + e["dur"] for e in spans)
    ops = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation") and lo <= e["ts"] <= hi]
    return steps, ops


def rows_without_times(rows):
    return [{k: v for k, v in r.items() if k not in TIMES} for r in rows]


def test_trace_holds_steps_2_to_6_and_leaves_the_rows_alone(data, tmp_path):
    traced, rows = run(data / "ten", tmp_path / "traced", epochs=2)
    assert os.listdir(tmp_path / "traced" / "trace") == ["trace_epoch0_steps2-6.pt.trace.json"]
    steps, ops = read_trace(tmp_path / "traced" / "trace" / "trace_epoch0_steps2-6.pt.trace.json")
    assert steps == [f"ProfilerStep#{i}" for i in range(2, 7)]
    assert len(ops) > 100 and any(e["name"].startswith("aten::") for e in ops)
    assert sum(e["name"] == "Optimizer.step#Adam.step" for e in ops) == 5  # the decoder's Adam, once a step

    _, plain_rows = run(data / "ten", tmp_path / "plain", epochs=2, profile=False)
    assert not os.path.exists(tmp_path / "plain" / "trace")
    assert len(rows) == len(plain_rows) == 2
    for got, want in zip(rows_without_times(rows), rows_without_times(plain_rows)):
        assert set(got) == set(want)
        for k in got:
            assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-6), k


def test_a_resumed_trainer_traces_its_own_first_epoch(data, tmp_path):
    run(data / "ten", tmp_path / "first", profile=False)
    ckpt = tmp_path / "first" / "ckpt" / checkpoint_name(BASE, False, 5, 1e-4, None)
    resumed, rows = run(data / "ten", tmp_path / "resumed", epochs=2, checkpoint=str(ckpt))
    assert resumed.start_epoch == 1 and [r["epoch"] for r in rows] == [0, 1]
    assert os.listdir(tmp_path / "resumed" / "trace") == ["trace_epoch1_steps2-6.pt.trace.json"]
    steps, _ = read_trace(tmp_path / "resumed" / "trace" / "trace_epoch1_steps2-6.pt.trace.json")
    assert steps == [f"ProfilerStep#{i}" for i in range(2, 7)]


def test_an_epoch_shorter_than_the_window_is_traced_to_its_end(data, tmp_path):
    trainer, _ = run(data / "five", tmp_path)
    assert len(trainer.train_loader) == 5
    assert os.listdir(tmp_path / "trace") == ["trace_epoch0_steps2-4.pt.trace.json"]
    steps, ops = read_trace(tmp_path / "trace" / "trace_epoch0_steps2-4.pt.trace.json")
    assert steps == ["ProfilerStep#2", "ProfilerStep#3", "ProfilerStep#4"] and ops
