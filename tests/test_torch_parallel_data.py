"""The data-parallel plumbing of the port on the CPU: a rank's rows of every
global batch against the JAX package's ``iterate_batches(shard=)`` (pure
numpy, no JAX step); the collectives over two gloo processes; the dry run
of every path on two ranks; a failed rank failing the run; the native
library built before the first batch; and the kernel wrappers' refusal of
tensors off the current CUDA device (the comparison runs on the CPU with
the current device given)."""

import inspect
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.torch_parallel_workers import collectives_rank, failing_rank, torchrun_rank
from tpu_captioner_torch.data import build, dataset
from tpu_captioner_torch.parallel import collectives
from tpu_captioner_torch.parallel.dryrun import PATHS, dryrun_multichip
from tpu_captioner_torch.parallel.mesh import Mesh, spawn

BASE = "synthetic_5_cap_per_img_1_min_word_freq"


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("records")
    build.build_synthetic_dataset(str(d), num_images={"TRAIN": 7, "VAL": 3, "TEST": 2}, max_len=12, image_size=16,
                                  seed_=2)
    return str(d)


@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2), (3, 4)])
def test_shard_rows_match_jax(records, shard):
    """35 captions in global batches of 8: four whole batches, then 3 rows
    and 5 of padding, of which each shard flags its own."""
    from tpu_captioner.data import dataset as jax_dataset

    ds, jds = dataset.CaptionDataset(records, BASE, "TRAIN"), jax_dataset.CaptionDataset(records, BASE, "TRAIN")
    got = list(dataset.iterate_batches(ds, 8, epoch=1, seed=5, shard=shard))
    want = list(jax_dataset.iterate_batches(jds, 8, epoch=1, seed=5, shard=shard))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for k, v in w.as_dict().items():
            np.testing.assert_array_equal(g.as_dict()[k], v, err_msg=k)
            assert g.as_dict()[k].dtype == v.dtype, k
    per = 8 // shard[1]
    assert int(got[-1].valid.sum()) == max(0, min(per, 3 - shard[0] * per))
    with pytest.raises(ValueError, match="not divisible"):
        next(dataset.iterate_batches(ds, 10, shard=(0, 4)))


def test_collectives_in_rank_order(tmp_path):
    """Two gloo ranks: the eval outputs gathered in rank order with their
    dtypes, rank 0's scalar, the sums; without a group each is the
    identity."""
    spawn(collectives_rank, 2, "cpu", args=(str(tmp_path),))
    for r in range(2):
        with np.load(tmp_path / f"rank{r}.npz") as f:
            seqs, lengths, caps, valid = (f[f"arr_{i}"] for i in range(4))
            np.testing.assert_array_equal(seqs, [[0, 1, 2], [0, 1, 2], [10, 11, 12], [10, 11, 12]])
            assert seqs.dtype == np.int32 and caps.dtype == np.int32 and valid.dtype == bool
            np.testing.assert_array_equal(lengths, [1, 2, 2, 3])
            np.testing.assert_array_equal(caps[:, 0, 0], [0, 0, 1, 1])
            np.testing.assert_array_equal(valid, [True, True, True, False])
            assert float(f["scalar"]) == 0.25 and f["summed"].tolist() == [2.0, 1.0]
            assert f["grad"].tolist() == [3.0, 3.0, 3.0]
            assert bool(f["multi"]) and bool(f["coordinator"]) == (r == 0)
    alone = Mesh(1, 0, torch.device("cpu"))
    arrays = (np.arange(3), np.ones(1), np.zeros((1, 2)), np.ones(1, bool))
    assert collectives.gather_eval_outputs(*arrays, alone) == arrays
    assert collectives.broadcast_scalar(0.5, None) == 0.5 and collectives.is_coordinator(None)
    t = torch.ones(2)
    assert collectives.all_reduce_sum(t, alone) is t and t.tolist() == [1.0, 1.0]


def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    """``dryrun_multichip(2, "cpu")``: every path on each rank's rows of one
    global batch, a finite global value for each, the ranks' weights equal
    after the steps, one printed line per path."""
    out = dryrun_multichip(2, "cpu")
    assert list(out) == list(PATHS) and all(np.isfinite(v) for v in out.values())
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(": ")[1] for ln in lines if ln.startswith("dryrun_multichip(2)")] == list(PATHS)


def test_torchrun_environment_joins_the_group():
    """Two processes given only ``torchrun``'s environment (a localhost
    rendezvous) join one group, as ``cli.train`` does under ``torchrun``;
    a process without it stays alone."""
    import socket

    import torch.multiprocessing as mp

    from tpu_captioner_torch.parallel.mesh import maybe_initialize_distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(torchrun_rank, args=(port,), nprocs=2, join=True)
    assert "WORLD_SIZE" not in os.environ and not maybe_initialize_distributed("cpu")


def test_a_failed_rank_fails_the_run():
    """A rank that raises ends the run: the error raised is its own or its
    peer's, whose collective lost it (which one the launcher sees first
    varies); nothing is caught."""
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="fails on purpose|Connection (closed|reset) by peer"):
        spawn(failing_rank, 2, "cpu")


def test_native_library_is_built_before_the_first_batch(records, monkeypatch, tmp_path):
    """Opening the memmapped records builds (or loads) the native library,
    and so does building the Trainer: no batch's ``data_time`` holds the
    compile, and no rank compiles at its first batch."""
    from tpu_captioner_torch.core.config import ExperimentConfig, ModelConfig, TrainConfig
    from tpu_captioner_torch.native import gather, lib
    from tpu_captioner_torch.train import loop

    gathered = []
    monkeypatch.setattr(dataset, "gather_batch_native", lambda *a: gathered.append(a) or gather.gather_batch_native(*a))
    lib.get_lib.cache_clear()
    ds = dataset.CaptionDataset(records, BASE, "TRAIN")
    assert lib.get_lib.cache_info().currsize == 1 and not gathered
    ds.gather(np.arange(2))
    assert len(gathered) == 1

    lib.get_lib.cache_clear()
    monkeypatch.setattr(loop, "CaptionDataset", lambda *a: SimpleNamespace())  # no records opened
    tiny = ModelConfig(embed_dim=16, decoder_dim=20, num_heads=4, num_layers=2, max_len=14, encoder_dim=24,
                       encoder_depths=(1, 1, 1, 1), encoder_dims=(8, 12, 16, 24))
    exp = ExperimentConfig(model=tiny, train=TrainConfig(batch_size=4, checkpoint_dir=str(tmp_path / "c")))
    loop.Trainer(exp, records, BASE, device="cpu", verbose=False)
    assert lib.get_lib.cache_info().currsize == 1


WRAPPERS = ("mlp_block:_mlp_forward", "mlp_block:fused_convnext_mlp_bwd", "dwconv:dwconv_forward",
            "dwconv:dwconv_filter_grad", "block_fused:_block_forward", "decode_step:fused_decode_step",
            "decode_step:fused_full_rollout", "lstm_step:fused_lstm_step", "dropout_mask:random_mask_pool")


def test_kernel_wrappers_refuse_tensors_off_the_current_device():
    """``ops/_build.py:require_current_device``: a CUDA tensor on another card
    than the current one raises ValueError; the current card's and the
    CPU's pass; every kernel wrapper calls it before it launches."""
    import importlib

    from tpu_captioner_torch.ops import _build

    on = lambda *devices: [SimpleNamespace(device=torch.device(d)) for d in devices]  # noqa: E731
    _build.require_current_device("k", on("cuda:1", "cuda:1", "cpu"), current=1)
    _build.require_current_device("k", on("cpu"), current=None)  # never asks the runtime
    for devices, current in ((("cuda:1",), 0), (("cuda:0", "cuda:1"), 0), (("cuda:0",), 3)):
        with pytest.raises(ValueError, match="current device is cuda:"):
            _build.require_current_device("k", on(*devices), current=current)
    for entry in WRAPPERS:
        module, name = entry.split(":")
        fn = getattr(importlib.import_module(f"tpu_captioner_torch.ops.{module}"), name)
        source = inspect.getsource(inspect.unwrap(fn))
        call, launch = source.find("_build.require_current_device("), source.find("_build.check(lib")
        assert 0 < call < launch, entry
