"""Rank functions of the data-parallel tests (``tests/test_torch_parallel*.py``).

``torch.multiprocessing.spawn`` starts each rank in a new interpreter that
imports its function by name, so they live here, in a module that imports
torch and the port only (no JAX).  Each takes the rank's ``Mesh`` first.
"""

import os

import numpy as np
import torch

from tpu_captioner_torch.core import prng
from tpu_captioner_torch.core.config import ModelConfig, TrainConfig
from tpu_captioner_torch.parallel.dryrun import rank_rows, replicas_agree
from tpu_captioner_torch.train.model import CaptionModel
from tpu_captioner_torch.train.state import TrainState
from tpu_captioner_torch.train.steps import make_train_step

KINDS = ("frozen", "fine_tune", "free_running")


def stochastic_depth_off(model):
    """Both train encodes without their stochastic-depth draw (the JAX
    comparison's ``deterministic`` encoder)."""
    model.encode = lambda images_u8, train=False, generator=None: CaptionModel.encode(model, images_u8)
    model.encode_fine_tune = lambda images_u8, starting_layer, generator=None: (
        CaptionModel.encode_fine_tune(model, images_u8, starting_layer)
    )


def run_steps(spec, mesh=None):
    """``spec['steps']`` steps of each kind in ``spec['kinds']``, each from
    ``spec['state_dict']``, on ``mesh``'s rows of ``spec['batch']`` (every
    row without a mesh).  Returns {kind: {"metrics": per step, "grads": per
    step (the clamped, summed ``.grad``s), "params": after the last step,
    "agree": per step, whether the ranks' weights and gradients are equal
    bit for bit}}."""
    cfg = ModelConfig(**spec["cfg"])
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in spec["batch"].items()}
    rows = batch if mesh is None else rank_rows(batch, mesh, "cpu")
    out = {}
    for kind in spec["kinds"]:
        model = CaptionModel(cfg, device="cpu")
        model.load_state_dict(spec["state_dict"])
        if not spec["stochastic_depth"]:
            stochastic_depth_off(model)
        tc = TrainConfig(**spec["train"], teacher_forcing=kind != "free_running")
        state = TrainState.create(model, tc, mesh)
        step = make_train_step(model, tc, spec["word_ids"], teacher_forcing=tc.teacher_forcing,
                               train_encoder=kind == "fine_tune", mesh=mesh)
        root = prng.root_seed(spec["seed"])
        got = {"metrics": [], "grads": [], "agree": []}
        for i in range(spec["steps"]):
            state, metrics = step(state, rows, prng.step_seed(root, "dropout", 0, i))
            got["metrics"].append({k: float(v) for k, v in metrics.items()})
            grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
            got["grads"].append(grads)
            got["agree"].append(replicas_agree([*model.state_dict().values(), *grads.values()], mesh))
        got["params"] = {k: v.clone() for k, v in model.state_dict().items()}
        out[kind] = got
    return out


def steps_rank(mesh, spec_path, out_path):
    out = run_steps(torch.load(spec_path, weights_only=False), mesh)
    if mesh.rank == 0:
        torch.save(out, out_path)


def trainer_rank(mesh, exp, data_dir, base, out_path):
    """A ``Trainer`` run on this rank: rank 0 saves its rows, its start
    epoch and weights; every rank checks that the ranks' weights agree."""
    from tpu_captioner_torch.train.loop import Trainer

    trainer = Trainer(exp, data_dir, base, device="cpu", verbose=False, mesh=mesh)
    start, resumed = trainer.start_epoch, replicas_agree(trainer.model.state_dict().values(), mesh)
    rows = trainer.run()
    if not (resumed and replicas_agree(trainer.model.state_dict().values(), mesh)):
        raise AssertionError(f"rank {mesh.rank}: the ranks' weights differ")
    if mesh.rank == 0:
        torch.save({"rows": rows, "start": start, "params": trainer.model.state_dict()}, out_path)
    else:
        torch.save({"start": start}, out_path + f".{mesh.rank}")


def collectives_rank(mesh, out_dir):
    """Each collective once: the gather in rank order, the broadcast from
    rank 0, the sums; each rank writes what it saw."""
    from tpu_captioner_torch.parallel import collectives as c

    r = mesh.rank
    seqs = np.full((2, 3), 10 * r, np.int32) + np.arange(3, dtype=np.int32)
    lengths = np.array([r + 1, r + 2], np.int64)
    caps = np.full((2, 2, 4), r, np.int32)
    valid = np.array([True, r == 0])
    gathered = c.gather_eval_outputs(seqs, lengths, caps, valid, mesh)
    scalar = c.broadcast_scalar(0.25 + r, mesh)
    summed = c.all_reduce_sum(torch.tensor([1.0, float(r)]), mesh)
    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = torch.full((3,), float(r + 1))
    c.all_reduce_gradients([p], mesh)
    c.barrier(mesh)
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), *gathered, scalar=scalar, summed=summed.numpy(),
             grad=p.grad.numpy(), multi=c.is_multiprocess(mesh), coordinator=c.is_coordinator(mesh))


def failing_rank(mesh):
    """Rank 1 raises; rank 0 waits on it in a collective."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    from tpu_captioner_torch.parallel.collectives import barrier

    barrier(mesh)


def loader_rank(mesh, data_dir, base):
    """Under a group of two: 0 and 2 devices resolve to 2, 3 raises
    ValueError, and this rank's loader yields its rows of each global
    batch, with its share of the padding flagged."""
    import pytest

    from tpu_captioner_torch.data.dataset import CaptionDataset, iterate_batches
    from tpu_captioner_torch.data.loader import DeviceLoader, resolve_num_devices

    assert resolve_num_devices(0, "cpu") == resolve_num_devices(2, "cpu") == 2
    with pytest.raises(ValueError, match="the process group has 2 ranks"):
        resolve_num_devices(3, "cpu")
    ds = CaptionDataset(data_dir, base, "VAL")
    with pytest.raises(ValueError, match="the process group has 2 ranks"):
        DeviceLoader(ds, 4, device="cpu", num_devices=3)
    loader = DeviceLoader(ds, 3, device="cpu", shuffle=False, num_devices=2)
    assert loader.global_batch == 6 and len(loader) == -(-len(ds) // 6)
    want = list(iterate_batches(ds, 6, shuffle=False, shard=(mesh.rank, 2)))
    got = list(loader.epoch(0))
    assert len(got) == len(want) == len(loader)
    for g, w in zip(got, want):
        for k, v in w.as_dict().items():
            np.testing.assert_array_equal(g[k].numpy(), v)
    assert not got[-1]["valid"].all() or mesh.rank == 0


def cli_train_rank(mesh, flags):
    """``cli.train`` inside a group of two: ``--numDevices 2`` trains on
    both ranks (rank 0 writes), 3 raises ValueError."""
    import pytest

    from tpu_captioner_torch.cli import train as cli_train

    with pytest.raises(ValueError, match="the process group has 2 ranks"):
        cli_train.main(flags + ["--numDevices", "3"])
    trainer = cli_train.main(flags + ["--numDevices", "2"])
    assert trainer.mesh.size == 2 and trainer.mesh.rank == mesh.rank and trainer.train_loader.global_batch == 16


def device_count_rank(mesh):
    """Under a group of two: 0 and 2 devices resolve to 2, the loader's
    global batch is twice its batch, and 3 raises ValueError."""
    import pytest

    from tpu_captioner_torch.data.loader import DeviceLoader, resolve_num_devices

    assert resolve_num_devices(0, "cpu") == resolve_num_devices(2, "cpu") == mesh.size == 2
    assert DeviceLoader([], 4, device="cpu", num_devices=2).global_batch == 8
    with pytest.raises(ValueError, match="the process group has 2 ranks"):
        resolve_num_devices(3, "cpu")
    with pytest.raises(ValueError, match="the process group has 2 ranks"):
        DeviceLoader([], 4, device="cpu", num_devices=8)


def torchrun_rank(rank, port):
    """A process launched as ``torchrun`` launches one (its environment
    only): ``maybe_initialize_distributed`` joins, ``make_mesh`` sees the
    group, and a collective runs."""
    import torch.distributed as dist

    from tpu_captioner_torch.parallel.collectives import all_reduce_sum
    from tpu_captioner_torch.parallel.mesh import make_mesh, maybe_initialize_distributed

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    try:
        assert maybe_initialize_distributed("cpu")
        mesh = make_mesh(0, "cpu")
        assert (mesh.size, mesh.rank) == (2, rank)
        assert all_reduce_sum(torch.ones(1), mesh).item() == 2.0
    finally:
        dist.destroy_process_group()
