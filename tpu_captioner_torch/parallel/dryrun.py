"""One data-parallel pass over every training and serving path
(counterpart of ``__graft_entry__.dryrun_multichip`` of the JAX package).

    python -m tpu_captioner_torch.parallel.dryrun 2 --device cpu

``dryrun_multichip(n, device)`` starts ``n`` ranks and runs, on each rank's
rows of one global batch: the frozen teacher-forced step, the fine-tune
step (``starting_layer`` 5), the free-running step, the greedy eval step and
beam 3 over the rank's images.  Rank 0 prints one line per path with its
global value (the steps' losses, the beam's mean score over every image),
and every rank checks that the ranks' weights are equal bit for bit after
the steps.  Any rank's failure raises.  A world of one runs in this process
inside a group of one, through the same collectives.  The model is the JAX
dry run's ``tiny`` flagship (32 x 32 images, batch 2 a rank, 9 tokens);
``run_paths`` takes any configuration and size (``chip_smoke.py`` phase 16a
runs it at full width).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu_captioner_torch.core import prng
from tpu_captioner_torch.core.config import ModelConfig, TrainConfig
from tpu_captioner_torch.parallel.collectives import all_reduce_sum, broadcast_tensors, is_coordinator
from tpu_captioner_torch.parallel.mesh import Mesh, single_rank_group, spawn

PATHS = ("frozen", "fine_tune", "free_running", "eval", "beam3")
TINY = dict(vocab_size=200, embed_dim=16, decoder_dim=32, num_heads=4, num_layers=2, max_len=12,
            encoder_dim=24, encoder_depths=(1, 1, 1, 1), encoder_dims=(8, 12, 16, 24), encoded_image_size=2)
TINY_BATCH, TINY_IMAGE, TINY_STEPS = 2, 32, 9  # rows a rank, image side, decoded tokens (the JAX dry run's)


def word_ids(vocab: int) -> Dict[str, int]:
    """The dry run's special tokens: the vocabulary's last three ids."""
    return {"<pad>": 0, "<unk>": vocab - 3, "<start>": vocab - 2, "<end>": vocab - 1}


def global_batch(rows: int, image_size: int, length: int, vocab: int, seed: int) -> Dict[str, torch.Tensor]:
    """A seeded global batch of host tensors: uint8 images, captions
    ``<start> words <end> <pad>...`` of random lengths, the last row
    padding (not ``valid``)."""
    rng = np.random.default_rng(seed)
    ids = word_ids(vocab)
    caplens = rng.integers(3, length + 1, rows).astype(np.int32)
    caps = np.zeros((rows, length), np.int32)
    for i, n in enumerate(caplens):
        caps[i, 0], caps[i, n - 1] = ids["<start>"], ids["<end>"]
        caps[i, 1 : n - 1] = rng.integers(1, vocab - 3, n - 2)
    valid = np.ones(rows, bool)
    valid[-1] = False
    return {"images": torch.from_numpy(rng.integers(0, 256, (rows, image_size, image_size, 3), dtype=np.uint8)),
            "captions": torch.from_numpy(caps), "caplens": torch.from_numpy(caplens),
            "valid": torch.from_numpy(valid)}


def rank_rows(batch: Dict[str, torch.Tensor], mesh: Mesh, device) -> Dict[str, torch.Tensor]:
    """``mesh``'s rank's contiguous rows of a global batch, on ``device``."""
    per = batch["images"].shape[0] // mesh.size
    return {k: v[mesh.rank * per : (mesh.rank + 1) * per].to(device) for k, v in batch.items()}


def replicas_agree(tensors, mesh: Optional[Mesh]) -> bool:
    """Whether every rank holds rank 0's ``tensors`` bit for bit (on every
    rank the same answer)."""
    tensors = list(tensors)
    theirs = [t.detach().clone() for t in tensors]
    broadcast_tensors(theirs, mesh)
    same = torch.tensor([float(all(torch.equal(a, b) for a, b in zip(tensors, theirs)))])
    all_reduce_sum(same, mesh)
    return int(same.item()) == (1 if mesh is None else mesh.size)


def run_paths(
    mesh: Mesh, cfg: ModelConfig, batch_size: int, image_size: int, max_decode_len: int, seed: int = 0,
) -> Tuple[Dict[str, float], torch.nn.Module]:
    """The five paths on ``mesh``'s rank (a ``Mesh`` without a group runs
    them alone on the global batch of ``batch_size * mesh.size`` rows).
    Returns ({path: global value}, the model after the three steps)."""
    from tpu_captioner_torch.infer.beam import beam_search_batch
    from tpu_captioner_torch.train.model import CaptionModel
    from tpu_captioner_torch.train.state import TrainState
    from tpu_captioner_torch.train.steps import make_eval_step, make_train_step

    device = mesh.device
    ids = word_ids(cfg.vocab_size)
    model = CaptionModel(cfg, device=device, seed=seed)
    tc = TrainConfig(batch_size=batch_size, max_decode_len=max_decode_len)
    free_tc = TrainConfig(batch_size=batch_size, max_decode_len=max_decode_len, teacher_forcing=False)
    batch = rank_rows(global_batch(batch_size * mesh.size, image_size, cfg.max_len, cfg.vocab_size, seed + 1),
                      mesh, device)
    state = TrainState.create(model, tc, mesh)
    root = prng.root_seed(seed)
    out: Dict[str, float] = {}
    for i, (path, step) in enumerate((
        ("frozen", make_train_step(model, tc, ids, mesh=mesh)),
        ("fine_tune", make_train_step(model, tc, ids, train_encoder=True, mesh=mesh)),
        ("free_running", make_train_step(model, free_tc, ids, teacher_forcing=False, mesh=mesh)),
    )):
        state, metrics = step(state, batch, prng.step_seed(root, "dropout", 0, i))
        out[path] = float(metrics["loss"])
    out["eval"] = float(make_eval_step(model, tc, ids, mesh=mesh)(batch)["loss"])
    res = beam_search_batch(model, batch["images"], beam_size=3, max_steps=max_decode_len,
                            start_id=ids["<start>"], end_id=ids["<end>"])
    scores = torch.stack([res.score.double().sum(), torch.tensor(float(res.score.numel()), dtype=torch.float64,
                                                                 device=res.score.device)])
    if not torch.isfinite(scores).all():
        raise AssertionError(f"beam 3: non-finite scores {res.score}")
    total, count = all_reduce_sum(scores, mesh).tolist()
    out["beam3"] = total / count
    bad = [p for p in PATHS if not np.isfinite(out[p])]
    if bad:
        raise AssertionError(f"non-finite values on the paths {bad}: {out}")
    if not replicas_agree(model.state_dict().values(), mesh):
        raise AssertionError(f"rank {mesh.rank}: the ranks' weights differ after the steps")
    return out, model


def _rank(mesh: Mesh, cfg: ModelConfig, batch_size: int, image_size: int, max_decode_len: int, seed: int,
          out_path: str) -> None:
    out, _ = run_paths(mesh, cfg, batch_size, image_size, max_decode_len, seed)
    if is_coordinator(mesh):
        with open(out_path, "w") as f:
            json.dump(out, f)


def dryrun_multichip(n: int, device="cuda", backend: Optional[str] = None) -> Dict[str, float]:
    """The five paths of the tiny model on ``n`` ranks (``device`` "cuda":
    rank r on card r; "cuda:i": every rank on card i, which needs
    ``backend="gloo"``; "cpu": gloo processes), ``TINY_BATCH`` rows each.
    Prints and returns rank 0's {path: global value}; raises if any rank
    fails."""
    args = (ModelConfig(**TINY), TINY_BATCH, TINY_IMAGE, TINY_STEPS, 0)
    if n == 1:
        with single_rank_group(device, backend) as mesh:
            out, _ = run_paths(mesh, *args)
    else:
        with tempfile.TemporaryDirectory(prefix="tc_dryrun_") as tmp:
            path = os.path.join(tmp, "paths.json")
            spawn(_rank, n, device, backend, args=(*args, path))
            with open(path) as f:
                out = json.load(f)
    report(n, out)
    return out


def report(n: int, out: Dict[str, float]) -> None:
    """One line per path of ``out`` (``run_paths``'), for ``n`` ranks."""
    for name in PATHS:
        what = "mean score" if name == "beam3" else "loss"
        print(f"dryrun_multichip({n}): {name}: ok, global {what} {out[name]!r}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device, args.backend)


if __name__ == "__main__":
    main()
