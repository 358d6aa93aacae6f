"""Collectives of data-parallel training (counterpart of
``tpu_captioner/parallel/collectives.py``; reference trainMultiGPU.py:96-131,
325-327).

Each takes the ``Mesh`` of ``parallel/mesh.py`` and is the identity when the
mesh has no group (a world of one, as in JAX).  With a group, even of one
rank, it runs through ``torch.distributed``:

- ``all_reduce_gradients``: the gradient sum that XLA inserts into the JAX
  mesh step, over flat buckets of the ``.grad``s in the caller's order,
  which is the same on every rank;
- ``all_reduce_sum``: global metrics and token counts;
- ``broadcast_tensors``: rank 0's parameters to every rank;
- ``gather_eval_outputs``: a fixed-shape all-gather of the eval step's host
  arrays, concatenated in rank order, for the coordinator's BLEU;
- ``broadcast_scalar``: rank 0's value (the BLEUs that keep the early
  stop, the LR decay and the unlock in lock step);
- ``barrier``.

The JAX package's ``host_local_rows`` and ``host_local_row_indices`` have no
counterpart: they pick a process's rows out of a global array, and here
each rank already holds only its own rows.  ``is_multiprocess`` and
``is_coordinator`` read the mesh, not the process's global state, so a
process may run the same code with and without a group.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpu_captioner_torch.parallel.mesh import Mesh

BUCKET_ELEMENTS = 1 << 24  # 64 MiB of f32 a collective


def is_multiprocess(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.size > 1


def is_coordinator(mesh: Optional[Mesh]) -> bool:
    """Rank 0, or a process without a mesh."""
    return mesh is None or mesh.rank == 0


def _grouped(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.group is not None


def all_reduce_sum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``t`` summed over the ranks, in place; returns it."""
    if _grouped(mesh):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def _buckets(tensors: Sequence[torch.Tensor]) -> Iterable[List[torch.Tensor]]:
    """Runs of ``tensors`` in order, one dtype and device each, of at most
    ``BUCKET_ELEMENTS`` (a larger tensor alone)."""
    run: List[torch.Tensor] = []
    size = 0
    for t in tensors:
        if run and (t.dtype != run[0].dtype or t.device != run[0].device or size + t.numel() > BUCKET_ELEMENTS):
            yield run
            run, size = [], 0
        run.append(t)
        size += t.numel()
    if run:
        yield run


def _flat_collective(tensors: Sequence[torch.Tensor], op) -> None:
    for run in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in run])
        op(flat)
        for t, part in zip(run, flat.split([t.numel() for t in run])):
            t.copy_(part.view_as(t))


def all_reduce_gradients(params: Iterable[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Sum the ``.grad`` of ``params`` over the ranks, in place.  Every rank
    must pass the same parameters in the same order, and the same ones must
    hold a gradient: ranks run one graph, so they do."""
    if not _grouped(mesh):
        return
    grads = [p.grad for p in params if p.grad is not None]
    _flat_collective(grads, lambda flat: dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group))


def broadcast_tensors(tensors: Iterable[torch.Tensor], mesh: Optional[Mesh], src: int = 0) -> None:
    """Overwrite ``tensors`` on every rank with rank ``src``'s, in place."""
    if not _grouped(mesh):
        return
    with torch.no_grad():
        _flat_collective(list(tensors), lambda flat: dist.broadcast(flat, src=src, group=mesh.group))


def gather_eval_outputs(
    sequences: np.ndarray, lengths: np.ndarray, all_captions: np.ndarray, valid: np.ndarray,
    mesh: Optional[Mesh],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Every rank's (B, T) sequences, (B,) lengths, (B, cpi, L) references
    and (B,) ``valid``, concatenated in rank order: one all-gather of a
    fixed-shape host buffer (the reference pickled ragged lists,
    trainMultiGPU.py:110-131)."""
    if not _grouped(mesh):
        return sequences, lengths, all_captions, valid
    b = sequences.shape[0]
    parts = (sequences.reshape(b, -1), lengths.reshape(b, 1), all_captions.reshape(b, -1), valid.reshape(b, 1))
    widths = [p.shape[1] for p in parts]
    rows = torch.from_numpy(np.concatenate([p.astype(np.int64) for p in parts], axis=1))
    out = [torch.empty_like(rows) for _ in range(mesh.size)]
    dist.all_gather(out, rows, group=mesh.group)
    cols = np.split(torch.cat(out).numpy(), np.cumsum(widths)[:-1], axis=1)
    return (
        cols[0].astype(sequences.dtype).reshape(-1, *sequences.shape[1:]),
        cols[1].astype(lengths.dtype).reshape(-1),
        cols[2].astype(all_captions.dtype).reshape(-1, *all_captions.shape[1:]),
        cols[3].astype(valid.dtype).reshape(-1),
    )


def broadcast_scalar(value: float, mesh: Optional[Mesh]) -> float:
    """Rank 0's ``value`` on every rank (dist.broadcast src=0)."""
    if not _grouped(mesh):
        return value
    t = torch.tensor([value], dtype=torch.float64)
    dist.broadcast(t, src=0, group=mesh.group)
    return float(t.item())


def barrier(mesh: Optional[Mesh]) -> None:
    """Return once every rank has arrived: a host all-reduce, which the
    gloo side of either backend serves."""
    if _grouped(mesh):
        dist.all_reduce(torch.zeros(1), group=mesh.group)
