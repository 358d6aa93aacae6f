"""Data-parallel process groups on ``torch.distributed`` (counterpart of
``tpu_captioner/parallel/mesh.py``).

The JAX package runs one program over a 1-D ``'data'`` mesh and XLA inserts
the gradient sums.  Here each card is one process (a rank) that holds its
own rows of every global batch; the train step sums the gradients itself
(``parallel/collectives.py``).  The group is created with
``backend="cpu:gloo,cuda:nccl"`` on cards, so device tensors (gradients,
metrics) go through NCCL and host arrays (the eval gathers, scalars)
through gloo, and with plain ``"gloo"`` on the CPU.  ``"gloo"`` also serves
two ranks on one card, which NCCL refuses ("Duplicate GPU detected").

Ranks join in one of two ways: launched by ``torchrun``, whose ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` are
read from the environment, or started by ``spawn``, which joins them
through a ``file://`` store in a temporary directory.  A rank selects its
card (``torch.cuda.set_device``) before it joins, so every kernel it builds
or launches goes to that card.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from tpu_captioner_torch.core.backend import require_cuda

# A collective that waits longer than this for a peer raises.
TIMEOUT = datetime.timedelta(minutes=10)


@dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group (the JAX mesh's
    ``'data'`` axis): ``size`` ranks, this one's ``rank`` and card
    (``device``), and the process ``group`` the collectives use (None: no
    group, and every collective is the identity)."""

    size: int
    rank: int
    device: torch.device
    group: Optional[Any] = None


def local_device_count() -> int:
    """Cards this host shows (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def default_backend(device) -> str:
    """NCCL for device tensors and gloo for host tensors on a card; gloo on
    the CPU."""
    return "cpu:gloo,cuda:nccl" if torch.device(device).type == "cuda" else "gloo"


def resolve_num_devices(requested: int, device) -> int:
    """The ranks a run trains on: ``requested``, or for 0 the initialised
    group's size (without a group: every visible card, 1 on the CPU).  It
    must equal the group's size (1 without a group), else ``ValueError``:
    more ranks are launched by ``torchrun`` or by ``cli.train``.  A card
    asked for on a host without one raises."""
    device = torch.device(device)
    if device.type == "cuda":
        require_cuda()
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    n = requested or (world if grouped else torch.cuda.device_count() if device.type == "cuda" else 1)
    if n != world:
        where = f"the process group has {world} ranks" if grouped else "this process is alone (no process group)"
        raise ValueError(
            f"{n} devices asked for, but {where}: launch one rank per device (torchrun --nproc_per_node "
            f"N, or cli.train, which spawns them), or pass --numDevices {world}"
        )
    return n


def maybe_initialize_distributed(
    device="cuda",
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
) -> bool:
    """Join the process group when launched by ``torchrun`` (the
    environment) or given ``init_method`` (a ``file://`` store with
    ``rank`` and ``world_size``); a process that is neither stays alone.
    On a card the rank first selects ``device``'s index, or ``LOCAL_RANK``
    (else the rank) when ``device`` names none.  Returns whether a group is
    initialised."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None and "WORLD_SIZE" not in env:
        return False
    rank = int(env["RANK"]) if rank is None else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    device = torch.device(device)
    if device.type == "cuda":
        require_cuda()
        index = device.index if device.index is not None else int(env.get("LOCAL_RANK", rank))
        if index >= torch.cuda.device_count():
            raise ValueError(f"rank {rank} wants card {index}; this host has {torch.cuda.device_count()}")
        torch.cuda.set_device(index)
    dist.init_process_group(
        backend or default_backend(device), init_method=init_method or "env://",
        rank=rank, world_size=world_size, timeout=TIMEOUT,
    )
    return True


def make_mesh(num_devices: int = 0, device="cuda") -> Mesh:
    """This process's ``Mesh``: the initialised group's on the rank's card
    (checked against ``num_devices`` by ``resolve_num_devices``), else a
    world of one with no group on ``device`` (a card without an index: the
    current one)."""
    resolve_num_devices(num_devices, device)
    device = torch.device(device)
    grouped = dist.is_initialized()
    if device.type == "cuda" and (grouped or device.index is None):
        device = torch.device("cuda", torch.cuda.current_device())
    if not grouped:
        return Mesh(1, 0, device)
    return Mesh(dist.get_world_size(), dist.get_rank(), device, dist.group.WORLD)


def _rank_main(rank: int, fn: Callable, world: int, device: str, backend: Optional[str], store: str,
               args: Sequence) -> None:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank)
    if device.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    maybe_initialize_distributed(device, backend, init_method=store, rank=rank, world_size=world)
    try:
        fn(make_mesh(world, device), *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, device="cuda", backend: Optional[str] = None, args: Sequence = ()) -> None:
    """Run ``fn(mesh, *args)`` in ``nprocs`` new processes, rank r on card r
    (``device`` "cuda"), every rank on one card (``device`` "cuda:i") or on
    the CPU, joined through a ``file://`` store in a temporary directory.
    ``fn`` must be importable by name.  Raises when any rank fails; the
    others are then stopped."""
    with tempfile.TemporaryDirectory(prefix="tc_ranks_") as tmp:
        store = "file://" + os.path.join(tmp, "store")
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, nprocs, str(device), backend, store, tuple(args)), nprocs=nprocs, join=True
        )


@contextlib.contextmanager
def single_rank_group(device="cuda", backend: Optional[str] = None):
    """A world of one in this process, through the same backends and
    collectives as a larger one; yields its ``Mesh`` and leaves the group
    on exit."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this process")
    with tempfile.TemporaryDirectory(prefix="tc_ranks_") as tmp:
        maybe_initialize_distributed(device, backend, init_method="file://" + os.path.join(tmp, "store"),
                                     rank=0, world_size=1)
        try:
            yield make_mesh(1, device)
        finally:
            dist.destroy_process_group()
