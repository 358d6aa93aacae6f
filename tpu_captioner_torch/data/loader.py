"""Host-to-device input pipeline of a rank's card (counterpart of
``tpu_captioner/data/loader.py``).

A background thread gathers batches (``data/dataset.py:iterate_batches``)
and keeps ``depth`` of them on the device ahead of the step, as the
reference's pinned-memory DataLoader workers did (train.py:155).  On a card
each batch is copied from pinned host memory on a side CUDA stream; the
consumer's stream waits on that copy's event before it sees the batch, and
each tensor is marked used on the consumer's stream so the caching allocator
does not hand its memory back to the copy stream early.  On the CPU the
thread yields host tensors.

Shutdown as ``prefetch_to_device`` of the JAX package: a consumer that stops
early (an exception mid-epoch, a closed generator) signals the thread, drains
the queue and joins it, so no batch stays referenced.

Data parallel: ``DeviceLoader`` under a ``parallel.mesh.Mesh`` of N ranks
walks global batches of ``batch_size * N`` rows and gathers and copies only
this rank's contiguous share onto its card (``ShardedLoader`` of the JAX
package).
"""

from __future__ import annotations

import queue
import threading
import warnings
from typing import Dict, Iterator, Optional

import torch

from tpu_captioner_torch.data.dataset import Batch, CaptionDataset, iterate_batches
from tpu_captioner_torch.parallel.mesh import Mesh, make_mesh, resolve_num_devices  # noqa: F401 (re-exported)


def _host_tensors(batch: Batch) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v) for k, v in batch.as_dict().items()}


def prefetch_to_device(host_iter: Iterator[Batch], device, depth: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of ``host_iter`` as dicts of tensors on ``device``, ``depth``
    of them prepared ahead by a background thread."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be cpu or cuda, got {device}")
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()
    err: list = []

    def put(item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def producer():
        try:
            for b in host_iter:
                host = _host_tensors(b)
                if copy_stream is None:
                    put((host, None))
                else:
                    with torch.cuda.device(device), torch.cuda.stream(copy_stream):
                        on_dev = {k: v.pin_memory().to(device, non_blocking=True) for k, v in host.items()}
                        ready = torch.cuda.Event()
                        ready.record(copy_stream)
                    put((on_dev, ready))
                if stop.is_set():
                    return
        except Exception as e:  # raised again in the consumer
            err.append(e)
        finally:
            # The end marker must not be dropped when the queue is full: the
            # consumer would drain the items and then wait forever.
            put(end)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                if err:
                    raise err[0]
                return
            batch, ready = item
            if ready is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(ready)
                for v in batch.values():
                    v.record_stream(stream)
            yield batch
    finally:
        stop.set()
        # Drain so a blocked producer sees `stop`; its last put may land in a
        # slot the drain freed, so drain until the thread is gone.
        for _ in range(50):  # x 0.1 s
            _drain(q)
            t.join(timeout=0.1)
            if not t.is_alive():
                break
        else:
            warnings.warn(
                "prefetch thread still alive 5 s after shutdown; abandoning it "
                "(its batch may stay referenced until the process exits)",
                RuntimeWarning,
            )
        _drain(q)


def _drain(q: "queue.Queue") -> None:
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass


class DeviceLoader:
    """Epoch loader of one rank (counterpart of ``ShardedLoader``): the
    seed-and-epoch shuffle, fixed-size global batches of ``batch_size``
    rows per rank with a padded final one, this rank's rows of each, and
    two batches prepared on its card ahead of the step (the JAX package's
    default prefetch).  Without ``mesh``, ``make_mesh(num_devices, device)``
    gives it: the initialised group's, else a world of one."""

    def __init__(
        self,
        dataset: CaptionDataset,
        batch_size: int,
        device="cuda",
        seed: int = 42,
        shuffle: bool = True,
        num_devices: int = 1,
        mesh: Optional[Mesh] = None,
    ):
        self.mesh = mesh if mesh is not None else make_mesh(num_devices, device)
        self.dataset = dataset
        self.batch_size = batch_size
        self.global_batch = batch_size * self.mesh.size
        self.device = self.mesh.device
        self.seed = seed
        self.shuffle = shuffle

    def __len__(self) -> int:
        return (len(self.dataset) + self.global_batch - 1) // self.global_batch

    def epoch(self, epoch: int) -> Iterator[Dict[str, torch.Tensor]]:
        host = iterate_batches(self.dataset, self.global_batch, epoch=epoch, seed=self.seed, shuffle=self.shuffle,
                               shard=(self.mesh.rank, self.mesh.size))
        return prefetch_to_device(host, self.device)
