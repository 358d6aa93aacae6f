"""Caption dataset over the packed records (counterpart of
``tpu_captioner/data/dataset.py``, reference dataLoader.py:15-56).

Item ``i`` is caption ``i`` with image ``i // captions_per_image``;
``len(dataset)`` counts captions (dataLoader.py:43,55-56).  VAL/TEST items
also carry all ``cpi`` reference captions of their image for BLEU
(dataLoader.py:51-53).  Images stay uint8 NHWC on the host; the /255 and
ImageNet normalisation run on the device (``models/encoder.py:
preprocess_images``).  Batches have one shape: a short final batch is padded
with the epoch's first rows (wrap-around) and flagged in ``valid``.

Memmapped records are gathered by the native threaded gather
(``native/gather.py``, as the JAX package's), equal to numpy's fancy
indexing bit for bit, whose library is built when the dataset is opened;
reference-format HDF5 records are read per row, and h5py is imported only
for them.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np

from tpu_captioner_torch.native.gather import gather_batch_native
from tpu_captioner_torch.native.lib import get_lib

# ImageNet statistics of the reference transform (train.py:152).
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


@dataclass
class Batch:
    """A training batch: uint8 images, int32 captions and lengths, and the
    ``valid`` flags (False for wrap-around padding rows)."""

    images: np.ndarray  # (B, H, W, 3) uint8
    captions: np.ndarray  # (B, L) int32
    caplens: np.ndarray  # (B,) int32
    valid: np.ndarray  # (B,) bool

    def as_dict(self) -> Dict[str, np.ndarray]:
        return {"images": self.images, "captions": self.captions, "caplens": self.caplens, "valid": self.valid}


@dataclass
class EvalBatch(Batch):
    all_captions: np.ndarray = None  # (B, cpi, L) int32

    def as_dict(self) -> Dict[str, np.ndarray]:
        d = super().as_dict()
        d["all_captions"] = self.all_captions
        return d


class CaptionDataset:
    def __init__(self, data_folder: str, data_name: str, split: str):
        if split not in {"TRAIN", "VAL", "TEST"}:
            raise ValueError(f"split must be TRAIN, VAL or TEST, got {split!r}")
        self.split = split
        self._h5 = None
        npy = os.path.join(data_folder, f"{split}_IMAGES_{data_name}.npy")
        h5 = os.path.join(data_folder, f"{split}_IMAGES_{data_name}.hdf5")
        if os.path.exists(npy):
            self.images = np.load(npy, mmap_mode="r")
            self.captions = np.load(os.path.join(data_folder, f"{split}_CAPTIONS_{data_name}.npy"))
            self.caplens = np.load(os.path.join(data_folder, f"{split}_CAPLENS_{data_name}.npy"))
            with open(os.path.join(data_folder, f"{split}_META_{data_name}.json")) as f:
                self.cpi = int(json.load(f)["captions_per_image"])
            n_images = self.images.shape[0]
            get_lib()  # the gather's library: built here, not in the first batch's data time
        elif os.path.exists(h5):
            # Reference-format records (utils/utils.py:102-160): NCHW uint8
            # HDF5 images, read per batch and turned NHWC.
            import h5py  # only reference HDF5 records need h5py

            self._h5_path = h5
            with h5py.File(h5, "r") as h:
                self.cpi = int(h.attrs["captions_per_image"])
                n_images = h["images"].shape[0]
            with open(os.path.join(data_folder, f"{split}_CAPTIONS_{data_name}.json")) as f:
                self.captions = np.asarray(json.load(f), dtype=np.int32)
            with open(os.path.join(data_folder, f"{split}_CAPLENS_{data_name}.json")) as f:
                self.caplens = np.asarray(json.load(f), dtype=np.int32)
            self.images = None
        else:
            raise FileNotFoundError(f"no {split} image records ({npy} or reference-format {h5})")
        if not len(self.captions) == len(self.caplens) == n_images * self.cpi:
            raise ValueError(
                f"{split}: {len(self.captions)} captions, {len(self.caplens)} lengths for "
                f"{n_images} images x {self.cpi}"
            )

    def __len__(self) -> int:
        return len(self.captions)

    @property
    def max_caption_len(self) -> int:
        return self.captions.shape[1]

    def _gather_images_h5(self, img_idx: np.ndarray) -> np.ndarray:
        if self._h5 is None:
            import h5py

            self._h5 = h5py.File(self._h5_path, "r")["images"]
        imgs = np.stack([self._h5[int(i)] for i in img_idx])  # (B, 3, H, W)
        return np.ascontiguousarray(imgs.transpose(0, 2, 3, 1))

    def gather(self, indices: np.ndarray) -> Batch:
        """The batch of caption ``indices``."""
        img_idx = indices // self.cpi
        if self.images is None:
            images = self._gather_images_h5(img_idx)
            captions, caplens = self.captions[indices], self.caplens[indices]
        else:
            images, captions, caplens = gather_batch_native(
                self.images, self.captions, self.caplens, img_idx, indices
            )
        valid = np.ones(len(indices), dtype=bool)
        if self.split == "TRAIN":
            return Batch(images, captions, caplens, valid)
        base = (img_idx * self.cpi)[:, None] + np.arange(self.cpi)[None, :]
        return EvalBatch(images, captions, caplens, valid, self.captions[base])


def epoch_indices(n: int, epoch: int, seed: int = 42, shuffle: bool = True) -> np.ndarray:
    """The epoch's order: a permutation from ``seed + epoch`` (the seed and
    epoch shuffle of DistributedSampler, trainMultiGPU.py:240,248), or
    0..n-1 without ``shuffle``."""
    if not shuffle:
        return np.arange(n)
    return np.random.default_rng(seed + epoch).permutation(n)


def iterate_batches(
    dataset: CaptionDataset,
    global_batch: int,
    epoch: int = 0,
    seed: int = 42,
    shuffle: bool = True,
    pad_final: bool = True,
    shard: Tuple[int, int] = (0, 1),
) -> Iterator[Batch]:
    """Batches of ``global_batch`` rows in ``epoch_indices`` order.  The
    final short batch is padded with the epoch's first rows, marked not
    ``valid`` (or dropped without ``pad_final``).  ``shard=(index, count)``
    gathers only rank ``index``'s contiguous ``global_batch // count`` rows
    of every global batch (the reference's DistributedSampler split,
    trainMultiGPU.py:240-245); every rank walks the same order, so the
    shards are disjoint and complete, and each flags its share of the
    padding."""
    index, count = shard
    if global_batch % count != 0:
        raise ValueError(f"global_batch {global_batch} not divisible by {count}")
    per = global_batch // count
    idx = epoch_indices(len(dataset), epoch, seed, shuffle)
    for s in range(0, len(idx), global_batch):
        chunk = idx[s : s + global_batch]
        pad = global_batch - len(chunk)
        if pad > 0:
            if not pad_final:
                break
            chunk = np.concatenate([chunk, idx[:pad]])
        batch = dataset.gather(chunk[index * per : (index + 1) * per])
        if pad > 0:
            # The padding is the global batch's tail: this rank's rows in it.
            batch.valid[max(0, global_batch - pad - index * per) :] = False
        yield batch


def normalize_images_host(images_u8: np.ndarray) -> np.ndarray:
    """The reference normalisation on the host (tests and CPU checks)."""
    x = images_u8.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD
