"""Offline dataset preparation: Karpathy JSON -> packed numpy records (a copy of
``tpu_captioner/data/build.py``; the port imports nothing of the JAX
package).

Images are stored NHWC uint8 in a flat ``.npy`` (memmap-able), captions and
caption lengths as int32 ``.npy`` arrays, beside a word map and one META
JSON per split.  Kept from the reference (utils/utils.py:21-160):
- splits train/restval -> TRAIN, val -> VAL, test -> TEST;
- the word map of ``data/vocab.py``;
- caption sampling with ``random.seed(123)``: ``choice`` to fill an image
  with fewer than ``captions_per_image`` captions, ``sample`` otherwise;
- 256x256 bicubic RGB resize through PIL;
- ``<start> ... <end> <pad>*`` encoding with caplen = len + 2.

PIL (image folders) and h5py (reference HDF5 records) are imported only by
the paths that read them: ``build_synthetic_dataset`` needs neither, and
writes byte for byte what the JAX package's writes for the same arguments.
"""

from __future__ import annotations

import json
import os
import shutil
from collections import Counter
from random import choice, sample, seed
from typing import Dict, List

import numpy as np

from tpu_captioner_torch.data.vocab import PAD, build_word_map, encode_caption, save_word_map


def _load_image(path: str, image_size: int) -> np.ndarray:
    from PIL import Image  # only the image-folder path needs PIL

    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    img = img.resize((image_size, image_size), Image.BICUBIC)
    arr = np.array(img)
    if arr.ndim == 2:
        arr = np.stack([arr, arr, arr], axis=2)
    if arr.shape != (image_size, image_size, 3) or arr.dtype != np.uint8:
        raise ValueError(f"{path}: decoded to {arr.shape} {arr.dtype}")
    return arr  # NHWC uint8


def create_input_files(
    dataset: str,
    karpathy_json_path: str,
    image_folder: str,
    captions_per_image: int,
    min_word_freq: int,
    output_folder: str,
    max_len: int = 100,
    image_size: int = 256,
) -> Dict[str, int]:
    """Build the TRAIN/VAL/TEST records and the word map; returns the map."""
    if dataset not in {"coco", "flickr8k", "flickr30k"}:
        raise ValueError(f"unknown dataset {dataset!r}")
    with open(karpathy_json_path, "r") as j:
        data = json.load(j)

    split_paths: Dict[str, List[str]] = {"TRAIN": [], "VAL": [], "TEST": []}
    split_caps: Dict[str, List[List[List[str]]]] = {"TRAIN": [], "VAL": [], "TEST": []}
    word_freq: Counter = Counter()
    for img in data["images"]:
        captions = []
        for c in img["sentences"]:
            word_freq.update(c["tokens"])
            if len(c["tokens"]) <= max_len:
                captions.append(c["tokens"])
        if len(captions) == 0:
            continue
        path = (
            os.path.join(image_folder, img["filepath"], img["filename"])
            if dataset == "coco"
            else os.path.join(image_folder, img["filename"])
        )
        if img["split"] in {"train", "restval"}:
            key = "TRAIN"
        elif img["split"] == "val":
            key = "VAL"
        elif img["split"] == "test":
            key = "TEST"
        else:
            continue
        split_paths[key].append(path)
        split_caps[key].append(captions)

    words = [w for w in word_freq.keys() if word_freq[w] > min_word_freq]
    word_map = {w: i + 1 for i, w in enumerate(words)}
    word_map["<unk>"] = len(word_map) + 1
    word_map["<start>"] = len(word_map) + 1
    word_map["<end>"] = len(word_map) + 1
    word_map[PAD] = 0

    base = f"{dataset}_{captions_per_image}_cap_per_img_{min_word_freq}_min_word_freq"
    os.makedirs(output_folder, exist_ok=True)
    save_word_map(word_map, os.path.join(output_folder, f"WORDMAP_{base}.json"))

    seed(123)
    for split in ("TRAIN", "VAL", "TEST"):
        impaths, imcaps = split_paths[split], split_caps[split]
        n = len(impaths)
        images = np.lib.format.open_memmap(
            os.path.join(output_folder, f"{split}_IMAGES_{base}.npy"),
            mode="w+", dtype=np.uint8, shape=(n, image_size, image_size, 3),
        )
        enc_captions: List[List[int]] = []
        caplens: List[int] = []
        for i, path in enumerate(impaths):
            if len(imcaps[i]) < captions_per_image:
                caps = imcaps[i] + [choice(imcaps[i]) for _ in range(captions_per_image - len(imcaps[i]))]
            else:
                caps = sample(imcaps[i], k=captions_per_image)
            images[i] = _load_image(path, image_size)
            for c in caps:
                ids, c_len = encode_caption(c, word_map, max_len)
                enc_captions.append(ids)
                caplens.append(c_len)
        images.flush()
        np.save(os.path.join(output_folder, f"{split}_CAPTIONS_{base}.npy"), np.asarray(enc_captions, dtype=np.int32))
        np.save(os.path.join(output_folder, f"{split}_CAPLENS_{base}.npy"), np.asarray(caplens, dtype=np.int32))
        meta = {"captions_per_image": int(captions_per_image), "num_images": int(n)}
        with open(os.path.join(output_folder, f"{split}_META_{base}.json"), "w") as f:
            json.dump(meta, f)
    return word_map


def convert_reference_artifacts(
    data_folder: str, data_name: str, output_folder: str, splits=("TRAIN", "VAL", "TEST")
) -> None:
    """Convert reference-format records (utils/utils.py:102-160: NCHW uint8
    HDF5 images, caption and caplen JSONs) into NHWC ``.npy`` records with
    the same content."""
    import h5py  # only reference HDF5 records need h5py

    os.makedirs(output_folder, exist_ok=True)
    src_wm = os.path.join(data_folder, f"WORDMAP_{data_name}.json")
    shutil.copyfile(src_wm, os.path.join(output_folder, f"WORDMAP_{data_name}.json"))
    for split in splits:
        with h5py.File(os.path.join(data_folder, f"{split}_IMAGES_{data_name}.hdf5"), "r") as h:
            cpi = int(h.attrs["captions_per_image"])
            imgs = h["images"]  # (N, 3, H, W) uint8
            n = imgs.shape[0]
            out = np.lib.format.open_memmap(
                os.path.join(output_folder, f"{split}_IMAGES_{data_name}.npy"),
                mode="w+", dtype=np.uint8, shape=(n, imgs.shape[2], imgs.shape[3], 3),
            )
            chunk = 512
            for s in range(0, n, chunk):
                e = min(s + chunk, n)
                out[s:e] = np.transpose(imgs[s:e], (0, 2, 3, 1))  # CHW -> HWC
            out.flush()
        with open(os.path.join(data_folder, f"{split}_CAPTIONS_{data_name}.json")) as f:
            caps = np.asarray(json.load(f), dtype=np.int32)
        with open(os.path.join(data_folder, f"{split}_CAPLENS_{data_name}.json")) as f:
            lens = np.asarray(json.load(f), dtype=np.int32)
        np.save(os.path.join(output_folder, f"{split}_CAPTIONS_{data_name}.npy"), caps)
        np.save(os.path.join(output_folder, f"{split}_CAPLENS_{data_name}.npy"), lens)
        with open(os.path.join(output_folder, f"{split}_META_{data_name}.json"), "w") as f:
            json.dump({"captions_per_image": cpi, "num_images": int(n)}, f)


def build_synthetic_dataset(
    output_folder: str,
    dataset: str = "synthetic",
    num_images: Dict[str, int] = None,
    vocab_words: int = 120,
    captions_per_image: int = 5,
    max_len: int = 50,
    image_size: int = 256,
    seed_: int = 0,
    learnable: bool = False,
    n_classes: int = 16,
) -> Dict[str, int]:
    """A random dataset in the record format, made from ``seed_``.  With
    ``learnable`` each image renders one of ``n_classes`` colours plus
    per-image noise, and its captions are a function of that class, so a
    model that learns the mapping reaches BLEU near 1 on VAL/TEST.  The
    word map holds ``vocab_words`` words and the four special tokens."""
    rng = np.random.default_rng(seed_)
    num_images = num_images or {"TRAIN": 32, "VAL": 8, "TEST": 8}
    words = [f"w{i}" for i in range(vocab_words)]
    word_map = build_word_map([words * 2], min_word_freq=1)
    base = f"{dataset}_{captions_per_image}_cap_per_img_1_min_word_freq"
    os.makedirs(output_folder, exist_ok=True)
    save_word_map(word_map, os.path.join(output_folder, f"WORDMAP_{base}.json"))

    # One palette for every split: VAL/TEST images are new samples (fresh
    # noise) of the classes seen in TRAIN.
    palette = np.random.default_rng(1234).integers(30, 226, size=(n_classes, 3), dtype=np.int64)
    for split, n in num_images.items():
        if learnable:
            cls = np.arange(n) % n_classes
            noise = rng.integers(-25, 26, size=(n, image_size, image_size, 3), dtype=np.int64)
            images = np.clip(palette[cls][:, None, None, :] + noise, 0, 255).astype(np.uint8)
        else:
            images = rng.integers(0, 256, size=(n, image_size, image_size, 3), dtype=np.uint8)
        np.save(os.path.join(output_folder, f"{split}_IMAGES_{base}.npy"), images)
        caps, lens = [], []
        for i in range(n * captions_per_image):
            if learnable:
                c = int(cls[i // captions_per_image])
                length = 4 + (c % 4)
                toks = [words[(c * 7 + 3 * j) % vocab_words] for j in range(length)]
            else:
                length = int(rng.integers(4, min(18, max_len)))
                toks = [words[int(rng.integers(0, vocab_words))] for _ in range(length)]
            ids, c_len = encode_caption(toks, word_map, max_len)
            caps.append(ids)
            lens.append(c_len)
        np.save(os.path.join(output_folder, f"{split}_CAPTIONS_{base}.npy"), np.asarray(caps, dtype=np.int32))
        np.save(os.path.join(output_folder, f"{split}_CAPLENS_{base}.npy"), np.asarray(lens, dtype=np.int32))
        with open(os.path.join(output_folder, f"{split}_META_{base}.json"), "w") as f:
            json.dump({"captions_per_image": captions_per_image, "num_images": n}, f)
    return word_map
