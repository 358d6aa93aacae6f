"""The port's data records, dataset, loader, vocabulary and word embeddings
against the JAX package's, on the CPU, on files the tests write themselves
(a synthetic dataset, a tiny Karpathy split with PNG images, reference-format
HDF5 records, GloVe and word2vec tables).  Everything here is exact: the
same files byte for byte, the same batches, the same tables."""

import json
import os
import struct
import threading

import numpy as np
import pytest
import torch

from tpu_captioner.data import build as jax_build
from tpu_captioner.data import dataset as jax_dataset
from tpu_captioner.data import vocab as jax_vocab
from tpu_captioner.models import embeddings as jax_embeddings
from tpu_captioner_torch.core.config import ModelConfig
from tpu_captioner_torch.data import build, dataset, vocab
from tpu_captioner_torch.data.loader import DeviceLoader, prefetch_to_device, resolve_num_devices
from tpu_captioner_torch.models import embeddings
from tpu_captioner_torch.train.model import CaptionModel

BASE = "synthetic_5_cap_per_img_1_min_word_freq"
SPLITS = {"TRAIN": 7, "VAL": 3, "TEST": 2}


def same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


@pytest.mark.parametrize("learnable", [False, True])
def test_synthetic_dataset_is_byte_identical(tmp_path, learnable):
    kw = dict(num_images=dict(SPLITS), vocab_words=37, max_len=12, image_size=16, seed_=3,
              learnable=learnable, n_classes=5)
    want = jax_build.build_synthetic_dataset(str(tmp_path / "jax"), **kw)
    got = build.build_synthetic_dataset(str(tmp_path / "port"), **kw)
    assert got == want and len(got) == 37 + 4
    same_files(tmp_path / "jax", tmp_path / "port")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("records")
    build.build_synthetic_dataset(str(d), num_images=dict(SPLITS), max_len=12, image_size=16, seed_=1)
    return str(d)


def batch_fields(b):
    return {k: np.asarray(v) for k, v in b.as_dict().items()}


@pytest.mark.parametrize("split,shuffle", [("TRAIN", True), ("VAL", False), ("TEST", False)])
def test_batches_match_jax(records, split, shuffle):
    """Epochs 0 and 1 at a batch size that leaves a short final batch: the
    same rows, wrap-around padding and ``valid`` flags (and, for VAL/TEST,
    every reference caption)."""
    ds, jds = dataset.CaptionDataset(records, BASE, split), jax_dataset.CaptionDataset(records, BASE, split)
    assert len(ds) == len(jds) == 5 * SPLITS[split] and ds.cpi == 5 and ds.max_caption_len == 14
    for epoch in (0, 1):
        got = list(dataset.iterate_batches(ds, 4, epoch=epoch, seed=42, shuffle=shuffle))
        want = list(jax_dataset.iterate_batches(jds, 4, epoch=epoch, seed=42, shuffle=shuffle))
        assert len(got) == len(want) == -(-len(ds) // 4)
        for g, w in zip(got, want):
            assert type(g).__name__ == type(w).__name__
            gf, wf = batch_fields(g), batch_fields(w)
            assert set(gf) == set(wf)
            for k in gf:
                np.testing.assert_array_equal(gf[k], wf[k], err_msg=k)
                assert gf[k].dtype == wf[k].dtype, k
        assert (~got[-1].valid).sum() == 4 * len(got) - len(ds)
    np.testing.assert_array_equal(dataset.epoch_indices(35, 1, 42), jax_dataset.epoch_indices(35, 1, 42))
    assert not np.array_equal(dataset.epoch_indices(35, 0), dataset.epoch_indices(35, 1))
    assert len(list(dataset.iterate_batches(ds, 4, pad_final=False))) == len(ds) // 4
    imgs = np.random.default_rng(0).integers(0, 256, (2, 4, 4, 3), dtype=np.uint8)
    np.testing.assert_array_equal(dataset.normalize_images_host(imgs), jax_dataset.normalize_images_host(imgs))


def test_vocab_helpers_match_jax(tmp_path):
    caps = [["a", "dog", "runs"], ["a", "cat"], ["the", "dog"], ["a", "dog", "a"]]
    for min_freq in (0, 1, 2):
        assert vocab.build_word_map(caps, min_freq) == jax_vocab.build_word_map(caps, min_freq)
    wm = vocab.build_word_map(caps, 1)
    for tokens in (["a", "dog"], ["zebra", "a"], []):
        assert vocab.encode_caption(tokens, wm, 6) == jax_vocab.encode_caption(tokens, wm, 6)
    assert vocab.special_ids(wm) == jax_vocab.special_ids(wm)
    rev = vocab.inverse_word_map(wm)
    assert rev == jax_vocab.inverse_word_map(wm)
    ids = vocab.encode_caption(["a", "dog"], wm, 3)[0]
    assert vocab.decode_ids(ids, rev) == jax_vocab.decode_ids(ids, rev) == ["<start>", "a", "dog", "<end>", "<pad>"]
    vocab.save_word_map(wm, str(tmp_path / "wm.json"))
    assert vocab.load_word_map(str(tmp_path / "wm.json")) == jax_vocab.load_word_map(str(tmp_path / "wm.json")) == wm


def test_karpathy_build_is_byte_identical(tmp_path):
    """``create_input_files`` on a tiny Karpathy split with PNG images of
    mixed modes and sizes: the same records, word map and metadata."""
    from PIL import Image

    rng = np.random.default_rng(4)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    words = ["a", "man", "dog", "on", "the", "grass", "red", "ball"]
    images = []
    for i, (split, mode) in enumerate([("train", "RGB"), ("restval", "L"), ("val", "RGB"), ("test", "RGBA"),
                                       ("train", "RGB"), ("other", "RGB")]):
        size = (20 + 3 * i, 17 + i)
        arr = rng.integers(0, 256, (size[1], size[0], len(mode)), dtype=np.uint8)
        Image.fromarray(arr[..., 0] if mode == "L" else arr, mode).save(img_dir / f"im{i}.png")
        n_caps = 2 if i == 0 else 4
        sentences = [{"tokens": list(rng.choice(words, int(rng.integers(2, 7))))} for _ in range(n_caps)]
        sentences.append({"tokens": words * 2})  # longer than max_len: counted, then dropped
        images.append({"filename": f"im{i}.png", "split": split, "sentences": sentences})
    with open(tmp_path / "karpathy.json", "w") as f:
        json.dump({"images": images}, f)
    args = ("flickr8k", str(tmp_path / "karpathy.json"), str(img_dir), 3, 1)
    want = jax_build.create_input_files(*args, str(tmp_path / "jax"), max_len=10, image_size=24)
    got = build.create_input_files(*args, str(tmp_path / "port"), max_len=10, image_size=24)
    assert got == want
    same_files(tmp_path / "jax", tmp_path / "port")


@pytest.fixture(scope="module")
def reference_records(tmp_path_factory):
    """Reference-format records: NCHW uint8 HDF5 images and caption JSONs."""
    import h5py

    d = tmp_path_factory.mktemp("reference")
    name = "coco_2_cap_per_img_5_min_word_freq"
    rng = np.random.default_rng(7)
    with open(d / f"WORDMAP_{name}.json", "w") as f:
        json.dump({"<pad>": 0, "a": 1, "<unk>": 2, "<start>": 3, "<end>": 4}, f)
    for split, n in (("TRAIN", 5), ("VAL", 3), ("TEST", 2)):
        with h5py.File(d / f"{split}_IMAGES_{name}.hdf5", "w") as h:
            h.attrs["captions_per_image"] = 2
            h.create_dataset("images", data=rng.integers(0, 256, (n, 3, 8, 8), dtype=np.uint8))
        caps = [[3] + [1] * int(k) + [4] + [0] * (4 - int(k)) for k in rng.integers(0, 5, 2 * n)]
        with open(d / f"{split}_CAPTIONS_{name}.json", "w") as f:
            json.dump(caps, f)
        with open(d / f"{split}_CAPLENS_{name}.json", "w") as f:
            json.dump([c.index(4) + 1 for c in caps], f)
    return str(d), name


def test_reference_records_convert_and_read_as_jax(reference_records, tmp_path):
    folder, name = reference_records
    jax_build.convert_reference_artifacts(folder, name, str(tmp_path / "jax"))
    build.convert_reference_artifacts(folder, name, str(tmp_path / "port"))
    same_files(tmp_path / "jax", tmp_path / "port")
    for split in ("TRAIN", "VAL"):
        from_h5 = dataset.CaptionDataset(folder, name, split)
        from_npy = dataset.CaptionDataset(str(tmp_path / "port"), name, split)
        jds = jax_dataset.CaptionDataset(folder, name, split)
        idx = np.array([len(jds) - 1, 0, 3])
        want = batch_fields(jds.gather(idx))
        for ds in (from_h5, from_npy):
            got = batch_fields(ds.gather(idx))
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(FileNotFoundError):
        dataset.CaptionDataset(folder, "missing", "TRAIN")


def test_cpu_loader_yields_the_host_batches(records):
    """On the CPU the loader's background thread yields host tensors equal
    to ``iterate_batches``' arrays, in order."""
    ds = dataset.CaptionDataset(records, BASE, "VAL")
    loader = DeviceLoader(ds, 4, device="cpu", shuffle=False)
    assert len(loader) == 4
    got = list(loader.epoch(1))
    want = list(dataset.iterate_batches(ds, 4, epoch=1, shuffle=False))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w.as_dict())
        for k, v in w.as_dict().items():
            assert g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), v, err_msg=k)


def test_loader_shutdown_and_errors():
    """A consumer that stops early leaves no thread behind; an error in the
    host iterator reaches the consumer; only cpu and cuda are taken."""

    def batches(n, fail_at=None):
        for i in range(n):
            if i == fail_at:
                raise RuntimeError("bad record")
            yield dataset.Batch(np.full((1, 2, 2, 3), i, np.uint8), np.zeros((1, 3), np.int32),
                                np.ones(1, np.int32), np.ones(1, bool))

    before = threading.active_count()
    it = prefetch_to_device(batches(50), "cpu", depth=2)
    assert int(next(it)["images"][0, 0, 0, 0]) == 0
    it.close()
    assert threading.active_count() == before
    with pytest.raises(RuntimeError, match="bad record"):
        list(prefetch_to_device(batches(5, fail_at=3), "cpu"))
    assert threading.active_count() == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        next(prefetch_to_device(batches(1), "meta"))


def test_more_than_one_device_raises(records):
    assert resolve_num_devices(0, "cpu") == resolve_num_devices(1, "cpu") == 1
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 #9"):
        resolve_num_devices(2, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 #9"):
        DeviceLoader(dataset.CaptionDataset(records, BASE, "VAL"), 4, device="cpu", num_devices=4)


@pytest.fixture(scope="module")
def word_tables(tmp_path_factory):
    """A word map, and one table of vectors as GloVe text (gzipped too) and
    as a word2vec binary."""
    import gzip

    d = tmp_path_factory.mktemp("emb")
    wm = {"<pad>": 0, "dog": 1, "cat": 2, "zebra": 3, "<unk>": 4, "<start>": 5, "<end>": 6}
    rng = np.random.default_rng(2)
    table = {w: rng.standard_normal(6).astype(np.float32) for w in ("dog", "cat", "tree", "<unk>")}
    lines = "".join(f"{w} " + " ".join(repr(float(x)) for x in v) + "\n" for w, v in table.items())
    (d / "glove.txt").write_text(lines + "short 1.0\n")
    with gzip.open(d / "glove.txt.gz", "wt") as f:
        f.write(lines)
    with open(d / "word2vec.bin", "wb") as f:
        f.write(f"{len(table)} 6\n".encode())
        for w, v in table.items():
            f.write(w.encode() + b" " + struct.pack("6f", *v) + b"\n")
    return d, wm


@pytest.mark.parametrize("name", ["glove.txt", "glove.txt.gz", "word2vec.bin"])
def test_word_tables_match_jax(word_tables, tmp_path, name):
    d, wm = word_tables
    got = embeddings.load_pretrained_word_embeddings(wm, str(d / name), 6)
    want = jax_embeddings.load_pretrained_word_embeddings(wm, str(d / name), 6)
    np.testing.assert_array_equal(got, want)
    assert got[wm["dog"]].any() and not got[wm["zebra"]].any() and not got[0].any()
    embeddings.extract_embeddings_npz(str(d / name), wm, 6, str(tmp_path / "port.npz"))
    jax_embeddings.extract_embeddings_npz(str(d / name), wm, 6, str(tmp_path / "jax.npz"))
    for path in ("port.npz", "jax.npz"):
        for load in (embeddings.load_pretrained_word_embeddings, jax_embeddings.load_pretrained_word_embeddings):
            np.testing.assert_array_equal(load(wm, str(tmp_path / path), 6), want)


def test_model_takes_the_table_and_pins_the_pad_row(word_tables):
    d, wm = word_tables
    table = embeddings.load_pretrained_word_embeddings(wm, str(d / "glove.txt"), 6)
    table[0] = 9.0  # the pad row is pinned at lookup, whatever the table holds
    small = dict(vocab_size=len(wm), embed_dim=6, num_heads=2, decoder_dim=8, num_layers=1,
                 encoder_depths=(1, 1, 1, 1), encoder_dims=(8, 8, 8, 8), encoder_dim=8, embedding_path=str(d))
    model = CaptionModel(ModelConfig(**small), device="cpu", pretrained_embeddings=table)
    np.testing.assert_array_equal(model.decoder.embedding.weight.detach().numpy(), table)
    emb = model.decoder.embed(torch.tensor([0, 1]), 0)
    torch.testing.assert_close(emb[0], model.decoder.pe[0])
    torch.testing.assert_close(emb[1], torch.from_numpy(table[1]) + model.decoder.pe[0])
    with pytest.raises(ValueError, match="pretrained embedding shape"):
        CaptionModel(ModelConfig(**small), device="cpu", pretrained_embeddings=table[:, :4])
    lstm = CaptionModel(ModelConfig(**{**small, "decoder": "lstm", "attention_dim": 4}), device="cpu",
                        pretrained_embeddings=table)
    assert not np.array_equal(lstm.decoder.embedding.weight.detach().numpy(), table)  # as JAX: LSTMs ignore it
