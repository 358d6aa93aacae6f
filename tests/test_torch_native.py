"""The port's native host runtime (``tpu_captioner_torch/native``) against the
JAX package's and the plain versions, on the CPU.

- BLEU-1..4 from the C++ counts equal ``eval/bleu.py``'s pure-Python scores
  exactly, and the JAX package's native ones to 1e-14 relative, on random
  corpora with exact, partial, disjoint, one-token and empty hypotheses,
  and on the degenerate corpora (no unigram match, every hypothesis empty,
  no hypothesis).  The JAX wrapper sums the weighted logs with ``sum()``,
  which Python 3.12 compensates; the plain scorer, and the port, add them
  in turn: the two may part in the last bit.
- The threaded gather equals numpy's fancy indexing and JAX's
  ``gather_batch_native`` bit for bit, on arrays and on memmapped records,
  and ``CaptionDataset.gather`` goes through it; an index out of range
  raises instead of reading past the records.
- The library lands in ``build/native/`` under a hash of its flags and
  sources, an edited source gets another name, two processes building into
  one empty directory at once both load it, and a compiler that fails
  raises with its stderr: nothing falls back.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tpu_captioner.native.bleu_native import bleu_1_to_4 as jax_native_bleu
from tpu_captioner.native.gather import gather_batch_native as jax_gather
from tpu_captioner.native.lib import native_available as jax_native_available
from tpu_captioner_torch.eval.bleu import bleu_1_to_4 as plain_bleu
from tpu_captioner_torch.native import bleu_native, gather, lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def corpus(seed, n, vocab=40):
    rng = np.random.default_rng(seed)
    refs, hyps = [], []
    for i in range(n):
        rs = [[int(w) for w in rng.integers(1, vocab, rng.integers(1, 16))] for _ in range(rng.integers(1, 6))]
        kind = i % 5
        if kind == 0:
            h = list(rs[0])
        elif kind == 1:
            h = [int(w) for w in rng.integers(1, vocab, rng.integers(1, 12))]
        elif kind == 2:
            h = [int(w) for w in rng.integers(vocab, vocab + 10, 3)]  # no overlap
        elif kind == 3:
            h = [int(rng.integers(1, vocab))]
        else:
            h = []
        refs.append(rs)
        hyps.append(h)
    return refs, hyps


@pytest.mark.parametrize("seed,n", [(0, 60), (1, 400), (2, 3)])
def test_bleu_equals_python_and_jax_native(seed, n):
    refs, hyps = corpus(seed, n)
    got = bleu_native.bleu_1_to_4(refs, hyps)
    assert got == plain_bleu(refs, hyps)
    assert jax_native_available()
    assert got == pytest.approx(jax_native_bleu(refs, hyps), rel=1e-14, abs=1e-300)
    assert 0 < got[0] <= 1 and all(isinstance(b, float) for b in got)


@pytest.mark.parametrize("refs,hyps", [
    ([[[1, 2, 3]]], [[9, 9, 9]]),  # no unigram matches: 0 at every order
    ([[[1, 2, 3]], [[4, 5]]], [[], []]),  # every hypothesis empty
    ([], []),  # no hypothesis
    ([[[1, 2, 3, 4]]], [[1, 2, 3, 4]]),  # exact: 1 at every order
    ([[[1, 2, 3, 4, 5, 6]]], [[1, 2]]),  # short: the brevity penalty, 0-match higher orders
])
def test_bleu_degenerate_corpora(refs, hyps):
    got = bleu_native.bleu_1_to_4(refs, hyps)
    assert got == plain_bleu(refs, hyps)
    assert got == pytest.approx(jax_native_bleu(refs, hyps), rel=1e-14, abs=1e-300)
    if not refs or not any(hyps):
        assert got == (0.0, 0.0, 0.0, 0.0)


def test_bleu_refuses_unpaired_corpora():
    with pytest.raises(ValueError, match="reference lists"):
        bleu_native.bleu_1_to_4([[[1]]], [])


def records(seed=0, n_images=10, cpi=5, size=8, length=12):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n_images, size, size, 3), dtype=np.uint8)
    captions = rng.integers(0, 50, (n_images * cpi, length)).astype(np.int32)
    caplens = rng.integers(2, length, (n_images * cpi,)).astype(np.int32)
    return images, captions, caplens


@pytest.mark.parametrize("n_threads", [0, 1, 3, 64])
def test_gather_equals_numpy_and_jax(tmp_path, n_threads):
    images, captions, caplens = records()
    np.save(tmp_path / "images.npy", images)
    mapped = np.load(tmp_path / "images.npy", mmap_mode="r")
    cap_idx = np.array([3, 17, 42, 0, 49, 17, 8])
    img_idx = cap_idx // 5
    for src in (images, mapped):
        got = gather.gather_batch_native(src, captions, caplens, img_idx, cap_idx, n_threads=n_threads)
        want = (images[img_idx], captions[cap_idx], caplens[cap_idx])
        jax = jax_gather(src, captions, caplens, img_idx, cap_idx, n_threads=n_threads)
        for a, b, c in zip(got, want, jax):
            assert a.dtype == b.dtype == c.dtype and a.flags.c_contiguous
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_gather_refuses_what_it_cannot_copy():
    images, captions, caplens = records()
    with pytest.raises(IndexError, match="image index"):
        gather.gather_batch_native(images, captions, caplens, np.array([10]), np.array([0]))
    with pytest.raises(IndexError, match="caption index"):
        gather.gather_batch_native(images, captions, caplens, np.array([0]), np.array([-1]))
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        gather.gather_batch_native(images[:, ::2], captions, caplens, np.array([0]), np.array([0]))
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        gather.gather_batch_native(images.astype(np.int32), captions, caplens, np.array([0]), np.array([0]))


def test_dataset_gathers_through_the_native_gather(tmp_path, monkeypatch):
    from tpu_captioner_torch.data import dataset
    from tpu_captioner_torch.data.build import build_synthetic_dataset

    build_synthetic_dataset(str(tmp_path), num_images={"TRAIN": 6, "VAL": 4, "TEST": 4}, max_len=10, image_size=16)
    calls = []
    real = dataset.gather_batch_native
    monkeypatch.setattr(dataset, "gather_batch_native", lambda *a, **k: calls.append(1) or real(*a, **k))
    name = "synthetic_5_cap_per_img_1_min_word_freq"
    for split in ("TRAIN", "VAL"):
        ds = dataset.CaptionDataset(str(tmp_path), name, split)
        idx = np.random.default_rng(0).permutation(len(ds))[:7]
        b = ds.gather(idx)
        np.testing.assert_array_equal(b.images, ds.images[idx // ds.cpi])
        np.testing.assert_array_equal(b.captions, ds.captions[idx])
        np.testing.assert_array_equal(b.caplens, ds.caplens[idx])
    assert len(calls) == 2


def test_library_lands_under_its_hash():
    path = lib.build()
    assert path == lib.library_path() and path.exists()
    assert path.parent == lib.BUILD_DIR and str(lib.BUILD_DIR) == os.path.join(ROOT, "build", "native")
    assert path.name.startswith("libtcnative-") and len(path.name) == len("libtcnative-") + 16 + len(".so")
    assert lib.get_lib()._name == str(path)


def test_an_edited_source_builds_anew(tmp_path, monkeypatch):
    for name in lib.SOURCES:
        shutil.copy(lib.SRC_DIR / name, tmp_path / name)
    monkeypatch.setattr(lib, "SRC_DIR", tmp_path)
    same = lib.library_path()
    with open(tmp_path / "bleu.cpp", "a") as f:
        f.write("\n// edited\n")
    assert lib.library_path() != same
    monkeypatch.setattr(lib, "SRC_DIR", lib.Path(lib.__file__).resolve().parent)
    assert lib.library_path() == same


def test_two_processes_build_at_once(tmp_path):
    """Both start on an empty build directory, build at once (each into a
    temporary name renamed into place), load the library and score."""
    code = textwrap.dedent(
        """
        import sys
        from pathlib import Path
        from tpu_captioner_torch.native import lib
        from tpu_captioner_torch.native.bleu_native import bleu_1_to_4
        lib.BUILD_DIR = Path(sys.argv[1])
        print(lib.get_lib()._name, bleu_1_to_4([[[1, 2, 3, 4]]], [[1, 2, 3, 4]]))
        """
    )
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    lines = {o.strip() for o, _ in outs}
    assert len(lines) == 1, lines
    (line,) = lines
    assert line.endswith("(1.0, 1.0, 1.0, 1.0)") and os.path.basename(line.split()[0]).startswith("libtcnative-")
    assert [f for f in os.listdir(tmp_path)] == [os.path.basename(line.split()[0])]


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    monkeypatch.setattr(lib, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(lib, "FLAGS", lib.FLAGS + ("-DNOT_BUILT_HERE",))
    monkeypatch.setattr(lib, "COMPILER", sys.executable)  # not a compiler: exits 2 with a usage error on stderr
    lib.get_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="failed to build the native runtime") as err:
            lib.build()
        assert "-DNOT_BUILT_HERE" in str(err.value)
        with pytest.raises(RuntimeError, match="failed to build"):
            bleu_native.bleu_1_to_4([[[1, 2]]], [[1, 2]])
        images, captions, caplens = records()
        with pytest.raises(RuntimeError, match="failed to build"):
            gather.gather_batch_native(images, captions, caplens, np.array([0]), np.array([0]))
        assert os.listdir(tmp_path / "native") == []  # the temporary file is removed
        monkeypatch.setattr(lib, "COMPILER", str(tmp_path / "no-such-compiler"))
        with pytest.raises(RuntimeError, match="cannot run"):
            lib.build()
    finally:
        lib.get_lib.cache_clear()
