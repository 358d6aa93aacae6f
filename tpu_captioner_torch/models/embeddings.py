"""Pretrained word embeddings (counterpart of
``tpu_captioner/models/embeddings.py``; reference transformerDecoder.py:29-42).

Reads GloVe text and word2vec binary files (optionally gzipped) without
gensim, or the compact ``.npz`` that ``extract_embeddings_npz`` writes
(``EMBEDDING_PRESETS`` point at those).  Rows of out-of-vocabulary words are
zero, as in the reference's zero-initialised matrix.  The table goes to
``CaptionModel(pretrained_embeddings=...)``; the model pins the ``<pad>``
row to zero at lookup when ``embedding_path`` is set (padding_idx
semantics, transformerDecoder.py:74).
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, Iterable, Tuple

import numpy as np


def _open_maybe_gzip(path: str, mode: str = "rb"):
    return gzip.open(path, mode) if path.endswith(".gz") else open(path, mode)


def _iter_word2vec_binary(f) -> Iterable[Tuple[str, np.ndarray]]:
    header = f.readline().split()
    vocab_size, dim = int(header[0]), int(header[1])
    for _ in range(vocab_size):
        word_bytes = b""
        while True:
            ch = f.read(1)
            if ch == b" ":
                break
            if ch != b"\n":
                word_bytes += ch
        yield word_bytes.decode("utf-8", errors="replace"), np.frombuffer(f.read(4 * dim), dtype=np.float32)


def _iter_glove_text(f) -> Iterable[Tuple[str, np.ndarray]]:
    for line in f:
        if isinstance(line, bytes):
            line = line.decode("utf-8", errors="replace")
        parts = line.rstrip().split(" ")
        if len(parts) >= 2:
            yield parts[0], np.asarray(parts[1:], dtype=np.float32)


def load_pretrained_word_embeddings(word_map: Dict[str, int], path: str, embed_dim: int) -> np.ndarray:
    """The (vocab, embed_dim) table of ``word_map``'s words from ``path``: an
    ``.npz`` of ``extract_embeddings_npz``, a word2vec binary ('word2vec' in
    the file name) or GloVe text.  Missing words get zero rows."""
    matrix = np.zeros((len(word_map), embed_dim), dtype=np.float32)
    if path.endswith(".npz"):
        data = np.load(path, allow_pickle=False)
        lut = {str(w): i for i, w in enumerate(data["words"])}
        vecs = data["vectors"]
        for word, idx in word_map.items():
            j = lut.get(word)
            if j is not None:
                matrix[idx] = vecs[j][:embed_dim]
        return matrix
    binary = "word2vec" in os.path.basename(path)
    with _open_maybe_gzip(path, "rb") as f:
        for word, vec in (_iter_word2vec_binary(f) if binary else _iter_glove_text(f)):
            idx = word_map.get(word)
            if idx is not None and len(vec) == embed_dim:
                matrix[idx] = vec
    return matrix


def extract_embeddings_npz(raw_path: str, word_map: Dict[str, int], embed_dim: int, out_path: str) -> None:
    """Raw embedding file -> ``.npz`` of the vocabulary's rows; row i is the
    word whose id is i."""
    matrix = load_pretrained_word_embeddings(word_map, raw_path, embed_dim)
    words = np.array(sorted(word_map, key=word_map.get))
    np.savez_compressed(out_path, words=words, vectors=matrix)
