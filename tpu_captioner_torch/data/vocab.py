"""Word maps and caption encoding (a copy of ``tpu_captioner/data/vocab.py``,
which is plain Python; the port imports nothing of the JAX package).

The reference's vocabulary semantics (utils/utils.py:49-94, 141-150):
- word frequencies are counted over every caption token, including captions
  later dropped for exceeding ``max_len``;
- kept words are those with frequency strictly greater than
  ``min_word_freq``, in first-seen order;
- ids: ``<pad>`` = 0, words 1..W, then ``<unk>``, ``<start>``, ``<end>``;
- encoding: ``<start> w1..wn <end> <pad>*(max_len-n)`` with caplen n + 2.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

PAD, UNK, START, END = "<pad>", "<unk>", "<start>", "<end>"


def build_word_map(tokenized_captions: Iterable[Sequence[str]], min_word_freq: int) -> Dict[str, int]:
    """The word -> id map of an iterable of token lists."""
    freq = Counter()
    for tokens in tokenized_captions:
        freq.update(tokens)
    words = [w for w in freq.keys() if freq[w] > min_word_freq]
    word_map = {w: i + 1 for i, w in enumerate(words)}
    word_map[UNK] = len(word_map) + 1
    word_map[START] = len(word_map) + 1
    word_map[END] = len(word_map) + 1
    word_map[PAD] = 0
    return word_map


def encode_caption(tokens: Sequence[str], word_map: Dict[str, int], max_len: int) -> Tuple[List[int], int]:
    """One caption -> (ids of length max_len + 2, caplen)."""
    unk = word_map[UNK]
    ids = (
        [word_map[START]]
        + [word_map.get(w, unk) for w in tokens]
        + [word_map[END]]
        + [word_map[PAD]] * (max_len - len(tokens))
    )
    return ids, len(tokens) + 2


def load_word_map(path: str) -> Dict[str, int]:
    with open(path, "r") as f:
        return json.load(f)


def save_word_map(word_map: Dict[str, int], path: str) -> None:
    with open(path, "w") as f:
        json.dump(word_map, f)


def inverse_word_map(word_map: Dict[str, int]) -> Dict[int, str]:
    return {v: k for k, v in word_map.items()}


def decode_ids(ids: Sequence[int], rev_map: Dict[int, str]) -> List[str]:
    return [rev_map[int(i)] for i in ids]


def special_ids(word_map: Dict[str, int]) -> Dict[str, int]:
    """The ids of ``<pad>``, ``<unk>``, ``<start>`` and ``<end>``."""
    return {name: word_map[name] for name in (PAD, UNK, START, END)}
