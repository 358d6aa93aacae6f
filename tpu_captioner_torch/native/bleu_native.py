"""Corpus BLEU with the n-gram counting in C++ (counterpart of
``tpu_captioner/native/bleu_native.py``).

The same numbers as ``eval/bleu.py`` (nltk's unsmoothed ``corpus_bleu``):
``native/bleu.cpp`` sums the clipped matches, the per-sentence denominators
(each at least 1) and the brevity penalty's lengths in one pass; the zero
precision's ``sys.float_info.min`` and the weighted sum of logs run here, as
there.  The reference scores ~25k COCO hypotheses per validation epoch; the
pure-Python Counter loops take seconds of host time for that.  A library
that does not build raises (``native/lib.py``); nothing falls back.
"""

from __future__ import annotations

import ctypes
import itertools
import math
import sys
from typing import List, Sequence, Tuple

import numpy as np

from tpu_captioner_torch.eval.bleu import BLEU_WEIGHTS, brevity_penalty
from tpu_captioner_torch.native.lib import get_lib, ptr


def _flatten(sentences: List[Sequence[int]]) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens int32, offsets int64 with len(sentences) + 1 entries)."""
    offsets = np.zeros(len(sentences) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in sentences], out=offsets[1:])
    tokens = np.fromiter(itertools.chain.from_iterable(sentences), dtype=np.int32, count=int(offsets[-1]))
    return tokens, offsets


def corpus_bleu_stats(
    references: List[List[Sequence[int]]], hypotheses: List[Sequence[int]], max_order: int = 4
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """(numerators[max_order], denominators[max_order], hypotheses' length,
    closest references' length), summed over the corpus."""
    if len(references) != len(hypotheses):
        raise ValueError(f"{len(references)} reference lists for {len(hypotheses)} hypotheses")
    lib = get_lib()
    c = ctypes
    hyp_tokens, hyp_offsets = _flatten(hypotheses)
    ref_tokens, ref_offsets = _flatten([r for refs in references for r in refs])
    ref_counts = np.asarray([len(r) for r in references], dtype=np.int64)
    nums = np.zeros(max_order, dtype=np.int64)
    dens = np.zeros(max_order, dtype=np.int64)
    hyp_len, ref_len = c.c_int64(0), c.c_int64(0)
    lib.corpus_bleu_stats(
        ptr(hyp_tokens, c.c_int32), ptr(hyp_offsets, c.c_int64), len(hypotheses),
        ptr(ref_tokens, c.c_int32), ptr(ref_offsets, c.c_int64), ptr(ref_counts, c.c_int64),
        max_order, ptr(nums, c.c_int64), ptr(dens, c.c_int64), c.byref(hyp_len), c.byref(ref_len),
    )
    return nums, dens, int(hyp_len.value), int(ref_len.value)


def bleu_1_to_4(
    references: List[List[Sequence[int]]], hypotheses: List[Sequence[int]]
) -> Tuple[float, float, float, float]:
    """BLEU-1..4 from one counting pass, equal to ``eval/bleu.py``'s."""
    nums, dens, hyp_len, ref_len = corpus_bleu_stats(references, hypotheses, 4)
    if nums[0] == 0:  # nltk: no unigram match gives 0 at every order
        return (0.0, 0.0, 0.0, 0.0)
    bp = brevity_penalty(ref_len, hyp_len)
    logp = [math.log(int(n) / int(d)) if n > 0 else math.log(sys.float_info.min) for n, d in zip(nums, dens)]
    out = []
    for n in (1, 2, 3, 4):
        s = 0.0
        for w, lp in zip(BLEU_WEIGHTS[n], logp):
            if w:
                s += w * lp
        out.append(bp * math.exp(s))
    return tuple(out)
