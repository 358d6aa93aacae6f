"""Corpus BLEU, reproducing nltk.translate.bleu_score.corpus_bleu exactly (a
copy of ``tpu_captioner/eval/bleu.py``, which is pure Python).

The reference scores BLEU-1..4 with nltk's default (unsmoothed) corpus_bleu
(train.py:434-437, test.py:208-211).  nltk quirks reproduced here:

- modified n-gram precision: clipped match counts summed over the corpus;
- brevity penalty uses the reference length closest to each hypothesis
  (ties -> shorter reference);
- NO smoothing: a zero higher-order precision is replaced by
  ``sys.float_info.min`` (nltk method0), which produces the degenerate
  ~1e-77/1e-154 values visible in the reference's early-epoch CSVs;
- weights are applied as exp(sum w_i log p_i).

Pure Python on the host; hypotheses/references are lists of token-id lists
(ids, not strings — BLEU only needs equality).
"""

from __future__ import annotations

import math
import sys
from collections import Counter
from typing import List, Sequence, Tuple

Weights = Tuple[float, ...]

BLEU_WEIGHTS = {
    1: (1.0, 0.0, 0.0, 0.0),
    2: (0.5, 0.5, 0.0, 0.0),
    3: (0.33, 0.33, 0.33, 0.0),  # reference uses 0.33 not 1/3 (train.py:436)
    4: (0.25, 0.25, 0.25, 0.25),
}


def _ngrams(seq: Sequence, n: int):
    return zip(*(seq[i:] for i in range(n)))


def modified_precision(
    references: List[List[Sequence]], hypotheses: List[Sequence], n: int
) -> Tuple[int, int]:
    """Corpus-level clipped matches and totals for order n."""
    num, den = 0, 0
    for refs, hyp in zip(references, hypotheses):
        hyp_counts = Counter(_ngrams(hyp, n))
        max_ref = Counter()
        for ref in refs:
            ref_counts = Counter(_ngrams(ref, n))
            for g, c in ref_counts.items():
                if c > max_ref[g]:
                    max_ref[g] = c
        num += sum(min(c, max_ref[g]) for g, c in hyp_counts.items())
        # nltk clamps each sentence's denominator to >= 1: a hypothesis too
        # short to have any n-gram still contributes denominator 1.
        den += max(1, sum(hyp_counts.values()))
    return num, den


def closest_ref_length(refs: List[Sequence], hyp_len: int) -> int:
    return min((abs(len(r) - hyp_len), len(r)) for r in refs)[1]


def brevity_penalty(ref_len: int, hyp_len: int) -> float:
    if hyp_len > ref_len:
        return 1.0
    if hyp_len == 0:
        return 0.0
    return math.exp(1 - ref_len / hyp_len)


def corpus_bleu(
    references: List[List[Sequence]],
    hypotheses: List[Sequence],
    weights: Weights = (0.25, 0.25, 0.25, 0.25),
) -> float:
    assert len(references) == len(hypotheses)
    hyp_len = sum(len(h) for h in hypotheses)
    ref_len = sum(
        closest_ref_length(refs, len(h)) for refs, h in zip(references, hypotheses)
    )
    bp = brevity_penalty(ref_len, hyp_len)
    # nltk: zero unigram matches -> BLEU is exactly 0 for every order.
    if modified_precision(references, hypotheses, 1)[0] == 0:
        return 0.0
    s = 0.0
    for i, w in enumerate(weights):
        if w == 0.0:
            continue
        num, den = modified_precision(references, hypotheses, i + 1)
        if num == 0:
            # nltk SmoothingFunction method0: replace zero precision with the
            # smallest positive float (emits the degenerate tiny BLEU values).
            p = sys.float_info.min
        else:
            p = num / den
        s += w * math.log(p)
    return bp * math.exp(s)


def bleu_1_to_4(references, hypotheses) -> Tuple[float, float, float, float]:
    return tuple(
        corpus_bleu(references, hypotheses, BLEU_WEIGHTS[n]) for n in (1, 2, 3, 4)
    )
