"""Token metrics of training (counterpart of ``tpu_captioner/eval/metrics.py``).

``masked_cross_entropy`` and ``topk_correct`` with the JAX package's
semantics; ``rollout_token_mask`` and BLEU belong to the eval slice and are
not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def masked_cross_entropy(
    logits: torch.Tensor,  # (B, T, V)
    targets: torch.Tensor,  # (B, T) int
    mask: torch.Tensor,  # (B, T) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of token cross-entropy over ``mask``, token count), in f32.
    Callers divide for the mean, as ``nn.CrossEntropyLoss`` over packed
    tokens does."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
    m = mask.float()
    return ((lse - tgt) * m).sum(), m.sum()


def topk_correct(
    logits: torch.Tensor,  # (..., V)
    targets: torch.Tensor,  # (...,)
    k: int,
    mask: Optional[torch.Tensor] = None,  # (...,) bool
) -> torch.Tensor:
    """Count of positions whose target is among the top ``k`` logits,
    ``mask``-weighted (utils/utils.py:239-254).  The target's rank is the
    number of logits strictly greater than its own, so a tie counts in the
    target's favour, as in the JAX package."""
    target_logit = logits.gather(-1, targets.long()[..., None])
    rank = (logits > target_logit).sum(dim=-1)
    correct = rank < k
    if mask is not None:
        correct = correct & mask
    return correct.sum()
