"""Token metrics (counterpart of ``tpu_captioner/eval/metrics.py``).

The JAX package's semantics:
- ``AverageMeter``, the host meter of the training loop (utils/utils.py:163);
- ``masked_cross_entropy`` and ``topk_correct`` (utils/utils.py:239-254);
- ``decode_lengths_from_sequences`` and ``rollout_token_mask``, which express
  the reference's ``preprocessDecoderOutputForMetrics`` (utils/utils.py:
  261-295) as masks over fixed (B, T) grids: a row's length is the index of
  its first ``<end>`` plus one (else the decode cap), and a (row, step)
  token counts when the step is below that length and the aligned target
  ``captions[row, 1 + step]`` is not ``<pad>``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


class AverageMeter:
    """Most recent value, sum, count and average of a metric
    (utils/utils.py:163-180)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0


def decode_lengths_from_sequences(
    sequences: torch.Tensor, end_id: int, max_decode_len: int
) -> torch.Tensor:
    """(B, T) sequences -> (B,) int32 lengths: first ``end_id`` index + 1,
    else ``max_decode_len``."""
    is_end = sequences == end_id
    first_end = is_end.int().argmax(dim=1)  # the first maximum
    return torch.where(is_end.any(dim=1), first_end + 1, max_decode_len).to(torch.int32)


def rollout_token_mask(
    sequences: torch.Tensor,
    captions: torch.Tensor,
    end_id: int,
    pad_id: int,
    max_decode_len: int,
    row_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (mask (B, T) bool, targets (B, T) int32, lengths (B,) int32).
    ``targets[:, t] = captions[:, 1 + t]`` is the token step t should
    predict (utils/utils.py:278); the mask keeps steps below the length whose
    target is not ``pad_id``, and only rows of ``row_valid`` when given."""
    T = sequences.shape[1]
    if captions.shape[1] < T + 1:
        raise ValueError(f"captions of length {captions.shape[1]} cannot align {T} rollout steps")
    lengths = decode_lengths_from_sequences(sequences, end_id, max_decode_len)
    targets = captions[:, 1 : 1 + T]
    steps = torch.arange(T, device=sequences.device)[None, :]
    mask = (steps < lengths[:, None]) & (targets != pad_id)
    if row_valid is not None:
        mask = mask & row_valid[:, None]
    return mask, targets.to(torch.int32), lengths


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
