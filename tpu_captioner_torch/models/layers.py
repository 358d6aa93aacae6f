"""Eval-only building blocks (counterpart of ``tpu_captioner/models/layers.py``).

Weights here are in PyTorch's layout: a linear weight is (out, in), as
``nn.Linear`` keeps it.  Dropout, ``MaskPool`` and ``lstm_cell`` belong to
training and the LSTM families and are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """``x @ w.T + b`` with ``w`` in (out, in) layout."""
    return F.linear(x, w, b)


def layer_norm(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis, computed in f32 (biased variance)."""
    y = F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)
    return y.to(x.dtype)


def causal_mask(t: int, device=None) -> torch.Tensor:
    """(1, 1, T, T) lower-triangular keep-mask (True = attend)."""
    return torch.ones(t, t, dtype=torch.bool, device=device).tril()[None, None]


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(..., T, E) -> (..., H, T, E/H)."""
    *lead, t, e = x.shape
    return x.reshape(*lead, t, num_heads, e // num_heads).transpose(-3, -2)


def attention_one_query(
    q: torch.Tensor,  # (R, H, Dh) — one query row per sequence
    k: torch.Tensor,  # (R, H, Tk, Dh)
    v: torch.Tensor,  # (R, H, Tk, Dh)
):
    """Scaled dot-product attention for a single query position over all Tk
    key/value rows given; a KV-cached caller passes only the positions
    written so far.  Returns (context (R, H, Dh), probs (R, H, Tk))."""
    scores = torch.einsum("rhd,rhtd->rht", q / math.sqrt(q.shape[-1]), k)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("rht,rhtd->rhd", probs, v)
    return ctx, probs
