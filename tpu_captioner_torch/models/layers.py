"""Building blocks (counterpart of ``tpu_captioner/models/layers.py``).

Weights here are in PyTorch's layout: a linear weight is (out, in), as
``nn.Linear`` keeps it, and ``lstm_cell`` takes an ``nn.LSTMCell``'s
``weight_ih`` (4D, in) and ``weight_hh`` (4D, D), gates in the order i, f,
g, o.

Dropout draws its masks one of two ways.  Inside ``mask_pool_scope(pool)``
every site takes the next range of a ``MaskPool``, the flat keep-pool one
train step draws at once (``ops/dropout_mask.py``); outside, each site draws
with ``torch.bernoulli`` from the generator it is given (``draw_mask``).
The free-running rollouts draw once per token and site, and name each draw
by ``site``: the token and the site's fold-in ids in the JAX package's key
chain (``tpu_captioner/models/transformer.py:_rng_at``).  The draw itself
ignores the name; it lets a test hand both packages the same masks.  The
pool's layout is the JAX package's, so both packages fed one bit array drop the same
elements: the JAX decoder traces its layer loop once under ``lax.scan``, so
each site inside ``pool_layer_scope(i, L)`` reserves L stripes and layer i
takes the stripe at ``offset + i * size``.  The port loops over layers in
Python and rewinds the pool at the end of every layer but the last, so each
layer walks the same site offsets.  The scopes are ``ContextVar``s: they
hold for the code run inside the ``with``, in this thread.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Optional, Sequence, Tuple

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


def lstm_update(gates: torch.Tensor, c: torch.Tensor):
    """The LSTMCell state update from its (..., 4D) gate pre-activations, in
    the order i, f, g, o -> (h_new, c_new)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def lstm_cell(
    x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
    w_ih: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor, b_hh: torch.Tensor,
):
    """``torch.nn.LSTMCell`` -> (h_new, c_new)."""
    return lstm_update(F.linear(x, w_ih, b_ih) + F.linear(h, w_hh, b_hh), c)


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
    drop: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """Scaled dot-product attention for a single query position over all Tk
    key/value rows given; a KV-cached caller passes only the positions
    written so far.  ``drop`` (dropout of the probabilities, in training)
    applies to the context only.  Returns (context (R, H, Dh), probs
    before dropout (R, H, Tk))."""
    scores = torch.einsum("rhd,rhtd->rht", q / math.sqrt(q.shape[-1]), k)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("rht,rhtd->rhd", probs if drop is None else drop(probs), v)
    return ctx, probs


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, Dh) -> (B, T, H*Dh)."""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


class MaskPool:
    """Flat pool of dropout keep-bits, consumed in call order.  Sites inside
    ``pool_layer_scope`` reserve a stripe per layer (see the module note).
    Overdraw and a site whose rate differs from the pool's raise."""

    def __init__(self, bits: torch.Tensor, keep: float):
        if bits.dim() != 1 or bits.dtype != torch.bool:
            raise ValueError(f"pool must be a flat bool tensor, got {bits.dtype} {tuple(bits.shape)}")
        self.bits = bits
        self.keep = keep
        self.offset = 0

    def take(self, shape: Sequence[int], keep: float) -> torch.Tensor:
        if abs(keep - self.keep) > 1e-9:
            raise ValueError(
                f"dropout site keep={keep} != pool keep={self.keep}; the pool is "
                "drawn at ONE rate"
            )
        n = math.prod(shape)
        layer = _POOL_LAYER.get()
        reserve = n if layer is None else n * layer[1]
        if self.offset + reserve > self.bits.shape[0]:
            raise ValueError(
                f"dropout mask pool exhausted: need {reserve} at offset {self.offset}, "
                f"pool holds {self.bits.shape[0]}"
            )
        start = self.offset + (0 if layer is None else layer[0] * n)
        self.offset += reserve
        return self.bits[start : start + n].view(*shape)


_ACTIVE_POOL: contextvars.ContextVar = contextvars.ContextVar("mask_pool", default=None)
_POOL_LAYER: contextvars.ContextVar = contextvars.ContextVar("pool_layer", default=None)


@contextlib.contextmanager
def mask_pool_scope(pool: Optional[MaskPool]):
    """Route every ``dropout`` inside the ``with`` through ``pool``."""
    token = _ACTIVE_POOL.set(pool)
    try:
        yield pool
    finally:
        _ACTIVE_POOL.reset(token)


@contextlib.contextmanager
def pool_layer_scope(index: int, count: int):
    """Mark the sites inside as layer ``index`` of ``count`` identical
    layers, entered in order 0..count-1.  Each site reserves ``count``
    stripes; on leaving a layer other than the last, the active pool is
    rewound so the next layer takes its stripes at the same sites."""
    pool = _ACTIVE_POOL.get()
    start = pool.offset if pool is not None else 0
    token = _POOL_LAYER.set((int(index), int(count)))
    try:
        yield
    finally:
        _POOL_LAYER.reset(token)
        if pool is not None and index < count - 1:
            pool.offset = start


def draw_mask(
    shape: Sequence[int], keep: float, generator: torch.Generator, device, site: Tuple[int, ...] = ()
) -> torch.Tensor:
    """A bool keep-mask of ``shape`` on ``device``, each element True with
    probability ``keep``, drawn from ``generator``.  ``site`` names the draw
    (see the module note) and does not change it."""
    del site
    probs = torch.full(tuple(shape), keep, device=device)
    return torch.bernoulli(probs, generator=generator).bool()


def dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator], train: bool,
    site: Tuple[int, ...] = (),
) -> torch.Tensor:
    """Inverted dropout: ``where(mask, x / keep, 0)``.  The mask comes from
    the active ``MaskPool``, else from ``draw_mask`` on ``generator``."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    pool = _ACTIVE_POOL.get()
    if pool is not None:
        mask = pool.take(x.shape, keep)
    else:
        if generator is None:
            raise ValueError("train-mode dropout outside a mask pool needs a generator")
        mask = draw_mask(x.shape, keep, generator, x.device, site)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def attention_core(
    q: torch.Tensor,  # (B, H, Tq, Dh)
    k: torch.Tensor,  # (B, H, Tk, Dh)
    v: torch.Tensor,  # (B, H, Tk, Dh)
    mask: Optional[torch.Tensor],  # broadcastable to (B, H, Tq, Tk); True = attend
    attn_dropout: float,
    generator: Optional[torch.Generator],
    train: bool,
):
    """Scaled dot-product attention over full sequences.  A fully masked row
    gives NaN probabilities, which are zeroed (those rows are never scored).
    Returns (context (B, H, Tq, Dh), probabilities before dropout)."""
    scores = (q / math.sqrt(q.shape[-1])) @ k.transpose(-1, -2)
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.nan_to_num(torch.softmax(scores, dim=-1), nan=0.0, posinf=0.0, neginf=0.0)
    ctx = dropout(probs, attn_dropout, generator, train) @ v
    return ctx, probs
