"""Early-exit scan (counterpart of ``tpu_captioner/core/loops.py``).

The reference's greedy loops break as soon as every row has emitted
``<end>`` (transformerDecoder.py:125-127).  ``scan_early_exit`` keeps
``lax.scan``'s interface and stops the same way: per-step outputs go into
zero-filled buffers, and the loop ends once ``done(carry)`` holds, checked
before each step.  Every rollout body emits exact zeros for finished rows, so
a run that stops at step s gives what the full scan gives.

It is a host loop: each ``done`` check that returns a tensor on the card
costs one device-to-host synchronise.  The check runs before every step, as
the JAX ``while_loop`` does, so a rollout runs no step past the one where its
last row finished.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import torch


def scan_early_exit(
    body: Callable[[Any, Any], Tuple[Any, Tuple[torch.Tensor, ...]]],
    carry0: Any,
    xs: Sequence,
    done: Callable[[Any], Any],
) -> Tuple[Any, Tuple[torch.Tensor, ...]]:
    """``body(carry, xs[t]) -> (carry, outputs)`` for t = 0, 1, ... until
    ``done(carry)`` holds or ``xs`` ends.  ``outputs`` is a tuple of tensors;
    each is stacked along a new first axis of length ``len(xs)`` whose
    never-executed steps stay zero.  Returns (the carry at exit, the stacked
    outputs); the outputs are None when ``done(carry0)`` already holds (their
    shapes come from the first step)."""
    carry, bufs = carry0, None
    for t in range(len(xs)):
        if bool(done(carry)):
            break
        carry, outs = body(carry, xs[t])
        if bufs is None:
            bufs = tuple(o.new_zeros((len(xs),) + o.shape) for o in outs)
        for buf, o in zip(bufs, outs):
            buf[t] = o
    return carry, bufs
