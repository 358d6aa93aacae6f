"""Seeded initialisers for the slice's modules (counterpart of
``tpu_captioner/models/torch_init.py``).

Each fills a tensor in place from an explicit ``torch.Generator``, so a model
built from one seed is the same on every run.  The distributions are
PyTorch's own defaults, which the JAX package reproduces:

- ``trunc_normal02``: torchvision ConvNeXt conv/linear init (std 0.02; the
  +-2 value cut is 100 sigma, so it is drawn untruncated, as in JAX);
- ``linear_default``: nn.Linear weight and bias, U(-1/sqrt(fan_in), +);
- ``xavier_uniform``: nn.MultiheadAttention packed in-projection;
- ``normal``: nn.Embedding, N(0, 1).
"""

from __future__ import annotations

import math

import torch


@torch.no_grad()
def trunc_normal02(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    return t.copy_(0.02 * torch.randn(t.shape, generator=gen, dtype=t.dtype))


@torch.no_grad()
def uniform_pm(t: torch.Tensor, bound: float, gen: torch.Generator) -> torch.Tensor:
    return t.copy_((torch.rand(t.shape, generator=gen, dtype=t.dtype) * 2 - 1) * bound)


@torch.no_grad()
def linear_default(lin: torch.nn.Linear, gen: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(lin.in_features)
    uniform_pm(lin.weight, bound, gen)
    if lin.bias is not None:
        uniform_pm(lin.bias, bound, gen)


@torch.no_grad()
def xavier_uniform(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    fan_out, fan_in = t.shape
    return uniform_pm(t, math.sqrt(6.0 / (fan_in + fan_out)), gen)


@torch.no_grad()
def normal(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    return t.copy_(torch.randn(t.shape, generator=gen, dtype=t.dtype))
