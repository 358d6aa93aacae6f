"""Optimizers and train state (counterpart of ``tpu_captioner/train/state.py``).

The reference's semantics (train.py:110-174, utils/utils.py:183-236):
- two separate Adam optimizers, decoder and encoder, with b1 0.9, b2 0.999
  and eps 1e-8;
- gradients clamped ELEMENTWISE to +-grad_clip before the update (the
  reference's clip_gradient is a clamp, not a norm clip);
- learning rates are mutable (``scale_lr``, the x0.8 decay);
- the encoder unlock starts a FRESH encoder Adam
  (``TrainState.reinit_encoder_optimizer``, train.py:161-165).

``torch.optim.Adam`` computes optax's ``adam`` update: both keep the biased
moments, divide by the bias corrections 1 - b^t and add eps outside the
square root.  Only float rounding differs.  Unlike the JAX state, this one
is updated in place.

Data parallel: every rank holds a whole copy; ``TrainState.create`` and
``broadcast_parameters`` after a restore give every rank rank 0's weights,
so ranks cannot start apart, and the summed gradients keep them together.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping, Optional

import torch
import torch.nn as nn

from tpu_captioner_torch.core.config import TrainConfig
from tpu_captioner_torch.parallel.collectives import broadcast_tensors
from tpu_captioner_torch.parallel.mesh import Mesh


def make_optimizer(params: Iterable[torch.Tensor], lr: float) -> torch.optim.Adam:
    """Adam with torch's defaults, which are the reference's."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def clip_gradients(params: Iterable[torch.Tensor], grad_clip: float) -> None:
    """Clamp every gradient elementwise to [-grad_clip, grad_clip], in place."""
    for p in params:
        if p.grad is not None:
            p.grad.clamp_(-grad_clip, grad_clip)


def get_lr(opt: torch.optim.Optimizer) -> float:
    return float(opt.param_groups[0]["lr"])


def scale_lr(opt: torch.optim.Optimizer, factor: float) -> None:
    """adjust_learning_rate (utils/utils.py:227-236): lr *= factor, in place."""
    for group in opt.param_groups:
        group["lr"] *= factor


def zero_frozen(module: nn.Module, trainable: Mapping[str, bool]) -> None:
    """Zero the gradients of ``module``'s parameters whose name maps to
    False in ``trainable``, in place."""
    for name, p in module.named_parameters():
        if not trainable.get(name, True) and p.grad is not None:
            p.grad.zero_()


def broadcast_parameters(model: nn.Module, mesh: Optional[Mesh]) -> None:
    """Rank 0's parameters and buffers on every rank of ``mesh``, in place."""
    broadcast_tensors(model.state_dict().values(), mesh)


@dataclass
class TrainState:
    """The model, both optimizers and the count of steps taken."""

    model: nn.Module  # a train.model.CaptionModel
    dec_opt: torch.optim.Optimizer
    enc_opt: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, cfg: TrainConfig, mesh: Optional[Mesh] = None) -> "TrainState":
        """Fresh Adams over ``model``, whose weights become rank 0's."""
        broadcast_parameters(model, mesh)
        return cls(
            model,
            make_optimizer(model.decoder.parameters(), cfg.decoder_lr),
            make_optimizer(model.encoder.parameters(), cfg.encoder_lr),
        )

    def reinit_encoder_optimizer(self, lr: float) -> "TrainState":
        """A fresh encoder Adam at ``lr`` for the fine-tune unlock
        (train.py:164), in place."""
        self.enc_opt = make_optimizer(self.model.encoder.parameters(), lr)
        return self
