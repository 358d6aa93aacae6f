"""ConvNeXt backbone in NHWC (counterpart of ``tpu_captioner/models/convnext.py``).

The 8 children match torchvision's ``convnext_base().features`` one to one,
under torchvision's parameter names, so the reference Encoder's
``convnext.*`` state dict loads directly:

  0  stem:   4x4/4 conv 3->128, LayerNorm
  1  stage:  3 blocks, dim 128          (keys ``1.{b}.block.{0,2,3,5}.*``,
  2  down:   LayerNorm, 2x2/2 conv       ``1.{b}.layer_scale``)
  3  stage:  3 blocks, dim 256
  4  down
  5  stage:  27 blocks, dim 512
  6  down
  7  stage:  3 blocks, dim 1024

Activations are NHWC (channels last) throughout; a conv sees them as an NCHW
view with channels-last strides.  Each block runs in one of three modes
(``core/config.py:STAGE_MODES``, one per stage, resolved from
``ModelConfig.use_pallas``):
- ``'mlp'``: depthwise 7x7 conv + bias through
  ``ops/dwconv.py:depthwise_conv7x7_nhwc`` on the conv weight seen as
  (7, 7, C) and the conv bias, with its forward kernel (forward with the
  bias in its epilogue, and input gradient) and its filter-gradient kernel
  (filter and bias gradient in one launch), then the fused tail of
  ``ops/mlp_block.py``;
- ``'off'``: the grouped ``F.conv2d`` and its autograd, as on the JAX main
  path, then the tail's plain version;
- ``'block'``: the whole block in one kernel, ``ops/block_fused.py`` (its
  backward through the dwconv and MLP-tail kernels).
The block's ``use_kernel`` says whether the tail takes its kernel (``'mlp'``)
and ``dw_kernel`` and ``dw_grad_kernel`` hold the two conv choices; they
follow the mode, and only the paired A/B of ``chip_smoke.py`` sets them
apart.  ``'block'`` reads none of the three.  All LayerNorms use eps 1e-6.

Stochastic depth (row mode, torchvision's): in training each block keeps an
image with survival ``1 - p``, p ramped as ``0.5 * i / (blocks - 1)``, and
scales a kept image by ``1 / survival``; the per-row scale is the fused
tail's ``sd``.  ``draw_sd`` draws the scales from a generator; without them
(eval) every scale is one.

Fine-tuning (``ConvNeXtFeatures.forward(..., grad_from=i)``): children below
``i`` run under ``no_grad``, so the backward stops at child ``i``'s input;
the others run with autograd, through the fused tail's backward kernel.
``remat`` picks what a stage keeps for its backward (``Stage``).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpu_captioner_torch.core.config import STAGE_MODES, stage_kernel_modes
from tpu_captioner_torch.models import torch_init
from tpu_captioner_torch.ops.block_fused import fused_convnext_block
from tpu_captioner_torch.ops.dwconv import depthwise_conv7x7_nhwc
from tpu_captioner_torch.ops.mlp_block import _mlp_plain, fused_convnext_mlp

BASE_DEPTHS = (3, 3, 27, 3)
BASE_DIMS = (128, 256, 512, 1024)
BASE_SD_RATE = 0.5
LN_EPS = 1e-6
REMAT_MODES = ("on", "off", "save_mlp_in")  # resolved modes; 'auto' is resolved by the caller


def sd_probs(depths: Sequence[int]) -> List[float]:
    """Per-block drop rates, ramped linearly from 0 to ``BASE_SD_RATE`` over
    all blocks (tpu_captioner/models/convnext.py:294-296)."""
    total = sum(depths)
    return [BASE_SD_RATE * i / max(total - 1.0, 1.0) for i in range(total)]


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """Apply ``conv`` to an NHWC tensor; returns NHWC."""
    y = F.conv2d(
        x.permute(0, 3, 1, 2), conv.weight, conv.bias,
        stride=conv.stride, padding=conv.padding, groups=conv.groups,
    )
    return y.permute(0, 2, 3, 1)


class CNBlock(nn.Module):
    def __init__(self, dim: int, mode="off", device=None):
        super().__init__()
        # Indices 1, 4 and 6 are torchvision's Permute/GELU/Permute; they hold
        # no parameters and keep the numbering of the reference keys.
        self.block = nn.Sequential(
            nn.Conv2d(dim, dim, 7, padding=3, groups=dim, device=device),
            nn.Identity(),
            nn.LayerNorm(dim, eps=LN_EPS, device=device),
            nn.Linear(dim, 4 * dim, device=device),
            nn.GELU(),
            nn.Linear(4 * dim, dim, device=device),
            nn.Identity(),
        )
        self.layer_scale = nn.Parameter(torch.empty(dim, 1, 1, device=device))
        if mode not in STAGE_MODES:
            raise ValueError(f"a ConvNeXt block's mode must be one of {STAGE_MODES}, got {mode!r}")
        self.mode = mode
        self.use_kernel = self.mode == "mlp"
        self.dw_kernel = self.dw_grad_kernel = self.use_kernel

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for i in (0, 3, 5):
            torch_init.trunc_normal02(self.block[i].weight, gen)
            self.block[i].bias.zero_()
        self.block[2].reset_parameters()
        self.layer_scale.fill_(1e-6)

    def forward(self, x: torch.Tensor, sd_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, H, W, C) -> (B, H, W, C); ``sd_rows`` (B,) is the per-image
        stochastic-depth scale (ones when None)."""
        b, h, w, c = x.shape
        conv, ln, pw1, pw2 = self.block[0], self.block[2], self.block[3], self.block[5]
        if self.mode == "block" or self.dw_kernel or self.dw_grad_kernel:
            taps = conv.weight.view(c, 7 * 7).t().contiguous().view(7, 7, c)  # (C, 1, 7, 7) -> (7, 7, C)
        if self.mode == "block":
            sd = x.new_ones(b) if sd_rows is None else sd_rows.contiguous()
            return fused_convnext_block(
                x.contiguous(), sd, taps, conv.bias, ln.weight, ln.bias, pw1.weight, pw1.bias,
                pw2.weight, pw2.bias, self.layer_scale.view(-1),
            )
        if self.dw_kernel or self.dw_grad_kernel:
            y = depthwise_conv7x7_nhwc(x.contiguous(), taps, self.dw_kernel, self.dw_grad_kernel, conv.bias)
        else:
            y = conv_nhwc(x, conv)
        y = y.reshape(-1, c).contiguous()
        tail = fused_convnext_mlp if self.use_kernel else _mlp_plain
        sd = y.new_ones(y.shape[0]) if sd_rows is None else sd_rows.repeat_interleave(h * w)
        out = tail(
            y, x.reshape(-1, c).contiguous(), sd.contiguous(),
            ln.weight, ln.bias, pw1.weight, pw1.bias, pw2.weight, pw2.bias,
            self.layer_scale.view(-1),
        )
        return out.view(x.shape)


class Stage(nn.Sequential):
    """A stack of blocks of one width.

    ``remat`` applies only when the stage runs with autograd.  ``'on'``
    recomputes each block's forward in the backward
    (``torch.utils.checkpoint``, non-reentrant), handed the same sd rows, so
    the block's forward kernel launches twice per step.  ``'off'`` and
    ``'save_mlp_in'`` run the blocks plainly: autograd then keeps each
    block's input (for the depthwise conv) and its dwconv output (for the
    fused tail), which is what the JAX package's ``save_mlp_in`` policy keeps
    (tpu_captioner/models/convnext.py:156-160, :244-256).  A ``'block'``
    block keeps only its input and recomputes its conv in the backward; under
    ``'on'`` its kernel runs twice per step."""

    def forward(self, x: torch.Tensor, sd_rows: Optional[Sequence[torch.Tensor]] = None,
                remat: str = "off"):
        if remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}, got {remat!r}")
        recompute = remat == "on" and torch.is_grad_enabled()
        for i, blk in enumerate(self):
            rows = None if sd_rows is None else sd_rows[i]
            if recompute:
                # The block draws nothing: its sd rows come in as an argument.
                x = checkpoint(blk, x, rows, use_reentrant=False, preserve_rng_state=False)
            else:
                x = blk(x, rows)
        return x


class Stem(nn.Sequential):
    def __init__(self, dim: int, device=None):
        super().__init__(
            nn.Conv2d(3, dim, 4, stride=4, device=device),
            nn.LayerNorm(dim, eps=LN_EPS, device=device),
        )

    def forward(self, x):
        return self[1](conv_nhwc(x, self[0]))


class Downsample(nn.Sequential):
    def __init__(self, dim_in: int, dim_out: int, device=None):
        super().__init__(
            nn.LayerNorm(dim_in, eps=LN_EPS, device=device),
            nn.Conv2d(dim_in, dim_out, 2, stride=2, device=device),
        )

    def forward(self, x):
        return conv_nhwc(self[0](x), self[1]).contiguous()


class ConvNeXtFeatures(nn.Sequential):
    """The 8-child feature pyramid: NHWC normalised images ->
    (B, H/32, W/32, dims[-1]).  ``mode`` is a ``ModelConfig.use_pallas``
    value, one for every stage or one per stage, as the JAX package's
    ``pallas_mode`` (tpu_captioner/models/convnext.py:286-307), resolved by
    ``stage_kernel_modes`` into each stage's block mode (``CNBlock``)."""

    def __init__(
        self,
        depths: Sequence[int] = BASE_DEPTHS,
        dims: Sequence[int] = BASE_DIMS,
        mode="off",
        device=None,
    ):
        modes = stage_kernel_modes(mode, len(depths))
        children = [Stem(dims[0], device)]
        for s, (depth, dim) in enumerate(zip(depths, dims)):
            if s > 0:
                children.append(Downsample(dims[s - 1], dim, device))
            children.append(Stage(*(CNBlock(dim, modes[s], device) for _ in range(depth))))
        super().__init__(*children)
        self.sd_probs = sd_probs(depths)

    def draw_sd(self, batch: int, generator: torch.Generator) -> List[torch.Tensor]:
        """Training-mode stochastic-depth scales: one (B,) tensor per block,
        on the generator's device, each entry 0 or ``1 / survival``."""
        rows = []
        for p in self.sd_probs:
            survival = 1.0 - p
            probs = torch.full((batch,), survival, device=generator.device)
            rows.append(torch.bernoulli(probs, generator=generator) / survival)
        return rows

    def forward(self, x: torch.Tensor, sd_rows: Optional[Sequence[torch.Tensor]] = None,
                grad_from: Optional[int] = None, remat: str = "off"):
        """NHWC images -> features; ``sd_rows`` is ``draw_sd``'s list (eval:
        None).  With ``grad_from`` set, children below it run under
        ``no_grad``; ``remat`` is each stage's (``Stage``)."""
        start = 0
        for i, child in enumerate(self):
            frozen = grad_from is not None and i < grad_from
            with torch.no_grad() if frozen else contextlib.nullcontext():
                if isinstance(child, Stage):
                    depth = len(child)
                    rows = None if sd_rows is None else sd_rows[start : start + depth]
                    x = child(x, rows, remat)
                    start += depth
                else:
                    x = child(x)
        return x

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """torchvision init: trunc-normal(0.02) convs/linears, zero biases,
        unit LayerNorms, layer scale 1e-6."""
        for m in self.modules():
            if isinstance(m, CNBlock):
                m.reset_parameters(gen)
            elif isinstance(m, (Stem, Downsample)):
                for sub in m:
                    if isinstance(sub, nn.Conv2d):
                        torch_init.trunc_normal02(sub.weight, gen)
                        sub.bias.zero_()
                    else:
                        sub.reset_parameters()
