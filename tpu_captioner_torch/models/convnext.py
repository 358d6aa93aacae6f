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
view with channels-last strides.  Each block: depthwise 7x7 conv + bias (the
grouped conv, as on the JAX main path), then the fused tail of
``ops/mlp_block.py``.  All LayerNorms use eps 1e-6.  Eval only: stochastic
depth is the all-ones row scale.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_captioner_torch.models import torch_init
from tpu_captioner_torch.ops.mlp_block import _mlp_plain, fused_convnext_mlp

BASE_DEPTHS = (3, 3, 27, 3)
BASE_DIMS = (128, 256, 512, 1024)
LN_EPS = 1e-6


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """Apply ``conv`` to an NHWC tensor; returns NHWC."""
    y = F.conv2d(
        x.permute(0, 3, 1, 2), conv.weight, conv.bias,
        stride=conv.stride, padding=conv.padding, groups=conv.groups,
    )
    return y.permute(0, 2, 3, 1)


class CNBlock(nn.Module):
    def __init__(self, dim: int, use_kernel: bool, device=None):
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
        self.use_kernel = use_kernel

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for i in (0, 3, 5):
            torch_init.trunc_normal02(self.block[i].weight, gen)
            self.block[i].bias.zero_()
        self.block[2].reset_parameters()
        self.layer_scale.fill_(1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        c = x.shape[-1]
        y = conv_nhwc(x, self.block[0]).reshape(-1, c).contiguous()
        ln, pw1, pw2 = self.block[2], self.block[3], self.block[5]
        tail = fused_convnext_mlp if self.use_kernel else _mlp_plain
        out = tail(
            y, x.reshape(-1, c).contiguous(), y.new_ones(y.shape[0]),
            ln.weight, ln.bias, pw1.weight, pw1.bias, pw2.weight, pw2.bias,
            self.layer_scale.view(-1),
        )
        return out.view(x.shape)


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
    (B, H/32, W/32, dims[-1])."""

    def __init__(
        self,
        depths: Sequence[int] = BASE_DEPTHS,
        dims: Sequence[int] = BASE_DIMS,
        use_kernel: bool = False,
        device=None,
    ):
        children = [Stem(dims[0], device)]
        for s, (depth, dim) in enumerate(zip(depths, dims)):
            if s > 0:
                children.append(Downsample(dims[s - 1], dim, device))
            children.append(nn.Sequential(*(CNBlock(dim, use_kernel, device) for _ in range(depth))))
        super().__init__(*children)

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
