"""Image encoder: ConvNeXt features + adaptive pool to (B, 7, 7, C)
(counterpart of ``tpu_captioner/models/encoder.py``).

The attribute is named ``convnext`` as in the reference Encoder, so its state
dict (keys ``convnext.*``) loads directly.  Images arrive as uint8 NHWC and
are normalised on the device by ``preprocess_images``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_captioner_torch.models.convnext import ConvNeXtFeatures

# ImageNet statistics of the reference transform (train.py:152), copied from
# tpu_captioner/data/dataset.py:26-27 (that package imports JAX).
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def preprocess_images(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> normalised f32 NHWC, one multiply-add (/255 folded into
    the mean/std affine)."""
    scale = torch.from_numpy(1.0 / (255.0 * IMAGENET_STD)).to(images_u8.device)
    bias = torch.from_numpy(-IMAGENET_MEAN / IMAGENET_STD).to(images_u8.device)
    return images_u8.float() * scale + bias


class Encoder(nn.Module):
    def __init__(
        self,
        encoded_image_size: int = 7,
        depths=(3, 3, 27, 3),
        dims=(128, 256, 512, 1024),
        use_kernel: bool = False,
        device=None,
    ):
        super().__init__()
        self.encoded_image_size = encoded_image_size
        self.convnext = ConvNeXtFeatures(depths, dims, use_kernel, device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """Normalised f32 NHWC (B, H, W, 3) -> (B, enc, enc, dims[-1])."""
        x = self.convnext(images)
        x = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), self.encoded_image_size)
        return x.permute(0, 2, 3, 1)
