"""Image encoder: ConvNeXt features + adaptive pool to (B, 7, 7, C)
(counterpart of ``tpu_captioner/models/encoder.py``).

The attribute is named ``convnext`` as in the reference Encoder, so its state
dict (keys ``convnext.*``) loads directly.  Images arrive as uint8 NHWC and
are normalised on the device by ``preprocess_images``.  ``fine_tune_mask``
says which parameters the fine-tune step trains.
"""

from __future__ import annotations

from typing import Dict

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


def fine_tune_mask(
    encoder: nn.Module, fine_tune: bool = True, starting_layer: int = 7
) -> Dict[str, bool]:
    """Parameter name -> trainable, as ``Encoder.fine_tune`` of the reference
    (encoder.py:29-34) and tpu_captioner/models/encoder.py:59 decide it:
    everything frozen, then the ConvNeXt children from ``starting_layer``
    on trainable iff ``fine_tune``."""

    def trainable(name: str) -> bool:
        top, child = name.split(".")[:2]
        return fine_tune and top == "convnext" and int(child) >= starting_layer

    return {name: trainable(name) for name, _ in encoder.named_parameters()}


class Encoder(nn.Module):
    def __init__(
        self,
        encoded_image_size: int = 7,
        depths=(3, 3, 27, 3),
        dims=(128, 256, 512, 1024),
        mode="off",
        device=None,
    ):
        """``mode``: a ``ModelConfig.use_pallas`` value (``ConvNeXtFeatures``)."""
        super().__init__()
        self.encoded_image_size = encoded_image_size
        self.convnext = ConvNeXtFeatures(depths, dims, mode, device)

    def forward(self, images: torch.Tensor, sd_rows=None, grad_from=None, remat="off") -> torch.Tensor:
        """Normalised f32 NHWC (B, H, W, 3) -> (B, enc, enc, dims[-1]);
        ``sd_rows`` are ``convnext.draw_sd``'s stochastic-depth scales
        (training) or None (eval); ``grad_from`` and ``remat`` as in
        ``ConvNeXtFeatures.forward``."""
        x = self.convnext(images, sd_rows, grad_from, remat)
        x = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), self.encoded_image_size)
        return x.permute(0, 2, 3, 1)
