"""Image encoder: ConvNeXt features + adaptive pool to (B, 7, 7, C)
(counterpart of ``tpu_captioner/models/encoder.py``).

The attribute is named ``convnext`` as in the reference Encoder, so its state
dict (keys ``convnext.*``) loads directly.  Images arrive as uint8 NHWC and
are normalised on the device by ``preprocess_images``.  ``fine_tune_mask``
says which parameters the fine-tune step trains.

In bf16 (``ModelConfig.compute_dtype``) the images are normalised and the
backbone and the pool compute in bf16, rounding where the JAX package's
bf16 encoder rounds on the CPU: the normalisation's multiply and add one
at a time, the pool as two bf16 products (``adaptive_pool_bf16``).
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


def preprocess_images(images_u8: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 NHWC -> normalised NHWC of ``dtype``: a multiply and an add
    (/255 folded into the mean/std affine), the affine's two vectors rounded
    to ``dtype`` and each op rounding to it, as in
    tpu_captioner/models/encoder.py:29-36."""
    scale = torch.from_numpy(1.0 / (255.0 * IMAGENET_STD)).to(images_u8.device, dtype)
    bias = torch.from_numpy(-IMAGENET_MEAN / IMAGENET_STD).to(images_u8.device, dtype)
    return images_u8.to(dtype) * scale + bias


def _pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) averaging matrix with torch's adaptive-pool bins
    [floor(i S / O), ceil((i + 1) S / O)) (tpu_captioner/models/convnext.py:
    adaptive_avg_pool_matrix)."""
    m = np.zeros((in_size, out_size), dtype=np.float32)
    for i in range(out_size):
        lo, hi = (i * in_size) // out_size, -(-((i + 1) * in_size) // out_size)
        m[lo:hi, i] = 1.0 / (hi - lo)
    return m


def adaptive_pool_bf16(x: torch.Tensor, out_hw: int) -> torch.Tensor:
    """The adaptive average pool of a bf16 NHWC tensor as the JAX package
    computes it (tpu_captioner/models/convnext.py:329-338): two bf16
    products with the bins' matrices, over H then W, the first rounded to
    bf16 before the second."""
    mh = torch.from_numpy(_pool_matrix(x.shape[1], out_hw)).to(x.device, x.dtype)
    mw = torch.from_numpy(_pool_matrix(x.shape[2], out_hw)).to(x.device, x.dtype)
    x = torch.einsum("bhwc,hp->bpwc", x, mh)
    return torch.einsum("bpwc,wq->bpqc", x, mw)


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
        """Normalised f32 or bf16 NHWC (B, H, W, 3) -> (B, enc, enc,
        dims[-1]) of the same dtype; ``sd_rows`` are ``convnext.draw_sd``'s
        stochastic-depth scales (training) or None (eval); ``grad_from`` and
        ``remat`` as in ``ConvNeXtFeatures.forward``."""
        x = self.convnext(images, sd_rows, grad_from, remat)
        if x.dtype == torch.bfloat16:
            return adaptive_pool_bf16(x, self.encoded_image_size)
        x = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), self.encoded_image_size)
        return x.permute(0, 2, 3, 1)
