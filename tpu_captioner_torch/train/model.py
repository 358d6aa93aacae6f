"""CaptionModel: encoder + Transformer decoder behind one interface
(counterpart of ``tpu_captioner/train/model.py``).

Covers what serving needs: ``encode`` (uint8 NHWC images -> (B, 7, 7, C)),
the decoder choice for the two Transformer families, and the kernel/plain
selection.  There is no training code yet.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from tpu_captioner_torch.core.backend import pin_f32_precision, require_cuda
from tpu_captioner_torch.core.config import ModelConfig
from tpu_captioner_torch.models.encoder import Encoder, preprocess_images
from tpu_captioner_torch.models.transformer import TransformerDecoder

SERVED_DECODERS = ("transformer", "transformer_attvis")


class CaptionModel(nn.Module):
    """Built on ``device`` with weights drawn from ``seed`` (a checkpoint
    load overwrites them).  Eval mode only."""

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        super().__init__()
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={cfg.compute_dtype!r}: only float32 is ported "
                "(bf16 is a later item of ROADMAP.md Queue 1)"
            )
        if cfg.decoder not in SERVED_DECODERS:
            raise NotImplementedError(
                f"decoder {cfg.decoder!r} is not ported yet (LSTM families: "
                "ROADMAP.md Queue 1 #10)"
            )
        device = torch.device(device)
        if device.type == "cuda":
            require_cuda()
            pin_f32_precision()
        self.cfg = cfg
        self.encoder = Encoder(
            cfg.encoded_image_size, tuple(cfg.encoder_depths), tuple(cfg.encoder_dims),
            use_kernel=cfg.use_pallas != "off", device=device,
        )
        # The two families differ only in whether teacher forcing and the
        # rollouts return attention maps; the decode step always does.
        self.decoder = TransformerDecoder(cfg, device=device)
        gen = torch.Generator().manual_seed(seed)
        self.encoder.convnext.reset_parameters(gen)
        self.decoder.reset_parameters(gen)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.decoder.fc_out.weight.device

    def use_decode_kernel(self) -> bool:
        """Beam search takes the fused decode step unless it is switched off
        (the wrapper itself runs the plain version for CPU tensors)."""
        return self.cfg.decode_kernel != "off"

    @torch.inference_mode()
    def encode(self, images_u8: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC (B, H, W, 3) -> (B, enc, enc, C) f32."""
        return self.encoder(preprocess_images(images_u8.to(self.device)))
