"""CaptionModel: encoder + Transformer decoder behind one interface
(counterpart of ``tpu_captioner/train/model.py``).

Covers what serving, the two teacher-forced train steps and the greedy eval
step need: ``encode`` (uint8 NHWC images -> (B, 7, 7, C), with stochastic
depth in training, without autograd), ``encode_fine_tune`` (the same with
autograd from a starting child on), ``tf_forward``, ``rollout``, the decoder
choice for the two Transformer families, and the kernel/plain selection.

The fine-tune policies of the JAX package (``finetune_use_pallas``,
``finetune_encoder_remat``, tpu_captioner/train/model.py:30-62) were chosen
on a 16 GB TPU v5e.  The port drops the first and decides the second anew:
- no per-stage kernel choice: the fused MLP kernels run at every stage.  The
  JAX package put stage 4 on XLA because the TPU backward staged 48 MB of
  weight gradients in scoped VMEM; a Hopper kernel has no such limit;
- ``finetune_encoder_remat`` below, decided on the H100.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from tpu_captioner_torch.core.backend import pin_f32_precision, require_cuda
from tpu_captioner_torch.core.config import ModelConfig
from tpu_captioner_torch.models.encoder import Encoder, preprocess_images
from tpu_captioner_torch.models.transformer import TransformerDecoder

SERVED_DECODERS = ("transformer", "transformer_attvis")


def decode_kernel_mode(mode: str) -> str:
    """The decode path a ``decode_kernel`` setting selects (counterpart of
    ``CaptionModel._decode_kernel_mode``, tpu_captioner/train/model.py:251):
    ``'off'`` the plain PyTorch decode, ``'step'`` the per-token kernel
    (``'on'`` and ``'step'``), ``'mega'`` the whole-rollout kernel.
    ``'auto'`` is ``'step'``, the JAX package's choice on its chip; the
    wrappers run their plain versions for CPU tensors.  ``'mega'`` stays
    ``'mega'`` at every size: the JAX package falls back to ``'step'`` when
    its weights and vocab tables outgrow the TPU's VMEM, and the Hopper
    kernel streams them from device memory, so it has no such limit."""
    if mode == "off":
        return "off"
    if mode == "mega":
        return "mega"
    if mode in ("auto", "on", "step"):
        return "step"
    raise ValueError(f"unknown decode_kernel {mode!r}")


def finetune_encoder_remat(remat: str, compute_dtype: str = "float32") -> str:
    """Remat mode of the fine-tune step's trainable stages (the one home of
    this policy).  Explicit modes pass through.  ``'auto'`` resolves to
    ``'off'`` for float32, the only ported dtype: on an NVIDIA H100 80GB
    HBM3 at 700 W (``chip_smoke.py`` phase 6) the full-width fine-tune step
    at batch 32 took 229.29 ms with ``'off'`` (peak 5.21 GiB) against
    280.97 ms with ``'on'`` (peak 4.76 GiB), which recomputes the 30
    trainable blocks' forwards; both fit in 80 GB many times over."""
    del compute_dtype  # only float32 is ported; the choice above was measured there
    return "off" if remat == "auto" else remat


class CaptionModel(nn.Module):
    """Built on ``device`` with weights drawn from ``seed`` (a checkpoint
    load overwrites them).  Training and eval are chosen per call (``train``
    arguments), not by ``nn.Module.train``."""

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
        return decode_kernel_mode(self.cfg.decode_kernel) != "off"

    @torch.no_grad()
    def encode(
        self, images_u8: torch.Tensor, train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """uint8 NHWC (B, H, W, 3) -> (B, enc, enc, C) f32, without autograd:
        the frozen encoder.  ``no_grad``, not ``inference_mode``, so the
        decoder may save the output for its backward (serving calls this
        under its own ``inference_mode``).  ``train`` draws stochastic depth
        from ``generator``: the reference keeps the encoder in train mode
        while it is frozen (train.py:242)."""
        x = preprocess_images(images_u8.to(self.device))
        if not train:
            return self.encoder(x)
        if generator is None:
            raise ValueError("train-mode encode needs a generator for stochastic depth")
        return self.encoder(x, self.encoder.convnext.draw_sd(x.shape[0], generator))

    def encode_fine_tune(
        self, images_u8: torch.Tensor, starting_layer: int,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``encode`` for the fine-tune step: ConvNeXt children below
        ``starting_layer`` run under ``no_grad``, the rest with autograd and
        the remat mode ``finetune_encoder_remat`` resolves from the config.
        ``generator`` draws stochastic depth (train mode); None runs every
        block with scale one."""
        x = preprocess_images(images_u8.to(self.device))
        sd_rows = None if generator is None else self.encoder.convnext.draw_sd(x.shape[0], generator)
        remat = finetune_encoder_remat(self.cfg.encoder_remat, self.cfg.compute_dtype)
        return self.encoder(x, sd_rows, grad_from=starting_layer, remat=remat)

    def tf_forward(
        self, encoder_out: torch.Tensor, captions: torch.Tensor, train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Teacher-forced logits aligned so ``logits[:, t]`` predicts
        ``captions[:, t + 1]``: (B, T-1, V), and the (B, T-1, P) attention
        maps for ``transformer_attvis`` (else None).  <pad> (id 0) positions
        are masked as keys (train.py:271)."""
        logits, alphas = self.decoder.tf_forward(
            encoder_out, captions, captions == 0, train, generator
        )
        return logits[:, :-1], alphas[:, :-1] if alphas is not None else None

    def rollout(
        self, encoder_out: torch.Tensor, start_id: int, end_id: int, max_decode_len: int, *,
        generator: Optional[torch.Generator] = None, teacher_tokens: Optional[torch.Tensor] = None,
        teacher_prob: float = 0.0, one_cell: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """Greedy free-running decode -> (logits (B, T, V), sequences (B, T)
        int32, attention maps (B, T, P) for ``transformer_attvis``, else
        None), through the rollout ``decode_kernel_mode`` selects.
        ``one_cell`` runs each token's layers in one kernel launch in the
        ``'step'`` mode (the JAX package's ``TPU_CAPTIONER_DECODE_ONECELL``).
        ``teacher_tokens``/``teacher_prob`` with a ``generator`` enable
        scheduled sampling.  The kernel rollouts are forward only;
        free-running training is not ported yet (ROADMAP.md Queue 1 #11)."""
        dec = self.decoder
        args = (encoder_out, start_id, end_id, max_decode_len)
        kw = dict(generator=generator, teacher_tokens=teacher_tokens, teacher_prob=teacher_prob)
        mode = decode_kernel_mode(self.cfg.decode_kernel)
        if mode == "mega":
            return dec.mega_rollout(*args, **kw)
        if mode == "step":
            return dec.fused_rollout(*args, one_cell=one_cell, **kw)
        return dec.rollout(*args, **kw)
