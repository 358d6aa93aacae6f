"""CaptionModel: encoder + one of the four decoder families behind one
interface (counterpart of ``tpu_captioner/train/model.py``).

Covers what serving, the train steps (teacher-forced and free-running) and
the greedy eval step need: ``encode`` (uint8 NHWC images -> (B, 7, 7, C),
with stochastic depth in training, without autograd), ``encode_fine_tune`` (the same with
autograd from a starting child on), ``tf_forward``, ``rollout``, the decoder
choice (``transformer``, ``transformer_attvis``, ``lstm``,
``lstm_no_attention``), and the kernel/plain selection.

``ModelConfig.use_pallas`` resolves per stage (``core/config.py:
stage_kernel_modes``): ``'mlp'`` (``'auto'``, ``'on'``), the fused MLP-tail
and depthwise-conv kernels; ``'block'``, the whole-block kernel of
``ops/block_fused.py``, whose backward runs the dwconv and MLP-tail
backward kernels; ``'off'``, the plain block.  A per-stage tuple sets each
stage apart, as in the JAX package; ``'auto'`` stays ``'mlp'`` on every
stage (``chip_smoke.py`` phase 9 records the block kernel against it).

The fine-tune policies of the JAX package (``finetune_use_pallas``,
``finetune_encoder_remat``, tpu_captioner/train/model.py:30-62) were chosen
on a 16 GB TPU v5e.  The port drops the first and decides the second anew:
- no fine-tune per-stage kernel choice: the fine-tune step runs the stages'
  modes as ``use_pallas`` sets them.  The JAX package put stage 4 on XLA
  because the TPU backward staged 48 MB of weight gradients in scoped VMEM;
  a Hopper kernel has no such limit;
- ``finetune_encoder_remat`` below, decided on the H100;
- the depthwise conv's two kernels (``ops/dwconv.py``) follow
  ``use_pallas``, as the MLP tail does, where the JAX package ships both off
  (its block passes ``use_pallas=False``; its filter gradient is XLA's
  unless ``TPU_CAPTIONER_DW_GRAD=pallas``).  Decided by the paired A/B of
  ``chip_smoke.py:dwconv_ab`` on an NVIDIA H100 80GB HBM3 at 700 W, each
  kernel apart, at full width and batch 32: a kernel is taken when the
  median of the pairs' differences exceeds their spread.  Medians, kernel
  against library, of five runs:
  - filter gradient, fine-tune step: run A 190.92 vs 227.61 ms and run B
    201.63 vs 235.12 (8 pairs each, one step per arm; every pair favoured
    the kernel); run C 193.81 vs 230.20 (12 pairs, fastest of 3 steps per
    arm; gain 36.70, spread 15.99); run D 192.34 vs 228.85 (gain 36.51,
    spread 13.79); run E 194.70 vs 229.68 (gain 34.72, spread 22.62);
  - forward kernel, fine-tune step: run A 224.11 vs 227.84 (pairs 1.77 to
    4.98); run B 227.54 vs 231.05 (pairs -23.42 to +7.89); run C, cuDNN's
    weight gradient in both arms, 229.81 vs 230.82 (gain 1.93, spread
    15.43: not favoured); runs D and E, the filter-gradient kernel in both
    arms, 187.89 vs 191.74 (gain 3.98, spread 2.87) and 189.07 vs 193.16
    (gain 4.01, spread 4.17: short of the rule by 0.16 ms).  Every pair of
    runs A, D and E favoured the kernel (by 2.47 ms at least in D and E),
    and so did every encoder-pass pair of all five runs, so it stays;
  - forward kernel, encoder pass: run A 60.94 vs 62.95 (pairs 0.51 to
    2.20); run B 61.20 vs 63.10 (1.71 to 2.09); run C 61.34 vs 63.28 (gain
    1.86, spread 0.54); run D 60.98 vs 63.00 (gain 1.97, spread 0.69); run
    E 60.93 vs 62.86 (gain 1.93, spread 0.54).
- bf16 (``compute_dtype='bfloat16'``) serves, evaluates and trains all
  four decoder families: ``encode`` returns the bf16 (B, 7, 7, C)
  features, as the JAX encoder does, and the decoder widens them to f32
  where it reads them (``project_memory``, and the LSTM's reads; JAX
  promotes bf16 @ f32 to f32 implicitly, PyTorch refuses mixed-dtype
  products).  The decode kernels' arm follows the model's dtype, not the
  backend: with a bf16 model the beam and every kernel rollout (the
  Transformer's per-layer, one-cell and ``'mega'``, the LSTM step) take
  the bf16 arm (``precise=False``: bf16 weight matrices, caches, memory
  K/V or features, bf16 products), which the JAX package takes on its own
  chip whatever the model's dtype (tpu_captioner/infer/beam.py:209, 325,
  models/transformer.py:532, models/lstm.py:329); an f32 model keeps the
  f32 arm and every f32 result it had (JAX takes its f32 arm in interpret
  mode only, on the CPU).  The plain decode path stays f32 in both, as
  the JAX package's XLA path is.  Training: the parameters and both Adams
  stay f32 (the JAX package's master weights), each encoder weight is
  cast to bf16 at use and its gradient comes back through the cast, and
  the encoder's backward runs the bf16 instances of the MLP tail's and the
  depthwise conv's backward kernels (in ``'block'``: the tail's f32
  backward on the widened bf16 operands, as JAX's VJP computes it, and the
  conv's bf16 ones; ``ops/block_fused.py``); the decoders train on the
  plain path.  Every ``use_pallas`` value, a per-stage list holding
  ``'block'`` among them, and the sub-tiled tail
  (``TPU_CAPTIONER_MLP_SUB``) run in bf16.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from tpu_captioner_torch.core.backend import pin_f32_precision, require_cuda
from tpu_captioner_torch.core.config import DECODE_KERNEL_MODES, LSTM_DECODERS, ModelConfig
from tpu_captioner_torch.models.encoder import Encoder, preprocess_images
from tpu_captioner_torch.models.lstm import DecoderWithAttention, DecoderWithoutAttention
from tpu_captioner_torch.models.transformer import TransformerDecoder


def decode_kernel_mode(mode: str, decoder: str) -> str:
    """The decode path a ``decode_kernel`` setting selects for a decoder
    family (counterpart of ``CaptionModel._decode_kernel_mode``,
    tpu_captioner/train/model.py:251): ``'off'`` the plain PyTorch decode,
    ``'step'`` the per-token kernel, ``'mega'`` the whole-rollout kernel.

    Transformer families: ``'on'`` and ``'step'`` are ``'step'``;
    ``'auto'`` is ``'step'``, the JAX package's choice on its chip; ``'mega'``
    stays ``'mega'`` at every size: the JAX package falls back to ``'step'``
    when its weights and vocab tables outgrow the TPU's VMEM, and the Hopper
    kernel streams them from device memory, so it has no such limit.

    ``lstm``: every mode but ``'off'`` and ``'auto'`` selects the LSTM step
    kernel (``ops/lstm_step.py``), as in the JAX package, where ``'auto'`` is
    ``'off'`` for the LSTM.  ``'auto'`` stays ``'off'`` because the paired
    A/B of ``chip_smoke.py:lstm_ab`` (12 pairs, fastest of 3 calls per arm,
    the kernel taken only when the median of the pairs' differences exceeds
    their spread in both contexts) did not favour the kernel in the bs-8
    beam on an NVIDIA H100 80GB HBM3 at 700 W.  Medians, kernel against
    plain, at full width (E = D = A = 512, vocab 9490):
    - beam 5, 50 steps, 8 images: run A 89.14 vs 116.90 ms (gain 26.75,
      spread 71.19); run B 95.59 vs 130.20 (gain 25.46, spread 48.18); run
      C 62.91 vs 81.82 (gain 19.43, spread 33.89);
    - eval step, batch 32, 51 tokens: run A 95.90 vs 124.38 (gain 27.37,
      spread 28.82); run B 106.51 vs 136.02 (gain 26.89, spread 17.32:
      favoured); run C 82.85 vs 102.45 (gain 19.21, spread 13.30:
      favoured).
    Run A's kernel ran one block per SM; runs B and C ran PR 7's kernel,
    two blocks per SM.  Against the redesigned kernel (PR 14's run J: the
    products on the 3xTF32 tensor cores, 0.0388 ms a step at R = 40):
    - beam 5, 8 images: 67.55 vs 94.72 ms (gain 19.13, spread 48.27);
    - eval step, batch 32: 44.22 vs 63.25 (gain 21.67, spread 20.72:
      favoured).
    The beam is host-bound and its pairs spread wider than the gain, so
    ``'auto'`` stays ``'off'`` until the bench (ROADMAP Queue 1 #3)
    decides it in pairs of its own.

    ``lstm_no_attention`` has no kernel: always ``'off'``.  The wrappers run
    their plain versions for CPU tensors."""
    if mode not in DECODE_KERNEL_MODES:
        raise ValueError(f"unknown decode_kernel {mode!r}")
    if mode == "off" or decoder == "lstm_no_attention":
        return "off"
    if decoder == "lstm":
        return "off" if mode == "auto" else "step"
    return "mega" if mode == "mega" else "step"


def finetune_encoder_remat(remat: str, compute_dtype: str = "float32") -> str:
    """Remat mode of the fine-tune step's trainable stages (the one home of
    this policy).  Explicit modes pass through.  ``'auto'`` resolves per
    dtype, each decided on an NVIDIA H100 80GB HBM3 at 700 W
    (``chip_smoke.py``), full width, batch 32:
    - float32: ``'off'`` (phase 6): 229.29 ms a step with ``'off'`` (peak
      5.21 GiB) against 280.97 ms with ``'on'`` (peak 4.76 GiB), which
      recomputes the 30 trainable blocks' forwards;
    - bfloat16: ``'off'`` (the JAX package's ``'save_mlp_in'``, which keeps
      each block's dwconv output, is what ``'off'`` keeps here:
      ``models/convnext.py:Stage``), by phase 12's paired A/B, whose rule
      was set before the run: ``'on'`` only if the median of 12 pairs'
      step-time differences favours it by more than their spread.  Medians
      of one step per arm a pair, device time by CUDA events (host clock in
      parentheses): ``'off'`` 102.44 ms (102.52) against ``'on'`` 136.33 ms
      (136.46); ``'off'`` - ``'on'`` per pair median -35.42 ms, spread
      54.03 (peak memory of ``'off'`` 4.42 GiB).
    Both fit in 80 GB many times over.  The choice holds in ``'block'``
    too, in both dtypes, with no A/B of its own: a ``'block'`` block keeps
    only its input and its operands for the backward (the conv output and
    the hidden activation are recomputed there, ``ops/block_fused.py``), so
    ``'on'`` keeps no less and adds one forward launch per trained block."""
    return _FINETUNE_REMAT_AUTO[compute_dtype] if remat == "auto" else remat


_FINETUNE_REMAT_AUTO = {"float32": "off", "bfloat16": "off"}


class CaptionModel(nn.Module):
    """Built on ``device`` with weights drawn from ``seed`` (a checkpoint
    load overwrites them).  ``pretrained_embeddings`` (vocab, E), a word
    table of ``models/embeddings.py``, replaces the Transformer families'
    embedding, as the JAX package's ``init_params`` does (the LSTM families
    ignore it there too).  Training and eval are chosen per call (``train``
    arguments), not by ``nn.Module.train``."""

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0, pretrained_embeddings=None):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda":
            require_cuda()
            pin_f32_precision()
        self.cfg = cfg
        self.encoder = Encoder(
            cfg.encoded_image_size, tuple(cfg.encoder_depths), tuple(cfg.encoder_dims),
            mode=cfg.use_pallas, device=device,
        )
        if cfg.decoder == "lstm":
            self.decoder = DecoderWithAttention(cfg, device=device)
        elif cfg.decoder == "lstm_no_attention":
            self.decoder = DecoderWithoutAttention(cfg, device=device)
        else:
            # The two Transformer families differ only in whether teacher
            # forcing and the rollouts return attention maps; the decode
            # step always does.
            self.decoder = TransformerDecoder(cfg, device=device)
        gen = torch.Generator().manual_seed(seed)
        self.encoder.convnext.reset_parameters(gen)
        self.decoder.reset_parameters(gen)
        if pretrained_embeddings is not None and cfg.decoder not in LSTM_DECODERS:
            table = torch.as_tensor(pretrained_embeddings, dtype=torch.float32)
            if tuple(table.shape) != (cfg.vocab_size, cfg.embed_dim):
                raise ValueError(
                    f"pretrained embedding shape {tuple(table.shape)} != ({cfg.vocab_size}, {cfg.embed_dim})"
                )
            with torch.no_grad():
                self.decoder.embedding.weight.copy_(table)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.decoder.embedding.weight.device

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: the encoder's, and the decode kernels' arm."""
        return torch.bfloat16 if self.cfg.compute_dtype == "bfloat16" else torch.float32

    def decode_mode(self) -> str:
        """``decode_kernel_mode`` of this model's setting and family."""
        return decode_kernel_mode(self.cfg.decode_kernel, self.cfg.decoder)

    def use_decode_kernel(self) -> bool:
        """Beam search takes the family's fused decode step unless
        ``decode_mode`` is ``'off'`` (the wrapper itself runs the plain
        version for CPU tensors)."""
        return self.decode_mode() != "off"

    @torch.no_grad()
    def encode(
        self, images_u8: torch.Tensor, train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """uint8 NHWC (B, H, W, 3) -> (B, enc, enc, C) of the compute dtype,
        without autograd: the frozen encoder.  ``no_grad``, not ``inference_mode``, so the
        decoder may save the output for its backward (serving calls this
        under its own ``inference_mode``).  ``train`` draws stochastic depth
        from ``generator``: the reference keeps the encoder in train mode
        while it is frozen (train.py:242)."""
        x = preprocess_images(images_u8.to(self.device), self.dtype)
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
        x = preprocess_images(images_u8.to(self.device), self.dtype)
        sd_rows = None if generator is None else self.encoder.convnext.draw_sd(x.shape[0], generator)
        remat = finetune_encoder_remat(self.cfg.encoder_remat, self.cfg.compute_dtype)
        return self.encoder(x, sd_rows, grad_from=starting_layer, remat=remat)

    def tf_forward(
        self, encoder_out: torch.Tensor, captions: torch.Tensor, train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Teacher-forced logits aligned so ``logits[:, t]`` predicts
        ``captions[:, t + 1]``: (B, T-1, V), and the (B, T-1, P) attention
        maps for ``lstm`` and ``transformer_attvis`` (else None).  The LSTM
        runs over ``captions[:, :-1]``; the Transformer predicts at every
        position, with <pad> (id 0) masked as keys (train.py:271), and its
        last position is dropped."""
        if self.cfg.decoder in LSTM_DECODERS:
            return self.decoder.tf_forward(encoder_out, captions, train, generator)
        logits, alphas = self.decoder.tf_forward(
            encoder_out, captions, captions == 0, train, generator
        )
        return logits[:, :-1], alphas[:, :-1] if alphas is not None else None

    def rollout(
        self, encoder_out: torch.Tensor, start_id: int, end_id: int, max_decode_len: int, *,
        generator: Optional[torch.Generator] = None, teacher_tokens: Optional[torch.Tensor] = None,
        teacher_prob: float = 0.0, one_cell: bool = False, deterministic: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """Greedy free-running decode -> (logits (B, T, V), sequences (B, T)
        int32, attention maps (B, T, P) for ``lstm`` and
        ``transformer_attvis``, else None), through the rollout
        ``decode_mode`` selects.  ``one_cell`` runs each token's Transformer
        layers in one kernel launch in the ``'step'`` mode (the JAX package's
        ``TPU_CAPTIONER_DECODE_ONECELL``).  ``teacher_tokens``/``teacher_prob``
        with a ``generator`` enable scheduled sampling.  The decode kernels
        serve deterministic rollouts only (no dropout), as in the JAX
        package; ``lstm`` takes its kernel rollout whenever the mode is not
        ``'off'``.  ``deterministic=False`` is the free-running rollout of
        training: the plain rollout of every family with dropout drawn from
        ``generator`` and autograd through the loop, whatever
        ``decode_mode`` says (tpu_captioner/train/model.py:195-247).  The
        kernel rollouts are forward only."""
        dec = self.decoder
        args = (encoder_out, start_id, end_id, max_decode_len)
        kw = dict(generator=generator, teacher_tokens=teacher_tokens, teacher_prob=teacher_prob)
        if not deterministic:
            return dec.rollout(*args, train=True, **kw)
        mode = self.decode_mode()
        if self.cfg.decoder in LSTM_DECODERS:
            return dec.fused_rollout(*args, dtype=self.dtype, **kw) if mode != "off" else dec.rollout(*args, **kw)
        if mode == "mega":
            return dec.mega_rollout(*args, dtype=self.dtype, **kw)
        if mode == "step":
            return dec.fused_rollout(*args, dtype=self.dtype, one_cell=one_cell, **kw)
        return dec.rollout(*args, **kw)
