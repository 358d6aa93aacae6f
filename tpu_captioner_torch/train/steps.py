"""Train and eval steps (counterpart of ``tpu_captioner/train/steps.py``).

Ported: the teacher-forced step, with the encoder frozen, which the reference
trains for its first ``fine_tune_epoch`` epochs (train.py:240-291), and
fine-tuned from ``starting_layer`` on (``train_encoder=True``), which it
trains after them; and the greedy eval step (``make_eval_step``) behind every
validation loss, top-5 and BLEU number (train.py:367-441).  The train step:
- the loss is the cross-entropy over the tokens at ``t < caplen - 1`` of
  valid rows, divided by their count (``nn.CrossEntropyLoss`` over
  ``pack_padded_sequence`` tokens, train.py:266-276);
- frozen: the encoder runs without autograd, with stochastic depth on, and
  its parameters have ``requires_grad`` off;
- fine-tune: ``fine_tune_mask`` sets ``requires_grad`` per parameter; the
  children below ``starting_layer`` run under ``no_grad``, so the backward
  stops at the first trainable child's input (the JAX step's
  ``stop_gradient``), and those parameters stay bit-identical;
- the gradients are clamped elementwise to +-grad_clip, then each Adam of
  ``train/state.py`` steps (the encoder's only when it trains);
- with ``dropout_masks`` 'auto' or 'pool' one ``random_mask_pool`` call
  draws every dropout mask of the step (``ops/dropout_mask.py``).  Its size
  is counted from the shapes (``pool_demand``), and the step checks that the
  forward consumed exactly that many bits.

The eval step runs ``rollout_loss`` without dropout or stochastic depth: the
encoder, the greedy rollout of ``cfg.max_decode_len`` steps that
``ModelConfig.decode_kernel`` selects, and the cross-entropy and top-5 over
``rollout_token_mask``'s tokens.  Not ported yet: free-running training
(``rollout_loss`` with gradients and scheduled sampling, ROADMAP.md Queue 1
#11).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from tpu_captioner_torch.core import prng
from tpu_captioner_torch.core.config import ModelConfig, TrainConfig
from tpu_captioner_torch.eval.metrics import masked_cross_entropy, rollout_token_mask, topk_correct
from tpu_captioner_torch.models.encoder import fine_tune_mask
from tpu_captioner_torch.models.layers import MaskPool, mask_pool_scope
from tpu_captioner_torch.ops import dropout_mask
from tpu_captioner_torch.train.state import TrainState, clip_gradients, zero_frozen

# Folds of a step seed: the encoder's stochastic depth and the decoder's
# dropout draw independent streams, as the JAX step splits its key.
_ENCODER, _DECODER = 0, 1


def pool_demand(cfg: ModelConfig, batch: int, length: int, pixels: int) -> int:
    """Keep-bits one teacher-forced decoder forward takes: the embedding's
    (B, T, E), then per layer the self- and cross-attention probabilities
    (B, H, T, T) and (B, H, T, P), three (B, T, E) outputs and the
    (B, T, FFN) hidden layer."""
    e, h, f = cfg.embed_dim, cfg.num_heads, cfg.decoder_dim
    per_layer = batch * length * (h * length + h * pixels + 3 * e + f)
    return batch * length * e + cfg.num_layers * per_layer


def _pooled_tf_forward(model, enc_out: torch.Tensor, caps: torch.Tensor, seed: int):
    """``model.tf_forward`` in training mode with every dropout mask taken
    from one pooled draw."""
    cfg = model.cfg
    pixels = enc_out.shape[1] * enc_out.shape[2] if enc_out.dim() == 4 else enc_out.shape[1]
    n = pool_demand(cfg, caps.shape[0], caps.shape[1], pixels)
    keep = 1.0 - cfg.dropout
    bits = dropout_mask.random_mask_pool(prng.seed_words(seed), n, keep, caps.device)
    with mask_pool_scope(MaskPool(bits, keep)) as pool:
        out = model.tf_forward(enc_out, caps, train=True)
    if pool.offset != n:
        raise RuntimeError(f"dropout sites took {pool.offset} bits, pool_demand counted {n}")
    return out


def tf_loss(
    model,
    batch: Dict[str, torch.Tensor],
    alpha_c: float,
    train: bool,
    seed: Optional[int] = None,
    attvis_regularization: bool = False,
    grad_from: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Teacher-forced loss of ``batch`` (``images`` uint8 NHWC, ``captions``
    (B, T), ``caplens`` (B,), ``valid`` (B,) bool).  ``train`` turns on
    stochastic depth and dropout, drawn from the 64-bit step ``seed``.
    ``grad_from`` runs the encoder with autograd from that ConvNeXt child on
    (``CaptionModel.encode_fine_tune``); None runs it without.
    Returns (loss, {loss, tokens, top5_correct}), the metrics detached."""
    dev = model.device
    caps = batch["captions"].to(dev).long()
    caplens = batch["caplens"].to(dev)
    valid = batch["valid"].to(dev).bool()
    if train and seed is None:
        raise ValueError("a training loss needs a seed")
    enc_gen = prng.generator(prng.fold_in(seed, _ENCODER), dev) if train else None
    if grad_from is None:
        enc_out = model.encode(batch["images"], train=train, generator=enc_gen)
    else:
        enc_out = model.encode_fine_tune(batch["images"], grad_from, generator=enc_gen)
    cfg = model.cfg
    if train and cfg.dropout > 0.0 and cfg.dropout_masks in ("auto", "pool"):
        logits, alphas = _pooled_tf_forward(model, enc_out, caps, prng.fold_in(seed, _DECODER))
    else:
        dec_gen = prng.generator(prng.fold_in(seed, _DECODER), dev) if train else None
        logits, alphas = model.tf_forward(enc_out, caps, train=train, generator=dec_gen)
    t = logits.shape[1]
    tmask = (torch.arange(t, device=dev)[None, :] < (caplens - 1)[:, None]) & valid[:, None]
    targets = caps[:, 1:]
    ce_sum, tokens = masked_cross_entropy(logits, targets, tmask)
    loss = ce_sum / tokens.clamp_min(1.0)
    if attvis_regularization and cfg.decoder == "transformer_attvis" and alpha_c and alphas is not None:
        per_pixel = (1.0 - (alphas * tmask[..., None]).sum(dim=1)) ** 2  # (B, P)
        denom = valid.sum().clamp_min(1) * per_pixel.shape[1]
        loss = loss + alpha_c * (per_pixel * valid[:, None]).sum() / denom
    top5 = topk_correct(logits.detach(), targets, 5, tmask)
    return loss, {"loss": loss.detach(), "tokens": tokens, "top5_correct": top5}


def rollout_loss(
    model,
    batch: Dict[str, torch.Tensor],
    word_ids: Dict[str, int],
    max_decode_len: int,
    *,
    one_cell: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Deterministic free-running loss of ``batch`` (``images``, ``captions``
    (B, >= max_decode_len + 1), ``valid``): the greedy rollout from
    ``<start>``, scored against ``captions[:, 1:]`` over
    ``rollout_token_mask``'s tokens.  Returns (loss, {loss, tokens,
    top5_correct, sequences, lengths}).  The JAX package's doubly stochastic
    term applies to the LSTM family only, which is not ported."""
    dev = model.device
    caps = batch["captions"].to(dev).long()
    valid = batch["valid"].to(dev).bool()
    end = word_ids["<end>"]
    enc_out = model.encode(batch["images"])
    logits, seqs, _ = model.rollout(enc_out, word_ids["<start>"], end, max_decode_len, one_cell=one_cell)
    mask, targets, lengths = rollout_token_mask(seqs, caps, end, word_ids["<pad>"], max_decode_len, valid)
    ce_sum, tokens = masked_cross_entropy(logits, targets, mask)
    loss = ce_sum / tokens.clamp_min(1.0)
    top5 = topk_correct(logits, targets, 5, mask)
    return loss, {"loss": loss, "tokens": tokens, "top5_correct": top5, "sequences": seqs, "lengths": lengths}


def make_train_step(
    model,
    cfg: TrainConfig,
    word_ids: Dict[str, int],
    *,
    teacher_forcing: bool = True,
    train_encoder: bool = False,
) -> Callable:
    """Returns ``step(state, batch, seed) -> (state, metrics)``, which
    updates ``state`` (a ``TrainState`` of ``model``) in place.  ``seed`` is
    a 64-bit step seed (``core.prng.step_seed``); ``metrics`` holds ``loss``,
    ``tokens`` and ``top5_correct``.  ``train_encoder`` trains the ConvNeXt
    children from ``cfg.starting_layer`` on.  After a step the trained
    parameters' ``.grad`` hold the clamped gradients that were applied.
    ``word_ids`` serves the free-running branch, which is not ported yet."""
    del word_ids
    if not teacher_forcing:
        raise NotImplementedError(
            "free-running training (rollout_loss) is not ported yet: ROADMAP.md Queue 1 #8"
        )
    mask = fine_tune_mask(model.encoder, train_encoder, cfg.starting_layer)
    for name, p in model.encoder.named_parameters():
        p.requires_grad_(mask[name])
    enc_params = [p for name, p in model.encoder.named_parameters() if mask[name]]
    grad_from = cfg.starting_layer if train_encoder else None
    dec_params = list(model.decoder.parameters())
    freeze_embedding = model.cfg.embedding_path is not None and not model.cfg.fine_tune_embeddings

    def step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int):
        state.dec_opt.zero_grad(set_to_none=True)
        state.enc_opt.zero_grad(set_to_none=True)
        loss, metrics = tf_loss(
            model, batch, cfg.alpha_c, True, seed, cfg.attvis_regularization, grad_from
        )
        loss.backward()
        if freeze_embedding:
            # nn.Embedding.from_pretrained(freeze=True) (transformerDecoder.py:74).
            zero_frozen(model.decoder, {"embedding.weight": False})
        clip_gradients(enc_params, cfg.grad_clip)
        clip_gradients(dec_params, cfg.grad_clip)
        if train_encoder:
            state.enc_opt.step()
        state.dec_opt.step()
        state.step += 1
        return state, metrics

    return step


def make_eval_step(
    model, cfg: TrainConfig, word_ids: Dict[str, int], *, one_cell: bool = False
) -> Callable:
    """Returns ``step(batch) -> metrics``, the deterministic free-running
    eval of validation and test (train.py:367-441): ``loss``, ``tokens``,
    ``top5_correct``, ``sequences`` (B, ``cfg.max_decode_len``) int32 and
    ``lengths`` (B,).  It runs under ``torch.inference_mode``, so it holds no
    autograd state whatever ``requires_grad`` a train step has set.
    ``one_cell`` runs each token's layers in one kernel launch when the model
    decodes with the per-token kernel."""

    @torch.inference_mode()
    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        _, aux = rollout_loss(model, batch, word_ids, cfg.max_decode_len, one_cell=one_cell)
        return aux

    return step
