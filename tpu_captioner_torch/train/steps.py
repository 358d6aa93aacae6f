"""Train and eval steps (counterpart of ``tpu_captioner/train/steps.py``).

Ported: the train step, teacher-forced or free-running
(``teacher_forcing=False``, train.py:293-361), with the encoder frozen, which
the reference trains for its first ``fine_tune_epoch`` epochs
(train.py:240-291), and fine-tuned from ``starting_layer`` on
(``train_encoder=True``), which it trains after them; and the greedy eval
step (``make_eval_step``) behind every validation loss, top-5 and BLEU
number (train.py:367-441); for all four decoder families.  The train step:
- teacher-forced, the loss is the cross-entropy over the tokens at
  ``t < caplen - 1`` of valid rows, divided by their count
  (``nn.CrossEntropyLoss`` over ``pack_padded_sequence`` tokens,
  train.py:266-276), plus for ``lstm`` ``alpha_c`` times the doubly
  stochastic attention term (train.py:269);
- free-running, it is ``rollout_loss`` with dropout and gradients: the
  plain greedy rollout of ``cfg.max_decode_len`` steps, dropout drawn once
  per token and site (``CaptionModel.rollout(deterministic=False)``), with
  ``cfg.scheduled_sampling_prob`` of the inputs taken from the captions;
  the step launches no dropout pool;
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
``rollout_token_mask``'s tokens, with the LSTM's term over the rollout's
maps.

Data parallel (``mesh``, a ``parallel.mesh.Mesh``): each rank holds its rows
of the global batch, and computes what one process computes on the global
batch, as the JAX mesh step does:
- every random draw is the global batch's, this rank keeping its rows
  (``models.layers.row_shard_scope``), so the dropout pool counts and draws
  the global batch's bits;
- the loss is divided by the global token count (and the doubly stochastic
  term by the global count of valid rows), all-reduced before the backward:
  for the free-running loss that is after the rollout;
- the gradients are summed over the ranks (``all_reduce_gradients``) before
  the elementwise clamp, so every rank applies the same update;
- the metrics (loss, tokens, top-5) are global.
The collectives are explicit: ``DistributedDataParallel`` fixes its
parameters when it is built, while the step sets ``requires_grad`` per call
and the Trainer unlocks the encoder mid-run.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from tpu_captioner_torch.core import prng
from tpu_captioner_torch.core.config import LSTM_DECODERS, ModelConfig, TrainConfig
from tpu_captioner_torch.eval.metrics import masked_cross_entropy, rollout_token_mask, topk_correct
from tpu_captioner_torch.models.encoder import fine_tune_mask
from tpu_captioner_torch.models.layers import MaskPool, mask_pool_scope, row_shard, row_shard_scope
from tpu_captioner_torch.ops import dropout_mask
from tpu_captioner_torch.parallel.collectives import all_reduce_gradients, all_reduce_sum
from tpu_captioner_torch.parallel.mesh import Mesh
from tpu_captioner_torch.train.state import TrainState, clip_gradients, zero_frozen

# Folds of a step seed: the encoder's stochastic depth and the decoder's
# dropout draw independent streams, as the JAX step splits its key.
_ENCODER, _DECODER = 0, 1


def pool_demand(cfg: ModelConfig, batch: int, length: int, pixels: int) -> int:
    """Keep-bits one teacher-forced decoder forward over (B, T) captions
    takes.  LSTM families: the (B, T-1, D) hidden states before the head.
    Transformer families: the embedding's (B, T, E), then per layer the
    self- and cross-attention probabilities (B, H, T, T) and (B, H, T, P),
    three (B, T, E) outputs and the (B, T, FFN) hidden layer."""
    if cfg.decoder in LSTM_DECODERS:
        return batch * (length - 1) * cfg.decoder_dim
    e, h, f = cfg.embed_dim, cfg.num_heads, cfg.decoder_dim
    per_layer = batch * length * (h * length + h * pixels + 3 * e + f)
    return batch * length * e + cfg.num_layers * per_layer


def _shard(mesh: Optional[Mesh]) -> Tuple[int, int]:
    return (0, 1) if mesh is None else (mesh.rank, mesh.size)


def _global(mesh: Optional[Mesh], *values: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``values`` summed over the ranks, in one all-reduce (as they are
    without a group)."""
    if mesh is None or mesh.group is None:
        return values
    return all_reduce_sum(torch.stack([v.float() for v in values]), mesh).unbind()


def _pooled_tf_forward(model, enc_out: torch.Tensor, caps: torch.Tensor, seed: int):
    """``model.tf_forward`` in training mode with every dropout mask taken
    from one pooled draw, for the global batch inside ``row_shard_scope``."""
    cfg = model.cfg
    pixels = enc_out.shape[1] * enc_out.shape[2] if enc_out.dim() == 4 else enc_out.shape[1]
    n = pool_demand(cfg, caps.shape[0] * row_shard()[1], caps.shape[1], pixels)
    keep = 1.0 - cfg.dropout
    bits = dropout_mask.random_mask_pool(prng.seed_words(seed), n, keep, caps.device)
    with mask_pool_scope(MaskPool(bits, keep)) as pool:
        out = model.tf_forward(enc_out, caps, train=True)
    if pool.offset != n:
        raise RuntimeError(f"dropout sites took {pool.offset} bits, pool_demand counted {n}")
    return out


def doubly_stochastic(
    alphas: torch.Tensor, valid: torch.Tensor, valid_count: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The doubly stochastic attention term (train.py:269): the mean over
    valid rows and the P pixels of (1 - sum over steps of alpha)^2, for
    (B, T, P) maps already masked to the scored steps.  ``valid_count``
    replaces ``valid.sum()`` (the global batch's count under a mesh)."""
    per_pixel = (1.0 - alphas.sum(dim=1)) ** 2  # (B, P)
    denom = (valid.sum() if valid_count is None else valid_count).clamp_min(1) * per_pixel.shape[1]
    return (per_pixel * valid[:, None]).sum() / denom


def tf_loss(
    model,
    batch: Dict[str, torch.Tensor],
    alpha_c: float,
    train: bool,
    seed: Optional[int] = None,
    attvis_regularization: bool = False,
    grad_from: Optional[int] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Teacher-forced loss of ``batch`` (``images`` uint8 NHWC, ``captions``
    (B, T), ``caplens`` (B,), ``valid`` (B,) bool).  ``train`` turns on
    stochastic depth and dropout, drawn from the 64-bit step ``seed``.
    ``grad_from`` runs the encoder with autograd from that ConvNeXt child on
    (``CaptionModel.encode_fine_tune``); None runs it without.  Under
    ``mesh`` the batch is this rank's rows and the loss this rank's share
    of the global batch's (see the module note).
    Returns (loss, {loss, tokens, top5_correct}), the metrics detached and
    global."""
    dev = model.device
    caps = batch["captions"].to(dev).long()
    caplens = batch["caplens"].to(dev)
    valid = batch["valid"].to(dev).bool()
    if train and seed is None:
        raise ValueError("a training loss needs a seed")
    cfg = model.cfg
    with row_shard_scope(*_shard(mesh)):
        if train:
            enc_out = _train_encode(model, batch["images"], seed, grad_from)
        elif grad_from is None:
            enc_out = model.encode(batch["images"])
        else:
            enc_out = model.encode_fine_tune(batch["images"], grad_from)
        if train and cfg.dropout > 0.0 and cfg.dropout_masks in ("auto", "pool"):
            logits, alphas = _pooled_tf_forward(model, enc_out, caps, prng.fold_in(seed, _DECODER))
        else:
            dec_gen = prng.generator(prng.fold_in(seed, _DECODER), dev) if train else None
            logits, alphas = model.tf_forward(enc_out, caps, train=train, generator=dec_gen)
    t = logits.shape[1]
    tmask = (torch.arange(t, device=dev)[None, :] < (caplens - 1)[:, None]) & valid[:, None]
    targets = caps[:, 1:]
    regularised = cfg.decoder == "lstm" or (attvis_regularization and cfg.decoder == "transformer_attvis")
    masked = None if alphas is None else alphas * tmask[..., None]
    return _finish(logits, targets, tmask, valid, alpha_c if regularised else 0.0, masked, mesh)


def _finish(logits, targets, mask, valid, alpha_c, alphas, mesh):
    """The loss over ``mask``'s tokens, divided by the global token count,
    plus ``alpha_c`` times the doubly stochastic term of ``alphas`` (already
    masked) over the global count of valid rows; and the global metrics."""
    ce_sum, tokens = masked_cross_entropy(logits, targets, mask)
    tokens_all, valid_all = _global(mesh, tokens, valid.sum())
    loss = ce_sum / tokens_all.clamp_min(1.0)
    if alpha_c and alphas is not None:
        loss = loss + alpha_c * doubly_stochastic(alphas, valid, valid_all)
    top5 = topk_correct(logits.detach(), targets, 5, mask)
    loss_all, top5_all = _global(mesh, loss.detach(), top5)
    return loss, {"loss": loss_all, "tokens": tokens_all, "top5_correct": top5_all}


def _train_encode(model, images, seed: int, grad_from: Optional[int]) -> torch.Tensor:
    """The encoder of a training loss: stochastic depth drawn from the step
    seed's encoder fold; autograd from ``grad_from`` on, or none."""
    enc_gen = prng.generator(prng.fold_in(seed, _ENCODER), model.device)
    if grad_from is None:
        return model.encode(images, train=True, generator=enc_gen)
    return model.encode_fine_tune(images, grad_from, generator=enc_gen)


def rollout_loss(
    model,
    batch: Dict[str, torch.Tensor],
    word_ids: Dict[str, int],
    alpha_c: float,
    max_decode_len: int,
    *,
    one_cell: bool = False,
    train: bool = False,
    seed: Optional[int] = None,
    grad_from: Optional[int] = None,
    scheduled_sampling_prob: float = 0.0,
    mesh: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Free-running loss of ``batch`` (``images``, ``captions``
    (B, >= max_decode_len + 1), ``valid``): the greedy rollout from
    ``<start>``, scored against ``captions[:, 1:]`` over
    ``rollout_token_mask``'s tokens, plus for ``lstm`` ``alpha_c`` times the
    doubly stochastic term of the rollout's maps (steps after a row's
    ``<end>`` hold zeros).  Deterministic by default (eval, through the
    rollout ``decode_kernel`` selects).  ``train`` runs the training form
    (tpu_captioner/train/steps.py:155-198): stochastic depth and dropout
    from the 64-bit step ``seed``, the plain rollout with autograd, the
    encoder with autograd from ``grad_from`` (as ``tf_loss``), and with
    ``scheduled_sampling_prob`` above 0 that share of the inputs taken from
    the captions.  Under ``mesh`` as ``tf_loss``: the rollout's token count
    is all-reduced once the rollout has run.  Returns (loss, {loss, tokens,
    top5_correct, sequences, lengths}), the metrics detached and global,
    the sequences and lengths this rank's."""
    dev = model.device
    caps = batch["captions"].to(dev).long()
    valid = batch["valid"].to(dev).bool()
    end = word_ids["<end>"]
    args = (word_ids["<start>"], end, max_decode_len)
    if train and seed is None:
        raise ValueError("a training loss needs a seed")
    with row_shard_scope(*_shard(mesh)):
        if train:
            enc_out = _train_encode(model, batch["images"], seed, grad_from)
            logits, seqs, alphas = model.rollout(
                enc_out, *args, deterministic=False,
                generator=prng.generator(prng.fold_in(seed, _DECODER), dev),
                teacher_tokens=caps if scheduled_sampling_prob > 0 else None,
                teacher_prob=scheduled_sampling_prob,
            )
        else:
            enc_out = model.encode(batch["images"])
            logits, seqs, alphas = model.rollout(enc_out, *args, one_cell=one_cell)
    mask, targets, lengths = rollout_token_mask(seqs, caps, end, word_ids["<pad>"], max_decode_len, valid)
    alpha = alpha_c if model.cfg.decoder == "lstm" else 0.0
    loss, metrics = _finish(logits, targets, mask, valid, alpha, alphas, mesh)
    return loss, {**metrics, "sequences": seqs, "lengths": lengths}


def make_train_step(
    model,
    cfg: TrainConfig,
    word_ids: Dict[str, int],
    *,
    teacher_forcing: bool = True,
    train_encoder: bool = False,
    mesh: Optional[Mesh] = None,
) -> Callable:
    """Returns ``step(state, batch, seed) -> (state, metrics)``, which
    updates ``state`` (a ``TrainState`` of ``model``) in place.  ``seed`` is
    a 64-bit step seed (``core.prng.step_seed``); ``metrics`` holds ``loss``,
    ``tokens`` and ``top5_correct``.  ``teacher_forcing`` picks ``tf_loss``,
    else ``rollout_loss`` in its training form with ``word_ids``' ids and
    ``cfg.scheduled_sampling_prob``.  ``train_encoder`` trains the ConvNeXt
    children from ``cfg.starting_layer`` on; the step sets the encoder's
    ``requires_grad`` to that choice when it is made and again when a call
    finds it changed, so frozen and fine-tune steps may share a model.
    After a step the trained parameters' ``.grad`` hold the clamped
    gradients that were applied.  Under ``mesh`` the batch is this rank's
    rows, the gradients are summed over the ranks before the clamp, and the
    metrics are global (see the module note)."""
    mask = fine_tune_mask(model.encoder, train_encoder, cfg.starting_layer)
    flags = [(p, mask[name]) for name, p in model.encoder.named_parameters()]
    for p, on in flags:
        p.requires_grad_(on)
    enc_params = [p for p, on in flags if on]
    grad_from = cfg.starting_layer if train_encoder else None
    dec_params = list(model.decoder.parameters())
    freeze_embedding = model.cfg.embedding_path is not None and not model.cfg.fine_tune_embeddings

    def loss_for(batch, seed):
        if teacher_forcing:
            return tf_loss(model, batch, cfg.alpha_c, True, seed, cfg.attvis_regularization, grad_from, mesh)
        return rollout_loss(
            model, batch, word_ids, cfg.alpha_c, cfg.max_decode_len, train=True, seed=seed,
            grad_from=grad_from, scheduled_sampling_prob=cfg.scheduled_sampling_prob, mesh=mesh,
        )

    def step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int):
        for p, on in flags:
            if p.requires_grad != on:
                p.requires_grad_(on)
        state.dec_opt.zero_grad(set_to_none=True)
        state.enc_opt.zero_grad(set_to_none=True)
        loss, metrics = loss_for(batch, seed)
        metrics = {k: metrics[k] for k in ("loss", "tokens", "top5_correct")}
        loss.backward()
        all_reduce_gradients(enc_params + dec_params, mesh)
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
    model, cfg: TrainConfig, word_ids: Dict[str, int], *, one_cell: bool = False, mesh: Optional[Mesh] = None
) -> Callable:
    """Returns ``step(batch) -> metrics``, the deterministic free-running
    eval of validation and test (train.py:367-441), with ``cfg.alpha_c``'s
    term for ``lstm``: ``loss``, ``tokens``,
    ``top5_correct``, ``sequences`` (B, ``cfg.max_decode_len``) int32 and
    ``lengths`` (B,).  It runs under ``torch.inference_mode``, so it holds no
    autograd state whatever ``requires_grad`` a train step has set.
    ``one_cell`` runs each token's layers in one kernel launch when the model
    decodes with the per-token kernel.  A bf16 model evaluates in every
    decode mode, each kernel in its bf16 arm.  Under ``mesh`` the metrics
    are global, the sequences and lengths this rank's rows'."""

    @torch.inference_mode()
    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        _, aux = rollout_loss(model, batch, word_ids, cfg.alpha_c, cfg.max_decode_len, one_cell=one_cell,
                              mesh=mesh)
        return aux

    return step
