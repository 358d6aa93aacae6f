"""Batched beam search with KV caches and attention maps (counterpart of
``tpu_captioner/infer/beam.py``).

Reference semantics, per image (caption.py:96-155):

- cumulative log-softmax scores; step-1 candidates come from beam 0 only;
- top-k over the live beams' (k x V) candidates; ``prev = idx // V``,
  ``word = idx % V``;
- beams that emit <end> are harvested into a running best, and the live width
  shrinks (slot admission: rank < live count);
- the loop ends when no image has live beams or after ``max_steps + 1``
  steps; if no beam completed, the best live beam is returned (the
  reference would crash there);
- per-step attention maps are re-gathered on every beam reshuffle.

The loop is a Python loop over device tensors, batched over images: each
step runs the decoder once over all B*k rows.  Images whose beams have all
finished keep stepping with their rows frozen by masks.  One adapter per
decoder family supplies the step, as in the JAX package: the Transformer's
KV-cached step, the LSTM's cell with attention (plain, or one
``fused_lstm_step`` launch per step) and the LSTM's cell without attention
(its maps are zeros).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from tpu_captioner_torch.models.lstm import flatten_pixels
from tpu_captioner_torch.ops.decode_step import apply_cache_update, fused_decode_step
from tpu_captioner_torch.ops.lstm_step import fused_lstm_step


class BeamResult(NamedTuple):
    sequence: torch.Tensor  # (B, L) int64, starts with <start>; padded with 0
    length: torch.Tensor  # (B,) tokens incl. <start> and <end>
    alphas: torch.Tensor  # (B, L, P) attention map per emitted token (0 at t=0)
    score: torch.Tensor  # (B,) cumulative log-prob


def _beam_loop(
    step_fn: Callable,  # (state, prev_words (B, k), pos) -> (state, logits (B, k, V), alpha (B, k, P))
    gather_fn: Callable,  # (state, rows (B*k,)) -> state
    init_state,
    batch: int,
    beam_size: int,
    max_steps: int,
    seq_len: int,
    num_pixels: int,
    start_id: int,
    end_id: int,
    vocab_size: int,
    device: torch.device,
) -> BeamResult:
    B, k, V = batch, beam_size, vocab_size
    neg_inf = torch.tensor(float("-inf"), device=device)
    slots = torch.arange(k, device=device)
    prev_words = torch.full((B, k), start_id, dtype=torch.long, device=device)
    cum = torch.zeros(B, k, device=device)
    alive = (slots == 0).expand(B, k).clone()  # step 1: beam 0 only
    live = torch.full((B,), k, dtype=torch.long, device=device)
    seqs = torch.zeros(B, k, seq_len, dtype=torch.long, device=device)
    seqs[:, :, 0] = start_id
    alpha_hist = torch.zeros(B, k, seq_len, num_pixels, device=device)
    best_score = torch.full((B,), float("-inf"), device=device)
    best_seq = torch.zeros(B, seq_len, dtype=torch.long, device=device)
    best_alpha = torch.zeros(B, seq_len, num_pixels, device=device)
    best_len = torch.zeros(B, dtype=torch.long, device=device)
    state = init_state

    def take(x, idx):  # x (B, k, ...), idx (B, k) -> reshuffled beams
        return torch.gather(x, 1, idx.view(idx.shape + (1,) * (x.dim() - 2)).expand_as(x))

    t = 1
    while t <= max_steps + 1 and bool((live > 0).any()):
        frozen = live == 0  # (B,)
        state, logits, alpha = step_fn(state, prev_words, t - 1)
        logp = F.log_softmax(logits.float(), dim=-1)
        cand = torch.where(alive[:, :, None], cum[:, :, None] + logp, neg_inf)
        top_scores, top_idx = cand.reshape(B, k * V).topk(k, dim=1)
        prev_idx = top_idx // V
        words = top_idx % V

        admitted = (slots[None, :] < live[:, None]) & ~frozen[:, None]
        is_end = words == end_id

        new_seqs = take(seqs, prev_idx)
        new_seqs[:, :, t] = words
        new_hist = take(alpha_hist, prev_idx)
        new_hist[:, :, t] = take(alpha, prev_idx)
        # Frozen images keep their final seqs/history unchanged.
        new_seqs = torch.where(frozen[:, None, None], seqs, new_seqs)
        new_hist = torch.where(frozen[:, None, None, None], alpha_hist, new_hist)

        # Harvest completed beams into the running best (per image).
        comp = torch.where(admitted & is_end, top_scores, neg_inf)
        b = comp.argmax(dim=1)
        b_score = comp.gather(1, b[:, None])[:, 0]
        improved = b_score > best_score
        best_score = torch.where(improved, b_score, best_score)
        b_seq = new_seqs[torch.arange(B, device=device), b]
        b_alpha = new_hist[torch.arange(B, device=device), b]
        best_seq = torch.where(improved[:, None], b_seq, best_seq)
        best_alpha = torch.where(improved[:, None, None], b_alpha, best_alpha)
        best_len = torch.where(improved, torch.full_like(best_len, t + 1), best_len)

        alive = admitted & ~is_end
        rows = (torch.arange(B, device=device)[:, None] * k + prev_idx).reshape(-1)
        prev_words = torch.where(frozen[:, None], prev_words, words)
        cum = torch.where(frozen[:, None], cum, torch.where(alive, top_scores, neg_inf))
        live = alive.sum(dim=1)
        seqs, alpha_hist = new_seqs, new_hist
        state = gather_fn(state, rows)
        t += 1

    # No beam completed -> the best live beam (divergence from the reference,
    # which would crash).
    none_done = torch.isneginf(best_score)
    fb = cum.argmax(dim=1)
    ar = torch.arange(B, device=device)
    seq = torch.where(none_done[:, None], seqs[ar, fb], best_seq)
    alpha = torch.where(none_done[:, None, None], alpha_hist[ar, fb], best_alpha)
    score = torch.where(none_done, cum[ar, fb], best_score)
    length = torch.where(none_done, torch.full_like(best_len, t), best_len)
    return BeamResult(seq, length, alpha, score)


# ---------------------------------------------------------------------------
# Decoder-family adapters (model-state rows = B * beam_size, image-major)
# ---------------------------------------------------------------------------

def _transformer_beam(model, enc_out, beam_size, max_steps):
    """Plain adapter: the head-split KV-cached ``TransformerDecoder.decode_step``."""
    dec = model.decoder
    B, k = enc_out.shape[0], beam_size
    V, P = model.cfg.vocab_size, model.cfg.num_pixels
    mem1 = dec.precompute_memory(enc_out)  # rows = B
    memory = type(mem1)(
        mem1.mem.repeat_interleave(k, dim=0),
        mem1.k.repeat_interleave(k, dim=1),
        mem1.v.repeat_interleave(k, dim=1),
    )
    cache0 = dec.init_cache(B * k, max_steps + 2)

    def step_fn(cache, prev_words, pos):
        logits, cache, alpha = dec.decode_step(prev_words.reshape(-1), pos, cache, memory)
        return cache, logits.view(B, k, V), alpha.view(B, k, P)

    def gather_fn(cache, rows):
        return type(cache)(cache.k[:, rows], cache.v[:, rows])

    return step_fn, gather_fn, cache0


def _transformer_beam_fused(model, enc_out, beam_size, max_steps):
    """Kernel adapter: the whole decode body as ``fused_decode_step`` over all
    B*k rows (the CUDA kernel for CUDA tensors), in the arm of the model's
    dtype (``CaptionModel.dtype``, through ``kernel_operands``: a bf16
    model's weights, memory K/V and caches in bf16, as
    tpu_captioner/infer/beam.py:298-348 takes them on its chip)."""
    dec = model.decoder
    c = model.cfg
    B, k = enc_out.shape[0], beam_size
    V, P = c.vocab_size, c.num_pixels
    mem = dec.project_memory(enc_out).repeat_interleave(k, dim=0)  # (B*k, P, E)
    kw, mem_k, mem_v, ck0, cv0 = dec.kernel_operands(mem, max_steps + 2, model.dtype)

    def step_fn(state, prev_words, pos):
        ck, cv = state
        x = dec.embed(prev_words.reshape(-1), pos).to(ck.dtype)
        x_out, alpha, k_new, v_new = fused_decode_step(
            kw, x.contiguous(), pos, ck, cv, mem_k, mem_v, c.num_heads
        )
        ck, cv = apply_cache_update(ck, cv, k_new, v_new, pos)
        logits = dec.fc_out(x_out)
        return (ck, cv), logits.view(B, k, V), alpha.view(B, k, P)

    def gather_fn(state, rows):
        ck, cv = state
        return ck[:, rows], cv[:, rows]

    return step_fn, gather_fn, (ck0, cv0)


def _lstm_attention_beam(model, enc_out, beam_size, max_steps):
    """LSTM with attention: the plain ``step`` or, with the decode kernel,
    ``fused_lstm_step`` over all B*k rows (the CUDA kernel for CUDA
    tensors) in the arm of the model's dtype (``kernel_operands``: a bf16
    model's weight matrices, features, their projection and the embedded
    tokens in bf16, as tpu_captioner/infer/beam.py:185-230 takes them on its
    chip).  The plain step runs in f32 on widened features.  Eval: no
    dropout before the head (caption.py:512)."""
    dec = model.decoder
    B, k = enc_out.shape[0], beam_size
    V, P = model.cfg.vocab_size, model.cfg.num_pixels
    enc = flatten_pixels(enc_out)
    h0, c0 = dec.init_hidden_state(enc.repeat_interleave(k, dim=0))

    def rows(t):  # (B, ...) -> (B*k, ...), image-major
        return t.repeat_interleave(k, dim=0).contiguous()

    if model.use_decode_kernel():
        dt = model.dtype
        w, enc_s, att1 = dec.kernel_operands(enc, dt)
        enc_s, att1 = rows(enc_s), rows(att1)
        cell = lambda h, c, emb: fused_lstm_step(w, emb.to(dt), h, c, enc_s, att1)  # noqa: E731
    else:
        enc_s = rows(enc.float())
        att1 = rows(dec.attention.encoder_att(enc.float()))
        cell = lambda h, c, emb: dec.step(h, c, emb, enc_s, att1)  # noqa: E731

    def step_fn(state, prev_words, _pos):
        h, c, alpha = cell(*state, dec.embedding(prev_words.reshape(-1)))
        return (h, c), dec.fc(h).view(B, k, V), alpha.view(B, k, P)

    return step_fn, _gather_rows, (h0, c0)


def _lstm_plain_beam(model, enc_out, beam_size, max_steps):
    """LSTM without attention: the cell on the token embedding; the maps
    are zeros."""
    dec = model.decoder
    B, k = enc_out.shape[0], beam_size
    V, P = model.cfg.vocab_size, model.cfg.num_pixels
    h0, c0 = dec.init_hidden_state(flatten_pixels(enc_out).repeat_interleave(k, dim=0))
    zeros = h0.new_zeros(B, k, P)

    def step_fn(state, prev_words, _pos):
        h, c, _ = dec.step(*state, dec.embedding(prev_words.reshape(-1)))
        return (h, c), dec.fc(h).view(B, k, V), zeros

    return step_fn, _gather_rows, (h0, c0)


def _gather_rows(state, rows):
    h, c = state
    return h[rows], c[rows]


def _transformer_adapter(model, *args):
    if model.use_decode_kernel():
        return _transformer_beam_fused(model, *args)
    return _transformer_beam(model, *args)


_ADAPTERS = {
    "lstm": _lstm_attention_beam,
    "lstm_no_attention": _lstm_plain_beam,
    "transformer": _transformer_adapter,
    "transformer_attvis": _transformer_adapter,
}


def _beam_batched(model, enc_out, *, beam_size, max_steps, start_id, end_id) -> BeamResult:
    adapter = _ADAPTERS[model.cfg.decoder]
    step_fn, gather_fn, init_state = adapter(model, enc_out, beam_size, max_steps)
    return _beam_loop(
        step_fn, gather_fn, init_state,
        enc_out.shape[0], beam_size, max_steps,
        seq_len=max_steps + 2,
        num_pixels=model.cfg.num_pixels,
        start_id=start_id, end_id=end_id,
        vocab_size=model.cfg.vocab_size,
        device=enc_out.device,
    )


@torch.inference_mode()
def beam_search_batch(
    model,  # CaptionModel
    images_u8: torch.Tensor,  # (B, H, W, 3) uint8
    *,
    beam_size: int = 5,
    max_steps: int = 50,
    start_id: int,
    end_id: int,
) -> BeamResult:
    """One encoder pass, then one batched beam loop over all images."""
    enc_out = model.encode(images_u8)
    return _beam_batched(
        model, enc_out, beam_size=beam_size, max_steps=max_steps,
        start_id=start_id, end_id=end_id,
    )


@torch.inference_mode()
def beam_search_encoded(
    model, enc_out: torch.Tensor, *, beam_size: int = 5, max_steps: int = 50,
    start_id: int, end_id: int,
) -> BeamResult:
    """Beam search from precomputed encoder output (B, e, e, C)."""
    return _beam_batched(
        model, enc_out, beam_size=beam_size, max_steps=max_steps,
        start_id=start_id, end_id=end_id,
    )


def beam_search(
    model, image_u8: torch.Tensor, *, beam_size: int = 5, max_steps: int = 50,
    start_id: int, end_id: int,
) -> BeamResult:
    """Single-image beam search (caption.py entry semantics); fields without
    the image axis."""
    res = beam_search_batch(
        model, image_u8[None], beam_size=beam_size, max_steps=max_steps,
        start_id=start_id, end_id=end_id,
    )
    return BeamResult(*(x[0] for x in res))
