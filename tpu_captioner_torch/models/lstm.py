"""LSTM caption decoders (counterpart of ``tpu_captioner/models/lstm.py``):
``DecoderWithAttention`` (soft attention, Show-Attend-Tell style) and
``DecoderWithoutAttention`` (the no-attention baseline).

Parameter names are the reference's (models/decoder.py,
models/lstmNoAttention.py): ``embedding``, ``attention.{encoder_att,
decoder_att, full_att}``, ``init_h``, ``init_c``, ``f_beta``, ``decode_step``
(an ``nn.LSTMCell``: ``weight_ih``, ``weight_hh``, ``bias_ih``,
``bias_hh``) and ``fc``, so a reference checkpoint's decoder state dict loads
directly.

``tf_forward`` is the teacher-forced pass of training: one Python loop over
the L - 1 input tokens on the full batch (the loss masks what the
reference's shrinking batch skips).  As in the JAX package, the token half
of the gate product and the vocab head are hoisted out of the loop, and the
three products of h (decoder_att, f_beta, weight_hh) merge into one
(A + C + 4D, D) product per step.  Its one dropout site is the (B, L - 1, D)
hidden states before the head, drawn from the active ``MaskPool`` or from a
generator.

The greedy rollouts of eval, ``rollout`` over the plain ``step`` and (with
attention) ``fused_rollout`` over ``ops/lstm_step.py:fused_lstm_step``, are
deterministic: no dropout.  They mix teacher tokens in when given
(scheduled sampling), freeze the state of rows that have emitted ``<end>``
and zero their outputs, and stop once every row has finished when no
teacher tokens are mixed in.  ``rollout(train=True)`` is the free-running
rollout of training: the plain step with dropout on each step's new hidden
state before the head (tpu_captioner/models/lstm.py:253, 445), drawn once
per token from the rollout's generator, autograd through the loop, and
every step run.  They return (logits (B, T, V), sequences
(B, T) int32, attention maps (B, T, P), or None without attention).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_captioner_torch.core.config import ModelConfig
from tpu_captioner_torch.core.loops import scan_early_exit
from tpu_captioner_torch.models import torch_init
from tpu_captioner_torch.models.layers import dropout, lstm_cell, lstm_update
from tpu_captioner_torch.models.transformer import teacher_schedule
from tpu_captioner_torch.ops import lstm_step as lstm_ops


def flatten_pixels(encoder_out: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) or (B, P, C) -> (B, P, C)."""
    return encoder_out.flatten(1, 2) if encoder_out.dim() == 4 else encoder_out


class Attention(nn.Module):
    """Bahdanau additive attention (decoder.py:16-31)."""

    def __init__(self, encoder_dim: int, decoder_dim: int, attention_dim: int, device=None):
        super().__init__()
        self.encoder_att = nn.Linear(encoder_dim, attention_dim, device=device)
        self.decoder_att = nn.Linear(decoder_dim, attention_dim, device=device)
        self.full_att = nn.Linear(attention_dim, 1, device=device)

    def from_projected(self, enc: torch.Tensor, att1: torch.Tensor, h: torch.Tensor):
        """(context (B, C), alpha (B, P)) of ``enc`` (B, P, C), whose
        ``encoder_att`` projection ``att1`` is hoisted by the caller."""
        att2 = self.decoder_att(h)
        alpha = torch.softmax(self.full_att(torch.relu(att1 + att2[:, None, :]))[..., 0], dim=1)
        return torch.einsum("bp,bpc->bc", alpha, enc), alpha


def _reset_cell(cell: nn.LSTMCell, gen: torch.Generator) -> None:
    for t in (cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh):
        torch_init.lstm_uniform(t, cell.hidden_size, gen)


class _LstmDecoder(nn.Module):
    """What both families share: the embedding, the initial state from the
    mean encoder pixel, the LSTM cell, the vocab head and the greedy loop."""

    def __init__(self, cfg: ModelConfig, cell_input: int, device=None):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.embedding = nn.Embedding(c.vocab_size, c.embed_dim, device=device)
        self.init_h = nn.Linear(c.encoder_dim, c.decoder_dim, device=device)
        self.init_c = nn.Linear(c.encoder_dim, c.decoder_dim, device=device)
        self.decode_step = nn.LSTMCell(cell_input, c.decoder_dim, device=device)
        self.fc = nn.Linear(c.decoder_dim, c.vocab_size, device=device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """Seeded init with the JAX package's distributions (decoder.py:58-61):
        U(+-0.1) embedding and head weight, zero head bias, default Linears,
        U(+-1/sqrt(D)) cell."""
        torch_init.uniform_pm(self.embedding.weight, 0.1, gen)
        for lin in self._linears():
            torch_init.linear_default(lin, gen)
        _reset_cell(self.decode_step, gen)
        torch_init.uniform_pm(self.fc.weight, 0.1, gen)
        self.fc.bias.zero_()

    def _linears(self):
        return (self.init_h, self.init_c)

    def init_hidden_state(self, enc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(h0, c0) from the mean pixel of ``enc`` (B, P, C) (decoder.py:63-67)."""
        mean = enc.mean(dim=1)
        return self.init_h(mean), self.init_c(mean)

    def _rollout(
        self, h0: torch.Tensor, c0: torch.Tensor, step_fn: Callable, start_id: int, end_id: int,
        steps: int, generator, teacher_tokens, teacher_prob: float, train: bool = False,
    ):
        """The greedy loop around ``step_fn(h, c, emb) -> (h_new, c_new,
        alpha or None)`` (decoder.py:119-163): the teacher mix, the head and
        argmax, the finished-row freeze and zeroed outputs, the early exit
        (not in ``train``).  ``train`` drops the head's input out; the draw
        of token t is named ``(t,)``: the JAX package takes the t-th key of
        its split, with no fold."""
        B, dev = h0.shape[0], h0.device
        teacher, use = teacher_schedule(teacher_tokens, teacher_prob, generator, steps, B, dev)
        if train and generator is None:
            raise ValueError("a training rollout needs a generator for its dropout")

        def body(carry, t):
            h, c, tok, finished = carry
            if teacher is not None:
                tok = torch.where(use[t], teacher[t], tok)
            h_new, c_new, alpha = step_fn(h, c, self.embedding(tok))
            logits = self.fc(dropout(h_new, self.cfg.dropout, generator, train, site=(t,)))
            pred = logits.argmax(dim=-1)
            act = ~finished
            outs = (torch.where(act[:, None], logits, 0.0), torch.where(act, pred, 0).to(torch.int32))
            if alpha is not None:
                outs += (torch.where(act[:, None], alpha, 0.0),)
            carry = (
                torch.where(act[:, None], h_new, h), torch.where(act[:, None], c_new, c),
                torch.where(act, pred, tok), finished | (act & (pred == end_id)),
            )
            return carry, outs

        tok0 = torch.full((B,), start_id, dtype=torch.long, device=dev)
        fin0 = torch.zeros(B, dtype=torch.bool, device=dev)
        done = (lambda carry: carry[3].all()) if teacher is None and not train else (lambda carry: False)
        _, outs = scan_early_exit(body, (h0, c0, tok0, fin0), range(steps), done)
        outs = [o.transpose(0, 1) for o in outs]
        return outs[0], outs[1], outs[2] if len(outs) > 2 else None


class DecoderWithAttention(_LstmDecoder):
    """Reference models/decoder.py:34-172."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, cfg.embed_dim + cfg.encoder_dim, device)
        self.attention = Attention(cfg.encoder_dim, cfg.decoder_dim, cfg.attention_dim, device)
        self.f_beta = nn.Linear(cfg.decoder_dim, cfg.encoder_dim, device=device)

    def _linears(self):
        att = self.attention
        return (att.encoder_att, att.decoder_att, att.full_att, self.init_h, self.init_c, self.f_beta)

    def step(self, h, c, emb, enc, att1):
        """One decode step (plain): (h_new, c_new, alpha)."""
        ctx, alpha = self.attention.from_projected(enc, att1, h)
        ctx = torch.sigmoid(self.f_beta(h)) * ctx  # decoder.py:104-105
        cell = self.decode_step
        h_new, c_new = lstm_cell(
            torch.cat([emb, ctx], dim=-1), h, c, cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh
        )
        return h_new, c_new, alpha

    def tf_forward(
        self,
        encoder_out: torch.Tensor,  # (B, 7, 7, C) or (B, P, C)
        captions: torch.Tensor,  # (B, L) token ids
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits (B, L-1, V), alphas (B, L-1, P)); ``logits[:, t]``
        predicts ``captions[:, t + 1]``.  Unmasked: the loss applies the
        decode-length mask."""
        enc = flatten_pixels(encoder_out)
        att, cell = self.attention, self.decode_step
        att1 = att.encoder_att(enc)
        h, c = self.init_hidden_state(enc)
        embs = self.embedding(captions[:, :-1])  # (B, T, E)
        E, A, C = embs.shape[-1], att1.shape[-1], enc.shape[-1]
        emb_gates = F.linear(embs, cell.weight_ih[:, :E])  # (B, T, 4D)
        wh = torch.cat([att.decoder_att.weight, self.f_beta.weight, cell.weight_hh])  # (A + C + 4D, D)
        w_full, b_full = att.full_att.weight[0], att.full_att.bias[0]
        w_ih_c = cell.weight_ih[:, E:]
        bias = cell.bias_ih + cell.bias_hh
        hids, alphas = [], []
        for t in range(embs.shape[1]):
            hp = F.linear(h, wh)
            score = torch.relu(att1 + (hp[:, :A] + att.decoder_att.bias)[:, None, :]) @ w_full + b_full
            alpha = torch.softmax(score, dim=1)
            ctx = torch.einsum("bp,bpc->bc", alpha, enc)
            gate = torch.sigmoid(hp[:, A : A + C] + self.f_beta.bias)
            h, c = lstm_update(emb_gates[:, t] + F.linear(gate * ctx, w_ih_c) + hp[:, A + C :] + bias, c)
            hids.append(h)
            alphas.append(alpha)
        hids = dropout(torch.stack(hids, dim=1), self.cfg.dropout, generator, train)  # decoder.py:109
        return self.fc(hids), torch.stack(alphas, dim=1)

    def rollout(
        self, encoder_out: torch.Tensor, start_id: int, end_id: int, max_decode_len: int, *,
        generator: Optional[torch.Generator] = None, teacher_tokens: Optional[torch.Tensor] = None,
        teacher_prob: float = 0.0, train: bool = False,
    ):
        """Greedy decode over the plain ``step``; ``train`` as ``_rollout``."""
        enc = flatten_pixels(encoder_out)
        att1 = self.attention.encoder_att(enc)
        h0, c0 = self.init_hidden_state(enc)
        return self._rollout(
            h0, c0, lambda h, c, emb: self.step(h, c, emb, enc, att1),
            start_id, end_id, max_decode_len, generator, teacher_tokens, teacher_prob, train,
        )

    def fused_rollout(
        self, encoder_out: torch.Tensor, start_id: int, end_id: int, max_decode_len: int, *,
        generator: Optional[torch.Generator] = None, teacher_tokens: Optional[torch.Tensor] = None,
        teacher_prob: float = 0.0,
    ):
        """``rollout`` with each token's attention and cell in
        ``fused_lstm_step`` (one kernel launch per token on the card)."""
        enc = flatten_pixels(encoder_out).contiguous()
        att1 = self.attention.encoder_att(enc)
        h0, c0 = self.init_hidden_state(enc)
        w = lstm_ops.prepare_lstm_weights(self)
        return self._rollout(
            h0, c0, lambda h, c, emb: lstm_ops.fused_lstm_step(w, emb, h, c, enc, att1),
            start_id, end_id, max_decode_len, generator, teacher_tokens, teacher_prob,
        )


class DecoderWithoutAttention(_LstmDecoder):
    """Reference models/lstmNoAttention.py:13-139: the cell reads the token
    embedding alone; the image enters through the initial state."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, cfg.embed_dim, device)

    def step(self, h, c, emb):
        cell = self.decode_step
        return (*lstm_cell(emb, h, c, cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh), None)

    def tf_forward(
        self, encoder_out: torch.Tensor, captions: torch.Tensor, train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, None]:
        """(logits (B, L-1, V), None), the token half of the gates hoisted."""
        h, c = self.init_hidden_state(flatten_pixels(encoder_out))
        cell = self.decode_step
        emb_gates = F.linear(self.embedding(captions[:, :-1]), cell.weight_ih, cell.bias_ih + cell.bias_hh)
        hids = []
        for t in range(emb_gates.shape[1]):
            h, c = lstm_update(emb_gates[:, t] + F.linear(h, cell.weight_hh), c)
            hids.append(h)
        hids = dropout(torch.stack(hids, dim=1), self.cfg.dropout, generator, train)
        return self.fc(hids), None

    def rollout(
        self, encoder_out: torch.Tensor, start_id: int, end_id: int, max_decode_len: int, *,
        generator: Optional[torch.Generator] = None, teacher_tokens: Optional[torch.Tensor] = None,
        teacher_prob: float = 0.0, train: bool = False,
    ):
        """Greedy decode; the maps are None; ``train`` as ``_rollout``."""
        h0, c0 = self.init_hidden_state(flatten_pixels(encoder_out))
        return self._rollout(
            h0, c0, self.step, start_id, end_id, max_decode_len, generator, teacher_tokens, teacher_prob, train
        )
