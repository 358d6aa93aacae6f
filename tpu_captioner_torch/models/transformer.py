"""Transformer caption decoder, eval pieces (counterpart of
``tpu_captioner/models/transformer.py``).

Post-norm layers with torch ``nn.TransformerDecoderLayer`` semantics: packed
QKV self-attention, cross-attention to the projected encoder memory, ReLU FFN,
LN eps 1e-5; sinusoidal PE added after the embedding.  Parameter names are the
reference's (``embedding``, ``transformer_decoder.layers.{i}.self_attn.*``,
``multihead_attn.*``, ``linear1/2``, ``norm1/2/3``, ``fc_out``,
``encoder_proj``), so a reference checkpoint's decoder state dict loads
directly.

Decoding keeps per-layer KV caches and projects the encoder memory to K/V once
per image.  ``decode_step`` here is the plain head-split version; the fused
kernel path is ``ops/decode_step.py``.

``tf_forward`` is the teacher-forced full-sequence pass of training, with
autograd through plain PyTorch ops (the JAX package runs it on XLA's
attention, without a Pallas kernel).  Its dropout sites, in the JAX order:
the embedding (before +PE); then, per layer, the self-attention
probabilities, the self-attention output, the cross-attention
probabilities, the cross-attention output, the FFN hidden layer and the FFN
output.

The greedy rollouts of eval come in three forms, as in the JAX package:
``rollout`` over the plain ``decode_step``, ``fused_rollout`` over
``ops/decode_step.py:fused_decode_step`` (one kernel launch per layer per
token, or one per token with ``one_cell``), and ``mega_rollout``, the whole
rollout as one ``fused_full_rollout`` launch.  All three stop once every row
has emitted ``<end>`` when no teacher tokens are mixed in, and return
(logits (B, T, V), sequences (B, T) int32, attention maps (B, T, P) or None),
with the steps of rows that finished earlier zeroed.  Scheduled sampling
draws its per-step masks with ``teacher_masks`` from a ``torch.Generator``;
the JAX package's threefry draws cannot be reproduced, only their
distribution.

``rollout(train=True)`` is the free-running rollout of training: the plain
decode step with dropout at every site of ``tf_forward``, drawn once per
token and site from the rollout's generator (``decode_step``'s ``drop``), with
autograd through the whole loop; it runs every step, as the JAX package's
``lax.scan`` does.  Its KV caches grow by concatenation, not in place, so
autograd keeps each step's keys.  The kernel rollouts stay deterministic.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_captioner_torch.core.config import ModelConfig
from tpu_captioner_torch.core.loops import scan_early_exit
from tpu_captioner_torch.models import torch_init
from tpu_captioner_torch.models.layers import (
    attention_core,
    attention_one_query,
    causal_mask,
    dropout,
    layer_norm,
    merge_heads,
    pool_layer_scope,
    split_heads,
)
from tpu_captioner_torch.ops import decode_step as decode_ops


def teacher_masks(
    generator: torch.Generator, steps: int, batch: int, prob: float, device
) -> torch.Tensor:
    """(steps, batch) bool: where scheduled sampling feeds the ground-truth
    token instead of the model's last prediction, each with ``prob``."""
    return (torch.rand(steps, batch, generator=generator, device=generator.device) < prob).to(device)


def teacher_schedule(teacher_tokens, teacher_prob, generator, steps, batch, device):
    """(teacher (steps, B) ids, use (steps, B) bool) for a rollout's
    scheduled sampling, or (None, None) when no teacher tokens are mixed in
    (as the JAX package, which needs its rng for them)."""
    if teacher_tokens is None or teacher_prob <= 0.0 or generator is None:
        return None, None
    use = teacher_masks(generator, steps, batch, teacher_prob, device)
    return teacher_tokens[:, :steps].to(device).long().T, use


def sinusoidal_pe(max_len: int, dim: int) -> torch.Tensor:
    """(max_len, dim) sinusoidal table (transformerDecoder.py:14-27)."""
    pos = torch.arange(max_len, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32) * (-math.log(10000.0) / dim))
    pe = torch.zeros(max_len, dim)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


class Memory(NamedTuple):
    mem: torch.Tensor  # (B, P, E) projected memory
    k: torch.Tensor  # (L, B, H, P, Dh) cross-attn keys
    v: torch.Tensor  # (L, B, H, P, Dh)


class Cache(NamedTuple):
    k: torch.Tensor  # (L, B, H, T, Dh) self-attn keys
    v: torch.Tensor  # (L, B, H, T, Dh)


class MultiheadAttention(nn.Module):
    """Parameters of ``nn.MultiheadAttention`` under its own names."""

    def __init__(self, embed_dim: int, device=None):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim, device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim, device=device))
        self.out_proj = nn.Linear(embed_dim, embed_dim, device=device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        torch_init.xavier_uniform(self.in_proj_weight, gen)
        self.in_proj_bias.zero_()
        torch_init.linear_default(self.out_proj, gen)
        self.out_proj.bias.zero_()


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        e, f = cfg.embed_dim, cfg.decoder_dim
        self.self_attn = MultiheadAttention(e, device)
        self.multihead_attn = MultiheadAttention(e, device)
        self.linear1 = nn.Linear(e, f, device=device)
        self.linear2 = nn.Linear(f, e, device=device)
        self.norm1 = nn.LayerNorm(e, eps=1e-5, device=device)
        self.norm2 = nn.LayerNorm(e, eps=1e-5, device=device)
        self.norm3 = nn.LayerNorm(e, eps=1e-5, device=device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        self.self_attn.reset_parameters(gen)
        self.multihead_attn.reset_parameters(gen)
        torch_init.linear_default(self.linear1, gen)
        torch_init.linear_default(self.linear2, gen)
        for norm in (self.norm1, self.norm2, self.norm3):
            norm.reset_parameters()


class _LayerStack(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(cfg, device) for _ in range(cfg.num_layers))


class TransformerDecoder(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        # transformer_attvis returns the cross-attention maps from tf_forward.
        self.capture_alphas = cfg.decoder == "transformer_attvis"
        e = cfg.embed_dim
        self.embedding = nn.Embedding(cfg.vocab_size, e, device=device)
        self.transformer_decoder = _LayerStack(cfg, device)
        self.fc_out = nn.Linear(e, cfg.vocab_size, device=device)
        if cfg.encoder_dim != e:
            self.encoder_proj = nn.Linear(cfg.encoder_dim, e, device=device)
        self.register_buffer("pe", sinusoidal_pe(cfg.max_len, e).to(device), persistent=False)

    @property
    def layers(self) -> nn.ModuleList:
        return self.transformer_decoder.layers

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """Seeded init with the JAX package's distributions: N(0, 1)
        embedding, default Linear heads, MHA xavier in-proj."""
        torch_init.normal(self.embedding.weight, gen)
        for lyr in self.layers:
            lyr.reset_parameters(gen)
        torch_init.linear_default(self.fc_out, gen)
        if hasattr(self, "encoder_proj"):
            torch_init.linear_default(self.encoder_proj, gen)

    # -- shared pieces ------------------------------------------------------
    def project_memory(self, encoder_out: torch.Tensor) -> torch.Tensor:
        """(B, 7, 7, C) or (B, P, C) -> (B, P, E)."""
        if encoder_out.dim() == 4:
            encoder_out = encoder_out.flatten(1, 2)
        if hasattr(self, "encoder_proj"):
            return self.encoder_proj(encoder_out)
        return encoder_out

    def _lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token embedding.  With pretrained embeddings the pad row is pinned
        to zero (padding_idx semantics, transformerDecoder.py:74)."""
        emb = self.embedding(tokens)
        if self.cfg.embedding_path is not None:
            emb = torch.where((tokens == 0)[..., None], torch.zeros((), device=emb.device), emb)
        return emb

    def embed(self, tokens: torch.Tensor, positions) -> torch.Tensor:
        """Token embedding + PE (eval: no dropout)."""
        return self._lookup(tokens) + self.pe[positions]

    # -- teacher forcing ----------------------------------------------------
    def _mha_full(self, m: MultiheadAttention, q_in, kv_in, mask, train, generator):
        """Full-sequence multi-head attention.  Returns (output (B, Tq, E),
        per-head probabilities before dropout (B, H, Tq, Tk))."""
        e, h = self.cfg.embed_dim, self.cfg.num_heads
        w, b = m.in_proj_weight, m.in_proj_bias
        q = split_heads(F.linear(q_in, w[:e], b[:e]), h)
        k = split_heads(F.linear(kv_in, w[e : 2 * e], b[e : 2 * e]), h)
        v = split_heads(F.linear(kv_in, w[2 * e :], b[2 * e :]), h)
        ctx, probs = attention_core(q, k, v, mask, self.cfg.dropout, generator, train)
        return m.out_proj(merge_heads(ctx)), probs

    def tf_forward(
        self,
        encoder_out: torch.Tensor,  # (B, 7, 7, C) or (B, P, C)
        captions: torch.Tensor,  # (B, T) token ids
        key_padding_mask: Optional[torch.Tensor] = None,  # (B, T) True where pad
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Full-sequence pass (transformerDecoder.py:88-108).  Returns
        (logits (B, T, V), cross-attention maps averaged over layers and
        heads (B, T, P) when ``capture_alphas``, else None)."""
        c = self.cfg
        p = c.dropout
        mem = self.project_memory(encoder_out)
        t = captions.shape[1]
        x = dropout(self._lookup(captions), p, generator, train) + self.pe[:t]
        mask = causal_mask(t, captions.device)
        if key_padding_mask is not None:
            mask = mask & (~key_padding_mask)[:, None, None, :]
        alphas = []
        for i, lyr in enumerate(self.layers):
            with pool_layer_scope(i, c.num_layers):
                sa, _ = self._mha_full(lyr.self_attn, x, x, mask, train, generator)
                x = layer_norm(x + dropout(sa, p, generator, train), lyr.norm1.weight, lyr.norm1.bias)
                ca, ca_probs = self._mha_full(lyr.multihead_attn, x, mem, None, train, generator)
                x = layer_norm(x + dropout(ca, p, generator, train), lyr.norm2.weight, lyr.norm2.bias)
                hid = dropout(torch.relu(lyr.linear1(x)), p, generator, train)
                ff = dropout(lyr.linear2(hid), p, generator, train)
                x = layer_norm(x + ff, lyr.norm3.weight, lyr.norm3.bias)
            if self.capture_alphas:
                alphas.append(ca_probs.mean(dim=1))
        logits = self.fc_out(x)
        return logits, torch.stack(alphas).mean(dim=0) if self.capture_alphas else None

    # -- incremental decode -------------------------------------------------
    def precompute_memory(self, encoder_out: torch.Tensor) -> Memory:
        """Project the memory to per-layer cross K/V once per image."""
        e, h = self.cfg.embed_dim, self.cfg.num_heads
        mem = self.project_memory(encoder_out)
        ks, vs = [], []
        for lyr in self.layers:
            w, b = lyr.multihead_attn.in_proj_weight, lyr.multihead_attn.in_proj_bias
            ks.append(split_heads(F.linear(mem, w[e : 2 * e], b[e : 2 * e]), h))
            vs.append(split_heads(F.linear(mem, w[2 * e :], b[2 * e :]), h))
        return Memory(mem, torch.stack(ks), torch.stack(vs))

    def init_cache(self, batch: int, max_len: int) -> Cache:
        c = self.cfg
        shape = (c.num_layers, batch, c.num_heads, max_len, c.embed_dim // c.num_heads)
        dev = self.fc_out.weight.device
        return Cache(torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))

    def decode_step(
        self, tokens: torch.Tensor, pos: int, cache, memory: Memory,
        drop: Optional[Callable[[torch.Tensor, Tuple[int, ...]], torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
        """One KV-cached decode step (plain PyTorch).  ``tokens`` (B,) is the
        token at position ``pos``.  A ``Cache`` gets this step's k/v written
        IN PLACE; a list of per-layer (B, H, pos, Dh) (keys, values), as a
        training rollout keeps, is returned grown by this step's rows, out of
        place, so autograd keeps each step's keys.  The step attends over
        positions <= pos.  ``drop(v, site)`` is training's dropout at the
        sites of ``tf_forward``, each named by the token and its fold-in ids
        (tpu_captioner/models/transformer.py:146-178, 354-395): the
        embedding 100; in layer i, (200, i) then the self-attention
        probabilities 1 and output 2, the cross-attention probabilities 3 and
        output 4, the FFN hidden layer (5, 0) and output 6.  Returns (logits
        (B, V), cache, cross-attention alpha (B, P) averaged over layers and
        heads)."""
        c = self.cfg
        e, h = c.embed_dim, c.num_heads

        def d(v, *site):
            return v if drop is None else drop(v, (pos, *site))

        x = self.embed(tokens, pos) if drop is None else d(self._lookup(tokens), 100) + self.pe[pos]  # (B, E)
        alphas, grown = [], []
        for i, lyr in enumerate(self.layers):
            sa = lyr.self_attn
            q, k_new, v_new = F.linear(x, sa.in_proj_weight, sa.in_proj_bias).chunk(3, dim=-1)
            k_new, v_new = split_heads(k_new[:, None], h), split_heads(v_new[:, None], h)
            if isinstance(cache, Cache):
                cache.k[i, :, :, pos] = k_new[:, :, 0]
                cache.v[i, :, :, pos] = v_new[:, :, 0]
                k_all, v_all = cache.k[i, :, :, : pos + 1], cache.v[i, :, :, : pos + 1]
            else:
                k_all, v_all = torch.cat([cache[i][0], k_new], dim=2), torch.cat([cache[i][1], v_new], dim=2)
                grown.append((k_all, v_all))
            ctx, _ = attention_one_query(
                split_heads(q[:, None], h)[:, :, 0], k_all, v_all, lambda pr: d(pr, 200, i, 1)
            )
            x = layer_norm(x + d(sa.out_proj(ctx.flatten(1)), 200, i, 2), lyr.norm1.weight, lyr.norm1.bias)
            ca = lyr.multihead_attn
            q2 = F.linear(x, ca.in_proj_weight[:e], ca.in_proj_bias[:e])
            ctx2, probs2 = attention_one_query(
                split_heads(q2[:, None], h)[:, :, 0], memory.k[i], memory.v[i], lambda pr: d(pr, 200, i, 3)
            )
            x = layer_norm(x + d(ca.out_proj(ctx2.flatten(1)), 200, i, 4), lyr.norm2.weight, lyr.norm2.bias)
            hid = d(torch.relu(lyr.linear1(x)), 200, i, 5, 0)
            x = layer_norm(x + d(lyr.linear2(hid), 200, i, 6), lyr.norm3.weight, lyr.norm3.bias)
            alphas.append(probs2.mean(dim=1))
        logits = self.fc_out(x)
        return logits, cache if isinstance(cache, Cache) else grown, torch.stack(alphas).mean(dim=0)

    # -- greedy rollouts ----------------------------------------------------
    def _greedy_loop(self, step_fn, tok0, end_id, steps, teacher, use, early_exit):
        """The rollout body shared by ``rollout`` and ``fused_rollout``:
        ``step_fn(tok, t) -> (logits (B, V), alpha (B, P))`` for the input
        token at step t; greedy feedback and finished-row masking around it."""
        fin0 = torch.zeros_like(tok0, dtype=torch.bool)

        def body(carry, t):
            tok, finished = carry
            if teacher is not None:
                tok = torch.where(use[t], teacher[t], tok)
            logits_t, alpha = step_fn(tok, t)
            pred = logits_t.argmax(dim=-1)
            act = ~finished
            out = (
                torch.where(act[:, None], logits_t, 0.0),
                torch.where(act, pred, 0).to(torch.int32),
                torch.where(act[:, None], alpha, 0.0),
            )
            return (torch.where(act, pred, tok), finished | (act & (pred == end_id))), out

        done = (lambda c: c[1].all()) if early_exit else (lambda c: False)
        _, (logits, seqs, alphas) = scan_early_exit(body, (tok0, fin0), range(steps), done)
        return logits.transpose(0, 1), seqs.transpose(0, 1), alphas.transpose(0, 1)

    def rollout(
        self,
        encoder_out: torch.Tensor,
        start_id: int,
        end_id: int,
        max_decode_len: int,
        *,
        generator: Optional[torch.Generator] = None,
        teacher_tokens: Optional[torch.Tensor] = None,
        teacher_prob: float = 0.0,
        train: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """Greedy KV-cached generation over the plain ``decode_step``
        (transformerDecoder.py:110-160).  ``teacher_tokens`` (B, >= T) with
        ``teacher_prob`` and a ``generator`` mix ground-truth input tokens in
        (scheduled sampling); without teacher tokens the loop stops once every
        row has emitted ``end_id``.  ``train`` grows the caches out of place,
        drops out from ``generator`` and runs every step."""
        memory = self.precompute_memory(encoder_out)
        B = memory.mem.shape[0]
        dev = memory.mem.device
        teacher, use = teacher_schedule(teacher_tokens, teacher_prob, generator, max_decode_len, B, dev)
        if train:
            if generator is None:
                raise ValueError("a training rollout needs a generator for its dropout")
            empty = memory.k.new_zeros(B, self.cfg.num_heads, 0, self.cfg.embed_dim // self.cfg.num_heads)
            cache = [(empty, empty)] * len(self.layers)

            def drop(v, site):
                return dropout(v, self.cfg.dropout, generator, True, site=site)
        else:
            cache, drop = self.init_cache(B, max_decode_len + 1), None

        def step_fn(tok, t):
            nonlocal cache
            logits_t, cache, alpha = self.decode_step(tok, t, cache, memory, drop)
            return logits_t, alpha

        tok0 = torch.full((B,), start_id, dtype=torch.long, device=dev)
        logits, seqs, alphas = self._greedy_loop(
            step_fn, tok0, end_id, max_decode_len, teacher, use, teacher_tokens is None and not train
        )
        return logits, seqs, alphas if self.capture_alphas else None

    def fused_rollout(
        self,
        encoder_out: torch.Tensor,
        start_id: int,
        end_id: int,
        max_decode_len: int,
        *,
        generator: Optional[torch.Generator] = None,
        teacher_tokens: Optional[torch.Tensor] = None,
        teacher_prob: float = 0.0,
        one_cell: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """``rollout`` with the decode body of each token in
        ``fused_decode_step`` (L kernel launches per token, or one with
        ``one_cell``), the cache rows persisted by ``apply_cache_update``,
        then the vocab head and argmax in PyTorch."""
        c = self.cfg
        E = c.embed_dim
        mem = self.project_memory(encoder_out)
        B = mem.shape[0]
        dev = mem.device
        w = decode_ops.prepare_decode_weights(self.layers, E)
        mem_k, mem_v = decode_ops.prepare_cross_memory(self.layers, mem, E)
        ck = torch.zeros(c.num_layers, B, max_decode_len + 1, E, device=dev)
        cv = torch.zeros_like(ck)
        teacher, use = teacher_schedule(teacher_tokens, teacher_prob, generator, max_decode_len, B, dev)

        def step_fn(tok, t):
            x = self.embed(tok, t)
            x_out, alpha, k_new, v_new = decode_ops.fused_decode_step(
                w, x.contiguous(), t, ck, cv, mem_k, mem_v, c.num_heads, one_cell=one_cell
            )
            decode_ops.apply_cache_update(ck, cv, k_new, v_new, t)
            return self.fc_out(x_out), alpha

        tok0 = torch.full((B,), start_id, dtype=torch.long, device=dev)
        logits, seqs, alphas = self._greedy_loop(
            step_fn, tok0, end_id, max_decode_len, teacher, use, teacher_tokens is None
        )
        return logits, seqs, alphas if self.capture_alphas else None

    def mega_rollout(
        self,
        encoder_out: torch.Tensor,
        start_id: int,
        end_id: int,
        max_decode_len: int,
        *,
        generator: Optional[torch.Generator] = None,
        teacher_tokens: Optional[torch.Tensor] = None,
        teacher_prob: float = 0.0,
    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """``rollout`` as one ``fused_full_rollout`` call: the embedding
        lookup, every decode step, the vocab head, the argmax and the token
        feedback in one kernel launch for CUDA tensors."""
        c = self.cfg
        E = c.embed_dim
        mem = self.project_memory(encoder_out)
        B = mem.shape[0]
        w = decode_ops.prepare_decode_weights(self.layers, E)
        mem_k, mem_v = decode_ops.prepare_cross_memory(self.layers, mem, E)
        emb = self.embedding.weight
        if c.embedding_path is not None:
            # padding_idx semantics (transformerDecoder.py:74): the kernel
            # gathers table rows verbatim, so pin the pad row here.
            emb = emb.clone()
            emb[0] = 0.0
        teacher, use = teacher_schedule(teacher_tokens, teacher_prob, generator, max_decode_len, B, mem.device)
        logits, seqs, alphas = decode_ops.fused_full_rollout(
            w, emb.contiguous(), self.fc_out.weight, self.fc_out.bias, self.pe, mem_k, mem_v,
            start_id, end_id, max_decode_len, c.num_heads, teacher=teacher, use_teacher=use,
        )
        return logits, seqs, alphas if self.capture_alphas else None
