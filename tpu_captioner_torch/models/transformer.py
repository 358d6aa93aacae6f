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
kernel path is ``ops/decode_step.py``.  Teacher forcing and the rollouts are
not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_captioner_torch.core.config import ModelConfig
from tpu_captioner_torch.models import torch_init
from tpu_captioner_torch.models.layers import attention_one_query, layer_norm, split_heads


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

    def embed(self, tokens: torch.Tensor, positions) -> torch.Tensor:
        """Token embedding + PE (eval: no dropout).  With pretrained
        embeddings the pad row is pinned to zero (padding_idx semantics,
        transformerDecoder.py:74)."""
        emb = self.embedding(tokens)
        if self.cfg.embedding_path is not None:
            emb = torch.where((tokens == 0)[..., None], torch.zeros((), device=emb.device), emb)
        return emb + self.pe[positions]

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
        self, tokens: torch.Tensor, pos: int, cache: Cache, memory: Memory
    ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
        """One KV-cached decode step (plain PyTorch).  ``tokens`` (B,) is the
        token at position ``pos``.  Writes this step's k/v into ``cache`` IN
        PLACE, then attends over positions <= pos.  Returns (logits (B, V),
        cache, cross-attention alpha (B, P) averaged over layers and heads)."""
        c = self.cfg
        e, h = c.embed_dim, c.num_heads
        x = self.embed(tokens, pos)  # (B, E)
        alphas = []
        for i, lyr in enumerate(self.layers):
            sa = lyr.self_attn
            q, k_new, v_new = F.linear(x, sa.in_proj_weight, sa.in_proj_bias).chunk(3, dim=-1)
            cache.k[i, :, :, pos] = split_heads(k_new[:, None], h)[:, :, 0]
            cache.v[i, :, :, pos] = split_heads(v_new[:, None], h)[:, :, 0]
            ctx, _ = attention_one_query(
                split_heads(q[:, None], h)[:, :, 0],
                cache.k[i, :, :, : pos + 1], cache.v[i, :, :, : pos + 1],
            )
            x = layer_norm(x + sa.out_proj(ctx.flatten(1)), lyr.norm1.weight, lyr.norm1.bias)
            ca = lyr.multihead_attn
            q2 = F.linear(x, ca.in_proj_weight[:e], ca.in_proj_bias[:e])
            ctx2, probs2 = attention_one_query(
                split_heads(q2[:, None], h)[:, :, 0], memory.k[i], memory.v[i]
            )
            x = layer_norm(x + ca.out_proj(ctx2.flatten(1)), lyr.norm2.weight, lyr.norm2.bias)
            ff = lyr.linear2(torch.relu(lyr.linear1(x)))
            x = layer_norm(x + ff, lyr.norm3.weight, lyr.norm3.bias)
            alphas.append(probs2.mean(dim=1))
        logits = self.fc_out(x)
        return logits, cache, torch.stack(alphas).mean(dim=0)
