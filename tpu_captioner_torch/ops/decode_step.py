"""Fused KV-cached Transformer decode step (counterpart of
``tpu_captioner/ops/decode_step.py``).

One call runs the whole L-layer decode body for one generated token over R
rows (R = batch, or batch x beams): per layer the packed QKV projection,
causal self-attention against the cache with the new k/v merged in, cross-
attention against precomputed memory K/V, the ReLU FFN, and three post-norm
LayerNorms (eps 1e-5).

Layouts (merged heads):
- x:               (R, E)
- cache k/v:       (L, R, T, E)   read-only here; ``apply_cache_update`` writes
- memory k/v:      (L, R, P, E)   from ``prepare_cross_memory``, once per image
- weights:         ``DecodeWeights`` — matrices (L, out, in) as nn.Linear
                   keeps them, vectors (L, D)

``fused_decode_step`` launches ``csrc/decode_step.cu`` for CUDA tensors (one
cooperative launch per layer over the whole card, in order, on the current
stream) and runs
``_decode_step_plain`` for CPU tensors.  Eval only: no dropout.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from tpu_captioner_torch.models.layers import attention_one_query, layer_norm, split_heads
from tpu_captioner_torch.ops import _build

LN_EPS = 1e-5


class DecodeWeights(NamedTuple):
    """Stacked decoder-layer weights in the kernel layout."""

    w_qkv: torch.Tensor  # (L, 3E, E)
    b_qkv: torch.Tensor  # (L, 3E)
    w_so: torch.Tensor  # (L, E, E) self-attn out
    b_so: torch.Tensor  # (L, E)
    w_cq: torch.Tensor  # (L, E, E) cross-attn query
    b_cq: torch.Tensor  # (L, E)
    w_co: torch.Tensor  # (L, E, E) cross-attn out
    b_co: torch.Tensor  # (L, E)
    w_f1: torch.Tensor  # (L, F, E)
    b_f1: torch.Tensor  # (L, F)
    w_f2: torch.Tensor  # (L, E, F)
    b_f2: torch.Tensor  # (L, E)
    ln1_s: torch.Tensor  # (L, E)
    ln1_b: torch.Tensor
    ln2_s: torch.Tensor
    ln2_b: torch.Tensor
    ln3_s: torch.Tensor
    ln3_b: torch.Tensor


@torch.no_grad()
def prepare_decode_weights(layers: Sequence[torch.nn.Module], embed_dim: int) -> DecodeWeights:
    """Stack the decoder layers' weights (``models.transformer.DecoderLayer``,
    reference parameter names) into the kernel layout.  Run once per decode
    call, outside the token loop."""
    e = embed_dim

    def st(fn):
        return torch.stack([fn(lyr) for lyr in layers]).contiguous()

    return DecodeWeights(
        w_qkv=st(lambda l: l.self_attn.in_proj_weight),
        b_qkv=st(lambda l: l.self_attn.in_proj_bias),
        w_so=st(lambda l: l.self_attn.out_proj.weight),
        b_so=st(lambda l: l.self_attn.out_proj.bias),
        w_cq=st(lambda l: l.multihead_attn.in_proj_weight[:e]),
        b_cq=st(lambda l: l.multihead_attn.in_proj_bias[:e]),
        w_co=st(lambda l: l.multihead_attn.out_proj.weight),
        b_co=st(lambda l: l.multihead_attn.out_proj.bias),
        w_f1=st(lambda l: l.linear1.weight),
        b_f1=st(lambda l: l.linear1.bias),
        w_f2=st(lambda l: l.linear2.weight),
        b_f2=st(lambda l: l.linear2.bias),
        ln1_s=st(lambda l: l.norm1.weight),
        ln1_b=st(lambda l: l.norm1.bias),
        ln2_s=st(lambda l: l.norm2.weight),
        ln2_b=st(lambda l: l.norm2.bias),
        ln3_s=st(lambda l: l.norm3.weight),
        ln3_b=st(lambda l: l.norm3.bias),
    )


@torch.no_grad()
def prepare_cross_memory(
    layers: Sequence[torch.nn.Module], mem: torch.Tensor, embed_dim: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Projected memory (R, P, E) -> merged-head cross K/V, each (L, R, P, E)."""
    e = embed_dim
    ks, vs = [], []
    for lyr in layers:
        w, b = lyr.multihead_attn.in_proj_weight, lyr.multihead_attn.in_proj_bias
        ks.append(F.linear(mem, w[e : 2 * e], b[e : 2 * e]))
        vs.append(F.linear(mem, w[2 * e :], b[2 * e :]))
    return torch.stack(ks).contiguous(), torch.stack(vs).contiguous()


def _decode_step_plain(
    w: DecodeWeights, x, pos: int, cache_k, cache_v, mem_k, mem_v, num_heads: int
):
    """Plain PyTorch version of the fused step; the kernel's definition.
    Reads cache positions < ``pos`` only and attends to the new k/v at
    ``pos`` without writing the cache."""
    L = cache_k.shape[0]
    alpha = x.new_zeros(x.shape[0], mem_k.shape[2])
    k_news, v_news = [], []
    for l in range(L):
        qkv = F.linear(x, w.w_qkv[l], w.b_qkv[l])
        q, k_new, v_new = qkv.chunk(3, dim=-1)
        keys = torch.cat([cache_k[l, :, :pos], k_new[:, None]], dim=1)  # (R, pos+1, E)
        vals = torch.cat([cache_v[l, :, :pos], v_new[:, None]], dim=1)
        ctx, _ = attention_one_query(
            split_heads(q[:, None], num_heads)[:, :, 0],
            split_heads(keys, num_heads), split_heads(vals, num_heads),
        )
        x = layer_norm(x + F.linear(ctx.flatten(1), w.w_so[l], w.b_so[l]), w.ln1_s[l], w.ln1_b[l], LN_EPS)
        q2 = F.linear(x, w.w_cq[l], w.b_cq[l])
        ctx2, probs2 = attention_one_query(
            split_heads(q2[:, None], num_heads)[:, :, 0],
            split_heads(mem_k[l], num_heads), split_heads(mem_v[l], num_heads),
        )
        alpha = alpha + probs2.mean(dim=1) / L
        x = layer_norm(x + F.linear(ctx2.flatten(1), w.w_co[l], w.b_co[l]), w.ln2_s[l], w.ln2_b[l], LN_EPS)
        h = torch.relu(F.linear(x, w.w_f1[l], w.b_f1[l]))
        x = layer_norm(x + F.linear(h, w.w_f2[l], w.b_f2[l]), w.ln3_s[l], w.ln3_b[l], LN_EPS)
        k_news.append(k_new)
        v_news.append(v_new)
    return x, alpha, torch.stack(k_news), torch.stack(v_news)


def _check(w: DecodeWeights, x, pos, cache_k, cache_v, mem_k, mem_v, num_heads):
    L, R, T, E = cache_k.shape
    P = mem_k.shape[2]
    Fd = w.w_f1.shape[1]
    shapes = {
        "x": (x, (R, E)), "cache_k": (cache_k, (L, R, T, E)), "cache_v": (cache_v, (L, R, T, E)),
        "mem_k": (mem_k, (L, R, P, E)), "mem_v": (mem_v, (L, R, P, E)),
        "w_qkv": (w.w_qkv, (L, 3 * E, E)), "b_qkv": (w.b_qkv, (L, 3 * E)),
        "w_f1": (w.w_f1, (L, Fd, E)), "b_f1": (w.b_f1, (L, Fd)), "w_f2": (w.w_f2, (L, E, Fd)),
    }
    for name in ("w_so", "w_cq", "w_co"):
        shapes[name] = (getattr(w, name), (L, E, E))
    for name in ("b_so", "b_cq", "b_co", "b_f2", "ln1_s", "ln1_b", "ln2_s", "ln2_b", "ln3_s", "ln3_b"):
        shapes[name] = (getattr(w, name), (L, E))
    for name, (t, shape) in shapes.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if E % num_heads or (E // num_heads) % 4 or Fd % 4:
        raise ValueError(f"kernel needs E/H and F divisible by 4 (E={E}, H={num_heads}, F={Fd})")
    if not 0 <= pos < T:
        raise ValueError(f"pos {pos} outside the cache length {T}")


def _lib():
    lib = _build.load("decode_step")
    lib.tc_decode_layer_forward.restype = ctypes.c_int
    lib.tc_decode_layer_forward.argtypes = [ctypes.c_void_p] * 28 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p
    ]
    lib.tc_decode_scratch_floats.restype = ctypes.c_longlong
    lib.tc_decode_scratch_floats.argtypes = [ctypes.c_int] * 5
    return lib


def fused_decode_step(
    w: DecodeWeights,
    x: torch.Tensor,  # (R, E) embedded token (+PE) at `pos`
    pos: int,
    cache_k: torch.Tensor,  # (L, R, T, E)
    cache_v: torch.Tensor,  # (L, R, T, E)
    mem_k: torch.Tensor,  # (L, R, P, E)
    mem_v: torch.Tensor,  # (L, R, P, E)
    num_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (x_out (R, E), alpha (R, P) — cross-attention probabilities
    averaged over heads and layers, k_new (L, R, E), v_new (L, R, E)).  The
    caches are read-only here; persist the new rows with
    ``apply_cache_update``.  CUDA tensors launch the kernel once per layer;
    CPU tensors take the plain version; any other device raises."""
    pos = int(pos)
    if x.device.type == "cpu":
        return _decode_step_plain(w, x, pos, cache_k, cache_v, mem_k, mem_v, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_decode_step runs on cpu or cuda tensors, got {x.device}")
    _check(w, x, pos, cache_k, cache_v, mem_k, mem_v, num_heads)
    L, R, T, E = cache_k.shape
    P = mem_k.shape[2]
    Fd = w.w_f1.shape[1]
    lib = _lib()
    x_out = torch.empty_like(x)
    alpha = torch.empty(R, P, device=x.device, dtype=torch.float32)
    k_new = torch.empty(L, R, E, device=x.device, dtype=torch.float32)
    v_new = torch.empty_like(k_new)
    scratch = torch.empty(
        lib.tc_decode_scratch_floats(R, E, num_heads, Fd, P), device=x.device, dtype=torch.float32
    )
    rest = [t.data_ptr() for t in (x_out, alpha, k_new, v_new, *w, cache_k, cache_v, mem_k, mem_v, scratch)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for layer in range(L):
            layer_in = x if layer == 0 else x_out  # the hidden state carries in x_out
            err = lib.tc_decode_layer_forward(
                layer_in.data_ptr(), *rest, layer, L, R, T, P, E, num_heads, Fd, pos, stream
            )
            _build.check(lib, err, "decode_step")
            fused_decode_step.launches += 1
    return x_out, alpha, k_new, v_new


fused_decode_step.launches = 0


def apply_cache_update(cache_k, cache_v, k_new, v_new, pos: int):
    """Write the step's per-layer K/V rows (L, R, E) at position ``pos`` of
    the (L, R, T, E) caches.  Updates the caches IN PLACE and returns them."""
    cache_k[:, :, pos] = k_new
    cache_v[:, :, pos] = v_new
    return cache_k, cache_v
