"""Fused KV-cached Transformer decode (counterpart of
``tpu_captioner/ops/decode_step.py``).

``fused_decode_step`` runs the whole L-layer decode body for one generated
token over R rows (R = batch, or batch x beams): per layer the packed QKV
projection, causal self-attention against the cache with the new k/v merged
in, cross-attention against precomputed memory K/V, the ReLU FFN, and three
post-norm LayerNorms (eps 1e-5).  ``fused_full_rollout`` runs a whole greedy
rollout: per token the embedding lookup plus PE, that body, the vocab head,
the argmax and the token feedback.

Layouts (merged heads):
- x:               (R, E)
- cache k/v:       (L, R, T, E)   read-only here; ``apply_cache_update`` writes
- memory k/v:      (L, R, P, E)   from ``prepare_cross_memory``, once per image
- weights:         ``DecodeWeights`` — matrices (L, out, in) as nn.Linear
                   keeps them, vectors (L, D)

Both launch ``csrc/decode_step.cu`` for CUDA tensors, cooperative launches
over the whole card on the current stream: ``fused_decode_step`` one per
layer, or one per token with ``one_cell=True`` (the TPU's ``_kernel_onecell``);
``fused_full_rollout`` one per rollout (the TPU's ``_mega_kernel``).  For CPU
tensors they run their plain versions, ``_decode_step_plain`` and
``_full_rollout_plain``.  Eval only: no dropout.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from tpu_captioner_torch.models.layers import attention_one_query, layer_norm, split_heads
from tpu_captioner_torch.ops import _build

LN_EPS = 1e-5
MAX_E = 1024  # csrc/decode_step.cu: 32 lanes x kLnPerLane LayerNorm values


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


def _check_tensors(device, shapes) -> None:
    """Each ``name: (tensor, shape)`` on ``device``, of its dtype and shape,
    contiguous and 16-byte aligned: what the kernels read."""
    for name, (t, shape, dtype) in shapes.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _weight_shapes(w: DecodeWeights, L: int, E: int, num_heads: int):
    Fd = w.w_f1.shape[1]
    f32 = torch.float32
    shapes = {
        "w_qkv": (w.w_qkv, (L, 3 * E, E), f32), "b_qkv": (w.b_qkv, (L, 3 * E), f32),
        "w_f1": (w.w_f1, (L, Fd, E), f32), "b_f1": (w.b_f1, (L, Fd), f32),
        "w_f2": (w.w_f2, (L, E, Fd), f32),
    }
    for name in ("w_so", "w_cq", "w_co"):
        shapes[name] = (getattr(w, name), (L, E, E), f32)
    for name in ("b_so", "b_cq", "b_co", "b_f2", "ln1_s", "ln1_b", "ln2_s", "ln2_b", "ln3_s", "ln3_b"):
        shapes[name] = (getattr(w, name), (L, E), f32)
    # Any head width: the kernels load keys as float4 when E/H % 4 == 0 and
    # as scalars otherwise.  What stays: whole heads, float4 rows in the
    # products (E and F % 4) and a LayerNorm row in one warp (E <= 1024).
    if num_heads < 1 or E % num_heads:
        raise ValueError(f"kernel needs E divisible by the heads (E={E}, H={num_heads})")
    if E % 4 or Fd % 4:
        raise ValueError(f"kernel needs E and F divisible by 4 for its float4 rows (E={E}, F={Fd})")
    if E > MAX_E:
        raise ValueError(f"kernel holds a LayerNorm row in one warp: E <= {MAX_E}, got {E}")
    return shapes


def _check(w: DecodeWeights, x, pos, cache_k, cache_v, mem_k, mem_v, num_heads):
    L, R, T, E = cache_k.shape
    P = mem_k.shape[2]
    f32 = torch.float32
    shapes = _weight_shapes(w, L, E, num_heads)
    shapes.update({
        "x": (x, (R, E), f32), "cache_k": (cache_k, (L, R, T, E), f32),
        "cache_v": (cache_v, (L, R, T, E), f32),
        "mem_k": (mem_k, (L, R, P, E), f32), "mem_v": (mem_v, (L, R, P, E), f32),
    })
    _check_tensors(x.device, shapes)
    if not 0 <= pos < T:
        raise ValueError(f"pos {pos} outside the cache length {T}")


def _lib():
    lib = _build.load("decode_step")
    lib.tc_decode_layer_forward.restype = ctypes.c_int
    lib.tc_decode_layer_forward.argtypes = [ctypes.c_void_p] * 28 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p
    ]
    lib.tc_decode_onecell_forward.restype = ctypes.c_int
    lib.tc_decode_onecell_forward.argtypes = [ctypes.c_void_p] * 28 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p
    ]
    lib.tc_decode_rollout.restype = ctypes.c_int
    lib.tc_decode_rollout.argtypes = [ctypes.c_void_p] * 33 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.tc_decode_scratch_floats.restype = ctypes.c_longlong
    lib.tc_decode_scratch_floats.argtypes = [ctypes.c_int] * 5
    lib.tc_rollout_scratch_floats.restype = ctypes.c_longlong
    lib.tc_rollout_scratch_floats.argtypes = [ctypes.c_int] * 6
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
    *,
    one_cell: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (x_out (R, E), alpha (R, P) — cross-attention probabilities
    averaged over heads and layers, k_new (L, R, E), v_new (L, R, E)).  The
    caches are read-only here; persist the new rows with
    ``apply_cache_update``.  CUDA tensors launch the kernel once per layer,
    or once for all layers with ``one_cell``; CPU tensors take the plain
    version (the same function either way); any other device raises.
    Forward only: raises on every device when autograd would need its
    gradient."""
    _build.refuse_autograd(
        "fused_decode_step", (*w, x, cache_k, cache_v, mem_k, mem_v),
        "not planned (decoding runs under torch.inference_mode)",
    )
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
        if one_cell:
            err = lib.tc_decode_onecell_forward(
                x.data_ptr(), *rest, L, R, T, P, E, num_heads, Fd, pos, stream
            )
            _build.check(lib, err, "decode_onecell")
            fused_decode_step.onecell_launches += 1
            return x_out, alpha, k_new, v_new
        for layer in range(L):
            layer_in = x if layer == 0 else x_out  # the hidden state carries in x_out
            err = lib.tc_decode_layer_forward(
                layer_in.data_ptr(), *rest, layer, L, R, T, P, E, num_heads, Fd, pos, stream
            )
            _build.check(lib, err, "decode_step")
            fused_decode_step.launches += 1
    return x_out, alpha, k_new, v_new


fused_decode_step.launches = 0  # per-layer kernel launches
fused_decode_step.onecell_launches = 0  # one-cell kernel launches


def apply_cache_update(cache_k, cache_v, k_new, v_new, pos: int):
    """Write the step's per-layer K/V rows (L, R, E) at position ``pos`` of
    the (L, R, T, E) caches.  Updates the caches IN PLACE and returns them."""
    cache_k[:, :, pos] = k_new
    cache_v[:, :, pos] = v_new
    return cache_k, cache_v


def _full_rollout_plain(
    w: DecodeWeights, embedding, fc_w, fc_b, pe, mem_k, mem_v, start_id: int, end_id: int,
    steps: int, num_heads: int, *, teacher=None, use_teacher=None,
):
    """Plain PyTorch version of the rollout kernel; its definition.  Per step
    s: the input token (the teacher's where ``use_teacher[s]``), its
    embedding row plus ``pe[s]``, ``_decode_step_plain`` with the cache
    written at s, logits ``x fc_w^T + fc_b``, the first argmax; rows that
    finished earlier emit zeros and keep their input token.  Stops once
    every row has finished (the steps left would only emit zeros)."""
    L, R, P, E = mem_k.shape
    V = fc_w.shape[0]
    dev = mem_k.device
    cache_k = mem_k.new_zeros(L, R, steps, E)
    cache_v = torch.zeros_like(cache_k)
    tok = torch.full((R,), start_id, dtype=torch.long, device=dev)
    fin = torch.zeros(R, dtype=torch.bool, device=dev)
    logits = mem_k.new_zeros(R, steps, V)
    seqs = torch.zeros(R, steps, dtype=torch.int32, device=dev)
    alphas = mem_k.new_zeros(R, steps, P)
    for s in range(steps):
        if bool(fin.all()):
            break
        if use_teacher is not None:
            tok = torch.where(use_teacher[s].bool(), teacher[s].long(), tok)
        x = embedding[tok] + pe[s]
        x, alpha, k_new, v_new = _decode_step_plain(w, x, s, cache_k, cache_v, mem_k, mem_v, num_heads)
        apply_cache_update(cache_k, cache_v, k_new, v_new, s)
        logits_s = F.linear(x, fc_w, fc_b)
        pred = logits_s.argmax(dim=-1)
        act = ~fin
        logits[:, s] = torch.where(act[:, None], logits_s, 0.0)
        seqs[:, s] = torch.where(act, pred, 0).to(torch.int32)
        alphas[:, s] = torch.where(act[:, None], alpha, 0.0)
        tok = torch.where(act, pred, tok)
        fin = fin | (act & (pred == end_id))
    return logits, seqs, alphas


def fused_full_rollout(
    w: DecodeWeights,
    embedding: torch.Tensor,  # (V, E), the pad row already zeroed where the model pins it
    fc_w: torch.Tensor,  # (V, E), nn.Linear layout
    fc_b: torch.Tensor,  # (V,)
    pe: torch.Tensor,  # (>= steps, E) positional table
    mem_k: torch.Tensor,  # (L, R, P, E)
    mem_v: torch.Tensor,  # (L, R, P, E)
    start_id: int,
    end_id: int,
    steps: int,
    num_heads: int,
    *,
    teacher: torch.Tensor = None,  # (steps, R) token ids
    use_teacher: torch.Tensor = None,  # (steps, R) bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A whole greedy rollout of ``steps`` tokens from ``start_id``: returns
    (logits (R, steps, V), seqs (R, steps) int32, alphas (R, steps, P)), with
    the steps of rows that emitted ``end_id`` earlier zeroed.  ``teacher``
    and ``use_teacher`` mix ground-truth input tokens in (scheduled
    sampling).  CUDA tensors launch the kernel once, which also stops once
    every row has finished and leaves the tokens it ran in
    ``fused_full_rollout.steps_run`` (a 0-d tensor on the card); CPU tensors
    take the plain version; any other device raises.  Forward only."""
    _build.refuse_autograd(
        "fused_full_rollout", (*w, embedding, fc_w, fc_b, pe, mem_k, mem_v),
        "not planned (decoding runs under torch.inference_mode)",
    )
    if (teacher is None) != (use_teacher is None):
        raise ValueError("teacher and use_teacher go together")
    steps = int(steps)
    if mem_k.device.type == "cpu":
        return _full_rollout_plain(
            w, embedding, fc_w, fc_b, pe, mem_k, mem_v, start_id, end_id, steps, num_heads,
            teacher=teacher, use_teacher=use_teacher,
        )
    if mem_k.device.type != "cuda":
        raise ValueError(f"fused_full_rollout runs on cpu or cuda tensors, got {mem_k.device}")
    L, R, P, E = mem_k.shape
    V = fc_w.shape[0]
    Fd = w.w_f1.shape[1]
    dev = mem_k.device
    if steps < 1 or pe.shape[0] < steps:
        raise ValueError(f"steps must be in [1, {pe.shape[0]}] (the PE table's length), got {steps}")
    pe = pe[:steps].contiguous()
    if teacher is not None:
        teacher = teacher.to(dev, torch.int32).contiguous()
        use_teacher = use_teacher.to(dev, torch.int32).contiguous()
    f32 = torch.float32
    shapes = _weight_shapes(w, L, E, num_heads)
    shapes.update({
        "embedding": (embedding, (V, E), f32), "fc_w": (fc_w, (V, E), f32), "fc_b": (fc_b, (V,), f32),
        "pe": (pe, (steps, E), f32),
        "mem_k": (mem_k, (L, R, P, E), f32), "mem_v": (mem_v, (L, R, P, E), f32),
    })
    if teacher is not None:
        shapes["teacher"] = (teacher, (steps, R), torch.int32)
        shapes["use_teacher"] = (use_teacher, (steps, R), torch.int32)
    _check_tensors(dev, shapes)
    lib = _lib()
    logits = torch.zeros(R, steps, V, device=dev, dtype=f32)
    seqs = torch.zeros(R, steps, device=dev, dtype=torch.int32)
    alphas = torch.zeros(R, steps, P, device=dev, dtype=f32)
    cache_k = torch.empty(L, R, steps, E, device=dev, dtype=f32)  # slot s is written before it is read
    cache_v = torch.empty_like(cache_k)
    state = torch.zeros(2 * R + 1, device=dev, dtype=torch.int32)  # tok, fin, tokens run
    state[:R] = start_id
    scratch = torch.empty(
        lib.tc_rollout_scratch_floats(R, E, num_heads, Fd, P, V), device=dev, dtype=f32
    )
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        err = lib.tc_decode_rollout(
            embedding.data_ptr(), fc_w.data_ptr(), fc_b.data_ptr(), pe.data_ptr(),
            ptr(teacher), ptr(use_teacher), logits.data_ptr(), seqs.data_ptr(), alphas.data_ptr(),
            *(t.data_ptr() for t in w), mem_k.data_ptr(), mem_v.data_ptr(),
            cache_k.data_ptr(), cache_v.data_ptr(), state.data_ptr(), scratch.data_ptr(),
            L, R, P, E, num_heads, Fd, V, steps, int(end_id),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, err, "decode_rollout")
    fused_full_rollout.launches += 1
    fused_full_rollout.steps_run = state[2 * R]
    return logits, seqs, alphas


fused_full_rollout.launches = 0
fused_full_rollout.steps_run = None
