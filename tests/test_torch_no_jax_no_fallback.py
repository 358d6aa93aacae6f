"""The port stands alone and never falls back.

- Importing every ``tpu_captioner_torch`` module (and ``chip_smoke``) in a
  fresh interpreter pulls in no JAX.
- On a host without CUDA, every request for the card raises: the kernel
  build, the kernel wrappers given a non-CPU tensor, a model asked for
  ``cuda``, and ``chip_smoke.main()``.
- The MLP-tail wrapper carries a gradient (its backward is a kernel too);
  the decode wrappers (the step, per layer or one-cell, and the whole
  rollout) are forward only and raise, on every device, when autograd would
  need a gradient through them.
- ``decode_kernel='mega'`` always reaches the whole-rollout kernel: it never
  resolves to the per-token one.
- The train step's branch that is not ported raises, naming its ROADMAP
  item; the fine-tune branch builds a step.
- The depthwise conv's wrappers refuse what their kernels do not take (other
  devices, bf16, non-contiguous tensors, tensors on two devices).
"""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import tpu_captioner_torch
        names = [m.name for m in pkgutil.walk_packages(
            tpu_captioner_torch.__path__, "tpu_captioner_torch.")]
        for name in names + ["chip_smoke"]:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "tpu_captioner"))
        assert not bad, bad
        assert len(names) >= 20, names
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr


@pytest.fixture
def cpu_only():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only host")


def test_cuda_requests_raise_without_a_card(cpu_only):
    from tpu_captioner_torch.core.config import ModelConfig
    from tpu_captioner_torch.ops import _build
    from tpu_captioner_torch.ops.decode_step import DecodeWeights, fused_decode_step
    from tpu_captioner_torch.ops.mlp_block import fused_convnext_mlp
    from tpu_captioner_torch.train.model import CaptionModel

    with pytest.raises(RuntimeError):
        CaptionModel(ModelConfig(vocab_size=11), device="cuda")
    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        nvcc = None
    if nvcc is None:  # a build that cannot run raises, it is not skipped
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load("mlp_block")
    meta = lambda *s: torch.empty(*s, device="meta")  # noqa: E731 — neither cpu nor cuda
    with pytest.raises(ValueError):
        fused_convnext_mlp(meta(4, 128), meta(4, 128), meta(4), *(meta(128),) * 2,
                           meta(512, 128), meta(512), meta(128, 512), meta(128), meta(128))
    w = DecodeWeights(*(meta(1, 1) for _ in DecodeWeights._fields))
    with pytest.raises(ValueError):
        fused_decode_step(w, meta(2, 8), 0, *(meta(1, 2, 4, 8),) * 2, *(meta(1, 2, 4, 8),) * 2, 2)


def test_chip_smoke_raises_without_a_card(cpu_only, capsys):
    sys.path.insert(0, ROOT)
    import chip_smoke

    with pytest.raises(RuntimeError, match="no CUDA device"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_bf16_and_lstm_are_refused():
    from tpu_captioner_torch.core.config import ModelConfig
    from tpu_captioner_torch.train.model import CaptionModel

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CaptionModel(ModelConfig(vocab_size=11, compute_dtype="bfloat16"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CaptionModel(ModelConfig(vocab_size=11, decoder="lstm"), device="cpu")


def test_mask_pool_refuses_other_devices():
    from tpu_captioner_torch.ops.dropout_mask import random_mask_pool

    with pytest.raises(ValueError, match="cpu or cuda"):
        random_mask_pool((1, 2), 16, 0.5, torch.empty(1, device="meta").device)


def test_kernel_wrappers_refuse_to_drop_gradients():
    from tpu_captioner_torch.ops.decode_step import DecodeWeights, fused_decode_step
    from tpu_captioner_torch.ops.mlp_block import fused_convnext_mlp

    c = 128
    mlp = [torch.ones(s) for s in ((4, c), (4, c), (4,), (c,), (c,), (4 * c, c), (4 * c,), (c, 4 * c), (c,), (c,))]
    mlp[5].requires_grad_(True)
    out = fused_convnext_mlp(*mlp)
    assert out.grad_fn is not None
    (grad_w1,) = torch.autograd.grad(out.sum(), mlp[5])
    assert grad_w1.shape == (4 * c, c) and grad_w1.abs().sum() > 0
    with torch.no_grad():
        assert fused_convnext_mlp(*mlp).shape == (4, c)
    w = DecodeWeights(*(torch.zeros(1, 1, requires_grad=True) for _ in DecodeWeights._fields))
    with pytest.raises(RuntimeError, match="forward only"):
        fused_decode_step(w, torch.zeros(2, 8), 0, *(torch.zeros(1, 2, 4, 8),) * 4, 2)


def test_unported_train_branches_raise():
    from tpu_captioner_torch.core.config import ModelConfig, TrainConfig
    from tpu_captioner_torch.train.model import CaptionModel
    from tpu_captioner_torch.train.steps import make_train_step

    model = CaptionModel(
        ModelConfig(vocab_size=11, encoder_depths=(1, 1, 1, 1), encoder_dims=(8, 8, 8, 8),
                    encoder_dim=8, embed_dim=8, num_heads=2, decoder_dim=8, num_layers=1),
        device="cpu",
    )
    assert callable(make_train_step(model, TrainConfig(), {}, train_encoder=True))
    trained = {n.split(".")[1] for n, p in model.encoder.named_parameters() if p.requires_grad}
    assert trained == {"5", "6", "7"}
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 #8"):
        make_train_step(model, TrainConfig(), {}, teacher_forcing=False)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 #8"):
        make_train_step(model, TrainConfig(), {}, teacher_forcing=False, train_encoder=True)


def rollout_args(make, L=1, R=2, P=3, E=8, V=5, steps=2):
    """``fused_full_rollout``'s tensor arguments, each from ``make(*shape)``."""
    from tpu_captioner_torch.ops.decode_step import DecodeWeights

    w = DecodeWeights(*(make(L, 1) for _ in DecodeWeights._fields))
    return (w, make(V, E), make(V, E), make(V), make(steps, E), make(L, R, P, E), make(L, R, P, E))


def test_rollout_wrappers_refuse_gradients_and_other_devices():
    from tpu_captioner_torch.ops.decode_step import DecodeWeights, fused_decode_step, fused_full_rollout

    meta = lambda *s: torch.empty(*s, device="meta")  # noqa: E731 — neither cpu nor cuda
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_full_rollout(*rollout_args(meta), 0, 1, 2, 2)
    w = DecodeWeights(*(meta(1, 1) for _ in DecodeWeights._fields))
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_decode_step(w, meta(2, 8), 0, *(meta(1, 2, 4, 8),) * 4, 2, one_cell=True)
    grad = lambda *s: torch.zeros(*s, requires_grad=True)  # noqa: E731
    with pytest.raises(RuntimeError, match="forward only"):
        fused_full_rollout(*rollout_args(grad), 0, 1, 2, 2)
    w = DecodeWeights(*(grad(1, 1) for _ in DecodeWeights._fields))
    with pytest.raises(RuntimeError, match="forward only"):
        fused_decode_step(w, torch.zeros(2, 8), 0, *(torch.zeros(1, 2, 4, 8),) * 4, 2, one_cell=True)


def test_mega_never_resolves_to_step(monkeypatch):
    from tpu_captioner_torch.core.config import DECODE_KERNEL_MODES, ModelConfig
    from tpu_captioner_torch.train.model import CaptionModel, decode_kernel_mode

    assert {m: decode_kernel_mode(m) for m in DECODE_KERNEL_MODES} == {
        "auto": "step", "on": "step", "step": "step", "mega": "mega", "off": "off"}
    with pytest.raises(ValueError):
        ModelConfig(decode_kernel="onecell")
    # A vocabulary whose tables the JAX package would not fit in VMEM.
    model = CaptionModel(
        ModelConfig(vocab_size=47_000, encoder_depths=(1, 1, 1, 1), encoder_dims=(8, 8, 8, 8),
                    encoder_dim=8, embed_dim=8, num_heads=2, decoder_dim=8, num_layers=1,
                    decode_kernel="mega"),
        device="cpu",
    )
    called = []
    for name in ("rollout", "fused_rollout", "mega_rollout"):
        monkeypatch.setattr(model.decoder, name, lambda *a, _n=name, **k: called.append(_n))
    model.rollout(torch.zeros(1, 4, 8), 1, 2, 3)
    assert called == ["mega_rollout"]


def test_dwconv_wrappers_refuse_other_devices_and_dtypes(cpu_only):
    from tpu_captioner_torch.ops import _build
    from tpu_captioner_torch.ops.dwconv import depthwise_conv7x7_nhwc, dwconv_filter_grad, dwconv_forward

    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        nvcc = None
    if nvcc is None:  # a CUDA request cannot build its kernels here: it raises
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load("dwconv")
    meta = lambda *s: torch.empty(*s, device="meta")  # noqa: E731 — neither cpu nor cuda
    for fn in (depthwise_conv7x7_nhwc, dwconv_forward):
        with pytest.raises(ValueError, match="cpu or cuda"):
            fn(meta(1, 8, 8, 16), meta(7, 7, 16))
    with pytest.raises(ValueError, match="cpu or cuda"):
        dwconv_filter_grad(meta(1, 8, 8, 16), meta(1, 8, 8, 16))
    x, w = torch.zeros(1, 8, 8, 16), torch.zeros(7, 7, 16)
    with pytest.raises(ValueError, match="float32"):
        depthwise_conv7x7_nhwc(x.bfloat16(), w.bfloat16())
    with pytest.raises(ValueError, match="float32"):
        dwconv_filter_grad(x, x.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        depthwise_conv7x7_nhwc(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="not cpu"):
        depthwise_conv7x7_nhwc(x, meta(7, 7, 16))
    with pytest.raises(ValueError, match="shape"):
        dwconv_forward(x, torch.zeros(3, 3, 16))
