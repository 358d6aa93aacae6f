"""The port stands alone and never falls back.

- Importing every ``tpu_captioner_torch`` module (and ``chip_smoke``) in a
  fresh interpreter pulls in no JAX.
- On a host without CUDA, every request for the card raises: the kernel
  build, the kernel wrappers given a non-CPU tensor, a model asked for
  ``cuda``, and ``chip_smoke.main()``.
- The MLP-tail wrapper carries a gradient (its backward is a kernel too);
  the decode wrappers (the step, per layer or one-cell, the whole rollout,
  and the LSTM step) are forward only and raise, on every device, when
  autograd would need a gradient through them.
- ``decode_kernel='mega'`` always reaches the whole-rollout kernel: it never
  resolves to the per-token one.
- Every train-step branch builds a step (teacher-forced and free-running,
  frozen and fine-tune), and the ``.npz`` form of ``--pretrainedEncoder``
  loads; more than one device (once refused as Queue 1 #9) takes a group of
  that many ranks, and a count the group does not have raises ValueError.
  The training modules (data, loader, checkpoints, Trainer, CLIs) and the
  data-parallel ones (``parallel/``: the group, the collectives, the dry
  run) catch no failure, but for the loader's queue timeouts and its
  thread's error, raised again in the consumer.  The native runtime
  (``native/``) raises when it does not build: nothing falls back to
  Python.
- The depthwise conv's wrappers refuse what their kernels do not take (other
  devices, a dtype without an instance: float16, mixed dtypes;
  non-contiguous tensors, tensors on two devices).  bf16 serves and trains
  the Transformer families; what it does not port raises naming its
  ROADMAP item.
- The whole-block wrapper refuses other devices, dtypes, shapes and layouts
  on every device, and on the card the widths its kernel is not built for;
  its library stages the conv by TMA (``csrc/dwconv_tile.cuh``), runs the
  3xTF32 products (``csrc/mlp_products.cuh``) and not the FFMA tail.
- The MLP-tail kernels' tensor-core products: the 3xTF32 header is in both
  libraries' build hash and holds the TF32 wgmma and the hi/lo rounding; no
  source calls a library GEMM; neither wrapper catches a failed launch; a
  build that cannot run raises; and ``ops/tf32.py``, the CPU model of the
  split, is imported by no module of the port (only the tests use it).
- The decode kernels stage their weight slices and activation rows with
  bulk copies on mbarriers (``csrc/mbarrier.cuh``, in ``decode_step.cu``'s
  build hash with ``warp_reduce.cuh``); no decode wrapper catches a failed
  launch, and a decode build that cannot run raises.
- ``CaptionModel.rollout`` with dropout (free-running training) takes the
  plain rollout in every decode mode and raises without a generator.
"""

import dataclasses
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
        assert len(names) >= 30, names
        assert "tpu_captioner_torch.ops.block_fused" in names, names
        for new in ("data.vocab", "data.build", "data.dataset", "data.loader", "models.embeddings",
                    "train.checkpoint", "train.loop", "cli.common", "cli.train", "cli.test", "cli.build_data",
                    "native.lib", "native.bleu_native", "native.gather", "infer.visualize", "cli.graphs",
                    "parallel.mesh", "parallel.collectives", "parallel.dryrun", "eval.flops"):
            assert "tpu_captioner_torch." + new in names, new
        bad = sorted(m for m in sys.modules if m.split(".")[0] in (
            "pandas", "nltk", "PIL", "h5py", "matplotlib", "scipy"))
        assert not bad, bad
        assert "tpu_captioner_torch.ops.tf32" in names, names
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
    """bf16 serves, evaluates and trains all four decoder families: a bf16
    model of each builds, and so do its four train steps (the LSTM
    families, once refused as #5c, are ported); a bf16 Transformer's
    ``'mega'`` and one-cell rollouts run (once refused as #5e), with finite
    f32 logits.  ``use_pallas='block'`` and per-stage lists holding it, once
    refused as #5d, are ported: such a bf16 model builds, encodes to finite
    bf16 features and takes a fine-tune step whose trained encoder
    gradients are finite, and no source of the package refuses anything as
    #5d.  The LSTM families, once refused in f32 too, are ported: an
    ``lstm`` model builds on the CPU."""
    import math
    import pathlib

    from tpu_captioner_torch.core import prng
    from tpu_captioner_torch.core.config import ModelConfig, TrainConfig
    from tpu_captioner_torch.models.lstm import DecoderWithAttention
    from tpu_captioner_torch.train.model import CaptionModel
    from tpu_captioner_torch.train.state import TrainState
    from tpu_captioner_torch.train.steps import make_train_step

    tiny = dict(vocab_size=11, encoder_depths=(1, 1, 1, 1), encoder_dims=(8, 8, 8, 8), encoder_dim=8,
                embed_dim=8, decoder_dim=8, num_heads=2, num_layers=1, max_len=6, compute_dtype="bfloat16")
    word_ids = {"<start>": 1, "<end>": 2, "<pad>": 0}
    for decoder in ("transformer", "transformer_attvis", "lstm", "lstm_no_attention"):
        model = CaptionModel(ModelConfig(decoder=decoder, attention_dim=6, **tiny), device="cpu")
        assert model.dtype == torch.bfloat16
        for teacher_forcing in (True, False):
            for train_encoder in (False, True):
                assert callable(make_train_step(model, TrainConfig(), word_ids, teacher_forcing=teacher_forcing,
                                                train_encoder=train_encoder))
    images = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(0))
    captions = torch.tensor([[1, 5, 2, 0, 0, 0], [1, 6, 7, 8, 2, 0]])
    batch = {"images": images, "captions": captions, "caplens": torch.tensor([3, 5]),
             "valid": torch.tensor([True, True])}
    for use_pallas in ("block", ("mlp", "mlp", "block", "off")):
        model = CaptionModel(ModelConfig(use_pallas=use_pallas, **tiny), device="cpu")
        with torch.inference_mode():
            feats = model.encode(images)
        assert feats.dtype == torch.bfloat16 and feats.shape == (2, 7, 7, 8) and torch.isfinite(feats.float()).all()
        tc = TrainConfig(batch_size=2, max_decode_len=4)
        state = TrainState.create(model, tc)
        state, m = make_train_step(model, tc, word_ids, train_encoder=True)(state, batch, prng.step_seed(prng.root_seed(1), "dropout", 0, 0))
        grads = [p.grad for p in model.encoder.parameters() if p.grad is not None]
        assert math.isfinite(float(m["loss"])) and grads and all(torch.isfinite(g).all() for g in grads)
    root = pathlib.Path(__file__).resolve().parents[1] / "tpu_captioner_torch"
    assert not [p for p in root.rglob("*") if p.suffix in (".py", ".cu", ".cuh") and "#5d" in p.read_text()]
    enc = torch.zeros(2, 7, 7, 8, dtype=torch.bfloat16)
    for mode, one_cell in (("mega", False), ("step", True)):
        model = CaptionModel(ModelConfig(decode_kernel=mode, **tiny), device="cpu")
        with torch.inference_mode():
            logits, seqs, _ = model.rollout(enc, 1, 2, 3, one_cell=one_cell)
        assert logits.dtype == torch.float32 and torch.isfinite(logits).all() and seqs.shape == (2, 3)
    model = CaptionModel(
        ModelConfig(vocab_size=11, decoder="lstm", encoder_depths=(1, 1, 1, 1), encoder_dims=(8, 8, 8, 8),
                    encoder_dim=8, embed_dim=8, attention_dim=6, decoder_dim=8),
        device="cpu",
    )
    assert isinstance(model.decoder, DecoderWithAttention) and model.device.type == "cpu"


def test_lstm_step_refuses_gradients_and_other_devices(cpu_only):
    """``fused_lstm_step`` raises for a tensor neither on the CPU nor on a
    card, and on every device when autograd would need its gradient; its
    build raises without nvcc."""
    from tpu_captioner_torch.ops import _build
    from tpu_captioner_torch.ops.lstm_step import LstmStepWeights, fused_lstm_step

    def args(make, R=2, E=3, D=4, A=5, C=6, P=7):
        w = LstmStepWeights(make(A, D), make(A), make(A), make(1), make(C, D), make(C),
                            make(4 * D, E), make(4 * D, C), make(4 * D, D), make(4 * D))
        return (w, make(R, E), make(R, D), make(R, D), make(R, P, C), make(R, P, A))

    meta = lambda *s: torch.empty(*s, device="meta")  # noqa: E731 — neither cpu nor cuda
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_lstm_step(*args(meta))
    grad = lambda *s: torch.zeros(*s, requires_grad=True)  # noqa: E731
    with pytest.raises(RuntimeError, match="forward only"):
        fused_lstm_step(*args(grad))
    with torch.no_grad():
        h, c, alpha = fused_lstm_step(*args(grad))  # the plain version, without autograd
    assert h.shape == c.shape == (2, 4) and torch.allclose(alpha.sum(dim=1), torch.ones(2))
    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        nvcc = None
    if nvcc is None:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load("lstm_step")


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


def test_unported_train_branches_raise(tmp_path):
    """The free-running branches, once refused here, are ported: they build
    steps; so is the .npz form of the pretrained encoder, once refused as
    Queue 1 #7: it loads.  More than one device, once refused as Queue 1
    #9, needs a group of that many ranks: alone, the loader and the
    device count raise ValueError; under a group of two, 2 resolves and
    the loader's global batch doubles, and 3 raises ValueError."""
    from types import SimpleNamespace

    import numpy as np

    from tpu_captioner_torch.core.config import ModelConfig, TrainConfig
    from tpu_captioner_torch.data.loader import DeviceLoader, resolve_num_devices
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
    ids = {"<pad>": 0, "<start>": 9, "<end>": 10}
    assert callable(make_train_step(model, TrainConfig(), ids, teacher_forcing=False))
    assert not any(p.requires_grad for p in model.encoder.parameters())
    assert callable(make_train_step(model, TrainConfig(), ids, teacher_forcing=False, train_encoder=True))
    with pytest.raises(ValueError, match="this process is alone"):
        resolve_num_devices(2, "cpu")
    with pytest.raises(ValueError, match="this process is alone"):
        DeviceLoader([], 4, device="cpu", num_devices=8)
    from tests.torch_parallel_workers import device_count_rank
    from tpu_captioner_torch.parallel.mesh import spawn

    spawn(device_count_rank, 2, "cpu")
    from tpu_captioner_torch.train.loop import Trainer

    trainer = Trainer.__new__(Trainer)  # only the backbone load runs
    trainer.model, trainer.exp, trainer.verbose = model, SimpleNamespace(model=model.cfg), False
    donor = CaptionModel(model.cfg, device="cpu", seed=5)
    np.savez(tmp_path / "convnext.npz", **{"features." + k[len("convnext."):]: v.numpy()
                                          for k, v in donor.encoder.state_dict().items()})
    trainer._load_backbone(str(tmp_path / "convnext.npz"))
    want = donor.encoder.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in model.encoder.state_dict().items())


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

    assert {m: decode_kernel_mode(m, "transformer") for m in DECODE_KERNEL_MODES} == {
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
    for fn in (depthwise_conv7x7_nhwc, dwconv_forward):  # a dtype with no instance
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fn(x.half(), w.half())
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fn(x.bfloat16(), w)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        dwconv_filter_grad(x, x.bfloat16())
    with pytest.raises(ValueError, match="float32 or bfloat16"):  # bf16 training takes bf16, float16 has no instance
        dwconv_filter_grad(x.half(), x.half())
    with pytest.raises(ValueError, match="contiguous"):
        depthwise_conv7x7_nhwc(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="not cpu"):
        depthwise_conv7x7_nhwc(x, meta(7, 7, 16))
    with pytest.raises(ValueError, match="shape"):
        dwconv_forward(x, torch.zeros(3, 3, 16))


def test_block_wrapper_refuses_what_its_kernel_does_not_take(cpu_only):
    from tpu_captioner_torch.ops import _build
    from tpu_captioner_torch.ops.block_fused import _check_block, fused_convnext_block

    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        nvcc = None
    if nvcc is None:  # a CUDA request cannot build its kernel here: it raises
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load("block_fused")

    def args(make, b=2, h=8, w=8, c=16):
        return [make(b, h, w, c), make(b), make(7, 7, c), make(c), make(c), make(c),
                make(4 * c, c), make(4 * c), make(c, 4 * c), make(c), make(c)]

    meta = lambda *s: torch.empty(*s, device="meta")  # noqa: E731 — neither cpu nor cuda
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_convnext_block(*args(meta))
    ok = args(torch.zeros)
    assert fused_convnext_block(*ok).shape == (2, 8, 8, 16)  # the plain version takes any width
    for i, bad, match in (
        (0, ok[0].bfloat16(), "float32"),
        (0, ok[0].transpose(1, 2), "contiguous"),
        (0, torch.zeros(2, 8, 16), r"\(B, H, W, C\)"),
        (1, torch.zeros(3), "shape"),
        (2, torch.zeros(3, 3, 16), "shape"),
        (6, torch.zeros(16, 64), "shape"),
        (2, meta(7, 7, 16), "not cpu"),
    ):
        with pytest.raises(ValueError, match=match):
            fused_convnext_block(*ok[:i], bad, *ok[i + 1:])
    with pytest.raises(ValueError, match="supports C in"):  # what a CUDA tensor of this width meets
        _check_block(*ok, kernel=True)
    _check_block(*args(torch.zeros, c=128), kernel=True)


def test_mlp_tensor_core_sources_have_no_fallback(cpu_only):
    import inspect
    import pathlib

    import tpu_captioner_torch
    from tpu_captioner_torch.ops import _build, mlp_block

    for name in ("mlp_block", "mlp_block_bwd", "block_fused"):
        sources = {p.name: text.decode() for p, text in _build._sources(_build.CSRC / f"{name}.cu", {}).items()}
        assert "tf32x3_gemm.cuh" in sources, sources.keys()
        # The products are launched by the library's own source or by the
        # forward products' header that mlp_block.cu and block_fused.cu share.
        callers = [n for n in (f"{name}.cu", "mlp_products.cuh") if "tf32x3::gemm" in sources.get(n, "")]
        assert callers, name
    header = (_build.CSRC / "tf32x3_gemm.cuh").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32" in header
    assert "cvt.rna.tf32.f32" in header and "cp.async.bulk.tensor" in header
    # The precise=False arm: the whole tile's and the backward's products on
    # the bf16 wgmma GEMM, fed by TMA.
    for name, entry in (("mlp_block", "tc_mlp_block_forward_bf16_products("),
                        ("mlp_block_bwd", "tc_mlp_block_backward_bf16_products(")):
        sources = {p.name: text.decode() for p, text in _build._sources(_build.CSRC / f"{name}.cu", {}).items()}
        assert "bf16_gemm.cuh" in sources and entry in sources[f"{name}.cu"], name
    bf16_header = (_build.CSRC / "bf16_gemm.cuh").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in bf16_header
    assert "tma_load_2d(" in bf16_header and "CU_TENSOR_MAP_DATA_TYPE_BFLOAT16" in bf16_header
    assert "bf16mm::gemm(xo, w1o" in (_build.CSRC / "mlp_block.cu").read_text()
    bwd = (_build.CSRC / "mlp_block_bwd.cu").read_text()
    body = bwd[bwd.index("int backward_bf16("):bwd.index("int backward_bf16_any(")]
    assert body.count("TC_TRY(gemm(") == 6 and "using bf16mm::gemm;" in body and "tf32x3" not in body
    for path in _build.CSRC.iterdir():
        assert "cublas" not in path.read_text().lower(), path.name
    for fn in (mlp_block._mlp_forward, mlp_block.fused_convnext_mlp_bwd):
        assert "except" not in inspect.getsource(fn)
    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        nvcc = None
    if nvcc is None:
        for name in ("mlp_block", "mlp_block_bwd"):
            with pytest.raises(RuntimeError, match="nvcc not found"):
                _build.build(name)
    package = pathlib.Path(tpu_captioner_torch.__file__).parent
    users = [p for p in package.rglob("*.py") if p.name != "tf32.py" and "ops.tf32" in p.read_text()]
    assert not users, users


def test_mlp_sub_tiled_source_keeps_h_on_chip_and_has_no_fallback(cpu_only):
    """The sub-tiled MLP tail is one launch of ``fused_kernel``: its first
    product takes A from registers (wgmma's register form), the x slabs
    and weight planes arrive by TMA, h goes to the peers' shared memory
    (distributed shared memory) on cluster-scope mbarriers and never to
    device memory; the f32 FFMA tail is gone; neither the wrapper nor the
    rule catches a failure."""
    import inspect

    from tpu_captioner_torch.ops import _build, mlp_block

    sources = {p.name: text.decode() for p, text in _build._sources(_build.CSRC / "mlp_block.cu", {}).items()}
    assert "mlp_tail.cuh" not in sources and not (_build.CSRC / "mlp_tail.cuh").exists()
    body = sources["mlp_block.cu"]
    for call in ("fused_kernel", "wgmma_rs<JCB>(", "tma_load_2d(", "st.shared::cluster", "mbar_wait_cluster(",
                 "mapa.shared::cluster", "setmaxnreg.inc", "cudaOccupancyMaxActiveClusters"):
        assert call in body, call
    assert "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32" in sources["tf32x3_gemm.cuh"]
    # The precise=False instance (kBP): A from registers on bf16 wgmma, the
    # chunk of h exchanged as one bf16 plane through the peers' shared
    # memory, W1 unfolded (ln_w and ln_b applied in the prologue).
    for call in ("fused_kernel<C, NC, T, true>", "bf16mm::wgmma_rs<JCB>(", "st_shared_b32<(S > 1)>(hdst[r]",
                 "st.shared::cluster.b32", "bf16mm::wgmma_ss128(", "prep_w1_bf16<C, T>"):
        assert call in body, call
    for n in (64, 32, 16):  # the register form at every JCB
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16" in sources["bf16_gemm.cuh"]
    for fn in (mlp_block._pipeline_sub, mlp_block._mlp_forward, mlp_block._lib):
        assert "except" not in inspect.getsource(fn), fn.__name__


def test_block_sources_run_the_tensor_core_tail_and_have_no_fallback(cpu_only):
    """The whole-block library: its conv + LayerNorm launch stages halo'd
    boxes by TMA through the depthwise conv's shared tile header, its
    products are the MLP tail's 3xTF32 ones, and it no longer builds the
    f32 FFMA tail; neither its wrapper nor its plan catches a failure."""
    import inspect

    from tpu_captioner_torch.ops import _build, block_fused

    sources = {p.name: text.decode() for p, text in _build._sources(_build.CSRC / "block_fused.cu", {}).items()}
    assert {"dwconv_tile.cuh", "mbarrier.cuh", "mlp_products.cuh", "tf32x3_gemm.cuh"} <= set(sources)
    assert "mlp_tail.cuh" not in sources, sorted(sources)
    assert "dwconv_tile.cuh" in {p.name for p in _build._sources(_build.CSRC / "dwconv.cu", {})}
    body = sources["block_fused.cu"]
    for call in ("tma_load_4d(", "mbar_wait(", "conv_patch(", "products<C>(", "bind_device(x)"):
        assert call in body, call
    for fn in (block_fused._block_forward, block_fused._plan_on, block_fused.block_plan, block_fused._lib):
        assert "except" not in inspect.getsource(fn), fn.__name__
    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        nvcc = None
    if nvcc is None:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build("block_fused")


def test_decode_sources_stage_by_bulk_copy_and_have_no_fallback(cpu_only):
    import inspect

    from tpu_captioner_torch.ops import _build, decode_step

    sources = {p.name: text.decode() for p, text in _build._sources(_build.CSRC / "decode_step.cu", {}).items()}
    assert {"decode_step.cu", "mbarrier.cuh", "warp_reduce.cuh"} <= set(sources), sources.keys()
    header, body = sources["mbarrier.cuh"], sources["decode_step.cu"]
    assert "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes" in header
    assert "mbarrier.try_wait.parity" in header and "fence.proxy.async" in header
    for call in ("bulk_load(", "mbar_expect_tx(", "mbar_wait(", "grid.sync()"):
        assert call in body, call
    # The hash follows the header: an edited mbarrier.cuh gives another library.
    before = _build.library_path("decode_step")
    path = _build.CSRC / "mbarrier.cuh"
    text = path.read_bytes()
    try:
        path.write_bytes(text + b"\n// edited\n")
        assert _build.library_path("decode_step") != before
    finally:
        path.write_bytes(text)
    assert _build.library_path("decode_step") == before
    for fn in (decode_step.fused_decode_step, decode_step.fused_full_rollout, decode_step._lib):
        assert "except" not in inspect.getsource(fn), fn.__name__
    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        nvcc = None
    if nvcc is None:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build("decode_step")


def test_rollout_with_dropout_raises():
    """A rollout with dropout, once refused, is ported: without a generator
    it raises (no draw from global state); with one it takes the plain
    rollout in every decode mode and of every family, with autograd."""
    from tpu_captioner_torch.core.config import ModelConfig
    from tpu_captioner_torch.train.model import CaptionModel

    for decoder in ("transformer", "lstm", "lstm_no_attention"):
        model = CaptionModel(
            ModelConfig(vocab_size=11, encoder_depths=(1, 1, 1, 1), encoder_dims=(8, 8, 8, 8), decoder=decoder,
                        encoder_dim=8, embed_dim=8, num_heads=2, decoder_dim=8, attention_dim=6, num_layers=1),
            device="cpu",
        )
        enc = torch.zeros(1, 4, 8)
        for mode in ("off", "step", "mega"):
            model.cfg = dataclasses.replace(model.cfg, decode_kernel=mode)
            with pytest.raises(ValueError, match="generator"):
                model.rollout(enc, 1, 2, 3, deterministic=False)
            logits, seqs, _ = model.rollout(enc, 1, 2, 3, deterministic=False, generator=torch.Generator())
            assert logits.shape == (1, 3, 11) and seqs.shape == (1, 3) and logits.requires_grad
            with torch.inference_mode():
                logits, seqs, _ = model.rollout(enc, 1, 2, 3)  # deterministic, the default
            assert logits.shape == (1, 3, 11) and seqs.shape == (1, 3)


def test_training_modules_catch_no_failure():
    """No ``except`` in the training entry point's modules and the
    data-parallel ones but the loader's queue timeouts and its thread's
    error, which the consumer raises: a failed rank or collective, and a
    failed dry run, raise."""
    import importlib
    import inspect
    import re

    allowed = {"tpu_captioner_torch.data.loader": ["except queue.Full:", "except Exception as e:",
                                                   "except queue.Empty:"]}
    for name in ("data.vocab", "data.build", "data.dataset", "data.loader", "models.embeddings",
                 "train.checkpoint", "train.loop", "train.steps", "train.state", "cli.common", "cli.train",
                 "cli.test", "cli.build_data", "parallel.mesh", "parallel.collectives", "parallel.dryrun"):
        mod = "tpu_captioner_torch." + name
        found = re.findall(r"except\b[^\n#]*:", inspect.getsource(importlib.import_module(mod)))
        assert found == allowed.get(mod, []), (mod, found)
    loader = inspect.getsource(importlib.import_module("tpu_captioner_torch.data.loader"))
    assert "err.append(e)" in loader and "raise err[0]" in loader
