"""The port stands alone and never falls back.

- Importing every ``tpu_captioner_torch`` module (and ``chip_smoke``) in a
  fresh interpreter pulls in no JAX.
- On a host without CUDA, every request for the card raises: the kernel
  build, the kernel wrappers given a non-CPU tensor, a model asked for
  ``cuda``, and ``chip_smoke.main()``.
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
        assert len(names) >= 14, names
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
