"""Shared set-up for the tests that hold the PyTorch port against the JAX
package (no tests here).

One small configuration, the same in both packages: ConvNeXt depths
(1, 1, 2, 1), dims (8, 16, 24, 32); a 3-layer Transformer with E=64, H=4,
FFN 48; 2x2 = 4 memory pixels; vocab 57.  Weights are drawn once by the JAX
package, their layer scales replaced with numpy-seeded values of order one
(the 1e-6 init would hide the MLP tail), and bridged into the port with
``state_dict_from_jax``.  Inputs are numpy arrays from a seed.
"""

import jax
import numpy as np
import torch

from tpu_captioner.core.config import ModelConfig as JaxModelConfig
from tpu_captioner.train.model import CaptionModel as JaxCaptionModel
from tpu_captioner_torch.core.config import ModelConfig
from tpu_captioner_torch.models.from_jax import state_dict_from_jax
from tpu_captioner_torch.train.model import CaptionModel

SMALL = dict(
    decoder="transformer",
    vocab_size=57,
    embed_dim=64,
    decoder_dim=48,
    num_heads=4,
    num_layers=3,
    max_len=16,
    encoder_dim=32,
    encoded_image_size=2,
    encoder_depths=(1, 1, 2, 1),
    encoder_dims=(8, 16, 24, 32),
)
IMAGE_SIZE = 64
START, END = 55, 56


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_model_and_params(seed: int = 0, **overrides):
    """JAX CaptionModel and numpy params with order-one layer scales."""
    cfg = JaxModelConfig(**{**SMALL, **overrides})
    model = JaxCaptionModel(cfg)
    params = to_numpy(model.init_params(jax.random.PRNGKey(seed), image_size=IMAGE_SIZE))
    rng = np.random.default_rng(seed + 100)
    for name, stage in params["encoder"]["convnext"].items():
        if "blocks" in stage:
            ls = stage["blocks"]["layer_scale"]
            stage["blocks"]["layer_scale"] = (0.5 * rng.standard_normal(ls.shape)).astype(np.float32)
    return model, params


def port_model(params, **overrides) -> CaptionModel:
    """The port's CaptionModel on the CPU holding the same weights."""
    cfg = ModelConfig(**{**SMALL, **overrides})
    model = CaptionModel(cfg, device="cpu", seed=0)
    model.load_state_dict(state_dict_from_jax(params, cfg))
    return model


def set_dw(model, dw_kernel: bool, dw_grad_kernel: bool) -> None:
    """Set every ConvNeXt block's two depthwise-conv choices (they follow
    ``use_pallas`` otherwise): with both False the block runs the grouped
    conv, else ``ops/dwconv.py`` with the two choices."""
    from tpu_captioner_torch.models.convnext import CNBlock

    for blk in model.modules():
        if isinstance(blk, CNBlock):
            blk.dw_kernel, blk.dw_grad_kernel = dw_kernel, dw_grad_kernel


def images(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, IMAGE_SIZE, IMAGE_SIZE, 3), dtype=np.uint8)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
