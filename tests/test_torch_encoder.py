"""The port's ConvNeXt encoder against JAX ``ConvNeXtEncoder`` with
``pallas_mode='off'`` on bridged weights (order-one layer scales, so every
block's MLP tail shows in the output), with the depthwise conv as the grouped
conv (``dw`` 'off') and through ``ops/dwconv.py`` with both of its kernels
chosen (``dw`` 'on': its plain versions on CPU tensors).  Tolerance 1e-4
absolute: f32 through 4 stages of convs and LayerNorms in two frameworks'
summation orders."""

import numpy as np
import pytest
import torch

from tests.test_torch_helpers import images, jax_model_and_params, port_model, set_dw
from tpu_captioner_torch.models.encoder import preprocess_images


@pytest.mark.parametrize("dw", ["off", "on"])
@pytest.mark.parametrize("use_pallas", ["on", "off"])
def test_encoder_matches_jax(use_pallas, dw):
    # 'on' routes the blocks through the fused wrapper (its plain version on
    # CPU tensors); 'off' calls the plain version directly.
    jmodel, params = jax_model_and_params(seed=1, use_pallas="off")
    model = port_model(params, use_pallas=use_pallas)
    set_dw(model, dw == "on", dw == "on")
    imgs = images(2, seed=5)
    want = np.asarray(jmodel.encode(params, imgs))
    got = model.encode(torch.from_numpy(imgs)).numpy()
    assert got.shape == want.shape == (2, 2, 2, 32)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_preprocess_matches_jax():
    from tpu_captioner.models.encoder import preprocess_images as jax_preprocess

    imgs = images(1, seed=2)
    np.testing.assert_allclose(
        preprocess_images(torch.from_numpy(imgs)).numpy(), np.asarray(jax_preprocess(imgs)),
        atol=1e-6, rtol=0,
    )
