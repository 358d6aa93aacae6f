"""Weight bridge: JAX params and reference checkpoints -> the port's state dict.

``state_dict_from_jax`` is the inverse of ``tpu_captioner/models/port_torch.py``:
it unstacks the scanned stage and layer axes and transposes JAX layouts back
to PyTorch's (Dense (in, out) -> Linear (out, in); LSTM w_ih (in, 4D) ->
weight_ih (4D, in); conv (kh, kw, in, out) -> (out, in, kh, kw)), for every
decoder family.  It takes numpy arrays, so this package needs no JAX.

``load_reference_checkpoint`` reads a reference ``.pth.tar`` (payload of the
reference utils/utils.py: ``encoder``/``decoder`` state dicts plus epoch and
BLEU metadata) straight into a ``CaptionModel``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from tpu_captioner_torch.core.config import LSTM_DECODERS, ModelConfig


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _conv(p: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    out[f"{prefix}.bias"] = _t(p["bias"])


def _ln(p: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _encoder_from_jax(p: Mapping, depths) -> Dict[str, torch.Tensor]:
    """ConvNeXtEncoder params ({'convnext': {'features_*': ...}}) -> keys
    ``convnext.*`` of ``models.encoder.Encoder``."""
    f = p["convnext"]
    out: Dict[str, torch.Tensor] = {}
    _conv(f["features_0"]["conv"], "convnext.0.0", out)
    _ln(f["features_0"]["LayerNorm_0"], "convnext.0.1", out)
    for s, depth in enumerate(depths):
        blocks = f[f"features_{2 * s + 1}"]["blocks"]
        for b in range(depth):
            base = f"convnext.{2 * s + 1}.{b}"
            one = lambda tree: {k: np.asarray(v)[b] for k, v in tree.items()}  # noqa: E731
            _conv(one(blocks["dwconv"]), f"{base}.block.0", out)
            _ln(one(blocks["LayerNorm_0"]), f"{base}.block.2", out)
            for idx, name in ((3, "pw1"), (5, "pw2")):
                out[f"{base}.block.{idx}.weight"] = _t(np.asarray(blocks[name]["kernel"])[b].T)
                out[f"{base}.block.{idx}.bias"] = _t(np.asarray(blocks[name]["bias"])[b])
            out[f"{base}.layer_scale"] = _t(np.asarray(blocks["layer_scale"])[b][:, None, None])
        if s < len(depths) - 1:
            down = f[f"features_{2 * s + 2}"]
            _ln(down["LayerNorm_0"], f"convnext.{2 * s + 2}.0", out)
            _conv(down["conv"], f"convnext.{2 * s + 2}.1", out)
    return out


def _decoder_from_jax(p: Mapping, num_layers: int) -> Dict[str, torch.Tensor]:
    """TransformerDecoder params -> reference decoder state-dict keys."""
    out: Dict[str, torch.Tensor] = {"embedding.weight": _t(p["embedding"])}
    lay = p["layers"]
    for i in range(num_layers):
        base = f"transformer_decoder.layers.{i}"
        for jname, tname in (("self_attn", "self_attn"), ("cross_attn", "multihead_attn")):
            m = lay[jname]
            out[f"{base}.{tname}.in_proj_weight"] = _t(np.asarray(m["in_w"])[i].T)
            out[f"{base}.{tname}.in_proj_bias"] = _t(np.asarray(m["in_b"])[i])
            out[f"{base}.{tname}.out_proj.weight"] = _t(np.asarray(m["out_w"])[i].T)
            out[f"{base}.{tname}.out_proj.bias"] = _t(np.asarray(m["out_b"])[i])
        for name in ("linear1", "linear2"):
            out[f"{base}.{name}.weight"] = _t(np.asarray(lay[name]["w"])[i].T)
            out[f"{base}.{name}.bias"] = _t(np.asarray(lay[name]["b"])[i])
        for name in ("norm1", "norm2", "norm3"):
            out[f"{base}.{name}.weight"] = _t(np.asarray(lay[name]["scale"])[i])
            out[f"{base}.{name}.bias"] = _t(np.asarray(lay[name]["bias"])[i])
    out["fc_out.weight"] = _t(np.asarray(p["fc_out"]["w"]).T)
    out["fc_out.bias"] = _t(p["fc_out"]["b"])
    if "encoder_proj" in p:
        out["encoder_proj.weight"] = _t(np.asarray(p["encoder_proj"]["w"]).T)
        out["encoder_proj.bias"] = _t(p["encoder_proj"]["b"])
    return out


def _linear(p: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["w"]).T)
    out[f"{prefix}.bias"] = _t(p["b"])


def _lstm_decoder_from_jax(p: Mapping) -> Dict[str, torch.Tensor]:
    """DecoderWithAttention or DecoderWithoutAttention params -> reference
    decoder state-dict keys (the inverse of ``port_lstm_attention_decoder``
    and ``port_lstm_no_attention_decoder``): LSTM ``w_ih`` (in, 4D) becomes
    ``decode_step.weight_ih`` (4D, in)."""
    out: Dict[str, torch.Tensor] = {"embedding.weight": _t(p["embedding"])}
    if "attention" in p:
        for name in ("encoder_att", "decoder_att", "full_att"):
            _linear(p["attention"][name], f"attention.{name}", out)
        _linear(p["f_beta"], "f_beta", out)
    for name in ("init_h", "init_c", "fc"):
        _linear(p[name], name, out)
    cell = p["lstm"]
    out["decode_step.weight_ih"] = _t(np.asarray(cell["w_ih"]).T)
    out["decode_step.weight_hh"] = _t(np.asarray(cell["w_hh"]).T)
    out["decode_step.bias_ih"] = _t(cell["b_ih"])
    out["decode_step.bias_hh"] = _t(cell["b_hh"])
    return out


def state_dict_from_jax(params_np: Mapping[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX ``{'encoder': ..., 'decoder': ...}`` params (numpy leaves) ->
    ``CaptionModel`` state dict (CPU tensors)."""
    sd = {
        f"encoder.{k}": v
        for k, v in _encoder_from_jax(params_np["encoder"], tuple(cfg.encoder_depths)).items()
    }
    if cfg.decoder in LSTM_DECODERS:
        dec = _lstm_decoder_from_jax(params_np["decoder"])
    else:
        dec = _decoder_from_jax(params_np["decoder"], cfg.num_layers)
    sd.update({f"decoder.{k}": v for k, v in dec.items()})
    return sd


def save_reference_checkpoint(model, path: str, **meta) -> None:
    """Write ``model``'s weights as a reference-format ``.pth.tar``."""
    torch.save(
        {
            "epoch": meta.get("epoch", 0),
            "epochsSinceImprovement": meta.get("epochs_since_improvement", 0),
            "bleu-4": meta.get("bleu4", 0.0),
            "encoder": {k: v.cpu() for k, v in model.encoder.state_dict().items()},
            "decoder": {k: v.cpu() for k, v in model.decoder.state_dict().items()},
        },
        path,
    )


def _load_part(module: torch.nn.Module, sd: Mapping[str, torch.Tensor], what: str) -> None:
    missing, _unexpected = module.load_state_dict(dict(sd), strict=False)
    if missing:
        raise KeyError(f"reference checkpoint {what} lacks {len(missing)} keys, e.g. {missing[:3]}")


def load_reference_checkpoint(model, path: str) -> Dict[str, Any]:
    """Load a reference ``.pth.tar`` into ``model`` (a ``CaptionModel``) in
    place; returns the checkpoint's metadata.  A ``module.`` prefix (DDP) is
    stripped; keys the port does not hold (buffers of the reference modules)
    are ignored, as the JAX porter ignores them; a missing key raises."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    strip = lambda sd: {re.sub(r"^module\.", "", k): v for k, v in dict(sd).items()}  # noqa: E731
    _load_part(model.encoder, strip(ckpt["encoder"]), "encoder")
    _load_part(model.decoder, strip(ckpt["decoder"]), "decoder")
    return {
        "epoch": ckpt.get("epoch"),
        "epochs_since_improvement": ckpt.get("epochsSinceImprovement"),
        "bleu4": ckpt.get("bleu-4"),
    }
