"""Checkpoints with the reference's payload and names (counterpart of
``tpu_captioner/train/checkpoint.py``; reference utils/utils.py:195-224).

Every epoch writes ``<directory>/<name>/``: ``state.pt`` (``torch.save`` of
the model's ``state_dict``, both Adams' ``state_dict``s and the step count)
and ``meta.json`` with the JAX package's keys (epoch,
``epochs_since_improvement``, ``bleu4``, the per-epoch ``results`` rows and
the experiment ``config``).  A new best BLEU-4 copies the directory to
``BEST_<name>``.  ``restore_checkpoint`` loads every tensor back bit for bit.
Data parallel: rank 0 alone calls ``save_checkpoint`` while the other
ranks wait for it at a barrier (``Trainer.run``), and every rank restores
from the shared path.
Reference ``.pth.tar`` files (weights only) load through
``models/from_jax.py:load_reference_checkpoint``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from tpu_captioner_torch.train.state import TrainState

STATE_FILE, META_FILE = "state.pt", "meta.json"


def checkpoint_name(
    data_name: str, lstm_decoder: bool, starting_layer: int, encoder_lr: float, embedding_name: Optional[str] = None
) -> str:
    """The reference's file name (utils/utils.py:217-220) without .pth.tar."""
    if lstm_decoder:
        return f"checkpoint_LSTM_Finetuning{starting_layer}_{encoder_lr}_{data_name}"
    return f"checkpoint_Transformer_Finetuning{starting_layer}_{encoder_lr}_{embedding_name}_{data_name}"


def save_checkpoint(
    directory: str, name: str, state: TrainState, host_meta: Dict[str, Any], is_best: bool = False
) -> str:
    """Write ``directory/name/{state.pt, meta.json}`` (each through a
    temporary file renamed into place) and copy the directory to
    ``BEST_name`` when ``is_best``.  Returns the directory."""
    base = os.path.join(os.path.abspath(directory), name)
    os.makedirs(base, exist_ok=True)
    payload = {
        "model": state.model.state_dict(),
        "dec_opt": state.dec_opt.state_dict(),
        "enc_opt": state.enc_opt.state_dict(),
        "step": state.step,
    }
    tmp = os.path.join(base, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(base, STATE_FILE))
    with open(os.path.join(base, META_FILE + ".tmp"), "w") as f:
        json.dump(host_meta, f)
    os.replace(os.path.join(base, META_FILE + ".tmp"), os.path.join(base, META_FILE))
    if is_best:
        best = os.path.join(os.path.abspath(directory), f"BEST_{name}")
        if os.path.exists(best):
            shutil.rmtree(best)
        shutil.copytree(base, best)
    return base


def restore_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, Dict[str, Any]]:
    """Load a directory of ``save_checkpoint`` into ``state`` (its model and
    both optimizers, in place); returns (state, host metadata).  The file is
    read to the host: the loads copy each tensor to its parameter's device,
    and Adam keeps its step counts on the host, as a fresh Adam does."""
    path = os.path.abspath(path)
    payload = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.dec_opt.load_state_dict(payload["dec_opt"])
    state.enc_opt.load_state_dict(payload["enc_opt"])
    state.step = int(payload["step"])
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    return state, meta
