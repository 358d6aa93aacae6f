"""Two data-parallel ranks of the port against its own one-process step on
the global batch, with dropout (the pooled draw, and the per-site draws of
``dropout_masks='threefry'``; the free-running rollout's per-token draws and
the scheduled-sampling coin) and stochastic depth on: every random site
draws for the global batch and each rank keeps its rows
(``models.layers.row_shard_scope``), so both runs drop, skip and sample the
same elements.  Two steps of each kind (frozen, fine-tune, free-running)
from the same weights, with order-one layer scales.  Tolerances: losses
1e-5 relative, token and top-5 counts equal, the parameters after the two
steps within 1e-2 x lr where both steps' gradients are at least 1e-7 (Adam
turns float noise below that into steps of +-lr), and the ranks' weights
and gradients bit for bit equal after every step."""

import pytest
import torch

from tests.torch_parallel_workers import KINDS, run_steps, steps_rank
from tpu_captioner_torch.core.config import ModelConfig
from tpu_captioner_torch.parallel.dryrun import global_batch, word_ids
from tpu_captioner_torch.parallel.mesh import spawn
from tpu_captioner_torch.train.model import CaptionModel

TINY = dict(vocab_size=40, embed_dim=16, decoder_dim=20, attention_dim=12, num_heads=4, num_layers=2, max_len=12,
            encoder_dim=24, encoder_depths=(1, 1, 2, 1), encoder_dims=(8, 12, 16, 24), encoded_image_size=2)
LR = 1e-4


@pytest.mark.parametrize("decoder,masks", [("transformer", "pool"), ("transformer", "threefry"), ("lstm", "pool")])
def test_two_ranks_match_one_process_with_dropout_and_stochastic_depth(tmp_path, decoder, masks):
    cfg = ModelConfig(decoder=decoder, dropout_masks=masks, **TINY)
    model = CaptionModel(cfg, device="cpu", seed=11)
    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():  # order-one layer scales: the blocks' tails count
        for blk in (m for m in model.modules() if hasattr(m, "layer_scale")):
            blk.layer_scale.copy_(0.5 * torch.rand(blk.layer_scale.shape, generator=gen))
    batch = {k: v.numpy() for k, v in global_batch(4, 32, cfg.max_len, cfg.vocab_size, seed=13).items()}
    spec = {"cfg": {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}, "state_dict": model.state_dict(),
            "batch": batch, "kinds": KINDS, "steps": 2, "seed": 14, "stochastic_depth": True,
            "train": dict(batch_size=2, max_decode_len=9, scheduled_sampling_prob=0.5, decoder_lr=LR,
                          encoder_lr=LR),
            "word_ids": word_ids(cfg.vocab_size)}
    torch.save(spec, tmp_path / "spec.pt")
    spawn(steps_rank, 2, "cpu", args=(str(tmp_path / "spec.pt"), str(tmp_path / "out.pt")))
    got = torch.load(tmp_path / "out.pt", weights_only=False)
    want = run_steps(spec)
    for kind in KINDS:
        g, w = got[kind], want[kind]
        assert g["agree"] == [True, True], kind
        for a, b in zip(g["metrics"], w["metrics"]):
            assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"]), (kind, a, b)
            assert a["tokens"] == b["tokens"] > 0 and a["top5_correct"] == b["top5_correct"], (kind, a, b)
        assert set(g["grads"][0]) == set(w["grads"][0]), kind
        checked = 0
        for name, grad in w["grads"][0].items():
            sure = (grad.abs() >= 1e-7) & (w["grads"][1][name].abs() >= 1e-7)
            err = (g["params"][name] - w["params"][name]).abs()[sure]
            assert err.numel() == 0 or err.max().item() <= 1e-2 * LR, (kind, name, err.max().item())
            checked += int(sure.sum())
        assert checked > 0, kind
