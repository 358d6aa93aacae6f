"""CLI: caption an image or a directory of images with beam search
(counterpart of ``tpu_captioner/cli/caption.py``).

    python -m tpu_captioner_torch.cli.caption --img photo.jpg \
        --checkpoint BEST_checkpoint_coco_5_cap_per_img_5_min_word_freq.pth.tar \
        --wordMap inputFiles/WORDMAP_coco_5_cap_per_img_5_min_word_freq.json \
        --beamSize 5 --out attention.png --device cuda

``--checkpoint`` takes a checkpoint directory of the port's own training
(``train/checkpoint.py:save_checkpoint``, e.g. ``checkpoints/BEST_...``): the
model is rebuilt from its ``meta.json`` config, as the JAX CLI rebuilds its
own, ``compute_dtype`` included, so a bf16 training run captions in bf16.  It
also takes a reference ``.pth.tar`` (the model then follows the flags; the
Orbax directories belong to the JAX package).  Images are captioned in
groups of 8, one encoder pass and one batched beam loop per group; ``--csv``
writes imageFile,generatedCaption rows.  For one image, ``--out`` draws
the attention grid (``infer/visualize.py``: each word over the image with
its upsampled map, smoothed unless ``--dont_smooth``), as the JAX CLI does;
the maps are the model's ``encoded_image_size`` square (JAX assumes 7).
``--usePallas`` picks the ConvNeXt
blocks' kernels (``ModelConfig.use_pallas``: ``auto``, ``on``, ``mlp``,
``block`` or ``off``, or four of these joined by commas, one per stage); a
checkpoint directory's own setting holds unless the flag is given.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

GROUP = 8


def load_image(path: str, size: int = 256) -> np.ndarray:
    from PIL import Image  # only the CLI's file path needs PIL

    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    img = img.resize((size, size), Image.BICUBIC)
    return np.asarray(img, dtype=np.uint8)


def _use_pallas(flag: str):
    return tuple(flag.split(",")) if "," in flag else flag


def build_model_and_params(args, word_map: Dict[str, int]):
    """Build the ``CaptionModel`` on ``args.device`` and load
    ``args.checkpoint`` into it.  A ``save_checkpoint`` directory rebuilds
    the training run's model from ``meta.json``'s ``config["model"]`` with
    ``vocab_size`` from the word map (tpu_captioner/cli/caption.py:31-65;
    JSON gives lists where the config held tuples) and loads ``state.pt``'s
    ``model`` weights to the host, then onto the device.  A reference
    ``.pth.tar`` takes the model the flags describe."""
    from tpu_captioner_torch.core.config import ModelConfig
    from tpu_captioner_torch.models.from_jax import load_reference_checkpoint
    from tpu_captioner_torch.train.checkpoint import META_FILE, STATE_FILE
    from tpu_captioner_torch.train.model import CaptionModel

    use_pallas = getattr(args, "usePallas", None)
    if os.path.isdir(args.checkpoint):
        with open(os.path.join(args.checkpoint, META_FILE)) as f:
            raw = dict(json.load(f)["config"]["model"])
        raw["vocab_size"] = len(word_map)
        for key in ("encoder_depths", "encoder_dims"):
            raw[key] = tuple(raw[key])
        if isinstance(raw["use_pallas"], list):
            raw["use_pallas"] = tuple(raw["use_pallas"])
        if use_pallas is not None:
            raw["use_pallas"] = _use_pallas(use_pallas)
        model = CaptionModel(ModelConfig(**raw), device=args.device, seed=args.seed)
        payload = torch.load(os.path.join(args.checkpoint, STATE_FILE), map_location="cpu", weights_only=True)
        model.load_state_dict(payload["model"])
        return model
    if not args.checkpoint.endswith(".pth.tar"):
        raise ValueError(
            f"--checkpoint {args.checkpoint!r} is neither a checkpoint directory of the port's training "
            "(state.pt, meta.json) nor a reference .pth.tar (Orbax directories belong to the JAX package)"
        )
    decoder = args.decoder or ("lstm" if args.lstmDecoder else "transformer")
    cfg = ModelConfig(
        decoder=decoder, vocab_size=len(word_map), embedding_name=args.embeddingName,
        use_pallas=_use_pallas(use_pallas or "auto"),
    )
    model = CaptionModel(cfg, device=args.device, seed=args.seed)
    load_reference_checkpoint(model, args.checkpoint)
    return model


def caption_batch(
    model, images_u8: np.ndarray, word_map: Dict[str, int], beam_size: int
) -> List[Tuple[str, float, np.ndarray, np.ndarray]]:
    """Beam-search one group of uint8 (B, H, W, 3) images.  Returns per image
    (caption, score, token sequence, attention maps), both arrays cut to the
    caption's length."""
    from tpu_captioner_torch.infer.beam import beam_search_batch

    rev = {v: k for k, v in word_map.items()}
    # Decode cap: 50 like the reference (caption.py:147), bounded by the
    # positional-encoding table of small configs.
    max_steps = min(50, model.cfg.max_len - 2)
    res = beam_search_batch(
        model, torch.from_numpy(np.ascontiguousarray(images_u8)).to(model.device),
        beam_size=beam_size, max_steps=max_steps,
        start_id=word_map["<start>"], end_id=word_map["<end>"],
    )
    seqs, lengths = res.sequence.cpu().numpy(), res.length.cpu().numpy()
    scores, alphas = res.score.cpu().numpy(), res.alphas.cpu().numpy()
    out = []
    for j in range(images_u8.shape[0]):
        n = int(lengths[j])
        seq = seqs[j, :n]
        words = [rev[int(i)] for i in seq]
        caption = " ".join(w for w in words if w not in ("<start>", "<end>"))
        out.append((caption, float(scores[j]), seq, alphas[j, :n]))
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--img", "-i", required=True, help="image file or directory")
    p.add_argument("--checkpoint", "-m", required=True,
                   help="a checkpoint directory of the port's training (cli.train), or a reference .pth.tar")
    p.add_argument("--wordMap", "-wm", required=True)
    p.add_argument("--beamSize", "-b", type=int, default=5)
    p.add_argument("--dont_smooth", dest="smooth", action="store_false")
    p.add_argument("--decoder", type=str, default=None)
    p.add_argument("--lstmDecoder", action="store_true")
    p.add_argument("--embeddingName", type=str, default=None)
    p.add_argument("--out", type=str, default=None, help="attention grid PNG")
    p.add_argument("--csv", type=str, default=None,
                   help="write imageFile,generatedCaption rows here")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--usePallas", type=str, default=None,
                   help="ConvNeXt block kernels: auto|on|mlp|block|off, or one per stage joined by commas "
                        "(default: a checkpoint directory's own, else auto)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the initial weights (the checkpoint replaces them)")
    args = p.parse_args(argv)

    with open(args.wordMap) as f:
        word_map = json.load(f)
    model = build_model_and_params(args, word_map)
    paths = (
        [os.path.join(args.img, f) for f in sorted(os.listdir(args.img))]
        if os.path.isdir(args.img)
        else [args.img]
    )
    rows = []
    for s in range(0, len(paths), GROUP):
        chunk = paths[s : s + GROUP]
        images = np.stack([load_image(path) for path in chunk])
        for path, image, (caption, score, seq, alphas) in zip(
            chunk, images, caption_batch(model, images, word_map, args.beamSize)
        ):
            print(f"{os.path.basename(path)}: {caption}  (score {score:.3f})")
            rows.append({"imageFile": os.path.basename(path), "generatedCaption": caption})
            if args.out and len(paths) == 1:
                from tpu_captioner_torch.infer.visualize import visualize_att

                visualize_att(image, seq, alphas, {v: k for k, v in word_map.items()}, smooth=args.smooth,
                              enc_image_size=model.cfg.encoded_image_size, out_path=args.out)
    if args.csv:
        with open(args.csv, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=["imageFile", "generatedCaption"])
            writer.writeheader()
            writer.writerows(rows)


if __name__ == "__main__":
    main()
