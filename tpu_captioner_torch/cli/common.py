"""Shared CLI plumbing (counterpart of ``tpu_captioner/cli/common.py``): the
reference's argparse surface (train.py:59-79, trainMultiGPU.py:63-87,
test.py:63-81) mapped onto ``ExperimentConfig``, with the JAX package's
flags and ``config_from_args``, plus ``--device`` (default ``cuda``: the
card, unless the caller asks for the CPU)."""

from __future__ import annotations

import argparse

from tpu_captioner_torch.core.config import ExperimentConfig, ModelConfig, TrainConfig


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataFolder", type=str, default="inputFiles", help="folder with built input records")
    p.add_argument("--dataName", type=str, default="coco_5_cap_per_img_5_min_word_freq",
                   help="base name of processed dataset")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint directory to resume or load (cli.test also takes a reference .pth.tar)")
    p.add_argument("--decoder", type=str, default=None,
                   choices=["lstm", "lstm_no_attention", "transformer", "transformer_attvis"],
                   help="decoder family (overrides --lstmDecoder)")
    p.add_argument("--lstmDecoder", action="store_true",
                   help="use the LSTM+attention decoder instead of Transformer")
    p.add_argument("--startingLayer", type=int, default=5,
                   help="first ConvNeXt child index unlocked when fine-tuning")
    p.add_argument("--encoderLr", type=float, default=1e-4, help="encoder learning rate when fine-tuning")
    p.add_argument("--embeddingName", type=str, default=None,
                   help="pretrained embedding preset (word2vec-google-news-300 | glove-wiki-gigaword-200)")
    p.add_argument("--pretrainedEncoder", type=str, default=None,
                   help="init the ConvNeXt backbone from a torchvision convnext_base state dict "
                        "(.pth/.pth.tar) or its .npz (build_data port-backbone); the reference always "
                        "trains from IMAGENET1K_V1")
    p.add_argument("--batchSize", type=int, default=32)
    p.add_argument("--numDevices", type=int, default=0,
                   help="cards to train on (0 = every visible card; more than one is not ported yet)")
    p.add_argument("--computeDtype", type=str, default="float32", choices=["float32", "bfloat16"])
    # Reduced-model overrides (default: the reference's ConvNeXt-Base and
    # 6-layer Transformer).
    p.add_argument("--embedDim", type=int, default=None)
    p.add_argument("--attentionDim", type=int, default=None,
                   help="LSTM additive-attention width (reference train.py:40)")
    p.add_argument("--decoderDim", type=int, default=None)
    p.add_argument("--numLayers", type=int, default=None)
    p.add_argument("--numHeads", type=int, default=None)
    p.add_argument("--maxLen", type=int, default=None)
    p.add_argument("--imageSize", type=int, default=None,
                   help="the JAX CLI's init shape; the port's modules need none, so it is accepted and unused")
    p.add_argument("--encoderDepths", type=str, default=None, help="comma ints, e.g. 1,1,2,1")
    p.add_argument("--encoderDims", type=str, default=None,
                   help="comma ints, e.g. 16,24,32,48 (last = encoder_dim)")
    p.add_argument("--encodedImageSize", type=int, default=None,
                   help="adaptive-pool target (reference encoder.py:15 = 7)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (the card) or cpu")


def config_from_args(args) -> ExperimentConfig:
    decoder = args.decoder or ("lstm" if args.lstmDecoder else "transformer")
    model_kw = {}
    for arg, name in (
        ("embedDim", "embed_dim"), ("decoderDim", "decoder_dim"), ("attentionDim", "attention_dim"),
        ("numLayers", "num_layers"), ("numHeads", "num_heads"), ("maxLen", "max_len"),
        ("encodedImageSize", "encoded_image_size"),
    ):
        v = getattr(args, arg, None)
        if v is not None:
            model_kw[name] = v
    if getattr(args, "encoderDepths", None):
        model_kw["encoder_depths"] = tuple(int(x) for x in args.encoderDepths.split(","))
    if getattr(args, "encoderDims", None):
        dims = tuple(int(x) for x in args.encoderDims.split(","))
        model_kw["encoder_dims"] = dims
        model_kw["encoder_dim"] = dims[-1]
    model = ModelConfig(
        decoder=decoder,
        embedding_name=args.embeddingName,
        compute_dtype=args.computeDtype,
        pretrained_encoder=getattr(args, "pretrainedEncoder", None),
        **model_kw,
    )
    train_kw = {}
    if getattr(args, "maxLen", None) is not None:
        # maxDecodeLen follows the padded caption length (reference: 51 for
        # an encoded length of 52, train.py:44, test.py:171).
        train_kw["max_decode_len"] = args.maxLen - 1
    train = TrainConfig(
        batch_size=args.batchSize,
        starting_layer=args.startingLayer,
        encoder_lr=args.encoderLr,
        checkpoint=args.checkpoint,
        teacher_forcing=getattr(args, "teacherForcing", True),
        epochs=getattr(args, "epochs", 120),
        **train_kw,
    )
    return ExperimentConfig(model=model, train=train, num_devices=args.numDevices)
