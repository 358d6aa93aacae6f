"""CLI: build input records from a Karpathy split, convert reference HDF5
records, generate a synthetic dataset, or extract pretrained embeddings
(counterpart of ``tpu_captioner/cli/build_data.py``; reference
createInputFiles.py).

    python -m tpu_captioner_torch.cli.build_data build --dataset coco \
        --karpathyJson dataset_coco.json --imageFolder images/ \
        --outputFolder inputFiles --capsPerImg 5 --minWordFreq 5 --maxLen 50
    python -m tpu_captioner_torch.cli.build_data convert --dataFolder ref/ \
        --dataName coco_5_cap_per_img_5_min_word_freq --outputFolder inputFiles
    python -m tpu_captioner_torch.cli.build_data synthetic --outputFolder tmp/
    python -m tpu_captioner_torch.cli.build_data embeddings --raw glove.txt \
        --wordMap inputFiles/WORDMAP_....json --embedDim 200 --out glove.npz

    python -m tpu_captioner_torch.cli.build_data port-backbone \
        --src convnext_base.pth --out convnext_base.npz

``build`` needs PIL and ``convert`` h5py; ``synthetic`` needs neither.
``port-backbone`` writes a torchvision ``convnext_base`` checkpoint's state
dict as an ``.npz`` of numpy arrays, which ``--pretrainedEncoder`` takes as
it takes the checkpoint.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build")
    b.add_argument("--dataset", default="coco", choices=["coco", "flickr8k", "flickr30k"])
    b.add_argument("--karpathyJson", required=True)
    b.add_argument("--imageFolder", required=True)
    b.add_argument("--outputFolder", default="inputFiles")
    b.add_argument("--capsPerImg", type=int, default=5)
    b.add_argument("--minWordFreq", type=int, default=5)
    b.add_argument("--maxLen", type=int, default=50)

    c = sub.add_parser("convert")
    c.add_argument("--dataFolder", required=True)
    c.add_argument("--dataName", required=True)
    c.add_argument("--outputFolder", default="inputFiles")

    s = sub.add_parser("synthetic")
    s.add_argument("--outputFolder", required=True)
    s.add_argument("--maxLen", type=int, default=50)
    s.add_argument("--imageSize", type=int, default=256)
    s.add_argument("--trainImages", type=int, default=32)
    s.add_argument("--valImages", type=int, default=8)
    s.add_argument("--testImages", type=int, default=8)
    s.add_argument("--learnable", action="store_true",
                   help="class-coded images with content-derived captions (val BLEU can reach ~1.0)")
    s.add_argument("--numClasses", type=int, default=16)

    pb = sub.add_parser("port-backbone", help="torchvision convnext .pth -> .npz")
    pb.add_argument("--src", required=True)
    pb.add_argument("--out", required=True)

    e = sub.add_parser("embeddings")
    e.add_argument("--raw", required=True, help="GloVe text / word2vec binary (.gz ok)")
    e.add_argument("--wordMap", required=True)
    e.add_argument("--embedDim", type=int, required=True)
    e.add_argument("--out", required=True, help="output .npz")

    args = p.parse_args(argv)
    if args.cmd == "build":
        from tpu_captioner_torch.data.build import create_input_files

        create_input_files(args.dataset, args.karpathyJson, args.imageFolder, args.capsPerImg,
                           args.minWordFreq, args.outputFolder, args.maxLen)
    elif args.cmd == "convert":
        from tpu_captioner_torch.data.build import convert_reference_artifacts

        convert_reference_artifacts(args.dataFolder, args.dataName, args.outputFolder)
    elif args.cmd == "synthetic":
        from tpu_captioner_torch.data.build import build_synthetic_dataset

        build_synthetic_dataset(
            args.outputFolder, max_len=args.maxLen, image_size=args.imageSize,
            num_images={"TRAIN": args.trainImages, "VAL": args.valImages, "TEST": args.testImages},
            learnable=args.learnable, n_classes=args.numClasses,
        )
    elif args.cmd == "port-backbone":
        from tpu_captioner_torch.train.loop import convert_backbone_to_npz

        convert_backbone_to_npz(args.src, args.out)
    elif args.cmd == "embeddings":
        from tpu_captioner_torch.models.embeddings import extract_embeddings_npz

        with open(args.wordMap) as f:
            word_map = json.load(f)
        extract_embeddings_npz(args.raw, word_map, args.embedDim, args.out)


if __name__ == "__main__":
    main()
