"""tpu_captioner_torch — the PyTorch/CUDA port of ``tpu_captioner`` for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package beside it is the reference this port is held against.  This
package imports ``torch`` and numpy only, never JAX.  Ported so far: serving,
``python -m tpu_captioner_torch.cli.caption``; training, ``cli.build_data``
-> ``cli.train`` (the ``Trainer``: teacher-forced, free-running and
scheduled-sampling steps, the encoder unlock, LR decay, early stop,
checkpoints and resume) -> ``cli.test``; for the four decoder families:

- ``core``   — the configs, a CUDA probe, step seeds, the early-exit scan;
- ``data``   — word maps, the record writers (synthetic, Karpathy, reference
               HDF5), the dataset and the one-card prefetching loader;
- ``models`` — ConvNeXt-Base encoder (NHWC, stochastic depth in training,
               remat and the fine-tune mask), the Transformer and LSTM
               decoders (teacher forcing, the decode pieces, the greedy
               rollouts, the free-running rollouts with dropout), word
               embeddings, and the weight bridge from JAX params and
               reference ``.pth.tar`` checkpoints;
- ``ops``    — the hand-written Hopper kernels of those paths, each beside
               its plain PyTorch version;
- ``eval``   — token metrics, the meter, rollout masks and corpus BLEU;
- ``native`` — the host runtime in C++ (corpus BLEU's counts, the batch
               gather), built with g++ on first use;
- ``train``  — ``CaptionModel``, optimizers and ``TrainState``, the train and
               eval steps, checkpoints and the ``Trainer``;
- ``infer``  — batched beam search and the attention grid;
- ``cli``    — ``caption``, ``build_data``, ``train``, ``test`` and ``graphs``.
"""

__version__ = "0.1.0"
