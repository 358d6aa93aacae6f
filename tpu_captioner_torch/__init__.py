"""tpu_captioner_torch — the PyTorch/CUDA port of ``tpu_captioner`` for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package beside it is the reference this port is held against.  This
package imports ``torch`` and numpy only, never JAX.  What is ported so far is
the serving path, ``python -m tpu_captioner_torch.cli.caption``, and the
teacher-forced train step, ``train.steps.make_train_step``, with the encoder
frozen or fine-tuned from a starting child on:

- ``core``   — ``ModelConfig``, ``TrainConfig``, a CUDA probe, step seeds;
- ``models`` — ConvNeXt-Base encoder (NHWC, stochastic depth in training,
               remat and the fine-tune mask),
               the Transformer decoder (teacher forcing and the decode
               pieces), and the weight bridge from JAX params and reference
               ``.pth.tar`` checkpoints;
- ``ops``    — the four hand-written Hopper kernels of those paths (fused
               ConvNeXt MLP tail forward and backward, per-layer KV-cached
               decode step, dropout mask pool), each beside its plain
               PyTorch version;
- ``eval``   — the train step's token metrics;
- ``train``  — ``CaptionModel``, optimizers and ``TrainState``, the train step;
- ``infer``  — batched beam search;
- ``cli``    — the captioning CLI.
"""

__version__ = "0.1.0"
