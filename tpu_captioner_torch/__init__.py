"""tpu_captioner_torch — the PyTorch/CUDA port of ``tpu_captioner`` for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package beside it is the reference this port is held against.  This
package imports ``torch`` and numpy only, never JAX.  What is ported so far is
the serving path, ``python -m tpu_captioner_torch.cli.caption``, the
teacher-forced train step, ``train.steps.make_train_step``, with the encoder
frozen or fine-tuned from a starting child on, and the greedy eval step,
``train.steps.make_eval_step``:

- ``core``   — ``ModelConfig``, ``TrainConfig``, a CUDA probe, step seeds,
               the early-exit scan;
- ``models`` — ConvNeXt-Base encoder (NHWC, stochastic depth in training,
               remat and the fine-tune mask),
               the Transformer decoder (teacher forcing, the decode pieces
               and the greedy rollouts), and the weight bridge from JAX
               params and reference ``.pth.tar`` checkpoints;
- ``ops``    — the six hand-written Hopper kernels of those paths (fused
               ConvNeXt MLP tail forward and backward; the KV-cached decode
               step per layer or one launch per token, and the whole greedy
               rollout; dropout mask pool), each beside its plain PyTorch
               version;
- ``eval``   — token metrics, rollout masks and corpus BLEU;
- ``train``  — ``CaptionModel``, optimizers and ``TrainState``, the train and
               eval steps;
- ``infer``  — batched beam search;
- ``cli``    — the captioning CLI.
"""

__version__ = "0.1.0"
