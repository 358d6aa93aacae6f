"""tpu_captioner_torch — the PyTorch/CUDA port of ``tpu_captioner`` for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package beside it is the reference this port is held against.  This
package imports ``torch`` and numpy only, never JAX.  What is ported so far is
the serving path, ``python -m tpu_captioner_torch.cli.caption``:

- ``core``   — ``ModelConfig`` and a CUDA probe;
- ``models`` — ConvNeXt-Base encoder (NHWC), the eval pieces of the
               Transformer decoder, and the weight bridge from JAX params and
               reference ``.pth.tar`` checkpoints;
- ``ops``    — the two hand-written Hopper kernels of the path (fused ConvNeXt
               MLP tail, per-layer KV-cached decode step), each beside its
               plain PyTorch version;
- ``train``  — ``CaptionModel`` (encode + decoder choice; no training yet);
- ``infer``  — batched beam search;
- ``cli``    — the captioning CLI.
"""

__version__ = "0.1.0"
