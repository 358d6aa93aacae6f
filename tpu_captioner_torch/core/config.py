"""Model configuration (counterpart of ``tpu_captioner/core/config.py``).

``ModelConfig`` keeps the JAX package's fields, defaults and word2vec head
rule, so a config serialised by one package builds the same model in the
other.  The TPU switches become kernel selectors: ``use_pallas`` picks the
ConvNeXt block kernels and ``decode_kernel`` the fused decode kernels.

``use_pallas`` takes what the JAX package's ``CaptionModel`` resolves
(tpu_captioner/train/model.py:82-99): one mode for every stage, or a tuple or
list with one mode per stage.  ``stage_kernel_modes`` resolves it:
- ``'auto'``, ``'on'``, ``'mlp'`` and ``True``: ``'mlp'``, the fused MLP-tail
  kernels (``ops/mlp_block.py``) and the depthwise-conv kernels
  (``ops/dwconv.py``).  ``'auto'`` is the JAX package's choice on its own chip;
- ``'block'``: the whole block in one kernel (``ops/block_fused.py``);
- ``'off'`` and ``False``: the plain PyTorch block.
A kernel mode launches the kernels for CUDA tensors and takes their plain
versions for CPU tensors; ``'off'`` takes the plain block everywhere.
``decode_kernel`` also takes the JAX package's ``'step'`` (the per-token
kernel, as ``'on'``) and ``'mega'`` (the whole greedy rollout in one launch);
``train/model.py:decode_kernel_mode`` resolves it.

``dropout_masks`` picks how a train step draws its decoder dropout masks:
``'auto'`` and ``'pool'`` take one pooled draw per step
(``ops/dropout_mask.py``: the kernel for CUDA, the plain version for the
CPU); ``'threefry'`` draws each site with ``torch.bernoulli`` from the
step's generator.  Threefry's own bits, which the JAX package draws there,
cannot be reproduced in PyTorch; only the distribution is the same.

``TrainConfig`` keeps the JAX package's training knobs and defaults;
``ExperimentConfig`` joins it to the model's and the number of cards.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

# Embedding-name -> (embed_dim, default artifact path), as in the JAX package
# (reference train.py:74-79).
EMBEDDING_PRESETS = {
    "word2vec-google-news-300": (300, "wordEmbeddings/word2vec-google-news-300.npz"),
    "glove-wiki-gigaword-200": (200, "wordEmbeddings/glove-wiki-gigaword-200.npz"),
}

LSTM_DECODERS = ("lstm", "lstm_no_attention")
DECODER_TYPES = (*LSTM_DECODERS, "transformer", "transformer_attvis")
KERNEL_MODES = ("auto", "on", "mlp", "block", "off")  # and True / False, as in the JAX package
STAGE_MODES = ("mlp", "block", "off")  # what each stage resolves to
DECODE_KERNEL_MODES = ("auto", "on", "step", "mega", "off")
DROPOUT_MASK_MODES = ("auto", "pool", "threefry")
ENCODER_REMAT_MODES = ("auto", "on", "off", "save_mlp_in")


def _stage_mode(mode) -> str:
    if mode is True or (isinstance(mode, str) and mode in ("auto", "on", "mlp")):
        return "mlp"
    if mode is False or mode == "off":
        return "off"
    if mode == "block":
        return "block"
    raise ValueError(
        f"use_pallas must be one of {KERNEL_MODES}, True, False, or a tuple of these with one per "
        f"stage; got {mode!r}"
    )


def stage_kernel_modes(use_pallas, n_stages: int) -> Tuple[str, ...]:
    """``use_pallas`` resolved to one of ``STAGE_MODES`` per ConvNeXt stage;
    raises a ``ValueError`` for any other value or a tuple of another length."""
    if isinstance(use_pallas, (tuple, list)):
        if len(use_pallas) != n_stages:
            raise ValueError(f"use_pallas needs one mode per stage ({n_stages}), got {use_pallas!r}")
        return tuple(_stage_mode(m) for m in use_pallas)
    return (_stage_mode(use_pallas),) * n_stages


@dataclass
class ModelConfig:
    """Model hyperparameters (reference train.py:38-44 plus per-decoder
    constructor defaults)."""

    decoder: str = "transformer"  # one of DECODER_TYPES
    vocab_size: int = 0  # filled from the word map
    embed_dim: int = 512
    attention_dim: int = 512  # LSTM additive-attention width
    decoder_dim: int = 512  # LSTM hidden size / transformer FFN width
    dropout: float = 0.5
    encoder_dim: int = 1024  # ConvNeXt-Base final channels
    encoded_image_size: int = 7  # adaptive-pool target
    encoder_depths: tuple = (3, 3, 27, 3)
    encoder_dims: tuple = (128, 256, 512, 1024)
    num_heads: int = 8  # forced to 6 for 300-dim word2vec
    num_layers: int = 6
    max_len: int = 52  # padded caption length
    embedding_name: Optional[str] = None  # key into EMBEDDING_PRESETS
    embedding_path: Optional[str] = None
    pretrained_encoder: Optional[str] = None
    fine_tune_embeddings: bool = True

    # Only 'float32' is ported; 'bfloat16' raises in CaptionModel.
    compute_dtype: str = "float32"
    use_pallas: Any = "auto"  # one of KERNEL_MODES, or one per stage (stage_kernel_modes)
    decode_kernel: str = "auto"  # one of DECODE_KERNEL_MODES
    # What the fine-tune step's trainable stages keep for the backward: one
    # of ENCODER_REMAT_MODES ('auto' resolves in train/model.py).
    encoder_remat: str = "auto"
    dropout_masks: str = "auto"  # one of DROPOUT_MASK_MODES

    def __post_init__(self):
        if self.decoder not in DECODER_TYPES:
            raise ValueError(f"decoder must be one of {DECODER_TYPES}, got {self.decoder!r}")
        stage_kernel_modes(self.use_pallas, len(self.encoder_depths))
        if self.decode_kernel not in DECODE_KERNEL_MODES:
            raise ValueError(f"decode_kernel must be one of {DECODE_KERNEL_MODES}, got {self.decode_kernel!r}")
        if self.dropout_masks not in DROPOUT_MASK_MODES:
            raise ValueError(
                f"dropout_masks must be one of {DROPOUT_MASK_MODES}, got {self.dropout_masks!r}"
            )
        if self.encoder_remat not in ENCODER_REMAT_MODES:
            raise ValueError(
                f"encoder_remat must be one of {ENCODER_REMAT_MODES}, got {self.encoder_remat!r}"
            )
        if self.embedding_name is not None and self.embedding_name in EMBEDDING_PRESETS:
            dim, path = EMBEDDING_PRESETS[self.embedding_name]
            self.embed_dim = dim
            if self.embedding_path is None:
                self.embedding_path = path
            # 300 % 8 != 0, so word2vec runs with 6 heads (transformerDecoder.py:62-64).
            if self.embedding_name == "word2vec-google-news-300":
                self.num_heads = 6

    @property
    def num_pixels(self) -> int:
        return self.encoded_image_size * self.encoded_image_size


@dataclass
class TrainConfig:
    """Training-loop knobs (reference train.py:46-58, trainMultiGPU.py:50-61),
    with the JAX package's defaults."""

    epochs: int = 120
    batch_size: int = 32
    decoder_lr: float = 1e-4
    encoder_lr: float = 1e-4
    grad_clip: float = 5.0  # elementwise clamp, not a norm clip (utils/utils.py:183-192)
    alpha_c: float = 1.0  # doubly stochastic attention regulariser (train.py:55)
    attvis_regularization: bool = False  # the regulariser on transformer_attvis maps too
    teacher_forcing: bool = True
    scheduled_sampling_prob: float = 0.0  # free-running training only
    max_decode_len: int = 51  # free-running rollout cap (train.py:329)
    fine_tune_epoch: int = 20  # encoder unlock epoch (train.py:161)
    starting_layer: int = 5  # first trainable ConvNeXt child (train.py:63)
    fine_tune_encoder: bool = False  # pre-unlock state (train.py:58)
    lr_decay_factor: float = 0.8  # adjust_learning_rate shrink (train.py:172)
    lr_decay_every: int = 8  # stagnant epochs between decays (train.py:171)
    early_stop_patience: int = 20
    seed: int = 42
    print_freq: int = 100
    checkpoint: Optional[str] = None  # resume path
    results_dir: str = "results"
    checkpoint_dir: str = "checkpoints"


@dataclass
class ExperimentConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    num_devices: int = 0  # cards to train on; 0 = every visible card
