"""Model configuration (counterpart of ``tpu_captioner/core/config.py``).

``ModelConfig`` keeps the JAX package's fields, defaults and word2vec head
rule, so a config serialised by one package builds the same model in the
other.  The TPU switches become kernel selectors: ``use_pallas`` picks the
fused ConvNeXt MLP kernel and ``decode_kernel`` the fused decode step.
``'auto'`` and ``'on'`` launch the kernel for CUDA tensors and take the plain
PyTorch version for CPU tensors; ``'off'`` takes the plain version everywhere.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# Embedding-name -> (embed_dim, default artifact path), as in the JAX package
# (reference train.py:74-79).
EMBEDDING_PRESETS = {
    "word2vec-google-news-300": (300, "wordEmbeddings/word2vec-google-news-300.npz"),
    "glove-wiki-gigaword-200": (200, "wordEmbeddings/glove-wiki-gigaword-200.npz"),
}

DECODER_TYPES = ("lstm", "lstm_no_attention", "transformer", "transformer_attvis")
KERNEL_MODES = ("auto", "on", "off")


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
    use_pallas: str = "auto"  # fused ConvNeXt MLP kernel: 'auto' | 'on' | 'off'
    decode_kernel: str = "auto"  # fused decode-step kernel: 'auto' | 'on' | 'off'
    # Training-only switches of the JAX config, kept so configs round-trip.
    encoder_remat: str = "auto"
    dropout_masks: str = "auto"

    def __post_init__(self):
        if self.decoder not in DECODER_TYPES:
            raise ValueError(f"decoder must be one of {DECODER_TYPES}, got {self.decoder!r}")
        for name in ("use_pallas", "decode_kernel"):
            if getattr(self, name) not in KERNEL_MODES:
                raise ValueError(
                    f"{name} must be one of {KERNEL_MODES}, got {getattr(self, name)!r}"
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
