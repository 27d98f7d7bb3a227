"""Neural building blocks of the port (torch.nn)."""

from .layers import (
    LN_EPS,
    MLP,
    MultiHeadAttention,
    SingleLayerMLP,
    SinusoidalEmbedding,
    SinusoidalMLPEmbedding,
    TransformerBlock,
    TransformerStack,
)
from .photometric_layers import PhotometricTransformerDecoder, PhotometricTransformerEncoder
from .spectra_layers import SpectraTransformerDecoder, SpectraTransformerEncoder

__all__ = [
    "LN_EPS", "MLP", "MultiHeadAttention", "PhotometricTransformerDecoder",
    "PhotometricTransformerEncoder", "SingleLayerMLP", "SinusoidalEmbedding",
    "SinusoidalMLPEmbedding", "SpectraTransformerDecoder", "SpectraTransformerEncoder",
    "TransformerBlock", "TransformerStack",
]
