"""Neural building blocks of the port (torch.nn)."""

from .layers import (
    LN_EPS,
    MLP,
    MultiHeadAttention,
    PatchEmbedding,
    SingleLayerMLP,
    SinusoidalEmbedding,
    SinusoidalMLPEmbedding,
    TransformerBlock,
    TransformerStack,
    sinusoidal_embedding_2d,
)
from .image_layers import (
    HostImgTransformerDecoder,
    HostImgTransformerDecoderHybrid,
    HostImgTransformerEncoder,
)
from .photometric_layers import PhotometricTransformerDecoder, PhotometricTransformerEncoder
from .spectra_layers import SpectraTransformerDecoder, SpectraTransformerEncoder

__all__ = [
    "HostImgTransformerDecoder", "HostImgTransformerDecoderHybrid", "HostImgTransformerEncoder",
    "LN_EPS", "MLP", "MultiHeadAttention", "PatchEmbedding", "PhotometricTransformerDecoder",
    "PhotometricTransformerEncoder", "SingleLayerMLP", "SinusoidalEmbedding",
    "SinusoidalMLPEmbedding", "SpectraTransformerDecoder", "SpectraTransformerEncoder",
    "TransformerBlock", "TransformerStack", "sinusoidal_embedding_2d",
]
