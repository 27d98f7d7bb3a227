"""Neural building blocks of the port (torch.nn)."""

from .layers import (
    LN_EPS,
    LayerNorm,
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
from .extras import (
    GumbelSoftmax,
    LearnableFourierEncoding,
    RelativeMultiHeadAttention,
    RelativePosition,
    TransformerModel,
    flatten,
    reshape,
)
from .image_layers import (
    HostImgTransformerDecoder,
    HostImgTransformerDecoderHybrid,
    HostImgTransformerEncoder,
)
from .photometric_layers import PhotometricTransformerDecoder, PhotometricTransformerEncoder
from .spectra_layers import SpectraTransformerDecoder, SpectraTransformerEncoder

__all__ = [
    "GumbelSoftmax", "HostImgTransformerDecoder", "HostImgTransformerDecoderHybrid",
    "HostImgTransformerEncoder", "LN_EPS", "LayerNorm", "LearnableFourierEncoding", "MLP",
    "MultiHeadAttention", "PatchEmbedding", "PhotometricTransformerDecoder",
    "PhotometricTransformerEncoder", "RelativeMultiHeadAttention", "RelativePosition",
    "SingleLayerMLP", "SinusoidalEmbedding", "SinusoidalMLPEmbedding",
    "SpectraTransformerDecoder", "SpectraTransformerEncoder", "TransformerBlock",
    "TransformerModel", "TransformerStack", "flatten", "reshape", "sinusoidal_embedding_2d",
]
