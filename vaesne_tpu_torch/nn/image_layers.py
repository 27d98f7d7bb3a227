"""ViT-style transformer encoder and decoders for host-galaxy images.

Counterparts of ``vaesne_tpu/nn/image_layers.py``:

  * ``HostImgTransformerEncoder``: patch tokens + a 2-D sin-cos grid (and
    two event-location tokens under ``focal_loc``), pooled into bottleneck
    tokens by cross-attention;
  * ``HostImgTransformerDecoder``: one query per pixel on a fixed 2-D
    sin-cos grid;
  * ``HostImgTransformerDecoderHybrid``: one query per patch, a Dense to
    p·p·d features, the pixel-shuffle unfold to a d-channel image, then two
    ``same`` convolutions (d → 4d → C) with a ReLU between.

Images are NCHW throughout, where the JAX layers run NHWC inside: the
patch tokens, the unfold and the convolutions keep the JAX layers' element
order, so the outputs are the same numbers transposed. The decoders return
NCHW. The convolutions run on cuDNN in fp32 with its deterministic
algorithms (``layers.conv2d``). The hybrid
decoder's 900-token self-attention (a 60×60 image at patch 2) and the
per-pixel decoder's 3,600-token one reach the fused attention kernels
(``ops.dispatch.routes_to_kernel``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    MLP,
    PatchEmbedding,
    SingleLayerMLP,
    SinusoidalMLPEmbedding,
    TransformerStack,
    conv2d,
    sinusoidal_embedding_2d,
)


class HostImgTransformerEncoder(nn.Module):
    """Learned bottleneck tokens cross-attend to the patch tokens (plus the
    event location's two tokens under ``focal_loc``). Input NCHW
    [B, C, H, W]; ``event_loc`` [B, 2] or None (zeros). Returns
    [B, bottleneck_length, bottleneck_dim]."""

    def __init__(self, img_size: int, bottleneck_length: int, bottleneck_dim: int,
                 patch_size: int = 4, in_channels: int = 3, focal_loc: bool = False,
                 model_dim: int = 32, num_heads: int = 4, ff_dim: int = 32,
                 num_layers: int = 4, dropout: float = 0.1, selfattn: bool = False,
                 sincosin: bool = True):
        super().__init__()
        if img_size % patch_size != 0:
            raise ValueError("image size must be divisible by patch size")
        self.grid = img_size // patch_size
        self.model_dim = model_dim
        self.focal_loc = focal_loc
        self.sincosin = sincosin
        self.patch_embed = PatchEmbedding(patch_size, in_channels, model_dim)
        if not sincosin:
            self.pos_embed = nn.Parameter(torch.zeros(self.grid * self.grid, model_dim))
        if focal_loc:
            self.eventloc_embd = SinusoidalMLPEmbedding(model_dim)
        self.initbottleneck = nn.Parameter(torch.randn(bottleneck_length, model_dim))
        self.blocks = TransformerStack(model_dim, num_heads, ff_dim, num_layers,
                                       dropout, selfattn)
        self.bottleneckfc = SingleLayerMLP(model_dim, bottleneck_dim)

    def forward(self, image: torch.Tensor, event_loc: Optional[torch.Tensor] = None,
                seed: Optional[int] = None) -> torch.Tensor:
        tokens = self.patch_embed(image)
        if self.sincosin:
            pos = sinusoidal_embedding_2d(self.model_dim, self.grid, self.grid, image.device)
        else:
            pos = self.pos_embed
        context = tokens + pos[None]
        if self.focal_loc:
            if event_loc is None:
                event_loc = torch.zeros(image.shape[0], 2, dtype=image.dtype,
                                        device=image.device)
            context = torch.cat([context, self.eventloc_embd(event_loc)], dim=1)
        x = self.initbottleneck[None].expand(image.shape[0], -1, -1)
        h = self.blocks(x, context=context, seed=seed)
        return self.bottleneckfc(x + h)


class HostImgTransformerDecoder(nn.Module):
    """Per-pixel decoder: H·W queries on the fixed 2-D sin-cos grid
    cross-attend to the projected latent tokens; an MLP head (or a plain
    Dense under ``mlpdecoder=False``) gives the channels. Returns NCHW
    [B, C, H, W]."""

    def __init__(self, img_size: int, bottleneck_dim: int, in_channels: int = 3,
                 model_dim: int = 32, num_heads: int = 4, ff_dim: int = 32,
                 num_layers: int = 4, dropout: float = 0.1, selfattn: bool = False,
                 mlpdecoder: bool = True):
        super().__init__()
        self.img_size = img_size
        self.in_channels = in_channels
        self.model_dim = model_dim
        self.contextfc = MLP(bottleneck_dim, model_dim, (model_dim,))
        self.blocks = TransformerStack(model_dim, num_heads, ff_dim, num_layers,
                                       dropout, selfattn)
        if mlpdecoder:
            self.decoder = MLP(model_dim, in_channels, (model_dim,))
        else:
            self.decoder = nn.Linear(model_dim, in_channels)

    def forward(self, bottleneck: torch.Tensor, seed: Optional[int] = None) -> torch.Tensor:
        b, s = bottleneck.shape[0], self.img_size
        pos = sinusoidal_embedding_2d(self.model_dim, s, s, bottleneck.device)
        x = pos[None].expand(b, -1, -1)
        h = self.blocks(x, context=self.contextfc(bottleneck), seed=seed)
        h = self.decoder(h + x)  # [B, H·W, C]
        return h.reshape(b, s, s, self.in_channels).permute(0, 3, 1, 2)


class HostImgTransformerDecoderHybrid(nn.Module):
    """Hybrid decoder: g·g patch queries (g = img_size/patch_size) on the
    2-D sin-cos grid cross-attend to the projected latent tokens; a Dense
    gives p·p·d features per patch, unfolded to a d-channel image (pixel
    (gy·p + py, gx·p + px) takes patch (gy, gx)'s feature block (py, px)),
    then ``refine_0`` (d → 4d, p×p, same) → ReLU → ``refine_1`` (4d → C).
    Returns NCHW [B, C, H, W]."""

    def __init__(self, img_size: int, bottleneck_dim: int, patch_size: int = 4,
                 in_channels: int = 3, model_dim: int = 64, num_heads: int = 4,
                 ff_dim: int = 128, num_layers: int = 4, dropout: float = 0.1,
                 selfattn: bool = False):
        super().__init__()
        if img_size % patch_size != 0:
            raise ValueError("patch_size must divide img_size")
        self.grid, self.patch_size, self.model_dim = img_size // patch_size, patch_size, model_dim
        d, p = model_dim, patch_size
        self.contextfc = MLP(bottleneck_dim, d, (d,))
        self.blocks = TransformerStack(d, num_heads, ff_dim, num_layers, dropout, selfattn)
        self.decoder = nn.Linear(d, d * p * p)
        self.refine_0 = nn.Conv2d(d, 4 * d, p)
        self.refine_1 = nn.Conv2d(4 * d, in_channels, p)
        # lax's SAME padding of a p×p kernel: (p−1)//2 before, the rest after
        lo = (p - 1) // 2
        self.same = (lo, p - 1 - lo) * 2

    def forward(self, bottleneck: torch.Tensor, seed: Optional[int] = None) -> torch.Tensor:
        b, g, p, d = bottleneck.shape[0], self.grid, self.patch_size, self.model_dim
        pos = sinusoidal_embedding_2d(d, g, g, bottleneck.device)
        x = pos[None].expand(b, -1, -1)
        h = self.blocks(x, context=self.contextfc(bottleneck), seed=seed)
        h = self.decoder(h + x)  # [B, g·g, p·p·d]
        # [B, gy, gx, py, px, d] → [B, d, gy, py, gx, px] → [B, d, g·p, g·p]
        h = h.reshape(b, g, g, p, p, d).permute(0, 5, 1, 3, 2, 4).reshape(b, d, g * p, g * p)
        h = F.relu(conv2d(F.pad(h, self.same), self.refine_0))
        return conv2d(F.pad(h, self.same), self.refine_1)
