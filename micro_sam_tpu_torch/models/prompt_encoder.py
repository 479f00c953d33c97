"""SAM prompt encoder.

Counterpart of ``micro_sam_tpu/models/prompt_encoder.py``: points (label -1
padding, 0 negative, 1 positive, 2 / 3 box corners) become sparse embeddings,
a low-resolution mask becomes the dense embedding (or ``no_mask_embed`` where
there is none).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from . import common as cm

NUM_POINT_EMBEDDINGS = 4


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.zeros(2, num_pos_feats))

    def init_(self, g: torch.Generator) -> None:
        self.positional_encoding_gaussian_matrix.normal_(generator=g)

    def encode(self, coords: torch.Tensor) -> torch.Tensor:
        """coords in [0, 1]^2, shape (..., 2) -> (..., 2 * num_pos_feats), f32."""
        c = (2 * coords.float() - 1) @ self.positional_encoding_gaussian_matrix.float()
        c = 2 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int = 256, image_embedding_size: Tuple[int, int] = (64, 64),
                 input_image_size: Tuple[int, int] = (1024, 1024), mask_in_chans: int = 16):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList(
            cm.Embedding(1, embed_dim) for _ in range(NUM_POINT_EMBEDDINGS))
        self.not_a_point_embed = cm.Embedding(1, embed_dim)
        self.no_mask_embed = cm.Embedding(1, embed_dim)
        self.mask_downscaling = nn.Sequential(
            cm.Conv2d(1, mask_in_chans // 4, 2, stride=2),
            cm.LayerNorm(mask_in_chans // 4),
            nn.GELU(),
            cm.Conv2d(mask_in_chans // 4, mask_in_chans, 2, stride=2),
            cm.LayerNorm(mask_in_chans),
            nn.GELU(),
            cm.Conv2d(mask_in_chans, embed_dim, 1),
        )

    def get_dense_pe(self) -> torch.Tensor:
        """Dense positional encoding over the embedding grid: (H, W, C) f32."""
        h, w = self.image_embedding_size
        dev = self.pe_layer.positional_encoding_gaussian_matrix.device
        gy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        gx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        yy, xx = torch.meshgrid(gy, gx, indexing="ij")
        return self.pe_layer.encode(torch.stack([xx, yy], dim=-1))

    def encode_points(self, points: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """points (B, P, 2) xy in input-image coords, labels (B, P) -> (B, P, C) f32."""
        size = torch.tensor([self.input_image_size[1], self.input_image_size[0]],
                            dtype=torch.float32, device=points.device)
        pe = self.pe_layer.encode((points.float() + 0.5) / size)
        lab = labels[..., None]
        emb = torch.where(lab == -1, self.not_a_point_embed.weight[0].float(), pe)
        for val in range(NUM_POINT_EMBEDDINGS):
            emb = emb + torch.where(lab == val, self.point_embeddings[val].weight[0].float(),
                                    torch.zeros((), device=emb.device))
        return emb

    def forward(self, points: torch.Tensor, labels: torch.Tensor,
                masks: Optional[torch.Tensor] = None,
                has_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (sparse (B, P, C), dense (B, 64, 64, C)); masks are
        (B, 256, 256, 1). ``has_mask`` (B,) picks, per prompt, the mask
        embedding or ``no_mask_embed``."""
        sparse = self.encode_points(points, labels)
        B = points.shape[0]
        h, w = self.image_embedding_size
        nme = self.no_mask_embed.weight[0].float().expand(B, h, w, -1)
        if masks is None:
            return sparse, nme
        dense = self.mask_downscaling(masks)
        if has_mask is not None:
            dense = torch.where(has_mask[:, None, None, None], dense, nme.to(dense.dtype))
        return sparse, dense
