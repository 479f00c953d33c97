"""SAM mask decoder: two-way transformer, upscaler, hypernetworks, IoU head.

Counterpart of ``micro_sam_tpu/models/mask_decoder.py``, in plain PyTorch: the
decoder has no TPU kernel. The math is ported as upstream SAM writes it
(per-head attention, ``linear(x + pe)``); the JAX package's folded cross
attention and positional-encoding fold are exact rewrites for the TPU's matrix
unit and agree with it within float rounding.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from . import common as cm
from ..ops.attention import attention

NUM_MASK_TOKENS = 4


class Attention(nn.Module):
    """Attention with optional down-projection of the internal width."""

    def __init__(self, dim: int, num_heads: int, downsample_rate: int = 1):
        super().__init__()
        internal = dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = cm.Linear(dim, internal)
        self.k_proj = cm.Linear(dim, internal)
        self.v_proj = cm.Linear(dim, internal)
        self.out_proj = cm.Linear(internal, dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        B, Nq, C = q.shape
        nh = self.num_heads
        out = attention(q.reshape(B, Nq, nh, C // nh), k.reshape(B, -1, nh, C // nh),
                        v.reshape(B, -1, nh, C // nh))
        return self.out_proj(out.reshape(B, Nq, C))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int, skip_first_layer_pe: bool,
                 downsample_rate: int = 2):
        super().__init__()
        self.self_attn = Attention(dim, num_heads)
        self.norm1 = cm.LayerNorm(dim, eps=1e-5)
        self.cross_attn_token_to_image = Attention(dim, num_heads, downsample_rate)
        self.norm2 = cm.LayerNorm(dim, eps=1e-5)
        self.mlp = cm.MLPBlock(dim, mlp_dim)
        self.norm3 = cm.LayerNorm(dim, eps=1e-5)
        self.cross_attn_image_to_token = Attention(dim, num_heads, downsample_rate)
        self.norm4 = cm.LayerNorm(dim, eps=1e-5)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)

        q = queries + query_pe
        k = keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))

        queries = self.norm3(queries + self.mlp(queries))

        q = queries + query_pe
        k = keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int = 2, dim: int = 256, num_heads: int = 8, mlp_dim: int = 2048):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(dim, num_heads, mlp_dim, skip_first_layer_pe=(i == 0))
            for i in range(depth))
        self.final_attn_token_to_image = Attention(dim, num_heads, 2)
        self.norm_final_attn = cm.LayerNorm(dim, eps=1e-5)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding (B, H, W, C), image_pe (1, H, W, C), points (B, T, C)."""
        B, H, W, C = image_embedding.shape
        keys = image_embedding.reshape(B, H * W, C)
        key_pe = image_pe.reshape(-1, H * W, C).to(keys.dtype)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q = queries + point_embedding
        k = keys + key_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MaskDecoder(nn.Module):
    def __init__(self, dim: int = 256, num_heads: int = 8, mlp_dim: int = 2048,
                 iou_head_depth: int = 3, iou_head_hidden: int = 256):
        super().__init__()
        self.transformer = TwoWayTransformer(2, dim, num_heads, mlp_dim)
        self.iou_token = cm.Embedding(1, dim)
        self.mask_tokens = cm.Embedding(NUM_MASK_TOKENS, dim)
        self.output_upscaling = nn.Sequential(
            cm.ConvTranspose2d(dim, dim // 4, 2, stride=2),
            cm.LayerNorm(dim // 4),
            nn.GELU(),
            cm.ConvTranspose2d(dim // 4, dim // 8, 2, stride=2),
            nn.GELU(),
        )
        self.output_hypernetworks_mlps = nn.ModuleList(
            cm.MLP(dim, dim, dim // 8, 3) for _ in range(NUM_MASK_TOKENS))
        self.iou_prediction_head = cm.MLP(dim, iou_head_hidden, NUM_MASK_TOKENS, iou_head_depth)

    def forward(self, image_embeddings: torch.Tensor, image_pe: torch.Tensor,
                sparse_prompt: torch.Tensor, dense_prompt: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """All 4 masks and IoU scores: ((B, 4, 256, 256) f32, (B, 4) f32).
        The caller selects the multimask outputs."""
        B = sparse_prompt.shape[0]
        dt = image_embeddings.dtype
        output_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], 0).to(dt)
        tokens = torch.cat([output_tokens.expand(B, -1, -1), sparse_prompt.to(dt)], dim=1)
        src = image_embeddings.expand(B, -1, -1, -1) + dense_prompt.to(dt)
        if image_pe.dim() == 3:
            image_pe = image_pe[None]
        hs, src_out = self.transformer(src, image_pe, tokens)
        iou_token_out = hs[:, 0]
        mask_tokens_out = hs[:, 1:1 + NUM_MASK_TOKENS]

        H, W = image_embeddings.shape[1], image_embeddings.shape[2]
        up = self.output_upscaling(src_out.reshape(B, H, W, -1))  # (B, 4H, 4W, C/8)
        hyper_in = torch.stack([self.output_hypernetworks_mlps[i](mask_tokens_out[:, i])
                                for i in range(NUM_MASK_TOKENS)], dim=1)
        masks = torch.einsum("bnc,bhwc->bnhw", hyper_in.float(), up.float())
        iou_pred = self.iou_prediction_head(iou_token_out.float())
        return masks, iou_pred
