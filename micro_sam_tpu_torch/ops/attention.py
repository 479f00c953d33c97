"""Attention cores for the SAM encoder and the mask decoder.

Semantics follow the reference encoder's decomposed relative-position
attention: the rel-pos terms use the *unscaled* query, the logits use
q * head_dim**-0.5.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .flash_attention import flash_attention_qkv, flash_attention_rel_pos
from .relpos_attention import relpos_attention_plain


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain softmax attention. q, k, v: (..., N, nH, hd) -> (..., N, nH, hd)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("...qhd,...khd->...hqk", (q * scale).float(), k.float())
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("...hqk,...khd->...qhd", w.float(), v.float()).to(v.dtype)


def _einsum_attention_rel_pos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              hw: Tuple[int, int], rel_h: Optional[torch.Tensor],
                              rel_w: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain rel-pos attention in the (B, N, nH, hd) layout; missing
    tables act as zeros."""
    H, W = hw
    hd = q.shape[-1]
    if rel_h is None:
        rel_h = q.new_zeros((H, H, hd))
        rel_w = q.new_zeros((W, W, hd))
    t = lambda a: a.transpose(1, 2)
    out = relpos_attention_plain(t(q), t(k), t(v), rel_h.to(q.dtype), rel_w.to(q.dtype), hw)
    return t(out)


def attention_qkv_with_rel_pos(qkv: torch.Tensor, hw: Tuple[int, int],
                               rel_h: Optional[torch.Tensor] = None,
                               rel_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused-qkv entry: (B, 3, nH, N, hd) -> (B, nH, N, hd) through the rel-pos
    flash attention kernel (its plain version for a CPU tensor)."""
    return flash_attention_qkv(qkv, hw, rel_h, rel_w, qkv.shape[2])


def attention_with_rel_pos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           hw: Tuple[int, int], rel_h: Optional[torch.Tensor] = None,
                           rel_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention over an (H, W) token grid with the decomposed rel-pos
    bias: q, k, v (B, N, nH, hd) with N == H * W -> (B, N, nH, hd), through
    ``flash_attention_rel_pos`` (the kernels; their plain versions for CPU
    tensors). Counterpart of ``micro_sam_tpu.ops.attention_with_rel_pos``. On
    the card the forward takes every head dim up to 256
    (``relpos_attention.MAX_HEAD_DIM``), its backward up to 128; each raises
    above."""
    return flash_attention_rel_pos(q, k, v, hw, rel_h, rel_w)
