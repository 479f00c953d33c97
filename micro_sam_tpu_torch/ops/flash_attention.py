"""Rel-pos flash attention over a fused qkv tensor.

Counterpart of ``micro_sam_tpu/ops/flash_attention.py::flash_attention_qkv``:
the ``relpos_attention`` kernel reads q/k/v as strided views of the fused
(B, 3, nH, N, hd) tensor, with no copies, and ``RelPosAttentionFn`` makes it
differentiable, its backward the ``relpos_attention_backward`` kernel (the
TPU's ``_flash_bwd_kernel``), as the JAX function's custom_vjp does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .relpos_attention import RelPosAttentionFn


def flash_attention_qkv(qkv: torch.Tensor, hw: Tuple[int, int],
                        rel_h: Optional[torch.Tensor], rel_w: Optional[torch.Tensor],
                        num_heads: int) -> torch.Tensor:
    """qkv: (B, 3, nH, N, hd) -> (B, nH, N, hd). Missing rel-pos tables act as zeros."""
    H, W = hw
    B, three, nH, N, hd = qkv.shape
    if three != 3 or nH != num_heads:
        raise ValueError(f"flash_attention_qkv: qkv shape {tuple(qkv.shape)}")
    if rel_h is None:
        rel_h = torch.zeros((H, H, hd), dtype=qkv.dtype, device=qkv.device)
        rel_w = torch.zeros((W, W, hd), dtype=qkv.dtype, device=qkv.device)
    return RelPosAttentionFn.apply(qkv, rel_h, rel_w, tuple(hw))
