"""Rel-pos flash attention over a fused qkv tensor (forward only).

Counterpart of ``micro_sam_tpu/ops/flash_attention.py::flash_attention_qkv``:
the ``relpos_attention`` kernel reads q/k/v as strided views of the fused
(B, 3, nH, N, hd) tensor, with no copies. The backward (TPU kernel
``_flash_bwd_kernel``) belongs to the training slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .relpos_attention import relpos_attention


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
    return relpos_attention(qkv[:, 0], qkv[:, 1], qkv[:, 2],
                            rel_h.to(qkv.dtype), rel_w.to(qkv.dtype), hw)
