"""Rel-pos flash attention: over a fused qkv tensor, and over separate q, k, v.

``flash_attention_qkv`` is the counterpart of
``micro_sam_tpu/ops/flash_attention.py::flash_attention_qkv``: the
``relpos_attention`` kernel reads q/k/v as strided views of the fused
(B, 3, nH, N, hd) tensor, with no copies, and ``RelPosAttentionFn`` makes it
differentiable, its backward the ``relpos_attention_backward`` kernel (the
TPU's ``_flash_bwd_kernel``), as the JAX function's custom_vjp does.

``flash_attention_rel_pos`` is the counterpart of ``flash_attention_rel_pos``
there (its TPU kernel ``_flash_kernel`` reached through ``_flash_forward``):
q, k, v and the result in the (B, N, nH, hd) layout. Here it is the same two
kernels under a second stride set: each reads the (B, nH, N, hd) transposed
views of the (B, N, nH, hd) tensors, with no copy, and writes its result into
such a view. The JAX package differentiates it by the einsum VJP; the port
computes the same gradients with the backward kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import relpos_attention as rpa
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


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """(B, N, nH, hd) -> its (B, nH, N, hd) view."""
    return t.transpose(1, 2)


class RelPosAttentionSplitFn(torch.autograd.Function):
    """Differentiable rel-pos attention over separate (B, N, nH, hd) q, k, v:
    the forward is ``relpos_attention`` (keeping the rows' log-sum-exps), the
    backward ``relpos_attention_backward`` writing dq / dk / dv straight into
    (B, N, nH, hd) tensors (the plain versions for CPU tensors). The tables'
    gradients come back in their dtype (f32 from the kernel)."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, hw):
        dt = q.dtype
        B, N, nH, _ = q.shape
        out = torch.empty(q.shape, device=q.device, dtype=dt)
        lse = torch.empty((B, nH, N), device=q.device, dtype=torch.float32)
        rpa.relpos_attention(*(_heads_first(t) for t in (q, k, v)), rel_h.to(dt), rel_w.to(dt),
                             hw, out=_heads_first(out), lse=lse)
        ctx.save_for_backward(q, k, v, rel_h, rel_w, out, lse)
        ctx.hw = tuple(hw)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, rel_h, rel_w, out, lse = ctx.saved_tensors
        dt = q.dtype
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        grads = [torch.empty(q.shape, device=q.device, dtype=dt) for _ in range(3)]
        dq, dk, dv = (_heads_first(g) for g in grads)
        _, _, _, drh, drw = rpa.relpos_attention_backward(
            *(_heads_first(t) for t in (q, k, v, out, dout.to(dt))), rel_h.to(dt), rel_w.to(dt),
            ctx.hw, dq=dq, dk=dk, dv=dv, lse=lse)
        return (*grads, drh.to(rel_h.dtype), drw.to(rel_w.dtype), None)


def flash_attention_rel_pos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            hw: Tuple[int, int], rel_h: Optional[torch.Tensor],
                            rel_w: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, N, nH, hd) attention over an (H, W) grid -> (B, N, nH, hd).
    Missing rel-pos tables act as zeros. On the card the forward and the
    backward take every head dim up to 256 (``relpos_attention.MAX_HEAD_DIM``)
    and raise above."""
    H, W = hw
    if rel_h is None:
        rel_h = torch.zeros((H, H, q.shape[-1]), dtype=q.dtype, device=q.device)
        rel_w = torch.zeros((W, W, q.shape[-1]), dtype=q.dtype, device=q.device)
    return RelPosAttentionSplitFn.apply(q, k, v, rel_h, rel_w, tuple(hw))
