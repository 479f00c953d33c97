"""The SAM ViT transformer block as a chain of hand-written CUDA kernels.

Counterpart of ``micro_sam_tpu/ops/fused_window_block.py``. On the TPU,
``fused_window_block`` (kernel ``_fused_block_kernel``) runs a whole windowed
block per window in VMEM, and ``fused_global_block`` (kernel
``_fused_global_kernel``) a whole global block per image. That design does not
carry over to Hopper: one window's LN1 output alone (196 x 768 bf16 = 294 KB)
exceeds the 227 KB of shared memory a block may use, and the TPU kernel also
keeps every block weight resident. Here each block is seven launches over all
rows of the batch at once:

    a   = layernorm(x, LN1) * valid          (layernorm kernel)
    qkv = a Wqkv^T + b                       (gemm)
    o   = relpos_attention(q, k, v)          (reads qkv rows, writes proj rows)
    x1  = x + (o Wproj^T + b)                (gemm, residual epilogue)
    h   = gelu(layernorm(x1, LN2) W1^T + b1) (layernorm, gemm with GELU epilogue)
    out = x1 + (h W2^T + b2)                 (gemm, residual epilogue)

The kernels take the block's product weights as they are held: in the
kernel chain's dtype (``Block.hold_weights_in_``). Each function has a plain
version (``*_plain``) that runs the same chain
through the kernels' plain PyTorch versions; it is the oracle the card holds
the kernel chain against. The JAX oracle is
``micro_sam_tpu/ops/fused_window_block.py::_unfused_reference``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .gemm import gemm, gemm_plain
from .layernorm import layernorm, layernorm_plain
from .relpos_attention import relpos_attention, relpos_attention_plain


def _relpos_attention_plain_into(q, k, v, rel_h, rel_w, hw, out):
    out.copy_(relpos_attention_plain(q, k, v, rel_h, rel_w, hw))
    return out


_KERNELS = (layernorm, gemm, relpos_attention)
_PLAIN = (layernorm_plain, gemm_plain, _relpos_attention_plain_into)


def _chain(x: torch.Tensor, valid: Optional[torch.Tensor], block, hw: Tuple[int, int],
           num_heads: int, plain: bool) -> torch.Tensor:
    ln, mm, att = _PLAIN if plain else _KERNELS
    Bn, N, C = x.shape
    hd = C // num_heads
    M = Bn * N
    attn = block.attn
    xf = x.reshape(M, C).contiguous()
    v_rows = None if valid is None else valid.reshape(M)
    a = ln(xf, block.norm1.weight, block.norm1.bias, block.norm1.eps, v_rows)
    qkv = mm(a, attn.qkv.weight, attn.qkv.bias)
    q5 = qkv.view(Bn, N, 3, num_heads, hd)
    q, k, v = (q5[:, :, i].transpose(1, 2) for i in range(3))  # (Bn, nH, N, hd) views
    rel_h, rel_w = attn.rel_tables(hw, x.dtype)
    o = torch.empty((Bn, N, num_heads, hd), device=x.device, dtype=x.dtype)
    att(q, k, v, rel_h, rel_w, hw, out=o.transpose(1, 2))
    o = o.view(M, C)
    x1 = mm(o, attn.proj.weight, attn.proj.bias, "residual", xf)
    b = ln(x1, block.norm2.weight, block.norm2.bias, block.norm2.eps)
    h = mm(b, block.mlp.lin1.weight, block.mlp.lin1.bias, "gelu")
    out = mm(h, block.mlp.lin2.weight, block.mlp.lin2.bias, "residual", x1)
    return out.view(Bn, N, C)


def fused_window_block(x: torch.Tensor, valid: Optional[torch.Tensor], block,
                       hw: Tuple[int, int], num_heads: int) -> torch.Tensor:
    """x: (BW, N, C) windows; valid: (BW, N, 1) pad mask or None -> (BW, N, C)."""
    return _chain(x, valid, block, hw, num_heads, plain=False)


def fused_window_block_plain(x, valid, block, hw, num_heads):
    return _chain(x, valid, block, hw, num_heads, plain=True)


def fused_global_block(x: torch.Tensor, block, hw: Tuple[int, int],
                       num_heads: int) -> torch.Tensor:
    """x: (B, N, C) with N = H * W tokens of global attention -> (B, N, C)."""
    return _chain(x, None, block, hw, num_heads, plain=False)


def fused_global_block_plain(x, block, hw, num_heads):
    return _chain(x, None, block, hw, num_heads, plain=True)
