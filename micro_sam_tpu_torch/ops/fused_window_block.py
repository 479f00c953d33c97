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
kernel chain's dtype (``Block.hold_weights_in_``). The chain splits after
the proj product: its first four launches are the attention half of a block
(``fused_window_attn``, the TPU's ``fused_window_attn`` (K10), and
``fused_global_attn``, the TPU's ``fused_global_attn`` (K5)), its last three
the MLP half (``mlp_half``); a whole block (K2, K3) is one after the other.
The TPU runs the attention halves only where a whole block does not fit VMEM
(vit_h's global blocks); here every block is the two halves, so no routing
is needed. Each function has a plain version (``*_plain``) that runs the same
chain through the kernels' plain PyTorch versions; it is the oracle the card
holds the kernel chain against. The JAX oracles are
``micro_sam_tpu/ops/fused_window_block.py::_unfused_reference``,
``::_unfused_window_attn_half`` and ``::_unfused_attn_half``.

Two more routes of the windowed blocks, the encoder's opt-in knobs (as in the
JAX package, inference only):

- ``fused_window_block_spatial`` (the TPU's K9, ``MSAM_TPU_SPATIAL_WINDOW=1``):
  the same seven launches on the padded (B, Hp, Wp, C) map instead of
  partitioned windows. LN and the products are per row, so they take the
  map's rows as they are, LN1's pad mask computed from each row's position
  (``layernorm(grid=...)``); the attention is ``relpos_attention_spatial``,
  which gathers each window's q / k / v from the qkv product's map rows and
  writes the proj product's map rows. No partition or unpartition copy is
  made, and each row and window sees the arithmetic of the partitioned
  chain.
- ``fused_window_stack`` (the TPU's K11, ``MSAM_TPU_WINDOW_STACK=1``): K2
  grouped per image. On the TPU it exists so that the qkv, proj and MLP
  products run over an image's whole window stack instead of one window's
  196 rows; here every ``gemm`` launch of the chain already spans all windows
  of all images, so K11 is the seven-launch chain under K11's per-image
  interface and needs no kernel of its own. The TPU's VMEM gate
  (``window_stack_config``) has no counterpart: the chain keeps nothing
  resident, so it takes every geometry.

A block that PEFT changed (``models/peft_sam.py``) runs the same launches:
``_product`` reads a linear's dense weight (int4 storage dequantized) and adds
its LoRA update and SSF scale and shift after the ``gemm``, the LoRA / FacT
updates of the qkv product go onto its rows before the attention (``fact``,
the encoder's shared FacT core), and an AdaptFormer adapter is added beside
the MLP. The PEFT terms are PyTorch around the kernels, as the JAX package
computes them outside its Pallas kernels (``apply_attention``).

A block split over a mesh's model axis (``parallel/mesh.shard_sam_``, which
sets ``Block.tp``) runs the same launches at its shard's widths: the qkv
product gives its ``num_heads / m`` heads (the head dim is the block's, not
C / heads), the attention runs on them, and the proj and lin2 products take
the shard's input columns with epilogue ``none`` and a zero bias. Their
partial sums are all-reduced in float32 over the model group (the kernel
writes each partial in the working type), and the bias and the residual are
added once to the sum, which is cast once. The PEFT terms split with their
products: a row-split product's LoRA / SSF / int4 tensors hold the shard's
output columns, so ``_product`` takes them as they are; a column-split
product's LoRA term joins the partial sum and its SSF is applied after it.
The JAX package leaves the same split to XLA (``micro_sam_tpu/parallel/mesh.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .gemm import gemm, gemm_plain
from .layernorm import layernorm, layernorm_plain
from .relpos_attention import (relpos_attention, relpos_attention_plain,
                               relpos_attention_spatial, relpos_attention_spatial_plain)


def _relpos_attention_plain_into(q, k, v, rel_h, rel_w, hw, out):
    out.copy_(relpos_attention_plain(q, k, v, rel_h, rel_w, hw))
    return out


def _relpos_attention_spatial_plain_into(q, k, v, rel_h, rel_w, window, out):
    out.copy_(relpos_attention_spatial_plain(q, k, v, rel_h, rel_w, window))
    return out


_KERNELS = (layernorm, gemm, relpos_attention, relpos_attention_spatial)
_PLAIN = (layernorm_plain, gemm_plain, _relpos_attention_plain_into,
          _relpos_attention_spatial_plain_into)


def _product(mm, x: torch.Tensor, lin, epilogue: str = "none",
             residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``lin``'s product of x (M, K): ``mm`` on its dense weight (int4 storage
    dequantized) in x's dtype, then its PEFT terms where it has any (the LoRA
    update, the SSF scale and shift: ``Linear.peft_terms``) and the epilogue
    after them; without, the epilogue stays in the kernel."""
    w = lin.dense_weight().to(x.dtype)
    if lin.lora is None and lin.ssf_scale is None:
        return mm(x, w, lin.bias, epilogue, residual)
    y = lin.peft_terms(x, mm(x, w, lin.bias))
    if epilogue == "gelu":
        return F.gelu(y)
    return y if residual is None else residual + y


def _heads(block, num_heads: int) -> int:
    """The heads a block runs: all of them, or its shard's under a model axis."""
    return num_heads if block.tp is None else num_heads // block.tp.size


def _out_product(mm, x: torch.Tensor, lin, residual: torch.Tensor, tp) -> torch.Tensor:
    """residual + lin(x) for the proj and lin2 products. Split over a model
    axis (``tp``), x holds the shard's input columns: the partial products
    (epilogue ``none``, a zero bias; plus the shard's LoRA term, its ``a``
    rows the shard's) are summed in float32 over the model group, then the
    bias, the SSF scale and shift and the residual are applied and the sum
    cast once."""
    if tp is None:
        return _product(mm, x, lin, "residual", residual)
    from ..parallel.mesh import all_reduce_f32
    w = lin.dense_weight().to(x.dtype)
    part = mm(x, w, lin.bias.new_zeros(w.shape[0]), "none")
    if lin.lora is not None:
        part = part.float() + lin.lora(x).float()
    out = all_reduce_f32(part, tp.group) + lin.bias.float()
    if lin.ssf_scale is not None:
        out = out * lin.ssf_scale + lin.ssf_shift
    return (out + residual.float()).to(x.dtype)


def _qkv(mm, a: torch.Tensor, attn, fact) -> torch.Tensor:
    """The qkv product of LN1's rows a (M, C), plus the LoRA / FacT updates."""
    qkv = _product(mm, a, attn.qkv)
    d = attn.qkv_deltas(a, fact)
    return qkv if d is None else qkv + d


def _attn_half(x: torch.Tensor, valid: Optional[torch.Tensor], block, hw: Tuple[int, int],
               num_heads: int, plain: bool, fact=None) -> torch.Tensor:
    """Launches 1-4 of a block: x + proj(attn(LN1(x) * valid)), (Bn, N, C)."""
    ln, mm, att, _ = _PLAIN if plain else _KERNELS
    Bn, N, C = x.shape
    heads, hd = _heads(block, num_heads), block.attn.head_dim
    M = Bn * N
    attn = block.attn
    xf = x.reshape(M, C).contiguous()
    v_rows = None if valid is None else valid.reshape(M)
    a = ln(xf, block.norm1.weight, block.norm1.bias, block.norm1.eps, v_rows)
    q5 = _qkv(mm, a, attn, fact).view(Bn, N, 3, heads, hd)
    q, k, v = (q5[:, :, i].transpose(1, 2) for i in range(3))  # (Bn, nH, N, hd) views
    rel_h, rel_w = attn.rel_tables(hw, x.dtype)
    o = x.new_empty((Bn, N, heads, hd))  # no device constant in a trace
    att(q, k, v, rel_h, rel_w, hw, out=o.transpose(1, 2))
    x1 = _out_product(mm, o.view(M, heads * hd), attn.proj, xf, block.tp)
    return x1.view(Bn, N, C)


def _mlp_half(x: torch.Tensor, block, plain: bool) -> torch.Tensor:
    """Launches 5-7 of a block: x + lin2(gelu(lin1(LN2(x)))), (Bn, N, C), plus
    the AdaptFormer adapter of LN2's output where PEFT gave the block one."""
    ln, mm, _, _ = _PLAIN if plain else _KERNELS
    shape = x.shape
    xf = x.reshape(-1, shape[-1]).contiguous()
    mlp = block.mlp
    b = ln(xf, block.norm2.weight, block.norm2.bias, block.norm2.eps)
    h = _product(mm, b, mlp.lin1, "gelu")
    if mlp.adapter is None:
        return _out_product(mm, h, mlp.lin2, xf, block.tp).view(shape)
    if block.tp is not None:
        return (_out_product(mm, h, mlp.lin2, xf, block.tp) + mlp.adapter(b)).view(shape)
    return (xf + _product(mm, h, mlp.lin2) + mlp.adapter(b)).view(shape)


def fused_window_attn(x: torch.Tensor, valid: Optional[torch.Tensor], block,
                      hw: Tuple[int, int], num_heads: int, fact=None) -> torch.Tensor:
    """The attention half of a windowed block (K10): x + attn(LN1(x) * valid).
    x: (BW, N, C) windows; valid: (BW, N, 1) pad mask or None -> (BW, N, C);
    ``fact`` the encoder's shared FacT core (u, v) where FacT is on.
    JAX oracle: ``_unfused_window_attn_half`` (``apply_attention`` for a PEFT
    block)."""
    return _attn_half(x, valid, block, hw, num_heads, False, fact)


def fused_window_attn_plain(x, valid, block, hw, num_heads, fact=None):
    return _attn_half(x, valid, block, hw, num_heads, True, fact)


def fused_global_attn(x: torch.Tensor, block, hw: Tuple[int, int],
                      num_heads: int, fact=None) -> torch.Tensor:
    """The attention half of a global block (K5): x + attn(LN1(x)) over
    N = H * W tokens. x: (B, N, C) -> (B, N, C). JAX oracle:
    ``_unfused_attn_half``."""
    return _attn_half(x, None, block, hw, num_heads, False, fact)


def fused_global_attn_plain(x, block, hw, num_heads, fact=None):
    return _attn_half(x, None, block, hw, num_heads, True, fact)


def mlp_half(x: torch.Tensor, block) -> torch.Tensor:
    """The MLP half of a block: x + lin2(gelu(lin1(LN2(x)))), x (..., C)."""
    return _mlp_half(x, block, plain=False)


def mlp_half_plain(x, block):
    return _mlp_half(x, block, plain=True)


def fused_window_block(x: torch.Tensor, valid: Optional[torch.Tensor], block,
                       hw: Tuple[int, int], num_heads: int) -> torch.Tensor:
    """x: (BW, N, C) windows; valid: (BW, N, 1) pad mask or None -> (BW, N, C)."""
    return mlp_half(fused_window_attn(x, valid, block, hw, num_heads), block)


def fused_window_block_plain(x, valid, block, hw, num_heads):
    return mlp_half_plain(fused_window_attn_plain(x, valid, block, hw, num_heads), block)


def fused_global_block(x: torch.Tensor, block, hw: Tuple[int, int],
                       num_heads: int) -> torch.Tensor:
    """x: (B, N, C) with N = H * W tokens of global attention -> (B, N, C)."""
    return mlp_half(fused_global_attn(x, block, hw, num_heads), block)


def fused_global_block_plain(x, block, hw, num_heads):
    return mlp_half_plain(fused_global_attn_plain(x, block, hw, num_heads), block)


def _spatial_block(xp: torch.Tensor, block, window: int, valid_hw: Tuple[int, int],
                   num_heads: int, plain: bool, fact=None) -> torch.Tensor:
    """The seven launches of a windowed block on the padded map xp
    (B, Hp, Wp, C) -> (B, Hp, Wp, C)."""
    ln, mm, _, att = _PLAIN if plain else _KERNELS
    B, Hp, Wp, C = xp.shape
    if Hp % window or Wp % window:
        raise ValueError(f"fused_window_block_spatial: map {(Hp, Wp)} is not whole "
                         f"{window} x {window} windows")
    heads, hd = _heads(block, num_heads), block.attn.head_dim
    M = B * Hp * Wp
    attn = block.attn
    xf = xp.reshape(M, C).contiguous()
    grid = None if (Hp, Wp) == tuple(valid_hw) else (Hp, Wp, *valid_hw)
    a = ln(xf, block.norm1.weight, block.norm1.bias, block.norm1.eps, None, grid)
    q6 = _qkv(mm, a, attn, fact).view(B, Hp, Wp, 3, heads, hd)
    q, k, v = (q6[:, :, :, i] for i in range(3))  # (B, Hp, Wp, nH, hd) map views
    rel_h, rel_w = attn.rel_tables((window, window), xp.dtype)
    o = torch.empty((B, Hp, Wp, heads, hd), device=xp.device, dtype=xp.dtype)
    att(q, k, v, rel_h, rel_w, window, out=o)
    x1 = _out_product(mm, o.view(M, heads * hd), attn.proj, xf, block.tp)
    return _mlp_half(x1, block, plain).view(B, Hp, Wp, C)


def fused_window_block_spatial(xp: torch.Tensor, block, window: int,
                               valid_hw: Tuple[int, int], num_heads: int,
                               fact=None) -> torch.Tensor:
    """A windowed block (K9) on the padded map: xp (B, Hp, Wp, C), Hp and Wp
    multiples of ``window``, ``valid_hw`` the true (H, W) before padding ->
    (B, Hp, Wp, C). LN1 zeroes the pad rows (y >= H or x >= W), as the
    partitioned chain's mask does. JAX counterpart:
    ``micro_sam_tpu/ops/fused_window_block.py::fused_window_block_spatial``;
    oracle ``_unfused_reference`` on the partitioned windows."""
    return _spatial_block(xp, block, window, valid_hw, num_heads, False, fact)


def fused_window_block_spatial_plain(xp, block, window, valid_hw, num_heads, fact=None):
    return _spatial_block(xp, block, window, valid_hw, num_heads, True, fact)


def _window_stack(x, valid, block, hw, num_heads, n_images, plain, fact=None):
    BW = x.shape[0]
    if n_images <= 0 or BW % n_images:
        raise ValueError(f"fused_window_stack: {BW} windows are not n_images = {n_images} "
                         f"equal stacks")
    if hw[0] != hw[1] or x.shape[1] != hw[0] * hw[1]:
        raise ValueError(f"fused_window_stack: windows {tuple(x.shape)} over grid {hw}")
    return _mlp_half(_attn_half(x, valid, block, hw, num_heads, plain, fact), block, plain)


def fused_window_stack(x: torch.Tensor, valid: Optional[torch.Tensor], block,
                       hw: Tuple[int, int], num_heads: int, n_images: int,
                       fact=None) -> torch.Tensor:
    """A windowed block over the window stacks of ``n_images`` images (K11):
    x (n_images * NW, N, C) windows, image by image; valid (.., N, 1) pad mask
    or None -> (n_images * NW, N, C). The seven launches of
    ``fused_window_block``, each over every window of every image (see the
    module's docstring). JAX counterpart:
    ``micro_sam_tpu/ops/fused_window_block.py::fused_window_stack``; oracle
    ``_unfused_reference``."""
    return _window_stack(x, valid, block, hw, num_heads, n_images, False, fact)


def fused_window_stack_plain(x, valid, block, hw, num_heads, n_images, fact=None):
    return _window_stack(x, valid, block, hw, num_heads, n_images, True, fact)
