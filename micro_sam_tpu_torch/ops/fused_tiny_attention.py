"""The TinyViT window-attention half block as a chain of hand-written CUDA kernels.

Counterpart of ``micro_sam_tpu/ops/fused_tiny_attention.py`` (TPU kernel
``_tiny_attn_kernel``: LN, qkv, all heads' attention, proj and the residual
for a group of windows in VMEM). Over the zero-padded (B, Hp, Wp, C) map:

    a   = layernorm(x, eps 1e-5)      every row, pad rows too (their LN is the LN bias)
    qkv = a Wqkv^T + b                (gemm; per-head [q | k | v] columns)
    o   = tiny_attention(qkv)         windows found by index arithmetic
    out = x + (o Wproj^T + b)         (gemm, "residual")

Four launches over all rows of the batch; the window partition costs no
transpose (``ops/tiny_attention.py``). The caller pads before (``F.pad``) and
crops after, as the JAX wrapper does in XLA; pad tokens take part in the
attention, as upstream. ``fused_tiny_attention_plain`` runs the same chain
through the kernels' plain versions: the card's oracle for the chain. The JAX
oracle is ``micro_sam_tpu/ops/fused_tiny_attention.py::_unfused_reference``,
with the qkv weight permuted between the JAX package's [q | k | v] thirds and
upstream's per-head order (``models/convert.py``).

The products take their weights cast to the input's dtype (a no-op for the
weights serving holds in it; training holds them in float32). In autograd,
``fused_tiny_attention`` runs as ``FusedTinyAttentionFn`` (the JAX package's
custom_vjp: the plain chain's backward, ``ops/chain_grad.py``).
"""
from __future__ import annotations

import torch

from .chain_grad import grad_params, recompute_grads
from .gemm import gemm, gemm_plain
from .layernorm import layernorm, layernorm_plain
from .tiny_attention import tiny_attention, tiny_attention_plain

_KERNELS = (layernorm, gemm, tiny_attention)
_PLAIN = (layernorm_plain, gemm_plain, tiny_attention_plain)


def _chain(x: torch.Tensor, attn, plain: bool) -> torch.Tensor:
    ln, mm, att = _PLAIN if plain else _KERNELS
    B, Hp, Wp, C = x.shape
    xf = x.reshape(-1, C)
    a = ln(xf, attn.norm.weight, attn.norm.bias, attn.norm.eps)
    qkv = mm(a, attn.qkv.weight.to(x.dtype), attn.qkv.bias)
    o = att(qkv, attn.attention_biases, (B, Hp, Wp), attn.window)
    out = mm(o, attn.proj.weight.to(x.dtype), attn.proj.bias, "residual", xf)
    return out.view(B, Hp, Wp, C)


class FusedTinyAttentionFn(torch.autograd.Function):
    """The attention half in autograd: forward the kernel chain, backward the
    plain chain's (the JAX package's ``fused_tiny_attention`` custom_vjp)."""

    @staticmethod
    def forward(ctx, x, attn, *params):
        ctx.attn, ctx.params = attn, params
        ctx.save_for_backward(x)
        return _chain(x, attn, plain=False)

    @staticmethod
    def backward(ctx, grad):
        x, = ctx.saved_tensors
        attn = ctx.attn
        dx, dps = recompute_grads(lambda t: _chain(t, attn, plain=True), x, ctx.params, grad)
        return (dx, None, *dps)


def fused_tiny_attention(x: torch.Tensor, attn) -> torch.Tensor:
    """x + proj(window-attention(LN(x))). x: (B, Hp, Wp, C) contiguous, zero-padded
    to multiples of ``attn.window``; attn: a ``models.tiny_vit.TinyAttention``.
    ``FusedTinyAttentionFn`` where autograd needs the call's gradient."""
    params = grad_params(x, attn)
    if params is not None:
        return FusedTinyAttentionFn.apply(x, attn, *params)
    return _chain(x, attn, plain=False)


def fused_tiny_attention_plain(x: torch.Tensor, attn) -> torch.Tensor:
    return _chain(x, attn, plain=True)
