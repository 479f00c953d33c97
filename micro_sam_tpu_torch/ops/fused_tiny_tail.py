"""The TinyViT block tail as a chain of hand-written CUDA kernels.

Counterpart of ``micro_sam_tpu/ops/fused_tiny_tail.py`` (TPU kernel
``_tiny_tail_kernel``, one program per row chunk):

    t   = bn(dw3x3(x))                "local conv"     (dwconv, no GELU)
    a   = layernorm(t, eps 1e-5)                       (layernorm)
    h   = gelu(a W1^T + b1)                            (gemm, "gelu")
    out = t + (h W2^T + b2)                            (gemm, "residual")

Four launches over all pixels of the batch; the local conv's BN goes to the
depthwise kernel as a scale and shift. ``fused_tiny_tail_plain`` runs the same
chain through the kernels' plain versions: the card's oracle for the chain.
The JAX oracle is ``micro_sam_tpu/ops/fused_tiny_tail.py::_unfused_reference``.

In autograd, ``fused_tiny_tail`` runs as ``FusedTinyTailFn`` (the JAX
package's custom_vjp: the plain chain's backward, ``ops/chain_grad.py``).
"""
from __future__ import annotations

import torch

from .chain_grad import grad_params, recompute_grads
from .dwconv import dwconv, dwconv_plain
from .gemm import gemm, gemm_plain
from .layernorm import layernorm, layernorm_plain

_KERNELS = (dwconv, layernorm, gemm)
_PLAIN = (dwconv_plain, layernorm_plain, gemm_plain)


def _chain(x: torch.Tensor, local_conv, mlp, plain: bool) -> torch.Tensor:
    dw, ln, mm = _PLAIN if plain else _KERNELS
    B, H, W, C = x.shape
    _, s, t = local_conv.folded(x.dtype)
    tf = dw(x, local_conv.c.weight, s, t).view(-1, C)
    a = ln(tf, mlp.norm.weight, mlp.norm.bias, mlp.norm.eps)
    h = mm(a, mlp.fc1.weight.to(x.dtype), mlp.fc1.bias, "gelu")
    out = mm(h, mlp.fc2.weight.to(x.dtype), mlp.fc2.bias, "residual", tf)
    return out.view(B, H, W, C)


class FusedTinyTailFn(torch.autograd.Function):
    """The block tail in autograd: forward the kernel chain, backward the
    plain chain's (the JAX package's ``fused_tiny_tail`` custom_vjp)."""

    @staticmethod
    def forward(ctx, x, local_conv, mlp, *params):
        ctx.mods, ctx.params = (local_conv, mlp), params
        ctx.save_for_backward(x)
        return _chain(x, local_conv, mlp, plain=False)

    @staticmethod
    def backward(ctx, grad):
        x, = ctx.saved_tensors
        local_conv, mlp = ctx.mods
        dx, dps = recompute_grads(lambda t: _chain(t, local_conv, mlp, plain=True), x,
                                  ctx.params, grad)
        return (dx, None, None, *dps)


def fused_tiny_tail(x: torch.Tensor, local_conv, mlp) -> torch.Tensor:
    """bn(dw3x3(x)) + MLP(LN(.)). x: (B, H, W, C) contiguous; local_conv: a
    ``models.common.Conv2d_BN``; mlp: a ``models.tiny_vit.TinyMlp``.
    ``FusedTinyTailFn`` where autograd needs the call's gradient."""
    params = grad_params(x, local_conv, mlp)
    if params is not None:
        return FusedTinyTailFn.apply(x, local_conv, mlp, *params)
    return _chain(x, local_conv, mlp, plain=False)


def fused_tiny_tail_plain(x: torch.Tensor, local_conv, mlp) -> torch.Tensor:
    return _chain(x, local_conv, mlp, plain=True)
