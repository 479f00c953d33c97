"""The TinyViT stage-0 MBConv as a chain of hand-written CUDA kernels.

Counterpart of ``micro_sam_tpu/ops/fused_mbconv.py`` (TPU kernel
``_mbconv_kernel``, one program per row chunk with the hidden map in VMEM):

    h   = gelu(bn1(x W1))          1 x 1 expand to 4C   (gemm, "gelu")
    h   = gelu(bn2(dw3x3(h)))      depthwise            (dwconv, GELU)
    out = gelu(x + bn3(h W3))      1 x 1 shrink         (gemm, "residual_gelu")

Three launches over all pixels of the batch. bn1 / bn3 are folded into the
1 x 1 weights and biases in f32 and cast to the working type
(``Conv2d_BN.folded``); bn2's scale and shift go to the depthwise kernel.
The 4C hidden map (33.5 MB per 1024^2 image in bf16) goes through device
memory between the launches, where the TPU kernel kept it in VMEM: a
single-pass kernel with a haloed tile in shared memory is the known next step.
GELU is exact erf; the JAX package's bf16 tanh-sigmoid form is a TPU
workaround and is not ported. ``fused_mbconv_plain`` runs the same chain
through the kernels' plain versions: the card's oracle for the chain. The JAX
oracle is ``micro_sam_tpu/models/tiny_vit.py::_mbconv_unfused``.
"""
from __future__ import annotations

import torch

from .chain_grad import grad_params, recompute_grads
from .dwconv import dwconv, dwconv_plain
from .gemm import gemm, gemm_plain

_KERNELS = (gemm, dwconv)
_PLAIN = (gemm_plain, dwconv_plain)


def _chain(x: torch.Tensor, block, plain: bool) -> torch.Tensor:
    mm, dw = _PLAIN if plain else _KERNELS
    B, H, W, C = x.shape
    w1, _, b1 = block.conv1.folded(x.dtype)
    _, s2, t2 = block.conv2.folded(x.dtype)
    w3, _, b3 = block.conv3.folded(x.dtype)
    hid = w1.shape[0]
    xf = x.reshape(-1, C)
    h = mm(xf, w1.reshape(hid, C), b1, "gelu")
    h = dw(h.view(B, H, W, hid), block.conv2.c.weight, s2, t2, gelu=True)
    out = mm(h.view(-1, hid), w3.reshape(C, hid), b3, "residual_gelu", xf)
    return out.view(B, H, W, C)


class FusedMBConvFn(torch.autograd.Function):
    """The MBConv chain in autograd: forward the kernel chain, backward the
    plain chain's (the JAX package's ``fused_mbconv`` custom_vjp)."""

    @staticmethod
    def forward(ctx, x, block, *params):
        ctx.block, ctx.params = block, params
        ctx.save_for_backward(x)
        return _chain(x, block, plain=False)

    @staticmethod
    def backward(ctx, grad):
        x, = ctx.saved_tensors
        block = ctx.block
        dx, dps = recompute_grads(lambda t: _chain(t, block, plain=True), x, ctx.params, grad)
        return (dx, None, *dps)


def fused_mbconv(x: torch.Tensor, block) -> torch.Tensor:
    """x: (B, H, W, C) contiguous; block: a ``models.tiny_vit.MBConv`` -> (B, H, W, C).
    ``FusedMBConvFn`` where autograd needs the call's gradient."""
    params = grad_params(x, block)
    if params is not None:
        return FusedMBConvFn.apply(x, block, *params)
    return _chain(x, block, plain=False)


def fused_mbconv_plain(x: torch.Tensor, block) -> torch.Tensor:
    return _chain(x, block, plain=True)
