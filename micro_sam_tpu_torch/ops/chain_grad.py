"""The backward of a kernel chain: its plain version recomputed in autograd.

The JAX package trains through its TinyViT kernels (K6 / K7 / K8) with a
``custom_vjp`` whose backward is the VJP of the unfused composition from the
saved input (``micro_sam_tpu/ops/fused_tiny_attention.py::_fta_bwd``,
``fused_mbconv.py::_fmb_bwd``, ``fused_tiny_tail.py::_ftt_bwd``). The port's
``torch.autograd.Function``s do the same: the forward runs the kernel chain
and saves its input; ``recompute_grads`` runs the chain's plain version on
that input in autograd and back-propagates the output's gradient through it,
into the input and the module's parameters (the float32 master weights,
through their casts to the compute dtype, and through ``fold_bn``).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def grad_params(x: torch.Tensor, *modules) -> Optional[Tuple[torch.Tensor, ...]]:
    """The parameters of ``modules`` (each once), which a chain's autograd
    function takes as inputs so that autograd routes their gradients; None
    where autograd needs no gradient of the call (serving: the kernel chain
    runs as it is, without collecting anything)."""
    if not torch.is_grad_enabled():
        return None
    seen, out = set(), []
    for m in modules:
        for p in m.parameters():
            if id(p) not in seen:
                seen.add(id(p))
                out.append(p)
    if x.requires_grad or any(p.requires_grad for p in out):
        return tuple(out)
    return None


def recompute_grads(plain: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                    params: Sequence[torch.Tensor], grad_out: torch.Tensor):
    """Gradients of ``plain(x)`` against ``grad_out``: (d x, d each param),
    None where a tensor needs none."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        out = plain(xg)
    wanted = [xg] + [p for p in params if p.requires_grad]
    grads = iter(torch.autograd.grad(out, wanted, grad_out, allow_unused=True))
    dx = next(grads)
    return dx, [next(grads) if p.requires_grad else None for p in params]
