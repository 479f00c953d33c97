"""Neural-net building blocks of the port.

Counterpart of ``micro_sam_tpu/models/common.py``. Parameters live in
``nn.Module``s whose names follow the segment_anything / micro-sam zoo keys, so
a zoo state dict loads with ``load_state_dict``. Parameters are float32 unless
a module holds them in its compute dtype; activations run in the model's
compute dtype, with weights cast to it at use, and LayerNorm statistics in
float32. Activations are channel-last (NHWC), as in
the JAX package; convolutions convert to PyTorch's NCHW at the call.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ weight.T + bias in x.dtype; weight (out, in) as in nn.Linear."""
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis, computed in float32, returned in x.dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """NHWC convolution with an (O, I, kh, kw) kernel."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     stride: int = 2) -> torch.Tensor:
    """NHWC transposed convolution with an (I, O, kh, kw) kernel."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                           None if bias is None else bias.to(x.dtype), stride=stride)
    return y.permute(0, 2, 3, 1)


def kaiming_uniform_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    bound = math.sqrt(3.0 / fan_in) if fan_in > 0 else 0.0
    # drawn in float32 and rounded, so a weight held in bfloat16 is the
    # rounding of the float32 model's
    draw = torch.empty(t.shape, device=generator.device).uniform_(-bound, bound,
                                                                  generator=generator)
    with torch.no_grad():
        return t.copy_(draw)


class Linear(nn.Linear):
    """nn.Linear that runs in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)

    def init_(self, g: torch.Generator) -> None:
        kaiming_uniform_(self.weight, self.in_features, g)
        if self.bias is not None:
            b = 1.0 / math.sqrt(self.in_features)
            with torch.no_grad():
                self.bias.uniform_(-b, b, generator=g)


class LayerNorm(nn.Module):
    """LayerNorm (and SAM's LayerNorm2d, the same op in channel-last layout)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class Conv2d(nn.Conv2d):
    """nn.Conv2d over channel-last input, in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.padding[0] if isinstance(self.padding, tuple) else self.padding
        return conv2d(x, self.weight, self.bias, self.stride[0], pad)

    def init_(self, g: torch.Generator) -> None:
        fan_in = self.in_channels * self.kernel_size[0] * self.kernel_size[1]
        kaiming_uniform_(self.weight, fan_in, g)
        if self.bias is not None:
            b = 1.0 / math.sqrt(fan_in)
            with torch.no_grad():
                self.bias.uniform_(-b, b, generator=g)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d (kernel == stride) over channel-last input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose2d(x, self.weight, self.bias, self.stride[0])

    def init_(self, g: torch.Generator) -> None:
        fan_in = self.in_channels * self.kernel_size[0] * self.kernel_size[1]
        kaiming_uniform_(self.weight, fan_in, g)
        if self.bias is not None:
            b = 1.0 / math.sqrt(fan_in)
            with torch.no_grad():
                self.bias.uniform_(-b, b, generator=g)


class Embedding(nn.Module):
    """A learned table with the zoo's ``<name>.weight`` key."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num, dim))

    def init_(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(generator=g)


class MLPBlock(nn.Module):
    """lin2(gelu(lin1(x))): the encoder / two-way-transformer MLP."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = Linear(dim, hidden)
        self.lin2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_block(self, x)


def mlp_block(m: MLPBlock, x: torch.Tensor) -> torch.Tensor:
    return m.lin2(gelu(m.lin1(x)))


class MLP(nn.Module):
    """SAM's multi-layer MLP (hypernetworks, IoU head): ReLU between layers."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int, depth: int,
                 sigmoid_output: bool = False):
        super().__init__()
        dims = [in_dim] + [hidden] * (depth - 1) + [out_dim]
        self.layers = nn.ModuleList(Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.sigmoid_output = sigmoid_output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(self, x)


def mlp(m: MLP, x: torch.Tensor) -> torch.Tensor:
    n = len(m.layers)
    for i, layer in enumerate(m.layers):
        x = layer(x)
        if i < n - 1:
            x = F.relu(x)
    return torch.sigmoid(x) if m.sigmoid_output else x


def init_module_(module: nn.Module, g: torch.Generator) -> None:
    """Random-initialize every layer of ``module`` that has an ``init_``."""
    for m in module.modules():
        if m is not module and hasattr(m, "init_"):
            m.init_(g)
