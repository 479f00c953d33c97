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

import numpy as np
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
           stride: int = 1, padding: int = 0, groups: int = 1) -> torch.Tensor:
    """NHWC convolution with an (O, I / groups, kh, kw) kernel."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype), stride=stride, padding=padding,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def conv2d_product(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   stride: int = 1) -> torch.Tensor:
    """NHWC convolution whose kernel is its stride (no overlap, no padding)
    as one product of the (k k I) patches, a reshape of x, with the (O, k k I)
    weight, the bias in its epilogue. Its backward is products, which repeat
    bit for bit."""
    O, I, k, _ = weight.shape
    B, H, W, C = x.shape
    Ho, Wo = H // k, W // k
    patches = x[:, :Ho * k, :Wo * k].reshape(B, Ho, k, Wo, k, C)
    patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(B, Ho, Wo, k * k * C)
    w = weight.permute(0, 2, 3, 1).reshape(O, k * k * I).to(x.dtype)
    return F.linear(patches, w, None if bias is None else bias.to(x.dtype))


class RepeatableConv2d(torch.autograd.Function):
    """cuDNN's stride-1 NCHW convolution forward, with a backward that
    repeats bit for bit: the input gradient is the forward convolution of
    the output gradient with the kernel flipped and its channels swapped
    (cuDNN's forward algorithms are deterministic, its backward ones need
    not be: on the H100 its data gradient of the SAM neck's 3 x 3
    convolution at a 8 x 8 grid differed from run to run); the weight
    gradient is kh kw products of the output gradient with the shifted
    input, channels last."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding):
        ctx.save_for_backward(x, weight)
        ctx.padding, ctx.has_bias = padding, bias is not None
        return F.conv2d(x, weight, bias, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        p = ctx.padding
        O, I, kh, kw = w.shape
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = F.conv2d(g, w.flip(2, 3).transpose(0, 1), padding=kh - 1 - p)
        if ctx.needs_input_grad[1]:
            N, _, H, W = g.shape
            g2 = g.permute(0, 2, 3, 1).reshape(N * H * W, O)
            xp = F.pad(x, (p, p, p, p)).permute(0, 2, 3, 1)
            gw = torch.stack([g2.t() @ xp[:, dy:dy + H, dx:dx + W].reshape(N * H * W, I)
                              for dy in range(kh) for dx in range(kw)], dim=-1)
            gw = gw.view(O, I, kh, kw)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = g.sum(dim=(0, 2, 3))
        return gx, gw, gb, None


def conv2d_nchw(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                padding: int) -> torch.Tensor:
    """Stride-1 NCHW convolution in x's dtype: ``RepeatableConv2d``, whose
    backward repeats bit for bit. A ``torch.jit`` trace records the plain
    convolution instead (the same forward), as a saved trace cannot hold a
    Python autograd function."""
    w, b = weight.to(x.dtype), None if bias is None else bias.to(x.dtype)
    if torch.jit.is_tracing():
        return F.conv2d(x, w, b, padding=padding)
    return RepeatableConv2d.apply(x, w, b, padding)


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     stride: int = 2) -> torch.Tensor:
    """NHWC transposed convolution with an (I, O, k, k) kernel whose size is
    its stride. The outputs of such a kernel do not overlap, so it is one
    product (I -> O k k, the bias in its epilogue) and a pixel shuffle; its
    backward is products too, which repeat bit for bit (cuDNN's
    weight-gradient algorithms for it may add with atomics)."""
    cin, cout, k, k2 = weight.shape
    if k != stride or k2 != stride:
        raise ValueError(f"conv_transpose2d: kernel {(k, k2)} is not the stride {stride}")
    B, H, W, _ = x.shape
    b = None if bias is None else bias.to(x.dtype).repeat_interleave(k * k)
    y = F.linear(x, weight.reshape(cin, cout * k * k).t().to(x.dtype), b)
    y = y.view(B, H, W, cout, k, k).permute(0, 1, 4, 2, 5, 3)
    return y.reshape(B, H * k, W * k, cout)


_RESIZE_MATRICES: dict = {}


def resize_matrix(n_in: int, n_out: int, antialias: bool = True, device=None,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The (n_in, n_out) weights of a bilinear resize along one axis with
    half-pixel centres: ``jax.image.resize``'s ``compute_weight_mat`` with
    the triangle kernel, widened by n_in / n_out when it shrinks and
    ``antialias``, each column normalized; computed in float32, then cast to
    ``dtype`` on ``device``, and kept per (size, device, dtype)."""
    key = (n_in, n_out, antialias, str(torch.device(device or "cpu")), dtype)
    w = _RESIZE_MATRICES.get(key)
    if w is None:
        f32 = np.float32
        inv_scale = f32(1.0 / (n_out / n_in))  # jax: a Python float, then float32
        kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
        sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
        x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
        weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
        total = weights.sum(axis=0, keepdims=True)
        weights = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                           weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
        inside = (sample >= -0.5) & (sample <= f32(n_in) - f32(0.5))
        w = torch.from_numpy(np.where(inside[None, :], weights, f32(0.0)).astype(f32))
        w = w.to(device or "cpu", dtype)
        _RESIZE_MATRICES[key] = w
    return w


def resize_bilinear(x: torch.Tensor, out_hw, antialias: bool = True) -> torch.Tensor:
    """(..., h, w) -> (..., H, W), bilinear with half-pixel centres, as
    ``jax.image.resize(..., "bilinear")`` (antialiased where it shrinks,
    unless ``antialias`` is False): two products with the fixed weights of
    ``resize_matrix`` in x's dtype (float32 for integer input), one along
    W, then one along H. Its backward is two products, so it repeats bit for
    bit (``F.interpolate``'s CUDA backward adds with atomics)."""
    H, W = int(out_hw[0]), int(out_hw[1])
    h, w = x.shape[-2], x.shape[-1]
    if (h, w) == (H, W):
        return x
    dt = x.dtype if x.is_floating_point() else torch.float32
    x = x.to(dt)
    if w != W:
        x = x @ resize_matrix(w, W, antialias, x.device, dt)
    if h != H:
        x = resize_matrix(h, H, antialias, x.device, dt).t() @ x
    return x


def resize_bilinear_hwc(x: torch.Tensor, out_hw, antialias: bool = True) -> torch.Tensor:
    """``resize_bilinear`` of channel-last (N, h, w, C) -> (N, H, W, C): the
    same two products, over W then over H, without a layout copy."""
    H, W = int(out_hw[0]), int(out_hw[1])
    N, h, w, C = x.shape
    if w != W:
        x = resize_matrix(w, W, antialias, x.device, x.dtype).t() @ x
    if h != H:
        x = (resize_matrix(h, H, antialias, x.device, x.dtype).t()
             @ x.reshape(N, h, W * C)).view(N, H, W, C)
    return x


def kaiming_uniform_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    bound = math.sqrt(3.0 / fan_in) if fan_in > 0 else 0.0
    # drawn in float32 and rounded, so a weight held in bfloat16 is the
    # rounding of the float32 model's
    draw = torch.empty(t.shape, device=generator.device).uniform_(-bound, bound,
                                                                  generator=generator)
    with torch.no_grad():
        return t.copy_(draw)


QUANT_BLOCK = 64  # input rows per int4 scale (``micro_sam_tpu/models/peft_sam.py``)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int4 values in [-7, 7], (out, in) of any integer dtype -> (out, in / 2)
    uint8, two a byte: element 2j in the low nibble, 2j + 1 in the high one,
    each stored with an offset of 8 (so 1..15)."""
    n = (q.to(torch.int16) + 8).to(torch.uint8)
    return n[:, 0::2] | (n[:, 1::2] << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pack_int4``: (out, in / 2) uint8 -> (out, in) int8."""
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    return torch.stack((lo, hi), dim=-1).reshape(packed.shape[0], -1)


def dequantize_packed(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Packed int4 (out, in / 2) and per (input block, output) scales (in /
    block, out) -> the dense (out, in) weight in the scales' dtype: each value
    times its scale, rounded once to that dtype (the JAX package's
    ``dense_weight``)."""
    q = unpack_int4(packed).to(scale.dtype)
    block = q.shape[1] // scale.shape[0]
    return (q.view(q.shape[0], -1, block) * scale.t()[:, :, None]).view(q.shape)


class LoRA(nn.Module):
    """A low-rank update ``(x a) b`` beside a product: a (in, rank), b (rank,
    out), the JAX package's orientation (keys ``lora.a`` / ``lora.b``)."""

    def __init__(self, in_dim: int, out_dim: int, rank: int):
        super().__init__()
        self.a = nn.Parameter(torch.zeros(in_dim, rank))
        self.b = nn.Parameter(torch.zeros(rank, out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x @ self.a.to(x.dtype)) @ self.b.to(x.dtype)


class Linear(nn.Linear):
    """nn.Linear that runs in its input's dtype.

    PEFT (``models/peft_sam.py``) may give it a LoRA update (``lora``), a
    scale and shift of its output (``ssf_scale`` / ``ssf_shift``), or int4
    storage of its weight (``quantize_int4_``: the buffers ``w_q4``, packed
    two a byte, and ``w_scale``, in place of the ``weight`` parameter,
    dequantized at each read by ``dense_weight``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.register_module("lora", None)
        self.register_parameter("ssf_scale", None)
        self.register_parameter("ssf_shift", None)

    def forward(self, x: torch.Tensor, shared=None) -> torch.Tensor:
        return self.peft_terms(x, linear(x, self.dense_weight(), self.bias), shared)

    @property
    def quantized(self) -> bool:
        return "weight" not in self._parameters

    def dense_weight(self) -> torch.Tensor:
        """The (out, in) weight; int4 storage dequantized (in bf16, the
        scales' dtype)."""
        if self.quantized:
            return dequantize_packed(self.w_q4, self.w_scale)
        return self.weight

    def peft_terms(self, x: torch.Tensor, y: torch.Tensor, shared=None) -> torch.Tensor:
        """y (the product of x and the weight, plus the bias) with the LoRA
        update added and the SSF scale and shift applied, in float32, back in
        y's dtype (``micro_sam_tpu/models/common.py::linear``). ``shared``
        wraps LoRA's ``a`` where the product is split on its output rows over
        a model axis and every shard reads ``a`` whole (``CopyToModel`` in
        training, so that its gradient sums the shards')."""
        if self.lora is None and self.ssf_scale is None:
            return y
        out = y.float()
        if self.lora is not None:
            a = self.lora.a if shared is None else shared(self.lora.a)
            out = out + ((x @ a.to(x.dtype)) @ self.lora.b.to(x.dtype)).float()
        if self.ssf_scale is not None:
            out = out * self.ssf_scale + self.ssf_shift
        return out.to(y.dtype)

    def add_ssf_(self) -> None:
        dev = self.bias.device
        self.ssf_scale = nn.Parameter(torch.ones(self.out_features, device=dev))
        self.ssf_shift = nn.Parameter(torch.zeros(self.out_features, device=dev))

    def quantize_int4_(self, block: int = QUANT_BLOCK) -> None:
        """Replace the weight by its int4 storage (``quantize_int4`` of the
        float32 weight; the JAX package's values and scales to the bit)."""
        if self.quantized:
            return
        from .peft_sam import quantize_int4
        q, scale = quantize_int4(self.weight.detach().float().t(), block)
        del self._parameters["weight"]
        self.register_buffer("w_q4", pack_int4(q.t()))
        self.register_buffer("w_scale", scale)

    def empty_int4_(self, block: int = QUANT_BLOCK) -> None:
        """int4 storage of zeros, to load a quantized state dict into."""
        if self.quantized:
            return
        dev = self.weight.device
        del self._parameters["weight"]
        self.register_buffer("w_q4", torch.zeros(self.out_features, self.in_features // 2,
                                                 dtype=torch.uint8, device=dev))
        self.register_buffer("w_scale", torch.zeros(self.in_features // block, self.out_features,
                                                    dtype=torch.bfloat16, device=dev))

    def hold_weight_in_(self, dtype: torch.dtype) -> None:
        """Keep the weight in ``dtype`` (a kernel chain's working type); the
        bias stays float32. int4 storage stays as it is."""
        if self.quantized:
            return
        self.weight = nn.Parameter(self.weight.detach().to(dtype),
                                   requires_grad=self.weight.requires_grad)

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
    """nn.Conv2d over channel-last input, in its input's dtype, in a form
    whose backward repeats bit for bit: a stride-1 kernel (1 x 1 included)
    is ``conv2d_nchw``, cuDNN's forward; a larger kernel that is its stride
    ``conv2d_product``. The port's models build no other (TinyViT's
    ``Conv2dBN`` calls ``conv2d`` itself)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.padding[0] if isinstance(self.padding, tuple) else self.padding
        k, stride = self.kernel_size[0], self.stride[0]
        if self.groups == 1 and stride == 1:
            return conv2d_nchw(x.permute(0, 3, 1, 2), self.weight, self.bias, pad).permute(0, 2, 3, 1)
        if self.groups == 1 and k == stride and pad == 0:
            return conv2d_product(x, self.weight, self.bias, k)
        raise ValueError(f"Conv2d: kernel {k}, stride {stride}, groups {self.groups} has no "
                         f"repeatable form")

    def init_(self, g: torch.Generator) -> None:
        fan_in = self.in_channels // self.groups * self.kernel_size[0] * self.kernel_size[1]
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


class BatchNorm(nn.Module):
    """Frozen-statistics BatchNorm over the channel (last) axis, eps 1e-5: the
    running statistics are buffers used as they are, never updated (the
    frozen-BN finetuning regime of ``micro_sam_tpu/models/common.py::batch_norm``).
    Keys as ``nn.BatchNorm2d``'s: weight, bias, running_mean, running_var. It
    is applied as the per-channel scale and shift of ``fold_bn``, folded into
    the convolution before it (``Conv2d_BN``)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.eps = eps


def fold_bn(bn: BatchNorm):
    """The BN as a per-channel (scale, shift) in float32 (float64 for a float64
    BN): bn(x) = x * scale + shift."""
    acc = torch.promote_types(bn.weight.dtype, torch.float32)
    scale = bn.weight.to(acc) * torch.rsqrt(bn.running_var.to(acc) + bn.eps)
    return scale, bn.bias.to(acc) - bn.running_mean.to(acc) * scale


class KeepsDerived(nn.Module):
    """A module that keeps what it derives from its parameters (a folded
    weight, gathered tables) while autograd is off, so that a forward without
    gradients derives it once, not per call. Each result is kept under a key
    with the version and storage of every tensor it was made from: an
    in-place write, a state-dict load or a move makes it anew."""

    def __init__(self):
        super().__init__()
        self._derived = {}

    def derived(self, key, sources, make):
        """``make()``, or what it gave for ``key`` while ``sources`` were as now."""
        stamp = tuple((t._version, t.data_ptr()) for t in sources)
        keep = not torch.is_grad_enabled()
        hit = self._derived.get(key)
        if keep and hit is not None and hit[0] == stamp:
            return hit[1]
        out = make()
        if keep:
            self._derived[key] = (stamp, out)
        return out

    def _apply(self, fn, *args, **kwargs):
        self._derived = {}
        return super()._apply(fn, *args, **kwargs)


class Conv2d_BN(KeepsDerived):
    """A bias-free convolution followed by a frozen BatchNorm (TinyViT's
    ``Conv2d_BN``; keys ``c.weight`` and ``bn.*``), over channel-last input.

    ``folded(dtype)`` gives the BN folded into the convolution: the weight
    times the BN scale over its output channels, computed in float32 and then
    cast to ``dtype``, with the BN scale and shift in float32; kept per dtype
    (``KeepsDerived``). ``forward`` is the convolution with the folded weight
    and the shift as its bias."""

    def __init__(self, in_ch: int, out_ch: int, ks: int = 1, stride: int = 1, pad: int = 0,
                 groups: int = 1):
        super().__init__()
        self.c = Conv2d(in_ch, out_ch, ks, stride=stride, padding=pad, groups=groups, bias=False)
        self.bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, _, shift = self.folded(x.dtype)
        c = self.c
        return conv2d(x, w, shift, c.stride[0], c.padding[0], c.groups)

    def folded(self, dtype: torch.dtype):
        """(weight * scale in ``dtype`` (O, I / groups, kh, kw), scale f32, shift f32)."""
        def fold():
            scale, shift = fold_bn(self.bn)
            return (self.c.weight.float() * scale.view(-1, 1, 1, 1)).to(dtype), scale, shift
        bn = self.bn
        return self.derived(dtype, (self.c.weight, bn.weight, bn.bias, bn.running_mean,
                                    bn.running_var), fold)


class Embedding(nn.Module):
    """A learned table with the zoo's ``<name>.weight`` key."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num, dim))

    def init_(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(generator=g)


class Adapter(nn.Module):
    """AdaptFormer's bottleneck beside an MLP: ``scale * relu(x down) up``;
    down (dim, proj), up (proj, dim), scale a scalar (JAX's orientation)."""

    def __init__(self, dim: int, proj: int, scale: float = 1.0):
        super().__init__()
        self.down = nn.Parameter(torch.zeros(dim, proj))
        self.up = nn.Parameter(torch.zeros(proj, dim))
        self.scale = nn.Parameter(torch.tensor(float(scale)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        down = F.relu(x @ self.down.to(x.dtype))
        return (self.scale * (down @ self.up.to(x.dtype)).float()).to(x.dtype)


class MLPBlock(nn.Module):
    """lin2(gelu(lin1(x))): the encoder / two-way-transformer MLP; PEFT may
    add an AdaptFormer ``adapter`` beside it."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = Linear(dim, hidden)
        self.lin2 = Linear(hidden, dim)
        self.register_module("adapter", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_block(self, x)


def mlp_block(m: MLPBlock, x: torch.Tensor) -> torch.Tensor:
    y = m.lin2(gelu(m.lin1(x)))
    if m.adapter is not None:
        y = y + m.adapter(x)
    return y


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
