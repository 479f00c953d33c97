"""TinyViT window attention kernel (``csrc/tiny_attention.cu``) and its plain
PyTorch version.

Per (window, head) of the zero-padded (B, Hp, Wp, C) map, hd = 32:

    out = softmax((q k^T) * hd^-0.5 + B[h, |dy| * w + |dx|]) v

q, k and v are read from the qkv product's rows in upstream TinyViT's
per-head order (head h: q at columns 96h, k at 96h + 32, v at 96h + 64); the
result is written to the same rows of a (B * Hp * Wp, C) tensor at column 32h,
the order the proj product reads. ``attention_biases`` is the learned
(nH, w^2) table; ``bias_offset_index`` numbers the offsets as upstream's
``attention_bias_idxs`` does.

Replaces the attention core of the TPU kernel
``micro_sam_tpu/ops/fused_tiny_attention.py::_tiny_attn_kernel``, whose
skip-max softmax (a fixed exponent offset of 16, clamped at 80) is not
ported: both versions here take the exact per-row maximum.

Bound on the H100: bytes (4 N hd flops per head and token against 4 hd
values moved, N = 49 or 196). One block per (window, head); bf16 keeps a whole
row of logits in registers on ``mma.sync``, f32 is a SIMT loop.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _cuda

HEAD_DIM = 32
WINDOWS = (7, 14)  # vit_t's stages


def bias_offset_index(window: int, device=None) -> torch.Tensor:
    """(N, N) index of each (query, key) pair's offset (|dy|, |dx|) into the
    (nH, w^2) bias table: |dy| * w + |dx|."""
    r = torch.arange(window * window, device=device)
    y, x = r // window, r % window
    return (y[:, None] - y[None, :]).abs() * window + (x[:, None] - x[None, :]).abs()


def tiny_attention_plain(qkv: torch.Tensor, attention_biases: torch.Tensor,
                         shape: Tuple[int, int, int], window: int) -> torch.Tensor:
    """qkv: (B * Hp * Wp, 3C) rows of the padded map; attention_biases (nH, w^2);
    shape (B, Hp, Wp). Returns (B * Hp * Wp, C) in qkv.dtype, computed in f32."""
    B, Hp, Wp = shape
    nH = attention_biases.shape[0]
    C = qkv.shape[1] // 3
    hd, w = C // nH, window
    ny, nx = Hp // w, Wp // w
    t = qkv.float().view(B, ny, w, nx, w, nH, 3, hd).permute(6, 0, 1, 3, 5, 2, 4, 7)
    q, k, v = t.reshape(3, B * ny * nx, nH, w * w, hd).unbind(0)
    bias = attention_biases.float()[:, bias_offset_index(w, qkv.device)]  # (nH, N, N)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * hd ** -0.5 + bias
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), v)
    o = o.view(B, ny, nx, nH, w, w, hd).permute(0, 1, 4, 2, 5, 3, 6)
    return o.reshape(B * Hp * Wp, C).to(qkv.dtype)


def tiny_attention(qkv: torch.Tensor, attention_biases: torch.Tensor,
                   shape: Tuple[int, int, int], window: int) -> torch.Tensor:
    """Window attention over the qkv rows of a padded (B, Hp, Wp) map. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    B, Hp, Wp = shape
    nH = attention_biases.shape[0]
    if qkv.dim() != 2 or qkv.shape[0] != B * Hp * Wp or qkv.shape[1] % (3 * nH):
        raise ValueError(f"tiny_attention: qkv {tuple(qkv.shape)} over the map {shape} "
                         f"with {nH} heads")
    if Hp % window or Wp % window or attention_biases.shape[1] != window * window:
        raise ValueError(f"tiny_attention: map {shape} and table "
                         f"{tuple(attention_biases.shape)} do not fit window {window}")
    if qkv.device.type == "cpu":
        return tiny_attention_plain(qkv, attention_biases, shape, window)
    if qkv.device.type != "cuda":
        raise RuntimeError(f"tiny_attention: unsupported device {qkv.device}")
    hd = qkv.shape[1] // (3 * nH)
    if hd != HEAD_DIM or window not in WINDOWS:
        raise ValueError(f"tiny_attention: head dim {hd} / window {window} not built "
                         f"(head dim {HEAD_DIM}, windows {WINDOWS})")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("tiny_attention: qkv must be contiguous and 16-byte aligned")
    table = attention_biases.to(device=qkv.device, dtype=torch.float32).contiguous()
    out = torch.empty((qkv.shape[0], nH * hd), device=qkv.device, dtype=qkv.dtype)
    lib = _cuda.library("tiny_attention")
    rc = lib.msam_tiny_attention(qkv.data_ptr(), table.data_ptr(), out.data_ptr(), B, Hp, Wp,
                                 nH, window, hd, float(hd ** -0.5), _cuda.dtype_code(qkv),
                                 _cuda.stream_ptr(qkv))
    _cuda.check("tiny_attention", rc)
    tiny_attention.launches += 1
    return out


tiny_attention.launches = 0
