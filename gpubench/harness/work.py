"""Work counted from shapes: the peaks, a kernel call's operations and
bytes, and a model's operations.

``call_ms`` is a frozen copy of ``chip_smoke.py::work`` (each input read
once, each output written once, against the data-sheet peaks), taking the
shapes that ``trace.KernelCalls`` records. ``vit_encode_flops`` counts the
operations of the logical model from the configuration: upstream SAM's
encoder, whose windowed blocks compute qkv, attention and proj on the
windows of the padded map and the MLP on the unpadded one. Neither reads
how the program computes, so a program that changes its kernels is read
on the same work.
"""
from __future__ import annotations

import math
from typing import Tuple

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_BF16 = 989e12    # bf16 tensor-core flop/s
PEAK_F32 = 67e12      # f32 flop/s outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3 bytes/s


def call_ms(call: tuple) -> Tuple[float, float]:
    """(operations ms, bytes ms) of one recorded kernel call at the peaks.

    ``call`` is ``(name, shapes...)`` as ``trace.KernelCalls`` records it:
    ``("gemm", M, K, N, itemsize, residual)``,
    ``("relpos_attention", B, nH, N, hd, H, W, itemsize)``,
    ``("relpos_attention_backward", B, nH, N, hd, H, W, itemsize)``,
    ``("layernorm", M, C, itemsize, masked)``."""
    name = call[0]
    if name == "gemm":
        _, M, K, N, s, residual = call
        ops, nbytes, rate = 2 * M * N * K, (M * K + N * K + M * N * (2 if residual else 1)) * s \
            + N * 4, PEAK_BF16 if s == 2 else PEAK_F32
    elif name == "relpos_attention":
        _, B, nH, N, hd, H, W, s = call
        ops = B * nH * (4 * N * N * hd + 2 * N * (H + W) * hd)
        nbytes = 4 * B * nH * N * hd * s + (H * H + W * W) * hd * s
        rate = PEAK_BF16 if s == 2 else PEAK_F32
    elif name == "relpos_attention_backward":  # S again, dP, dv, dk, dq; the tables' terms
        _, B, nH, N, hd, H, W, s = call
        ops = B * nH * (10 * N * N * hd + 6 * N * (H + W) * hd)
        nbytes = 8 * B * nH * N * hd * s + (H * H + W * W) * hd * (s + 4)
        rate = PEAK_BF16 if s == 2 else PEAK_F32
    elif name == "layernorm":
        _, M, C, s, masked = call
        ops, nbytes, rate = 8 * M * C, 2 * M * C * s + 2 * C * 4 + (M * 4 if masked else 0), PEAK_F32
    else:
        raise ValueError(f"no work count for kernel {name!r}")
    return ops / rate * 1e3, nbytes / PEAK_BYTES * 1e3


def bound_ms(calls) -> float:
    """The least device time of the calls run one after another: each call's
    larger of its operations and its bytes at the peaks, summed."""
    return sum(max(call_ms(c)) for c in calls)


def vit_encode_flops(cfg: dict) -> float:
    """Operations of one image through the configuration's ViT encoder at
    its input size (patch embed, blocks, neck), as upstream SAM computes it."""
    C, heads = cfg["encoder_embed_dim"], cfg["encoder_num_heads"]
    hd = C // heads
    grid = cfg["image_size"] // cfg["vit_patch_size"]
    ws = cfg["window_size"]
    hidden = int(C * cfg["mlp_ratio"])
    tokens = grid * grid
    pad = math.ceil(grid / ws) * ws
    out = cfg["prompt_embed_dim"]
    flops = 2 * tokens * (3 * cfg["vit_patch_size"] ** 2) * C  # patch embed
    for i in range(cfg["encoder_depth"]):
        if i in cfg["encoder_global_attn_indexes"]:
            rows, n, h, w, windows = tokens, tokens, grid, grid, 1
        else:
            rows, n, h, w, windows = pad * pad, ws * ws, ws, ws, (pad // ws) ** 2
        flops += 2 * rows * C * 4 * C                                  # qkv, proj
        flops += windows * heads * (4 * n * n * hd + 2 * n * (h + w) * hd)  # attention, rel-pos
        flops += 2 * tokens * C * hidden * 2                           # MLP
    flops += 2 * tokens * C * out + 2 * tokens * out * out * 9         # neck
    return float(flops)
