"""A SAM's weights from a seed, in the published state-dict layout.

The keys and shapes are the plain reference's (``reference/sam.py``), which
are segment-anything's. Every tensor is carved out of two draws made on the
target device with one ``torch.Generator``: a uniform one for the products'
weights and biases and the norms, a normal one for the embeddings and
tables. So a seed gives the same weights on every run, made in two large
calls, in float32:

- a product's weight (linear, convolution): U(-sqrt(3 / fan_in), +), its
  bias U(-1 / sqrt(fan_in), +), fan_in = the weight's size over its first
  axis;
- a norm's weight 1 + U(-0.1, 0.1), its bias U(-0.1, 0.1);
- ``pos_embed`` and the rel-pos tables N(0, 0.02^2);
- the prompt embeddings, the decoder's tokens and the random Fourier
  matrix N(0, 1).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from reference.sam import Sam as ReferenceSam


def _kind(key: str, shapes: Dict[str, Tuple[int, ...]]) -> str:
    leaf = key.rsplit(".", 1)[-1]
    if leaf in ("pos_embed", "rel_pos_h", "rel_pos_w"):
        return "table"
    if (leaf == "positional_encoding_gaussian_matrix" or "point_embed" in key
            or "no_mask_embed" in key or "iou_token" in key or "mask_tokens" in key):
        return "embedding"
    shape = shapes[key]
    if leaf == "weight":
        return "product_weight" if len(shape) >= 2 else "norm_weight"
    sibling = shapes.get(key[: -len("bias")] + "weight")
    return "product_bias" if sibling is not None and len(sibling) >= 2 else "norm_bias"


def make_reference(cfg: dict, seed: int, device) -> ReferenceSam:
    """The plain reference model of ``cfg`` on ``device`` holding the weights
    drawn from ``seed`` (float32). It is built on the device (its own
    initialization, overwritten here, is a few kernels there)."""
    with torch.device(device):
        model = ReferenceSam(cfg)
    tensors = model.state_dict()
    shapes = {k: tuple(v.shape) for k, v in tensors.items()}
    kinds = {k: _kind(k, shapes) for k in shapes}
    normal = [k for k in shapes if kinds[k] in ("table", "embedding")]
    uniform = [k for k in shapes if k not in normal]
    size = lambda keys: sum(math.prod(shapes[k]) for k in keys)
    g = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(size(uniform), generator=g, device=device)
    n = torch.randn(size(normal), generator=g, device=device)
    with torch.no_grad():
        at = 0
        for k in uniform:
            m = math.prod(shapes[k])
            t = u[at:at + m].view(shapes[k]) * 2 - 1  # U(-1, 1)
            at += m
            kind = kinds[k]
            if kind == "product_weight":
                t.mul_(math.sqrt(3.0 * shapes[k][0] / m))
            elif kind == "product_bias":
                w = shapes[k[: -len("bias")] + "weight"]
                t.mul_(1.0 / math.sqrt(math.prod(w) / w[0]))
            elif kind == "norm_weight":
                t.mul_(0.1).add_(1.0)
            else:
                t.mul_(0.1)
            tensors[k].copy_(t)
        at = 0
        for k in normal:
            m = math.prod(shapes[k])
            t = n[at:at + m].view(shapes[k])
            at += m
            tensors[k].copy_(t * 0.02 if kinds[k] == "table" else t)
    return model.eval()


def make_state_dict(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``cfg`` drawn from ``seed`` on ``device`` (float32), in
    the published layout."""
    return make_reference(cfg, seed, device).state_dict()
