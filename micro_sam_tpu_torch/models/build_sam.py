"""SAM model configurations (vit_b / vit_l / vit_h; vit_t awaits its slice)."""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch

from .sam import Sam, SamConfig

SAM_CONFIGS = {
    "vit_b": SamConfig(model_type="vit_b", embed_dim=768, depth=12, num_heads=12,
                       global_attn_indexes=(2, 5, 8, 11)),
    "vit_l": SamConfig(model_type="vit_l", embed_dim=1024, depth=24, num_heads=16,
                       global_attn_indexes=(5, 11, 17, 23)),
    "vit_h": SamConfig(model_type="vit_h", embed_dim=1280, depth=32, num_heads=16,
                       global_attn_indexes=(7, 15, 23, 31)),
    # TinyViT (MobileSAM): Sam() raises until the encoder is ported
    "vit_t": SamConfig(model_type="vit_t", encoder="tiny_vit", embed_dim=320, depth=12,
                       num_heads=10),
}


def get_config(model_type: str, compute_dtype: Optional[str] = None) -> SamConfig:
    base = model_type[:5]  # "vit_b" from "vit_b_lm"
    if base not in SAM_CONFIGS:
        raise ValueError(f"Unknown model type {model_type}; options: {list(SAM_CONFIGS)}")
    cfg = SAM_CONFIGS[base]
    return cfg if compute_dtype is None else replace(cfg, compute_dtype=compute_dtype)


def resolve_device(device: Optional[str]) -> torch.device:
    """``None`` means the GPU; asking for it without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU.")
    return dev


def default_compute_dtype(device: torch.device) -> str:
    return "bfloat16" if device.type == "cuda" else "float32"


def build_sam(model_type: str, seed: int = 0, compute_dtype: Optional[str] = None,
              device: Optional[str] = None) -> Sam:
    """Random-init SAM (weights drawn on the CPU from ``seed``, then moved).

    ``device=None`` means the GPU; ``compute_dtype=None`` is bfloat16 there and
    float32 on the CPU."""
    dev = resolve_device(device)
    sam = Sam(get_config(model_type, compute_dtype or default_compute_dtype(dev)))
    sam.init_(torch.Generator().manual_seed(seed))
    return sam.to(dev).eval()
