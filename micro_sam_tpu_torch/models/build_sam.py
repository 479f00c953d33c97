"""SAM model configurations (vit_b / vit_l / vit_h, and vit_t with the TinyViT encoder)."""
from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, Optional

import torch

from .sam import Sam, SamConfig

SAM_CONFIGS = {
    "vit_b": SamConfig(model_type="vit_b", embed_dim=768, depth=12, num_heads=12,
                       global_attn_indexes=(2, 5, 8, 11)),
    "vit_l": SamConfig(model_type="vit_l", embed_dim=1024, depth=24, num_heads=16,
                       global_attn_indexes=(5, 11, 17, 23)),
    "vit_h": SamConfig(model_type="vit_h", embed_dim=1280, depth=32, num_heads=16,
                       global_attn_indexes=(7, 15, 23, 31)),
    # TinyViT (MobileSAM); its widths are models/tiny_vit.py's constants
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


def make_sam(cfg: SamConfig, state_dict: Optional[Dict[str, torch.Tensor]] = None, seed: int = 0,
             weight_dtype: Optional[torch.dtype] = None,
             peft_kwargs: Optional[Dict[str, Any]] = None) -> Sam:
    """The one construction of a SAM, on the CPU: float32 weights drawn from
    ``seed`` (or to be loaded); the PEFT surgery of ``peft_kwargs``
    (``peft_sam.apply_peft``); ``state_dict`` loaded, its PEFT parameters
    wherever it has them (a trained LoRA loads as trained, where the JAX
    package draws it anew) and a linear it holds as int4 as int4;
    ``quantize`` of ``peft_kwargs`` (on float32 weights, so it quantizes what
    the JAX package quantizes); last, the encoder blocks' product weights held
    in ``weight_dtype`` (default: the compute dtype; see ``Sam``)."""
    from .common import Linear
    from .convert import is_peft_key
    from .peft_sam import apply_peft, quantize_encoder_int4
    kwargs = dict(peft_kwargs or {})
    quantize = kwargs.pop("quantize", False)
    sam = Sam(cfg, torch.float32)
    if state_dict is None:
        sam.init_(torch.Generator().manual_seed(seed))
    if peft_kwargs:
        apply_peft(sam, **kwargs)
    if state_dict is not None:
        for name, mod in sam.named_modules():
            if isinstance(mod, Linear) and f"{name}.w_q4" in state_dict:
                mod.empty_int4_()
        missing, unexpected = sam.load_state_dict(state_dict, strict=False)
        missing = [k for k in missing if not is_peft_key(k)]
        if missing or unexpected:
            raise RuntimeError(f"checkpoint does not fit the model: missing {missing[:5]}, "
                               f"unexpected {unexpected[:5]}")
    if quantize:
        quantize_encoder_int4(sam.image_encoder)
    return sam.hold_weights_in_(weight_dtype or cfg.dtype)


def build_sam(model_type: str, seed: int = 0, compute_dtype: Optional[str] = None,
              device: Optional[str] = None, weight_dtype: Optional[torch.dtype] = None) -> Sam:
    """Random-init SAM (weights drawn on the CPU from ``seed``, then moved;
    ``make_sam``).

    ``device=None`` means the GPU; ``compute_dtype=None`` is bfloat16 there and
    float32 on the CPU; ``weight_dtype`` as in ``Sam``."""
    dev = resolve_device(device)
    cfg = get_config(model_type, compute_dtype or default_compute_dtype(dev))
    return make_sam(cfg, seed=seed, weight_dtype=weight_dtype).to(dev).eval()
