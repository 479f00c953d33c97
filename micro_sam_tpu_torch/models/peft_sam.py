"""Parameter-efficient finetuning (PEFT): surgery on a SAM's modules.

Counterpart of ``micro_sam_tpu/models/peft_sam.py``. The JAX package adds
keys to its parameter tree; here the surgery gives the encoder's modules the
same parameters, under the same names (``models/convert.py`` maps one to the
other), and the forward applies them where present:

- ``lora``: low-rank updates ``(x a) b`` of the attention's q / v (and k, and
  the MLP's two products with ``"mlp"`` in ``update_matrices``); a drawn, b
  zero;
- ``fact``: FacT, a core ``u (dim, r)`` / ``v (r, dim)`` shared by the blocks
  and per-block diagonal scales of q and v: ``(x (u * s)) v``;
- ``ssf``: a scale and shift of the outputs of qkv, proj, lin1 and lin2;
- ``adaptformer``: a bottleneck adapter beside each MLP;
- ``attention_tuning`` / ``bias_tuning`` / ``layernorm_tuning`` /
  ``classical`` (the last ``unfreeze_blocks`` blocks): which encoder
  parameters train, nothing added;
- ``quantize=True``: the blocks' four base products stored as int4 (two a
  byte) with bf16 scales per 64 input rows, dequantized at each read (QLoRA).

Trainability is ``get_peft_mask``, a map from state-dict names to bools equal
to the JAX package's optax mask, which ``freeze_peft_`` realizes with
``requires_grad_``. A block that PEFT changed runs the encoder's kernel
chains with the PEFT terms around their products (K1 on the qkv rows with
the LoRA / FacT updates; ``ops/fused_window_block.py``), and K1 / K4 in
training.

Where the JAX package draws FacT's ``v`` as zeros and its scales as zeros
(so every FacT gradient is zero), the port keeps ``v`` zero, as upstream's
FacTv, and starts the scales at one, so the first step moves ``v``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from . import common as cm

QUANT_BLOCK = cm.QUANT_BLOCK
SURGERIES = ("lora", "fact", "ssf", "adaptformer", "attention_tuning", "bias_tuning",
             "layernorm_tuning", "classical")


class FacTScales(nn.Module):
    """A block's FacT scales of q and v (keys ``attn.fact.q_scale`` /
    ``attn.fact.v_scale``)."""

    def __init__(self, rank: int, device=None):
        super().__init__()
        self.q_scale = nn.Parameter(torch.ones(rank, device=device))
        self.v_scale = nn.Parameter(torch.ones(rank, device=device))


def _lora(in_dim: int, out_dim: int, rank: int, g: torch.Generator, device) -> cm.LoRA:
    """A drawn ``a`` (normal / sqrt(in)) and a zero ``b``: the standard LoRA start."""
    m = cm.LoRA(in_dim, out_dim, rank)
    with torch.no_grad():
        m.a.copy_(torch.randn(in_dim, rank, generator=g) / math.sqrt(in_dim))
    return m.to(device)


def apply_peft(sam, rank: Optional[int] = None, peft_module: str = "lora",
               attention_layers_to_update: Optional[Sequence[int]] = None,
               update_matrices: Sequence[str] = ("q", "v"), projection_size: int = 64,
               alpha: float = 1.0, dropout: Optional[float] = None, quantize: bool = False,
               generator: Optional[torch.Generator] = None, **kwargs):
    """Give ``sam``'s encoder the PEFT parameters of ``peft_module``, in place;
    returns ``sam``. New parameters are drawn on the CPU from ``generator``
    (default: seed 42, as the JAX package's ``PRNGKey(42)``) and are float32.
    ``alpha`` and ``dropout`` are accepted for the reference's signature, as
    in the JAX package. ``quantize`` stores the blocks' base products as int4
    (``quantize_encoder_int4``)."""
    if sam.config.encoder != "vit":
        raise ValueError(f"PEFT needs a ViT encoder (vit_b / vit_l / vit_h); "
                         f"{sam.config.model_type} has the TinyViT encoder")
    name = peft_module.lower()
    if name not in SURGERIES:
        raise ValueError(f"Unknown peft_module: {peft_module}")
    enc = sam.image_encoder
    blocks = enc.blocks
    rank = rank or 4
    g = generator if generator is not None else torch.Generator().manual_seed(42)
    dev = enc.pos_embed.device
    layers = range(len(blocks)) if attention_layers_to_update is None \
        else attention_layers_to_update
    for i in layers:
        block = blocks[i]
        attn, mlp = block.attn, block.mlp
        dim = attn.qkv.in_features
        if name == "lora":
            attn.lora = nn.ModuleDict({p: _lora(dim, dim, rank, g, dev)
                                       for p in ("q", "k", "v") if p in update_matrices})
            if "mlp" in update_matrices:
                hidden = mlp.lin1.out_features
                mlp.lin1.lora = _lora(dim, hidden, rank, g, dev)
                mlp.lin2.lora = _lora(hidden, dim, rank, g, dev)
        elif name == "fact":
            if enc.fact_u is None:
                enc.fact_u = nn.Parameter((torch.randn(dim, rank, generator=g) * 0.02).to(dev))
                enc.fact_v = nn.Parameter(torch.zeros(rank, dim, device=dev))
            attn.fact = FacTScales(rank, dev)
        elif name == "ssf":
            for lin in (attn.qkv, attn.proj, mlp.lin1, mlp.lin2):
                lin.add_ssf_()
        elif name == "adaptformer":
            adapter = cm.Adapter(dim, projection_size, float(kwargs.get("adapter_scale", 1.0)))
            with torch.no_grad():
                adapter.down.copy_(torch.randn(dim, projection_size, generator=g)
                                   / math.sqrt(dim))
            mlp.adapter = adapter.to(dev)
    if quantize:
        quantize_encoder_int4(enc)
    return sam


# ---------------------------------------------------------------------------
# int4 weight storage (QLoRA)
# ---------------------------------------------------------------------------

def quantize_int4(w: torch.Tensor, block: int = QUANT_BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric blockwise int4 quantization of an (in, out) weight, the JAX
    package's to the bit: per (input block, output column) the absmax / 7
    (+1e-12) in float32, values rounded half to even and clipped to [-7, 7].
    Returns (q int8 (in, out), scale bf16 (in / block, out))."""
    in_dim, out_dim = w.shape
    if in_dim % block:
        raise ValueError(f"quantize_int4: {in_dim} input rows are not whole blocks of {block}")
    wb = w.float().reshape(in_dim // block, block, out_dim)
    scale = wb.abs().amax(dim=1) / 7.0 + 1e-12
    q = torch.clamp(torch.round(wb / scale[:, None, :]), -7, 7)
    return q.to(torch.int8).reshape(in_dim, out_dim), scale.to(torch.bfloat16)


def dequantize_int4(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(q (in, out), scale (in / block, out)) -> the dense (in, out) weight in
    the scale's dtype (the JAX package's ``dequantize_int4``)."""
    return cm.dequantize_packed(cm.pack_int4(q.t()), scale).t()


def quantize_encoder_int4(enc) -> None:
    """Store the base products of every encoder block (qkv, proj, lin1, lin2)
    as int4, in place; biases, norms, rel-pos tables, patch embed, neck and
    every PEFT parameter stay as they are."""
    for block in enc.blocks:
        for lin in (block.attn.qkv, block.attn.proj, block.mlp.lin1, block.mlp.lin2):
            lin.quantize_int4_()


# ---------------------------------------------------------------------------
# which parameters train
# ---------------------------------------------------------------------------

def _jax_leaf(module: nn.Module, leaf: str) -> str:
    """The JAX package's leaf name of a port parameter or buffer."""
    if isinstance(module, (cm.Linear, nn.Conv2d, nn.ConvTranspose2d, cm.Embedding)):
        return {"weight": "w", "bias": "b"}.get(leaf, leaf)
    if isinstance(module, (cm.LayerNorm, cm.BatchNorm)):
        return {"weight": "scale", "running_mean": "mean", "running_var": "var"}.get(leaf, leaf)
    return leaf


def _jax_paths(sam) -> Dict[str, str]:
    """State-dict name -> a '/'-joined path with the JAX package's leaf names
    (module names as the port's: the mask's rules read only leaf names and
    the names of the encoder's blocks, norms and PEFT modules, which agree)."""
    modules = dict(sam.named_modules())
    out = {}
    for name in sam.state_dict():
        mod_name, _, leaf = name.rpartition(".")
        out[name] = "/" + "/".join(mod_name.split(".") + [_jax_leaf(modules[mod_name], leaf)])
    return out


def get_peft_mask(sam, peft_module: str = "lora",
                  unfreeze_blocks: Optional[int] = None) -> Dict[str, bool]:
    """Which of ``sam``'s state-dict entries train: {name: bool}, the JAX
    package's optax mask under the converter's names. The prompt encoder and
    mask decoder train; of the encoder, the PEFT parameters (``lora``,
    ``fact``, ``ssf``, adapters, the depth adapters of the 3d wrapper), or for
    the selective surgeries the biases / norms / attention, or with
    ``classical`` the last ``unfreeze_blocks`` blocks whole."""
    name = peft_module.lower()

    def encoder_rule(path: str) -> bool:
        if name == "bias_tuning":
            return path.endswith("/b") or path.endswith("/bias")
        if name == "layernorm_tuning":
            return "/norm" in path or path.endswith("scale")
        if name == "attention_tuning":
            return "/attn/" in path
        return "/lora" in path or "ssf" in path or "/adapter" in path or "fact" in path

    n_blocks = len(sam.image_encoder.blocks) if hasattr(sam.image_encoder, "blocks") else 0
    mask = {}
    for key, path in _jax_paths(sam).items():
        if not key.startswith("image_encoder."):
            mask[key] = True
            continue
        parts = key.split(".")
        if (name == "classical" and unfreeze_blocks and parts[1] == "blocks"
                and int(parts[2]) >= n_blocks - unfreeze_blocks):
            mask[key] = True
            continue
        mask[key] = encoder_rule(path[len("/image_encoder"):])
    return mask


def freeze_peft_(sam, mask: Dict[str, bool]) -> None:
    """``requires_grad_`` of every parameter by ``mask`` (buffers have none)."""
    for key, p in sam.named_parameters():
        p.requires_grad_(bool(mask[key]))


# ---------------------------------------------------------------------------
# the reference's class surface: selectors passed as
# ``PEFT_Sam(sam, peft_module=LoRASurgery)``
# ---------------------------------------------------------------------------

class _SurgeryName:
    """Base of the reference's surgery selector classes."""
    peft_module_name = "lora"


class LoRASurgery(_SurgeryName):
    """Low-rank adaptation of the attention (and optionally MLP) products."""
    peft_module_name = "lora"


class AttentionLoRA(_SurgeryName):
    """LoRA over the attention's projections."""
    peft_module_name = "lora"


class MLPLoRA(_SurgeryName):
    """LoRA over the MLP (``update_matrices=("q", "v", "mlp")``)."""
    peft_module_name = "lora"


class FacTSurgery(_SurgeryName):
    """Factorized tuning: a shared low-rank core and per-block scales."""
    peft_module_name = "fact"


class ScaleShiftLayer(_SurgeryName):
    """Per-feature scale and shift (SSF's building block)."""
    peft_module_name = "ssf"


class SSFSurgery(_SurgeryName):
    """Scale-shift tuning of the attention and MLP outputs."""
    peft_module_name = "ssf"


class AdaptFormer(_SurgeryName):
    """A bottleneck adapter beside each MLP."""
    peft_module_name = "adaptformer"


class SelectiveSurgery(_SurgeryName):
    """Base of the surgeries that only choose what trains."""
    peft_module_name = "classical"


class AttentionSurgery(SelectiveSurgery):
    """Only the attention layers train."""
    peft_module_name = "attention_tuning"


class BiasSurgery(SelectiveSurgery):
    """Only the biases train."""
    peft_module_name = "bias_tuning"


class LayerNormSurgery(SelectiveSurgery):
    """Only the layer norms train."""
    peft_module_name = "layernorm_tuning"


class ClassicalSurgery(SelectiveSurgery):
    """The last ``unfreeze_blocks`` encoder blocks train."""
    peft_module_name = "classical"


class PEFT_Sam:
    """Applies a surgery to ``sam`` and freezes the encoder's base weights by
    its mask (upstream's ``PEFT_Sam``); the mask stays as ``mask``. Attribute
    access falls through to the SAM."""

    def __init__(self, sam, rank: Optional[int] = None, peft_module="lora", **kwargs):
        if isinstance(peft_module, str):
            module_name = peft_module
        elif isinstance(peft_module, type) and issubclass(peft_module, _SurgeryName):
            module_name = peft_module.peft_module_name
        else:
            module_name = getattr(peft_module, "__name__", "lora").lower().replace("surgery", "")
        self.peft_module = module_name
        self.sam = apply_peft(sam, rank=rank, peft_module=module_name, **kwargs)
        self.mask = get_peft_mask(sam, module_name, unfreeze_blocks=kwargs.get("unfreeze_blocks"))
        freeze_peft_(sam, self.mask)

    def __getattr__(self, item):
        return getattr(self.sam, item)
