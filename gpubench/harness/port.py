"""The one module that builds the program under test (``micro_sam_tpu_torch``)
from the benchmark's configuration and weights."""
from __future__ import annotations

import sys

import torch

from .spec import ROOT

if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def sam_config(cfg: dict):
    """The port's ``SamConfig`` for a configuration file's dict."""
    from micro_sam_tpu_torch.models.sam import SamConfig
    return SamConfig(model_type=cfg["model_type"], img_size=cfg["image_size"],
                     patch_size=cfg["vit_patch_size"], embed_dim=cfg["encoder_embed_dim"],
                     depth=cfg["encoder_depth"], num_heads=cfg["encoder_num_heads"],
                     mlp_ratio=cfg["mlp_ratio"], window_size=cfg["window_size"],
                     global_attn_indexes=tuple(cfg["encoder_global_attn_indexes"]),
                     prompt_embed_dim=cfg["prompt_embed_dim"],
                     compute_dtype=cfg["compute_dtype"])


def build_predictor(cfg: dict, state_dict, device):
    """A ``SamPredictor`` over the port's ``Sam`` holding ``state_dict`` (the
    published layout), built on ``device`` through ``make_sam``, the port's
    construction from a checkpoint: nothing is drawn on the host and no file
    is written."""
    from micro_sam_tpu_torch.models.build_sam import make_sam
    from micro_sam_tpu_torch.predictor import SamPredictor
    with torch.device(device):
        sam = make_sam(sam_config(cfg), state_dict=state_dict)
    predictor = SamPredictor(sam.to(device).eval())
    predictor.model_type = predictor.model_name = cfg["model_type"]
    return predictor


def util():
    from micro_sam_tpu_torch import util as port_util
    return port_util


def launch_counts() -> dict:
    """The port's own launch counters of the encoder's kernels."""
    from micro_sam_tpu_torch.ops import gemm, layernorm, relpos_attention
    return {"gemm": gemm.gemm.launches, "layernorm": layernorm.layernorm.launches,
            "relpos_attention": relpos_attention.relpos_attention.launches}


def build_seconds() -> float:
    """Seconds the port's kernel libraries took to build in this process (0 when
    they were built already)."""
    from micro_sam_tpu_torch.ops import _cuda
    return float(_cuda.build_seconds)


def predictor_for(ctx):
    """The predictor of a run: the cell's configuration with its weights drawn
    from the seed on the card (set-up phases ``weights`` and ``model``)."""
    from .weights import make_state_dict
    weights = make_state_dict(ctx.cell.config, ctx.seed, ctx.device)
    ctx.mark("weights")
    predictor = build_predictor(ctx.cell.config, weights, ctx.device)
    ctx.mark("model")
    return predictor
