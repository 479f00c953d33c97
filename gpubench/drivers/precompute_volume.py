"""Embedding precompute of whole z-stacks, closed loop, volumes back to back.

Each step hands one grey volume to ``util.precompute_image_embeddings(predictor,
volume, save_path=None, ndim=3, batch_size=<batch>, verbose=False)``, as a
microscopist's precompute before ``annotator_3d`` or 3d segmentation does:
the data signature (sha1 of the volume), each slice's min-max normalization
(``util._to_image``) and resize, ``encode_batch`` a batch at a time, the copy
out, and the zlib chunk writes of the in-memory cache. The volumes come from
a pool made in set-up and are taken in turn, so no call finds its
embeddings cached. The window counts the slices finished.

Traffic parameters: ``slices``, ``height``, ``width`` (a volume's shape; the
slices' sides are the model's input size, so the reference needs no
resize), ``top`` (the largest grey value: 4095 for 12-bit data), ``pool``,
``batch`` and ``check_slices`` (how many of the window's slices the
correctness check compares, drawn from the seed).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, List

import numpy as np
import torch
import torch.nn.functional as F

from harness import check, port
from reference.to_image import to_image

VOLUME_STREAM = 0x5EED_0D3D  # keeps the volumes' stream apart from the weights'


def volume_pool(seed: int, n: int, slices: int, height: int, width: int, top: int,
                device) -> List[np.ndarray]:
    """``n`` (slices, height, width) uint16 volumes from ``seed``: a smooth
    random field over the stack plus grain, in [0, top], drawn on the card
    and brought to the host once."""
    g = torch.Generator(device=device).manual_seed((int(seed) ^ VOLUME_STREAM) % (2 ** 63))
    out = []
    for _ in range(n):
        low = torch.rand((1, 1, max(slices // 8, 2), max(height // 32, 2), max(width // 32, 2)),
                         generator=g, device=device)
        smooth = F.interpolate(low, (slices, height, width), mode="trilinear",
                               align_corners=False)[0, 0]
        grain = torch.rand((slices, height, width), generator=g, device=device)
        x = ((smooth * 0.75 + grain * 0.25) * top).round_().clamp_(0, top)
        out.append(x.to(torch.int32).cpu().numpy().astype(np.uint16))
    return out


@dataclass
class State:
    ctx: Any
    pool: List[np.ndarray]
    predictor: Any
    util: Any
    sample: check.Reservoir
    steps: int = 0


def _precompute(state: State, volume: np.ndarray) -> np.ndarray:
    emb = state.util.precompute_image_embeddings(
        state.predictor, volume, save_path=None, ndim=3,
        batch_size=state.ctx.cell.traffic["batch"], verbose=False)
    return emb["features"]


def setup(ctx) -> State:
    t, cfg = ctx.cell.traffic, ctx.cell.config
    if (t["height"], t["width"]) != (cfg["image_size"], cfg["image_size"]):
        raise ValueError("the slices' sides must be the model's input size")
    pool = volume_pool(ctx.seed, t["pool"], t["slices"], t["height"], t["width"], t["top"],
                       ctx.device)
    ctx.mark("inputs")
    predictor = port.predictor_for(ctx)
    state = State(ctx=ctx, pool=pool, predictor=predictor, util=port.util(),
                  sample=check.Reservoir(t["check_slices"], ctx.seed))
    _precompute(state, pool[0][: t["batch"]])  # one batch: the window's shapes, built and warmed
    ctx.mark("warm-up")
    return state


def step(state: State):
    """One volume: (its pool index, its embeddings (slices, 1, 256, 64, 64))."""
    v = state.steps % len(state.pool)
    with state.ctx.stages.stage("precompute_volume"):
        feats = _precompute(state, state.pool[v])
    state.steps += 1
    return v, feats


def window(state: State, seconds: float) -> dict:
    state.steps = 0
    slices = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        v, feats = step(state)
        for z in range(len(feats)):
            state.sample.offer(lambda z=z: (v, z, feats[z, 0].copy()))
        slices += len(feats)
    elapsed = time.perf_counter() - t0
    return {"seconds": elapsed, "attempted": slices, "failed": 0, "images": slices,
            "steps": state.steps}


def end_to_end(state: State, win: dict) -> dict:
    return {"embed_images_per_s": win["images"] / win["seconds"]}


def release(state: State) -> None:
    state.predictor = None
    check.free_cuda()


def compared(state: State, win: dict) -> dict:
    """The worst relative error, over the sampled slices, of the program's
    embeddings against the reference's, which normalizes each slice itself
    (``reference/to_image.py``)."""
    ctx = state.ctx
    model = check.make_reference(ctx.cell.config, ctx.seed, ctx.device)
    items = state.sample.items
    refs = check.reference_embeddings(model, (to_image(state.pool[v][z]) for v, z, _ in items),
                                      ctx.device)
    return {"embed_rel_err": max(check.rel_err(torch.from_numpy(got), ref)
                                 for (_, _, got), ref in zip(items, refs))}


def control(ctx) -> dict:
    """``compared``'s number with the fp8 reference in the program's place,
    over the first volume's first ``check_slices`` slices."""
    t = ctx.cell.traffic
    volume = volume_pool(ctx.seed, 1, t["slices"], t["height"], t["width"], t["top"],
                         ctx.device)[0]
    images = [to_image(volume[z]) for z in range(t["check_slices"])]
    model = check.make_reference(ctx.cell.config, ctx.seed, ctx.device)
    refs = check.reference_embeddings(model, images, ctx.device)
    lower = check.reference_embeddings(model, images, ctx.device, "fp8")
    return {"embed_rel_err": max(check.rel_err(c, r) for c, r in zip(lower, refs))}
