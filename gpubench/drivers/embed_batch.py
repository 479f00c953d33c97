"""Embedding precompute of a stack of slices, closed loop, batches back to back.

Each step gathers a batch of uint8 slices at the model's input size from a
pool made in set-up (in an order drawn from the seed), embeds it with
``SamPredictor.encode_batch`` and brings the embeddings to the host in the
cache layout (``util._features_to_cache_layout``: NCHW float32), as
``util._compute_3d`` does with each batch. ``_compute_3d``'s per-slice
min-max normalization (``util._to_image``) is left out: it is host work
that would hide the encoder (``PERF.md``, Open questions).

Traffic parameters: ``batch``, ``pool``, ``height``, ``width`` (the slices'
size) and ``check_batches`` (how many of the window's batches the
correctness check compares, drawn from the seed).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from harness import check, data, port

WARMUP_STEPS = 2


@dataclass
class State:
    ctx: Any
    pool: np.ndarray
    predictor: Any
    order: Any
    util: Any
    sample: check.Reservoir
    steps: int = 0


def setup(ctx) -> State:
    t = ctx.cell.traffic
    pool = data.image_pool(ctx.seed, t["pool"], t["height"], t["width"], ctx.device)
    ctx.mark("inputs")
    predictor = port.predictor_for(ctx)
    state = State(ctx=ctx, pool=pool, predictor=predictor, order=data.order(ctx.seed, t["pool"]),
                  util=port.util(), sample=check.Reservoir(t["check_batches"], ctx.seed))
    for _ in range(WARMUP_STEPS):  # the shapes of the window's steps, built and warmed
        step(state)
    state.steps = 0
    ctx.mark("warm-up")
    return state


def step(state: State):
    """One batch: (pool indices, host embeddings (B, 256, 64, 64))."""
    t, stages, util = state.ctx.cell.traffic, state.ctx.stages, state.util
    idx = [next(state.order) for _ in range(t["batch"])]
    with stages.stage("slice_prep"):
        batch = state.pool[idx]
    with stages.stage("encode_batch"):
        feats = state.predictor.encode_batch(batch)
    with stages.stage("copy_out"):
        out = util._features_to_cache_layout(feats)
    state.steps += 1
    return idx, out


def window(state: State, seconds: float) -> dict:
    state.steps = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        idx, out = step(state)
        state.sample.offer(lambda: (idx, out))
    elapsed = time.perf_counter() - t0
    images = state.steps * state.ctx.cell.traffic["batch"]
    return {"seconds": elapsed, "attempted": images, "failed": 0, "images": images,
            "steps": state.steps}


def end_to_end(state: State, win: dict) -> dict:
    return {"embed_images_per_s": win["images"] / win["seconds"]}


def release(state: State) -> None:
    state.predictor = None
    check.free_cuda()


def compared(state: State, win: dict) -> dict:
    """The worst relative error, over the sampled batches' slices, of the
    program's embeddings against the reference's."""
    ctx = state.ctx
    model = check.make_reference(ctx.cell.config, ctx.seed, ctx.device)
    pairs = [(i, out[j]) for idx, out in state.sample.items for j, i in enumerate(idx)]
    refs = check.reference_embeddings(model, (state.pool[i] for i, _ in pairs), ctx.device)
    return {"embed_rel_err": max(check.rel_err(torch.from_numpy(got), ref)
                                 for (_, got), ref in zip(pairs, refs))}


def control(ctx) -> dict:
    """``compared``'s number with the fp8 reference in the program's place."""
    t = ctx.cell.traffic
    return {"embed_rel_err": check.control_embeddings(ctx, t["check_batches"] * t["batch"])}
