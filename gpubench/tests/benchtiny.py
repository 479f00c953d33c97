"""A cell of the benchmark at a size the CPU holds, for the tests: the
drivers, the checks and the plain reference as the card runs them, with the
encoder 64 wide, 2 blocks (one windowed, one global), on 256^2 images."""
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

import run  # noqa: E402
from harness import spec  # noqa: E402
from harness.trace import StageLog  # noqa: E402

TRAFFIC = {
    "embed_batch": {"driver": "embed_batch", "batch": 4, "pool": 8, "height": 256, "width": 256,
                    "check_batches": 2},
}
CELLS = {"embed_batch": "vit_h.embed_b8"}


def tiny_config():
    with open(os.path.join(BENCH, "configs", "sam_vit_h.json")) as f:
        cfg = json.load(f)
    cfg.update(encoder_embed_dim=64, encoder_depth=2, encoder_num_heads=2,
               encoder_global_attn_indexes=[1], image_size=256, compute_dtype="float32")
    return cfg


def tiny_cell(driver: str) -> spec.Cell:
    """The committed cell of ``driver`` (its limits, its metrics) at the tiny size."""
    cell = spec.load_cell(CELLS[driver])
    cell.config = tiny_config()
    cell.traffic = dict(TRAFFIC[driver])
    return cell


def run_tiny(driver: str, seed: int = 2 ** 31 + 11, seconds: float = 0.5) -> dict:
    return run.run_cell(tiny_cell(driver), seed, seconds, False, torch.device("cpu"), time.time())


def context(cell, seed):
    return run.Context(cell, seed, torch.device("cpu"), StageLog())
