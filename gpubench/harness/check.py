"""What decides ``correct``: the reference run over the inputs whose answers
the window produced, the numbers compared, and a seeded sample of answers.

The reference (``reference/sam.py``) takes the same configuration, the
weights drawn again from the seed and the inputs the benchmark made; it runs
after the window, once the program is freed, one image at a time.
"""
from __future__ import annotations

import gc
import random
from typing import Iterable, List

import numpy as np
import torch

from reference.sam import Precision, no_tf32

from . import data
from .weights import make_reference


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from the seed
    (reservoir sampling: the window need not know how many will come)."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self.rng = random.Random(int(seed) ^ 0x7E57)

    def offer(self, make_item) -> None:
        """Offer the next item; ``make_item()`` is called only if it is kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make_item())
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = make_item()


def free_cuda() -> None:
    gc.collect()
    torch.cuda.empty_cache()


@torch.no_grad()
def reference_embeddings(model, images: Iterable[np.ndarray], device,
                         precision: str = "float32") -> List[torch.Tensor]:
    """(256, 64, 64) float32 embeddings, on the host, of each (H, W, 3) image."""
    prec = Precision(precision)
    out = []
    with no_tf32():
        for img in images:
            x = torch.from_numpy(np.ascontiguousarray(img)).to(device)[None]
            out.append(model.embed(x, prec)[0].float().cpu())
    return out


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref||, both float32."""
    got, ref = got.float(), ref.float()
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def control_embeddings(ctx, n: int, precision: str = "fp8") -> float:
    """The control's reading for an embedding cell: the reference put in the
    program's place and computed in ``precision`` (the step below the
    configuration's bfloat16), over the first ``n`` images the window would
    take, against the float32 reference: the worst relative error."""
    t = ctx.cell.traffic
    pool = data.image_pool(ctx.seed, t["pool"], t["height"], t["width"], ctx.device)
    order = data.order(ctx.seed, t["pool"])
    images = [pool[next(order)] for _ in range(n)]
    model = make_reference(ctx.cell.config, ctx.seed, ctx.device)
    refs = reference_embeddings(model, images, ctx.device)
    lower = reference_embeddings(model, images, ctx.device, precision)
    return max(rel_err(c, r) for c, r in zip(lower, refs))
