"""Inputs made from the seed: image pools.

Images are smooth random fields with grain, drawn on the card from the
seed (a few large calls) and brought to the host once, as uint8 (H, W, 3)
slices: what a user hands the program. The same seed gives the same pool;
every seed gives the same sizes.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

IMAGE_STREAM = 0x5EED_1A6E  # keeps the images' stream apart from the weights'


def image_pool(seed: int, n: int, height: int, width: int, device) -> np.ndarray:
    """(n, height, width, 3) uint8 images from ``seed``."""
    g = torch.Generator(device=device).manual_seed((int(seed) ^ IMAGE_STREAM) % (2 ** 63))
    low = torch.rand((n, 3, max(height // 32, 2), max(width // 32, 2)), generator=g,
                     device=device)
    smooth = F.interpolate(low, (height, width), mode="bilinear", align_corners=False)
    grain = torch.rand((n, 3, height, width), generator=g, device=device)
    x = (smooth * 200.0 + grain * 55.0).clamp_(0, 255).to(torch.uint8)
    return x.permute(0, 2, 3, 1).contiguous().cpu().numpy()


def order(seed: int, pool: int):
    """An endless stream of pool indices: each pass a permutation drawn
    from the seed."""
    rng = np.random.default_rng(int(seed))
    while True:
        yield from (int(i) for i in rng.permutation(pool))
