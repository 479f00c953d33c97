"""The depthwise kernel's body and tile choice (``ops/dwconv.py::dwconv_plan``)
on the CPU, by the rules ``csrc/dwconv.cu`` checks, and the wrapper's (9, C)
re-layout of the weight.

The kernel itself runs only on the card (tests/test_torch_cuda.py holds both
bodies against the plain version); here the choice is pinned for every C
from 8 to 1280 and odd and small maps: the TMA body exactly where C's bytes
are a multiple of 16 and the addresses 16-byte aligned, the channel slab
dividing C, the tile within the kernel's limits (256 threads, a TMA box of at
most 256 a side, two halo slots in shared memory), and enough tiles for the
SMs where the map has them.
"""
import pytest
import torch

SMEM_LIMIT = 232448


def _check(plan, B, H, W, C, elt, align):
    from micro_sam_tpu_torch.ops.dwconv import MAX_THREADS, SMS
    tma = (C * elt) % 16 == 0 and align % 16 == 0
    assert plan.body == ("tma" if tma else "plain")
    v = plan.vec
    assert v >= 1 and v & (v - 1) == 0 and v * elt <= 16
    assert C % v == 0 and align % (v * elt) == 0
    if tma:
        assert v * elt == 16
    assert plan.ct % v == 0 and C % plan.ct == 0 and plan.ct * elt <= max(128, v * elt)
    assert plan.ct // v * plan.tw <= MAX_THREADS
    assert 1 <= plan.th <= H and 1 <= plan.tw <= W and plan.tw + 2 <= 256 and plan.th + 2 <= 256
    slot = -(-(plan.th + 2) * (plan.tw + 2) * plan.ct * elt // 128) * 128
    assert 2 * slot + 16 + 128 <= SMEM_LIMIT
    tiles = plan.tiles(B, H, W, C)
    # too few tiles only where the tile cannot shrink further
    if tiles < 2 * SMS:
        assert plan.th <= 8 or plan.th == H
    if tiles < SMS // 2:
        assert plan.tw <= 8


@pytest.mark.parametrize("elt", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("H,W", [(1, 1), (3, 5), (17, 13), (64, 64), (255, 257)])
def test_plan_every_channel_count(elt, H, W):
    """Every C from 8 to 1280 on a few maps, aligned addresses."""
    from micro_sam_tpu_torch.ops.dwconv import dwconv_plan
    for C in range(8, 1281):
        _check(dwconv_plan(1, H, W, C, elt, 16), 1, H, W, C, elt, 16)


@pytest.mark.parametrize("elt,align", [(2, 2), (2, 4), (2, 8), (4, 4), (4, 8)],
                         ids=["bf16_2", "bf16_4", "bf16_8", "f32_4", "f32_8"])
def test_plan_unaligned_takes_the_other_body(elt, align):
    """Addresses aligned to less than 16 bytes (never less than an element)."""
    from micro_sam_tpu_torch.ops.dwconv import dwconv_plan
    for C in (8, 12, 24, 40, 64, 160, 320, 1000):
        plan = dwconv_plan(2, 19, 23, C, elt, align)
        _check(plan, 2, 19, 23, C, elt, align)
        assert plan.body == "plain"


@pytest.mark.parametrize("shape,want", [
    ((1, 256, 256, 256), ("tma", 8, 64, 16, 16)),   # the MBConv's hidden map: 1024 tiles
    ((1, 128, 128, 128), ("tma", 8, 64, 8, 16)),    # stage 1 tail
    ((1, 64, 64, 160), ("tma", 8, 40, 8, 25)),      # stage 2 tail: slabs of 40 channels
    ((1, 64, 64, 320), ("tma", 8, 64, 8, 16)),      # stage 3 tail
    ((8, 256, 256, 256), ("tma", 8, 64, 16, 16)),   # batch 8
    ((1, 9, 7, 12), ("plain", 4, 12, 8, 7)),        # 24 bytes a pixel
])
def test_plan_vit_t_shapes(shape, want):
    """The bf16 plans at the depthwise shapes of a vit_t encode."""
    from micro_sam_tpu_torch.ops.dwconv import dwconv_plan
    plan = dwconv_plan(*shape, 2, 16)
    assert tuple(plan) == want
    _check(plan, *shape, 2, 16)


def test_weight_relayout_is_tap_major_and_cached():
    """(C, 1, 3, 3) -> (9, C) f32 with w9[3 di + dj, c] = w[c, 0, di, dj];
    the same tensor object until the weight changes in place."""
    from micro_sam_tpu_torch.ops.dwconv import _tap_major
    w = torch.randn(40, 1, 3, 3, dtype=torch.float64)
    w9 = _tap_major(w, torch.device("cpu"))
    assert w9.shape == (9, 40) and w9.dtype == torch.float32 and w9.is_contiguous()
    for di in range(3):
        for dj in range(3):
            assert torch.equal(w9[3 * di + dj], w[:, 0, di, dj].float())
    assert _tap_major(w, torch.device("cpu")) is w9
    w.mul_(2)
    w9b = _tap_major(w, torch.device("cpu"))
    assert w9b is not w9 and torch.equal(w9b, 2 * w9)
