"""The tiny_attention kernel's layout (``ops/tiny_attention.py::
tiny_attention_plan``) on the CPU, by the limits ``csrc/tiny_attention.cu``
checks, and the index arithmetic its bf16 kernel uses in place of divides.

The kernel runs only on the card (tests/test_torch_cuda.py holds it against
the plain version). Here: the plans at vit_t's three stages; for every head
count and both windows a unit's heads dividing nH, a warp for every (head,
16-row group) so that no row group waits for another (stage 2's 13 groups
side by side), the warps within the kernel's launch bounds, the shared
memory within a block's and the blocks an SM within the SM's; the
signed-offset bias table and key offsets giving upstream's bias for every
(query, key) pair; the 64-byte swizzle giving conflict-free fragment loads;
the kernel's arithmetic (log2 units, exp2, bf16 probabilities, key chunks
with the running maximum) against the plain version.
"""
import math

import pytest
import torch

from micro_sam_tpu_torch.ops import tiny_attention as ta


@pytest.mark.parametrize("shape,want", [
    ((1, 133, 133, 128, 4, 7), (2, 8, 722, 361)),    # stage 1: 2 heads a unit, 2 units a block
    ((1, 70, 70, 160, 5, 14), (1, 13, 125, 125)),    # stage 2: a head, 13 row groups
    ((1, 70, 70, 320, 10, 7), (2, 8, 500, 250)),     # stage 3
    ((2, 70, 70, 160, 5, 14), (1, 13, 250, 125)),    # batch 2: a block an SM, 2 units each
    ((8, 133, 133, 128, 4, 7), (2, 8, 5776, 386)),   # 15 rounds of at most 3 blocks an SM
])
def test_plan_vit_t_stages(shape, want):
    plan = ta.tiny_attention_plan(*shape)
    assert (plan.heads, plan.warps, plan.units, plan.grid) == want
    assert plan.slots == 2 and plan.smem <= ta.SMEM_LIMIT
    assert plan.blocks_per_sm * (plan.smem + 1024) <= ta.SMEM_PER_SM


@pytest.mark.parametrize("window", ta.WINDOWS)
@pytest.mark.parametrize("B", [1, 3])
def test_plan_every_head_count(window, B):
    groups = math.ceil(window * window / 16)
    for nH in range(1, 41):
        Hp, Wp = 2 * window, 3 * window
        plan = ta.tiny_attention_plan(B, Hp, Wp, 32 * nH, nH, window)
        assert nH % plan.heads == 0
        assert plan.warps == plan.heads * groups  # no row group in turns
        assert plan.warps <= ta.MAX_WARPS[window]
        assert plan.smem == ta.smem_bytes(window, plan.heads, nH) <= ta.SMEM_LIMIT
        assert 1 <= plan.blocks_per_sm <= ta.REG_BLOCKS_PER_SM[window]
        assert plan.blocks_per_sm * (plan.smem + 1024) <= ta.SMEM_PER_SM
        assert plan.units == B * 6 * nH // plan.heads
        # the fewest rounds the SMs allow, every block as many units as any other
        rounds = math.ceil(plan.units / (ta.SMS * plan.blocks_per_sm))
        assert math.ceil(plan.units / plan.grid) == rounds
        assert plan.grid == math.ceil(plan.units / rounds)
        # no larger divisor of nH would have fit
        for d in range(plan.heads + 1, nH + 1):
            if nH % d == 0:
                assert (d * groups > ta.MAX_WARPS[window]
                        or ta.smem_bytes(window, d, nH) > ta.SMEM_LIMIT)


@pytest.mark.parametrize("args", [
    (1, 14, 14, 128, 4, 8),    # no kernel for window 8
    (1, 14, 14, 160, 4, 7),    # head dim 40
    (1, 15, 14, 128, 4, 7),    # map not whole windows
    (1, 14, 14, 32 * 80, 80, 14),  # 80 heads' bias tables exceed a block's memory
])
def test_plan_refuses(args):
    with pytest.raises(ValueError):
        ta.tiny_attention_plan(*args)


def test_smem_at_the_stages():
    """The kernel's ta_layout: two slots, tables, key offsets, barriers, 1024
    bytes of slack."""
    assert ta.smem_bytes(7, 2, 4) == 2 * 3 * 2 * 64 * 64 + 4 * 13 * 13 * 4 + 64 * 4 + 16 + 1024
    assert ta.smem_bytes(14, 1, 5) == 96336


@pytest.mark.parametrize("window", ta.WINDOWS)
def test_signed_offset_bias_indexing(window):
    """tab[base(q) - koff(k)] of the (2w - 1)^2 signed-offset table is
    upstream's table[h, |dy| w + |dx|] for every query and key of a window."""
    w, T = window, 2 * window - 1
    N = w * w
    table = torch.randn(3, N)
    r = torch.arange(T * T)
    dy, dx = (r // T - (w - 1)).abs(), (r % T - (w - 1)).abs()
    tab = table[:, dy * w + dx]  # the kernel's staging, before the log2(e) factor
    tok = torch.arange(N)
    base = (tok // w + w - 1) * T + tok % w + w - 1
    koff = (tok // w) * T + tok % w
    idx = base[:, None] - koff[None, :]
    assert int(idx.min()) >= 0 and int(idx.max()) < T * T
    assert torch.equal(tab[:, idx], table[:, ta.bias_offset_index(w)])


def test_swizzled_fragment_loads_are_conflict_free():
    """Eight consecutive 64-byte rows at one logical 16-byte chunk (an
    ldmatrix 8 x 8 load) land on eight distinct groups of four banks under
    TMA's 64-byte swizzle (chunk ^ (row / 2) % 4), for any first row."""
    for row0 in range(0, 208, 8):
        for chunk in range(4):
            groups = {((r * 64 + ((chunk ^ ((r >> 1) & 3)) << 4)) // 16) % 8
                      for r in range(row0, row0 + 8)}
            assert len(groups) == 8


@pytest.mark.parametrize("stage", [(1, 14, 21, 128, 4, 7), (1, 28, 14, 64, 2, 14)])
def test_kernel_arithmetic_matches_plain(stage):
    """The bf16 kernel's arithmetic emulated in f32: logits in log2 units
    (log2(e) in the scale and the bias table), keys in chunks of 64 (window
    7) or 80 (window 14) with the running maximum and the sums rescaled,
    exp2, probabilities rounded to bf16 and summed as rounded, v in bf16."""
    B, Hp, Wp, C, nH, w = stage
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn(B * Hp * Wp, 3 * C, generator=g).to(torch.bfloat16)
    table = torch.randn(nH, w * w, generator=g) * 0.5
    hd, N, log2e = 32, w * w, 1.4426950408889634
    ny, nx = Hp // w, Wp // w
    t = qkv.float().view(B, ny, w, nx, w, nH, 3, hd).permute(6, 0, 1, 3, 5, 2, 4, 7)
    q, k, v = t.reshape(3, -1, nH, N, hd).unbind(0)
    s2 = (q @ k.transpose(-1, -2)) * (hd ** -0.5 * log2e) \
        + (table * log2e)[:, ta.bias_offset_index(w)]
    chunk = 64 if w == 7 else 80
    m = torch.full(s2.shape[:-1] + (1,), -math.inf)
    o, l = torch.zeros(q.shape), torch.zeros(m.shape)
    for c0 in range(0, N, chunk):
        sc = s2[..., c0:c0 + chunk]
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        a = torch.exp2(m - m_new)
        p = torch.exp2(sc - m_new).to(torch.bfloat16).float()
        o = o * a + p @ v[..., c0:c0 + chunk, :]
        l = l * a + p.sum(-1, keepdim=True)
        m = m_new
    o = (o / l).view(B, ny, nx, nH, w, w, hd).permute(0, 1, 4, 2, 5, 3, 6).reshape(-1, C)
    ref = ta.tiny_attention_plain(qkv.float(), table, (B, Hp, Wp), w)
    assert float((o - ref).abs().max()) <= 2e-2 * float(ref.abs().max())
