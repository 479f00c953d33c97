"""The layernorm kernel's variant and layout choice (``ops/layernorm.py::
layernorm_plan``) on the CPU, by the rules ``csrc/layernorm.cu`` checks, and
the wrapper's host-side shortcuts.

The kernel itself runs only on the card (tests/test_torch_cuda.py holds both
variants against the plain version); here the choice is pinned for every
width up to 1536: the vector variant exactly where the elements are bf16,
the width is one of the four models' and every address 16-byte aligned; a
row's 16-byte vectors covered once by its lanes; the grid within the SMs and
the register budget of the kernel's launch bounds.
"""
import pytest
import torch

from micro_sam_tpu_torch.ops import layernorm as ln


def _cdiv(a, b):
    return -(-a // b)


def _check(plan, rows, cols, elt, align):
    vec = elt == 2 and cols in ln.VEC_WIDTHS and align % 16 == 0
    assert plan.variant == ("vec" if vec else "general")
    if not vec:
        assert (plan.lanes, plan.rows_per_warp) == (32, 1)
        assert 32 * plan.per_lane >= cols and plan.per_lane <= 48
        assert plan.grid == max(1, _cdiv(rows, ln.WARPS))
        return
    lanes, nv = plan.lanes, plan.per_lane
    assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32
    assert lanes * nv * 8 == cols  # every lane busy, every vector once
    assert (cols // 8) % (2 * lanes) or lanes == 32  # the largest such power of two
    assert plan.rows_per_warp == 32 // lanes
    groups = _cdiv(rows, plan.rows_per_warp)
    assert 1 <= plan.grid <= max(1, _cdiv(groups, ln.WARPS))
    assert plan.grid <= ln.SMS * ln.blocks_per_sm(nv)
    # the launch bounds' register budget holds gamma, beta (16 a vector) and
    # two row groups (8 a vector) with room for the rest
    assert 65536 // (256 * ln.blocks_per_sm(nv)) >= 24 * nv + 30


@pytest.mark.parametrize("elt", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("rows", [1, 7, 17, 4096, 4900, 17689])
def test_plan_every_width(elt, rows):
    for cols in range(1, ln.MAX_COLS + 1):
        _check(ln.layernorm_plan(rows, cols, elt, 16), rows, cols, elt, 16)


@pytest.mark.parametrize("align", [2, 4, 8])
def test_plan_unaligned_takes_the_general_variant(align):
    for cols in ln.VEC_WIDTHS + (72, 1000, 1536):
        plan = ln.layernorm_plan(4900, cols, 2, align)
        _check(plan, 4900, cols, 2, align)
        assert plan.variant == "general"


@pytest.mark.parametrize("cols,want", [
    (128, (16, 1, 2)),   # vit_t stage 1: two rows a warp, a vector a lane
    (160, (4, 5, 8)),    # vit_t stage 2: eight rows a warp
    (320, (8, 5, 4)),    # vit_t stage 3
    (768, (32, 3, 1)),   # vit_b
    (1024, (32, 4, 1)),  # vit_l
    (1280, (32, 5, 1)),  # vit_h
])
def test_vec_layout_of_the_models_widths(cols, want):
    assert ln.vec_layout(cols) == want[:2]
    plan = ln.layernorm_plan(4900, cols, 2, 16)
    assert (plan.variant, plan.lanes, plan.per_lane, plan.rows_per_warp) == ("vec",) + want


@pytest.mark.parametrize("rows,cols,grid", [
    (4900, 768, 264), (4096, 768, 264), (19600, 768, 264),   # vit_b, K9's 4-tile batch
    (4900, 1280, 132), (4900, 1024, 132),                   # vit_h, vit_l
    (17689, 128, 528), (16384, 128, 528),                   # vit_t stage 1
    (4900, 160, 77), (4096, 160, 64), (4900, 320, 132), (4096, 320, 128),
    (1, 768, 1), (9, 160, 1),                               # rows that fill no block
])
def test_plan_grid_at_the_models_shapes(rows, cols, grid):
    plan = ln.layernorm_plan(rows, cols, 2, 16)
    assert plan.grid == grid
    _check(plan, rows, cols, 2, 16)


def test_vec_lanes_cover_each_row_once():
    """The kernel's walk: lane j of a row's group reads vectors j + i * L;
    the warp's 32 / L groups take consecutive rows."""
    for cols in ln.VEC_WIDTHS:
        lanes, nv = ln.vec_layout(cols)
        per_warp = 32 // lanes
        seen = {}
        for lane in range(32):
            sub, j = divmod(lane, lanes)
            for i in range(nv):
                seen.setdefault(sub, []).append(j + i * lanes)
        assert sorted(seen) == list(range(per_warp))
        for vecs in seen.values():
            assert sorted(vecs) == list(range(cols // 8))


@pytest.mark.parametrize("cols", [0, -3, ln.MAX_COLS + 1, 4096])
def test_plan_refuses_widths_beyond_the_kernel(cols):
    with pytest.raises(ValueError):
        ln.layernorm_plan(16, cols, 2, 16)


def test_plan_is_cached_per_shape():
    ln.layernorm_plan.cache_clear()
    ln.layernorm_plan(4900, 768, 2, 16)
    ln.layernorm_plan(4900, 768, 2, 16)
    assert ln.layernorm_plan.cache_info().hits == 1


def test_parameters_already_f32_are_not_copied():
    w = torch.rand(768)
    assert ln._f32_on(w, w.device) is w
    assert ln._f32_on(w.double(), w.device).dtype == torch.float32
    strided = torch.rand(768, 2)[:, 0]
    got = ln._f32_on(strided, strided.device)
    assert got.is_contiguous() and torch.equal(got, strided)


def test_alignment_of_views():
    buf = torch.zeros(4096, dtype=torch.bfloat16)
    assert ln._alignment(buf) == 16
    assert ln._alignment(buf[1:]) == 2
    assert ln._alignment(buf[4:], buf) == 8
