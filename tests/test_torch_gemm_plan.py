"""The bf16 gemm kernel's plan (``ops.gemm.gemm_plan``), the wrapper's
refusals and the CPU path, without a card.

The plan is pinned at every distinct product of the vit_b / vit_l / vit_h /
vit_t encodes (``chip_smoke.GEMM_SHAPES``, the shapes ``chip_smoke.py``
times) at batch 1 and 8: the tile width, the ring's stages, a persistent grid
of at most one block an SM, and the width being the cheaper in waves. The
CPU path is held against ``gemm_plain`` (the same function) and against a
float64 numpy product rounded where the plain composition rounds, through
torch's casts: f32 within 1e-5 of max|ref|, bf16 within 2^-7 (one unit in
the last place of bf16) of max|ref|.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from micro_sam_tpu_torch.ops.gemm import (EPILOGUES, STAGES, GemmPlan, check_launch, gemm,
                                          gemm_plain, gemm_plan, max_stages)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_smoke)
SHAPES = [(model, label, M, N, K, epi) for model, rows in _smoke.GEMM_SHAPES.items()
          for label, M, N, K, epi, _ in rows]
SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block may use on the H100


def _ceil(a, b):
    return -(-a // b)


def test_main_path_shape_table_covers_the_encodes():
    n = {m: sum(r[5] for r in rows) for m, rows in _smoke.GEMM_SHAPES.items()}
    assert n == {"vit_b": 48, "vit_l": 96, "vit_h": 128, "vit_t": 44}
    assert len(SHAPES) == 38


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("model,label,M,N,K,epilogue", SHAPES,
                         ids=[f"{m}-{lab.replace(' ', '_')}" for m, lab, *_ in SHAPES])
def test_plan_at_main_path_shapes(model, label, M, N, K, epilogue, batch):
    M *= batch
    p = gemm_plan(M, N, K, epilogue)
    assert p.bn in (128, 256) and p.stages == STAGES[p.bn]
    assert p.tiles == _ceil(M, 128) * _ceil(N, p.bn)
    assert 1 <= p.grid <= 132 and p.grid == min(p.tiles, 132)
    # the ring, its barriers and two order barriers fit, with 1024 bytes to
    # align the tiles
    assert p.stages * ((128 + p.bn) * 64 * 2 + 16) + 16 + 1024 <= SMEM_LIMIT
    assert 3 <= p.stages <= max_stages(p.bn)
    if p.turns:  # 128-wide tiles in turns: no GELU, more than one tile a block
        assert p.bn == 128 and p.tiles > 132 and "gelu" not in epilogue
        return
    # split tiles: the width costs no more waves, weighted by width, than the other
    assert "gelu" in epilogue or _ceil(M, 128) * _ceil(N, 128) <= 132
    other = 384 - p.bn
    cost = lambda bn: _ceil(_ceil(M, 128) * _ceil(N, bn), 132) * bn
    assert cost(p.bn) <= cost(other)
    if cost(p.bn) == cost(other):
        assert p.bn == 256


@pytest.mark.parametrize("M,N,K,epilogue,expect", [
    (4900, 768, 768, "residual", GemmPlan(128, 5, 132, 234, True)),   # vit_b proj
    (4900, 3072, 768, "gelu", GemmPlan(256, 4, 132, 468)),            # vit_b lin1
    (4900, 2304, 768, "none", GemmPlan(128, 5, 132, 702, True)),      # vit_b qkv
    (4900, 5120, 1280, "gelu", GemmPlan(256, 4, 132, 780)),           # vit_h lin1: wraps 6 times
    (4096, 1280, 5120, "residual", GemmPlan(128, 5, 132, 320, True)),  # vit_h lin2
    (65536, 64, 256, "residual_gelu", GemmPlan(128, 5, 132, 512)),    # vit_t shrink: N < a tile
    (4900, 160, 160, "residual", GemmPlan(128, 5, 78, 78)),           # vit_t s2 proj: a tile a block
    (4096, 1280, 320, "gelu", GemmPlan(128, 5, 132, 320)),            # vit_t s3 lin1: 2.4 waves
    (37, 40, 72, "none", GemmPlan(128, 5, 1, 1)),                     # smaller than one tile
], ids=["vit_b_proj", "vit_b_lin1", "vit_b_qkv", "vit_h_lin1", "vit_h_lin2", "vit_t_shrink",
        "vit_t_s2_proj", "vit_t_s3_lin1", "below_one_tile"])
def test_plan_pinned(M, N, K, epilogue, expect):
    assert gemm_plan(M, N, K, epilogue) == expect


def test_plan_follows_the_sm_count():
    assert gemm_plan(4900, 5120, 1280, "gelu", sms=114).grid == 114
    assert gemm_plan(4900, 768, 768, "gelu", sms=64) == GemmPlan(256, 4, 64, 117)
    assert gemm_plan(4900, 768, 768, "none", sms=64) == GemmPlan(128, 5, 64, 234, True)


def test_ring_depths_that_fit():
    assert (max_stages(256), max_stages(128)) == (4, 7)


def _bf16(shape, seed, offset=0):
    """A contiguous bf16 tensor whose data starts ``offset`` elements into a
    fresh buffer (offset 1: 2 bytes past 16-byte alignment)."""
    n = int(np.prod(shape))
    buf = torch.from_numpy(np.random.RandomState(seed).randn(n + offset).astype(np.float32))
    return buf.to(torch.bfloat16)[offset:].view(shape)


_REFUSALS = {
    "k_not_multiple_of_8": lambda: check_launch(_bf16((16, 12), 0), _bf16((8, 12), 1), None),
    "k_zero": lambda: check_launch(_bf16((16, 0), 0), _bf16((8, 0), 1), None),
    "x_misaligned": lambda: check_launch(_bf16((16, 32), 0, 1), _bf16((8, 32), 1), None),
    "weight_misaligned": lambda: check_launch(_bf16((16, 32), 0), _bf16((8, 32), 1, 1), None),
    "residual_misaligned": lambda: check_launch(_bf16((16, 32), 0), _bf16((8, 32), 1),
                                                _bf16((16, 8), 2, 1)),
    "residual_wrong_shape": lambda: check_launch(_bf16((16, 32), 0), _bf16((8, 32), 1),
                                                 _bf16((16, 16), 2)),
    "residual_wrong_dtype": lambda: check_launch(_bf16((16, 32), 0), _bf16((8, 32), 1),
                                                 _bf16((16, 8), 2).float()),
    "inner_dims_differ": lambda: check_launch(_bf16((16, 32), 0), _bf16((8, 40), 1), None),
    "x_not_contiguous": lambda: check_launch(_bf16((32, 16), 0).t(), _bf16((8, 32), 1), None),
    "dtypes_differ": lambda: check_launch(_bf16((16, 32), 0), _bf16((8, 32), 1).float(), None),
    "residual_with_plain_epilogue": lambda: gemm(_bf16((16, 32), 0), _bf16((8, 32), 1),
                                                 torch.zeros(8), "gelu", _bf16((16, 8), 2)),
    "residual_epilogue_without_residual": lambda: gemm(_bf16((16, 32), 0), _bf16((8, 32), 1),
                                                       torch.zeros(8), "residual"),
    "unknown_epilogue": lambda: gemm(_bf16((16, 32), 0), _bf16((8, 32), 1), torch.zeros(8),
                                     "relu"),
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_wrapper_refuses_before_any_launch(case):
    before = gemm.launches
    with pytest.raises(ValueError):
        _REFUSALS[case]()
    assert gemm.launches == before


def test_launch_checks_pass_what_the_kernel_takes():
    x, w, r = _bf16((4900, 768), 0), _bf16((2304, 768), 1), _bf16((4900, 2304), 2)
    check_launch(x, w, r)
    check_launch(x, w, None)
    check_launch(x.float()[:, :20].contiguous(), w.float()[:, :20].contiguous(), None)  # f32: any K


def _numpy_reference(x, w, b, epilogue, r, dtype):
    """float64 product, rounded to ``dtype`` where the plain composition
    stores: v = round(xW^T + b), then round(gelu(v)), round(R + v) or
    round(gelu(round(R + v))); GELU exact (erf), evaluated in float64."""
    from scipy.special import erf
    rnd = lambda a: torch.from_numpy(np.asarray(a, np.float64)).to(dtype).double().numpy()
    gelu = lambda a: 0.5 * a * (1.0 + erf(a / np.sqrt(2.0)))
    v = rnd(x.double().numpy() @ w.double().numpy().T + b.double().numpy())
    if epilogue == "gelu":
        v = rnd(gelu(v))
    elif epilogue in ("residual", "residual_gelu"):
        v = rnd(r.double().numpy() + v)
        if epilogue == "residual_gelu":
            v = rnd(gelu(v))
    return v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("epilogue", sorted(EPILOGUES))
@pytest.mark.parametrize("M,K,N", [(37, 72, 40), (130, 256, 96)], ids=["ragged", "two_tiles"])
def test_cpu_path_matches_plain_and_numpy(dtype, epilogue, M, K, N):
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.randn(N, K) * K ** -0.5).astype(np.float32)).to(dtype)
    b = torch.from_numpy((rng.randn(N) * 0.1).astype(np.float32))
    r = (torch.from_numpy(rng.randn(M, N).astype(np.float32)).to(dtype)
         if epilogue.startswith("residual") else None)
    before = gemm.launches
    got = gemm(x, w, b, epilogue, r)
    assert gemm.launches == before  # the CPU path launches nothing
    assert got.dtype == dtype and got.shape == (M, N)
    assert torch.equal(got, gemm_plain(x, w, b, epilogue, r))
    ref = _numpy_reference(x, w, b, epilogue, r, dtype)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    err = np.abs(got.double().numpy() - ref).max() / np.abs(ref).max()
    assert err <= tol, err

