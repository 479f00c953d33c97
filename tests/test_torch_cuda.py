"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test carries the ``cuda`` marker and skips without an NVIDIA GPU (the
kernels have no CPU mode). This file imports neither jax nor the JAX package,
so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: f32 relative error <= 1e-4 of max|ref| with TF32 off; bf16
<= 2e-2 of max|ref|, the plain version run in f32 on the same bf16 inputs.
"""
import pytest
import torch

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _held(got, ref, dtype):
    got, ref = got.float().cpu(), ref.float().cpu()
    assert torch.isfinite(got).all()
    err = float((got - ref).abs().max()) / (float(ref.abs().max()) + 1e-30)
    assert err <= (1e-4 if dtype == torch.float32 else 2e-2), err


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_layernorm_matches_plain(dev, dtype, masked):
    from micro_sam_tpu_torch.ops.layernorm import layernorm, layernorm_plain
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(4900, 768, generator=g) * 3).to(dev, dtype)
    w = (torch.randn(768, generator=g) * 0.5 + 1).to(dev)
    b = (torch.randn(768, generator=g) * 0.1).to(dev)
    v = (torch.rand(4900, generator=g) > 0.2).float().to(dev) if masked else None
    n = layernorm.launches
    got = layernorm(x, w, b, 1e-6, v)
    torch.cuda.synchronize()
    assert layernorm.launches == n + 1
    _held(got, layernorm_plain(x.float(), w, b, 1e-6, v), dtype)


# every layernorm shape of the vit_b, vit_l, vit_h and vit_t encodes (rows, C)
LN_ENCODE_SHAPES = [(4900, 768), (4096, 768), (4900, 1024), (4096, 1024), (4900, 1280),
                    (4096, 1280), (17689, 128), (16384, 128), (4900, 160), (4096, 160),
                    (4900, 320), (4096, 320)]


def _ln_case(dev, dtype, M, C, masked, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(M, C, generator=g) * 3).to(dev, dtype)
    w = (torch.randn(C, generator=g) * 0.5 + 1).to(dev)
    b = (torch.randn(C, generator=g) * 0.1).to(dev)
    v = (torch.rand(M, generator=g) > 0.2).float().to(dev) if masked else None
    return x, w, b, v


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("M,C", LN_ENCODE_SHAPES)
def test_layernorm_encode_shapes_match_plain(dev, dtype, masked, M, C):
    from micro_sam_tpu_torch.ops.layernorm import layernorm, layernorm_plain
    x, w, b, v = _ln_case(dev, dtype, M, C, masked)
    n = layernorm.launches
    got = layernorm(x, w, b, 1e-6, v)
    torch.cuda.synchronize()
    assert layernorm.launches == n + 1
    _held(got, layernorm_plain(x.float(), w, b, 1e-6, v), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,C", [(1, 768), (4, 768), (1, 1280)])
def test_layernorm_grid_mode_equals_the_read_mask(dev, dtype, B, C):
    """K9's grid mode against plain, and to the bit against the same rows
    with the mask read (the default route's LN1)."""
    from micro_sam_tpu_torch.ops.layernorm import grid_mask, layernorm, layernorm_plain
    grid = (70, 70, 64, 64)
    x, w, b, _ = _ln_case(dev, dtype, B * 4900, C, False, seed=1)
    got = layernorm(x, w, b, 1e-6, grid=grid)
    torch.cuda.synchronize()
    _held(got, layernorm_plain(x.float(), w, b, 1e-6, grid=grid), dtype)
    assert torch.equal(got, layernorm(x, w, b, 1e-6, grid_mask(x.shape[0], grid, dev)))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("C", [72, 100, 1000, 1001, 1536, 256])
def test_layernorm_general_widths_match_plain(dev, dtype, C):
    """Widths without a vector instantiation, not multiples of 8, the widest."""
    from micro_sam_tpu_torch.ops.layernorm import layernorm, layernorm_plain, layernorm_plan
    x, w, b, v = _ln_case(dev, dtype, 777, C, True, seed=2)
    assert layernorm_plan(777, C, x.element_size(), 16).variant == "general"
    got = layernorm(x, w, b, 1e-5, v)
    torch.cuda.synchronize()
    _held(got, layernorm_plain(x.float(), w, b, 1e-5, v), dtype)


@pytest.mark.parametrize("C", [128, 768, 1280])
def test_layernorm_misaligned_input_matches_plain(dev, C):
    """An input 2 bytes past a 16-byte boundary takes the general variant."""
    from micro_sam_tpu_torch.ops.layernorm import layernorm, layernorm_plain
    M = 300
    x0, w, b, v = _ln_case(dev, torch.bfloat16, M, C, True, seed=3)
    buf = torch.empty(M * C + 1, device=dev, dtype=torch.bfloat16)
    x = buf[1:].view(M, C)
    x.copy_(x0)
    assert x.data_ptr() % 16 == 2
    got = layernorm(x, w, b, 1e-6, v)
    torch.cuda.synchronize()
    _held(got, layernorm_plain(x0.float(), w, b, 1e-6, v), torch.bfloat16)


@pytest.mark.parametrize("C", [128, 160, 320, 768, 1024, 1280])
@pytest.mark.parametrize("M", [1, 3, 7, 9, 17, 63])
def test_layernorm_rows_that_fill_no_block_match_plain(dev, C, M):
    from micro_sam_tpu_torch.ops.layernorm import layernorm, layernorm_plain
    x, w, b, v = _ln_case(dev, torch.bfloat16, M, C, True, seed=M)
    got = layernorm(x, w, b, 1e-6, v)
    torch.cuda.synchronize()
    _held(got, layernorm_plain(x.float(), w, b, 1e-6, v), torch.bfloat16)


@pytest.mark.parametrize("C", [128, 160, 320, 768, 1024, 1280])
def test_layernorm_vec_variant_on_any_grid_matches_plain(dev, C):
    """One block walking every row (the next rows' loads in flight), and the
    general variant at the same width, against plain."""
    from micro_sam_tpu_torch.ops.layernorm import (LayernormPlan, layernorm, layernorm_plain,
                                                   layernorm_plan)
    M = 4900
    x, w, b, v = _ln_case(dev, torch.bfloat16, M, C, True, seed=4)
    ref = layernorm_plain(x.float(), w, b, 1e-6, v)
    plan = layernorm_plan(M, C, 2, 16)
    assert plan.variant == "vec"
    for p in (plan._replace(grid=1), plan._replace(grid=3),
              LayernormPlan("general", 32, -(-C // 32), 1, -(-M // 8))):
        got = layernorm(x, w, b, 1e-6, v, plan=p)
        torch.cuda.synchronize()
        _held(got, ref, torch.bfloat16)


def test_layernorm_refuses_what_the_plan_would_not_choose(dev):
    from micro_sam_tpu_torch.ops.layernorm import layernorm, layernorm_plan
    x, w, b, _ = _ln_case(dev, torch.float32, 64, 768, False)
    vec = layernorm_plan(64, 768, 2, 16)
    with pytest.raises(RuntimeError):  # no f32 vector variant
        layernorm(x, w, b, 1e-6, plan=vec)
    xb = x.to(torch.bfloat16)
    with pytest.raises(RuntimeError):  # the lanes of another width
        layernorm(xb, w, b, 1e-6, plan=vec._replace(lanes=16))
    xo = torch.zeros(64 * 72, device=dev, dtype=torch.bfloat16).view(64, 72)
    with pytest.raises(RuntimeError):  # a width without a vector instantiation
        layernorm(xo, w[:72], b[:72], 1e-6, plan=vec)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("epilogue", ["none", "gelu", "residual", "residual_gelu"])
@pytest.mark.parametrize("M,K,N", [
    (4900, 768, 2304), (37, 72, 40), (130, 3072, 768), (4900, 1024, 3072), (4900, 1280, 5120),
    (4900, 5120, 1280), (65536, 64, 256), (65536, 256, 64), (4900, 160, 480), (100, 256, 384),
    (333, 128, 200), (70, 64, 37)],
    ids=["vit_b_qkv", "ragged", "vit_b_lin2", "vit_l_qkv", "vit_h_lin1_wraps", "vit_h_lin2",
         "vit_t_expand", "vit_t_shrink", "vit_t_s2_qkv", "m_below_one_tile", "m_not_64_multiple",
         "n_not_8_multiple"])
def test_gemm_matches_plain(dev, dtype, epilogue, M, K, N):
    from micro_sam_tpu_torch.ops.gemm import gemm, gemm_plain
    g = torch.Generator().manual_seed(1)
    x = torch.randn(M, K, generator=g).to(dev, dtype)
    w = (torch.randn(N, K, generator=g) * K ** -0.5).to(dev, dtype)
    b = (torch.randn(N, generator=g) * 0.1).to(dev)
    r = torch.randn(M, N, generator=g).to(dev, dtype) if epilogue.startswith("residual") else None
    got = gemm(x, w, b, epilogue, r)
    torch.cuda.synchronize()
    _held(got, gemm_plain(x.float(), w.float(), b, epilogue, None if r is None else r.float()),
          dtype)


def _main_path_gemm_shapes():
    """chip_smoke.GEMM_SHAPES: every distinct product of the vit_b, vit_l,
    vit_h and vit_t encodes, (model, label, M, N, K, epilogue)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return [(m, lab, M, N, K, e) for m, rows in smoke.GEMM_SHAPES.items()
            for lab, M, N, K, e, _ in rows]


GEMM_MAIN_PATH = _main_path_gemm_shapes()


@pytest.mark.parametrize("model,label,M,N,K,epilogue", GEMM_MAIN_PATH,
                         ids=[f"{m}-{lab.replace(' ', '_')}" for m, lab, *_ in GEMM_MAIN_PATH])
def test_gemm_main_path_shapes_match_plain(dev, model, label, M, N, K, epilogue):
    from micro_sam_tpu_torch.ops.gemm import gemm, gemm_plain
    g = torch.Generator().manual_seed(11)
    dt = torch.bfloat16
    x = torch.randn(M, K, generator=g).to(dev, dt)
    w = (torch.randn(N, K, generator=g) * K ** -0.5).to(dev, dt)
    b = (torch.randn(N, generator=g) * 0.1).to(dev)
    r = torch.randn(M, N, generator=g).to(dev, dt) if epilogue.startswith("residual") else None
    got = gemm(x, w, b, epilogue, r)
    torch.cuda.synchronize()
    _held(got, gemm_plain(x.float(), w.float(), b, epilogue, None if r is None else r.float()),
          dt)


@pytest.mark.parametrize("epilogue", ["none", "residual"])
@pytest.mark.parametrize("bn,turns,stages,grid", [
    (256, False, 3, 7), (256, False, 4, 132), (128, False, 3, 7), (128, False, 7, 132),
    (128, True, 3, 7), (128, True, 7, 5), (128, True, 5, 132), (128, True, 4, 1)],
    ids=["256_s3_g7", "256_s4_g132", "128_s3_g7", "128_s7_g132", "turns_s3_g7", "turns_s7_g5",
         "turns_s5_g132", "turns_s4_g1"])
def test_gemm_every_plan_matches_plain(dev, epilogue, bn, turns, stages, grid):
    """Each schedule of the kernel, its ring shallow and deep, on grids small
    enough that a block walks many tiles (an odd count in turns) and the
    ring wraps many times: a ragged (1000, 1280) x (2000, 1280)^T product."""
    from micro_sam_tpu_torch.ops.gemm import GemmPlan, gemm, gemm_plain
    g = torch.Generator().manual_seed(14)
    M, K, N = 1000, 1280, 2000
    x = torch.randn(M, K, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(N, K, generator=g) * K ** -0.5).to(dev, torch.bfloat16)
    b = (torch.randn(N, generator=g) * 0.1).to(dev)
    r = torch.randn(M, N, generator=g).to(dev, torch.bfloat16) if epilogue != "none" else None
    tiles = -(-M // 128) * -(-N // bn)
    got = gemm(x, w, b, epilogue, r, plan=GemmPlan(bn, stages, grid, tiles, turns))
    torch.cuda.synchronize()
    _held(got, gemm_plain(x.float(), w.float(), b, epilogue, None if r is None else r.float()),
          torch.bfloat16)


@pytest.mark.parametrize("epilogue", ["gelu", "residual_gelu"])
def test_gemm_refuses_turns_with_gelu(dev, epilogue):
    """The kernel has no GELU epilogue in turns (the plan never asks for
    one): the launch is refused, and nothing is counted."""
    from micro_sam_tpu_torch.ops.gemm import GemmPlan, gemm
    x = torch.zeros(300, 64, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(256, 64, device=dev, dtype=torch.bfloat16)
    r = torch.zeros(300, 256, device=dev, dtype=torch.bfloat16) if epilogue != "gelu" else None
    n = gemm.launches
    with pytest.raises(RuntimeError):
        gemm(x, w, torch.zeros(256, device=dev), epilogue, r, plan=GemmPlan(128, 5, 2, 6, True))
    assert gemm.launches == n


@pytest.mark.parametrize("N,K", [(1280, 1280), (5120, 1280)], ids=["bn128", "bn256"])
def test_gemm_weight_map_reused_with_new_x(dev, N, K):
    """A weight's tensor map is encoded once and reused while X changes: three
    calls on one weight with new X (and new M) all hold, the weight's map is
    encoded at most once, and a call again on the last X encodes nothing."""
    from micro_sam_tpu_torch.ops import _cuda
    from micro_sam_tpu_torch.ops.gemm import gemm, gemm_plain
    g = torch.Generator().manual_seed(12)
    w = (torch.randn(N, K, generator=g) * K ** -0.5).to(dev, torch.bfloat16)
    b = (torch.randn(N, generator=g) * 0.1).to(dev)
    lib = _cuda.library("gemm")
    before, encoded, xs = lib.msam_gemm_maps_encoded(1), [], []
    for M in (4900, 4096, 4900):
        xs.append(torch.randn(M, K, generator=g).to(dev, torch.bfloat16))
        got = gemm(xs[-1], w, b, "gelu")
        torch.cuda.synchronize()
        _held(got, gemm_plain(xs[-1].float(), w.float(), b, "gelu"), torch.bfloat16)
        encoded.append(lib.msam_gemm_maps_encoded(1))
    # at most the first call encodes W (an earlier test's weight of this shape
    # may have left its map at this address); the others reuse it
    assert encoded[0] - before in (0, 1) and encoded[1] == encoded[2] == encoded[0]
    x_maps = lib.msam_gemm_maps_encoded(0)
    gemm(xs[-1], w, b, "gelu")
    assert lib.msam_gemm_maps_encoded(0) == x_maps and lib.msam_gemm_maps_encoded(1) == encoded[0]


def test_gemm_counts_one_launch_per_call(dev):
    from micro_sam_tpu_torch.ops.gemm import gemm
    g = torch.Generator().manual_seed(13)
    n = gemm.launches
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn(300, 64, generator=g).to(dev, dt)
        w = torch.randn(96, 64, generator=g).to(dev, dt)
        gemm(x, w, torch.zeros(96, device=dev))
        gemm(x, w, torch.zeros(96, device=dev), "residual", torch.zeros(300, 96, device=dev,
                                                                         dtype=dt))
    gemm(torch.empty(0, 64, device=dev, dtype=torch.bfloat16),
         torch.zeros(96, 64, device=dev, dtype=torch.bfloat16), torch.zeros(96, device=dev))
    torch.cuda.synchronize()
    assert gemm.launches == n + 4  # an empty product launches nothing


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,W,hd", [(25, 14, 14, 64), (1, 64, 64, 64), (3, 10, 7, 64),
                                      (25, 14, 14, 80), (1, 64, 64, 80), (3, 10, 7, 80)],
                         ids=["window", "global", "ragged", "window_hd80", "global_hd80",
                              "ragged_hd80"])
def test_relpos_attention_matches_plain(dev, dtype, B, H, W, hd):
    from micro_sam_tpu_torch.ops.relpos_attention import relpos_attention, relpos_attention_plain
    nH, N = 12, H * W
    g = torch.Generator().manual_seed(2)
    qkv = torch.randn(B * N, 3, nH, hd, generator=g).to(dev, dtype)
    q5 = qkv.view(B, N, 3, nH, hd)
    q, k, v = (q5[:, :, i].transpose(1, 2) for i in range(3))  # token-major strided views
    rh = (torch.randn(H, H, hd, generator=g) * 0.3).to(dev, dtype)
    rw = (torch.randn(W, W, hd, generator=g) * 0.3).to(dev, dtype)
    out = torch.empty(B, N, nH, hd, device=dev, dtype=dtype)
    got = relpos_attention(q, k, v, rh, rw, (H, W), out=out.transpose(1, 2))
    torch.cuda.synchronize()
    ref = relpos_attention_plain(q.float(), k.float(), v.float(), rh.float(), rw.float(), (H, W))
    _held(got, ref, dtype)


VARIANT_CASES = {  # id: (B, nH, H, W, hd, the bf16 kernel's variant)
    "global_12h": (1, 12, 64, 64, 64, "rows"),
    "global_16h": (1, 16, 64, 64, 64, "rows"),
    "w32_rows2": (2, 3, 16, 32, 64, "rows"),
    "w24_window": (2, 3, 2, 24, 64, "window"),
    "w40": (2, 3, 24, 40, 64, "rows"),
    "w96_general": (1, 2, 8, 96, 64, "general"),
    "tiny": (3, 2, 2, 3, 64, "window"),
    "window_b25": (25, 12, 14, 14, 64, "window"),
    "window_b100": (100, 12, 14, 14, 64, "window"),
    "window_b25_hd80": (25, 16, 14, 14, 80, "window"),
    "window_b100_hd80": (100, 16, 14, 14, 80, "window"),
    "window_hd160": (4, 2, 14, 14, 160, "rows"),
    "global_hd160": (1, 2, 64, 64, 160, "rows"),
    "window_hd256": (4, 2, 14, 14, 256, "rows"),
    "global_hd256": (1, 2, 64, 64, 256, "rows"),
    "w96_hd256": (1, 2, 3, 96, 256, "general"),
    # windows at the edge of one block's shared memory: the largest that
    # stays resident, and three that take the rows variant instead
    "w16_hd96_window": (2, 2, 16, 16, 96, "window"),
    "w16_hd128": (2, 2, 16, 16, 128, "rows"),
    "w15_hd128": (2, 2, 15, 15, 128, "rows"),
    "w4x64_hd96": (2, 2, 4, 64, 96, "rows"),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(VARIANT_CASES))
def test_relpos_attention_variants_match_plain(dev, dtype, case):
    """The forward at each variant's edges (``forward_plan``): the global
    grid at 12 and 16 heads, W dividing 64 and not, W > 64, a grid of 6
    tokens, the 14 x 14 windows at batch 25 and at the tiled path's 100, head
    dims 64 / 80, 160 / 256 (two 128-column output slices), and windows
    whose keys fit 256 slots but not one block's shared memory. q, k, v
    strided out of qkv rows, the output into proj rows; one launch a call."""
    from micro_sam_tpu_torch.ops.relpos_attention import (forward_plan, kernel_head_dim,
                                                          relpos_attention,
                                                          relpos_attention_plain)
    B, nH, H, W, hd, variant = VARIANT_CASES[case]
    N = H * W
    assert forward_plan(N, H, W, kernel_head_dim(hd)).variant == variant
    g = torch.Generator().manual_seed(8)
    q5 = torch.randn(B, N, 3, nH, hd, generator=g).to(dev, dtype)
    q, k, v = (q5[:, :, i].transpose(1, 2) for i in range(3))
    rh = (torch.randn(H, H, hd, generator=g) * 0.3).to(dev, dtype)
    rw = (torch.randn(W, W, hd, generator=g) * 0.3).to(dev, dtype)
    out = torch.full((B, N, nH, hd), float("nan"), device=dev, dtype=dtype).transpose(1, 2)
    n = relpos_attention.launches
    got = relpos_attention(q, k, v, rh, rw, (H, W), out=out)
    torch.cuda.synchronize()
    assert got is out and relpos_attention.launches == n + 1
    _held(got, relpos_attention_plain(q.float(), k.float(), v.float(), rh.float(), rw.float(),
                                      (H, W)), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,W,hd", [(25, 14, 14, 64), (1, 64, 64, 64), (3, 10, 7, 64),
                                      (25, 14, 14, 80), (1, 64, 64, 80), (3, 10, 7, 80)],
                         ids=["window", "global", "ragged", "window_hd80", "global_hd80",
                              "ragged_hd80"])
def test_relpos_attention_backward_matches_plain(dev, dtype, B, H, W, hd):
    """K4's four launches against the plain VJP (bf16: within 3e-2 of the f32
    plain result on the same bf16 inputs), gradients written straight into
    the rows of a (B, N, 3, nH, hd) qkv gradient."""
    from micro_sam_tpu_torch.ops.relpos_attention import (
        relpos_attention, relpos_attention_backward, relpos_attention_backward_plain)
    nH, N = 12, H * W
    g = torch.Generator().manual_seed(6)
    q5 = torch.randn(B, N, 3, nH, hd, generator=g).to(dev, dtype)
    q, k, v = (q5[:, :, i].transpose(1, 2) for i in range(3))
    rh = (torch.randn(H, H, hd, generator=g) * 0.3).to(dev, dtype)
    rw = (torch.randn(W, W, hd, generator=g) * 0.3).to(dev, dtype)
    out = relpos_attention(q, k, v, rh, rw, (H, W))
    dout = torch.randn(B, nH, N, hd, generator=g).to(dev, dtype)
    d5 = torch.full_like(q5, float("nan"))
    n = relpos_attention_backward.launches
    got = relpos_attention_backward(q, k, v, out, dout, rh, rw, (H, W),
                                    *(d5[:, :, i].transpose(1, 2) for i in range(3)))
    torch.cuda.synchronize()
    assert relpos_attention_backward.launches == n + 4
    assert torch.isfinite(d5).all()  # every row of the qkv gradient written
    ref = relpos_attention_backward_plain(*(t.float() for t in (q, k, v, out, dout, rh, rw)),
                                          (H, W))
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for a, r in zip(got, ref):
        a, r = a.float().cpu(), r.float().cpu()
        err = float((a - r).abs().max()) / (float(r.abs().max()) + 1e-30)
        assert err <= tol, err


@pytest.mark.parametrize("hd", [64, 80])
def test_relpos_attention_fn_on_card_matches_cpu(dev, hd):
    """RelPosAttentionFn through autograd (K1 forward, K4 backward) on the card
    in f32 against the same function's plain CPU route."""
    from micro_sam_tpu_torch.ops.relpos_attention import RelPosAttentionFn
    g = torch.Generator().manual_seed(7)
    B, nH, H, W = 2, 4, 14, 14
    rows = torch.randn(B, H * W, 3, nH, hd, generator=g)
    tabs = [torch.randn(H, H, hd, generator=g) * 0.3, torch.randn(W, W, hd, generator=g) * 0.3]
    gout = torch.randn(B, nH, H * W, hd, generator=g)
    res = []
    for d in ("cpu", dev):
        r = rows.to(d).detach().requires_grad_()
        th, tw = (t.to(d).detach().requires_grad_() for t in tabs)
        out = RelPosAttentionFn.apply(r.permute(0, 2, 3, 1, 4), th, tw, (H, W))
        out.backward(gout.to(d))
        res.append([t.detach().cpu() for t in (out, r.grad, th.grad, tw.grad)])
    for a, r in zip(res[1], res[0]):
        assert float((a - r).abs().max()) <= 1e-4 * float(r.abs().max())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["window", "global"])
def test_block_chain_matches_plain(dev, dtype, kind):
    from micro_sam_tpu_torch.models.common import init_module_
    from micro_sam_tpu_torch.models.image_encoder import Block, window_partition
    from micro_sam_tpu_torch.ops import fused_window_block as fwb
    C, nH = 128, 2
    g = torch.Generator().manual_seed(3)
    if kind == "window":
        blk = Block(C, nH, 4.0, 7, (7, 7))
        x = torch.randn(2, 10, 10, C, generator=g)  # pads to 14: masked windows
        xw, _ = window_partition(x, 7)
        valid, _ = window_partition(torch.ones(2, 10, 10, 1), 7)
        xw, valid = xw.reshape(-1, 49, C).to(dev, dtype), valid.reshape(-1, 49, 1).to(dev)
    else:
        blk = Block(C, nH, 4.0, 0, (16, 16))
        xw, valid = torch.randn(2, 256, C, generator=g).to(dev, dtype), None
    init_module_(blk, g)
    blk = blk.hold_weights_in_(dtype).to(dev)
    hw = (7, 7) if kind == "window" else (16, 16)
    with torch.no_grad():
        if kind == "window":
            got = fwb.fused_window_block(xw, valid, blk, hw, nH)
            ref = fwb.fused_window_block_plain(xw.float(), valid, blk, hw, nH)
        else:
            got = fwb.fused_global_block(xw, blk, hw, nH)
            ref = fwb.fused_global_block_plain(xw.float(), blk, hw, nH)
    torch.cuda.synchronize()
    _held(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["window", "global"])
def test_attn_half_chains_match_plain(dev, dtype, kind):
    """K10 / K5, the attention halves, at head dim 80 (vit_h's) against the
    same halves through the plain versions: four launches a call."""
    from micro_sam_tpu_torch.models.common import init_module_
    from micro_sam_tpu_torch.models.image_encoder import Block, window_partition
    from micro_sam_tpu_torch.ops import fused_window_block as fwb
    from micro_sam_tpu_torch.ops.gemm import gemm
    from micro_sam_tpu_torch.ops.layernorm import layernorm
    from micro_sam_tpu_torch.ops.relpos_attention import relpos_attention
    C, nH = 160, 2
    g = torch.Generator().manual_seed(14)
    if kind == "window":
        blk = Block(C, nH, 4.0, 7, (7, 7))
        x = torch.randn(2, 10, 10, C, generator=g)  # pads to 14: masked windows
        xw, _ = window_partition(x, 7)
        valid, _ = window_partition(torch.ones(2, 10, 10, 1), 7)
        xw, valid = xw.reshape(-1, 49, C).to(dev, dtype), valid.reshape(-1, 49, 1).to(dev)
        hw = (7, 7)
    else:
        blk = Block(C, nH, 4.0, 0, (16, 16))
        xw, valid, hw = torch.randn(2, 256, C, generator=g).to(dev, dtype), None, (16, 16)
    init_module_(blk, g)
    blk = blk.hold_weights_in_(dtype).to(dev)
    counters = (layernorm, gemm, relpos_attention)
    before = [c.launches for c in counters]
    with torch.no_grad():
        if kind == "window":
            got = fwb.fused_window_attn(xw, valid, blk, hw, nH)
            launched = [c.launches - b for c, b in zip(counters, before)]
            ref = fwb.fused_window_attn_plain(xw.float(), valid, blk, hw, nH)
        else:
            got = fwb.fused_global_attn(xw, blk, hw, nH)
            launched = [c.launches - b for c, b in zip(counters, before)]
            ref = fwb.fused_global_attn_plain(xw.float(), blk, hw, nH)
    torch.cuda.synchronize()
    assert launched == [1, 2, 1]
    _held(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_relpos_attention_backward_refuses_hd96(dev, dtype):
    """The backward kernel used to be built for head dims 64 and 80 only and
    refused 96; it is now built for 96 too and matches the plain backward
    there (bf16: within 3e-2 of the f32 plain result). What it still refuses
    is a head dim above 256, before any launch (up to 128 until the backward
    was built at 256)."""
    from micro_sam_tpu_torch.ops.relpos_attention import (
        relpos_attention, relpos_attention_backward, relpos_attention_backward_plain)
    B, nH, H, hd = 2, 2, 7, 96
    g = torch.Generator().manual_seed(15)
    rows = torch.randn(B, H * H, 3, nH, hd, generator=g).to(dev, dtype)
    q, k, v = (rows[:, :, i].transpose(1, 2) for i in range(3))
    rh, rw = ((torch.randn(H, H, hd, generator=g) * 0.3).to(dev, dtype) for _ in range(2))
    out = relpos_attention(q, k, v, rh, rw, (H, H))
    dout = torch.randn(B, nH, H * H, hd, generator=g).to(dev, dtype)
    n = relpos_attention_backward.launches
    got = relpos_attention_backward(q, k, v, out, dout, rh, rw, (H, H))
    torch.cuda.synchronize()
    assert relpos_attention_backward.launches == n + 4
    _held_grads(got, relpos_attention_backward_plain(
        *(t.float() for t in (q, k, v, out, dout, rh, rw)), (H, H)), dtype)
    big = torch.zeros(1, 1, 4, 264, device=dev, dtype=dtype)
    tab = torch.zeros(2, 2, 264, device=dev, dtype=dtype)
    with pytest.raises(ValueError, match="up to 256"):
        relpos_attention_backward(big, big, big, big, big, tab, tab, (2, 2))
    assert relpos_attention_backward.launches == n + 4


def _held_grads(got, ref, dtype):
    """The backward's outputs against the plain backward's: f32 rel 1e-4,
    bf16 3e-2 (K4's bound)."""
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    assert len(got) == len(ref) == 5
    for a, r in zip(got, ref):
        a, r = a.float().cpu(), r.float().cpu()
        assert a.shape == r.shape and torch.isfinite(a).all()
        err = float((a - r).abs().max()) / (float(r.abs().max()) + 1e-30)
        assert err <= tol, err


BWD_VARIANT_CASES = {  # id: (B, nH, H, W, hd, the bf16 dk/dv and dq variants)
    "global": (1, 12, 64, 64, 64, "rows", "rows"),
    "global_16h": (1, 16, 64, 64, 64, "rows", "rows"),
    "global_hd80": (1, 16, 64, 64, 80, "rows", "rows"),
    "grid24x40": (2, 3, 24, 40, 64, "rows", "rows"),
    "w96": (1, 4, 8, 96, 64, "general", "general"),
    "tiny": (3, 2, 2, 3, 64, "window", "rows"),
    "windows50": (50, 12, 14, 14, 64, "window", "window"),
    "windows50_hd80": (50, 16, 14, 14, 80, "window", "window"),
    **{f"hd{hd}": (2, 2, 7, 9, hd, v, v) for hd, v in
       ((32, "window"), (64, "window"), (80, "window"), (96, "window"), (128, "window"),
        (160, "rows"), (256, "rows"))},
    "windows_hd128": (4, 4, 14, 14, 128, "rows", "rows"),
    "global_hd256": (1, 2, 64, 64, 256, "rows", "rows"),
}


def _backward_case(dev, dtype, B, nH, H, W, hd, seed):
    """q, k, v strided out of (B, N, 3, nH, hd) rows, the tables, the
    forward's output and lse (from the kernel) and an upstream gradient."""
    from micro_sam_tpu_torch.ops.relpos_attention import relpos_attention
    g = torch.Generator().manual_seed(seed)
    N = H * W
    rows = torch.randn(B, N, 3, nH, hd, generator=g).to(dev, dtype)
    q, k, v = (rows[:, :, i].transpose(1, 2) for i in range(3))
    rh = (torch.randn(H, H, hd, generator=g) * 0.3).to(dev, dtype)
    rw = (torch.randn(W, W, hd, generator=g) * 0.3).to(dev, dtype)
    lse = torch.empty(B, nH, N, device=dev)
    out = relpos_attention(q, k, v, rh, rw, (H, W), lse=lse)
    dout = torch.randn(B, nH, N, hd, generator=g).to(dev, dtype)
    return q, k, v, rh, rw, out, lse, dout


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(BWD_VARIANT_CASES))
def test_relpos_attention_backward_variants_match_plain(dev, dtype, case):
    """Each stage variant of the backward (backward_plan: window, rows,
    general) and each built head dim, with the forward's lse as the
    training path hands it, against the plain backward (f32 rel 1e-4; bf16
    3e-2 of the f32 plain result on the same bf16 inputs); four launches."""
    from micro_sam_tpu_torch.ops.relpos_attention import (
        backward_plan, kernel_head_dim, relpos_attention_backward,
        relpos_attention_backward_plain)
    B, nH, H, W, hd, dkdv, dq = BWD_VARIANT_CASES[case]
    plan = backward_plan(H * W, H, W, kernel_head_dim(hd))
    assert (plan.dkdv, plan.dq) == (dkdv, dq)
    q, k, v, rh, rw, out, lse, dout = _backward_case(dev, dtype, B, nH, H, W, hd, seed=hd + W)
    n = relpos_attention_backward.launches
    got = relpos_attention_backward(q, k, v, out, dout, rh, rw, (H, W), lse=lse)
    torch.cuda.synchronize()
    assert relpos_attention_backward.launches == n + 4
    _held_grads(got, relpos_attention_backward_plain(
        *(t.float() for t in (q, k, v, out, dout, rh, rw)), (H, W)), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["global", "windows50", "w96", "hd256"])
def test_relpos_attention_backward_is_deterministic(dev, dtype, case):
    """Two runs of the backward on the same inputs are equal to the bit (no
    atomics; every sum in a fixed order), with and without a given lse."""
    from micro_sam_tpu_torch.ops.relpos_attention import relpos_attention_backward
    B, nH, H, W, hd = BWD_VARIANT_CASES[case][:5]
    q, k, v, rh, rw, out, lse, dout = _backward_case(dev, dtype, B, nH, H, W, hd, seed=5)
    runs = [relpos_attention_backward(q, k, v, out, dout, rh, rw, (H, W), lse=lse)
            for _ in range(2)]
    runs.append(relpos_attention_backward(q, k, v, out, dout, rh, rw, (H, W)))
    torch.cuda.synchronize()
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,nH,H,W,hd", [(1, 12, 64, 64, 64), (25, 16, 14, 14, 80),
                                         (1, 4, 8, 96, 64), (2, 2, 7, 9, 256), (3, 2, 2, 3, 40)],
                         ids=["global", "windows_hd80", "w96", "hd256", "tiny_hd40"])
def test_relpos_attention_lse_matches_plain(dev, dtype, B, nH, H, W, hd):
    """K1's stored row log-sum-exps against the plain forward's (rel 1e-4 of
    max in both dtypes), and the serving call without lse unchanged to the
    bit by asking for them."""
    from micro_sam_tpu_torch.ops.relpos_attention import relpos_attention, relpos_attention_plain
    q, k, v, rh, rw, out, lse, _ = _backward_case(dev, dtype, B, nH, H, W, hd, seed=9)
    ref = torch.empty_like(lse)
    relpos_attention_plain(q.float(), k.float(), v.float(), rh.float(), rw.float(), (H, W),
                           lse=ref)
    err = float((lse - ref).abs().max()) / float(ref.abs().max())
    assert torch.isfinite(lse).all() and err <= 1e-4, err
    assert torch.equal(relpos_attention(q, k, v, rh, rw, (H, W)), out)


HD_SWEEP = [16, 32, 40, 64, 80, 96, 100, 128, 160, 256]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("misaligned", [False, True], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("hd", HD_SWEEP)
def test_relpos_attention_head_dim_sweep(dev, dtype, hd, misaligned):
    """Forward and backward at every head dim up to 256 against the plain
    versions: an instantiated head dim runs in place, another one staged
    into the next instantiated one, zero-padded; a view offset by one
    element (rows not 16-byte aligned) is staged too. One forward launch and
    four backward launches a call, whatever the staging."""
    from micro_sam_tpu_torch.ops.relpos_attention import (
        relpos_attention, relpos_attention_backward, relpos_attention_backward_plain,
        relpos_attention_plain)
    B, nH, H, W = 3, 2, 7, 9
    N = H * W
    g = torch.Generator().manual_seed(40 + hd)
    flat = torch.randn(B * N * 3 * nH * hd + 1, generator=g).to(dev, dtype)
    q5 = flat[1:].view(B, N, 3, nH, hd) if misaligned else flat[:-1].view(B, N, 3, nH, hd)
    q, k, v = (q5[:, :, i].transpose(1, 2) for i in range(3))
    rh = (torch.randn(H, H, hd, generator=g) * 0.3).to(dev, dtype)
    rw = (torch.randn(W, W, hd, generator=g) * 0.3).to(dev, dtype)
    n_f, n_b = relpos_attention.launches, relpos_attention_backward.launches
    out_rows = torch.full((B * N * nH * hd + 1,), float("nan"), device=dev, dtype=dtype)
    out = (out_rows[1:] if misaligned else out_rows[:-1]).view(B, N, nH, hd).transpose(1, 2)
    got = relpos_attention(q, k, v, rh, rw, (H, W), out=out)
    torch.cuda.synchronize()
    assert got is out and relpos_attention.launches == n_f + 1
    _held(got, relpos_attention_plain(q.float(), k.float(), v.float(), rh.float(), rw.float(),
                                      (H, W)), dtype)
    dout = torch.randn(B, nH, N, hd, generator=g).to(dev, dtype)
    grads = relpos_attention_backward(q, k, v, got, dout, rh, rw, (H, W))
    torch.cuda.synchronize()
    assert relpos_attention_backward.launches == n_b + 4
    _held_grads(grads, relpos_attention_backward_plain(
        *(t.float() for t in (q, k, v, got, dout, rh, rw)), (H, W)), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("B, nH, w, Hp, Wp", [(2, 3, 7, 14, 21), (4, 12, 14, 70, 70)],
                         ids=["toy", "tiled_batch"])
def test_relpos_attention_spatial_matches_partitioned(dev, dtype, hd, B, nH, w, Hp, Wp):
    """The spatial mode reads each w x w window of padded (B, Hp, Wp) maps
    from the qkv product's rows and writes the proj product's rows: the same
    as the plain mode on the partitioned windows (equal: the same
    arithmetic), and within tolerance of the plain version. Geometries: a toy
    (2, 14, 21) map of 7 x 7 windows, and the tiled path's 4-tile batch,
    (4, 70, 70) maps of 14 x 14 windows at vit_b's 12 heads."""
    from micro_sam_tpu_torch.ops.relpos_attention import (
        _unwindows, _windows, relpos_attention, relpos_attention_spatial,
        relpos_attention_spatial_plain)
    g = torch.Generator().manual_seed(50 + hd)
    rows = torch.randn(B * Hp * Wp, 3 * nH * hd, generator=g).to(dev, dtype)
    q6 = rows.view(B, Hp, Wp, 3, nH, hd)
    q, k, v = (q6[:, :, :, i] for i in range(3))
    rh, rw = ((torch.randn(w, w, hd, generator=g) * 0.3).to(dev, dtype) for _ in range(2))
    o = torch.full((B, Hp, Wp, nH, hd), float("nan"), device=dev, dtype=dtype)
    n = relpos_attention_spatial.launches
    got = relpos_attention_spatial(q, k, v, rh, rw, w, out=o)
    torch.cuda.synchronize()
    assert got is o and relpos_attention_spatial.launches == n + 1
    part = relpos_attention(*(_windows(t, w) for t in (q, k, v)), rh, rw, (w, w))
    assert torch.equal(got, _unwindows(part, B, Hp, Wp, w))
    _held(got, relpos_attention_spatial_plain(q.float(), k.float(), v.float(), rh.float(),
                                              rw.float(), w), dtype)


def _window_block(dev, dtype, C, nH, w, seed):
    from micro_sam_tpu_torch.models.common import init_module_
    from micro_sam_tpu_torch.models.image_encoder import Block
    g = torch.Generator().manual_seed(seed)
    blk = Block(C, nH, 4.0, w, (w, w))
    init_module_(blk, g)
    return blk.hold_weights_in_(dtype).to(dev), g


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("H", [10, 14], ids=["padded", "unpadded"])
def test_spatial_block_chain_matches_plain_and_k2(dev, dtype, H):
    """K9 on the padded map: 7 launches (LN1 in the grid mode, the spatial
    attention), within tolerance of its plain version, and equal to the
    partitioned K2 chain on the same windows."""
    from micro_sam_tpu_torch.models.image_encoder import partition_tokens, window_unpartition
    from micro_sam_tpu_torch.ops import fused_window_block as fwb
    from micro_sam_tpu_torch.ops.gemm import gemm
    from micro_sam_tpu_torch.ops.layernorm import layernorm
    from micro_sam_tpu_torch.ops.relpos_attention import relpos_attention_spatial
    C, nH, w, B = 128, 2, 7, 2
    blk, g = _window_block(dev, dtype, C, nH, w, 60)
    x = torch.randn(B, H, H, C, generator=g).to(dev, dtype)
    xw, valid, pad_hw = partition_tokens(x, w)
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad_hw[1] - H, 0, pad_hw[0] - H))
    counters = (layernorm, gemm, relpos_attention_spatial)
    before = [c.launches for c in counters]
    with torch.no_grad():
        got = fwb.fused_window_block_spatial(xp, blk, w, (H, H), nH)
        launched = [c.launches - b for c, b in zip(counters, before)]
        ref = fwb.fused_window_block_spatial_plain(xp.float(), blk, w, (H, H), nH)
        k2 = fwb.fused_window_block(xw, valid, blk, (w, w), nH)
    torch.cuda.synchronize()
    assert launched == [2, 4, 1]
    _held(got, ref, dtype)
    assert torch.equal(got, window_unpartition(k2.reshape(-1, w, w, C), w, pad_hw, pad_hw))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_window_stack_chain_matches_plain(dev, dtype, masked):
    """K11 over 2 images of 4 windows: the seven launches of K2, within
    tolerance of its plain version and equal to K2 on the same windows."""
    from micro_sam_tpu_torch.ops import fused_window_block as fwb
    from micro_sam_tpu_torch.ops.gemm import gemm
    from micro_sam_tpu_torch.ops.layernorm import layernorm
    from micro_sam_tpu_torch.ops.relpos_attention import relpos_attention
    C, nH, w = 128, 2, 7
    blk, g = _window_block(dev, dtype, C, nH, w, 61)
    x = torch.randn(8, w * w, C, generator=g).to(dev, dtype)
    valid = (torch.rand(8, w * w, 1, generator=g) > 0.2).float().to(dev) if masked else None
    counters = (layernorm, gemm, relpos_attention)
    before = [c.launches for c in counters]
    with torch.no_grad():
        got = fwb.fused_window_stack(x, valid, blk, (w, w), nH, 2)
        launched = [c.launches - b for c, b in zip(counters, before)]
        ref = fwb.fused_window_stack_plain(x.float(), valid, blk, (w, w), nH, 2)
        k2 = fwb.fused_window_block(x, valid, blk, (w, w), nH)
    torch.cuda.synchronize()
    assert launched == [2, 4, 1]
    _held(got, ref, dtype)
    assert torch.equal(got, k2)


@pytest.mark.parametrize("knob", ["MSAM_TPU_SPATIAL_WINDOW", "MSAM_TPU_WINDOW_STACK"])
def test_encoder_routes_on_card_match_default(dev, monkeypatch, knob):
    """A small bf16 ViT (3 blocks, 128 wide, 16 x 16 tokens padded to 21 for
    7 x 7 windows, 2 images) under each route's knob, on the card: the same
    embedding as the default route."""
    from micro_sam_tpu_torch.models.sam import Sam, SamConfig, preprocess
    cfg = SamConfig(embed_dim=128, depth=3, num_heads=2, window_size=7,
                    global_attn_indexes=(2,), img_size=256, compute_dtype="bfloat16")
    sam = Sam(cfg).init_(torch.Generator().manual_seed(63)).to(dev).eval()
    img = torch.rand(2, 256, 256, 3, generator=torch.Generator().manual_seed(62)) * 255
    px = preprocess(img.to(dev), 256)
    monkeypatch.delenv("MSAM_TPU_SPATIAL_WINDOW", raising=False)
    monkeypatch.delenv("MSAM_TPU_WINDOW_STACK", raising=False)
    with torch.no_grad():
        default = sam.encode_image(px)
        monkeypatch.setenv(knob, "1")
        got = sam.encode_image(px)
    torch.cuda.synchronize()
    assert torch.equal(got, default)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,N,nH,hd,hw", [(1, 4096, 12, 64, (64, 64)), (25, 196, 16, 80, (14, 14)),
                                          (2, 70, 2, 80, (7, 10))],
                         ids=["global_hd64", "window_hd80", "ragged_hd80"])
def test_flash_attention_rel_pos_matches_plain(dev, dtype, B, N, nH, hd, hw):
    """K12: (B, N, nH, hd) q, k, v through the forward kernel (one launch) and
    the backward kernel (four), against the plain versions on the
    (B, nH, N, hd) views: f32 rel 1e-4, bf16 (the plain run in f32 on the same
    inputs) 2e-2 forward and 3e-2 backward."""
    from micro_sam_tpu_torch.ops.flash_attention import flash_attention_rel_pos
    from micro_sam_tpu_torch.ops.relpos_attention import (
        relpos_attention, relpos_attention_backward, relpos_attention_backward_plain,
        relpos_attention_plain)
    H, W = hw
    g = torch.Generator().manual_seed(18)
    q, k, v, dout = (torch.randn(B, N, nH, hd, generator=g).to(dev, dtype) for _ in range(4))
    rh = (torch.randn(H, H, hd, generator=g) * 0.3).to(dev, dtype)
    rw = (torch.randn(W, W, hd, generator=g) * 0.3).to(dev, dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, rh, rw)]
    n_fwd, n_bwd = relpos_attention.launches, relpos_attention_backward.launches
    with torch.enable_grad():
        out = flash_attention_rel_pos(*leaves[:3], hw, *leaves[3:])
        out.backward(dout)
    torch.cuda.synchronize()
    assert (relpos_attention.launches - n_fwd, relpos_attention_backward.launches - n_bwd) == (1, 4)
    assert out.shape == (B, N, nH, hd) and out.is_contiguous()
    t = lambda a: a.float().transpose(1, 2)
    ref = relpos_attention_plain(t(q), t(k), t(v), rh.float(), rw.float(), hw)
    _held(out.detach(), ref.transpose(1, 2), dtype)
    refs = relpos_attention_backward_plain(t(q), t(k), t(v), ref, t(dout), rh.float(), rw.float(),
                                           hw)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for leaf, r in zip(leaves, refs):
        r = r.transpose(1, 2) if r.dim() == 4 else r
        a, r = leaf.grad.float().cpu(), r.float().cpu()
        assert a.shape == r.shape
        err = float((a - r).abs().max()) / (float(r.abs().max()) + 1e-30)
        assert err <= tol, err


def test_encoder_on_card_matches_cpu(dev):
    """A small ViT (2 blocks, 128 wide, 16 x 16 tokens padded to 21 for 7 x 7
    windows) through the whole encoder: card f32 against CPU f32."""
    from micro_sam_tpu_torch.models.sam import Sam, SamConfig, preprocess
    cfg = SamConfig(embed_dim=128, depth=2, num_heads=2, window_size=7,
                    global_attn_indexes=(1,), img_size=256)
    sam = Sam(cfg).init_(torch.Generator().manual_seed(4)).eval()
    img = torch.rand(1, 256, 256, 3, generator=torch.Generator().manual_seed(5)) * 255
    ref = sam.encode_image(preprocess(img, 256))
    got = sam.to(dev).encode_image(preprocess(img.to(dev), 256))
    torch.cuda.synchronize()
    rel = float((got.cpu() - ref).abs().max() / ref.abs().max())
    assert rel <= 1e-4, rel


def test_vit_h_class_encoder_on_card_matches_cpu(dev):
    """Head dim 80 through the whole encoder (160 wide, 2 heads, 4 blocks,
    the last global, 16 x 16 tokens padded to 28 for 14 x 14 windows): card
    f32 against CPU f32."""
    from micro_sam_tpu_torch.models.sam import Sam, SamConfig, preprocess
    cfg = SamConfig(model_type="vit_h", embed_dim=160, depth=4, num_heads=2,
                    global_attn_indexes=(3,), img_size=256)
    sam = Sam(cfg).init_(torch.Generator().manual_seed(16)).eval()
    img = torch.rand(1, 256, 256, 3, generator=torch.Generator().manual_seed(17)) * 255
    ref = sam.encode_image(preprocess(img, 256))
    got = sam.to(dev).encode_image(preprocess(img.to(dev), 256))
    torch.cuda.synchronize()
    rel = float((got.cpu() - ref).abs().max() / ref.abs().max())
    assert rel <= 1e-4, rel


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,W,C,gelu", [(2, 64, 48, 256, True), (1, 128, 128, 128, False),
                                          (2, 13, 11, 160, False), (1, 9, 7, 12, True)],
                         ids=["mbconv", "tail", "odd", "narrow"])
def test_dwconv_matches_plain(dev, dtype, B, H, W, C, gelu):
    """Any H, W and C: 12 bf16 channels (24 bytes a pixel) take the kernel's
    body without TMA."""
    from micro_sam_tpu_torch.ops.dwconv import dwconv, dwconv_plain
    g = torch.Generator().manual_seed(8)
    x = torch.randn(B, H, W, C, generator=g).to(dev, dtype)
    w = (torch.randn(C, 1, 3, 3, generator=g) / 3).to(dev)
    s, t = (torch.rand(C, generator=g) + 0.5).to(dev), (torch.randn(C, generator=g) * 0.1).to(dev)
    n = dwconv.launches
    got = dwconv(x, w, s, t, gelu)
    torch.cuda.synchronize()
    assert dwconv.launches == n + 1
    _held(got, dwconv_plain(x.float(), w, s, t, gelu), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Hp,Wp,C,nH,w", [(1, 133, 133, 128, 4, 7), (1, 70, 70, 160, 5, 14),
                                            (2, 14, 21, 320, 10, 7)],
                         ids=["stage1", "stage2", "stage3"])
def test_tiny_attention_matches_plain(dev, dtype, B, Hp, Wp, C, nH, w):
    from micro_sam_tpu_torch.ops.tiny_attention import tiny_attention, tiny_attention_plain
    g = torch.Generator().manual_seed(9)
    qkv = torch.randn(B * Hp * Wp, 3 * C, generator=g).to(dev, dtype)
    table = (torch.randn(nH, w * w, generator=g) * 0.5).to(dev)
    n = tiny_attention.launches
    got = tiny_attention(qkv, table, (B, Hp, Wp), w)
    torch.cuda.synchronize()
    assert tiny_attention.launches == n + 1
    _held(got, tiny_attention_plain(qkv.float(), table, (B, Hp, Wp), w), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("Hp,C,nH,w", [(133, 128, 4, 7), (70, 160, 5, 14), (70, 320, 10, 7)],
                         ids=["stage1", "stage2", "stage3"])
def test_tiny_attention_batch2_matches_plain(dev, dtype, Hp, C, nH, w):
    from micro_sam_tpu_torch.ops.tiny_attention import tiny_attention, tiny_attention_plain
    g = torch.Generator().manual_seed(10)
    qkv = torch.randn(2 * Hp * Hp, 3 * C, generator=g).to(dev, dtype)
    table = (torch.randn(nH, w * w, generator=g) * 0.5).to(dev)
    got = tiny_attention(qkv, table, (2, Hp, Hp), w)
    torch.cuda.synchronize()
    _held(got, tiny_attention_plain(qkv.float(), table, (2, Hp, Hp), w), dtype)


@pytest.mark.parametrize("case", ["grid1", "grid7", "one_head", "warps_in_turns"])
@pytest.mark.parametrize("Hp,C,nH,w", [(133, 128, 4, 7), (70, 160, 5, 14), (70, 320, 10, 7)],
                         ids=["stage1", "stage2", "stage3"])
def test_tiny_attention_other_layouts_match_plain(dev, case, Hp, C, nH, w):
    """The bf16 kernel under layouts the plan does not pick: one block or 7
    walking every unit through the load ring, a head a unit, fewer warps than
    (head, row group) pairs."""
    from micro_sam_tpu_torch.ops.tiny_attention import (TinyAttentionPlan, smem_bytes,
                                                        tiny_attention, tiny_attention_plain,
                                                        tiny_attention_plan)
    g = torch.Generator().manual_seed(11)
    qkv = torch.randn(Hp * Hp, 3 * C, generator=g).to(dev, torch.bfloat16)
    table = (torch.randn(nH, w * w, generator=g) * 0.5).to(dev)
    plan = tiny_attention_plan(1, Hp, Hp, C, nH, w)
    groups = -(-w * w // 16)
    if case == "grid1":
        plan = plan._replace(grid=1)
    elif case == "grid7":
        plan = plan._replace(grid=7)
    elif case == "one_head":
        units = (Hp // w) ** 2 * nH
        plan = TinyAttentionPlan(1, groups, units, min(units, 132), 2, smem_bytes(w, 1, nH), 1)
    else:
        plan = plan._replace(warps=max(1, plan.warps // 3))
    got = tiny_attention(qkv, table, (1, Hp, Hp), w, plan=plan)
    torch.cuda.synchronize()
    _held(got, tiny_attention_plain(qkv.float(), table, (1, Hp, Hp), w), torch.bfloat16)


def test_tiny_attention_reuses_its_tensor_map(dev):
    from micro_sam_tpu_torch.ops import _cuda
    from micro_sam_tpu_torch.ops.tiny_attention import tiny_attention
    qkv = torch.randn(70 * 70, 480, device=dev).to(torch.bfloat16)
    table = torch.randn(5, 196, device=dev)
    tiny_attention(qkv, table, (1, 70, 70), 14)
    lib = _cuda.library("tiny_attention")
    n = lib.msam_tiny_attention_maps_encoded()
    for _ in range(3):
        tiny_attention(qkv, table, (1, 70, 70), 14)
    torch.cuda.synchronize()
    assert lib.msam_tiny_attention_maps_encoded() == n


def test_tiny_attention_refuses_more_warps_than_built(dev):
    from micro_sam_tpu_torch.ops.tiny_attention import tiny_attention, tiny_attention_plan
    qkv = torch.randn(70 * 70, 480, device=dev).to(torch.bfloat16)
    table = torch.randn(5, 196, device=dev)
    plan = tiny_attention_plan(1, 70, 70, 160, 5, 14)
    with pytest.raises(RuntimeError):
        tiny_attention(qkv, table, (1, 70, 70), 14, plan=plan._replace(warps=14))
    with pytest.raises(RuntimeError):  # heads not dividing nH
        tiny_attention(qkv, table, (1, 70, 70), 14, plan=plan._replace(heads=2))


def _tiny_vit(dtype, dev):
    """A random vit_t encoder with non-trivial BN statistics."""
    from micro_sam_tpu_torch.models.common import BatchNorm, init_module_
    from micro_sam_tpu_torch.models.tiny_vit import TinyViT
    g = torch.Generator().manual_seed(10)
    enc = TinyViT(dtype=dtype)
    init_module_(enc, g)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.2)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
    return enc.to(dev).eval()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("chain", ["K6", "K7", "K8"])
def test_tiny_chains_match_plain(dev, dtype, chain):
    """The vit_t kernel chains against the same chains through the plain
    versions (f32, on the same inputs), stage 1's attention and tail."""
    from micro_sam_tpu_torch.ops import fused_mbconv as k7, fused_tiny_attention as k6
    from micro_sam_tpu_torch.ops import fused_tiny_tail as k8
    enc = _tiny_vit(dtype, dev)
    g = torch.Generator().manual_seed(11)
    blk = enc.layers[1].blocks[0]
    with torch.no_grad():
        if chain == "K7":
            x = torch.randn(2, 32, 40, 64, generator=g).to(dev, dtype)
            mb = enc.layers[0].blocks[0]
            got, ref = k7.fused_mbconv(x, mb), k7.fused_mbconv_plain(x.float(), mb)
        elif chain == "K6":
            x = torch.randn(2, 21, 28, 128, generator=g).to(dev, dtype)
            got = k6.fused_tiny_attention(x, blk.attn)
            ref = k6.fused_tiny_attention_plain(x.float(), blk.attn)
        else:
            x = torch.randn(2, 20, 24, 128, generator=g).to(dev, dtype)
            got = k8.fused_tiny_tail(x, blk.local_conv, blk.mlp)
            ref = k8.fused_tiny_tail_plain(x.float(), blk.local_conv, blk.mlp)
    torch.cuda.synchronize()
    _held(got, ref, dtype)


def test_vit_t_encoder_on_card_matches_cpu(dev):
    """vit_t through the whole encoder at 128 px: card f32 against CPU f32."""
    from dataclasses import replace
    from micro_sam_tpu_torch.models.build_sam import get_config
    from micro_sam_tpu_torch.models.sam import Sam, preprocess
    cfg = replace(get_config("vit_t", "float32"), img_size=128)
    sam = Sam(cfg).init_(torch.Generator().manual_seed(12)).eval()
    img = torch.rand(1, 128, 128, 3, generator=torch.Generator().manual_seed(13)) * 255
    ref = sam.encode_image(preprocess(img, 128))
    got = sam.to(dev).encode_image(preprocess(img.to(dev), 128))
    torch.cuda.synchronize()
    rel = float((got.cpu() - ref).abs().max() / ref.abs().max())
    assert rel <= 1e-4, rel


def test_get_sam_model_defaults_to_the_card(dev):
    from micro_sam_tpu_torch.util import get_sam_model
    for model_type in ("vit_b", "vit_t"):
        p = get_sam_model(model_type)
        assert p.device.type == "cuda" and p.model.config.compute_dtype == "bfloat16"


# ---------------------------------------------------------------------------
# dwconv: the TMA body at the vit_t shapes, the other body, edges
# ---------------------------------------------------------------------------

DW_VIT_T = {"mbconv": (256, 256, 256, True), "stage1_tail": (128, 128, 128, False),
            "stage2_tail": (64, 64, 160, False), "stage3_tail": (64, 64, 320, False)}


def _dw_case(dev, dtype, B, H, W, C, seed=8):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, H, W, C, generator=g).to(dev, dtype)
    w = (torch.randn(C, 1, 3, 3, generator=g) / 3).to(dev)
    s, t = (torch.rand(C, generator=g) + 0.5).to(dev), (torch.randn(C, generator=g) * 0.1).to(dev)
    return x, w, s, t


def _dw_held(dev, dtype, x, w, s, t, gelu, body):
    from micro_sam_tpu_torch.ops.dwconv import _alignment, dwconv, dwconv_plain, dwconv_plan
    B, H, W, C = x.shape
    plan = dwconv_plan(B, H, W, C, x.element_size(), _alignment(x))
    assert plan.body == body
    n = dwconv.launches
    got = dwconv(x, w, s, t, gelu)
    torch.cuda.synchronize()
    assert dwconv.launches == n + 1
    _held(got, dwconv_plain(x.float(), w, s, t, gelu), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("shape", list(DW_VIT_T))
def test_dwconv_vit_t_shapes_match_plain(dev, dtype, B, shape):
    """The depthwise shapes of a vit_t encode (the MBConv's with GELU, the
    three tails'), batch 1 and 8: the TMA body, one launch a call."""
    H, W, C, gelu = DW_VIT_T[shape]
    _dw_held(dev, dtype, *_dw_case(dev, dtype, B, H, W, C), gelu, "tma")


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("C", [8, 12, 24, 40, 160, 320])
@pytest.mark.parametrize("H,W", [(1, 1), (1, 6), (2, 2), (3, 3), (5, 1), (2, 9), (3, 40),
                                 (17, 13), (33, 65)])
def test_dwconv_edges_match_plain(dev, dtype, C, H, W):
    """H or W of 1, 2 and 3, odd sizes, narrow and wide channel counts: the
    TMA body where C's bytes are a multiple of 16 (C 12 in bf16 is not), the
    other body else; both with and without GELU."""
    x, w, s, t = _dw_case(dev, dtype, 2, H, W, C, seed=H * 100 + W + C)
    body = "tma" if (C * x.element_size()) % 16 == 0 else "plain"
    for gelu in (False, True):
        _dw_held(dev, dtype, x, w, s, t, gelu, body)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("C", [64, 160, 12])
def test_dwconv_unaligned_view_takes_the_other_body(dev, dtype, C):
    """A map one element past an aligned address: no TMA; the other body's
    vectors as wide as the address allows."""
    x0, w, s, t = _dw_case(dev, dtype, 2, 19, 23, C)
    buf = torch.empty(x0.numel() + 1, device=dev, dtype=dtype)
    x = buf[1:].view(x0.shape)
    x.copy_(x0)
    _dw_held(dev, dtype, x, w, s, t, True, "plain")


def test_dwconv_weight_update_is_seen(dev):
    """The (9, C) re-layout of the weight is cached per weight tensor and
    made anew after an in-place update."""
    from micro_sam_tpu_torch.ops.dwconv import dwconv, dwconv_plain
    x, w, s, t = _dw_case(dev, torch.float32, 1, 20, 24, 64)
    _held(dwconv(x, w, s, t), dwconv_plain(x, w, s, t), torch.float32)
    with torch.no_grad():
        w.mul_(-2.0)
    _held(dwconv(x, w, s, t), dwconv_plain(x, w, s, t), torch.float32)


# ---------------------------------------------------------------------------
# rel-pos attention (K1, K4) on grids whose u tables need key rectangles
# ---------------------------------------------------------------------------

LARGE_GRIDS = {"336x336_hd64": (336, 336, 64), "336x336_hd80": (336, 336, 80),
               "32x640_hd64": (32, 640, 64)}


def _large_case(dev, dtype, H, W, hd, seed, nH=2):
    """q, k, v strided out of (1, N, 3, nH, hd) rows, the tables, 128
    sampled q rows (the map's corners among them) and 64 of them for the
    backward."""
    g = torch.Generator().manual_seed(seed)
    N = H * W
    rows = torch.randn(1, N, 3, nH, hd, generator=g).to(dev, dtype)
    q, k, v = (rows[:, :, i].transpose(1, 2) for i in range(3))
    rh = (torch.randn(H, H, hd, generator=g) * 0.3).to(dev, dtype)
    rw = (torch.randn(W, W, hd, generator=g) * 0.3).to(dev, dtype)
    corners = torch.tensor([0, W - 1, N - W, N - 1])
    sample = torch.cat([corners, torch.randperm(N, generator=g)[:124]]).unique().to(dev)
    return q, k, v, rh, rw, sample


def _rects(dtype, H, W, hd, backward=False):
    from micro_sam_tpu_torch.ops import relpos_attention as rpa
    if dtype == torch.bfloat16:
        plan = (rpa.backward_plan if backward else rpa.forward_plan)(H * W, H, W, hd)
        return [r for r, _ in plan.rects]
    return list((rpa.f32_backward_rects if backward else rpa.f32_forward_rects)(H, W, hd))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(LARGE_GRIDS))
def test_relpos_attention_large_grid_matches_plain_rows(dev, dtype, case):
    """K1 on a grid above the one-rectangle limit: one launch a key
    rectangle, the outputs merged by their log-sum-exps; 128 sampled rows
    (output and lse) against the plain version's rows over all keys."""
    from micro_sam_tpu_torch.ops.relpos_attention import (relpos_attention,
                                                          relpos_attention_plain_rows)
    H, W, hd = LARGE_GRIDS[case]
    rects = _rects(dtype, H, W, hd)
    assert len(rects) > 1
    q, k, v, rh, rw, sample = _large_case(dev, dtype, H, W, hd, seed=H + W + hd)
    lse = torch.empty(q.shape[:3], device=dev)
    n = relpos_attention.launches
    out = relpos_attention(q, k, v, rh, rw, (H, W), lse=lse)
    torch.cuda.synchronize()
    assert relpos_attention.launches == n + len(rects)
    ref, ref_lse = relpos_attention_plain_rows(q, k, v, rh, rw, (H, W), sample)
    _held(out[:, :, sample], ref, dtype)
    err = float((lse[:, :, sample] - ref_lse).abs().max()) / float(ref_lse.abs().max())
    assert torch.isfinite(lse).all() and err <= 1e-4, err
    # without lse: the same output (the rectangles' log-sum-exps in buffers of their own)
    assert torch.equal(relpos_attention(q, k, v, rh, rw, (H, W)), out)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(LARGE_GRIDS))
def test_relpos_attention_backward_large_grid_matches_plain_rows(dev, dtype, case):
    """K4 on the same grids, dout zero outside 64 sampled rows: dq (zero
    elsewhere), dk, dv and both table gradients against the plain backward
    of those rows (f32 rel 1e-4, bf16 3e-2); four launches a rectangle."""
    from micro_sam_tpu_torch.ops.relpos_attention import (
        relpos_attention, relpos_attention_backward, relpos_attention_backward_plain_rows)
    H, W, hd = LARGE_GRIDS[case]
    rects = _rects(dtype, H, W, hd, backward=True)
    assert len(rects) > 1
    q, k, v, rh, rw, sample = _large_case(dev, dtype, H, W, hd, seed=H * W + hd)
    rows = sample[:64]
    lse = torch.empty(q.shape[:3], device=dev)
    out = relpos_attention(q, k, v, rh, rw, (H, W), lse=lse)
    g = torch.Generator().manual_seed(hd)
    dout = torch.zeros_like(q)
    dout[:, :, rows] = torch.randn(q.shape[0], q.shape[1], len(rows), hd,
                                   generator=g).to(dev, dtype)
    n = relpos_attention_backward.launches
    got = relpos_attention_backward(q, k, v, out, dout, rh, rw, (H, W), lse=lse)
    torch.cuda.synchronize()
    assert relpos_attention_backward.launches == n + 4 * len(rects)
    _held_grads(got, relpos_attention_backward_plain_rows(q, k, v, out, dout, rh, rw, (H, W),
                                                          rows), dtype)


# ---------------------------------------------------------------------------
# the UNETR decoder of AIS (plain PyTorch: cuDNN convolutions) on the card
# ---------------------------------------------------------------------------

def _narrow_unetr(use_conv_transpose, seed=0):
    """The decoder at narrow widths (embed 256, features 64 / 32 / 16 / 8),
    random weights and BN statistics; on the CPU."""
    from micro_sam_tpu_torch.models.common import BatchNorm
    from micro_sam_tpu_torch.models.unetr import UNETRDecoder
    model = UNETRDecoder(features=(64, 32, 16, 8), use_conv_transpose=use_conv_transpose)
    model.init_(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.running_mean.copy_(0.5 * torch.randn(m.running_mean.shape, generator=g))
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
    return model.eval()


@pytest.mark.parametrize("use_conv_transpose", [True, False], ids=["conv_transpose", "bilinear"])
def test_unetr_decoder_f32_on_the_card_matches_the_cpu(dev, use_conv_transpose):
    """f32 with TF32 off: the card's output within 1e-4 of max of the CPU's,
    from NHWC features handed over as a channels-last view."""
    model = _narrow_unetr(use_conv_transpose)
    x = torch.randn(2, 16, 16, 256, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        ref = model(x.permute(0, 3, 1, 2))
        got = model.to(dev)(x.to(dev).permute(0, 3, 1, 2))
    assert got.device.type == "cuda" and got.is_contiguous(memory_format=torch.channels_last)
    _held(got, ref, torch.float32)


def test_decoder_adapter_on_the_card(dev):
    """DecoderAdapter on bf16 features on the card: the decoder's output stays
    on the card in bf16, the maps reach the host as float32 numpy of the
    original size."""
    import numpy as np
    from micro_sam_tpu_torch.instance_segmentation import DecoderAdapter
    dec = DecoderAdapter(_narrow_unetr(True).to(dev))
    x = torch.randn(1, 16, 16, 256, generator=torch.Generator().manual_seed(4)).to(
        dev, torch.bfloat16)
    with torch.no_grad():
        raw = dec._forward_impl(x)
    assert raw.device.type == "cuda" and raw.dtype == torch.bfloat16
    assert raw.shape == (1, 3, 256, 256)
    maps = dec(x, (256, 200), (300, 234))
    assert isinstance(maps, np.ndarray) and maps.dtype == np.float32
    assert maps.shape == (1, 3, 300, 234) and np.isfinite(maps).all()
    assert ((maps >= 0) & (maps <= 1)).all()


# ---------------------------------------------------------------------------
# multi-dimensional segmentation and tracking
# ---------------------------------------------------------------------------

def test_link_scorer_on_the_card_matches_the_cpu(dev):
    """The packaged tracker weights: the scorer's f32 logits on the card
    within rel 1e-5 of the CPU's (TF32 off), and the same links."""
    import numpy as np
    from micro_sam_tpu_torch import learned_tracking as lt
    params = lt.load_linker(lt._PACKAGED_WEIGHTS)
    images, segs, _ = lt.hela_like_tracking_sequence(n_frames=6, shape=(256, 256), n_cells=6,
                                                     seed=0)
    card, cpu = lt.LearnedTracker(params, device="cuda"), lt.LearnedTracker(params, device="cpu")
    assert card.scorer.fc1.weight.device.type == "cuda"
    for t in range(len(segs) - 1):
        _, _, got = card.score_frames(segs[t], segs[t + 1], images[t], images[t + 1])
        _, _, ref = cpu.score_frames(segs[t], segs[t + 1], images[t], images[t + 1])
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        assert float(np.abs(got - ref).max()) <= 1e-5 * float(np.abs(ref).max())
    assert card.link(segs, images) == cpu.link(segs, images)


def test_segment_mask_in_volume_on_the_card_matches_the_cpu(dev):
    """A narrow vit_b (64 wide, 2 blocks, 128 px, random weights) in f32 with
    TF32 off: every projected slice within IoU 0.99 of the CPU's, the same z
    range."""
    import numpy as np
    from micro_sam_tpu_torch.models.sam import Sam, SamConfig
    from micro_sam_tpu_torch.multi_dimensional_segmentation import segment_mask_in_volume
    from micro_sam_tpu_torch.predictor import SamPredictor
    from micro_sam_tpu_torch.sample_data import synthetic_data
    from micro_sam_tpu_torch.util import precompute_image_embeddings
    cfg = SamConfig(embed_dim=64, depth=2, num_heads=2, global_attn_indexes=(1,), img_size=128)
    image, seg = synthetic_data(shape=(128, 128), seed=11, n_objects=5)
    volume = np.stack([np.roll(image, 2 * z, axis=0) for z in range(6)])
    truth = np.stack([np.roll(seg, 2 * z, axis=0) for z in range(6)])
    runs = []
    for device in ("cpu", "cuda"):
        sam = Sam(cfg).init_(torch.Generator().manual_seed(5)).eval()
        predictor = SamPredictor(sam.to(device))
        emb = precompute_image_embeddings(predictor, volume, ndim=3, verbose=False, batch_size=3)
        out = np.zeros(volume.shape, np.uint32)
        out[2] = truth[2] == 1
        runs.append(segment_mask_in_volume(out, predictor, emb, np.array([2]), False, False, 0.0,
                                           "mask"))
    (ref, ref_range), (got, got_range) = runs
    assert got_range == ref_range == (0, 5)
    for z in range(6):
        union = np.logical_or(got[z], ref[z]).sum()
        assert union == 0 or np.logical_and(got[z], ref[z]).sum() / union >= 0.99, z


# ---------------------------------------------------------------------------
# joint finetuning: the UNETR decoder's training step
# ---------------------------------------------------------------------------

def test_decoder_step_f32_on_the_card_matches_the_cpu(dev):
    """The decoder's loss (``unetr_loss``: published widths on (1, 16, 16,
    256) features, 256^2 distance targets) and its gradients on the card
    against the same step on the CPU in float64, TF32 off. In float64 on the
    card every gradient within rel 1e-6 of its tensor's max. In float32 the
    loss within rel 1e-5, and every gradient within rel 1e-3 of its max or
    within twice the CPU f32 step's largest distance from float64 over all
    gradients: the random decoder's gradients are ill-conditioned, and f32
    rounding alone moves some small ones by more than 1e-3 of their max.
    Gradients zero in the exact arithmetic (biases whose output meets an
    InstanceNorm) stay below 1e-6 of the largest."""
    from micro_sam_tpu_torch.models.unetr import UNETRDecoder
    from micro_sam_tpu_torch.sample_data import synthetic_data
    from micro_sam_tpu_torch.training import PerObjectDistanceTransform
    from micro_sam_tpu_torch.training.joint_sam_trainer import unetr_loss
    feats = torch.randn(1, 16, 16, 256, generator=torch.Generator().manual_seed(5))
    seg = synthetic_data((256, 256), seed=3, n_objects=12, radius_range=(8, 20))[1]
    targets = torch.from_numpy(PerObjectDistanceTransform()(seg)[None])
    runs = {}
    for d, dt in (("cpu", torch.float64), ("cpu", torch.float32), (dev, torch.float64),
                  (dev, torch.float32)):
        model = UNETRDecoder().init_(torch.Generator().manual_seed(0)).to(d, dt)
        with torch.enable_grad():
            loss = unetr_loss(model, feats.to(d, dt), targets.to(d, dt))
            loss.backward()
        runs[(str(d), dt)] = (float(loss.detach()), {n: p.grad.double().cpu()
                                                     for n, p in model.named_parameters()})
    ref_loss, ref = runs[("cpu", torch.float64)]
    cpu32 = runs[("cpu", torch.float32)][1]
    g_max = max(float(g.abs().max()) for g in ref.values())
    held = [n for n, r in ref.items() if float(r.abs().max()) > 1e-6 * g_max]
    floor = 2 * max(float((cpu32[n] - ref[n]).abs().max()) for n in held)
    for dt, loss_tol in ((torch.float64, 1e-9), (torch.float32, 1e-5)):
        loss, got = runs[(str(dev), dt)]
        assert abs(loss - ref_loss) <= loss_tol * abs(ref_loss)
        for name, r in ref.items():
            err = float((got[name] - r).abs().max())
            if name not in held:
                assert float(got[name].abs().max()) <= 1e-6 * g_max, name
            elif dt == torch.float64:
                assert err <= 1e-6 * float(r.abs().max()), name
            else:
                assert err <= max(1e-3 * float(r.abs().max()), floor), name


def test_joint_step_bf16_on_the_card(dev, monkeypatch):
    """One JointSamTrainer step on the card (vit_b width, 2 blocks, 256 px,
    bf16 compute over f32 weights; the decoder at published widths): finite
    losses, the SAM and decoder weights moved, the attention through K1 (2
    forward with the recompute and 1 in the decoder step's encode a block)
    and K4 (4 a block)."""
    import dataclasses
    from micro_sam_tpu_torch.instance_segmentation import get_unetr
    from micro_sam_tpu_torch.models import build_sam
    from micro_sam_tpu_torch.ops.relpos_attention import (relpos_attention,
                                                          relpos_attention_backward)
    from micro_sam_tpu_torch.sample_data import synthetic_data
    from micro_sam_tpu_torch.training import (JointSamTrainer, PerObjectDistanceTransform,
                                              get_trainable_sam_model)
    import numpy as np
    monkeypatch.setitem(build_sam.SAM_CONFIGS, "vit_b", dataclasses.replace(
        build_sam.SAM_CONFIGS["vit_b"], depth=2, global_attn_indexes=(1,), img_size=256))
    model = get_trainable_sam_model("vit_b")
    assert model.device.type == "cuda" and model.config.dtype == torch.bfloat16
    trainer = JointSamTrainer("t", None, None, model, unetr=get_unetr(), n_sub_iteration=2,
                              n_objects_per_batch=4, logger=False)
    data = [synthetic_data((128, 128), seed=s, n_objects=10, radius_range=(6, 12)) for s in (1, 2)]
    x = np.stack([d[0] for d in data]).astype(np.float32)
    y = np.stack([d[1] for d in data])
    t = np.stack([PerObjectDistanceTransform()(s) for s in y])
    sam0 = model.sam.mask_decoder.iou_token.weight.detach().clone()
    dec0 = trainer.unetr.out_conv.weight.detach().clone()
    f0, b0 = relpos_attention.launches, relpos_attention_backward.launches
    batch = trainer._prepare_batch(x, y, True, False)
    with torch.enable_grad():
        loss, _ = trainer.train_step(batch, True, False, True)
    inst = trainer.instance_step(batch[0], t)
    torch.cuda.synchronize()
    assert np.isfinite(float(loss)) and np.isfinite(float(inst))
    assert (relpos_attention.launches - f0, relpos_attention_backward.launches - b0) == (6, 8)
    assert not torch.equal(sam0, model.sam.mask_decoder.iou_token.weight)
    assert not torch.equal(dec0, trainer.unetr.out_conv.weight)


# ---------------------------------------------------------------------------
# PEFT blocks (the K1 route) and the vit_t chains in autograd
# ---------------------------------------------------------------------------

def _peft_vit(dev, case, dtype):
    """A 2-block ViT at vit_b width (block 0 windowed, block 1 global, 256
    px) with the surgery ``case``, its fresh PEFT parameters redrawn so that
    they change the output; product weights held in ``dtype``."""
    import dataclasses
    from micro_sam_tpu_torch.models.build_sam import get_config
    from micro_sam_tpu_torch.models.peft_sam import apply_peft
    from micro_sam_tpu_torch.models.sam import Sam
    kw = {"lora": dict(rank=4, update_matrices=("q", "k", "v", "mlp")),
          "int4_lora": dict(rank=4, quantize=True), "fact": dict(rank=4, peft_module="fact"),
          "ssf": dict(peft_module="ssf"), "adaptformer": dict(peft_module="adaptformer")}[case]
    cfg = dataclasses.replace(get_config("vit_b", "bfloat16"), depth=2, global_attn_indexes=(1,),
                              img_size=256)
    g = torch.Generator().manual_seed(21)
    sam = Sam(cfg, torch.float32).init_(g)
    apply_peft(sam, **kw)
    with torch.no_grad():
        for name, p in sam.image_encoder.named_parameters():
            if any(m in name for m in (".lora.", "fact", "ssf_", ".adapter.")):
                p.add_(torch.randn(p.shape, generator=g) * 0.05)
    for blk in sam.image_encoder.blocks:
        blk.hold_weights_in_(dtype)
    return sam.to(dev).eval()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["lora", "int4_lora", "fact", "ssf", "adaptformer"])
def test_peft_block_route_matches_plain(dev, dtype, case):
    """A PEFT block's attention half (``fused_window_attn`` /
    ``fused_global_attn``: K1 on its qkv rows with the LoRA / FacT updates,
    the products through gemm) and MLP half against the same halves through
    the plain versions (f32, on the same inputs): a masked window batch and a
    global grid; one K1 launch an attention half."""
    from micro_sam_tpu_torch.ops import fused_window_block as fwb
    from micro_sam_tpu_torch.ops.relpos_attention import relpos_attention
    enc = _peft_vit(dev, case, dtype)
    fact = enc.image_encoder.fact
    g = torch.Generator().manual_seed(22)
    win = torch.randn(8, 196, 768, generator=g).to(dev, dtype)
    valid = (torch.rand(8, 196, 1, generator=g) > 0.2).float().to(dev)
    glob = torch.randn(1, 256, 768, generator=g).to(dev, dtype)
    for blk, x, v, hw in ((enc.image_encoder.blocks[0], win, valid, (14, 14)),
                          (enc.image_encoder.blocks[1], glob, None, (16, 16))):
        with torch.no_grad():
            n0 = relpos_attention.launches
            if v is None:
                got = fwb.mlp_half(fwb.fused_global_attn(x, blk, hw, 12, fact), blk)
            else:
                got = fwb.mlp_half(fwb.fused_window_attn(x, v, blk, hw, 12, fact), blk)
            torch.cuda.synchronize()
            assert relpos_attention.launches - n0 == 1
            xf = x.float()
            if v is None:
                ref = fwb.mlp_half_plain(fwb.fused_global_attn_plain(xf, blk, hw, 12, fact), blk)
            else:
                ref = fwb.mlp_half_plain(fwb.fused_window_attn_plain(xf, v, blk, hw, 12, fact),
                                         blk)
        _held(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("chain", ["K6", "K7", "K8"])
def test_tiny_chain_functions_on_the_card(dev, dtype, chain):
    """Each chain's autograd function with float32 master weights: its
    forward (the kernel chain) against the plain chain in f32 on the same
    inputs; its backward (the plain chain recomputed in ``dtype``) equal to
    autograd through the plain chain in ``dtype`` (rel 1e-3 of each max:
    the same computation), gradients reaching the f32 weights."""
    from micro_sam_tpu_torch.ops import fused_mbconv as k7, fused_tiny_attention as k6
    from micro_sam_tpu_torch.ops import fused_tiny_tail as k8
    enc = _tiny_vit(torch.float32, dev)
    g = torch.Generator().manual_seed(23)
    blk = enc.layers[1].blocks[0]
    if chain == "K7":
        x, mods = torch.randn(2, 32, 40, 64, generator=g), (enc.layers[0].blocks[0],)
        fn, plain = k7.fused_mbconv, k7.fused_mbconv_plain
    elif chain == "K6":
        x, mods = torch.randn(2, 21, 28, 128, generator=g), (blk.attn,)
        fn, plain = k6.fused_tiny_attention, k6.fused_tiny_attention_plain
    else:
        x, mods = torch.randn(2, 20, 24, 128, generator=g), (blk.local_conv, blk.mlp)
        fn, plain = k8.fused_tiny_tail, k8.fused_tiny_tail_plain
    params = [p for m in mods for p in m.parameters()]
    x = x.to(dev, dtype)
    xs = [x.clone().requires_grad_() for _ in range(2)]
    out = fn(xs[0], *mods)
    assert type(out.grad_fn).__name__.startswith("Fused")
    with torch.no_grad():
        ref = plain(x.float(), *mods)
    _held(out.detach(), ref, dtype)
    go = torch.randn(out.shape, generator=g).to(dev, dtype)
    ga = torch.autograd.grad(out, [xs[0]] + params, go)
    gb = torch.autograd.grad(plain(xs[1], *mods), [xs[1]] + params, go)
    torch.cuda.synchronize()
    for p, a, b in zip([xs[0]] + params, ga, gb):
        assert a.dtype == p.dtype and torch.isfinite(a).all()
        err = float((a.float() - b.float()).abs().max()) / (float(b.float().abs().max()) + 1e-30)
        assert err <= 1e-3, err


def test_sa50_gate_on_the_card(dev, tmp_path):
    """The SA50 quality gate of finetuning (tests/test_torch_training_quality.py)
    on the card: the small SAM trained 60 epochs with the port's SamTrainer
    (f32 weights and compute, the attention through K1 / K4 at head dim 48,
    staged), exported, reloaded by get_sam_model on the card (bf16) and
    scored by the iterative-prompting evaluation: SA50 > 0.7 at iteration00."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(__file__))  # the gate's module, beside this file
    from test_torch_training_quality import SA50_BAR, sa50_gate
    sa50, msa, seconds = sa50_gate(dev, tmp_path)
    print(f"SA50 per iteration on the card: {[round(s, 4) for s in sa50]}; mSA "
          f"{[round(m, 4) for m in msa]}; training {seconds:.1f} s")
    assert sa50[0] > SA50_BAR, sa50


def test_gate_training_repeats_on_the_card(dev, tmp_path):
    """Two one-epoch trainings of the SA50 gate's SAM on the card (24 steps,
    f32) give bitwise-equal weights: the resizes and the transposed
    convolutions of the SAM step are products and its convolutions
    ``conv2d_product`` / ``conv2d_nchw`` (``models/common.py``), whose
    backward repeats, where cuDNN's data gradient of the neck's 3 x 3
    convolution and ``F.interpolate``'s backward did not."""
    import os
    import sys
    import time
    sys.path.insert(0, os.path.dirname(__file__))  # the gate's module, beside this file
    from test_torch_training_quality import train_gate
    states, seconds = [], []
    for k in range(2):
        t0 = time.perf_counter()
        trainer, _ = train_gate(dev, tmp_path / str(k), epochs=1)
        seconds.append(time.perf_counter() - t0)
        states.append({n: v.detach().clone() for n, v in trainer.model.sam.state_dict().items()})
    differ = [n for n, v in states[0].items() if not torch.equal(v, states[1][n])]
    print(f"the gate's one-epoch training, twice: {[round(t, 2) for t in seconds]} s; "
          f"{len(differ)} of {len(states[0])} tensors differ")
    assert not differ, differ[:8]


def test_iterative_prompting_on_the_card_matches_the_cpu(dev):
    """The evaluation's iterative loop of the trained fixture SAM (f32) on the
    card against the same on the CPU, the card fed the CPU's corrective
    prompts: every object's mask at IoU >= 0.99 in every iteration."""
    import os
    import numpy as np
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.evaluation.inference import iterative_prompting_segmentations
    from micro_sam_tpu_torch.models.convert import params_from_flat_npz
    from micro_sam_tpu_torch.models.sam import Sam
    from micro_sam_tpu_torch.predictor import SamPredictor
    from micro_sam_tpu_torch.prompt_generators import IterativePromptGenerator
    from micro_sam_tpu_torch.sample_data import synthetic_data
    cfg, sd = params_from_flat_npz(os.path.join(os.path.dirname(__file__), "fixtures",
                                                "bench_sam_tiny1024.npz"))
    image, gt = synthetic_data(shape=(1024, 1024), seed=200, n_objects=20, radius_range=(30, 110))
    gt = gt.astype(np.uint32)
    calls, segs = [], {}
    for device in ("cpu", "cuda"):
        sam = Sam(cfg)
        sam.load_state_dict(sd)
        predictor = SamPredictor(sam.to(device).eval())
        util.set_precomputed(predictor, util.precompute_image_embeddings(predictor, image,
                                                                         verbose=False))
        if device == "cpu":
            gen = IterativePromptGenerator(np.random.RandomState(0))

            def prompts(*a, **k):
                calls.append(gen(*a, **k))
                return calls[-1]
        else:
            replay = list(calls)

            def prompts(*a, **k):
                return replay.pop(0)
        segs[device] = iterative_prompting_segmentations(predictor, gt, True, n_iterations=4,
                                                         use_masks=True, prompt_generator=prompts)
    for got, ref in zip(segs["cuda"], segs["cpu"]):
        for i in np.unique(gt)[1:]:
            a, b = got == i, ref == i
            assert (a & b).sum() / max((a | b).sum(), 1) >= 0.99 or not (a | b).any()


# ---------------------------------------------------------------------------
# the annotators and model export
# ---------------------------------------------------------------------------

def _fixture_predictor(device):
    import os
    from micro_sam_tpu_torch.models.convert import params_from_flat_npz
    from micro_sam_tpu_torch.models.sam import Sam
    from micro_sam_tpu_torch.predictor import SamPredictor
    cfg, sd = params_from_flat_npz(os.path.join(os.path.dirname(__file__), "fixtures",
                                                "bench_sam_tiny1024.npz"))
    sam = Sam(cfg)
    sam.load_state_dict(sd)
    predictor = SamPredictor(sam.to(device).eval())
    predictor.model_type = predictor.model_name = "vit_b"
    return predictor


def test_annotator_clicks_on_the_card_match_the_cpu(dev):
    """The 2d annotator on a FakeViewer with the trained fixture SAM (f32):
    the same clicks through the segment key give every object's mask at IoU
    >= 0.99 of the CPU's, and the committed labels are equal."""
    import numpy as np
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch._test_util import FakeViewer, check_layer_initialization
    from micro_sam_tpu_torch.sam_annotator._state import AnnotatorState
    from micro_sam_tpu_torch.sam_annotator.annotator_2d import annotator_2d
    from micro_sam_tpu_torch.sample_data import synthetic_data
    image, gt = synthetic_data(shape=(512, 512), seed=201, n_objects=8, radius_range=(15, 55))
    centers = [np.argwhere(gt == i).mean(0) for i in np.unique(gt)[1:]]
    runs = {}
    for device in ("cpu", "cuda"):
        state = AnnotatorState()
        state.reset_state()
        predictor = _fixture_predictor(device)
        emb = util.precompute_image_embeddings(predictor, image, verbose=False)
        viewer = annotator_2d(image, embedding_path=emb, viewer=FakeViewer(), return_viewer=True,
                              predictor=predictor)
        check_layer_initialization(viewer, image.shape)
        masks = []
        for y, x in centers:
            pts = viewer.layers["point_prompts"]
            pts.data = np.array([[y, x]])
            pts.properties = {"label": np.array(["positive"], dtype=object)}
            viewer.press("s")
            masks.append(viewer.layers["current_object"].data.copy())
            viewer.press("c")
        runs[device] = (masks, viewer.layers["committed_objects"].data.copy())
        state.reset_state()
    for got, ref in zip(runs["cuda"][0], runs["cpu"][0]):
        union = np.logical_or(got, ref).sum()
        assert union > 0 and np.logical_and(got, ref).sum() / union >= 0.99
    assert np.array_equal(runs["cuda"][1], runs["cpu"][1])


def test_torchscript_encoder_on_the_card(dev, tmp_path, monkeypatch):
    """The exported TorchScript encoder (vit_b, random weights, f32) loaded
    onto the card runs no port kernel, and its embedding is within rel 1e-3
    of the kernel path's f32 embedding of the same image."""
    import numpy as np
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.bioimageio.bioengine_export import export_image_encoder
    from micro_sam_tpu_torch.models.sam import preprocess
    from micro_sam_tpu_torch.ops.gemm import gemm
    from micro_sam_tpu_torch.ops.layernorm import layernorm
    from micro_sam_tpu_torch.ops.relpos_attention import relpos_attention
    predictor = util.get_sam_model("vit_b", compute_dtype="float32", seed=0)
    monkeypatch.setattr(util, "get_sam_model", lambda *a, **k: predictor)
    path = export_image_encoder("vit_b", str(tmp_path))
    traced = torch.jit.load(path, map_location="cuda")
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 3, 1024, 768).astype(np.float32) * 255)
    counts = [k.launches for k in (gemm, layernorm, relpos_attention)]
    with torch.no_grad():
        got = traced(x.cuda())
        torch.cuda.synchronize()
        assert [k.launches for k in (gemm, layernorm, relpos_attention)] == counts
        ref = predictor.model.encode_image(preprocess(x.cuda().permute(0, 2, 3, 1), 1024))
    assert [k.launches for k in (gemm, layernorm, relpos_attention)] != counts
    ref = ref.permute(0, 3, 1, 2).float()
    assert got.shape == (1, 256, 64, 64) and got.is_cuda
    err = float((got - ref).abs().max()) / float(ref.abs().max())
    assert err <= 1e-3, err


# ---------------------------------------------------------------------------
# multi-GPU execution (parallel/): two gloo ranks on the one card, and an NCCL
# world of one
# ---------------------------------------------------------------------------

def test_split_block_chains_match_plain(dev, tmp_path):
    """A vit_b block split over model = 2 (gloo, both ranks on the card): the
    attention and MLP halves launch their kernels at the split widths (qkv
    N 1152, proj K 384, lin1 N 1536, lin2 K 1536, 6 heads of 64), 2 layernorm,
    4 gemm and 1 relpos_attention a rank, and the block equals the unsplit
    plain chain in f32 on the same inputs (f32 1e-4, bf16 2e-2 of max)."""
    import torch_parallel_worlds as w
    w.wait(w.start("run_split_chains", 2, str(tmp_path)))
    got = torch.load(tmp_path / "split.pt", weights_only=False)
    assert len(got) == 4
    for (kind, dtype), r in got.items():
        assert r["launches"] == [2, 4, 1], (kind, dtype)
        _held(r["out"], r["ref"], torch.float32 if dtype == str(torch.float32)
              else torch.bfloat16)


def test_nccl_world_of_one_equals_unmeshed(dev):
    """get_sam_model(mesh=make_mesh()) in an NCCL world of one: the encode
    (its batch all-gathered through NCCL) and a predict bitwise equal to the
    unmeshed predictor's."""
    import socket
    import numpy as np
    import torch.distributed as dist
    from micro_sam_tpu_torch.parallel.mesh import make_mesh
    from micro_sam_tpu_torch.util import get_sam_model
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = make_mesh()
        assert mesh.backend == "nccl" and mesh.shape == {"data": 1, "model": 1}
        img = np.random.RandomState(0).randint(0, 255, (1024, 1024, 3)).astype(np.uint8)
        outs = []
        for m in (mesh, None):
            pred = get_sam_model("vit_b", mesh=m)
            pred.set_image(img)
            outs.append((pred.features.float().cpu().numpy(),) + tuple(pred.predict(
                point_coords=np.array([[300.0, 420.0]]), point_labels=np.array([1]),
                return_logits=True)))
        for a, b in zip(*outs):
            assert np.array_equal(a, b)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# tracing: the port's spans under the benchmark's profiler session
# ---------------------------------------------------------------------------

def test_a_cuda_only_profiler_session_records_the_spans(dev):
    """The benchmark traces its window with CUDA activities alone: the port's
    spans are on in such a session, and they add no device event of their
    own to the card's busy time."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from micro_sam_tpu_torch import tracing
    from micro_sam_tpu_torch.models.sam import Sam, SamConfig
    from micro_sam_tpu_torch.predictor import SamPredictor
    cfg = SamConfig(embed_dim=64, depth=2, num_heads=2, global_attn_indexes=(1,), img_size=128)
    predictor = SamPredictor(Sam(cfg).init_(torch.Generator().manual_seed(5)).eval().to(dev))
    batch = np.zeros((2, 128, 128, 3), np.uint8)
    predictor.encode_batch(batch)
    torch.cuda.synchronize()
    last = max((s.id for s in tracing.spans()), default=0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        predictor.encode_batch(batch)
        torch.cuda.synchronize()
    names = sorted(s.name for s in tracing.spans() if s.id > last)
    assert names == ["encode_batch", "encode_batch.cast", "encode_batch.copy_in",
                     "encode_batch.launch"]
    device = {e.name() for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA}
    assert device and not device & set(names), sorted(device)
