"""The rel-pos attention forward's variant choice and its head dims above
128, on the CPU.

``forward_plan`` is the pure function of (N, H, W, head dim) that picks the
bf16 kernel's variant (``csrc/relpos_attention.cu`` checks the same rule).
The kernel itself runs only on the card (tests/test_torch_cuda.py, which
holds each variant's tiling against the plain version); here the choice is
pinned, with the window variant's shared memory, and the forward's plain version
at head dims 160 and 256 is held against the JAX package's einsum
composition (f32, abs <= 5e-5, as tests/test_torch_kernels.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import abs_err

TOL = 5e-5


@pytest.mark.parametrize("grid,want", [
    # every SAM ViT's 14 x 14 windows, at every built head dim up to 128
    ((196, 14, 14, 32), "window"),
    ((196, 14, 14, 64), "window"),
    ((196, 14, 14, 80), "window"),
    ((196, 14, 14, 96), "window"),
    ((196, 14, 14, 128), "window"),
    # the global grid: key tiles of one map row
    ((4096, 64, 64, 64), "rows"),
    ((4096, 64, 64, 80), "rows"),
    # W dividing 64 and not, past the window's 256 slots
    ((960, 24, 40, 64), "rows"),
    ((512, 16, 32, 64), "rows"),
    # W > 64: 64-slot row segments, also where the padded row alone fits 256
    ((768, 8, 96, 64), "general"),
    ((200, 1, 200, 64), "general"),
    # a tiny grid
    ((6, 2, 3, 64), "window"),
    # windows that fit 256 slots but not the shared memory of one block
    ((256, 16, 16, 96), "window"),
    ((256, 16, 16, 128), "rows"),
    ((225, 15, 15, 128), "rows"),
    ((256, 4, 64, 96), "rows"),
    # above head dim 128: never the window variant
    ((196, 14, 14, 256), "rows"),
    ((4096, 64, 64, 256), "rows"),
], ids=["window_hd32", "window", "window_hd80", "window_hd96", "window_hd128", "global",
        "global_hd80", "w40", "w32", "w96", "w200", "tiny", "w16_hd96", "w16_hd128",
        "w15_hd128", "w4x64_hd96", "window_hd256", "global_hd256"])
def test_forward_plan(grid, want):
    """(N, H, W, kernel head dim) -> the bf16 forward's variant and its
    kernel code."""
    from micro_sam_tpu_torch.ops.relpos_attention import VARIANT_CODES, forward_plan
    plan = forward_plan(*grid)
    assert plan.variant == want
    assert plan.code == VARIANT_CODES[want]


@pytest.mark.parametrize("grid,smem,fits", [
    ((196, 14, 14, 64), 124864, True), ((196, 14, 14, 128), 212928, True),
    ((256, 16, 16, 128), 251392, False), ((256, 4, 64, 96), 237056, False),
], ids=["window", "window_hd128", "w16_hd128", "w4x64_hd96"])
def test_window_shared_memory(grid, smem, fits):
    """The window variant's shared memory (``bf16_smem`` of the kernel: k, v
    and q rows of pitch hd + 8, f32 u rows of odd pitch) against the limit of
    one block, 232448 bytes."""
    from micro_sam_tpu_torch.ops.relpos_attention import SMEM_LIMIT, _window_smem
    assert _window_smem(*grid) == smem
    assert (smem <= SMEM_LIMIT) == fits


@pytest.mark.parametrize("hd", [160, 256])
def test_forward_above_hd128_matches_jax_einsum(hd):
    """Head dims above 128: the port's forward (its plain version on a CPU
    tensor, the kernel on the card) against JAX's einsum composition, which
    takes every head dim."""
    from micro_sam_tpu.ops.attention import _einsum_attention_rel_pos as jax_einsum
    from micro_sam_tpu_torch.ops.relpos_attention import relpos_attention

    B, nH, H, W = 2, 2, 4, 5
    rng = np.random.RandomState(hd)
    qkv = rng.randn(B, 3, nH, H * W, hd).astype(np.float32) * 0.5
    rh = (rng.randn(H, H, hd) * 0.1).astype(np.float32)
    rw = (rng.randn(W, W, hd) * 0.1).astype(np.float32)
    q, k, v = (np.ascontiguousarray(qkv[:, i].transpose(0, 2, 1, 3)) for i in range(3))
    ref = np.asarray(jax_einsum(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), (H, W),
                                jnp.asarray(rh), jnp.asarray(rw)))
    t = torch.from_numpy
    got = relpos_attention(t(qkv)[:, 0], t(qkv)[:, 1], t(qkv)[:, 2], t(rh), t(rw), (H, W))
    assert got.shape == (B, nH, H * W, hd)
    assert abs_err(got.transpose(1, 2).numpy(), ref) < TOL


# ---------------------------------------------------------------------------
# key rectangles: grids whose u tables do not fit one block
# ---------------------------------------------------------------------------

BUILT = (32, 64, 80, 96, 128, 256)


def _covers_once(rects, H, W):
    seen = np.zeros((H, W), np.int64)
    for r in rects:
        assert r.kh > 0 and r.kw > 0 and r.ky0 + r.kh <= H and r.kx0 + r.kw <= W
        seen[r.ky0:r.ky0 + r.kh, r.kx0:r.kx0 + r.kw] += 1
    return bool((seen == 1).all())


@pytest.mark.parametrize("H,W", [(336, 336), (32, 640), (1024, 64), (64, 1024), (200, 300)])
@pytest.mark.parametrize("hd", [64, 80, 128])
def test_large_grids_are_planned(H, W, hd):
    """Grids the kernels used to refuse (their one-block u tables too large):
    every plan is a set of key rectangles that cover each key once, each
    launched in the variant its columns take, each within shared memory by
    the kernels' own reckonings (bf16 forward, each backward stage, f32)."""
    from micro_sam_tpu_torch.ops import relpos_attention as rpa
    N = H * W
    fwd, bwd = rpa.forward_plan(N, H, W, hd), rpa.backward_plan(N, H, W, hd)
    assert len(bwd.rects) > 1 and (len(fwd.rects) > 1 or (H, W) == (200, 300))
    for r, code in fwd.rects:
        assert code == rpa.VARIANT_CODES["rows" if r.kw <= 64 else "general"]
        assert rpa._tiled_smem(H, W, hd, r.kh, r.kw) <= rpa.SMEM_LIMIT
    for r, codes in bwd.rects:
        var = rpa.VARIANT_CODES["rows" if r.kw <= 64 else "general"]
        assert codes == (0, var, var, 0)
        assert all(rpa._bwd_tiled_smem(s, H, W, hd, r.kh, r.kw) <= rpa.SMEM_LIMIT
                   for s in (0, 1, 2))
    for rects in ([r for r, _ in fwd.rects], [r for r, _ in bwd.rects],
                  rpa.f32_forward_rects(H, W, hd), rpa.f32_backward_rects(H, W, hd)):
        assert _covers_once(rects, H, W)
    assert all(rpa._f32_smem(hd, r.kh, r.kw) <= rpa.SMEM_LIMIT
               for r in rpa.f32_forward_rects(H, W, hd))
    assert all(rpa._bwd_f32_smem(s, hd, r.kh, r.kw) <= rpa.SMEM_LIMIT
               for r in rpa.f32_backward_rects(H, W, hd) for s in (1, 2))


SWEEP_SIDES = (1, 2, 7, 14, 15, 16, 63, 64, 65, 96, 128, 200, 333, 336, 512, 640, 1000, 1024)


@pytest.mark.parametrize("hd", BUILT)
def test_every_grid_up_to_1024_fits(hd):
    """For every pair of sides in SWEEP_SIDES (up to 1024 x 1024) at each
    built head dim, every key rectangle of every plan fits shared memory by
    the kernels' reckonings, and the rectangles cover each key once."""
    from micro_sam_tpu_torch.ops import relpos_attention as rpa
    for H in SWEEP_SIDES:
        for W in SWEEP_SIDES:
            N = H * W
            fwd, bwd = rpa.forward_plan(N, H, W, hd), rpa.backward_plan(N, H, W, hd)
            if fwd.variant != "window":
                assert all(rpa._tiled_smem(H, W, hd, r.kh, r.kw) <= rpa.SMEM_LIMIT
                           for r, _ in fwd.rects)
            for r, codes in bwd.rects:
                for stage in (0, 1, 2):
                    if codes[stage] != rpa.VARIANT_CODES["window"]:
                        assert rpa._bwd_tiled_smem(stage, H, W, hd, r.kh, r.kw) <= rpa.SMEM_LIMIT
            assert all(rpa._f32_smem(hd, r.kh, r.kw) <= rpa.SMEM_LIMIT
                       for r in rpa.f32_forward_rects(H, W, hd))
            assert all(rpa._bwd_f32_smem(s, hd, r.kh, r.kw) <= rpa.SMEM_LIMIT
                       for r in rpa.f32_backward_rects(H, W, hd) for s in (1, 2))
            for rects in ([r for r, _ in fwd.rects], [r for r, _ in bwd.rects]):
                assert _covers_once(rects, H, W), (H, W)


@pytest.mark.parametrize("hd", BUILT)
def test_sam_grids_keep_one_launch(hd):
    """The 64 x 64 global grid and the 14 x 14 windows of every SAM ViT keep
    one key rectangle, the whole map, in every direction and dtype."""
    from micro_sam_tpu_torch.ops import relpos_attention as rpa
    for H in (64, 14):
        whole = rpa.KeyRect(0, 0, H, H)
        fwd, bwd = rpa.forward_plan(H * H, H, H, hd), rpa.backward_plan(H * H, H, H, hd)
        assert fwd.rects == ((whole, fwd.code),) and bwd.rects == ((whole, bwd.codes),)
        assert rpa.f32_forward_rects(H, H, hd) == rpa.f32_backward_rects(H, H, hd) == (whole,)


def test_key_rects_fewest_and_covering():
    from micro_sam_tpu_torch.ops.relpos_attention import KeyRect, key_rects
    assert key_rects(10, 12, lambda kh, kw: True) == (KeyRect(0, 0, 10, 12),)
    rects = key_rects(10, 12, lambda kh, kw: kh + kw <= 17)
    assert len(rects) == 2 and _covers_once(rects, 10, 12)
    rects = key_rects(9, 9, lambda kh, kw: kh <= 4 and kw <= 5)
    assert len(rects) == 6 and _covers_once(rects, 9, 9)


def _f64_rect_forward(q, k, v, rh, rw, out, dims, hdp, scale, geo, strides, lse=None, rect=None,
                      code=None, lse_prev=None):
    """A float64 stand-in for one launch of the forward kernel over a key
    rectangle, as the kernel does it: the rectangle's softmax and its
    log-sum-exp, merged into ``out`` by ``lse_prev`` where given."""
    B, nH, N, H, W = dims
    ky0, kx0, kh, kw = rect
    keys = torch.tensor([(ky0 + y) * W + kx0 + x for y in range(kh) for x in range(kw)])
    qd, kd, vd = (t.double() for t in (q, k, v))
    r_q = qd.reshape(B, nH, H, W, hdp)
    logits = (scale * qd @ kd[:, :, keys].transpose(-1, -2)).view(B, nH, H, W, kh, kw)
    logits = logits + (torch.einsum("bnijc,ikc->bnijk", r_q, rh.double()[:, ky0:ky0 + kh])[..., None]
                       + torch.einsum("bnijc,jkc->bnijk", r_q, rw.double()[:, kx0:kx0 + kw])[..., None, :])
    logits = logits.reshape(B, nH, N, kh * kw)
    L = torch.logsumexp(logits, -1)
    o = torch.softmax(logits, -1) @ vd[:, :, keys]
    if lse_prev is not None:
        p = lse_prev.double()
        joint = torch.logaddexp(L, p)
        o = o * torch.exp(L - joint)[..., None] + out.double() * torch.exp(p - joint)[..., None]
        L = joint
    out.copy_(o)
    if lse is not None:
        lse.copy_(L)


@pytest.mark.parametrize("with_lse", [False, True])
def test_forward_rectangles_merge_to_the_whole(monkeypatch, with_lse):
    """The wrapper's launches over four key rectangles of a 5 x 7 map (a
    float64 stand-in for the kernel): each merges into the output by the
    log-sum-exps of those before, which alternate between two buffers so
    that the last lands in the caller's lse; the result is the plain
    forward over all keys."""
    from micro_sam_tpu_torch.ops import relpos_attention as rpa
    B, nH, H, W, hd = 2, 2, 5, 7, 32
    N = H * W
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(B, nH, N, hd, generator=g, dtype=torch.float64) for _ in range(3))
    rh = torch.randn(H, H, hd, generator=g, dtype=torch.float64) * 0.3
    rw = torch.randn(W, W, hd, generator=g, dtype=torch.float64) * 0.3
    rects = tuple((rpa.KeyRect(*r), 0) for r in ((0, 0, 3, 4), (0, 4, 3, 3), (3, 0, 2, 4),
                                                 (3, 4, 2, 3)))
    monkeypatch.setattr(rpa, "f32_forward_rects", lambda *a: tuple(r for r, _ in rects))
    monkeypatch.setattr(rpa, "_forward_kernel", _f64_rect_forward)
    out = torch.full(q.shape, float("nan"), dtype=torch.float64)
    lse = torch.full((B, nH, N), float("nan"), dtype=torch.float64) if with_lse else None
    n = rpa._forward_launches(q, k, v, rh, rw, out, (B, nH, N, H, W), hd, hd ** -0.5, (0, 0, 0),
                              None, lse)
    assert n == 4
    ref_lse = torch.empty(B, nH, N, dtype=torch.float64)
    ref = rpa.relpos_attention_plain(q, k, v, rh, rw, (H, W), lse=ref_lse)
    # the plain version computes in f32
    assert torch.allclose(out, ref.double(), atol=1e-5, rtol=0)
    if with_lse:
        assert torch.allclose(lse, ref_lse, atol=1e-5, rtol=0)


def test_backward_rectangles_add_to_the_whole(monkeypatch):
    """The wrapper's backward over three key rectangles of a 4 x 6 map (a
    float64 stand-in for the four stages): each rectangle's dk / dv written,
    its dq added from the second on, its table gradients added into zeroed
    ones; the result is the plain backward's."""
    from micro_sam_tpu_torch.ops import relpos_attention as rpa
    B, nH, H, W, hd = 2, 2, 4, 6, 32
    N = H * W
    g = torch.Generator().manual_seed(4)
    q, k, v, dout = (torch.randn(B, nH, N, hd, generator=g, dtype=torch.float64)
                     for _ in range(4))
    rh = torch.randn(H, H, hd, generator=g, dtype=torch.float64) * 0.3
    rw = torch.randn(W, W, hd, generator=g, dtype=torch.float64) * 0.3
    lse = torch.empty(B, nH, N, dtype=torch.float64)
    out = rpa.relpos_attention_plain(q, k, v, rh, rw, (H, W), lse=lse).double()
    rects = (rpa.KeyRect(0, 0, 4, 3), rpa.KeyRect(0, 3, 2, 3), rpa.KeyRect(2, 3, 2, 3))
    monkeypatch.setattr(rpa, "f32_backward_rects", lambda *a: rects)
    seen = []

    def stand_in(stage, code, ins, lse_, rhs, rws, outs, drh, drw, scratch, dims, hdp, scale,
                 rect=None, acc=0):
        seen.append((stage, rect, acc))
        if stage:
            return
        ky0, kx0, kh, kw = rect
        keys = torch.tensor([(ky0 + y) * W + kx0 + x for y in range(kh) for x in range(kw)])
        qd, kd, vd, od, gd = (t.double() for t in ins)
        r_q = qd.reshape(B, nH, H, W, hdp)
        logits = (scale * qd @ kd[:, :, keys].transpose(-1, -2)).view(B, nH, H, W, kh, kw)
        ph = torch.einsum("bnijc,ikc->bnijk", r_q, rhs.double()[:, ky0:ky0 + kh])
        pw = torch.einsum("bnijc,jkc->bnijk", r_q, rws.double()[:, kx0:kx0 + kw])
        p = torch.exp((logits + ph[..., None] + pw[..., None, :]).reshape(B, nH, N, kh * kw)
                      - lse_.double()[..., None])
        ds = p * (gd @ vd[:, :, keys].transpose(-1, -2) - (gd * od).sum(-1, keepdim=True))
        outs[1][:, :, keys] = scale * ds.transpose(-1, -2) @ qd
        outs[2][:, :, keys] = p.transpose(-1, -2) @ gd
        ds6 = ds.view(B, nH, H, W, kh, kw)
        dsr, dsc = ds6.sum(-1), ds6.sum(-2)
        dq = (scale * ds @ kd[:, :, keys]
              + torch.einsum("bnijk,ikc->bnijc", dsr, rhs.double()[:, ky0:ky0 + kh]).reshape(qd.shape)
              + torch.einsum("bnijk,jkc->bnijc", dsc, rws.double()[:, kx0:kx0 + kw]).reshape(qd.shape))
        outs[0].copy_(outs[0] + dq if acc & 1 else dq)
        assert acc & 2
        drh[:, ky0:ky0 + kh] += torch.einsum("bnijk,bnijc->ikc", dsr, r_q)
        drw[:, kx0:kx0 + kw] += torch.einsum("bnijk,bnijc->jkc", dsc, r_q)
    monkeypatch.setattr(rpa, "_backward_kernel", stand_in)
    monkeypatch.setattr(rpa.relpos_attention_backward, "launches", 0)
    grads = [torch.full(q.shape, float("nan"), dtype=torch.float64) for _ in range(3)]
    got = rpa._backward_staged(q, k, v, out, dout, rh, rw, (H, W), *grads, lse=lse)
    assert rpa.relpos_attention_backward.launches == 12
    assert [(s, a) for s, _, a in seen] == [(s, a) for a in (2, 3, 3) for s in range(4)]
    assert [r for s, r, _ in seen if s == 0] == list(rects)
    ref = rpa.relpos_attention_backward_plain(q, k, v, out, dout, rh, rw, (H, W), lse)
    for a, b in zip(got, ref):  # the plain backward computes in f32
        assert torch.allclose(a.double(), b.double(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("H,W", [(5, 7), (8, 3)])
def test_plain_rows_match_the_plain_versions(H, W):
    """The sampled-row plain versions (used on the card for grids whose N x N
    logits would not fit) against the full plain forward and backward, f32."""
    from micro_sam_tpu_torch.ops import relpos_attention as rpa
    B, nH, hd = 2, 2, 16
    N = H * W
    g = torch.Generator().manual_seed(H * W)
    q, k, v = (torch.randn(B, nH, N, hd, generator=g) for _ in range(3))
    rh, rw = (torch.randn(s, s, hd, generator=g) * 0.3 for s in (H, W))
    rows = torch.tensor([0, W - 1, N // 2, N - 1, 3])
    lse = torch.empty(B, nH, N)
    out = rpa.relpos_attention_plain(q, k, v, rh, rw, (H, W), lse=lse)
    o, lr = rpa.relpos_attention_plain_rows(q, k, v, rh, rw, (H, W), rows)
    assert abs_err(o.numpy(), out[:, :, rows].numpy()) < TOL
    assert abs_err(lr.numpy(), lse[:, :, rows].numpy()) < TOL
    dout = torch.zeros_like(q)
    dout[:, :, rows] = torch.randn(B, nH, len(rows), hd, generator=g)
    ref = rpa.relpos_attention_backward_plain(q, k, v, out, dout, rh, rw, (H, W))
    got = rpa.relpos_attention_backward_plain_rows(q, k, v, out, dout, rh, rw, (H, W), rows)
    for a, b in zip(got, ref):
        assert abs_err(a.numpy(), b.numpy()) < TOL
