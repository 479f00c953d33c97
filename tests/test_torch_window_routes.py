"""The spatial-window (K9) and window-stack (K11) routes of the port, and the
rel-pos kernels' head-dim staging, on the CPU.

The same numpy inputs go through the JAX oracle (``_unfused_reference``, the
composition the JAX package holds its K9 / K11 kernels to, or the JAX encoder)
and the port, whose wrappers run their kernels' plain versions on CPU
tensors. Tolerances: blocks f32 abs <= 5e-5 (tests/test_fused_block.py's own
bound); the encoder rel <= 1e-4 of max|ref| against JAX and equal between the
port's routes (each row and window sees the same arithmetic); the head-dim
staging against the plain version rel <= 1e-6 (a float64 stand-in for the
kernel, so only the staging's arithmetic is under test).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import (abs_err, jax_block, jax_params, one_thread, port_block, port_sam,
                                   rel_err, tiny_jax_config)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: tier-1's six test processes share the
    machine's cores, and small tensors gain nothing from more (ROADMAP.md,
    Budgets)."""
    with one_thread():
        yield


TOL = 5e-5
ROUTES = {"default": {}, "spatial": {"MSAM_TPU_SPATIAL_WINDOW": "1"},
          "stack": {"MSAM_TPU_WINDOW_STACK": "1"},
          "both knobs": {"MSAM_TPU_SPATIAL_WINDOW": "1", "MSAM_TPU_WINDOW_STACK": "1"}}


def _jax_windows(x, W):
    """(B, H, H, C) -> JAX-partitioned (B * nW, W * W, C) windows, the pad mask
    (or None) and the padded size."""
    from micro_sam_tpu.models.image_encoder import window_partition
    B, H, _, C = x.shape
    xw, pad_hw = window_partition(jnp.asarray(x), W)
    valid = None
    if tuple(pad_hw) != (H, H):
        valid, _ = window_partition(jnp.ones((B, H, H, 1)), W)
        valid = valid.reshape(-1, W * W, 1)
    return xw.reshape(-1, W * W, C), valid, tuple(pad_hw)


@pytest.mark.parametrize("padded", [False, True])
def test_spatial_block_matches_jax_unfused(padded):
    """K9: the port's spatial chain on the padded map against JAX's
    ``_unfused_reference`` on the partitioned windows (tests/test_fused_block.py:45)."""
    from micro_sam_tpu.models.image_encoder import window_unpartition
    from micro_sam_tpu.ops.fused_window_block import _unfused_reference
    from micro_sam_tpu_torch.ops import fused_window_block as fwb

    C, nH, W, B = 64, 2, 7, 2
    H = 18 if padded else 14  # 18 pads to 21 (3 x 3 windows)
    bp = jax_block(C, nH, (W, W), seed=11)
    x = np.random.RandomState(12).randn(B, H, H, C).astype(np.float32)
    xw, valid, pad_hw = _jax_windows(x, W)
    ref = _unfused_reference(xw, valid, bp, (W, W), nH)
    ref = np.asarray(window_unpartition(ref.reshape(-1, W, W, C), W, pad_hw, (H, H)))

    blk = port_block(bp, C, nH, W, (W, W))
    Hp = pad_hw[0]
    xp = torch.zeros(B, Hp, Hp, C)
    xp[:, :H, :H] = torch.from_numpy(x)
    with torch.no_grad():
        got = fwb.fused_window_block_spatial_plain(xp, blk, W, (H, H), nH)
        wrapped = fwb.fused_window_block_spatial(xp, blk, W, (H, H), nH)
    assert got.shape == (B, Hp, Hp, C)
    assert abs_err(got[:, :H, :H].numpy(), ref) < TOL
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("padded", [False, True])
def test_spatial_block_equals_partitioned_chain(padded):
    """K9 against the partitioned K2 chain on the same windows, pad rows
    included: the same per-row and per-window arithmetic, so equal."""
    from micro_sam_tpu_torch.models.image_encoder import partition_tokens, window_unpartition
    from micro_sam_tpu_torch.ops import fused_window_block as fwb

    C, nH, W, B = 32, 2, 7, 3
    H = 10 if padded else 14
    blk = port_block(jax_block(C, nH, (W, W), seed=13), C, nH, W, (W, W))
    x = torch.from_numpy(np.random.RandomState(14).randn(B, H, H, C).astype(np.float32))
    xw, valid, pad_hw = partition_tokens(x, W)
    with torch.no_grad():
        ref = fwb.fused_window_block_plain(xw, valid, blk, (W, W), nH)
        ref = window_unpartition(ref.reshape(-1, W, W, C), W, pad_hw, pad_hw)
        xp = torch.nn.functional.pad(x, (0, 0, 0, pad_hw[1] - H, 0, pad_hw[0] - H))
        got = fwb.fused_window_block_spatial_plain(xp, blk, W, (H, H), nH)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("masked", [False, True])
def test_window_stack_matches_jax_unfused(masked):
    """K11: the port's window-stack chain against JAX's ``_unfused_reference``
    (tests/test_fused_block.py:397), 2 images of 4 windows."""
    from micro_sam_tpu.ops.fused_window_block import _unfused_reference
    from micro_sam_tpu_torch.ops import fused_window_block as fwb

    C, nH, W, n_images, NW = 64, 2, 8, 2, 4
    N = W * W
    bp = jax_block(C, nH, (W, W), seed=15)
    rng = np.random.RandomState(16)
    x = rng.randn(n_images * NW, N, C).astype(np.float32)
    valid = (rng.rand(n_images * NW, N, 1) > 0.2).astype(np.float32) if masked else None
    ref = np.asarray(_unfused_reference(jnp.asarray(x), None if valid is None else
                                        jnp.asarray(valid), bp, (W, W), nH))
    blk = port_block(bp, C, nH, W, (W, W))
    tv = None if valid is None else torch.from_numpy(valid)
    with torch.no_grad():
        got = fwb.fused_window_stack_plain(torch.from_numpy(x), tv, blk, (W, W), nH, n_images)
        wrapped = fwb.fused_window_stack(torch.from_numpy(x), tv, blk, (W, W), nH, n_images)
    assert abs_err(got.numpy(), ref) < TOL
    assert torch.equal(wrapped, got)


def test_window_stack_takes_whole_image_stacks():
    from micro_sam_tpu_torch.ops import fused_window_block as fwb
    C, nH, W = 32, 2, 7
    blk = port_block(jax_block(C, nH, (W, W), seed=17), C, nH, W, (W, W))
    with pytest.raises(ValueError, match="n_images"):
        fwb.fused_window_stack(torch.zeros(5, W * W, C), None, blk, (W, W), nH, 2)


@pytest.fixture(scope="module")
def tiny_models():
    cfg = tiny_jax_config()
    params = jax_params(cfg)
    return cfg, params, port_sam(cfg, params)


@pytest.mark.parametrize("route", list(ROUTES))
def test_encoder_routes_match_jax(tiny_models, monkeypatch, route):
    """``ImageEncoderViT.forward`` under each knob (16 x 16 tokens pad to 28 for
    the 14 x 14 windows): against JAX's encoder, and equal to the port's
    default route."""
    from micro_sam_tpu.models.sam import Sam as JaxSam, preprocess as jax_pre
    from micro_sam_tpu_torch.models.sam import preprocess
    cfg, params, sam = tiny_models
    img = (np.random.RandomState(18).rand(2, 256, 256, 3) * 255).astype(np.float32)
    ref = np.asarray(JaxSam(cfg, params).encode_image(params, jax_pre(jnp.asarray(img), 256)))
    px = preprocess(torch.from_numpy(img), 256)
    for knob in ("MSAM_TPU_SPATIAL_WINDOW", "MSAM_TPU_WINDOW_STACK"):
        monkeypatch.delenv(knob, raising=False)
    default = sam.encode_image(px)
    for knob, value in ROUTES[route].items():
        monkeypatch.setenv(knob, value)
    got = sam.encode_image(px)
    assert rel_err(got.numpy(), ref) <= 1e-4
    assert torch.equal(got, default)


@pytest.mark.parametrize("route", ["spatial", "stack"])
def test_encoder_routes_call_their_chains(tiny_models, monkeypatch, route):
    """Each knob sends every windowed block through its chain, by the module
    names of ops/fused_window_block, and leaves the global blocks alone."""
    from micro_sam_tpu_torch.ops import fused_window_block as fwb
    from micro_sam_tpu_torch.models.sam import preprocess
    cfg, _, sam = tiny_models
    calls = []
    for name in ("fused_window_block_spatial", "fused_window_stack", "fused_window_attn",
                 "fused_global_attn"):
        fn = getattr(fwb, name)
        monkeypatch.setattr(fwb, name, lambda *a, _f=fn, _n=name: calls.append(_n) or _f(*a))
    for knob, value in ROUTES[route].items():
        monkeypatch.setenv(knob, value)
    sam.encode_image(preprocess(torch.zeros(1, 256, 256, 3), 256))
    n_window = cfg.depth - len(cfg.global_attn_indexes)
    chain = "fused_window_block_spatial" if route == "spatial" else "fused_window_stack"
    assert sorted(calls) == sorted([chain] * n_window + ["fused_global_attn"]
                                   * len(cfg.global_attn_indexes))


def test_layernorm_grid_mask_equals_the_partition_mask():
    from micro_sam_tpu_torch.models.image_encoder import partition_tokens, window_partition
    from micro_sam_tpu_torch.ops.layernorm import grid_mask, layernorm
    B, H, W, Hp, Wp, C = 2, 10, 12, 14, 14, 16
    valid = torch.zeros(B, Hp, Wp)
    valid[:, :H, :W] = 1
    assert torch.equal(grid_mask(B * Hp * Wp, (Hp, Wp, H, W), "cpu"), valid.reshape(-1))
    x = torch.randn(B * Hp * Wp, C)
    w, b = torch.rand(C) + 0.5, torch.randn(C)
    ref = layernorm(x, w, b, 1e-6, valid.reshape(-1))
    assert torch.equal(layernorm(x, w, b, 1e-6, grid=(Hp, Wp, H, W)), ref)
    ones = partition_tokens(torch.ones(B, H, W, 1), 7)[1]
    assert torch.equal(window_partition(valid[..., None], 7)[0].reshape(ones.shape), ones)


# ---------------------------------------------------------------------------
# the rel-pos wrappers' staging: head dims between the instantiated ones and
# misaligned views run in an instantiated head dim, zero-padded
# ---------------------------------------------------------------------------

def _f64_forward(q, k, v, rh, rw, out, dims, hdp, scale, geo, strides, lse=None):
    """A float64 stand-in for one forward launch on staged operands: the
    kernel's arithmetic with the scale it is handed (not hdp ** -0.5)."""
    B, nH, N, H, W = dims
    assert q.shape[-1] == rh.shape[-1] == hdp and geo == (0, 0, 0)
    qd, kd, vd = (t.double() for t in (q, k, v))
    logits = scale * qd @ kd.transpose(-1, -2)
    r_q = qd.reshape(B, nH, H, W, hdp)
    bh = torch.einsum("bnijc,ikc->bnijk", r_q, rh.double())
    bw = torch.einsum("bnijc,jkc->bnijk", r_q, rw.double())
    logits = logits.view(B, nH, H, W, H, W) + bh[..., :, None] + bw[..., None, :]
    out.copy_(torch.softmax(logits.view(B, nH, N, N), -1) @ vd)


def _staging_case(hd, dtype=torch.float32, seed=19):
    B, nH, H, W = 2, 3, 4, 5
    g = torch.Generator().manual_seed(seed)
    rows = torch.randn(B, H * W, 3 * nH * hd + 1, generator=g, dtype=torch.float64).to(dtype)
    # q, k, v strided out of rows offset by one element: not 16-byte aligned
    q5 = rows[..., 1:].view(B, H * W, 3, nH, hd)
    q, k, v = (q5[:, :, i].transpose(1, 2) for i in range(3))
    rh, rw = ((torch.randn(s, s, hd, generator=g, dtype=torch.float64) * 0.3).to(dtype)
              for s in (H, W))
    return q, k, v, rh, rw, (H, W)


@pytest.mark.parametrize("hd", [40, 16, 64, 160])
def test_forward_staging_pads_the_head_dim(monkeypatch, hd):
    """hd 40 runs in the kernel built for 64, hd 16 in 32, hd 160 in 256, and
    a misaligned hd-64 view in 64 itself: the stand-in kernel on the staged
    buffers, cut back to hd, is the plain result at the true head dim."""
    from micro_sam_tpu_torch.ops import relpos_attention as rpa
    q, k, v, rh, rw, hw = _staging_case(hd)
    seen = []
    monkeypatch.setattr(rpa, "_forward_kernel",
                        lambda *a: seen.append(a[7]) or _f64_forward(*a))
    out = torch.full(q.shape, float("nan"))
    rpa._launch_forward(q, k, v, rh, rw, out, (q.shape[0], q.shape[1], q.shape[2], *hw),
                        (0, 0, 0), rpa._in_place, lambda t: t.stride()[:3])
    assert seen == [rpa.kernel_head_dim(hd)] == [{40: 64, 16: 32, 64: 64, 160: 256}[hd]]
    # the stand-in on the unpadded operands in float64 (the plain version
    # computes in f32, whose own error at hd 160 is about 1e-6)
    dims = (q.shape[0], q.shape[1], q.shape[2], *hw)
    ref64 = torch.empty(q.shape, dtype=torch.float64)
    _f64_forward(*(t.double() for t in (q, k, v, rh, rw)), ref64, dims, hd, hd ** -0.5,
                 (0, 0, 0), None)
    assert rel_err(out.numpy(), ref64.numpy()) <= 1e-6
    if hd <= 128:
        ref = rpa.relpos_attention_plain(q.double(), k.double(), v.double(), rh.double(),
                                         rw.double(), hw)
        assert rel_err(out.numpy(), ref.numpy()) <= 1e-6


def test_backward_staging_pads_the_head_dim(monkeypatch):
    """The backward's staging at hd 40 (kernel 64): a float64 stand-in for
    the four stages computes the gradients on the padded buffers with the
    true scale; cut back to hd (d rel_h / d rel_w too) they are the plain
    backward's, written into the caller's gradient views. The forward's row
    log-sum-exps reach every stage as given."""
    from micro_sam_tpu_torch.ops import relpos_attention as rpa
    hd = 40
    q, k, v, rh, rw, hw = _staging_case(hd, seed=20)
    lse = torch.empty(q.shape[:3])
    out = rpa.relpos_attention_plain(q, k, v, rh, rw, hw, lse=lse)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(21))

    def stand_in(stage, code, ins, lse_, rhs, rws, outs, drh, drw, scratch, dims, hdp, scale):
        assert hdp == 64 and all(t.shape[-1] == 64 for t in (*ins, *outs, rhs, rws))
        assert lse_ is lse and code == 0
        if stage:
            return
        qd, kd, vd, od, gd = (t.double().requires_grad_(i < 3) for i, t in enumerate(ins))
        th, tw = (t.double().requires_grad_() for t in (rhs, rws))
        B, nH, N, H, W = dims
        r_q = qd.reshape(B, nH, H, W, hdp)
        logits = (scale * qd @ kd.transpose(-1, -2)).view(B, nH, H, W, H, W)
        logits = (logits + torch.einsum("bnijc,ikc->bnijk", r_q, th)[..., :, None]
                  + torch.einsum("bnijc,jkc->bnijk", r_q, tw)[..., None, :])
        o = torch.softmax(logits.view(B, nH, N, N), -1) @ vd
        grads = torch.autograd.grad(o, (qd, kd, vd, th, tw), gd)
        for dst, src in zip((*outs, drh, drw), grads):
            dst.copy_(src)
    monkeypatch.setattr(rpa, "_backward_kernel", stand_in)
    monkeypatch.setattr(rpa.relpos_attention_backward, "launches", 0)
    dq, dk, dv = (torch.full(q.shape, float("nan")) for _ in range(3))
    got = rpa._backward_staged(q, k, v, out, dout, rh, rw, hw, dq, dk, dv, lse)
    ref = rpa.relpos_attention_backward_plain(*(t.double() for t in (q, k, v, out, dout, rh, rw)),
                                              hw)
    assert got[0] is dq and got[2] is dv
    assert got[3].shape == rh.shape and got[4].shape == rw.shape
    for g, r in zip(got, ref):
        assert rel_err(g.detach().numpy(), r.numpy()) <= 1e-6


def test_head_dims_above_128_are_refused():
    """Only above 256 now, by the forward and the backward alike: both are
    built up to 256 and stage every head dim up to it; above, both raise
    before any launch."""
    from micro_sam_tpu_torch.ops import relpos_attention as rpa
    assert rpa.HEAD_DIMS == (32, 64, 80, 96, 128, 256)
    assert rpa.BWD_HEAD_DIMS == rpa.HEAD_DIMS and rpa.MAX_BWD_HEAD_DIM == 256
    assert [rpa.kernel_head_dim(d) for d in (1, 32, 33, 72, 80, 81, 100, 128, 129, 160, 256)] \
        == [32, 32, 64, 80, 80, 96, 128, 128, 256, 256, 256]
    assert [rpa.kernel_head_dim(d, rpa.BWD_HEAD_DIMS) for d in (1, 33, 81, 100, 128, 136, 256)] \
        == [32, 64, 96, 128, 128, 256, 256]
    for dims in (rpa.HEAD_DIMS, rpa.BWD_HEAD_DIMS):
        with pytest.raises(ValueError, match="forward and backward.*up to 256"):
            rpa.kernel_head_dim(257, dims)
    q = torch.zeros(1, 1, 4, 264)
    tab = torch.zeros(2, 2, 264)
    with pytest.raises(ValueError, match="up to 256"):  # before any launch
        rpa._backward_staged(q, q, q, q, q, tab, tab, (2, 2), None, None, None)
    with pytest.raises(ValueError, match="up to 256"):
        rpa._launch_forward(q, q, q, tab, tab, q.clone(), (1, 1, 4, 2, 2), (0, 0, 0),
                            rpa._in_place, lambda t: t.stride()[:3])


def test_spatial_plain_is_the_partitioned_attention():
    """``relpos_attention_spatial`` on the CPU: the windows of (B, Hp, Wp, nH, hd)
    maps, each through ``relpos_attention_plain``."""
    from micro_sam_tpu_torch.models.image_encoder import window_partition
    from micro_sam_tpu_torch.ops import relpos_attention as rpa
    B, w, nwy, nwx, nH, hd = 2, 4, 2, 3, 2, 8
    g = torch.Generator().manual_seed(22)
    rows = torch.randn(B, nwy * w, nwx * w, 3, nH, hd, generator=g)
    q, k, v = (rows[:, :, :, i] for i in range(3))
    rh, rw = (torch.randn(w, w, hd, generator=g) * 0.3 for _ in range(2))
    out = torch.empty(B, nwy * w, nwx * w, nH, hd)
    got = rpa.relpos_attention_spatial(q, k, v, rh, rw, w, out=out)
    assert got is out
    win = lambda t: window_partition(t.reshape(B, nwy * w, nwx * w, nH * hd), w)[0].reshape(
        -1, w * w, nH, hd).transpose(1, 2)
    ref = rpa.relpos_attention_plain(win(q), win(k), win(v), rh, rw, (w, w))
    assert torch.equal(win(got), ref)
