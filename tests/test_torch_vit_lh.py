"""vit_l / vit_h in the port against the JAX package, on the CPU.

vit_h has head dim 80 (1280 / 16); its blocks run as the attention halves
``fused_window_attn`` (K10) / ``fused_global_attn`` (K5) followed by
``mlp_half``. The same numpy inputs go through the JAX function (Pallas in
interpret mode, or the unfused composition) and the port's function (the
kernels' plain versions on CPU tensors). f32 throughout. Tolerances: kernels
and chains abs <= 5e-5 (as tests/test_torch_kernels.py); whole encoder and
predictor rel <= 1e-4 of max|ref|; the golden fixture (an independent torch
oracle) rel < 1e-3, the bound tests/test_golden.py holds the JAX package to.
"""
import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import (abs_err, jax_block, jax_params, one_thread, port_block, port_sam,
                                   rel_err)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: tier-1's six test processes share the
    machine's cores, and small tensors gain nothing from more (ROADMAP.md,
    Budgets)."""
    with one_thread():
        yield


TOL = 5e-5
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
C80, NH80 = 160, 2  # head dim 80, the vit_h class at a CI width


def vit_h_class_config(img_size=256, depth=4, global_attn_indexes=(3,), embed_dim=C80,
                       num_heads=NH80, model_type="vit_h"):
    """A vit_h-class JAX config: head dim 80; at 256 px the 16 x 16 tokens pad
    to 28 for the 14 x 14 windows, so the window pad mask is exercised."""
    from micro_sam_tpu.models.sam import SamConfig
    return SamConfig(model_type=model_type, embed_dim=embed_dim, depth=depth,
                     num_heads=num_heads, global_attn_indexes=global_attn_indexes,
                     img_size=img_size)


def _window_inputs(masked, BW=3, W=7, seed=12):
    rng = np.random.RandomState(seed)
    x = rng.randn(BW, W * W, C80).astype(np.float32)
    valid = (rng.rand(BW, W * W, 1) > 0.2).astype(np.float32) if masked else None
    return x, valid


@pytest.mark.parametrize("oracle", ["pallas_interpret", "unfused_half"])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attn_matches_jax(masked, oracle):
    """K10: x + attn(LN1(x) * valid) at hd 80."""
    from micro_sam_tpu.ops import fused_window_block as jfwb
    from micro_sam_tpu_torch.ops.fused_window_block import fused_window_attn

    W = 7
    bp = jax_block(C80, NH80, (W, W), seed=13)
    x, valid = _window_inputs(masked)
    jx, jv = jnp.asarray(x), None if valid is None else jnp.asarray(valid)
    if oracle == "pallas_interpret":
        ref = jfwb.fused_window_attn(jx, jv, bp, (W, W), NH80)
    else:
        ref = jfwb._unfused_window_attn_half(jx, jv, bp, (W, W), NH80)
    with torch.no_grad():
        got = fused_window_attn(torch.from_numpy(x),
                                None if valid is None else torch.from_numpy(valid),
                                port_block(bp, C80, NH80, W, (W, W)), (W, W), NH80)
    assert abs_err(got.numpy(), np.asarray(ref)) < TOL


@pytest.mark.parametrize("oracle", ["pallas_interpret", "unfused_half"])
def test_global_attn_matches_jax(oracle):
    """K5: x + attn(LN1(x)) over 16 x 16 tokens at hd 80."""
    from micro_sam_tpu.ops import fused_window_block as jfwb
    from micro_sam_tpu_torch.ops.fused_window_block import fused_global_attn

    H = 16
    bp = jax_block(C80, NH80, (H, H), seed=14)
    x = np.random.RandomState(15).randn(1, H * H, C80).astype(np.float32)
    if oracle == "pallas_interpret":
        assert jfwb.global_attn_config(H, H, jnp.float32, channels=C80,
                                       num_heads=NH80) is not None  # the Pallas kernel runs
        ref = jfwb.fused_global_attn(jnp.asarray(x), bp, (H, H), NH80)
    else:
        ref = jfwb._unfused_attn_half(jnp.asarray(x), bp, (H, H), NH80)
    with torch.no_grad():
        got = fused_global_attn(torch.from_numpy(x), port_block(bp, C80, NH80, 0, (H, H)),
                                (H, H), NH80)
    assert abs_err(got.numpy(), np.asarray(ref)) < TOL


@pytest.mark.parametrize("kind", ["window", "window_masked", "global"])
def test_blocks_are_their_two_halves(kind):
    """A whole block is the attention half, then the MLP half, bit for bit."""
    from micro_sam_tpu_torch.ops import fused_window_block as fwb

    W = 0 if kind == "global" else 7
    hw = (16, 16) if kind == "global" else (W, W)
    blk = port_block(jax_block(C80, NH80, hw, seed=16), C80, NH80, W, hw)
    if kind == "global":
        x, valid = np.random.RandomState(17).randn(1, 256, C80).astype(np.float32), None
    else:
        x, valid = _window_inputs(kind == "window_masked", seed=17)
    x = torch.from_numpy(x)
    valid = None if valid is None else torch.from_numpy(valid)
    with torch.no_grad():
        if kind == "global":
            whole = fwb.fused_global_block(x, blk, hw, NH80)
            halves = fwb.mlp_half(fwb.fused_global_attn(x, blk, hw, NH80), blk)
            plain = fwb.mlp_half_plain(fwb.fused_global_attn_plain(x, blk, hw, NH80), blk)
        else:
            whole = fwb.fused_window_block(x, valid, blk, hw, NH80)
            halves = fwb.mlp_half(fwb.fused_window_attn(x, valid, blk, hw, NH80), blk)
            plain = fwb.mlp_half_plain(fwb.fused_window_attn_plain(x, valid, blk, hw, NH80), blk)
    assert torch.equal(whole, halves) and torch.equal(whole, plain)


def test_encoder_matches_jax_vit_h_class():
    """Depth 4 with a global block at index 3, hd 80, 256 px (pad mask)."""
    from micro_sam_tpu.models.sam import Sam as JaxSam, preprocess as jax_pre
    from micro_sam_tpu_torch.models.sam import preprocess
    cfg = vit_h_class_config()
    params = jax_params(cfg, seed=18)
    img = (np.random.RandomState(19).rand(1, 256, 256, 3) * 255).astype(np.float32)
    ref = np.asarray(JaxSam(cfg, params).encode_image(params, jax_pre(jnp.asarray(img), 256)))
    got = port_sam(cfg, params).encode_image(preprocess(torch.from_numpy(img), 256)).numpy()
    assert rel_err(got, ref) <= 1e-4


@pytest.mark.parametrize("name", ["vit_l", "vit_h"])
def test_golden_vit_lh512_embedding(name):
    """vit_l / vit_h at their real widths (1024 x 16 heads, 1280 x 16 heads),
    depth 4, 512 px, against the torch-oracle embedding."""
    from micro_sam_tpu_torch.models.sam import preprocess
    from tests.make_golden import build_lh_configs, build_lh_params, fixed_image
    cfg = build_lh_configs()[name]
    sam = port_sam(cfg, build_lh_params(cfg))
    image = fixed_image(cfg.img_size, 512)
    got = sam.encode_image(preprocess(torch.from_numpy(image), cfg.img_size)).numpy()
    ref = np.load(os.path.join(FIXTURES, "golden_vit_lh512.npz"))[f"embedding_{name}"]
    assert rel_err(got, ref.astype(np.float32)) < 1e-3


@pytest.mark.parametrize("name", ["vit_h_class", "vit_l_depth24", "vit_h_depth32"])
def test_params_round_trip(name):
    """params_from_jax equals the JAX package's torch export and the port's
    module layout, and params_to_jax gives the tree back, at the depths and
    global indexes of vit_l (24; 5, 11, 17, 23) and vit_h (32; 7, 15, 23, 31)
    at a narrow width, and at the depth-4 vit_h-class config."""
    from micro_sam_tpu.models.convert import export_torch_state_dict
    from micro_sam_tpu.models.sam import init_sam_params
    from micro_sam_tpu_torch.models.build_sam import SAM_CONFIGS
    from micro_sam_tpu_torch.models.convert import params_from_jax, params_to_jax
    from micro_sam_tpu_torch.models.sam import Sam, SamConfig
    if name == "vit_h_class":
        cfg = vit_h_class_config()
    else:
        full = SAM_CONFIGS[name[:5]]
        cfg = vit_h_class_config(depth=full.depth, global_attn_indexes=full.global_attn_indexes,
                                 embed_dim=32, model_type=full.model_type)
    params = jax.tree.map(np.asarray, init_sam_params(jax.random.PRNGKey(20), cfg))
    pcfg = SamConfig(**dataclasses.asdict(cfg))
    sd = params_from_jax(params, pcfg)
    ref = export_torch_state_dict(params, cfg)
    assert sorted(sd) == sorted(ref) == sorted(Sam(pcfg).state_dict())
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    for i in range(cfg.depth):  # global blocks hold the (2 * 16 - 1)-row tables
        rows = sd[f"image_encoder.blocks.{i}.attn.rel_pos_h"].shape[0]
        assert rows == (31 if i in cfg.global_attn_indexes else 27), (i, rows)
    back = params_to_jax(sd, pcfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def _small_real_width(model_type):
    """vit_l / vit_h at their real width and heads, cut to depth 2 and 256 px."""
    from micro_sam_tpu_torch.models.build_sam import SAM_CONFIGS
    return dataclasses.replace(SAM_CONFIGS[model_type], depth=2, global_attn_indexes=(1,),
                               img_size=256)


@pytest.mark.parametrize("model_type", ["vit_l", "vit_h"])
def test_sam_layout_checkpoint_loads(model_type, monkeypatch, tmp_path):
    """A segment_anything-layout ``.pth`` of vit_l / vit_h (random weights at
    the real width) names its model type by its width and loads unchanged;
    ``vit_l_lm`` / ``vit_h_...`` names resolve to the base config."""
    from micro_sam_tpu_torch.models import build_sam
    from micro_sam_tpu_torch.models.convert import load_torch_checkpoint
    from micro_sam_tpu_torch.util import get_sam_model
    monkeypatch.setitem(build_sam.SAM_CONFIGS, model_type, _small_real_width(model_type))
    src = build_sam.build_sam(model_type, seed=21, device="cpu")
    path = str(tmp_path / f"sam_{model_type}.pth")
    torch.save(src.state_dict(), path)
    cfg, sd, decoder_state = load_torch_checkpoint(path)
    assert cfg.model_type == model_type and decoder_state is None
    name = "vit_l_lm" if model_type == "vit_l" else model_type
    assert build_sam.get_config(name).model_type == model_type
    p = get_sam_model(name, device="cpu", checkpoint_path=path)
    assert p.model.config.model_type == model_type and p.model_type == name
    got = p.model.state_dict()
    assert sorted(got) == sorted(src.state_dict())
    for k, v in src.state_dict().items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)


def test_slice_matches_jax_predictor(monkeypatch, tmp_path):
    """get_sam_model("vit_h", device="cpu") -> precompute (cached) -> predict
    with a box, against the JAX predictor on the same parameters; vit_h is
    cut to the vit_h-class config (hd 80, depth 4, 256 px). A box prompt adds
    no pad point, so the JAX predictor's prompt buckets do not come in
    (ROADMAP Queue 3). The cache carries the model type in its signature."""
    from micro_sam_tpu.models.sam import Sam as JaxSam
    from micro_sam_tpu.predictor import SamPredictor as JaxPredictor
    from micro_sam_tpu.util import precompute_image_embeddings as jax_precompute
    from micro_sam_tpu.util import set_precomputed as jax_set
    from micro_sam_tpu_torch.models import build_sam
    from micro_sam_tpu_torch.models.convert import params_to_jax
    from micro_sam_tpu_torch.util import (get_sam_model, precompute_image_embeddings,
                                          set_precomputed)
    cfg = vit_h_class_config()
    monkeypatch.setitem(build_sam.SAM_CONFIGS, "vit_h",
                        build_sam.SamConfig(**dataclasses.asdict(cfg)))
    pp = get_sam_model("vit_h", device="cpu", seed=22)
    assert pp.device.type == "cpu" and pp.model.config.compute_dtype == "float32"
    blk = pp.model.image_encoder.blocks[0]
    assert blk.attn.rel_pos_h.shape[1] == 80
    jp = JaxPredictor(JaxSam(cfg, params_to_jax(pp.model.state_dict(), pp.model.config)))
    image = np.random.RandomState(23).randint(0, 256, size=(256, 256)).astype(np.uint8)
    save_path = str(tmp_path / "emb.zarr")
    got = precompute_image_embeddings(pp, image, save_path=save_path, verbose=False)
    ref = jax_precompute(jp, image, verbose=False)
    assert got["features"].shape == ref["features"].shape == (1, 256, 16, 16)
    assert rel_err(got["features"], ref["features"]) <= 1e-4
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the same model reads its cache silently
        again = precompute_image_embeddings(pp, image, save_path=save_path, verbose=False)
    np.testing.assert_array_equal(np.asarray(again["features"]), got["features"])
    pl = get_sam_model("vit_l", device="cpu", seed=22)
    with pytest.warns(UserWarning, match="model_type"):
        precompute_image_embeddings(pl, image, save_path=save_path, verbose=False)
    set_precomputed(pp, got)
    jax_set(jp, ref)
    kw = dict(box=np.array([40., 30., 200., 180.]), return_logits=True)
    pm, pi, plo = pp.predict(**kw)
    jm, ji, jl = jp.predict(**kw)
    assert pm.shape == jm.shape == (3, 256, 256)
    assert rel_err(pm, jm) <= 1e-4 and rel_err(plo, jl) <= 1e-4 and abs_err(pi, ji) <= 1e-4


def test_backward_at_hd80_on_cpu_matches_autograd():
    """vit_h's head dim is one the backward kernel is built for; on CPU
    tensors at hd 80, relpos_attention_backward returns the plain gradients,
    which equal autograd through relpos_attention_plain (both in f32:
    rel 1e-5 of each gradient's max)."""
    from micro_sam_tpu_torch.ops.relpos_attention import (BWD_HEAD_DIMS,
                                                          relpos_attention_backward,
                                                          relpos_attention_plain)
    assert 80 in BWD_HEAD_DIMS
    g = torch.Generator().manual_seed(24)
    B, nH, H, W, hd = 2, 2, 3, 4, 80
    q, k, v = (torch.randn(B, nH, H * W, hd, generator=g).requires_grad_() for _ in range(3))
    rh = (torch.randn(H, H, hd, generator=g) * 0.3).requires_grad_()
    rw = (torch.randn(W, W, hd, generator=g) * 0.3).requires_grad_()
    dout = torch.randn(B, nH, H * W, hd, generator=g)
    out = relpos_attention_plain(q, k, v, rh, rw, (H, W))
    ref = torch.autograd.grad(out, (q, k, v, rh, rw), dout)
    got = relpos_attention_backward(q.detach(), k.detach(), v.detach(), out.detach(), dout,
                                    rh.detach(), rw.detach(), (H, W))
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        assert float((a - r).abs().max()) <= 1e-5 * float(r.abs().max())
