"""The port's vit_t (TinyViT / MobileSAM) against the JAX package, f32 on the CPU.

One JAX vit_t parameter tree, with non-trivial BatchNorm statistics and
attention-bias tables drawn with numpy, is carried into the port through
``params_from_jax``. The kernel chains (K6 window attention, K7 MBConv, K8
block tail), which on CPU tensors run the kernels' plain versions, are held
against the JAX package's unfused composition and its Pallas kernel in
interpret mode; the whole encoder against ``apply_tiny_vit`` with the fused
family off and on; the slice against the JAX predictor. Tolerance: rel 1e-4 of
max|ref| (f32); the golden bytes are float16, so against them rel 1e-3 (the
bound tests/test_golden.py holds the JAX package to) and, value by value,
half a float16 step plus rel 1e-4.

The qkv layout is the one place the port does not follow the JAX package:
upstream TinyViT (MobileSAM) splits its qkv channels per head, the JAX package
into global thirds (``micro_sam_tpu/models/tiny_vit.py:175``), and its
converter reads an upstream checkpoint without reordering (``:340-344,377``).
``test_qkv_layout_divergence`` pins the difference.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import abs_err, one_thread, rel_err


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: tier-1's six test processes share the
    machine's cores, and small tensors gain nothing from more (ROADMAP.md,
    Budgets)."""
    with one_thread():
        yield


FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TOL = 1e-4
SIZE = 128


def _jax_config(img_size=SIZE):
    from micro_sam_tpu.models.build_sam import get_config
    return dataclasses.replace(get_config("vit_t"), img_size=img_size)


def _scramble(tree, rng):
    """Non-trivial BN statistics and affine terms, and attention-bias tables."""
    if isinstance(tree, dict):
        if "mean" in tree and "var" in tree:
            n = tree["mean"].shape
            tree["mean"] = (rng.randn(*n) * 0.2).astype(np.float32)
            tree["var"] = (rng.rand(*n) + 0.5).astype(np.float32)
            tree["scale"] = (1 + rng.randn(*n) * 0.2).astype(np.float32)
            tree["bias"] = (rng.randn(*n) * 0.2).astype(np.float32)
        for k, v in tree.items():
            if k == "attention_biases":
                tree[k] = (rng.randn(*v.shape) * 0.5).astype(np.float32)
            else:
                _scramble(v, rng)
    elif isinstance(tree, list):
        for v in tree:
            _scramble(v, rng)
    return tree


def _jax_tree(img_size=SIZE, seed=0, encoder=None):
    from micro_sam_tpu.models.sam import init_sam_params
    params = jax.tree.map(np.asarray, init_sam_params(jax.random.PRNGKey(seed),
                                                      _jax_config(img_size)))
    if encoder is not None:
        params["image_encoder"] = jax.tree.map(np.asarray, encoder)
    else:
        _scramble(params["image_encoder"], np.random.RandomState(seed + 1))
    return params


def _port_sam(params, img_size=SIZE, compute_dtype="float32"):
    from micro_sam_tpu_torch.models.build_sam import get_config
    from micro_sam_tpu_torch.models.convert import params_from_jax
    from micro_sam_tpu_torch.models.sam import Sam
    cfg = dataclasses.replace(get_config("vit_t", compute_dtype), img_size=img_size)
    sam = Sam(cfg)
    sam.load_state_dict(params_from_jax(params, cfg))
    return sam.eval()


@pytest.fixture(scope="module")
def models():
    params = _jax_tree()
    return params, _port_sam(params)


def _rand(shape, seed, scale=0.5):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("window", [7, 14])
def test_bias_offset_index_matches_jax(window):
    """|dy| * w + |dx| numbers the offsets as upstream's attention_bias_idxs:
    query (0, 0) meets every offset first, in row-major order."""
    from micro_sam_tpu.models.tiny_vit import _attention_bias_idxs
    from micro_sam_tpu_torch.ops.tiny_attention import bias_offset_index
    ref, n_offsets = _attention_bias_idxs(window)
    assert n_offsets == window * window
    np.testing.assert_array_equal(bias_offset_index(window).numpy(), ref)


STAGES = {1: (128, 4, 7, 21), 2: (160, 5, 14, 28), 3: (320, 10, 7, 14)}  # C, nH, w, Hp


@pytest.mark.parametrize("oracle", ["unfused", "pallas_interpret"])
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_tiny_attention_chain_matches_jax(models, stage, oracle):
    """K6 at the geometries of tests/test_fused_tiny.py: the padded map in,
    x + proj(attn(LN(x))) out."""
    from micro_sam_tpu.models.tiny_vit import _attention_bias_idxs
    from micro_sam_tpu.ops import fused_tiny_attention as jfta
    from micro_sam_tpu_torch.ops.fused_tiny_attention import fused_tiny_attention
    params, sam = models
    C, nh, w, Hp = STAGES[stage]
    p = params["image_encoder"][f"stage{stage}"][0]["attn"]
    n = w * w
    bias_cat = jnp.asarray(p["attention_biases"])[:, jnp.asarray(_attention_bias_idxs(w)[0])]
    bias_cat = bias_cat.transpose(1, 0, 2).reshape(n, nh * n)
    x = _rand((2, Hp, Hp, C), seed=stage)
    fn = jfta._unfused_reference if oracle == "unfused" else jfta._tiny_fused_forward
    ref = np.asarray(fn(jnp.asarray(x), jax.tree.map(jnp.asarray, p), bias_cat, nh, w))
    attn = sam.image_encoder.layers[stage].blocks[0].attn
    assert (attn.num_heads, attn.window) == (nh, w)
    with torch.no_grad():
        got = fused_tiny_attention(torch.from_numpy(x), attn).numpy()
    assert rel_err(got, ref) <= TOL


@pytest.mark.parametrize("oracle", ["unfused", "pallas_interpret"])
@pytest.mark.parametrize("H,W", [(64, 48), (8, 16)])
def test_mbconv_chain_matches_jax(models, H, W, oracle):
    """K7 at the shapes of tests/test_fused_tiny.py (two row chunks of the
    JAX kernel at H = 64; image-edge halos at both)."""
    from micro_sam_tpu.models import tiny_vit as jtv
    from micro_sam_tpu.ops.fused_mbconv import _mbconv_fused_forward
    from micro_sam_tpu_torch.ops.fused_mbconv import fused_mbconv
    params, sam = models
    p = jax.tree.map(jnp.asarray, params["image_encoder"]["stage0"][0])
    x = jnp.asarray(_rand((2, H, W, 64), seed=H))
    ref = np.asarray(jtv._mbconv_unfused(p, x) if oracle == "unfused"
                     else _mbconv_fused_forward(x, p))
    with torch.no_grad():
        got = fused_mbconv(torch.from_numpy(np.asarray(x)), sam.image_encoder.layers[0].blocks[0])
    assert rel_err(got.numpy(), ref) <= TOL


@pytest.mark.parametrize("oracle", ["unfused", "pallas_interpret"])
@pytest.mark.parametrize("stage,H,W", [(1, 16, 24), (2, 16, 16), (3, 8, 16)])
def test_tail_chain_matches_jax(models, stage, H, W, oracle):
    """K8: bn(dw3x3(x)) then + MLP(LN(.)); H a multiple of 8 for the JAX kernel."""
    from micro_sam_tpu.ops import fused_tiny_tail as jftt
    from micro_sam_tpu_torch.ops.fused_tiny_tail import fused_tiny_tail
    params, sam = models
    bp = jax.tree.map(jnp.asarray, params["image_encoder"][f"stage{stage}"][0])
    C = STAGES[stage][0]
    x = jnp.asarray(_rand((2, H, W, C), seed=10 + stage, scale=1.0))
    fn = jftt._unfused_reference if oracle == "unfused" else jftt._tail_fused_forward
    ref = np.asarray(fn(x, bp["local_conv"], bp["mlp"]))
    blk = sam.image_encoder.layers[stage].blocks[0]
    with torch.no_grad():
        got = fused_tiny_tail(torch.from_numpy(np.asarray(x)), blk.local_conv, blk.mlp)
    assert rel_err(got.numpy(), ref) <= TOL


@pytest.mark.parametrize("fused", ["0", "1"], ids=["jax_unfused", "jax_fused"])
@pytest.mark.parametrize("size", [SIZE, 101], ids=["128", "odd101"])
def test_encoder_matches_jax(models, monkeypatch, size, fused):
    """The whole encoder; at 101 px every stage pads its windows and the JAX
    package takes its conv fallbacks (odd sizes, H % 8 != 0)."""
    from micro_sam_tpu.models.tiny_vit import apply_tiny_vit
    params, sam = models
    monkeypatch.setenv("MSAM_TPU_FUSED_TINY", fused)
    x = np.random.RandomState(size).rand(1, size, size, 3).astype(np.float32)
    ref = np.asarray(apply_tiny_vit(jax.tree.map(jnp.asarray, params["image_encoder"]),
                                    jnp.asarray(x)))
    got = sam.encode_image(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, -(-size // 16), -(-size // 16), 256)
    assert rel_err(got, ref) <= TOL


def test_golden_vit_t1024_embedding():
    """The independent torch oracle's bytes at 1024 px (tests/make_golden.py),
    the weights carried over through params_from_jax."""
    from micro_sam_tpu_torch.models.sam import preprocess
    from tests.make_golden import build_tiny_vit_params, fixed_image
    sam = _port_sam(_jax_tree(1024, encoder=build_tiny_vit_params()), img_size=1024)
    got = sam.encode_image(preprocess(torch.from_numpy(fixed_image(1024, 77)), 1024)).numpy()
    golden = np.load(os.path.join(FIXTURES, "golden_vit_t1024.npz"))["embedding"]
    ref = golden.astype(np.float32)
    assert rel_err(got, ref) < 1e-3
    # the bytes are float16: within half a float16 step of each value, plus
    # rel 1e-4 of max|ref|
    half_step = 0.5 * np.spacing(np.abs(golden)).astype(np.float32)
    assert np.all(np.abs(got - ref) <= half_step + 1e-4 * np.abs(ref).max())


def test_params_round_trip_and_jax_export(models):
    """JAX tree -> port -> JAX tree and port -> JAX tree -> port are exact; the
    key layout is the JAX package's own torch export, whose qkv rows are the
    port's permuted back to [q | k | v] thirds."""
    from micro_sam_tpu.models.convert import export_torch_state_dict
    from micro_sam_tpu_torch.models.convert import params_from_jax, params_to_jax
    params, sam = models
    cfg = sam.config
    sd = params_from_jax(params, cfg)
    back = params_to_jax(sd, cfg)
    flat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(params)}
    flat_back = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(back)}
    assert sorted(flat) == sorted(flat_back)
    for k, v in flat.items():
        np.testing.assert_array_equal(flat_back[k], v, err_msg=k)
    again = params_from_jax(back, cfg)
    assert sorted(again) == sorted(sd) == sorted(sam.state_dict())
    for k in sd:
        torch.testing.assert_close(again[k], sd[k], rtol=0, atol=0)

    export = export_torch_state_dict(params, _jax_config())
    assert sorted(export) == sorted(sd)
    qkv = [k for k in sd if k.endswith((".attn.qkv.weight", ".attn.qkv.bias"))]
    assert len(qkv) == 2 * 10
    for k, v in export.items():
        if k in qkv:
            nh = sam.image_encoder.layers[int(k.split(".")[2])].blocks[0].attn.num_heads
            thirds = v.reshape(3, nh, -1, *v.shape[1:])
            v = thirds.swapaxes(0, 1).reshape(v.shape)
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_native_checkpoint_loads(models, tmp_path):
    from micro_sam_tpu.util import save_native_checkpoint
    from micro_sam_tpu_torch.models.convert import load_native_checkpoint
    params, sam = models
    path = str(tmp_path / "vit_t.npz")
    save_native_checkpoint(path, params, _jax_config())
    cfg, sd = load_native_checkpoint(path)
    assert cfg.model_type == "vit_t" and cfg.encoder == "tiny_vit"
    ref = sam.state_dict()
    assert sorted(sd) == sorted(ref)
    for k in ref:
        torch.testing.assert_close(sd[k], ref[k].float(), rtol=0, atol=0)


def _mobile_sam_state_dict(sam):
    """A MobileSAM-layout checkpoint of the port's weights, with the keys
    upstream's module adds: the ImageNet head, BN batch counters."""
    sd = {k: v.clone() for k, v in sam.state_dict().items()}
    sd["image_encoder.norm_head.weight"] = torch.ones(320)
    sd["image_encoder.norm_head.bias"] = torch.zeros(320)
    sd["image_encoder.head.weight"] = torch.zeros(1000, 320)
    sd["image_encoder.head.bias"] = torch.zeros(1000)
    for k in list(sd):
        if k.endswith(".bn.running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def test_mobile_sam_checkpoint_loads_as_it_is(models, tmp_path):
    """load_torch_checkpoint / get_sam_model take a MobileSAM vit_t dict without
    permuting it: the loaded model holds the same tensors and encodes the same."""
    from micro_sam_tpu_torch.models.convert import infer_model_type, load_torch_checkpoint
    from micro_sam_tpu_torch.util import get_sam_model
    _, sam = models
    sd = _mobile_sam_state_dict(sam)
    assert infer_model_type(sd) == "vit_t"
    path = str(tmp_path / "vit_t.pt")
    torch.save(sd, path)
    cfg, loaded, _ = load_torch_checkpoint(path)
    assert cfg.encoder == "tiny_vit"
    ref = sam.state_dict()
    assert sorted(loaded) == sorted(ref)
    for k in ref:
        torch.testing.assert_close(loaded[k], ref[k], rtol=0, atol=0)
    p = get_sam_model("vit_t", device="cpu", checkpoint_path=path)
    got = p.model.state_dict()
    assert p.model.config.img_size == 1024 and sorted(got) == sorted(ref)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0)


def _upstream_tiny_attention(sd, pre, x, num_heads, window):
    """Upstream TinyViT's Attention.forward (MobileSAM tiny_vit_sam.py): the qkv
    channels split per head, q, k, v = qkv.view(B, N, nH, -1).split(...)."""
    import torch.nn.functional as F
    from tests.torch_tiny_vit_ref import attention_bias_idxs
    B, N, C = x.shape
    kd = C // num_heads
    x = F.layer_norm(x, (C,), sd[f"{pre}.norm.weight"], sd[f"{pre}.norm.bias"], eps=1e-5)
    qkv = F.linear(x, sd[f"{pre}.qkv.weight"], sd[f"{pre}.qkv.bias"])
    q, k, v = qkv.view(B, N, num_heads, -1).split([kd, kd, kd], dim=3)
    q, k, v = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    attn = (q @ k.transpose(-2, -1)) * kd ** -0.5
    attn = attn + sd[f"{pre}.attention_biases"][:, attention_bias_idxs(window)]
    out = (attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(B, N, C)
    return F.linear(out, sd[f"{pre}.proj.weight"], sd[f"{pre}.proj.bias"])


def test_qkv_layout_divergence(models, monkeypatch):
    """Intended divergence: on one MobileSAM-layout state dict the port
    computes upstream's function (per-head qkv split, written out above), the
    JAX package (convert_tiny_vit + apply_tiny_vit, global thirds) another;
    params_from_jax permutes, so on the JAX package's own tree the two agree."""
    import tests.torch_tiny_vit_ref as oracle
    from micro_sam_tpu.models.tiny_vit import apply_tiny_vit, convert_tiny_vit
    _, sam = models
    monkeypatch.setenv("MSAM_TPU_FUSED_TINY", "0")
    sd = {k: v.float() for k, v in sam.state_dict().items() if k.startswith("image_encoder.")}
    x = np.random.RandomState(5).rand(1, SIZE, SIZE, 3).astype(np.float32)
    with torch.no_grad():
        port = sam.encode_image(torch.from_numpy(x)).numpy()
        monkeypatch.setattr(oracle, "_tiny_attention", _upstream_tiny_attention)
        upstream = oracle.tiny_vit_encoder(sd, torch.from_numpy(x).permute(0, 3, 1, 2))
    assert rel_err(port, upstream.permute(0, 2, 3, 1).numpy()) <= TOL

    jax_tree = convert_tiny_vit({k: v.numpy() for k, v in sd.items()})
    jax_out = np.asarray(apply_tiny_vit(jax_tree, jnp.asarray(x)))
    assert rel_err(port, jax_out) > 1e-2  # the JAX package reads the qkv rows as thirds

    same = _port_sam(_jax_tree(encoder=jax_tree))  # through the permutation
    assert rel_err(same.encode_image(torch.from_numpy(x)).numpy(), jax_out) <= TOL


def test_slice_matches_jax_predictor(monkeypatch):
    """get_sam_model("vit_t", device="cpu") -> precompute -> predict with one
    point (upstream's single pad point is the JAX bucket of 2), against the
    JAX predictor on the same parameters; the model is cut to 256 px."""
    from micro_sam_tpu.models.sam import Sam as JaxSam
    from micro_sam_tpu.predictor import SamPredictor as JaxPredictor
    from micro_sam_tpu.util import precompute_image_embeddings as jax_precompute
    from micro_sam_tpu.util import set_precomputed as jax_set
    from micro_sam_tpu_torch.models import build_sam
    from micro_sam_tpu_torch.models.convert import params_to_jax
    from micro_sam_tpu_torch.util import (get_sam_model, precompute_image_embeddings,
                                          set_precomputed)
    monkeypatch.setenv("MSAM_TPU_FUSED_TINY", "0")
    monkeypatch.setitem(build_sam.SAM_CONFIGS, "vit_t",
                        dataclasses.replace(build_sam.SAM_CONFIGS["vit_t"], img_size=256))
    pp = get_sam_model("vit_t", device="cpu", seed=3)
    assert pp.device.type == "cpu" and pp.model.config.compute_dtype == "float32"
    assert pp.model.config.encoder == "tiny_vit"
    cfg = _jax_config(256)
    jp = JaxPredictor(JaxSam(cfg, params_to_jax(pp.model.state_dict(), pp.model.config)))
    # at the model's size, so both packages encode the same pixels (their
    # resizes may differ by a grey level)
    image = np.random.RandomState(6).randint(0, 256, size=(256, 256)).astype(np.uint8)
    got = precompute_image_embeddings(pp, image, verbose=False)
    ref = jax_precompute(jp, image, verbose=False)
    assert got["features"].shape == ref["features"].shape == (1, 256, 16, 16)
    assert rel_err(got["features"], ref["features"]) <= TOL
    set_precomputed(pp, got)
    jax_set(jp, ref)
    kw = dict(point_coords=np.array([[120., 80.]]), point_labels=np.array([1]),
              return_logits=True)
    pm, pi, pl = pp.predict(**kw)
    jm, ji, jl = jp.predict(**kw)
    assert pm.shape == jm.shape == (3, 256, 256)
    assert rel_err(pm, jm) <= TOL and rel_err(pl, jl) <= TOL and abs_err(pi, ji) <= TOL


def test_bf16_encoder_stays_near_f32(models):
    """The bf16 model (product weights held in bf16, BN folded in f32 then
    cast) through the plain chains, against the f32 model: the card's bf16
    tolerance, 3e-2 of max."""
    params, sam = models
    bf16 = _port_sam(params, compute_dtype="bfloat16")
    blk = bf16.image_encoder.layers[1].blocks[0]
    assert blk.attn.qkv.weight.dtype == torch.bfloat16 and blk.mlp.fc2.weight.dtype == torch.bfloat16
    assert blk.local_conv.c.weight.dtype == torch.float32
    x = torch.from_numpy(np.random.RandomState(7).rand(1, SIZE, SIZE, 3).astype(np.float32))
    got = bf16.encode_image(x)
    assert got.dtype == torch.bfloat16
    assert rel_err(got.float().numpy(), sam.encode_image(x).numpy()) <= 3e-2


def test_folded_bn_follows_the_parameters():
    """Conv2d_BN keeps its fold until a parameter or statistic changes: an
    in-place write, a state-dict load or a move; not under autograd."""
    from micro_sam_tpu_torch.models.common import Conv2d_BN, fold_bn
    m = Conv2d_BN(8, 16)
    m.c.init_(torch.Generator().manual_seed(0))

    def fresh(dtype=torch.float32):
        s, t = fold_bn(m.bn)
        return (m.c.weight * s.view(-1, 1, 1, 1)).to(dtype), s, t

    with torch.no_grad():
        first = m.folded(torch.float32)
        assert m.folded(torch.float32)[0] is first[0]
        m.bn.running_var.mul_(4.0)
        assert all(torch.equal(a, b) for a, b in zip(m.folded(torch.float32), fresh()))
        m.load_state_dict({k: torch.rand_like(v) + 0.5 for k, v in m.state_dict().items()})
        assert all(torch.equal(a, b) for a, b in zip(m.folded(torch.float32), fresh()))
        half = m.folded(torch.bfloat16)
        assert half[0].dtype == torch.bfloat16 and torch.equal(half[0], fresh(torch.bfloat16)[0])
        m.double()
        assert m.folded(torch.float32)[0] is not first[0]
    assert m.folded(torch.float32)[0].requires_grad


def test_build_sam_vit_t_devices():
    from micro_sam_tpu_torch.models.build_sam import build_sam
    if torch.cuda.is_available():
        sam = build_sam("vit_t")
        assert sam.config.compute_dtype == "bfloat16"
        assert next(sam.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            build_sam("vit_t")  # the default device is the GPU; no silent CPU run
    sam = build_sam("vit_t", device="cpu")
    assert sam.config.compute_dtype == "float32" and sam.config.encoder == "tiny_vit"
    assert sum(p.numel() for p in sam.image_encoder.parameters()) > 5_000_000
