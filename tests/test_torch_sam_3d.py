"""The port's 3d SAM wrappers against the JAX package, f32 on the CPU.

The tiny config (``tests/torch_port_util.py``) at 128 px, volumes of 2
slices. ``Sam3DWrapper``'s depth adapters are redrawn with numpy (a fresh
adapter is the identity in the port and nearly so in the JAX package) and
carried across by ``params_from_jax``; ``SimpleSam3DWrapper``'s head by
``simple_head_from_jax``. Outputs within rel 1e-4 of max|ref|, the adapters'
gradients within rel 1e-4 of each tensor's max of ``jax.grad``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import jax_params, one_thread, port_sam, rel_err, tiny_jax_config


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: tier-1's six test processes share the
    machine's cores, and small tensors gain nothing from more (ROADMAP.md,
    Budgets)."""
    with one_thread():
        yield


SIZE, DEPTH = 128, 2
TOL = 1e-4


def _cfg():
    return tiny_jax_config(SIZE)


def _volume(seed=0):
    return np.random.RandomState(seed).uniform(0, 255, (1, DEPTH, SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def wrappers():
    """(JAX wrapper, its params with redrawn adapters, the port's wrapper on them)."""
    from micro_sam_tpu.models.sam import Sam as JaxSam
    from micro_sam_tpu.models.sam_3d_wrapper import Sam3DWrapper as JaxWrapper
    from micro_sam_tpu_torch.models.convert import params_from_jax
    from micro_sam_tpu_torch.models.sam_3d_wrapper import Sam3DWrapper
    cfg = _cfg()
    base = jax_params(cfg)
    jw = JaxWrapper(JaxSam(cfg, base), d_size=DEPTH)
    tree = jax.tree.map(np.asarray, jw.params)
    rng = np.random.RandomState(5)
    for bp in tree["image_encoder"]["blocks"]:
        for name in ("adapter_pre", "adapter_post"):
            ad = bp[name]
            ad["depth_conv"]["w"] = (rng.randn(*ad["depth_conv"]["w"].shape) * 0.5).astype(np.float32)
            ad["norm"]["scale"] = (1 + rng.randn(*ad["norm"]["scale"].shape) * 0.2).astype(np.float32)
            ad["norm"]["bias"] = (rng.randn(*ad["norm"]["bias"].shape) * 0.2).astype(np.float32)
            ad["point"]["w"] = (rng.randn(*ad["point"]["w"].shape) * 0.1).astype(np.float32)
    pw = Sam3DWrapper(port_sam(cfg, base), d_size=DEPTH)
    pw.sam.load_state_dict(params_from_jax(tree, pw.config))
    return jw, tree, pw.eval()


def test_sam3d_forward_matches_jax(wrappers):
    """Adapters, blocks, neck and the prompt-less decode: the masks of a
    2-slice volume."""
    jw, tree, pw = wrappers
    vol = _volume()
    ref = np.asarray(jax.jit(jw)(jax.tree.map(jnp.asarray, tree), jnp.asarray(vol)))
    with torch.no_grad():
        got = pw(torch.from_numpy(vol)).numpy()
    assert got.shape == ref.shape == (1, DEPTH, 4, SIZE // 4, SIZE // 4)
    assert rel_err(got, ref) <= TOL


def test_sam3d_adapter_gradients_match_jax(wrappers):
    """The wrapper in autograd (each block train_block: K1 / K4's plain
    versions on the CPU) against jax.grad of the same scalar: every
    adapter tensor of every block."""
    jw, tree, pw = wrappers
    vol = _volume(1)
    w = np.random.RandomState(2).randn(1, DEPTH, 4, SIZE // 4, SIZE // 4).astype(np.float32)
    pw.zero_grad()
    with one_thread():
        (pw(torch.from_numpy(vol)) * torch.from_numpy(w)).sum().backward()
    g = jax.jit(jax.grad(lambda p: jnp.sum(jw(p, jnp.asarray(vol)) * w)))(
        jax.tree.map(jnp.asarray, tree))
    blocks = pw.sam.image_encoder.blocks
    n = 0
    for i, bp in enumerate(g["image_encoder"]["blocks"]):
        for name in ("adapter_pre", "adapter_post"):
            ad, ref = getattr(blocks[i], name), bp[name]
            pairs = [(ad.depth_conv.weight.grad.numpy().transpose(2, 3, 4, 1, 0),
                      ref["depth_conv"]["w"]),
                     (ad.norm.weight.grad.numpy(), ref["norm"]["scale"]),
                     (ad.norm.bias.grad.numpy(), ref["norm"]["bias"]),
                     (ad.point.weight.grad.numpy().T, ref["point"]["w"]),
                     (ad.point.bias.grad.numpy(), ref["point"]["b"])]
            for got, want in pairs:
                assert rel_err(got, np.asarray(want)) <= TOL, (i, name)
                n += 1
    assert n == 2 * 5 * len(blocks)


def test_fresh_adapters_are_the_identity():
    """A fresh port wrapper's encoder equals the bare encoder (its depth
    convolution and point bias start at zero); the JAX package's fresh
    adapter adds its drawn point bias. freeze_encoder leaves the adapters
    trainable and the base frozen."""
    from micro_sam_tpu.models.image_encoder import apply_image_encoder
    from micro_sam_tpu.models.sam import Sam as JaxSam
    from micro_sam_tpu.models.sam import preprocess as jax_preprocess
    from micro_sam_tpu.models.sam_3d_wrapper import Sam3DWrapper as JaxWrapper
    from micro_sam_tpu.models.sam_3d_wrapper import apply_sam_3d_encoder as jax_3d
    from micro_sam_tpu_torch.models.sam import preprocess
    from micro_sam_tpu_torch.models.sam_3d_wrapper import Sam3DWrapper, apply_sam_3d_encoder
    cfg = _cfg()
    base = jax_params(cfg)
    sam = port_sam(cfg, base)
    px = preprocess(torch.from_numpy(_volume(3)[0]), SIZE)
    with torch.no_grad():
        bare = sam.image_encoder(px)
        pw = Sam3DWrapper(sam, d_size=DEPTH, freeze_encoder=True)
        got = apply_sam_3d_encoder(sam.image_encoder, px, DEPTH)
    assert np.abs(got.numpy() - bare.numpy()).max() <= 1e-5
    blk = sam.image_encoder.blocks[0]
    assert blk.adapter_pre.point.weight.requires_grad and not blk.attn.qkv.weight.requires_grad
    assert pw.encoder_frozen
    jw = JaxWrapper(JaxSam(cfg, base), d_size=DEPTH)
    jpx = jax_preprocess(jnp.asarray(_volume(3)[0]), SIZE)
    enc = jw.params["image_encoder"]
    jax_bare = jax.jit(lambda p: apply_image_encoder(
        p, jpx, cfg.num_heads, cfg.window_size, cfg.global_attn_indexes))(base["image_encoder"])
    jax_adapted = jax.jit(lambda p: jax_3d(p, cfg, jpx, DEPTH))(jw.params)
    assert float(jnp.abs(jax_adapted - jax_bare).max()) > 1e-3
    assert float(jnp.abs(enc["blocks"][0]["adapter_pre"]["point"]["b"]).max()) > 0


def test_simple_sam3d_matches_jax():
    """The per-slice encoder and the conv / LN / ReLU head: (1, 2, 8, 8, 3)
    logits of a 2-slice volume, three classes."""
    from micro_sam_tpu.models.sam import Sam as JaxSam
    from micro_sam_tpu.models.sam_3d_wrapper import SimpleSam3DWrapper as JaxSimple
    from micro_sam_tpu_torch.models.sam_3d_wrapper import simple_head_from_jax
    from micro_sam_tpu_torch.models.simple_sam_3d_wrapper import SimpleSam3DWrapper
    cfg = _cfg()
    base = jax_params(cfg)
    jw = JaxSimple(JaxSam(cfg, base), num_classes=3)
    pw = SimpleSam3DWrapper(port_sam(cfg, base), num_classes=3)
    head = simple_head_from_jax(jax.tree.map(np.asarray, jw.decoder_params))
    pw.load_state_dict({**{f"sam.{k}": v for k, v in pw.sam.state_dict().items()}, **head})
    vol = _volume(4)
    ref = np.asarray(jax.jit(jw)(base, jnp.asarray(vol)))
    with torch.no_grad():
        got = pw(torch.from_numpy(vol)).numpy()
    assert got.shape == ref.shape == (1, DEPTH, SIZE // 16, SIZE // 16, 3)
    assert rel_err(got, ref) <= TOL


def test_3d_entry_points(monkeypatch):
    """get_sam_3d_model / get_simple_sam_3d_model build on the CPU with
    device="cpu" (the GPU without it), and run a volume; the reference's
    class surface (ImageEncoderViT3DWrapper, NDBlockWrapper) calls the same
    functions."""
    from micro_sam_tpu_torch.models import build_sam
    from micro_sam_tpu_torch.models.sam import SamConfig, preprocess
    from micro_sam_tpu_torch.models.sam_3d_wrapper import (ImageEncoderViT3DWrapper,
                                                          NDBlockWrapper, apply_sam_3d_encoder,
                                                          get_sam_3d_model,
                                                          get_simple_sam_3d_model)
    monkeypatch.setitem(build_sam.SAM_CONFIGS, "vit_b", SamConfig(**dataclasses.asdict(_cfg())))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            get_sam_3d_model("vit_b")
    model = get_sam_3d_model("vit_b", d_size=DEPTH, device="cpu")
    vol = torch.from_numpy(_volume(6))
    with torch.no_grad():
        masks = model(vol)
        px = preprocess(vol[0], SIZE)
        enc = model.sam.image_encoder
        assert torch.equal(ImageEncoderViT3DWrapper(enc)(px, DEPTH),
                           apply_sam_3d_encoder(enc, px, DEPTH))
        x = enc._patch_embed(px)
        NDBlockWrapper(enc.blocks[0])(x, DEPTH)
    assert masks.shape == (1, DEPTH, 4, SIZE // 4, SIZE // 4) and torch.isfinite(masks).all()
    simple = get_simple_sam_3d_model("vit_b", device="cpu", num_classes=2)
    with torch.no_grad():
        out = simple(vol)
    assert out.shape == (1, DEPTH, SIZE // 16, SIZE // 16, 2) and torch.isfinite(out).all()
