"""The port's ViT image encoder against the JAX package and the golden fixtures.

f32 on the CPU. Helpers: abs <= 5e-5; whole encoder: rel <= 1e-4 of max|ref|;
golden fixtures (written by an independent torch oracle): rel < 1e-3, the
bound tests/test_golden.py holds the JAX package to.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import (abs_err, jax_block, jax_params, port_block, port_sam,
                                   rel_err, tiny_jax_config)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.mark.parametrize("q,k,L", [(14, 14, 27), (16, 16, 27), (8, 16, 31), (16, 8, 31)],
                         ids=["native", "interp", "q<k", "q>k"])
def test_get_rel_pos_matches_jax(q, k, L):
    from micro_sam_tpu.models.image_encoder import get_rel_pos as jax_get
    from micro_sam_tpu_torch.models.image_encoder import get_rel_pos
    table = np.random.RandomState(L).randn(L, 8).astype(np.float32)
    ref = np.asarray(jax_get(q, k, jnp.asarray(table)))
    got = get_rel_pos(q, k, torch.from_numpy(table)).numpy()
    assert abs_err(got, ref) < 5e-5


def test_window_partition_with_padding_matches_jax():
    from micro_sam_tpu.models.image_encoder import window_partition as jp, window_unpartition as ju
    from micro_sam_tpu_torch.models.image_encoder import window_partition, window_unpartition
    x = np.random.RandomState(0).randn(2, 16, 18, 5).astype(np.float32)
    ref, pad_ref = jp(jnp.asarray(x), 7)
    got, pad = window_partition(torch.from_numpy(x), 7)
    assert pad == tuple(pad_ref) == (21, 21)
    assert abs_err(got.numpy(), np.asarray(ref)) == 0.0
    back = window_unpartition(got, 7, pad, (16, 18)).numpy()
    assert abs_err(back, np.asarray(ju(ref, 7, pad_ref, (16, 18)))) == 0.0
    assert abs_err(back, x) == 0.0


@pytest.mark.parametrize("window", [7, 0], ids=["windowed_padded", "global"])
def test_apply_block_matches_jax(window):
    from micro_sam_tpu.models.image_encoder import apply_block as jax_apply_block
    from micro_sam_tpu_torch.models.image_encoder import apply_block
    C, nH, H = 32, 2, 10  # 10 pads to 14 for 7 x 7 windows
    size = (window, window) if window else (H, H)
    bp = jax_block(C, nH, size, seed=7)
    x = np.random.RandomState(8).randn(2, H, H, C).astype(np.float32)
    ref = np.asarray(jax_apply_block(bp, jnp.asarray(x), nH, window))
    with torch.no_grad():
        got = apply_block(port_block(bp, C, nH, window, size), torch.from_numpy(x)).numpy()
    assert abs_err(got, ref) < 5e-5


def test_encoder_matches_jax_tiny():
    """Tiny config: 16 x 16 tokens pad to 28 for the 14 x 14 windows (pad mask)."""
    from micro_sam_tpu.models.sam import Sam as JaxSam, preprocess as jax_pre
    from micro_sam_tpu_torch.models.sam import preprocess
    cfg = tiny_jax_config()
    params = jax_params(cfg)
    img = (np.random.RandomState(0).rand(2, 256, 256, 3) * 255).astype(np.float32)
    ref = np.asarray(JaxSam(cfg, params).encode_image(params, jax_pre(jnp.asarray(img), 256)))
    got = port_sam(cfg, params).encode_image(preprocess(torch.from_numpy(img), 256)).numpy()
    assert rel_err(got, ref) <= 1e-4


def _golden_embedding(make_cfg, make_params, image, fixture):
    from micro_sam_tpu_torch.models.sam import preprocess
    cfg = make_cfg()
    sam = port_sam(cfg, make_params())
    got = sam.encode_image(preprocess(torch.from_numpy(image), cfg.img_size)).numpy()
    ref = np.load(os.path.join(FIXTURES, fixture))["embedding"].astype(np.float32)
    return rel_err(got, ref)


def test_golden_vit_b224_embedding():
    from tests.make_golden import build_config, build_params, fixed_inputs
    image, _, _ = fixed_inputs(build_config())
    assert _golden_embedding(build_config, build_params, image, "golden_vit_b224.npz") < 1e-3


def test_golden_relpos_interp_embedding():
    """Global rel-pos tables shorter than 2 * tokens - 1: both interpolate."""
    from tests.make_golden import build_interp_config, build_interp_params, fixed_image
    image = fixed_image(build_interp_config().img_size, 448)
    assert _golden_embedding(build_interp_config, build_interp_params, image,
                             "golden_relpos_interp.npz") < 1e-3


@pytest.mark.slow
def test_golden_vit_b1024_embedding():
    from tests.make_golden import build_config_1024, build_params_1024, fixed_inputs_1024
    image, _, _ = fixed_inputs_1024(build_config_1024())
    assert _golden_embedding(build_config_1024, build_params_1024, image,
                             "golden_vit_b1024.npz") < 1e-3


def test_rel_tables_follow_the_parameters():
    """The kept (rel_h, rel_w) pair is rebuilt after an in-place write and a
    state-dict load, and is not kept under autograd."""
    from micro_sam_tpu_torch.models.image_encoder import Attention, get_rel_pos
    attn = Attention(16, 2, (7, 7))
    attn.init_(torch.Generator().manual_seed(0))

    def fresh():
        return get_rel_pos(7, 7, attn.rel_pos_h), get_rel_pos(7, 7, attn.rel_pos_w)

    with torch.no_grad():
        first = attn.rel_tables((7, 7), torch.float32)
        assert attn.rel_tables((7, 7), torch.float32)[0] is first[0]
        attn.rel_pos_h.mul_(2.0)
        got = attn.rel_tables((7, 7), torch.float32)
        assert all(torch.equal(g, r) for g, r in zip(got, fresh()))
        sd = {k: torch.randn_like(v) for k, v in attn.state_dict().items()}
        attn.load_state_dict(sd)
        got = attn.rel_tables((7, 7), torch.float32)
        assert all(torch.equal(g, r) for g, r in zip(got, fresh()))
        half = attn.rel_tables((7, 7), torch.bfloat16)
        assert half[0].dtype == torch.bfloat16 and torch.equal(half[0], fresh()[0].bfloat16())
    assert attn.rel_tables((7, 7), torch.float32)[0].requires_grad


def test_bf16_model_holds_rounded_block_weights():
    """The same seed gives a bf16 model whose block product weights are the
    bf16 rounding of the f32 model's, and every other parameter equal."""
    from micro_sam_tpu_torch.models.sam import Sam, SamConfig
    cfg = dict(embed_dim=64, depth=2, num_heads=2, global_attn_indexes=(1,), img_size=256)
    f32 = Sam(SamConfig(**cfg)).init_(torch.Generator().manual_seed(5)).state_dict()
    bf16 = Sam(SamConfig(**cfg, compute_dtype="bfloat16")).init_(
        torch.Generator().manual_seed(5)).state_dict()
    held = [k for k, v in bf16.items() if v.dtype == torch.bfloat16]
    assert len(held) == 2 * 4 and all(k.endswith((".qkv.weight", ".proj.weight", ".lin1.weight",
                                                  ".lin2.weight")) for k in held)
    for k, v in f32.items():
        assert torch.equal(bf16[k], v.to(bf16[k].dtype)), k


def test_build_sam_defaults_to_the_card():
    from micro_sam_tpu_torch.models.build_sam import build_sam
    if torch.cuda.is_available():
        sam = build_sam("vit_b")
        assert sam.config.compute_dtype == "bfloat16"
        assert next(sam.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            build_sam("vit_b")  # the default device is the GPU; no silent CPU run
    sam = build_sam("vit_b", device="cpu")
    assert sam.config.compute_dtype == "float32"
    assert next(sam.parameters()).device.type == "cpu"
