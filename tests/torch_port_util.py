"""Shared set-up for the tests of the PyTorch port (tests/test_torch_*.py):
one set of weights and inputs, made with numpy / the JAX package's init, fed to
both packages."""
import dataclasses

import numpy as np


def tiny_jax_config(img_size=256):
    """The tiny config of tests/conftest.py: 16 x 16 tokens pad to 28 for the
    14 x 14 windows, so the window pad mask is exercised."""
    from micro_sam_tpu.models.sam import SamConfig
    return SamConfig(model_type="vit_b", embed_dim=64, depth=2, num_heads=2,
                     global_attn_indexes=(1,), img_size=img_size)


def jax_params(cfg, seed=0, relpos_std=0.2):
    """Random JAX params; rel-pos tables and pos_embed (zeros at init) get
    numpy noise so that the bias path is exercised."""
    import jax
    import jax.numpy as jnp
    from micro_sam_tpu.models.sam import init_sam_params
    params = init_sam_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.RandomState(seed + 100)
    enc = params["image_encoder"]
    for b in enc["blocks"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            b["attn"][key] = jnp.asarray(
                rng.randn(*b["attn"][key].shape).astype(np.float32) * relpos_std)
    enc["pos_embed"] = jnp.asarray(rng.randn(*enc["pos_embed"].shape).astype(np.float32) * 0.1)
    return params


def port_sam(cfg, params, compute_dtype="float32"):
    """The port's Sam on the CPU with the JAX params' weights."""
    import jax
    from micro_sam_tpu_torch.models.convert import params_from_jax
    from micro_sam_tpu_torch.models.sam import Sam, SamConfig
    pcfg = SamConfig(**{**dataclasses.asdict(cfg), "compute_dtype": compute_dtype})
    sam = Sam(pcfg)
    sam.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), pcfg))
    return sam.eval()


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


def abs_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max())


def jax_block(C, num_heads, input_size, seed=0):
    """A JAX encoder block with random rel-pos tables."""
    import jax
    import jax.numpy as jnp
    from micro_sam_tpu.models.image_encoder import init_block
    bp = init_block(jax.random.PRNGKey(seed), C, num_heads, 4.0, input_size, use_rel_pos=True)
    rng = np.random.RandomState(seed + 1)
    for key in ("rel_pos_h", "rel_pos_w"):
        bp["attn"][key] = jnp.asarray(rng.randn(*bp["attn"][key].shape).astype(np.float32) * 0.2)
    return bp


def port_block(bp, C, num_heads, window_size, input_size):
    """The port's Block holding the weights of JAX block params ``bp``."""
    import torch
    from micro_sam_tpu_torch.models.image_encoder import Block
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    sd = {"norm1.weight": t(bp["norm1"]["scale"]), "norm1.bias": t(bp["norm1"]["bias"]),
          "norm2.weight": t(bp["norm2"]["scale"]), "norm2.bias": t(bp["norm2"]["bias"]),
          "attn.rel_pos_h": t(bp["attn"]["rel_pos_h"]), "attn.rel_pos_w": t(bp["attn"]["rel_pos_w"])}
    for name, p in (("attn.qkv", bp["attn"]["qkv"]), ("attn.proj", bp["attn"]["proj"]),
                    ("mlp.lin1", bp["mlp"]["lin1"]), ("mlp.lin2", bp["mlp"]["lin2"])):
        sd[f"{name}.weight"] = t(np.asarray(p["w"]).T)
        sd[f"{name}.bias"] = t(p["b"])
    blk = Block(C, num_heads, 4.0, window_size, input_size)
    blk.load_state_dict(sd)
    return blk.eval()
