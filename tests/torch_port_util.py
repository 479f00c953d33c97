"""Shared set-up for the tests of the PyTorch port (tests/test_torch_*.py):
one set of weights and inputs, made with numpy / the JAX package's init, fed to
both packages."""
import contextlib
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


def jax_step_loss(cfg, params, batch, prompt_pad: int):
    """The JAX reference of one point round (multimask, n_sub_iteration 1) of
    the port's trainer on a prepared ``batch``, as a function of the params
    (for ``jax.value_and_grad``, the round-0 logits as its aux): composed from
    TrainableSAM, dice_score and the trainer's loss; the point prompt is
    followed by ``prompt_pad`` -1 tokens."""
    import jax
    import jax.numpy as jnp
    from micro_sam_tpu.models.sam import Sam
    from micro_sam_tpu.training.sam_trainer import dice_score
    from micro_sam_tpu.training.trainable_sam import TrainableSAM
    images, gt, valid, points0, labels0, _ = (jnp.asarray(t.numpy()) for t in batch)
    model = TrainableSAM(Sam(cfg, params))
    B, O, S1, S2 = gt.shape
    N = B * O
    scale = cfg.img_size / max(S1, S2)

    def loss_fn(p):
        feats = jnp.repeat(model.image_embeddings_oft(p, images), O, axis=0)
        pts = jnp.concatenate([points0.reshape(N, 1, 2) * scale,
                               jnp.zeros((N, prompt_pad, 2))], 1)
        lbl = jnp.concatenate([labels0.reshape(N, 1), -jnp.ones((N, prompt_pad), jnp.int32)], 1)
        low, iou = model.forward_decoder(p, feats, pts, lbl)
        gt_c = gt.reshape(N, S1, S2)
        up = model.upscale_masks(low, (S1, S2))
        d3 = (1.0 - dice_score(jax.nn.sigmoid(up), gt_c[:, None]))[:, 1:]
        sel = jnp.argmin(d3, axis=1) + 1
        rows = jnp.arange(N)
        up_sel = up[rows, sel]
        inter = jnp.sum((up_sel > 0) & (gt_c > 0.5), axis=(-2, -1), dtype=jnp.float32)
        union = jnp.sum((up_sel > 0) | (gt_c > 0.5), axis=(-2, -1), dtype=jnp.float32)
        actual = jax.lax.stop_gradient(inter / jnp.maximum(union, 1e-7))
        v = valid.reshape(N).astype(jnp.float32)
        per = jnp.min(d3, axis=1) + (iou[rows, sel] - actual) ** 2
        return jnp.sum(per * v) / jnp.maximum(v.sum(), 1), low

    return loss_fn


def jax_box_step_loss(cfg, params, batch):
    """The JAX reference of one box round (single mask, n_sub_iteration 1, no
    mask prompt) of the port's trainer on a prepared ``batch``, as a function
    of the params: the box corners (labels 2, 3) and no padding point, the
    first mask's dice + IoU loss over the valid objects."""
    import jax
    import jax.numpy as jnp
    from micro_sam_tpu.models.sam import Sam
    from micro_sam_tpu.training.sam_trainer import dice_score
    from micro_sam_tpu.training.trainable_sam import TrainableSAM
    images, gt, valid, _, _, boxes0 = (jnp.asarray(t.numpy()) for t in batch)
    model = TrainableSAM(Sam(cfg, params))
    B, O, S1, S2 = gt.shape
    N = B * O
    scale = cfg.img_size / max(S1, S2)

    def loss_fn(p):
        feats = jnp.repeat(model.image_embeddings_oft(p, images), O, axis=0)
        pts = boxes0.reshape(N, 2, 2) * scale
        lbl = jnp.tile(jnp.asarray([[2, 3]], jnp.int32), (N, 1))
        low, iou = model.forward_decoder(p, feats, pts, lbl)
        gt_c = gt.reshape(N, S1, S2)
        up = model.upscale_masks(low[:, :1], (S1, S2))[:, 0]
        d = 1.0 - dice_score(jax.nn.sigmoid(up), gt_c)
        inter = jnp.sum((up > 0) & (gt_c > 0.5), axis=(-2, -1), dtype=jnp.float32)
        union = jnp.sum((up > 0) | (gt_c > 0.5), axis=(-2, -1), dtype=jnp.float32)
        actual = jax.lax.stop_gradient(inter / jnp.maximum(union, 1e-7))
        v = valid.reshape(N).astype(jnp.float32)
        per = d + (iou[:, 0] - actual) ** 2
        return jnp.sum(per * v) / jnp.maximum(v.sum(), 1)

    return loss_fn


# ---------------------------------------------------------------------------
# the UNETR decoder of AIS (tests/test_torch_unetr.py, test_torch_ais.py,
# test_torch_automatic_segmentation.py)
# ---------------------------------------------------------------------------

NARROW_UNETR = (64, 32, 16, 8)
# watershed thresholds that cut the random decoder's maps (noise around 0.5)
# on the tiny config into a few tens of objects
AIS_KW = dict(center_distance_threshold=0.37, boundary_distance_threshold=0.55,
              foreground_threshold=0.385, distance_smoothing=1.0)


def unetr_jax_params(use_conv_transpose, affine=False, seed=1, features=NARROW_UNETR,
                     embed_dim=256):
    """The JAX package's random decoder with random BN statistics and, when
    ``affine``, random affine InstanceNorms in every ConvBlock (numpy leaves)."""
    import jax
    from micro_sam_tpu.models.unetr import init_unetr_decoder
    p = jax.tree.map(np.asarray, init_unetr_decoder(
        jax.random.PRNGKey(seed), embed_dim=embed_dim, out_channels=3, features=features,
        use_conv_transpose=use_conv_transpose))
    rng = np.random.RandomState(seed + 10)
    for i in (1, 2, 3, 4):
        bn = p[f"deconv{i}"]["bn"]
        n = bn["mean"].shape[0]
        bn.update(mean=(0.5 * rng.randn(n)).astype(np.float32),
                  var=(rng.rand(n) + 0.5).astype(np.float32),
                  scale=(1 + 0.2 * rng.randn(n)).astype(np.float32),
                  bias=(0.1 * rng.randn(n)).astype(np.float32))
    if affine:
        for blk in [p["base"], p["decoder_head"]] + list(p["decoder"]["blocks"]):
            for k, n in (("norm1", blk["conv1"]["w"].shape[2]),
                         ("norm2", blk["conv1"]["w"].shape[3])):
                blk[k] = {"scale": (1 + 0.3 * rng.randn(n)).astype(np.float32),
                          "bias": (0.2 * rng.randn(n)).astype(np.float32)}
    return p


def port_unetr(params):
    """The port's decoder holding the JAX pytree's weights (on the CPU)."""
    from micro_sam_tpu_torch.models.convert import unetr_params_from_jax
    from micro_sam_tpu_torch.models.unetr import decoder_from_state
    return decoder_from_state(unetr_params_from_jax(params))


def matched_share(got, ref, iou_min=0.99):
    """(share of ref's objects matched by one of got's at IoU >= iou_min,
    ref's objects)."""
    ids = [i for i in np.unique(ref) if i != 0]
    n = 0
    for i in ids:
        inside = ref == i
        cand, counts = np.unique(got[inside], return_counts=True)
        best = max((c / (inside.sum() + (got == g).sum() - c) for g, c in zip(cand, counts)
                    if g != 0), default=0.0)
        n += int(best >= iou_min)
    return n / max(len(ids), 1), len(ids)


def joint_checkpoint(path, cfg, seed=0):
    """A trainer checkpoint to start joint training from at CI cost, built by
    the port alone: a random Sam of ``cfg`` (seed ``seed``) as the JAX
    pytree under ``model_state``, its config, and a random decoder at
    ``NARROW_UNETR`` widths as the JAX pytree under ``decoder_state``
    (``train_sam`` builds its decoder from the checkpoint's state). Returns
    the path."""
    import dataclasses
    import pickle
    import torch
    from micro_sam_tpu_torch.models.convert import params_to_jax, unetr_params_to_jax
    from micro_sam_tpu_torch.models.sam import Sam, SamConfig
    from micro_sam_tpu_torch.models.unetr import UNETRDecoder
    pcfg = SamConfig(**dataclasses.asdict(cfg))
    sam = Sam(pcfg).init_(torch.Generator().manual_seed(seed))
    dec = UNETRDecoder(features=NARROW_UNETR).init_(torch.Generator().manual_seed(seed + 1))
    state = {"model_state": params_to_jax(sam.state_dict(), pcfg), "model_type": pcfg.model_type,
             "model_config": dataclasses.asdict(pcfg),
             "decoder_state": unetr_params_to_jax(dec.state_dict())}
    with open(path, "wb") as f:
        pickle.dump(state, f)
    return str(path)


@contextlib.contextmanager
def one_thread():
    """torch on one intra-op thread for the block. Tier-1 runs six test
    processes on the machine's cores, and torch's thread pool in each then
    oversubscribes them: a trainer step's many small ops wait on each
    other's threads, which costs such a test many times its time alone
    (ROADMAP.md, Budgets)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
