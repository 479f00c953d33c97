"""The port's finetuning path on the CPU against the JAX package.

Inputs come from numpy seeds; the weights of the tiny config go through
``tests/torch_port_util.py``. All f32. The port's trainer grows prompts as
upstream micro-sam does (one padding point, only without a box); its parity
is held against the JAX package's functions composed with the same unpadded
prompts, and ``test_padded_round0_diverges`` pins the difference from the JAX
trainer's fixed-capacity, -1-padded prompt arrays.
"""
import dataclasses
import pickle
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import (jax_params, jax_step_loss, joint_checkpoint, one_thread, port_sam,
                             rel_err)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: tier-1's six test processes share the
    machine's cores, and small tensors gain nothing from more (ROADMAP.md,
    Budgets)."""
    with one_thread():
        yield


def _cfg(img_size=128):
    from micro_sam_tpu.models.sam import SamConfig
    return SamConfig(model_type="vit_b", embed_dim=64, depth=2, num_heads=2,
                     global_attn_indexes=(1,), img_size=img_size)


def _batch(n_images=2, size=64, seed=0):
    from micro_sam_tpu.sample_data import synthetic_data
    imgs, segs = [], []
    for b in range(n_images):
        image, seg = synthetic_data(shape=(size, size), seed=seed + b, n_objects=4,
                                    radius_range=(5, 9))
        imgs.append(np.repeat(image[..., None], 3, axis=-1).astype(np.float32))
        segs.append(seg)
    return np.stack(imgs), np.stack(segs)


def _port_trainable(cfg, params):
    from micro_sam_tpu_torch.models.sam import Sam, SamConfig
    from micro_sam_tpu_torch.training.trainable_sam import TrainableSAM
    sam = Sam(SamConfig(**dataclasses.asdict(cfg)), torch.float32)
    sam.load_state_dict(port_sam(cfg, params).state_dict())
    return TrainableSAM(sam)


# ---------------------------------------------------------------------------
# host-side data: the same arrays for the same seeds
# ---------------------------------------------------------------------------

def test_host_helpers_match_jax():
    from micro_sam_tpu import native, sample_data, util as jutil
    from micro_sam_tpu_torch import sample_data as psd, util as putil
    from micro_sam_tpu_torch.training.training import relabel_consecutive
    for shape, seed in (((96, 128), 3), ((20, 40, 40), 1)):
        for a, b in zip(sample_data.synthetic_data(shape, seed=seed), psd.synthetic_data(shape, seed=seed)):
            np.testing.assert_array_equal(a, b)
    seg = sample_data.synthetic_data((96, 96), seed=4)[1] * 3
    assert jutil.get_centers_and_bounding_boxes(seg) == putil.get_centers_and_bounding_boxes(seg)
    for a, b in zip(native.relabel_consecutive(seg), relabel_consecutive(seg)):
        np.testing.assert_array_equal(a, b) if isinstance(a, np.ndarray) else None
        assert not isinstance(a, np.ndarray) or a.dtype == b.dtype
    assert native.relabel_consecutive(seg)[1:] == relabel_consecutive(seg)[1:]


@pytest.mark.parametrize("n_pos,n_neg", [(1, 0), (2, 3)])
def test_prompt_generator_matches_jax(n_pos, n_neg):
    from micro_sam_tpu.prompt_generators import PointAndBoxPromptGenerator as J
    from micro_sam_tpu_torch.prompt_generators import PointAndBoxPromptGenerator as P
    from micro_sam_tpu_torch.util import get_centers_and_bounding_boxes
    _, segs = _batch(1, 96, seed=7)
    seg = segs[0]
    ids = np.unique(seg)[1:]
    centers, boxes = get_centers_and_bounding_boxes(seg)
    masks = np.stack([seg == i for i in ids])[:, None].astype(np.float32)
    bb = [(boxes[i][0][0], boxes[i][1][0], boxes[i][0][1], boxes[i][1][1]) for i in ids]
    cc = [centers[i] for i in ids]
    outs = [G(n_pos, n_neg, 4, get_box_prompts=True, rng=np.random.RandomState(11))(masks, bb, cc)
            for G in (J, P)]
    for a, b in zip(outs[0][:3], outs[1][:3]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("points,boxes,n_neg", [(True, False, 0), (False, True, 0), (True, True, 2)])
def test_convert_to_sam_inputs_matches_jax(points, boxes, n_neg):
    from micro_sam_tpu.training.util import ConvertToSamInputs as J
    from micro_sam_tpu_torch.training.util import ConvertToSamInputs as P
    x, y = _batch(2, 96, seed=1)
    seeds = [123, 456]
    kw = dict(n_objects=3, n_pos=1, n_neg=n_neg, get_points=points, get_boxes=boxes,
              sample_seeds=seeds)
    ref = J()(x, y, **kw)
    got = P()(x, y, **kw)
    assert all(isinstance(t, torch.Tensor) for t in got)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_dataset_and_loader_match_jax():
    from micro_sam_tpu.training.training import SamDataset as JD, SamLoader as JL
    from micro_sam_tpu_torch.training.training import SamDataset as PD, SamLoader as PL
    from micro_sam_tpu.sample_data import synthetic_data
    images = [synthetic_data((200, 160), seed=s) for s in (5, 6)]
    kw = dict(patch_shape=(96, 96), n_samples=4, seed=3)
    ref = list(JL(JD([i for i, _ in images], [s for _, s in images], **kw), batch_size=2))
    got = list(PL(PD([i for i, _ in images], [s for _, s in images], **kw), batch_size=2))
    assert len(ref) == len(got) == 2
    for (ra, rb), (ga, gb) in zip(ref, got):
        np.testing.assert_array_equal(ra, ga)
        np.testing.assert_array_equal(rb, gb)


# ---------------------------------------------------------------------------
# the trainer's pieces
# ---------------------------------------------------------------------------

def test_gumbel_pick_ring_dice_and_boxes_match_jax():
    from micro_sam_tpu.ops.amg_utils import batched_mask_to_box as jbox
    from micro_sam_tpu.training import sam_trainer as js
    from micro_sam_tpu_torch.ops.amg_utils import batched_mask_to_box as pbox
    from micro_sam_tpu_torch.training import sam_trainer as ps
    rng = np.random.RandomState(2)
    N, H, W = 5, 24, 32
    gt = np.zeros((N, H, W), np.float32)
    for n in range(N - 1):  # the last mask stays empty
        y0, x0 = rng.randint(0, 12), rng.randint(0, 16)
        gt[n, y0:y0 + rng.randint(2, 12), x0:x0 + rng.randint(2, 16)] = 1
    pred = rng.rand(N, H, W) > 0.7
    a, b = (gt > 0) & ~pred, pred & ~(gt > 0)
    key = jax.random.PRNGKey(9)
    ref = js._gumbel_pick2(key, jnp.asarray(a), jnp.asarray(b))
    field = torch.from_numpy(np.array(jax.random.gumbel(key, (N, H * W))))
    got = ps._gumbel_pick2(field, torch.from_numpy(a), torch.from_numpy(b))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())
    np.testing.assert_array_equal(np.asarray(jbox(jnp.asarray(gt))), pbox(torch.from_numpy(gt)).numpy())
    np.testing.assert_array_equal(np.asarray(js._bbox_ring(jnp.asarray(gt))),
                                  ps._bbox_ring(torch.from_numpy(gt)).numpy())
    sig = rng.rand(N, H, W).astype(np.float32)
    np.testing.assert_allclose(ps.dice_score(torch.from_numpy(sig), torch.from_numpy(gt)).numpy(),
                               np.asarray(js.dice_score(jnp.asarray(sig), jnp.asarray(gt))),
                               rtol=1e-6)


@pytest.mark.parametrize("src,dst", [(512, 1024), (256, 512), (64, 128)])
def test_bilinear_resize_matches_jax_image_resize(src, dst):
    """The resize (two products with fixed weights) equals jax.image.resize
    for the trainer's upsamplings (patch -> model input, low-res logits ->
    patch)."""
    from micro_sam_tpu_torch.training.trainable_sam import resize_bilinear
    x = np.random.RandomState(src).randn(2, 3, src, src).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, 3, dst, dst), method="bilinear")
    assert rel_err(resize_bilinear(torch.from_numpy(x), (dst, dst)), ref) <= 1e-6


@pytest.mark.parametrize("src,dst,layout", [(32, 128, "nchw"), (128, 64, "nchw"),
                                             (100, 37, "nchw"), (37, 100, "nchw"),
                                             (20, 40, "nhwc"), (48, 20, "nhwc")])
def test_resize_rewrite_matches_jax_both_ways(src, dst, layout):
    """``resize_bilinear`` (NCHW) and ``resize_bilinear_hwc`` (NHWC), up and
    down (antialiased), against jax.image.resize forward and its VJP (rel
    1e-5: both compute the weights in float32, the sample positions rounded
    apart at odd ratios): the backward is the transposed products."""
    from micro_sam_tpu_torch.models.common import resize_bilinear, resize_bilinear_hwc
    rng = np.random.RandomState(src + dst)
    shape = (2, 3, src, src + 5) if layout == "nchw" else (2, src, src + 5, 3)
    out = (dst, dst + 3)
    x = rng.randn(*shape).astype(np.float32)
    full = shape[:2] + out if layout == "nchw" else (shape[0],) + out + (shape[-1],)
    g = rng.randn(*full).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: jax.image.resize(a, full, method="bilinear"), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = (resize_bilinear if layout == "nchw" else resize_bilinear_hwc)(xt, out)
    got.backward(torch.from_numpy(g))
    assert rel_err(got.detach(), ref) <= 1e-5
    assert rel_err(xt.grad, vjp(jnp.asarray(g))[0]) <= 1e-5


@pytest.mark.parametrize("kind", ["transposed", "2x2_stride2", "1x1", "3x3_stride1",
                                  "1x1_stride1"])
def test_conv_rewrites_match_jax(kind):
    """The forms whose backward replaces cuDNN's: ``conv_transpose2d``
    (kernel == stride: one product and a pixel shuffle; the mask decoder's
    upscaling, the UNETR's deconvolutions), ``conv2d_product`` (kernel ==
    stride: the prompt encoder's mask convolutions; and 1 x 1) and
    ``conv2d_nchw`` (stride 1, NCHW, ``RepeatableConv2d``: the neck's 1 x 1
    and 3 x 3, the UNETR's convolutions) against the JAX package's
    ``conv_transpose2d`` / ``conv2d``, forward and VJP, f32 rel 1e-5."""
    import micro_sam_tpu.models.common as jc
    from micro_sam_tpu_torch.models.common import conv2d_nchw, conv2d_product, conv_transpose2d
    rng = np.random.RandomState(7)
    x = rng.randn(2, 8, 10, 16).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    if kind == "transposed":
        wj = rng.randn(2, 2, 12, 16).astype(np.float32)          # (kh, kw, out, in)
        fj = lambda xx, ww, bb: jc.conv_transpose2d({"w": ww, "b": bb}, xx, 2)  # noqa: E731
        wt = torch.from_numpy(wj.transpose(3, 2, 0, 1).copy())    # (in, out, kh, kw)
        fp = lambda xx, ww, bb: conv_transpose2d(xx, ww, bb, 2)   # noqa: E731
    else:
        k, stride, pad = {"2x2_stride2": (2, 2, 0), "1x1": (1, 1, 0), "3x3_stride1": (3, 1, 1),
                          "1x1_stride1": (1, 1, 0)}[kind]
        wj = rng.randn(k, k, 16, 12).astype(np.float32)            # HWIO
        fj = lambda xx, ww, bb: jc.conv2d({"w": ww, "b": bb}, xx, stride, pad)  # noqa: E731
        wt = torch.from_numpy(wj.transpose(3, 2, 0, 1).copy())    # (out, in, kh, kw)
        if kind.endswith("stride1"):
            def fp(xx, ww, bb):
                y = conv2d_nchw(xx.permute(0, 3, 1, 2), ww, bb, pad)
                return y.permute(0, 2, 3, 1)
        else:
            def fp(xx, ww, bb):
                return conv2d_product(xx, ww, bb, stride)
    ref, vjp = jax.vjp(fj, jnp.asarray(x), jnp.asarray(wj), jnp.asarray(b))
    g = rng.randn(*ref.shape).astype(np.float32)
    dx, dw, db = vjp(jnp.asarray(g))
    xt, bt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(b).requires_grad_()
    wt.requires_grad_()
    got = fp(xt, wt, bt)
    got.backward(torch.from_numpy(g))
    assert rel_err(got.detach(), ref) <= 1e-5
    assert rel_err(xt.grad, dx) <= 1e-5 and rel_err(bt.grad, db) <= 1e-5
    perm = (3, 2, 0, 1)
    assert rel_err(wt.grad, np.asarray(dw).transpose(perm)) <= 1e-5


def test_adamw_matches_optax():
    """make_optimizer: torch AdamW with optax.adamw's defaults (weight decay
    1e-4, not torch's 1e-2) over 3 steps on the same gradients."""
    import optax
    from micro_sam_tpu_torch.training.sam_trainer import make_optimizer
    rng = np.random.RandomState(0)
    w0 = rng.randn(4, 5).astype(np.float32) * 0.02
    grads = [rng.randn(4, 5).astype(np.float32) for _ in range(3)]

    class M:  # the trainable-model surface make_optimizer reads
        sam = torch.nn.Linear(5, 4, bias=False)
    with torch.no_grad():
        M.sam.weight.copy_(torch.from_numpy(w0))
    opt = make_optimizer(M, lr=1e-3)
    tx = optax.adamw(1e-3)
    p, state = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    for g in grads:
        M.sam.weight.grad = torch.from_numpy(g)
        opt.step()
        upd, state = tx.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, upd)
    np.testing.assert_allclose(M.sam.weight.detach().numpy(), np.asarray(p), rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# one whole step, and the padded prompts of the JAX trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_case():
    """The port's trainer at n_sub_iteration 1 on a 2-image batch, and the JAX
    reference's loss, gradients and round-0 logits for the same prompts."""
    from micro_sam_tpu_torch.training.sam_trainer import SamTrainer
    cfg = _cfg()
    params = jax_params(cfg, seed=2)
    model = _port_trainable(cfg, params)
    x, y = _batch(2, 64, seed=20)
    trainer = SamTrainer("step", [(x, y)], [(x, y)], model, n_sub_iteration=1,
                         n_objects_per_batch=3, logger=False)
    batch = trainer._prepare_batch(x, y, True, False, 1, 0)
    (loss, low), grads = jax.jit(jax.value_and_grad(jax_step_loss(cfg, params, batch, 1),
                                                    has_aux=True))(params)
    return dict(cfg=cfg, params=params, model=model, trainer=trainer, batch=batch,
                ref_loss=float(loss), ref_grads=jax.tree.map(np.asarray, grads),
                ref_low=np.asarray(low))


def test_train_step_matches_jax_reference(step_case):
    """One point step (n_sub_iteration 1, multimask): loss rel 1e-5, every
    parameter gradient rel <= 1e-3 of its max, against the JAX reference with
    the same unpadded prompts (the point and one padding point). The key
    biases of the decoder's attention have a zero gradient (a key bias shifts
    all logits of a query alike): there both sides are float noise, held
    below 1e-6 of the largest gradient."""
    from micro_sam_tpu_torch.models.convert import params_from_jax
    c = step_case
    model = c["model"]
    model.sam.zero_grad(set_to_none=True)
    loss, _ = c["trainer"]._loss(*c["batch"], True, False, True)
    loss.backward()
    assert abs(float(loss.detach()) - c["ref_loss"]) <= 1e-5 * abs(c["ref_loss"])
    g_sd = params_from_jax(c["ref_grads"], c["cfg"])
    g_max = max(float(g.abs().max()) for g in g_sd.values())
    n = 0
    for name, p in model.sam.named_parameters():
        want = g_sd[name]
        got = torch.zeros_like(p) if p.grad is None else p.grad  # the unused mask path
        if float(want.abs().max()) <= 1e-7 * g_max:
            assert float(got.abs().max()) <= 1e-6 * g_max, name
            continue
        assert rel_err(got, want) <= 1e-3, name
        n += 1
    assert n >= 130  # all but the mask path and the zero-by-symmetry ones


def test_padded_round0_diverges(step_case):
    """The JAX trainer's round 0 carries 2 * 8 + 1 = 17 label -1 slots after
    the point (n_sub_iteration 8); upstream, and the port, one. The extra
    tokens take part in the decoder's attention: the logits move by far more
    than the parity tolerance, while the port's round-0 decode equals the JAX
    decode of the unpadded prompts."""
    c = step_case
    batch, model = c["batch"], c["model"]
    padded = np.asarray(jax.jit(jax_step_loss(c["cfg"], c["params"], batch, 17))(c["params"])[1])
    B, O = batch[1].shape[:2]
    scale = c["cfg"].img_size / batch[1].shape[-1]
    with torch.no_grad():
        feats = model.image_embeddings_oft(batch[0]).repeat_interleave(O, 0)
        pts = torch.cat([batch[3].reshape(B * O, 1, 2) * scale, torch.zeros(B * O, 1, 2)], 1)
        lbl = torch.cat([batch[4].reshape(B * O, 1).long(), -torch.ones(B * O, 1).long()], 1)
        port_low, _ = model.forward_decoder(feats, pts, lbl)
    assert rel_err(port_low, c["ref_low"]) <= 1e-4
    assert rel_err(padded, c["ref_low"]) >= 1e-2


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def test_fit_checkpoint_loads_in_both_packages(tmp_path):
    """SamTrainer.fit(iterations=2) writes best.pkl in the JAX trainer's
    format: micro_sam_tpu.util.get_sam_model and the port's both load it and
    give the same embedding (rel <= 1e-4); the weights moved."""
    from micro_sam_tpu.util import get_sam_model as jax_get
    from micro_sam_tpu_torch.training.sam_trainer import SamTrainer
    from micro_sam_tpu_torch.util import get_sam_model
    cfg = _cfg()
    params = jax_params(cfg, seed=3)
    model = _port_trainable(cfg, params)
    x, y = _batch(1, 64, seed=30)
    trainer = SamTrainer("rt", [(x, y), (x, y)], [(x, y)], model, n_sub_iteration=2,
                         n_objects_per_batch=2, save_root=str(tmp_path), lr=1e-3, logger=False)
    before = model.sam.mask_decoder.iou_token.weight.detach().clone()
    trainer.fit(iterations=2, verbose=False)
    assert trainer._iteration == 2
    assert not torch.equal(before, model.sam.mask_decoder.iou_token.weight)
    path = str(tmp_path / "rt" / "best.pkl")
    jp = jax_get(model_type="vit_b", checkpoint_path=path, compute_dtype="float32")
    pp = get_sam_model("vit_b", device="cpu", checkpoint_path=path)
    assert pp.model.config.embed_dim == 64 and jp.model.config.embed_dim == 64
    img = np.random.RandomState(0).randint(0, 255, (128, 128, 3)).astype(np.uint8)
    jp.set_image(img)
    pp.set_image(img)
    assert rel_err(pp.get_image_embedding(), np.asarray(jp.get_image_embedding())) <= 1e-4
    want = model.sam.mask_decoder.iou_token.weight.detach().clone()
    assert torch.equal(pp.model.mask_decoder.iou_token.weight, want)
    with torch.no_grad():  # the trainer reloads its own checkpoint
        model.sam.mask_decoder.iou_token.weight.zero_()
    state = trainer.load_checkpoint("latest")
    assert state["iteration"] == 2 and torch.equal(model.sam.mask_decoder.iou_token.weight, want)


def test_train_sam_on_the_cpu(tmp_path, monkeypatch):
    """train_sam end to end with device="cpu" at the tiny geometry, with the
    segmentation decoder (the joint trainer, a loader with targets) and
    without; without a GPU device=None raises."""
    from micro_sam_tpu_torch.models import build_sam
    from micro_sam_tpu_torch.models.sam import SamConfig
    from micro_sam_tpu_torch.training import get_trainable_sam_model, train_sam
    from micro_sam_tpu_torch.training.training import SamDataset, SamLoader
    from micro_sam_tpu_torch.sample_data import synthetic_data
    monkeypatch.setitem(build_sam.SAM_CONFIGS, "vit_b", SamConfig(**dataclasses.asdict(_cfg())))
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # no logger, as on the card
    image, seg = synthetic_data((160, 160), seed=9)
    loader = SamLoader(SamDataset([image], [seg], (96, 96), n_samples=2), batch_size=1)
    joint = SamLoader(SamDataset([image], [seg], (96, 96), n_samples=2,
                                 with_segmentation_decoder=True), batch_size=1)
    with pytest.raises(ValueError, match="distance_targets"):
        train_sam("joint", "vit_b", loader, loader, with_segmentation_decoder=True, device="cpu")
    with one_thread():
        train_sam("joint", "vit_b", joint, joint, with_segmentation_decoder=True, n_iterations=1,
                  n_sub_iteration=2, n_objects_per_batch=2, device="cpu",
                  save_root=str(tmp_path),
                  checkpoint_path=joint_checkpoint(tmp_path / "start.pkl", _cfg()))
    with open(tmp_path / "joint" / "best.pkl", "rb") as f:
        assert "deconv1" in pickle.load(f)["decoder_state"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            get_trainable_sam_model("vit_b")
    train_sam("cpu", "vit_b", loader, loader, with_segmentation_decoder=False, n_iterations=2,
              n_sub_iteration=2, n_objects_per_batch=2, device="cpu", save_root=str(tmp_path))
    assert (tmp_path / "cpu" / "best.pkl").exists() and (tmp_path / "cpu" / "latest.pkl").exists()
    model = get_trainable_sam_model("vit_b", device="cpu", freeze=["image_encoder"])
    assert all(p.dtype == torch.float32 for p in model.sam.parameters())
    assert not any(p.requires_grad for p in model.sam.image_encoder.parameters())
