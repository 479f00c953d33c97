"""vit_h / vit_l finetuning in the port against the JAX package, on the CPU.

The GPU preset ("A100": vit_h, 25 objects) and its entry points
(``train_sam_for_configuration``, ``default_sam_loader``), one training step
of a vit_h-class model (heads of 80, windowed and global blocks, a padded
window), and ``flash_attention_rel_pos`` / ``attention_with_rel_pos`` (the
split-layout entry of the rel-pos attention). The same numpy inputs go through
both packages; f32 throughout. Tolerances: the step's loss rel 1e-5 and every
gradient rel 1e-3 of its max (as tests/test_torch_training.py); the attention
and its gradients rel 2e-5 of each tensor's max (as
tests/test_torch_backward.py).
"""
import dataclasses
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (jax_params, jax_step_loss, joint_checkpoint, one_thread, port_sam,
                             rel_err)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: tier-1's six test processes share the
    machine's cores, and small tensors gain nothing from more (ROADMAP.md,
    Budgets)."""
    with one_thread():
        yield


def _vit_h_class(img_size=128):
    """vit_h's head dim (80) at a CI width: 160 wide, 2 heads, a windowed and
    a global block; at 128 px the 8 x 8 tokens pad to 14 for the 14 x 14
    window."""
    from micro_sam_tpu.models.sam import SamConfig
    return SamConfig(model_type="vit_h", embed_dim=160, depth=2, num_heads=2,
                     global_attn_indexes=(1,), img_size=img_size)


def _images(n, size=192, seed=0):
    """8-bit images of small disks (about 40 in a 128 x 128 patch) and their
    instance segmentations."""
    from micro_sam_tpu.sample_data import synthetic_data
    data = [synthetic_data((size, size), radius_range=(4, 6), n_objects=80, seed=seed + i)
            for i in range(n)]
    return [d[0] for d in data], [d[1] for d in data]


def test_train_step_vit_h_class_matches_jax():
    """One point step (n_sub_iteration 1, multimask) of a vit_h-class model
    against the JAX reference with the same prompts: loss rel 1e-5, every
    parameter gradient rel 1e-3 of its max; the decoder's key biases (zero by
    symmetry) below 1e-6 of the largest gradient."""
    from micro_sam_tpu_torch.models.convert import params_from_jax
    from micro_sam_tpu_torch.models.sam import Sam, SamConfig
    from micro_sam_tpu_torch.training.sam_trainer import SamTrainer
    from micro_sam_tpu_torch.training.trainable_sam import TrainableSAM
    cfg = _vit_h_class()
    params = jax_params(cfg, seed=6)
    sam = Sam(SamConfig(**dataclasses.asdict(cfg)), torch.float32)
    sam.load_state_dict(port_sam(cfg, params).state_dict())
    assert sam.image_encoder.blocks[0].attn.rel_pos_h.shape[-1] == 80
    model = TrainableSAM(sam)
    imgs, segs = _images(2, size=64, seed=40)
    x = np.stack([np.repeat(i[..., None], 3, -1) for i in imgs]).astype(np.float32)
    y = np.stack(segs)
    trainer = SamTrainer("step_h", None, None, model, n_sub_iteration=1, n_objects_per_batch=3,
                         logger=False)
    batch = trainer._prepare_batch(x, y, True, False, 1, 0)
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(jax_step_loss(cfg, params, batch, 1),
                                                          has_aux=True))(params)
    loss, _ = trainer._loss(*batch, True, False, True)
    loss.backward()
    assert abs(float(loss.detach()) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    g_sd = params_from_jax(jax.tree.map(np.asarray, ref_grads), cfg)
    g_max = max(float(g.abs().max()) for g in g_sd.values())
    n = 0
    for name, p in model.sam.named_parameters():
        want = g_sd[name]
        got = torch.zeros_like(p) if p.grad is None else p.grad
        if float(want.abs().max()) <= 1e-7 * g_max:
            assert float(got.abs().max()) <= 1e-6 * g_max, name
            continue
        assert rel_err(got, want) <= 1e-3, name
        n += 1
    assert n >= 130


def test_configurations_match_jax():
    from micro_sam_tpu.training.training import CONFIGURATIONS as JAX_CONFIGURATIONS
    from micro_sam_tpu_torch.training import CONFIGURATIONS
    assert CONFIGURATIONS == JAX_CONFIGURATIONS
    assert CONFIGURATIONS["A100"] == {"model_type": "vit_h", "n_objects_per_batch": 25}


@pytest.mark.parametrize("gpu,want", [(True, "A100"), (False, "CPU")])
def test_find_best_configuration(monkeypatch, gpu, want):
    from micro_sam_tpu_torch.training.training import _find_best_configuration
    monkeypatch.setattr(torch.cuda, "is_available", lambda: gpu)
    assert _find_best_configuration() == want


def test_train_sam_for_configuration_arguments(monkeypatch):
    """The preset's settings, overridden by keyword arguments and by
    ``model_type``; an unknown preset raises."""
    from micro_sam_tpu_torch.training import training
    seen = []
    monkeypatch.setattr(training, "train_sam", lambda **kw: seen.append(kw))
    training.train_sam_for_configuration("a", "A100", "tl", "vl")
    training.train_sam_for_configuration("b", "A100", "tl", "vl", model_type="vit_l_lm",
                                         n_objects_per_batch=5, with_segmentation_decoder=False)
    training.train_sam_for_configuration("c", "Minimal", "tl", "vl")
    assert [(s["model_type"], s["n_objects_per_batch"]) for s in seen] == [
        ("vit_h", 25), ("vit_l_lm", 5), ("vit_t", 4)]
    assert seen[0]["with_segmentation_decoder"] and not seen[1]["with_segmentation_decoder"]
    assert seen[2]["n_sub_iteration"] == 4 and seen[0]["train_loader"] == "tl"
    with pytest.raises(ValueError, match="Invalid configuration"):
        training.train_sam_for_configuration("d", "TPUv9", "tl", "vl")


def _write_sources(kind, imgs, segs, tmp_path):
    """(raw_paths, raw_key, label_paths, label_key) for ``default_sam_loader``:
    the arrays themselves, one HDF5 file per image, or a directory of tifs."""
    if kind == "arrays":
        return imgs, None, segs, None
    if kind == "h5":
        import h5py
        paths = []
        for i, (im, sg) in enumerate(zip(imgs, segs)):
            paths.append(str(tmp_path / f"im{i}.h5"))
            with h5py.File(paths[-1], "w") as f:
                f["raw"], f["labels"] = im, sg
        return paths, "raw", paths, "labels"
    import imageio.v3 as imageio
    for sub, arrays in (("raw", imgs), ("labels", segs)):
        (tmp_path / sub).mkdir()
        for i, a in enumerate(arrays):
            imageio.imwrite(tmp_path / sub / f"im{i}.tif", a)
    return str(tmp_path / "raw"), "*.tif", str(tmp_path / "labels"), "*.tif"


@pytest.mark.parametrize("source", ["arrays", "h5", "tif_dir"])
def test_default_sam_loader_matches_jax(source, tmp_path):
    """The same patches and labels as the JAX package's loader for the same
    images (train and validation seeds), given as arrays, HDF5 files with a
    key or a directory with a glob pattern; at its default (with the
    segmentation decoder) the same distance targets too."""
    from micro_sam_tpu.training.training import default_sam_loader as jax_loader
    from micro_sam_tpu_torch.training import default_sam_loader
    imgs, segs = _images(2, size=160, seed=7)
    raw, raw_key, labels, label_key = _write_sources(source, imgs, segs, tmp_path)
    for is_train in (True, False):
        kw = dict(raw_paths=raw, raw_key=raw_key, label_paths=labels, label_key=label_key,
                  patch_shape=(1, 96, 96), with_segmentation_decoder=False, n_samples=4,
                  is_train=is_train, batch_size=2)
        ref, got = list(jax_loader(**kw)), list(default_sam_loader(**kw))
        assert len(ref) == len(got) == 2
        for (ra, rb), (ga, gb) in zip(ref, got):
            np.testing.assert_array_equal(ra, ga)
            np.testing.assert_array_equal(rb, gb)
    kw = dict(raw_paths=raw, raw_key=raw_key, label_paths=labels, label_key=label_key,
              patch_shape=(96, 96), n_samples=2, batch_size=2)
    (ref,), (got,) = list(jax_loader(**kw)), list(default_sam_loader(**kw))
    assert len(got) == 3 and got[2].shape == (2, 3, 96, 96)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def test_train_sam_for_configuration_a100_on_the_cpu(tmp_path, monkeypatch):
    """The GPU preset end to end with ``device="cpu"``, vit_h patched to the
    vit_h-class width: the trainer gets vit_h and 25 objects per image, and
    best.pkl loads in both packages with the same embedding (rel 1e-4); at
    its default the preset also trains the segmentation decoder."""
    from micro_sam_tpu.util import get_sam_model as jax_get_sam_model
    from micro_sam_tpu_torch.models import build_sam
    from micro_sam_tpu_torch.models.sam import SamConfig
    from micro_sam_tpu_torch.training import default_sam_loader, training
    from micro_sam_tpu_torch.util import get_sam_model
    monkeypatch.setitem(build_sam.SAM_CONFIGS, "vit_h",
                        SamConfig(**dataclasses.asdict(_vit_h_class())))
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # no logger, as on the card
    seen = {}

    def recording(base):
        class Recording(base):
            def _prepare_batch(self, *a, **kw):
                batch = super()._prepare_batch(*a, **kw)
                seen.setdefault("objects", set()).add(batch[1].shape[1])
                seen["model"] = (self.model.config.model_type, self.model.config.embed_dim,
                                 self.model.config.num_heads)
                seen["trainer"] = base.__name__
                return batch
        return Recording
    monkeypatch.setattr(training, "SamTrainer", recording(training.SamTrainer))
    monkeypatch.setattr(training, "JointSamTrainer", recording(training.JointSamTrainer))
    imgs, segs = _images(3, seed=11)
    loader = lambda train: default_sam_loader(
        raw_paths=imgs[:2] if train else imgs[2:], raw_key=None,
        label_paths=segs[:2] if train else segs[2:], label_key=None, patch_shape=(128, 128),
        with_segmentation_decoder=False, is_train=train, n_samples=2 if train else 1)
    joint = lambda train: default_sam_loader(
        raw_paths=imgs[:2] if train else imgs[2:], raw_key=None,
        label_paths=segs[:2] if train else segs[2:], label_key=None, patch_shape=(128, 128),
        is_train=train, n_samples=1)
    with one_thread():
        training.train_sam_for_configuration(
            "joint", "A100", joint(True), joint(False), n_iterations=1, n_sub_iteration=2,
            device="cpu", save_root=str(tmp_path),
            checkpoint_path=joint_checkpoint(tmp_path / "start.pkl", _vit_h_class()))
    assert seen["trainer"] == "JointSamTrainer"
    with open(tmp_path / "joint" / "best.pkl", "rb") as f:
        assert "deconv1" in pickle.load(f)["decoder_state"]
    training.train_sam_for_configuration("cfg_h", "A100", loader(True), loader(False),
                                         with_segmentation_decoder=False, n_iterations=2,
                                         n_sub_iteration=2, device="cpu",
                                         save_root=str(tmp_path))
    assert seen == {"objects": {25}, "model": ("vit_h", 160, 2), "trainer": "SamTrainer"}
    path = str(tmp_path / "cfg_h" / "best.pkl")
    pp = get_sam_model("vit_h", device="cpu", checkpoint_path=path)
    jp = jax_get_sam_model(model_type="vit_h", checkpoint_path=path, compute_dtype="float32")
    assert pp.model.config.embed_dim == jp.model.config.embed_dim == 160
    img = np.random.RandomState(1).randint(0, 255, (128, 128, 3)).astype(np.uint8)
    pp.set_image(img)
    jp.set_image(img)
    assert rel_err(pp.get_image_embedding(), np.asarray(jp.get_image_embedding())) <= 1e-4


def _split_case(H, W, hd, seed):
    rng = np.random.RandomState(seed)
    B, nH, N = 2, 2, H * W
    q, k, v, g = (rng.randn(B, N, nH, hd).astype(np.float32) for _ in range(4))
    rh = (rng.randn(H, H, hd) * 0.3).astype(np.float32)
    rw = (rng.randn(W, W, hd) * 0.3).astype(np.float32)
    return q, k, v, rh, rw, g


@pytest.mark.parametrize("entry", ["flash_attention_rel_pos", "attention_with_rel_pos"])
@pytest.mark.parametrize("H,W,hd,tables", [(14, 14, 64, True), (8, 12, 80, True),
                                            (14, 14, 80, True), (8, 12, 80, False)],
                         ids=["window_hd64", "grid8x12_hd80", "window_hd80", "no_tables_hd80"])
def test_split_layout_attention_matches_jax(entry, H, W, hd, tables):
    """(B, N, nH, hd) q, k, v: the output and the gradients of q, k, v and
    the tables against jax.grad of micro_sam_tpu.ops.attention_with_rel_pos
    (the einsum path on the CPU), rel <= 2e-5; the gradients come back in the
    (B, N, nH, hd) layout."""
    from micro_sam_tpu.ops.attention import attention_with_rel_pos as jax_attention
    from micro_sam_tpu_torch.ops import attention as pattn
    from micro_sam_tpu_torch.ops import flash_attention as pflash
    fn = getattr(pflash if entry == "flash_attention_rel_pos" else pattn, entry)
    q, k, v, rh, rw, g = _split_case(H, W, hd, seed=H * W + hd)
    n_in = 5 if tables else 3

    def f(*a):
        out = jax_attention(a[0], a[1], a[2], (H, W), *(a[3:] if tables else (None, None)))
        return jnp.sum(out * g), out

    (_, ref_out), ref_grads = jax.jit(jax.value_and_grad(f, argnums=tuple(range(n_in)),
                                                         has_aux=True))(
        *(q, k, v, rh, rw)[:n_in])
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, rh, rw)[:n_in]]
    out = fn(*leaves[:3], (H, W), *(leaves[3:] if tables else (None, None)))
    assert out.shape == q.shape
    out.backward(torch.from_numpy(g))
    assert rel_err(out.detach(), ref_out) <= 2e-5
    for t, want in zip(leaves, ref_grads):
        assert t.grad.shape == t.shape and t.grad.dtype == torch.float32
        assert rel_err(t.grad, want) <= 2e-5
