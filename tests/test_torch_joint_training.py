"""Joint finetuning (SAM and the UNETR instance decoder), the simple and
semantic trainers, the exports and the training command line of the port on
the CPU, against the JAX package.

The tiny SAM config at 128 px and the narrow UNETR of
``tests/torch_port_util.py`` (features 64 / 32 / 16 / 8) over the same
weights, f32. Tolerances: losses rel 1e-5; gradients rel 1e-3 of each
tensor's max (as tests/test_torch_training.py); the decoder after one AdamW
step within 1e-7 where the gradient exceeds 1e-3 of its tensor's max, and
within 2 x lr elsewhere (Adam's first step is about lr * sign(g), and float
noise can flip the sign of a gradient near zero); AIS maps rel 1e-4. The JAX
package's gradients are read through an optax transformation that returns
them as its state, so they come from its own jitted steps.
"""
import dataclasses
import pickle
import random
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from torch_port_util import (NARROW_UNETR, jax_params, joint_checkpoint, one_thread, port_sam,
                             port_unetr, rel_err, unetr_jax_params)

LR = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield


def _cfg(img_size=128):
    from micro_sam_tpu.models.sam import SamConfig
    return SamConfig(model_type="vit_b", embed_dim=64, depth=2, num_heads=2,
                     global_attn_indexes=(1,), img_size=img_size)


def _port_cfg():
    from micro_sam_tpu_torch.models.sam import SamConfig
    return SamConfig(**dataclasses.asdict(_cfg()))


def _data(n_images=2, size=64, seed=0):
    """8-bit (B, size, size, 3) images of small disks, their labels and
    distance targets (the port's transform)."""
    from micro_sam_tpu_torch.sample_data import synthetic_data
    from micro_sam_tpu_torch.training import PerObjectDistanceTransform
    imgs, segs = [], []
    for b in range(n_images):
        image, seg = synthetic_data(shape=(size, size), seed=seed + b, n_objects=5,
                                    radius_range=(5, 9))
        imgs.append(np.repeat(image[..., None], 3, axis=-1).astype(np.float32))
        segs.append(seg)
    targets = np.stack([PerObjectDistanceTransform(min_size=10)(s) for s in segs])
    return np.stack(imgs), np.stack(segs), targets


def _port_trainable(params):
    from micro_sam_tpu_torch.models.sam import Sam
    from micro_sam_tpu_torch.training.trainable_sam import TrainableSAM
    sam = Sam(_port_cfg(), torch.float32)
    sam.load_state_dict(port_sam(_cfg(), params).state_dict())
    return TrainableSAM(sam)


def _jax_trainable(params):
    from micro_sam_tpu.models.sam import Sam
    from micro_sam_tpu.training.trainable_sam import TrainableSAM
    return TrainableSAM(Sam(_cfg(), params))


# optax transformation whose update is zero and whose state is the gradient
CAPTURE = optax.GradientTransformation(
    init=lambda p: jax.tree.map(jnp.zeros_like, p),
    update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _grads_held(named_params, want: dict, n_min: int):
    """Every gradient within rel 1e-3 of its tensor's max against ``want``
    (name -> tensor). Gradients that are zero in the exact arithmetic are
    float noise in both packages: unused paths, the key biases of SAM's
    attention (a key bias shifts all logits of a query alike) and the
    decoder's biases whose output meets an InstanceNorm before any ReLU (the
    upsamplers' ahead of a ConvBlock); where the reference is below 1e-6 of
    the largest gradient, the port is held below it too."""
    g_max = max(float(g.abs().max()) for g in want.values())
    n = 0
    for name, p in named_params:
        ref = want[name]
        got = torch.zeros_like(p) if p.grad is None else p.grad
        if float(ref.abs().max()) <= 1e-6 * g_max:
            assert float(got.abs().max()) <= 1e-6 * g_max, name
            continue
        assert rel_err(got, ref) <= 1e-3, name
        n += 1
    assert n >= n_min, n


# ---------------------------------------------------------------------------
# the distance targets, the transforms, the dataset with targets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("instances,min_size", [(False, 25), (True, 25), (False, 200)])
def test_distance_transform_matches_jax(instances, min_size):
    from micro_sam_tpu.sample_data import synthetic_data
    from micro_sam_tpu.training.training import PerObjectDistanceTransform as J
    from micro_sam_tpu_torch.training import PerObjectDistanceTransform as P
    seg = synthetic_data((160, 192), seed=3)[1]
    ref = J(instances=instances, min_size=min_size)(seg)
    got = P(instances=instances, min_size=min_size)(seg)
    assert got.shape == ref.shape == (3 + instances, 160, 192) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert (got[-1][seg > 0] < 1).any() and (got[-1][seg == 0] == 1).all()


def test_transforms_match_jax():
    from micro_sam_tpu.sample_data import synthetic_data
    from micro_sam_tpu.training import util as ju
    from micro_sam_tpu_torch.training import util as pu
    image, seg = synthetic_data((90, 100), seed=5)
    raw = image.astype(np.float32) / 300.0
    for mode in (None, "normalize_minmax", "normalize_percentile"):
        np.testing.assert_array_equal(pu.get_raw_transform(mode)(raw.copy()),
                                      ju.get_raw_transform(mode)(raw.copy()))
    with pytest.raises(ValueError):
        pu.get_raw_transform("nope")
    for kw in (dict(), dict(do_rescaling=True)):
        np.testing.assert_array_equal(pu.ResizeRawTrafo((3, 128, 112), **kw)(image),
                                      ju.ResizeRawTrafo((3, 128, 112), **kw)(image))
    np.testing.assert_allclose(pu.ResizeLabelTrafo((96, 101), min_size=10)(seg),
                               ju.ResizeLabelTrafo((96, 101), min_size=10)(seg), atol=1e-6)
    assert pu.identity(raw) is raw
    x, y = np.stack([image] * 2), np.stack([seg] * 2)
    for a, b in zip(ju.ConvertToSemanticSamInputs()(x, y), pu.ConvertToSemanticSamInputs()(x, y)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_dataset_with_targets_matches_jax():
    """The same (raw, labels, targets) batches as the JAX package's loader
    for the same images and seeds (train and validation)."""
    from micro_sam_tpu.sample_data import synthetic_data
    from micro_sam_tpu.training.training import default_sam_loader as jax_loader
    from micro_sam_tpu_torch.training import default_sam_loader
    images = [synthetic_data((200, 160), seed=s) for s in (5, 6)]
    for is_train in (True, False):
        kw = dict(raw_paths=[i for i, _ in images], raw_key=None,
                  label_paths=[s for _, s in images], label_key=None, patch_shape=(96, 96),
                  n_samples=4, is_train=is_train, batch_size=2)
        ref, got = list(jax_loader(**kw)), list(default_sam_loader(**kw))
        assert len(ref) == len(got) == 2
        for r, g in zip(ref, got):
            assert len(r) == len(g) == 3 and g[2].shape == (2, 3, 96, 96)
            for a, b in zip(r, g):
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the decoder step against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decoder_case():
    """Both packages' joint trainers on the same SAM, decoder, images and
    targets; the JAX package's loss and gradients of its decoder step."""
    from micro_sam_tpu.training.joint_sam_trainer import JointSamTrainer as JT
    from micro_sam_tpu_torch.models.convert import unetr_params_from_jax
    from micro_sam_tpu_torch.training import JointSamTrainer
    params = jax_params(_cfg(), seed=4)
    dec = unetr_jax_params(True, seed=2)
    x, _, t = _data(2, 64, seed=40)
    jt = JT("j", None, None, _jax_trainable(params), unetr=jax.tree.map(jnp.asarray, dec),
            logger=False)
    jt.unetr_optimizer = CAPTURE
    jt.unetr_opt_state = CAPTURE.init(jt.unetr_params)
    _, grads, loss = jt._build_unetr_step()(jt.unetr_params, jt.unetr_opt_state, jt.model.params,
                                            jnp.asarray(x), jnp.asarray(t))
    pt = JointSamTrainer("p", None, None, _port_trainable(params), unetr=port_unetr(dec),
                         logger=False)
    return dict(params=params, dec=dec, x=x, t=t, pt=pt, ref_loss=float(loss),
                ref_grads=unetr_params_from_jax(jax.tree.map(np.asarray, grads)))


def test_decoder_loss_and_gradients_match_jax(decoder_case):
    from micro_sam_tpu_torch.training.joint_sam_trainer import unetr_loss
    c = decoder_case
    pt = c["pt"]
    with torch.no_grad():
        feats = pt.model.image_embeddings_oft(torch.from_numpy(c["x"]))
    pt.unetr.zero_grad(set_to_none=True)
    loss = unetr_loss(pt.unetr, feats, torch.from_numpy(c["t"]))
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - c["ref_loss"]) <= 1e-5 * abs(c["ref_loss"])
    _grads_held(pt.unetr.named_parameters(), c["ref_grads"], n_min=30)
    assert not any(p.grad is not None for p in pt.model.sam.parameters())


def test_decoder_step_matches_optax(decoder_case):
    """One decoder update (a fresh pair of trainers) against the JAX
    package's ``_instance_iteration`` (optax.adamw 1e-5); BN statistics are
    not updated; four target channels train on their last three."""
    from micro_sam_tpu.training.joint_sam_trainer import JointSamTrainer as JT
    from micro_sam_tpu_torch.models.convert import unetr_params_from_jax
    from micro_sam_tpu_torch.training import JointSamTrainer
    c = decoder_case
    jt = JT("j", None, None, _jax_trainable(c["params"]),
            unetr=jax.tree.map(jnp.asarray, c["dec"]), logger=False)
    ref_loss = jt._instance_iteration(jnp.asarray(c["x"]), jnp.asarray(c["t"]))
    want = unetr_params_from_jax(jax.tree.map(np.asarray, jt.unetr_params))
    pt = JointSamTrainer("p", None, None, _port_trainable(c["params"]), unetr=port_unetr(c["dec"]),
                         logger=False)
    before = {k: v.clone() for k, v in pt.unetr.state_dict().items()}
    four = np.concatenate([np.zeros_like(c["t"][:, :1]), c["t"]], axis=1)  # instances first
    loss = pt.instance_step(torch.from_numpy(c["x"]), four)
    assert abs(float(loss) - ref_loss) <= 1e-5 * abs(ref_loss)
    g = c["ref_grads"]
    g_max = max(float(v.abs().max()) for v in g.values())
    for name, got in pt.unetr.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            assert torch.equal(got, before[name]), name
            continue
        diff = (got - want[name]).abs()
        # zero-by-symmetry gradients (_grads_held) are float noise: no element is clear
        clear = (g[name].abs() > 1e-3 * g[name].abs().max()) & (g[name].abs() > 1e-6 * g_max)
        assert not clear.any() or float(diff[clear].max()) <= 1e-7, name
        assert float(diff.max()) <= 2 * LR, name
        assert not torch.equal(got, before[name]), name


def test_jax_decoder_step_refuses_four_target_channels(decoder_case):
    """A fault of the reference: ResizeLabelTrafo's four channels (instances
    first) reach JAX's decoder loss, which fails on a shape mismatch against
    its three predicted channels; the port trains on the last three (above)."""
    from micro_sam_tpu.training.joint_sam_trainer import JointSamTrainer as JT
    c = decoder_case
    jt = JT("j", None, None, _jax_trainable(c["params"]),
            unetr=jax.tree.map(jnp.asarray, c["dec"]), logger=False)
    four = np.concatenate([np.zeros_like(c["t"][:, :1]), c["t"]], axis=1)
    with pytest.raises((TypeError, ValueError)):
        jt._instance_iteration(jnp.asarray(c["x"]), jnp.asarray(four))


# ---------------------------------------------------------------------------
# fit, the checkpoints, the entry points
# ---------------------------------------------------------------------------

def test_joint_fit_checkpoint_loads_in_both_packages(tmp_path):
    """JointSamTrainer.fit(iterations=2) writes latest / best with the
    decoder; JAX's get_predictor_and_decoder and the port's
    get_predictor_and_segmenter give the same foreground map from best.pkl,
    and load_checkpoint restores the decoder."""
    from micro_sam_tpu import instance_segmentation as jis
    from micro_sam_tpu_torch.automatic_segmentation import get_predictor_and_segmenter
    from micro_sam_tpu_torch.training import JointSamTrainer
    params = jax_params(_cfg(), seed=5)
    x, y, t = _data(1, 64, seed=50)
    pt = JointSamTrainer("joint", [(x, y, t), (x, y, t)], [(x, y)], _port_trainable(params),
                         unetr=port_unetr(unetr_jax_params(True, seed=3)), n_sub_iteration=2,
                         n_objects_per_batch=2, save_root=str(tmp_path), lr=1e-3, logger=False)
    dec0 = {k: v.clone() for k, v in pt.unetr.state_dict().items()}
    pt.fit(iterations=2, verbose=False)
    assert pt._iteration == 2
    path = str(tmp_path / "joint" / "best.pkl")
    with open(path, "rb") as f:
        state = pickle.load(f)
    assert state["iteration"] == 2 and "deconv1" in state["decoder_state"]
    trained = {k: v.clone() for k, v in pt.unetr.state_dict().items()}
    assert not torch.equal(trained["out_conv.weight"], dec0["out_conv.weight"])
    image = np.random.RandomState(0).randint(0, 255, (128, 128)).astype(np.uint8)
    jp, jd = jis.get_predictor_and_decoder("vit_b", checkpoint_path=path)
    ja = jis.InstanceSegmentationWithDecoder(jp, jd)
    ja.initialize(image)
    _, pa = get_predictor_and_segmenter("vit_b", checkpoint=path, device="cpu",
                                        segmentation_mode="ais")
    assert pa._decoder.unetr.geometry["features"] == NARROW_UNETR
    for k, v in pa._decoder.unetr.state_dict().items():
        assert torch.equal(v, trained[k]), k
    pa.initialize(image)
    assert rel_err(pa.get_state()["foreground"], ja.get_state()["foreground"]) <= 1e-4
    with torch.no_grad():
        for p in pt.unetr.parameters():
            p.zero_()
    assert pt.load_checkpoint(checkpoint="latest")["iteration"] == 2
    for k, v in pt.unetr.state_dict().items():
        assert torch.equal(v, trained[k]), k


def _joint_loader(size=96, n=2, seed=9):
    from micro_sam_tpu_torch.sample_data import synthetic_data
    from micro_sam_tpu_torch.training.training import SamDataset, SamLoader
    data = [synthetic_data((size + 32, size + 32), seed=seed + i, n_objects=8,
                           radius_range=(6, 10)) for i in range(n)]
    return SamLoader(SamDataset([d[0] for d in data], [d[1] for d in data], (size, size),
                                n_samples=2, with_segmentation_decoder=True), batch_size=1)


@pytest.fixture
def tiny_vit_b(monkeypatch):
    """vit_b patched to the tiny config, no TensorBoard writer."""
    from micro_sam_tpu_torch.models import build_sam
    monkeypatch.setitem(build_sam.SAM_CONFIGS, "vit_b", _port_cfg())
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


class _Seen:
    """Patches ``training.JointSamTrainer`` to keep the trainers it builds."""

    def __init__(self, monkeypatch):
        from micro_sam_tpu_torch.training import training
        self.trainers = []
        seen = self

        class Seen(training.JointSamTrainer):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                seen.trainers.append(self)
                self.sam0 = {k: v.clone() for k, v in self.model.sam.state_dict().items()}
                self.unetr0 = {k: v.clone() for k, v in self.unetr.state_dict().items()}
        monkeypatch.setattr(training, "JointSamTrainer", Seen)


def test_train_instance_segmentation_freezes_sam(tmp_path, monkeypatch, tiny_vit_b):
    """train_instance_segmentation: every SAM parameter and buffer bitwise
    unchanged, every decoder weight moved, best.pkl carries the decoder."""
    from micro_sam_tpu_torch.training import train_instance_segmentation
    seen = _Seen(monkeypatch)
    loader = _joint_loader()
    train_instance_segmentation("inst", "vit_b", loader, loader, n_iterations=2, device="cpu",
                                n_sub_iteration=2, n_objects_per_batch=2, save_root=str(tmp_path),
                                checkpoint_path=joint_checkpoint(tmp_path / "start.pkl", _cfg()))
    (tr,) = seen.trainers
    assert tr.optimizer is None and tr._iteration == 2
    for k, v in tr.model.sam.state_dict().items():
        assert torch.equal(v, tr.sam0[k]), k
    moved = [k for k, v in tr.unetr.state_dict().items() if not torch.equal(v, tr.unetr0[k])]
    params = {k for k, _ in tr.unetr.named_parameters()}
    assert set(moved) == params
    with open(tmp_path / "inst" / "best.pkl", "rb") as f:
        assert "decoder_state" in pickle.load(f)


def test_jax_freeze_moves_frozen_leaves():
    """A fault of the reference: train_sam's ``freeze`` builds
    optax.chain(optax.masked(adamw, freeze_mask(...))); optax.masked passes
    the raw gradient through for the masked-out (frozen) leaves and
    apply_updates adds it, so a frozen leaf at 1.0 with gradient 0.5 ends at
    1.5 while a trainable one moves by lr. The port's frozen parameters stay
    bitwise (test_train_instance_segmentation_freezes_sam)."""
    from micro_sam_tpu.training.util import freeze_mask
    params = {"image_encoder": {"w": jnp.ones(3)}, "mask_decoder": {"w": jnp.ones(3)}}
    tx = optax.chain(optax.masked(optax.adamw(LR), freeze_mask(params, ["image_encoder"])))
    grads = jax.tree.map(lambda p: 0.5 * jnp.ones_like(p), params)
    updates, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, updates)
    np.testing.assert_array_equal(np.asarray(new["image_encoder"]["w"]), 1.5)
    assert abs(float(new["mask_decoder"]["w"][0]) - (1 - LR * (1 + 1e-4))) <= 1e-7


def test_exports_match_jax(tmp_path, monkeypatch, tiny_vit_b):
    """train_sam at its default (the decoder on, device="cpu"; SAM and the
    narrow decoder from a checkpoint) end to end;
    export_instance_segmentation_model writes the keys the JAX package's
    export writes, and the file loads in both packages;
    export_custom_sam_model equals JAX's file key for key, values exact."""
    from micro_sam_tpu import util as ju
    from micro_sam_tpu.instance_segmentation import get_predictor_and_decoder
    from micro_sam_tpu.training import training as jtr
    from micro_sam_tpu_torch import util as pu
    from micro_sam_tpu_torch.instance_segmentation import get_predictor_and_decoder as p_get
    from micro_sam_tpu_torch.training import export_instance_segmentation_model, train_sam
    loader = _joint_loader()
    train_sam("default", "vit_b", loader, loader, n_iterations=1, n_sub_iteration=2,
              n_objects_per_batch=2, device="cpu", save_root=str(tmp_path),
              checkpoint_path=joint_checkpoint(tmp_path / "start.pkl", _cfg()))
    best = str(tmp_path / "default" / "best.pkl")
    outs = {n: str(tmp_path / f"{n}.pkl") for n in ("jax", "port")}
    jtr.export_instance_segmentation_model(best, outs["jax"], "vit_b")
    export_instance_segmentation_model(trained_model_path=best, output_path=outs["port"],
                                       model_type="vit_b")
    files = {}
    for n, p in outs.items():
        with open(p, "rb") as f:
            files[n] = pickle.load(f)
    assert set(files["port"]) == set(files["jax"]) >= {"model_state", "decoder_state"}
    _, jdec = get_predictor_and_decoder("vit_b", checkpoint_path=outs["port"])
    pp, pdec = p_get("vit_b", checkpoint_path=outs["port"], device="cpu")
    assert pp.model.config.embed_dim == 64 and pdec.unetr.geometry["features"] == NARROW_UNETR
    assert jdec is not None

    sd = {n: str(tmp_path / f"{n}.pt") for n in ("jax", "port")}
    ju.export_custom_sam_model(best, "vit_b", sd["jax"])
    pu.export_custom_sam_model(best, "vit_b", sd["port"])
    ref, got = (torch.load(sd[n], weights_only=True) for n in ("jax", "port"))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], ref[k]), k
    assert pu.get_sam_model("vit_b", device="cpu", checkpoint_path=sd["port"]).model is not None


def test_save_native_checkpoint_loads_in_jax(tmp_path, monkeypatch):
    """The flat npz at exactly the path given (a ``.msam`` stays one), read
    back by the JAX package's load_native_checkpoint to the same parameters
    and by the port's loader to the same state dict."""
    from micro_sam_tpu import util as ju
    from micro_sam_tpu.models import build_sam as jbs
    from micro_sam_tpu_torch import util as pu
    from micro_sam_tpu_torch.models import build_sam as pbs
    from micro_sam_tpu_torch.models.convert import load_native_checkpoint
    monkeypatch.setitem(jbs.SAM_CONFIGS, "vit_b", _cfg())
    monkeypatch.setitem(pbs.SAM_CONFIGS, "vit_b", _port_cfg())
    params = jax_params(_cfg(), seed=6)
    sam = port_sam(_cfg(), params)
    path = tmp_path / "w.msam"
    pu.save_native_checkpoint(str(path), sam.state_dict(), sam.config)
    assert path.exists() and not (tmp_path / "w.msam.npz").exists()
    _, back = ju.load_native_checkpoint(str(path))
    flat_ref = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_got)
    for k, v in flat_ref:
        np.testing.assert_array_equal(np.asarray(flat_got[k]), np.asarray(v))
    _, sd = load_native_checkpoint(str(path))
    for k, v in sam.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_training_command_line(tmp_path, monkeypatch, tiny_vit_b):
    """``micro_sam_tpu_torch.train`` with ``-d cpu`` on .tif files: trains SAM
    and the decoder (both from ``-c``'s checkpoint) and exports the best
    checkpoint."""
    imageio = pytest.importorskip("imageio.v3")
    from micro_sam_tpu_torch.sample_data import synthetic_data
    from micro_sam_tpu_torch.training.training import main
    paths = {"im": [], "lab": []}
    for i in range(3):
        image, seg = synthetic_data((96, 96), seed=20 + i, n_objects=6, radius_range=(6, 10))
        for kind, a in (("im", image), ("lab", seg.astype(np.uint16))):
            paths[kind].append(str(tmp_path / f"{kind}{i}.tif"))
            imageio.imwrite(paths[kind][-1], a)
    out = tmp_path / "exported.pkl"
    main(["--images", *paths["im"], "--labels", *paths["lab"], "-m", "vit_b", "--patch_shape",
          "96", "96", "--n_epochs", "1", "--n_objects_per_batch", "3", "-d", "cpu",
          "-s", str(tmp_path), "--name", "cli", "--export_path", str(out),
          "-c", joint_checkpoint(tmp_path / "start.pkl", _cfg())])
    with open(out, "rb") as f:
        state = pickle.load(f)
    assert state["model_type"] == "vit_b" and "decoder_state" in state
    assert (tmp_path / "cli" / "latest.pkl").exists()


# ---------------------------------------------------------------------------
# the simple and semantic trainers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("points,box", [(True, True), (True, False), (False, True)])
def test_simple_trainer_choices_match_jax(points, box):
    from micro_sam_tpu.training.simple_sam_trainer import SimpleSamTrainer as J
    from micro_sam_tpu_torch.training import SimpleSamTrainer as P
    state = types.SimpleNamespace(use_points=points, use_box=box)
    choices = []
    for cls in (J, P):
        random.seed(17)
        choices.append([(cls._get_prompt_and_multimasking_choices(state, i),
                         cls._get_prompt_and_multimasking_choices_for_val(state, i))
                        for i in range(24)])
    assert choices[0] == choices[1]
    assert len({c[0] for c in choices[1]}) == 1 + (points and box)


def test_simple_and_medsam_trainers_step():
    """SimpleSamTrainer (one round, no mask prompt) and MedSAMTrainer (boxes
    only) take a step each on the tiny config: finite losses, weights moved."""
    from micro_sam_tpu_torch.training import MedSAMTrainer, SimpleSamTrainer
    x, y, _ = _data(1, 64, seed=60)
    model = _port_trainable(jax_params(_cfg(), seed=7))
    for cls in (SimpleSamTrainer, MedSAMTrainer):
        tr = cls("s", [(x, y)], [(x, y)], model, n_objects_per_batch=2, lr=1e-3, logger=False)
        assert tr.n_sub_iteration == 1 and tr.mask_prob == 0.0
        before = model.sam.mask_decoder.iou_token.weight.detach().clone()
        loss, _ = tr._run_epoch(train=True)
        assert np.isfinite(loss) and tr._iteration == 1
        assert not torch.equal(before, model.sam.mask_decoder.iou_token.weight)
    assert not MedSAMTrainer("m", None, None, model, logger=False).use_points


@pytest.mark.parametrize("kind", ["SemanticSamTrainer", "SemanticMapsSamTrainer"])
def test_semantic_loss_and_gradients_match_jax(kind):
    """The promptless decode's loss (dice + cross-entropy, or sigmoid dice on
    maps) and every SAM gradient against the JAX package's jitted step on the
    same weights; one optimizer step of the port moves the weights."""
    from micro_sam_tpu.training import semantic_sam_trainer as js
    from micro_sam_tpu_torch.models.convert import params_from_jax
    from micro_sam_tpu_torch.training import semantic_sam_trainer as ps
    params = jax_params(_cfg(), seed=8)
    x, y, _ = _data(2, 64, seed=70)
    targets = (y % 3) if kind == "SemanticSamTrainer" else (y > 0).astype(np.float32)
    pt = getattr(ps, kind)("p", [(x, targets)], None, _port_trainable(params), num_classes=3,
                           logger=False)
    jt = getattr(js, kind)("j", None, None, _jax_trainable(params), optimizer=CAPTURE,
                           num_classes=3, logger=False)
    images, tj = jt.convert_inputs(x, targets)  # the step donates the parameters
    _, grads, loss = jt._build_semantic_step((64, 64))(jt.model.params, jt.opt_state, images, tj)
    pi, tp = pt.convert_inputs(x, targets)
    got = pt.semantic_loss(pi, tp)
    got.backward()
    got = got.detach()
    assert abs(float(got) - float(loss)) <= 1e-5 * abs(float(loss))
    _grads_held(pt.model.sam.named_parameters(),
                params_from_jax(jax.tree.map(np.asarray, grads), pt.model.config), n_min=100)
    w = pt.model.sam.mask_decoder.output_hypernetworks_mlps[0].layers[0].weight
    w0 = w.detach().clone()
    train_loss, _ = pt._run_epoch(train=True)
    assert np.isfinite(train_loss) and pt._iteration == 1 and not torch.equal(w0, w)


def test_custom_dice_loss_matches_jax():
    from micro_sam_tpu.training.semantic_sam_trainer import CustomDiceLoss as J
    from micro_sam_tpu_torch.training import CustomDiceLoss as P
    rng = np.random.RandomState(3)
    pred = rng.randn(2, 4, 16, 20).astype(np.float32)
    target = rng.randint(0, 4, (2, 1, 16, 20))
    for softmax in (True, False):
        ref = float(J(4, softmax)(pred, target))
        got = float(P(4, softmax)(torch.from_numpy(pred), torch.from_numpy(target)))
        assert abs(got - ref) <= 1e-6 * abs(ref)
