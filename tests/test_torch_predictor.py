"""The port's SamPredictor, resize, postprocessing and embedding cache against
the JAX package, on the tiny config over the same weights (f32, CPU).

Tolerances: mask logits and low-res logits rel <= 1e-4 of max|ref|, IoU abs
<= 1e-4, embeddings rel <= 1e-4; the resize equal to PIL's (difference 0);
cache reads exact.
"""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.make_zarr_fixture import feature_pattern, fixture_input
from tests.torch_port_util import (abs_err, jax_params, one_thread, port_sam, rel_err,
                                   tiny_jax_config)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: tier-1's six test processes share the
    machine's cores, and small tensors gain nothing from more (ROADMAP.md,
    Budgets)."""
    with one_thread():
        yield


FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module")
def predictors():
    from micro_sam_tpu.models.sam import Sam as JaxSam
    from micro_sam_tpu.predictor import SamPredictor as JaxPredictor
    from micro_sam_tpu_torch.predictor import SamPredictor
    cfg = tiny_jax_config()
    params = jax_params(cfg)
    return JaxPredictor(JaxSam(cfg, params)), SamPredictor(port_sam(cfg, params))


@pytest.fixture(scope="module")
def features():
    return np.random.RandomState(2).randn(1, 256, 16, 16).astype(np.float32)


# prompt sets whose JAX packing needs no power-of-two padding (2 or 4 tokens)
PROMPTS = {
    "1 point": dict(point_coords=np.array([[120., 80.]]), point_labels=np.array([1])),
    "3 points": dict(point_coords=np.array([[120., 80.], [30., 150.], [250., 20.]]),
                     point_labels=np.array([1, 0, 1])),
    "box": dict(box=np.array([40., 30., 220., 160.])),
    "box + 2 points": dict(point_coords=np.array([[100., 90.], [60., 50.]]),
                           point_labels=np.array([1, 0]), box=np.array([40., 30., 220., 160.])),
    "batched boxes": dict(box=np.array([[40., 30., 220., 160.], [10., 10., 90., 60.],
                                        [150., 100., 290., 190.]])),
}


@pytest.mark.parametrize("multimask", [True, False], ids=["multimask", "single"])
@pytest.mark.parametrize("name", list(PROMPTS))
def test_predict_matches_jax(predictors, features, name, multimask):
    jp, pp = predictors
    for p in (jp, pp):
        p.set_features(features, original_size=(200, 300))
    kw = dict(PROMPTS[name], multimask_output=multimask, return_logits=True)
    jm, ji, jl = jp.predict(**kw)
    pm, pi, pl = pp.predict(**kw)
    assert pm.shape == jm.shape and pm.shape[-2:] == (200, 300)
    assert rel_err(pm, jm) <= 1e-4
    assert rel_err(pl, jl) <= 1e-4
    assert abs_err(pi, ji) <= 1e-4


def test_mask_input_matches_jax(predictors, features):
    jp, pp = predictors
    for p in (jp, pp):
        p.set_features(features, original_size=(256, 256))
    mask = (np.random.RandomState(3).randn(1, 64, 64) * 4).astype(np.float32)
    kw = dict(point_coords=np.array([[100., 90.]]), point_labels=np.array([1]),
              mask_input=mask, return_logits=True)
    jm, ji, _ = jp.predict(**kw)
    pm, pi, _ = pp.predict(**kw)
    assert rel_err(pm, jm) <= 1e-4 and abs_err(pi, ji) <= 1e-4


def test_set_image_matches_jax(predictors):
    """An image already at the model's size: no resize, so both encode the same pixels."""
    jp, pp = predictors
    image = (np.random.RandomState(4).rand(256, 256, 3) * 255).astype(np.uint8)
    jp.set_image(image)
    pp.set_image(image)
    assert rel_err(pp.get_image_embedding(), jp.get_image_embedding()) <= 1e-4
    kw = dict(point_coords=np.array([[100., 90.]]), point_labels=np.array([1]),
              return_logits=True)
    assert rel_err(pp.predict(**kw)[0], jp.predict(**kw)[0]) <= 1e-4


def test_bucket_padding_divergence(predictors, features):
    """Intended divergence: the JAX predictor pads prompts to power-of-two
    buckets with label -1 tokens (micro_sam_tpu/predictor.py:294-300), and every
    such token takes part in the two-way transformer's attention. The port
    packs as upstream SAM (one pad point, only without a box), so it equals
    the JAX decoder on the unpadded tokens and differs from the JAX predictor."""
    from micro_sam_tpu.models.sam import postprocess_masks as jax_post
    jp, pp = predictors
    for p in (jp, pp):
        p.set_features(features, original_size=(256, 256))
    kw = dict(point_coords=np.array([[120., 80.], [30., 150.]]), point_labels=np.array([1, 0]),
              multimask_output=False, return_logits=True)
    pm, pi, _ = pp.predict(**kw)
    jm, ji, _ = jp.predict(**kw)  # packs [pos, neg, pad] then pads to 4 tokens
    sam = jp.model
    pts = jnp.asarray([[[120., 80.], [30., 150.], [0., 0.]]])
    lab = jnp.asarray([[1, 0, -1]])
    feats = jnp.transpose(jnp.asarray(features), (0, 2, 3, 1))
    low, iou = sam.decode_masks(sam.params, feats, pts, lab)
    ref = np.asarray(jax_post(low[:, 0:1], (256, 256), (256, 256), 256))[0]
    assert rel_err(pm, ref) <= 1e-4 and abs_err(pi, np.asarray(iou)[0, 0:1]) <= 1e-4
    assert abs_err(pm, jm) > 1e-3  # the bucket's extra pad token moves the logits


@pytest.mark.parametrize("original", [(100, 150), (600, 400)], ids=["down", "up"])
def test_postprocess_masks_matches_jax(original):
    from micro_sam_tpu.models.sam import postprocess_masks as jax_post
    from micro_sam_tpu_torch.models.sam import postprocess_masks
    low = (np.random.RandomState(5).randn(2, 3, 64, 64) * 5).astype(np.float32)
    input_size = (171, 256) if original == (100, 150) else (256, 171)
    ref = np.asarray(jax_post(jnp.asarray(low), input_size, original, 256))
    got = postprocess_masks(torch.from_numpy(low), input_size, original, 256).numpy()
    assert rel_err(got, ref) <= 1e-4


@pytest.mark.parametrize("shape", [(300, 200), (90, 70)], ids=["down", "up"])
def test_resize_equals_pil(shape):
    from PIL import Image
    from micro_sam_tpu_torch.utils.transforms import ResizeLongestSide, get_preprocess_shape
    image = (np.random.RandomState(6).rand(*shape, 3) * 255).astype(np.uint8)
    h, w = get_preprocess_shape(*shape, 256)
    ref = np.asarray(Image.fromarray(image).resize((w, h), Image.BILINEAR), np.float32)
    got = ResizeLongestSide(256).apply_image(image)
    assert got.shape == ref.shape and np.abs(got - ref).max() == 0


@pytest.mark.parametrize("ndim", [2, 3])
def test_precompute_matches_jax(predictors, ndim):
    from micro_sam_tpu.util import precompute_image_embeddings as jax_pre
    from micro_sam_tpu_torch.util import precompute_image_embeddings
    jp, pp = predictors
    rng = np.random.RandomState(7)
    data = rng.randint(0, 256, size=(256, 256) if ndim == 2 else (2, 256, 256)).astype(np.uint8)
    ref = jax_pre(jp, data, verbose=False)
    got = precompute_image_embeddings(pp, data, verbose=False)
    assert got["features"].shape == ref["features"].shape
    assert rel_err(got["features"], ref["features"]) <= 1e-4
    assert tuple(got["input_size"]) == tuple(ref["input_size"])
    assert tuple(got["original_size"]) == tuple(ref["original_size"])


def _no_encode(predictor, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("cache hit expected: the encoder must not run")
    monkeypatch.setattr(predictor, "encode_batch", boom)


def test_cache_written_by_jax_loads_in_port(predictors, tmp_path, monkeypatch):
    from micro_sam_tpu.util import precompute_image_embeddings as jax_pre
    from micro_sam_tpu_torch.util import precompute_image_embeddings, set_precomputed
    jp, pp = predictors
    image = fixture_input((64, 80))
    path = str(tmp_path / "jax.zarr")
    ref = jax_pre(jp, image, save_path=path, verbose=False)
    _no_encode(pp, monkeypatch)
    got = precompute_image_embeddings(pp, image, save_path=path, verbose=False)
    np.testing.assert_array_equal(np.asarray(got["features"]), np.asarray(ref["features"]))
    assert tuple(got["input_size"]) == tuple(ref["input_size"])
    set_precomputed(pp, got)
    assert pp.original_size == (64, 80)


def test_cache_written_by_port_loads_in_jax(predictors, tmp_path, monkeypatch):
    from micro_sam_tpu import util as jax_util
    from micro_sam_tpu_torch.util import precompute_image_embeddings
    jp, pp = predictors
    image = fixture_input((64, 80))
    path = str(tmp_path / "torch.zarr")
    ref = precompute_image_embeddings(pp, image, save_path=path, verbose=False)
    monkeypatch.setattr(jax_util, "_encode_batch",
                        lambda *a, **k: (_ for _ in ()).throw(AssertionError("cache miss")))
    got = jax_util.precompute_image_embeddings(jp, image, save_path=path, verbose=False)
    np.testing.assert_array_equal(np.asarray(got["features"]), ref["features"])
    assert tuple(got["original_size"]) == (64, 80)


def test_reference_cache_fixture_loads(predictors, tmp_path, monkeypatch):
    """A cache in the upstream layout (input_size attr, no 'done' marker)."""
    from micro_sam_tpu_torch.util import precompute_image_embeddings
    _, pp = predictors
    cache = tmp_path / "cache.zarr"
    shutil.copytree(os.path.join(FIXTURES, "zarr_ref_cache"), cache)
    _no_encode(pp, monkeypatch)
    emb = precompute_image_embeddings(pp, fixture_input(), save_path=str(cache), verbose=False)
    np.testing.assert_array_equal(np.asarray(emb["features"]), feature_pattern((1, 256, 64, 64)))
    assert tuple(emb["input_size"]) == (914, 1024) and tuple(emb["original_size"]) == (96, 112)
    other = fixture_input().copy()
    other[0, 0] ^= 0xFF
    with pytest.raises(RuntimeError, match="data_signature"):
        precompute_image_embeddings(pp, other, save_path=str(cache), verbose=False)


def test_get_sam_model_devices():
    from micro_sam_tpu_torch.util import get_sam_model
    p = get_sam_model("vit_b_lm", device="cpu", seed=3)
    assert p.device.type == "cpu" and p.model.config.compute_dtype == "float32"
    assert p.model.config.embed_dim == 768 and p.model_type == "vit_b_lm"
    assert p.model.image_encoder.blocks[0].attn.qkv.weight.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            get_sam_model("vit_b")  # the default device is the GPU; no silent CPU run
    else:
        gp = get_sam_model("vit_b")
        assert gp.device.type == "cuda" and gp.model.config.compute_dtype == "bfloat16"
