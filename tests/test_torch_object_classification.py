"""The port's object classification (per-object embedding features, the
random-forest helpers, the projection of predictions) and its embedding
visualization (PCA, the 2d / 3d / tiled projections) against the JAX
package, each package over embeddings from its own encoder (the tiny config
of tests/torch_port_util.py, the same weights, f32, CPU).

Tolerances: features within rel 1e-5 of max; the PCA within 1e-5 once each
component's sign is aligned with the JAX package's (an SVD fixes a component
only up to its sign, and the RGB normalisation of a flipped component is
1 - x); the prediction projection exact.
"""
import numpy as np
import pytest

from tests.torch_port_util import jax_params, one_thread, port_sam, rel_err, tiny_jax_config


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: tier-1's six test processes share the
    machine's cores, and small tensors gain nothing from more (ROADMAP.md,
    Budgets)."""
    with one_thread():
        yield


TILE, HALO = (128, 96), (16, 16)


@pytest.fixture(scope="module")
def models():
    from micro_sam_tpu.models.sam import Sam as JaxSam
    from micro_sam_tpu.predictor import SamPredictor as JaxPredictor
    from micro_sam_tpu_torch.predictor import SamPredictor
    cfg = tiny_jax_config(img_size=128)
    params = jax_params(cfg)
    jp, pp = JaxPredictor(JaxSam(cfg, params)), SamPredictor(port_sam(cfg, params))
    jp.transform.apply_image = pp.transform.apply_image  # the same pixels into both encoders
    return jp, pp


@pytest.fixture(scope="module")
def embeddings(models):
    """Each package's 2d, 3d and tiled embeddings of one image, with its truth."""
    from micro_sam_tpu import util as jutil
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.sample_data import synthetic_data
    image, seg = synthetic_data(shape=(128, 96), seed=60, n_objects=4)
    big = np.tile(image, (2, 3))
    big_seg = np.zeros(big.shape, np.uint32)
    for k in range(6):  # every copy of the objects an id of its own
        y, x = divmod(k, 3)
        big_seg[128 * y:128 * (y + 1), 96 * x:96 * (x + 1)] = np.where(seg > 0, seg + 10 * k, 0)
    out = {}
    for name, mod, pred in (("jax", jutil, models[0]), ("port", util, models[1])):
        out[name] = {
            "2d": mod.precompute_image_embeddings(pred, image, verbose=False),
            "3d": mod.precompute_image_embeddings(pred, np.stack([image, image[::-1]]), ndim=3,
                                                  verbose=False),
            "tiled": mod.precompute_image_embeddings(pred, big, tile_shape=TILE, halo=HALO,
                                                     verbose=False)}
    return out, image, seg.astype(np.uint32), big_seg


def _aligned(got, ref, as_rgb):
    """``got`` with each component's sign turned to agree with ``ref``."""
    got = np.array(got, np.float64)
    for c in range(got.shape[-1]):
        g, r = got[..., c], np.asarray(ref[..., c], np.float64)
        flipped = as_rgb and np.abs((1 - g) - r).max() < np.abs(g - r).max()
        flipped = flipped or (not as_rgb and (g * r).sum() < 0)
        if flipped:
            got[..., c] = 1 - g if as_rgb else -g
    return got


@pytest.mark.parametrize("kind", ["2d", "3d", "tiled"])
def test_object_features_match_jax(embeddings, kind):
    from micro_sam_tpu.object_classification import compute_object_features as jfeat
    from micro_sam_tpu_torch.object_classification import compute_object_features as pfeat
    embs, _, seg, big_seg = embeddings
    segmentation = {"2d": seg, "3d": np.stack([seg, seg[::-1]]), "tiled": big_seg}[kind]
    got_ids, got = pfeat(embs["port"][kind], segmentation, verbose=False)
    ref_ids, ref = jfeat(embs["jax"][kind], segmentation, verbose=False)
    assert np.array_equal(got_ids, ref_ids) and len(got_ids) == len(np.unique(segmentation)) - 1
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    assert rel_err(got, ref) <= 1e-5
    # the same embeddings give the same features to the bit
    same = pfeat(embs["jax"][kind], segmentation, verbose=False)[1]
    assert np.array_equal(same, ref)


def test_classifier_round_trip(embeddings, models, tmp_path):
    """train_classifier, joblib's file, run_prediction_with_object_classifier
    with the projection and without, and project_prediction_to_segmentation
    against the JAX package's."""
    import joblib
    from micro_sam_tpu.object_classification import project_prediction_to_segmentation as jproj
    from micro_sam_tpu_torch import object_classification as oc
    embs, image, seg, _ = embeddings
    ids, feats = oc.compute_object_features(embs["port"]["2d"], seg, verbose=False)
    labels = (np.arange(len(ids)) % 2) + 1
    rf = oc.train_classifier(feats, labels, n_estimators=20)
    pred = oc.run_prediction_with_classifier(rf, feats)
    assert np.array_equal(pred, labels)
    path = str(tmp_path / "rf.joblib")
    joblib.dump(rf, path)
    (projected,) = oc.run_prediction_with_object_classifier([image], [seg], models[1], path)
    assert np.array_equal(projected, jproj(seg, pred, ids))
    assert np.array_equal(projected, oc.project_prediction_to_segmentation(seg, pred, ids))
    assert set(np.unique(projected)) == {0, 1, 2}
    (raw,) = oc.run_prediction_with_object_classifier([image], [seg], models[1], path,
                                                      project_prediction=False)
    assert np.array_equal(raw, pred)


@pytest.mark.parametrize("as_rgb", [True, False])
def test_compute_pca_matches_jax(embeddings, as_rgb):
    from micro_sam_tpu.visualization import compute_pca as jpca
    from micro_sam_tpu_torch.visualization import compute_pca as ppca
    embs = embeddings[0]
    got = ppca(np.asarray(embs["port"]["2d"]["features"]), as_rgb=as_rgb)
    ref = jpca(np.asarray(embs["jax"]["2d"]["features"]), as_rgb=as_rgb)
    assert got.shape == ref.shape == (8, 8, 3)  # the 8 x 8 grid of a 128 px encoder
    scale = 1.0 if as_rgb else np.abs(ref).max()
    assert np.abs(_aligned(got, ref, as_rgb) - ref).max() <= 1e-5 * scale
    if as_rgb:
        assert got.min() >= 0 and got.max() <= 1


@pytest.mark.parametrize("kind", ["2d", "3d", "tiled"])
def test_projection_for_visualization_matches_jax(embeddings, kind):
    from micro_sam_tpu.visualization import project_embeddings_for_visualization as jvis
    from micro_sam_tpu_torch.visualization import project_embeddings_for_visualization as pvis
    embs = embeddings[0]
    got, got_scale = pvis(embs["port"][kind])
    ref, ref_scale = jvis(embs["jax"][kind])
    assert got.shape == ref.shape and got_scale == ref_scale
    if kind == "3d":
        for z in range(len(got)):
            assert np.abs(_aligned(got[z], ref[z], True) - ref[z]).max() <= 1e-5
    elif kind == "2d":
        assert got.shape[:2] == (8, 6)  # the square padding cropped off
        assert np.abs(_aligned(got, ref, True) - ref).max() <= 1e-5
    else:  # per-tile PCAs pasted side by side: align each tile's block
        e = got.shape[0] // 2
        for y in range(0, got.shape[0], e):
            for x in range(0, got.shape[1], e):
                g, r = got[y:y + e, x:x + e], ref[y:y + e, x:x + e]
                assert np.abs(_aligned(g, r, True) - r).max() <= 1e-5
