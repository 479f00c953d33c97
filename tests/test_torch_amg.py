"""The port's AMG device decode (predictor.amg_decode) and its automatic mask
generators (instance_segmentation.py) against the JAX package, on the tiny
config over the same weights (f32, CPU).

The decoder's last hypernetwork layers are scaled by 30 in both packages'
weights, so that random weights give masks stable enough to pass the
default prefilter floors (0.5, 0.5).

Tolerances: packed bits and boxes equal, iou and stability within 1e-4;
records equal (count, order, points, crop boxes, boxes, areas, masks) except
pixels whose port logit lies within 1e-3 of the threshold (such a pixel may
flip between the packages, 1e-5 apart in f32), with ``predicted_iou`` within
1e-4 and ``stability_score`` within 1e-4 plus what the pixels within 1e-3 of
the stability thresholds (threshold +- 1) could move it by. Crops that are resized take the port's
(PIL-exact) resize in both packages, and tiled AMG gets the same tiled
embeddings in both, so that both decode the same features.
"""
import numpy as np
import pytest
import torch

from tests.torch_port_util import jax_params, one_thread, port_sam, tiny_jax_config


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: tier-1's six test processes share the
    machine's cores, and small tensors gain nothing from more (ROADMAP.md,
    Budgets)."""
    with one_thread():
        yield


FLIP = 1e-3
TOL = 1e-4


@pytest.fixture(scope="module")
def predictors():
    from micro_sam_tpu.models.sam import Sam as JaxSam
    from micro_sam_tpu.predictor import SamPredictor as JaxPredictor
    from micro_sam_tpu_torch.predictor import SamPredictor
    cfg = tiny_jax_config()
    params = jax_params(cfg)
    for h in params["mask_decoder"]["hyper_mlps"]:
        h["layers"][2]["w"] = h["layers"][2]["w"] * 30.0
        h["layers"][2]["b"] = h["layers"][2]["b"] * 30.0
    jp = JaxPredictor(JaxSam(cfg, params))
    pp = SamPredictor(port_sam(cfg, params))
    jp.transform.apply_image = pp.transform.apply_image  # the same pixels into both encoders
    return jp, pp


@pytest.fixture(scope="module")
def image():
    from micro_sam_tpu.sample_data import synthetic_data
    return synthetic_data(shape=(256, 256), seed=7)[0]


class NearThreshold:
    """Records, for each candidate the port's AMG decodes, the pixels whose
    logit lies within FLIP of the threshold, in the full image's frame,
    keyed by (point in the image frame, crop box XYXY); the three masks of a
    point share one map."""

    def __init__(self, monkeypatch):
        import micro_sam_tpu_torch.predictor as pred
        from micro_sam_tpu_torch.instance_segmentation import AutomaticMaskGenerator
        self.maps, self.slack, self.logits = {}, {}, []
        post, batch_data = pred.postprocess_masks, AutomaticMaskGenerator._batch_data

        def record(masks, *a, **k):
            out = post(masks, *a, **k)
            self.logits.append(out)
            return out

        def batch(gen, survivors, points, crop_box, original_size):
            logits = self.logits[-1]
            near = (logits.abs() < FLIP).any(dim=1).numpy()  # (B, h, w)
            # the stability score counts pixels above +-1 (the offset): a
            # pixel within FLIP of either may flip too, moving the score by
            # about 1 / (the count above -1)
            at_offset = (((logits - 1).abs() < FLIP) | ((logits + 1).abs() < FLIP)).sum((-2, -1))
            low = (logits > -1).sum((-2, -1))
            slack = (at_offset.double() / (low - at_offset).clamp_min(1).double()).amax(1)
            x0, y0, x1, y1 = crop_box
            for p, m, sl in zip(np.asarray(points), near, slack.tolist()):
                full = np.zeros(tuple(original_size), bool)
                full[y0:y0 + m.shape[0], x0:x0 + m.shape[1]] = m
                key = (tuple(p + np.array([x0, y0])), tuple(crop_box))
                self.maps[key], self.slack[key] = full, TOL + sl
            return batch_data(gen, survivors, points, crop_box, original_size)

        monkeypatch.setattr(pred, "postprocess_masks", record)
        monkeypatch.setattr(AutomaticMaskGenerator, "_batch_data", batch)

    def key(self, record):
        x, y, w, h = record["crop_box"]
        return tuple(record["point_coords"][0]), (x, y, x + w, y + h)

    def of(self, record):
        return self.maps[self.key(record)]

    def union(self):
        return np.any(np.stack(list(self.maps.values())), axis=0)


def _rle_mask(rle):
    from micro_sam_tpu_torch.ops.amg_utils import rle_to_mask
    return rle_to_mask({"size": rle["size"], "counts": [int(c) for c in rle["counts"]]})


def _assert_records_match(got, ref, near, mode, binary=None):
    """got / ref: the port's / the JAX package's ``generate`` output in ``mode``."""
    if mode == "instance_segmentation":
        assert got.shape == ref.shape and got.dtype == ref.dtype
        differ = got != ref
        assert not (differ & ~near.union()).any(), int((differ & ~near.union()).sum())
        return 0
    assert len(got) == len(ref)
    flips = 0
    for k, (g, r) in enumerate(zip(got, ref)):
        assert g["point_coords"] == r["point_coords"] and g["crop_box"] == r["crop_box"]
        assert abs(g["predicted_iou"] - r["predicted_iou"]) <= TOL
        assert abs(g["stability_score"] - r["stability_score"]) <= near.slack[near.key(g)]
        if mode == "coco_rle":
            assert g["segmentation"]["size"] == r["segmentation"]["size"]
            if binary is not None and binary[k]:
                assert g["segmentation"] == r["segmentation"]
            continue
        gm, rm = ((g["segmentation"], r["segmentation"]) if mode == "binary_mask"
                  else (_rle_mask(g["segmentation"]), _rle_mask(r["segmentation"])))
        differ = gm != rm
        assert not (differ & ~near.of(g)).any()
        flips += int(differ.sum())
        if not differ.any():
            assert g["bbox"] == [int(v) for v in r["bbox"]] and g["area"] == r["area"]
    return flips


MODES = ("binary_mask", "rle", "coco_rle", "instance_segmentation")


def _assert_crop_lists_match(pg, jg, near):
    """The state ``initialize`` leaves, crop by crop: the same candidates in
    the same order, their RLEs, boxes and points, iou and stability."""
    assert [len(c) for c in pg.crop_list] == [len(c) for c in jg.crop_list]
    for got, ref, box in zip(pg.crop_list, jg.crop_list, pg.crop_boxes):
        np.testing.assert_array_equal(got["points"], ref["points"])
        np.testing.assert_allclose(got["iou_preds"], ref["iou_preds"], rtol=0, atol=TOL)
        for k, (g, r) in enumerate(zip(got["rles"], ref["rles"])):
            key = (tuple(got["points"][k] + np.asarray(box[:2])), tuple(box))  # in the image
            assert abs(got["stability_score"][k] - ref["stability_score"][k]) <= near.slack[key]
            differ = _rle_mask(g) != _rle_mask(r)
            assert not (differ & ~near.maps[key]).any()
            if not differ.any():
                np.testing.assert_array_equal(got["boxes"][k], ref["boxes"][k])


def _generate_both(jg, pg, near, **kw):
    """Every output mode of both generators, checked; returns the port's
    binary records."""
    out = {}
    exact = None
    for mode in MODES:
        got, ref = pg.generate(output_mode=mode, **kw), jg.generate(output_mode=mode, **kw)
        _assert_records_match(got, ref, near, mode, exact)
        if mode == "binary_mask":
            exact = [bool((g["segmentation"] == r["segmentation"]).all())
                     for g, r in zip(got, ref)]
        out[mode] = got
    return out


# ---------------------------------------------------------------------------
# the device decode
# ---------------------------------------------------------------------------

def _decode_inputs(predictors, original_size, seed):
    from micro_sam_tpu_torch.ops.amg_utils import build_point_grid
    jp, pp = predictors
    feats = np.random.RandomState(seed).randn(1, 256, 16, 16).astype(np.float32)
    for p in (jp, pp):
        p.set_features(feats, original_size=original_size)
    grid = build_point_grid(4) * np.array(original_size)[None, ::-1]
    xy = pp.transform.apply_coords(grid, original_size).astype(np.float32)
    B = len(xy)
    pts = np.concatenate([xy[:, None], np.zeros((B, 1, 2), np.float32)], 1)
    lbl = np.tile(np.array([[1, -1]], np.int32), (B, 1))
    return xy, pts, lbl


def _port_logits(pp, xy):
    from micro_sam_tpu_torch.models.sam import postprocess_masks
    B = len(xy)
    pts = torch.from_numpy(np.concatenate([xy[:, None], np.zeros((B, 1, 2), np.float32)], 1))
    low, _ = pp.model.decode_masks(pp.features, pts, torch.tensor([[1, -1]]).expand(B, 2))
    return postprocess_masks(low[:, 1:], pp.input_size, pp.original_size, 256).numpy()


@pytest.mark.parametrize("original_size", [(256, 256), (250, 180)], ids=["256x256", "250x180"])
def test_amg_decode_matches_jax(predictors, original_size):
    """Packed bytes equal to the JAX program's (250 is no multiple of 8: the
    per-column pad bits), iou and stability within 1e-4, boxes equal."""
    import jax.numpy as jnp
    from micro_sam_tpu.predictor import _amg_decode_impl
    from micro_sam_tpu_torch.predictor import amg_decode
    jp, pp = predictors
    xy, pts, lbl = _decode_inputs(predictors, original_size, seed=11)
    packed, iou, stab, boxes = (np.asarray(a) for a in _amg_decode_impl(
        jp.model, jp.model.params, jp.features, jnp.asarray(pts), jnp.asarray(lbl), 0.0, 1.0,
        tuple(jp.input_size), tuple(jp.original_size)))
    got = {k: v.numpy() for k, v in amg_decode(pp, xy).items()}
    H, W = original_size
    assert got["packed"].shape == packed.shape == (len(xy) * 3, W, -(-H // 8))
    np.testing.assert_array_equal(got["order"], np.arange(len(xy) * 3))
    np.testing.assert_allclose(got["iou"], iou.reshape(-1), rtol=0, atol=TOL)
    np.testing.assert_allclose(got["stability"], stab.reshape(-1), rtol=0, atol=TOL)
    differ = got["packed"] != packed
    if differ.any():  # only pixels at the threshold may flip
        near = np.abs(_port_logits(pp, xy)).reshape(-1, H, W) < FLIP
        bits = lambda p: np.unpackbits(p, axis=-1)[..., :H].transpose(0, 2, 1)  # noqa: E731
        flipped = bits(got["packed"]) != bits(packed)
        assert not (flipped & ~near).any()
        same = ~flipped.any(axis=(1, 2))
    else:
        same = np.ones(len(packed), bool)
    assert same.mean() > 0.9
    np.testing.assert_array_equal(got["boxes"][same], boxes.reshape(-1, 4)[same])


@pytest.mark.parametrize("quantile", [0.25, 0.6])
def test_amg_decode_survivors_match_jax(predictors, quantile):
    """Survivors of the floors: the same rows, in the same order, as the JAX
    compacting program (without its crop-window transfer)."""
    import jax.numpy as jnp
    from micro_sam_tpu.predictor import _amg_compact_impl
    from micro_sam_tpu_torch.predictor import amg_decode
    jp, pp = predictors
    xy, pts, lbl = _decode_inputs(predictors, (250, 180), seed=12)
    all_rows = amg_decode(pp, xy)

    def floor(v):  # the middle of the widest gap near the quantile: no value sits on it
        s = np.sort(v.numpy())
        i = int(quantile * len(s))
        j = max(range(max(i - 4, 0), min(i + 4, len(s) - 1)), key=lambda n: s[n + 1] - s[n])
        return float((s[j] + s[j + 1]) / 2)
    floors = (floor(all_rows["iou"]), floor(all_rows["stability"]))
    ref = _amg_compact_impl(jp.model, jp.model.params, jp.features, jnp.asarray(pts),
                            jnp.asarray(lbl), len(xy), 0.0, 1.0, tuple(jp.input_size),
                            tuple(jp.original_size), floors[0], floors[1], None)
    n = int(ref["n"])
    got = amg_decode(pp, xy, prefilter=floors)
    assert 0 < n < len(xy) * 3
    np.testing.assert_array_equal(got["order"].numpy(), np.asarray(ref["order"])[:n])
    np.testing.assert_allclose(got["iou"].numpy(), np.asarray(ref["iou"])[:n], atol=TOL)
    keep = all_rows["order"][got["order"]]
    assert torch.equal(got["packed"], all_rows["packed"][keep])


# ---------------------------------------------------------------------------
# the generators end to end
# ---------------------------------------------------------------------------

GENERATORS = {
    "all candidates": (dict(prefilter_thresholds=None),
                       [dict(pred_iou_thresh=0.0, stability_score_thresh=0.0,
                             box_nms_thresh=1.0),
                        dict(pred_iou_thresh=0.0, stability_score_thresh=0.0)]),
    "default floors": (dict(), [dict(pred_iou_thresh=0.5, stability_score_thresh=0.5,
                                     box_nms_thresh=1.0),
                                dict(pred_iou_thresh=0.7, stability_score_thresh=0.9,
                                     box_nms_thresh=0.95)]),
    "crop layer": (dict(prefilter_thresholds=None, crop_n_layers=1),
                   [dict(pred_iou_thresh=0.5, stability_score_thresh=0.5, box_nms_thresh=1.0,
                         crop_nms_thresh=1.0),
                    dict(pred_iou_thresh=0.5, stability_score_thresh=0.5)]),
    "small regions": (dict(prefilter_thresholds=(0.5, 0.5)),
                      [dict(pred_iou_thresh=0.5, stability_score_thresh=0.5, box_nms_thresh=1.0,
                            min_mask_region_area=20),
                       dict(pred_iou_thresh=0.5, stability_score_thresh=0.5, box_nms_thresh=1.0,
                            min_mask_region_area=3000)]),
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_amg_matches_jax(predictors, image, monkeypatch, name):
    from micro_sam_tpu.instance_segmentation import AutomaticMaskGenerator as JaxAMG
    from micro_sam_tpu_torch.instance_segmentation import AutomaticMaskGenerator
    jp, pp = predictors
    near = NearThreshold(monkeypatch)
    kw, generates = GENERATORS[name]
    jg = JaxAMG(jp, points_per_side=4, points_per_batch=16, **kw)
    pg = AutomaticMaskGenerator(pp, points_per_side=4, points_per_batch=16, **kw)
    jg.initialize(image)
    pg.initialize(image)
    _assert_crop_lists_match(pg, jg, near)
    n_records = []
    for gkw in generates:
        out = _generate_both(jg, pg, near, **gkw)
        n_records.append(len(out["binary_mask"]))
        assert out["instance_segmentation"].shape == image.shape
    assert n_records[0] >= 4, n_records


def test_amg_state_round_trip(predictors, image, monkeypatch):
    from micro_sam_tpu.instance_segmentation import AutomaticMaskGenerator as JaxAMG
    from micro_sam_tpu_torch.instance_segmentation import AutomaticMaskGenerator
    jp, pp = predictors
    near = NearThreshold(monkeypatch)
    pg = AutomaticMaskGenerator(pp, points_per_side=4, points_per_batch=16)
    pg.initialize(image)
    state = pg.get_state()
    assert state["prefilter_thresholds"] == (0.5, 0.5)
    restored = AutomaticMaskGenerator(pp, points_per_side=4, prefilter_thresholds=None)
    restored.set_state(state)
    jg = JaxAMG(jp, points_per_side=4, points_per_batch=16)
    jg.initialize(image)
    kw = dict(pred_iou_thresh=0.6, stability_score_thresh=0.6, box_nms_thresh=1.0)
    _generate_both(jg, restored, near, **kw)
    np.testing.assert_array_equal(restored.generate(**kw), pg.generate(**kw))
    pg.clear_state()
    assert not pg.is_initialized
    with pytest.raises(RuntimeError):
        pg.get_state()


def test_amg_below_the_floors(predictors, image, monkeypatch):
    """generate under the floors: a generator that ran its own initialize
    warns and redoes the decode (then equals the JAX package's); restored
    state raises."""
    from micro_sam_tpu.instance_segmentation import AutomaticMaskGenerator as JaxAMG
    from micro_sam_tpu_torch.instance_segmentation import AutomaticMaskGenerator
    jp, pp = predictors
    near = NearThreshold(monkeypatch)
    pg = AutomaticMaskGenerator(pp, points_per_side=4, points_per_batch=16)
    pg.initialize(image)
    state = pg.get_state()
    n_before = len(pg.crop_list[0])
    kw = dict(pred_iou_thresh=-0.5, stability_score_thresh=0.3, box_nms_thresh=1.0,
              output_mode="binary_mask")
    with pytest.warns(UserWarning, match="below the device prefilter floors"):
        got = pg.generate(**kw)
    assert pg._prefilter_thresholds == (-0.5, 0.3) and len(pg.crop_list[0]) > n_before
    jg = JaxAMG(jp, points_per_side=4, points_per_batch=16)
    jg.initialize(image)
    with pytest.warns(UserWarning):
        ref = jg.generate(**kw)
    _assert_records_match(got, ref, near, "binary_mask")
    restored = AutomaticMaskGenerator(pp, points_per_side=4)
    restored.set_state(state)
    with pytest.raises(ValueError, match="below"):
        restored.generate(**kw)


def test_tiled_amg_matches_jax(predictors, monkeypatch):
    from micro_sam_tpu.instance_segmentation import TiledAutomaticMaskGenerator as JaxTiled
    from micro_sam_tpu_torch.instance_segmentation import TiledAutomaticMaskGenerator
    from micro_sam_tpu_torch.sample_data import synthetic_data
    from micro_sam_tpu_torch.util import precompute_image_embeddings
    jp, pp = predictors
    image = synthetic_data(shape=(256, 320), seed=8)[0]
    emb = precompute_image_embeddings(pp, image, tile_shape=(128, 128), halo=(32, 32),
                                      verbose=False)
    assert sorted(emb["features"]) == list(range(6))
    near = NearThreshold(monkeypatch)
    jg = JaxTiled(jp, points_per_side=4, points_per_batch=16)
    pg = TiledAutomaticMaskGenerator(pp, points_per_side=4, points_per_batch=16)
    jg.initialize(image, image_embeddings=emb)
    pg.initialize(image, image_embeddings=emb, tile_shape=(128, 128), halo=(32, 32))
    assert pg.crop_boxes == jg.crop_boxes and len(pg.crop_boxes) == 6
    _assert_crop_lists_match(pg, jg, near)
    assert sum(len(c) for c in pg.crop_list) >= 6 * 16
    # random weights give masks as large as a tile: the crop-edge filter
    # leaves none, and the records compare empty
    out = _generate_both(jg, pg, near, pred_iou_thresh=0.5, stability_score_thresh=0.5,
                         box_nms_thresh=1.0)
    assert out["instance_segmentation"].shape == image.shape
    with pytest.raises(ValueError, match="Inconsistent tile_shape"):
        pg.initialize(image, image_embeddings=emb, tile_shape=(96, 96))
