"""The port's batched prompt inference (inference.py), flat and tiled, against
the JAX package on the tiny config over the same weights and embeddings (f32,
CPU); and ``models/convert.params_from_flat_npz`` on the trained AMG fixture.

Every prompt here gives both decoders the same tokens (a box, or one point
and its pad point). Tolerances: low-res logits rel <= 1e-4 of max|ref|,
predicted IoU abs <= 1e-4, stability abs <= 1e-4 plus what the pixels within
1e-3 of the stability thresholds could move it by; masks, boxes and the
instance segmentation equal except pixels whose port logit lies within 1e-3
of the threshold. The fixture's tensors equal.
"""
import os

import numpy as np
import pytest
import torch

from tests.torch_port_util import jax_params, one_thread, port_sam, rel_err, tiny_jax_config


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: tier-1's six test processes share the
    machine's cores, and small tensors gain nothing from more (ROADMAP.md,
    Budgets)."""
    with one_thread():
        yield


TILE, HALO = (128, 128), (32, 32)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "bench_sam_tiny1024.npz")


@pytest.fixture(scope="module")
def predictors():
    from micro_sam_tpu.models.sam import Sam as JaxSam
    from micro_sam_tpu.predictor import SamPredictor as JaxPredictor
    from micro_sam_tpu_torch.predictor import SamPredictor
    cfg = tiny_jax_config()
    params = jax_params(cfg)
    for h in params["mask_decoder"]["hyper_mlps"]:  # sharper masks from random weights
        h["layers"][2]["w"] = h["layers"][2]["w"] * 30.0
        h["layers"][2]["b"] = h["layers"][2]["b"] * 30.0
    return JaxPredictor(JaxSam(cfg, params)), SamPredictor(port_sam(cfg, params))


@pytest.fixture(scope="module")
def data(predictors):
    from micro_sam_tpu_torch.sample_data import synthetic_data
    from micro_sam_tpu_torch.util import get_centers_and_bounding_boxes, precompute_image_embeddings
    _, pp = predictors
    image, seg = synthetic_data(shape=(256, 320), seed=7)
    centers, bboxes = get_centers_and_bounding_boxes(seg)
    ids = sorted(bboxes)
    boxes = np.array([[bboxes[i][1][0], bboxes[i][0][0], bboxes[i][1][1], bboxes[i][0][1]]
                      for i in ids], dtype=np.float64)
    points = np.array([[[centers[i][1], centers[i][0]]] for i in ids])
    return {"image": image, "seg": seg, "boxes": boxes, "points": points,
            "untiled": precompute_image_embeddings(pp, image, verbose=False),
            "tiled": precompute_image_embeddings(pp, image, tile_shape=TILE, halo=HALO,
                                                 verbose=False)}


class PortLogits:
    """The port's high-res mask logits of every decode, in order."""

    def __init__(self, monkeypatch):
        import micro_sam_tpu_torch.predictor as pred
        post, self.batches = pred.postprocess_masks, []

        def record(masks, *a, **k):
            out = post(masks, *a, **k)
            self.batches.append(out)
            return out
        monkeypatch.setattr(pred, "postprocess_masks", record)

    def all(self):
        return torch.cat([b.reshape(-1, *b.shape[-2:]) for b in self.batches]).numpy()


def _assert_records_match(got, ref, logits, thr):
    """Mask records of one frame, the k-th from the k-th decoded logit map."""
    assert len(got) == len(ref) == len(logits)
    for g, r, lg, t in zip(got, ref, logits, np.broadcast_to(thr, (len(got),))):
        assert g["seg_id"] == r["seg_id"]
        assert abs(g["predicted_iou"] - r["predicted_iou"]) <= 1e-4
        at_offset = ((np.abs(lg - t - 1) < 1e-3) | (np.abs(lg - t + 1) < 1e-3)).sum()
        low = max(int((lg > t - 1).sum()) - int(at_offset), 1)
        assert abs(g["stability_score"] - r["stability_score"]) <= 1e-4 + at_offset / low
        assert rel_err(g["logits"], np.asarray(r["logits"])) <= 1e-4
        differ = g["segmentation"] != np.asarray(r["segmentation"])
        assert not (differ & ~(np.abs(lg - t) < 1e-3)).any()
        if not differ.any():
            assert g["bbox"] == [int(v) for v in r["bbox"]] and g["area"] == r["area"]


PROMPTS = {"boxes": dict(kind="boxes"), "points": dict(kind="points"),
           "points, auto threshold": dict(kind="points", mask_threshold="auto")}


@pytest.mark.parametrize("name", list(PROMPTS))
def test_batched_inference_matches_jax(predictors, data, monkeypatch, name):
    from micro_sam_tpu import inference as jinf
    from micro_sam_tpu_torch import inference as pinf
    jp, pp = predictors
    kind = PROMPTS[name]["kind"]
    thr = PROMPTS[name].get("mask_threshold")
    # the automatic threshold's windowed histograms cost seconds an image: 4 prompts
    n = 4 if thr == "auto" else len(data["points"])
    prompts = dict(boxes=data["boxes"]) if kind == "boxes" else \
        dict(points=data["points"][:n], point_labels=np.ones((n, 1), np.int64))
    kw = dict(image=None, batch_size=3, mask_threshold=thr, **prompts)
    for p in (jp, pp):
        p.set_features(data["untiled"]["features"], data["untiled"]["original_size"],
                       data["untiled"]["input_size"])
    logits = PortLogits(monkeypatch)
    got = pinf.batched_inference(pp, return_instance_segmentation=False, **kw)
    ref = jinf.batched_inference(jp, return_instance_segmentation=False, **kw)
    lg = logits.all()
    if thr == "auto":
        lowres = np.concatenate([r["logits"] for r in ref])[:, None]
        t = pinf._local_otsu_threshold(lowres).reshape(-1)
        np.testing.assert_array_equal(t, jinf._local_otsu_threshold(lowres).reshape(-1))
    else:
        t = 0.0
    _assert_records_match(got, ref, lg, t)
    near = (np.abs(lg - np.reshape(t, (-1, 1, 1))) < 1e-3).any(axis=0)
    seg_g = pinf.batched_inference(pp, **kw)
    seg_r = jinf.batched_inference(jp, **kw)
    assert seg_g.shape == data["image"].shape and seg_g.dtype == seg_r.dtype
    assert not ((seg_g != seg_r) & ~near).any()
    assert len(np.unique(seg_g)) > 2


def test_batched_inference_rejects_bad_prompts(predictors):
    from micro_sam_tpu_torch.inference import batched_inference
    _, pp = predictors
    with pytest.raises(ValueError, match="together"):
        batched_inference(pp, None, 4, points=np.zeros((2, 1, 2)))
    with pytest.raises(ValueError, match="disagree"):
        batched_inference(pp, None, 4, boxes=np.zeros((2, 4)), points=np.zeros((3, 1, 2)),
                          point_labels=np.ones((3, 1)))
    with pytest.raises(ValueError, match="No prompts"):
        batched_inference(pp, None, 4)


@pytest.mark.parametrize("optimize_memory", [False, True], ids=["records", "per-tile NMS"])
def test_batched_tiled_inference_matches_jax(predictors, data, monkeypatch, optimize_memory):
    from micro_sam_tpu import inference as jinf
    from micro_sam_tpu_torch import inference as pinf
    from micro_sam_tpu_torch.utils.blocking import Blocking
    jp, pp = predictors
    emb = data["tiled"]
    kw = dict(image=None, batch_size=4, image_embeddings=emb, boxes=data["boxes"],
              optimize_memory=optimize_memory)
    if optimize_memory:
        kw["min_size"] = 0  # util.apply_nms's
    logits = PortLogits(monkeypatch)
    got = pinf.batched_tiled_inference(pp, return_instance_segmentation=False, **kw)
    ref = jinf.batched_tiled_inference(jp, return_instance_segmentation=False, **kw)
    tiling = Blocking([0, 0], emb["shape"], TILE)
    routed = pinf._route_prompts_to_tiles(pinf._PromptSet(data["boxes"], None, None, None),
                                          tiling, HALO)
    # each tile's prompts decoded once, tile by tile, in batches of 4
    per_tile = [-(-len(routed[t]) // 4) for t in sorted(routed)]
    assert len(logits.batches) == sum(per_tile) and len(routed) > 1
    near = np.zeros(emb["shape"], bool)
    b = 0
    tile_logits = []
    for tid, nb in zip(sorted(routed), per_tile):
        lg = torch.cat([x.reshape(-1, *x.shape[-2:]) for x in logits.batches[b:b + nb]]).numpy()
        b += nb
        tile_logits.append(lg)
        sl = tiling.get_block_with_halo(tid, list(HALO)).outer_block.slicing
        near[sl] |= (np.abs(lg) < 1e-3).any(axis=0)
    if optimize_memory:
        assert got.shape == ref.shape == emb["shape"] and got.dtype == ref.dtype
        assert not ((got != ref) & ~near).any()
        assert len(np.unique(got)) > 2
        return
    assert [g["global_bbox"] for g in got] == [r["global_bbox"] for r in ref] or \
        any((g["segmentation"] != r["segmentation"]).any() for g, r in zip(got, ref))
    k = 0
    for lg in tile_logits:
        _assert_records_match(got[k:k + len(lg)], ref[k:k + len(lg)], lg, 0.0)
        k += len(lg)
    seg_g = pinf.batched_tiled_inference(pp, **{**kw, "optimize_memory": False})
    seg_r = jinf.batched_tiled_inference(jp, **{**kw, "optimize_memory": False})
    assert seg_g.shape == emb["shape"] and not ((seg_g != seg_r) & ~near).any()
    assert len(np.unique(seg_g)) > 2


def test_mask_data_to_segmentation_and_apply_nms_match_jax(predictors, data):
    from micro_sam_tpu import util as jutil
    from micro_sam_tpu_torch import util as putil
    from micro_sam_tpu_torch.inference import batched_inference
    _, pp = predictors
    pp.set_features(data["untiled"]["features"], data["untiled"]["original_size"],
                    data["untiled"]["input_size"])
    records = batched_inference(pp, None, 8, boxes=data["boxes"],
                                return_instance_segmentation=False)
    for kw in (dict(), dict(min_object_size=200), dict(with_background=True),
               dict(merge_exclusively=False, max_object_size=3000)):
        np.testing.assert_array_equal(putil.mask_data_to_segmentation(records, **kw),
                                      jutil.mask_data_to_segmentation(records, **kw))
    for kw in (dict(min_size=10), dict(min_size=0, perform_box_nms=True, nms_thresh=0.5),
               dict(min_size=0, intersection_over_min=True, nms_thresh=0.5)):
        np.testing.assert_array_equal(putil.apply_nms(records, **kw),
                                      jutil.apply_nms(records, **kw))


@pytest.mark.skipif(not os.path.exists(FIXTURE), reason="fixture not built")
def test_params_from_flat_npz_matches_jax_loader():
    import jax
    from bench import _load_bench_fixture
    from micro_sam_tpu_torch.models.convert import params_from_flat_npz, params_from_jax
    from micro_sam_tpu_torch.models.sam import Sam
    cfg_j, params = _load_bench_fixture(FIXTURE)
    cfg, sd = params_from_flat_npz(FIXTURE)
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.window_size, cfg.img_size,
            cfg.global_attn_indexes) == (cfg_j.embed_dim, cfg_j.depth, cfg_j.num_heads,
                                         cfg_j.window_size, cfg_j.img_size,
                                         cfg_j.global_attn_indexes)
    ref = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    assert sorted(sd) == sorted(ref)
    for k in ref:
        assert sd[k].dtype == ref[k].dtype == torch.float32
        assert torch.equal(sd[k], ref[k]), k
    Sam(cfg).load_state_dict(sd)
