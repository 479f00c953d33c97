"""The port's annotators (micro_sam_tpu_torch/sam_annotator) against the JAX
package's, on the tiny config of tests/torch_port_util.py (f32, CPU): every
case of tests/test_sam_annotator.py and tests/test_widgets.py replayed in both
packages with the same FakeViewer actions.

Both packages read the port's embeddings where a case hands them in (the
cache layout is shared), and the JAX predictor's power-of-two prompt buckets
are turned off, so the decodes differ by f32 rounding only. Tolerances:
prompts from the point / shape layers exactly equal; masks of
``prompt_segmentation`` and of the segment key at IoU >= 0.99 per object;
``segment_slices_with_prompts`` / ``SegmentNDWidget`` at IoU >= 0.99 a slice
with equal slices and z ranges; commit relabeling and ``commit_to_file``
bitwise; tracking state and lineage equal; AMG / AIS auto-segmentation with
>= 98 % of the objects matched at IoU >= 0.99 both ways (the bound of
tests/test_torch_ais.py);
image-series files equal; object features within rel 1e-3 with equal
predictions; training-widget loaders' batches equal.
"""
import importlib
import os
import sys
import types

import numpy as np
import pytest

from tests.torch_port_util import (AIS_KW, jax_params, matched_share,
                                   one_thread, port_sam, port_unetr, rel_err, tiny_jax_config,
                                   unetr_jax_params)

JAX, PORT = "micro_sam_tpu", "micro_sam_tpu_torch"
PKGS = (JAX, PORT)
SIZE = 256   # the tiny model's input size
IOU = 0.99


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def models():
    """{package: predictor} of one set of weights, the hypernetworks' last
    layers scaled for sharp masks; the same pixels into both encoders."""
    from micro_sam_tpu.models.sam import Sam as JaxSam
    from micro_sam_tpu.predictor import SamPredictor as JaxPredictor
    from micro_sam_tpu_torch.predictor import SamPredictor
    cfg = tiny_jax_config(img_size=SIZE)
    params = jax_params(cfg)
    for h in params["mask_decoder"]["hyper_mlps"]:
        h["layers"][2]["w"] = h["layers"][2]["w"] * 30.0
        h["layers"][2]["b"] = h["layers"][2]["b"] * 30.0
    jp, pp = JaxPredictor(JaxSam(cfg, params)), SamPredictor(port_sam(cfg, params))
    jp.transform.apply_image = pp.transform.apply_image
    for p in (jp, pp):
        p.model_type = p.model_name = "vit_b"
    return {JAX: jp, PORT: pp}


@pytest.fixture(autouse=True)
def exact_prompts(monkeypatch):
    import micro_sam_tpu.predictor as jpred
    monkeypatch.setattr(jpred, "_next_pow2", lambda n: n)


def _reset(state):
    state.reset_state()
    state.widgets = {}
    state.annotator = None
    state.skip_recomputing_embeddings = False


@pytest.fixture(autouse=True)
def states():
    """Both packages' AnnotatorState singletons, reset around each test."""
    out = {pkg: mod(pkg, "sam_annotator._state").AnnotatorState() for pkg in PKGS}
    for s in out.values():
        _reset(s)
    yield out
    for s in out.values():
        _reset(s)


@pytest.fixture(autouse=True)
def messages():
    """Both packages' messages collected; errors abort, infos proceed."""
    logs = {}
    for pkg in PKGS:
        compat = mod(pkg, "sam_annotator._compat")
        logs[pkg] = []
        compat.set_message_handler(lambda t, m, log=logs[pkg]: log.append((t, m)) or t == "error")
    yield logs
    for pkg in PKGS:
        mod(pkg, "sam_annotator._compat").set_message_handler(None)


@pytest.fixture
def tiny_models(models, monkeypatch):
    """Both packages' get_sam_model return the tiny predictors."""
    for pkg in PKGS:
        def fake(model_type="vit_b", device=None, checkpoint_path=None, return_state=False,
                 predictor=models[pkg], **kwargs):
            return (predictor, {}) if return_state else predictor
        monkeypatch.setattr(mod(pkg, "util"), "get_sam_model", fake)
    return models


def _embeddings(models, data, ndim=None):
    """The port's embeddings of ``data``, read by both packages."""
    from micro_sam_tpu_torch.util import precompute_image_embeddings
    return precompute_image_embeddings(models[PORT], data, ndim=ndim, verbose=False)


def iou(a, b):
    a, b = np.asarray(a) > 0, np.asarray(b) > 0
    union = np.logical_or(a, b).sum()
    return 1.0 if union == 0 else np.logical_and(a, b).sum() / union


def assert_labels_match(got, ref, tol=IOU):
    """The same ids, each object at IoU >= tol."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    ids = np.unique(ref)
    np.testing.assert_array_equal(np.unique(got), ids)
    for i in ids[ids != 0]:
        assert iou(got == i, ref == i) >= tol, i


def assert_slices_match(got, ref, tol=IOU):
    for z in range(ref.shape[0]):
        assert_labels_match(got[z], ref[z], tol)


@pytest.fixture(scope="module")
def image():
    from micro_sam_tpu_torch.sample_data import synthetic_data
    return synthetic_data(shape=(SIZE, SIZE), seed=42)


def _synthetic(**kw):
    from micro_sam_tpu_torch.sample_data import synthetic_data
    return synthetic_data(**kw)


# ---------------------------------------------------------------------------
# tests/test_sam_annotator.py, replayed
# ---------------------------------------------------------------------------

def test_state_and_tracking_bookkeeping(states):
    out = {}
    for pkg in PKGS:
        state = states[pkg]
        assert mod(pkg, "sam_annotator._state").AnnotatorState() is state
        assert not state.initialized_for_interactive_segmentation()
        assert not state.initialized_for_tracking()
        at = mod(pkg, "sam_annotator.annotator_tracking")
        at._init_tracking_state(state)
        assert state.initialized_for_tracking()
        new_id = at.add_new_track(state)
        c1, c2 = at.register_division(state, parent_track=1)
        out[pkg] = (new_id, c1, c2, dict(state.lineage), state.current_track_id)
    assert out[PORT] == out[JAX]


def test_layers_to_prompts_are_equal():
    out = {}
    for pkg in PKGS:
        u = mod(pkg, "sam_annotator.util")
        res = [u.point_layer_to_prompts(u.PointData(
            data=np.array([[10.0, 20.0], [30.0, 40.0]]),
            properties={"label": np.array(["positive", "negative"])}))]
        res.append(u.point_layer_to_prompts(u.PointData(
            data=np.array([[5.0, 5.0]]), properties={"label": np.array(["negative"])})))
        res.append(u.point_layer_to_prompts(u.PointData(
            data=np.array([[0, 1.0, 2.0], [1, 3.0, 4.0], [1, 5.0, 6.0]]),
            properties={"label": np.array(["positive", "positive", "negative"]),
                        "track_id": np.array(["2", "1", "1"])}), i=1, track_id=1))
        rect = np.array([[2.0, 3.0], [2.0, 10.0], [8.0, 10.0], [8.0, 3.0]])
        poly = np.array([[1.0, 1.0], [1.0, 12.0], [12.0, 6.0]])
        ellipse = np.array([[3.0, 2.0], [3.0, 12.0], [11.0, 12.0], [11.0, 2.0]])
        res.append(u.shape_layer_to_prompts(u.ShapeData(
            data=[rect, poly, ellipse], shape_type=["rectangle", "polygon", "ellipse"]), (16, 16)))
        res.append(u.prompt_layers_to_state(
            u.PointData(data=np.array([[0, 1.0, 2.0], [2, 3.0, 4.0]]),
                        properties={"state": np.array(["track", "division"])}),
            u.ShapeData(data=[np.array([[2.0, 1.0, 1.0], [2.0, 5.0, 5.0]])],
                        properties={"state": ["track"]}), 2))
        out[pkg] = res
    (p2d, stop, p3d, (boxes, masks), track_state) = out[PORT]
    (j2d, jstop, j3d, (jboxes, jmasks), jtrack_state) = out[JAX]
    for got, ref in ((p2d, j2d), (p3d, j3d)):
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
    assert stop is None and jstop is None and track_state == jtrack_state == "division"
    np.testing.assert_array_equal(np.array(boxes), np.array(jboxes))
    assert masks[0] is None and jmasks[0] is None
    for m, jm in zip(masks[1:], jmasks[1:]):
        np.testing.assert_array_equal(m, jm)
        assert m.any()


PROMPT_CASES = {
    "points": (np.array([[128.0, 128.0], [60.0, 60.0]]), np.array([1, 0]), [], []),
    "boxes": (np.zeros((0, 2)), np.zeros(0), [np.array([10.0, 10.0, 60.0, 60.0]),
                                              np.array([100.0, 100.0, 160.0, 160.0])],
              [None, None]),
    "box_and_points": (np.array([[128.0, 128.0]]), np.array([1]),
                       [np.array([100.0, 100.0, 160.0, 160.0])], [None]),
    "batched": (np.array([[60.0, 60.0], [128.0, 128.0], [30.0, 200.0]]), np.array([1, 1, 0]),
                [np.array([100.0, 20.0, 200.0, 90.0])], [None]),
}


@pytest.mark.parametrize("case", list(PROMPT_CASES))
def test_prompt_segmentation_matches_jax(models, image, case):
    emb = _embeddings(models, image[0])
    points, labels, boxes, masks = PROMPT_CASES[case]
    out = {}
    for pkg in PKGS:
        u = mod(pkg, "sam_annotator.util")
        out[pkg] = u.prompt_segmentation(
            models[pkg], points, labels, boxes, masks, image[0].shape, multiple_box_prompts=True,
            image_embeddings=emb, batched=case == "batched",
            previous_segmentation=np.zeros(image[0].shape, dtype="uint32"))
        assert u.prompt_segmentation(models[pkg], np.zeros((0, 2)), np.zeros(0), [], [],
                                     image[0].shape, multiple_box_prompts=True,
                                     image_embeddings=emb) is None
    assert out[PORT].max() >= 1
    assert_labels_match(out[PORT], out[JAX])


def test_segment_slices_with_prompts_matches_jax(models):
    image2d, _ = _synthetic(shape=(SIZE, SIZE), seed=21, n_objects=3)
    volume = np.stack([image2d, np.roll(image2d, 4, 0), np.roll(image2d, 8, 0)])
    emb = _embeddings(models, volume, ndim=3)
    out = {}
    for pkg in PKGS:
        u = mod(pkg, "sam_annotator.util")
        points = u.PointData(data=np.array([[1, 128.0, 128.0], [2, 60.0, 60.0]]),
                             properties={"label": np.array(["positive", "negative"])})
        boxes = u.ShapeData(data=[np.array([[0, 20.0, 30.0], [0, 90.0, 120.0]])],
                            shape_type=["rectangle"])
        out[pkg] = u.segment_slices_with_prompts(models[pkg], points, boxes, emb, volume.shape)
    seg, slices, lo, hi = out[PORT]
    jseg, jslices, jlo, jhi = out[JAX]
    # slice 2 holds a lone negative point: the stop annotation above the object
    assert slices.tolist() == jslices.tolist() == [0, 1, 2]
    assert (lo, hi) == (jlo, jhi) == (False, True)
    assert seg[0].max() == 1 and seg[1].max() == 1
    assert_slices_match(seg, jseg)


def test_commit_segmentation_is_bitwise():
    committed = np.zeros((32, 32), dtype=np.uint32)
    committed[2:10, 2:10] = 1
    committed[20:24, 2:6] = 2
    current = np.zeros_like(committed)
    current[20:30, 20:30] = 5
    current[3:12, 3:12] = 9
    overlap = np.zeros_like(committed)
    overlap[2:12, 2:12] = 7
    vol = np.zeros((3, 16, 16), dtype=np.uint32)
    vol[:, 4:8, 4:8] = 3
    out = {}
    for pkg in PKGS:
        w = mod(pkg, "sam_annotator._widgets")
        res = [w.commit_segmentation(committed, current, preserve_mode=m, preservation_threshold=t)
               for m in ("objects", "pixels", "none") for t in (0.5, 0.75)]
        res.append(w.commit_segmentation(res[0], overlap))
        res.append(w.commit_segmentation(np.zeros_like(vol), vol, z_range=(1, 1)))
        out[pkg] = res
    for got, ref in zip(out[PORT], out[JAX]):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def _read_store(path, zarr_lite):
    """Every dataset and attribute of a zarr commit file, flattened."""
    f = zarr_lite.open(path, mode="r")
    out = {"attrs": dict(f.attrs), "committed_objects": f["committed_objects"][...]}
    for name in sorted(f["prompts"].keys()):
        g = f["prompts"][name]
        out[name] = (dict(g.attrs), {k: g[k][...] for k in sorted(g.keys())})
    return out


def test_commit_to_file_is_bitwise(tmp_path):
    committed = np.zeros((32, 32), dtype=np.uint32)
    seg = np.zeros_like(committed)
    seg[4:12, 4:12] = 1
    seg2 = np.zeros_like(committed)
    seg2[20:30, 20:30] = 3
    out = {}
    for pkg in PKGS:
        u = mod(pkg, "sam_annotator.util")
        w = mod(pkg, "sam_annotator._widgets")
        points = u.PointData(data=np.array([[8.0, 8.0]]),
                             properties={"label": np.array(["positive"])})
        boxes = u.ShapeData(data=[np.array([[1.0, 1.0], [14.0, 14.0]])], shape_type=["rectangle"])
        path = str(tmp_path / f"{pkg}.zarr")
        first = w.commit_to_file(path, committed, seg, point_prompts=points,
                                 shape_prompts=boxes, data_signature="sig-1")
        second = w.commit_to_file(path, first, seg2, data_signature="sig-1")
        with pytest.raises(RuntimeError):
            w.commit_to_file(path, second, seg, data_signature="other-sig")
        out[pkg] = (first, second, _read_store(path, mod(pkg, "utils.zarr_lite")))
    np.testing.assert_array_equal(out[PORT][0], out[JAX][0])
    np.testing.assert_array_equal(out[PORT][1], out[JAX][1])
    got, ref = out[PORT][2], out[JAX][2]
    assert got.keys() == ref.keys() and got["attrs"] == ref["attrs"]
    np.testing.assert_array_equal(got["committed_objects"], ref["committed_objects"])
    for k in got:
        if k.startswith("object-"):
            assert got[k][0] == ref[k][0] and got[k][1].keys() == ref[k][1].keys()
            for name in got[k][1]:
                np.testing.assert_array_equal(got[k][1][name], ref[k][1][name])


def _object_features(pkg, emb, seg):
    return mod(pkg, "object_classification").compute_object_features(emb, seg)


def test_object_classifier_workflow_matches_jax(models, image):
    seg = image[1]
    emb = _embeddings(models, image[0])
    annotations = np.zeros_like(seg, dtype=np.uint8)
    for value, oid in ((1, np.unique(seg)[1]), (2, np.unique(seg)[2]), (1, np.unique(seg)[3])):
        ys, xs = np.where(seg == oid)
        annotations[ys[0], xs[0]] = value
    out = {}
    for pkg in PKGS:
        wf = mod(pkg, "sam_annotator.object_classifier").ObjectClassifierWorkflow(
            predictor=models[pkg])
        wf.set_image(image[0], seg, image_embeddings=emb)
        n = wf.add_annotations(annotations)
        np.random.seed(0)  # the forest draws from numpy's global state
        out[pkg] = (n, wf._current[1], wf.train_and_predict())
    assert out[PORT][0] == out[JAX][0] == 3
    assert rel_err(out[PORT][1], out[JAX][1]) <= 1e-3
    np.testing.assert_array_equal(out[PORT][2], out[JAX][2])


# ---------------------------------------------------------------------------
# tests/test_widgets.py, replayed
# ---------------------------------------------------------------------------

def test_form_layer_and_model_selection_match_jax():
    cases = [(0, 0, 0, 0), (512, 0, 0, 0), (100, 0, 0, 0), (512, 300, 0, 0), (100, 300, 0, 0),
             (512, 512, 64, 32), (0, 0, 64, 64)]
    out = {}
    for pkg in PKGS:
        w = mod(pkg, "sam_annotator._widgets")
        compat = mod(pkg, "sam_annotator._compat")
        res = [w._process_tiling_inputs(*c) for c in cases]

        class Form(compat.FormWidget):
            def __init__(self):
                super().__init__()
                self.calls = []
                self.f = self._add_choice_param(
                    "mode", "a", ["a", "b"], update=lambda: self.calls.append(self.mode))

        form = Form()
        form.set_param("mode", "b")
        form.f.blockSignals(True)
        form.set_param("mode", "a")
        res.append((form.mode, form.calls))
        emb = w.EmbeddingWidget()
        for family, size in (("Light Microscopy", "base"), ("Natural Images (SAM)", "huge"),
                             ("Electron Microscopy", "large")):
            emb.set_param("model_family", family)
            emb.set_param("model_size", size)
            res.append((emb._resolve_model_type(), list(emb.model_size_field.options)))
        out[pkg] = res
    assert out[PORT][:len(cases) + 1] == out[JAX][:len(cases) + 1]
    assert out[PORT][len(cases) + 1:] == out[JAX][len(cases) + 1:]
    assert out[PORT][len(cases):len(cases) + 2] == [("a", ["b"]), ("vit_b_lm", ["tiny", "base",
                                                                                  "large"])]


def test_embedding_widget_matches_jax(states, tiny_models, messages, tmp_path):
    image, _ = _synthetic(shape=(128, 128), seed=3)
    out = {}
    for pkg in PKGS:
        w = mod(pkg, "sam_annotator._widgets")
        fake = mod(pkg, "_test_util")
        zarr_lite = mod(pkg, "utils.zarr_lite")
        save_path = str(tmp_path / f"{pkg}.zarr")
        widget = w.EmbeddingWidget()
        widget.image = fake.FakeLayer(image, name="image")
        widget.set_param("embeddings_save_path", save_path)
        widget.run_button.click()
        state = states[pkg]
        assert state.predictor is tiny_models[pkg] and state.image_shape == image.shape
        f = zarr_lite.open(save_path, mode="r")
        attrs = {k: f.attrs[k] for k in ("data_signature", "input_size", "original_size")}
        features = np.asarray(f["features"][...])
        _reset(state)
        again = w.EmbeddingWidget()
        again.image = fake.FakeLayer(image, name="image")
        again.set_param("embeddings_save_path", save_path)
        other = image.copy()
        other[:16, :16] = 0
        third = w.EmbeddingWidget()
        third.image = fake.FakeLayer(other, name="image")
        third.set_param("embeddings_save_path", save_path)
        out[pkg] = (attrs, features, again._validate_inputs(), third._validate_inputs(),
                    [t for t, _ in messages[pkg]])
    assert out[PORT][0] == out[JAX][0]
    assert rel_err(out[PORT][1], out[JAX][1]) <= 1e-4
    assert out[PORT][2:] == out[JAX][2:] == (False, True, ["info", "error"])


def _prompt(viewer, points, labels, **properties):
    pts = viewer.layers["point_prompts"]
    pts.data = np.asarray(points, dtype=float)
    pts.properties = {"label": np.array(labels, dtype=object),
                      **{k: np.array(v, dtype=object) for k, v in properties.items()}}


def test_annotator_2d_stack_matches_jax(models, states, tiny_models, image):
    emb = _embeddings(models, image[0])
    out = {}
    for pkg in PKGS:
        fake = mod(pkg, "_test_util")
        a2d = mod(pkg, "sam_annotator.annotator_2d")
        viewer = fake.FakeViewer()
        assert a2d.annotator_2d(image[0], embedding_path=emb, model_type="vit_b", viewer=viewer,
                                return_viewer=True, predictor=models[pkg]) is viewer
        fake.check_layer_initialization(viewer, image[0].shape)
        assert set(states[pkg].widgets) >= {"embeddings", "segment", "autosegment", "commit",
                                             "clear"}
        _prompt(viewer, [[128.0, 128.0]], ["positive"])
        viewer.press("s")
        first = viewer.layers["current_object"].data.copy()
        viewer.press("t")  # toggled to negative, then a positive point added
        labels = list(viewer.layers["point_prompts"].properties["label"])
        _prompt(viewer, [[128.0, 128.0], [60.0, 200.0]], labels + ["positive"])
        viewer.press("s")
        second = viewer.layers["current_object"].data.copy()
        viewer.layers["prompts"].data = [np.array([[20.0, 20.0], [90.0, 110.0]])]
        viewer.layers["prompts"].shape_type = ["rectangle"]
        _prompt(viewer, np.zeros((0, 2)), [])
        viewer.press("s")
        box = viewer.layers["current_object"].data.copy()
        viewer.press("c")
        committed = viewer.layers["committed_objects"].data.copy()
        assert viewer.layers["current_object"].data.max() == 0
        assert len(viewer.layers["point_prompts"].data) == 0
        viewer.press("Shift-C")
        out[pkg] = (first, second, box, committed, labels)
    assert out[PORT][4] == out[JAX][4] == ["negative"]
    for got, ref in zip(out[PORT][:4], out[JAX][:4]):
        assert got.max() >= 1
        assert_labels_match(got, ref)


@pytest.mark.parametrize("with_decoder", [False, True], ids=["amg", "ais"])
def test_autosegment_widget_matches_jax(models, states, image, with_decoder):
    emb = _embeddings(models, image[0])
    decoders = {}
    if with_decoder:
        from micro_sam_tpu.instance_segmentation import DecoderAdapter as JaxDecoderAdapter
        from micro_sam_tpu_torch.instance_segmentation import DecoderAdapter
        params = unetr_jax_params(True)
        decoders = {PORT: DecoderAdapter(port_unetr(params)), JAX: JaxDecoderAdapter(params)}
    out = {}
    for pkg in PKGS:
        state = states[pkg]
        state.predictor, state.image_embeddings = models[pkg], emb
        state.image_shape = image[0].shape
        inst = mod(pkg, "instance_segmentation")
        if with_decoder:
            state.decoder = decoders[pkg]
        else:  # a small point grid
            state.amg = inst.AutomaticMaskGenerator(models[pkg], points_per_side=6,
                                                    points_per_batch=36)
        viewer = mod(pkg, "_test_util").FakeViewer()
        viewer.add_labels(np.zeros(image[0].shape, dtype="uint32"), name="auto_segmentation")
        widget = mod(pkg, "sam_annotator._widgets").AutoSegmentWidget(
            viewer, with_decoder=with_decoder, volumetric=False)
        if with_decoder:
            # the random decoder's maps need AIS_KW's foreground threshold and
            # smoothing, which the widget does not expose
            kwargs_of = widget._segmentation_kwargs
            widget._segmentation_kwargs = lambda f=kwargs_of: dict(
                f(), foreground_threshold=AIS_KW["foreground_threshold"],
                distance_smoothing=AIS_KW["distance_smoothing"])
            for key, value in (("center_distance_thresh", AIS_KW["center_distance_threshold"]),
                               ("boundary_distance_thresh",
                                AIS_KW["boundary_distance_threshold"]),
                               ("min_object_size", 0)):
                widget.set_param(key, value)
        else:
            for key, value in (("pred_iou_thresh", -10.0), ("stability_score_thresh", 0.0),
                               ("min_object_size", 0)):
                widget.set_param(key, value)
        widget.run_button.click()
        widget._reset_segmentation_mode(not with_decoder)
        out[pkg] = (viewer.layers["auto_segmentation"].data.copy(), sorted(widget._fields))
    got, ref = out[PORT][0], out[JAX][0]
    share, n = matched_share(got, ref)
    assert n >= 3 and share >= 0.98, (share, n)
    assert matched_share(ref, got)[0] >= 0.98
    assert out[PORT][1] == out[JAX][1]


def _volume_state(models, states, volume, emb):
    for pkg in PKGS:
        state = states[pkg]
        state.predictor, state.image_embeddings = models[pkg], emb
        state.image_shape = volume.shape


def test_segment_nd_widget_matches_jax(models, states):
    image, _ = _synthetic(shape=(SIZE, SIZE), seed=7)
    volume = np.stack([image, np.roll(image, 3, 1), np.roll(image, 6, 1)])
    emb = _embeddings(models, volume, ndim=3)
    _volume_state(models, states, volume, emb)
    out = {}
    for pkg in PKGS:
        viewer = mod(pkg, "_test_util").FakeViewer()
        viewer.add_labels(np.zeros(volume.shape, dtype="uint32"), name="current_object")
        viewer.add_points(np.array([[1, 128.0, 128.0]]), name="point_prompts",
                          properties={"label": np.array(["positive"], dtype=object)})
        viewer.add_shapes(name="prompts", ndim=3)
        widget = mod(pkg, "sam_annotator._widgets").SegmentNDWidget(viewer, tracking=False)
        widget.set_param("projection", "box")
        widget.set_param("iou_threshold", 0.0)
        widget.run_button.click()
        out[pkg] = (viewer.layers["current_object"].data.copy(), states[pkg].z_range)
    assert out[PORT][1] == out[JAX][1] == (0, 2)
    assert_slices_match(out[PORT][0], out[JAX][0])


def test_commit_widget_to_file_matches_jax(states, tmp_path):
    out = {}
    for pkg in PKGS:
        states[pkg].data_signature = "f00d"
        viewer = mod(pkg, "_test_util").FakeViewer()
        seg = np.zeros((64, 64), dtype="uint32")
        seg[10:20, 10:20] = 3
        seg[30:40, 5:15] = 8
        committed = np.zeros((64, 64), dtype="uint32")
        committed[12:18, 30:40] = 1
        viewer.add_labels(seg, name="current_object")
        viewer.add_labels(committed, name="committed_objects")
        viewer.add_points(name="point_prompts", ndim=2)
        viewer.add_shapes(name="prompts", ndim=2)
        widget = mod(pkg, "sam_annotator._widgets").CommitWidget(viewer)
        path = str(tmp_path / f"{pkg}.zarr")
        widget.set_param("commit_path", path)
        widget.run_button.click()
        assert viewer.layers["current_object"].data.max() == 0
        out[pkg] = (viewer.layers["committed_objects"].data.copy(),
                    _read_store(path, mod(pkg, "utils.zarr_lite")))
    np.testing.assert_array_equal(out[PORT][0], out[JAX][0])
    assert out[PORT][1]["attrs"] == out[JAX][1]["attrs"]
    np.testing.assert_array_equal(out[PORT][1]["committed_objects"],
                                  out[JAX][1]["committed_objects"])


def test_training_widget_loaders_match_jax(tmp_path):
    import imageio.v3 as imageio
    raw_dir, label_dir = tmp_path / "im", tmp_path / "gt"
    raw_dir.mkdir()
    label_dir.mkdir()
    for i in range(3):
        image, seg = _synthetic(shape=(128, 128), seed=i)
        imageio.imwrite(raw_dir / f"{i}.tif", image)
        imageio.imwrite(label_dir / f"{i}.tif", seg)
    out = {}
    for pkg in PKGS:
        widget = mod(pkg, "sam_annotator.training_ui").TrainingWidget()
        assert widget._validate_inputs() is True
        for key, value in (("raw_path", str(raw_dir)), ("raw_key", "*.tif"),
                           ("label_path", str(label_dir)), ("label_key", "*.tif"),
                           ("patch_x", 128), ("patch_y", 128)):
            widget.set_param(key, value)
        assert widget._validate_inputs() is False
        train_loader, val_loader = widget._get_loaders()
        out[pkg] = ([b for b in train_loader], [b for b in val_loader],
                    widget.configuration == mod(pkg, "training.training")
                    ._find_best_configuration())
    assert out[PORT][2] and out[JAX][2]
    for got_batches, ref_batches in zip(out[PORT][:2], out[JAX][:2]):
        assert len(got_batches) == len(ref_batches) >= 1
        for got, ref in zip(got_batches, ref_batches):
            assert len(got) == len(ref) == 3
            for g, r in zip(got, ref):
                np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(r, np.float64),
                                           rtol=0, atol=1e-6)


def test_tracking_annotator_stack_matches_jax(states):
    out = {}
    for pkg in PKGS:
        state = states[pkg]
        state.image_shape = (3, 64, 64)
        viewer = mod(pkg, "_test_util").FakeViewer()
        mod(pkg, "sam_annotator._annotator").AnnotatorTracking(viewer)
        res = [state.current_track_id, dict(state.lineage), sorted(state.widgets)]
        mod(pkg, "sam_annotator._widgets")._update_lineage(viewer)
        res += [dict(state.lineage), list(state.widgets["tracking"].track_id_field.options)]
        state.widgets["tracking"].set_param("track_id", "2")
        res.append(state.current_track_id)
        out[pkg] = res
    assert out[PORT] == out[JAX]
    assert out[PORT][3] == {1: [2, 3], 2: [], 3: []}


def test_image_series_annotator_matches_jax(states, tiny_models, tmp_path):
    import imageio.v3 as imageio
    images = [_synthetic(shape=(128, 128), seed=80 + i, n_objects=2)[0] for i in range(3)]
    files = {}
    for pkg in PKGS:
        series = mod(pkg, "sam_annotator.image_series_annotator")
        out = str(tmp_path / pkg)
        viewer = mod(pkg, "_test_util").FakeViewer()
        assert series.image_series_annotator(images, out, model_type="vit_b", viewer=viewer,
                                             return_viewer=True) is viewer
        _prompt(viewer, [[64.0, 64.0]], ["positive"])
        viewer.press("s")
        viewer.press("c")
        viewer.press("n")
        assert viewer.layers["committed_objects"].data.max() == 0
        viewer.press("n")
        _reset(states[pkg])
        assert series.image_series_annotator(images, out, model_type="vit_b",
                                             viewer=mod(pkg, "_test_util").FakeViewer(),
                                             return_viewer=True, skip_segmented=True)
        files[pkg] = {f: imageio.imread(os.path.join(out, f)) for f in sorted(os.listdir(out))}
    assert list(files[PORT]) == list(files[JAX]) == ["seg_00000.tif", "seg_00001.tif"]
    assert files[PORT]["seg_00000.tif"].max() >= 1
    assert_labels_match(files[PORT]["seg_00000.tif"], files[JAX]["seg_00000.tif"])
    np.testing.assert_array_equal(files[PORT]["seg_00001.tif"], files[JAX]["seg_00001.tif"])


def test_object_classifier_gui_matches_jax(states, tiny_models, tmp_path):
    import pickle
    image, seg = _synthetic(shape=(128, 128), seed=90, n_objects=4)
    seg = seg.astype("uint32")
    ann = np.zeros_like(seg)
    for value, oid in ((1, np.unique(seg)[1]), (2, np.unique(seg)[2])):
        ys, xs = np.nonzero(seg == oid)
        ann[ys[0], xs[0]] = value
    out = {}
    for pkg in PKGS:
        viewer = mod(pkg, "_test_util").FakeViewer()
        oc = mod(pkg, "sam_annotator.object_classifier")
        assert oc.object_classifier(image, seg, model_type="vit_b", viewer=viewer,
                                    return_viewer=True) is viewer
        viewer.layers["annotations"].data = ann
        annotator = states[pkg].annotator
        np.random.seed(0)
        pred = annotator.train_and_predict()
        rf_path = str(tmp_path / f"{pkg}.pkl")
        annotator._widgets["export"].set_param("export_path", rf_path)
        annotator.export_rf()
        with open(rf_path, "rb") as f:
            assert hasattr(pickle.load(f), "predict")
        out[pkg] = (annotator._workflow._current[1], pred)
    assert rel_err(out[PORT][0], out[JAX][0]) <= 1e-3
    np.testing.assert_array_equal(out[PORT][1], out[JAX][1])
    assert out[PORT][1].max() >= 1


def test_image_series_object_classifier_matches_jax(states, tiny_models, tmp_path):
    import imageio.v3 as imageio
    pairs = [_synthetic(shape=(128, 128), seed=95 + i, n_objects=3) for i in range(2)]
    images, segs = [p[0] for p in pairs], [p[1].astype("uint32") for p in pairs]
    ann = np.zeros_like(segs[0])
    ys, xs = np.nonzero(segs[0] == np.unique(segs[0])[1])
    ann[ys[0], xs[0]] = 1
    out = {}
    for pkg in PKGS:
        oc = mod(pkg, "sam_annotator.object_classifier")
        folder = str(tmp_path / pkg)
        viewer = mod(pkg, "_test_util").FakeViewer()
        assert oc.image_series_object_classifier(images, segs, folder, model_type="vit_b",
                                                 viewer=viewer, return_viewer=True) is viewer
        viewer.layers["annotations"].data = ann
        np.random.seed(0)
        viewer.press("n")
        np.testing.assert_array_equal(viewer.layers["segmentation"].data, segs[1])
        out[pkg] = imageio.imread(os.path.join(folder, "prediction_00000.tif"))
    np.testing.assert_array_equal(out[PORT], out[JAX])


def test_annotator_3d_stack_matches_jax(models, states, tiny_models):
    image2d, _ = _synthetic(shape=(128, 128), seed=77, n_objects=2)
    volume = np.stack([image2d, np.roll(image2d, 2, 0), np.roll(image2d, 4, 0)])
    emb = _embeddings(models, volume, ndim=3)
    _volume_state(models, states, volume, emb)
    out = {}
    for pkg in PKGS:
        fake = mod(pkg, "_test_util")
        viewer = fake.FakeViewer()
        assert mod(pkg, "sam_annotator.annotator_3d").annotator_3d(
            volume, embedding_path=emb, model_type="vit_b", viewer=viewer, return_viewer=True,
            predictor=models[pkg]) is viewer
        fake.check_layer_initialization(viewer, volume.shape)
        viewer.dims.point = (1, 0, 0)
        _prompt(viewer, [[1.0, 64.0, 64.0]], ["positive"])
        viewer.press("s")
        slice_seg = viewer.layers["current_object"].data.copy()
        viewer.press("Shift-S")
        nd_seg = viewer.layers["current_object"].data.copy()
        z_range = states[pkg].z_range
        viewer.press("c")
        out[pkg] = (slice_seg, nd_seg, viewer.layers["committed_objects"].data.copy(), z_range)
    assert out[PORT][3] == out[JAX][3]
    assert out[PORT][0][1].max() >= 1 and out[PORT][0][0].max() == 0
    assert (out[PORT][1] > 0).any(axis=(1, 2)).sum() >= 2
    for got, ref in zip(out[PORT][:3], out[JAX][:3]):
        assert_slices_match(got, ref)


def test_annotator_tracking_stack_matches_jax(models, states, tiny_models):
    frame, _ = _synthetic(shape=(128, 128), seed=88, n_objects=2)
    series = np.stack([frame, np.roll(frame, 2, 1), np.roll(frame, 4, 1)])
    emb = _embeddings(models, series, ndim=3)
    _volume_state(models, states, series, emb)
    out = {}
    for pkg in PKGS:
        viewer = mod(pkg, "_test_util").FakeViewer()
        assert mod(pkg, "sam_annotator.annotator_tracking").annotator_tracking(
            series, embedding_path=emb, model_type="vit_b", viewer=viewer,
            return_viewer=True) is viewer
        viewer.dims.point = (0, 0, 0)
        _prompt(viewer, [[0.0, 64.0, 64.0]], ["positive"], track_id=["1"], state=["track"])
        viewer.press("s")
        frame_seg = viewer.layers["current_object"].data.copy()
        viewer.press("Shift-S")
        out[pkg] = (frame_seg, viewer.layers["current_object"].data.copy(),
                    dict(states[pkg].lineage), states[pkg].current_track_id)
    assert out[PORT][2:] == out[JAX][2:]
    assert out[PORT][0][0].max() == 1
    assert (out[PORT][1] == 1).any(axis=(1, 2)).sum() >= 2
    for got, ref in zip(out[PORT][:2], out[JAX][:2]):
        assert_slices_match(got, ref)


# ---------------------------------------------------------------------------
# the port's own entry points
# ---------------------------------------------------------------------------

def test_initialize_predictor_reads_a_decoder_path(states, monkeypatch, tmp_path):
    """initialize_predictor(decoder_path=...) builds the decoder of a
    separate decoder checkpoint (a torch_em state under ``model_state``), and
    prefer_decoder=False leaves it out."""
    import dataclasses
    import torch
    from micro_sam_tpu_torch.models import build_sam
    from micro_sam_tpu_torch.models.unetr import UNETRDecoder
    monkeypatch.setitem(build_sam.SAM_CONFIGS, "vit_b", build_sam.SamConfig(
        **{**dataclasses.asdict(tiny_jax_config(img_size=SIZE)), "compute_dtype": "float32"}))
    decoder = UNETRDecoder(features=(64, 32, 16, 8)).init_(torch.Generator().manual_seed(3))
    path = str(tmp_path / "decoder.pt")
    torch.save({"model_state": decoder.state_dict()}, path)
    image, _ = _synthetic(shape=(64, 64), seed=2)
    state = states[PORT]
    for prefer in (True, False):
        state.initialize_predictor(image, "vit_b", ndim=2, device="cpu", decoder_path=path,
                                   prefer_decoder=prefer)
        assert state.image_embeddings["features"].shape == (1, 256, 16, 16)
        if not prefer:
            assert state.decoder is None
            continue
        got, ref = state.decoder.unetr.state_dict(), decoder.state_dict()
        assert got.keys() == ref.keys() and all(torch.equal(got[k], ref[k]) for k in ref)



@pytest.fixture
def napari_stub(monkeypatch):
    """A stand-in ``napari`` / ``magicgui`` in sys.modules: the viewer is
    the port's FakeViewer, ``run`` returns at once (the user's corrections
    are none)."""
    from micro_sam_tpu_torch._test_util import FakeViewer
    viewers = []

    def viewer():
        viewers.append(FakeViewer())
        return viewers[-1]

    napari = types.ModuleType("napari")
    napari.Viewer, napari.run = viewer, lambda: None
    monkeypatch.setitem(sys.modules, "napari", napari)
    monkeypatch.setitem(sys.modules, "magicgui", types.ModuleType("magicgui"))
    return viewers


def test_annotate_true_opens_the_port_annotator(models, states, napari_stub, tmp_path):
    """automatic_instance_segmentation(annotate=True) opens the port's 2d
    annotator with the automatic result and returns what is committed."""
    from micro_sam_tpu_torch import automatic_segmentation as pas
    from micro_sam_tpu_torch.instance_segmentation import AutomaticMaskGenerator
    image, _ = _synthetic(shape=(128, 128), seed=5, n_objects=3)
    segmenter = AutomaticMaskGenerator(models[PORT], points_per_side=4, points_per_batch=16)
    kw = dict(pred_iou_thresh=-10.0, stability_score_thresh=0.0, verbose=False)
    auto = pas.automatic_instance_segmentation(models[PORT], segmenter, image, **kw)
    got = pas.automatic_instance_segmentation(models[PORT], segmenter, image, annotate=True,
                                              **kw)
    assert len(napari_stub) == 1 and auto.max() >= 1
    viewer = napari_stub[0]
    mod(PORT, "_test_util").check_layer_initialization(viewer, image.shape)
    np.testing.assert_array_equal(got, auto)
    assert states[PORT].predictor is models[PORT]


def test_entry_points_want_the_gpu(monkeypatch, states):
    """No fallback: without a GPU the annotators load no model unless
    device="cpu" is passed."""
    import torch
    from micro_sam_tpu_torch.sam_annotator import annotator_2d, annotator_3d, annotator_tracking
    from micro_sam_tpu_torch._test_util import FakeViewer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    image, _ = _synthetic(shape=(64, 64), seed=1)
    for entry, data in ((annotator_2d, image), (annotator_3d, np.stack([image] * 2)),
                        (annotator_tracking, np.stack([image] * 2))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry(data, viewer=FakeViewer(), return_viewer=True)
    with pytest.raises(RuntimeError, match="napari"):  # no viewer given and no napari
        annotator_2d(image, embedding_path={"features": None}, predictor=object())
