"""The port's evaluation (micro_sam_tpu_torch/evaluation: matching, the
evaluation tables, prompt-based and iterative inference, the grid searches,
the 3d evaluation) and its IterativePromptGenerator against the JAX package,
on the tiny config of tests/torch_port_util.py (f32, CPU).

Tolerances: matching, mSA, the prompt generators and the evaluation tables
exact. The SAM decoder's last hypernetwork layers are scaled by 30 in both
packages (tests/test_torch_inference.py) so that random weights give stable
masks; both packages read the same embeddings (the cache layout is
shared); and the JAX predictor's power-of-two prompt buckets, a divergence
by design (tests/test_torch_predictor.py::test_bucket_padding_divergence),
are turned off (``exact_prompts``), so the decodes differ only by f32
rounding: the iterative loop fed
the JAX package's prompts holds every object's mask to IoU >= 0.99 with the
JAX package's in every iteration; free-running under one numpy seed, the
per-iteration mSA may differ by at most FREE_RUNNING_MSA (see
``test_iterative_prompting_free_running``). The grid searches' CSVs, read
with pandas, are equal, and so are the best parameters.
"""
import os

import numpy as np
import pytest

from tests.torch_port_util import (AIS_KW, jax_params, one_thread, port_sam, port_unetr,
                                   tiny_jax_config, unetr_jax_params)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: tier-1's six test processes share the
    machine's cores, and small tensors gain nothing from more (ROADMAP.md,
    Budgets)."""
    with one_thread():
        yield


SIZE = 256
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "bench_sam_tiny1024.npz")
# the largest per-iteration mSA difference allowed between the packages when
# each draws its own corrective points under one seed, on the trained
# fixture: measured 0.0 on this test's 512^2 image (seeds 11-13, both
# starts, 4 iterations) and 0.0650 on its 1024^2 image of 20 cells (box
# start, no masks: 0.2752 / 0.1804 / 0.4735 / 0.6625 against the JAX
# package's 0.2752 / 0.1771 / 0.4953 / 0.7275), where one pixel of object
# 1's round-0 mask differs (f32 rounding) and moves its corrective point and
# every later one
FREE_RUNNING_MSA = 0.1


@pytest.fixture(scope="module")
def models():
    from micro_sam_tpu.models.sam import Sam as JaxSam
    from micro_sam_tpu.predictor import SamPredictor as JaxPredictor
    from micro_sam_tpu_torch.predictor import SamPredictor
    cfg = tiny_jax_config(img_size=SIZE)
    params = jax_params(cfg)
    for h in params["mask_decoder"]["hyper_mlps"]:  # sharper masks from random weights
        h["layers"][2]["w"] = h["layers"][2]["w"] * 30.0
        h["layers"][2]["b"] = h["layers"][2]["b"] * 30.0
    jp, pp = JaxPredictor(JaxSam(cfg, params)), SamPredictor(port_sam(cfg, params))
    jp.transform.apply_image = pp.transform.apply_image  # the same pixels into both encoders
    return jp, pp


@pytest.fixture
def exact_prompts(monkeypatch):
    """The JAX predictor without its power-of-two prompt buckets: both
    decoders then see the same tokens (the prompts and SAM's one pad point)."""
    import micro_sam_tpu.predictor as jpred
    monkeypatch.setattr(jpred, "_next_pow2", lambda n: n)


@pytest.fixture(scope="module")
def data(models):
    """A synthetic image, its truth and the port's embeddings of it, set on
    both predictors."""
    from micro_sam_tpu import util as jutil
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.sample_data import synthetic_data
    jp, pp = models
    image, seg = synthetic_data(shape=(SIZE, SIZE), seed=5, n_objects=6)
    emb = util.precompute_image_embeddings(pp, image, verbose=False)
    util.set_precomputed(pp, emb)
    jutil.set_precomputed(jp, emb)
    return image, seg.astype(np.uint32), emb


def _label_pairs():
    """Label pairs with matched, merged, split, shifted and missing objects,
    and the empty cases."""
    from micro_sam_tpu_torch.sample_data import synthetic_data
    _, gt = synthetic_data(shape=(96, 96), seed=3, n_objects=6)
    gt = gt.astype(np.uint32)
    rng = np.random.RandomState(0)
    merged = gt.copy()
    merged[merged == 2] = 1
    split = gt.copy()
    ys, xs = np.nonzero(gt == 3)
    split[ys[ys > ys.mean()], xs[ys > ys.mean()]] = 50
    shifted = np.roll(gt, (2, 3), axis=(0, 1)) * 7
    noisy = gt.copy()
    noisy[rng.rand(*gt.shape) < 0.05] = 0
    noisy[gt == 4] = 0
    random = rng.randint(0, 4, gt.shape).astype(np.uint32)
    empty = np.zeros_like(gt)
    return {"identical": (gt, gt), "merged": (merged, gt), "split": (split, gt),
            "shifted": (shifted, gt), "noisy": (noisy, gt), "random": (random, gt),
            "empty prediction": (empty, gt), "empty truth": (gt, empty),
            "both empty": (empty, empty)}


@pytest.mark.parametrize("case", list(_label_pairs()))
def test_matching_and_msa_match_jax(case):
    import importlib
    # the packages export the function ``matching`` under the module's name
    jm = importlib.import_module("micro_sam_tpu.evaluation.matching")
    pm = importlib.import_module("micro_sam_tpu_torch.evaluation.matching")
    seg, gt = _label_pairs()[case]
    for t in (0.5, 0.75, 0.9):
        assert pm.matching(seg, gt, threshold=t) == jm.matching(seg, gt, threshold=t)
    got, ref = (m.mean_segmentation_accuracy(seg, gt, return_accuracies=True) for m in (pm, jm))
    assert got[0] == ref[0] and got[1] == ref[1]
    thr = [0.3, 0.6]
    assert pm.mean_segmentation_accuracy(seg, gt, thr) == jm.mean_segmentation_accuracy(seg, gt, thr)


@pytest.mark.parametrize("thresholds", [None, [0.5, 0.7]])
def test_run_evaluation_matches_jax(tmp_path, thresholds):
    """Arrays and TIFF files, the CSV written and read back as the cache."""
    import imageio.v3 as imageio
    import pandas as pd
    from micro_sam_tpu.evaluation import run_evaluation as jrun
    from micro_sam_tpu_torch.evaluation import run_evaluation as prun
    pairs = _label_pairs()
    gts = [pairs[k][1] for k in ("merged", "split", "noisy")]
    preds = [pairs[k][0] for k in ("merged", "split", "noisy")]
    paths = []
    for i, (g, p) in enumerate(zip(gts, preds)):
        imageio.imwrite(tmp_path / f"gt{i}.tif", g)
        imageio.imwrite(tmp_path / f"pred{i}.tif", p)
        paths.append((str(tmp_path / f"gt{i}.tif"), str(tmp_path / f"pred{i}.tif")))
    ref = jrun(gts, preds, save_path=str(tmp_path / "jax.csv"), thresholds=thresholds)
    got = prun(gts, preds, save_path=str(tmp_path / "port.csv"), thresholds=thresholds)
    pd.testing.assert_frame_equal(got, ref)
    pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "port.csv"),
                                  pd.read_csv(tmp_path / "jax.csv"))
    from_files = prun([g for g, _ in paths], [p for _, p in paths], thresholds=thresholds)
    pd.testing.assert_frame_equal(from_files, ref)
    cached = prun([], [], save_path=str(tmp_path / "port.csv"))
    pd.testing.assert_frame_equal(cached, ref)


@pytest.mark.parametrize("ndim", [2, 3])
def test_iterative_prompt_generator_matches_jax(ndim):
    """The same corrective points from the same seed, empty regions included."""
    from micro_sam_tpu.prompt_generators import IterativePromptGenerator as Jax
    from micro_sam_tpu_torch.prompt_generators import IterativePromptGenerator as Port
    rng = np.random.RandomState(1)
    shape = (5, 1) + ((4,) if ndim == 3 else ()) + (24, 28)
    gt = (rng.rand(*shape) > 0.6).astype(np.float32)
    pred = (rng.rand(*shape) > 0.5).astype(np.float32)
    pred[0] = gt[0]                      # no error region: the fallbacks
    gt[1] = 0                            # empty truth
    pred[2] = 0
    got = Port(np.random.RandomState(7))(gt, pred)
    ref = Jax(np.random.RandomState(7))(gt, pred)
    assert got[0].dtype == ref[0].dtype and got[0].shape == ref[0].shape
    for g, r in zip(got, ref):
        assert (g is None and r is None) or np.array_equal(g, r)
    with pytest.raises(ValueError):  # neither (N, 1, H, W) nor (N, 1, Z, H, W)
        Port()(np.zeros((2, 5, 5)), np.zeros((2, 5, 5)))


class Recording:
    """The JAX package's IterativePromptGenerator, keeping what it returns."""
    calls = []

    def __init__(self, rng=None):
        from micro_sam_tpu.prompt_generators import IterativePromptGenerator
        self.gen = IterativePromptGenerator(rng)

    def __call__(self, *a, **k):
        out = self.gen(*a, **k)
        Recording.calls.append(out)
        return out


class Replay:
    """Hands out recorded prompts in order."""

    def __init__(self, calls):
        self.calls = list(calls)

    def __call__(self, segmentation, prediction, **k):
        return self.calls.pop(0)


def _jax_iterations(jp, gt, start_with_box, use_masks, n_iterations, tmp_path, monkeypatch):
    """The JAX package's iterative prompting of one image: its per-iteration
    segmentations and the corrective prompts it drew."""
    import imageio.v3 as imageio
    from micro_sam_tpu.evaluation import inference as jinf
    Recording.calls = []
    monkeypatch.setattr(jinf, "IterativePromptGenerator", Recording)
    paths = [str(tmp_path / f"jax{it}.tif") for it in range(n_iterations)]
    jinf._run_inference_with_iterative_prompting_for_image(
        jp, None, gt, start_with_box_prompt=start_with_box, dilation=5, batch_size=4,
        n_iterations=n_iterations, prediction_paths=paths, use_masks=use_masks)
    return [imageio.imread(p) for p in paths], list(Recording.calls)


def _object_ious(got, ref, ids):
    out = []
    for i in ids:
        a, b = got == i, ref == i
        union = (a | b).sum()
        out.append(1.0 if union == 0 else (a & b).sum() / union)
    return np.array(out)


@pytest.mark.parametrize("start_with_box,use_masks", [(True, False), (False, True)])
def test_iterative_prompting_strict(models, exact_prompts, data, tmp_path, monkeypatch, start_with_box,
                                    use_masks):
    """The port's loop fed the JAX package's corrective prompts: every
    object's mask at IoU >= 0.99 with the JAX package's in every iteration."""
    from micro_sam_tpu_torch.evaluation.inference import iterative_prompting_segmentations
    jp, pp = models
    _, gt, _ = data
    ref, calls = _jax_iterations(jp, gt, start_with_box, use_masks, 3, tmp_path, monkeypatch)
    assert len(calls) == 2
    got = iterative_prompting_segmentations(pp, gt, start_with_box, batch_size=4,
                                            n_iterations=3, use_masks=use_masks,
                                            prompt_generator=Replay(calls))
    ids = np.unique(gt)[1:]
    assert len(got) == 3
    for g, r in zip(got, ref):
        assert g.dtype == np.uint32 and g.shape == gt.shape
        assert _object_ious(g, r, ids).min() >= 0.99


@pytest.fixture(scope="module")
def fixture_models():
    """The trained fixture SAM (tests/fixtures/bench_sam_tiny1024.npz) in both
    packages, the port's embeddings of a 512^2 synthetic image of its kind
    (8 cells; the encoder resizes it to 1024^2, so they keep the sizes it was
    trained on) set on both, and the image's truth."""
    from bench import _load_bench_fixture
    from micro_sam_tpu import util as jutil
    from micro_sam_tpu.models.sam import Sam as JaxSam
    from micro_sam_tpu.predictor import SamPredictor as JaxPredictor
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.models.convert import params_from_flat_npz
    from micro_sam_tpu_torch.models.sam import Sam
    from micro_sam_tpu_torch.predictor import SamPredictor
    from micro_sam_tpu_torch.sample_data import synthetic_data
    jp = JaxPredictor(JaxSam(*_load_bench_fixture(FIXTURE)))
    cfg, sd = params_from_flat_npz(FIXTURE)
    sam = Sam(cfg)
    sam.load_state_dict(sd)
    pp = SamPredictor(sam.eval())
    image, gt = synthetic_data(shape=(512, 512), seed=201, n_objects=8, radius_range=(15, 55))
    emb = util.precompute_image_embeddings(pp, image, verbose=False)
    util.set_precomputed(pp, emb)
    jutil.set_precomputed(jp, emb)
    return jp, pp, gt.astype(np.uint32)


def test_iterative_prompting_free_running(fixture_models, exact_prompts, tmp_path, monkeypatch):
    """Each package draws its own corrective points under one numpy seed, 3
    iterations from boxes on the trained fixture (whose masks score):
    per-iteration mSA within FREE_RUNNING_MSA of the JAX package's, round 0
    equal."""
    from micro_sam_tpu_torch.evaluation import mean_segmentation_accuracy
    from micro_sam_tpu_torch.evaluation.inference import iterative_prompting_segmentations
    jp, pp, gt = fixture_models
    np.random.seed(11)
    ref, _ = _jax_iterations(jp, gt, True, False, 3, tmp_path, monkeypatch)
    np.random.seed(11)
    got = iterative_prompting_segmentations(pp, gt, True, batch_size=32, n_iterations=3)
    msa = np.array([[mean_segmentation_accuracy(s, gt) for s in segs] for segs in (got, ref)])
    assert msa[0, 0] == msa[1, 0] and msa[1].max() > 0.5
    assert np.abs(msa[0] - msa[1]).max() <= FREE_RUNNING_MSA, msa


def test_iterative_prompting_files(models, data, tmp_path):
    """run_inference_with_iterative_prompting writes one TIFF per iteration,
    the segmentations of the array function; the evaluation reads them."""
    import imageio.v3 as imageio
    from micro_sam_tpu_torch.evaluation import run_evaluation_for_iterative_prompting
    from micro_sam_tpu_torch.evaluation.inference import (
        iterative_prompting_segmentations, run_inference_with_iterative_prompting)
    _, pp = models
    image, gt, emb = data
    imageio.imwrite(tmp_path / "im.tif", image)
    imageio.imwrite(tmp_path / "gt.tif", gt)
    np.random.seed(3)
    run_inference_with_iterative_prompting(pp, [str(tmp_path / "im.tif")],
                                           [str(tmp_path / "gt.tif")], None,
                                           str(tmp_path / "pred"), start_with_box_prompt=False,
                                           batch_size=4, n_iterations=3)
    np.random.seed(3)
    segs = iterative_prompting_segmentations(pp, gt, False, batch_size=4, n_iterations=3)
    for it, seg in enumerate(segs):
        assert np.array_equal(imageio.imread(tmp_path / "pred" / f"iteration{it:02}" / "im.tif"),
                              seg)
    res = run_evaluation_for_iterative_prompting([str(tmp_path / "gt.tif")],
                                                 str(tmp_path / "pred"), str(tmp_path / "exp"))
    assert len(res) == 3 and list(res.columns) == ["mSA", "SA50", "SA75"]
    assert os.path.exists(tmp_path / "exp" / "results" / "iterative_prompts_start_point.csv")


@pytest.mark.parametrize("use_points,use_boxes,n_pos,n_neg",
                         [(False, True, 0, 0), (True, False, 2, 3), (True, True, 1, 2)])
def test_run_inference_with_prompts_matches_jax(models, exact_prompts, data, tmp_path, use_points, use_boxes,
                                                n_pos, n_neg):
    """Both packages over the same files (the port's embedding cache read by
    both), numpy's global stream seeded alike: objects at IoU >= 0.99."""
    import imageio.v3 as imageio
    from micro_sam_tpu.evaluation.inference import run_inference_with_prompts as jrun
    from micro_sam_tpu_torch.evaluation.inference import (precompute_all_embeddings,
                                                          run_inference_with_prompts as prun)
    jp, pp = models
    image, gt, _ = data
    imageio.imwrite(tmp_path / "im.tif", image)
    imageio.imwrite(tmp_path / "gt.tif", gt)
    ims, gts = [str(tmp_path / "im.tif")], [str(tmp_path / "gt.tif")]
    precompute_all_embeddings(pp, ims, str(tmp_path / "emb"))
    for fn, pred, out in ((jrun, jp, "jax"), (prun, pp, "port")):
        np.random.seed(5)
        with _quiet():
            fn(pred, ims, gts, str(tmp_path / "emb"), str(tmp_path / out), use_points=use_points,
               use_boxes=use_boxes, n_positives=n_pos, n_negatives=n_neg, batch_size=4)
    got, ref = (imageio.imread(tmp_path / d / "im.tif") for d in ("port", "jax"))
    assert got.dtype == ref.dtype
    assert _object_ious(got, ref, np.unique(gt)[1:]).min() >= 0.99


class _quiet:
    def __enter__(self):
        import warnings
        self.w = warnings.catch_warnings()
        self.w.__enter__()
        warnings.simplefilter("ignore")  # the shared cache's soft keys (backend, hash) differ

    def __exit__(self, *exc):
        self.w.__exit__(*exc)


def test_precompute_all_embeddings_names_arrays_apart(models, data, tmp_path):
    """Two arrays get two caches (image-0, image-1); the JAX package names
    both "array", so its second image meets the first's cache and raises."""
    from micro_sam_tpu.evaluation.inference import precompute_all_embeddings as jpre
    from micro_sam_tpu_torch.evaluation.inference import precompute_all_embeddings as ppre
    from micro_sam_tpu_torch.sample_data import synthetic_data
    jp, pp = models
    images = [data[0], synthetic_data(shape=(SIZE, SIZE), seed=6)[0]]
    ppre(pp, images, str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "port")) == ["image-0.zarr", "image-1.zarr"]
    with pytest.raises(RuntimeError, match="data_signature"):
        jpre(jp, images, str(tmp_path / "jax"))


def _grid_pair(models, kind):
    from micro_sam_tpu import instance_segmentation as jis
    from micro_sam_tpu_torch import instance_segmentation as pis
    jp, pp = models
    if kind == "amg":
        kw = dict(points_per_side=8, points_per_batch=32)
        grid = {"pred_iou_thresh": [0.6, 0.8], "stability_score_thresh": [0.6, 0.9]}
        return (jis.AutomaticMaskGenerator(jp, **kw), pis.AutomaticMaskGenerator(pp, **kw), grid,
                {})
    dp = unetr_jax_params(True)
    # the random decoder's maps are noise around 0.5: thresholds that cut
    # them into a few tens of objects (tests/test_torch_ais.py)
    grid = {"center_distance_threshold": [0.37, 0.4], "boundary_distance_threshold": [0.55],
            "distance_smoothing": [1.0], "min_size": [0, 20]}
    fixed = {"foreground_threshold": AIS_KW["foreground_threshold"]}
    return (jis.InstanceSegmentationWithDecoder(jp, jis.DecoderAdapter(dp)),
            pis.InstanceSegmentationWithDecoder(pp, pis.DecoderAdapter(port_unetr(dp))), grid,
            fixed)


@pytest.mark.parametrize("kind", ["amg", "ais"])
def test_grid_search_matches_jax(models, exact_prompts, data, tmp_path, kind):
    """run_instance_segmentation_grid_search_and_inference in both packages
    over the same embeddings: the per-image CSVs and the best-parameter CSV
    equal under pandas, the same best parameters, the predictions' objects at
    IoU >= 0.99."""
    import imageio.v3 as imageio
    import pandas as pd
    from micro_sam_tpu.evaluation import instance_segmentation as jgs
    from micro_sam_tpu_torch.evaluation import instance_segmentation as pgs
    from micro_sam_tpu_torch.sample_data import synthetic_data
    jseg, pseg, grid, fixed = _grid_pair(models, kind)
    image, gt, _ = data
    image2, gt2 = synthetic_data(shape=(SIZE, SIZE), seed=8, n_objects=5)
    vals = [image, image2]
    gts = [gt, gt2.astype(np.uint32)]
    from micro_sam_tpu_torch.evaluation.inference import precompute_all_embeddings
    precompute_all_embeddings(pseg._predictor, vals, str(tmp_path / "emb"))
    for mod, seg, out in ((jgs, jseg, "jax"), (pgs, pseg, "port")):
        with _quiet():
            mod.run_instance_segmentation_grid_search_and_inference(
                seg, grid, vals, gts, [image], embedding_dir=str(tmp_path / "emb"),
                prediction_dir=str(tmp_path / out / "pred"),
                result_dir=str(tmp_path / out / "gs"), fixed_generate_kwargs=fixed,
                verbose_gs=False, experiment_folder=str(tmp_path / out))
    for name in ("image-0.csv", "image-1.csv"):
        ref = pd.read_csv(tmp_path / "jax" / "gs" / name)
        assert len(ref) == int(np.prod([len(v) for v in grid.values()]))
        pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "port" / "gs" / name), ref)
    (best,) = os.listdir(tmp_path / "jax" / "results")
    pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "port" / "results" / best),
                                  pd.read_csv(tmp_path / "jax" / "results" / best))
    got = pgs.evaluate_instance_segmentation_grid_search(str(tmp_path / "port" / "gs"),
                                                         list(grid))
    ref = jgs.evaluate_instance_segmentation_grid_search(str(tmp_path / "jax" / "gs"),
                                                         list(grid))
    assert got == ref and all(type(v) is float for v in got[0].values())
    got, ref = (imageio.imread(tmp_path / d / "pred" / "image-0.tif") for d in ("port", "jax"))
    ids = np.unique(ref)[1:]
    assert len(ids) and _object_ious(got, ref, ids).min() >= 0.99


@pytest.mark.parametrize("rows", [
    [{"a": 0.1, "b": True, "mSA": 0.5}, {"a": 0.2, "b": False, "mSA": 0.5}],
    [{"a": 1, "c": "mask", "mSA": 0.25}, {"a": 2, "c": "box", "mSA": 0.75},
     {"a": 2, "c": "box", "mSA": 0.125}],
    [{"a": 50, "b": 0.3, "mSA": 1 / 3}, {"a": 100, "b": 0.3, "mSA": 2 / 3}],
])
def test_grid_search_csv_as_pandas(tmp_path, rows):
    """The CSV writer against pandas' to_csv (with and without the index),
    and the best parameters against the JAX package's pandas selection."""
    import pandas as pd
    from micro_sam_tpu.evaluation import instance_segmentation as jgs
    from micro_sam_tpu_torch.evaluation import instance_segmentation as pgs
    for index in (False, True):
        pgs.write_csv(str(tmp_path / "port.csv"), rows, index=index)
        pd.DataFrame(rows).to_csv(tmp_path / "pandas.csv", index=index)
        assert (tmp_path / "port.csv").read_text() == (tmp_path / "pandas.csv").read_text()
    for d in ("p", "j"):
        os.makedirs(tmp_path / d)
    pgs.write_csv(str(tmp_path / "p" / "x.csv"), rows)
    pd.DataFrame(rows).to_csv(tmp_path / "j" / "x.csv", index=False)
    params = [k for k in rows[0] if k != "mSA"]
    got = pgs.evaluate_instance_segmentation_grid_search(str(tmp_path / "p"), params)
    ref = jgs.evaluate_instance_segmentation_grid_search(str(tmp_path / "j"), params)
    assert got == ref
    assert [type(v) for v in got[0].values()] == [type(v.item()) if hasattr(v, "item") else
                                                  type(v) for v in ref[0].values()]


@pytest.mark.parametrize("mode", ["box", "points"])
def test_segment_slices_from_ground_truth_matches_jax(models, exact_prompts, mode):
    """A 3-slice volume, each object projected from its middle slice in both
    packages (each with its own encoder): the same scores, the objects at
    IoU >= 0.99."""
    from micro_sam_tpu.evaluation.multi_dimensional_segmentation import (
        segment_slices_from_ground_truth as jseg)
    from micro_sam_tpu_torch.evaluation.multi_dimensional_segmentation import (
        segment_slices_from_ground_truth as pseg)
    from micro_sam_tpu_torch.sample_data import synthetic_data
    jp, pp = models
    image, seg = synthetic_data(shape=(128, 128), seed=50, n_objects=3)
    volume = np.stack([np.roll(image, 2 * z, axis=0) for z in range(3)])
    gt = np.stack([np.roll(seg, 2 * z, axis=0) for z in range(3)]).astype(np.uint32)
    kw = dict(interactive_seg_mode=mode, iou_threshold=0.5, projection="mask",
              return_segmentation=True)
    ref, ref_seg = jseg(volume, gt, predictor=jp, **kw)
    got, got_seg = pseg(volume, gt, predictor=pp, **kw)
    assert got == ref
    assert got_seg.dtype == ref_seg.dtype
    assert _object_ious(got_seg, ref_seg, np.unique(gt)[1:]).min() >= 0.99
