"""The port's evaluation flows (the cases of tests/test_evaluation_flows.py):
the benchmark series (crops, the automatic and interactive series with their
resume, the clean-up guard, the single-dataset runner and the command line),
the LIVECell runners, the 3d grid search and the model comparison, held
against the JAX package where both run on the same data.

The models are the tiny config at 128 px (tests/torch_port_util.py) with the
same weights in both packages, the SAM decoder's last hypernetwork layers
scaled by 30 and the JAX predictor's power-of-two prompt buckets turned off
(tests/test_torch_evaluation.py). Tolerances: the crops and the tables
exact; predictions object by object at IoU >= 0.99.
"""
import os
from glob import glob

import numpy as np
import pytest

from tests.torch_port_util import jax_params, one_thread, port_sam, tiny_jax_config


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: tier-1's six test processes share the
    machine's cores, and small tensors gain nothing from more (ROADMAP.md,
    Budgets)."""
    with one_thread():
        yield


SIZE = 128


@pytest.fixture(scope="module")
def models():
    from micro_sam_tpu.models.sam import Sam as JaxSam
    from micro_sam_tpu.predictor import SamPredictor as JaxPredictor
    from micro_sam_tpu_torch.predictor import SamPredictor
    cfg = tiny_jax_config(img_size=SIZE)
    params = jax_params(cfg)
    for h in params["mask_decoder"]["hyper_mlps"]:
        h["layers"][2]["w"] = h["layers"][2]["w"] * 30.0
        h["layers"][2]["b"] = h["layers"][2]["b"] * 30.0
    jp, pp = JaxPredictor(JaxSam(cfg, params)), SamPredictor(port_sam(cfg, params))
    jp.transform.apply_image = pp.transform.apply_image  # the same pixels into both encoders
    return jp, pp, params


@pytest.fixture
def exact_prompts(monkeypatch):
    import micro_sam_tpu.predictor as jpred
    monkeypatch.setattr(jpred, "_next_pow2", lambda n: n)


@pytest.fixture
def patched_models(models, monkeypatch):
    """get_sam_model of each package handing out its tiny predictor."""
    from micro_sam_tpu import util as jutil
    from micro_sam_tpu_torch import util
    jp, pp, params = models
    for mod, pred, state in ((jutil, jp, {"model_state": params}),
                             (util, pp, {"model_state": pp.model.state_dict()})):
        monkeypatch.setattr(mod, "get_sam_model",
                            lambda pred=pred, state=state, **kw:
                            (pred, dict(state)) if kw.get("return_state") else pred)
    return jp, pp


def _make_pair_dataset(root, name, n=2, shape=(SIZE, SIZE), volumetric=False, seed=70):
    import imageio.v3 as imageio
    from micro_sam_tpu_torch.sample_data import synthetic_data
    img_dir, gt_dir = os.path.join(root, name, "images"), os.path.join(root, name, "labels")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    for i in range(n):
        image, seg = synthetic_data(shape=shape, seed=seed + i, n_objects=3)
        if volumetric:
            image = np.stack([np.roll(image, 2 * z, axis=0) for z in range(3)])
            seg = np.stack([np.roll(seg, 2 * z, axis=0) for z in range(3)])
        imageio.imwrite(os.path.join(img_dir, f"im{i}.tif"), image)
        imageio.imwrite(os.path.join(gt_dir, f"im{i}.tif"), seg.astype(np.uint16))
    return sorted(glob(os.path.join(img_dir, "*"))), sorted(glob(os.path.join(gt_dir, "*")))


def _object_ious(got, ref):
    out = []
    for i in np.unique(ref)[1:]:
        a, b = got == i, ref == i
        out.append((a & b).sum() / max((a | b).sum(), 1))
    return np.array(out) if out else np.ones(1)


@pytest.mark.parametrize("dataset,volumetric", [("livecell", False), ("lucchi", True)])
def test_crop_extraction_matches_jax(tmp_path, dataset, volumetric):
    """The most-instances-first crops (and, for a volume, its per-slice 2d
    crops) equal the JAX package's, file by file; a second call finds them."""
    import imageio.v3 as imageio
    from micro_sam_tpu.evaluation import benchmark_datasets as jbd
    from micro_sam_tpu_torch.evaluation import benchmark_datasets as pbd
    shape = (SIZE, 600) if not volumetric else (SIZE, SIZE)
    for pkg in ("jax", "port"):
        _make_pair_dataset(str(tmp_path / pkg), dataset, n=2, shape=shape, volumetric=volumetric)
    ndim = pbd._extract_slices_from_dataset(str(tmp_path / "port" / dataset), dataset)
    assert ndim == jbd._extract_slices_from_dataset(str(tmp_path / "jax" / dataset), dataset)
    assert ndim == (3 if volumetric else 2)
    for d in ((2, 3) if volumetric else (2,)):
        got = pbd._get_image_label_paths(str(tmp_path / "port" / dataset), d)
        ref = jbd._get_image_label_paths(str(tmp_path / "jax" / dataset), d)
        assert [os.path.basename(p) for p in got[0]] == [os.path.basename(p) for p in ref[0]]
        assert len(got[0]) == len(got[1]) > 0
        for g, r in zip(got[0] + got[1], ref[0] + ref[1]):
            assert np.array_equal(imageio.imread(g), imageio.imread(r))
    assert pbd._extract_slices_from_dataset(str(tmp_path / "port" / dataset), dataset) == ndim


def test_benchmark_automatic_series(models, tmp_path, monkeypatch):
    """The AMG series over crops writes its table (the JAX package's columns)."""
    import pandas as pd
    from micro_sam_tpu_torch.automatic_segmentation import get_predictor_and_segmenter
    from micro_sam_tpu_torch.evaluation import benchmark_datasets as bd
    _, pp, _ = models
    state = {"model_state": pp.model.state_dict()}
    asked = []

    def fake(model_type, checkpoint=None, segmentation_mode=None, is_tiled=False, device=None):
        asked.append(device)
        return get_predictor_and_segmenter(model_type, predictor=pp, state=state,
                                           segmentation_mode=segmentation_mode,
                                           is_tiled=is_tiled, points_per_side=4,
                                           points_per_batch=16)
    monkeypatch.setattr(bd, "get_predictor_and_segmenter", fake)
    images, gts = _make_pair_dataset(str(tmp_path), "tiny", n=1)
    out = str(tmp_path / "out")
    bd._run_automatic_segmentation_per_dataset(images, gts, "vit_b", out, ndim=2,
                                               segmentation_mode="amg", device="cpu")
    res = pd.read_csv(os.path.join(out, "results", "amg_2d.csv"))
    assert list(res.columns) == ["mSA", "SA50", "SA75"] and asked == ["cpu"]
    assert len(glob(os.path.join(out, "amg_2d", "inference", "*"))) == 1


def test_benchmark_interactive_3d_series_resumes(models, patched_models, tmp_path, monkeypatch):
    """The 3d interactive series stores its segmentation; with its table
    removed it scores the stored segmentation without segmenting again."""
    from micro_sam_tpu_torch.evaluation import benchmark_datasets as bd
    from micro_sam_tpu_torch.evaluation import multi_dimensional_segmentation as mds
    images, gts = _make_pair_dataset(str(tmp_path / "data"), "vol", n=1, volumetric=True)
    out = str(tmp_path / "out")
    os.makedirs(os.path.join(out, "results"), exist_ok=True)
    bd._run_interactive_segmentation_per_dataset(images, gts, out, "vit_b", prompt_choice="box",
                                                 ndim=3)
    csv = os.path.join(out, "results", "interactive_segmentation_3d_with_box.csv")
    assert os.path.exists(csv)
    assert len(glob(os.path.join(out, "interactive_segmentation_3d", "box", "*"))) == 1
    first = open(csv).read()

    def boom(*a, **k):
        raise AssertionError("resume must not segment again")
    monkeypatch.setattr(mds, "segment_mask_in_volume", boom)
    os.remove(csv)
    bd._run_interactive_segmentation_per_dataset(images, gts, out, "vit_b", prompt_choice="box",
                                                 ndim=3)
    assert open(csv).read() == first


def test_benchmark_runner_matches_jax(models, patched_models, exact_prompts, tmp_path):
    """run_benchmark_evaluation's interactive series (box and point starts,
    3 iterations) in both packages, numpy's stream seeded alike: the same
    iterative-prompting tables, within the free-running bound of
    tests/test_torch_evaluation.py."""
    import pandas as pd
    from micro_sam_tpu.evaluation import benchmark_datasets as jbd
    from micro_sam_tpu_torch.evaluation import benchmark_datasets as pbd
    _make_pair_dataset(str(tmp_path / "data"), "tiny", n=2)
    frames = {}
    for name, mod in (("jax", jbd), ("port", pbd)):
        np.random.seed(0)
        frames[name] = mod.run_benchmark_evaluation(
            str(tmp_path / "data"), "tiny", "vit_b", str(tmp_path / name), run_amg=False,
            run_ais=False, run_interactive=True, n_val=1)
        assert os.path.exists(tmp_path / name / "tiny" / "vit_b" / "benchmark_results.csv")
    assert list(frames["port"].index) == list(frames["jax"].index) == [
        "interactive_point", "interactive_box"]
    pd.testing.assert_frame_equal(frames["port"], frames["jax"], atol=0.1, rtol=0)
    for start in ("point", "box"):
        name = f"iterative_prompts_start_{start}.csv"
        got = pd.read_csv(tmp_path / "port" / "tiny" / "vit_b" / "results" / name)
        ref = pd.read_csv(tmp_path / "jax" / "tiny" / "vit_b" / "results" / name)
        assert len(got) == len(ref) == 3
        pd.testing.assert_frame_equal(got.iloc[:1], ref.iloc[:1])   # round 0: no draw yet


def test_benchmark_command_line(models, patched_models, tmp_path):
    """The command line over a local dataset: the interactive 2d series, its
    tables, and the crops removed afterwards (the source data kept)."""
    from micro_sam_tpu_torch.evaluation import benchmark_datasets as bd
    _make_pair_dataset(str(tmp_path / "data"), "livecell", n=1)
    bd.main(["-i", str(tmp_path / "data"), "-d", "livecell", "-o", str(tmp_path / "out"),
             "--evaluate", "interactive", "-D", "cpu"])
    results = sorted(os.listdir(tmp_path / "out" / "livecell" / "results"))
    assert results == ["iterative_prompts_start_box.csv",
                       "iterative_prompts_start_box_use_masks.csv",
                       "iterative_prompts_start_point.csv",
                       "iterative_prompts_start_point_use_masks.csv"]
    assert sorted(os.listdir(tmp_path / "data" / "livecell")) == ["images", "labels"]


def test_benchmark_cleanup_never_deletes_source_data_by_default(tmp_path):
    """As in the JAX package: the default clean-up keeps images/ and labels/
    (there is no download to bring them back); ``retain=[]`` removes them."""
    from micro_sam_tpu_torch.evaluation import benchmark_datasets as bd
    data = tmp_path / "ds"
    for sub in ("images", "labels", "roi_2d"):
        (data / sub).mkdir(parents=True)
        (data / sub / "f.tif").write_bytes(b"x")
    out = tmp_path / "out"
    (out / "amg_2d").mkdir(parents=True)
    (out / "interactive_segmentation_2d").mkdir(parents=True)
    bd._clear_cached_items(retain=None, path=str(data), output_folder=str(out))
    assert (data / "images" / "f.tif").exists() and (data / "labels" / "f.tif").exists()
    assert not (data / "roi_2d").exists()
    assert not (out / "amg_2d").exists() and not (out / "interactive_segmentation_2d").exists()
    bd._clear_cached_items(retain=["data"], path=str(data), output_folder=str(out))
    assert (data / "images").exists()
    bd._clear_cached_items(retain=[], path=str(data), output_folder=str(out))
    assert not (data / "images").exists()


def _livecell_layout(root, n=1):
    """The official LIVECell layout with synthetic images of two cell types."""
    import imageio.v3 as imageio
    from micro_sam_tpu_torch.sample_data import synthetic_data
    img_dir = os.path.join(root, "images", "livecell_test_images")
    os.makedirs(img_dir, exist_ok=True)
    for k, cell_type in enumerate(("A172", "BV2")):
        gt_dir = os.path.join(root, "annotations", "livecell_test_images", cell_type)
        os.makedirs(gt_dir, exist_ok=True)
        for i in range(n):
            image, seg = synthetic_data(shape=(SIZE, SIZE), seed=90 + 10 * k + i, n_objects=3)
            imageio.imwrite(os.path.join(img_dir, f"{cell_type}_{i}.tif"), image)
            imageio.imwrite(os.path.join(gt_dir, f"{cell_type}_{i}.tif"), seg.astype(np.uint16))


def test_livecell_runners_match_jax(models, patched_models, exact_prompts, tmp_path):
    """The LIVECell paths and livecell_inference (points) in both packages:
    the same files, the predictions object by object at IoU >= 0.99; then the
    port's default settings' inference and evaluation (the settings' prompt
    inference is held against the JAX package in tests/test_torch_evaluation.py)."""
    import imageio.v3 as imageio
    import pandas as pd
    from micro_sam_tpu.evaluation import livecell as jlc
    from micro_sam_tpu_torch.evaluation import livecell as plc
    _livecell_layout(str(tmp_path / "data"))
    assert plc._get_livecell_paths(str(tmp_path / "data")) == \
        jlc._get_livecell_paths(str(tmp_path / "data"))
    with pytest.raises(RuntimeError, match="not found"):
        plc._get_livecell_paths(str(tmp_path / "missing"))
    for name, mod in (("jax", jlc), ("port", plc)):
        np.random.seed(1)
        mod.livecell_inference(None, str(tmp_path / "data"), "vit_b", str(tmp_path / name),
                               use_points=True, use_boxes=False, n_positives=1, n_negatives=1)
    preds = sorted(glob(str(tmp_path / "jax" / "points" / "p1-n1" / "*.tif")))
    assert len(preds) == 2
    for ref in preds:
        got = ref.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
        assert _object_ious(imageio.imread(got), imageio.imread(ref)).min() >= 0.99
    plc.run_livecell_inference(None, str(tmp_path / "data"), "vit_b", str(tmp_path / "port"))
    plc.run_livecell_evaluation(str(tmp_path / "data"), str(tmp_path / "port"))
    tables = sorted(glob(str(tmp_path / "port" / "results" / "*.csv")))
    assert [os.path.basename(t) for t in tables] == [
        "box.csv", "points-p1-n0.csv", "points-p2-n4.csv", "points-p4-n8.csv"]
    assert all(list(pd.read_csv(t).columns) == ["mSA", "SA50", "SA75"] for t in tables)


def test_multi_dimensional_grid_search_matches_jax(models, patched_models, exact_prompts,
                                                   tmp_path):
    """run_multi_dimensional_segmentation_grid_search over a 1 x 2 x 1 grid in
    both packages: the CSVs equal under pandas (the port's written without
    pandas), the stored segmentations object by object at IoU >= 0.99."""
    import imageio.v3 as imageio
    import pandas as pd
    from micro_sam_tpu.evaluation import multi_dimensional_segmentation as jmd
    from micro_sam_tpu_torch.evaluation import multi_dimensional_segmentation as pmd
    from micro_sam_tpu_torch.sample_data import synthetic_data
    image, seg = synthetic_data(shape=(SIZE, SIZE), seed=50, n_objects=3)
    volume = np.stack([np.roll(image, 2 * z, axis=0) for z in range(3)])
    gt = np.stack([np.roll(seg, 2 * z, axis=0) for z in range(3)]).astype(np.uint32)
    grid = {"iou_threshold": [0.5], "projection": ["box", "mask"], "box_extension": [0.1]}
    for name, mod in (("jax", jmd), ("port", pmd)):
        path = mod.run_multi_dimensional_segmentation_grid_search(
            volume, gt, "vit_b", None, None, str(tmp_path / name), grid_search_values=grid,
            store_segmentation=True)
        assert path == str(tmp_path / name / "grid_search_results.csv")
    ref = pd.read_csv(tmp_path / "jax" / "grid_search_results.csv")
    assert len(ref) == 2
    pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "port" / "grid_search_results.csv"), ref)
    for path in sorted(glob(str(tmp_path / "jax" / "segmentation-*.tif"))):
        got = imageio.imread(path.replace("jax", "port", 1))
        assert _object_ious(got, imageio.imread(path)).min() >= 0.99


def test_model_comparison_flow(models, exact_prompts, tmp_path, monkeypatch):
    """generate_data_for_model_comparison with the same two models in both
    packages: the same h5 layout and per-object masks (IoU >= 0.99), equal
    scores; the galleries are written; the napari browser raises cleanly
    without napari."""
    import h5py
    from micro_sam_tpu import util as jutil
    from micro_sam_tpu.models.sam import Sam as JaxSam
    from micro_sam_tpu.predictor import SamPredictor as JaxPredictor
    from micro_sam_tpu.evaluation import model_comparison as jmc
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.evaluation import model_comparison as pmc
    from micro_sam_tpu_torch.predictor import SamPredictor
    from micro_sam_tpu_torch.sample_data import synthetic_data
    jp, pp, params = models
    cfg = tiny_jax_config(img_size=SIZE)
    params2 = jax_params(cfg, seed=1)
    for h in params2["mask_decoder"]["hyper_mlps"]:
        h["layers"][2]["w"] = h["layers"][2]["w"] * 30.0
        h["layers"][2]["b"] = h["layers"][2]["b"] * 30.0
    pairs = {"vit_b": (jp, pp),
             "vit_t": (JaxPredictor(JaxSam(cfg, params2)), SamPredictor(port_sam(cfg, params2)))}
    pairs["vit_t"][0].transform.apply_image = pp.transform.apply_image
    monkeypatch.setattr(jutil, "get_sam_model", lambda model_type, **kw: pairs[model_type][0])
    monkeypatch.setattr(util, "get_sam_model", lambda model_type, **kw: pairs[model_type][1])
    image, seg = synthetic_data(shape=(SIZE, SIZE), seed=9, n_objects=3)
    image = np.repeat(image[..., None], 3, axis=-1)
    loader = [(image[None], seg[None])]
    for name, mod in (("jax", jmc), ("port", pmc)):
        mod.generate_data_for_model_comparison(loader, str(tmp_path / name), model_type1="vit_b",
                                               model_type2="vit_t", n_samples=1)
    with h5py.File(tmp_path / "jax" / "sample0.h5", "r") as jf, \
            h5py.File(tmp_path / "port" / "sample0.h5", "r") as pf:
        assert sorted(pf.keys()) == sorted(jf.keys())
        assert sorted(pf["objects"].keys()) == sorted(jf["objects"].keys())
        for oid, obj in jf["objects"].items():
            for key in ("gt_mask", "points/mask1", "points/mask2", "box/mask1", "box/mask2"):
                a, b = pf["objects"][oid][key][:], obj[key][:]
                assert (a & b).sum() / max((a | b).sum(), 1) >= 0.99 or (a | b).sum() == 0
            for k in obj.attrs:
                assert np.array_equal(pf["objects"][oid].attrs[k], obj.attrs[k])
        got = pmc._score_objects(pf, "points", min_size=0, have_model3=False)
        ref = jmc._score_objects(jf, "points", min_size=0, have_model3=False)
        assert list(got.columns) == list(ref.columns)
        assert np.abs(got[["score1", "score2"]].values - ref[["score1", "score2"]].values).max() \
            <= 1e-2
    pmc.model_comparison(str(tmp_path / "port"), n_images_per_sample=2, min_size=0,
                         plot_folder=str(tmp_path / "plots"))
    assert len(glob(str(tmp_path / "plots" / "*.png"))) >= 1
    with pytest.raises(RuntimeError, match="napari"):
        pmc.model_comparison_with_napari(str(tmp_path / "port"))


def test_evaluation_command_line(tmp_path, capsys):
    """python -m micro_sam_tpu_torch.evaluation.evaluation over directories."""
    import imageio.v3 as imageio
    import pandas as pd
    from micro_sam_tpu_torch.evaluation import evaluation
    from micro_sam_tpu_torch.sample_data import synthetic_data
    for d in ("gt", "pred"):
        os.makedirs(tmp_path / d)
    seg = synthetic_data(shape=(64, 64), seed=1, n_objects=3)[1].astype(np.uint16)
    imageio.imwrite(tmp_path / "gt" / "a.tif", seg)
    imageio.imwrite(tmp_path / "pred" / "a.tif", np.roll(seg, 1, axis=0))
    evaluation.main(["-g", str(tmp_path / "gt"), "-p", str(tmp_path / "pred"), "--pattern",
                     "*.tif", "-o", str(tmp_path / "res.csv")])
    res = pd.read_csv(tmp_path / "res.csv")
    assert list(res.columns) == ["mSA", "SA50", "SA75"] and res["SA50"].iloc[0] == 1.0
    assert "mSA" in capsys.readouterr().out
