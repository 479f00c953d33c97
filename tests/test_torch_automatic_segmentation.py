"""The port's automatic segmentation entry points (automatic_segmentation.py,
precompute_state.py) against the JAX package, on the tiny config of
tests/torch_port_util.py with a narrow UNETR, f32 on the CPU.

Label images from the decoder's maps are compared object by object (IoU >=
0.99, >= 98 % matched: the maps agree within 1e-4 and the watershed is exact
on equal maps, tests/test_torch_ais.py); the AIS state caches exchange maps
to the bit between the packages.
"""
import os
import sys

import numpy as np
import pytest

from tests.torch_port_util import AIS_KW, jax_params, matched_share, port_sam, tiny_jax_config
from tests.torch_port_util import one_thread, unetr_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: tier-1's six test processes share the
    machine's cores, and small tensors gain nothing from more (ROADMAP.md,
    Budgets)."""
    with one_thread():
        yield


TILE, HALO = (128, 128), (32, 32)


def _thresholds(segmenter, image, **init):
    """Watershed thresholds at quantiles of the random decoder's maps (the
    port's, on this image), which cut them into tens of objects."""
    segmenter.initialize(image, **init)
    st = segmenter.get_state()
    return dict(center_distance_threshold=float(np.quantile(st["center_distances"], 0.3)),
                boundary_distance_threshold=float(np.quantile(st["boundary_distances"], 0.5)),
                foreground_threshold=float(np.quantile(st["foreground"], 0.4)),
                distance_smoothing=1.0)


@pytest.fixture(scope="module")
def models():
    from micro_sam_tpu.models.sam import Sam as JaxSam
    from micro_sam_tpu.predictor import SamPredictor as JaxPredictor
    from micro_sam_tpu_torch.predictor import SamPredictor
    cfg = tiny_jax_config()
    params = jax_params(cfg)
    jp, pp = JaxPredictor(JaxSam(cfg, params)), SamPredictor(port_sam(cfg, params))
    jp.transform.apply_image = pp.transform.apply_image  # the same pixels into both encoders
    state = {"decoder_state": unetr_jax_params(True)}
    return jp, pp, state


@pytest.fixture(scope="module")
def image():
    from micro_sam_tpu_torch.sample_data import synthetic_data
    return synthetic_data(shape=(256, 320), seed=13, n_objects=6)[0]


@pytest.mark.parametrize("tiled", [False, True], ids=["untiled", "tiled"])
@pytest.mark.parametrize("mode,with_decoder,expected", [
    ("auto", True, "InstanceSegmentationWithDecoder"),
    (None, False, "AutomaticMaskGenerator"),
    ("amg", True, "AutomaticMaskGenerator"),
    ("ais", True, "InstanceSegmentationWithDecoder"),
    ("apg", True, "AutomaticPromptGenerator"),
], ids=["auto_decoder", "auto_no_decoder", "amg", "ais", "apg"])
def test_get_predictor_and_segmenter(models, mode, with_decoder, expected, tiled):
    from micro_sam_tpu_torch.automatic_segmentation import get_predictor_and_segmenter
    _, pp, state = models
    p, seg = get_predictor_and_segmenter("vit_b", predictor=pp, segmentation_mode=mode,
                                         state=state if with_decoder else {}, is_tiled=tiled)
    assert p is pp
    assert type(seg).__name__ == ("Tiled" if tiled else "") + expected
    if hasattr(seg, "_decoder"):
        assert seg._decoder.device == pp.device  # the predictor's device


@pytest.mark.parametrize("mode", ["ais", "apg"])
def test_segmenter_without_decoder_raises(models, mode):
    from micro_sam_tpu_torch.automatic_segmentation import get_predictor_and_segmenter
    _, pp, _ = models
    with pytest.raises(RuntimeError, match="does not contain a decoder"):
        get_predictor_and_segmenter("vit_b", predictor=pp, state={}, segmentation_mode=mode)
    with pytest.raises(ValueError, match="state"):
        get_predictor_and_segmenter("vit_b", predictor=pp, segmentation_mode=mode)


def test_entry_points_want_the_card(tmp_path):
    """Without device="cpu" the entry points want the GPU and raise without one."""
    import torch
    from micro_sam_tpu_torch.automatic_segmentation import get_predictor_and_segmenter
    from micro_sam_tpu_torch.precompute_state import precompute_state
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_predictor_and_segmenter("vit_b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        precompute_state(str(tmp_path / "x.tif"), str(tmp_path / "out"))


@pytest.mark.parametrize("tiled", [False, True], ids=["untiled", "tiled"])
def test_automatic_instance_segmentation_matches_jax(models, image, tmp_path, tiled):
    import imageio.v3 as imageio
    from micro_sam_tpu import automatic_segmentation as jas
    from micro_sam_tpu_torch import automatic_segmentation as pas
    jp, pp, state = models
    tiling = dict(tile_shape=TILE, halo=HALO) if tiled else {}
    emb_path = str(tmp_path / "emb.zarr")
    out_path = str(tmp_path / "seg.tif")
    _, pseg = pas.get_predictor_and_segmenter("vit_b", predictor=pp, state=state, is_tiled=tiled)
    _, jseg = jas.get_predictor_and_segmenter("vit_b", predictor=jp, state=state, is_tiled=tiled)
    kw = _thresholds(pseg, image, **tiling)
    got = pas.automatic_instance_segmentation(pp, pseg, image, output_path=out_path,
                                              embedding_path=emb_path, verbose=False,
                                              batch_size=2, **tiling, **kw)
    # the JAX package reads the port's embedding cache: both decode one set of embeddings
    ref = jas.automatic_instance_segmentation(jp, jseg, image, embedding_path=emb_path,
                                              verbose=False, batch_size=2, **tiling, **kw)
    assert got.shape == ref.shape == image.shape and got.dtype == np.uint32
    share, n = matched_share(got, ref)
    assert n > 5 and share >= 0.98, (share, n)
    np.testing.assert_array_equal(imageio.imread(out_path), got)
    # an existing result is left as it is
    assert pas.automatic_instance_segmentation(pp, pseg, image, output_path=out_path,
                                               verbose=False) is None


@pytest.mark.parametrize("mode", ["apg", "amg"])
def test_automatic_instance_segmentation_other_modes(models, image, mode):
    from micro_sam_tpu_torch import automatic_segmentation as pas
    _, pp, state = models
    extra = dict(points_per_side=4) if mode == "amg" else {}
    _, seg = pas.get_predictor_and_segmenter("vit_b", predictor=pp, state=state,
                                             segmentation_mode=mode, **extra)
    kw = dict(pred_iou_thresh=0.0, stability_score_thresh=0.0) if mode == "amg" else dict(
        min_size=0, prompt_function=lambda *a, **k: {
            "points": np.array([[[60.0, 60.0]], [[200.0, 128.0]]]),
            "point_labels": np.ones((2, 1))})
    if mode == "amg":
        seg._prefilter_thresholds = None
    out, emb = pas.automatic_instance_segmentation(pp, seg, image, verbose=False,
                                                   return_embeddings=True, **kw)
    assert out.shape == image.shape and out.dtype == np.uint32 and out.max() > 0
    assert emb["original_size"] == image.shape


def test_tiled_with_mask_matches_jax(models, image):
    """A mask restricts the tiled path to the tiles it touches; the other
    tiles' area stays empty."""
    from micro_sam_tpu import automatic_segmentation as jas
    from micro_sam_tpu_torch import automatic_segmentation as pas
    from micro_sam_tpu_torch.utils.blocking import Blocking
    jp, pp, state = models
    mask = np.zeros(image.shape, bool)
    mask[10:100, 20:110] = True  # tile 0 only
    _, pseg = pas.get_predictor_and_segmenter("vit_b", predictor=pp, state=state, is_tiled=True)
    ws = _thresholds(pseg, image, tile_shape=TILE, halo=HALO)
    got = pas.automatic_instance_segmentation(pp, pseg, image, tile_shape=TILE, halo=HALO,
                                              mask_path=mask, verbose=False, **ws)
    inner0 = Blocking([0, 0], image.shape, TILE).get_block_with_halo(0, list(HALO)).inner_block
    outside = np.ones(image.shape, bool)
    outside[inner0.slicing] = False
    assert got.shape == image.shape and not got[outside].any() and got.max() > 0
    _, jseg = jas.get_predictor_and_segmenter("vit_b", predictor=jp, state=state, is_tiled=True)
    maps = pseg.get_state()
    jseg._image_embeddings = pseg._image_embeddings
    jseg.set_state(maps)
    np.testing.assert_array_equal(got, jseg.generate(**ws))


def test_volumes_and_tracking_are_not_ported(models, image):
    """What is still not ported raises: a mask with a volume, the annotator.
    Volumes and timeseries themselves run (tests/test_torch_multi_dimensional_segmentation.py);
    inputs of the wrong shape raise."""
    from micro_sam_tpu_torch import automatic_segmentation as pas
    _, pp, state = models
    _, seg = pas.get_predictor_and_segmenter("vit_b", predictor=pp, state=state)
    with pytest.raises(NotImplementedError, match="2d inputs only"):
        pas.automatic_instance_segmentation(pp, seg, np.stack([image] * 2),
                                            mask_path=np.ones((2,) + image.shape), verbose=False)
    with pytest.raises(ValueError, match="shape expectation of 3d"):
        pas.automatic_instance_segmentation(pp, seg, image, ndim=3, verbose=False)
    with pytest.raises(ValueError, match="shape expectation of 3d"):
        pas.automatic_tracking(pp, seg, image)
    with pytest.raises(RuntimeError, match="napari"):  # the annotator needs napari
        pas.automatic_instance_segmentation(pp, seg, image, annotate=True, verbose=False)
    with pytest.raises(ValueError, match="shape expectation"):
        pas.automatic_instance_segmentation(pp, seg, np.zeros((4, 5, 6)), ndim=2, verbose=False)


def test_cache_is_state_both_ways(models, image, tmp_path):
    """The AIS maps through the h5 store: written, read back into a fresh
    segmenter to the bit, and exchanged with the JAX package's store."""
    from micro_sam_tpu import precompute_state as jps
    from micro_sam_tpu.instance_segmentation import get_decoder as jax_decoder
    from micro_sam_tpu_torch import precompute_state as pps
    from micro_sam_tpu_torch.instance_segmentation import get_decoder
    from micro_sam_tpu_torch.util import precompute_image_embeddings
    jp, pp, state = models
    emb = precompute_image_embeddings(pp, image, verbose=False)
    dec = get_decoder(decoder_state=state["decoder_state"], device="cpu")
    first = pps.cache_is_state(pp, dec, image, emb, str(tmp_path), verbose=False)
    assert os.path.exists(tmp_path / "is_state.h5")
    again = pps.cache_is_state(pp, dec, image, emb, str(tmp_path), verbose=False)
    for k in first._STATE_KEYS:
        np.testing.assert_array_equal(getattr(again, f"_{k}"), getattr(first, f"_{k}"))
    assert pps.cache_is_state(pp, dec, image, emb, str(tmp_path), verbose=False,
                              skip_load=True) is None
    # the JAX package reads the port's maps, and the port the JAX package's
    theirs = jps.cache_is_state(jp, jax_decoder(decoder_state=state["decoder_state"]), image,
                                emb, str(tmp_path), verbose=False)
    for k in first._STATE_KEYS:
        np.testing.assert_array_equal(getattr(theirs, f"_{k}"), getattr(first, f"_{k}"))
    (tmp_path / "jax").mkdir()
    jps.cache_is_state(jp, jax_decoder(decoder_state=state["decoder_state"]), image, emb,
                       str(tmp_path / "jax"), verbose=False, i=None)
    ours = pps.cache_is_state(pp, dec, image, emb, str(tmp_path / "jax"), verbose=False)
    for k in first._STATE_KEYS:
        assert float(np.abs(getattr(ours, f"_{k}") - getattr(first, f"_{k}")).max()) <= 1e-4
    np.testing.assert_array_equal(ours.generate(**AIS_KW),
                                  theirs.__class__.generate(ours, **AIS_KW))


def test_cache_amg_state_round_trip(models, image, tmp_path):
    from micro_sam_tpu_torch import precompute_state as pps
    from micro_sam_tpu_torch.util import precompute_image_embeddings
    _, pp, _ = models
    emb = precompute_image_embeddings(pp, image, verbose=False)
    amg = pps.cache_amg_state(pp, image, emb, str(tmp_path), verbose=False, points_per_side=4,
                              prefilter_thresholds=None)
    assert os.path.exists(tmp_path / "amg_state" / "state.pkl")
    again = pps.cache_amg_state(pp, image, emb, str(tmp_path), verbose=False, points_per_side=4,
                                prefilter_thresholds=None)
    kw = dict(pred_iou_thresh=0.0, stability_score_thresh=0.0)
    np.testing.assert_array_equal(again.generate(**kw), amg.generate(**kw))
    sliced = pps.cache_amg_state(pp, image, emb, str(tmp_path), verbose=False, i=None,
                                 points_per_side=4)
    assert sliced.is_initialized


@pytest.fixture
def patched_model(models, monkeypatch):
    """get_sam_model handing out the tiny predictor, with the device it was asked for."""
    from micro_sam_tpu_torch import util
    _, pp, state = models
    asked = []

    def fake(model_type=None, device=None, checkpoint_path=None, return_state=False, **kw):
        asked.append(device)
        return (pp, dict(state)) if return_state else pp
    monkeypatch.setattr(util, "get_sam_model", fake)
    return asked


@pytest.mark.parametrize("with_decoder", [True, False], ids=["ais", "amg"])
def test_precompute_state_over_files(models, image, tmp_path, patched_model, monkeypatch,
                                     with_decoder):
    import imageio.v3 as imageio
    from micro_sam_tpu_torch import precompute_state as pps
    from micro_sam_tpu_torch import util
    import functools
    _, pp, state = models
    if not with_decoder:
        monkeypatch.setattr(util, "get_sam_model",
                            lambda **kw: (patched_model.append(kw["device"]) or (pp, {})))
        # AMG's state at 4 x 4 points (the default grid is 32 x 32)
        monkeypatch.setattr(pps, "cache_amg_state",
                            functools.partial(pps.cache_amg_state, points_per_side=4))
    folder = tmp_path / "images"
    folder.mkdir()
    for k in range(2):
        imageio.imwrite(folder / f"im{k}.tif", np.roll(image, 10 * k, axis=1))
    out = tmp_path / "out"
    pps.precompute_state(str(folder), str(out), pattern="*.tif", precompute_amg_state=True,
                         verbose=False, device="cpu")
    assert patched_model == ["cpu"]
    for k in range(2):
        root = out / f"im{k}.zarr"
        assert (root / ".zgroup").exists() or (root / "zarr.json").exists() or root.is_dir()
        if with_decoder:
            assert (root / "is_state.h5").exists()
        else:
            assert (root / "amg_state" / "state.pkl").exists()


def test_precompute_state_over_a_volume(models, tmp_path, patched_model):
    """A volume: the embeddings of every slice, then each slice's AIS maps
    under its own h5 group, equal to the slice's own decode."""
    import h5py
    from micro_sam_tpu_torch import precompute_state as pps
    from micro_sam_tpu_torch.instance_segmentation import (InstanceSegmentationWithDecoder,
                                                           get_decoder)
    from micro_sam_tpu_torch.sample_data import synthetic_data
    from micro_sam_tpu_torch.util import precompute_image_embeddings
    _, pp, state = models
    vol = np.stack([synthetic_data(shape=(128, 160), seed=s)[0] for s in (1, 2)])
    out = tmp_path / "vol"
    pps.precompute_state(vol, str(out), ndim=3, precompute_amg_state=True, verbose=False,
                         device="cpu")
    with h5py.File(out.with_suffix(".zarr") / "is_state.h5", "r") as f:
        assert sorted(f) == ["state-0", "state-1"]
        fg1 = f["state-1"]["foreground"][:]
    ais = InstanceSegmentationWithDecoder(pp, get_decoder(decoder_state=state["decoder_state"],
                                                          device="cpu"))
    ais.initialize(vol[1], image_embeddings=precompute_image_embeddings(pp, vol[1],
                                                                        verbose=False))
    assert fg1.shape == vol.shape[1:]
    assert float(np.abs(fg1 - ais._foreground).max()) <= 1e-5


def test_split_kwargs():
    from micro_sam_tpu_torch.automatic_segmentation import _split_kwargs
    init_kwargs, gen_kwargs = _split_kwargs(
        ["--points_per_side", "16", "--pred_iou_thresh", "0.7", "--output_mode", "binary_mask",
         "--verbose_off", "true"])
    assert init_kwargs == {"points_per_side": 16}
    assert gen_kwargs == {"pred_iou_thresh": 0.7, "output_mode": "binary_mask",
                          "verbose_off": True}


def test_add_suffix_and_inputs_from_paths(tmp_path):
    from micro_sam_tpu_torch.automatic_segmentation import (_add_suffix_to_output_path,
                                                            _get_inputs_from_paths)
    assert _add_suffix_to_output_path("a/seg", "_automatic").endswith("a/seg_automatic.tif")
    assert _add_suffix_to_output_path("seg.png", "_x").endswith("seg_x.png")
    for name in ("b.tif", "a.tif", "c.png"):
        (tmp_path / name).write_bytes(b"")
    assert [os.path.basename(p) for p in _get_inputs_from_paths(str(tmp_path), "*.tif")] == \
        ["a.tif", "b.tif"]
    assert _get_inputs_from_paths(str(tmp_path / "c.png"), None) == [str(tmp_path / "c.png")]


def test_command_lines(models, image, tmp_path, patched_model, monkeypatch):
    """Both command lines with -d cpu: the device reaches the model, the
    unknown arguments reach generate."""
    import imageio.v3 as imageio
    from micro_sam_tpu_torch import automatic_segmentation as pas
    from micro_sam_tpu_torch import precompute_state as pps
    path = tmp_path / "im.tif"
    imageio.imwrite(path, image)
    out = tmp_path / "seg.tif"
    args = ["-i", str(path), "-o", str(out), "-d", "cpu", "--mode", "ais"]
    for k, v in AIS_KW.items():
        args += [f"--{k}", str(v)]
    monkeypatch.setattr(sys, "argv", ["micro_sam_tpu_torch.automatic_segmentation"] + args)
    pas.main()
    seg = imageio.imread(out)
    assert seg.shape == image.shape and seg.max() > 0
    monkeypatch.setattr(sys, "argv", ["micro_sam_tpu_torch.precompute_embeddings", "-i",
                                      str(path), "-e", str(tmp_path / "emb"), "-d", "cpu", "-p"])
    pps.main()
    assert (tmp_path / "emb.zarr" / "is_state.h5").exists()
    assert patched_model == ["cpu", "cpu"]
