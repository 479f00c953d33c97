"""The port's decoder-based segmentation (instance_segmentation.py: AIS, APG,
their tiled forms, the factory) and the watershed of native/ against the JAX
package, on the tiny config of tests/torch_port_util.py with a narrow UNETR
(embed 256, features 64 / 32 / 16 / 8) over the same weights (f32, CPU).

Tolerances: the watershed, size filter and ``generate`` on identical maps
equal to the bit; the decoder's maps within 1e-4; end to end from each
package's own maps, objects matched at IoU >= 0.99 with >= 98 % matched.
APG decodes SAM prompts: its label images equal except pixels whose port
logit lies within 1e-3 of the threshold (tests/test_torch_amg.py); the SAM
decoder's last hypernetwork layers are scaled by 30 in both packages so that
random weights give stable masks. The random decoder's maps are noise around
0.5, so the watershed runs at thresholds that leave a few tens of objects.
"""
import pickle

import numpy as np
import pytest
import torch

from tests.torch_port_util import AIS_KW, jax_params, matched_share, port_sam, tiny_jax_config
from tests.torch_port_util import one_thread, port_unetr, unetr_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: tier-1's six test processes share the
    machine's cores, and small tensors gain nothing from more (ROADMAP.md,
    Budgets)."""
    with one_thread():
        yield


FLIP = 1e-3
TILE, HALO = (128, 128), (32, 32)


@pytest.fixture(scope="module")
def setup():
    from micro_sam_tpu import instance_segmentation as jis
    from micro_sam_tpu.models.sam import Sam as JaxSam
    from micro_sam_tpu.predictor import SamPredictor as JaxPredictor
    from micro_sam_tpu_torch import instance_segmentation as pis
    from micro_sam_tpu_torch.predictor import SamPredictor
    from micro_sam_tpu_torch.sample_data import synthetic_data
    cfg = tiny_jax_config()
    params = jax_params(cfg)
    for h in params["mask_decoder"]["hyper_mlps"]:
        h["layers"][2]["w"] = h["layers"][2]["w"] * 30.0
        h["layers"][2]["b"] = h["layers"][2]["b"] * 30.0
    jp, pp = JaxPredictor(JaxSam(cfg, params)), SamPredictor(port_sam(cfg, params))
    jp.transform.apply_image = pp.transform.apply_image  # the same pixels into both encoders
    dp = unetr_jax_params(True)
    image = synthetic_data(shape=(256, 256), seed=7)[0]
    return dict(jp=jp, pp=pp, jd=jis.DecoderAdapter(dp), pd=pis.DecoderAdapter(port_unetr(dp)),
                jis=jis, pis=pis, image=image)


@pytest.fixture(scope="module")
def ais_pair(setup):
    """Both packages' AIS, initialized on the same image."""
    ja = setup["jis"].InstanceSegmentationWithDecoder(setup["jp"], setup["jd"])
    pa = setup["pis"].InstanceSegmentationWithDecoder(setup["pp"], setup["pd"])
    ja.initialize(setup["image"])
    pa.initialize(setup["image"])
    return ja, pa


def _watershed_case(ndim, seed=0, ties=True):
    rng = np.random.RandomState(seed)
    shape = (48, 56) if ndim == 2 else (6, 30, 34)
    hm = rng.rand(*shape).astype(np.float32)
    if ties:
        hm = np.round(hm * 8) / 8
    seeds = np.zeros(shape, np.uint32)
    seeds.flat[rng.choice(hm.size, 15, replace=False)] = np.arange(1, 16)
    mask = rng.rand(*shape) > 0.15
    return hm, seeds, mask


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("method", ["priority", "unionfind", None])
def test_seeded_watershed_matches_jax(method, ndim):
    from micro_sam_tpu import native as jnative
    from micro_sam_tpu_torch import native
    hm, seeds, mask = _watershed_case(ndim)
    got = native.seeded_watershed(hm, seeds, mask, method=method)
    np.testing.assert_array_equal(got, jnative.seeded_watershed(hm, seeds, mask, method=method))
    assert got.dtype == np.uint32 and (got[mask] > 0).any()
    assert (got[~mask & (seeds == 0)] == 0).all()  # seeds stay where they are


@pytest.mark.parametrize("ndim", [2, 3])
def test_plain_flood_equals_the_priority_flood(ndim):
    from micro_sam_tpu import native as jnative
    from micro_sam_tpu_torch import native
    hm, seeds, mask = _watershed_case(ndim, seed=1)
    got = native.seeded_watershed_plain(hm, seeds, mask)
    np.testing.assert_array_equal(got, native.seeded_watershed(hm, seeds, mask,
                                                               method="priority"))
    np.testing.assert_array_equal(got, jnative._watershed_py(hm, seeds, mask.astype(np.uint8)))


def test_watershed_methods_differ_beyond_ties():
    """The union-find flood, which the dispatch takes from 4M pixels on,
    differs from the priority flood on a heightmap without a single tie
    (the JAX package's docstring says only on exact ties): the port keeps
    the JAX package's dispatch, and this pins the divergence."""
    from micro_sam_tpu_torch import native
    rng = np.random.RandomState(2)
    base = rng.rand(128, 128)
    hm = np.empty(base.size, np.float32)
    hm[np.argsort(base.ravel(), kind="stable")] = np.arange(base.size) / base.size
    hm = hm.reshape(base.shape)
    assert len(np.unique(hm)) == hm.size  # no ties
    seeds = np.zeros(hm.shape, np.uint32)
    seeds.flat[rng.choice(hm.size, 20, replace=False)] = np.arange(1, 21)
    a = native.seeded_watershed(hm, seeds, method="priority")
    b = native.seeded_watershed(hm, seeds, method="unionfind")
    assert 0 < (a != b).mean() < 0.2


def test_watershed_rejects_unknown_method_and_shapes():
    from micro_sam_tpu_torch import native
    hm, seeds, mask = _watershed_case(2, seed=2)
    with pytest.raises(ValueError, match="one 2d or 3d shape"):
        native.seeded_watershed(hm, seeds[:-1], mask)
    with pytest.raises(ValueError, match="Unknown watershed method"):
        native.seeded_watershed(hm, seeds, mask, method="flood")


def test_watershed_library_failure_raises(monkeypatch):
    """A library that cannot be built raises; nothing falls back to the flood."""
    from micro_sam_tpu_torch import native
    hm, seeds, mask = _watershed_case(2)

    def broken():
        raise RuntimeError("building postprocess.cpp failed")
    monkeypatch.setattr(native, "library", broken)
    with pytest.raises(RuntimeError, match="failed"):
        native.seeded_watershed(hm, seeds, mask)


@pytest.mark.parametrize("kw", [dict(min_size=20), dict(min_size=5, max_size=60),
                                dict(min_size=20, relabel=False)],
                         ids=["min", "min_max", "keep_ids"])
def test_size_filter_matches_jax(kw):
    from micro_sam_tpu import native as jnative
    from micro_sam_tpu_torch import native
    seg = np.random.RandomState(3).randint(0, 40, size=(64, 64)).astype(np.uint32)
    seg[seg > 30] = 0
    np.testing.assert_array_equal(native.size_filter(seg, **kw), jnative.size_filter(seg, **kw))


def test_distance_transform_matches_jax():
    from micro_sam_tpu import native as jnative
    from micro_sam_tpu_torch import native
    mask = np.random.RandomState(4).rand(40, 50) > 0.3
    np.testing.assert_array_equal(native.distance_transform(mask),
                                  jnative.distance_transform(mask))


def _blobs():
    yy, xx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    d = np.minimum(np.hypot(yy - 20, xx - 20), np.hypot(yy - 44, xx - 44))
    return d / 20.0, (d < 12).astype(np.float32)


@pytest.mark.parametrize("case", ["blobs", "noise"])
def test_watershed_from_distances_matches_jax(case):
    from micro_sam_tpu import instance_segmentation as jis
    from micro_sam_tpu_torch import instance_segmentation as pis
    if case == "blobs":
        cd, fg = _blobs()
        args = (cd, 1 - fg, fg)
        kw = dict(center_distance_threshold=0.4, boundary_distance_threshold=0.9,
                  foreground_threshold=0.5, distance_smoothing=0.6, min_size=5)
    else:
        rng = np.random.RandomState(5)
        args = tuple(rng.rand(3, 80, 70).astype(np.float32))
        kw = dict(center_distance_threshold=0.45, boundary_distance_threshold=0.55,
                  foreground_threshold=0.4, distance_smoothing=1.2, min_size=3)
    got = pis.watershed_from_center_and_boundary_distances(*args, **kw)
    ref = jis.watershed_from_center_and_boundary_distances(*args, **kw)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.uint32
    if case == "blobs":
        assert len(np.unique(got)) - 1 == 2


def test_ais_maps_match_jax(ais_pair, setup):
    ja, pa = ais_pair
    for key in pa._STATE_KEYS:
        got, ref = getattr(pa, f"_{key}"), getattr(ja, f"_{key}")
        assert got.shape == ref.shape == setup["image"].shape and got.dtype == np.float32
        assert float(np.abs(got - ref).max()) <= 1e-4, key


@pytest.mark.parametrize("mode", ["instance_segmentation", "binary_mask"])
@pytest.mark.parametrize("kw", [AIS_KW, dict(AIS_KW, min_size=20, foreground_smoothing=0.0)],
                         ids=["default_smoothing", "min_size"])
def test_ais_generate_on_identical_maps_is_exact(ais_pair, setup, mode, kw):
    ja, _ = ais_pair
    pa = setup["pis"].InstanceSegmentationWithDecoder(setup["pp"], setup["pd"])
    pa.set_state(ja.get_state())  # JAX's maps
    got, ref = pa.generate(output_mode=mode, **kw), ja.generate(output_mode=mode, **kw)
    if mode == "instance_segmentation":
        assert got.dtype == ref.dtype == np.uint32
        np.testing.assert_array_equal(got, ref)
        assert len(np.unique(got)) > 5
        return
    assert len(got) == len(ref) > 5
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["segmentation"], r["segmentation"])
        assert [g[k] for k in ("area", "bbox", "crop_box", "seg_id")] == \
            [r[k] for k in ("area", "bbox", "crop_box", "seg_id")]


def test_ais_end_to_end_matches_jax(ais_pair):
    ja, pa = ais_pair
    got, ref = pa.generate(**AIS_KW), ja.generate(**AIS_KW)
    share, n = matched_share(got, ref)
    assert n > 5 and share >= 0.98, (share, n)
    assert matched_share(ref, got)[0] >= 0.98


def test_ais_state_round_trip_and_errors(ais_pair, setup):
    _, pa = ais_pair
    state = pickle.loads(pickle.dumps(pa.get_state()))
    again = setup["pis"].InstanceSegmentationWithDecoder(setup["pp"], setup["pd"])
    with pytest.raises(RuntimeError, match="initialize"):
        again.generate()
    again.set_state(state)
    np.testing.assert_array_equal(again.generate(**AIS_KW), pa.generate(**AIS_KW))
    again.clear_state()
    assert not again.is_initialized and again._foreground is None
    with pytest.raises(RuntimeError):
        again.get_state()
    with pytest.raises(ValueError, match="not supported"):
        pa.generate(output_mode="rle", **AIS_KW)


def test_tiled_ais_canvases(setup):
    """Tiled AIS: the canvases within 1e-4 of the JAX package's; equal to the
    bit to each tile's maps from the same batch's decoder output, cropped,
    resized and pasted into its inner block; within 1e-5 of each tile's own
    untiled decode (batch 1)."""
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.models.unetr import postprocess_decoder_output
    from micro_sam_tpu_torch.sample_data import synthetic_data
    from micro_sam_tpu_torch.utils.blocking import Blocking
    pp, pd, pis, jis = setup["pp"], setup["pd"], setup["pis"], setup["jis"]
    image = synthetic_data(shape=(256, 320), seed=8)[0]
    emb = util.precompute_image_embeddings(pp, image, tile_shape=TILE, halo=HALO, verbose=False)
    pt = pis.TiledInstanceSegmentationWithDecoder(pp, pd)
    jt = jis.TiledInstanceSegmentationWithDecoder(setup["jp"], setup["jd"])
    pt.initialize(image, image_embeddings=emb, batch_size=4)
    jt.initialize(image, image_embeddings=emb, batch_size=4)
    for key in pt._STATE_KEYS:
        assert float(np.abs(getattr(pt, f"_{key}") - getattr(jt, f"_{key}")).max()) <= 1e-4
    tiling = Blocking([0, 0], image.shape, TILE)
    n = len(tiling)
    assert n == 6
    canvases = np.zeros((3,) + image.shape, np.float32)
    for chunk in np.array_split(np.arange(n), 2):  # initialize's two batches (of 3)
        feats, frames = [], []
        for t in chunk:  # each tile's features as the segmenter gets them
            feats.append(util.set_precomputed(pp, emb, tile_id=int(t)).features)
            frames.append((pp.input_size, pp.original_size))
        out = pd._forward_impl(torch.cat(feats)).float()
        for k, (t, (ins, orig)) in enumerate(zip(chunk, frames)):
            maps = postprocess_decoder_output(out[k:k + 1], ins, orig)[0].numpy()
            block = tiling.get_block_with_halo(int(t), list(HALO))
            canvases[(slice(None),) + block.inner_block.slicing] = \
                maps[(slice(None),) + block.inner_block_local.slicing]
            alone = pd(tile_feats := feats[k], ins, orig)[0]
            assert tile_feats.shape[0] == 1
            inner = (slice(None),) + block.inner_block_local.slicing
            assert float(np.abs(alone[inner] - maps[inner]).max()) <= 1e-5
    np.testing.assert_array_equal(np.stack([pt._foreground, pt._center_distances,
                                            pt._boundary_distances]), canvases)
    assert pt.generate(**AIS_KW).shape == image.shape


class NearLogits:
    """The pixels (in the image's frame) whose port mask logit lies within
    FLIP of the threshold 0, over every prompt the port decodes; tiled
    decodes are placed by the tile they ran in."""

    def __init__(self, monkeypatch, shape, tiling=None):
        import micro_sam_tpu_torch.inference as inf
        import micro_sam_tpu_torch.predictor as pred
        self.near = np.zeros(shape, bool)
        self.tile = None
        post, install = pred.postprocess_masks, inf.util.set_precomputed

        def record(masks, *a, **k):
            out = post(masks, *a, **k)
            near = (out.abs() < FLIP).reshape(-1, *out.shape[-2:]).any(0).numpy()
            if self.tile is None:
                self.near |= near
            else:
                frame = tiling.get_block_with_halo(self.tile, list(HALO)).outer_block
                self.near[frame.slicing] |= near
            return out

        def installed(p, e, i=None, tile_id=None):
            self.tile = tile_id
            return install(p, e, i=i, tile_id=tile_id)
        monkeypatch.setattr(pred, "postprocess_masks", record)
        monkeypatch.setattr(inf.util, "set_precomputed", installed)


def _install(setup, image):
    """The port's embeddings of ``image`` installed in both predictors."""
    from micro_sam_tpu_torch.util import precompute_image_embeddings
    emb = precompute_image_embeddings(setup["pp"], image, verbose=False)
    for p in (setup["pp"], setup["jp"]):
        p.set_features(emb["features"], emb["original_size"], emb["input_size"])


def _few_points(foreground, center_distances, boundary_distances, **kwargs):
    pts = np.array([[[60.0, 60.0]], [[128.0, 128.0]], [[200.0, 180.0]], [[40.0, 210.0]],
                    [[230.0, 30.0]]])
    return {"points": pts, "point_labels": np.ones((len(pts), 1))}


def _assert_labels_match(got, ref, near):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint32
    assert not ((got != ref) & ~near).any(), int(((got != ref) & ~near).sum())


@pytest.mark.parametrize("refine", [False, True], ids=["points", "box_refinement"])
def test_apg_matches_jax(ais_pair, setup, monkeypatch, refine):
    ja, _ = ais_pair
    pis, jis = setup["pis"], setup["jis"]
    pg = pis.AutomaticPromptGenerator(setup["pp"], setup["pd"])
    jg = jis.AutomaticPromptGenerator(setup["jp"], setup["jd"])
    state = ja.get_state()
    _install(setup, setup["image"])
    pg.set_state(state)
    jg.set_state(state)
    near = NearLogits(monkeypatch, setup["image"].shape)
    kw = dict(min_size=0, prompt_function=_few_points, refine_with_box_prompts=refine)
    got, ref = pg.generate(**kw), jg.generate(**kw)
    _assert_labels_match(got, ref, near.near)
    assert len(np.unique(got)) > 2
    records = pg.generate(output_mode="binary_mask", **kw)
    assert len(records) == len(np.unique(got)) - 1


def test_apg_default_derivation_matches_jax(ais_pair, setup, monkeypatch):
    """The default prompt derivation (cores of the thresholded maps, one
    point each) on a cropped map, then the whole APG on it."""
    ja, _ = ais_pair
    pis, jis = setup["pis"], setup["jis"]
    sl = np.s_[:96, :96]
    maps = {k: v[sl] for k, v in ja.get_state().items()}
    kw = dict(foreground_threshold=0.385, center_distance_threshold=0.37,
              boundary_distance_threshold=0.55)
    got = pis._derive_point_prompts(maps["foreground"], maps["center_distances"],
                                    maps["boundary_distances"], **kw)
    ref = jis._derive_point_prompts(maps["foreground"], maps["center_distances"],
                                    maps["boundary_distances"], **kw)
    assert 2 <= len(got["points"]) <= 200
    np.testing.assert_array_equal(got["points"], ref["points"])
    np.testing.assert_array_equal(got["point_labels"], ref["point_labels"])
    assert got["points"].shape[1:] == (1, 2)
    image = setup["image"][sl]
    _install(setup, image)
    pg = pis.AutomaticPromptGenerator(setup["pp"], setup["pd"])
    jg = jis.AutomaticPromptGenerator(setup["jp"], setup["jd"])
    for g in (pg, jg):
        g.set_state(maps)
    near = NearLogits(monkeypatch, image.shape)
    _assert_labels_match(pg.generate(min_size=0, **kw), jg.generate(min_size=0, **kw),
                         near.near)
    assert pis._derive_point_prompts(*(np.ones((8, 8)),) * 3) is None
    empty = pis.AutomaticPromptGenerator(setup["pp"], setup["pd"])
    empty.set_state({k: np.ones((8, 8), np.float32) for k in maps})
    assert empty.generate().shape == (8, 8) and empty.generate(output_mode="binary_mask") == []


@pytest.fixture(scope="module")
def tiled(setup):
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.sample_data import synthetic_data
    image = synthetic_data(shape=(256, 320), seed=9)[0]
    emb = util.precompute_image_embeddings(setup["pp"], image, tile_shape=TILE, halo=HALO,
                                           verbose=False)
    return image, emb


@pytest.mark.parametrize("variant", ["records", "optimize_memory", "box_refinement"])
def test_tiled_apg_matches_jax(setup, tiled, monkeypatch, variant):
    from micro_sam_tpu_torch.utils.blocking import Blocking
    image, emb = tiled
    pis, jis = setup["pis"], setup["jis"]
    pg = pis.TiledAutomaticPromptGenerator(setup["pp"], setup["pd"])
    jg = jis.TiledAutomaticPromptGenerator(setup["jp"], setup["jd"])
    pg.initialize(image, image_embeddings=emb, batch_size=2)
    jg.set_state(pg.get_state())  # the same maps in both
    near = NearLogits(monkeypatch, image.shape, Blocking([0, 0], image.shape, TILE))
    kw = dict(min_size=0, prompt_function=_few_points, batch_size=2,
              optimize_memory=variant == "optimize_memory",
              refine_with_box_prompts=variant == "box_refinement")
    got, ref = pg.generate(**kw), jg.generate(**kw)
    _assert_labels_match(got, ref, near.near)
    assert len(np.unique(got)) > 2
    if variant == "optimize_memory":
        with pytest.raises(ValueError, match="Invalid settings"):
            pg.generate(optimize_memory=True, output_mode="binary_mask")


def test_tiled_apg_state_round_trip(setup, tiled):
    image, emb = tiled
    pis = setup["pis"]
    pg = pis.TiledAutomaticPromptGenerator(setup["pp"], setup["pd"])
    pg.initialize(image, image_embeddings=emb, batch_size=2)
    state = pickle.loads(pickle.dumps(pg.get_state()))
    assert state["image_embeddings"] is not None
    again = pis.TiledAutomaticPromptGenerator(setup["pp"], setup["pd"])
    again.set_state(state)
    kw = dict(min_size=0, prompt_function=_few_points)
    np.testing.assert_array_equal(again.generate(**kw), pg.generate(**kw))
    no_emb = dict(state, image_embeddings=None)
    with pytest.raises(ValueError, match="does not carry embeddings"):
        pis.TiledAutomaticPromptGenerator(setup["pp"], setup["pd"]).set_state(no_emb)
    restored = pis.TiledAutomaticPromptGenerator(setup["pp"], setup["pd"])
    restored.set_state(no_emb, image_embeddings=emb)
    np.testing.assert_array_equal(restored.generate(**kw), pg.generate(**kw))


@pytest.mark.parametrize("tiled_", [False, True], ids=["untiled", "tiled"])
def test_generator_factory(setup, tiled_):
    pis = setup["pis"]
    pp, pd = setup["pp"], setup["pd"]
    make = pis.get_instance_segmentation_generator
    amg = (pis.TiledAutomaticMaskGenerator if tiled_ else pis.AutomaticMaskGenerator)
    ais = (pis.TiledInstanceSegmentationWithDecoder if tiled_
           else pis.InstanceSegmentationWithDecoder)
    apg = pis.TiledAutomaticPromptGenerator if tiled_ else pis.AutomaticPromptGenerator
    assert type(make(pp, is_tiled=tiled_)) is amg
    assert type(make(pp, is_tiled=tiled_, decoder=pd)) is ais
    assert pis.DEFAULT_SEGMENTATION_MODE_WITH_DECODER == "ais"
    assert type(make(pp, is_tiled=tiled_, decoder=pd, segmentation_mode="AMG",
                     points_per_side=4)) is amg
    assert type(make(pp, is_tiled=tiled_, decoder=pd, segmentation_mode="ais")) is ais
    assert type(make(pp, is_tiled=tiled_, decoder=pd, segmentation_mode="apg")) is apg
    with pytest.raises(ValueError, match="Invalid segmentation_mode"):
        make(pp, is_tiled=tiled_, decoder=pd, segmentation_mode="watershed")
    with pytest.raises(ValueError, match="needs a decoder"):
        make(pp, is_tiled=tiled_, segmentation_mode="apg")


def test_decoder_entry_points_want_the_card(setup):
    """Without device="cpu" the decoder wants the GPU; the predictor's
    checkpoint without a decoder state is refused."""
    from micro_sam_tpu_torch import instance_segmentation as pis
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pis.get_decoder()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pis.get_unetr(decoder_state=unetr_jax_params(True))
