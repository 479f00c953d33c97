"""The port's multi-dimensional segmentation (multi_dimensional_segmentation.py,
native.greedy_multicut, the 3d branch of automatic_segmentation.py and
automatic_tracking) against the JAX package, on the tiny config of
tests/torch_port_util.py (128 px) with a narrow UNETR, f32 on the CPU.

Tolerances:
- the integer parts get the same integer inputs in both packages and are held
  to the bit: the multicut (C++, its Python twin and the JAX package's; both
  number a cluster by its smallest node, so the labels themselves are equal,
  not only the partitions), the overlap edges, the gap closing, the merge,
  the greedy linker, ``track_across_frames`` (segmentation and the lineage
  list in its order), the napari track data and the CTC export;
- ``segment_mask_in_volume`` decodes slice after slice from the previous
  slice's mask: every slice's mask within IoU 0.99 of the JAX package's and
  the same (z_min, z_max) (a pixel whose logit lies at the threshold may
  flip, 1e-5 apart in f32, and its prompt carries into the next slice). The
  point modes run the JAX decoder on the unpadded prompt (``_next_pow2``
  patched to the identity), as the port decodes it;
- the automatic 3d segmentation and tracking decode the UNETR's maps and
  flood a watershed from their thresholds: objects matched by
  ``matched_share`` (IoU >= 0.99, >= 98 % of the objects), as
  tests/test_torch_automatic_segmentation.py does in 2d.
"""
import os
import sys

import numpy as np
import pytest

from tests.torch_port_util import (jax_params, matched_share, one_thread, port_sam, tiny_jax_config,
                                   unetr_jax_params)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: tier-1's six test processes share the
    machine's cores, and small tensors gain nothing from more (ROADMAP.md,
    Budgets)."""
    with one_thread():
        yield


SIZE = 128
Z = 6
TILE, HALO = (64, 64), (16, 16)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    from micro_sam_tpu.models.sam import Sam as JaxSam
    from micro_sam_tpu.predictor import SamPredictor as JaxPredictor
    from micro_sam_tpu_torch.predictor import SamPredictor
    cfg = tiny_jax_config(img_size=SIZE)
    params = jax_params(cfg)
    jp, pp = JaxPredictor(JaxSam(cfg, params)), SamPredictor(port_sam(cfg, params))
    jp.transform.apply_image = pp.transform.apply_image  # the same pixels into both encoders
    return jp, pp, {"decoder_state": unetr_jax_params(True)}


@pytest.fixture(scope="module")
def volume():
    """A (Z, 128, 128) volume of synthetic_data shifted by 2 rows a slice,
    and its truth."""
    from micro_sam_tpu_torch.sample_data import synthetic_data
    image, seg = synthetic_data(shape=(SIZE, SIZE), seed=11, n_objects=5)
    return (np.stack([np.roll(image, 2 * z, axis=0) for z in range(Z)]),
            np.stack([np.roll(seg, 2 * z, axis=0) for z in range(Z)]).astype(np.uint32))


@pytest.fixture(scope="module")
def embeddings(models, volume):
    from micro_sam_tpu_torch.util import precompute_image_embeddings
    return precompute_image_embeddings(models[1], volume[0], ndim=3, verbose=False,
                                       batch_size=2)


def _unique_per_slice(vol):
    """Each slice's ids made consecutive and lifted above the slices before."""
    out = np.zeros(vol.shape, np.uint32)
    offset = 0
    for z in range(len(vol)):
        ids, inv = np.unique(vol[z], return_inverse=True)
        lut = np.arange(len(ids), dtype=np.uint32) + (offset if ids[0] == 0 else offset + 1)
        if ids[0] == 0:
            lut[0] = 0
        out[z] = lut[inv.reshape(vol[z].shape)]
        offset = max(offset, int(out[z].max()))
    return out


def _slice_segmentation(seed=3, n_slices=7, size=96):
    """Per-slice segmentations of drifting objects with unique ids per slice:
    one object left out of an interior slice (a z-gap), another split in
    two on one slice, and a one-slice object."""
    from micro_sam_tpu_torch.sample_data import synthetic_data
    _, seg = synthetic_data(shape=(size, size), seed=seed, n_objects=6)
    vol = np.stack([np.roll(seg, 3 * z, axis=1) for z in range(n_slices)]).astype(np.uint32)
    ids = [int(i) for i in np.unique(seg) if i]
    vol[3][vol[3] == ids[0]] = 0
    part = vol[2] == ids[1]
    rows = np.nonzero(part)[0]
    vol[2][part & (np.arange(size)[:, None] > rows.mean())] = 1000
    vol[5][2:8, 2:8] = 1001
    return _unique_per_slice(vol)


def _tracking_sequence(seed=0):
    from micro_sam_tpu_torch.learned_tracking import hela_like_tracking_sequence
    return hela_like_tracking_sequence(n_frames=8, shape=(128, 128), n_cells=5,
                                       division_prob=0.3, seed=seed)


def _thresholds(segmenter, image, **init):
    """Watershed thresholds at quantiles of the random decoder's maps (the
    port's, on one slice), which cut them into tens of 3d objects."""
    segmenter.initialize(image, **init)
    st = segmenter.get_state()
    return dict(center_distance_threshold=float(np.quantile(st["center_distances"], 0.7)),
                boundary_distance_threshold=float(np.quantile(st["boundary_distances"], 0.5)),
                foreground_threshold=float(np.quantile(st["foreground"], 0.3)),
                distance_smoothing=1.0)


# ---------------------------------------------------------------------------
# the multicut
# ---------------------------------------------------------------------------

def _partition(labels):
    """Labels renumbered by first appearance: equal for equal partitions."""
    _, first, inv = np.unique(labels, return_index=True, return_inverse=True)
    rank = np.argsort(np.argsort(first))
    return rank[inv.reshape(-1)]


@pytest.mark.parametrize("n_nodes,n_edges,seed", [(50, 200, 0), (200, 1000, 1), (200, 1000, 2),
                                                  (400, 600, 3), (30, 60, 4)])
def test_greedy_multicut_matches_twin_and_jax(n_nodes, n_edges, seed):
    from micro_sam_tpu import native as jnative
    from micro_sam_tpu_torch import native
    rng = np.random.RandomState(seed)
    uv = rng.randint(0, n_nodes, size=(n_edges, 2))
    uv = uv[uv[:, 0] != uv[:, 1]]
    costs = rng.randn(len(uv)) + 0.3
    got = native.greedy_multicut(n_nodes, uv, costs)
    plain = native.greedy_multicut_plain(n_nodes, uv, costs)
    ref = np.asarray(jnative.greedy_multicut(n_nodes, uv, costs))
    assert got.dtype == np.int64 and got.shape == (n_nodes,)
    assert got.min() == 0 and set(np.unique(got)) == set(range(int(got.max()) + 1))
    assert 1 < got.max() + 1 < n_nodes
    np.testing.assert_array_equal(_partition(got), _partition(plain))
    np.testing.assert_array_equal(_partition(got), _partition(ref))
    # the smallest node numbers its cluster in both: the labels are equal too
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, ref)


def test_greedy_multicut_edge_cases():
    from micro_sam_tpu_torch import native
    # duplicate edges are summed: +1 and -2 between 0 and 1 keep them apart
    uv = np.array([[0, 1], [1, 0], [1, 2]])
    for fn in (native.greedy_multicut, native.greedy_multicut_plain):
        np.testing.assert_array_equal(fn(4, uv, np.array([1.0, -2.0, 0.5])), [0, 1, 1, 2])
        np.testing.assert_array_equal(fn(3, np.zeros((0, 2), np.int64), np.zeros(0)), [0, 1, 2])
        with pytest.raises(ValueError, match="outside"):
            fn(2, np.array([[0, 2]]), np.array([1.0]))


def test_greedy_multicut_has_no_silent_fallback(monkeypatch):
    """A failed build raises; nothing stands in for the library."""
    from micro_sam_tpu_torch import native
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "library_path", lambda: (_ for _ in ()).throw(
        RuntimeError("building postprocess.cpp failed")))
    with pytest.raises(RuntimeError, match="failed"):
        native.greedy_multicut(3, np.array([[0, 1]]), np.array([1.0]))


def test_compute_iou_matches_jax():
    from micro_sam_tpu import util as jutil
    from micro_sam_tpu_torch import util
    rng = np.random.RandomState(0)
    a, b = rng.rand(2, 40, 50) > 0.5
    assert util.compute_iou(a, b) == jutil.compute_iou(a, b)
    assert util.compute_iou(np.zeros((4, 4)), np.zeros((4, 4))) == 0.0


# ---------------------------------------------------------------------------
# the merge: edges, closing, multicut over them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 4])
def test_compute_edges_from_overlap_matches_jax(seed):
    from micro_sam_tpu import multi_dimensional_segmentation as jm
    from micro_sam_tpu_torch import multi_dimensional_segmentation as pm
    seg = _slice_segmentation(seed)
    got = pm.compute_edges_from_overlap(seg)
    assert got == jm.compute_edges_from_overlap(seg) and len(got) > 10


@pytest.mark.parametrize("gap_closing", [1, 2])
def test_preprocess_closing_matches_jax(gap_closing):
    from micro_sam_tpu import multi_dimensional_segmentation as jm
    from micro_sam_tpu_torch import multi_dimensional_segmentation as pm
    seg = _slice_segmentation()
    got = pm._preprocess_closing(seg, gap_closing, lambda n=1: None)
    ref = jm._preprocess_closing(seg, gap_closing, lambda n=1: None)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("with_background", [True, False], ids=["bg", "no_bg"])
@pytest.mark.parametrize("min_z_extent", [None, 3])
@pytest.mark.parametrize("gap_closing", [None, 1, 2])
def test_merge_instance_segmentation_3d_matches_jax(gap_closing, min_z_extent, with_background):
    from micro_sam_tpu import multi_dimensional_segmentation as jm
    from micro_sam_tpu_torch import multi_dimensional_segmentation as pm
    seg = _slice_segmentation()
    kw = dict(gap_closing=gap_closing, min_z_extent=min_z_extent,
              with_background=with_background, verbose=False)
    got = pm.merge_instance_segmentation_3d(seg.copy(), **kw)
    ref = jm.merge_instance_segmentation_3d(seg.copy(), **kw)
    assert got.dtype == np.uint32 and got.shape == seg.shape
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.max() < seg.max()


def test_merge_gives_each_truth_object_one_id(volume):
    """The truth slices, ids unique per slice, merge back into the 3d truth;
    with one slice of an object removed and gap_closing=1, it is filled."""
    from micro_sam_tpu_torch.multi_dimensional_segmentation import merge_instance_segmentation_3d
    truth = volume[1]
    merged = merge_instance_segmentation_3d(_unique_per_slice(truth), verbose=False)
    share, n = matched_share(merged, truth, iou_min=0.95)
    assert n >= 4 and share == 1.0
    gap = truth.copy()
    gap[2][gap[2] == 1] = 0
    closed = merge_instance_segmentation_3d(_unique_per_slice(gap), gap_closing=1, verbose=False)
    # the closing along z fills the pixels the object covers in both neighbours
    # (it moves 2 rows a slice), with the object's id
    obj = closed[1][truth[1] == 1]
    both = (truth[1] == 1) & (truth[3] == 1)
    assert len(np.unique(obj)) == 1 and obj[0] > 0 and (closed[3][truth[3] == 1] == obj[0]).all()
    assert (closed[2][both] == obj[0]).all() and both.sum() >= 0.8 * (truth[2] == 1).sum()


# ---------------------------------------------------------------------------
# projection through a volume
# ---------------------------------------------------------------------------

PROJECTIONS = ["box", "mask", "points", "points_and_mask", "single_point",
               {"use_box": True, "use_mask": False, "use_points": True}]
# (anchors, stop_lower, stop_upper, iou_threshold, the z range expected): an
# outward walk to both ends; the IoU stop (the random decoder's masks cover
# most of the slice, so the first step outward fails it); an even gap (two
# walks and the centre from both neighbours) with stop_lower; an odd gap with
# stop_upper; a gap of 2 (one slice seeded between its neighbours) and walks
# out to both ends
WALKS = {"outward": ([2], False, False, 0.0, (0, Z - 1)),
         "iou_stop": ([2], False, False, 0.5, (2, 2)),
         "even_gap": ([1, 5], True, False, 0.0, (1, 5)),
         "odd_gap": ([0, 3], False, True, 0.0, (0, 3)),
         "gap_2": ([1, 3], False, False, 0.0, (0, Z - 1))}


@pytest.mark.parametrize("walk", list(WALKS))
@pytest.mark.parametrize("projection", PROJECTIONS,
                         ids=[p if isinstance(p, str) else "flags" for p in PROJECTIONS])
def test_segment_mask_in_volume_matches_jax(models, volume, embeddings, monkeypatch,
                                            projection, walk):
    import micro_sam_tpu.predictor as jax_pred
    from micro_sam_tpu import multi_dimensional_segmentation as jm
    from micro_sam_tpu_torch import multi_dimensional_segmentation as pm
    jp, pp, _ = models
    monkeypatch.setattr(jax_pred, "_next_pow2", lambda n: n)
    anchors, stop_lower, stop_upper, iou, z_expected = WALKS[walk]
    runs = []
    for mod, predictor in ((pm, pp), (jm, jp)):
        seg = np.zeros(volume[0].shape, np.uint32)
        for a in anchors:
            seg[a] = volume[1][a] == 1
        notified = []
        out, z_range = mod.segment_mask_in_volume(
            seg, predictor, embeddings, np.array(anchors), stop_lower, stop_upper, iou,
            projection, update_progress=notified.append)
        runs.append((out, z_range, len(notified)))
    (got, gz, gn), (ref, rz, rn) = runs
    assert gz == rz and gn == rn and got.dtype == ref.dtype
    for z in range(Z):
        inter = np.logical_and(got[z], ref[z]).sum()
        union = np.logical_or(got[z], ref[z]).sum()
        assert union == 0 or inter / union >= 0.99, (z, inter, union)
    assert gz == z_expected
    written = [z for z in range(Z) if got[z].any()]
    assert written == list(range(min(anchors[0], gz[0]), max(anchors[-1], gz[1]) + 1))


def test_projection_validation():
    from micro_sam_tpu_torch.multi_dimensional_segmentation import _validate_projection
    assert _validate_projection("mask") == (True, True, False, False)
    assert _validate_projection({"use_box": 0, "use_mask": 1, "use_points": 1}) == (0, 1, 1, False)
    for bad in ("boxes", None, {"use_box": True}):
        with pytest.raises(ValueError):
            _validate_projection(bad)


# ---------------------------------------------------------------------------
# automatic 3d segmentation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tiled", [False, True], ids=["untiled", "tiled"])
def test_automatic_3d_segmentation_matches_jax(models, volume, tmp_path, tiled):
    from micro_sam_tpu import automatic_segmentation as jas
    from micro_sam_tpu import multi_dimensional_segmentation as jm
    from micro_sam_tpu_torch import automatic_segmentation as pas
    from micro_sam_tpu_torch import multi_dimensional_segmentation as pm
    jp, pp, state = models
    vol = volume[0][:4]
    tiling = dict(tile_shape=TILE, halo=HALO) if tiled else {}
    _, pseg = pas.get_predictor_and_segmenter("vit_b", predictor=pp, state=state, is_tiled=tiled)
    _, jseg = jas.get_predictor_and_segmenter("vit_b", predictor=jp, state=state, is_tiled=tiled)
    kw = _thresholds(pseg, vol[0], **tiling)
    emb_path = str(tmp_path / "emb.zarr")
    got, emb = pm.automatic_3d_segmentation(vol, pp, pseg, embedding_path=emb_path,
                                            gap_closing=1, min_z_extent=2, verbose=False,
                                            return_embeddings=True, batch_size=2, **tiling, **kw)
    # the JAX package reads the port's embedding cache: both decode one set of embeddings
    ref = jm.automatic_3d_segmentation(vol, jp, jseg, embedding_path=emb_path, gap_closing=1,
                                       min_z_extent=2, verbose=False, **tiling, **kw)
    assert got.shape == ref.shape == vol.shape and got.dtype == np.uint32
    share, n = matched_share(got, ref)
    assert n > 20 and share >= 0.98, (share, n)
    # tiled embeddings carry their sizes per tile
    assert emb["original_size"] == (None if tiled else vol.shape[1:])


def test_segment_slices_offsets(models, volume, monkeypatch):
    """Each slice's labels are lifted by the running maximum where they are
    nonzero; a slice without objects adds nothing."""
    from micro_sam_tpu_torch import multi_dimensional_segmentation as pm
    _, pp, _ = models
    slices = [np.array([[0, 1], [2, 2]]), np.zeros((2, 2), int), np.array([[3, 0], [1, 0]])]

    class Fixed:
        def initialize(self, image, image_embeddings=None, verbose=False, i=None):
            self.i = i

        def generate(self, **kw):
            return slices[self.i]
    monkeypatch.setattr(pm.util, "precompute_image_embeddings", lambda **kw: "emb")
    seg, emb = pm._segment_slices(np.zeros((3, 2, 2)), pp, Fixed(), None, False, None, None)
    assert seg.dtype == np.uint32 and emb == "emb"
    np.testing.assert_array_equal(seg, [[[0, 1], [2, 2]], [[0, 0], [0, 0]], [[5, 0], [3, 0]]])


def test_automatic_instance_segmentation_3d(models, volume, tmp_path):
    import imageio.v3 as imageio
    from micro_sam_tpu_torch import automatic_segmentation as pas
    _, pp, state = models
    vol = volume[0][:3]
    _, seg = pas.get_predictor_and_segmenter("vit_b", predictor=pp, state=state)
    kw = _thresholds(seg, vol[0])
    out_path = tmp_path / "vol.tif"
    got = pas.automatic_instance_segmentation(pp, seg, vol, output_path=str(out_path),
                                              ndim=3, verbose=False, **kw)
    assert got.shape == vol.shape and got.dtype == np.uint32 and got.max() > 0
    np.testing.assert_array_equal(imageio.imread(out_path), got)
    # a volume given as ndim=None is 3d by its shape
    again = pas.automatic_instance_segmentation(pp, seg, vol, verbose=False, **kw)
    np.testing.assert_array_equal(again, got)
    with pytest.raises(NotImplementedError, match="2d inputs only"):
        pas.automatic_instance_segmentation(pp, seg, vol, ndim=3, mask_path=np.ones(vol.shape),
                                            verbose=False)
    with pytest.raises(ValueError, match="shape expectation of 3d"):
        pas.automatic_instance_segmentation(pp, seg, vol[0], ndim=3, verbose=False)


# ---------------------------------------------------------------------------
# tracking
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_link_tracks_matches_jax(seed):
    from micro_sam_tpu import multi_dimensional_segmentation as jm
    from micro_sam_tpu_torch import multi_dimensional_segmentation as pm
    _, segs, _ = _tracking_sequence(seed)
    got = pm._greedy_link_tracks(segs)
    assert got == jm._greedy_link_tracks(segs)
    assert len(got[0]) > 20


def test_connected_components_in_networkx_order():
    """The lineage components come in networkx's order (the JAX package
    builds them with networkx, which the GPU machine does not have)."""
    import networkx as nx
    from micro_sam_tpu_torch.multi_dimensional_segmentation import _connected_components
    rng = np.random.RandomState(0)
    for n_edges in (1, 5, 30, 80):
        edges = [tuple(int(v) for v in e) for e in rng.randint(1, 60, size=(n_edges, 2))]
        g = nx.Graph()
        for u, v in edges:
            g.add_edge(u, v)
        got = _connected_components(edges)
        assert [set(c) for c in got] == list(nx.connected_components(g))


@pytest.mark.parametrize("min_time_extent", [None, 3])
@pytest.mark.parametrize("gap_closing", [None, 1])
def test_track_across_frames_greedy_matches_jax(gap_closing, min_time_extent):
    from micro_sam_tpu import multi_dimensional_segmentation as jm
    from micro_sam_tpu_torch import multi_dimensional_segmentation as pm
    images, segs, _ = _tracking_sequence(1)
    kw = dict(gap_closing=gap_closing, min_time_extent=min_time_extent, verbose=False)
    got, got_lin = pm.track_across_frames(images, segs.copy(), **kw)
    ref, ref_lin = jm.track_across_frames(images, segs.copy(), **kw)
    np.testing.assert_array_equal(got, ref)
    assert got_lin == ref_lin  # the list in its order, each dict in its order
    assert [list(d) for d in got_lin] == [list(d) for d in ref_lin]
    assert any(children for lin in got_lin for children in lin.values())


def test_get_napari_track_data_matches_jax():
    from micro_sam_tpu import multi_dimensional_segmentation as jm
    from micro_sam_tpu_torch import multi_dimensional_segmentation as pm
    images, segs, _ = _tracking_sequence(2)
    tracks, lineages = pm.track_across_frames(images, segs, verbose=False)
    got, got_parents = pm.get_napari_track_data(tracks, lineages, n_threads=2)
    ref, ref_parents = jm.get_napari_track_data(tracks, lineages, n_threads=2)
    np.testing.assert_array_equal(got, ref)
    assert got.shape[1] == 4 and got_parents == ref_parents and got_parents
    empty, _ = pm.get_napari_track_data(np.zeros((2, 8, 8), np.uint32), [], n_threads=1)
    assert empty.shape == (0, 4)


def test_export_ctc_matches_jax(tmp_path):
    import imageio.v3 as imageio
    from micro_sam_tpu import multi_dimensional_segmentation as jm
    from micro_sam_tpu_torch import multi_dimensional_segmentation as pm
    images, segs, _ = _tracking_sequence(0)
    tracks, lineages = pm.track_across_frames(images, segs, verbose=False)
    pm._export_ctc(tracks, lineages, str(tmp_path / "port"))
    jm._export_ctc(tracks, lineages, str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == len(tracks) + 1
    for name in names:
        if name.endswith(".tif"):
            np.testing.assert_array_equal(imageio.imread(tmp_path / "port" / name),
                                          imageio.imread(tmp_path / "jax" / name))
    assert (tmp_path / "port" / "res_track.txt").read_text() == \
        (tmp_path / "jax" / "res_track.txt").read_text()


def test_extract_tracks_and_lineages_matches_jax():
    """The Trackastra branch's conversion of napari tracks (Trackastra itself
    is not installed, so its model is not run)."""
    from micro_sam_tpu import multi_dimensional_segmentation as jm
    from micro_sam_tpu_torch import multi_dimensional_segmentation as pm
    images, segs, _ = _tracking_sequence(0)
    tracks, lineages = pm.track_across_frames(images, segs, verbose=False)
    data, parents = pm.get_napari_track_data(tracks, lineages, n_threads=1)
    parent_graph = {c: p[0] for c, p in parents.items()}
    got = pm._extract_tracks_and_lineages(segs, data, parent_graph)
    assert got == jm._extract_tracks_and_lineages(segs, data, parent_graph)


def test_automatic_tracking_matches_jax(models, volume, tmp_path):
    from micro_sam_tpu import automatic_segmentation as jas
    from micro_sam_tpu_torch import automatic_segmentation as pas
    jp, pp, state = models
    frames = volume[0][:4]
    _, pseg = pas.get_predictor_and_segmenter("vit_b", predictor=pp, state=state)
    _, jseg = jas.get_predictor_and_segmenter("vit_b", predictor=jp, state=state)
    kw = _thresholds(pseg, frames[0])
    emb_path = str(tmp_path / "emb.zarr")
    got, lineages, emb = pas.automatic_tracking(
        pp, pseg, frames, output_path=str(tmp_path / "ctc"), embedding_path=emb_path,
        verbose=False, return_embeddings=True, gap_closing=1, min_time_extent=2, **kw)
    ref, ref_lineages = jas.automatic_tracking(jp, jseg, frames, embedding_path=emb_path,
                                               verbose=False, gap_closing=1, min_time_extent=2,
                                               **kw)
    assert got.shape == frames.shape and got.dtype == ref.dtype
    share, n = matched_share(got, ref)
    assert n > 20 and share >= 0.98, (share, n)
    tracks = set(np.unique(got)) - {0}
    assert tracks == {t for lin in lineages for t in lin} and len(lineages) == len(ref_lineages)
    assert (tmp_path / "ctc" / "res_track.txt").exists() and emb["features"].shape[0] == 4
    with pytest.raises(ValueError, match="shape expectation of 3d"):
        pas.automatic_tracking(pp, pseg, frames[0], verbose=False)


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


def test_command_line_volume_and_tracking(models, volume, tmp_path, patched_model, monkeypatch):
    """The command line with -d cpu on a volume (-n 3) and with --tracking."""
    import imageio.v3 as imageio
    from micro_sam_tpu_torch import automatic_segmentation as pas
    _, pp, state = models
    frames = volume[0][:3]
    path = tmp_path / "vol.tif"
    imageio.imwrite(path, frames)
    _, seg = pas.get_predictor_and_segmenter("vit_b", predictor=pp, state=state)
    kw = []
    for k, v in _thresholds(seg, frames[0]).items():
        kw += [f"--{k}", str(v)]
    out = tmp_path / "seg.tif"
    monkeypatch.setattr(sys, "argv", ["micro_sam_tpu_torch.automatic_segmentation", "-i",
                                      str(path), "-o", str(out), "-d", "cpu", "-n", "3"] + kw)
    pas.main()
    got = imageio.imread(out)
    assert got.shape == frames.shape and got.max() > 0
    ctc = tmp_path / "tracks"
    monkeypatch.setattr(sys, "argv", ["micro_sam_tpu_torch.automatic_segmentation", "-i",
                                      str(path), "-o", str(ctc), "-d", "cpu", "--tracking",
                                      "--min_time_extent", "2"] + kw)
    pas.main()
    assert (ctc / "res_track.txt").exists() and (ctc / "mask002.tif").exists()
    assert patched_model == ["cpu", "cpu"]
