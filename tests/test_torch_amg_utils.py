"""The port's AMG utilities (ops/amg_utils.py), its native postprocessing
library (native/) and the vendored helpers against the JAX package, case by
case on numpy inputs from fixed seeds, and each native wrapper against its
numpy twin.

Tolerances: stability score and box IoU 1e-6; everything else equal.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_sam_tpu.ops import amg_utils as ja
from micro_sam_tpu_torch import native
from micro_sam_tpu_torch.ops import amg_utils as pa


def _logits(seed, shape=(3, 2, 40, 56)):
    return (np.random.RandomState(seed).randn(*shape) * 3).astype(np.float32)


def _masks(seed, n=6, h=40, w=56, p=0.5):
    rng = np.random.RandomState(seed)
    m = rng.rand(n, h, w) < p
    m[0] = False                        # an empty mask
    m[1, :, :] = False
    m[1, 5:17, 9:30] = True             # a rectangle
    return m


def _blobs(seed, n=5, h=50, w=60):
    """Masks of a few disks each, with holes: room for islands and holes."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    out = np.zeros((n, h, w), bool)
    for k in range(n):
        for _ in range(rng.randint(1, 4)):
            cy, cx, r = rng.randint(0, h), rng.randint(0, w), rng.randint(1, 12)
            out[k] |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        for _ in range(rng.randint(0, 3)):
            out[k, rng.randint(0, h), rng.randint(0, w)] = False
    return out


def _boxes(seed, n=20):
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2) * 80
    wh = rng.rand(n, 2) * 40 + 1
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


@pytest.mark.parametrize("threshold,offset", [(0.0, 1.0), (0.5, 0.25), (-1.0, 2.0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_stability_score_matches_jax(seed, threshold, offset):
    x = _logits(seed)
    ref = np.asarray(ja.calculate_stability_score(jnp.asarray(x), threshold, offset))
    got = pa.calculate_stability_score(torch.from_numpy(x), threshold, offset).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_to_box_matches_jax(seed):
    m = _masks(seed, p=0.02 * (seed + 1))
    ref = np.asarray(ja.batched_mask_to_box(jnp.asarray(m)))
    got = pa.batched_mask_to_box(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_box_iou_matches_jax(seed):
    b1, b2 = _boxes(seed), _boxes(seed + 10, 7)
    ref = np.asarray(ja.box_iou(jnp.asarray(b1), jnp.asarray(b2)))
    got = pa.box_iou(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("categories", [False, True], ids=["plain", "categories"])
@pytest.mark.parametrize("threshold", [0.3, 0.7])
@pytest.mark.parametrize("seed", [0, 1])
def test_batched_nms_matches_jax(seed, threshold, categories):
    boxes = _boxes(seed, 40)
    scores = np.random.RandomState(seed + 5).rand(40)
    scores[3] = scores[7]  # a tie: index order decides
    cats = np.random.RandomState(seed + 6).randint(0, 3, 40) if categories else None
    ref = ja.batched_nms(boxes, scores, cats, iou_threshold=threshold)
    got = pa.batched_nms(boxes, scores, cats, iou_threshold=threshold)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n,layers,scale", [(4, 0, 1), (8, 2, 2), (32, 1, 1), (12, 2, 3)])
def test_point_grids_match_jax(n, layers, scale):
    ref = ja.build_all_layer_point_grids(n, layers, scale)
    got = pa.build_all_layer_point_grids(n, layers, scale)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("size,layers,ratio", [((256, 256), 1, 512 / 1500),
                                               ((300, 420), 2, 0.25), ((1024, 768), 0, 0.3)])
def test_crop_boxes_and_uncrop_match_jax(size, layers, ratio):
    ref = ja.generate_crop_boxes(size, layers, ratio)
    got = pa.generate_crop_boxes(size, layers, ratio)
    assert got == ref
    boxes = _boxes(3, 10).astype(np.int32)
    pts = np.random.RandomState(4).rand(10, 2) * 100
    masks = _masks(5, n=2, h=size[0] // 4, w=size[1] // 4)
    orig_box = [0, 0, size[1], size[0]]
    for cb in got[0]:
        np.testing.assert_array_equal(pa.uncrop_boxes_xyxy(boxes, cb),
                                      ja.uncrop_boxes_xyxy(boxes, cb))
        np.testing.assert_array_equal(pa.uncrop_points(pts, cb), ja.uncrop_points(pts, cb))
        np.testing.assert_array_equal(pa.is_box_near_crop_edge(boxes, cb, orig_box),
                                      ja.is_box_near_crop_edge(boxes, cb, orig_box))
        small = [cb[0] // 4, cb[1] // 4, cb[0] // 4 + masks.shape[2], cb[1] // 4 + masks.shape[1]]
        h4, w4 = small[3] + 3, small[2] + 5
        np.testing.assert_array_equal(pa.uncrop_masks(masks, small, h4, w4),
                                      ja.uncrop_masks(masks, small, h4, w4))
    np.testing.assert_array_equal(pa.box_xyxy_to_xywh(boxes), ja.box_xyxy_to_xywh(boxes))
    assert [b[0].tolist() for b in pa.batch_iterator(3, pts)] == \
        [b[0].tolist() for b in ja.batch_iterator(3, pts)]


def _counts(rle):
    return [int(c) for c in rle["counts"]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle_round_trips_match_jax(seed):
    masks = _masks(seed, p=0.3)
    masks[2, 0, 0] = True  # a mask starting with a foreground run
    for m in masks:
        ref, got = ja.mask_to_rle(m), pa.mask_to_rle(m)
        assert got == ref
        np.testing.assert_array_equal(pa.rle_to_mask(got), m)
        np.testing.assert_array_equal(pa.rle_to_mask(got), ja.rle_to_mask(ref))
        assert pa.area_from_rle(got) == ja.area_from_rle(ref) == int(m.sum())
        assert pa.coco_encode_rle(got) == ja.coco_encode_rle(ref)
    batched = pa.batched_mask_to_rle(masks)
    assert [_counts(r) for r in batched] == [_counts(ja.mask_to_rle(m)) for m in masks]


@pytest.mark.parametrize("mode", ["holes", "islands"])
@pytest.mark.parametrize("seed", [0, 1])
def test_remove_small_regions_matches_jax(seed, mode):
    for m in _blobs(seed):
        for thresh in (5, 40, 400):
            got, gc = pa.remove_small_regions(m, thresh, mode)
            ref, rc = ja.remove_small_regions(m, thresh, mode)
            assert gc == rc
            np.testing.assert_array_equal(got, ref)


def test_mask_data_filter_and_cat():
    d = pa.MaskData(a=np.arange(5), b=[10, 11, 12, 13, 14], c=torch.arange(5))
    d.filter(np.array([True, False, True, True, False]))
    assert d["a"].tolist() == [0, 2, 3] and d["b"] == [10, 12, 13] and d["c"].tolist() == [0, 2, 3]
    d.filter(np.array([2, 0]))
    assert d["a"].tolist() == [3, 0] and d["b"] == [13, 10]
    d.cat(pa.MaskData(a=np.array([7]), b=[17], c=np.array([7])))
    assert d["a"].tolist() == [3, 0, 7] and d["b"] == [13, 10, 17] and len(d) == 3


# ---------------------------------------------------------------------------
# native
# ---------------------------------------------------------------------------

def test_native_builds_into_build_dir():
    path = native.library_path()
    assert path.startswith(native.build_dir()) and os.sep + "build" + os.sep in path
    assert os.path.exists(path)
    assert not any(f.endswith(".so") for f in os.listdir(os.path.dirname(native.SOURCE)))


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No numpy version stands in: a source that does not compile raises."""
    bad = tmp_path / "postprocess.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "_HERE", str(tmp_path / "pkg" / "native"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed"):
        native.library()


def test_native_concurrent_builds_are_atomic(monkeypatch, tmp_path):
    """Several threads building at once: each loads a whole library."""
    import threading
    monkeypatch.setattr(native, "_HERE", str(tmp_path / "pkg" / "native"))
    paths, errors = [], []

    def build():
        try:
            paths.append(native.library_path())
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)
    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1
    import ctypes
    ctypes.CDLL(paths[0]).rle_encode_packed  # loads, and has its symbols
    leftovers = [f for f in os.listdir(os.path.dirname(paths[0])) if f.endswith(".tmp")]
    assert not leftovers


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_label_matches_plain_and_jax(seed):
    from micro_sam_tpu import native as jn
    rng = np.random.RandomState(seed)
    seg = rng.randint(0, 5, (70, 90)).astype(np.uint32)
    seg[10:40, 20:60] = 7  # a large region
    got = native.label(seg)
    np.testing.assert_array_equal(got, native.label_plain(seg))
    if jn.has_native():
        np.testing.assert_array_equal(got, jn.label(seg))
    vol = rng.randint(0, 3, (4, 20, 25))
    lab3 = native.label(vol)
    np.testing.assert_array_equal(lab3, native.label_plain(vol))
    assert lab3.max() > 1 and (lab3 == 0).sum() == (vol == 0).sum()


def test_unique_isin_relabel_match_jax():
    from micro_sam_tpu import native as jn
    seg = np.random.RandomState(3).choice([0, 3, 9, 40], size=(30, 40)).astype(np.uint32)
    for rc in (False, True):
        got, ref = native.unique(seg, return_counts=rc), jn.unique(seg, return_counts=rc)
        for g, r in zip(got if rc else [got], ref if rc else [ref]):
            np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(native.isin(seg, [3, 40]), jn.isin(seg, [3, 40]))
    g, r = native.relabel_consecutive(seg), jn.relabel_consecutive(seg)
    np.testing.assert_array_equal(g[0], r[0])
    assert g[1:] == r[1:]


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_rle_batch_matches_plain(seed):
    masks = _masks(seed, p=0.4)
    got = native.compute_rle_batch(masks)
    ref = native.compute_rle_batch_plain(masks)
    assert [_counts(g) for g in got] == [_counts(r) for r in ref]
    assert [g["size"] for g in got] == [r["size"] for r in ref]


@pytest.mark.parametrize("h", [256, 250, 7])
def test_rle_from_packed_matches_mask_to_rle(h):
    w = 33 if h == 7 else 180
    masks = _masks(h, n=5, h=h, w=w, p=0.2)
    packed = np.packbits(masks.transpose(0, 2, 1), axis=-1)  # (N, W, ceil(H/8))
    expect = [_counts(pa.mask_to_rle(m)) for m in masks]
    got = native.rle_from_packed(packed, h, w)
    assert [_counts(g) for g in got] == expect
    assert [_counts(g) for g in native.rle_from_packed_plain(packed, h, w)] == expect
    assert all(g["size"] == [h, w] for g in got)


@pytest.mark.parametrize("crop", [(64, 48), (61, 45), (250, 180)])
def test_rle_from_packed_cropped_matches_pasted_frame(crop):
    H, W = 250, 180
    ch, cw = crop
    masks = _masks(sum(crop), n=4, h=ch, w=cw, p=0.3)
    masks[3, -1, -1] = True  # a window ending in foreground
    rng = np.random.RandomState(1)
    origins = np.stack([rng.randint(0, W - cw + 1, 4), rng.randint(0, H - ch + 1, 4)], 1)
    origins[0] = (W - cw, H - ch)  # flush with the frame's far corner
    packed = np.packbits(masks.transpose(0, 2, 1), axis=-1)
    expect = []
    for (x0, y0), m in zip(origins, masks):
        full = np.zeros((H, W), bool)
        full[y0:y0 + ch, x0:x0 + cw] = m
        expect.append(_counts(pa.mask_to_rle(full)))
    got = native.rle_from_packed_cropped(packed, origins, crop, H, W)
    assert [_counts(g) for g in got] == expect
    plain = native.rle_from_packed_cropped_plain(packed, origins, crop, H, W)
    assert [_counts(g) for g in plain] == expect


def test_vendored_shims_match_jax():
    from micro_sam_tpu import _vendored as jv
    from micro_sam_tpu_torch import _vendored as pv
    masks = _masks(9, p=0.1)
    np.testing.assert_array_equal(pv.batched_mask_to_box(masks), jv.batched_mask_to_box(masks))
    np.testing.assert_array_equal(pv.batched_mask_to_box(torch.from_numpy(masks)),
                                  jv.batched_mask_to_box(masks))
    for impl in ("default", "numpy"):
        got = pv.mask_to_rle_pytorch(torch.from_numpy(masks), impl)
        assert [_counts(g) for g in got] == [_counts(r) for r in
                                             jv.mask_to_rle_pytorch(masks, impl)]
    assert [_counts(g) for g in pv.mask_to_rle_numpy(masks[2])] == \
        [_counts(r) for r in jv.mask_to_rle_numpy(masks[2])]



def test_native_rejects_malformed_buffers():
    """Sizes are checked before a pointer reaches the library."""
    packed = np.zeros((2, 10, 4), np.uint8)  # 2 masks, 10 columns, 32 rows
    with pytest.raises(ValueError, match="columns"):
        native.rle_from_packed(packed, 40, 10)
    with pytest.raises(ValueError, match="windows"):
        native.rle_from_packed_cropped(packed, np.zeros((3, 2)), (32, 10), 64, 64)
    with pytest.raises(ValueError, match="leaves"):
        native.rle_from_packed_cropped(packed, np.array([[0, 0], [60, 0]]), (32, 10), 64, 64)
    assert len(native.rle_from_packed_cropped(packed, np.array([[0, 0], [54, 32]]), (32, 10),
                                              64, 64)) == 2
