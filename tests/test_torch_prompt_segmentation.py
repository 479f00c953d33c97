"""The port's prompt layer (prompt_based_segmentation.py) against the JAX
package, untiled and tiled, on the tiny config over the same weights and the
same embeddings (f32, CPU).

Where both packages give the decoder the same tokens (one point and its pad
point, a box alone, a box with a mask, a mask alone) the JAX function is
compared as it is. Where the JAX predictor pads a prompt set to a power of
two (a box with one point: 3 tokens -> 4; derived points), the JAX side runs
with that bucket turned off (``_next_pow2`` patched to the identity), i.e.
the JAX decoder on the unpadded tokens the port gives its decoder.

Tolerances (those of test_torch_predictor.py::test_predict_matches_jax):
low-res logits rel <= 1e-4 of max|ref|, scores abs <= 1e-4; the binary
masks equal except pixels whose port logit lies within 1e-3 of the
threshold.
"""
import numpy as np
import pytest

from tests.torch_port_util import (abs_err, jax_params, one_thread, port_sam, rel_err,
                                   tiny_jax_config)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: tier-1's six test processes share the
    machine's cores, and small tensors gain nothing from more (ROADMAP.md,
    Budgets)."""
    with one_thread():
        yield


TILE, HALO = (128, 128), (32, 32)


@pytest.fixture(scope="module")
def predictors():
    from micro_sam_tpu.models.sam import Sam as JaxSam
    from micro_sam_tpu.predictor import SamPredictor as JaxPredictor
    from micro_sam_tpu_torch.predictor import SamPredictor
    cfg = tiny_jax_config()
    params = jax_params(cfg)
    return JaxPredictor(JaxSam(cfg, params)), SamPredictor(port_sam(cfg, params))


@pytest.fixture(scope="module")
def data(predictors):
    """image, segmentation, and the port's embeddings of the image, untiled
    and tiled (both packages get the same)."""
    from micro_sam_tpu_torch.sample_data import synthetic_data
    from micro_sam_tpu_torch.util import precompute_image_embeddings
    _, pp = predictors
    image, seg = synthetic_data(shape=(256, 320), seed=7)
    return {"image": image, "seg": seg,
            "untiled": precompute_image_embeddings(pp, image[:, :256], verbose=False),
            "tiled": precompute_image_embeddings(pp, image, tile_shape=TILE, halo=HALO,
                                                 verbose=False)}


class PortLogits:
    """The port's high-res mask logits of its last decode (every channel)."""

    def __init__(self, monkeypatch):
        import micro_sam_tpu_torch.predictor as pred
        post, self.last = pred.postprocess_masks, None

        def record(masks, *a, **k):
            self.last = post(masks, *a, **k)
            return self.last
        monkeypatch.setattr(pred, "postprocess_masks", record)

    def near(self, tile=None, shape=None):
        near = (self.last.abs() < 1e-3).any(dim=1)[0].numpy()
        if tile is None:
            return near
        full = np.zeros(shape, bool)
        full[tile.slicing] = near
        return full


def _object(seg, tiled):
    """An object of the segmentation inside tile 1's inner block (tiled) or
    in the left 256 columns, away from the edges."""
    ids, counts = np.unique(seg, return_counts=True)
    for i in ids[np.argsort(-counts)]:
        if i == 0:
            continue
        ys, xs = np.nonzero(seg == i)
        y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
        ok = (140 <= x0 and x1 <= 250 and 5 <= y0 and y1 <= 123) if tiled else \
            (5 <= x0 and x1 <= 250 and 5 <= y0 and y1 <= 250)
        if ok:
            return seg == i, np.array([y0, x0, y1, x1]), np.array([[(y0 + y1) // 2, (x0 + x1) // 2]])
    raise AssertionError("no object fits")


def _case(name, mask, box, center):
    """(function name, kwargs, needs the unpadded JAX decoder)."""
    neg = center + np.array([[0, (box[3] - box[1]) // 2 + 6]])
    return {
        "1 point": ("segment_from_points",
                    dict(points=center, labels=np.array([1])), False),
        "2 points": ("segment_from_points",
                     dict(points=np.concatenate([center, neg]), labels=np.array([1, 0]),
                          multimask_output=False), True),
        "box": ("segment_from_box", dict(box=box), False),
        "box, multimask": ("segment_from_box", dict(box=box, multimask_output=True), False),
        "mask: box + logits": ("segment_from_mask", dict(mask=mask), False),
        "mask: logits only": ("segment_from_mask", dict(mask=mask, use_box=False), False),
        "mask: points + box + logits": ("segment_from_mask",
                                        dict(mask=mask, use_points=True), True),
        "box + 1 point": ("segment_from_box_and_points",
                          dict(box=box, points=center, labels=np.array([1])), True),
    }[name]


CASES = ("1 point", "2 points", "box", "box, multimask", "mask: box + logits",
         "mask: logits only", "mask: points + box + logits", "box + 1 point")


@pytest.mark.parametrize("tiled", [False, True], ids=["untiled", "tiled"])
@pytest.mark.parametrize("name", CASES)
def test_segment_from_matches_jax(predictors, data, monkeypatch, name, tiled):
    import micro_sam_tpu.predictor as jax_pred
    from micro_sam_tpu import prompt_based_segmentation as jseg
    from micro_sam_tpu_torch import prompt_based_segmentation as pseg
    jp, pp = predictors
    seg = data["seg"] if tiled else data["seg"][:, :256]
    mask, box, center = _object(seg, tiled)
    fn, kw, unpadded = _case(name, mask, box, center)
    emb = data["tiled" if tiled else "untiled"]
    logits = PortLogits(monkeypatch)
    got = getattr(pseg, fn)(pp, image_embeddings=emb, return_all=True, **kw)
    if unpadded:
        monkeypatch.setattr(jax_pred, "_next_pow2", lambda n: n)
    ref = getattr(jseg, fn)(jp, image_embeddings=emb, return_all=True, **kw)
    (gm, gs, gl), (rm, rs, rl) = got, (np.asarray(a) for a in ref)
    assert gm.shape == rm.shape and gm.shape[-2:] == seg.shape and gm.dtype == rm.dtype
    assert rel_err(gl, rl) <= 1e-4 and abs_err(gs, rs) <= 1e-4
    tile = None
    if tiled:
        from micro_sam_tpu_torch.prompt_based_segmentation import _tile_at
        tile = _tile_at(seg.shape, TILE, HALO, center[0])[1]
    near = logits.near(tile, seg.shape)
    differ = (gm != rm).any(axis=0)
    assert not (differ & ~near).any()
    assert gm.any()


def test_tiled_prompts_route_to_their_tile(predictors, data):
    """A tiled prompt is decoded in the tile that holds it: the mask is zero
    outside that tile's halo block."""
    from micro_sam_tpu_torch.prompt_based_segmentation import _tile_at, segment_from_box
    _, pp = predictors
    mask, box, center = _object(data["seg"], True)
    got = segment_from_box(pp, box, image_embeddings=data["tiled"])
    tile_id, tile = _tile_at(data["seg"].shape, TILE, HALO, (box[:2] + box[2:]) / 2)
    assert tile_id == 1 and pp.original_size == tuple(tile.shape)
    outside = np.ones(data["seg"].shape, bool)
    outside[tile.slicing] = False
    assert not got[0][outside].any()


@pytest.mark.parametrize("extension", [0, 3, 0.25])
def test_prompt_derivation_matches_jax(data, extension):
    from micro_sam_tpu import prompt_based_segmentation as jseg
    from micro_sam_tpu_torch import prompt_based_segmentation as pseg
    mask, box, _ = _object(data["seg"][:, :256], False)
    np.testing.assert_array_equal(pseg._compute_box_from_mask(mask, box_extension=extension),
                                  jseg._compute_box_from_mask(mask, box_extension=extension))
    np.testing.assert_array_equal(pseg._process_box(box, mask.shape, (512, 512), extension),
                                  jseg._process_box(box, mask.shape, (512, 512), extension))
    for single in (False, True):
        g = pseg._compute_points_from_mask(mask, None, extension, use_single_point=single)
        r = jseg._compute_points_from_mask(mask, None, extension, use_single_point=single)
        np.testing.assert_array_equal(g[0], r[0])
        np.testing.assert_array_equal(g[1], r[1])
    for shape in ((256, 256), (300, 200), (100, 160)):
        m = np.zeros(shape, bool)
        m[shape[0] // 4: shape[0] // 2, shape[1] // 3: shape[1] // 2] = True
        g, r = pseg._compute_logits_from_mask(m), jseg._compute_logits_from_mask(m)
        assert g.shape == r.shape == (1, 256, 256)
        assert rel_err(g, r) <= 1e-5
