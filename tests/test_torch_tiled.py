"""The port's tiled precompute (2d and 3d), tiled caches and tiled prompts
against the JAX package, on the tiny config over the same weights (f32, CPU).

Tolerances: per tile features rel <= 1e-4 of max|ref|, sizes equal; mask
logits rel <= 1e-4, IoU abs <= 1e-4 (as tests/test_torch_predictor.py);
cache reads exact. Tiles are resized to the encoder's input size by the
port's own resize, which equals the JAX package's PIL resize to the bit
(tests/test_torch_resize.py).
"""
import os
import shutil

import numpy as np
import pytest

from tests.make_zarr_fixture import feature_pattern, fixture_input
from tests.torch_port_util import (abs_err, jax_params, one_thread, port_sam, rel_err,
                                   tiny_jax_config)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: tier-1's six test processes share the
    machine's cores, and small tensors gain nothing from more (ROADMAP.md,
    Budgets)."""
    with one_thread():
        yield


FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TILE, HALO = (96, 96), (16, 16)  # 160 x 320: 2 x 4 tiles, tiles 1, 2 and 5, 6 of one shape


@pytest.fixture(scope="module")
def predictors():
    from micro_sam_tpu.models.sam import Sam as JaxSam
    from micro_sam_tpu.predictor import SamPredictor as JaxPredictor
    from micro_sam_tpu_torch.predictor import SamPredictor
    cfg = tiny_jax_config()
    params = jax_params(cfg)
    return JaxPredictor(JaxSam(cfg, params)), SamPredictor(port_sam(cfg, params))


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(30).randint(0, 256, size=(160, 320)).astype(np.uint8)


@pytest.fixture(scope="module")
def volume():
    return np.random.RandomState(31).randint(0, 256, size=(3, 120, 100)).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_tiles(predictors, image, volume):
    """The JAX package's tiled embeddings of ``image`` and ``volume``."""
    from micro_sam_tpu.util import precompute_image_embeddings as jax_pre
    jp, _ = predictors
    return {2: jax_pre(jp, image, tile_shape=TILE, halo=HALO, batch_size=2, verbose=False),
            3: jax_pre(jp, volume, tile_shape=(64, 64), halo=(8, 8), batch_size=2,
                       verbose=False)}


def _assert_tiles_match(got, ref, exact=False):
    assert sorted(got) == sorted(ref)
    for t in ref:
        g, r = got[t], ref[t]
        assert tuple(g["input_size"]) == tuple(r["input_size"])
        assert tuple(g["original_size"]) == tuple(r["original_size"])
        if exact:
            np.testing.assert_array_equal(np.asarray(g["features"]), np.asarray(r["features"]))
        else:
            assert rel_err(g["features"], r["features"]) <= 1e-4


def _counting(predictor, monkeypatch):
    """Count the images the predictor encodes."""
    seen = []
    encode = predictor.encode_batch
    monkeypatch.setattr(predictor, "encode_batch", lambda b: seen.append(len(b)) or encode(b))
    return seen


def _no_encode(predictor, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("cache hit expected: the encoder must not run")
    monkeypatch.setattr(predictor, "encode_batch", boom)


@pytest.mark.parametrize("ndim", [2, 3])
def test_tiled_precompute_matches_jax(predictors, image, volume, jax_tiles, monkeypatch, ndim):
    """Tiled 2d (8 tiles, consecutive same-shape tiles batched 2 at a time)
    and tiled 3d (4 tiles x 3 slices, batched 2 slices at a time) against the
    JAX package, tile by tile."""
    from micro_sam_tpu_torch.util import precompute_image_embeddings
    _, pp = predictors
    seen = _counting(pp, monkeypatch)
    if ndim == 2:
        got = precompute_image_embeddings(pp, image, tile_shape=TILE, halo=HALO, batch_size=2,
                                          verbose=False)
        assert got["shape"] == (160, 320) and seen == [1, 2, 1, 1, 2, 1]
    else:
        got = precompute_image_embeddings(pp, volume, tile_shape=(64, 64), halo=(8, 8),
                                          batch_size=2, verbose=False)
        assert got["shape"] == (3, 120, 100) and seen == [2, 1] * 4
        assert got["features"][0]["features"].shape == (3, 1, 256, 16, 16)
    ref = jax_tiles[ndim]
    assert (got["tile_shape"], got["halo"]) == (tuple(ref["tile_shape"]), tuple(ref["halo"]))
    assert got["input_size"] is None and got["original_size"] is None
    _assert_tiles_match(got["features"], ref["features"])


def test_tiled_precompute_restricted_to_a_mask(predictors, image):
    from micro_sam_tpu.util import precompute_image_embeddings as jax_pre
    from micro_sam_tpu_torch.util import precompute_image_embeddings
    jp, pp = predictors
    mask = np.zeros(image.shape, bool)
    mask[10:20, 10:20] = True     # tile 0
    mask[150:158, 310:318] = True  # tile 7 (the bottom-right corner)
    ref = jax_pre(jp, image, tile_shape=TILE, halo=HALO, mask=mask, verbose=False)
    got = precompute_image_embeddings(pp, image, tile_shape=TILE, halo=HALO, mask=mask,
                                      verbose=False)
    assert sorted(got["features"]) == [0, 7]
    _assert_tiles_match(got["features"], ref["features"])


def test_tile_subset_resumes_without_reencoding(predictors, image, jax_tiles, tmp_path,
                                                monkeypatch):
    """A first call restricted to tiles 1 and 3, not finalized, then the full
    call on the same cache: tiles 1 and 3 are taken from the cache and the
    other six encoded; the result is the whole tiled embedding."""
    from micro_sam_tpu_torch.util import precompute_image_embeddings
    _, pp = predictors
    path = str(tmp_path / "tiles.zarr")
    seen = _counting(pp, monkeypatch)
    part = precompute_image_embeddings(pp, image, save_path=path, tile_shape=TILE, halo=HALO,
                                       tile_subset=[1, 3], finalize=False, verbose=False)
    assert sorted(part["features"]) == [1, 3] and sum(seen) == 2
    seen.clear()
    full = precompute_image_embeddings(pp, image, save_path=path, tile_shape=TILE, halo=HALO,
                                       verbose=False)
    assert sum(seen) == 6
    _assert_tiles_match(full["features"], jax_tiles[2]["features"])
    for t in (1, 3):
        np.testing.assert_array_equal(full["features"][t]["features"],
                                      part["features"][t]["features"])
    with pytest.raises(ValueError, match="tile_subset"):
        precompute_image_embeddings(pp, image, tile_subset=[0], verbose=False)


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_tiled_cache_written_by_jax_loads_in_port(predictors, image, volume, tmp_path,
                                                  monkeypatch, ndim, lazy):
    from micro_sam_tpu.util import precompute_image_embeddings as jax_pre
    from micro_sam_tpu_torch.util import _get_tile_features, precompute_image_embeddings
    jp, pp = predictors
    data, tile, halo = (image, TILE, HALO) if ndim == 2 else (volume, (64, 64), (8, 8))
    path = str(tmp_path / "jax.zarr")
    ref = jax_pre(jp, data, save_path=path, tile_shape=tile, halo=halo, verbose=False)
    _no_encode(pp, monkeypatch)
    got = precompute_image_embeddings(pp, data, save_path=path, tile_shape=tile, halo=halo,
                                      lazy_loading=lazy, verbose=False)
    assert got["shape"] == tuple(data.shape) and got["tile_shape"] == tile
    tiles = {int(t): _get_tile_features(got, t) for t in ref["features"]}
    _assert_tiles_match(tiles, ref["features"], exact=True)


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_tiled_cache_written_by_port_loads_in_jax(predictors, image, volume, tmp_path,
                                                  monkeypatch, ndim, lazy):
    from micro_sam_tpu import util as jax_util
    from micro_sam_tpu_torch.util import precompute_image_embeddings
    jp, pp = predictors
    data, tile, halo = (image, TILE, HALO) if ndim == 2 else (volume, (64, 64), (8, 8))
    path = str(tmp_path / "torch.zarr")
    ref = precompute_image_embeddings(pp, data, save_path=path, tile_shape=tile, halo=halo,
                                      batch_size=2, verbose=False)
    monkeypatch.setattr(jax_util, "_encode_batch",
                        lambda *a, **k: (_ for _ in ()).throw(AssertionError("cache miss")))
    got = jax_util.precompute_image_embeddings(jp, data, save_path=path, tile_shape=tile,
                                               halo=halo, lazy_loading=lazy, verbose=False)
    tiles = {int(t): jax_util._get_tile_features(got, t) for t in ref["features"]}
    _assert_tiles_match(tiles, ref["features"], exact=True)


def test_tiled_cache_guards_tile_shape_and_halo(predictors, image, tmp_path):
    """``tile_shape`` and ``halo`` are hard keys of the cache signature."""
    from micro_sam_tpu_torch.util import precompute_image_embeddings
    _, pp = predictors
    path = str(tmp_path / "tiles.zarr")
    precompute_image_embeddings(pp, image, save_path=path, tile_shape=TILE, halo=HALO,
                                verbose=False)
    with pytest.raises(RuntimeError, match="halo"):
        precompute_image_embeddings(pp, image, save_path=path, tile_shape=TILE, halo=(8, 8),
                                    verbose=False)


def test_reference_tiled_cache_fixture_loads(predictors, tmp_path, monkeypatch):
    """A tiled cache in the upstream layout (tests/make_zarr_fixture.py)."""
    from micro_sam_tpu_torch.util import precompute_image_embeddings
    _, pp = predictors
    cache = tmp_path / "cache.zarr"
    shutil.copytree(os.path.join(FIXTURES, "zarr_ref_cache_tiled"), cache)
    _no_encode(pp, monkeypatch)
    emb = precompute_image_embeddings(pp, fixture_input((96, 112)), save_path=str(cache),
                                      tile_shape=(64, 64), halo=(8, 8), verbose=False)
    assert emb["tile_shape"] == (64, 64) and emb["halo"] == (8, 8)
    assert sorted(emb["features"]) == [0, 1, 2, 3]
    np.testing.assert_array_equal(emb["features"][2]["features"],
                                  feature_pattern((1, 256, 64, 64)) + 2)
    assert tuple(emb["features"][2]["input_size"]) == (1024, 1024)


@pytest.mark.parametrize("ndim,tile_id,z", [(2, 0, None), (2, 5, None), (3, 3, 1)],
                         ids=["2d_tile0", "2d_tile5", "3d_tile3_slice1"])
def test_tiled_prompt_matches_jax(predictors, image, volume, jax_tiles, ndim, tile_id, z):
    """``set_precomputed(..., tile_id=...)`` (and ``i`` for a volume) then one
    point: the port's tile embedding and prediction against the JAX
    package's (a point and its pad token: no power-of-two padding)."""
    from micro_sam_tpu.util import set_precomputed as jax_set
    from micro_sam_tpu_torch.util import precompute_image_embeddings, set_precomputed
    jp, pp = predictors
    data, tile, halo = (image, TILE, HALO) if ndim == 2 else (volume, (64, 64), (8, 8))
    emb = precompute_image_embeddings(pp, data, tile_shape=tile, halo=halo, verbose=False)
    jax_set(jp, jax_tiles[ndim], i=z, tile_id=tile_id)
    set_precomputed(pp, emb, i=z, tile_id=tile_id)
    assert pp.original_size == tuple(jp.original_size)
    assert pp.input_size == tuple(jp.input_size)
    assert rel_err(pp.get_image_embedding(), np.asarray(jp.get_image_embedding())) <= 1e-4
    h, w = pp.original_size
    kw = dict(point_coords=np.array([[w * 0.4, h * 0.6]]), point_labels=np.array([1]),
              return_logits=True)
    pm, pi, pl = pp.predict(**kw)
    jm, ji, jl = jp.predict(**kw)
    assert pm.shape == jm.shape and pm.shape[-2:] == (h, w)
    assert rel_err(pm, jm) <= 1e-4 and rel_err(pl, jl) <= 1e-4 and abs_err(pi, ji) <= 1e-4


def test_untiled_embeddings_refuse_a_tile_id_less_set(predictors, image):
    from micro_sam_tpu_torch.util import precompute_image_embeddings, set_precomputed
    _, pp = predictors
    emb = precompute_image_embeddings(pp, image, tile_shape=TILE, halo=HALO, verbose=False)
    with pytest.raises(ValueError, match="tile_id"):
        set_precomputed(pp, emb)
