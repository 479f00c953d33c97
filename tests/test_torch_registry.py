"""The port's model registry and zoo cache, its device helper, the one-hot
helper, lazy image loading, the sample-data fetchers and hooks, and the info
command, against the JAX package on the CPU.

The zoo cache: with no ``checkpoint_path``, both packages load a file seeded
under ``<MICROSAM_CACHEDIR>/models/<model_type>`` once its xxh128 hash
matches the registry's, and write the registry's ``xxh128:...`` string into
the embedding cache's signature; the embeddings agree within the f32 bound
of tests/test_torch_encoder.py (rel 1e-4 of max). The seeded file is a
trainer checkpoint of the tiny config (a zoo ``.pt`` of full vit_b is too
large for the CPU tests), so the registry's hash for it is patched to the
file's own in both packages.
"""
import dataclasses
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from tests.torch_port_util import jax_params, rel_err, tiny_jax_config

MODEL = "vit_b"


def _xxh128(path):
    import xxhash
    with open(path, "rb") as f:
        return xxhash.xxh128(f.read()).hexdigest()


@pytest.fixture
def zoo(tmp_path, monkeypatch):
    """A tiny trainer checkpoint seeded as <cachedir>/models/vit_b, the
    registry's hash of vit_b set to its own in both packages."""
    import jax
    from micro_sam_tpu import util as jutil
    from micro_sam_tpu_torch import util
    cfg = tiny_jax_config()
    state = {"model_state": jax.tree.map(np.asarray, jax_params(cfg)), "model_type": MODEL,
             "model_config": dataclasses.asdict(cfg)}
    path = tmp_path / "cache" / "models" / MODEL
    path.parent.mkdir(parents=True)
    with open(path, "wb") as f:
        pickle.dump(state, f)
    monkeypatch.setenv("MICROSAM_CACHEDIR", str(tmp_path / "cache"))
    registry_hash = f"xxh128:{_xxh128(path)}"
    for mod in (jutil, util):
        monkeypatch.setitem(mod._MODEL_HASHES, MODEL, registry_hash)
    return path, registry_hash


def test_zoo_cache_loads_in_both_packages(zoo, tmp_path):
    """get_sam_model without a checkpoint_path loads the cached file in both
    packages: equal embeddings, the registry's hash in both caches' signature."""
    from micro_sam_tpu import util as jutil
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.sample_data import synthetic_data
    from micro_sam_tpu_torch.utils import zarr_lite
    path, registry_hash = zoo
    jp, jstate = jutil.get_sam_model(MODEL, return_state=True)
    pp, pstate = util.get_sam_model(MODEL, device="cpu", return_state=True)
    assert pstate["checkpoint_path"] == jstate["checkpoint_path"] == str(path)
    assert pp._hash == jp._hash == registry_hash
    pp.transform.apply_image = jp.transform.apply_image  # the same pixels into both encoders
    image = synthetic_data(shape=(200, 256), seed=4)[0]
    stores = {}
    for name, mod, pred in (("jax", jutil, jp), ("port", util, pp)):
        stores[name] = str(tmp_path / f"{name}.zarr")
        emb = mod.precompute_image_embeddings(pred, image, save_path=stores[name], verbose=False)
        stores[name + "_features"] = np.asarray(emb["features"])
    assert rel_err(stores["port_features"], stores["jax_features"]) <= 1e-4
    for name in ("jax", "port"):
        assert zarr_lite.open(stores[name], "r").attrs["model_hash"] == registry_hash
    # the port's weights are the file's, not a random draw
    drawn = util.get_sam_model(MODEL, device="cpu", checkpoint_path=None, seed=3)
    assert torch.equal(drawn.model.image_encoder.pos_embed, pp.model.image_encoder.pos_embed)


def test_zoo_cache_checked_before_loading(zoo, monkeypatch):
    """A file whose hash is not the registry's raises in both packages, and
    without xxhash the port refuses to load the file unchecked."""
    from micro_sam_tpu import util as jutil
    from micro_sam_tpu_torch import util
    path, _ = zoo
    with open(path, "ab") as f:
        f.write(b"\0")
    for mod, kw in ((jutil, {}), (util, {"device": "cpu"})):
        with pytest.raises(RuntimeError, match="corrupt"):
            mod.get_sam_model(MODEL, **kw)
    monkeypatch.setitem(sys.modules, "xxhash", None)  # import xxhash -> ImportError
    with pytest.raises(RuntimeError, match="xxhash"):
        util.get_sam_model(MODEL, device="cpu")


def test_no_cached_file_draws_random_weights(tmp_path, monkeypatch):
    from micro_sam_tpu_torch import util
    monkeypatch.setenv("MICROSAM_CACHEDIR", str(tmp_path))
    monkeypatch.setattr(util, "get_config", _tiny_get_config(util.get_config))
    pp, state = util.get_sam_model(MODEL, device="cpu", return_state=True)
    assert pp._hash is None and "checkpoint_path" not in state
    assert util.get_cache_directory() == util.microsam_cachedir() == str(tmp_path)


def _tiny_get_config(get_config):
    from micro_sam_tpu_torch.models.sam import SamConfig

    def tiny(model_type, compute_dtype="float32"):
        get_config(model_type, compute_dtype)  # validates the name
        return SamConfig(**{**dataclasses.asdict(tiny_jax_config()),
                            "compute_dtype": compute_dtype})
    return tiny


def test_registry_matches_jax():
    from micro_sam_tpu import util as jutil
    from micro_sam_tpu_torch import util
    assert util.get_model_names() == jutil.get_model_names()
    assert util.models() == jutil.models()


def test_get_device():
    from micro_sam_tpu_torch import util
    assert util.get_device("cpu") == torch.device("cpu")
    assert util.get_device(torch.device("cpu")) == torch.device("cpu")
    if not torch.cuda.is_available():
        for dev in (None, "auto", "cuda"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                util.get_device(dev)


@pytest.mark.parametrize("ids", [None, [3, 1], [2, 7]])
def test_segmentation_to_one_hot_matches_jax(ids):
    from micro_sam_tpu import util as jutil
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.sample_data import synthetic_data
    seg = synthetic_data(shape=(64, 80), seed=2, n_objects=5)[1]
    ids = None if ids is None else np.array(ids)
    if ids is not None and not np.isin(ids, seg).all():
        for mod in (jutil, util):
            with pytest.raises(RuntimeError, match="not found"):
                mod.segmentation_to_one_hot(seg, ids)
        return
    got, ref = util.segmentation_to_one_hot(seg, ids), jutil.segmentation_to_one_hot(seg, ids)
    assert got.dtype == ref.dtype == np.float32 and np.array_equal(got, ref)


def test_load_image_data_lazily(tmp_path):
    import h5py
    from micro_sam_tpu_torch import util
    data = np.arange(60, dtype=np.uint16).reshape(3, 4, 5)
    with h5py.File(tmp_path / "v.h5", "w") as f:
        f.create_dataset("raw", data=data)
    lazy = util.load_image_data(str(tmp_path / "v.h5"), "raw", lazy_loading=True)
    assert isinstance(lazy, h5py.Dataset) and np.array_equal(lazy[1], data[1])
    lazy.file.close()
    assert np.array_equal(util.load_image_data(str(tmp_path / "v.h5"), "raw"), data)


def test_command_line_names_the_registry(monkeypatch, capsys):
    from micro_sam_tpu_torch import automatic_segmentation, util
    monkeypatch.setattr(sys, "argv", ["automatic_segmentation", "-h"])
    with pytest.raises(SystemExit):
        automatic_segmentation.main()
    out = " ".join(capsys.readouterr().out.split())
    assert ", ".join(util.get_model_names()) in out


def test_sample_data_matches_jax(tmp_path, monkeypatch):
    """The fetchers read the cache only; the napari hooks ask synthetic_data
    for the JAX package's samples (shapes and seeds; the generator itself is
    held against the JAX package's elsewhere) and wrap them as it does, or
    read the cached file."""
    import imageio.v3 as imageio
    from micro_sam_tpu import sample_data as jsd
    from micro_sam_tpu_torch import sample_data as psd
    monkeypatch.setenv("MICROSAM_CACHEDIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="not cached"):
        psd.fetch_hela_2d_example_data(str(tmp_path))
    asked = {"jax": [], "port": []}
    for name, mod in (("jax", jsd), ("port", psd)):
        def small(shape=(512, 512), seed=0, name=name, **kw):  # a cheap stand-in, by its args
            asked[name].append((tuple(shape), seed, kw))
            rng = np.random.RandomState(seed)
            return (rng.randint(0, 255, (2, 3)).astype(np.uint8),
                    rng.randint(0, 3, (2, 3)).astype(np.uint32))
        monkeypatch.setattr(mod, "synthetic_data", small)
    for name in ("sample_data_wholeslide", "sample_data_livecell", "sample_data_hela_2d",
                 "sample_data_3d", "sample_data_tracking", "sample_data_segmentation",
                 "sample_data_image_series"):
        got, ref = getattr(psd, name)(), getattr(jsd, name)()
        assert len(got) == len(ref)
        for (g, gm, gk), (r, rm, rk) in zip(got, ref):
            assert gm == rm and gk == rk and np.array_equal(g, r)
    assert asked["port"] == asked["jax"] and len(asked["port"]) == 16
    cached = tmp_path / "sample_data" / "hela-2d-image.png"
    cached.parent.mkdir()
    imageio.imwrite(cached, np.full((8, 9), 7, np.uint8))
    assert psd.fetch_hela_2d_example_data(str(tmp_path)) == str(cached)
    ((img, meta, kind),) = psd.sample_data_hela_2d()
    assert img.shape == (8, 9) and meta == {"name": "hela_2d"} and kind == "image"


def test_info_reports_torch(monkeypatch, tmp_path, capsys):
    from micro_sam_tpu_torch import info
    monkeypatch.setenv("MICROSAM_CACHEDIR", str(tmp_path))
    summary = info.accelerator_summary()
    assert torch.__version__ in summary
    if not torch.cuda.is_available():
        assert "no CUDA device" in summary
    info.main([])
    out = capsys.readouterr().out
    assert "vit_b_lm" in out and "Accelerator Information" in out
