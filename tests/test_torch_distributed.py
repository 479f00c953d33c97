"""The port's multi-process execution (micro_sam_tpu_torch/parallel/distributed.py)
on the CPU: gloo worlds of python processes, against one process and the JAX
package.

One 2-rank world (tests/torch_parallel_worlds.py::run_multihost) runs the
multi-process precompute into a shared cache and then one SamTrainer epoch
split over model = 2, whose checkpoint rank 0 writes; ``dryrun_multihost``
starts a world of its own (two processes and one alone) and asserts the JAX
dryrun's equalities.
"""
import numpy as np
import pytest
import torch

import torch_parallel_worlds as w
from torch_port_util import one_thread, rel_err


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def multihost(tmp_path_factory):
    """The 2-rank world's results, and the single process's precompute of the
    same image on the same weights."""
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.models.build_sam import make_sam
    from micro_sam_tpu_torch.models.sam import SamConfig
    from micro_sam_tpu_torch.predictor import SamPredictor
    tmp = tmp_path_factory.mktemp("multihost")
    for size, kw, seed in ((256, w.CFG256, 0), (128, w.CFG128, 1)):
        torch.save(make_sam(SamConfig(**kw), None, seed, torch.float32).state_dict(),
                   tmp / f"sd{size}.pt")
    procs = w.start("run_multihost", 2, str(tmp))
    try:
        pred = SamPredictor(w.load_sam(w.CFG256, tmp / "sd256.pt"))
        single = util.precompute_image_embeddings(pred, w.multihost_image(),
                                                  tile_shape=(150, 150), halo=(16, 16),
                                                  verbose=False)
    finally:
        w.wait(procs)
    return tmp, torch.load(tmp / "multihost.pt", weights_only=False), single


@pytest.mark.parametrize("n_tiles,nproc", [(10, 3), (7, 2), (4, 4), (3, 5)])
def test_process_tile_ids_match_jax(n_tiles, nproc):
    from micro_sam_tpu.parallel.distributed import process_tile_ids as jax_ids
    from micro_sam_tpu_torch.parallel.distributed import process_tile_ids
    shares = [process_tile_ids(n_tiles, p, nproc) for p in range(nproc)]
    assert shares == [jax_ids(n_tiles, p, nproc) for p in range(nproc)]
    assert sorted(sum(shares, [])) == list(range(n_tiles))


def test_multihost_precompute_equals_single_process(multihost):
    """Two processes' shares of the tiles, adopted by rank 0, equal the single
    process's tiles (the same per-tile encodes: bitwise); the cache's signature
    is stamped once, by rank 0."""
    from micro_sam_tpu_torch.utils import zarr_lite
    tmp, got, single = multihost
    assert set(got["features"]) == set(single["features"]) == {0, 1, 2, 3}
    for t, f in single["features"].items():
        assert np.array_equal(got["features"][t], np.asarray(f["features"])), t
    assert got["stamps"] == [1, 0]
    cache = zarr_lite.open(str(tmp / "mh.zarr"), mode="r")
    assert cache.attrs.get("done") and cache.attrs.get("tile_shape") == [150, 150]


def test_dryrun_multihost(tmp_path):
    """Two processes against one: the precompute and AMG hashes equal, the
    step's and the trainer's losses within 1e-4, their parameters' checksums
    and rank 0's checkpoint's within rel 1e-5."""
    from micro_sam_tpu_torch.parallel.distributed import dryrun_multihost
    results = dryrun_multihost(n_processes=2, workdir=str(tmp_path))
    assert [c["nproc"] for c in results["cluster"]] == [2, 2]
    assert results["single"]["nproc"] == 1
    assert results["cluster"][0]["mesh"] == {"data": 2, "model": 1}
    assert results["cluster"][0]["checkpoint_written"]


def test_model_axis_checkpoint_loads_whole(multihost):
    """The checkpoint of a SamTrainer split over model = 2 holds the whole
    tensors under the single-process keys: it loads in one port process and
    in the JAX package's get_sam_model, with the trained weights, and their
    embeddings agree (rel 1e-4)."""
    import jax
    from micro_sam_tpu.util import get_sam_model as jax_get
    from micro_sam_tpu_torch.models.convert import params_from_jax
    from micro_sam_tpu_torch.util import get_sam_model
    tmp, got, _ = multihost
    path = str(tmp / "tp" / "tp" / "latest.pkl")
    pp = get_sam_model("vit_b", device="cpu", checkpoint_path=path)
    sd = pp.model.state_dict()
    trained = got["params"]
    assert set(trained) <= set(sd)
    for k, v in trained.items():
        assert tuple(sd[k].shape) == v.shape and np.array_equal(sd[k].numpy(), v), k
    before = w.load_sam(w.CFG128, tmp / "sd128.pt").state_dict()
    assert not np.array_equal(before["image_encoder.blocks.0.attn.qkv.weight"].numpy(),
                              trained["image_encoder.blocks.0.attn.qkv.weight"])
    jp = jax_get(model_type="vit_b", checkpoint_path=path, compute_dtype="float32")
    j_sd = params_from_jax(jax.tree.map(np.asarray, jp.model.params), pp.model.config)
    for k, v in trained.items():
        assert np.array_equal(j_sd[k].numpy(), v), k
    img = np.random.RandomState(0).randint(0, 255, (128, 128, 3)).astype(np.uint8)
    jp.set_image(img)
    pp.set_image(img)
    assert rel_err(pp.get_image_embedding(), np.asarray(jp.get_image_embedding())) <= 1e-4
