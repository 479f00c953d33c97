"""Multi-process execution: the ``torch.distributed`` world, the per-process
share of the tiled precompute, and the equality dryrun of a cluster against
one process.

Counterpart of ``micro_sam_tpu/parallel/distributed.py``. The JAX package
forms a ``jax.distributed`` cluster and lets XLA insert the collectives under
a global mesh; here each process is one rank of a ``torch.distributed``
world (NCCL across GPUs, gloo on the CPU or for two ranks on one GPU), on the
mesh of ``parallel/mesh.py``. The precompute fan-out is embarrassingly
parallel: each process encodes a round-robin share of the tiles and writes
their chunks of the shared zarr cache; rank 0 stamps the cache's signature
once every share has landed.

A real multi-GPU run starts one process a GPU, each with ``MSAM_COORDINATOR``
(host:port of rank 0), ``MSAM_NUM_PROCESSES`` and ``MSAM_PROCESS_ID`` set (or
``init_method=`` given), and calls ``initialize()`` first.

    python -m micro_sam_tpu_torch.parallel.distributed <workdir> <out.json>

runs one process's share of the dryrun (a single process without ``MSAM_*``)
on the process's GPU over NCCL; ``dryrun_multihost``, its CPU stand-in, adds
``cpu`` as a third argument and names gloo in ``MSAM_BACKEND``.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from .mesh import Mesh, make_mesh

#: the dryrun's global batch: one sample a data rank of a 2-process cluster
DRYRUN_BATCH = 2


def _dist():
    import torch.distributed as dist
    return dist


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               init_method: Optional[str] = None, **kwargs) -> None:
    """Join (or form) the ``torch.distributed`` world; idempotent.

    The topology comes from the arguments, else from ``MSAM_COORDINATOR``
    (host:port of rank 0), ``MSAM_NUM_PROCESSES`` and ``MSAM_PROCESS_ID``.
    ``init_method`` (e.g. a ``file://`` store) replaces the ``tcp://``
    address. ``backend`` (else ``MSAM_BACKEND``) is NCCL unless named: gloo
    must be asked for (the CPU, or two ranks on one GPU)."""
    if is_initialized():
        return
    dist = _dist()
    coordinator_address = coordinator_address or os.environ.get("MSAM_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("MSAM_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("MSAM_PROCESS_ID", "0"))
    if init_method is None:
        if coordinator_address is None:
            raise ValueError("initialize needs a coordinator address (MSAM_COORDINATOR) or an "
                             "init_method")
        init_method = f"tcp://{coordinator_address}"
    backend = backend or os.environ.get("MSAM_BACKEND", "nccl")
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, **kwargs)


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return _dist().get_rank() if is_initialized() else 0


def process_count() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def barrier(name: Optional[str] = None) -> None:
    """Block until every process of the world reaches this point (``name``
    labels the point for a reader; the world has one barrier at a time)."""
    if is_initialized():
        _dist().barrier()


def global_mesh(model_axis: int = 1, device=None) -> Mesh:
    """The ("data", "model") mesh over every process of the world: rank r at
    (r // model_axis, r % model_axis), so a model group is a run of adjacent
    ranks."""
    return make_mesh(None, model_axis=model_axis, device=device)


def process_tile_ids(n_tiles: int, process_id: Optional[int] = None,
                     process_count: Optional[int] = None) -> List[int]:
    """Round-robin tile assignment: the cheaper border tiles are spread over
    the processes instead of the last row going to one of them."""
    pid = process_index() if process_id is None else process_id
    if process_count is None:
        process_count = _dist().get_world_size() if is_initialized() else 1
    return list(range(pid, n_tiles, process_count))


def global_batch(local_data, mesh: Mesh) -> torch.Tensor:
    """The global batch from this data rank's share (the shares concatenated
    in data-rank order, all-gathered over the data group), on the mesh's
    device."""
    from .mesh import all_gather_cat
    t = torch.as_tensor(np.asarray(local_data) if not torch.is_tensor(local_data)
                        else local_data).to(mesh.device)
    return all_gather_cat(t, mesh.data_group)


def replicate(value, mesh: Mesh):
    """Mesh rank 0's value on every rank: a tensor or an array broadcast as a
    tensor on the mesh's device, anything else as a pickled object."""
    if mesh.world is None:
        return torch.as_tensor(value).to(mesh.device) if isinstance(value, np.ndarray) else value
    if torch.is_tensor(value) or isinstance(value, np.ndarray):
        t = torch.as_tensor(value).to(mesh.device).contiguous()
        _dist().broadcast(t, src=mesh.ranks[0], group=mesh.world)
        return t
    return mesh.broadcast_object(value)


def precompute_image_embeddings_multihost(
    predictor,
    input_: np.ndarray,
    save_path: str,
    tile_shape,
    halo,
    ndim: Optional[int] = None,
    batch_size: int = 1,
    verbose: bool = False,
    mask: Optional[np.ndarray] = None,
    lazy_loading: bool = False,
):
    """Tiled embedding precompute fanned out over the processes of the world.

    Each process encodes a round-robin share of the tile grid on its own GPU
    (``predictor`` is this process's, not meshed) and writes those tiles'
    chunks into the shared ``save_path``. After a barrier, process 0 adopts
    every share and stamps the signature (once); after another, every process
    loads the finished cache. Layout and signature are the single process's."""
    from .. import util

    if save_path is None:
        raise ValueError("Multi-process precompute needs a shared save_path: the processes "
                         "exchange their shares through the zarr cache.")
    if tile_shape is None:
        raise ValueError("Multi-process precompute fans out over tiles: pass tile_shape.")
    ndim = input_.ndim if ndim is None else ndim
    halo = tuple(halo) if halo is not None else tuple(0 for _ in tile_shape)
    shape_2d = input_.shape[:2] if ndim == 2 else input_.shape[1:3]
    blocking = util._tile_grid(shape_2d, tuple(tile_shape))
    mask_2d = mask if (mask is None or ndim == 2) else np.max(mask, axis=0)
    all_ids = util._get_tiles_in_mask(blocking, mask_2d)
    mine = set(process_tile_ids(len(all_ids)))
    my_ids = [t for i, t in enumerate(all_ids) if i in mine]
    kw = dict(save_path=str(save_path), ndim=ndim, tile_shape=tuple(tile_shape), halo=halo,
              mask=mask)

    # phase 1: every process writes its share (no signature yet)
    util.precompute_image_embeddings(predictor, input_, batch_size=batch_size,
                                     verbose=verbose and process_index() == 0,
                                     tile_subset=my_ids, finalize=False, **kw)
    barrier("msam-precompute-shards")
    # phase 2: process 0 adopts every share and stamps the signature
    if process_index() == 0:
        util.precompute_image_embeddings(predictor, input_, batch_size=batch_size,
                                         verbose=False, **kw)
    barrier("msam-precompute-done")
    # phase 3: everyone loads the finished cache
    return util.precompute_image_embeddings(predictor, input_, verbose=False,
                                            lazy_loading=lazy_loading, **kw)


# ---------------------------------------------------------------------------
# the dryrun: one process's share, and the cluster against one process
# ---------------------------------------------------------------------------

def _sum_sq(tensors) -> float:
    return float(sum(float((t.detach().double() ** 2).sum()) for t in tensors))


def _dryrun_worker(workdir: str, device=None) -> dict:
    """One process's share of the dryrun: the tiled precompute fanned out over
    the processes, one training step of ``make_train_step`` on deterministic
    inputs, one epoch of the real ``SamTrainer`` fed this process's share,
    and the AMG of a meshed predictor, on the world's data axis (one device a
    process: ``device``, else the process's GPU). Returns the scalars that
    must agree with a single process's run of the same work
    (``dryrun_multihost``)."""
    import hashlib
    import pickle

    from .. import util
    from ..instance_segmentation import AutomaticMaskGenerator
    from ..predictor import SamPredictor
    from ..training.sam_trainer import SamTrainer, adamw
    from ..training.trainable_sam import TrainableSAM
    from .mesh import gather_state_dict, shard_sam_
    from .train_step import _dryrun_batch, dryrun_sam, make_train_step

    nproc = process_count()
    mesh = global_mesh(device=device)
    dev = mesh.device
    d, di = mesh.shape["data"], mesh.data_index
    per = DRYRUN_BATCH // d
    share = slice(di * per, (di + 1) * per)

    # 1. the tiled precompute fanned out over the processes
    image = (np.random.RandomState(3).rand(300, 300) * 255).astype(np.uint8)
    predictor = SamPredictor(dryrun_sam(0, dev))
    cache = os.path.join(workdir, "emb.zarr")
    if nproc > 1:
        emb = precompute_image_embeddings_multihost(predictor, image, cache, tile_shape=(128, 128),
                                                    halo=(16, 16))
    else:
        emb = util.precompute_image_embeddings(predictor, image, save_path=cache,
                                               tile_shape=(128, 128), halo=(16, 16),
                                               verbose=False)
    sha = hashlib.sha1()
    for tid in sorted(emb["features"]):
        feats = np.asarray(emb["features"][tid]["features"], dtype=np.float32)
        sha.update(np.round(feats, 4).tobytes())
    emb_sha = sha.hexdigest()

    # 2. one meshed training step on deterministic inputs
    sam = shard_sam_(dryrun_sam(0, dev), mesh)
    step = make_train_step(sam, adamw(sam.parameters(), 1e-4), mesh)
    arrays = _dryrun_batch(DRYRUN_BATCH, sam.config)
    loss, _ = step(*(torch.as_tensor(a[share], device=dev) for a in arrays))
    checksum = _sum_sq(gather_state_dict(sam, mesh).values())

    # 3. the real trainer, one epoch, each process fed its share
    rng = np.random.RandomState(7)
    g_imgs = (rng.rand(DRYRUN_BATCH, 128, 128, 3) * 255).astype(np.float32)
    g_lbls = np.zeros((DRYRUN_BATCH, 128, 128), np.int64)
    for b in range(DRYRUN_BATCH):
        for i in range(3):
            y, x = rng.randint(0, 100, 2)
            g_lbls[b, y:y + 24, x:x + 24] = i + 1
    loader = [(g_imgs[share], g_lbls[share])]
    trainer = SamTrainer(name="mh-dryrun", train_loader=loader, val_loader=loader,
                         model=TrainableSAM(dryrun_sam(1, dev)), n_sub_iteration=2,
                         n_objects_per_batch=2, seed=0, save_root=os.path.join(workdir, "ckpt"),
                         mesh=mesh, logger=False)
    trainer.fit(epochs=1, verbose=False)
    trainer_loss = float(trainer.train_metrics[0]["train_loss"])
    trainer_param_checksum = _sum_sq(gather_state_dict(trainer.model.sam, mesh).values())
    barrier("msam-checkpoint-written")
    ckpt = os.path.join(workdir, "ckpt", "mh-dryrun", "latest.pkl")
    ckpt_checksum = None
    if os.path.exists(ckpt):
        with open(ckpt, "rb") as f:
            state = pickle.load(f)
        ckpt_checksum = _sum_sq(torch.as_tensor(np.asarray(v)) for v in
                                _leaves(state["model_state"]))

    # 4. the AMG of a meshed predictor
    amg_pred = SamPredictor(dryrun_sam(0, dev), mesh=mesh)
    rng = np.random.RandomState(11)
    amg_img = np.zeros((128, 128), np.uint8)
    for i in range(4):
        y, x = rng.randint(10, 100, 2)
        amg_img[y:y + 20, x:x + 20] = 120 + 30 * i
    amg = AutomaticMaskGenerator(amg_pred, points_per_side=4, points_per_batch=2 * d,
                                 prefilter_thresholds=(0.0, 0.0))
    amg.initialize(amg_img)
    records = amg.generate(pred_iou_thresh=0.0, stability_score_thresh=0.0, box_nms_thresh=0.9,
                           output_mode="rle")
    sha = hashlib.sha1()
    for rec in records:
        sha.update(np.asarray(rec["segmentation"]["counts"], np.int64).tobytes())
        sha.update(np.round(np.float64(rec["predicted_iou"]), 5).tobytes())
    amg_sha = sha.hexdigest()
    barrier("msam-dryrun-done")
    return {"nproc": nproc, "mesh": mesh.shape, "emb_sha": emb_sha, "step_loss": float(loss),
            "param_checksum": checksum, "trainer_loss": trainer_loss,
            "trainer_param_checksum": trainer_param_checksum, "ckpt_checksum": ckpt_checksum,
            "amg_sha": amg_sha, "checkpoint_written": os.path.exists(ckpt)}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _worker_main(argv: Sequence[str]) -> None:
    """python -m micro_sam_tpu_torch.parallel.distributed <workdir> <out.json> [device]

    The world from MSAM_COORDINATOR / MSAM_NUM_PROCESSES / MSAM_PROCESS_ID
    and ``initialize``'s backend (absent: one process); the process's GPU
    unless ``device`` names another (``cpu``)."""
    import json
    workdir, out_path = argv[0], argv[1]
    device = argv[2] if len(argv) > 2 else None
    if os.environ.get("MSAM_NUM_PROCESSES"):
        initialize()
    try:
        result = _dryrun_worker(workdir, device)
    finally:
        if is_initialized():
            _dist().destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(result, f)
    print(f"[distributed dryrun] process {result['nproc']}: {result}")


def dryrun_multihost(n_processes: int = 2, timeout: int = 600, workdir: Optional[str] = None
                     ) -> dict:
    """Run ``_dryrun_worker`` in one process and in a gloo world of
    ``n_processes`` CPU processes (started together), and check that the
    world equals the single process: the precompute's and the AMG's hashes,
    the step's loss (1e-4) and parameters' checksum (rel 1e-5), the trainer's
    loss (1e-4) and parameters' checksum (rel 1e-5), and the checkpoint that
    rank 0 wrote (rel 1e-5). The stand-in for a multi-GPU node: the CPU, gloo
    and one torch thread a process are asked for here."""
    import json
    import socket
    import subprocess
    import sys
    import tempfile

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()

    def env_for(pid: Optional[int]) -> dict:
        env = {k: v for k, v in os.environ.items() if not k.startswith("MSAM_")}
        env["OMP_NUM_THREADS"] = "1"
        if pid is not None:
            env.update(MSAM_COORDINATOR=f"localhost:{port}", MSAM_NUM_PROCESSES=str(n_processes),
                       MSAM_PROCESS_ID=str(pid), MSAM_BACKEND="gloo")
        return env

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cmd = [sys.executable, "-m", "micro_sam_tpu_torch.parallel.distributed"]
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        jobs = []
        for pid in [None] + list(range(n_processes)):
            where = os.path.join(tmp, "single" if pid is None else "cluster")
            os.makedirs(where, exist_ok=True)
            out = os.path.join(tmp, f"{'single' if pid is None else pid}.json")
            jobs.append((pid, out, subprocess.Popen(cmd + [where, out, "cpu"], env=env_for(pid),
                                                    cwd=repo, stdout=subprocess.PIPE,
                                                    stderr=subprocess.PIPE, text=True)))
        results = {"cluster": []}
        failed = []
        for pid, out, p in jobs:
            so, se = p.communicate(timeout=timeout)
            if p.returncode != 0:
                failed.append(f"{'single process' if pid is None else f'process {pid}'} failed:"
                              f"\n{so[-2000:]}\n{se[-2000:]}")
                continue
            with open(out) as f:
                r = json.load(f)
            if pid is None:
                results["single"] = r
            else:
                results["cluster"].append(r)
        if failed:
            raise RuntimeError("\n".join(failed))

    single, cluster = results["single"], results["cluster"]

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1.0)

    for c in cluster:
        if c["emb_sha"] != single["emb_sha"]:
            raise AssertionError("multi-process precompute differs from the single process")
        if abs(c["step_loss"] - single["step_loss"]) >= 1e-4:
            raise AssertionError(("step loss", c["step_loss"], single["step_loss"]))
        if rel(c["param_checksum"], single["param_checksum"]) >= 1e-5:
            raise AssertionError(("step params", c["param_checksum"], single["param_checksum"]))
        if abs(c["trainer_loss"] - single["trainer_loss"]) >= 1e-4:
            raise AssertionError(("trainer loss", c["trainer_loss"], single["trainer_loss"]))
        if rel(c["trainer_param_checksum"], single["trainer_param_checksum"]) >= 1e-5:
            raise AssertionError(("trainer params", c["trainer_param_checksum"],
                                  single["trainer_param_checksum"]))
        if c["amg_sha"] != single["amg_sha"]:
            raise AssertionError("multi-process AMG differs from the single process")
    if not cluster[0]["checkpoint_written"] or cluster[0]["ckpt_checksum"] is None:
        raise AssertionError("rank 0 wrote no checkpoint")
    if rel(cluster[0]["ckpt_checksum"], single["ckpt_checksum"]) >= 1e-5:
        raise AssertionError(("checkpoint", cluster[0]["ckpt_checksum"], single["ckpt_checksum"]))
    print(f"dryrun_multihost: {n_processes} processes == one process: precompute and AMG "
          f"hashes equal, step loss {single['step_loss']:.6f}, trainer loss "
          f"{single['trainer_loss']:.6f}, checkpoint checksum equal")
    return results


if __name__ == "__main__":
    import sys as _sys
    _worker_main(_sys.argv[1:])
