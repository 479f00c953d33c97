"""The rank side of tests/test_torch_parallel.py and test_torch_distributed.py:
functions that spawned gloo ranks run on the CPU. They import torch and the
port only (no JAX), read the weights the test wrote with ``params_from_jax``
and write what rank 0 holds for the test to hold against the JAX package."""
import os

import numpy as np
import torch

#: the tiny config of tests/conftest.py (the encoder's and the AMG's) and the
#: JAX trainer test's 128 px one
CFG256 = dict(model_type="vit_b", embed_dim=64, depth=2, num_heads=2, global_attn_indexes=(1,),
              img_size=256, compute_dtype="float32")
CFG128 = dict(CFG256, img_size=128)
#: the global batches
ENCODE_BATCH = 4
TRAIN_BATCH = 4
GUARD_BATCHES = (2, 1)   # data ranks' shares that sum to an odd global batch


def encode_input():
    return (np.random.RandomState(0).rand(ENCODE_BATCH, 256, 256, 3) * 255).astype(np.float32)


def precompute_input():
    return (np.random.RandomState(7).rand(400, 400) * 255).astype(np.uint8)


def trainer_data():
    """The JAX package's meshed-trainer test data: 4 images of 3 squares."""
    rng = np.random.RandomState(0)
    imgs = (rng.rand(TRAIN_BATCH, 128, 128, 3) * 255).astype(np.float32)
    labels = np.zeros((TRAIN_BATCH, 128, 128), np.int64)
    for b in range(TRAIN_BATCH):
        for i in range(3):
            y, x = rng.randint(0, 100, 2)
            labels[b, y:y + 24, x:x + 24] = i + 1
    return imgs, labels


def step_input(cfg):
    from micro_sam_tpu_torch.parallel.train_step import _dryrun_batch
    return _dryrun_batch(TRAIN_BATCH, cfg)


def load_sam(cfg_kw, path, train=False):
    from micro_sam_tpu_torch.models.sam import Sam, SamConfig
    sam = Sam(SamConfig(**cfg_kw), torch.float32)
    sam.load_state_dict(torch.load(path, weights_only=True))
    return sam.train() if train else sam.eval()


class RecordedAdamW(torch.optim.AdamW):
    """``training.sam_trainer.adamw`` that keeps the gradients of its last step."""

    def __init__(self, params, lr=1e-5):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
        self.grads = None

    def step(self, closure=None):
        self.grads = [None if p.grad is None else p.grad.detach().clone()
                      for g in self.param_groups for p in g["params"]]
        return super().step(closure)


def trainer_run(cfg_kw, sd_path, mesh, imgs, labels, root, name="m"):
    """One epoch of SamTrainer (the JAX meshed-trainer test's settings) on this
    rank's share; returns (metrics, whole parameters, whole gradients)."""
    from micro_sam_tpu_torch.parallel.mesh import gather_tensors
    from micro_sam_tpu_torch.training.sam_trainer import SamTrainer
    from micro_sam_tpu_torch.training.trainable_sam import TrainableSAM
    from micro_sam_tpu_torch.training.util import ConvertToSamInputs
    model = TrainableSAM(load_sam(cfg_kw, sd_path, train=True))
    names = [n for n, _ in model.sam.named_parameters()]
    opt = RecordedAdamW([p for _, p in model.sam.named_parameters()])
    trainer = SamTrainer(name=name, train_loader=[(imgs, labels)], val_loader=[(imgs, labels)],
                         model=model, optimizer=opt, n_sub_iteration=1, n_objects_per_batch=2,
                         convert_inputs=ConvertToSamInputs(box_distortion_factor=0.025,
                                                           rng=np.random.RandomState(17)),
                         save_root=root, mesh=mesh, seed=0, logger=False)
    trainer.fit(epochs=1, verbose=False)
    trained = {k: p.detach().clone() for k, p in model.sam.named_parameters()}
    with torch.no_grad():
        for p in model.sam.parameters():
            p.zero_()
    trainer.load_checkpoint("latest")  # every rank reloads its shards of the whole tensors
    if not all(torch.equal(p, trained[k]) for k, p in model.sam.named_parameters()):
        raise AssertionError("the reloaded checkpoint differs from the trained parameters")
    params = dict(model.sam.named_parameters())
    grads = {k: g for k, g in zip(names, opt.grads) if g is not None}
    if mesh is not None:
        params = gather_tensors(params, mesh, model.config)
        grads = gather_tensors(grads, mesh, model.config)
    return (trainer.train_metrics, {k: v.detach().numpy().copy() for k, v in params.items()},
            {k: v.numpy() for k, v in grads.items()})


def step_run(cfg_kw, sd_path, mesh):
    """One ``make_train_step`` step (AdamW 1e-4) on this rank's share of
    ``step_input``; returns (loss, whole parameters after)."""
    from micro_sam_tpu_torch.parallel.mesh import gather_tensors, shard_sam_
    from micro_sam_tpu_torch.parallel.train_step import make_train_step
    from micro_sam_tpu_torch.training.sam_trainer import adamw
    sam = load_sam(cfg_kw, sd_path, train=True)
    d, i = (1, 0) if mesh is None else (mesh.shape["data"], mesh.data_index)
    if mesh is not None:
        shard_sam_(sam, mesh)
    step = make_train_step(sam, adamw(sam.parameters(), 1e-4), mesh)
    per = TRAIN_BATCH // d
    arrays = step_input(sam.config)
    loss, _ = step(*(torch.as_tensor(a[i * per:(i + 1) * per]) for a in arrays))
    params = dict(sam.named_parameters())  # the buffers (the prompt PE matrix) do not train
    if mesh is not None:
        params = gather_tensors(params, mesh, sam.config)
    return float(loss), {k: v.detach().numpy().copy() for k, v in params.items()}


AMG_GRID = 4   # points a side of the AMG and of the sharded decode


def amg_records(predictor):
    """The JAX meshed-AMG test's AMG on synthetic_data (256^2, seed 42); the
    predictor keeps the image's embeddings."""
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.instance_segmentation import AutomaticMaskGenerator
    from micro_sam_tpu_torch.sample_data import synthetic_data
    image, _ = synthetic_data(shape=(256, 256), seed=42)
    emb = util.precompute_image_embeddings(predictor, image, verbose=False)
    amg = AutomaticMaskGenerator(predictor, points_per_side=4, prefilter_thresholds=(-10.0, -10.0))
    amg.initialize(image, emb, verbose=False)
    records = amg.generate(pred_iou_thresh=0.0, stability_score_thresh=0.0,
                           output_mode="binary_mask")
    return [(float(r["predicted_iou"]), np.asarray(r["segmentation"])) for r in records]


def shared_cache_check(pred, mesh, workdir):
    """The meshed precompute into one save_path shared by the ranks: computed,
    then a cache hit, then loaded lazily; on every rank each tile equals the
    first run's. Returns (every rank's verdict, the path)."""
    import torch.distributed as dist
    from micro_sam_tpu_torch import util
    path = os.path.join(workdir, f"shared_{mesh.shape['data']}x{mesh.shape['model']}.zarr")
    kw = dict(tile_shape=(256, 256), halo=(32, 32), verbose=False, batch_size=4)
    runs = [util.precompute_image_embeddings(pred, precompute_input(), save_path=path, **kw),
            util.precompute_image_embeddings(pred, precompute_input(), save_path=path, **kw),
            util.precompute_image_embeddings(pred, precompute_input(), save_path=path,
                                             lazy_loading=True, **kw)]
    first = runs[0]["features"]
    same = all(np.array_equal(np.asarray(util._get_tile_features(r, t)["features"]),
                              np.asarray(first[t]["features"]))
               for r in runs[1:] for t in first)
    verdicts = [None] * mesh.size
    dist.all_gather_object(verdicts, (mesh.rank, same, sorted(first)))
    return verdicts, path


def world_checks(model_axis, workdir):
    """Every check of one world on this rank; rank 0's results."""
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.parallel.mesh import make_mesh
    from micro_sam_tpu_torch.predictor import SamPredictor
    from micro_sam_tpu_torch.ops.amg_utils import build_point_grid
    from micro_sam_tpu_torch.parallel import distributed
    from micro_sam_tpu_torch.parallel.decode import ShardedAmgDecoder
    from micro_sam_tpu_torch.parallel.embed import (ShardedEncoder,
                                                    precompute_image_embeddings_sharded)
    from micro_sam_tpu_torch.parallel.train_step import dryrun_production, dryrun_training_step
    mesh = make_mesh(model_axis=model_axis, device="cpu")
    out = {"shape": mesh.shape}
    sd256 = os.path.join(workdir, "sd256.pt")
    enc = ShardedEncoder(load_sam(CFG256, sd256), mesh=mesh, batch_size=ENCODE_BATCH)
    batch = encode_input()
    out["encode"] = enc.encode_batch(batch)
    out["encode_partial"] = enc.encode_batch(batch[:3])
    out["encode_tiles"] = np.stack(enc.encode_tiles(list(batch[:3])))
    share = np.arange(6, dtype=np.float32).reshape(3, 2) + 10 * mesh.data_index
    out["global_batch"] = distributed.global_batch(share, mesh).numpy()
    out["replicate"] = (distributed.replicate(np.full(3, mesh.rank, np.float32), mesh).numpy(),
                        distributed.replicate({"rank": mesh.rank}, mesh))
    pred = SamPredictor(load_sam(CFG256, sd256), mesh=mesh)
    emb = util.precompute_image_embeddings(pred, precompute_input(), tile_shape=(256, 256),
                                           halo=(32, 32), verbose=False, batch_size=4)
    out["precompute"] = {t: np.asarray(e["features"]) for t, e in emb["features"].items()}
    emb = precompute_image_embeddings_sharded(SamPredictor(load_sam(CFG256, sd256)),
                                              precompute_input(), (256, 256), (32, 32),
                                              mesh=mesh, batch_size=4)
    if not all(np.array_equal(np.asarray(e["features"]), out["precompute"][t])
               for t, e in emb["features"].items()):
        raise AssertionError("precompute_image_embeddings_sharded differs from the meshed predictor")
    out["shared_cache"] = shared_cache_check(pred, mesh, workdir)
    out["amg"] = amg_records(pred)
    grid = (build_point_grid(AMG_GRID) * 256).astype(np.float32)
    out["amg_decode"] = [ShardedAmgDecoder(pred)(g) for g in (grid, grid[:13])]
    if mesh.size == 4:  # the JAX package's dryruns run on its 4 x 2 mesh
        out["dryrun"] = (dryrun_training_step(mesh), dryrun_production(mesh, workdir))

    d, i = mesh.shape["data"], mesh.data_index
    imgs, labels = trainer_data()
    per = TRAIN_BATCH // d
    out["trainer"] = trainer_run(CFG128, os.path.join(workdir, "sd128.pt"), mesh,
                                 imgs[i * per:(i + 1) * per], labels[i * per:(i + 1) * per],
                                 os.path.join(workdir, f"ckpt{model_axis}_{mesh.size}"))
    out["step"] = step_run(CFG128, os.path.join(workdir, "sd128.pt"), mesh)
    if d == 2:  # the shares of an odd global batch
        k = GUARD_BATCHES[i]
        try:
            trainer_run(CFG128, os.path.join(workdir, "sd128.pt"), mesh, imgs[:k], labels[:k],
                        os.path.join(workdir, f"guard{mesh.size}"), name="g")
            out["guard"] = None
        except ValueError as e:
            out["guard"] = str(e)
    return out


def run_world(rank, n, model_axis, workdir, name):
    """A rank of the gloo world ``name`` of ``n`` CPU ranks: ``world_checks``,
    rank 0's results written to <workdir>/<name>.pt."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/{name}.init", world_size=n,
                            rank=rank)
    try:
        out = world_checks(model_axis, workdir)
        if rank == 0:
            torch.save(out, os.path.join(workdir, f"{name}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# tests/test_torch_distributed.py: the multi-process precompute and a model-
# axis checkpoint in one 2-rank world
# ---------------------------------------------------------------------------

MULTIHOST_IMAGE = dict(shape=(300, 300), seed=6)


def multihost_image():
    rng = np.random.RandomState(MULTIHOST_IMAGE["seed"])
    return (rng.rand(*MULTIHOST_IMAGE["shape"]) * 255).astype(np.uint8)


def run_multihost(rank, n, workdir):
    """A rank of a 2-rank gloo world: ``precompute_image_embeddings_multihost``
    into <workdir>/mh.zarr, counting the cache's "done" stamps of this rank;
    then one epoch of a SamTrainer split over model = 2 writing its
    checkpoint under <workdir>/tp. Rank 0 writes <workdir>/multihost.pt."""
    import torch.distributed as dist
    from micro_sam_tpu_torch.parallel import distributed
    from micro_sam_tpu_torch.parallel.mesh import make_mesh
    from micro_sam_tpu_torch.predictor import SamPredictor
    from micro_sam_tpu_torch.utils import zarr_lite
    torch.set_num_threads(1)
    distributed.initialize(num_processes=n, process_id=rank, backend="gloo",
                           init_method=f"file://{workdir}/multihost.init")
    try:
        stamps = []
        original = zarr_lite.Attributes.__setitem__

        def counted(self, key, value):
            if key == "done":
                stamps.append(key)
            return original(self, key, value)

        zarr_lite.Attributes.__setitem__ = counted
        try:
            pred = SamPredictor(load_sam(CFG256, os.path.join(workdir, "sd256.pt")))
            emb = distributed.precompute_image_embeddings_multihost(
                pred, multihost_image(), os.path.join(workdir, "mh.zarr"),
                tile_shape=(150, 150), halo=(16, 16))
        finally:
            zarr_lite.Attributes.__setitem__ = original
        all_stamps = [None] * n
        dist.all_gather_object(all_stamps, len(stamps))
        features = {t: np.asarray(e["features"]) for t, e in emb["features"].items()}

        mesh = make_mesh(model_axis=2, device="cpu")
        imgs, labels = trainer_data()
        metrics, params, _ = trainer_run(CFG128, os.path.join(workdir, "sd128.pt"), mesh, imgs,
                                         labels, os.path.join(workdir, "tp"), name="tp")
        if rank == 0:
            torch.save({"features": features, "stamps": all_stamps, "params": params,
                        "metrics": metrics}, os.path.join(workdir, "multihost.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# starting a world: one python process a rank
# ---------------------------------------------------------------------------

def start(target, n, *args):
    """Start ``n`` ranks, each ``target(rank, n, *args)`` of this module in a
    python process of its own; returns the processes (``wait`` ends them)."""
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([here, root, os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1")
    procs = []
    for rank in range(n):
        code = (f"import torch_parallel_worlds as w; w.{target}({rank}, {n}, "
                f"{', '.join(repr(a) for a in args)})")
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, cwd=root,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def wait(procs, timeout=300):
    """Wait for every rank; raises with the output of those that failed."""
    failed = []
    for rank, p in enumerate(procs):
        try:
            so, se = p.communicate(timeout=timeout)
        except Exception:
            for q in procs:
                q.kill()
            raise
        if p.returncode != 0:
            failed.append(f"rank {rank} exited {p.returncode}:\n{so[-3000:]}\n{se[-5000:]}")
    if failed:
        raise RuntimeError("\n".join(failed))


# ---------------------------------------------------------------------------
# tests/test_torch_cuda.py: the split chains on the card, two gloo ranks on
# one GPU
# ---------------------------------------------------------------------------

SPLIT_CASES = {"window": (25, 14, 768, 12), "global": (1, 64, 768, 12)}  # batch, side, C, heads


def _split_block_case(kind, dtype, seed=20):
    """A vit_b-width block (random, seed) and its input: 25 masked 14 x 14
    windows, or one 64 x 64 global grid."""
    from micro_sam_tpu_torch.models.common import init_module_
    from micro_sam_tpu_torch.models.image_encoder import Block
    B, side, C, nH = SPLIT_CASES[kind]
    g = torch.Generator().manual_seed(seed)
    blk = Block(C, nH, 4.0, side if kind == "window" else 0, (side, side))
    init_module_(blk, g)
    x = torch.randn(B, side * side, C, generator=g)
    valid = (torch.rand(B, side * side, 1, generator=g) > 0.1).float() if kind == "window" else None
    return blk, x, valid


def run_split_chains(rank, n, workdir):
    """A rank of a 2-rank gloo world on cuda:0: the attention and MLP halves
    of a vit_b block split over model = 2 (the kernels at the split widths),
    each kind and dtype, with the launches of a call; rank 0 also runs the
    unsplit plain chain in f32 on the same inputs. Rank 0 writes
    <workdir>/split.pt."""
    import torch.distributed as dist
    from micro_sam_tpu_torch.ops import fused_window_block as fwb
    from micro_sam_tpu_torch.ops.gemm import gemm
    from micro_sam_tpu_torch.ops.layernorm import layernorm
    from micro_sam_tpu_torch.ops.relpos_attention import relpos_attention
    from micro_sam_tpu_torch.parallel.mesh import make_mesh, shard_tensor, split_rule
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{workdir}/split.init", world_size=n,
                            rank=rank)
    try:
        mesh = make_mesh(model_axis=n)
        dev = mesh.device
        counters = (layernorm, gemm, relpos_attention)
        out = {}
        for kind in SPLIT_CASES:
            for dtype in (torch.float32, torch.bfloat16):
                blk, x, valid = _split_block_case(kind, dtype)
                blk.hold_weights_in_(dtype)
                B, side, C, nH = SPLIT_CASES[kind]
                hw = (side, side)
                ref = None
                if rank == 0:
                    whole = blk.to(dev)
                    with torch.no_grad():
                        xr = x.to(dev, dtype).float()
                        ref = (fwb.fused_window_attn_plain(xr, None if valid is None else
                                                           valid.to(dev), whole, hw, nH)
                               if kind == "window" else fwb.fused_global_attn_plain(xr, whole, hw, nH))
                        ref = fwb.mlp_half_plain(ref, whole).cpu()
                    blk = blk.cpu()
                for name, p in blk.named_parameters():
                    rule = split_rule(f"image_encoder.blocks.0.{name}")
                    if rule is not None:
                        p.data = shard_tensor(p.data, rule, n, mesh.model_index)
                blk.tp = mesh.model_shard
                blk = blk.to(dev)
                xd, vd = x.to(dev, dtype), None if valid is None else valid.to(dev)
                before = [c.launches for c in counters]
                with torch.no_grad():
                    y = (fwb.fused_window_attn(xd, vd, blk, hw, nH) if kind == "window"
                         else fwb.fused_global_attn(xd, blk, hw, nH))
                    y = fwb.mlp_half(y, blk)
                torch.cuda.synchronize()
                out[(kind, str(dtype))] = dict(out=y.float().cpu(), ref=ref,
                                               launches=[c.launches - b for c, b in
                                                         zip(counters, before)])
        if rank == 0:
            torch.save(out, os.path.join(workdir, "split.pt"))
    finally:
        dist.destroy_process_group()
