"""The data x model mesh over ``torch.distributed``, and a SAM sharded on it.

Counterpart of ``micro_sam_tpu/parallel/mesh.py``. There the mesh is a
``jax.sharding.Mesh``: one program that XLA partitions over the devices and
into which it inserts the collectives. Here the mesh is one process per rank
with explicit collectives: each rank computes its shard, and the port says
where the shards meet.

- ``data``: batch / tile parallelism. Each data rank encodes and decodes a
  contiguous slice of a batch, and the slices are all-gathered, so every rank
  holds the whole result. Training averages the gradients over the data
  group.
- ``model``: tensor parallelism inside the ViT encoder's blocks (Megatron's
  layout). qkv and lin1 are split on their output rows, qkv by heads (rank k
  keeps the q, k and v rows of heads [k nH / m, (k + 1) nH / m)); proj and
  lin2 on their input columns. Each rank's partial proj / lin2 product is
  all-reduced in float32 over the model group, and the bias and the residual
  are added once, after the sum. Everything else is replicated.

The layout is JAX's ``make_mesh``: the world reshaped to (n // m, m), rank =
data_index * m + model_index, so a model group is a run of adjacent ranks
(adjacent GPUs of a node). The ranks communicate only through ``broadcast``,
``all_reduce``, ``all_gather`` (list form) and ``barrier``, which NCCL and
gloo both take, on CUDA tensors too.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch

#: state-dict suffix of an encoder block's tensor -> (dim it splits on, by heads)
_SPLIT = {
    "attn.qkv.weight": (0, True), "attn.qkv.bias": (0, True),
    "mlp.lin1.weight": (0, False), "mlp.lin1.bias": (0, False),
    "attn.proj.weight": (1, False), "mlp.lin2.weight": (1, False),
}
#: the gradient all-reduce's bucket size (DDP's default)
BUCKET_BYTES = 25 * 1024 * 1024


def _dist():
    import torch.distributed as dist
    return dist


class ModelShard(NamedTuple):
    """What a split encoder block needs of the mesh: its model group, the
    group's size and this rank's place in it."""
    group: object
    size: int
    rank: int


class Mesh:
    """This rank's place on a ("data", "model") mesh: ``shape`` {"data": d,
    "model": m}, ``data_index`` / ``model_index``, the process groups of its
    data row (``data_group``: the ranks of its model index) and of its model
    column (``model_group``), the whole ``world`` (None for the 1 x 1 mesh of a
    process outside any process group: then no collective runs), the global
    ``ranks`` in mesh order, the ``backend`` and the ``device``."""

    def __init__(self, shape: Dict[str, int], data_index: int, model_index: int, world,
                 data_group, model_group, device: torch.device, ranks: List[int],
                 backend: Optional[str]):
        self.shape = dict(shape)
        self.data_index = data_index
        self.model_index = model_index
        self.world = world
        self.data_group = data_group
        self.model_group = model_group
        self.device = device
        self.ranks = list(ranks)
        self.backend = backend

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    @property
    def rank(self) -> int:
        """This rank's index on the mesh (0 is the one that writes files)."""
        return self.data_index * self.shape["model"] + self.model_index

    @property
    def model_shard(self) -> Optional[ModelShard]:
        m = self.shape["model"]
        return ModelShard(self.model_group, m, self.model_index) if m > 1 else None

    def barrier(self) -> None:
        if self.world is not None:
            _dist().barrier(group=self.world)

    def broadcast_object(self, obj):
        """``obj`` of mesh rank 0 on every rank."""
        if self.world is None:
            return obj
        box = [obj]
        _dist().broadcast_object_list(box, src=self.ranks[0], group=self.world)
        return box[0]

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, data_index={self.data_index}, "
                f"model_index={self.model_index}, backend={self.backend}, device={self.device})")


def _rank_device(rank: int, device=None) -> torch.device:
    """The device of global rank ``rank``: ``device`` when the caller names one
    (``"cpu"`` for the CPU), else cuda:(LOCAL_RANK, or rank % the devices)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the mesh on the CPU.")
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local is not None
                        else rank % torch.cuda.device_count())


def mesh_layout(n: int, model_axis: int = 1) -> List[List[int]]:
    """The ranks 0..n-1 on the (n // model_axis, model_axis) mesh, row by row
    (JAX's ``make_mesh`` reshape of its device list)."""
    if n % model_axis:
        raise ValueError(f"{n} ranks not divisible by model axis {model_axis}")
    return [list(range(i * model_axis, (i + 1) * model_axis)) for i in range(n // model_axis)]


def make_mesh(world=None, model_axis: int = 1, device=None) -> Mesh:
    """Mesh with ("data", "model") axes over the ranks of ``world`` (default:
    the default process group). Without a process group, the 1 x 1 mesh of
    the calling process. Every rank of the default group calls it, in the
    same order as its other ``new_group`` calls. Raises when the world is not
    a multiple of ``model_axis``, and on NCCL when two ranks share a device
    (NCCL takes one rank a device; use gloo there)."""
    dist = _dist()
    model_axis = max(1, int(model_axis))
    if world is None and not (dist.is_available() and dist.is_initialized()):
        if model_axis != 1:
            raise ValueError(f"1 rank is not divisible by model axis {model_axis}")
        return Mesh({"data": 1, "model": 1}, 0, 0, None, None, None, _rank_device(0, device),
                    [0], None)
    group = dist.group.WORLD if world is None else world
    ranks = dist.get_process_group_ranks(group)
    n = len(ranks)
    rows = mesh_layout(n, model_axis)
    me = dist.get_rank()
    d = n // model_axis
    data_index, model_index = divmod(ranks.index(me), model_axis)
    data_group = model_group = None
    for j in range(model_axis):  # every rank creates every group, in one order
        g = dist.new_group([ranks[row[j]] for row in rows])
        if j == model_index:
            data_group = g
    for i, row in enumerate(rows):
        g = dist.new_group([ranks[r] for r in row])
        if i == data_index:
            model_group = g
    backend = str(dist.get_backend(group))
    dev = _rank_device(me, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend == "nccl":
        devices = [None] * n
        dist.all_gather_object(devices, str(dev), group=group)
        if len(set(devices)) < n:
            raise ValueError(f"NCCL takes one rank a device, but the ranks are on {devices}; "
                             "run two ranks on one device over gloo")
    return Mesh({"data": d, "model": model_axis}, data_index, model_index, group, data_group,
                model_group, dev, ranks, backend)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_reduce_f32(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` in float32 (a new tensor); ``t`` as
    float32 when ``group`` is None."""
    acc = t.to(torch.float32, copy=True)
    if group is not None:
        _dist().all_reduce(acc, group=group)
    return acc


def all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors of one shape, concatenated on dim 0 in rank order."""
    if group is None:
        return t
    dist = _dist()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """``all_gather_cat`` for tensors whose dim 0 differs between ranks: the
    counts first, each tensor padded to the largest, trimmed after."""
    if group is None:
        return t
    dist = _dist()
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    counts = [torch.empty_like(n) for _ in range(dist.get_world_size(group))]
    dist.all_gather(counts, n, group=group)
    counts = [int(c) for c in counts]
    top = max(counts)
    if top > t.shape[0]:
        t = torch.cat([t, t.new_zeros((top - t.shape[0],) + tuple(t.shape[1:]))])
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in counts]
    dist.all_gather(parts, t, group=group)
    return torch.cat([p[:c] for p, c in zip(parts, counts)])


class CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce (float32) backward over a group (the model
    group in the encoder): before a product split on its output rows, and on
    what every head's attention reads (the rel-pos tables)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_f32(g, ctx.group).to(g.dtype), None


class ReduceFromModel(torch.autograd.Function):
    """All-reduce forward over a group (summed in float32; the sum is
    float32), identity backward: after a product split on its input columns
    (the model group), and on a loss's batch sums (the data group)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        return all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def all_reduce_gradients_(params: Iterable[torch.Tensor], group, op: str = "mean") -> int:
    """All-reduce the gradients of ``params`` over ``group`` (``op`` "mean" or
    "sum"), flattened into float32 buckets of about ``BUCKET_BYTES``. A
    missing gradient counts as zeros where another rank has one, and stays
    missing where no rank has one (so AdamW leaves that parameter alone, as
    in one process). Returns the bytes reduced."""
    if group is None:
        return 0
    if op not in ("mean", "sum"):
        raise ValueError(f"unknown op {op!r}")
    dist = _dist()
    size = dist.get_world_size(group)
    params = [p for p in params if p.requires_grad]
    moved = 0
    start = 0
    while start < len(params):
        stop, nbytes = start, 0
        while stop < len(params) and (stop == start or nbytes + 4 * params[stop].numel()
                                      <= BUCKET_BYTES):
            nbytes += 4 * params[stop].numel()
            stop += 1
        chunk = params[start:stop]
        has = torch.tensor([float(p.grad is not None) for p in chunk], device=chunk[0].device)
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                          .reshape(-1).float() for p in chunk] + [has])
        dist.all_reduce(flat, group=group)
        if op == "mean":
            flat[:-len(chunk)] /= size
        at = 0
        for p, n_have in zip(chunk, flat[-len(chunk):].tolist()):
            g = flat[at:at + p.numel()].view_as(p).to(p.dtype)
            at += p.numel()
            if n_have == 0:
                continue
            if p.grad is None:
                p.grad = g.clone()
            else:
                p.grad.copy_(g)
        moved += flat.numel() * 4
        start = stop
    return moved


# ---------------------------------------------------------------------------
# the sharding of a SAM
# ---------------------------------------------------------------------------

def split_rule(name: str, config=None) -> Optional[Tuple[int, bool]]:
    """How state-dict entry ``name`` splits over the model axis: (dim, by
    heads), or None where it is replicated (``_spec_for_path`` of the JAX
    package, in the port's (out, in) weight layout). A TinyViT (vit_t) stays
    whole: its chains are not split."""
    if config is not None and getattr(config, "encoder", "vit") != "vit":
        return None
    if not name.startswith("image_encoder.blocks."):
        return None
    for suffix, rule in _SPLIT.items():
        if name.endswith("." + suffix):
            return rule
    return None


def shard_tensor(t: torch.Tensor, rule: Tuple[int, bool], size: int, index: int) -> torch.Tensor:
    """Shard ``index`` of ``size`` of ``t`` under ``rule``; by heads, the q, k
    and v rows of the shard's heads, in that order."""
    dim, by_heads = rule
    if by_heads:
        parts = t.reshape(3, t.shape[0] // 3, *t.shape[1:]).chunk(size, dim=1)[index]
        return parts.reshape(-1, *t.shape[1:]).contiguous()
    return t.chunk(size, dim=dim)[index].contiguous()


def unshard_tensor(parts: List[torch.Tensor], rule: Tuple[int, bool]) -> torch.Tensor:
    """The whole tensor from its shards in rank order (``shard_tensor``'s inverse)."""
    dim, by_heads = rule
    if by_heads:
        thirds = [p.reshape(3, p.shape[0] // 3, *p.shape[1:]) for p in parts]
        whole = torch.cat(thirds, dim=1)
        return whole.reshape(-1, *whole.shape[2:])
    return torch.cat(parts, dim=dim)


def _refuse_peft(sam) -> None:
    from ..models.common import Linear
    enc = sam.image_encoder
    peft = getattr(enc, "fact_u", None) is not None
    for blk in enc.blocks:
        peft |= blk.attn.lora is not None or blk.attn.fact is not None
        peft |= blk.mlp.adapter is not None
        peft |= blk.adapter_pre is not None or blk.adapter_post is not None
        for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.lin1, blk.mlp.lin2):
            assert isinstance(lin, Linear)
            peft |= lin.lora is not None or lin.ssf_scale is not None or lin.quantized
    if peft:
        raise NotImplementedError("PEFT and int4 encoder blocks are not split over a model "
                                  "axis; run them on the data axis (model_axis=1)")


def shard_sam_(sam, mesh: Mesh):
    """Keep this rank's shard of each split encoder tensor, in place (the
    Parameters stay the same objects, so an optimizer made before still
    holds them), and hand each block the model group (``Block.tp``).
    ``sam_param_shardings`` + ``device_put`` of the JAX package. A vit_t, or
    a mesh whose model axis is 1, stays whole. Raises when the heads or the
    MLP width do not divide by the model axis, for a PEFT / int4 encoder
    under a model axis, and for a SAM already split."""
    m = mesh.shape["model"]
    cfg = sam.config
    if m == 1 or cfg.encoder != "vit":
        return sam
    enc = sam.image_encoder
    if any(blk.tp is not None for blk in enc.blocks):
        raise ValueError("this SAM is already split over a model axis")
    hidden = enc.blocks[0].mlp.lin1.out_features
    if enc.num_heads % m or hidden % m:
        raise ValueError(f"{enc.num_heads} heads and an MLP of {hidden} must both divide by "
                         f"the model axis {m}")
    _refuse_peft(sam)
    for name, p in sam.named_parameters():
        rule = split_rule(name, cfg)
        if rule is not None:
            p.data = shard_tensor(p.data, rule, m, mesh.model_index)
    for blk in enc.blocks:
        blk.tp = mesh.model_shard
    return sam


def shard_params(state_dict: Dict[str, torch.Tensor], mesh: Mesh, config=None
                 ) -> Dict[str, torch.Tensor]:
    """This rank's shards of a whole state dict (a checkpoint, the output of
    ``params_from_jax``), under ``split_rule``."""
    m = mesh.shape["model"]
    if m == 1:
        return dict(state_dict)
    out = {}
    for k, v in state_dict.items():
        rule = split_rule(k, config)
        out[k] = v if rule is None else shard_tensor(v, rule, m, mesh.model_index)
    return out


def gather_tensors(named: Dict[str, torch.Tensor], mesh: Mesh, config=None
                   ) -> Dict[str, torch.Tensor]:
    """Whole tensors from this rank's shards of state-dict entries (``named``:
    name -> shard, e.g. the parameters or their gradients), under
    ``split_rule``: a collective over the model group, every rank calls it."""
    if mesh.shape["model"] == 1:
        return dict(named)
    dist = _dist()
    out = {}
    for k, v in named.items():
        rule = split_rule(k, config)
        if rule is None:
            out[k] = v
            continue
        v = v.contiguous()
        parts = [torch.empty_like(v) for _ in range(mesh.shape["model"])]
        dist.all_gather(parts, v, group=mesh.model_group)
        out[k] = unshard_tensor(parts, rule)
    return out


def gather_state_dict(sam, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The whole state dict of a SAM split over ``mesh``'s model axis, under
    the single-process keys (a collective over the model group)."""
    split = any(getattr(b, "tp", None) is not None  # a TinyViT's blocks are never split
                for b in getattr(sam.image_encoder, "blocks", ()))
    sd = sam.state_dict()
    return gather_tensors(sd, mesh, sam.config) if split else sd
