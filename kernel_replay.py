"""Time the ViT kernels of one encode and of one vit_b training step,
replayed back to back, for one or more checkouts of this repository, each in
its own process and in the order given, so that two versions of a kernel are
compared on one card:

    python3 kernel_replay.py OLD NEW NEW OLD [--model vit_b|vit_h|vit_t] [--out FILE]
    python3 kernel_replay.py OLD NEW NEW OLD --gemm-shapes [--out FILE]
    python3 kernel_replay.py OLD NEW NEW OLD --dwconv-shapes [--out FILE]
    python3 kernel_replay.py OLD NEW NEW OLD --layernorm-shapes [--out FILE]
    python3 kernel_replay.py OLD NEW NEW OLD --tiny-attention-shapes [--out FILE]
    python3 kernel_replay.py . --gemm-plans [--out FILE]
    python3 kernel_replay.py . --dwconv-plans [--out FILE]
    python3 kernel_replay.py . --layernorm-plans [--out FILE]
    python3 kernel_replay.py . --tiny-attention-plans [--out FILE]
    python3 kernel_replay.py OLD NEW NEW OLD --encode [--model ...] [--out FILE]
    python3 kernel_replay.py OLD NEW NEW OLD --train-step [--out FILE]

Each argument is the root of a checkout (``.`` for this one). Its process
imports that checkout's ``micro_sam_tpu_torch`` and builds its kernels into
that checkout's ``build/``. The encode replay records the ``layernorm`` /
``gemm`` / ``relpos_attention`` launches of one batch-1 1024 x 1024 encode of
``--model`` (default vit_b; bf16, random weights from seed 0, a random image
from seed 0) through the encoder's default route (vit_t: the ``dwconv``,
``layernorm``, ``gemm`` and ``tiny_attention`` launches of its MBConv,
attention and tail chains); with vit_b, the step
replay records the
``relpos_attention`` (K1, with the checkpoint recompute) and
``relpos_attention_backward`` (K4) calls of one vit_b ``forward_train`` and
its backward (batch 2 of 1024 x 1024, bf16 compute, f32 weights from seed 0,
random pixels and upstream gradient from seed 0), as a training step makes
them. Each kernel's calls are replayed back to back: device time from
torch.profiler (CUPTI), by the ``time_ms`` of the ``chip_smoke.py`` beside
this script, the mean of 20 runs (10 for the step), taken ``REPS`` times.
Prints the card's name and power limit, one JSON line per checkout and the
median of each kernel per checkout (``ms`` per encode, ``step_ms`` per
step); ``--out`` writes all of it to a JSON file. ``--gemm-shapes`` replaces
both replays by the bf16 ``gemm`` at every distinct shape of the vit_b,
vit_l, vit_h and vit_t encodes (``gemm_sweep`` of ``chip_smoke.py``: held
against the plain version, timed with ``F.linear`` + epilogue, the bound and
the plan) and the host microseconds a ``gemm`` call costs (``host_us``);
``--gemm-plans`` times the vit_b, vit_h and vit_t shapes under every plan the
kernel takes (``plan_sweep``), for tuning ``gemm_plan``. ``--dwconv-shapes``
replaces the replays by the bf16 ``dwconv`` at each depthwise shape of the
vit_t encode (``dwconv_sweep`` of ``chip_smoke.py``: held against the plain
version, timed with cuDNN's depthwise convolution, the bound), and sums them
per encode; ``--dwconv-plans`` times those shapes under tiles of 128 and 256
threads and 4 to 32 rows (``dwconv_plan_sweep``), for tuning ``dwconv_plan``.
``--layernorm-shapes`` replaces the replays by the bf16 ``layernorm`` at
every shape of the vit_b, vit_l, vit_h and vit_t encodes and K9's grid-mode
shapes (``layernorm_sweep``: against plain, timed with ``F.layer_norm``, the
bound and the plan), ``--tiny-attention-shapes`` by the bf16
``tiny_attention`` at the three vit_t stages (``tiny_attention_sweep``:
timed with SDPA on the gathered bias); each with the host microseconds a
call costs (``host_us``) and the sums per encode. ``--layernorm-plans`` and
``--tiny-attention-plans`` time those shapes under other grids (and, for
``tiny_attention``, other heads a unit), for tuning ``layernorm_plan`` and
``tiny_attention_plan``.
``--encode`` times, instead of any kernel, ``SamPredictor.encode_batch`` of
``--model`` on a host clock that ends in a synchronize (1024 x 1024 pixels
at batch 1 and 8, ``ENCODE_REPS`` runs after two warm-ups, the median per
image): the serving metric with the host's work in it. ``--train-step``
times vit_b ``JointSamTrainer`` steps at train_sam's defaults (batch 2 of
phase 6's 512 x 512 patches, 25 objects, 8 rounds, bf16 compute, f32
weights from seed 0), each split as phase 14 splits it into the SAM step
(phase 6's step) and the decoder step: host clock (the card synchronized)
and device busy time (torch.profiler) per step. In a checkout whose models
have the repeatable forms (``models/common.py::conv2d_nchw``) it also times
them undone one at a time in the same process (``plain_forms``:
``F.interpolate``, cuDNN's transposed and stride-1 convolutions), the
variants taken in turns, and prints the kernels whose device time differs
most between all forms and none. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

REPS = 5
KNOBS = ("MSAM_TPU_SPATIAL_WINDOW", "MSAM_TPU_WINDOW_STACK")


def smoke_module():
    """The chip_smoke.py beside this script (its ``time_ms`` and gemm sweep):
    one timer for both scripts, loaded before a checkout's root goes on the
    path."""
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(here, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# the sweeps that replace the replays, one flag each (a child runs one)
SWEEPS = ("gemm-shapes", "gemm-plans", "dwconv-shapes", "dwconv-plans", "layernorm-shapes",
          "layernorm-plans", "tiny-attention-shapes", "tiny-attention-plans", "encode",
          "train-step")
ENCODE_REPS = 10


def sweep_child(root: str, smoke, sweep: str) -> dict:
    import torch
    from micro_sam_tpu_torch.ops import _cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.build()
    smoke.time_ms(lambda: torch.ones(1024, device="cuda").add_(1), iters=2, warmup=1)
    out = {"root": root, "kernels": _cuda.build_dir()}
    if sweep == "dwconv-shapes":
        out["shapes"] = {"vit_t": smoke.dwconv_sweep()}
    elif sweep == "dwconv-plans":
        out["plans"] = dwconv_plan_sweep(smoke)
    elif sweep == "gemm-plans":
        out["plans"] = {m: plan_sweep(smoke, m) for m in PLAN_MODELS}
    elif sweep == "layernorm-shapes":
        out["host_us"] = smoke.host_us("layernorm")
        out["shapes"] = {m: smoke.layernorm_sweep(m) for m in smoke.LAYERNORM_SHAPES}
    elif sweep == "tiny-attention-shapes":
        out["host_us"] = smoke.host_us("tiny_attention")
        out["shapes"] = {"vit_t": smoke.tiny_attention_sweep()}
    elif sweep == "layernorm-plans":
        out["plans"] = layernorm_plan_sweep(smoke)
    elif sweep == "tiny-attention-plans":
        out["plans"] = tiny_attention_plan_sweep(smoke)
    else:
        out["host_us"] = smoke.host_us("gemm")
        out["shapes"] = {model: smoke.gemm_sweep(model) for model in smoke.GEMM_SHAPES}
    return out


PLAN_MODELS = ("vit_b", "vit_h", "vit_t")


def timed_plans(smoke, name, label, run, ref, picked, cands) -> dict:
    """Each plan of ``cands`` (with ``picked``) held against ``ref`` and timed;
    one row: ms per plan, the picked one and the best."""
    ms = {}
    for p in sorted(set(cands) | {picked}):
        smoke.check(f"{name} {label} {p}", run(p), ref, "bfloat16", quiet=True)
        ms[str(tuple(p))] = smoke.time_ms(lambda: run(p))
    best = min(ms, key=ms.get)
    print(f"  {name} {label}: picked {tuple(picked)} {ms[str(tuple(picked))]:.4f} ms; best "
          f"{best} {ms[best]:.4f} ms", flush=True)
    return {"shape": label, "ms": ms, "picked": str(tuple(picked)), "best": best}


def dwconv_plan_sweep(smoke) -> list:
    """The bf16 dwconv at each depthwise shape of the vit_t encode under
    tiles of 128 and 256 threads, 4 to 32 rows (the TMA body), each run held
    against the plain version; one row per shape: ms per tile and the tile
    ``dwconv_plan`` picks."""
    import torch
    from micro_sam_tpu_torch.ops.dwconv import dwconv, dwconv_plain, dwconv_plan
    g = torch.Generator().manual_seed(6)
    rows = []
    for label, H, W, C, gelu, n in smoke.DWCONV_SHAPES:
        x = torch.randn(1, H, W, C, generator=g).to("cuda", torch.bfloat16)
        w = (torch.randn(C, 1, 3, 3, generator=g) / 3).to("cuda")
        s, t = (torch.rand(C, generator=g) + 0.5).cuda(), (torch.randn(C, generator=g) * 0.1).cuda()
        picked = dwconv_plan(1, H, W, C, 2)
        cands = []
        for threads in (128, 256):
            for th in (4, 8, 16, 32):
                tw = min(W, 128, threads // (picked.ct // picked.vec))
                slot = -(-(th + 2) * (tw + 2) * picked.ct * 2 // 128) * 128
                if 2 * slot + 144 <= 232448:  # two halo slots within a block's shared memory
                    cands.append(picked._replace(th=min(th, H), tw=tw))
        rows.append(timed_plans(smoke, "dwconv", f"{label} (1, {H}, {W}, {C})",
                                lambda p: dwconv(x, w, s, t, gelu, plan=p),
                                dwconv_plain(x.float(), w, s, t, gelu), picked, cands))
        rows[-1]["launches_per_encode"] = n
    return rows


def layernorm_plan_sweep(smoke) -> list:
    """The bf16 layernorm at each vit_b / vit_h / vit_t shape under persistent
    grids of 1 to 4 blocks an SM and a block per 8 row groups."""
    import torch
    from micro_sam_tpu_torch.ops.layernorm import WARPS, layernorm, layernorm_plain, layernorm_plan
    g = torch.Generator().manual_seed(7)
    rows = []
    for model in ("vit_b", "vit_h", "vit_t"):
        for label, M, C, mask, _ in smoke.LAYERNORM_SHAPES[model]:
            x = (torch.randn(M, C, generator=g) * 3).to("cuda", torch.bfloat16)
            w, b = (torch.rand(C, generator=g) + 0.5).cuda(), torch.randn(C, generator=g).cuda()
            ref = layernorm_plain(x.float(), w, b, 1e-6)
            picked = layernorm_plan(M, C, 2, 16)
            groups = -(-M // picked.rows_per_warp)
            most = -(-groups // WARPS)
            cands = [picked._replace(grid=min(most, 132 * k)) for k in (1, 2, 3, 4)]
            cands.append(picked._replace(grid=most))
            rows.append(timed_plans(smoke, "layernorm", f"{model} {label}",
                                    lambda p: layernorm(x, w, b, 1e-6, plan=p), ref, picked,
                                    cands))
    return rows


def tiny_attention_plan_sweep(smoke) -> list:
    """The bf16 tiny_attention at the three vit_t stages, batch 1 and 8, under
    every heads a unit that fits and persistent grids of 1 to 8 blocks an SM
    (and a block per unit)."""
    import torch
    from micro_sam_tpu_torch.ops.tiny_attention import (MAX_WARPS, TinyAttentionPlan,
                                                        blocks_per_sm, smem_bytes,
                                                        tiny_attention, tiny_attention_plain,
                                                        tiny_attention_plan)
    g = torch.Generator().manual_seed(8)
    rows = []
    for B in (1, 8):
        for Hp, C, nH, w, st in smoke.TINY_ATTN_SHAPES:
            qkv = torch.randn(B * Hp * Hp, 3 * C, generator=g).to("cuda", torch.bfloat16)
            table = (torch.randn(nH, w * w, generator=g) * 0.5).cuda()
            ref = tiny_attention_plain(qkv.float(), table, (B, Hp, Hp), w)
            picked = tiny_attention_plan(B, Hp, Hp, C, nH, w)
            groups = -(-w * w // 16)
            cands = []
            for heads in (d for d in range(1, nH + 1) if nH % d == 0):
                if heads * groups > MAX_WARPS[w]:
                    continue
                units = B * (Hp // w) ** 2 * nH // heads
                per_sm = blocks_per_sm(w, heads, nH)
                for grid in {min(units, 132 * k) for k in range(1, per_sm + 1)} | {units}:
                    cands.append(TinyAttentionPlan(heads, heads * groups, units, grid, 2,
                                                   smem_bytes(w, heads, nH), per_sm))
            rows.append(timed_plans(smoke, "tiny_attention", f"stage {st} batch {B}",
                                    lambda p: tiny_attention(qkv, table, (B, Hp, Hp), w, plan=p),
                                    ref, picked, cands))
    return rows


def plan_sweep(smoke, model) -> list:
    """The bf16 gemm at each distinct shape of ``model``'s encode under the
    plans the kernel takes: 256-wide tiles split between the warpgroups,
    128-wide tiles split or (without a GELU) taken in turns, each at ring
    depths 3 to the most that fits, on the persistent grid (at most one block
    an SM), and the split plans at their default depth with a block per
    tile; each run held against the plain version. One row per shape: ms per
    plan, and the plan ``gemm_plan`` picks."""
    import torch
    from micro_sam_tpu_torch.ops.gemm import (STAGES, GemmPlan, gemm, gemm_plain, gemm_plan,
                                              max_stages)
    g = torch.Generator().manual_seed(5)
    rows = []
    for label, M, N, K, epi, n in smoke.GEMM_SHAPES[model]:
        rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to("cuda",
                                                                             torch.bfloat16)
        x, w, b = rnd(M, K), rnd(N, K, scale=K ** -0.5), torch.zeros(N, device="cuda")
        r = rnd(M, N) if epi.startswith("residual") else None
        ref = gemm_plain(x.float(), w.float(), b, epi, None if r is None else r.float())
        cands = []
        for bn, turns in ((256, False), (128, False), (128, True)):
            if turns and "gelu" in epi:  # the kernel takes no GELU in turns
                continue
            tiles = -(-M // 128) * -(-N // bn)
            cands += [GemmPlan(bn, st, min(tiles, 132), tiles, turns)
                      for st in range(3, max_stages(bn) + 1)]
            if not turns:  # a block per tile
                cands.append(GemmPlan(bn, STAGES[bn], tiles, tiles))
        ms = {}
        for p in cands:
            smoke.check(f"gemm {model} {label} {p}", gemm(x, w, b, epi, r, plan=p), ref,
                        "bfloat16", quiet=True)
            ms[str(p)] = smoke.time_ms(lambda: gemm(x, w, b, epi, r, plan=p))
        best = min(ms, key=ms.get)
        picked = str(gemm_plan(M, N, K, epi))
        rows.append({"shape": f"{label} ({M}x{K})({K}x{N}) {epi}", "launches_per_encode": n,
                     "ms": ms, "picked": picked, "best": best})
        print(f"  {model} {rows[-1]['shape']}: picked {picked} {ms[picked]:.4f} ms; best {best} "
              f"{ms[best]:.4f} ms", flush=True)
    return rows


# the chain modules whose kernel tables an encode of each model is recorded through
RECORDED = {"vit_t": ("fused_mbconv", "fused_tiny_attention", "fused_tiny_tail")}
REPLAYED = {"vit_t": ("dwconv", "layernorm", "gemm", "tiny_attention")}


def child(root: str, model: str, sweep: str = "") -> dict:
    root = os.path.abspath(root)
    smoke = smoke_module()
    device_ms = smoke.time_ms
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import micro_sam_tpu_torch
    pkg = os.path.dirname(os.path.abspath(micro_sam_tpu_torch.__file__))
    if pkg != os.path.join(root, "micro_sam_tpu_torch"):
        raise RuntimeError(f"imported {pkg}, not the package of {root}")
    if sweep == "encode":
        return encode_child(root, model)
    if sweep == "train-step":
        return train_step_child(root, smoke)
    if sweep:
        return sweep_child(root, smoke, sweep)
    import importlib
    from micro_sam_tpu_torch.ops import _cuda
    from micro_sam_tpu_torch.util import _to_image, get_sam_model
    for k in KNOBS:
        os.environ.pop(k, None)
    rng = np.random.RandomState(0)
    x1 = _to_image(rng.randint(0, 256, size=(1024, 1024)).astype(np.uint8))[None]
    predictor = get_sam_model(model, seed=0)
    predictor.encode_batch(x1.astype(np.float32))  # builds the kernels
    torch.cuda.synchronize()
    calls = []
    modules = [importlib.import_module(f"micro_sam_tpu_torch.ops.{n}")
               for n in RECORDED.get(model, ("fused_window_block",))]
    saved = [m._KERNELS for m in modules]

    def wrap(fn):
        def call(*a, **kw):
            calls.append((fn.__name__, fn, a, kw))
            return fn(*a, **kw)
        return call
    for m, kernels in zip(modules, saved):
        m._KERNELS = tuple(wrap(f) for f in kernels)
    try:
        predictor.encode_batch(x1.astype(np.float32))
    finally:
        for m, kernels in zip(modules, saved):
            m._KERNELS = kernels
    torch.cuda.synchronize()
    out = {"root": root, "model": model, "kernels": _cuda.build_dir(), "launches": {}, "ms": {}}
    for name in REPLAYED.get(model, ("layernorm", "gemm", "relpos_attention")):
        mine = [c for c in calls if c[0] == name]
        out["launches"][name] = len(mine)
        out["ms"][name] = [device_ms(lambda: [fn(*a, **kw) for _, fn, a, kw in mine])
                           for _ in range(REPS)]
    del calls, predictor
    if model == "vit_b":
        out.update(step_replay(device_ms))
    return out


def encode_child(root: str, model: str) -> dict:
    """Host-clock ms per image of ``encode_batch`` at batch 1 and 8 (median of
    ``ENCODE_REPS`` after two warm-ups), bf16, random weights from seed 0."""
    import time
    import numpy as np
    import torch
    from micro_sam_tpu_torch.util import _to_image, get_sam_model
    for k in KNOBS:
        os.environ.pop(k, None)
    x1 = _to_image(np.random.RandomState(0).randint(0, 256, size=(1024, 1024))
                   .astype(np.uint8))[None].astype(np.float32)
    predictor = get_sam_model(model, seed=0)
    out = {"root": root, "model": model, "encode_ms": {}}
    for bs in (1, 8):
        x = np.repeat(x1, bs, axis=0)
        for _ in range(2):
            predictor.encode_batch(x)
        torch.cuda.synchronize()
        ts = []
        for _ in range(ENCODE_REPS):
            t0 = time.perf_counter()
            predictor.encode_batch(x)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3 / bs)
        out["encode_ms"][str(bs)] = statistics.median(ts)
        out.setdefault("all_ms", {})[str(bs)] = ts
    return out


STEP_ROUNDS, STEP_REPS = 2, 3


def plain_forms() -> dict:
    """The forms that ``models/common.py``'s repeatable rewrites replaced, by
    rewrite: ``F.interpolate`` for the bilinear resizes, cuDNN's transposed
    convolution (kernel == stride) and cuDNN's stride-1 convolution, each a
    tuple of (object, attribute, replacement)."""
    import torch.nn.functional as F
    from micro_sam_tpu_torch.models import common, unetr
    from micro_sam_tpu_torch.training import joint_sam_trainer, sam_trainer, trainable_sam

    def cast(x, t):
        return None if t is None else t.to(x.dtype)

    def resize(x, out_hw, antialias=True):
        if tuple(x.shape[-2:]) == tuple(out_hw):
            return x
        down = out_hw[0] < x.shape[-2] or out_hw[1] < x.shape[-1]
        return F.interpolate(x, tuple(out_hw), mode="bilinear", align_corners=False,
                             antialias=down and antialias)

    def upsample2x(x):
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)

    def conv_transpose2d(x, weight, bias=None, stride=2):
        return F.conv_transpose2d(x.permute(0, 3, 1, 2), cast(x, weight), cast(x, bias),
                                  stride=stride).permute(0, 2, 3, 1)

    def conv_transpose(x, weight, bias, stride):
        return F.conv_transpose2d(x, cast(x, weight), cast(x, bias), stride=stride)

    def conv2d_forward(self, x):
        return common.conv2d(x, self.weight, self.bias, self.stride[0], self.padding[0],
                             self.groups)

    def conv(x, weight, bias, padding):
        return F.conv2d(x, cast(x, weight), cast(x, bias), padding=padding)

    return {"resize": ((trainable_sam, "resize_bilinear", resize),
                       (sam_trainer, "resize_bilinear", resize),
                       (joint_sam_trainer, "resize_bilinear", resize),
                       (unetr, "upsample2x", upsample2x)),
            "conv_transpose": ((common, "conv_transpose2d", conv_transpose2d),
                               (unetr, "conv_transpose", conv_transpose)),
            "conv": ((common.Conv2d, "forward", conv2d_forward), (unetr, "conv", conv))}


class Swapped:
    """Puts the plain forms of the rewrites ``names`` in place, and back."""

    def __init__(self, forms, names):
        self.patches = [p for n in names for p in forms[n]]

    def __enter__(self):
        self.saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in self.patches]
        for obj, attr, new in self.patches:
            setattr(obj, attr, new)

    def __exit__(self, *exc):
        for obj, attr, old in self.saved:
            setattr(obj, attr, old)


def device_kernels(fn) -> tuple:
    """(host ms, {kernel name: device ms}) of ``fn()`` under torch.profiler."""
    import time
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, {e.key[:120]: e.self_device_time_total / 1e3 for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0}


def train_step_child(root: str, smoke) -> dict:
    """``--train-step``: vit_b JointSamTrainer steps, the SAM step and the
    decoder step timed apart (host clock, the card synchronized; device busy
    from one profiled step of each), under every variant of the rewrites in
    turns: STEP_ROUNDS rounds of STEP_REPS timed steps and one profiled step
    a part, after a warm-up of each variant; with the warm-up, whether each
    variant's gradients of one step repeat bit for bit (``repeats``)."""
    import time
    import numpy as np
    import torch
    from micro_sam_tpu_torch.instance_segmentation import get_unetr
    from micro_sam_tpu_torch.models import common
    from micro_sam_tpu_torch.ops import _cuda
    from micro_sam_tpu_torch.training import JointSamTrainer, get_trainable_sam_model
    from micro_sam_tpu_torch.training.joint_sam_trainer import unetr_loss
    _cuda.build()
    imgs, segs = smoke.training_data()
    batches = list(smoke.joint_loaders(imgs, segs)[0])
    model = get_trainable_sam_model("vit_b", device="cuda", seed=0)
    trainer = JointSamTrainer("timing", None, None, model, unetr=get_unetr(device="cuda"),
                              n_sub_iteration=8, n_objects_per_batch=25, lr=1e-5, logger=False)
    prepared = []
    for i, (x, y, t) in enumerate(batches):
        choice = trainer._get_prompt_and_multimasking_choices(i)
        prepared.append((trainer._prepare_batch(x, y, *choice[:2], *choice[3:], batch_idx=i),
                         choice, t))

    def sam_step(i):
        b, (use_points, use_box, multimask, _, _), _ = prepared[i % len(prepared)]
        with torch.enable_grad():
            trainer.train_step(b, use_points, use_box, multimask)
        torch.cuda.synchronize()

    def decoder_step(i):
        b, _, t = prepared[i % len(prepared)]
        trainer.instance_step(b[0], t)
        torch.cuda.synchronize()

    def grads(params, loss_fn):
        """Each parameter's gradient of ``loss_fn()``, the trainer's generator
        put back first: the same draws every time."""
        trainer.generator.set_state(gen_state)
        for p in params:
            p.grad = None
        with torch.enable_grad():
            loss_fn().backward()
        return [p.grad.clone() for p in params if p.grad is not None]

    def sam_loss():
        b, (use_points, use_box, multimask, _, _), _ = prepared[0]
        return trainer._loss(*b, use_points, use_box, multimask)[0]

    def decoder_loss():
        b, _, t = prepared[0]
        with torch.no_grad():
            feats = model.image_embeddings_oft(b[0])
        t = torch.as_tensor(np.asarray(t)[:, -3:], dtype=torch.float32).to(feats.device)
        return unetr_loss(trainer.unetr, feats, t)

    def repeats() -> dict:
        """Of STEP_REPS gradient computations from the same weights and draws,
        the tensors that differ from the first's, per part."""
        out = {}
        for part, params, fn in (("sam", list(model.sam.parameters()), sam_loss),
                                 ("decoder", list(trainer.unetr.parameters()), decoder_loss)):
            first = grads(params, fn)
            out[part] = [sum(not torch.equal(a, b) for a, b in zip(first, grads(params, fn)))
                         for _ in range(STEP_REPS - 1)] + [len(first)]
        return out

    gen_state = trainer.generator.get_state()
    repeatable = hasattr(common, "conv2d_nchw")
    forms = plain_forms() if repeatable else {}
    variants = {"as is": ()}
    if repeatable:
        variants.update({f"{n} undone": (n,) for n in forms})
        variants["all undone"] = tuple(forms)
    out = {"root": root, "repeatable_forms": repeatable, "variants": {}}
    for name, undo in variants.items():  # warm-up: each form's first call
        with Swapped(forms, undo):
            for i in range(len(prepared)):
                sam_step(i)
                decoder_step(i)
            differ = repeats()
        print(f"  {name}: gradient tensors differing from the first of {STEP_REPS} computations "
              f"(the last number: tensors compared): {differ}", flush=True)
        out["variants"][name] = {"sam_ms": [], "decoder_ms": [], "sam_busy_ms": [],
                                 "decoder_busy_ms": [], "differing_gradients": differ}
    for r in range(STEP_ROUNDS):
        for name, undo in variants.items():
            row = out["variants"][name]
            with Swapped(forms, undo):
                for part, fn in (("sam", sam_step), ("decoder", decoder_step)):
                    for i in range(STEP_REPS):
                        t0 = time.perf_counter()
                        fn(i)
                        row[f"{part}_ms"].append((time.perf_counter() - t0) * 1e3)
                    _, kernels = device_kernels(lambda: fn(r))
                    row[f"{part}_busy_ms"].append(sum(kernels.values()))
                    row[f"{part}_kernels"] = kernels
            print(f"  round {r} {name}: SAM step {row['sam_ms'][-STEP_REPS:]} ms (device busy "
                  f"{row['sam_busy_ms'][-1]:.3f}), decoder step {row['decoder_ms'][-STEP_REPS:]} "
                  f"ms (device busy {row['decoder_busy_ms'][-1]:.3f})", flush=True)
    for name, row in out["variants"].items():
        print(f"  {name}: median SAM step {statistics.median(row['sam_ms']):.3f} ms, device busy "
              f"{statistics.median(row['sam_busy_ms']):.3f}; decoder step "
              f"{statistics.median(row['decoder_ms']):.3f} ms, device busy "
              f"{statistics.median(row['decoder_busy_ms']):.3f}", flush=True)
    if repeatable:
        for part in ("sam", "decoder"):
            new, old = (out["variants"][v][f"{part}_kernels"] for v in ("as is", "all undone"))
            diff = sorted(((new.get(k, 0.0) - old.get(k, 0.0), k) for k in set(new) | set(old)),
                          key=lambda d: -abs(d[0]))[:12]
            print(f"  {part} step, device ms as is minus all undone, by kernel (one profiled "
                  f"step each):", flush=True)
            for d, k in diff:
                print(f"    {d:+9.3f} ms  as is {new.get(k, 0.0):8.3f}  undone "
                      f"{old.get(k, 0.0):8.3f}  {k[:100]}", flush=True)
    return out


def step_replay(device_ms) -> dict:
    """The K1 and K4 calls of one vit_b forward_train + backward (batch 2,
    1024^2, bf16), recorded by patching the module names the autograd
    function calls them by, each kernel's calls replayed back to back."""
    import torch
    from micro_sam_tpu_torch.ops import relpos_attention as rpa
    from micro_sam_tpu_torch.training import get_trainable_sam_model
    sam = get_trainable_sam_model("vit_b", seed=0).sam
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 1024, 1024, 3, generator=g).cuda()
    gout = None
    calls = {"relpos_attention": [], "relpos_attention_backward": []}
    saved = {n: getattr(rpa, n) for n in calls}

    def wrap(name, fn):
        def call(*a, **kw):
            calls[name].append((a, kw))
            return fn(*a, **kw)
        # the wrapped function counts its launches on the object its module
        # name points to, which is now this wrapper
        call.launches = 0
        return call
    with torch.enable_grad():
        y = sam.encode_image_train(x)  # builds nothing new: a warm-up step
        gout = torch.randn(y.shape, generator=g).to(y.device, y.dtype)
        y.backward(gout)
        for n, fn in saved.items():
            setattr(rpa, n, wrap(n, fn))
        try:
            sam.zero_grad(set_to_none=True)
            sam.encode_image_train(x).backward(gout)
        finally:
            for n, fn in saved.items():
                setattr(rpa, n, fn)
    torch.cuda.synchronize()
    out = {"step_calls": {n: len(c) for n, c in calls.items()}, "step_ms": {}}
    for n, mine in calls.items():
        fn = saved[n]
        out["step_ms"][n] = [device_ms(lambda: [fn(*a, **kw) for a, kw in mine], iters=10)
                             for _ in range(REPS)]
    return out


def gemm_summary(runs) -> dict:
    """Per model: the median of each shape's kernel ms over the runs of one
    checkout, and per encode the sums of the shapes times their launches
    (kernel and F.linear + epilogue, the bound) with the host us a call."""
    out = ({"host_us": statistics.median(r["host_us"] for r in runs)} if "host_us" in runs[0]
           else {})
    for model, rows in runs[0]["shapes"].items():
        ms = [statistics.median(r["shapes"][model][i]["ms"] for r in runs)
              for i in range(len(rows))]
        lib = [statistics.median(r["shapes"][model][i]["library_ms"] for r in runs)
               for i in range(len(rows))]
        n = [row["launches_per_encode"] for row in rows]
        out[model] = {"ms": dict(zip((row["shape"] for row in rows), ms)),
                      "per_encode_ms": sum(a * b for a, b in zip(ms, n)),
                      "per_encode_library_ms": sum(a * b for a, b in zip(lib, n)),
                      "per_encode_bound_ms": sum(row["bound_ms"] * k for row, k in zip(rows, n))}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--model", default="vit_b", choices=("vit_b", "vit_h", "vit_l", "vit_t"))
    group = ap.add_mutually_exclusive_group()
    for name in SWEEPS:
        group.add_argument(f"--{name}", dest="sweep", action="store_const", const=name,
                           default="")
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.model, args.sweep)), flush=True)
        return
    import torch
    if not torch.cuda.is_available() or not args.roots:
        sys.exit("kernel_replay.py needs a CUDA card and at least one checkout")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    runs = []
    for root in args.roots:
        flags = ["--model", args.model] + ([f"--{args.sweep}"] if args.sweep else [])
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root] + flags,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            sys.exit(f"{root}: replay failed (rc {proc.returncode})")
        *logged, last = proc.stdout.strip().splitlines()
        print("\n".join(logged), flush=True)
        run = json.loads(last)
        runs.append(run)
        print(json.dumps(run), flush=True)
    summary = {}
    for root in dict.fromkeys(r["root"] for r in runs):
        mine = [r for r in runs if r["root"] == root]
        if args.sweep.endswith("plans"):
            continue
        if args.sweep == "train-step":
            summary[root] = {v: {k: statistics.median(x for r in mine for x in r["variants"][v][k])
                                 for k in ("sam_ms", "decoder_ms", "sam_busy_ms",
                                           "decoder_busy_ms")}
                             for v in mine[0]["variants"]}
            print(f"{root}: vit_b joint step parts, medians over its runs: "
                  f"{json.dumps(summary[root])}", flush=True)
            for r in mine:
                for row in r["variants"].values():
                    row.pop("sam_kernels", None), row.pop("decoder_kernels", None)
            continue
        if args.sweep == "encode":
            summary[root] = {bs: statistics.median(r["encode_ms"][bs] for r in mine)
                             for bs in ("1", "8")}
            print(f"{root}: {args.model} encode ms per image, median of its runs, batch 1 / 8: "
                  f"{summary[root]}", flush=True)
            continue
        if args.sweep:
            summary[root] = gemm_summary(mine)
            print(f"{root}: median over its runs, ms per shape and per encode (the shapes "
                  f"times their launches) {json.dumps(summary[root])}", flush=True)
            continue
        summary[root] = {k: statistics.median(v for r in mine for v in r["ms"][k])
                         for k in mine[0]["ms"]}
        if "step_ms" in mine[0]:
            summary[root]["step"] = {k: statistics.median(v for r in mine
                                                          for v in r["step_ms"][k])
                                     for k in mine[0]["step_ms"]}
        print(f"{root}: median ms per {args.model} encode and per training step "
              f"{summary[root]}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card.strip(), "runs": runs, "median_ms": summary}, f, indent=1)


if __name__ == "__main__":
    main()
