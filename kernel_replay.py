"""Time the ViT kernels of one vit_b encode and of one vit_b training step,
replayed back to back, for one or more checkouts of this repository, each in
its own process and in the order given, so that two versions of a kernel are
compared on one card:

    python3 kernel_replay.py OLD NEW NEW OLD [--out FILE]

Each argument is the root of a checkout (``.`` for this one). Its process
imports that checkout's ``micro_sam_tpu_torch`` and builds its kernels into
that checkout's ``build/``. The encode replay records the ``layernorm`` /
``gemm`` / ``relpos_attention`` launches of one batch-1 1024 x 1024 vit_b
encode (bf16, random weights from seed 0, a random image from seed 0)
through the encoder's default route; the step replay records the
``relpos_attention`` (K1, with the checkpoint recompute) and
``relpos_attention_backward`` (K4) calls of one vit_b ``forward_train`` and
its backward (batch 2 of 1024 x 1024, bf16 compute, f32 weights from seed 0,
random pixels and upstream gradient from seed 0), as a training step makes
them. Each kernel's calls are replayed back to back: device time from
torch.profiler (CUPTI), by the ``time_ms`` of the ``chip_smoke.py`` beside
this script, the mean of 20 runs (10 for the step), taken ``REPS`` times.
Prints the card's name and power limit, one JSON line per checkout and the
median of each kernel per checkout (``ms`` per encode, ``step_ms`` per
step); ``--out`` writes all of it to a JSON file. Needs one CUDA card.
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


def smoke_timer():
    """``time_ms`` of the chip_smoke.py beside this script: one timer for both
    scripts, loaded before a checkout's root goes on the path."""
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(here, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.time_ms


def child(root: str) -> dict:
    root = os.path.abspath(root)
    device_ms = smoke_timer()
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import micro_sam_tpu_torch
    pkg = os.path.dirname(os.path.abspath(micro_sam_tpu_torch.__file__))
    if pkg != os.path.join(root, "micro_sam_tpu_torch"):
        raise RuntimeError(f"imported {pkg}, not the package of {root}")
    from micro_sam_tpu_torch.ops import _cuda
    from micro_sam_tpu_torch.ops import fused_window_block as fwb
    from micro_sam_tpu_torch.util import _to_image, get_sam_model
    for k in KNOBS:
        os.environ.pop(k, None)
    rng = np.random.RandomState(0)
    x1 = _to_image(rng.randint(0, 256, size=(1024, 1024)).astype(np.uint8))[None]
    predictor = get_sam_model("vit_b", seed=0)
    predictor.encode_batch(x1.astype(np.float32))  # builds the kernels
    torch.cuda.synchronize()
    calls, saved = [], fwb._KERNELS

    def wrap(fn):
        def call(*a, **kw):
            calls.append((fn.__name__, fn, a, kw))
            return fn(*a, **kw)
        return call
    fwb._KERNELS = tuple(wrap(f) for f in saved)
    try:
        predictor.encode_batch(x1.astype(np.float32))
    finally:
        fwb._KERNELS = saved
    torch.cuda.synchronize()
    out = {"root": root, "kernels": _cuda.build_dir(), "launches": {}, "ms": {}}
    for name in ("layernorm", "gemm", "relpos_attention"):
        mine = [c for c in calls if c[0] == name]
        out["launches"][name] = len(mine)
        out["ms"][name] = [device_ms(lambda: [fn(*a, **kw) for _, fn, a, kw in mine])
                           for _ in range(REPS)]
    del calls, predictor
    out.update(step_replay(device_ms))
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return
    import torch
    if not torch.cuda.is_available() or not args.roots:
        sys.exit("kernel_replay.py needs a CUDA card and at least one checkout")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    runs = []
    for root in args.roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            sys.exit(f"{root}: replay failed (rc {proc.returncode})")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(run)
        print(json.dumps(run), flush=True)
    summary = {}
    for root in dict.fromkeys(r["root"] for r in runs):
        mine = [r for r in runs if r["root"] == root]
        summary[root] = {k: statistics.median(v for r in mine for v in r["ms"][k])
                         for k in mine[0]["ms"]}
        summary[root]["step"] = {k: statistics.median(v for r in mine for v in r["step_ms"][k])
                                 for k in mine[0]["step_ms"]}
        print(f"{root}: median ms per encode and per training step {summary[root]}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card.strip(), "runs": runs, "median_ms": summary}, f, indent=1)


if __name__ == "__main__":
    main()
