#!/usr/bin/env python3
"""Drive micro_sam_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any fault ends the run with a non-zero exit, and no result line):
 1. the card: CUDA must be available; prints its name and power limit;
 2. builds the CUDA kernels from micro_sam_tpu_torch/csrc and prints the time;
 3. holds each kernel (layernorm, gemm, relpos_attention) and the two block
    chains against their plain PyTorch versions on the card, at the vit_b
    shapes, in bf16 and f32, with timings, bounds and a library yardstick;
    a chain's launches are counted around one run of it;
 4. the main path at full width: get_sam_model("vit_b") with random weights,
    precompute_image_embeddings on a 1024^2 image and a 3-slice volume, then
    SamPredictor.predict with points, a box, box + point, a mask and a batch
    of boxes; checks shapes, finiteness, kernel launch counts and the
    embedding against the same model's plain f32 run on the CPU. One more
    encode is recorded call by call, and each kernel's launches of it are
    replayed on their own inputs: checked against the plain version, and
    timed back to back as the kernel, the plain version and library calls;
 5. prints one JSON line of the kernels and, last, the device line.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BF16 = 989e12   # H100 SXM dense tensor-core bf16 flop/s
PEAK_F32 = 67e12     # H100 SXM f32 flop/s outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
C, NH, HD, HIDDEN = 768, 12, 64, 3072
WIN_ROWS, GLOB_ROWS = 25 * 196, 4096   # rows of one 1024^2 image in the two block kinds
F32_TOL, BF16_TOL = 1e-4, 2e-2
ENCODE_BATCH, ENCODE_REPS, DECODE_REPS = 8, 5, 30


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Median over ``iters`` launches of ``fn``, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def check(name, got, ref, dtype_name, quiet=False):
    """f32: relative error <= 1e-4; bf16: abs error <= 2e-2 * max|ref|."""
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values in the kernel output")
    a = float((got - ref).abs().max())
    rel = a / (float(ref.abs().max()) + 1e-30)
    tol = F32_TOL if dtype_name == "float32" else BF16_TOL
    ok = rel <= tol
    if not quiet or not ok:
        log(f"  {name:<44s} {dtype_name:<8s} max_abs_err {a:.3e}  rel {rel:.3e}  "
            f"(tol rel {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} [{dtype_name}] disagrees with its plain version")
    return a


# ---------------------------------------------------------------------------
# kernel calls: their work, their plain and library counterparts, recording
# ---------------------------------------------------------------------------

def work(name, a):
    """(operations ms, bytes ms) of one kernel call at the published peaks:
    each input read once, each output written once."""
    x = a[0]
    s = x.element_size()
    rate = PEAK_BF16 if x.dtype == torch.bfloat16 else PEAK_F32
    if name == "layernorm":
        M, Cc = x.shape
        masked = len(a) > 4 and a[4] is not None
        ops, nbytes, rate = 8 * M * Cc, 2 * M * Cc * s + 2 * Cc * 4 + (M * 4 if masked else 0), PEAK_F32
    elif name == "gemm":
        (M, K), N = x.shape, a[1].shape[0]
        residual = len(a) > 3 and a[3] == "residual"
        ops = 2 * M * N * K
        nbytes = (M * K + N * K + M * N * (2 if residual else 1)) * s + N * 4
    else:
        B, nH, N, hd = x.shape
        H, W = a[5]
        ops = B * nH * (4 * N * N * hd + 2 * N * (H + W) * hd)
        nbytes = 4 * B * nH * N * hd * s + (H * H + W * W) * hd * s
    return ops / rate * 1e3, nbytes / PEAK_BYTES * 1e3


def bound_of(calls):
    """The least time for the calls' work: the larger of all their operations
    over the peak rate and all their bytes over the memory rate."""
    ops_ms = sum(work(n, a)[0] for n, a, _ in calls)
    bytes_ms = sum(work(n, a)[1] for n, a, _ in calls)
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def counterparts(name, a, kw):
    """(kernel, plain, library, f32 reference) closures of one kernel call.
    The library one is a PyTorch call computing the same function, its inputs
    made here, outside any timing (the rel-pos bias is materialized)."""
    import torch.nn.functional as F
    from micro_sam_tpu_torch.ops.gemm import gemm, gemm_plain
    from micro_sam_tpu_torch.ops.layernorm import layernorm, layernorm_plain
    from micro_sam_tpu_torch.ops.relpos_attention import (relpos_attention,
                                                          relpos_attention_plain)
    x = a[0]
    dt = x.dtype
    f32 = lambda t: None if t is None or not torch.is_tensor(t) else t.float()
    if name == "layernorm":
        _, w, b, eps = a[:4]
        v = a[4] if len(a) > 4 else None
        wd, bd = w.to(dt), b.to(dt)
        vd = None if v is None else v.reshape(-1, 1).to(dt)
        ln = lambda: F.layer_norm(x, (x.shape[1],), wd, bd, eps)
        return (lambda: layernorm(*a), lambda: layernorm_plain(*a),
                ln if vd is None else (lambda: ln() * vd),
                lambda: layernorm_plain(x.float(), w, b, eps, v))
    if name == "gemm":
        _, w, b = a[:3]
        epi, r = (a[3] if len(a) > 3 else "none"), (a[4] if len(a) > 4 else None)
        bd = b.to(dt)
        lin = lambda: F.linear(x, w, bd)
        lib = {"none": lin, "gelu": lambda: F.gelu(lin()), "residual": lambda: r + lin()}[epi]
        return (lambda: gemm(*a), lambda: gemm_plain(*a), lib,
                lambda: gemm_plain(x.float(), w.float(), b, epi, f32(r)))
    q, k, v, rh, rw, hw = a
    B, nH, N, hd = q.shape
    H, W = hw
    r_q = q.float().reshape(B, nH, H, W, hd)
    bias = (torch.einsum("bnijc,ikc->bnijk", r_q, rh.float())[..., :, None]
            + torch.einsum("bnijc,jkc->bnijk", r_q, rw.float())[..., None, :]
            ).reshape(B, nH, N, N).to(dt)
    return (lambda: relpos_attention(*a, **kw), lambda: relpos_attention_plain(*a),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias),
            lambda: relpos_attention_plain(q.float(), k.float(), v.float(), rh.float(),
                                           rw.float(), hw))


class Recorder:
    """Records every kernel call the block chains make, (name, args, kwargs),
    by wrapping the chain's kernel table; each call still launches its kernel
    and counts as before. The recorded tensors stay alive for replay."""

    def __enter__(self):
        from micro_sam_tpu_torch.ops import fused_window_block as fwb
        self.module, self.saved, self.calls = fwb, fwb._KERNELS, []

        def wrap(fn):
            def call(*a, **kw):
                self.calls.append((fn.__name__, a, kw))
                return fn(*a, **kw)
            return call
        fwb._KERNELS = tuple(wrap(f) for f in self.saved)
        return self

    def __exit__(self, *exc):
        self.module._KERNELS = self.saved


def replay(calls, iters=10):
    """(kernel ms, plain ms, library ms) of the calls run back to back, each
    time a median over ``iters`` runs of the whole sequence."""
    fns = [counterparts(*c) for c in calls]
    return tuple(time_ms(lambda: [f[i]() for f in fns], iters=iters, warmup=2)
                 for i in range(3))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phase(counters):
    from micro_sam_tpu_torch.models.image_encoder import Block, get_rel_pos, partition_tokens
    from micro_sam_tpu_torch.models.common import init_module_
    from micro_sam_tpu_torch.ops.fused_window_block import (
        fused_global_block, fused_global_block_plain, fused_window_block,
        fused_window_block_plain)

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1234)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    shapes = {"layernorm": [], "gemm": [], "relpos_attention": []}
    chains = []
    valid_win = partition_tokens(torch.ones(1, 64, 64, 1, device=dev), 14)[1].reshape(-1)

    for dt, dname in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        log(f"-- {dname}")
        calls = []  # (name, args, kwargs, label) at the main path's shapes
        for M in (WIN_ROWS, GLOB_ROWS):  # LN1 (masked on window rows) and LN2
            x = rnd(M, C, scale=3.0).to(dt)
            w, b = rnd(C, scale=0.5) + 1, rnd(C, scale=0.1)
            for v in ((valid_win, None) if M == WIN_ROWS else (None,)):
                calls.append(("layernorm", (x, w, b, 1e-6, v), {},
                              f"({M}, {C}){' masked' if v is not None else ''}"))
        for M in (WIN_ROWS, GLOB_ROWS):  # the four products of a block
            for pname, K, N, epi in (("qkv", C, 3 * C, "none"), ("proj", C, C, "residual"),
                                     ("lin1", C, HIDDEN, "gelu"), ("lin2", HIDDEN, C, "residual")):
                r = rnd(M, N).to(dt) if epi == "residual" else None
                a = (rnd(M, K).to(dt), rnd(N, K, scale=K ** -0.5).to(dt), rnd(N, scale=0.1), epi)
                calls.append(("gemm", a + ((r,) if r is not None else ()), {},
                              f"{pname} ({M}x{K})({K}x{N}) {epi}"))
        for B, H in ((25, 14), (1, 64)):  # straight from the qkv rows, into the proj rows
            N = H * H
            q5 = rnd(B * N, 3, NH, HD).to(dt).view(B, N, 3, NH, HD)
            q, k, v = (q5[:, :, i].transpose(1, 2) for i in range(3))
            rh = get_rel_pos(H, H, rnd(2 * H - 1, HD, scale=0.3)).to(dt)
            rw = get_rel_pos(H, H, rnd(2 * H - 1, HD, scale=0.3)).to(dt)
            out = torch.empty(B, N, NH, HD, device=dev, dtype=dt).transpose(1, 2)
            calls.append(("relpos_attention", (q, k, v, rh, rw, (H, H)), {"out": out},
                          f"({B}, {NH}, {N}, {HD})"))
        for name, a, kw, label in calls:
            kern, plain, lib, ref = counterparts(name, a, kw)
            err = check(f"{name} {label}", kern(), ref(), dname)
            k_ms = time_ms(kern)
            p_ms = time_ms(plain, iters=5 if name == "relpos_attention" else 20)
            l_ms = time_ms(lib)
            b_ms, b_by = bound_of([(name, a, kw)])
            shapes[name].append(dict(shape=label, dtype=dname, max_abs_err=err, ms=k_ms,
                                     plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by))
            log(f"    ms {k_ms:.4f}  plain_ms {p_ms:.4f}  library_ms {l_ms:.4f}  "
                f"bound_ms {b_ms:.4f} ({b_by})")
        del calls

        # the block chains at batch 1: launches counted, work and library
        # time from the calls recorded in one chain run
        def chain(name, run, run_plain, x):
            got = run(x)
            err = check(name, got, run_plain(x.float()), dname)
            before = {k: c.launches for k, c in counters.items()}
            with Recorder() as rec:
                run(x)
            launches = {k: c.launches - before[k] for k, c in counters.items()}
            if launches != {"layernorm": 2, "gemm": 4, "relpos_attention": 1}:
                raise AssertionError(f"{name}: launches {launches}, not the chain's seven")
            k_ms = time_ms(lambda: run(x))
            p_ms = time_ms(lambda: run_plain(x), iters=5)
            l_ms = replay(rec.calls)[2]
            b_ms, b_by = bound_of(rec.calls)
            chains.append(dict(name=name, dtype=dname, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                               library_ms=l_ms, bound_ms=b_ms, bound_by=b_by, launches=launches))
            log(f"    launches {launches}  ms {k_ms:.4f}  plain_ms {p_ms:.4f}  library_ms "
                f"(its calls, each as a library call) {l_ms:.4f}  bound_ms {b_ms:.4f} ({b_by})")

        blk = Block(C, NH, 4.0, 14, (14, 14))
        init_module_(blk, g)
        blk = blk.hold_weights_in_(dt).to(dev)
        valid = valid_win.reshape(25, 196, 1)
        chain("fused_window_block chain (K2) (25, 196, 768) masked",
              lambda x: fused_window_block(x, valid, blk, (14, 14), NH),
              lambda x: fused_window_block_plain(x, valid, blk, (14, 14), NH),
              rnd(25, 196, C).to(dt))
        gblk = Block(C, NH, 4.0, 0, (64, 64))
        init_module_(gblk, g)
        gblk = gblk.hold_weights_in_(dt).to(dev)
        chain("fused_global_block chain (K3) (1, 4096, 768)",
              lambda x: fused_global_block(x, gblk, (64, 64), NH),
              lambda x: fused_global_block_plain(x, gblk, (64, 64), NH),
              rnd(1, 4096, C).to(dt))
        del blk, gblk
        torch.cuda.empty_cache()
    return shapes, chains


def encode_replay_phase(predictor, x1, counters, launches, n_images):
    """Records one batch-1 encode of the main path's model and image, then
    replays each kernel's launches of it on their own inputs: against the f32
    plain version (the check), and timed, back to back, as the kernel, as the
    plain version and as library calls."""
    before = {k: c.launches for k, c in counters.items()}
    with Recorder() as rec:
        predictor.encode_batch(x1)
    torch.cuda.synchronize()
    per_encode = {k: c.launches - before[k] for k, c in counters.items()}
    log(f"  launches in one recorded encode: {per_encode}")
    if any(per_encode[k] * n_images != launches[k] for k in counters):
        raise AssertionError("one encode's launches are not the main path's per image")
    out = {}
    for name in counters:
        calls = [c for c in rec.calls if c[0] == name]
        err = 0.0
        for c in calls:
            kern, _, _, ref = counterparts(*c)
            err = max(err, check(f"{name} on main-path inputs", kern(), ref(), "bfloat16",
                                 quiet=True))
        k_ms, p_ms, l_ms = replay(calls)
        b_ms, b_by = bound_of(calls)
        out[name] = dict(launches_per_encode=per_encode[name], max_abs_err=err, ms=k_ms,
                         plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"  {name}: {len(calls)} launches of one encode, max_abs_err {err:.3e}; ms {k_ms:.4f}"
            f"  plain_ms {p_ms:.4f}  library_ms {l_ms:.4f}  bound_ms {b_ms:.4f} ({b_by})")
    return out


def summarize(shapes, launches, per_encode):
    """One entry per kernel. launches: the main path's count; ms, plain_ms,
    library_ms, bound_ms: all of the kernel's launches of one batch-1 bf16
    1024^2 encode, replayed back to back on that encode's inputs; shapes: the
    per-shape checks and timings of phase 3."""
    sources = {"layernorm": "micro_sam_tpu_torch/csrc/layernorm.cu",
               "gemm": "micro_sam_tpu_torch/csrc/gemm.cu",
               "relpos_attention": "micro_sam_tpu_torch/csrc/relpos_attention.cu"}
    replaces = {
        "layernorm": "micro_sam_tpu/ops/fused_window_block.py:76 (_fused_block_kernel LN1/LN2); :681 (_fused_global_kernel)",
        "gemm": "micro_sam_tpu/ops/fused_window_block.py:76 (_fused_block_kernel qkv/proj/MLP); :681 (_fused_global_kernel)",
        "relpos_attention": "micro_sam_tpu/ops/flash_attention.py:221 (_flash_kernel_qkv); attention in fused_window_block.py:76 and :681",
    }
    out = []
    for name, rows in shapes.items():
        e = per_encode[name]
        out.append({
            "name": name, "route": "cuda", "source": sources[name], "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": max([e["max_abs_err"]] + [r["max_abs_err"] for r in rows]),
            "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"], "library_ms": e["library_ms"],
            "launches_per_encode": e["launches_per_encode"],
            "per": "all launches of one 1024x1024 vit_b bf16 encode at batch 1, back to back",
            "shapes": rows,
        })
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def main_path_phase(counters):
    from micro_sam_tpu_torch.util import (_to_image, get_sam_model,
                                          precompute_image_embeddings, set_precomputed)
    from micro_sam_tpu_torch.models.sam import preprocess

    rng = np.random.RandomState(0)
    image = rng.randint(0, 256, size=(1024, 1024)).astype(np.uint8)  # a grey 2d image
    volume = rng.randint(0, 256, size=(3, 768, 1024)).astype(np.uint8)

    for c in counters.values():
        c.launches = 0
    predictor = get_sam_model("vit_b", seed=0)
    emb = precompute_image_embeddings(predictor, image, verbose=False)
    emb3 = precompute_image_embeddings(predictor, volume, verbose=False)
    set_precomputed(predictor, emb)
    outs = {
        "1 point": predictor.predict(np.array([[500., 400.]]), np.array([1])),
        "3 points": predictor.predict(np.array([[500., 400.], [300., 700.], [800., 100.]]),
                                      np.array([1, 0, 1])),
        "box": predictor.predict(box=np.array([200., 150., 700., 650.])),
        "box + point": predictor.predict(np.array([[450., 400.]]), np.array([1]),
                                         box=np.array([200., 150., 700., 650.])),
    }
    low = outs["box"][2]
    outs["mask input"] = predictor.predict(np.array([[450., 400.]]), np.array([1]),
                                           mask_input=low[np.argmax(outs["box"][1])][None])
    boxes = np.stack([[50. + 100 * i, 60., 150. + 100 * i, 300.] for i in range(8)])
    outs["8 boxes"] = predictor.predict_batched(boxes=boxes)
    set_precomputed(predictor, emb3, i=1)
    outs["volume slice 1, 1 point"] = predictor.predict(np.array([[500., 300.]]), np.array([1]))
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}

    n_images = 1 + volume.shape[0]
    depth = predictor.model.config.depth  # per block: 2 layernorm, 4 gemm, 1 relpos_attention
    expect = {"layernorm": 2 * depth * n_images, "gemm": 4 * depth * n_images,
              "relpos_attention": depth * n_images}
    log(f"  launches in the main path: {launches} (expected {expect} for {n_images} images)")
    if launches != expect:
        raise AssertionError("the main path did not go through the kernels as expected")

    feats = emb["features"]
    assert feats.shape == (1, 256, 64, 64) and np.isfinite(feats).all(), feats.shape
    assert emb3["features"].shape == (3, 1, 256, 64, 64) and np.isfinite(emb3["features"]).all()
    assert tuple(emb3["input_size"]) == (768, 1024) and tuple(emb3["original_size"]) == (768, 1024)
    for name, (m, iou, lo) in outs.items():
        batch = (8,) if name == "8 boxes" else ()
        H, W = (768, 1024) if name.startswith("volume") else (1024, 1024)
        assert m.shape == batch + (3, H, W) and m.dtype == bool, (name, m.shape)
        assert iou.shape == batch + (3,) and np.isfinite(iou).all(), (name, iou.shape)
        assert lo.shape == batch + (3, 256, 256) and np.isfinite(lo).all(), (name, lo.shape)
        log(f"  predict {name:<24s} masks {m.shape} iou {np.round(iou.reshape(-1)[:3], 4).tolist()}"
            f" fg {float(m.mean()):.4f}")

    # timing: encode per 1024^2 image at batch 1 and 8, decode p50
    rgb = _to_image(image)
    x1 = rgb[None].astype(np.float32)
    xb = np.repeat(x1, ENCODE_BATCH, axis=0)
    t_enc = {}
    for bs, x in ((1, x1), (ENCODE_BATCH, xb)):
        predictor.encode_batch(x)
        torch.cuda.synchronize()
        ts = []
        for _ in range(ENCODE_REPS):
            t0 = time.perf_counter()
            predictor.encode_batch(x)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3 / bs)
        t_enc[bs] = statistics.median(ts)
    set_precomputed(predictor, emb)
    dts = []
    for i in range(DECODE_REPS):
        t0 = time.perf_counter()
        predictor.predict(np.array([[300. + 10 * i, 400.]]), np.array([1]))
        dts.append((time.perf_counter() - t0) * 1e3)
    dec_p50 = float(np.percentile(dts[len(dts) // 6:], 50))
    log(f"  encode ms per 1024^2 image (host clock, median of 5, incl. host resize/transfer): "
        f"batch 1 {t_enc[1]:.3f}, batch {ENCODE_BATCH} {t_enc[ENCODE_BATCH]:.3f}; "
        f"tiles/s at batch {ENCODE_BATCH} {1e3 / t_enc[ENCODE_BATCH]:.3f}")
    log(f"  decode p50 ms (1 point, host clock incl. mask upscale and transfer): {dec_p50:.3f}")
    per_encode = encode_replay_phase(predictor, x1, counters, launches, n_images)

    # the embedding against the same model's plain f32 run on the CPU
    px = preprocess(torch.from_numpy(x1))
    cpu = get_sam_model("vit_b", seed=0, device="cpu")
    t0 = time.perf_counter()
    ref = cpu.model.encode_image(px).float()
    log(f"  CPU f32 reference encode: {time.perf_counter() - t0:.1f} s")
    ref_nchw = ref.permute(0, 3, 1, 2).numpy()
    f32 = get_sam_model("vit_b", seed=0, compute_dtype="float32")
    got32 = f32.model.encode_image(px.cuda()).float().cpu()
    for name, got, tol in (("f32 kernel path", got32.permute(0, 3, 1, 2).numpy(), 1e-3),
                           ("bf16 kernel path", feats, 3e-2)):
        rel = float(np.abs(got - ref_nchw).max() / np.abs(ref_nchw).max())
        log(f"  embedding {name} vs CPU plain f32: rel {rel:.3e} (tol {tol:g}) "
            f"{'ok' if rel <= tol else 'FAIL'}")
        if not rel <= tol:
            raise AssertionError(f"{name} embedding disagrees with the CPU reference")
    return launches, per_encode, {"encode_ms_b1": t_enc[1], "encode_ms_b8": t_enc[ENCODE_BATCH],
                      "tiles_per_s_b8": 1e3 / t_enc[ENCODE_BATCH], "decode_p50_ms": dec_p50}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU.",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from micro_sam_tpu_torch.ops import _cuda
    from micro_sam_tpu_torch.ops.gemm import gemm
    from micro_sam_tpu_torch.ops.layernorm import layernorm
    from micro_sam_tpu_torch.ops.relpos_attention import relpos_attention

    # phase 1: the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("set torch.backends.cuda.matmul.allow_tf32 = False, torch.backends.cudnn.allow_tf32 = False")

    # phase 2: build
    t0 = time.perf_counter()
    _cuda.build()
    for n in _cuda.SOURCES:
        _cuda.library(n)
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc wall {_cuda.build_seconds:.1f} s) "
        f"into {_cuda.build_dir()}")
    for n in _cuda.SOURCES:
        path = os.path.join(_cuda.build_dir(), f"{n}.log")
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    if "registers" in line or "spill" in line and " 0 bytes spill" not in line:
                        log(f"  ptxas {n}: {line.strip()}")

    # phase 3: kernels vs plain
    log("kernels vs plain versions (bf16: plain in f32 on the same bf16 inputs)")
    counters = {"layernorm": layernorm, "gemm": gemm, "relpos_attention": relpos_attention}
    shapes, chains = kernel_phase(counters)
    log("main path: vit_b, 1024^2, random weights (seed 0), bf16")
    launches, per_encode, e2e = main_path_phase(counters)
    log(json.dumps({"kernels": summarize(shapes, launches, per_encode), "chains": chains,
                    "card": card,
                    "end_to_end": e2e}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
