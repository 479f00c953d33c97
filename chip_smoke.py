#!/usr/bin/env python3
"""Drive micro_sam_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase 18     # phases 1, 2 and 18 only; no result lines

Phases (any fault ends the run with a non-zero exit, and no result line):
 1. the card: CUDA must be available; prints its name and power limit;
 2. builds the CUDA kernels from micro_sam_tpu_torch/csrc and prints the time,
    each kernel's ptxas registers and any spill or warning; fails if a gemm,
    dwconv, tiny_attention or layernorm kernel spills or, where the toolkit
    has cuobjdump, if a bf16 gemm kernel's SASS holds no HGMMA (warpgroup
    product) or no UTMALDG (TMA load), or a kernel of dwconv's TMA body or
    tiny_attention's bf16 kernel no UTMALDG;
 3. holds each kernel (layernorm, gemm, relpos_attention) and the two block
    chains against their plain PyTorch versions on the card, at the vit_b
    shapes, in bf16 and f32, with timings, bounds and a library yardstick
    (relpos_attention's rows with the forward variant each launch takes,
    gemm's with its plan); a chain's launches are counted around one run of
    it; layernorm at every shape of the vit_b encode and of K9's grid mode
    (``layernorm_sweep``: against plain, timed with F.layer_norm, bound,
    plan, the sums per encode); the host microseconds a gemm and a
    layernorm call cost;
 4. the main path at full width: get_sam_model("vit_b") with random weights,
    precompute_image_embeddings on a 1024^2 image and a 3-slice volume, then
    SamPredictor.predict with points, a box, box + point, a mask and a batch
    of boxes; checks shapes, finiteness, kernel launch counts and the
    embedding against the same model's plain f32 run on the CPU. One more
    encode is recorded call by call (its layernorm and tiny_attention
    shapes checked against the sweeps' tables), and each kernel's launches
    of it are replayed on their own inputs: checked against the plain
    version, and timed back to back as the kernel, the plain version and
    library calls;
 5. holds the backward kernel relpos_attention_backward (K4), handed the
    forward's lse as the training path does, against its plain backward at
    vit_b's training shapes ((50, 12, 196, 64) windows, the (2, 12, 4096, 64)
    global grid), f32 (rel 1e-4) and bf16 (rel 3e-2 of the f32 plain result on the same bf16
    inputs), with timings, bounds and an SDPA-backward yardstick, its stage
    variants and, in bf16, each of its four stages timed alone; then K1 and
    K4 in bf16 on grids beyond one key rectangle (336 x 336 at head dims 64
    and 80, 32 x 640 at 64; 2 heads): the forward's output and lse on 128
    sampled rows, and the backward with dout on 64 of them, against the
    plain version's rows over all keys, launches per call (one, four, a key
    rectangle), each timed with its bound;
 6. finetuning at full vit_b width: train_sam("vit_b", with_segmentation_decoder
    =False, n_iterations=2) on 512^2 synthetic patches, its best.pkl loaded
    into the predictor for one predict; then SamTrainer steps at train_sam's
    defaults (batch 2, 25 objects, 8 rounds, lr 1e-5, bf16 compute with f32
    weights), 3 warm-up and 5 timed, with the attention launches per step
    counted (24 forward, 48 backward); one step's K4 calls are recorded and
    replayed as the kernel, the plain version and SDPA backward; one f32 step
    on the card (batch 1, 4 objects, one round; vit_b cut to 6 blocks, global
    at 2 and 5) against the same step on the CPU, in a process started at the
    phase's start (gradients within rel 1e-3 of each tensor's max);
 7. vit_t (TinyViT / MobileSAM): holds the new kernels (tiny_attention at the
    three stage geometries, dwconv at the MBConv and the three tail shapes,
    the gemm's residual_gelu epilogue) and the K6 / K7 / K8 chains against
    their plain versions, bf16 and f32, with launches per chain call checked;
    dwconv at each depthwise shape of the encode (``dwconv_sweep``: held
    against plain, timed with cuDNN's depthwise convolution, bound, the sum
    per encode);
    the gemm at each of the 14 distinct products of the vit_t encode
    (``gemm_sweep``: held against plain, timed with F.linear + epilogue,
    bound and plan); layernorm at each of its six shapes and tiny_attention
    at its three stages (``layernorm_sweep``, ``tiny_attention_sweep``:
    against plain, timed with F.layer_norm / SDPA on the gathered bias,
    bound, plan, the sums per encode) and the host microseconds a
    tiny_attention call costs;
    then the same serving path as phase 4 with get_sam_model("vit_t"): launch
    counts per encode (12 dwconv, 10 tiny_attention, 20 layernorm, 44 gemm),
    each chain call's launches counted around it on that path (a chain's
    launches in the kernels line),
    encode / decode times, one encode replayed per kernel and per chain (the
    chains' library yardsticks: cuDNN convolutions, F.layer_norm, F.linear,
    SDPA with the gathered bias), the embedding against the CPU's plain f32 run;
 8. vit_h / vit_l: holds relpos_attention at head dim 80 ((25, 16, 196, 80)
    and (1, 16, 4096, 80)) and at vit_l's 16 heads of 64, layernorm and gemm
    at vit_h's widths (C 1280, N 3840 / 1280 / 5120, K 5120) and the
    attention halves K10 (25, 196, 1280, masked) and K5 (1, 4096, 1280)
    against their plain versions, bf16 and f32, four launches a call; the
    gemm at the 8 distinct products of the vit_l encode; layernorm at every
    shape of the vit_h and vit_l encodes and vit_h's K9; then the serving
    path of phase 4 with
    get_sam_model("vit_h") and get_sam_model("vit_l"): launches per encode
    (64 / 128 / 32 and 48 / 96 / 24 layernorm / gemm / relpos_attention),
    each chain call's launches counted around it on the path by patching
    fused_window_attn, fused_global_attn and mlp_half of
    ops/fused_window_block (vit_h: 4 K5, 28 K10, 32 MLP halves per encode),
    encode / decode times, one encode replayed per kernel and per chain, and
    the embedding against the same weights' plain f32 run on the card (block
    by block through the plain versions: a full-width f32 encode on the CPU
    takes minutes); the bf16 path is held to max(3e-2, 1.5x the plain bf16
    chain's drift on the card), both printed. Prints the phase's wall time;
 9. vit_h / vit_l finetuning: holds the backward kernel at head dim 80
    ((50, 16, 196, 80) and (2, 16, 4096, 80), vit_h's training shapes at batch
    2) and flash_attention_rel_pos (K12: (B, N, nH, hd) q, k, v, forward and
    backward, at (1, 4096, 12, 64) and (25, 196, 16, 80)) against their plain
    versions, bf16 and f32, with timings, bounds and SDPA yardsticks, and
    counts K12's launches on its own path (two calls through
    attention_with_rel_pos); then timed SamTrainer steps of vit_h (5; the
    "A100" preset's model and objects, on default_sam_loader over phase 6's
    patches; the preset itself runs with the decoder in phase 14(e)) and of
    vit_l at full width cut to 6 blocks (3; global at 5) at train_sam's
    defaults, launches per step 64 / 128 and 12 / 24, one profiled step and
    one step's K4 calls replayed each; and one f32 step (its CPU half in a
    process started at the phase's start) of a full-width vit_h
    cut to 4 blocks (global at 3) on the card against the CPU. Prints the
    phase's wall time;
10. tiled precompute, the encoder's K9 / K11 routes and the rel-pos kernels
    at every head dim: relpos_attention at head dims 16, 32, 40, 64, 80, 96,
    100, 128, 160 and 256, its lse and its backward (window and global
    grids, and a misaligned view) against their plain versions, bf16 and
    f32, the aligned bf16 forwards timed with their variant; K9
    (fused_window_block_spatial, vit_b and vit_h widths, padded and not) and
    K11 (fused_window_stack, 4 images) against their plain versions and the
    partitioned K2 chain; the device time of the partition copies K9 removes
    and of the spatial addressing; then get_sam_model("vit_b") (bf16, seed 0)
    precomputing a 2048^2 synthetic_data image and a (4, 1536, 1536) volume
    in 1024^2 tiles with a 256 halo, 4 tiles (slices) an encode, under the
    default, K9 (MSAM_TPU_SPATIAL_WINDOW=1) and K11 (MSAM_TPU_WINDOW_STACK=1)
    routes: launches per 4-tile batch (84; K9: 8 spatial attention launches
    in 8 calls of 7) and per chain call, every tile against the untiled
    precompute of its crop (3e-2 of max) and the opt-in routes against the
    default (2e-2), a tiled prompt, tiles/s (not of K11, the default route's
    launches); a tiled cache under build/ reloaded lazily and a tile_subset
    call resumed with no launch; one K9 encode replayed per kernel and per
    chain (K11's row times one call of its kernel check); vit_h (full
    width, 8 blocks) through K9 against its default route. Prints the
    phase's wall time;
11. the prompt layer and AMG: (a) get_sam_model("vit_b") (bf16, seed 0) on a
    1024^2 synthetic_data image: segment_from_points / _box / _mask /
    _box_and_points, batched_inference over the objects' boxes at batch 32,
    AutomaticMaskGenerator (32 x 32 points, 64 a batch, no floors): one
    encode's launches during initialize (24 layernorm, 48 gemm, 12
    relpos_attention) and none during generate, initialize timed and split
    (encode, decode + reduction, host copy + RLE), candidates/s, generate
    timed in two modes, one initialize profiled; TiledAutomaticMaskGenerator
    (16 x 16) and batched_tiled_inference over phase 10's tiled 2048^2
    embeddings, every tile decoded once; (b) the trained fixture SAM
    (tests/fixtures/bench_sam_tiny1024.npz, f32): AMG with the default
    floors on the card against the same on the CPU (the port's plain path, in
    a process started at the phase's start), records matched by point (mask
    IoU >= 0.99, scores within 1e-3, at most 2 % unmatched, each at a cut),
    and the floors against none at the default thresholds. Prints the
    phase's wall time;
12. decoder-based instance segmentation: get_sam_model("vit_b") (bf16, seed
    0) and the UNETR decoder at published widths (random weights from seed 0,
    BN statistics randomized as tests/make_golden.py does) through
    get_predictor_and_segmenter on phase 11's 1024^2 image: AIS initialize
    with one encode's launches and none in generate, timed and split
    (encode, decoder, crop + resize, copy to the host), profiled by layer;
    AIS and APG on maps built from the image's truth (>= 90 % of the objects
    at IoU >= 0.8; one prompt per object, +-10 %); the decoder (both
    upsampler kinds) on the card against the CPU (f32 rel 1e-3, TF32 off;
    bf16 against f32 within max(3e-2, 2x the CPU's own bf16 drift)), with
    its device time, operations and bound; tiled AIS at batch 4 over phase
    10's embeddings (tiles/s, canvases equal to the batch's decoder output
    pasted per tile, each tile's batch-1 decode within the bf16 bound) and
    tiled APG with optimize_memory; automatic_instance_segmentation in the
    modes ais, apg and amg, and cache_amg_state written and reloaded. Prints
    the phase's wall time;
13. multi-dimensional segmentation and tracking: (a) get_sam_model("vit_b")
    (bf16, seed 0) on an (8, 512, 512) synthetic_data volume rolled 2 rows a
    slice: precompute_image_embeddings(ndim=3, batch_size=4) with the
    launches of its 2 encode calls, segment_mask_in_volume from a truth mask
    in the five projection modes and a flag dict (a bridge between two truth
    slices) with no kernel launched, each projected slice's time split into
    the store read, the copy to the card, the decode and the host, over the
    in-memory embeddings and over a zarr store read lazily; (b)
    automatic_instance_segmentation(ndim=3) with AIS (the decoder at published
    widths) with the encodes' launches only in the embeddings, split into
    embeddings, per-slice initialize and generate, and the merge, then its
    tiled form on two 1024^2 slices in 512^2 tiles, halo 128; (c) the truth
    slices merged back into the truth (every object one 3d id at IoU >=
    0.95), gap closing filling a removed slice, native.greedy_multicut equal
    to its Python twin on 3 random graphs, and the trained fixture's
    segment_mask_in_volume (f32) on the card against the CPU (a process
    started at the phase's start; every slice's mask IoU >= 0.99, the same z
    ranges); (d) track_across_frames with the greedy, the learned (scorer on
    the card) and the auto linker on a HeLa-like sequence, scored against its
    truth links, the scorer's logits on the card against the CPU (rel <=
    1e-5, the same links), and automatic_tracking through AIS with the
    encodes' launches only in the embeddings. Prints the phase's wall time;
14. joint finetuning and the other trainers, on phase 6's 512^2 patches:
    (a) train_sam("smoke_joint", "vit_b", n_iterations=2) at its default (SAM
    and the UNETR decoder at published widths) on default_sam_loader with
    distance targets, counted from zero (2 x (24 + 12) K1 and 2 x 48 K4
    launches, 12 K1 in validation), its best.pkl through
    export_instance_segmentation_model into get_predictor_and_segmenter (the
    decoder equal to the trainer's, bitwise), AIS initialize and generate;
    (g) export_custom_sam_model and save_native_checkpoint of that checkpoint
    loaded back by get_sam_model (embedding within the bf16 bound); (b)
    JointSamTrainer steps at train_sam's defaults, 3 warm-up and 5 timed,
    split into the SAM step and the decoder step, images/s, peak memory,
    launches per step asserted (36 K1, 48 K4), one joint step and one
    decoder step profiled by layer; (c) one f32 decoder step (published
    widths, (1, 32, 32, 256) features, 512^2 targets) on the card against the
    CPU (loss rel 1e-5, gradients rel 1e-3 of each tensor's max); (d)
    train_instance_segmentation (every SAM tensor bitwise unchanged, every
    decoder parameter moved); (e) train_sam_for_configuration("A100") at its
    default (vit_h, cut to 8 blocks, and the decoder) with its peak memory; (f)
    SimpleSamTrainer, MedSAMTrainer and SemanticSamTrainer (3 classes), 2
    steps each. Prints the phase's wall time;
15. PEFT, the 3d wrappers and vit_t finetuning (bf16, seed 0; CPU references
    in two processes started at the phase's start): (f) get_sam_3d_model
    ("vit_b", d_size=8, its depth convolutions redrawn) and
    get_simple_sam_3d_model("vit_b") on an (8, 1024, 1024) volume: one
    forward's launches (24 / 48 / 12: the slices share each launch), its
    time, the encoder against its plain version in f32 on the card (3e-2);
    (b) train_sam(peft_kwargs={"rank": 4}) for 2 steps (48 + 12 K1, 96 K4;
    every base encoder tensor bitwise unchanged, every LoRA b moved), then
    timed LoRA steps by phase 6's protocol (the full step's in this run);
    (a) get_sam_model("vit_b", peft_kwargs={"rank": 4}) with its LoRA b
    redrawn: one encode's launches (every block's chain, K1 on its qkv rows
    with the LoRA updates: 24 / 48 / 12), the embedding against the CPU's f32
    run (3e-2) and against the base model's (moved by at least 0.12), the
    encode's time against the base model's; (c) QLoRA: train_sam with
    {"rank": 4, "quantize": True} for a step (the base frozen), the int4
    base's bytes, the int4 against the dense embedding, export_custom_qlora_
    model into get_sam_model against its checkpoint (2e-2); (d)
    get_predictor_and_decoder(peft_kwargs=...) on (b)'s checkpoint with a
    decoder state (the LoRA bitwise, set_image's launches, the maps); (e)
    train_sam_for_configuration("Minimal") at its default (vit_t and the
    decoder; 5 encodes' chain launches), timed vit_t steps at the preset's
    settings (12 / 10 / 20 / 44 dwconv / tiny_attention / layernorm / gemm a
    step), peak memory, a profiled step, one f32 vit_t step on the card
    against the CPU. Prints the phase's wall time;
16. evaluation (bf16 vit_b, seed 0, two 1024^2 synthetic_data images of 20
    cells): (a) precompute_all_embeddings into a zarr folder under build/;
    (b) the iterative-prompting loop of the evaluation, 8 iterations from
    the objects' boxes, with and without masks, over (a)'s cache with no
    launch: ms an iteration split into decode and host, mSA per iteration
    scored on the host; (c) run_instance_segmentation_grid_search for AIS
    (the UNETR at published widths, a 2 x 2 grid at quantiles of its maps)
    and AMG (16 x 16 points, a 2 x 2 grid) on one image over (a)'s cache,
    the CSVs written without pandas, the best parameters, ms a combination;
    (d) segment_slices_from_ground_truth on phase 13's 8-slice volume; (e)
    compute_object_features and project_embeddings_for_visualization on
    the card's embeddings, untiled and tiled; the encodes' launches (24 / 48
    / 12 each) asserted throughout; (f) the trained fixture (f32) on a 512^2
    image of its kind on the card against the CPU (two processes started at
    the phase's start): the iterative loop fed the CPU's corrective points
    (every object's mask at IoU >= 0.99 each iteration, mSA within 1e-3),
    the AMG grid search's best parameters equal, the features within rel
    1e-3, the PCA within 1e-3 once signs are aligned. Prints the phase's
    wall time;
17. the annotators and model export, headless through the port's FakeViewer
    (vit_b bf16, seed 0): (a) annotator_2d on a 1024^2 synthetic_data image,
    initialize_predictor timed (model, encode, resize + in-memory cache
    write) with the encode's launches asserted, 20 presses of "s" (1-3
    points, a box, segment(batched=True) over 8 boxes; p50 ms a press split
    into decode and host), "c", the layer contract; (b) SegmentNDWidget over
    phase 13's (8, 512, 512) volume from one point (ms a projected slice);
    (c) track_from_prompts over 4 frames of phase 13's sequence; (d)
    AutoSegmentWidget in AIS mode (the UNETR at published widths) and the
    image-series precompute of 2 images into a folder; (e) export (vit_b,
    f32): export_sam_model then test_model_package on the card,
    export_bioengine_model, whose TorchScript encoder, loaded onto the
    card, launches no port kernel and agrees with the kernel path's f32
    embedding within rel 1e-3, and whose ONNX decoder names its six
    inputs; (f) the trained fixture's 10 clicks (f32) on the card against
    the CPU (a process started at the phase's start): every mask at IoU >=
    0.99, the committed labels equal. The CPU references of phases 4 and 12
    run in processes started at phases 3 and 9. Prints the phase's wall
    time;
18. multi-GPU execution (``parallel/``), every time marked as two ranks
    time-sliced on one card (no multi-GPU speed; NCCL across cards
    unmeasured): (b) a gloo world of two spawned ranks (gloo named, both on
    cuda:0, the kernels built here first, the data made here once), while
    this process runs (a) an NCCL world of one, get_sam_model("vit_b",
    mesh=make_mesh()) (bf16, seed 0) through phase 4's 1024^2 precompute and
    a predict, bitwise equal to the unmeshed predictor, and one f32 step each
    of JointSamTrainer, SimpleSamTrainer and SemanticSamTrainer (vit_b cut
    to 6 blocks) bitwise equal to the unmeshed trainer's, and the single
    process's runs of the ranks' work: at data = 2 phase 10's tiled precompute (two tiles a rank; rel 3e-2
    of the single process's) and the trained fixture's AMG at phase 11's cut
    (records at the default thresholds and at the floors matched as phase 11
    matches them, the candidates and each batch's survivors equal on both
    ranks); at model = 2 one 1024^2
    encode in bf16 (timed) and f32 with 48 gemm, 12 relpos_attention and 24 layernorm
    launches a rank (bf16 rel 3e-2, f32 1e-3 of the unsplit run); one f32
    SamTrainer step of vit_b cut to 6 blocks at data = 2 and at model = 2
    (every gradient within rel 1e-3 of its max of the single process's on the
    same global batch), and at data = 2 one f32 step each of JointSamTrainer
    (the SAM's and the decoder's gradients; a second step timed),
    MedSAMTrainer and SemanticSamTrainer held the same way; at model = 2 the
    LoRA and QLoRA vit_b encodes (bf16, the LoRA one timed, and f32; the same
    launches a rank and tolerances), one f32 LoRA step (its K1 / K4 launches
    counted, held the same way) and the f32 vit_t predict (whole on the model
    axis; IoU within 2e-4, masks equal on > 0.999); timed bf16 steps at
    train_sam's defaults at data = 2 with the gradient all-reduce's ms and
    bytes; the multi-process
    precompute into a shared cache under build/ (equal to the single process,
    the signature stamped once); then the gemm at vit_b's model = 2 shapes
    against its plain version, timed with F.linear and its bound. Prints the
    phase's wall time;
19. prints one JSON line of details (per-shape rows, chains, end-to-end and
    training numbers, the tiled routes, the AMG, AIS, multi-dimensional,
    joint-training, PEFT, evaluation, annotator and multi-GPU numbers), then the kernels line (one entry
    per kernel, vit_t chain and ViT attention half, the backward at head dim
    80, K12, the spatial mode of relpos_attention, K9 and K11: launches,
    max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms; for gemm the
    launches per plan of each model's encode; for the
    backward its stages, launches per stage variant and head dims; for
    relpos_attention also its launches per forward variant in one vit_b
    encode; phase 15's counts as ``launches_lora_*`` / ``launches_qlora_*``
    / ``launches_vit_t_training_step``; phase 18's per-rank launches of the
    model = 2 encode as ``launches_tp_vit_b_encode``) and, last, the device
    line.
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
BWD_BF16_TOL = 3e-2   # K4 in bf16 against the f32 plain backward on the same inputs
ENCODE_BATCH, ENCODE_REPS, DECODE_REPS = 8, 5, 30
TRAIN_WARMUP, TRAIN_REPS = 3, 5
TRAIN_REPS_VIT_L = 3
PROFILER_SESSIONS = 10


def log(*a):
    print(*a, flush=True)


MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep


def runs_recorded(acts):
    """The device activities of a profiler session, split into the runs
    between two recorded markers: each a list, in order of start."""
    acts = sorted(acts, key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(acts) if MARKER in e.name]
    return [acts[i + 1:j] for i, j in zip(marks, marks[1:])]


def time_ms(fn, iters=20, warmup=3):
    """Device time of one run of ``fn``: the summed durations of the kernels
    and copies it puts on the card, from torch.profiler (CUPTI), averaged over
    the runs recorded of ``iters``. The host's gaps between launches are not
    in it: small kernels launched from Python leave the card idle between
    them, which a pair of CUDA events around the run would count. A profiler
    session loses, now and then, the launches of its first milliseconds (one
    of 20 of a K4 call in every session of a run on the H100, 20 of 40 of a
    replay of four global launches: a mean over ``iters`` read low by as
    much), so each session runs ``fn`` ``warmup`` times, then the ``iters``
    runs, each followed by a marker kernel (``torch.cuda._sleep``), and
    averages over the runs between two recorded markers. A session that
    recorded no such run, or runs of unequal launch counts, is run again, up
    to ten times; should none record one, the run fails: there is no other
    timer."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(warmup):
                fn()
            torch.cuda._sleep(1000)
            for _ in range(iters):
                fn()
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        runs = runs_recorded(e for e in prof.events()
                             if e.device_type == torch.autograd.DeviceType.CUDA)
        if runs and len({len(r) for r in runs}) == 1 and runs[0]:
            return sum(e.time_range.elapsed_us() for r in runs for e in r) / 1e3 / len(runs)
        log(f"  (the profiler recorded {len(runs)} runs of {iters} "
            f"(launches {sorted({len(r) for r in runs})}), session {attempt + 1} of "
            f"{PROFILER_SESSIONS})")
    raise RuntimeError(f"torch.profiler recorded no whole run of {iters} in "
                       f"{PROFILER_SESSIONS} sessions")


def check(name, got, ref, dtype_name, quiet=False, tol=None):
    """f32: relative error <= 1e-4; bf16: abs error <= 2e-2 * max|ref| (or
    ``tol``). A tuple of outputs is checked output by output; returns the
    largest absolute error."""
    if isinstance(got, tuple):
        return max(check(f"{name} [{i}]", g, r, dtype_name, quiet, tol)
                   for i, (g, r) in enumerate(zip(got, ref)))
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values in the kernel output")
    a = float((got - ref).abs().max())
    rel = a / (float(ref.abs().max()) + 1e-30)
    if tol is None:
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
        from micro_sam_tpu_torch.ops.gemm import RESIDUAL_EPILOGUES
        (M, K), N = x.shape, a[1].shape[0]
        residual = len(a) > 3 and a[3] in RESIDUAL_EPILOGUES
        ops = 2 * M * N * K
        nbytes = (M * K + N * K + M * N * (2 if residual else 1)) * s + N * 4
    elif name == "relpos_attention":
        B, nH, N, hd = x.shape
        H, W = a[5]
        ops = B * nH * (4 * N * N * hd + 2 * N * (H + W) * hd)
        nbytes = 4 * B * nH * N * hd * s + (H * H + W * W) * hd * s
    elif name == "relpos_attention_spatial":  # (B, Hp, Wp, nH, hd) maps of w x w windows
        B, Hp, Wp, nH, hd = x.shape
        w = a[5]
        n_win, N = B * (Hp // w) * (Wp // w), w * w
        ops = n_win * nH * (4 * N * N * hd + 4 * N * w * hd)
        nbytes = 4 * B * Hp * Wp * nH * hd * s + 2 * w * w * hd * s
    elif name == "dwconv":  # SIMT multiply-adds, no tensor cores
        ops, nbytes, rate = 18 * x.numel(), 2 * x.numel() * s + 11 * x.shape[-1] * 4, PEAK_F32
    elif name == "tiny_attention":
        M, C3 = x.shape
        nH, N = a[1].shape
        ops = 4 * M * N * (C3 // 3)  # (M / N) windows x nH heads x 4 N^2 hd
        nbytes = M * C3 * s + M * (C3 // 3) * s + nH * N * 4
    else:  # relpos_attention_backward: S again, dP, dv, dk, dq; the tables' terms
        B, nH, N, hd = x.shape
        H, W = a[7]
        ops = B * nH * (10 * N * N * hd + 6 * N * (H + W) * hd)
        nbytes = 8 * B * nH * N * hd * s + (H * H + W * W) * hd * (s + 4)
    return ops / rate * 1e3, nbytes / PEAK_BYTES * 1e3


def bound_of(calls):
    """The least time for the calls' work: the larger of all their operations
    over the peak rate and all their bytes over the memory rate."""
    ops_ms = sum(work(n, a)[0] for n, a, _ in calls)
    bytes_ms = sum(work(n, a)[1] for n, a, _ in calls)
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def materialized_bias(q, rh, rw, hw, dt):
    """The rel-pos bias as an (B, nH, N, N) tensor in ``dt`` (for SDPA)."""
    B, nH, N, hd = q.shape
    H, W = hw
    r_q = q.float().reshape(B, nH, H, W, hd)
    return (torch.einsum("bnijc,ikc->bnijk", r_q, rh.float())[..., :, None]
            + torch.einsum("bnijc,jkc->bnijk", r_q, rw.float())[..., None, :]
            ).reshape(B, nH, N, N).to(dt)


def sdpa_backward(q, k, v, rh, rw, hw, dout):
    """A closure running only the backward of SDPA with the rel-pos bias
    materialized as a float tensor that requires grad: the yardstick of the
    backward kernel (gradients of q, k, v and the N x N bias). The forward and
    the bias build run here, outside any timing."""
    import torch.nn.functional as F
    leaves = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]
    bias = materialized_bias(q, rh, rw, hw, q.dtype).requires_grad_()
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(*leaves, attn_mask=bias)
    g = dout.contiguous()

    def run():
        with torch.enable_grad():
            return torch.autograd.grad(out, leaves + [bias], g, retain_graph=True)
    return run


def counterparts(name, a, kw):
    """(kernel, plain, library, f32 reference) closures of one kernel call.
    The library one is a PyTorch call computing the same function, its inputs
    made here, outside any timing (the rel-pos bias is materialized)."""
    import torch.nn.functional as F
    from micro_sam_tpu_torch.ops.dwconv import dwconv, dwconv_plain
    from micro_sam_tpu_torch.ops.gemm import gemm, gemm_plain
    from micro_sam_tpu_torch.ops.layernorm import layernorm, layernorm_plain
    from micro_sam_tpu_torch.ops.relpos_attention import (
        relpos_attention, relpos_attention_backward, relpos_attention_backward_plain,
        relpos_attention_plain)
    from micro_sam_tpu_torch.ops.tiny_attention import (bias_offset_index, tiny_attention,
                                                        tiny_attention_plain)
    x = a[0]
    dt = x.dtype
    f32 = lambda t: None if t is None or not torch.is_tensor(t) else t.float()
    if name == "layernorm":  # the mask, given or from the grid (K9), multiplied in
        from micro_sam_tpu_torch.ops.layernorm import grid_mask
        _, w, b, eps = a[:4]
        v = a[4] if len(a) > 4 else None
        grid = a[5] if len(a) > 5 else None
        wd, bd = w.to(dt), b.to(dt)
        mask = v if grid is None else grid_mask(x.shape[0], grid, x.device)
        vd = None if mask is None else mask.reshape(-1, 1).to(dt)
        ln = lambda: F.layer_norm(x, (x.shape[1],), wd, bd, eps)
        return (lambda: layernorm(*a), lambda: layernorm_plain(*a),
                ln if vd is None else (lambda: ln() * vd),
                lambda: layernorm_plain(x.float(), w, b, eps, v, grid))
    if name == "gemm":
        _, w, b = a[:3]
        epi, r = (a[3] if len(a) > 3 else "none"), (a[4] if len(a) > 4 else None)
        bd = b.to(dt)
        lin = lambda: F.linear(x, w, bd)
        lib = {"none": lin, "gelu": lambda: F.gelu(lin()), "residual": lambda: r + lin(),
               "residual_gelu": lambda: F.gelu(r + lin())}[epi]
        return (lambda: gemm(*a), lambda: gemm_plain(*a), lib,
                lambda: gemm_plain(x.float(), w.float(), b, epi, f32(r)))
    if name == "dwconv":  # cuDNN's depthwise conv, the BN folded into its weight and bias
        _, w, sc, sh = a[:4]
        gelu = a[4] if len(a) > 4 else kw.get("gelu", False)
        xc = x.permute(0, 3, 1, 2)  # channels-last NCHW view
        wf, bf = (w.float() * sc.float().view(-1, 1, 1, 1)).to(dt), sh.to(dt)
        conv = lambda: F.conv2d(xc, wf, bf, padding=1, groups=x.shape[-1])
        return (lambda: dwconv(*a, **kw), lambda: dwconv_plain(*a, **kw),
                (lambda: F.gelu(conv())) if gelu else conv,
                lambda: dwconv_plain(x.float(), w, sc, sh, gelu))
    if name == "tiny_attention":  # SDPA on (windows, nH, N, hd) with the bias gathered
        _, table, shape, w = a
        nH, N = table.shape
        hd = x.shape[1] // (3 * nH)
        B, Hp, Wp = shape
        t = x.view(B, Hp // w, w, Wp // w, w, nH, 3, hd).permute(6, 0, 1, 3, 5, 2, 4, 7)
        q, k, v = t.reshape(3, -1, nH, N, hd).contiguous().unbind(0)
        bias = table.float()[:, bias_offset_index(w, x.device)].to(dt)
        return (lambda: tiny_attention(*a), lambda: tiny_attention_plain(*a),
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias),
                lambda: tiny_attention_plain(x.float(), table, shape, w))
    if name == "relpos_attention_backward":
        q, k, v, out, dout, rh, rw, hw = a
        return (lambda: relpos_attention_backward(*a, **kw),
                lambda: relpos_attention_backward_plain(*a),
                sdpa_backward(q, k, v, rh, rw, hw, dout),
                lambda: relpos_attention_backward_plain(*(t.float() for t in a[:7]), hw))
    if name == "relpos_attention_spatial":  # SDPA on the windows, partitioned here
        from micro_sam_tpu_torch.ops.relpos_attention import (
            _windows, relpos_attention_spatial, relpos_attention_spatial_plain)
        q, k, v, rh, rw, w = a
        qw, kw_, vw = (_windows(t, w) for t in (q, k, v))
        bias = materialized_bias(qw, rh, rw, (w, w), dt)
        return (lambda: relpos_attention_spatial(*a, **kw),
                lambda: relpos_attention_spatial_plain(*a),
                lambda: F.scaled_dot_product_attention(qw, kw_, vw, attn_mask=bias),
                lambda: relpos_attention_spatial_plain(q.float(), k.float(), v.float(),
                                                       rh.float(), rw.float(), w))
    q, k, v, rh, rw, hw = a
    bias = materialized_bias(q, rh, rw, hw, dt)
    return (lambda: relpos_attention(*a, **kw), lambda: relpos_attention_plain(*a),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias),
            lambda: relpos_attention_plain(q.float(), k.float(), v.float(), rh.float(),
                                           rw.float(), hw))


class Recorder:
    """Records every kernel call the block chains make, (name, args, kwargs),
    by wrapping the kernel table of each chain module (``ops/fused_*.py``,
    default the ViT blocks'); each call still launches its kernel and counts
    as before. The recorded tensors stay alive for replay."""

    def __init__(self, *names):
        import importlib
        self.modules = [importlib.import_module(f"micro_sam_tpu_torch.ops.{n}")
                        for n in (names or ("fused_window_block",))]

    def __enter__(self):
        self.saved, self.calls = [m._KERNELS for m in self.modules], []

        def wrap(fn):
            def call(*a, **kw):
                self.calls.append((fn.__name__, a, kw))
                return fn(*a, **kw)
            return call
        for m, kernels in zip(self.modules, self.saved):
            m._KERNELS = tuple(wrap(f) for f in kernels)
        return self

    def __exit__(self, *exc):
        for m, kernels in zip(self.modules, self.saved):
            m._KERNELS = kernels


def replay(calls, iters=10):
    """(kernel ms, plain ms, library ms) of the calls run back to back: the
    device time of one run of the whole sequence (``time_ms``)."""
    fns = [counterparts(*c) for c in calls]
    return tuple(time_ms(lambda: [f[i]() for f in fns], iters=iters, warmup=2)
                 for i in range(3))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def relpos_variant(a):
    """The forward kernel's variant (``forward_plan``) for a relpos_attention
    call's arguments, with its dtype: the f32 kernel has one form."""
    from micro_sam_tpu_torch.ops.relpos_attention import forward_plan, kernel_head_dim
    B, nH, N, hd = a[0].shape
    H, W = a[5]
    if a[0].dtype == torch.float32:
        return "f32 simt"
    return forward_plan(N, H, W, kernel_head_dim(hd)).variant


def measure_calls(calls, dname, shapes):
    """Each (name, args, kwargs, label) call against its f32 reference, then
    timed as the kernel, the plain version and the library call; one row per
    call into ``shapes[name]`` (relpos_attention's with its variant)."""
    for name, a, kw, label in calls:
        kern, plain, lib, ref = counterparts(name, a, kw)
        err = check(f"{name} {label}", kern(), ref(), dname)
        k_ms = time_ms(kern)
        p_ms = time_ms(plain, iters=5 if name == "relpos_attention" else 20)
        l_ms = time_ms(lib)
        b_ms, b_by = bound_of([(name, a, kw)])
        row = dict(shape=label, dtype=dname, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                   library_ms=l_ms, bound_ms=b_ms, bound_by=b_by)
        if name == "relpos_attention":
            row["variant"] = relpos_variant(a)
        if name == "gemm":
            row["plan"] = gemm_plan_label(a)
        shapes[name].append(row)
        log(f"    {('variant ' + row['variant'] + '  ') if 'variant' in row else ''}"
            f"{('plan ' + row['plan'] + '  ') if 'plan' in row else ''}"
            f"ms {k_ms:.4f}  plain_ms {p_ms:.4f}  library_ms {l_ms:.4f}  "
            f"bound_ms {b_ms:.4f} ({b_by})")


def vit_gemm_shapes(width, blocks_win, blocks_glob):
    """The four products of a ViT block at ``width``, on the window rows and
    on the global rows of one 1024^2 image: (label, M, N, K, epilogue,
    launches per encode)."""
    return tuple((f"{p} {M}", M, N, K, epi, n)
                 for M, n in ((WIN_ROWS, blocks_win), (GLOB_ROWS, blocks_glob))
                 for p, N, K, epi in (("qkv", 3 * width, width, "none"),
                                      ("proj", width, width, "residual"),
                                      ("lin1", 4 * width, width, "gelu"),
                                      ("lin2", width, 4 * width, "residual")))


# every distinct gemm shape of one batch-1 1024^2 encode, with its launches
# per encode: (label, M, N, K, epilogue, launches)
GEMM_SHAPES = {
    "vit_b": vit_gemm_shapes(768, 8, 4),
    "vit_l": vit_gemm_shapes(1024, 20, 4),
    "vit_h": vit_gemm_shapes(1280, 28, 4),
    "vit_t": (("MBConv expand", 65536, 256, 64, "gelu", 2),
              ("MBConv shrink", 65536, 64, 256, "residual_gelu", 2),
              ("s1 qkv", 17689, 384, 128, "none", 2), ("s1 proj", 17689, 128, 128, "residual", 2),
              ("s1 lin1", 16384, 512, 128, "gelu", 2), ("s1 lin2", 16384, 128, 512, "residual", 2),
              ("s2 qkv", 4900, 480, 160, "none", 6), ("s2 proj", 4900, 160, 160, "residual", 6),
              ("s2 lin1", 4096, 640, 160, "gelu", 6), ("s2 lin2", 4096, 160, 640, "residual", 6),
              ("s3 qkv", 4900, 960, 320, "none", 2), ("s3 proj", 4900, 320, 320, "residual", 2),
              ("s3 lin1", 4096, 1280, 320, "gelu", 2),
              ("s3 lin2", 4096, 320, 1280, "residual", 2)),
}


def gemm_plan_label(a):
    """The bf16 kernel's plan for a gemm call (``ops.gemm.gemm_plan``), or
    the kernel's fixed tiling where the package has no plan."""
    from micro_sam_tpu_torch.ops import gemm as gemm_mod
    x, w = a[0], a[1]
    if x.dtype != torch.bfloat16:
        return "f32 simt 64x64"
    if not hasattr(gemm_mod, "gemm_plan"):
        return "wmma 128x128, a block per tile"
    return str(gemm_mod.gemm_plan(x.shape[0], w.shape[0], x.shape[1],
                                  a[3] if len(a) > 3 else "none"))


def gemm_sweep(model, shapes=None, seed=4242):
    """The bf16 gemm at every distinct shape of ``model``'s encode
    (``GEMM_SHAPES``, or ``shapes``): held against the plain version in f32 on
    the same inputs, timed as the kernel and as F.linear + its epilogue, with
    its bound and plan; then the sums per encode (each shape times its
    launches)."""
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, torch.bfloat16)

    cases = []
    for label, M, N, K, epi, n in shapes or GEMM_SHAPES[model]:
        a = (rnd(M, K), rnd(N, K, scale=K ** -0.5), rnd(N, scale=0.1).float(), epi)
        if epi in ("residual", "residual_gelu"):
            a += (rnd(M, N),)
        cases.append((f"{label} ({M}x{K})({K}x{N}) {epi}", a, n))
    return sweep_rows("gemm", model, cases)


# the depthwise shapes of one batch-1 1024^2 vit_t encode with their launches
# per encode: (label, H, W, C, gelu, launches)
DWCONV_SHAPES = (("MBConv", 256, 256, 256, True, 2), ("s1 tail", 128, 128, 128, False, 2),
                 ("s2 tail", 64, 64, 160, False, 6), ("s3 tail", 64, 64, 320, False, 2))


def dwconv_sweep(seed=4343):
    """The bf16 dwconv at each depthwise shape of the vit_t encode
    (``DWCONV_SHAPES``): held against the plain version in f32 on the same
    inputs, timed as the kernel and as cuDNN's depthwise convolution (BN
    folded, F.gelu), with its bound and tile; then the sums per encode (each
    shape times its launches)."""
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(seed)
    cases = []
    for label, H, W, Cc, gelu, n in DWCONV_SHAPES:
        a = ((torch.randn(1, H, W, Cc, generator=g)).to(dev, torch.bfloat16),
             (torch.randn(Cc, 1, 3, 3, generator=g) / 3).to(dev),
             (torch.randn(Cc, generator=g) * 0.2 + 1).to(dev),
             (torch.randn(Cc, generator=g) * 0.1).to(dev), gelu)
        cases.append((f"{label} (1, {H}, {W}, {Cc}){' gelu' if gelu else ''}", a, n))
    return sweep_rows("dwconv", "vit_t", cases)


def _vit_layernorm_shapes(width, win_blocks, glob_blocks):
    """A ViT encode's layernorm shapes: LN1 (masked) and LN2 of the windowed
    blocks on the window rows, both of the global blocks on the global rows."""
    return ((f"LN1 ({WIN_ROWS}, {width}) masked", WIN_ROWS, width, "valid", win_blocks),
            (f"LN2 ({WIN_ROWS}, {width})", WIN_ROWS, width, None, win_blocks),
            (f"LN1 / LN2 ({GLOB_ROWS}, {width})", GLOB_ROWS, width, None, 2 * glob_blocks))


# the layernorm shapes of one batch-1 1024^2 encode of each model, with their
# launches per encode (the K9 rows: LN1 in the grid mode on the padded maps
# of the spatial route, per vit_b / vit_h encode and per vit_b 4-tile batch):
# (label, rows, C, mask: "valid" read, "grid" from the row's position, or
# None, launches)
LAYERNORM_SHAPES = {
    "vit_b": _vit_layernorm_shapes(768, 8, 4),
    "vit_l": _vit_layernorm_shapes(1024, 20, 4),
    "vit_h": _vit_layernorm_shapes(1280, 28, 4),
    "vit_t": (("s1 attention (17689, 128)", 17689, 128, None, 2),
              ("s1 MLP (16384, 128)", 16384, 128, None, 2),
              ("s2 attention (4900, 160)", 4900, 160, None, 6),
              ("s2 MLP (4096, 160)", 4096, 160, None, 6),
              ("s3 attention (4900, 320)", 4900, 320, None, 2),
              ("s3 MLP (4096, 320)", 4096, 320, None, 2)),
    "vit_b K9": (("LN1 (1, 70, 70, 768) grid", 4900, 768, "grid", 8),),
    "vit_b K9 4-tile batch": (("LN1 (4, 70, 70, 768) grid", 19600, 768, "grid", 8),),
    "vit_h K9": (("LN1 (1, 70, 70, 1280) grid", 4900, 1280, "grid", 28),),
}


def kernel_plan_label(name, a):
    """The plan the kernel takes for a gemm, dwconv, layernorm or
    tiny_attention call (``gemm_plan``, ``dwconv_plan``, ``layernorm_plan``,
    ``tiny_attention_plan``), or the fixed layout of a package without one."""
    if name == "gemm":
        return gemm_plan_label(a)
    if name == "dwconv":
        from micro_sam_tpu_torch.ops.dwconv import _alignment, dwconv_plan
        x = a[0]
        return str(tuple(dwconv_plan(*x.shape, x.element_size(), _alignment(x))))
    if name == "layernorm":
        from micro_sam_tpu_torch.ops import layernorm as mod
        if not hasattr(mod, "layernorm_plan"):
            return "a warp a row, 8 a block"
        from micro_sam_tpu_torch.ops.dwconv import _alignment
        x, w, b = a[:3]
        return str(mod.layernorm_plan(*x.shape, x.element_size(), _alignment(x, w, b)))
    from micro_sam_tpu_torch.ops import tiny_attention as mod
    qkv, table, (B, Hp, Wp), w = a
    if qkv.dtype != torch.bfloat16:
        return "f32 simt"
    if not hasattr(mod, "tiny_attention_plan"):
        return "a block of 4 warps per (window, head)"
    return str(mod.tiny_attention_plan(B, Hp, Wp, qkv.shape[1] // 3, table.shape[0], w))


def sweep_rows(name, model, cases):
    """Each (label, args, launches) call of ``name`` in bf16 against its plain
    version in f32 on the same inputs, timed as the kernel and as its library
    call, with its bound and plan; then the sums per encode (each shape times
    its launches)."""
    rows = []
    for label, a, n in cases:
        kern, _, lib, ref = counterparts(name, a, {})
        err = check(f"{name} {model} {label}", kern(), ref(), "bfloat16", quiet=True)
        k_ms, l_ms = time_ms(kern), time_ms(lib)
        b_ms, b_by = bound_of([(name, a, {})])
        rows.append(dict(model=model, shape=label, launches_per_encode=n, dtype="bfloat16",
                         max_abs_err=err, ms=k_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                         plan=kernel_plan_label(name, a)))
        log(f"    {name} {model} {label:<44s} x{n:<3d} ms {k_ms:.4f}  library_ms {l_ms:.4f}  "
            f"bound_ms {b_ms:.4f} ({b_by})  share of bound {b_ms / k_ms:.3f}  plan {rows[-1]['plan']}")
    tot = {k: sum(r[k] * r["launches_per_encode"] for r in rows)
           for k in ("ms", "library_ms", "bound_ms")}
    log(f"  {name} {model}, the shapes times their launches: ms {tot['ms']:.4f}  "
        f"library_ms {tot['library_ms']:.4f}  bound_ms {tot['bound_ms']:.4f}  share of bound "
        f"{tot['bound_ms'] / tot['ms']:.3f}")
    torch.cuda.empty_cache()
    return rows


def layernorm_sweep(model, seed=4444):
    """The bf16 layernorm at each shape of ``model``'s encode
    (``LAYERNORM_SHAPES``), masked as the encode masks it, against plain,
    timed with F.layer_norm (times the mask), bound, plan, sums per encode."""
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(seed)
    cases = []
    for label, M, Cc, mask, n in LAYERNORM_SHAPES[model]:
        a = ((torch.randn(M, Cc, generator=g) * 3).to(dev, torch.bfloat16),
             (torch.randn(Cc, generator=g) * 0.5 + 1).to(dev),
             (torch.randn(Cc, generator=g) * 0.1).to(dev), 1e-6,
             (torch.rand(M, generator=g) > 0.2).float().to(dev) if mask == "valid" else None)
        if mask == "grid":
            a += ((70, 70, 64, 64),)
        cases.append((label, a, n))
    return sweep_rows("layernorm", model, cases)


TINY_ATTN_LAUNCHES = {1: 2, 2: 6, 3: 2}  # launches per vit_t encode of each stage


def tiny_attention_sweep(seed=4545):
    """The bf16 tiny_attention at the three stage shapes of the vit_t encode
    (``TINY_ATTN_SHAPES``) against plain, timed with SDPA (bias gathered),
    bound, plan, sums per encode."""
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(seed)
    cases = []
    for Hp, Cc, nH, w, st in TINY_ATTN_SHAPES:
        a = (torch.randn(Hp * Hp, 3 * Cc, generator=g).to(dev, torch.bfloat16),
             (torch.randn(nH, w * w, generator=g) * 0.5).to(dev), (1, Hp, Hp), w)
        cases.append((f"stage {st} (1, {Hp}, {Hp}, {Cc}) {nH} heads, window {w}", a,
                      TINY_ATTN_LAUNCHES[st]))
    return sweep_rows("tiny_attention", "vit_t", cases)


def host_us(name, launches=1000):
    """Host microseconds a gemm, layernorm or tiny_attention call costs
    (wrapper, plan, tensor maps, launch): a host clock around ``launches``
    calls of a small bf16 shape on the same inputs (one weight), before the
    synchronize."""
    from micro_sam_tpu_torch.ops.gemm import gemm
    from micro_sam_tpu_torch.ops.layernorm import layernorm
    from micro_sam_tpu_torch.ops.tiny_attention import tiny_attention
    g = torch.Generator(device="cpu").manual_seed(8)
    if name == "gemm":
        x, w = (torch.randn(256, 256, generator=g).to("cuda", torch.bfloat16) for _ in range(2))
        b = torch.zeros(256, device="cuda")
        call, shape = lambda: gemm(x, w, b), "(256x256)(256x256)"
    elif name == "layernorm":
        x = torch.randn(256, 768, generator=g).to("cuda", torch.bfloat16)
        w, b = torch.ones(768, device="cuda"), torch.zeros(768, device="cuda")
        call, shape = lambda: layernorm(x, w, b, 1e-6), "(256, 768)"
    else:
        qkv = torch.randn(14 * 14, 384, generator=g).to("cuda", torch.bfloat16)
        table = torch.zeros(4, 49, device="cuda")
        call, shape = lambda: tiny_attention(qkv, table, (1, 14, 14), 7), "(1, 14, 14, 128)"
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        call()
    us = (time.perf_counter() - t0) / launches * 1e6
    torch.cuda.synchronize()
    log(f"  {name} host cost: {us:.2f} us a call (host clock around {launches} calls of {shape})")
    return us


def sass_check(lib, tag, ops):
    """The library ``lib`` as built: no spill in any of its kernels (ptxas),
    and, where the toolkit has cuobjdump, each instruction of ``ops`` in the
    SASS of every kernel whose name holds ``tag``; fails if one has none (or
    no kernel has the tag). Returns the counts of those kernels."""
    from micro_sam_tpu_torch.ops import _cuda
    d = _cuda.build_dir()
    with open(os.path.join(d, f"{lib}.log")) as f:
        spills = [ln.strip() for ln in f if "spill" in ln and " 0 bytes spill stores" not in ln]
    if spills:
        raise AssertionError(f"{lib}: ptxas spills: {spills}")
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        log(f"  {lib} SASS: the toolkit has no cuobjdump; not checked")
        return None
    sass = subprocess.run([tool, "-sass", os.path.join(d, f"lib{lib}.so")], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(ops, 0)
        elif fn is not None:
            for op in ops:
                counts[fn][op] += op in line
    mine = {k: v for k, v in counts.items() if tag in k}
    log(f"  {lib} SASS: {len(counts)} kernels, {len(mine)} with '{tag}'; {' / '.join(ops)} "
        f"instructions each: {sorted({tuple(v.values()) for v in mine.values()})}")
    if not mine or any(0 in v.values() for v in mine.values()):
        raise AssertionError(f"{lib}: a '{tag}' kernel without {ops}: {counts}")
    return mine


def kernel_phase(counters, width=C, heads=NH, halves=False, attn_heads=()):
    """The three ViT kernels and a block's chains against their plain versions
    at the shapes of one 1024^2 encode of a model ``width`` wide with ``heads``
    heads, bf16 and f32. The chains are the whole blocks (K2, K3: 7 launches
    a call) or, with ``halves``, the attention halves (K10, K5: 4).
    ``attn_heads``: more (heads, head dim) pairs to hold relpos_attention at,
    at the same window and global shapes."""
    from micro_sam_tpu_torch.models.image_encoder import Block, get_rel_pos, partition_tokens
    from micro_sam_tpu_torch.models.common import init_module_
    from micro_sam_tpu_torch.ops import fused_window_block as fwb

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1234)
    Cw, nH = width, heads
    hd, hidden = Cw // nH, 4 * Cw

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    shapes = {"layernorm": [], "gemm": [], "relpos_attention": []}
    chains = []
    valid_win = partition_tokens(torch.ones(1, 64, 64, 1, device=dev), 14)[1].reshape(-1)

    for dt, dname in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        log(f"-- {dname}")
        calls = []  # (name, args, kwargs, label) at the main path's shapes
        for M in (WIN_ROWS, GLOB_ROWS):  # LN1 (masked on window rows) and LN2
            x = rnd(M, Cw, scale=3.0).to(dt)
            w, b = rnd(Cw, scale=0.5) + 1, rnd(Cw, scale=0.1)
            for v in ((valid_win, None) if M == WIN_ROWS else (None,)):
                calls.append(("layernorm", (x, w, b, 1e-6, v), {},
                              f"({M}, {Cw}){' masked' if v is not None else ''}"))
        for M in (WIN_ROWS, GLOB_ROWS):  # the four products of a block
            for pname, K, N, epi in (("qkv", Cw, 3 * Cw, "none"), ("proj", Cw, Cw, "residual"),
                                     ("lin1", Cw, hidden, "gelu"), ("lin2", hidden, Cw, "residual")):
                r = rnd(M, N).to(dt) if epi == "residual" else None
                a = (rnd(M, K).to(dt), rnd(N, K, scale=K ** -0.5).to(dt), rnd(N, scale=0.1), epi)
                calls.append(("gemm", a + ((r,) if r is not None else ()), {},
                              f"{pname} ({M}x{K})({K}x{N}) {epi}"))
        for (h, d), (B, H) in ((hh, bh) for hh in ((nH, hd),) + tuple(attn_heads)
                               for bh in ((25, 14), (1, 64))):
            N = H * H  # straight from the qkv rows, into the proj rows
            q5 = rnd(B * N, 3, h, d).to(dt).view(B, N, 3, h, d)
            q, k, v = (q5[:, :, i].transpose(1, 2) for i in range(3))
            rh = get_rel_pos(H, H, rnd(2 * H - 1, d, scale=0.3)).to(dt)
            rw = get_rel_pos(H, H, rnd(2 * H - 1, d, scale=0.3)).to(dt)
            out = torch.empty(B, N, h, d, device=dev, dtype=dt).transpose(1, 2)
            calls.append(("relpos_attention", (q, k, v, rh, rw, (H, H)), {"out": out},
                          f"({B}, {h}, {N}, {d})"))
        measure_calls(calls, dname, shapes)
        del calls

        # the chains at batch 1: launches counted, work and library time
        # from the calls recorded in one chain run
        def chain(name, label, run, run_plain, x, expect):
            got = run(x)
            err = check(label, got, run_plain(x.float()), dname)
            before = {k: c.launches for k, c in counters.items()}
            with Recorder() as rec:
                run(x)
            launches = {k: c.launches - before[k] for k, c in counters.items()
                        if c.launches != before[k]}
            if launches != expect:
                raise AssertionError(f"{label}: launches {launches}, not {expect}")
            k_ms = time_ms(lambda: run(x))
            p_ms = time_ms(lambda: run_plain(x), iters=5)
            l_ms = replay(rec.calls)[2]
            b_ms, b_by = bound_of(rec.calls)
            chains.append(dict(name=name, shape=label, dtype=dname, max_abs_err=err, ms=k_ms,
                               plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                               launches=launches))
            log(f"    launches {launches}  ms {k_ms:.4f}  plain_ms {p_ms:.4f}  library_ms "
                f"(its calls, each as a library call) {l_ms:.4f}  bound_ms {b_ms:.4f} ({b_by})")

        blk = Block(Cw, nH, 4.0, 14, (14, 14))
        init_module_(blk, g)
        blk = blk.hold_weights_in_(dt).to(dev)
        gblk = Block(Cw, nH, 4.0, 0, (64, 64))
        init_module_(gblk, g)
        gblk = gblk.hold_weights_in_(dt).to(dev)
        valid = valid_win.reshape(25, 196, 1)
        xw, xg = rnd(25, 196, Cw).to(dt), rnd(1, 4096, Cw).to(dt)
        if halves:
            chain("fused_window_attn", f"fused_window_attn chain (K10) (25, 196, {Cw}) masked",
                  lambda x: fwb.fused_window_attn(x, valid, blk, (14, 14), nH),
                  lambda x: fwb.fused_window_attn_plain(x, valid, blk, (14, 14), nH), xw,
                  CHAIN_LAUNCHES["fused_window_attn"])
            chain("fused_global_attn", f"fused_global_attn chain (K5) (1, 4096, {Cw})",
                  lambda x: fwb.fused_global_attn(x, gblk, (64, 64), nH),
                  lambda x: fwb.fused_global_attn_plain(x, gblk, (64, 64), nH), xg,
                  CHAIN_LAUNCHES["fused_global_attn"])
        else:
            seven = {"layernorm": 2, "gemm": 4, "relpos_attention": 1}
            chain("fused_window_block", f"fused_window_block chain (K2) (25, 196, {Cw}) masked",
                  lambda x: fwb.fused_window_block(x, valid, blk, (14, 14), nH),
                  lambda x: fwb.fused_window_block_plain(x, valid, blk, (14, 14), nH), xw, seven)
            chain("fused_global_block", f"fused_global_block chain (K3) (1, 4096, {Cw})",
                  lambda x: fwb.fused_global_block(x, gblk, (64, 64), nH),
                  lambda x: fwb.fused_global_block_plain(x, gblk, (64, 64), nH), xg, seven)
        del blk, gblk, xw, xg
        torch.cuda.empty_cache()
    return shapes, chains


def swept_shapes_check(model, calls):
    """The layernorm and tiny_attention shapes of a recorded encode of
    ``model`` against the sweeps' tables (``LAYERNORM_SHAPES``,
    ``TINY_ATTN_SHAPES``), launches per shape included: the sweeps time what
    the encode runs."""
    import collections
    want = collections.Counter()
    for _, M, Cc, _, n in LAYERNORM_SHAPES.get(model, ()):
        want[("layernorm", M, Cc)] += n
    if model == "vit_t":
        for Hp, Cc, _, _, st in TINY_ATTN_SHAPES:
            want[("tiny_attention", Hp * Hp, 3 * Cc)] += TINY_ATTN_LAUNCHES[st]
    seen = collections.Counter((c[0],) + tuple(c[1][0].shape) for c in calls
                               if c[0] in {k[0] for k in want})
    if seen != want:
        raise AssertionError(f"{model}: the encode's shapes {dict(seen)} are not the sweeps' "
                             f"{dict(want)}")


def encode_replay_phase(predictor, x1, counters, launches, n_images, chains=None,
                        chain_launches=None, model=None):
    """Records one batch-1 encode of the main path's model and image, then
    replays each kernel's launches of it on their own inputs: against the f32
    plain version (the check), and timed, back to back, as the kernel, as the
    plain version and as library calls. ``chains`` (``TINY_CHAINS`` or
    ``VIT_CHAINS``) with ``chain_launches``, each chain's launches in the main
    path (``ChainLaunches``): the chain calls are recorded too, and replayed
    by ``chain_replay``."""
    import importlib
    chains = chains or ()
    before = {k: c.launches for k, c in counters.items()}
    home, tables = CHAIN_HOME[chains] if chains else (None, ())
    module = importlib.import_module(f"micro_sam_tpu_torch.{home}") if chains else None
    chain_recs = [CallRecorder(module, n) for n in chains]
    with Recorder(*tables) as rec:
        for r in chain_recs:
            r.__enter__()
        try:
            predictor.encode_batch(x1)
        finally:
            for r in chain_recs:
                r.__exit__()
    torch.cuda.synchronize()
    per_encode = {k: c.launches - before[k] for k, c in counters.items()}
    log(f"  launches in one recorded encode: {per_encode}")
    if any(per_encode[k] * n_images != launches[k] for k in counters):
        raise AssertionError("one encode's launches are not the main path's per image")
    swept_shapes_check(model, rec.calls)
    out = {}
    for name in counters:
        calls = [c for c in rec.calls if c[0] == name]
        if not calls:
            continue
        err = 0.0
        for c in calls:
            kern, _, _, ref = counterparts(*c)
            err = max(err, check(f"{name} on main-path inputs", kern(), ref(), "bfloat16",
                                 quiet=True))
        k_ms, p_ms, l_ms = replay(calls)
        b_ms, b_by = bound_of(calls)
        out[name] = dict(launches_per_encode=per_encode[name], max_abs_err=err, ms=k_ms,
                         plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by)
        if name == "gemm":  # launches per plan
            plans = [gemm_plan_label(c[1]) for c in calls]
            out[name]["plans"] = {k: plans.count(k) for k in sorted(set(plans))}
        if name == "relpos_attention":  # launches per variant, each variant replayed alone
            out[name]["variants"] = {}
            for var in sorted({relpos_variant(c[1]) for c in calls}):
                mine = [c for c in calls if relpos_variant(c[1]) == var]
                kerns = [counterparts(*c)[0] for c in mine]
                v_ms = time_ms(lambda: [f() for f in kerns], iters=10, warmup=2)
                v_b, v_by = bound_of(mine)
                out[name]["variants"][var] = dict(launches=len(mine), ms=v_ms, bound_ms=v_b,
                                                  bound_by=v_by)
                log(f"    variant {var}: {len(mine)} launches, ms {v_ms:.4f}, bound_ms "
                    f"{v_b:.4f} ({v_by})")
        log(f"  {name}: {len(calls)} launches of one encode, max_abs_err {err:.3e}; ms {k_ms:.4f}"
            f"  plain_ms {p_ms:.4f}  library_ms {l_ms:.4f}  bound_ms {b_ms:.4f} ({b_by})")
    del rec
    if chains:
        out["chains"] = {}
        for r in chain_recs:
            out["chains"][r.name] = chain_replay(r.calls, chain_launches[r.name])
            r.calls.clear()
            torch.cuda.empty_cache()
    return out


KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
               "bound_ms", "bound_by", "library_ms")


def summarize(shapes, launches, per_encode, bwd_rows, train_launches, k4, tiny, lh, ft,
              host):
    """One entry per kernel, per vit_t chain and per ViT attention half (K5,
    K10). launches: the count of the path the kernel is on (vit_b serving for
    layernorm, gemm and relpos_attention, whose vit_t, training, vit_h and
    vit_l counts are ``launches_vit_t_path`` / ``launches_training_path`` /
    ``launches_vit_h_path`` / ``launches_vit_l_path``; training for the
    backward; vit_t serving for dwconv, tiny_attention and the vit_t chains;
    vit_h serving for K5 and K10). ms, plain_ms, library_ms, bound_ms: the
    kernel's launches (a chain's calls) of one batch-1 bf16 1024^2 encode of
    its model, and the backward's calls of one training step, replayed back
    to back on their own inputs; shapes: the per-shape checks and timings of
    phases 3, 5, 7 and 8 (the vit_h widths, head dim 80). Phase 9 adds the
    backward at head dim 80 (launches and times of the vit_h training path,
    one vit_h step's calls) and K12 (launches and times of its own path:
    two calls through attention_with_rel_pos, forward and backward). The
    gemm entry adds the launches per plan of each model's encode; the gemm,
    layernorm and tiny_attention entries the host microseconds a call costs
    (``host``, by kernel)."""
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
            "shapes": rows + tiny["shapes"].get(name, []) + lh["shapes"][name],
        })
        for m in ("vit_h", "vit_l"):
            out[-1][f"launches_{m}_path"] = lh[m]["launches"][name]
            out[-1][m] = lh[m]["per_encode"][name]
        if name == "gemm":
            out[-1]["plans"] = {"vit_b": e["plans"], "vit_t": tiny["per_encode"][name]["plans"],
                                **{m: lh[m]["per_encode"][name]["plans"]
                                   for m in ("vit_h", "vit_l")}}
        if name in host:
            out[-1]["host_us"] = host[name]
        out[-1]["max_abs_err"] = max([out[-1]["max_abs_err"]] + [
            r["max_abs_err"] for r in lh["shapes"][name]])
        if name == "relpos_attention":
            out[-1]["variants"] = {k: v["launches"] for k, v in e["variants"].items()}
            out[-1]["variants_vit_h"] = {
                k: v["launches"] for k, v in lh["vit_h"]["per_encode"][name]["variants"].items()}
            out[-1]["launches_training_path"] = train_launches[name]
            for m in ("vit_h", "vit_l"):
                out[-1][f"launches_{m}_training_path"] = ft[m]["launches"][name]
        else:
            out[-1]["launches_vit_t_path"] = tiny["launches"][name]
            out[-1]["vit_t"] = tiny["per_encode"][name]
    out.append({
        "name": "relpos_attention_backward", "route": "cuda",
        "source": "micro_sam_tpu_torch/csrc/relpos_attention_bwd.cu",
        "replaces": "micro_sam_tpu/ops/flash_attention.py:619 (_flash_backward_qkv; kernel "
                    "_flash_bwd_kernel :409)",
        "launches": train_launches["relpos_attention_backward"],
        "max_abs_err": max([k4["max_abs_err"]] + [r["max_abs_err"] for r in bwd_rows]),
        "ms": k4["ms"], "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"], "library_ms": k4["library_ms"],
        "calls_per_step": k4["calls_per_step"],
        "stages": "0 prep (u rows, D, lse2), 1 dk/dv, 2 dq (with dSr / dSc), 3 table gradients",
        "variants": k4["launches_by_variant"],
        "head_dims": "built for 32, 64, 80, 96, 128 and 256; any head dim up to 256 staged into "
                     "the next built one; above 256 refused",
        "per": "all calls of one vit_b bf16 training step (batch 2 of 1024^2), back to back",
        "shapes": bwd_rows, "launches_vit_l_training_path":
            ft["vit_l"]["launches"]["relpos_attention_backward"], "vit_l": ft["vit_l"]["k4"],
    })
    k4h = ft["vit_h"]["k4"]
    out.append({
        "name": "relpos_attention_backward (head dim 80)", "route": "cuda",
        "source": "micro_sam_tpu_torch/csrc/relpos_attention_bwd.cu",
        "replaces": "micro_sam_tpu/ops/flash_attention.py:619 (_flash_backward_qkv; kernel "
                    "_flash_bwd_kernel :409)",
        "launches": ft["vit_h"]["launches"]["relpos_attention_backward"],
        "max_abs_err": max([k4h["max_abs_err"]] + [r["max_abs_err"] for r in ft["bwd_rows"]]),
        "ms": k4h["ms"], "plain_ms": k4h["plain_ms"], "bound_ms": k4h["bound_ms"],
        "bound_by": k4h["bound_by"], "library_ms": k4h["library_ms"],
        "calls_per_step": k4h["calls_per_step"], "variants": k4h["launches_by_variant"],
        "per": "all calls of one vit_h bf16 training step (batch 2 of 1024^2), back to back",
        "shapes": ft["bwd_rows"],
    })
    k12 = ft["k12"]
    out.append({
        "name": "flash_attention_rel_pos (K12)", "route": "cuda",
        "source": "micro_sam_tpu_torch/ops/flash_attention.py (csrc/relpos_attention.cu, "
                  "csrc/relpos_attention_bwd.cu)",
        "replaces": "micro_sam_tpu/ops/flash_attention.py:151 (_flash_forward -> "
                    "flash_attention_rel_pos :204, kernel _flash_kernel :41)",
        "launches": k12["launches"], "max_abs_err": max(r["max_abs_err"] for r in ft["k12_rows"]),
        "ms": k12["ms"], "plain_ms": k12["plain_ms"], "bound_ms": k12["bound_ms"],
        "bound_by": k12["bound_by"], "library_ms": k12["library_ms"],
        "launches_by_kernel": k12["by_kernel"],
        "per": "forward and backward of (1, 4096, 12, 64) and (25, 196, 16, 80) in bf16 through "
               "attention_with_rel_pos, back to back",
        "shapes": ft["k12_rows"],
    })
    vit_t = "all {} of one 1024x1024 vit_t bf16 encode at batch 1, back to back"
    for name, source, replaces in (
            ("dwconv", "micro_sam_tpu_torch/csrc/dwconv.cu",
             "micro_sam_tpu/ops/fused_mbconv.py:57 (_mbconv_kernel depthwise); "
             "ops/fused_tiny_tail.py:31 (_tiny_tail_kernel local conv)"),
            ("tiny_attention", "micro_sam_tpu_torch/csrc/tiny_attention.cu",
             "micro_sam_tpu/ops/fused_tiny_attention.py:60 (_tiny_attn_kernel attention core)")):
        e = tiny["per_encode"][name]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": tiny["launches"][name], "max_abs_err": max(
                [e["max_abs_err"]] + [r["max_abs_err"] for r in tiny["shapes"][name]]),
            "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"], "library_ms": e["library_ms"],
            "launches_per_encode": e["launches_per_encode"], "per": vit_t.format("launches"),
            "shapes": tiny["shapes"][name],
        })
        if name in host:
            out[-1]["host_us"] = host[name]
    for name, tag, replaces in (
            ("fused_mbconv", "K7", "micro_sam_tpu/ops/fused_mbconv.py:120 (_mbconv_fused_forward "
             ":106 -> fused_mbconv :147, kernel _mbconv_kernel :57)"),
            ("fused_tiny_attention", "K6", "micro_sam_tpu/ops/fused_tiny_attention.py:174 "
             "(_tiny_fused_forward :145 -> fused_tiny_attention :224, kernel _tiny_attn_kernel :60)"),
            ("fused_tiny_tail", "K8", "micro_sam_tpu/ops/fused_tiny_tail.py:94 (_tail_fused_forward "
             ":69 -> fused_tiny_tail :128, kernel _tiny_tail_kernel :31)")):
        e = tiny["per_encode"]["chains"][name]
        rows = [r for r in tiny["chains"] if r["name"] == name]
        out.append({
            "name": f"{name} chain ({tag})", "route": "cuda",
            "source": f"micro_sam_tpu_torch/ops/{name}.py", "replaces": replaces,
            "launches": e["launches"],
            "max_abs_err": max([e["max_abs_err"]] + [r["max_abs_err"] for r in rows]),
            "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"], "library_ms": e["library_ms"],
            "calls_per_encode": e["calls_per_encode"], "per": vit_t.format("calls"),
            "shapes": rows,
        })
    vit_h = "all calls of one 1024x1024 vit_h bf16 encode at batch 1, back to back"
    for name, tag, replaces in (
            ("fused_global_attn", "K5", "micro_sam_tpu/ops/fused_window_block.py:976 "
             "(fused_global_attn :1114 -> _fused_global_forward :891, kernel "
             "_fused_global_kernel :681 with mlp=False)"),
            ("fused_window_attn", "K10", "micro_sam_tpu/ops/fused_window_block.py:527 "
             "(fused_window_attn :636 -> _fused_forward :346, kernel _fused_block_kernel :76 "
             "with mlp=False)")):
        e = lh["vit_h"]["per_encode"]["chains"][name]
        rows = [r for r in lh["chains"] if r["name"] == name]
        out.append({
            "name": f"{name} chain ({tag})", "route": "cuda",
            "source": "micro_sam_tpu_torch/ops/fused_window_block.py (csrc/layernorm.cu, "
                      "csrc/gemm.cu, csrc/relpos_attention.cu)", "replaces": replaces,
            "launches": e["launches"],
            "max_abs_err": max([e["max_abs_err"]] + [r["max_abs_err"] for r in rows]),
            "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"], "library_ms": e["library_ms"],
            "calls_per_encode": e["calls_per_encode"], "per": vit_h,
            "vit_l": lh["vit_l"]["per_encode"]["chains"][name], "shapes": rows,
        })
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def main_path_inputs():
    """The main path's grey 1024^2 image and (3, 768, 1024) volume, and the
    image as the encoder's (1, 1024, 1024, 3) float32 pixels."""
    from micro_sam_tpu_torch.util import _to_image
    rng = np.random.RandomState(0)
    image = rng.randint(0, 256, size=(1024, 1024)).astype(np.uint8)
    volume = rng.randint(0, 256, size=(3, 768, 1024)).astype(np.uint8)
    return image, volume, _to_image(image)[None].astype(np.float32)


def cpu_reference_encode(root, model_type, threads):
    """The plain f32 encode of ``main_path_inputs``' image on the CPU, seed
    0 (a process of its own, started before phase 3): (NHWC numpy, seconds)."""
    sys.path.insert(0, root)
    torch.set_grad_enabled(False)
    torch.set_num_threads(threads)
    from micro_sam_tpu_torch.models.sam import preprocess
    from micro_sam_tpu_torch.util import get_sam_model
    t0 = time.perf_counter()
    px = preprocess(torch.from_numpy(main_path_inputs()[2]))
    ref = get_sam_model(model_type, seed=0, device="cpu").model.encode_image(px).float()
    return ref.numpy(), time.perf_counter() - t0


def main_path_phase(counters, model_type="vit_b", chains=None, reference="cpu", cpu_ref=None):
    """``model_type``'s serving path: precompute, seven predicts, launch counts
    (``expected_launches``), each chain call's launches (``chains``), encode /
    decode times, the encode replay and the embedding against the plain f32
    run of the same weights: on the CPU (``reference="cpu"``; ``cpu_ref``, a
    future of ``cpu_reference_encode``, where one was started), or on the card
    (``"card"``, for vit_l / vit_h, whose f32 encode takes minutes on the
    CPU)."""
    from micro_sam_tpu_torch.util import (get_sam_model, precompute_image_embeddings,
                                          set_precomputed)
    from micro_sam_tpu_torch.models.sam import preprocess

    image, volume, x1 = main_path_inputs()

    for c in counters.values():
        c.launches = 0
    with ChainLaunches(counters, chains or ()) as chain_counts:
        predictor = get_sam_model(model_type, seed=0)
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
        outs["volume slice 1, 1 point"] = predictor.predict(np.array([[500., 300.]]),
                                                            np.array([1]))
        torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}

    n_images = 1 + volume.shape[0]
    per_image = expected_launches(predictor.model.config)
    expect = {k: per_image.get(k, 0) * n_images for k in counters}
    log(f"  launches in the main path: {launches} (expected {expect} for {n_images} images)")
    if launches != expect:
        raise AssertionError("the main path did not go through the kernels as expected")
    if chains:
        calls = {k: v * n_images for k, v in expected_chain_calls(predictor.model.config).items()}
        log(f"  chain launches in the main path, counted around each call: "
            f"{chain_counts.launches} in {chain_counts.calls} calls (expected {calls} calls)")
        if sum(chain_counts.launches.values()) != sum(launches.values()):
            raise AssertionError("the main path launched kernels outside its chains")
        if chain_counts.calls != calls:
            raise AssertionError("the main path did not call its chains as expected")

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
    log("  one batch-1 encode under torch.profiler:")
    prof = profile_step(lambda: (predictor.encode_batch(x1), torch.cuda.synchronize()),
                        SERVE_PROFILE_GROUPS)
    per_encode = encode_replay_phase(predictor, x1, counters, launches, n_images, chains,
                                     chain_counts.launches, model_type)

    # the embedding against the same weights' plain f32 run
    px = preprocess(torch.from_numpy(x1))
    f32 = get_sam_model(model_type, seed=0, compute_dtype="float32")
    got32 = f32.model.encode_image(px.cuda()).float().cpu()
    t0 = time.perf_counter()
    if reference == "cpu" and cpu_ref is not None:
        ref, seconds = cpu_ref.result()
        ref = torch.from_numpy(ref)
        where, tol16, drift = "CPU", 3e-2, {}
        log(f"  (the CPU reference took {seconds:.1f} s in a process of its own)")
    elif reference == "cpu":
        ref = get_sam_model(model_type, seed=0, device="cpu").model.encode_image(px).float()
        where, tol16, drift = "CPU", 3e-2, {}
    else:  # block by block through the plain versions on the card, f32 and bf16
        ref = plain_encode(f32.model, px.cuda()).float().cpu()
        plain16 = plain_encode(predictor.model, px.cuda()).float().cpu()
        bf16_drift = float((plain16 - ref).abs().max() / ref.abs().max())
        where, tol16 = "the card's", max(3e-2, 1.5 * bf16_drift)
        drift = {"plain_bf16_rel": bf16_drift}
        log(f"  plain bf16 chain on the card vs plain f32: rel {bf16_drift:.3e}; the bf16 "
            f"kernel path is held to max(3e-2, 1.5 x that) = {tol16:.3e}")
    torch.cuda.synchronize()
    log(f"  {where} f32 reference encode: {time.perf_counter() - t0:.1f} s")
    ref_nchw = ref.permute(0, 3, 1, 2).numpy()
    rels = {}
    for name, got, tol in (("f32 kernel path", got32.permute(0, 3, 1, 2).numpy(), 1e-3),
                           ("bf16 kernel path", feats, tol16)):
        rel = rels[name] = float(np.abs(got - ref_nchw).max() / np.abs(ref_nchw).max())
        log(f"  embedding {name} vs {where} plain f32: rel {rel:.3e} (tol {tol:g}) "
            f"{'ok' if rel <= tol else 'FAIL'}")
        if not rel <= tol:
            raise AssertionError(f"{name} embedding disagrees with the plain f32 reference")
    del predictor, f32
    torch.cuda.empty_cache()
    return launches, per_encode, {"model": model_type, "encode_ms_b1": t_enc[1],
                                  "encode_ms_b8": t_enc[ENCODE_BATCH],
                                  "tiles_per_s_b8": 1e3 / t_enc[ENCODE_BATCH],
                                  "decode_p50_ms": dec_p50, "profiled_encode_b1": prof,
                                  "embedding_rel": {**rels, **drift, "tol_bf16": tol16,
                                                    "reference": f"{where} plain f32"}}


def plain_encode(model, px):
    """The encoder block by block through the plain versions
    (``image_encoder.apply_block``), in the model's compute dtype."""
    from micro_sam_tpu_torch.models.image_encoder import apply_block
    enc = model.image_encoder
    x = enc._patch_embed(px.to(model.config.dtype))
    for blk in enc.blocks:
        x = apply_block(blk, x)
    return enc.neck(x)


def expected_chain_calls(cfg):
    """Chain calls of one encode: vit_t one K7 per MBConv, one K6 and one K8
    per attention block; a ViT one attention half (K5 global, K10 windowed)
    and one MLP half per block."""
    if cfg.encoder == "tiny_vit":
        from micro_sam_tpu_torch.models.tiny_vit import DEPTHS
        return {"fused_mbconv": DEPTHS[0], "fused_tiny_attention": sum(DEPTHS[1:]),
                "fused_tiny_tail": sum(DEPTHS[1:])}
    n_glob = len(cfg.global_attn_indexes)
    return {"fused_window_attn": cfg.depth - n_glob, "fused_global_attn": n_glob,
            "mlp_half": cfg.depth}


def expected_launches(cfg):
    """Kernel launches of one encode. vit_b: per block 2 layernorm, 4 gemm, 1
    relpos_attention. vit_t: 2 MBConvs x (2 gemm + 1 dwconv); 10 attention
    blocks x (K6: layernorm, 2 gemm, tiny_attention; K8: dwconv, layernorm,
    2 gemm)."""
    if cfg.encoder == "tiny_vit":
        from micro_sam_tpu_torch.models.tiny_vit import DEPTHS
        n_mb, n_blk = DEPTHS[0], sum(DEPTHS[1:])
        return {"gemm": 2 * n_mb + 4 * n_blk, "dwconv": n_mb + n_blk, "layernorm": 2 * n_blk,
                "tiny_attention": n_blk}
    return {"layernorm": 2 * cfg.depth, "gemm": 4 * cfg.depth, "relpos_attention": cfg.depth}


# ---------------------------------------------------------------------------
# phase 7: vit_t, its kernels and chains (K6, K7, K8)
# ---------------------------------------------------------------------------

TINY_CHAINS = ("fused_mbconv", "fused_tiny_attention", "fused_tiny_tail")
VIT_CHAINS = ("fused_window_attn", "fused_global_attn", "mlp_half")
# the encoder's two opt-in routes for windowed blocks (phase 10): K9 and K11
K9_CHAINS = ("fused_window_block_spatial", "fused_global_attn", "mlp_half")
K11_CHAINS = ("fused_window_stack", "fused_global_attn", "mlp_half")
WHOLE_BLOCK_CHAINS = ("fused_window_block_spatial", "fused_window_stack")
# a chain set -> (the module whose names the encoder calls its chains by, the
# ops modules whose kernel tables the chains launch through)
CHAIN_HOME = {TINY_CHAINS: ("models.tiny_vit", TINY_CHAINS),
              VIT_CHAINS: ("ops.fused_window_block", ("fused_window_block",)),
              K9_CHAINS: ("ops.fused_window_block", ("fused_window_block",)),
              K11_CHAINS: ("ops.fused_window_block", ("fused_window_block",))}
CHAIN_LAUNCHES = {"fused_mbconv": {"gemm": 2, "dwconv": 1},
                  "fused_tiny_attention": {"layernorm": 1, "gemm": 2, "tiny_attention": 1},
                  "fused_tiny_tail": {"dwconv": 1, "layernorm": 1, "gemm": 2},
                  "fused_window_attn": {"layernorm": 1, "gemm": 2, "relpos_attention": 1},
                  "fused_global_attn": {"layernorm": 1, "gemm": 2, "relpos_attention": 1},
                  "mlp_half": {"layernorm": 1, "gemm": 2},
                  "fused_window_block_spatial": {"layernorm": 2, "gemm": 4,
                                                 "relpos_attention_spatial": 1},
                  "fused_window_stack": {"layernorm": 2, "gemm": 4, "relpos_attention": 1}}


def chain_work(name, a):
    """(operations ms, bytes ms) of one chain call, counting only the
    block's own input and output and its weights (what a single fused pass
    would move); operations at the tensor-core rate of the working type."""
    x = a[0]
    s = x.element_size()
    rate = PEAK_BF16 if x.dtype == torch.bfloat16 else PEAK_F32
    C = x.shape[-1]
    M = x.numel() // C
    if name in WHOLE_BLOCK_CHAINS:  # a whole windowed block, K9 on the padded map
        blk, nH = (a[1], a[4]) if name == "fused_window_block_spatial" else (a[2], a[4])
        w = a[2] if name == "fused_window_block_spatial" else a[3][0]
        N, hd = w * w, C // nH
        ops = 24 * M * C * C + (M // N) * nH * (4 * N * N * hd + 4 * N * w * hd)
        weights = 12 * C * C * s + 2 * w * w * hd * s + 13 * C * 4
        weights += M * 4 if name == "fused_window_stack" and a[1] is not None else 0
    elif name in ("fused_window_attn", "fused_global_attn"):  # LN1, qkv, attention, proj
        valid, blk, (H, W), nH = (a[1:5] if name == "fused_window_attn"
                                  else (None, *a[1:4]))
        Bn, N = x.shape[0], x.shape[1]
        hd = C // nH
        ops = 8 * M * C * C + Bn * nH * (4 * N * N * hd + 2 * N * (H + W) * hd)
        weights = 4 * C * C * s + (H * H + W * W) * hd * s + 6 * C * 4
        weights += 0 if valid is None else M * 4
    elif name == "mlp_half":  # LN2, lin1 + GELU, lin2 + residual
        ops, weights = 16 * M * C * C, 8 * C * C * s + 7 * C * 4
    elif name == "fused_mbconv":
        hid = 4 * C
        ops, weights = 4 * M * C * hid + 18 * M * hid, 2 * C * hid * s + 13 * hid * 4
    elif name == "fused_tiny_attention":
        attn = a[1]
        N = attn.window ** 2
        ops = 8 * M * C * C + 4 * M * N * C
        weights = 4 * C * C * s + attn.num_heads * N * 4 + 6 * C * 4
    else:
        hid = 4 * C
        ops, weights = 4 * M * C * hid + 18 * M * C, 2 * C * hid * s + 16 * C * 4
    return ops / rate * 1e3, (2 * M * C * s + weights) / PEAK_BYTES * 1e3


def chain_counterparts(name, a, kw):
    """(kernel, plain, library, f32 reference) closures of one chain call.
    Library: K7 the cuDNN conv chain (1 x 1, depthwise, 1 x 1, BN folded,
    F.gelu); K6 F.layer_norm + F.linear + SDPA with the gathered float bias +
    F.linear; K8 cuDNN depthwise + F.layer_norm + two F.linear; K10 / K5
    F.layer_norm (* valid) + F.linear + SDPA with the rel-pos bias
    materialized + F.linear; the MLP half F.layer_norm + F.linear + F.gelu +
    F.linear. Folds and biases are made here, outside any timing."""
    import torch.nn.functional as F
    from micro_sam_tpu_torch.ops import fused_mbconv as k7
    from micro_sam_tpu_torch.ops import fused_tiny_attention as k6
    from micro_sam_tpu_torch.ops import fused_tiny_tail as k8
    from micro_sam_tpu_torch.ops import fused_window_block as fwb
    from micro_sam_tpu_torch.ops.tiny_attention import bias_offset_index
    x = a[0]
    dt = x.dtype
    if name in WHOLE_BLOCK_CHAINS:
        return whole_block_counterparts(name, a)
    if name in VIT_CHAINS:
        kern, plain = getattr(fwb, name), getattr(fwb, f"{name}_plain")
        off = 1 if name == "fused_window_attn" else 0  # its valid mask
        blk = a[1] if name == "mlp_half" else a[1 + off]
        Cx = x.shape[-1]
        f32_args = (x.float(),) + tuple(a[1:])
        if name == "mlp_half":
            w1, w2 = blk.mlp.lin1.weight, blk.mlp.lin2.weight
            n2w, n2b, b1, b2 = (t.to(dt) for t in (blk.norm2.weight, blk.norm2.bias,
                                                   blk.mlp.lin1.bias, blk.mlp.lin2.bias))

            def lib():
                h = F.layer_norm(x, (Cx,), n2w, n2b, blk.norm2.eps)
                return x + F.linear(F.gelu(F.linear(h, w1, b1)), w2, b2)
        else:
            valid = a[1] if name == "fused_window_attn" else None
            hw, nH = a[2 + off], a[3 + off]
            Bn, N = x.shape[0], x.shape[1]
            attn = blk.attn
            n1w, n1b, bq, bp = (t.to(dt) for t in (blk.norm1.weight, blk.norm1.bias,
                                                   attn.qkv.bias, attn.proj.bias))
            vd = None if valid is None else valid.to(dt)

            def qkv():
                h = F.layer_norm(x, (Cx,), n1w, n1b, blk.norm1.eps)
                h = h if vd is None else h * vd
                t = F.linear(h, attn.qkv.weight, bq).view(Bn, N, 3, nH, Cx // nH)
                return t.permute(2, 0, 3, 1, 4).unbind(0)
            rh, rw = attn.rel_tables(hw, dt)
            bias = materialized_bias(qkv()[0], rh, rw, hw, dt)

            def lib():
                o = F.scaled_dot_product_attention(*qkv(), attn_mask=bias)
                return x + F.linear(o.transpose(1, 2).reshape(Bn, N, Cx), attn.proj.weight, bp)
        return (lambda: kern(*a), lambda: plain(*a), lib, lambda: plain(*f32_args))
    B, H, W, C = x.shape
    xc = x.permute(0, 3, 1, 2)  # channels-last NCHW view for cuDNN
    if name == "fused_mbconv":
        blk = a[1]
        (w1, _, b1), (w2, _, b2), (w3, _, b3) = (c.folded(dt) for c in (blk.conv1, blk.conv2,
                                                                        blk.conv3))
        b1, b2, b3 = (b.to(dt) for b in (b1, b2, b3))

        def lib():
            h = F.gelu(F.conv2d(xc, w1, b1))
            h = F.gelu(F.conv2d(h, w2, b2, padding=1, groups=h.shape[1]))
            return F.gelu(xc + F.conv2d(h, w3, b3))
        return (lambda: k7.fused_mbconv(x, blk), lambda: k7.fused_mbconv_plain(x, blk), lib,
                lambda: k7.fused_mbconv_plain(x.float(), blk))
    if name == "fused_tiny_attention":
        attn = a[1]
        w, nH = attn.window, attn.num_heads
        N, hd = w * w, C // nH
        bias = attn.attention_biases.float()[:, bias_offset_index(w, x.device)].to(dt)
        lnw, lnb, bq, bp = (t.to(dt) for t in (attn.norm.weight, attn.norm.bias, attn.qkv.bias,
                                               attn.proj.bias))

        def lib():
            qkv = F.linear(F.layer_norm(x, (C,), lnw, lnb, attn.norm.eps), attn.qkv.weight, bq)
            t = qkv.view(B, H // w, w, W // w, w, nH, 3, hd).permute(6, 0, 1, 3, 5, 2, 4, 7)
            t = t.reshape(3, -1, nH, N, hd)
            o = F.scaled_dot_product_attention(t[0], t[1], t[2], attn_mask=bias)
            o = o.view(B, H // w, W // w, nH, w, w, hd).permute(0, 1, 4, 2, 5, 3, 6)
            return x + F.linear(o.reshape(B, H, W, C), attn.proj.weight, bp)
        return (lambda: k6.fused_tiny_attention(x, attn),
                lambda: k6.fused_tiny_attention_plain(x, attn), lib,
                lambda: k6.fused_tiny_attention_plain(x.float(), attn))
    lc, mlp = a[1], a[2]
    wf, _, shift = lc.folded(dt)
    shift = shift.to(dt)
    lnw, lnb, b1, b2 = (t.to(dt) for t in (mlp.norm.weight, mlp.norm.bias, mlp.fc1.bias,
                                           mlp.fc2.bias))

    def lib():
        t = F.conv2d(xc, wf, shift, padding=1, groups=C).permute(0, 2, 3, 1)
        h = F.gelu(F.linear(F.layer_norm(t, (C,), lnw, lnb, mlp.norm.eps), mlp.fc1.weight, b1))
        return t + F.linear(h, mlp.fc2.weight, b2)
    return (lambda: k8.fused_tiny_tail(x, lc, mlp), lambda: k8.fused_tiny_tail_plain(x, lc, mlp),
            lib, lambda: k8.fused_tiny_tail_plain(x.float(), lc, mlp))


def window_block_library(xw, vd, blk, w, nH):
    """A windowed block's seven steps as library calls over (BW, N, C)
    windows: F.layer_norm (times the pad mask ``vd`` in the working type, or
    None), F.linear, SDPA with the rel-pos bias materialized (here, from
    ``xw``, outside any timing), F.linear, F.layer_norm, F.linear + F.gelu,
    F.linear. Returns the function of the windows."""
    import torch.nn.functional as F
    dt, (Bn, N, C) = xw.dtype, xw.shape
    attn = blk.attn
    n1w, n1b, bq, bp, n2w, n2b, b1, b2 = (t.to(dt) for t in (
        blk.norm1.weight, blk.norm1.bias, attn.qkv.bias, attn.proj.bias, blk.norm2.weight,
        blk.norm2.bias, blk.mlp.lin1.bias, blk.mlp.lin2.bias))

    def qkv(x):
        h = F.layer_norm(x, (C,), n1w, n1b, blk.norm1.eps)
        h = h if vd is None else h * vd
        t = F.linear(h, attn.qkv.weight, bq).view(Bn, N, 3, nH, C // nH)
        return t.permute(2, 0, 3, 1, 4).unbind(0)
    rh, rw = attn.rel_tables((w, w), dt)
    bias = materialized_bias(qkv(xw)[0], rh, rw, (w, w), dt)

    def run(x):
        o = F.scaled_dot_product_attention(*qkv(x), attn_mask=bias)
        x1 = x + F.linear(o.transpose(1, 2).reshape(Bn, N, C), attn.proj.weight, bp)
        h = F.layer_norm(x1, (C,), n2w, n2b, blk.norm2.eps)
        return x1 + F.linear(F.gelu(F.linear(h, blk.mlp.lin1.weight, b1)), blk.mlp.lin2.weight, b2)
    return run


def whole_block_counterparts(name, a):
    """(kernel, plain, library, f32 reference) closures of one K9
    (``fused_window_block_spatial``) or K11 (``fused_window_stack``) call. The
    library is ``window_block_library`` over the windows; for K9 the
    partition of the padded map into windows and the way back are part of it
    (the library calls need them; the kernel chain does not)."""
    from micro_sam_tpu_torch.models.image_encoder import window_partition, window_unpartition
    from micro_sam_tpu_torch.ops import fused_window_block as fwb
    kern, plain = getattr(fwb, name), getattr(fwb, f"{name}_plain")
    x = a[0]
    dt = x.dtype
    if name == "fused_window_block_spatial":
        blk, w, (H, W), nH = a[1:5]
        B, Hp, Wp, C = x.shape
        vmap = torch.zeros(B, Hp, Wp, 1, device=x.device, dtype=dt)
        vmap[:, :H, :W] = 1
        vd = window_partition(vmap, w)[0].reshape(-1, w * w, 1)
        part = lambda: window_partition(x, w)[0].reshape(-1, w * w, C)
        run = window_block_library(part(), vd, blk, w, nH)

        def lib():
            return window_unpartition(run(part()).reshape(-1, w, w, C), w, (Hp, Wp), (Hp, Wp))
    else:
        valid, blk, (w, _), nH = a[1:5]
        run = window_block_library(x, None if valid is None else valid.to(dt), blk, w, nH)
        lib = lambda: run(x)
    return (lambda: kern(*a), lambda: plain(*a), lib, lambda: plain(x.float(), *a[1:]))


def chain_bound(calls):
    ops_ms = sum(chain_work(n, a)[0] for n, a, _ in calls)
    bytes_ms = sum(chain_work(n, a)[1] for n, a, _ in calls)
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def chain_replay(calls, launches):
    """One encode's calls of one chain, replayed: checked against the f32
    plain chain, then timed back to back as the kernel chain, the plain chain
    and the library calls (device time, ``time_ms``). ``launches``: the
    chain's launches in the main path, as ``ChainLaunches`` counted them."""
    fns = [chain_counterparts(*c) for c in calls]
    name = calls[0][0]
    err = max(check(f"{name} on main-path inputs", f[0](), f[3](), "bfloat16", quiet=True)
              for f in fns)
    k_ms, p_ms, l_ms = (time_ms(lambda: [f[i]() for f in fns], iters=10, warmup=2)
                        for i in range(3))
    b_ms, b_by = chain_bound(calls)
    row = dict(calls_per_encode=len(calls), launches=launches, max_abs_err=err, ms=k_ms,
               plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by)
    log(f"  {name} chain: {len(calls)} calls of one encode, max_abs_err {err:.3e}; ms {k_ms:.4f}"
        f"  plain_ms {p_ms:.4f}  library_ms {l_ms:.4f}  bound_ms {b_ms:.4f} ({b_by})")
    return row


class ChainLaunches:
    """Counts the kernel launches of each chain call while the main path
    runs: patches the names the encoder calls its chains by (``chains``,
    ``TINY_CHAINS`` in ``models/tiny_vit.py`` or ``VIT_CHAINS`` in
    ``ops/fused_window_block.py``) with wrappers that take the counters'
    deltas around each call and hold them against ``CHAIN_LAUNCHES``.
    ``launches`` / ``calls``: per chain, summed over the run. With no chains
    it patches nothing."""

    def __init__(self, counters, chains):
        self.counters, self.chains = counters, chains
        self.launches = {n: 0 for n in chains}
        self.calls = {n: 0 for n in chains}

    def __enter__(self):
        import importlib
        self.saved = {}
        if not self.chains:
            return self
        self.module = importlib.import_module(
            f"micro_sam_tpu_torch.{CHAIN_HOME[self.chains][0]}")
        self.saved = {n: getattr(self.module, n) for n in self.chains}

        def wrap(name, fn):
            def call(*a, **kw):
                before = {k: c.launches for k, c in self.counters.items()}
                out = fn(*a, **kw)
                delta = {k: c.launches - before[k] for k, c in self.counters.items()
                         if c.launches != before[k]}
                if delta != CHAIN_LAUNCHES[name]:
                    raise AssertionError(f"{name} on the main path: launches {delta}, not "
                                         f"{CHAIN_LAUNCHES[name]}")
                self.launches[name] += sum(delta.values())
                self.calls[name] += 1
                return out
            return call
        for n, fn in self.saved.items():
            setattr(self.module, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)


def random_tiny_vit(dt, dev, g):
    """A random vit_t encoder with non-trivial BatchNorm statistics."""
    from micro_sam_tpu_torch.models.common import BatchNorm, init_module_
    from micro_sam_tpu_torch.models.tiny_vit import TinyViT
    enc = TinyViT(dtype=dt)
    init_module_(enc, g)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.2)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
                m.weight.copy_(1 + torch.randn(m.weight.shape, generator=g) * 0.2)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.2)
    return enc.to(dev).eval()


TINY_ATTN_SHAPES = ((133, 128, 4, 7, 1), (70, 160, 5, 14, 2), (70, 320, 10, 7, 3))  # Hp, C, nH, w, stage
TINY_TAIL_SHAPES = ((128, 128, 1), (64, 160, 2), (64, 320, 3))  # H, C, stage


def tiny_kernel_phase(counters):
    """The vit_t kernels (tiny_attention, dwconv, the gemm's residual_gelu
    epilogue) and chains (K6, K7, K8) against their plain versions at the
    shapes of one 1024^2 encode, bf16 and f32, timed with bounds and yardsticks."""
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(5678)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    shapes = {"tiny_attention": [], "dwconv": [], "gemm": []}
    chains = []
    for dt, dname in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        log(f"-- {dname}")
        calls = []
        for Hp, Cc, nH, w, _ in TINY_ATTN_SHAPES:
            calls.append(("tiny_attention", (rnd(Hp * Hp, 3 * Cc).to(dt), rnd(nH, w * w, scale=0.5),
                                             (1, Hp, Hp), w), {},
                          f"(1, {Hp}, {Hp}, {Cc}) {nH} heads, window {w}"))
        for H, Cc, gelu in ((256, 256, True),) + tuple((h, c, False) for h, c, _ in TINY_TAIL_SHAPES):
            calls.append(("dwconv", (rnd(1, H, H, Cc).to(dt), rnd(Cc, 1, 3, 3, scale=1 / 3),
                                     rnd(Cc, scale=0.2) + 1, rnd(Cc, scale=0.1), gelu), {},
                          f"(1, {H}, {H}, {Cc}){' gelu' if gelu else ''}"))
        M, K, N = 256 * 256, 256, 64
        calls.append(("gemm", (rnd(M, K).to(dt), rnd(N, K, scale=K ** -0.5).to(dt),
                               rnd(N, scale=0.1), "residual_gelu", rnd(M, N).to(dt)), {},
                      f"MBConv shrink ({M}x{K})({K}x{N}) residual_gelu"))
        measure_calls(calls, dname, shapes)
        del calls

        enc = random_tiny_vit(dt, dev, g)
        runs = [("fused_mbconv", (rnd(1, 256, 256, 64).to(dt), enc.layers[0].blocks[0]),
                 "K7 (1, 256, 256, 64)")]
        for Hp, Cc, nH, w, st in TINY_ATTN_SHAPES:
            runs.append(("fused_tiny_attention", (rnd(1, Hp, Hp, Cc).to(dt),
                                                  enc.layers[st].blocks[0].attn),
                         f"K6 (1, {Hp}, {Hp}, {Cc}) window {w}"))
        for H, Cc, st in TINY_TAIL_SHAPES:
            blk = enc.layers[st].blocks[0]
            runs.append(("fused_tiny_tail", (rnd(1, H, H, Cc).to(dt), blk.local_conv, blk.mlp),
                         f"K8 (1, {H}, {H}, {Cc})"))
        for name, a, label in runs:
            kern, plain, lib, ref = chain_counterparts(name, a, {})
            err = check(f"{name} chain {label}", kern(), ref(), dname)
            before = {k: c.launches for k, c in counters.items()}
            kern()
            torch.cuda.synchronize()
            launches = {k: c.launches - before[k] for k, c in counters.items()
                        if c.launches != before[k]}
            if launches != CHAIN_LAUNCHES[name]:
                raise AssertionError(f"{name}: launches {launches}, not {CHAIN_LAUNCHES[name]}")
            k_ms, p_ms, l_ms = time_ms(kern), time_ms(plain, iters=5), time_ms(lib)
            b_ms, b_by = chain_bound([(name, a, {})])
            chains.append(dict(name=name, shape=label, dtype=dname, max_abs_err=err, ms=k_ms,
                               plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                               launches=launches))
            log(f"    launches {launches}  ms {k_ms:.4f}  plain_ms {p_ms:.4f}  library_ms "
                f"{l_ms:.4f}  bound_ms {b_ms:.4f} ({b_by})")
        del enc, runs
        torch.cuda.empty_cache()
    return shapes, chains


# ---------------------------------------------------------------------------
# phase 5: the backward kernel against its plain version
# ---------------------------------------------------------------------------

STAGES = ("prep", "dk/dv", "dq", "tables")


def backward_stage_fns(a, lse):
    """One closure per stage of K4 (``STAGES``) on a relpos_attention_backward
    call's own operands (at a built head dim, rows the kernel reads in place)
    and its forward's lse, each launching that stage alone into buffers of
    its own, in the variant ``backward_plan`` picks; run once in order here,
    so that each stage finds its predecessors' scratch. For timing: the
    wrapper's launch count does not see them."""
    from micro_sam_tpu_torch.ops import relpos_attention as rpa
    q, k, v, out, dout, rh, rw, (H, W) = a
    B, nH, N, hd = q.shape
    rht, rwt = rpa._tables(rh, rw, q.dtype, hd)
    outs = [torch.empty_like(q) for _ in range(3)]
    drh, drw = (torch.empty(s, s, hd, device=q.device) for s in (H, W))
    scratch = torch.empty(rpa._bwd_scratch_floats(B, nH, N, H, W), device=q.device)
    codes = (rpa.backward_plan(N, H, W, hd).codes if q.dtype == torch.bfloat16 else (0, 0, 0, 0))
    fns = [lambda s=s: rpa._backward_kernel(s, codes[s], [q, k, v, out, dout], lse, rht, rwt, outs,
                                            drh, drw, scratch, (B, nH, N, H, W), hd, hd ** -0.5)
           for s in range(4)]
    for f in fns:
        f()
    return fns


def backward_variants(a):
    """K4's bf16 variants of its dk/dv and dq stages for a call's arguments."""
    from micro_sam_tpu_torch.ops.relpos_attention import backward_plan, kernel_head_dim
    B, nH, N, hd = a[0].shape
    H, W = a[7]
    if a[0].dtype == torch.float32:
        return "f32 simt"
    plan = backward_plan(N, H, W, kernel_head_dim(hd))
    return f"dk/dv {plan.dkdv}, dq {plan.dq}"


def backward_phase(grids=((50, 14), (2, 64)), nH=NH, hd=HD, seed=4321):
    """K4 at the window and global shapes ((batch, grid side) pairs: vit_b's
    by default), q / k / v read from the qkv rows' strides, dout the
    transposed view of the proj product's rows and the forward's lse, as the
    training path gives them; in bf16 each stage also timed alone."""
    from micro_sam_tpu_torch.models.image_encoder import get_rel_pos
    from micro_sam_tpu_torch.ops.relpos_attention import relpos_attention
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(seed)
    NH, HD = nH, hd

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    rows = []
    for dt, dname in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        for B, H in grids:
            N = H * H
            q5 = rnd(B * N, 3, NH, HD).to(dt).view(B, N, 3, NH, HD)
            q, k, v = (q5[:, :, i].transpose(1, 2) for i in range(3))
            rh = get_rel_pos(H, H, rnd(2 * H - 1, HD, scale=0.3)).to(dt)
            rw = get_rel_pos(H, H, rnd(2 * H - 1, HD, scale=0.3)).to(dt)
            lse = torch.empty((B, NH, N), device=dev)
            out = relpos_attention(q, k, v, rh, rw, (H, H), lse=lse)
            dout = rnd(B, N, NH, HD).to(dt).transpose(1, 2)
            a = (q, k, v, out, dout, rh, rw, (H, H))
            kern, plain, lib, ref = counterparts("relpos_attention_backward", a, {"lse": lse})
            tol = F32_TOL if dt == torch.float32 else BWD_BF16_TOL
            label = f"relpos_attention_backward ({B}, {NH}, {N}, {HD}) dq dk dv drh drw"
            err = check(label, kern(), ref(), dname, tol=tol)
            k_ms = time_ms(kern)
            p_ms = time_ms(plain, iters=5)
            l_ms = time_ms(lib, iters=10)
            b_ms, b_by = bound_of([("relpos_attention_backward", a, {})])
            row = dict(shape=f"({B}, {NH}, {N}, {HD})", dtype=dname, variant=backward_variants(a),
                       max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                       bound_by=b_by)
            stages = ""
            if dt == torch.bfloat16:
                row["stage_ms"] = dict(zip(STAGES,
                                           (time_ms(f) for f in backward_stage_fns(a, lse))))
                stages = "; stages " + ", ".join(f"{k} {v:.4f}" for k, v in row["stage_ms"].items())
            rows.append(row)
            log(f"    {row['variant']}: ms {k_ms:.4f}  plain_ms {p_ms:.4f}  library_ms (SDPA "
                f"backward, bias grad) {l_ms:.4f}  bound_ms {b_ms:.4f} ({b_by}){stages}")
            del a, kern, plain, lib, ref, q5, q, k, v, out, dout, lse
            torch.cuda.empty_cache()
    return rows


# grids whose u tables need more than one key rectangle: (H, W, head dim), 2
# heads, batch 1 (a 336 x 336 map is vit_b's global grid at img_size 5376)
LARGE_GRIDS = ((336, 336, 64), (336, 336, 80), (32, 640, 64))


def large_grid_phase(seed=4545, nH=2):
    """K1 and K4 (bf16) on ``LARGE_GRIDS``: the forward's output and lse on 128
    sampled q rows (the map's corners among them) against the plain version's
    rows over all keys; the backward with dout zero outside 64 of them against
    the plain backward of those rows (dq, dk, dv, both table gradients); the
    launches per call (one a key rectangle, four a rectangle); both timed
    with their bound. Returns the forward's and the backward's rows."""
    from micro_sam_tpu_torch.ops import relpos_attention as rpa
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(seed)
    fwd_rows, bwd_rows = [], []
    for H, W, hd in LARGE_GRIDS:
        N = H * W
        x5 = torch.randn(1, N, 3, nH, hd, generator=g).to(dev, torch.bfloat16)
        q, k, v = (x5[:, :, i].transpose(1, 2) for i in range(3))
        rh = (torch.randn(H, H, hd, generator=g) * 0.3).to(dev, torch.bfloat16)
        rw = (torch.randn(W, W, hd, generator=g) * 0.3).to(dev, torch.bfloat16)
        sample = torch.cat([torch.tensor([0, W - 1, N - W, N - 1]),
                            torch.randperm(N, generator=g)[:124]]).unique().to(dev)
        lse = torch.empty((1, nH, N), device=dev)
        fplan, bplan = rpa.forward_plan(N, H, W, hd), rpa.backward_plan(N, H, W, hd)
        before = rpa.relpos_attention.launches
        out = rpa.relpos_attention(q, k, v, rh, rw, (H, W), lse=lse)
        torch.cuda.synchronize()
        f_launches = rpa.relpos_attention.launches - before
        if f_launches != len(fplan.rects):
            raise AssertionError(f"K1 {H}x{W}: {f_launches} launches, not {len(fplan.rects)}")
        ref, ref_lse = rpa.relpos_attention_plain_rows(q, k, v, rh, rw, (H, W), sample)
        label = f"({H}x{W}, {nH} heads of {hd}) {len(fplan.rects)} key rectangles"
        err = check(f"relpos_attention {label}, 128 rows", out[:, :, sample], ref, "bfloat16")
        check(f"relpos_attention {label}, lse of 128 rows", lse[:, :, sample], ref_lse,
              "float32")
        a = (q, k, v, rh, rw, (H, W))
        f_ms = time_ms(lambda: rpa.relpos_attention(*a, lse=lse), iters=3, warmup=1)
        b_ms, b_by = bound_of([("relpos_attention", a, {})])
        fwd_rows.append(dict(shape=f"(1, {nH}, {N}, {hd}) grid {H}x{W}", dtype="bfloat16",
                             variant=f"{fplan.variant} x{len(fplan.rects)}", max_abs_err=err,
                             ms=f_ms, bound_ms=b_ms, bound_by=b_by, launches=f_launches))
        log(f"    K1 {label}: ms {f_ms:.4f}  bound_ms {b_ms:.4f} ({b_by})")
        rows = sample[:64]
        dout = torch.zeros_like(q)
        dout[:, :, rows] = torch.randn(1, nH, len(rows), hd, generator=g).to(dev, torch.bfloat16)
        before = rpa.relpos_attention_backward.launches
        got = rpa.relpos_attention_backward(q, k, v, out, dout, rh, rw, (H, W), lse=lse)
        torch.cuda.synchronize()
        k_launches = rpa.relpos_attention_backward.launches - before
        if k_launches != 4 * len(bplan.rects):
            raise AssertionError(f"K4 {H}x{W}: {k_launches} launches, not {4 * len(bplan.rects)}")
        ref = rpa.relpos_attention_backward_plain_rows(q, k, v, out, dout, rh, rw, (H, W), rows)
        blabel = f"({H}x{W}, {nH} heads of {hd}) {len(bplan.rects)} key rectangles"
        err = check(f"relpos_attention_backward {blabel}, dout on 64 rows", got, ref,
                    "bfloat16", tol=BWD_BF16_TOL)
        ab = (q, k, v, out, dout, rh, rw, (H, W))
        k_ms = time_ms(lambda: rpa.relpos_attention_backward(*ab, lse=lse), iters=3, warmup=1)
        b_ms, b_by = bound_of([("relpos_attention_backward", ab, {})])
        bwd_rows.append(dict(shape=f"(1, {nH}, {N}, {hd}) grid {H}x{W}", dtype="bfloat16",
                             variant=f"dk/dv {bplan.dkdv}, dq {bplan.dq} x{len(bplan.rects)}",
                             max_abs_err=err, ms=k_ms, bound_ms=b_ms, bound_by=b_by,
                             launches=k_launches))
        log(f"    K4 {blabel}: ms {k_ms:.4f}  bound_ms {b_ms:.4f} ({b_by})")
        del x5, q, k, v, out, dout, got, ref, a, ab, lse
        torch.cuda.empty_cache()
    return fwd_rows, bwd_rows


# ---------------------------------------------------------------------------
# phase 6: finetuning
# ---------------------------------------------------------------------------

class CallRecorder:
    """Records every call of one module-level function, (name, args, kwargs),
    by patching the module attribute its callers look up; each call still
    runs (and counts) as before."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.saved = getattr(self.module, self.name)

        def call(*a, **kw):
            self.calls.append((self.name, a, kw))
            return self.saved(*a, **kw)
        # the wrapped function counts its launches on the object its module
        # name points to, which is now this wrapper
        call.launches = 0
        setattr(self.module, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


PROFILE_GROUPS = (  # kernel-name patterns -> the layer they belong to
    ("K4 relpos_attention_backward", ("prep_bf16_kernel", "dkdv_bf16_kernel", "dq_bf16_kernel",
                                      "relgrad_bf16_kernel")),
    ("K1 relpos_attention", ("relpos_attention_bf16_kernel",)),
    ("matrix products and convolutions (cuBLAS / cuDNN)", ("gemm", "nvjet", "sm90", "xmma",
                                                           "cutlass", "conv")),
    ("LayerNorm (PyTorch)", ("layer_norm",)),
    ("dtype casts and copies", ("copy_kernel",)),
)


SERVE_PROFILE_GROUPS = (  # the port's kernels first: cuBLAS names contain "gemm" too
    ("gemm (port kernel)", ("gemm_wgmma_kernel", "gemm_f32_kernel")),
    ("layernorm (port kernel)", ("layernorm_vec_kernel", "layernorm_general_kernel")),
    ("relpos_attention (port kernel)", ("relpos_attention_bf16_kernel",)),
    ("dwconv (port kernel)", ("dwconv_tma_kernel", "dwconv_plain_kernel")),
    ("tiny_attention (port kernel)", ("tiny_attention_tma_kernel", "tiny_attention_f32_kernel")),
    ("convolutions and products (cuDNN / cuBLAS)", ("conv", "nvjet", "sm90", "xmma", "cutlass",
                                                    "gemm")),
)


def profile_step(step, groups_of=PROFILE_GROUPS):
    """One step under torch.profiler: device time by layer and the top
    kernels, and the device's busy share of the step's host-clock time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy == 0:
        log("  profiled step: the profiler saw no device time (not measured)")
        return None
    groups = {name: 0.0 for name, _ in groups_of}
    groups["other (elementwise, reductions, copies)"] = 0.0
    for e in kernels:
        for name, pats in groups_of:
            if any(p in e.key for p in pats):
                groups[name] += e.self_device_time_total / 1e3
                break
        else:
            groups["other (elementwise, reductions, copies)"] += e.self_device_time_total / 1e3
    log(f"  profiled step (torch.profiler): host clock {wall:.3f} ms, device busy {busy:.3f} ms "
        f"(idle share {1 - busy / wall:.3f})")
    for name, ms in groups.items():
        log(f"    {name}: {ms:.3f} ms")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    for e in top:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:110]}")
    return {"host_ms": wall, "device_busy_ms": busy, "idle_share": 1 - busy / wall,
            "by_layer_ms": groups,
            "top_kernels": [[e.key[:110], e.self_device_time_total / 1e3, e.count] for e in top]}


def f32_step_grads(device, x, y, model_type="vit_b"):
    """(loss, {name: grad}) of one f32 point step (one round, 4 objects) of
    the randomly initialized ``model_type`` on ``device``."""
    from micro_sam_tpu_torch.training import SamTrainer, get_trainable_sam_model
    model = get_trainable_sam_model(model_type, device=device, compute_dtype="float32")
    trainer = SamTrainer("f32", None, None, model, n_sub_iteration=1, n_objects_per_batch=4,
                         logger=False)
    batch = trainer._prepare_batch(x, y, True, False, 1, 0)
    with torch.enable_grad():
        loss, _ = trainer._loss(*batch, True, False, True)
        loss.backward()
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).float().cpu()
             for n, p in model.sam.named_parameters()}
    return float(loss), grads


def training_data():
    """Six 512^2 synthetic patches (88-94 disks each) and their segmentations."""
    from micro_sam_tpu_torch.sample_data import synthetic_data
    data = [synthetic_data((512, 512), seed=s) for s in range(6)]
    n_obj = [int(seg.max()) for _, seg in data]
    log(f"  512^2 synthetic patches, objects per patch {n_obj}")
    if min(n_obj) < 25:
        raise AssertionError("a training patch holds fewer than 25 objects")
    return [d[0] for d in data], [d[1] for d in data]


def check_checkpoint(path, model_type, image, steps=2):
    """A trainer's best.pkl: ``steps`` iterations with a finite loss, and it
    loads into ``get_sam_model(model_type)`` for one predict on the card."""
    import pickle
    from micro_sam_tpu_torch.util import _to_image, get_sam_model
    with open(path, "rb") as f:
        ck = pickle.load(f)
    log(f"  best.pkl iteration {ck['iteration']}, metrics {ck['metrics']}")
    if ck["iteration"] != steps or not np.isfinite(ck["metrics"][0]["train_loss"]):
        raise AssertionError(f"the trainer did not take its {steps} steps")
    del ck
    predictor = get_sam_model(model_type, checkpoint_path=path)
    predictor.set_image(_to_image(image))
    m, iou, lo = predictor.predict(np.array([[256., 256.]]), np.array([1]))
    log(f"  best.pkl -> get_sam_model({model_type!r}) -> predict: masks {m.shape} "
        f"iou {np.round(iou, 4).tolist()}")
    if m.shape != (3, 512, 512) or not np.isfinite(iou).all() or not np.isfinite(lo).all():
        raise AssertionError("the finetuned checkpoint does not predict")
    del predictor
    torch.cuda.empty_cache()


def timed_steps(counters, model_type, train_loader, val_loader, batches, save_root,
                reps=TRAIN_REPS, peft_kwargs=None):
    """SamTrainer steps of ``model_type`` at train_sam's defaults (batch 2, 25
    objects, 8 rounds, lr 1e-5, bf16 compute, f32 weights): TRAIN_WARMUP
    warm-up and ``reps`` timed steps, the attention launches per step held to
    2 forward (with the recompute) and 4 backward per block, one profiled
    step, and one step's K4 calls recorded and replayed as the kernel, the
    plain version and SDPA backward; ``batches`` are the loader's, drawn
    once. With ``peft_kwargs`` the model of that PEFT surgery (its base
    frozen). Returns (k4, stats, the counters just after the timed steps)."""
    from micro_sam_tpu_torch.ops import relpos_attention as rpa
    from micro_sam_tpu_torch.training import SamTrainer, get_trainable_sam_model
    t_build = time.perf_counter()
    model = get_trainable_sam_model(model_type, device="cuda", peft_kwargs=peft_kwargs)
    log(f"  {model_type}: trainable model built in {time.perf_counter() - t_build:.1f} s")
    trainer = SamTrainer("timing", train_loader, val_loader, model, n_sub_iteration=8,
                         n_objects_per_batch=25, lr=1e-5, logger=False, save_root=save_root)

    def step(i):
        x, y = batches[i % len(batches)]
        use_points, use_box, multimask, n_pos, n_neg = \
            trainer._get_prompt_and_multimasking_choices(trainer._iteration)
        b = trainer._prepare_batch(x, y, use_points, use_box, n_pos, n_neg, batch_idx=i)
        if b[1].shape[:2] != (2, 25):
            raise AssertionError(f"the trainer sampled {tuple(b[1].shape[:2])} objects, not (2, 25)")
        with torch.enable_grad():
            loss, miou = trainer.train_step(b, use_points, use_box, multimask)
        torch.cuda.synchronize()
        return loss, miou

    for i in range(TRAIN_WARMUP):
        step(i)
    before = {n: p.detach().clone() for n, p in model.sam.named_parameters() if p.requires_grad}
    counts0 = {k: c.launches for k, c in counters.items()}
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(reps):
        t0 = time.perf_counter()
        loss, miou = step(TRAIN_WARMUP + i)
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    launches = {k: c.launches for k, c in counters.items()}
    per_step = {k: (launches[k] - counts0[k]) / reps for k in counters}
    depth = model.config.depth
    expect = {"relpos_attention": 2 * depth, "relpos_attention_backward": 4 * depth}
    log(f"  launches per timed step: {per_step} (expected {expect}: {depth} blocks x 2 forward "
        f"with the recompute, x 4 backward stages)")
    if any(per_step[k] != v for k, v in expect.items()) or any(
            per_step[k] for k in counters if k not in expect):
        raise AssertionError("a training step did not go through the attention kernels as expected")
    grads_ok = all(torch.isfinite(p.grad).all() for p in model.sam.parameters() if p.grad is not None)
    moved = sum(not torch.equal(before[n], p.detach()) for n, p in model.sam.named_parameters()
                if n in before)
    n_params = len(before)
    del before
    log(f"  bf16 steps: losses {losses}; grads finite {grads_ok}; {moved} of {n_params} "
        f"trainable parameter tensors moved")
    if not (np.isfinite(losses).all() and grads_ok and moved >= 0.9 * n_params):
        raise AssertionError("the bf16 training steps are not finite or did not move the weights")
    step_ms = statistics.median(times)
    log(f"  step ms (host clock incl. prompt sampling, median of {reps}): {step_ms:.3f} "
        f"(all {[round(t, 3) for t in times]}); images/s {2e3 / step_ms:.3f}; "
        f"peak memory {peak / 2**30:.3f} GiB")

    prof = profile_step(lambda: step(TRAIN_WARMUP + reps))

    # one step's backward calls, replayed
    with CallRecorder(rpa, "relpos_attention_backward") as rec:
        step(TRAIN_WARMUP + reps + 1)
    calls = rec.calls
    err = 0.0
    for name, a, kw in calls:
        kern, _, _, ref = counterparts(name, a, kw)
        err = max(err, check(f"{name} on training-step inputs", kern(), ref(), "bfloat16",
                             quiet=True, tol=BWD_BF16_TOL))
    k_ms, p_ms, l_ms = replay(calls, iters=5)
    b_ms, b_by = bound_of(calls)
    variants = {}
    for _, a, _ in calls:
        v = backward_variants(a)
        variants[v] = variants.get(v, 0) + 4
    k4 = dict(calls_per_step=len(calls), launches_by_variant=variants, max_abs_err=err, ms=k_ms,
              plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by)
    log(f"  relpos_attention_backward: {len(calls)} calls of one step, max_abs_err {err:.3e}; "
        f"ms {k_ms:.4f}  plain_ms {p_ms:.4f}  library_ms {l_ms:.4f}  bound_ms {b_ms:.4f} ({b_by})")
    del calls, rec, trainer, model
    torch.cuda.empty_cache()
    stats = {"model": model_type, "depth": depth, "peft": peft_kwargs,
             "batch": 2, "objects_per_image": 25, "n_sub_iteration": 8,
             "patch": 512, "compute_dtype": "bfloat16", "step_ms": step_ms, "step_ms_all": times,
             "images_per_s": 2e3 / step_ms, "peak_memory_bytes": peak,
             "launches_per_step": per_step, "losses": losses, "profiled_step": prof}
    return k4, stats, launches


def f32_step_grads_cpu(root, threads, x, y, model_type, depth=None, global_attn_indexes=None):
    """``f32_step_grads`` on the CPU in a process of its own (``threads``),
    ``model_type`` cut to ``depth`` blocks (``CutDepth``) when given."""
    import contextlib
    sys.path.insert(0, root)
    torch.set_num_threads(threads)
    with CutDepth(model_type, depth, global_attn_indexes) if depth else contextlib.nullcontext():
        return f32_step_grads("cpu", x, y, model_type)


def f32_step_check(x, y, model_type="vit_b", cpu_run=None):
    """One f32 step of ``model_type`` on the card against the same step on the
    CPU (here, or ``cpu_run``: the future of ``f32_step_grads_cpu`` on the
    same inputs): every gradient within rel 1e-3 of its max, the loss within
    1e-4. Returns (worst gradient rel, loss rel)."""
    t0 = time.perf_counter()
    loss_gpu, g_gpu = f32_step_grads("cuda", x, y, model_type)
    loss_cpu, g_cpu = cpu_run.result() if cpu_run is not None else \
        f32_step_grads("cpu", x, y, model_type)
    g_max = max(float(g.abs().max()) for g in g_cpu.values())
    worst, worst_name, n_held = 0.0, "", 0
    for name, ref in g_cpu.items():
        got = g_gpu[name]
        if float(ref.abs().max()) <= 1e-7 * g_max:  # zero by symmetry (key biases) or unused
            if float(got.abs().max()) > 1e-6 * g_max:
                raise AssertionError(f"f32 step: {name} should have no gradient")
            continue
        rel = float((got - ref).abs().max() / ref.abs().max())
        n_held += 1
        if rel > worst:
            worst, worst_name = rel, name
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    log(f"  f32 step card vs CPU ({time.perf_counter() - t0:.1f} s): loss {loss_gpu:.6f} vs "
        f"{loss_cpu:.6f} (rel {loss_rel:.2e}); worst gradient rel {worst:.3e} ({worst_name}) "
        f"over {n_held} tensors (tol 1e-3) {'ok' if worst <= 1e-3 else 'FAIL'}")
    if worst > 1e-3 or loss_rel > 1e-4:
        raise AssertionError("the f32 training step on the card disagrees with the CPU")
    return worst, loss_rel


class CutDepth:
    """``SAM_CONFIGS[model_type]`` at full width cut to its first ``depth``
    blocks while the block runs, the global ones ``global_attn_indexes``
    (default: the last): a path run at a smaller depth still takes both block
    kinds through their kernels."""

    def __init__(self, model_type, depth, global_attn_indexes=None):
        self.model_type, self.depth = model_type, depth
        self.globals = tuple(global_attn_indexes or (depth - 1,))

    def __enter__(self):
        import dataclasses
        from micro_sam_tpu_torch.models import build_sam
        self.saved = build_sam.SAM_CONFIGS[self.model_type]
        cfg = dataclasses.replace(self.saved, depth=self.depth,
                                  global_attn_indexes=self.globals)
        build_sam.SAM_CONFIGS[self.model_type] = cfg
        return cfg

    def __exit__(self, *exc):
        from micro_sam_tpu_torch.models import build_sam
        build_sam.SAM_CONFIGS[self.model_type] = self.saved


# the f32 parity steps: blocks (global ones) of the cut model; their CPU half
# runs in a process started at the phase's start
F32_STEP_CUT = {"vit_b": (6, (2, 5)), "vit_h": (4, (3,))}
F32_STEP_CPU_THREADS = 4


def f32_step_cpu_run(pool, root, batch, model_type):
    """The CPU half of ``f32_step_check`` on the first item of ``batch``, at
    F32_STEP_CUT's depth, submitted to ``pool``; returns the future."""
    depth, globs = F32_STEP_CUT[model_type]
    return pool.submit(f32_step_grads_cpu, root, F32_STEP_CPU_THREADS, batch[0][:1],
                       batch[1][:1], model_type, depth, globs)


def f32_step_card_check(batch, model_type, cpu_run):
    """``f32_step_check`` of ``model_type`` cut to F32_STEP_CUT's depth, the
    CPU half from ``cpu_run``. Returns (worst gradient rel, loss rel, blocks)."""
    depth, globs = F32_STEP_CUT[model_type]
    with CutDepth(model_type, depth, globs):
        log(f"  f32 step of {model_type} at full width, {depth} blocks (global at "
            f"{', '.join(map(str, globs))})")
        return f32_step_check(batch[0][:1], batch[1][:1], model_type, cpu_run) + (depth,)


def training_phase(counters, root):
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from micro_sam_tpu_torch.training.training import SamDataset, SamLoader

    imgs, segs = training_data()
    train_loader = SamLoader(SamDataset(imgs[:4], segs[:4], (512, 512), n_samples=4), batch_size=2)
    val_loader = SamLoader(SamDataset(imgs[4:], segs[4:], (512, 512), n_samples=2, seed=1),
                           batch_size=2)
    save_root = os.path.join(root, "build", "chip_smoke_training")
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        # the f32 step's batch from a loader of its own: train_loader's draws stay as they were
        f32_batch = next(iter(SamLoader(SamDataset(imgs[:4], segs[:4], (512, 512), n_samples=4),
                                        batch_size=2)))
        cpu_run = f32_step_cpu_run(pool, root, f32_batch, "vit_b")
        return training_path(counters, imgs, train_loader, val_loader, save_root, f32_batch,
                             cpu_run)


def training_path(counters, imgs, train_loader, val_loader, save_root, f32_batch, cpu_run):
    """Phase 6's card work: train_sam, timed steps, the checkpoint, the f32
    step (its CPU half ``cpu_run``)."""
    from micro_sam_tpu_torch.training import train_sam

    # the training path, counted from train_sam to the last timed step
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    with torch.enable_grad():
        train_sam("smoke", "vit_b", train_loader, val_loader, with_segmentation_decoder=False,
                  n_iterations=2, device="cuda", save_root=save_root)
    torch.cuda.synchronize()
    train_sam_s = time.perf_counter() - t0
    log(f"  train_sam: {train_sam_s:.1f} s for 2 steps and validation")
    best = os.path.join(save_root, "smoke", "best.pkl")

    batches = list(train_loader)
    k4, stats, launches = timed_steps(counters, "vit_b", train_loader, val_loader, batches,
                                      save_root)
    log(f"  launches in the training path (train_sam, {TRAIN_WARMUP} + {TRAIN_REPS} steps): "
        f"{launches}")

    # the checkpoint predicts on the card
    check_checkpoint(best, "vit_b", imgs[0])

    # one f32 step on the card against the same step on the CPU, vit_b cut
    worst, loss_rel, depth = f32_step_card_check(f32_batch, "vit_b", cpu_run)
    training = {**stats, "train_sam_s": train_sam_s, "f32_step_grad_rel": worst,
                "f32_step_loss_rel": loss_rel, "f32_step_blocks": depth}
    return launches, k4, training


# ---------------------------------------------------------------------------
# phase 9: vit_h / vit_l finetuning, K4 at head dim 80, K12
# ---------------------------------------------------------------------------

K12_SHAPES = ((1, 64, 12, 64), (25, 14, 16, 80))  # (B, grid side, nH, hd): N = side^2


def k12_phase(counters):
    """``flash_attention_rel_pos`` (K12): (B, N, nH, hd) q, k, v through
    ``attention_with_rel_pos``, forward and backward, against the plain
    versions on the (B, nH, N, hd) views at ``K12_SHAPES``, bf16 and f32 (the
    backward to BWD_BF16_TOL in bf16), each shape's calls recorded and
    replayed. Then its path: both shapes in bf16 through the entry point,
    counted from zero (one forward and four backward launches a call), and
    that run's calls replayed. Returns (rows, the path's entry)."""
    from micro_sam_tpu_torch.models.image_encoder import get_rel_pos
    from micro_sam_tpu_torch.ops import attention_with_rel_pos
    from micro_sam_tpu_torch.ops import relpos_attention as rpa
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(9876)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    def case(B, H, nH, hd, dt):
        q, k, v, dout = (rnd(B, H * H, nH, hd).to(dt) for _ in range(4))
        rh, rw = (get_rel_pos(H, H, rnd(2 * H - 1, hd, scale=0.3)).to(dt) for _ in range(2))
        return (q, k, v, rh, rw, dout), (H, H)

    def run(c, hw):
        leaves = [t.detach().requires_grad_() for t in c[:5]]
        with torch.enable_grad():
            out = attention_with_rel_pos(*leaves[:3], hw, *leaves[3:])
            out.backward(c[5])
        return out.detach(), tuple(t.grad for t in leaves)

    def recorded(c, hw):
        with CallRecorder(rpa, "relpos_attention") as fwd, \
                CallRecorder(rpa, "relpos_attention_backward") as bwd:
            run(c, hw)
        return fwd.calls + bwd.calls

    heads = lambda t: t.float().transpose(1, 2)
    rows = []
    for dt, dname in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        for B, H, nH, hd in K12_SHAPES:
            c, hw = case(B, H, nH, hd, dt)
            label = f"flash_attention_rel_pos ({B}, {H * H}, {nH}, {hd})"
            out, grads = run(c, hw)
            q, k, v, rh, rw, dout = c
            ref = rpa.relpos_attention_plain(heads(q), heads(k), heads(v), rh.float(), rw.float(),
                                             hw)
            err = check(f"{label} out", out, ref.transpose(1, 2), dname)
            refs = rpa.relpos_attention_backward_plain(heads(q), heads(k), heads(v), ref,
                                                       heads(dout), rh.float(), rw.float(), hw)
            refs = tuple(r.transpose(1, 2) if r.dim() == 4 else r for r in refs)
            err = max(err, check(f"{label} dq dk dv drh drw", grads, refs, dname,
                                 tol=F32_TOL if dt == torch.float32 else BWD_BF16_TOL))
            calls = recorded(c, hw)
            k_ms, p_ms, l_ms = replay(calls, iters=5)
            b_ms, b_by = bound_of(calls)
            rows.append(dict(shape=f"({B}, {H * H}, {nH}, {hd})", dtype=dname, max_abs_err=err,
                             ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by))
            log(f"    forward + backward: ms {k_ms:.4f}  plain_ms {p_ms:.4f}  library_ms (SDPA "
                f"forward + backward, bias materialized) {l_ms:.4f}  bound_ms {b_ms:.4f} ({b_by})")
            del c, out, grads, ref, refs, calls
            torch.cuda.empty_cache()

    cases = [case(B, H, nH, hd, torch.bfloat16) for B, H, nH, hd in K12_SHAPES]
    for c in counters.values():
        c.launches = 0
    for c, hw in cases:
        run(c, hw)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items() if c.launches}
    expect = {"relpos_attention": len(cases), "relpos_attention_backward": 4 * len(cases)}
    log(f"  K12 path ({len(cases)} calls through attention_with_rel_pos, forward and backward): "
        f"launches {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError("flash_attention_rel_pos did not go through the kernels as expected")
    calls = [call for c, hw in cases for call in recorded(c, hw)]
    k_ms, p_ms, l_ms = replay(calls, iters=5)
    b_ms, b_by = bound_of(calls)
    err = max(r["max_abs_err"] for r in rows if r["dtype"] == "bfloat16")
    entry = dict(launches=sum(launches.values()), by_kernel=launches, max_abs_err=err, ms=k_ms,
                 plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by)
    log(f"  K12 path replayed: ms {k_ms:.4f}  plain_ms {p_ms:.4f}  library_ms {l_ms:.4f}  "
        f"bound_ms {b_ms:.4f} ({b_by})")
    del cases, calls
    torch.cuda.empty_cache()
    return rows, entry


VIT_L_TIMED_DEPTH = 6   # vit_l's timed steps: one period of its blocks (global at 5)


def finetuning_phase(counters, root):
    """vit_h / vit_l finetuning: K4 at head dim 80 and K12 against their plain
    versions; timed vit_h steps (the "A100" preset's model and objects, on
    default_sam_loader over phase 6's patches; the preset itself runs with
    the decoder in phase 14(e)) and vit_l steps at full width cut to
    ``VIT_L_TIMED_DEPTH`` blocks; one f32 step of a full-width vit_h cut to
    F32_STEP_CUT's depth on the card against the CPU (a process started at
    the phase's start)."""
    import gc
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from micro_sam_tpu_torch.training import default_sam_loader

    imgs, segs = training_data()

    def loader(train):
        return default_sam_loader(
            raw_paths=imgs[:4] if train else imgs[4:], raw_key=None,
            label_paths=segs[:4] if train else segs[4:], label_key=None, patch_shape=(512, 512),
            with_segmentation_decoder=False, n_samples=4 if train else 2, is_train=train,
            batch_size=2)
    train_loader, val_loader = loader(True), loader(False)
    save_root = os.path.join(root, "build", "chip_smoke_training")
    batches = list(train_loader)
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_run = f32_step_cpu_run(pool, root, batches[0], "vit_h")
        log("  K4 at head dim 80 (vit_h's training shapes, batch 2) vs plain backward "
            "(bf16: within 3e-2 of the f32 plain result)")
        with torch.enable_grad():
            bwd_rows = backward_phase(grids=((50, 14), (2, 64)), nH=16, hd=80, seed=4322)
        log("  K12 flash_attention_rel_pos vs plain versions")
        k12_rows, k12 = k12_phase(counters)

        for c in counters.values():
            c.launches = 0
        k4_h, stats_h, launches_h = timed_steps(counters, "vit_h", train_loader, val_loader,
                                                batches, save_root)
        log(f"  launches in the vit_h training path ({TRAIN_WARMUP} + {TRAIN_REPS} steps): "
            f"{launches_h}")
        gc.collect()
        torch.cuda.empty_cache()

        for c in counters.values():
            c.launches = 0
        with CutDepth("vit_l", VIT_L_TIMED_DEPTH):
            log(f"  vit_l at full width (1024, 16 heads of 64), {VIT_L_TIMED_DEPTH} blocks "
                f"(global at {VIT_L_TIMED_DEPTH - 1})")
            k4_l, stats_l, launches_l = timed_steps(counters, "vit_l", train_loader, val_loader,
                                                    batches, save_root, reps=TRAIN_REPS_VIT_L)
        log(f"  launches in the vit_l training path ({TRAIN_WARMUP} + {TRAIN_REPS_VIT_L} "
            f"steps): {launches_l}")
        gc.collect()
        torch.cuda.empty_cache()

        worst, loss_rel, depth = f32_step_card_check(batches[0], "vit_h", cpu_run)
    stats_h.update(f32_step_cut_grad_rel=worst, f32_step_cut_loss_rel=loss_rel,
                   f32_step_blocks=depth)
    return dict(bwd_rows=bwd_rows, k12_rows=k12_rows, k12=k12,
                vit_h=dict(k4=k4_h, training=stats_h, launches=launches_h),
                vit_l=dict(k4=k4_l, training=stats_l, launches=launches_l))


# ---------------------------------------------------------------------------
# phase 10: the rel-pos kernels at every head dim, K9 / K11, and tiled
# precompute through the three encoder routes
# ---------------------------------------------------------------------------

HD_SWEEP = (16, 32, 40, 64, 80, 96, 100, 128, 160, 256)
SWEEP_GRIDS = ((25, 14, False), (25, 14, True), (1, 64, False))  # (batch, grid side, misaligned)
ROUTE_KNOBS = ("MSAM_TPU_SPATIAL_WINDOW", "MSAM_TPU_WINDOW_STACK")
ROUTES = {"default": ({}, VIT_CHAINS), "K9": ({"MSAM_TPU_SPATIAL_WINDOW": "1"}, K9_CHAINS),
          "K11": ({"MSAM_TPU_WINDOW_STACK": "1"}, K11_CHAINS)}
TILE, HALO, TILE_BATCH = (1024, 1024), (256, 256), 4
TILE_REPS = 3


class Route:
    """Sets the encoder's route knobs (``ROUTES``) for the duration, and
    restores them after."""

    def __init__(self, name):
        self.env = ROUTES[name][0]

    def __enter__(self):
        self.saved = {k: os.environ.pop(k, None) for k in ROUTE_KNOBS}
        os.environ.update(self.env)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def head_dim_sweep():
    """relpos_attention and its backward (with the forward's lse) at every head
    dim of ``HD_SWEEP`` on (25, 4, 196, hd) windows and a (1, 4, 4096, hd)
    global grid, q / k / v strided out of qkv rows, and on the windows once
    more with every row one element off its 16-byte alignment; against the
    plain versions, f32 rel 1e-4, bf16 2e-2 of max (the backward 3e-2; the
    forward's lse 1e-4 of max in both). Head dims the kernels are not built
    for run staged into the next built one. The aligned bf16 forwards are
    timed, with their variant, bound and SDPA (bias materialized) beside
    them."""
    from micro_sam_tpu_torch.ops.relpos_attention import (
        kernel_head_dim, relpos_attention, relpos_attention_backward,
        relpos_attention_backward_plain, relpos_attention_plain)
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(2468)
    rows = []
    nH = 4
    for dt, dname in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        for hd in HD_SWEEP:
            for B, H, misaligned in SWEEP_GRIDS:
                N = H * H
                flat = torch.randn(B * N * 3 * nH * hd + 1, generator=g).to(dev, dt)
                q5 = (flat[1:] if misaligned else flat[:-1]).view(B, N, 3, nH, hd)
                q, k, v = (q5[:, :, i].transpose(1, 2) for i in range(3))
                rh, rw = ((torch.randn(H, H, hd, generator=g) * 0.3).to(dev, dt) for _ in range(2))
                label = f"({B}, {nH}, {N}, {hd}){' misaligned' if misaligned else ''}"
                lse, lse_ref = (torch.empty(B, nH, N, device=dev) for _ in range(2))
                out = relpos_attention(q, k, v, rh, rw, (H, H), lse=lse)
                f32 = [t.float() for t in (q, k, v, out, rh, rw)]
                ref = relpos_attention_plain(*f32[:3], *f32[4:], (H, H), lse=lse_ref)
                err = check(f"relpos_attention {label}", out, ref, dname, quiet=True)
                check(f"relpos_attention lse {label}", lse, lse_ref, dname, quiet=True,
                      tol=F32_TOL)
                a = (q, k, v, rh, rw, (H, H))
                row = dict(shape=label, dtype=dname, kernel_head_dim=kernel_head_dim(hd),
                           variant=relpos_variant(a), max_abs_err=err)
                timing = ""
                if dt == torch.bfloat16 and not misaligned:
                    kern, _, lib, _ = counterparts("relpos_attention", a, {})
                    row["ms"], row["library_ms"] = time_ms(kern), time_ms(lib)
                    row["bound_ms"], row["bound_by"] = bound_of([("relpos_attention", a, {})])
                    timing = (f"; ms {row['ms']:.4f}  library_ms {row['library_ms']:.4f}  "
                              f"bound_ms {row['bound_ms']:.4f} ({row['bound_by']})")
                    del kern, lib
                dout = torch.randn(B, nH, N, hd, generator=g).to(dev, dt)
                grads = relpos_attention_backward(q, k, v, out, dout, rh, rw, (H, H), lse=lse)
                ref_b = relpos_attention_backward_plain(*f32[:4], dout.float(), *f32[4:], (H, H))
                err_b = check(f"relpos_attention_backward {label}", grads, ref_b, dname,
                              quiet=True, tol=F32_TOL if dt == torch.float32 else BWD_BF16_TOL)
                del dout, grads, ref_b, lse, lse_ref
                torch.cuda.synchronize()
                row["backward_max_abs_err"] = err_b
                rows.append(row)
                log(f"  hd {hd:3d} (kernel {kernel_head_dim(hd):3d}) {label:<32s} {dname:<8s} "
                    f"{row['variant']:<8s} forward max_abs_err {err:.3e}, backward {err_b:.3e} "
                    f"ok{timing}")
                del flat, q5, q, k, v, out, f32, ref, a
        torch.cuda.empty_cache()
    return rows


WINDOW_ROUTE_CASES = (  # (name, width, heads, images, padded map side, valid side)
    ("fused_window_block_spatial", 768, 12, 1, 70, 64),
    ("fused_window_block_spatial", 768, 12, 4, 70, 64),  # the tiled path's 4-tile batch
    ("fused_window_block_spatial", 768, 12, 1, 56, 56),
    ("fused_window_block_spatial", 1280, 16, 1, 70, 64),
    ("fused_window_stack", 768, 12, 4, 70, 64),
)


def window_routes_kernel_phase(counters):
    """K9 and K11 against their plain versions (bf16 and f32) and against the
    partitioned K2 chain on the same windows (equal to the bit in bf16,
    within 1e-6 of max in f32, or the run fails), with launches counted
    around one call, times, bounds and library yardsticks: K9 on (1, 70, 70,
    768) and the tiled path's (4, 70, 70, 768) maps (12 heads, valid 64 x
    64), unpadded (1, 56, 56, 768) and vit_h's (1, 70, 70, 1280) (16 heads
    of 80); K11 on 4 images' 25 windows, (100, 196, 768), masked."""
    import torch.nn.functional as F
    from micro_sam_tpu_torch.models.common import init_module_
    from micro_sam_tpu_torch.models.image_encoder import (Block, partition_tokens,
                                                          window_unpartition)
    from micro_sam_tpu_torch.ops import fused_window_block as fwb
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1357)
    rows = []
    for dt, dname in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        for name, Cw, nH, n_img, Hp, H in WINDOW_ROUTE_CASES:
            blk = Block(Cw, nH, 4.0, 14, (14, 14))
            init_module_(blk, g)
            blk = blk.hold_weights_in_(dt).to(dev)
            x = (torch.randn(n_img, H, H, Cw, generator=g) * 1.0).to(dev, dt)
            xw, valid, pad_hw = partition_tokens(x, 14)
            if name == "fused_window_block_spatial":
                a = (F.pad(x, (0, 0, 0, Hp - H, 0, Hp - H)), blk, 14, (H, H), nH)
                label = f"K9 ({n_img}, {Hp}, {Hp}, {Cw}) valid {H} x {H}"
            else:
                a = (xw, valid, blk, (14, 14), nH, n_img)
                label = f"K11 ({xw.shape[0]}, 196, {Cw}) {n_img} images, masked"
            kern, plain, lib, ref = chain_counterparts(name, a, {})
            got = kern()
            err = check(f"{name} {label}", got, ref(), dname)
            k2 = fwb.fused_window_block(xw, valid, blk, (14, 14), nH)
            if name == "fused_window_block_spatial":
                k2 = window_unpartition(k2.reshape(-1, 14, 14, Cw), 14, pad_hw, pad_hw)
            k2_diff = float((got.float() - k2.float()).abs().max())
            log(f"    {label} vs the partitioned K2 chain on the same windows: max abs "
                f"difference {k2_diff:.3e}")
            if k2_diff > (1e-6 if dt == torch.float32 else 0.0) * float(k2.float().abs().max()):
                raise AssertionError(f"{label}: differs from the partitioned K2 chain by "
                                     f"{k2_diff:.3e}")
            before = {k: c.launches for k, c in counters.items()}
            kern()
            torch.cuda.synchronize()
            launches = {k: c.launches - before[k] for k, c in counters.items()
                        if c.launches != before[k]}
            if launches != CHAIN_LAUNCHES[name]:
                raise AssertionError(f"{label}: launches {launches}, not {CHAIN_LAUNCHES[name]}")
            k_ms, p_ms, l_ms = time_ms(kern), time_ms(plain, iters=5), time_ms(lib)
            b_ms, b_by = chain_bound([(name, a, {})])
            rows.append(dict(name=name, shape=label, dtype=dname, max_abs_err=err,
                             k2_max_abs_diff=k2_diff, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                             bound_ms=b_ms, bound_by=b_by, launches=launches))
            log(f"    launches {launches}  ms {k_ms:.4f}  plain_ms {p_ms:.4f}  library_ms "
                f"{l_ms:.4f}  bound_ms {b_ms:.4f} ({b_by})")
            del blk, x, xw, valid, a, kern, plain, lib, ref, got, k2
            torch.cuda.empty_cache()
    return rows


def spatial_costs():
    """Device time of the copies the spatial route removes (one vit_b encode
    makes 4 partition / unpartition pairs, one per run of windowed blocks, at
    (1, 64, 64, 768) bf16) against the pad / crop pairs it makes instead, and
    of the spatial addressing inside relpos_attention: the spatial mode on
    (1, 70, 70) and the tiled batch's (4, 70, 70) maps of qkv rows against the
    plain mode on the same rows in window order."""
    import torch.nn.functional as F
    from micro_sam_tpu_torch.models.image_encoder import partition_tokens, window_unpartition
    from micro_sam_tpu_torch.ops.relpos_attention import (_windows, relpos_attention,
                                                          relpos_attention_spatial)
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(97531)
    x = torch.randn(1, 64, 64, C, generator=g).to(dev, torch.bfloat16)

    def copies():
        for _ in range(4):
            xw, _, pad = partition_tokens(x, 14)
            window_unpartition(xw.reshape(-1, 14, 14, C), 14, pad, (64, 64))

    def pads():
        for _ in range(4):
            F.pad(x, (0, 0, 0, 6, 0, 6))[:, :64, :64].contiguous()
    part_ms, pad_ms = time_ms(copies, iters=50), time_ms(pads, iters=50)
    out = dict(partition_unpartition_ms_per_encode=part_ms, pad_crop_ms_per_encode=pad_ms)
    log(f"  copies per vit_b encode (4 runs of windowed blocks, device time): partition + "
        f"unpartition {part_ms:.4f} ms on the default route, pad + crop {pad_ms:.4f} ms on "
        f"the K9 route")
    rh, rw = ((torch.randn(14, 14, HD, generator=g) * 0.3).to(dev, torch.bfloat16)
              for _ in range(2))
    for B in (1, TILE_BATCH):  # one encode's map; the tiled path's batch
        rows = torch.randn(B * 70 * 70, 3 * C, generator=g).to(dev, torch.bfloat16)
        q6 = rows.view(B, 70, 70, 3, NH, HD)
        q, k, v = (q6[:, :, :, i] for i in range(3))
        o_map = torch.empty(B, 70, 70, NH, HD, device=dev, dtype=torch.bfloat16)
        wrows = _windows(q6.reshape(B, 70, 70, 3 * NH, HD), 14).transpose(1, 2).contiguous()
        w5 = wrows.view(25 * B, 196, 3, NH, HD)
        qw, kw, vw = (w5[:, :, i].transpose(1, 2) for i in range(3))
        o_win = torch.empty(25 * B, 196, NH, HD, device=dev,
                            dtype=torch.bfloat16).transpose(1, 2)
        sp_ms = time_ms(lambda: relpos_attention_spatial(q, k, v, rh, rw, 14, out=o_map),
                        iters=50)
        pl_ms = time_ms(lambda: relpos_attention(qw, kw, vw, rh, rw, (14, 14), out=o_win),
                        iters=50)
        sfx = "" if B == 1 else f"_batch{B}"
        out[f"relpos_spatial_ms{sfx}"], out[f"relpos_window_order_ms{sfx}"] = sp_ms, pl_ms
        log(f"  relpos_attention on ({B}, 70, 70) maps, 12 heads of 64: spatial mode "
            f"{sp_ms:.4f} ms, plain mode on the same rows in window order {pl_ms:.4f} ms")
    return out


def tiled_data():
    """A 2048 x 2048 synthetic_data image (seed 0), a (4, 1536, 1536) volume
    of its crops, shifted 128 / 96 pixels a slice, and the image's
    segmentation (phase 11's tiled prompts)."""
    from micro_sam_tpu_torch.sample_data import synthetic_data
    t0 = time.perf_counter()
    image, seg = synthetic_data((2048, 2048), seed=0)
    volume = np.stack([image[128 * z:128 * z + 1536, 96 * z:96 * z + 1536] for z in range(4)])
    log(f"  data: image {image.shape}, volume {volume.shape} ({time.perf_counter() - t0:.1f} s)")
    return image, volume, seg


def rel_max(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def tiled_route_run(predictor, counters, route, image, volume, crops, default=None,
                    timed=True):
    """One route's tiled path: ``image`` 2d and ``volume`` 3d at TILE / HALO,
    TILE_BATCH tiles (slices) an encode, counted from zero (kernels and, by
    ChainLaunches, each chain call). Checks the launches per 4-tile batch,
    every tile against its untiled crop (``crops``, within 3e-2 of max) and,
    off the default route, against the default route's tiles (``default``,
    within 2e-2 of max). Then a tiled prompt, and with ``timed`` tiles/s of
    the 2d image (host clock, median of TILE_REPS after a warm-up)."""
    from micro_sam_tpu_torch.util import precompute_image_embeddings, set_precomputed
    chains = ROUTES[route][1]
    n_win = 8  # vit_b's windowed blocks
    per_batch = ({"layernorm": 24, "gemm": 48, "relpos_attention": 12} if route != "K9" else
                 {"layernorm": 24, "gemm": 48, "relpos_attention": 4,
                  "relpos_attention_spatial": 8})
    chain_calls = {chains[0]: n_win, "fused_global_attn": 4,
                   "mlp_half": 12 if route == "default" else 4}
    with Route(route):
        for c in counters.values():
            c.launches = 0
        with ChainLaunches(counters, chains) as cc:
            emb2 = precompute_image_embeddings(predictor, image, tile_shape=TILE, halo=HALO,
                                               batch_size=TILE_BATCH, verbose=False)
            torch.cuda.synchronize()
            l2 = {k: c.launches for k, c in counters.items() if c.launches}
            calls2 = dict(cc.calls)
            emb3 = precompute_image_embeddings(predictor, volume, tile_shape=TILE, halo=HALO,
                                               batch_size=TILE_BATCH, verbose=False)
            torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        n_b3 = len(emb3["features"])  # one batch of 4 slices a tile
        log(f"  {route} route: launches {dict((k, v) for k, v in launches.items() if v)} in "
            f"{1 + n_b3} batches of {TILE_BATCH} (2d: {l2}); chain launches "
            f"{cc.launches} in {cc.calls} calls")
        if l2 != per_batch or sum(l2.values()) != 84 or calls2 != chain_calls:
            raise AssertionError(f"{route} route: a 4-tile batch made {l2} in chain calls "
                                 f"{calls2}, not {per_batch} in {chain_calls}")
        if any(launches[k] != (1 + n_b3) * per_batch.get(k, 0) for k in counters) or \
                any(cc.calls[k] != (1 + n_b3) * v for k, v in chain_calls.items()):
            raise AssertionError(f"{route} route: the tiled path did not go through the "
                                 f"kernels and chains as expected")
        if sum(cc.launches.values()) != sum(launches.values()):
            raise AssertionError(f"{route} route: kernels launched outside the chains")
        err_crop, err_default = 0.0, 0.0
        for ndim, emb in ((2, emb2), (3, emb3)):
            assert sorted(emb["features"]) == [0, 1, 2, 3], sorted(emb["features"])
            for t, tile in emb["features"].items():
                f = tile["features"]
                if not np.isfinite(f).all():
                    raise AssertionError(f"{route}: tile {t} of the {ndim}d path is not finite")
                err_crop = max(err_crop, rel_max(f, crops[ndim][t]))
                if default is not None:
                    err_default = max(err_default, rel_max(f, default[ndim][t]))
        shapes2 = sorted({tuple(t["original_size"]) for t in emb2["features"].values()})
        shapes3 = sorted({tuple(t["original_size"]) for t in emb3["features"].values()})
        log(f"  {route}: 2d tiles of {shapes2}, 3d tiles of {shapes3}; every tile vs its "
            f"untiled crop: rel {err_crop:.3e} (tol 3e-2)"
            + ("" if default is None else f"; vs the default route: rel {err_default:.3e} "
               f"(tol 2e-2)"))
        if err_crop > 3e-2 or err_default > 2e-2:
            raise AssertionError(f"{route}: tiled features disagree")
        set_precomputed(predictor, emb2, tile_id=3)
        m, iou, lo = predictor.predict(np.array([[600., 500.]]), np.array([1]))
        h, w = emb2["features"][3]["original_size"]
        set_precomputed(predictor, emb3, tile_id=1, i=2)
        m3, iou3, _ = predictor.predict(np.array([[300., 500.]]), np.array([1]))
        h3, w3 = emb3["features"][1]["original_size"]
        if m.shape != (3, h, w) or m3.shape != (3, h3, w3) or not (
                np.isfinite(iou).all() and np.isfinite(iou3).all() and np.isfinite(lo).all()):
            raise AssertionError(f"{route}: a tiled prompt did not predict")
        log(f"  {route}: set_precomputed(tile_id=3) -> predict: masks {m.shape}, iou "
            f"{np.round(iou, 4).tolist()}; 3d tile 1 slice 2: masks {m3.shape}")
        ts, tps = [], None
        if timed:
            precompute_image_embeddings(predictor, image, tile_shape=TILE, halo=HALO,
                                        batch_size=TILE_BATCH, verbose=False)
            torch.cuda.synchronize()
        for _ in range(TILE_REPS if timed else 0):
            t0 = time.perf_counter()
            precompute_image_embeddings(predictor, image, tile_shape=TILE, halo=HALO,
                                        batch_size=TILE_BATCH, verbose=False)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        if timed:
            tps = 4 / statistics.median(ts)
            log(f"  {route}: tiles/s at batch {TILE_BATCH} (4 tiles of 1280^2 -> 1024^2, host "
                f"clock incl. resize, median of {TILE_REPS}): {tps:.3f} (all "
                f"{[round(t, 4) for t in ts]} s)")
    feats = {2: {t: v["features"] for t, v in emb2["features"].items()},
             3: {t: v["features"] for t, v in emb3["features"].items()}}
    return feats, emb2, dict(launches=launches, launches_per_batch=l2, chain_launches=dict(cc.launches),
                       chain_calls=dict(cc.calls), tile_rel_vs_crop=err_crop,
                       tile_rel_vs_default=err_default if default is not None else None,
                       tiles_per_s=tps, tiles_s=ts)


def tiled_cache_checks(predictor, counters, image, root):
    """On the default route: a tiled cache written under build/ reloads
    lazily, with no launch; a second call with a ``tile_subset`` resumes from
    the first's tiles, with no launch."""
    import shutil
    from micro_sam_tpu_torch.util import _get_tile_features, precompute_image_embeddings
    cache_dir = os.path.join(root, "build", "chip_smoke_tiled")
    shutil.rmtree(cache_dir, ignore_errors=True)
    kw = dict(tile_shape=TILE, halo=HALO, batch_size=TILE_BATCH, verbose=False)
    with Route("default"):
        path = os.path.join(cache_dir, "tiles.zarr")
        emb = precompute_image_embeddings(predictor, image, save_path=path, **kw)
        for c in counters.values():
            c.launches = 0
        lazy = precompute_image_embeddings(predictor, image, save_path=path, lazy_loading=True,
                                           **kw)
        moved = {k: c.launches for k, c in counters.items() if c.launches}
        tile2 = _get_tile_features(lazy, 2)
        if moved or isinstance(lazy["features"], dict) or not np.array_equal(
                tile2["features"], emb["features"][2]["features"]):
            raise AssertionError(f"the tiled cache did not reload lazily as written ({moved})")
        path = os.path.join(cache_dir, "resume.zarr")
        first = precompute_image_embeddings(predictor, image, save_path=path, tile_subset=[0, 3],
                                            finalize=False, **kw)
        for c in counters.values():
            c.launches = 0
        second = precompute_image_embeddings(predictor, image, save_path=path,
                                             tile_subset=[0, 3], **kw)
        moved = {k: c.launches for k, c in counters.items() if c.launches}
        if moved or sorted(second["features"]) != [0, 3] or not all(
                np.array_equal(second["features"][t]["features"], first["features"][t]["features"])
                for t in (0, 3)):
            raise AssertionError(f"the tile_subset call did not resume from the cache ({moved})")
    log(f"  tiled cache {cache_dir}: reloads lazily (tile 2 equal, no launch); a second "
        f"tile_subset [0, 3] call resumes with no launch")
    return dict(lazy_reload=True, resume_without_launch=True)


VIT_H_K9_DEPTH = 8   # vit_h through K9: one period of its blocks (global at 7)


def vit_h_spatial_check(counters):
    """One 1024^2 vit_h encode (full width cut to VIT_H_K9_DEPTH blocks, bf16,
    seed 0) through the K9 route against the default route's, within the
    phase-8 bf16 bound (3e-2 of max); a spatial attention launch for each
    windowed block."""
    import gc
    from micro_sam_tpu_torch.util import _to_image, get_sam_model
    rng = np.random.RandomState(0)
    x1 = _to_image(rng.randint(0, 256, size=(1024, 1024)).astype(np.uint8))[None].astype(
        np.float32)
    with CutDepth("vit_h", VIT_H_K9_DEPTH):
        predictor = get_sam_model("vit_h", seed=0)
    ref = predictor.encode_batch(x1).float().cpu()
    with Route("K9"):
        for c in counters.values():
            c.launches = 0
        got = predictor.encode_batch(x1).float().cpu()
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items() if c.launches}
    rel = float((got - ref).abs().max() / ref.abs().max())
    log(f"  vit_h ({VIT_H_K9_DEPTH} blocks) 1024^2 encode through the K9 route vs the default "
        f"route: rel {rel:.3e} (tol 3e-2); launches {launches}")
    if rel > 3e-2 or launches.get("relpos_attention_spatial") != VIT_H_K9_DEPTH - 1:
        raise AssertionError("vit_h through the K9 route disagrees or missed the spatial kernel")
    del predictor
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rel_vs_default=rel, launches=launches)


def tiled_phase(counters, root):
    """Phase 10: the head-dim sweep, K9 / K11 against plain and K2, the
    copies K9 removes, the tiled path at vit_b full width under the three
    routes, the tiled cache, vit_h through K9, and the tiled path's 4-tile
    batch encoded through each opt-in route and replayed per kernel and per
    chain, every launch against its plain version at the shapes the tiled
    path gives it (the kernels line's K9 / K11 rows)."""
    from micro_sam_tpu_torch.util import (_resize_for_encoder, get_sam_model,
                                          precompute_image_embeddings)
    from micro_sam_tpu_torch.utils.blocking import Blocking
    log("  rel-pos attention forward at every head dim up to 256, its backward up to 128, vs plain")
    sweep = head_dim_sweep()
    log("  K9 / K11 vs their plain versions and the partitioned K2 chain")
    window_rows = window_routes_kernel_phase(counters)
    costs = spatial_costs()
    image, volume, seg = tiled_data()
    predictor = get_sam_model("vit_b", seed=0)
    blocking = Blocking((0, 0), image.shape, TILE)
    blocking3 = Blocking((0, 0), volume.shape[1:], TILE)
    t0 = time.perf_counter()
    with Route("default"):
        crops = {2: {t: precompute_image_embeddings(
                     predictor, image[blocking.get_block_with_halo(t, HALO).outer_block.slicing],
                     verbose=False)["features"] for t in range(len(blocking))},
                 3: {t: precompute_image_embeddings(
                     predictor, volume[(slice(None),) + blocking3.get_block_with_halo(
                         t, HALO).outer_block.slicing], batch_size=TILE_BATCH,
                     verbose=False)["features"] for t in range(len(blocking3))}}
    log(f"  untiled crops of every tile encoded ({time.perf_counter() - t0:.1f} s)")
    feats, runs, embs = {}, {}, {}
    for route in ROUTES:  # K11 runs the default route's launches: checked, not timed
        feats[route], embs[route], runs[route] = tiled_route_run(
            predictor, counters, route, image, volume, crops, feats.get("default"),
            timed=route != "K11")
    cache = tiled_cache_checks(predictor, counters, image, root)
    # the 2d path's one batch: its 4 tiles resized to 1024^2, as _compute_tiled_2d encodes them
    x4 = np.stack([_resize_for_encoder(predictor, image[blocking.get_block_with_halo(
        t, HALO).outer_block.slicing]) for t in range(len(blocking))]).astype(np.float32)
    replays = {}
    for route in ("K9",):  # K11's launches are the default route's: its row times one call
        log(f"  the tiled path's 4-tile batch {x4.shape} through the {route} route, replayed "
            f"per kernel and chain:")
        with Route(route):
            for c in counters.values():
                c.launches = 0
            with ChainLaunches(counters, ROUTES[route][1]) as cc:
                predictor.encode_batch(x4)
                torch.cuda.synchronize()
            one = {k: c.launches for k, c in counters.items()}
            replays[route] = encode_replay_phase(predictor, x4, counters, one, 1,
                                                 ROUTES[route][1], dict(cc.launches))
    del predictor
    torch.cuda.empty_cache()
    vit_h = vit_h_spatial_check(counters)
    return dict(head_dim_sweep=sweep, window_routes=window_rows, costs=costs, routes=runs,
                cache=cache, replays=replays, vit_h_k9=vit_h,
                amg_inputs=dict(image=image, seg=seg, emb=embs["default"]))


def summarize_tiled(p10):
    """The kernels line's rows of phase 10: the spatial mode of
    relpos_attention, K9 and K11. launches: the count of the route's tiled
    path (2d and 3d, from zero); ms, plain_ms, library_ms, bound_ms: for K9
    and the spatial mode, the launches (a chain's calls) of one vit_b encode
    of the tiled path's 4-tile batch through the route, replayed back to
    back; for K11 (the default route's launches with its arguments) one call
    at the tiled path's shape, (100, 196, 768) bf16, from the routes' kernel
    checks."""
    routes, rp = p10["routes"], p10["replays"]
    per = ("all {} of one vit_b bf16 encode of the tiled 2d path's batch (4 tiles of 1280^2 "
           "resized to 1024^2) through the {} route, back to back")
    sp = rp["K9"]["relpos_attention_spatial"]
    out = [{
        "name": "relpos_attention (spatial mode)", "route": "cuda",
        "source": "micro_sam_tpu_torch/csrc/relpos_attention.cu",
        "replaces": "micro_sam_tpu/ops/fused_window_block.py:76 (_fused_block_kernel with "
                    "spatial=, attention stage; pallas_call :484)",
        "launches": routes["K9"]["launches"]["relpos_attention_spatial"],
        "max_abs_err": max([sp["max_abs_err"]] + [r["max_abs_err"] for r in
                                                  p10["head_dim_sweep"]]),
        "ms": sp["ms"], "plain_ms": sp["plain_ms"], "bound_ms": sp["bound_ms"],
        "bound_by": sp["bound_by"], "library_ms": sp["library_ms"],
        "launches_per_encode": sp["launches_per_encode"], "per": per.format("launches", "K9"),
        "head_dim_sweep": p10["head_dim_sweep"], "costs": p10["costs"],
    }]
    for route, name, replaces in (
            ("K9", "fused_window_block_spatial", "micro_sam_tpu/ops/fused_window_block.py:600 "
             "(fused_window_block_spatial -> _fused_forward(spatial_hw=...), pallas_call :484, "
             "kernel _fused_block_kernel :76 with spatial=)"),
            ("K11", "fused_window_stack", "micro_sam_tpu/ops/fused_window_block.py:1331 "
             "(fused_window_stack -> _fused_window_stack_forward :1338, pallas_call :1396, "
             "kernel _fused_window_stack_kernel :1168)")):
        rows = [r for r in p10["window_routes"] if r["name"] == name]
        if route in rp:
            e = rp[route]["chains"][name]
            calls, what = e["calls_per_encode"], per.format("calls", route)
        else:
            e = next(r for r in rows if r["dtype"] == "bfloat16")
            calls, what = None, f"one call, {e['shape']}, bf16 (the default route's launches)"
        out.append({
            "name": f"{name} chain ({route})", "route": "cuda",
            "source": "micro_sam_tpu_torch/ops/fused_window_block.py (csrc/layernorm.cu, "
                      "csrc/gemm.cu, csrc/relpos_attention.cu)", "replaces": replaces,
            "launches": routes[route]["chain_launches"][name],
            "max_abs_err": max([e["max_abs_err"]] + [r["max_abs_err"] for r in rows]),
            "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"], "library_ms": e["library_ms"],
            "calls_per_encode": calls, "per": what, "shapes": rows,
        })
    return out


# ---------------------------------------------------------------------------
# phase 11: the prompt layer and automatic mask generation
# ---------------------------------------------------------------------------

AMG_SIDE, AMG_BATCH = 32, 64
FIXTURE = os.path.join("tests", "fixtures", "bench_sam_tiny1024.npz")
FIXTURE_IMAGE = dict(shape=(1024, 1024), seed=200, n_objects=20, radius_range=(30, 110))
FIXTURE_FLOORS = (0.5, 0.5)
# processes sharing the CPU reference: its decode's passes over the 64 prompts'
# copies of the embedding scale poorly over one process's threads
FIXTURE_SHARDS = 4
AMG_PROFILE_GROUPS = SERVE_PROFILE_GROUPS[:-1] + (
    ("mask upscale (bilinear)", ("upsample",)),
    ("copies to the host", ("Memcpy",)),
) + SERVE_PROFILE_GROUPS[-1:]


def fixture_amg(root, device, prefilters=(FIXTURE_FLOORS,), side=AMG_SIDE, batch=AMG_BATCH,
                shard=(0, 1), mesh=None):
    """The trained fixture SAM (f32) on ``device``: AMG ``initialize`` over
    ``side`` x ``side`` points, ``batch`` a batch, on the fixture's synthetic
    image, once per prefilter. ``shard=(k, n)`` takes the k-th of n equal
    parts of the grid, in whole batches, so that n processes share the CPU
    reference (each with its share of the CPU's threads; their states joined
    in order are the whole grid's). ``mesh``: the predictor runs on this
    rank's share of it (phase 18). Returns, per prefilter, the state
    (``get_state``), the survivors of each batch's device decode and the
    seconds ``initialize`` took."""
    sys.path.insert(0, root)
    torch.set_grad_enabled(False)
    import micro_sam_tpu_torch.instance_segmentation as inst
    from micro_sam_tpu_torch.models.convert import params_from_flat_npz
    from micro_sam_tpu_torch.models.sam import Sam
    from micro_sam_tpu_torch.ops.amg_utils import build_point_grid
    from micro_sam_tpu_torch.predictor import SamPredictor
    from micro_sam_tpu_torch.sample_data import synthetic_data
    k, n = shard
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or n) // n))
    cfg, sd = params_from_flat_npz(os.path.join(root, FIXTURE), compute_dtype="float32")
    sam = Sam(cfg)
    sam.load_state_dict(sd)
    predictor = SamPredictor(sam.to(device).eval(), mesh=mesh)
    image = synthetic_data(**FIXTURE_IMAGE)[0]
    grid = build_point_grid(side)
    part = len(grid) // n
    assert part * n == len(grid) and part % batch == 0, (len(grid), n, batch)
    runs = []
    for prefilter in prefilters:
        amg = inst.AutomaticMaskGenerator(predictor, points_per_side=None,
                                          point_grids=[grid[k * part:(k + 1) * part]],
                                          points_per_batch=batch, prefilter_thresholds=prefilter)
        survivors = []
        decode = amg._decode_batch

        def counted(points, im_size):
            out = decode(points, im_size)
            survivors.append(int(out["order"].numel()))
            return out
        amg._decode_batch = counted
        t0 = time.perf_counter()
        amg.initialize(image)
        runs.append(dict(state=amg.get_state(), survivors=survivors,
                         initialize_s=time.perf_counter() - t0))
    return runs


def fixture_records(shards):
    """The records of ``generate`` ("rle" mode) at the default thresholds and
    at the floors, from the states of ``shards`` (``fixture_amg`` runs of
    one prefilter, in grid order) joined into one."""
    import micro_sam_tpu_torch.instance_segmentation as inst
    from micro_sam_tpu_torch.ops.amg_utils import MaskData
    crop = MaskData()
    for run in shards:
        crop.cat(run["state"]["crop_list"][0])
    state = dict(shards[0]["state"], crop_list=[crop])
    amg = inst.AutomaticMaskGenerator(None, points_per_side=AMG_SIDE)
    amg.set_state(state)
    return dict(records=amg.generate(output_mode="rle"),
                records_at_floors=amg.generate(*FIXTURE_FLOORS, output_mode="rle"),
                survivors=sum((run["survivors"] for run in shards), []),
                candidates=len(crop), initialize_s=max(run["initialize_s"] for run in shards))


def match_fixture_records(card, cpu, thresholds=(0.88, 0.95), floors=(0.5, 0.5), nms=0.7,
                          tol=1e-3):
    """Pairs the card's and the CPU's records by point; every pair's mask IoU
    >= 0.99 and scores within ``tol``; at most 2 % unmatched, each with a
    score within ``tol`` of a floor or a threshold, or suppressed in the
    other run by a box whose IoU with its own lies within ``tol`` of the NMS
    threshold. Returns the numbers of the check."""
    from micro_sam_tpu_torch.ops.amg_utils import rle_to_mask
    key = lambda r: tuple(r["point_coords"][0])  # noqa: E731
    a, b = {key(r): r for r in card}, {key(r): r for r in cpu}
    worst_iou, worst_score = 1.0, 0.0
    for k in a.keys() & b.keys():
        ma, mb = rle_to_mask(a[k]["segmentation"]), rle_to_mask(b[k]["segmentation"])
        iou = float((ma & mb).sum() / max((ma | mb).sum(), 1))
        worst_iou = min(worst_iou, iou)
        worst_score = max(worst_score, abs(a[k]["predicted_iou"] - b[k]["predicted_iou"]),
                          abs(a[k]["stability_score"] - b[k]["stability_score"]))
    if worst_iou < 0.99 or worst_score > tol:
        raise AssertionError(f"fixture AMG: matched records differ (IoU {worst_iou:.5f}, "
                             f"scores {worst_score:.3e})")

    def xyxy(r):
        x, y, w, h = r["bbox"]
        return np.array([x, y, x + w, y + h], np.float64)

    def box_iou(p, q):
        lt, rb = np.maximum(p[:2], q[:2]), np.minimum(p[2:], q[2:])
        inter = np.prod(np.clip(rb - lt, 0, None))
        return inter / max(np.prod(p[2:] - p[:2]) + np.prod(q[2:] - q[:2]) - inter, 1e-9)

    unmatched = []
    for mine, other in ((a, b), (b, a)):
        for k in mine.keys() - other.keys():
            r = mine[k]
            near_cut = (min(abs(r["predicted_iou"] - t) for t in (thresholds[0], floors[0])) <= tol
                        or min(abs(r["stability_score"] - t)
                               for t in (thresholds[1], floors[1])) <= tol)
            near_nms = any(abs(box_iou(xyxy(r), xyxy(o)) - nms) <= tol for o in other.values())
            if not (near_cut or near_nms):
                raise AssertionError(f"fixture AMG: record at {k} only in one run, and not at "
                                     f"a cut: {r['predicted_iou']:.4f} "
                                     f"{r['stability_score']:.4f}")
            unmatched.append(k)
    n = max(len(a), len(b))
    if len(unmatched) > 0.02 * n:
        raise AssertionError(f"fixture AMG: {len(unmatched)} of {n} records unmatched")
    return dict(records_card=len(a), records_cpu=len(b), matched=len(a.keys() & b.keys()),
                unmatched=len(unmatched), min_mask_iou=worst_iou, max_score_diff=worst_score)


class Timed:
    """Host-clock seconds of every call of ``obj.name``, the card synchronized
    after each, while the block runs."""

    def __init__(self, obj, name):
        self.obj, self.name, self.seconds = obj, name, []

    def __enter__(self):
        fn = self.saved = getattr(self.obj, self.name)

        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out
        setattr(self.obj, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.saved)


def prompt_layer_checks(predictor, image, seg, emb):
    """The four segment_from_* entry points on one object of ``seg``, and
    batched_inference over the boxes of every object, at batch 32."""
    from micro_sam_tpu_torch import prompt_based_segmentation as pbs
    from micro_sam_tpu_torch.inference import batched_inference
    from micro_sam_tpu_torch.util import get_centers_and_bounding_boxes
    centers, bboxes = get_centers_and_bounding_boxes(seg)
    ids = sorted(bboxes)
    obj = max(ids, key=lambda i: (seg == i).sum())
    (y0, y1), (x0, x1) = bboxes[obj]
    box = np.array([y0, x0, y1, x1])
    center = np.array([[round(centers[obj][0]), round(centers[obj][1])]])
    t0 = time.perf_counter()
    outs = {
        "segment_from_points": pbs.segment_from_points(
            predictor, center, np.array([1]), image_embeddings=emb, return_all=True),
        "segment_from_box": pbs.segment_from_box(predictor, box, image_embeddings=emb,
                                                 return_all=True),
        "segment_from_mask": pbs.segment_from_mask(predictor, seg == obj, image_embeddings=emb,
                                                   return_all=True),
        "segment_from_box_and_points": pbs.segment_from_box_and_points(
            predictor, box, center, np.array([1]), image_embeddings=emb, return_all=True),
    }
    t_prompts = time.perf_counter() - t0
    for name, (m, scores, logits) in outs.items():
        if m.shape != (1,) + seg.shape or m.dtype != bool or not (
                np.isfinite(scores).all() and np.isfinite(logits).all()):
            raise AssertionError(f"{name}: masks {m.shape} {m.dtype}, scores finite "
                                 f"{np.isfinite(scores).all()}")
        log(f"  {name}: mask {m.shape} fg {float(m.mean()):.4f} scores "
            f"{np.round(np.ravel(scores), 4).tolist()}")
    boxes = np.array([[bboxes[i][1][0], bboxes[i][0][0], bboxes[i][1][1], bboxes[i][0][1]]
                      for i in ids], np.float64)
    t0 = time.perf_counter()
    inst = batched_inference(predictor, None, 32, boxes=boxes)
    t_batched = time.perf_counter() - t0
    if inst.shape != seg.shape or inst.dtype != np.uint32:
        raise AssertionError(f"batched_inference: {inst.shape} {inst.dtype}")
    log(f"  batched_inference: {len(boxes)} boxes at batch 32 -> instance segmentation "
        f"{inst.shape} with {len(np.unique(inst)) - 1} objects ({t_batched:.3f} s host clock; "
        f"the four segment_from_* {t_prompts:.3f} s)")
    return dict(segment_from_s=t_prompts, batched_inference_s=t_batched, boxes=len(boxes),
                objects=int(len(np.unique(inst)) - 1))


def amg_vit_b(counters, predictor, image):
    """AMG at vit_b full width: launches during initialize (one encode's) and
    generate (none), initialize timed and split, generate timed in two
    modes, one initialize profiled."""
    import micro_sam_tpu_torch.instance_segmentation as inst
    from micro_sam_tpu_torch import util
    amg = inst.AutomaticMaskGenerator(predictor, points_per_side=AMG_SIDE,
                                      points_per_batch=AMG_BATCH, prefilter_thresholds=None)
    for c in counters.values():
        c.launches = 0
    amg.initialize(image)
    torch.cuda.synchronize()
    init_launches = {k: c.launches for k, c in counters.items() if c.launches}
    for c in counters.values():
        c.launches = 0
    out = {}
    for mode in ("instance_segmentation", "binary_mask"):
        t0 = time.perf_counter()
        out[mode] = amg.generate(output_mode=mode)
        out[f"{mode}_s"] = time.perf_counter() - t0
    gen_launches = {k: c.launches for k, c in counters.items() if c.launches}
    expect = {"layernorm": 24, "gemm": 48, "relpos_attention": 12}
    log(f"  AMG launches: initialize {init_launches} (expected {expect}), generate "
        f"{gen_launches or 0}")
    if init_launches != expect or gen_launches:
        raise AssertionError("AMG did not encode once through the kernels, or generate "
                             "launched a kernel")
    seg = out["instance_segmentation"]
    if seg.shape != image.shape[:2] or seg.dtype != np.uint32 or not isinstance(
            out["binary_mask"], list):
        raise AssertionError(f"AMG generate: {seg.shape} {seg.dtype}")
    n_cand = len(amg.crop_list[0])
    if n_cand != AMG_SIDE ** 2 * 3:
        raise AssertionError(f"AMG kept {n_cand} candidates without floors, not "
                             f"{AMG_SIDE ** 2 * 3}")
    # one initialize, timed: encode, decode + reduction, host copy + RLE
    with Timed(util, "precompute_image_embeddings") as enc, \
            Timed(amg, "_decode_batch") as dec, Timed(amg, "_batch_data") as host:
        t0 = time.perf_counter()
        amg.initialize(image)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
    split = {"encode_ms": 1e3 * sum(enc.seconds), "decode_reduce_ms": 1e3 * sum(dec.seconds),
             "copy_rle_ms": 1e3 * sum(host.seconds)}
    split["other_ms"] = 1e3 * t_init - sum(split.values())
    log(f"  AMG initialize ({AMG_SIDE} x {AMG_SIDE} points, {AMG_BATCH} a batch, 1024^2, host "
        f"clock, the card "
        f"synchronized after each part): {1e3 * t_init:.3f} ms = "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; {n_cand / t_init:.1f} candidates/s; generate: instance_segmentation "
        f"{1e3 * out['instance_segmentation_s']:.3f} ms, binary_mask "
        f"{1e3 * out['binary_mask_s']:.3f} ms ({len(out['binary_mask'])} records)")
    log("  one AMG initialize under torch.profiler:")
    prof = profile_step(lambda: (amg.initialize(image), torch.cuda.synchronize()),
                        AMG_PROFILE_GROUPS)
    return dict(initialize_ms=1e3 * t_init, split_ms=split, candidates=n_cand,
                candidates_per_s=n_cand / t_init,
                generate_ms={m: 1e3 * out[f"{m}_s"] for m in ("instance_segmentation",
                                                               "binary_mask")},
                records=len(out["binary_mask"]), launches_initialize=init_launches,
                profiled_initialize=prof)


def tiled_amg_checks(predictor, image, seg, emb):
    """TiledAutomaticMaskGenerator(points_per_side=16) and one
    batched_tiled_inference with boxes over phase 10's tiled embeddings:
    shapes, and no tile decoded twice."""
    import micro_sam_tpu_torch.instance_segmentation as inst
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.inference import batched_tiled_inference
    from micro_sam_tpu_torch.util import get_centers_and_bounding_boxes
    n_tiles = len(emb["features"])
    tamg = inst.TiledAutomaticMaskGenerator(predictor, points_per_side=16)
    crops = []
    process = tamg._process_crop

    def seen(image_, crop_box, *a, **k):
        crops.append(tuple(crop_box))
        return process(image_, crop_box, *a, **k)
    tamg._process_crop = seen
    with Timed(tamg, "_decode_batch") as dec:
        t0 = time.perf_counter()
        tamg.initialize(image, image_embeddings=emb)
        t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    tseg = tamg.generate()
    t_gen = time.perf_counter() - t0
    if len(crops) != n_tiles or len(set(crops)) != n_tiles or len(dec.seconds) != n_tiles * 4:
        raise AssertionError(f"tiled AMG decoded tiles {crops} in {len(dec.seconds)} batches")
    if tseg.shape != image.shape[:2] or tseg.dtype != np.uint32:
        raise AssertionError(f"tiled AMG: {tseg.shape} {tseg.dtype}")
    _, bboxes = get_centers_and_bounding_boxes(seg)
    boxes = np.array([[b[1][0], b[0][0], b[1][1], b[0][1]] for b in bboxes.values()],
                     np.float64)[::8]
    tiles = []
    install = util.set_precomputed

    def record(p, e, i=None, tile_id=None):
        tiles.append(tile_id)
        return install(p, e, i=i, tile_id=tile_id)
    util.set_precomputed = record
    try:
        t0 = time.perf_counter()
        bseg = batched_tiled_inference(predictor, None, 32, image_embeddings=emb, boxes=boxes)
        t_bt = time.perf_counter() - t0
    finally:
        util.set_precomputed = install
    if len(tiles) != len(set(tiles)) or bseg.shape != image.shape[:2]:
        raise AssertionError(f"batched_tiled_inference: tiles {tiles}, {bseg.shape}")
    log(f"  tiled AMG (16 x 16 points a tile, {n_tiles} tiles of phase 10's 2048^2 "
        f"embeddings): crops {crops}, {len(dec.seconds)} decode batches, "
        f"{sum(len(c) for c in tamg.crop_list)} candidates over the floors; initialize {1e3 * t_init:.3f} ms, generate {1e3 * t_gen:.3f} ms, "
        f"{len(np.unique(tseg)) - 1} objects; batched_tiled_inference {len(boxes)} boxes over "
        f"tiles {tiles}: {len(np.unique(bseg)) - 1} objects ({1e3 * t_bt:.3f} ms)")
    return dict(tiles=n_tiles, decode_batches=len(dec.seconds), initialize_ms=1e3 * t_init,
                generate_ms=1e3 * t_gen, batched_tiled_inference_ms=1e3 * t_bt,
                boxes=len(boxes), tiles_decoded=tiles)


def amg_phase(counters, root, p10):
    """Phase 11: (a) the prompt layer, batched and tiled inference, AMG and
    tiled AMG at vit_b full width (bf16, random weights, seed 0); (b) the
    trained fixture's AMG records on the card (f32) against the port's plain
    path on the CPU (f32, in a process of its own, started first so that it
    runs beside part (a))."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from micro_sam_tpu_torch.sample_data import synthetic_data
    from micro_sam_tpu_torch.util import get_sam_model, precompute_image_embeddings
    with ProcessPoolExecutor(FIXTURE_SHARDS,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_runs = [pool.submit(fixture_amg, root, "cpu", (FIXTURE_FLOORS,), AMG_SIDE, AMG_BATCH,
                                (k, FIXTURE_SHARDS)) for k in range(FIXTURE_SHARDS)]
        log("  (a) vit_b, 1024^2, random weights (seed 0), bf16")
        predictor = get_sam_model("vit_b", seed=0)
        image, seg = synthetic_data((1024, 1024), seed=0)
        emb = precompute_image_embeddings(predictor, image, verbose=False)
        prompts = prompt_layer_checks(predictor, image, seg, emb)
        amg = amg_vit_b(counters, predictor, image)
        inputs = p10["amg_inputs"]
        tiled = tiled_amg_checks(predictor, inputs["image"], inputs["seg"], inputs["emb"])
        del predictor
        torch.cuda.empty_cache()
        log(f"  (b) the trained fixture (f32): AMG {AMG_SIDE} x {AMG_SIDE}, {AMG_BATCH} a batch, "
            f"floors (0.5, 0.5), on the card and on the CPU")
        floors, no_floors = (fixture_records([run]) for run in fixture_amg(
            root, "cuda", (FIXTURE_FLOORS, None), AMG_SIDE, AMG_BATCH))

        def records(run):
            return [(r["point_coords"], [int(c) for c in r["segmentation"]["counts"]])
                    for r in run["records"]]
        if records(floors) != records(no_floors):
            raise AssertionError("fixture AMG: the floors changed the records at the default "
                                 "thresholds")
        t0 = time.perf_counter()
        cpu = fixture_records([run.result()[0] for run in cpu_runs])
        log(f"  waited {time.perf_counter() - t0:.1f} s for the CPU run ({FIXTURE_SHARDS} "
            f"processes, 1/{FIXTURE_SHARDS} of the grid each; the longest initialize "
            f"{cpu['initialize_s']:.1f} s)")
    check = match_fixture_records(floors["records"], cpu["records"])
    at_floors = match_fixture_records(floors["records_at_floors"], cpu["records_at_floors"],
                                      thresholds=FIXTURE_FLOORS)
    areas = [int(sum(r["segmentation"]["counts"][1::2])) for r in floors["records"]]
    log(f"  fixture AMG: {len(floors['records'])} records on the card, {len(cpu['records'])} on "
        f"the CPU, {check['matched']} matched (min mask IoU {check['min_mask_iou']:.5f}, max "
        f"score difference {check['max_score_diff']:.3e}), {check['unmatched']} unmatched; at "
        f"the floors' thresholds {at_floors['records_card']} / {at_floors['records_cpu']}, "
        f"{at_floors['matched']} matched (min IoU {at_floors['min_mask_iou']:.5f}, scores "
        f"{at_floors['max_score_diff']:.3e}), {at_floors['unmatched']} unmatched; "
        f"floors and no floors equal at the default thresholds; survivors per batch "
        f"{floors['survivors']} of {3 * AMG_BATCH} (CPU {cpu['survivors']}); mean mask area "
        f"{float(np.mean(areas)) if areas else 0.0:.1f} px; card initialize "
        f"{1e3 * floors['initialize_s']:.3f} ms with floors, "
        f"{1e3 * no_floors['initialize_s']:.3f} ms without")
    return dict(prompt_layer=prompts, amg_vit_b=amg, tiled=tiled,
                fixture=dict(check, at_floors=at_floors, survivors=floors["survivors"],
                             survivors_cpu=cpu["survivors"],
                             mean_area=float(np.mean(areas)) if areas else 0.0,
                             initialize_ms_floors=1e3 * floors["initialize_s"],
                             initialize_ms_no_floors=1e3 * no_floors["initialize_s"]))


# ---------------------------------------------------------------------------
# phase 12: decoder-based instance segmentation (AIS, APG) and the automatic
# segmentation entry points
# ---------------------------------------------------------------------------

AIS_REPS = 3
AIS_MATCH_IOU, AIS_MATCH_SHARE = 0.8, 0.9
# each CPU reference started in an earlier phase (phase 4's encode, phase
# 12's two decoders), beside that phase's card work
EARLY_CPU_THREADS = 3
APG_PROMPT_SLACK = 0.1
TILED_APG_POINTS = 50
DECODER_F32_TOL = 1e-3
# the decoder's stage functions (models/unetr.py), each timed under a profiler range
UNETR_STAGES = ("conv", "conv_transpose", "upsample2x", "instance_norm", "bn_relu",
                "postprocess_decoder_output")
AIS_LAYERS = (("convolutions (cuDNN)", ("conv", "conv_transpose")),
              ("InstanceNorm", ("instance_norm",)), ("BN + ReLU", ("bn_relu",)),
              ("resize (bilinear x2 upsamplers; crop + resize to the original size)",
               ("upsample2x", "postprocess_decoder_output")))


def random_unetr(use_conv_transpose=True, seed=0):
    """The UNETR decoder at published widths (embed 256, features 512 / 256 /
    128 / 64, 3 outputs), random weights from ``seed``, BN running statistics
    randomized as tests/make_golden.py::build_unetr_torch does (means 0.5 x
    N(0, 1), variances U(0.5, 1.5), from seed 99); on the CPU."""
    from micro_sam_tpu_torch.models.common import BatchNorm
    from micro_sam_tpu_torch.models.unetr import UNETRDecoder
    model = UNETRDecoder(use_conv_transpose=use_conv_transpose).init_(
        torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(99)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.running_mean.copy_(0.5 * torch.randn(m.running_mean.shape, generator=g))
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
    return model.eval()


def unetr_cpu_reference(root, feats, use_conv_transpose, threads):
    """The decoder on the CPU (a process of its own): f32 and bf16 outputs
    on ``feats`` (1, 64, 64, 256) NHWC f32, and the seconds each took."""
    sys.path.insert(0, root)
    torch.set_grad_enabled(False)
    torch.set_num_threads(threads)
    model = random_unetr(use_conv_transpose)
    x = torch.from_numpy(feats).permute(0, 3, 1, 2)
    t0 = time.perf_counter()
    y32 = model(x).numpy()
    t1 = time.perf_counter()
    y16 = model(x.to(torch.bfloat16)).float().numpy()
    return y32, y16, t1 - t0, time.perf_counter() - t1


def unetr_flops(model, x):
    """Operations of one decoder call on ``x``: 2 x the multiply-adds of its
    convolutions and transposed convolutions, from the shapes they run at."""
    from micro_sam_tpu_torch.models import unetr as um
    total = [0]

    def conv(m, inp, out):
        taps = m.kernel_size[0] * m.kernel_size[1]
        total[0] += 2 * out.numel() * m.in_channels // m.groups * taps

    def conv_t(m, inp, out):
        total[0] += 2 * inp[0].numel() * m.out_channels * m.kernel_size[0] * m.kernel_size[1]
    hooks = [m.register_forward_hook(conv_t if isinstance(m, um.ConvTranspose2d) else conv)
             for m in model.modules() if isinstance(m, (um.ConvTranspose2d, um.Conv2d))]
    try:
        model(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


class StageRanges:
    """Runs every stage function of models/unetr.py under a profiler range
    ``unetr.<stage>`` while the block runs."""

    def __enter__(self):
        from micro_sam_tpu_torch.models import unetr as um
        self.um, self.saved = um, {n: getattr(um, n) for n in UNETR_STAGES}
        for n, fn in self.saved.items():
            def ranged(*a, _fn=fn, _n=n, **k):
                with torch.profiler.record_function(f"unetr.{_n}"):
                    return _fn(*a, **k)
            setattr(um, n, ranged)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.um, n, fn)


def profile_ais(step):
    """One AIS ``initialize`` under torch.profiler: the device's busy and idle
    share, and device time by layer (the decoder's stages by their ranges,
    the encode's port kernels by name, the copies to the host)."""
    from torch.profiler import ProfilerActivity, profile
    with StageRanges(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall = (time.perf_counter() - t0) * 1e3
    # the device's own spans of the ranges (GPU user annotations) double the
    # kernels under them: kernels only; each range's kernel time from its
    # host-side event (the kernels of the ops it ran)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
               and not e.key.startswith("unetr.")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy == 0:
        log("  profiled initialize: the profiler saw no device time (not measured)")
        return None
    ranges = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("unetr."):
            name = e.name[len("unetr."):]
            ranges[name] = ranges.get(name, 0.0) + e.device_time_total / 1e3
    layers = {name: sum(ranges.get(s, 0.0) for s in stages) for name, stages in AIS_LAYERS}
    port = [pat for name, pats in SERVE_PROFILE_GROUPS if "port kernel" in name for pat in pats]
    layers["the encode's port kernels"] = sum(e.self_device_time_total for e in kernels
                                              if any(p in e.key for p in port)) / 1e3
    layers["copies to the host"] = sum(e.self_device_time_total for e in kernels
                                       if "Memcpy DtoH" in e.key) / 1e3
    layers["other (the encode's other ops, joins, sigmoid)"] = busy - sum(layers.values())
    log(f"  profiled AIS initialize (torch.profiler): host clock {wall:.3f} ms, device busy "
        f"{busy:.3f} ms (idle share {1 - busy / wall:.3f})")
    for name, ms in layers.items():
        log(f"    {name}: {ms:.3f} ms")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    for e in top:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:110]}")
    return {"host_ms": wall, "device_busy_ms": busy, "idle_share": 1 - busy / wall,
            "by_layer_ms": layers, "stage_ranges_ms": ranges,
            "top_kernels": [[e.key[:110], e.self_device_time_total / 1e3, e.count] for e in top]}


def decoder_checks(feats, cpu_runs):
    """The decoder on the card against the CPU (f32, TF32 off) and bf16
    against f32 on the card, for both upsampler kinds; the bf16 decoder's
    device time at batch 1 and its operations."""
    rows = {}
    x32 = torch.from_numpy(feats).cuda().permute(0, 3, 1, 2)
    x16 = x32.to(torch.bfloat16)
    for use_ct, run in zip((True, False), cpu_runs):
        kind = "conv-transpose" if use_ct else "bilinear + 1x1"
        model = random_unetr(use_ct).cuda()
        y32 = model(x32).float().cpu().numpy()
        y16 = model(x16).float().cpu().numpy()
        ref32, ref16, t32, t16 = run.result()
        scale = float(np.abs(ref32).max())
        err32 = float(np.abs(y32 - ref32).max()) / scale
        drift_card = float(np.abs(y16 - y32).max()) / float(np.abs(y32).max())
        drift_cpu = float(np.abs(ref16 - ref32).max()) / scale
        bf16_tol = max(3e-2, 2 * drift_cpu)
        ok = np.isfinite(y16).all() and err32 <= DECODER_F32_TOL and drift_card <= bf16_tol
        log(f"  decoder ({kind} upsamplers) {y32.shape}: card f32 vs CPU f32 rel "
            f"{err32:.3e} (tol {DECODER_F32_TOL:g}); card bf16 vs card f32 rel {drift_card:.3e} "
            f"(tol max(3e-2, 2 x the CPU's own bf16 drift {drift_cpu:.3e}) = {bf16_tol:.3e}) "
            f"{'ok' if ok else 'FAIL'}; CPU f32 {t32:.1f} s, bf16 {t16:.1f} s")
        if not ok:
            raise AssertionError(f"the decoder ({kind}) on the card disagrees with the CPU")
        flops = unetr_flops(model, x16)
        ms = time_ms(lambda: model(x16), iters=10)
        bound = flops / PEAK_BF16 * 1e3
        log(f"    bf16 decoder at batch 1: {ms:.3f} ms device time, {flops / 1e9:.1f} GFLOP, "
            f"bound {bound:.3f} ms (operations at the dense bf16 peak): {bound / ms:.1%} of it")
        rows[kind] = dict(f32_rel_err=err32, bf16_drift=drift_card, bf16_drift_cpu=drift_cpu,
                          bf16_tol=bf16_tol, ms=ms, gflop=flops / 1e9, bound_ms=bound,
                          cpu_f32_s=t32, cpu_bf16_s=t16)
        del model
    return rows


def truth_maps(seg):
    """AIS maps from an instance segmentation: the foreground, and as both
    distance maps 1 - d / max d over each object (d the distance to the
    object's outside): 0 at its deepest point, about 1 at its boundary, 1 in
    the background."""
    from scipy import ndimage
    from micro_sam_tpu_torch.ops.host_ops import regionprops
    dist = np.ones(seg.shape, np.float32)
    for prop in regionprops(seg):
        sl = tuple(slice(max(s.start - 1, 0), s.stop + 1) for s in prop.slices)
        inside = seg[sl] == prop.label
        d = ndimage.distance_transform_edt(np.pad(inside, 1))[1:-1, 1:-1]
        dist[sl][inside] = (1 - d / d.max())[inside]
    return {"foreground": (seg > 0).astype(np.float32), "center_distances": dist,
            "boundary_distances": dist.copy()}


def match_objects(got, truth, iou_min):
    """(truth objects matched by an object of ``got`` at IoU >= iou_min, truth
    objects)."""
    ids = [int(i) for i in np.unique(truth) if i != 0]
    n = 0
    for i in ids:
        inside = truth == i
        cand, counts = np.unique(got[inside], return_counts=True)
        best = max((c / (inside.sum() + (got == g).sum() - c) for g, c in zip(cand, counts)
                    if g != 0), default=0.0)
        n += int(best >= iou_min)
    return n, len(ids)


def ais_vit_b(counters, predictor, segmenter, image):
    """AIS initialize (one encode's launches, timed and split, profiled) and
    generate on the random decoder's maps."""
    from micro_sam_tpu_torch import instance_segmentation as inst
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.models import unetr as um
    from micro_sam_tpu_torch.utils import zarr_lite
    for c in counters.values():
        c.launches = 0
    segmenter.initialize(image)  # the warm-up
    torch.cuda.synchronize()
    init_launches = {k: c.launches for k, c in counters.items() if c.launches}
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    seg = segmenter.generate()
    t_gen = time.perf_counter() - t0
    gen_launches = {k: c.launches for k, c in counters.items() if c.launches}
    expect = {"layernorm": 24, "gemm": 48, "relpos_attention": 12}
    log(f"  AIS launches: initialize {init_launches} (expected {expect}), generate "
        f"{gen_launches or 0}")
    if init_launches != expect or gen_launches:
        raise AssertionError("AIS did not encode once through the kernels, or generate "
                             "launched a kernel")
    maps = segmenter.get_state()
    if any(m.shape != image.shape[:2] or m.dtype != np.float32 or not np.isfinite(m).all()
           for m in maps.values()) or seg.shape != image.shape[:2] or seg.dtype != np.uint32:
        raise AssertionError("AIS: maps or segmentation of the wrong shape / dtype")
    runs = []
    for _ in range(AIS_REPS):
        with Timed(util, "precompute_image_embeddings") as enc, \
                Timed(util, "_resize_for_encoder") as resize, \
                Timed(predictor, "encode_batch") as encode, \
                Timed(zarr_lite.Group, "create_dataset") as cache, \
                Timed(segmenter._decoder, "_forward_impl") as dec, \
                Timed(um, "postprocess_decoder_output") as post, \
                Timed(inst.DecoderAdapter, "__call__") as call:
            t0 = time.perf_counter()
            segmenter.initialize(image)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        split = {"encode_ms": 1e3 * sum(enc.seconds),
                 "of_it_normalize_resize_ms": 1e3 * sum(resize.seconds),
                 "of_it_encode_batch_ms": 1e3 * sum(encode.seconds),
                 "of_it_cache_write_ms": 1e3 * sum(cache.seconds),
                 "decoder_ms": 1e3 * sum(dec.seconds),
                 "crop_resize_ms": 1e3 * sum(post.seconds)}
        split["copy_to_host_ms"] = 1e3 * sum(call.seconds) - split["decoder_ms"] \
            - split["crop_resize_ms"]
        split["other_ms"] = 1e3 * total - sum(v for k, v in split.items()
                                              if not k.startswith("of_it"))
        runs.append((1e3 * total, split))
    runs.sort(key=lambda r: r[0])
    t_init, split = runs[len(runs) // 2]
    log(f"  AIS initialize (1024^2, host clock, median of {AIS_REPS} after a warm-up, the card "
        f"synchronized after each part): {t_init:.3f} ms = "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; generate (defaults, random maps) {1e3 * t_gen:.3f} ms, "
        f"{len(np.unique(seg)) - 1} objects")
    prof = profile_ais(lambda: (segmenter.initialize(image), torch.cuda.synchronize()))
    return dict(initialize_ms=t_init, split_ms=split, generate_ms=1e3 * t_gen,
                launches_initialize=init_launches, profiled_initialize=prof)


def truth_checks(predictor, ais, apg, seg, emb):
    """AIS and APG on maps built from the truth: AIS matches >= 90 % of the
    objects at IoU >= 0.8; APG derives one prompt per object (+-10 %) and
    ends in a uint32 label image."""
    from micro_sam_tpu_torch import instance_segmentation as inst
    from micro_sam_tpu_torch import util
    maps = truth_maps(seg)
    ais.set_state(maps)
    t0 = time.perf_counter()
    out = ais.generate()
    t_ais = time.perf_counter() - t0
    matched, n = match_objects(out, seg, AIS_MATCH_IOU)
    log(f"  AIS on the truth's maps: {len(np.unique(out)) - 1} objects, {matched} of {n} truth "
        f"objects matched at IoU >= {AIS_MATCH_IOU} (need {AIS_MATCH_SHARE:.0%}); generate "
        f"{1e3 * t_ais:.3f} ms")
    if matched < AIS_MATCH_SHARE * n:
        raise AssertionError("AIS on the truth's maps missed objects")
    util.set_precomputed(predictor, emb)
    apg.set_state(maps)
    derive, prompts = inst._derive_point_prompts, []

    def counted(*a, **k):
        out_ = derive(*a, **k)
        prompts.append(0 if out_ is None else len(out_["points"]))
        return out_
    inst._derive_point_prompts = counted
    try:
        t0 = time.perf_counter()
        apg_out = apg.generate()
        t_apg = time.perf_counter() - t0
    finally:
        inst._derive_point_prompts = derive
    log(f"  APG on the truth's maps: {prompts} prompts for {n} objects (need within "
        f"{APG_PROMPT_SLACK:.0%}), label image {apg_out.shape} {apg_out.dtype} with "
        f"{len(np.unique(apg_out)) - 1} objects (SAM's weights are random: not scored); "
        f"generate {1e3 * t_apg:.3f} ms")
    if prompts != [prompts[0]] or abs(prompts[0] - n) > APG_PROMPT_SLACK * n or \
            apg_out.shape != seg.shape or apg_out.dtype != np.uint32:
        raise AssertionError("APG on the truth's maps: wrong prompts or result")
    return dict(objects=n, ais_matched=matched, ais_generate_ms=1e3 * t_ais,
                apg_prompts=prompts[0], apg_generate_ms=1e3 * t_apg,
                apg_objects=int(len(np.unique(apg_out)) - 1))


def tiled_ais_checks(predictor, decoder, inputs, bf16_tol):
    """Tiled AIS over phase 10's tiled 2048^2 embeddings at batch 4: tiles/s;
    the canvases equal to the bit to each tile's maps from the batch's
    decoder output pasted into its inner block, and within the bf16 bound of
    each tile's own untiled decode; tiled APG with optimize_memory and about
    50 points."""
    from micro_sam_tpu_torch import instance_segmentation as inst
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.models.unetr import postprocess_decoder_output
    from micro_sam_tpu_torch.util import get_centers_and_bounding_boxes
    from micro_sam_tpu_torch.utils.blocking import Blocking
    image, seg, emb = inputs["image"], inputs["seg"], inputs["emb"]
    tiles = sorted(emb["features"])
    tais = inst.get_instance_segmentation_generator(predictor, True, decoder, "ais")
    tais.initialize(image, image_embeddings=emb, batch_size=4)
    times = []
    for _ in range(AIS_REPS):
        t0 = time.perf_counter()
        tais.initialize(image, image_embeddings=emb, batch_size=4)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t_init = statistics.median(times)
    tiling = Blocking([0, 0], image.shape[:2], tuple(emb["tile_shape"]))
    halo = list(emb["halo"])
    feats = []  # each tile's features as the segmenter gets them: installed on the predictor
    for t in tiles:
        feats.append(util.set_precomputed(predictor, emb, tile_id=t).features)
    out = decoder._forward_impl(torch.cat(feats)).float()
    canvases = np.zeros((3,) + image.shape[:2], np.float32)
    worst = 0.0
    for k, t in enumerate(tiles):
        tile = emb["features"][t]
        maps = postprocess_decoder_output(out[k:k + 1], tile["input_size"],
                                          tile["original_size"])[0].cpu().numpy()
        block = tiling.get_block_with_halo(t, halo)
        inner = (slice(None),) + block.inner_block_local.slicing
        canvases[(slice(None),) + block.inner_block.slicing] = maps[inner]
        alone = decoder(feats[k], tile["input_size"], tile["original_size"])[0]
        worst = max(worst, float(np.abs(alone[inner] - maps[inner]).max()))
    got = np.stack([tais._foreground, tais._center_distances, tais._boundary_distances])
    equal = bool(np.array_equal(got, canvases))
    log(f"  tiled AIS ({len(tiles)} tiles of phase 10's 2048^2 embeddings, batch 4): initialize "
        f"{1e3 * t_init:.3f} ms (median of {AIS_REPS}), {len(tiles) / t_init:.2f} tiles/s; "
        f"canvases equal to the batch's decoder output pasted per tile: {equal}; each tile's "
        f"own untiled decode (batch 1) within {worst:.3e} of it (tol {bf16_tol:.3e})")
    if not equal or worst > bf16_tol:
        raise AssertionError("tiled AIS canvases disagree with the tiles' decodes")
    centers, _ = get_centers_and_bounding_boxes(seg)
    pts = np.array([[[c[1], c[0]]] for c in list(centers.values())[:TILED_APG_POINTS]])

    def fifty(*a, **k):
        return {"points": pts, "point_labels": np.ones((len(pts), 1))}
    tapg = inst.get_instance_segmentation_generator(predictor, True, decoder, "apg")
    tapg.set_state(dict(tais.get_state(), image_embeddings=emb))
    t0 = time.perf_counter()
    tseg = tapg.generate(prompt_function=fifty, optimize_memory=True)
    t_apg = time.perf_counter() - t0
    log(f"  tiled APG (optimize_memory, {len(pts)} points at the truth's centers): "
        f"{tseg.shape} {tseg.dtype}, {len(np.unique(tseg)) - 1} objects, generate "
        f"{1e3 * t_apg:.3f} ms")
    if tseg.shape != image.shape[:2] or tseg.dtype != np.uint32:
        raise AssertionError(f"tiled APG: {tseg.shape} {tseg.dtype}")
    return dict(tiles=len(tiles), initialize_ms=1e3 * t_init, tiles_per_s=len(tiles) / t_init,
                canvases_equal=equal, untiled_max_abs_diff=worst, apg_points=len(pts),
                apg_generate_ms=1e3 * t_apg)


def end_to_end_checks(predictor, state, image, seg, root):
    """automatic_instance_segmentation in the modes ais, apg (a point at each
    truth center: the random decoder's maps would give thousands) and amg
    (16 x 16 points); cache_amg_state through the pickle store, reloaded into
    a fresh segmenter with an equal generate."""
    import shutil
    from micro_sam_tpu_torch.automatic_segmentation import (automatic_instance_segmentation,
                                                            get_predictor_and_segmenter)
    from micro_sam_tpu_torch.precompute_state import cache_amg_state
    from micro_sam_tpu_torch.util import get_centers_and_bounding_boxes
    centers, _ = get_centers_and_bounding_boxes(seg)
    pts = np.array([[[c[1], c[0]]] for c in centers.values()])
    gen = {"ais": {}, "apg": dict(prompt_function=lambda *a, **k: {
        "points": pts, "point_labels": np.ones((len(pts), 1))}), "amg": {}}
    out = {}
    for mode in ("ais", "apg", "amg"):
        init = dict(points_per_side=16) if mode == "amg" else {}
        _, segmenter = get_predictor_and_segmenter("vit_b", predictor=predictor, state=state,
                                                   segmentation_mode=mode, **init)
        t0 = time.perf_counter()
        res = automatic_instance_segmentation(predictor, segmenter, image, ndim=2,
                                              verbose=False, **gen[mode])
        out[f"{mode}_ms"] = 1e3 * (time.perf_counter() - t0)
        out[f"{mode}_objects"] = int(len(np.unique(res)) - 1)
        if res.shape != image.shape[:2] or res.dtype != np.uint32:
            raise AssertionError(f"automatic_instance_segmentation ({mode}): {res.shape} "
                                 f"{res.dtype}")
    cache = os.path.join(root, "build", "chip_smoke_ais")
    shutil.rmtree(cache, ignore_errors=True)
    from micro_sam_tpu_torch.util import precompute_image_embeddings
    emb = precompute_image_embeddings(predictor, image, verbose=False)
    first = cache_amg_state(predictor, image, emb, cache, verbose=False, points_per_side=16)
    again = cache_amg_state(predictor, image, emb, cache, verbose=False, points_per_side=16)
    same = bool(np.array_equal(first.generate(), again.generate()))
    out["amg_state_reloaded_equal"] = same
    log("  automatic_instance_segmentation (ndim=2): " + ", ".join(
        f"{m} {out[f'{m}_objects']} objects in {out[f'{m}_ms']:.1f} ms"
        for m in ("ais", "apg", "amg")) + f"; cache_amg_state written to "
        f"{os.path.relpath(cache, root)}/amg_state/state.pkl and reloaded: generate equal "
        f"{same}; the AIS h5 store (is_state.h5) needs h5py, which this machine lacks: it is "
        f"covered by the CPU tests (tests/test_torch_automatic_segmentation.py)")
    if not same:
        raise AssertionError("cache_amg_state: the reloaded state generates otherwise")
    return out


def start_decoder_references(pool, root):
    """Phase 12's CPU references of the decoder, submitted to ``pool`` (an
    earlier phase's start, so that they run beside it): the features of
    FIXTURE_IMAGE (vit_b bf16, seed 0, on the card) and a future per
    upsampler kind."""
    from micro_sam_tpu_torch.sample_data import synthetic_data
    from micro_sam_tpu_torch.util import get_sam_model, precompute_image_embeddings, set_precomputed
    predictor = get_sam_model("vit_b", seed=0)
    emb = precompute_image_embeddings(predictor, synthetic_data(**FIXTURE_IMAGE)[0], verbose=False)
    feats = set_precomputed(predictor, emb).features.float().cpu().numpy()
    del predictor
    torch.cuda.empty_cache()
    return feats, [pool.submit(unetr_cpu_reference, root, feats, use_ct, EARLY_CPU_THREADS)
                   for use_ct in (True, False)]


def ais_phase(counters, root, p10, decoder_refs):
    """Phase 12: the UNETR decoder on the card against the CPU (its CPU
    references ``decoder_refs``, from ``start_decoder_references``), AIS and
    APG (vit_b bf16, random weights from seed 0, the decoder at published
    widths with random BN statistics) on phase 11's 1024^2 image, on maps
    built from its truth, tiled over phase 10's embeddings, and the
    automatic segmentation entry points end to end."""
    from micro_sam_tpu_torch.automatic_segmentation import get_predictor_and_segmenter
    from micro_sam_tpu_torch.instance_segmentation import get_instance_segmentation_generator
    from micro_sam_tpu_torch.sample_data import synthetic_data
    from micro_sam_tpu_torch.util import get_sam_model, precompute_image_embeddings
    feats, cpu_runs = decoder_refs
    predictor = get_sam_model("vit_b", seed=0)
    image, seg = synthetic_data(**FIXTURE_IMAGE)
    emb = precompute_image_embeddings(predictor, image, verbose=False)
    state = {"decoder_state": random_unetr(True).state_dict()}
    _, ais = get_predictor_and_segmenter("vit_b", predictor=predictor, state=state,
                                         segmentation_mode="ais")
    log(f"  (a) AIS, vit_b bf16 on a 1024^2 synthetic_data image (seed "
        f"{FIXTURE_IMAGE['seed']}), decoder of random weights")
    a = ais_vit_b(counters, predictor, ais, image)
    log("  (b) AIS and APG on maps built from the image's truth")
    apg = get_instance_segmentation_generator(predictor, False, ais._decoder, "apg")
    truth = truth_checks(predictor, ais, apg, seg, emb)
    log("  (e) the automatic segmentation entry points (while the CPU references run)")
    e2e = end_to_end_checks(predictor, state, image, seg, root)
    log("  (c) the decoder on the card against the CPU (two processes, started at phase 9)")
    t0 = time.perf_counter()
    rows = decoder_checks(feats, cpu_runs)
    log(f"  (waited {time.perf_counter() - t0:.1f} s for the CPU references and the checks)")
    log("  (d) tiled AIS and APG over phase 10's tiled embeddings")
    tiled = tiled_ais_checks(predictor, ais._decoder, p10["amg_inputs"],
                             rows["conv-transpose"]["bf16_tol"])
    del predictor, ais, apg
    torch.cuda.empty_cache()
    return dict(decoder=rows, ais=a, truth=truth, tiled=tiled, end_to_end=e2e)


# ---------------------------------------------------------------------------
# phase 13: multi-dimensional segmentation and tracking
# ---------------------------------------------------------------------------

VOLUME = dict(shape=(512, 512), seed=11, n_objects=12)   # tests/test_multi_dimensional_segmentation.py
VOLUME_SLICES, VOLUME_SHIFT, VOLUME_BATCH = 8, 2, 4      # rows a slice, np.roll along y
PROJECTION_IOU = 0.5
# (name, projection, anchors, stop_lower, stop_upper): the five modes walk out
# of slice 3 under the IoU stop; the flag dict bridges the gap of 3 between two
# truth slices (two walks, each one step from a truth mask: the random
# decoder's masks may cover the slice, and a walk that went on from one would
# derive its next prompt from it) and walks out of both under the IoU stop
PROJECTION_RUNS = [(m, m, (3,), False, False)
                   for m in ("box", "mask", "points", "points_and_mask", "single_point")] + [
    ("flags box + points, bridge", {"use_box": True, "use_mask": False, "use_points": True},
     (2, 5), False, False)]
TILED_3D = dict(slices=2, shape=(1024, 1024), tile_shape=(512, 512), halo=(128, 128))
# the trained fixture over 6 slices of its image rolled 4 rows a slice: the
# three largest objects from slice 2 in three modes, IoU stop 0.2 (its masks
# lie 0.5-0.85 from the truth, a stricter stop ends most walks at once)
FIXTURE_3D = dict(slices=6, shift=4, anchor=2, iou=0.2, modes=("mask", "points", "box"),
                  objects=3, threads=4)
TRACKING = dict(n_frames=10, shape=(256, 256), n_cells=6, seed=0)
SCORER_TOL = 1e-5
# AIS watershed thresholds at quantiles of the random decoder's maps (center
# distance, boundary distance, foreground), as tests/test_torch_multi_dimensional_segmentation.py,
# and a floor on the object size: the random maps' objects are ~80 px, about
# 1000 a 512^2 slice without it (the merge's greedy multicut re-sums every
# edge at each contraction: its time grows with the square of the objects)
AIS_QUANTILES = (0.7, 0.5, 0.3)
AIS_MIN_SIZE = {"volume": 200, "tracking": 100}


class Span(Timed):
    """``Timed``, and the kernel launches the calls made, summed per kernel."""

    def __init__(self, obj, name, counters):
        super().__init__(obj, name)
        self.counters, self.launches = counters, {}

    def __enter__(self):
        fn = self.saved = getattr(self.obj, self.name)

        def call(*a, **kw):
            before = {n: c.launches for n, c in self.counters.items()}
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            for n, c in self.counters.items():
                if c.launches != before[n]:
                    self.launches[n] = self.launches.get(n, 0) + c.launches - before[n]
            return out
        setattr(self.obj, self.name, call)
        return self


def encode_launches(counters, calls):
    """The launches ``calls`` vit_b encode_batch calls make (a call's launches
    do not depend on its batch)."""
    return {k: v * calls for k, v in {"layernorm": 24, "gemm": 48, "relpos_attention": 12}.items()
            if k in counters}


def check_launches(what, got, calls, counters):
    expect = encode_launches(counters, calls)
    log(f"  {what}: launches {got or 0} (expected {expect}: {calls} encode calls)")
    if got != expect:
        raise AssertionError(f"{what}: the encodes did not go through the kernels as expected")


def rolled(image, n, shift):
    return np.stack([np.roll(image, shift * z, axis=0) for z in range(n)])


def unique_per_slice(vol):
    """Each slice's ids lifted above those of the slices before it."""
    out = np.zeros(vol.shape, np.uint32)
    offset = 0
    for z in range(len(vol)):
        ids, inv = np.unique(vol[z], return_inverse=True)
        lut = (np.arange(len(ids)) + offset + (ids[0] != 0)).astype(np.uint32)
        lut[0] = 0 if ids[0] == 0 else lut[0]
        out[z] = lut[inv.reshape(vol[z].shape)]
        offset = max(offset, int(out[z].max()))
    return out


def ais_thresholds(segmenter, image, min_size):
    segmenter.initialize(image)
    st = segmenter.get_state()
    return dict(zip(("center_distance_threshold", "boundary_distance_threshold",
                     "foreground_threshold"),
                    (float(np.quantile(st[k], q)) for k, q in zip(
                        ("center_distances", "boundary_distances", "foreground"),
                        AIS_QUANTILES))), distance_smoothing=1.0, min_size=min_size)


def clear_objects(truth, z):
    """The objects of slice ``z``, largest first, that stay clear of the top
    and bottom rows in every slice: np.roll wraps an object there round to
    the other side, and a prompt from such a mask spans the slice (its
    derived points then take the quadratic peak suppression of
    _compute_points_from_mask over a slice-sized crop, tens of seconds a
    prompt)."""
    ids, counts = np.unique(truth[z], return_counts=True)
    out = []
    for i in ids[1:][np.argsort(-counts[1:])]:
        rows = np.nonzero((truth == i).any(axis=(0, 2)))[0]
        if rows.min() > 0 and rows.max() < truth.shape[1] - 1:
            out.append(int(i))
    if not out:
        raise AssertionError("no object of the volume stays clear of its borders")
    return out


def projection_split(spans, wall_s, n):
    """ms per projected slice: the store read (set_precomputed less the copy),
    the copy to the card (set_features), the decode (predict, masks back on
    the host included), and the host (segment_from_mask's prompts and the
    walk's IoU)."""
    proj, install, copy, dec = (1e3 * sum(s.seconds) for s in spans)
    split = {"store_read_ms": (install - copy) / n, "copy_to_card_ms": copy / n,
             "decode_ms": dec / n, "host_ms": (1e3 * wall_s - install - dec) / n}
    split["of_host_prompts_ms"] = (proj - install - dec) / n
    return {"per_slice_ms": 1e3 * wall_s / n, "projected_slices": n, **split}


def interactive_3d(counters, predictor, volume, truth, root):
    """(a) The volume's embeddings, then segment_mask_in_volume in each
    projection run, launch-free; the split of a projected slice, over the
    in-memory embeddings and over the lazily read store."""
    from micro_sam_tpu_torch import multi_dimensional_segmentation as mds
    from micro_sam_tpu_torch import util
    out = {}
    for c in counters.values():
        c.launches = 0
    with Span(predictor, "encode_batch", counters) as enc:
        t0 = time.perf_counter()
        emb = util.precompute_image_embeddings(predictor, volume, ndim=3,
                                               batch_size=VOLUME_BATCH, verbose=False)
        torch.cuda.synchronize()
        out["embeddings_ms"] = 1e3 * (time.perf_counter() - t0)
    launches = {k: c.launches for k, c in counters.items() if c.launches}
    check_launches(f"precompute_image_embeddings(ndim=3, batch_size={VOLUME_BATCH}) of "
                   f"{len(volume)} slices", launches, len(enc.seconds), counters)
    if len(enc.seconds) != -(-len(volume) // VOLUME_BATCH):
        raise AssertionError(f"{len(enc.seconds)} encode calls for {len(volume)} slices")
    feats = emb["features"]
    if feats.shape != (len(volume), 1, 256, 64, 64) or not np.isfinite(feats).all():
        raise AssertionError(f"volume embeddings {feats.shape}")
    out["embeddings_ms_per_slice"] = out["embeddings_ms"] / len(volume)
    obj = clear_objects(truth, 3)[0]

    def project(embeddings, runs):
        rows = []
        for c in counters.values():
            c.launches = 0
        with Timed(mds, "segment_from_mask") as proj, Timed(util, "set_precomputed") as inst, \
                Timed(predictor, "set_features") as copy, Timed(predictor, "predict") as dec:
            for name, projection, anchors, lo, hi in runs:
                seg = np.zeros(volume.shape, np.uint32)
                for a in anchors:
                    seg[a] = truth[a] == obj
                n0, t0 = len(proj.seconds), time.perf_counter()
                res, (z0, z1) = mds.segment_mask_in_volume(seg, predictor, embeddings,
                                                           np.array(anchors), lo, hi,
                                                           PROJECTION_IOU, projection)
                wall = time.perf_counter() - t0
                n = len(proj.seconds) - n0
                written = [int(z) for z in range(len(res)) if res[z].any()]
                ok = (0 <= z0 <= anchors[0] and anchors[-1] <= z1 < len(volume)
                      and all((res[a] == (truth[a] == obj)).all() for a in anchors)
                      and set(written) <= set(range(z0, z1 + 1)) and res.dtype == np.uint32)
                rows.append(dict(name=name, z_range=[int(z0), int(z1)], projected=n,
                                 written=written, ms=1e3 * wall, ok=bool(ok)))
                log(f"  segment_mask_in_volume {name}: z range ({z0}, {z1}), {n} slices "
                    f"projected, written {written}, {1e3 * wall:.3f} ms")
                if not ok:
                    raise AssertionError(f"segment_mask_in_volume {name}: z range or slices off")
        during = {k: c.launches for k, c in counters.items() if c.launches}
        if during:
            raise AssertionError(f"a port kernel launched during the projection: {during}")
        total = sum(r["ms"] for r in rows) / 1e3
        return rows, projection_split((proj, inst, copy, dec), total,
                                      sum(r["projected"] for r in rows))

    project(emb, PROJECTION_RUNS[:1])  # the warm-up: the decoder's first calls
    out["runs"], out["split"] = project(emb, PROJECTION_RUNS)
    log("  ms per projected slice over the in-memory embeddings (host clock, the card "
        "synchronized after each part): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                                      out["split"].items()))
    # the same projection over the embedding store read lazily, slice by slice
    import shutil
    store = os.path.join(root, "build", "chip_smoke_3d", "embeddings.zarr")
    shutil.rmtree(os.path.dirname(store), ignore_errors=True)
    for c in counters.values():
        c.launches = 0
    with Span(predictor, "encode_batch", counters) as enc:
        t0 = time.perf_counter()
        util.precompute_image_embeddings(predictor, volume, ndim=3, batch_size=VOLUME_BATCH,
                                         save_path=store, verbose=False)
        out["store_write_ms"] = 1e3 * (time.perf_counter() - t0)
    check_launches("the same to a zarr store", {k: c.launches for k, c in counters.items()
                                                if c.launches}, len(enc.seconds), counters)
    lazy = util.precompute_image_embeddings(predictor, volume, ndim=3, save_path=store,
                                            lazy_loading=True, verbose=False)
    _, out["split_lazy_store"] = project(lazy, PROJECTION_RUNS[:1])
    log("  ms per projected slice over the store read lazily: " + ", ".join(
        f"{k} {v:.3f}" for k, v in out["split_lazy_store"].items()))
    return out, emb


def automatic_3d(counters, predictor, ais, tiled_ais, volume, kw):
    """(b) automatic_instance_segmentation(ndim=3) with AIS: the encodes only
    during the embeddings; the split of embeddings, per-slice initialize +
    generate and the merge. Then its tiled form once."""
    from micro_sam_tpu_torch import multi_dimensional_segmentation as mds
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.automatic_segmentation import automatic_instance_segmentation
    from micro_sam_tpu_torch.sample_data import synthetic_data
    out = {}
    for segmenter, vol, tiling, tag in (
            (ais, volume, {}, "untiled"),
            (tiled_ais, rolled(synthetic_data(shape=TILED_3D["shape"], seed=5)[0],
                               TILED_3D["slices"], VOLUME_SHIFT),
             dict(tile_shape=TILED_3D["tile_shape"], halo=TILED_3D["halo"]), "tiled")):
        for c in counters.values():
            c.launches = 0
        with Span(predictor, "encode_batch", counters) as enc, \
                Span(util, "precompute_image_embeddings", counters) as emb, \
                Span(segmenter, "initialize", counters) as init, \
                Span(segmenter, "generate", counters) as gen, \
                Span(mds, "merge_instance_segmentation_3d", counters) as merge:
            t0 = time.perf_counter()
            seg = automatic_instance_segmentation(predictor, segmenter, vol, ndim=3,
                                                  verbose=False, **tiling, **kw)
            torch.cuda.synchronize()
            total = 1e3 * (time.perf_counter() - t0)
        check_launches(f"automatic_instance_segmentation(ndim=3, {tag}): embeddings",
                       emb.launches, len(enc.seconds), counters)
        outside = {k: v for s in (init, gen, merge) for k, v in s.launches.items()}
        if outside or (tag == "untiled" and len(enc.seconds) != len(vol)):
            raise AssertionError(f"automatic 3d ({tag}): launches outside the embeddings "
                                 f"{outside}, or {len(enc.seconds)} encode calls")
        if seg.shape != vol.shape or seg.dtype != np.uint32:
            raise AssertionError(f"automatic 3d ({tag}): {seg.shape} {seg.dtype}")
        row = {"ms": total, "embeddings_ms": 1e3 * sum(emb.seconds),
               "initialize_ms_per_slice": 1e3 * sum(init.seconds) / len(vol),
               "generate_ms_per_slice": 1e3 * sum(gen.seconds) / len(vol),
               "merge_ms": 1e3 * sum(merge.seconds), "encode_calls": len(enc.seconds),
               "slices": len(vol), "objects_3d": int(len(np.unique(seg)) - 1)}
        row["other_ms"] = total - row["embeddings_ms"] - row["merge_ms"] - len(vol) * (
            row["initialize_ms_per_slice"] + row["generate_ms_per_slice"])
        out[tag] = row
        log(f"  automatic 3d ({tag}, {len(vol)} slices of {vol.shape[1]}^2"
            + (f" in {tiling['tile_shape'][0]}^2 tiles, halo {tiling['halo'][0]}" if tiling
               else "") + "): " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else
                                            f"{k} {v}" for k, v in row.items()))
    return out


def fixture_projection(root, device, threads=None):
    """The trained fixture SAM (f32) on ``device``: the embeddings of
    FIXTURE_3D's volume, then segment_mask_in_volume for each of its
    objects and modes. Returns {(object, mode): (bit-packed masks, z range)}
    and the seconds it took."""
    sys.path.insert(0, root)
    torch.set_grad_enabled(False)
    if threads:
        torch.set_num_threads(threads)
    from micro_sam_tpu_torch.models.convert import params_from_flat_npz
    from micro_sam_tpu_torch.models.sam import Sam
    from micro_sam_tpu_torch.multi_dimensional_segmentation import segment_mask_in_volume
    from micro_sam_tpu_torch.predictor import SamPredictor
    from micro_sam_tpu_torch.sample_data import synthetic_data
    from micro_sam_tpu_torch.util import precompute_image_embeddings
    t0 = time.perf_counter()
    cfg, sd = params_from_flat_npz(os.path.join(root, FIXTURE), compute_dtype="float32")
    sam = Sam(cfg)
    sam.load_state_dict(sd)
    predictor = SamPredictor(sam.to(device).eval())
    image, seg = synthetic_data(**FIXTURE_IMAGE)
    volume = rolled(image, FIXTURE_3D["slices"], FIXTURE_3D["shift"])
    truth = rolled(seg, FIXTURE_3D["slices"], FIXTURE_3D["shift"])
    emb = precompute_image_embeddings(predictor, volume, ndim=3, batch_size=2, verbose=False)
    a = FIXTURE_3D["anchor"]
    objects = clear_objects(truth, a)[:FIXTURE_3D["objects"]]
    runs = {}
    for obj in objects:
        for mode in FIXTURE_3D["modes"]:
            s = np.zeros(volume.shape, np.uint32)
            s[a] = truth[a] == obj
            res, z_range = segment_mask_in_volume(s, predictor, emb, np.array([a]), False, False,
                                                  FIXTURE_3D["iou"], mode)
            runs[(obj, mode)] = (np.packbits(res > 0), tuple(int(z) for z in z_range))
    return runs, time.perf_counter() - t0


def fixture_checks(root, cpu_run):
    """(c) The fixture's projections on the card against the CPU: every
    slice's mask within IoU 0.99, the same z range."""
    card, card_s = fixture_projection(root, "cuda")
    t0 = time.perf_counter()
    cpu, cpu_s = cpu_run.result()
    waited = time.perf_counter() - t0
    n = FIXTURE_3D["slices"] * FIXTURE_IMAGE["shape"][0] * FIXTURE_IMAGE["shape"][1]
    worst, ranges = 1.0, {}
    for key, (bits, z_range) in card.items():
        got = np.unpackbits(bits, count=n).reshape(FIXTURE_3D["slices"], -1).astype(bool)
        ref = np.unpackbits(cpu[key][0], count=n).reshape(FIXTURE_3D["slices"], -1).astype(bool)
        for z in range(len(got)):
            union = (got[z] | ref[z]).sum()
            if union:
                worst = min(worst, float((got[z] & ref[z]).sum() / union))
        ranges[f"{key[0]} {key[1]}"] = list(z_range)
        if z_range != cpu[key][1]:
            raise AssertionError(f"fixture projection {key}: z range {z_range} on the card, "
                                 f"{cpu[key][1]} on the CPU")
    log(f"  trained fixture (f32, TF32 off), segment_mask_in_volume over {FIXTURE_3D['slices']} "
        f"slices of 1024^2, {len(card)} runs: card {card_s:.1f} s, CPU {cpu_s:.1f} s (waited "
        f"{waited:.1f} s); worst slice mask IoU card vs CPU {worst:.6f}, z ranges equal: {ranges}")
    if worst < 0.99:
        raise AssertionError(f"fixture projection: a slice's mask IoU {worst} < 0.99")
    return dict(runs=len(card), min_mask_iou=worst, z_ranges=ranges, card_s=card_s, cpu_s=cpu_s,
                waited_s=waited)


def merge_checks(truth):
    """(c) The truth slices merge back into the 3d truth; gap closing fills a
    removed slice; the multicut's C++ equals its Python twin."""
    from micro_sam_tpu_torch import native
    from micro_sam_tpu_torch.multi_dimensional_segmentation import merge_instance_segmentation_3d
    t0 = time.perf_counter()
    merged = merge_instance_segmentation_3d(unique_per_slice(truth), verbose=False)
    merge_ms = 1e3 * (time.perf_counter() - t0)
    worst, n_objects = 1.0, 0
    for i in (int(i) for i in np.unique(truth) if i):
        inside = truth == i
        got = np.unique(merged[inside])
        iou = float(inside.sum() / ((merged == got[0]).sum() + inside.sum()
                                    - (merged[inside] == got[0]).sum()))
        if len(got) != 1 or got[0] == 0 or iou < 0.95:
            raise AssertionError(f"merge of the truth: object {i} got ids {got}, IoU {iou}")
        worst, n_objects = min(worst, iou), n_objects + 1
    gap = truth.copy()
    obj = int(np.unique(truth[3])[1])
    gap[3][gap[3] == obj] = 0
    closed = merge_instance_segmentation_3d(unique_per_slice(gap), gap_closing=1, verbose=False)
    both = (truth[2] == obj) & (truth[4] == obj)
    own = np.unique(closed[2][truth[2] == obj])
    filled = float((closed[3][both] == own[0]).mean()) if len(own) == 1 else 0.0
    if filled != 1.0 or both.sum() < 0.8 * (truth[3] == obj).sum():
        raise AssertionError(f"gap closing: {filled} of the removed slice's pixels filled")
    rng = np.random.RandomState(7)
    graphs = []
    for _ in range(3):
        uv = rng.randint(0, 200, size=(1000, 2))
        uv = uv[uv[:, 0] != uv[:, 1]]
        costs = rng.randn(len(uv)) + 0.3
        t0 = time.perf_counter()
        got = native.greedy_multicut(200, uv, costs)
        t1 = time.perf_counter()
        ref = native.greedy_multicut_plain(200, uv, costs)
        t2 = time.perf_counter()
        if not np.array_equal(got, ref):
            raise AssertionError("greedy_multicut: the C++ and its Python twin differ")
        graphs.append(dict(clusters=int(got.max()) + 1, cpp_ms=1e3 * (t1 - t0),
                           plain_ms=1e3 * (t2 - t1)))
    log(f"  merge of the {len(truth)} truth slices (ids unique per slice): {n_objects} objects, "
        f"each one 3d id, worst IoU {worst:.4f}, {merge_ms:.1f} ms; gap closing filled the "
        f"removed slice ({int(both.sum())} pixels); greedy_multicut C++ = plain on 3 graphs of "
        f"200 nodes / {len(uv)} edges: {graphs}")
    return dict(objects=n_objects, min_iou=worst, merge_ms=merge_ms, gap_filled_px=int(both.sum()),
                multicut=graphs)


def tracked_links(segs, tracked, lineages):
    """{(frame, object id): track id} and {child track: parent track} of a
    tracking result, for evaluate_tracking."""
    node_to_track = {}
    for t in range(len(segs)):
        for oid in np.unique(segs[t]):
            if oid:
                tr = np.bincount(tracked[t][segs[t] == oid]).argmax()
                if tr:
                    node_to_track[(t, int(oid))] = int(tr)
    parents = {c: p for lin in lineages for p, children in lin.items() for c in children}
    return node_to_track, parents


def tracking_checks(counters, predictor, ais):
    """(d) track_across_frames with the greedy, the learned (scorer on the card)
    and the auto linker on a HeLa-like sequence, the scorer on the card against
    the CPU, then automatic_tracking through AIS."""
    from micro_sam_tpu_torch import learned_tracking as lt
    from micro_sam_tpu_torch import multi_dimensional_segmentation as mds
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.automatic_segmentation import automatic_tracking
    images, segs, links = lt.hela_like_tracking_sequence(**TRACKING)
    out = {}
    for name, tracker in (("greedy", None), ("learned", "learned"), ("auto", "auto")):
        t0 = time.perf_counter()
        tracked, lineages = mds.track_across_frames(images, segs, verbose=False, tracker=tracker)
        ms = 1e3 * (time.perf_counter() - t0)
        m = lt.evaluate_tracking(segs, links, *tracked_links(segs, tracked, lineages))
        out[name] = dict(ms=ms, tracks=int(len(np.unique(tracked)) - 1),
                         lineages=len(lineages), **m)
        log(f"  track_across_frames ({name}): {ms:.1f} ms, {out[name]['tracks']} tracks, "
            f"{len(lineages)} lineages; link f1 {m['link_f1']:.3f}, division f1 "
            f"{m['division_f1']:.3f} against the truth links")
    params = lt.load_linker(lt._PACKAGED_WEIGHTS)
    card, cpu = lt.LearnedTracker(params), lt.LearnedTracker(params, device="cpu")
    worst = 0.0
    for t in range(len(segs) - 1):
        _, _, got = card.score_frames(segs[t], segs[t + 1], images[t], images[t + 1])
        _, _, ref = cpu.score_frames(segs[t], segs[t + 1], images[t], images[t + 1])
        worst = max(worst, float(np.abs(got - ref).max() / np.abs(ref).max()))
    same = card.link(segs, images) == cpu.link(segs, images)
    log(f"  the scorer on {card.device} against the CPU (f32, TF32 off): logits rel "
        f"{worst:.3e} (<= {SCORER_TOL}), links identical {same}")
    if worst > SCORER_TOL or not same:
        raise AssertionError("the learned scorer on the card differs from the CPU")
    out["scorer_rel_err"], out["scorer_links_identical"] = worst, same
    kw = ais_thresholds(ais, images[0], AIS_MIN_SIZE["tracking"])
    for c in counters.values():
        c.launches = 0
    with Span(predictor, "encode_batch", counters) as enc, \
            Span(util, "precompute_image_embeddings", counters) as emb, \
            Span(ais, "initialize", counters) as init, Span(ais, "generate", counters) as gen, \
            Span(mds, "track_across_frames", counters) as track:
        t0 = time.perf_counter()
        tracked, lineages = automatic_tracking(predictor, ais, images, output_path=None,
                                               verbose=False, **kw)
        total = 1e3 * (time.perf_counter() - t0)
    check_launches(f"automatic_tracking of {len(images)} frames: embeddings", emb.launches,
                   len(enc.seconds), counters)
    outside = {k: v for s in (init, gen, track) for k, v in s.launches.items()}
    if outside or len(enc.seconds) != len(images) or tracked.shape != images.shape:
        raise AssertionError(f"automatic_tracking: launches outside the embeddings {outside}, "
                             f"{len(enc.seconds)} encode calls, {tracked.shape}")
    row = {"ms": total, "embeddings_ms": 1e3 * sum(emb.seconds),
           "initialize_ms_per_frame": 1e3 * sum(init.seconds) / len(images),
           "generate_ms_per_frame": 1e3 * sum(gen.seconds) / len(images),
           "tracking_ms": 1e3 * sum(track.seconds), "frames": len(images),
           "tracks": int(len(np.unique(tracked)) - 1), "lineages": len(lineages)}
    out["automatic_tracking"] = row
    log(f"  automatic_tracking (AIS, {len(images)} frames of {images.shape[1]}^2): " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}" for k, v in row.items()))
    return out


def multi_dim_phase(counters, root):
    """Phase 13: multi-dimensional segmentation and tracking on vit_b bf16
    (random weights, seed 0) with the UNETR decoder at published widths; the
    checks that do not depend on random weights; the trained fixture on the
    card against the CPU."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from micro_sam_tpu_torch.automatic_segmentation import get_predictor_and_segmenter
    from micro_sam_tpu_torch.sample_data import synthetic_data
    from micro_sam_tpu_torch.util import get_sam_model
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_run = pool.submit(fixture_projection, root, "cpu", FIXTURE_3D["threads"])
        predictor = get_sam_model("vit_b", seed=0)
        image, seg = synthetic_data(**VOLUME)
        volume = rolled(image, VOLUME_SLICES, VOLUME_SHIFT)
        truth = rolled(seg, VOLUME_SLICES, VOLUME_SHIFT).astype(np.uint32)
        log(f"  (a) interactive 3d: vit_b bf16, a ({VOLUME_SLICES}, {VOLUME['shape'][0]}, "
            f"{VOLUME['shape'][1]}) synthetic_data volume rolled {VOLUME_SHIFT} rows a slice")
        a, _ = interactive_3d(counters, predictor, volume, truth, root)
        state = {"decoder_state": random_unetr(True).state_dict()}
        _, ais = get_predictor_and_segmenter("vit_b", predictor=predictor, state=state,
                                             segmentation_mode="ais")
        _, tiled_ais = get_predictor_and_segmenter("vit_b", predictor=predictor, state=state,
                                                   segmentation_mode="ais", is_tiled=True)
        log("  (b) automatic 3d segmentation (AIS, the decoder at published widths, thresholds "
            f"at the quantiles {AIS_QUANTILES} of slice 0's maps)")
        kw = ais_thresholds(ais, volume[0], AIS_MIN_SIZE["volume"])
        b = automatic_3d(counters, predictor, ais, tiled_ais, volume, kw)
        log("  (c) checks that do not depend on random weights")
        c = merge_checks(truth)
        c["fixture"] = fixture_checks(root, cpu_run)
        log("  (d) tracking: a HeLa-like sequence "
            f"({TRACKING['n_frames']} frames of {TRACKING['shape'][0]}^2, {TRACKING['n_cells']} "
            "cells)")
        d = tracking_checks(counters, predictor, ais)
    del predictor, ais, tiled_ais
    torch.cuda.empty_cache()
    return dict(interactive=a, automatic_3d=b, checks=c, tracking=d)


# ---------------------------------------------------------------------------
# phase 14: joint finetuning (SAM and the UNETR decoder) and the other trainers
# ---------------------------------------------------------------------------

JOINT_PROFILE_GROUPS = PROFILE_GROUPS[:2] + (
    ("matrix products and convolutions (cuBLAS / cuDNN; SAM and the decoder)",
     ("gemm", "nvjet", "sm90", "xmma", "cutlass", "conv", "Conv")),
    ("LayerNorm (PyTorch)", ("layer_norm",)),
    ("InstanceNorm statistics (Welford reductions, forward)", ("Welford",)),
    ("bilinear resizes (SAM's mask upscaling, the decoder's x2 and output resize)",
     ("upsample", "bilinear")),
    ("dtype casts and copies", ("copy_kernel",)),
)
DECODER_STEP_F32_TOL = 1e-3   # every decoder gradient, of its tensor's max
DECODER_LOSS_F32_TOL = 1e-5


class TrainersKept:
    """Patches the trainer class ``name`` that ``training/training.py`` builds
    (``SamTrainer`` or ``JointSamTrainer``) with a subclass that keeps each
    trainer it builds, with copies of its SAM's state (``sam0``) and, where it
    has one, its decoder's (``unetr0``) as they were built."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        from micro_sam_tpu_torch.training import training as tr
        self.tr, self.saved, self.trainers = tr, getattr(tr, self.name), []
        seen = self

        class Seen(self.saved):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.sam0 = {k: v.clone() for k, v in self.model.sam.state_dict().items()}
                if hasattr(self, "unetr"):
                    self.unetr0 = {k: v.clone() for k, v in self.unetr.state_dict().items()}
                seen.trainers.append(self)
        setattr(tr, self.name, Seen)
        return self

    def __exit__(self, *exc):
        setattr(self.tr, self.name, self.saved)


def joint_loaders(imgs, segs):
    """default_sam_loader at its default (with the distance targets) over
    phase 6's patches: 4 for training (2 batches of 2), 2 for validation."""
    from micro_sam_tpu_torch.training import default_sam_loader

    def loader(train):
        return default_sam_loader(
            raw_paths=imgs[:4] if train else imgs[4:], raw_key=None,
            label_paths=segs[:4] if train else segs[4:], label_key=None, patch_shape=(512, 512),
            n_samples=4 if train else 2, is_train=train, batch_size=2)
    return loader(True), loader(False)


def counted(counters, fn):
    """(fn's result, the launches it made): the counts set to 0 just before
    and read just after (the card synchronized)."""
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items() if c.launches}


def expect_launches(what, got, expect):
    log(f"  {what}: launches {got} (expected {expect})")
    if got != expect:
        raise AssertionError(f"{what} did not go through the kernels as expected")


def joint_whole_path(counters, imgs, segs, save_root):
    """(a) train_sam at its default (the decoder on) for 2 steps, best.pkl
    through export_instance_segmentation_model into get_predictor_and_segmenter,
    AIS initialize and generate; the exported decoder equals the trainer's."""
    from micro_sam_tpu_torch.automatic_segmentation import get_predictor_and_segmenter
    from micro_sam_tpu_torch.training import export_instance_segmentation_model, train_sam
    train_loader, val_loader = joint_loaders(imgs, segs)
    t0 = time.perf_counter()
    with TrainersKept("JointSamTrainer") as seen, torch.enable_grad():
        _, launches = counted(counters, lambda: train_sam(
            "smoke_joint", "vit_b", train_loader, val_loader, n_iterations=2, device="cuda",
            save_root=save_root))
    train_s = time.perf_counter() - t0
    (trainer,) = seen.trainers
    depth = trainer.model.config.depth
    expect_launches("train_sam (default: the decoder on; 2 steps, validation)", launches,
                    {"relpos_attention": 2 * (2 * depth + depth) + depth,
                     "relpos_attention_backward": 2 * 4 * depth})
    moved = [k for k, v in trainer.unetr.state_dict().items() if not torch.equal(v, trainer.unetr0[k])]
    n_par = len(list(trainer.unetr.parameters()))
    log(f"  train_sam: {train_s:.1f} s; decoder tensors moved {len(moved)} of {n_par} parameters; "
        f"losses {[round(m['train_loss'], 5) for m in trainer.train_metrics]}")
    if len(moved) != n_par or not np.isfinite(trainer.train_metrics[-1]["train_loss"]):
        raise AssertionError("the joint training did not train the decoder or its loss is not finite")
    best = os.path.join(save_root, "smoke_joint", "best.pkl")
    exported = os.path.join(save_root, "smoke_joint_exported.pkl")
    export_instance_segmentation_model(best, exported, "vit_b")
    predictor, ais = get_predictor_and_segmenter("vit_b", checkpoint=exported,
                                                 segmentation_mode="ais")
    same = all(torch.equal(v, trainer.unetr.state_dict()[k])
               for k, v in ais._decoder.unetr.state_dict().items())
    (_, init_launches) = counted(counters, lambda: ais.initialize(imgs[0]))
    t0 = time.perf_counter()
    seg = ais.generate()
    gen_ms = 1e3 * (time.perf_counter() - t0)
    maps = ais.get_state()
    log(f"  best.pkl -> export_instance_segmentation_model -> get_predictor_and_segmenter: "
        f"decoder equal to the trainer's (bitwise) {same}; AIS initialize launches "
        f"{init_launches}, generate {gen_ms:.1f} ms, {len(np.unique(seg)) - 1} objects")
    if not same:
        raise AssertionError("the exported decoder differs from the trained one")
    if seg.shape != imgs[0].shape[:2] or seg.dtype != np.uint32 or any(
            m.shape != imgs[0].shape[:2] or not np.isfinite(m).all() for m in maps.values()):
        raise AssertionError("AIS from the exported joint model: maps or segmentation wrong")
    state = {"train_sam_s": train_s, "launches": launches, "ais_initialize_launches": init_launches,
             "ais_objects": int(len(np.unique(seg)) - 1), "decoder_equal": same}
    sam_state = {k: v.detach().clone() for k, v in trainer.model.sam.state_dict().items()}
    cfg = trainer.model.config
    del seen, trainer, train_loader, val_loader
    return state, best, predictor, sam_state, cfg


def joint_timed_steps(counters, batches):
    """(b) JointSamTrainer steps at train_sam's defaults (batch 2, 25 objects,
    8 rounds, lr 1e-5, bf16 compute with f32 weights; the decoder at
    published widths): TRAIN_WARMUP warm-up and TRAIN_REPS timed, each split
    into the SAM step and the decoder step (the card synchronized after
    each), the attention launches per step asserted, peak memory, one joint
    step profiled by layer and one decoder step alone."""
    from micro_sam_tpu_torch.instance_segmentation import get_unetr
    from micro_sam_tpu_torch.training import JointSamTrainer, get_trainable_sam_model
    model = get_trainable_sam_model("vit_b", device="cuda")
    trainer = JointSamTrainer("timing", None, None, model, unetr=get_unetr(device="cuda"),
                              n_sub_iteration=8, n_objects_per_batch=25, lr=1e-5, logger=False)
    parts = {}

    def step(i):
        x, y, t = batches[i % len(batches)]
        use_points, use_box, multimask, n_pos, n_neg = \
            trainer._get_prompt_and_multimasking_choices(trainer._iteration)
        b = trainer._prepare_batch(x, y, use_points, use_box, n_pos, n_neg, batch_idx=i)
        if b[1].shape[:2] != (2, 25):
            raise AssertionError(f"the trainer sampled {tuple(b[1].shape[:2])} objects, not (2, 25)")
        t0 = time.perf_counter()
        with torch.enable_grad():
            loss, _ = trainer.train_step(b, use_points, use_box, multimask)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        inst = trainer.instance_step(b[0], t)
        torch.cuda.synchronize()
        parts.update(sam_ms=1e3 * (t1 - t0), decoder_ms=1e3 * (time.perf_counter() - t1),
                     loss=float(loss), instance_loss=float(inst), batch=b, targets=t)

    for i in range(TRAIN_WARMUP):
        step(i)
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for c in counters.values():
        c.launches = 0
    for i in range(TRAIN_REPS):
        t0 = time.perf_counter()
        step(TRAIN_WARMUP + i)
        rows.append(dict(step_ms=1e3 * (time.perf_counter() - t0),
                         **{k: parts[k] for k in ("sam_ms", "decoder_ms", "loss", "instance_loss")}))
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: c.launches / TRAIN_REPS for k, c in counters.items() if c.launches}
    depth = model.config.depth
    expect_launches(f"joint steps (per step: {depth} blocks x (2 forward with the recompute + 1 "
                    "in the decoder step's encode), x 4 backward)", per_step,
                    {"relpos_attention": 3 * depth, "relpos_attention_backward": 4 * depth})
    losses = [r["loss"] for r in rows] + [r["instance_loss"] for r in rows]
    if not np.isfinite(losses).all():
        raise AssertionError("a joint step's loss is not finite")
    med = {k: statistics.median(r[k] for r in rows) for k in ("step_ms", "sam_ms", "decoder_ms")}
    log(f"  joint step ms (host clock, median of {TRAIN_REPS}, prompt sampling outside the "
        f"parts): step {med['step_ms']:.3f} = SAM step {med['sam_ms']:.3f} + decoder step "
        f"{med['decoder_ms']:.3f} (+ host); images/s {2e3 / med['step_ms']:.3f}; peak memory "
        f"{peak / 2**30:.3f} GiB; losses SAM {[round(r['loss'], 4) for r in rows]}, decoder "
        f"{[round(r['instance_loss'], 4) for r in rows]}")
    prof = profile_step(lambda: step(TRAIN_WARMUP + TRAIN_REPS), JOINT_PROFILE_GROUPS)
    b, t = parts["batch"], parts["targets"]
    log("  the decoder step alone:")
    prof_dec = profile_step(lambda: (trainer.instance_step(b[0], t), torch.cuda.synchronize()),
                            JOINT_PROFILE_GROUPS)
    del trainer, model, parts
    torch.cuda.empty_cache()
    return {"model": "vit_b", "batch": 2, "objects_per_image": 25, "n_sub_iteration": 8,
            "patch": 512, "compute_dtype": "bfloat16", "decoder_features": [512, 256, 128, 64],
            **med, "images_per_s": 2e3 / med["step_ms"], "steps": rows, "peak_memory_bytes": peak,
            "launches_per_step": per_step, "profiled_step": prof, "profiled_decoder_step": prof_dec}


DECODER_STEP_CPU_THREADS = 4


def decoder_step_grads(seg, device, dtype, root=None, threads=None):
    """(loss, {name: gradient as float64 numpy}, seconds) of one decoder step
    (``unetr_loss``; the UNETR at published widths with random BN statistics,
    ``random_unetr``) on (1, 32, 32, 256) features from seed 1414 and the
    512^2 distance targets of ``seg``, in ``dtype`` on ``device``. Also the
    CPU reference's process (``root`` / ``threads`` given)."""
    if root is not None:
        sys.path.insert(0, root)
    if threads:
        torch.set_num_threads(threads)
    from micro_sam_tpu_torch.training import PerObjectDistanceTransform
    from micro_sam_tpu_torch.training.joint_sam_trainer import unetr_loss
    feats = torch.randn(1, 32, 32, 256, generator=torch.Generator().manual_seed(1414))
    targets = torch.from_numpy(PerObjectDistanceTransform()(seg)[None])
    model = random_unetr(True).to(device, dtype)
    t0 = time.perf_counter()
    with torch.enable_grad():
        loss = unetr_loss(model, feats.to(device, dtype), targets.to(device, dtype))
        loss.backward()
    grads = {n: p.grad.double().cpu().numpy() for n, p in model.named_parameters()}
    return float(loss.detach()), grads, time.perf_counter() - t0


DECODER_STEP_F64_TOL = 1e-6   # every gradient of the f64 step, card against CPU


def decoder_step_check(seg, cpu_runs):
    """(c) The decoder step on the card against the same step on the CPU in
    float64 (``cpu_runs``: the futures of the CPU's f32 and f64 steps, in a
    process started at the phase's start), TF32 off. In float64 on the card:
    the loss within rel 1e-9 and every gradient within rel 1e-6 of its
    tensor's max (the same function, computed exactly). In float32 on the
    card: the loss within rel 1e-5; every gradient within rel 1e-3 of its
    tensor's max, or within twice the CPU f32 step's largest distance from
    float64 over all gradients (the f32 rounding this random decoder
    amplifies: the CPU's own f32 step lies up to about 1e-2 of some small
    tensors' max from float64). Gradients that are zero in the exact
    arithmetic (biases whose output meets an InstanceNorm, below 1e-6 of the
    largest in f64) are held below that on the card."""
    loss32g, g32g, s32g = decoder_step_grads(seg, "cuda", torch.float32)
    loss64g, g64g, s64g = decoder_step_grads(seg, "cuda", torch.float64)
    (loss32, g32, s32), (loss64, g64, s64) = (r.result() for r in cpu_runs)
    g_max = max(float(np.abs(v).max()) for v in g64.values())
    noise = [n for n, v in g64.items() if float(np.abs(v).max()) <= 1e-6 * g_max]
    held = [n for n in g64 if n not in noise]
    for name in noise:
        if max(float(np.abs(g[name]).max()) for g in (g32g, g64g)) > 1e-6 * g_max:
            raise AssertionError(f"decoder step: {name} should have no gradient")
    err = lambda g, n: float(np.abs(g[n] - g64[n]).max())
    floor = 2 * max(err(g32, n) for n in held)
    rel64 = max(err(g64g, n) / float(np.abs(g64[n]).max()) for n in held)
    rel32 = {n: err(g32g, n) / float(np.abs(g64[n]).max()) for n in held}
    by_floor = [n for n in held if rel32[n] > DECODER_STEP_F32_TOL]
    bad = [n for n in by_floor if err(g32g, n) > floor]
    worst = max(held, key=lambda n: rel32[n])
    loss_rel32, loss_rel64 = abs(loss32g - loss64) / abs(loss64), abs(loss64g - loss64) / abs(loss64)
    log(f"  decoder step against the CPU in f64 (card f32 {1e3 * s32g:.1f} ms, f64 "
        f"{1e3 * s64g:.1f} ms; CPU f32 {s32:.1f} s, f64 {s64:.1f} s): card f64 loss rel "
        f"{loss_rel64:.2e}, worst gradient rel {rel64:.2e} (tol {DECODER_STEP_F64_TOL:g}); card "
        f"f32 loss rel {loss_rel32:.2e} (tol {DECODER_LOSS_F32_TOL:g}; CPU f32 "
        f"{abs(loss32 - loss64) / abs(loss64):.2e}), worst gradient rel {rel32[worst]:.3e} "
        f"({worst}; CPU f32 {err(g32, worst) / float(np.abs(g64[worst]).max()):.3e}); "
        f"{len(held) - len(by_floor)} of {len(held)} tensors within rel "
        f"{DECODER_STEP_F32_TOL:g}, the other {len(by_floor)} within the f32 floor "
        f"{floor / g_max:.3e} of the largest gradient: {len(bad)} beyond; {len(noise)} zero by "
        f"symmetry")
    if loss_rel64 > 1e-9 or rel64 > DECODER_STEP_F64_TOL:
        raise AssertionError("the f64 decoder step on the card disagrees with the CPU")
    if loss_rel32 > DECODER_LOSS_F32_TOL or bad:
        raise AssertionError(f"the f32 decoder step on the card disagrees with the CPU: {bad}")
    return {"f64_loss_rel": loss_rel64, "f64_grad_rel": rel64, "f32_loss_rel": loss_rel32,
            "f32_worst_grad_rel": rel32[worst], "f32_worst_tensor": worst,
            "f32_floor_of_max": floor / g_max, "held_by_floor": by_floor,
            "cpu_f32_grad_rel": {n: err(g32, n) / float(np.abs(g64[n]).max()) for n in held},
            "card_f32_grad_rel": rel32, "zero_by_symmetry": noise}


def instance_only_check(counters, imgs, segs, save_root):
    """(d) train_instance_segmentation for 2 steps: every SAM tensor bitwise
    unchanged, every decoder parameter moved; the SAM step runs its forward
    only."""
    from micro_sam_tpu_torch.training import train_instance_segmentation
    train_loader, val_loader = joint_loaders(imgs, segs)
    t0 = time.perf_counter()
    with TrainersKept("JointSamTrainer") as seen, torch.enable_grad():
        _, launches = counted(counters, lambda: train_instance_segmentation(
            "smoke_inst", "vit_b", train_loader, val_loader, n_iterations=2, device="cuda",
            save_root=save_root))
    wall = time.perf_counter() - t0
    (tr,) = seen.trainers
    depth = tr.model.config.depth
    expect_launches("train_instance_segmentation (2 steps: the SAM forward and the decoder "
                    "step's encode; validation)", launches,
                    {"relpos_attention": 2 * 2 * depth + depth})
    sam_same = all(torch.equal(v, tr.sam0[k]) for k, v in tr.model.sam.state_dict().items())
    moved = sum(not torch.equal(v, tr.unetr0[k]) for k, v in tr.unetr.named_parameters())
    n_par = len(list(tr.unetr.parameters()))
    log(f"  train_instance_segmentation: {wall:.1f} s; SAM bitwise unchanged {sam_same}; "
        f"decoder parameters moved {moved} of {n_par}")
    if not sam_same or moved != n_par or tr.optimizer is not None:
        raise AssertionError("train_instance_segmentation moved SAM or left the decoder")
    del seen, tr
    torch.cuda.empty_cache()
    return {"wall_s": wall, "launches": launches, "sam_unchanged": sam_same,
            "decoder_moved": moved}


PRESET_VIT_H_DEPTH = 8   # the A100 preset's vit_h: one period of its blocks (global at 7)


def preset_joint_check(counters, imgs, segs, save_root):
    """(e) train_sam_for_configuration("A100") at its default: vit_h (full
    width cut to PRESET_VIT_H_DEPTH blocks) and the decoder, 2 steps;
    launches and peak memory."""
    import gc
    from micro_sam_tpu_torch.training import train_sam_for_configuration
    train_loader, val_loader = joint_loaders(imgs, segs)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with TrainersKept("JointSamTrainer") as seen, torch.enable_grad(), \
            CutDepth("vit_h", PRESET_VIT_H_DEPTH) as cfg:
        _, launches = counted(counters, lambda: train_sam_for_configuration(
            "smoke_h_joint", "A100", train_loader, val_loader, n_iterations=2, device="cuda",
            save_root=save_root))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    (tr,) = seen.trainers
    got = (tr.model.config.model_type, tr.model.config.embed_dim, tr.n_objects_per_batch)
    depth = cfg.depth
    expect_launches("train_sam_for_configuration('A100') (vit_h and the decoder, 2 steps, "
                    "validation)", launches,
                    {"relpos_attention": 2 * 3 * depth + depth,
                     "relpos_attention_backward": 2 * 4 * depth})
    moved = sum(not torch.equal(v, tr.unetr0[k]) for k, v in tr.unetr.named_parameters())
    log(f"  A100 preset with the decoder (vit_h cut to {depth} blocks): {wall:.1f} s for 2 "
        f"steps, validation and checkpoints; trainer {got}; peak memory {peak / 2**30:.3f} GiB; "
        f"decoder parameters moved {moved}")
    if got != ("vit_h", cfg.embed_dim, 25) or moved != len(list(tr.unetr.parameters())):
        raise AssertionError("the A100 preset did not train vit_h and the decoder")
    del seen, tr
    gc.collect()
    torch.cuda.empty_cache()
    return {"wall_s": wall, "launches": launches, "peak_memory_bytes": peak}


def other_trainers_check(imgs, segs):
    """(f) SimpleSamTrainer, MedSAMTrainer and SemanticSamTrainer (3 classes)
    on one vit_b, 2 steps each: finite losses, weights moved."""
    import random
    from micro_sam_tpu_torch.training import (MedSAMTrainer, SemanticSamTrainer,
                                              SimpleSamTrainer, get_trainable_sam_model)
    from micro_sam_tpu_torch.training.training import SamDataset, SamLoader
    random.seed(0)
    model = get_trainable_sam_model("vit_b", device="cuda")
    loader = SamLoader(SamDataset(imgs[:4], segs[:4], (512, 512), n_samples=4), batch_size=2)
    batches = list(loader)
    semantic = [(x, (y % 3).astype(np.int64)) for x, y in batches]
    out = {}
    for cls, data, kw in ((SimpleSamTrainer, batches, {}), (MedSAMTrainer, batches, {}),
                          (SemanticSamTrainer, semantic, {"num_classes": 3})):
        tr = cls(cls.__name__, data, None, model, logger=False, **kw)
        before = {n: p.detach().clone() for n, p in model.sam.named_parameters()}
        t0 = time.perf_counter()
        with torch.enable_grad():
            loss, _ = tr._run_epoch(train=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        moved = sum(not torch.equal(before[n], p) for n, p in model.sam.named_parameters())
        log(f"  {cls.__name__}: 2 steps in {wall:.2f} s, mean loss {loss:.5f}, {moved} of "
            f"{len(before)} parameter tensors moved")
        if tr._iteration != 2 or not np.isfinite(loss) or moved < 0.5 * len(before):
            raise AssertionError(f"{cls.__name__} did not train")
        out[cls.__name__] = {"loss": loss, "moved": moved, "wall_s": wall}
        del before, tr
    del model
    torch.cuda.empty_cache()
    return out


def writers_check(predictor, best, sam_state, cfg, image, save_root):
    """(g) export_custom_sam_model and save_native_checkpoint of (a)'s
    checkpoint, loaded back by get_sam_model: their embeddings against the
    exported joint model's, within the bf16 bound."""
    from micro_sam_tpu_torch.util import (_to_image, export_custom_sam_model, get_sam_model,
                                          save_native_checkpoint)
    pt = os.path.join(save_root, "smoke_joint_sam.pt")
    native = os.path.join(save_root, "smoke_joint.msam")
    export_custom_sam_model(best, "vit_b", pt)
    save_native_checkpoint(native, sam_state, cfg)
    img = _to_image(image)
    predictor.set_image(img)
    ref = predictor.get_image_embedding()
    out = {}
    for name, path in (("export_custom_sam_model", pt), ("save_native_checkpoint", native)):
        p = get_sam_model("vit_b", checkpoint_path=path)
        p.set_image(img)
        emb = p.get_image_embedding()
        rel = float(np.abs(emb - ref).max() / np.abs(ref).max())
        out[name] = rel
        log(f"  {name} -> get_sam_model: embedding rel {rel:.3e} of the trainer's "
            f"(tol {BF16_TOL:g}); {os.path.getsize(path) / 2**20:.1f} MiB")
        if not np.isfinite(emb).all() or rel > BF16_TOL:
            raise AssertionError(f"{name}: the written model does not give the trained embedding")
        del p
    torch.cuda.empty_cache()
    return out


def joint_phase(counters, root):
    """Phase 14: joint finetuning (SAM and the UNETR decoder at published
    widths) through train_sam's default and its exports, timed joint steps,
    the f32 decoder step on the card against the CPU, decoder-only training,
    the A100 preset with the decoder, the other trainers and the writers."""
    import multiprocessing
    import shutil
    from concurrent.futures import ProcessPoolExecutor
    save_root = os.path.join(root, "build", "chip_smoke_joint")
    shutil.rmtree(save_root, ignore_errors=True)
    imgs, segs = training_data()
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_runs = [pool.submit(decoder_step_grads, segs[0], "cpu", dt, root,
                                DECODER_STEP_CPU_THREADS) for dt in (torch.float32, torch.float64)]
        log("  (a) train_sam('smoke_joint', 'vit_b') at its default (the decoder on), exported, "
            "AIS")
        a, best, predictor, sam_state, cfg = joint_whole_path(counters, imgs, segs, save_root)
        log("  (g) the writers")
        g = writers_check(predictor, best, sam_state, cfg, imgs[0], save_root)
        del predictor, sam_state
        torch.cuda.empty_cache()
        log("  (b) timed joint steps at train_sam's defaults")
        train_loader, _ = joint_loaders(imgs, segs)
        b = joint_timed_steps(counters, list(train_loader))
        log("  (c) the decoder step on the card in f64 and f32 (TF32 off) against the CPU in f64")
        c = decoder_step_check(segs[0], cpu_runs)
    log("  (d) train_instance_segmentation")
    d = instance_only_check(counters, imgs, segs, save_root)
    log("  (e) the A100 preset at its default (vit_h and the decoder)")
    e = preset_joint_check(counters, imgs, segs, save_root)
    log("  (f) the other trainers")
    f = other_trainers_check(imgs, segs)
    shutil.rmtree(save_root, ignore_errors=True)
    return dict(whole_path=a, timed=b, decoder_step_f32=c, instance_only=d, a100_joint=e,
                other_trainers=f, writers=g)


# ---------------------------------------------------------------------------
# phase 15: PEFT (LoRA, QLoRA), the 3d wrappers, vit_t finetuning
# ---------------------------------------------------------------------------

PEFT = {"rank": 4}
QLORA = {"rank": 4, "quantize": True}
PEFT_CPU_THREADS = 3   # each of the two CPU reference processes
VIT_B_BLOCK_LINEARS = 12 * (768 * 2304 + 768 * 768 + 768 * 3072 + 3072 * 768)  # weights
TINY_ENCODE = {"dwconv": 12, "tiny_attention": 10, "layernorm": 20, "gemm": 44}
VIT_B_ENCODE = {"layernorm": 24, "gemm": 48, "relpos_attention": 12}
VOLUME_SLICES = 8
SIDE = 1024   # the images and slices of phase 15


def redraw_lora_(sam, seed=1515, scale=0.1):
    """Non-zero LoRA ``b`` in every block (a fresh ``b`` is zero and would
    hide the update), drawn on the CPU from ``seed``; at this scale the
    update moves the embedding far more than (a)'s tolerance (checked
    there)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sam.image_encoder.named_parameters():
            if ".lora." in name and name.endswith(".b"):
                p.copy_(torch.randn(p.shape, generator=g) * scale)


def peft_pixels():
    """One preprocessed SIDE^2 image of random grey levels (seed 15), float32."""
    from micro_sam_tpu_torch.models.sam import preprocess
    img = np.random.RandomState(15).randint(0, 256, (1, SIDE, SIDE, 3)).astype(np.float32)
    return preprocess(torch.from_numpy(img), SIDE)


def lora_cpu_reference(root, threads):
    """(The LoRA vit_b's embedding (seed 0, ``b`` redrawn) in f32 on the CPU,
    seconds): the reference of (a), in a process started at the phase's start."""
    sys.path.insert(0, root)
    torch.set_num_threads(threads)
    from micro_sam_tpu_torch.util import get_sam_model
    model = get_sam_model("vit_b", device="cpu", seed=0, peft_kwargs=PEFT).model
    redraw_lora_(model)
    t0 = time.perf_counter()
    emb = model.encode_image(peft_pixels()).float().numpy()
    return emb, time.perf_counter() - t0


def host_ms(fn, reps=5):
    """Median host-clock ms of ``fn`` (the card synchronized), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def lora_serving(counters, cpu_ref):
    """(a) get_sam_model("vit_b", peft_kwargs={"rank": 4}), bf16, b redrawn:
    one encode's launches (every block's chain, K1 on its qkv rows with the
    LoRA updates), the embedding against the CPU's f32 run and against the
    base model's (the update must move it well beyond the tolerance), the
    encode's time against the base model's."""
    from micro_sam_tpu_torch.util import get_sam_model
    px = peft_pixels().cuda()
    model = get_sam_model("vit_b", seed=0, peft_kwargs=PEFT).model
    redraw_lora_(model)
    emb, launches = counted(counters, lambda: model.encode_image(px))
    expect_launches("LoRA vit_b encode (12 PEFT blocks)", launches, VIT_B_ENCODE)
    ref, cpu_s = cpu_ref.result()
    got = emb.float().cpu().numpy()
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    lora_ms = host_ms(lambda: model.encode_image(px))
    base = get_sam_model("vit_b", seed=0).model
    base_ms = host_ms(lambda: base.encode_image(px))
    plain = base.encode_image(px).float()
    moved = float((emb.float() - plain).abs().max() / plain.abs().max())
    log(f"  LoRA embedding vs the CPU's f32 run ({cpu_s:.1f} s there): rel {rel:.3e} (tol "
        f"{BF16_TOL * 1.5:g}); vs the base model's: rel {moved:.3e} (at least "
        f"{4 * 1.5 * BF16_TOL:g}); encode b1 host ms LoRA {lora_ms:.3f}, base {base_ms:.3f}")
    if not np.isfinite(got).all() or rel > 1.5 * BF16_TOL:
        raise AssertionError("the LoRA embedding disagrees with the CPU")
    if moved < 4 * 1.5 * BF16_TOL:
        raise AssertionError("the LoRA update does not move the card's embedding")
    del model, base
    torch.cuda.empty_cache()
    return {"launches": launches, "embedding_rel": rel, "lora_vs_base_rel": moved,
            "encode_ms_b1": lora_ms, "base_encode_ms_b1": base_ms, "cpu_reference_s": cpu_s}


def frozen_base_check(trainer, what):
    """After training: every base encoder tensor bitwise as built, every LoRA
    ``b`` moved; returns (LoRA tensors moved, of)."""
    from micro_sam_tpu_torch.models.convert import is_peft_key
    now = trainer.model.sam.state_dict()
    base = [k for k in now if k.startswith("image_encoder.") and not is_peft_key(k)]
    changed = [k for k in base if not torch.equal(now[k], trainer.sam0[k])]
    lora = [k for k in now if ".lora." in k]
    moved = [k for k in lora if not torch.equal(now[k], trainer.sam0[k])]
    b_moved = all(k in moved for k in lora if k.endswith(".b"))
    log(f"  {what}: base encoder tensors changed {len(changed)} of {len(base)}; LoRA tensors "
        f"moved {len(moved)} of {len(lora)}")
    if changed or not b_moved:
        raise AssertionError(f"{what}: the base moved or the LoRA did not train")
    return len(moved), len(lora)


def lora_training(counters, imgs, segs, save_root):
    """(b) train_sam(peft_kwargs={"rank": 4}) for 2 steps (the base frozen,
    LoRA moved, K1 / K4 launches), then timed LoRA steps at train_sam's
    defaults, the protocol of phase 6's full SAM steps in this run."""
    from micro_sam_tpu_torch.training import train_sam
    from micro_sam_tpu_torch.training.training import SamDataset, SamLoader
    train_loader = SamLoader(SamDataset(imgs[:4], segs[:4], (512, 512), n_samples=4), batch_size=2)
    val_loader = SamLoader(SamDataset(imgs[4:], segs[4:], (512, 512), n_samples=2, seed=1),
                           batch_size=2)
    t0 = time.perf_counter()
    with TrainersKept("SamTrainer") as seen, torch.enable_grad():
        _, launches = counted(counters, lambda: train_sam(
            "smoke_lora", "vit_b", train_loader, val_loader, with_segmentation_decoder=False,
            n_iterations=2, device="cuda", save_root=save_root, peft_kwargs=PEFT))
    wall = time.perf_counter() - t0
    (tr,) = seen.trainers
    depth = tr.model.config.depth
    expect_launches("train_sam(peft_kwargs={'rank': 4}) (2 steps, validation)", launches,
                    {"relpos_attention": 2 * 2 * depth + depth,
                     "relpos_attention_backward": 2 * 4 * depth})
    moved = frozen_base_check(tr, "LoRA train_sam")
    n_train = sum(p.numel() for p in tr.model.sam.parameters() if p.requires_grad)
    del seen, tr
    torch.cuda.empty_cache()
    k4, stats, _ = timed_steps(counters, "vit_b", train_loader, val_loader, list(train_loader),
                               save_root, peft_kwargs=PEFT)
    return {"train_sam_s": wall, "launches": launches, "lora_moved": moved,
            "trainable_parameters": n_train, "timed": stats, "k4_replay": k4}


def qlora_checks(counters, imgs, segs, save_root):
    """(c) QLoRA: train_sam(peft_kwargs={"rank": 4, "quantize": True}) for a
    step (K1 / K4 launches, the base frozen), the int4 base's bytes, the
    quantized model's embedding against the dense one's (same weights and
    LoRA), and export_custom_qlora_model of its checkpoint into
    get_sam_model: the embedding against the checkpoint's own."""
    from micro_sam_tpu_torch.training import train_sam
    from micro_sam_tpu_torch.training.training import SamDataset, SamLoader
    from micro_sam_tpu_torch.util import export_custom_qlora_model, get_sam_model
    loader = SamLoader(SamDataset(imgs[:2], segs[:2], (512, 512), n_samples=2), batch_size=2)
    with TrainersKept("SamTrainer") as seen, torch.enable_grad():
        _, launches = counted(counters, lambda: train_sam(
            "smoke_qlora", "vit_b", loader, loader, with_segmentation_decoder=False,
            n_iterations=1, device="cuda", save_root=save_root, peft_kwargs=QLORA))
    (tr,) = seen.trainers
    depth = tr.model.config.depth
    expect_launches("train_sam(peft_kwargs={'rank': 4, 'quantize': True}) (1 step, validation)",
                    launches, {"relpos_attention": 2 * depth + depth,
                               "relpos_attention_backward": 4 * depth})
    frozen_base_check(tr, "QLoRA train_sam")
    int4 = sum(b.numel() * b.element_size() for n, b in tr.model.sam.named_buffers()
               if n.endswith(".w_q4") or n.endswith(".w_scale"))
    bf16 = 2 * VIT_B_BLOCK_LINEARS
    log(f"  QLoRA base: {int4} bytes of int4 values and bf16 scales, against {bf16} bytes in "
        f"bf16 ({int4 / bf16:.4f})")
    if int4 != VIT_B_BLOCK_LINEARS // 2 + 2 * VIT_B_BLOCK_LINEARS // 64:
        raise AssertionError("the QLoRA base is not packed int4 with one bf16 scale per 64 rows")
    del seen, tr
    px = peft_pixels().cuda()
    embs = {}
    for name, kw in (("dense", PEFT), ("int4", QLORA)):
        m = get_sam_model("vit_b", seed=0, peft_kwargs=kw).model
        redraw_lora_(m)
        embs[name], launches_e = counted(counters, lambda: m.encode_image(px).float())
        expect_launches(f"{name} LoRA encode", launches_e, VIT_B_ENCODE)
        del m
    drift = float((embs["int4"] - embs["dense"]).abs().max() / embs["dense"].abs().max())
    best = os.path.join(save_root, "smoke_qlora", "best.pkl")
    exported = os.path.join(save_root, "smoke_qlora_exported.pkl")
    export_custom_qlora_model(None, best, "vit_b", exported)
    trained = get_sam_model("vit_b", checkpoint_path=best, peft_kwargs=PEFT).model
    dense = get_sam_model("vit_b", checkpoint_path=exported, peft_kwargs=PEFT).model
    if not trained.image_encoder.blocks[0].attn.qkv.quantized or \
            dense.image_encoder.blocks[0].attn.qkv.quantized:
        raise AssertionError("the checkpoint should load as int4, its export as dense weights")
    e_t, e_d = trained.encode_image(px).float(), dense.encode_image(px).float()
    export_rel = float((e_d - e_t).abs().max() / e_t.abs().max())
    log(f"  int4 vs dense embedding (same weights and LoRA): rel {drift:.3e}; the export "
        f"({os.path.getsize(exported) / 2**20:.1f} MiB) vs its checkpoint "
        f"({os.path.getsize(best) / 2**20:.1f} MiB) through get_sam_model: rel {export_rel:.3e} "
        f"(tol {BF16_TOL:g})")
    if not (torch.isfinite(e_d).all() and export_rel <= BF16_TOL and drift < 0.5):
        raise AssertionError("the QLoRA export or the int4 embedding is off")
    del trained, dense, embs
    torch.cuda.empty_cache()
    return {"launches": launches, "base_bytes_int4": int4, "base_bytes_bf16": bf16,
            "int4_vs_dense_rel": drift, "export_vs_checkpoint_rel": export_rel}


def peft_decoder_check(counters, save_root):
    """(d) get_predictor_and_decoder(peft_kwargs=...) on (b)'s checkpoint with
    a decoder state (the UNETR at published widths, random): the trained
    LoRA loaded bitwise, one set_image's launches, the decoder's maps."""
    import pickle
    from micro_sam_tpu_torch.instance_segmentation import get_predictor_and_decoder
    from micro_sam_tpu_torch.models.convert import params_from_jax
    best = os.path.join(save_root, "smoke_lora", "best.pkl")
    with open(best, "rb") as f:
        state = pickle.load(f)
    state["decoder_state"] = random_unetr().state_dict()
    path = os.path.join(save_root, "smoke_lora_decoder.pkl")
    with open(path, "wb") as f:
        pickle.dump(state, f)
    predictor, decoder = get_predictor_and_decoder("vit_b", path, peft_kwargs=PEFT)
    want = params_from_jax(state["model_state"], predictor.model.config)
    got = predictor.model.state_dict()
    lora = [k for k in want if ".lora." in k]
    same = all(torch.equal(got[k].cpu(), want[k]) for k in lora)
    img = np.random.RandomState(16).randint(0, 256, (512, 512, 3)).astype(np.uint8)
    _, launches = counted(counters, lambda: predictor.set_image(img))
    maps = decoder(predictor.features, predictor.input_size, predictor.original_size)
    log(f"  get_predictor_and_decoder(peft_kwargs=...): {len(lora)} LoRA tensors equal to the "
        f"checkpoint's {same}; set_image launches {launches}; decoder maps {maps.shape}")
    expect_launches("set_image of the LoRA predictor", launches, VIT_B_ENCODE)
    if not same or maps.shape != (1, 3, 512, 512) or not np.isfinite(maps).all():
        raise AssertionError("get_predictor_and_decoder(peft_kwargs=...) is off")
    del predictor, decoder
    torch.cuda.empty_cache()
    return {"lora_equal": same, "launches": launches}


def vit_t_f32_batch(imgs, segs):
    """The first of (e)'s timed batches cut to one patch: the f32 step's input."""
    from micro_sam_tpu_torch.training.training import SamDataset, SamLoader
    x, y = next(iter(SamLoader(SamDataset(imgs[:4], segs[:4], (512, 512), n_samples=4),
                               batch_size=2)))
    return x[:1], y[:1]


def vit_t_training(counters, imgs, segs, save_root, f32_batch, cpu_run):
    """(e) vit_t finetuning: train_sam_for_configuration("Minimal") at its
    default (with the decoder) for 2 steps, its launches (each step's SAM and
    decoder encodes, a validation encode); timed SamTrainer steps at the
    preset's settings (batch 2 of 512^2, 4 objects, 4 rounds), launches per
    step asserted, peak memory, one step profiled; one f32 step on
    ``f32_batch`` on the card against the CPU's (``cpu_run``)."""
    from micro_sam_tpu_torch.training import SamTrainer, get_trainable_sam_model
    from micro_sam_tpu_torch.training.training import (CONFIGURATIONS, SamDataset, SamLoader,
                                                       train_sam_for_configuration)
    preset = CONFIGURATIONS["Minimal"]
    train_loader, val_loader = joint_loaders(imgs, segs)
    t0 = time.perf_counter()
    with TrainersKept("JointSamTrainer") as seen, torch.enable_grad():
        _, launches = counted(counters, lambda: train_sam_for_configuration(
            "smoke_minimal", "Minimal", train_loader, val_loader, n_iterations=2, device="cuda",
            save_root=save_root))
    wall = time.perf_counter() - t0
    (tr,) = seen.trainers
    got = (tr.model.config.model_type, tr.n_objects_per_batch, tr.n_sub_iteration)
    expect_launches("train_sam_for_configuration('Minimal') (vit_t and the decoder, 2 steps, "
                    "validation: 5 encodes)", launches, {k: 5 * v for k, v in TINY_ENCODE.items()})
    moved = sum(not torch.equal(v, tr.sam0[k]) for k, v in tr.model.sam.state_dict().items())
    log(f"  Minimal preset: {wall:.1f} s; trainer {got}; SAM tensors moved {moved}")
    if got != ("vit_t", preset["n_objects_per_batch"], preset["n_sub_iteration"]) or moved == 0:
        raise AssertionError("the Minimal preset did not train vit_t")
    del seen, tr
    torch.cuda.empty_cache()

    model = get_trainable_sam_model("vit_t", device="cuda")
    trainer = SamTrainer("timing_t", None, None, model, n_sub_iteration=preset["n_sub_iteration"],
                         n_objects_per_batch=preset["n_objects_per_batch"], logger=False)
    batches = list(SamLoader(SamDataset(imgs[:4], segs[:4], (512, 512), n_samples=4),
                             batch_size=2))

    def step(i):
        x, y = batches[i % len(batches)]
        use_points, use_box, multimask, n_pos, n_neg = \
            trainer._get_prompt_and_multimasking_choices(trainer._iteration)
        b = trainer._prepare_batch(x, y, use_points, use_box, n_pos, n_neg, batch_idx=i)
        with torch.enable_grad():
            loss, _ = trainer.train_step(b, use_points, use_box, multimask)
        torch.cuda.synchronize()
        return float(loss)

    for i in range(TRAIN_WARMUP):
        step(i)
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    times, losses = [], []
    for i in range(TRAIN_REPS):
        t0 = time.perf_counter()
        losses.append(step(TRAIN_WARMUP + i))
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: c.launches / TRAIN_REPS for k, c in counters.items() if c.launches}
    expect_launches("vit_t training steps (per step: the encoder's chains once, their "
                    "backward the plain chains')", per_step, TINY_ENCODE)
    step_ms = statistics.median(times)
    log(f"  vit_t step ms (host clock, median of {TRAIN_REPS}): {step_ms:.3f} (all "
        f"{[round(t, 3) for t in times]}); images/s {2e3 / step_ms:.3f}; peak memory "
        f"{peak / 2**30:.3f} GiB; losses {[round(v, 4) for v in losses]}")
    if not np.isfinite(losses).all():
        raise AssertionError("a vit_t training step's loss is not finite")
    prof = profile_step(lambda: step(TRAIN_WARMUP + TRAIN_REPS), SERVE_PROFILE_GROUPS)
    x, y = f32_batch
    del trainer, model
    torch.cuda.empty_cache()
    log("  f32 vit_t step on the card vs the CPU")
    worst, loss_rel = f32_step_check(x, y, "vit_t", cpu_run)
    return {"preset_s": wall, "preset_launches": launches, "step_ms": step_ms,
            "step_ms_all": times, "images_per_s": 2e3 / step_ms, "peak_memory_bytes": peak,
            "launches_per_step": per_step, "losses": losses, "profiled_step": prof,
            "f32_step_grad_rel": worst, "f32_step_loss_rel": loss_rel,
            "settings": {"batch": 2, "patch": 512, **preset}}


def wrappers_3d(counters):
    """(f) get_sam_3d_model("vit_b", d_size=8) (its depth convolutions
    redrawn) and get_simple_sam_3d_model("vit_b") on an 8-slice 1024^2
    volume, bf16: one forward's launches (the 8 slices in one launch a
    kernel), its time, and the encoder against its plain version in f32 on
    the card."""
    from micro_sam_tpu_torch.models.sam import preprocess
    from micro_sam_tpu_torch.models.sam_3d_wrapper import (apply_sam_3d_encoder,
                                                          get_sam_3d_model,
                                                          get_simple_sam_3d_model)
    vol = torch.from_numpy(np.random.RandomState(17).randint(
        0, 256, (1, VOLUME_SLICES, SIDE, SIDE, 3)).astype(np.float32)).cuda()
    px = preprocess(vol[0], SIDE)
    model = get_sam_3d_model("vit_b", d_size=VOLUME_SLICES, seed=0)
    g = torch.Generator().manual_seed(18)
    with torch.no_grad():
        for blk in model.sam.image_encoder.blocks:
            for ad in (blk.adapter_pre, blk.adapter_post):
                ad.depth_conv.weight.copy_(torch.randn(ad.depth_conv.weight.shape, generator=g) * 0.3)
    out = {}
    with torch.no_grad():
        masks, launches = counted(counters, lambda: model(vol))
        expect_launches("Sam3DWrapper forward (8 slices)", launches, VIT_B_ENCODE)
        fwd_ms = host_ms(lambda: model(vol), reps=3)
        enc = model.sam.image_encoder
        feats = apply_sam_3d_encoder(enc, px.to(torch.bfloat16), VOLUME_SLICES).float()
        ref = apply_sam_3d_encoder(enc, px, VOLUME_SLICES, plain=True).float()
        rel = float((feats - ref).abs().max() / ref.abs().max())
        log(f"  Sam3DWrapper: masks {tuple(masks.shape)}, forward {fwd_ms:.3f} ms; encoder vs "
            f"plain f32: rel {rel:.3e} (tol {1.5 * BF16_TOL:g})")
        if masks.shape != (1, VOLUME_SLICES, 4, SIDE // 4, SIDE // 4) \
                or not torch.isfinite(masks).all() \
                or rel > 1.5 * BF16_TOL:
            raise AssertionError("Sam3DWrapper is off")
        out["sam_3d"] = {"launches": launches, "forward_ms": fwd_ms, "encoder_rel": rel}
        del model, masks, feats, ref
        torch.cuda.empty_cache()
        simple = get_simple_sam_3d_model("vit_b", seed=0)
        logits, launches = counted(counters, lambda: simple(vol))
        expect_launches("SimpleSam3DWrapper forward (8 slices)", launches, VIT_B_ENCODE)
        fwd_ms = host_ms(lambda: simple(vol), reps=3)
        feats = simple.sam.encode_image(px).float()
        ref = apply_sam_3d_encoder(simple.sam.image_encoder, px, VOLUME_SLICES, plain=True).float()
        rel = float((feats - ref).abs().max() / ref.abs().max())
        log(f"  SimpleSam3DWrapper: logits {tuple(logits.shape)}, forward {fwd_ms:.3f} ms; "
            f"encoder vs plain f32: rel {rel:.3e} (tol {1.5 * BF16_TOL:g})")
        if logits.shape != (1, VOLUME_SLICES, SIDE // 16, SIDE // 16, 1) \
                or not torch.isfinite(logits).all() \
                or rel > 1.5 * BF16_TOL:
            raise AssertionError("SimpleSam3DWrapper is off")
        out["simple_sam_3d"] = {"launches": launches, "forward_ms": fwd_ms, "encoder_rel": rel}
    del simple
    torch.cuda.empty_cache()
    return out


def add_peft_launches(rows, p15):
    """Phase 15's launch counts on the kernels line's rows: a LoRA vit_b
    encode, the LoRA train_sam path, a vit_t training step."""
    peft_keys = {"layernorm", "gemm", "relpos_attention"}
    for r in rows:
        name = r["name"]
        if name in peft_keys:
            r["launches_lora_encode"] = p15["lora_serving"]["launches"][name]
        if name in ("relpos_attention", "relpos_attention_backward"):
            r["launches_lora_train_sam_path"] = p15["lora_training"]["launches"][name]
            r["launches_qlora_train_sam_path"] = p15["qlora"]["launches"][name]
        if name in TINY_ENCODE:
            r["launches_vit_t_training_step"] = p15["vit_t"]["launches_per_step"][name]


def peft_phase(counters, root):
    """Phase 15: LoRA serving and training, QLoRA, get_predictor_and_decoder
    with PEFT, vit_t finetuning, the 3d wrappers."""
    import multiprocessing
    import shutil
    from concurrent.futures import ProcessPoolExecutor
    save_root = os.path.join(root, "build", "chip_smoke_peft")
    shutil.rmtree(save_root, ignore_errors=True)
    imgs, segs = training_data()
    f32_batch = vit_t_f32_batch(imgs, segs)
    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_ref = pool.submit(lora_cpu_reference, root, PEFT_CPU_THREADS)
        cpu_step = pool.submit(f32_step_grads_cpu, root, PEFT_CPU_THREADS, *f32_batch, "vit_t")
        log(f"  (f) Sam3DWrapper and SimpleSam3DWrapper, {VOLUME_SLICES} slices of {SIDE}^2")
        f = wrappers_3d(counters)
        log("  (b) train_sam with LoRA, timed LoRA steps")
        b = lora_training(counters, imgs, segs, save_root)
        log("  (a) LoRA serving")
        a = lora_serving(counters, cpu_ref)
        log("  (c) QLoRA")
        c = qlora_checks(counters, imgs, segs, save_root)
        log("  (d) get_predictor_and_decoder with PEFT")
        d = peft_decoder_check(counters, save_root)
        log("  (e) vit_t finetuning: the Minimal preset, timed steps, the f32 step")
        e = vit_t_training(counters, imgs, segs, save_root, f32_batch, cpu_step)
    shutil.rmtree(save_root, ignore_errors=True)
    return dict(lora_serving=a, lora_training=b, qlora=c, predictor_and_decoder=d, vit_t=e,
                wrappers_3d=f)


# ---------------------------------------------------------------------------
# phase 16: evaluation on the card
# ---------------------------------------------------------------------------

EVAL_IMAGE = dict(shape=(1024, 1024), n_objects=20, radius_range=(30, 110))  # seeds 160, 161
EVAL_ITERATIONS = 8
EVAL_AMG = dict(points_per_side=16, points_per_batch=64)
EVAL_AMG_GRID = {"pred_iou_thresh": [0.6, 0.8], "stability_score_thresh": [0.6, 0.9]}
# AIS's grid at quantiles of the random decoder's maps (center and boundary
# distance), the foreground threshold and a size floor fixed
EVAL_AIS_QUANTILES = {"center_distance_threshold": (0.6, 0.7),
                      "boundary_distance_threshold": (0.5, 0.6)}
EVAL_AIS_FIXED = dict(foreground_quantile=0.3, min_size=1000)
EVAL_TILED = dict(tile_shape=(512, 512), halo=(128, 128), batch_size=4)
EVAL_CPU_THREADS = 3      # each of the two CPU reference processes
# the fixture's image at half its side (the encoder resizes it to 1024^2, so
# its objects keep the sizes it was trained on), 4 iterations: the CPU's
# share of the phase
EVAL_FIXTURE_IMAGE = dict(shape=(512, 512), seed=201, n_objects=8, radius_range=(15, 55))
EVAL_FIXTURE_ITERATIONS = 4
EVAL_FIXTURE_AMG = dict(points_per_side=8, points_per_batch=64)   # one batch of 64 points
EVAL_FIXTURE_TOL = dict(mask_iou=0.99, msa=1e-3, features=1e-3, pca=1e-3)


def eval_fixture(root, device, threads=None, part="loop", prompts=None):
    """The trained fixture SAM (f32) on ``device`` over a 512^2 image of its
    kind (EVAL_FIXTURE_IMAGE). part "loop": the evaluation's iterative loop
    from the objects' boxes, EVAL_FIXTURE_ITERATIONS rounds without masks, its corrective
    points drawn from RandomState(0) or, given ``prompts``, replayed from
    them; "grid": the AMG grid search (EVAL_FIXTURE_AMG, EVAL_AMG_GRID; CSVs under
    build/chip_smoke_eval/fixture-<device>), then the object features and
    the PCA projection of the embeddings. Returns (results, seconds)."""
    sys.path.insert(0, root)
    torch.set_grad_enabled(False)
    if threads:
        torch.set_num_threads(threads)
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.evaluation import instance_segmentation as egs
    from micro_sam_tpu_torch.evaluation.inference import iterative_prompting_segmentations
    from micro_sam_tpu_torch.evaluation.matching import mean_segmentation_accuracy
    from micro_sam_tpu_torch.instance_segmentation import AutomaticMaskGenerator
    from micro_sam_tpu_torch.models.convert import params_from_flat_npz
    from micro_sam_tpu_torch.models.sam import Sam
    from micro_sam_tpu_torch.object_classification import compute_object_features
    from micro_sam_tpu_torch.predictor import SamPredictor
    from micro_sam_tpu_torch.prompt_generators import IterativePromptGenerator
    from micro_sam_tpu_torch.sample_data import synthetic_data
    from micro_sam_tpu_torch.visualization import project_embeddings_for_visualization
    t0 = time.perf_counter()
    cfg, sd = params_from_flat_npz(os.path.join(root, FIXTURE), compute_dtype="float32")
    sam = Sam(cfg)
    sam.load_state_dict(sd)
    predictor = SamPredictor(sam.to(device).eval())
    image, gt = synthetic_data(**EVAL_FIXTURE_IMAGE)
    gt = gt.astype(np.uint32)
    out = {"encodes": 0}
    encode = predictor.encode_batch

    def counted_encode(*a, **k):
        out["encodes"] += 1
        return encode(*a, **k)
    predictor.encode_batch = counted_encode
    emb = util.precompute_image_embeddings(predictor, image, verbose=False)
    if part == "loop":
        util.set_precomputed(predictor, emb)
        drawn, replay = [], list(prompts or [])
        gen = IterativePromptGenerator(np.random.RandomState(0))

        def corrective(*a, **k):
            drawn.append(replay.pop(0) if prompts is not None else gen(*a, **k))
            return drawn[-1]
        segs = iterative_prompting_segmentations(predictor, gt, True,
                                                 n_iterations=EVAL_FIXTURE_ITERATIONS,
                                                 prompt_generator=corrective)
        out.update(prompts=drawn, segs=np.stack(segs).astype(np.uint8),
                   msa=[mean_segmentation_accuracy(s, gt) for s in segs])
    else:
        import shutil
        result_dir = os.path.join(root, "build", "chip_smoke_eval", f"fixture-{device}")
        shutil.rmtree(result_dir, ignore_errors=True)
        amg = AutomaticMaskGenerator(predictor, **EVAL_FIXTURE_AMG)
        egs.run_instance_segmentation_grid_search(amg, EVAL_AMG_GRID, [image], [gt], result_dir,
                                                  None)
        best, best_msa = egs.evaluate_instance_segmentation_grid_search(result_dir,
                                                                        list(EVAL_AMG_GRID))
        ids, feats = compute_object_features(emb, gt, verbose=False)
        vis, _ = project_embeddings_for_visualization(emb, as_rgb=False)
        out.update(rows=egs.read_csv(os.path.join(result_dir, "image-0.csv")), best=best,
                   best_msa=best_msa, ids=ids, features=feats, pca=vis)
    return out, time.perf_counter() - t0


def eval_fixture_checks(counters, root, cpu_loop, cpu_grid):
    """(f) The fixture on the card against the CPU: the grid search (the same
    best parameters), the features (rel 1e-3 of max) and the PCA (1e-3 once
    each component's sign is aligned); the loop fed the CPU's corrective
    points (every object's mask at IoU >= 0.99 with the CPU's in every
    iteration, each iteration's mSA within 1e-3); the encodes' launches."""
    from micro_sam_tpu_torch.models.convert import params_from_flat_npz
    tol = EVAL_FIXTURE_TOL
    cfg = params_from_flat_npz(os.path.join(root, FIXTURE))[0]
    (grid, grid_s), l_grid = counted(counters, lambda: eval_fixture(root, "cuda", part="grid"))
    t0 = time.perf_counter()
    ref_grid, cpu_grid_s = cpu_grid.result()
    ref_loop, cpu_loop_s = cpu_loop.result()
    waited = time.perf_counter() - t0
    (loop, loop_s), l_loop = counted(counters, lambda: eval_fixture(
        root, "cuda", part="loop", prompts=ref_loop["prompts"]))
    for what, got, n in (("grid", l_grid, grid["encodes"]), ("loop", l_loop, loop["encodes"])):
        expect_launches(f"the fixture's {what} part ({n} encodes of the 96-wide encoder)", got,
                        {k: v * n for k, v in expected_launches(cfg).items()})
    worst = 1.0
    for g_seg, r_seg in zip(loop["segs"], ref_loop["segs"]):
        for i in range(1, int(r_seg.max()) + 1):
            a, b = g_seg == i, r_seg == i
            union = (a | b).sum()
            if union:
                worst = min(worst, float((a & b).sum() / union))
    msa_diff = float(np.abs(np.subtract(loop["msa"], ref_loop["msa"])).max())
    feat_rel = rel_max(grid["features"], ref_grid["features"])
    pca = np.array(grid["pca"], np.float64)
    ref_pca = np.asarray(ref_grid["pca"], np.float64)
    for c in range(pca.shape[-1]):  # an SVD fixes each component up to its sign
        if (pca[..., c] * ref_pca[..., c]).sum() < 0:
            pca[..., c] *= -1
    pca_rel = rel_max(pca, ref_pca)
    rows_diff = max(abs(g["mSA"] - r["mSA"]) for g, r in zip(grid["rows"], ref_grid["rows"]))
    log(f"  trained fixture (f32, TF32 off; CPU {cpu_loop_s:.1f} / {cpu_grid_s:.1f} s, waited "
        f"{waited:.1f} s; card {loop_s:.1f} / {grid_s:.1f} s): iterative loop fed the CPU's "
        f"points, worst object mask IoU card vs CPU {worst:.6f}, per-iteration mSA card "
        f"{np.round(loop['msa'], 4).tolist()} (largest difference {msa_diff:.2e}); AMG grid "
        f"best {grid['best']} ({grid['best_msa']:.4f}) vs the CPU's {ref_grid['best']} "
        f"({ref_grid['best_msa']:.4f}), rows' mSA within {rows_diff:.2e}; features rel "
        f"{feat_rel:.2e}, PCA (signs aligned) rel {pca_rel:.2e}")
    if worst < tol["mask_iou"] or msa_diff > tol["msa"]:
        raise AssertionError("the fixture's iterative loop on the card disagrees with the CPU")
    if grid["best"] != ref_grid["best"] or not np.array_equal(grid["ids"], ref_grid["ids"]):
        raise AssertionError("the fixture's grid search picked other parameters on the card")
    if feat_rel > tol["features"] or pca_rel > tol["pca"] or not np.isfinite(pca).all():
        raise AssertionError("the fixture's features or PCA disagree with the CPU")
    return dict(min_mask_iou=worst, msa=loop["msa"], cpu_msa=ref_loop["msa"], msa_diff=msa_diff,
                best=grid["best"], best_msa=grid["best_msa"], cpu_best_msa=ref_grid["best_msa"],
                rows_msa_diff=rows_diff, features_rel=feat_rel, pca_rel=pca_rel,
                launches=dict(grid=l_grid, loop=l_loop), card_s=[loop_s, grid_s],
                cpu_s=[cpu_loop_s, cpu_grid_s], waited_s=waited)


def launched(counters):
    """The launches since the counts were set to 0, per kernel."""
    return {k: c.launches for k, c in counters.items() if c.launches}


def eval_quiet(counters, what):
    """No kernel launched since the counts were set to 0 (the work used
    cached embeddings)."""
    moved = launched(counters)
    if moved:
        raise AssertionError(f"{what} launched kernels: {moved}")


def eval_grid_searches(counters, predictor, image, gt, emb, emb_dir, store):
    """(c) run_instance_segmentation_grid_search for AIS (the UNETR at
    published widths, its grid at quantiles of the maps) and AMG (EVAL_AMG,
    EVAL_AMG_GRID) on one image over (a)'s cache: no launch, the CSVs'
    columns, the best parameters; ms per combination."""
    from micro_sam_tpu_torch.automatic_segmentation import get_predictor_and_segmenter
    from micro_sam_tpu_torch.evaluation import instance_segmentation as egs
    from micro_sam_tpu_torch.instance_segmentation import AutomaticMaskGenerator
    state = {"decoder_state": random_unetr(True).state_dict()}
    _, ais = get_predictor_and_segmenter("vit_b", predictor=predictor, state=state,
                                         segmentation_mode="ais")
    ais.initialize(image, image_embeddings=emb)
    maps = ais.get_state()
    grid_ais = {k: [round(float(np.quantile(maps[k.replace("_threshold", "s")], q)), 4)
                    for q in qs] for k, qs in EVAL_AIS_QUANTILES.items()}
    fixed = {"foreground_threshold": round(float(np.quantile(
        maps["foreground"], EVAL_AIS_FIXED["foreground_quantile"])), 4),
        "min_size": EVAL_AIS_FIXED["min_size"]}
    out = {}
    for name, seg, grid, kw in (("ais", ais, grid_ais, fixed),
                                ("amg", AutomaticMaskGenerator(predictor, **EVAL_AMG),
                                 EVAL_AMG_GRID, {})):
        result_dir = os.path.join(store, name)
        for c in counters.values():
            c.launches = 0
        with Timed(seg, "initialize") as ini, Timed(seg, "generate") as gen:
            t0 = time.perf_counter()
            egs.run_instance_segmentation_grid_search(seg, grid, [image], [gt], result_dir,
                                                      emb_dir, fixed_generate_kwargs=kw)
            wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        eval_quiet(counters, f"the {name} grid search over cached embeddings")
        best, best_msa = egs.evaluate_instance_segmentation_grid_search(result_dir, list(grid))
        rows = egs.read_csv(os.path.join(result_dir, "image-0.csv"))
        if len(rows) != 4 or list(rows[0]) != list(grid) + ["mSA", "SA50", "SA75"] or \
                set(best) != set(grid) or len(gen.seconds) != 4:
            raise AssertionError(f"the {name} grid search's table is not the 2 x 2 grid's")
        out[name] = dict(grid=grid, fixed=kw, best=best, best_msa=best_msa,
                         msa=[r["mSA"] for r in rows], initialize_ms=1e3 * sum(ini.seconds),
                         ms_per_combination=1e3 * statistics.mean(gen.seconds), wall_ms=1e3 * wall)
        log(f"  {name} grid search {grid} ({kw}): best {best} (mSA {best_msa:.4f}); initialize "
            f"{out[name]['initialize_ms']:.1f} ms, generate + score "
            f"{out[name]['ms_per_combination']:.1f} ms a combination, {1e3 * wall:.1f} ms in all")
    return out


def eval_iterative(counters, predictor, gt):
    """(b) The iterative loop from boxes, EVAL_ITERATIONS rounds with and
    without masks, on the embeddings set on ``predictor``: no launch; ms per
    iteration split into decode (batched_inference: the decode, the masks'
    reduction and their copy to the host) and host (the corrective points,
    the painting); mSA per iteration, scored on the host."""
    from micro_sam_tpu_torch.evaluation import inference as einf
    from micro_sam_tpu_torch.evaluation.matching import mean_segmentation_accuracy
    out = {}
    for use_masks in (False, True):
        np.random.seed(0)
        for c in counters.values():
            c.launches = 0
        with Timed(einf, "batched_inference") as dec:
            t0 = time.perf_counter()
            segs = einf.iterative_prompting_segmentations(predictor, gt, True,
                                                          n_iterations=EVAL_ITERATIONS,
                                                          use_masks=use_masks)
            wall = time.perf_counter() - t0
        eval_quiet(counters, "the iterative loop")
        t1 = time.perf_counter()
        msa = [mean_segmentation_accuracy(s, gt) for s in segs]
        score_ms = 1e3 * (time.perf_counter() - t1) / len(segs)
        n = len(segs)
        if n != EVAL_ITERATIONS or len(dec.seconds) != n or any(
                s.shape != gt.shape or s.dtype != np.uint32 for s in segs):
            raise AssertionError("the iterative loop did not give one segmentation an iteration")
        key = "with_masks" if use_masks else "without_masks"
        out[key] = dict(ms_per_iteration=1e3 * wall / n, decode_ms=1e3 * sum(dec.seconds) / n,
                        host_ms=(1e3 * wall - 1e3 * sum(dec.seconds)) / n, score_ms=score_ms,
                        msa=msa)
        log(f"  iterative prompting {key.replace('_', ' ')}, {n} iterations from boxes, "
            f"{len(np.unique(gt)) - 1} objects: {out[key]['ms_per_iteration']:.1f} ms an "
            f"iteration = decode {out[key]['decode_ms']:.1f} + host {out[key]['host_ms']:.1f} "
            f"(scoring {score_ms:.1f} ms more); mSA {np.round(msa, 4).tolist()}")
    return out


def eval_features(counters, predictor, image, gt, emb):
    """(e) compute_object_features and project_embeddings_for_visualization
    on the card's embeddings, untiled and tiled (EVAL_TILED: one encode of
    the 4 tiles)."""
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.object_classification import compute_object_features
    from micro_sam_tpu_torch.visualization import project_embeddings_for_visualization
    n_obj = len(np.unique(gt)) - 1
    for c in counters.values():
        c.launches = 0
    with Span(predictor, "encode_batch", counters) as enc:
        tiled = util.precompute_image_embeddings(predictor, image, verbose=False, **EVAL_TILED)
    check_launches("tiled embeddings (4 tiles of 768^2, batch 4)", launched(counters),
                   len(enc.seconds), counters)
    out = {}
    for name, e in (("untiled", emb), ("tiled", tiled)):
        t0 = time.perf_counter()
        ids, feats = compute_object_features(e, gt, verbose=False)
        t1 = time.perf_counter()
        vis, scale = project_embeddings_for_visualization(e)
        t2 = time.perf_counter()
        ok = (len(ids) == n_obj and feats.shape == (n_obj, 257) and np.isfinite(feats).all()
              and vis.ndim == 3 and vis.shape[-1] == 3 and np.isfinite(vis).all()
              and vis.min() >= 0 and vis.max() <= 1)
        out[name] = dict(features_ms=1e3 * (t1 - t0), pca_ms=1e3 * (t2 - t1),
                         vis_shape=list(vis.shape), scale=list(scale))
        log(f"  {name}: object features {feats.shape} in {1e3 * (t1 - t0):.1f} ms, the PCA "
            f"projection {vis.shape} in {1e3 * (t2 - t1):.1f} ms")
        if not ok:
            raise AssertionError(f"{name} features or projection malformed")
    return out


def eval_phase(counters, root):
    """Phase 16: evaluation on vit_b bf16 (random weights, seed 0), and the
    trained fixture on the card against the CPU (two processes started at the
    phase's start)."""
    import multiprocessing
    import shutil
    from concurrent.futures import ProcessPoolExecutor
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.evaluation import inference as einf
    from micro_sam_tpu_torch.evaluation.multi_dimensional_segmentation import (
        segment_slices_from_ground_truth)
    from micro_sam_tpu_torch.sample_data import synthetic_data
    store = os.path.join(root, "build", "chip_smoke_eval")
    shutil.rmtree(store, ignore_errors=True)
    emb_dir = os.path.join(store, "embeddings")
    out = {}
    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_loop = pool.submit(eval_fixture, root, "cpu", EVAL_CPU_THREADS, "loop")
        cpu_grid = pool.submit(eval_fixture, root, "cpu", EVAL_CPU_THREADS, "grid")
        predictor = util.get_sam_model("vit_b", seed=0)
        images = [synthetic_data(seed=160 + i, **EVAL_IMAGE) for i in range(2)]
        image, gt = images[0][0], images[0][1].astype(np.uint32)
        log(f"  (a) precompute_all_embeddings of 2 synthetic_data images of 1024^2 into {emb_dir}")
        for c in counters.values():
            c.launches = 0
        with Span(predictor, "encode_batch", counters) as enc:
            t0 = time.perf_counter()
            einf.precompute_all_embeddings(predictor, [im for im, _ in images], emb_dir)
            out["precompute_ms"] = 1e3 * (time.perf_counter() - t0)
        check_launches("precompute_all_embeddings", launched(counters), len(enc.seconds),
                       counters)
        if len(enc.seconds) != 2 or sorted(os.listdir(emb_dir)) != ["image-0.zarr",
                                                                    "image-1.zarr"]:
            raise AssertionError("precompute_all_embeddings did not cache each image")
        for c in counters.values():
            c.launches = 0
        emb = util.precompute_image_embeddings(predictor, image,
                                               os.path.join(emb_dir, "image-0.zarr"),
                                               verbose=False)
        eval_quiet(counters, "reading the cached embeddings")
        util.set_precomputed(predictor, emb)
        log(f"  (b) iterative prompting (vit_b bf16, {EVAL_ITERATIONS} iterations)")
        out["iterative"] = eval_iterative(counters, predictor, gt)
        log("  (c) the grid searches of AIS (the decoder at published widths) and AMG, 2 x 2, "
            "one image")
        out["grid_search"] = eval_grid_searches(counters, predictor, image, gt, emb, emb_dir,
                                                store)
        log(f"  (d) segment_slices_from_ground_truth on the ({VOLUME_SLICES}, "
            f"{VOLUME['shape'][0]}, {VOLUME['shape'][1]}) volume of phase 13")
        vim, vseg = synthetic_data(**VOLUME)
        volume = rolled(vim, VOLUME_SLICES, VOLUME_SHIFT)
        truth = rolled(vseg, VOLUME_SLICES, VOLUME_SHIFT).astype(np.uint32)
        for c in counters.values():
            c.launches = 0
        with Span(predictor, "encode_batch", counters) as enc:
            t0 = time.perf_counter()
            scores = segment_slices_from_ground_truth(volume, truth, predictor=predictor)
            wall = time.perf_counter() - t0
        check_launches("segment_slices_from_ground_truth", launched(counters), len(enc.seconds),
                       counters)
        if not 0 <= scores["sa"] <= 1 or len(enc.seconds) != VOLUME_SLICES:
            raise AssertionError(f"segment_slices_from_ground_truth: {scores}")
        out["segment_slices"] = dict(ms=1e3 * wall, objects=len(np.unique(truth)) - 1,
                                     **{k: float(v) for k, v in scores.items()})
        log(f"  segment_slices_from_ground_truth: {1e3 * wall:.1f} ms for "
            f"{out['segment_slices']['objects']} objects; scores {out['segment_slices']}")
        log("  (e) object features and the PCA projection of the card's embeddings")
        out["features"] = eval_features(counters, predictor, image, gt, emb)
        del predictor
        torch.cuda.empty_cache()
        log("  (f) the trained fixture (f32) on the card against the CPU")
        out["fixture"] = eval_fixture_checks(counters, root, cpu_loop, cpu_grid)
    shutil.rmtree(store, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 17: the annotators and model export
# ---------------------------------------------------------------------------

ANNOT_IMAGE = dict(shape=(1024, 1024), seed=202, n_objects=20, radius_range=(30, 110))
ANNOT_PRESSES = 20       # presses of "s": cycles of 1, 2, 3 points, a box, 8 boxes batched
ANNOT_TRACK_FRAMES = 4
ANNOT_SERIES = 2         # images of the image-series precompute
ANNOT_FIXTURE_CLICKS = 10
ANNOT_CPU_THREADS = 4    # the fixture's CPU clicks, a process started at the phase's start
TORCHSCRIPT_TOL = 1e-3   # the golden f32 bound


def object_points(obj, k, rng):
    """``k`` pixels of the mask ``obj`` drawn by ``rng``, as (y, x) points."""
    ys, xs = np.nonzero(obj)
    pick = rng.choice(len(ys), size=k, replace=False)
    return np.stack([ys[pick], xs[pick]], axis=1).astype(float)


def press(viewer, key, predict):
    """(wall ms, decode ms) of one key press; ``predict`` is a ``Span`` on
    the predictor's decode."""
    n = len(predict.seconds)
    t0 = time.perf_counter()
    viewer.press(key)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    return wall, 1e3 * sum(predict.seconds[n:])


def set_prompts(viewer, points=(), labels=(), boxes=(), props=None):
    """The prompt layers hold exactly these points (with labels) and boxes."""
    pts = viewer.layers["point_prompts"]
    pts.data = np.asarray(points, dtype=float).reshape(-1, pts.data.shape[1])
    pts.properties = {"label": np.array(labels, dtype=object), **(props or {})}
    shp = viewer.layers["prompts"]
    shp.data = [np.asarray(b, dtype=float) for b in boxes]
    shp.shape_type = ["rectangle"] * len(boxes)


def box_vertices(obj_mask):
    ys, xs = np.nonzero(obj_mask)
    return [[ys.min(), xs.min()], [ys.min(), xs.max()], [ys.max(), xs.max()],
            [ys.max(), xs.min()]]


def annotator_2d_checks(counters, out):
    """(a) annotator_2d on a 1024^2 image: initialize_predictor timed (model,
    encode, cache write), the encode's launches, ANNOT_PRESSES presses of "s"
    (decode and host ms each), "c", the layer contract."""
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch._test_util import FakeViewer, check_layer_initialization
    from micro_sam_tpu_torch.predictor import SamPredictor
    from micro_sam_tpu_torch.sam_annotator import _widgets as widgets
    from micro_sam_tpu_torch.sam_annotator._state import AnnotatorState
    from micro_sam_tpu_torch.sam_annotator.annotator_2d import annotator_2d
    from micro_sam_tpu_torch.sample_data import synthetic_data
    image, gt = synthetic_data(**ANNOT_IMAGE)
    state = AnnotatorState()
    state.reset_state()
    for c in counters.values():
        c.launches = 0
    with Span(SamPredictor, "encode_batch", counters) as enc, \
            Timed(util, "get_sam_model") as load, \
            Timed(util, "precompute_image_embeddings") as pre, \
            Timed(AnnotatorState, "initialize_predictor") as init:
        viewer = annotator_2d(image, model_type="vit_b", viewer=FakeViewer(), return_viewer=True)
    check_launches("annotator_2d (initialize_predictor)", launched(counters), len(enc.seconds),
                   counters)
    if len(enc.seconds) != 1:
        raise AssertionError(f"annotator_2d encoded {len(enc.seconds)} times")
    check_layer_initialization(viewer, image.shape)
    ms = {k: 1e3 * sum(t.seconds) for k, t in (("initialize", init), ("model", load),
                                               ("precompute", pre), ("encode", enc))}
    ms["cache_write_and_resize"] = ms["precompute"] - ms["encode"]
    out["initialize_ms"] = ms
    log(f"  initialize_predictor {ms['initialize']:.1f} ms: model {ms['model']:.1f}, encode "
        f"{ms['encode']:.1f}, resize + in-memory cache write {ms['cache_write_and_resize']:.1f}")
    predictor = state.predictor
    ids = [i for i in np.unique(gt) if i != 0]
    rng = np.random.RandomState(0)
    for c in counters.values():
        c.launches = 0
    presses = []
    with Span(predictor, "predict", counters) as dec:
        for n in range(ANNOT_PRESSES):
            kind = n % 5
            obj = gt == ids[n % len(ids)]
            if kind < 3:
                set_prompts(viewer, object_points(obj, kind + 1, rng), ["positive"] * (kind + 1))
                wall, d = press(viewer, "s", dec)
            elif kind == 3:
                set_prompts(viewer, boxes=[box_vertices(obj)])
                wall, d = press(viewer, "s", dec)
            else:  # segment(viewer, batched=True) over 8 boxes
                set_prompts(viewer, boxes=[box_vertices(gt == ids[(n + j) % len(ids)])
                                           for j in range(8)])
                t0 = time.perf_counter()
                n0 = len(dec.seconds)
                widgets.segment(viewer, batched=True)
                torch.cuda.synchronize()
                wall, d = 1e3 * (time.perf_counter() - t0), 1e3 * sum(dec.seconds[n0:])
            seg = viewer.layers["current_object"].data
            if not (seg.shape == image.shape and seg.max() >= 1):
                raise AssertionError(f"press {n} ({kind}): no object segmented")
            presses.append((kind, wall, d))
    eval_quiet(counters, "the key presses (decodes over the cached embeddings)")
    walls = [w for _, w, _ in presses]
    decs = [d for _, _, d in presses]
    out["press_ms"] = dict(p50=float(np.percentile(walls, 50)),
                           decode_p50=float(np.percentile(decs, 50)),
                           host_p50=float(np.percentile([w - d for _, w, d in presses], 50)),
                           batched_8_boxes=[w for k, w, _ in presses if k == 4],
                           presses=len(presses))
    log(f"  {len(presses)} presses of s: p50 {out['press_ms']['p50']:.1f} ms a press (decode "
        f"{out['press_ms']['decode_p50']:.1f}, host {out['press_ms']['host_p50']:.1f}); "
        f"segment(batched=True) over 8 boxes {np.round(out['press_ms']['batched_8_boxes'], 1)}")
    viewer.press("c")
    committed = viewer.layers["committed_objects"].data
    if committed.max() < 1 or viewer.layers["current_object"].data.max() != 0:
        raise AssertionError("commit: nothing committed, or the current object not cleared")
    check_layer_initialization(viewer, image.shape)
    out["committed_objects"] = int(len(np.unique(committed)) - 1)
    return viewer, image


def annotator_3d_checks(counters, predictor, out):
    """(b) SegmentNDWidget over phase 13's (8, 512, 512) volume from one
    point on the middle slice; (c) track_from_prompts over
    ANNOT_TRACK_FRAMES frames of phase 13's sequence."""
    from micro_sam_tpu_torch import learned_tracking as lt
    from micro_sam_tpu_torch._test_util import FakeViewer
    from micro_sam_tpu_torch.sam_annotator import util as vutil
    from micro_sam_tpu_torch.sam_annotator._state import AnnotatorState
    from micro_sam_tpu_torch.sam_annotator._widgets import SegmentNDWidget
    from micro_sam_tpu_torch.sample_data import synthetic_data
    from micro_sam_tpu_torch.util import precompute_image_embeddings
    vim, vseg = synthetic_data(**VOLUME)
    volume = rolled(vim, VOLUME_SLICES, VOLUME_SHIFT)
    truth = rolled(vseg, VOLUME_SLICES, VOLUME_SHIFT)
    mid = VOLUME_SLICES // 2
    for c in counters.values():
        c.launches = 0
    with Span(predictor, "encode_batch", counters) as enc:
        emb = precompute_image_embeddings(predictor, volume, verbose=False)
    check_launches("the volume's embeddings", launched(counters), len(enc.seconds), counters)
    state = AnnotatorState()
    state.predictor, state.image_embeddings, state.image_shape = predictor, emb, volume.shape
    viewer = FakeViewer()
    viewer.add_labels(np.zeros(volume.shape, dtype="uint32"), name="current_object")
    obj = clear_objects(truth, mid)[0]
    y, x = np.argwhere(truth[mid] == obj).mean(0)
    viewer.add_points(np.array([[mid, y, x]]), name="point_prompts",
                      properties={"label": np.array(["positive"], dtype=object)})
    viewer.add_shapes(name="prompts", ndim=3)
    widget = SegmentNDWidget(viewer, tracking=False)
    widget.set_param("projection", "single_point")
    widget.set_param("iou_threshold", 0.0)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    widget.run_button.click()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eval_quiet(counters, "SegmentNDWidget")
    z0, z1 = state.z_range
    seg = viewer.layers["current_object"].data
    n_slices = int((seg > 0).any(axis=(1, 2)).sum())
    if seg[mid].max() < 1 or n_slices < 2:
        raise AssertionError(f"SegmentNDWidget: {n_slices} slices segmented, z range {z0}-{z1}")
    out["segment_nd"] = dict(ms=1e3 * wall, ms_per_slice=1e3 * wall / (z1 - z0 + 1),
                             z_range=[int(z0), int(z1)], slices=n_slices)
    log(f"  SegmentNDWidget ({VOLUME_SLICES}, 512, 512), single point on slice {mid}: "
        f"{1e3 * wall:.1f} ms, z {z0}-{z1}, {1e3 * wall / (z1 - z0 + 1):.1f} ms a slice")

    images, segs, _ = lt.hela_like_tracking_sequence(**TRACKING)
    frames, fsegs = images[:ANNOT_TRACK_FRAMES], segs[:ANNOT_TRACK_FRAMES]
    for c in counters.values():
        c.launches = 0
    with Span(predictor, "encode_batch", counters) as enc:
        femb = precompute_image_embeddings(predictor, frames, ndim=3, verbose=False)
    check_launches("the frames' embeddings", launched(counters), len(enc.seconds), counters)
    cell = int(np.unique(fsegs[0])[1])
    y, x = np.argwhere(fsegs[0] == cell).mean(0)
    points = vutil.PointData(data=np.array([[0, y, x]]), properties={
        "label": np.array(["positive"], dtype=object), "track_id": np.array(["1"], dtype=object),
        "state": np.array(["track"], dtype=object)})
    boxes = vutil.ShapeData(data=[], shape_type=[])
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    seg, slices, _, stop_upper = vutil.segment_slices_with_prompts(
        predictor, points, boxes, femb, frames.shape, track_id=1)
    tracked, division = vutil.track_from_prompts(points, boxes, seg, predictor, slices, femb,
                                                 stop_upper, threshold=0.0,
                                                 projection="single_point")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eval_quiet(counters, "track_from_prompts")
    n = int((tracked == 1).any(axis=(1, 2)).sum())
    if n < 2:
        raise AssertionError(f"track_from_prompts: the track holds {n} frames")
    out["tracking"] = dict(ms=1e3 * wall, frames=n, division=bool(division))
    log(f"  track_from_prompts over {ANNOT_TRACK_FRAMES} frames of {TRACKING['shape']}: "
        f"{1e3 * wall:.1f} ms, the track in {n} frames")


def annotator_auto_checks(counters, predictor, viewer, image, store, out):
    """(d) AutoSegmentWidget in AIS mode (the UNETR at published widths)
    over (a)'s embeddings; the image-series precompute of ANNOT_SERIES
    images into a folder (.npy files, read with np.load: the script does not
    assume the optional imageio)."""
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.instance_segmentation import get_decoder
    import importlib
    # the module (the package's attribute of its name is the function)
    isa = importlib.import_module("micro_sam_tpu_torch.sam_annotator.image_series_annotator")
    from micro_sam_tpu_torch.sam_annotator._state import AnnotatorState
    from micro_sam_tpu_torch.sam_annotator._widgets import AutoSegmentWidget
    from micro_sam_tpu_torch.sample_data import synthetic_data
    state = AnnotatorState()
    state.amg = None
    state.decoder = get_decoder(decoder_state=random_unetr(True).state_dict())
    widget = AutoSegmentWidget(viewer, with_decoder=True, volumetric=False)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    widget.run_button.click()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eval_quiet(counters, "AutoSegmentWidget (AIS over the cached embeddings)")
    auto = viewer.layers["auto_segmentation"].data
    if auto.shape != image.shape:
        raise AssertionError(f"AutoSegmentWidget: {auto.shape}")
    out["autosegment_ais"] = dict(ms=1e3 * wall, objects=int(len(np.unique(auto)) - 1))
    log(f"  AutoSegmentWidget (AIS, the decoder at published widths): {1e3 * wall:.1f} ms, "
        f"{out['autosegment_ais']['objects']} objects")

    folder = os.path.join(store, "series")
    os.makedirs(folder, exist_ok=True)
    files = []
    for i in range(ANNOT_SERIES):
        path = os.path.join(folder, f"image-{i}.npy")
        np.save(path, synthetic_data(shape=(1024, 1024), seed=210 + i)[0])
        files.append(path)
    emb_folder = os.path.join(store, "series_embeddings")
    saved = util.get_sam_model, util.load_image_data
    util.get_sam_model = lambda *a, **k: (predictor, {}) if k.get("return_state") else predictor
    util.load_image_data = lambda path, key=None, **k: np.load(path)
    try:
        for c in counters.values():
            c.launches = 0
        with Span(predictor, "encode_batch", counters) as enc:
            t0 = time.perf_counter()
            _, paths = isa._precompute(files, "vit_b", emb_folder, None, None, False)
            wall = time.perf_counter() - t0
    finally:
        util.get_sam_model, util.load_image_data = saved
    check_launches("the image series' precompute", launched(counters), len(enc.seconds), counters)
    if len(enc.seconds) != ANNOT_SERIES or not all(os.path.isdir(p) for p in paths):
        raise AssertionError(f"image series precompute: {paths}")
    out["image_series_precompute_ms"] = 1e3 * wall
    log(f"  image series: {ANNOT_SERIES} images precomputed into {emb_folder} in "
        f"{1e3 * wall:.1f} ms")


def export_checks(counters, store, out):
    """(e) vit_b (f32, random weights, seed 0): export_sam_model, then
    test_model_package on the card; export_bioengine_model (TorchScript
    encoder + ONNX decoder): the traced encoder loaded onto the card runs no
    port kernel and agrees with the kernel path's f32 embedding within
    TORCHSCRIPT_TOL; the ONNX file names the six inputs."""
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.bioimageio import export_bioengine_model, export_sam_model
    from micro_sam_tpu_torch.bioimageio.model_export import test_model_package
    from micro_sam_tpu_torch.models.sam import preprocess
    from micro_sam_tpu_torch.sample_data import synthetic_data
    image, gt = synthetic_data(shape=(512, 512), seed=203, n_objects=6)
    predictor = util.get_sam_model("vit_b", seed=0, compute_dtype="float32")
    saved = util.get_sam_model
    util.get_sam_model = lambda *a, **k: predictor
    try:
        t0 = time.perf_counter()
        pkg = export_sam_model(image, gt, "vit_b", "chip-smoke-vit-b",
                               os.path.join(store, "vit_b_package.zip"), predictor=predictor)
        t1 = time.perf_counter()
        report = test_model_package(pkg)
        t2 = time.perf_counter()
        root = export_bioengine_model("vit_b", os.path.join(store, "bioengine"))
        t3 = time.perf_counter()
    finally:
        util.get_sam_model = saved
    if not report["passed"]:
        raise AssertionError(f"test_model_package: {report}")
    layout = sorted(os.path.relpath(os.path.join(d, f), root)
                    for d, _, fs in os.walk(root) for f in fs)
    expect = ["image-encoder/1/model.pt", "image-encoder/config.pbtxt",
              "vit_b-decoder/1/model.onnx", "vit_b-decoder/config.pbtxt"]
    if layout != expect:
        raise AssertionError(f"export_bioengine_model: {layout}")
    with open(os.path.join(root, "vit_b-decoder", "1", "model.onnx"), "rb") as f:
        onnx = f.read()
    names = (b"image_embeddings", b"point_coords", b"point_labels", b"mask_input",
             b"has_mask_input", b"orig_im_size")
    if len(onnx) < 10_000 or not all(n in onnx for n in names):
        raise AssertionError("export_onnx_model: the ONNX file lacks the six inputs")
    traced = torch.jit.load(os.path.join(root, "image-encoder", "1", "model.pt"),
                            map_location="cuda")
    x = torch.from_numpy(np.random.RandomState(1).rand(1, 3, 1024, 768).astype(np.float32) * 255)
    for c in counters.values():
        c.launches = 0
    t4 = time.perf_counter()
    got = traced(x.cuda())
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    eval_quiet(counters, "the TorchScript encoder")
    ref = predictor.model.encode_image(preprocess(x.cuda().permute(0, 2, 3, 1)))
    ref = ref.permute(0, 3, 1, 2).float()
    rel = float((got - ref).abs().max() / ref.abs().max())
    log(f"  export_sam_model {1e3 * (t1 - t0):.1f} ms, test_model_package on the card "
        f"{1e3 * (t2 - t1):.1f} ms: {report}")
    log(f"  export_bioengine_model {1e3 * (t3 - t2):.1f} ms: {layout}; the TorchScript "
        f"encoder on the card {1e3 * (t5 - t4):.1f} ms, no port kernel, vs the kernel path's "
        f"f32 embedding rel {rel:.3e} (tol {TORCHSCRIPT_TOL:g})")
    if not (got.shape == (1, 256, 64, 64) and rel <= TORCHSCRIPT_TOL):
        raise AssertionError(f"TorchScript encoder: {tuple(got.shape)}, rel {rel:.3e}")
    out["export"] = dict(export_sam_model_ms=1e3 * (t1 - t0), test_model_package_ms=1e3 * (t2 - t1),
                         package=report, bioengine_ms=1e3 * (t3 - t2),
                         torchscript_ms=1e3 * (t5 - t4), torchscript_rel=rel,
                         package_mb=os.path.getsize(pkg) / 2 ** 20)
    del predictor, traced
    torch.cuda.empty_cache()


def annotator_fixture_clicks(root, device, threads=None):
    """The trained fixture SAM (f32) in the 2d annotator on ``device``: on a
    512^2 image of its kind, ANNOT_FIXTURE_CLICKS presses of "s" (one point
    at an object's centre, or two for the even clicks), each committed.
    Returns (bit-packed masks, the committed labels, seconds)."""
    sys.path.insert(0, root)
    torch.set_grad_enabled(False)
    if threads:
        torch.set_num_threads(threads)
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch._test_util import FakeViewer
    from micro_sam_tpu_torch.models.convert import params_from_flat_npz
    from micro_sam_tpu_torch.models.sam import Sam
    from micro_sam_tpu_torch.predictor import SamPredictor
    from micro_sam_tpu_torch.sam_annotator._state import AnnotatorState
    from micro_sam_tpu_torch.sam_annotator.annotator_2d import annotator_2d
    from micro_sam_tpu_torch.sample_data import synthetic_data
    t0 = time.perf_counter()
    cfg, sd = params_from_flat_npz(os.path.join(root, FIXTURE), compute_dtype="float32")
    sam = Sam(cfg)
    sam.load_state_dict(sd)
    predictor = SamPredictor(sam.to(device).eval())
    predictor.model_type = predictor.model_name = "vit_b"
    image, gt = synthetic_data(**EVAL_FIXTURE_IMAGE)
    state = AnnotatorState()
    state.reset_state()
    emb = util.precompute_image_embeddings(predictor, image, verbose=False)
    viewer = annotator_2d(image, embedding_path=emb, viewer=FakeViewer(), return_viewer=True,
                          predictor=predictor)
    ids = [i for i in np.unique(gt) if i != 0]
    masks = []
    for n in range(ANNOT_FIXTURE_CLICKS):
        obj = gt == ids[n % len(ids)]
        cy, cx = np.argwhere(obj).mean(0)
        pts = [[cy, cx]] if n % 2 else [[cy, cx], np.argwhere(obj)[0]]
        set_prompts(viewer, pts, ["positive"] * len(pts))
        viewer.press("s")
        masks.append(np.packbits(viewer.layers["current_object"].data > 0))
        viewer.press("c")
    committed = viewer.layers["committed_objects"].data.copy()
    state.reset_state()
    return masks, committed, time.perf_counter() - t0


def annotator_phase(counters, root):
    """Phase 17: the annotators and model export on the card (vit_b bf16,
    random weights, seed 0; export in f32), through the port's FakeViewer;
    the trained fixture's clicks on the card against the CPU (a process
    started at the phase's start)."""
    import multiprocessing
    import shutil
    from concurrent.futures import ProcessPoolExecutor
    from micro_sam_tpu_torch.sam_annotator._state import AnnotatorState
    store = os.path.join(root, "build", "chip_smoke_annotator")
    shutil.rmtree(store, ignore_errors=True)
    os.makedirs(store)
    out = {}
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_clicks = pool.submit(annotator_fixture_clicks, root, "cpu", ANNOT_CPU_THREADS)
        log(f"  (a) annotator_2d on a {ANNOT_IMAGE['shape'][0]}^2 synthetic_data image: "
            f"initialize, {ANNOT_PRESSES} presses of s, c")
        viewer, image = annotator_2d_checks(counters, out)
        state = AnnotatorState()
        predictor, emb2d = state.predictor, state.image_embeddings
        log("  (b) SegmentNDWidget and (c) track_from_prompts")
        annotator_3d_checks(counters, predictor, out)
        log("  (d) AutoSegmentWidget (AIS) and the image-series precompute")
        state.image_embeddings, state.image_shape, state.z_range = emb2d, image.shape, None
        annotator_auto_checks(counters, predictor, viewer, image, store, out)
        state.reset_state()
        del predictor, viewer
        torch.cuda.empty_cache()
        log("  (e) export (vit_b, f32)")
        export_checks(counters, store, out)
        log(f"  (f) the trained fixture (f32): {ANNOT_FIXTURE_CLICKS} clicks on the card "
            f"against the CPU")
        card_masks, card_committed, card_s = annotator_fixture_clicks(root, "cuda")
        t0 = time.perf_counter()
        cpu_masks, cpu_committed, cpu_s = cpu_clicks.result()
        waited = time.perf_counter() - t0
    ious = []
    for a, b in zip(card_masks, cpu_masks):
        a, b = np.unpackbits(a).astype(bool), np.unpackbits(b).astype(bool)
        ious.append(float((a & b).sum() / max((a | b).sum(), 1)))
    equal = bool(np.array_equal(card_committed, cpu_committed))
    log(f"  fixture clicks (card {card_s:.1f} s, CPU {cpu_s:.1f} s, waited {waited:.1f} s): "
        f"worst mask IoU card vs CPU {min(ious):.6f}, committed labels equal: {equal}")
    if not (min(ious) >= 0.99 and equal and card_committed.max() >= 1):
        raise AssertionError(f"fixture clicks: IoUs {ious}, committed labels equal {equal}")
    out["fixture"] = dict(min_iou=min(ious), committed_equal=equal, card_s=card_s, cpu_s=cpu_s,
                          waited_s=waited)
    shutil.rmtree(store, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 18: multi-GPU execution (parallel/): an NCCL world of one, and a gloo
# world of two ranks time-sliced on the one card
# ---------------------------------------------------------------------------

PAR_DIR = os.path.join("build", "chip_smoke_parallel")
PAR_RANKS = 2
TP_ENCODE_TOL = {"bfloat16": 3e-2, "float32": 1e-3}   # the model = 2 encode against the unsplit
PAR_STEP_TOL = 1e-3         # every f32 gradient, rel to its tensor's max
PAR_TIMED = (1, 3)          # warm-up and timed bf16 steps at data = 2
PAR_ENCODE_REPS = 3
PAR_DATA_WAIT_S = 600       # a rank's wait for the parent's data
PAR_NOTE = ("two ranks time-sliced on one card: no multi-GPU speed; NCCL across cards and "
            "NVLink unmeasured")
DERIVED_GLOO = ("joint", "medsam", "semantic")   # f32 steps at data = 2 against one process
DERIVED_NCCL = ("joint", "simple", "semantic")   # the NCCL world of one, bitwise
VIT_T_IOU_ATOL = 2e-4       # the JAX package's meshed vit_t test's bounds
VIT_T_MASK_SHARE = 0.999
# the four products of a vit_b block split over model = 2, per rank: qkv and lin1
# on half their output rows, proj and lin2 on half their input columns (epilogue
# none: the bias and the residual are added after the float32 all-reduce)
TP_GEMM_SHAPES = tuple(
    (f"{p} {M}", M, N, K, epi, n)
    for M, n in ((WIN_ROWS, 8), (GLOB_ROWS, 4))
    for p, N, K, epi in (("qkv", 3 * C // 2, C, "none"), ("proj", C, C // 2, "none"),
                         ("lin1", 2 * C, C, "gelu"), ("lin2", C, 2 * C, "none")))


def free_port():
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def nccl_world_of_one(counters, batch, models):
    """An NCCL world of one rank: get_sam_model("vit_b", mesh=make_mesh())
    (bf16, seed 0) precomputes phase 4's 1024^2 image and predicts once; both
    must equal the unmeshed predictor's, bitwise. Then one f32 step each of
    JointSamTrainer, SimpleSamTrainer and SemanticSamTrainer on the mesh and
    off it (``derived_step`` on ``batch`` with ``models``), bitwise equal.
    Returns (the results, the unmeshed steps: the single process's
    references)."""
    import torch.distributed as dist
    from micro_sam_tpu_torch.parallel.mesh import make_mesh
    from micro_sam_tpu_torch.util import get_sam_model, precompute_image_embeddings, set_precomputed
    image = main_path_inputs()[0]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
                            rank=0)
    try:
        mesh = make_mesh()
        if mesh.backend != "nccl" or mesh.device != torch.device("cuda", 0):
            raise AssertionError(f"the NCCL world's mesh is {mesh}")
        runs = {}
        for name, m in (("meshed", mesh), ("unmeshed", None)):
            pred = get_sam_model("vit_b", mesh=m)
            emb, n = counted(counters, lambda: precompute_image_embeddings(pred, image,
                                                                            verbose=False))
            check_launches(f"NCCL world of one, {name} precompute", n, 1, counters)
            set_precomputed(pred, emb)
            out = pred.predict(point_coords=np.array([[300.0, 420.0], [520.0, 610.0]]),
                               point_labels=np.array([1, 0]), return_logits=True)
            runs[name] = (emb["features"], *out, n)
            del pred
        same = [bool(np.array_equal(a, b)) for a, b in zip(runs["meshed"][:4], runs["unmeshed"][:4])]
        log(f"  NCCL world of one ({mesh}): embedding, masks, iou, low-res logits bitwise equal "
            f"to the unmeshed predictor: {same}")
        if not all(same):
            raise AssertionError("the NCCL world of one differs from the unmeshed predictor")
        steps, single = {}, {}
        for kind in DERIVED_NCCL:
            got, single[kind] = (derived_step(kind, m, *batch, models) for m in (mesh, None))
            steps[kind] = derived_bitwise(kind, got, single[kind])
        return dict(bitwise_equal=all(same), launches=runs["meshed"][4], derived=steps), single
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()


class GradsKept(torch.optim.AdamW):
    """AdamW that keeps the gradients its last step saw (after the trainer's
    all-reduce)."""

    def step(self, closure=None):
        self.grads = {id(p): p.grad.detach().clone() for g in self.param_groups
                      for p in g["params"] if p.grad is not None}
        return super().step(closure)


def par_step_grads(mesh, x, y, spans=None):
    """(loss, {name: whole f32 gradient on the CPU}) of one f32 SamTrainer point
    step (one round, 4 objects) of vit_b cut to F32_STEP_CUT's 6 blocks on the
    global batch (x, y): on ``mesh`` each data rank takes its share and the
    gradients are the trainer's after its all-reduce (gathered over the model
    group); None is the single process. ``spans`` (a list) gains the host
    seconds of the model's build, the batch, the step and the gradients'
    gathering."""
    from micro_sam_tpu_torch.parallel.mesh import gather_tensors
    from micro_sam_tpu_torch.training import SamTrainer, get_trainable_sam_model
    spans = [] if spans is None else spans
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        spans.append((name, round(time.perf_counter() - t0, 3)))
        t0 = time.perf_counter()

    depth, globs = F32_STEP_CUT["vit_b"]
    with CutDepth("vit_b", depth, globs):
        model = get_trainable_sam_model("vit_b", device="cuda", compute_dtype="float32")
    lap("build")
    named = list(model.sam.named_parameters())
    opt = GradsKept([p for _, p in named], lr=1e-5, betas=(0.9, 0.999), eps=1e-8,
                    weight_decay=1e-4)
    trainer = SamTrainer("f32", None, None, model, optimizer=opt, n_sub_iteration=1,
                         n_objects_per_batch=4, logger=False, mesh=mesh)
    d, i = (1, 0) if mesh is None else (mesh.shape["data"], mesh.data_index)
    per = len(x) // d
    batch = trainer._prepare_batch(x[i * per:(i + 1) * per], y[i * per:(i + 1) * per], True,
                                   False, 1, 0)
    lap("batch")
    with torch.enable_grad():
        loss, _ = trainer.train_step(batch, True, False, True)
    lap("step")
    grads = {n: opt.grads[id(p)] for n, p in named if id(p) in opt.grads}
    if mesh is not None:
        grads = gather_tensors(grads, mesh, model.config)
    grads = {n: g.float().cpu() for n, g in grads.items()}
    lap("gradients to the host")
    return float(loss), grads


def hold_step_grads(what, got, ref, zero=1e-7):
    """Every gradient of ``got`` within PAR_STEP_TOL of its tensor's max in
    ``ref`` (zero-by-symmetry tensors, ``zero`` of the largest or less in
    ``ref``, below 1e-6 of the largest), the loss rel 1e-5. Returns (worst
    rel, loss rel)."""
    (loss, g), (loss_ref, g_ref) = got, ref
    g_max = max(float(t.abs().max()) for t in g_ref.values())
    worst, worst_name = 0.0, ""
    for name, r in g_ref.items():
        a = g[name]
        if float(r.abs().max()) <= zero * g_max:
            if float(a.abs().max()) > 1e-6 * g_max:
                raise AssertionError(f"{what}: {name} should have no gradient")
            continue
        rel = float((a - r).abs().max() / r.abs().max())
        if rel > worst:
            worst, worst_name = rel, name
    loss_rel = abs(loss - loss_ref) / abs(loss_ref)
    log(f"  {what}: loss {loss:.6f} vs {loss_ref:.6f} (rel {loss_rel:.2e}), worst gradient rel "
        f"{worst:.3e} ({worst_name}; tol {PAR_STEP_TOL}) "
        f"{'ok' if worst <= PAR_STEP_TOL and loss_rel <= 1e-5 else 'FAIL'}")
    if worst > PAR_STEP_TOL or loss_rel > 1e-5:
        raise AssertionError(f"{what} differs from the single process")
    return worst, loss_rel


def par_timed_steps(mesh, imgs, segs):
    """bf16 SamTrainer steps at train_sam's defaults (global batch 2: one
    image a data rank, 25 objects, 8 rounds, lr 1e-5) on ``mesh``:
    PAR_TIMED warm-up and timed ``train_step`` calls (forward, backward, the
    all-reduce, AdamW; the prompt sampling before each is not timed), host
    clock, the card synchronized around each; the gradient all-reduce's ms
    and bytes a step (the trainer's ``all_reduce_gradients_``, timed the
    same way)."""
    from micro_sam_tpu_torch.training import SamTrainer, get_trainable_sam_model
    from micro_sam_tpu_torch.training import sam_trainer
    from micro_sam_tpu_torch.training.training import SamDataset, SamLoader
    model = get_trainable_sam_model("vit_b", device="cuda")
    trainer = SamTrainer("par", None, None, model, n_sub_iteration=8, n_objects_per_batch=25,
                         logger=False, mesh=mesh)
    loader = SamLoader(SamDataset(imgs[:4], segs[:4], (512, 512), n_samples=2 * sum(PAR_TIMED)),
                       batch_size=2)
    reduce, spans = sam_trainer.all_reduce_gradients_, []

    def timed_reduce(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = reduce(*a, **kw)
        torch.cuda.synchronize()
        spans.append((time.perf_counter() - t0, n))
        return n

    sam_trainer.all_reduce_gradients_ = timed_reduce
    steps = []
    try:
        i = mesh.data_index
        for k, (x, y) in enumerate(loader):
            if k == sum(PAR_TIMED):
                break
            choice = trainer._get_prompt_and_multimasking_choices(trainer._iteration)
            batch = trainer._prepare_batch(x[i:i + 1], y[i:i + 1], *choice[:2], *choice[3:],
                                           batch_idx=k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.enable_grad():
                trainer.train_step(batch, *choice[:3])
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
    finally:
        sam_trainer.all_reduce_gradients_ = reduce
    w = PAR_TIMED[0]
    return dict(step_ms=1e3 * statistics.median(steps[w:]),
                allreduce_ms=1e3 * statistics.median(s for s, _ in spans[w:]),
                allreduce_bytes=spans[-1][1], steps=len(steps) - w)


def joint_targets(y):
    """The joint trainer's (B, 3, H, W) distance targets of labels ``y``."""
    from micro_sam_tpu_torch.training import PerObjectDistanceTransform
    return np.stack([PerObjectDistanceTransform()(np.asarray(s))[-3:] for s in y])


def derived_models():
    """The f32 vit_b cut to F32_STEP_CUT's 6 blocks and a UNETR decoder at
    published widths, built once a process, with their initial states:
    ``derived_step`` reloads them before each step."""
    from micro_sam_tpu_torch.instance_segmentation import get_unetr
    from micro_sam_tpu_torch.training import get_trainable_sam_model
    depth, globs = F32_STEP_CUT["vit_b"]
    with CutDepth("vit_b", depth, globs):
        model = get_trainable_sam_model("vit_b", device="cuda", compute_dtype="float32")
    unetr = get_unetr(device="cuda")
    return model, unetr, {k: v.clone() for k, v in model.sam.state_dict().items()}, \
        {k: v.clone() for k, v in unetr.state_dict().items()}


def derived_step(kind, mesh, x, y, t, models, timed=False):
    """One f32 step of the trainer ``kind`` ("joint", "medsam", "simple",
    "semantic") on ``derived_models``' models, reloaded first (one round, 4
    objects, lr 1e-5; the joint trainer's SAM AdamW at lr 0, so that its
    decoder step reads the SAM every run started from) on the global batch
    (x, y, joint targets t): on a data ``mesh`` each data rank takes its
    share. Returns {"loss", "grads" (whole f32 gradients on the CPU, after
    the trainer's all-reduce), "decoder_grads", "decoder_loss", "launches"
    (K1 / K4 of the step), "step_ms" (a second step, host clock, with
    ``timed``)}."""
    import random
    from micro_sam_tpu_torch.ops.relpos_attention import (relpos_attention,
                                                          relpos_attention_backward)
    from micro_sam_tpu_torch.training import (JointSamTrainer, MedSAMTrainer,
                                              SemanticSamTrainer, SimpleSamTrainer)
    model, unetr, sam0, unetr0 = models
    model.sam.load_state_dict(sam0)
    unetr.load_state_dict(unetr0)
    named = list(model.sam.named_parameters())
    adam = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    opt = GradsKept([p for _, p in named], lr=0.0 if kind == "joint" else 1e-5, **adam)
    kw = dict(optimizer=opt, n_sub_iteration=1, n_objects_per_batch=4, logger=False, mesh=mesh)
    if kind == "joint":
        trainer = JointSamTrainer(kind, None, None, model, unetr=unetr, **kw)
        trainer.unetr_optimizer = GradsKept(list(unetr.parameters()), lr=1e-5, **adam)
    else:
        cls = {"medsam": MedSAMTrainer, "simple": SimpleSamTrainer,
               "semantic": SemanticSamTrainer}[kind]
        trainer = cls(kind, None, None, model, **({"num_classes": 3} if kind == "semantic"
                                                  else {}), **kw)
    d, i = (1, 0) if mesh is None else (mesh.shape["data"], mesh.data_index)
    per = len(x) // d
    xs, ys, ts = x[i * per:(i + 1) * per], y[i * per:(i + 1) * per], t[i * per:(i + 1) * per]
    counters = {"relpos_attention": relpos_attention,
                "relpos_attention_backward": relpos_attention_backward}

    def step():
        out = {}
        with torch.enable_grad():
            if kind == "semantic":
                images, targets = trainer.convert_inputs(xs, np.asarray(ys) % 3)
                out["loss"] = trainer._step(images.cuda(), targets.cuda(), True)
            else:
                random.seed(0)  # SimpleSamTrainer's draw: mesh rank 0's, as one process's
                choice = trainer._get_prompt_and_multimasking_choices(trainer._iteration)
                batch = trainer._prepare_batch(xs, ys, *choice[:2], *choice[3:])
                out["loss"], _ = trainer.train_step(batch, *choice[:3])
                if kind == "joint":
                    out["decoder_loss"] = trainer.instance_step(batch[0], ts)
        return out

    out, launches = counted(counters, step)
    depth = model.config.depth  # the joint step's decoder step encodes once more
    expect_launches(f"f32 {kind} step ({'one process' if mesh is None else mesh})", launches,
                    {"relpos_attention": (3 if kind == "joint" else 2) * depth,
                     "relpos_attention_backward": 4 * depth})
    res = {"loss": float(out["loss"]), "launches": launches,
           "decoder_loss": float(out["decoder_loss"]) if "decoder_loss" in out else None}
    res["grads"] = {n: opt.grads[id(p)].float().cpu() for n, p in named if id(p) in opt.grads}
    res["decoder_grads"] = None if kind != "joint" else {
        n: trainer.unetr_optimizer.grads[id(p)].cpu() for n, p in unetr.named_parameters()}
    if timed:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        res["step_ms"] = 1e3 * (time.perf_counter() - t0)
    return res


def derived_bitwise(kind, got, ref):
    """The NCCL world of one's step of ``kind`` bitwise equal to the
    unmeshed trainer's: loss, every gradient, the decoder's."""
    parts = {"loss": got["loss"] == ref["loss"],
             "gradients": all(torch.equal(v, ref["grads"][k]) for k, v in got["grads"].items())}
    if got["decoder_grads"] is not None:
        parts["decoder loss"] = got["decoder_loss"] == ref["decoder_loss"]
        parts["decoder gradients"] = all(torch.equal(v, ref["decoder_grads"][k])
                                         for k, v in got["decoder_grads"].items())
    same = all(parts.values())
    log(f"  NCCL world of one, {kind} step (f32, vit_b cut to 6 blocks): loss {got['loss']:.6f}"
        f"{'' if got['decoder_loss'] is None else ', decoder loss %.6f' % got['decoder_loss']}, "
        f"{len(got['grads'])} gradients, launches {got['launches']}; bitwise equal to the "
        f"unmeshed trainer: {parts}")
    if not same or set(got["grads"]) != set(ref["grads"]):
        raise AssertionError(f"the NCCL world of one's {kind} step differs from the unmeshed "
                             f"trainer")
    return dict(bitwise_equal=same, launches=got["launches"])


def hold_derived(kind, got, ref):
    """A data = 2 step of ``kind`` against one process: ``hold_step_grads``
    on the SAM's gradients and, for the joint trainer, the decoder's."""
    out = {"sam": hold_step_grads(f"f32 {kind} step at data = 2 vs one process",
                                  (got["loss"], got["grads"]), (ref["loss"], ref["grads"]))}
    if got["decoder_grads"] is not None:
        # a decoder gradient at or below 1e-6 of the largest is float noise
        # (tests/test_torch_joint_training.py::_grads_held)
        out["decoder"] = hold_step_grads(
            f"f32 {kind} step at data = 2, the decoder, vs one process",
            (got["decoder_loss"], got["decoder_grads"]),
            (ref["decoder_loss"], ref["decoder_grads"]), zero=1e-6)
    return {k: dict(worst_grad_rel=v[0], loss_rel=v[1]) for k, v in out.items()}


def peft_predictors():
    """{(name, dtype): unmeshed predictor} of the LoRA and QLoRA vit_b in bf16
    and f32: get_sam_model("vit_b", compute_dtype="float32",
    peft_kwargs=PEFT) (seed 0), its LoRA ``b`` drawn non-zero
    (``redraw_lora_``), and the other three made from its weights (``make_sam``
    with QLORA quantizes the loaded float32 base, as get_sam_model does)."""
    from micro_sam_tpu_torch.models.build_sam import get_config, make_sam
    from micro_sam_tpu_torch.predictor import SamPredictor
    from micro_sam_tpu_torch.util import get_sam_model
    base = get_sam_model("vit_b", compute_dtype="float32", peft_kwargs=PEFT)
    redraw_lora_(base.model)
    sd = {k: v.cpu() for k, v in base.model.state_dict().items()}
    preds = {}
    for name, peft in (("lora", PEFT), ("qlora", QLORA)):
        for dt in ("bfloat16", "float32"):
            preds[(name, dt)] = base if (name, dt) == ("lora", "float32") else SamPredictor(
                make_sam(get_config("vit_b", dt), sd, 0, None, peft_kwargs=peft).cuda().eval())
    return preds


def peft_step_grads(mesh, x, y):
    """(loss, whole f32 gradients) of one f32 SamTrainer point step of the
    LoRA vit_b (F32_STEP_CUT's 6 blocks, LoRA ``b`` drawn non-zero, the base
    encoder frozen as ``train_sam(peft_kwargs=)`` freezes it) on the global
    batch; on ``mesh`` each data rank its share, the blocks split over the
    model axis."""
    from micro_sam_tpu_torch.parallel.mesh import gather_tensors
    from micro_sam_tpu_torch.training import SamTrainer, get_trainable_sam_model
    depth, globs = F32_STEP_CUT["vit_b"]
    with CutDepth("vit_b", depth, globs):
        model = get_trainable_sam_model("vit_b", device="cuda", compute_dtype="float32",
                                        peft_kwargs=PEFT)
    redraw_lora_(model.sam)
    named = [(n, p) for n, p in model.sam.named_parameters() if p.requires_grad]
    opt = GradsKept([p for _, p in named], lr=1e-5, betas=(0.9, 0.999), eps=1e-8,
                    weight_decay=1e-4)
    trainer = SamTrainer("lora", None, None, model, optimizer=opt, n_sub_iteration=1,
                         n_objects_per_batch=4, logger=False, mesh=mesh)
    d, i = (1, 0) if mesh is None else (mesh.shape["data"], mesh.data_index)
    per = len(x) // d
    batch = trainer._prepare_batch(x[i * per:(i + 1) * per], y[i * per:(i + 1) * per], True,
                                   False, 1, 0)
    with torch.enable_grad():
        loss, _ = trainer.train_step(batch, True, False, True)
    grads = {n: opt.grads[id(p)] for n, p in named if id(p) in opt.grads}
    if mesh is not None:
        grads = gather_tensors(grads, mesh, model.config)
    if not any(".lora." in n for n in grads) or any(
            n.startswith("image_encoder.") and n.endswith(".qkv.weight") for n in grads):
        raise AssertionError("the LoRA step did not train the LoRA terms alone in the encoder")
    return float(loss), {n: g.float().cpu() for n, g in grads.items()}


def vit_t_predict(mesh):
    """get_sam_model("vit_t") (f32, seed 0) on ``mesh`` or unmeshed: phase
    4's image precomputed, one point predicted; (masks, iou predictions)."""
    from micro_sam_tpu_torch.util import get_sam_model, precompute_image_embeddings, set_precomputed
    pred = get_sam_model("vit_t", compute_dtype="float32", mesh=mesh)
    set_precomputed(pred, precompute_image_embeddings(pred, main_path_inputs()[0],
                                                      verbose=False))
    masks, ious, _ = pred.predict(point_coords=np.array([[300.0, 420.0]]),
                                  point_labels=np.array([1]))
    return np.asarray(masks), np.asarray(ious)


def parallel_rank(rank, root, workdir, spawned_at):
    """One rank of the gloo world of PAR_RANKS ranks on cuda:0 (spawned by
    ``parallel_phase`` at ``spawned_at``, wall clock): its checks on the
    parent's data (<workdir>/data.npz), its results written to
    <workdir>/rank<rank>.pt."""
    import torch.distributed as dist
    log(f"  [rank {rank}] up {time.time() - spawned_at:.1f} s after the spawn")
    sys.path.insert(0, root)
    os.chdir(root)
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{workdir}/gloo.init",
                            world_size=PAR_RANKS, rank=rank)
    try:
        res = parallel_rank_checks(rank, root, workdir)
        torch.save(res, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def parallel_rank_checks(rank, root, workdir):
    from micro_sam_tpu_torch.ops.gemm import gemm
    from micro_sam_tpu_torch.ops.layernorm import layernorm
    from micro_sam_tpu_torch.ops.relpos_attention import (relpos_attention,
                                                          relpos_attention_backward)
    from micro_sam_tpu_torch.parallel import distributed
    from micro_sam_tpu_torch.parallel.mesh import make_mesh
    from micro_sam_tpu_torch.predictor import SamPredictor
    from micro_sam_tpu_torch.training.training import SamDataset, SamLoader
    from micro_sam_tpu_torch.util import get_sam_model, precompute_image_embeddings
    from micro_sam_tpu_torch.utils import zarr_lite
    counters = {"layernorm": layernorm, "gemm": gemm, "relpos_attention": relpos_attention}
    t_start = time.perf_counter()
    say = lambda *a: log(f"  [rank {rank} +{time.perf_counter() - t_start:.1f} s]", *a)  # noqa: E731
    dp, tp = make_mesh(model_axis=1), make_mesh(model_axis=PAR_RANKS)
    say(f"meshes {dp.shape} and {tp.shape} over {dp.backend} on {dp.device}")
    pred = get_sam_model("vit_b", mesh=dp)
    import torch._dynamo  # noqa: F401  a first AdamW step imports it: here, while the data comes
    data = os.path.join(workdir, "data.npz")  # the parent writes it meanwhile
    while not os.path.exists(data):
        if time.perf_counter() - t_start > PAR_DATA_WAIT_S:
            raise TimeoutError(f"no {data} after {PAR_DATA_WAIT_S} s")
        time.sleep(0.1)
    with np.load(data) as f:
        image = f["image"]
        imgs, segs = list(f["imgs"]), list(f["segs"])
    say("the model built, the data read")
    res = {}
    # data = 2: phase 10's tiled precompute, two tiles a rank
    precompute_image_embeddings(pred, image[:1024, :1024], verbose=False)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb, n = counted(counters, lambda: precompute_image_embeddings(
        pred, image, tile_shape=TILE, halo=HALO, batch_size=TILE_BATCH, verbose=False))
    res["tiled_s"] = time.perf_counter() - t0
    check_launches(f"[rank {rank}] data = 2 tiled precompute ({res['tiled_s']:.3f} s, two "
                   f"tiles a rank)", n, 1, counters)
    res["tiled_launches"] = n
    res["tiled"] = {t: np.asarray(e["features"]) for t, e in emb["features"].items()}
    # the multi-process precompute into a shared cache: the same weights in an
    # unmeshed predictor a process
    stamps, setitem = [], zarr_lite.Attributes.__setitem__

    def stamping(self, key, value):
        if key == "done":
            stamps.append(key)
        return setitem(self, key, value)

    zarr_lite.Attributes.__setitem__ = stamping
    try:
        t0 = time.perf_counter()
        emb = distributed.precompute_image_embeddings_multihost(
            SamPredictor(pred.model), image, os.path.join(workdir, "multihost.zarr"),
            tile_shape=TILE, halo=HALO, batch_size=TILE_BATCH)
        res["multihost_s"] = time.perf_counter() - t0
    finally:
        zarr_lite.Attributes.__setitem__ = setitem
    res["multihost"] = {t: np.asarray(e["features"]) for t, e in emb["features"].items()}
    res["stamps"] = len(stamps)
    say(f"multi-process precompute {res['multihost_s']:.3f} s")
    del pred, emb
    # data = 2: the trained fixture's AMG at phase 11's cut
    run = fixture_amg(root, "cuda", mesh=dp)[0]
    res["amg"] = fixture_records([run])
    say(f"data = 2 fixture AMG: {res['amg']['candidates']} candidates, "
        f"{len(res['amg']['records'])} records, initialize {run['initialize_s']:.3f} s")
    # model = 2: one 1024^2 encode a dtype, bf16 timed
    x1 = main_path_inputs()[2]
    res["tp"] = {}
    for dt in ("bfloat16", "float32"):
        pred = get_sam_model("vit_b", mesh=tp, compute_dtype=dt)
        feats, n = counted(counters, lambda: pred.encode_batch(x1).float().cpu().numpy())
        check_launches(f"[rank {rank}] model = 2 encode {dt} (split widths)", n, 1, counters)
        res["tp"][dt] = dict(features=feats, launches=n)
        if dt == "bfloat16":
            times = []
            for _ in range(PAR_ENCODE_REPS):
                t0 = time.perf_counter()
                pred.encode_batch(x1)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            res["tp"][dt]["encode_ms"] = 1e3 * statistics.median(times)
        say(f"model = 2 encode {dt}: launches {n}"
            + (f", {res['tp'][dt]['encode_ms']:.3f} ms" if dt == "bfloat16" else ""))
        del pred
    torch.cuda.empty_cache()
    # training: one f32 step at data = 2 and at model = 2 on phase 6's f32 batch
    x, y = next(iter(SamLoader(SamDataset(imgs[:4], segs[:4], (512, 512), n_samples=4),
                               batch_size=2)))
    res["step"] = {}
    for name, m in (("data", dp), ("model", tp)):
        spans = []
        res["step"][name] = par_step_grads(m, x, y, spans)
        say(f"f32 step at {name} = 2, host seconds {spans}")
    # the derived trainers at data = 2 (f32, 6 blocks), the joint step timed
    t = joint_targets(y)
    res["derived"], models = {}, derived_models()
    for kind in DERIVED_GLOO:
        res["derived"][kind] = derived_step(kind, dp, x, y, t, models, timed=kind == "joint")
        say(f"f32 {kind} step at data = 2: loss {res['derived'][kind]['loss']:.6f}, launches "
            f"{res['derived'][kind]['launches']}"
            + (f", {res['derived'][kind]['step_ms']:.3f} ms (a second step)"
               if kind == "joint" else ""))
    # model = 2: the LoRA and QLoRA encodes (K1 and the split chains), a LoRA
    # step (K1 / K4 at the shard's heads), the meshed vit_t predict
    del models
    torch.cuda.empty_cache()
    res["peft"], preds = {}, peft_predictors()
    for name, dt in list(preds):
        pred = preds.pop((name, dt)).shard_on_mesh(tp)
        feats, n = counted(counters, lambda: pred.encode_batch(x1).float().cpu().numpy())
        check_launches(f"[rank {rank}] model = 2 {name} encode {dt} (split widths; the "
                       f"{name} terms PyTorch around the kernels)", n, 1, counters)
        entry = dict(features=feats, launches=n)
        if name == "lora" and dt == "bfloat16":
            times = []
            for _ in range(PAR_ENCODE_REPS):
                t0 = time.perf_counter()
                pred.encode_batch(x1)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            entry["encode_ms"] = 1e3 * statistics.median(times)
        res["peft"][(name, dt)] = entry
        del pred
    say(f"model = 2 LoRA bf16 encode {res['peft'][('lora', 'bfloat16')]['encode_ms']:.3f} ms")
    torch.cuda.empty_cache()
    res["lora_step"], k4 = counted({"relpos_attention": relpos_attention,
                                    "relpos_attention_backward": relpos_attention_backward},
                                   lambda: peft_step_grads(tp, x, y))
    depth = F32_STEP_CUT["vit_b"][0]
    expect_launches(f"[rank {rank}] f32 LoRA step at model = 2", k4,
                    {"relpos_attention": 2 * depth, "relpos_attention_backward": 4 * depth})
    res["lora_step_launches"] = k4
    say(f"f32 LoRA step at model = 2: loss {res['lora_step'][0]:.6f}, launches {k4}")
    res["vit_t"] = vit_t_predict(tp)
    if rank:  # rank 0's copy is the whole of each
        res["step"] = None
        for r in res["derived"].values():
            r["grads"] = r["decoder_grads"] = None
        res["lora_step"] = None
    torch.cuda.empty_cache()
    res["timed"] = par_timed_steps(dp, imgs, segs)
    say(f"data = 2 bf16 steps at train_sam's defaults: {res['timed']}")
    return res


def parallel_phase(counters, root):
    """Phase 18: the gloo world of PAR_RANKS spawned ranks on the one card
    (the kernels built here first, the data made here once), and meanwhile
    the NCCL world of one and this process's single-process runs of the same
    work, which the ranks are held against; then the gemm at the split shapes
    against its plain version."""
    import shutil
    from micro_sam_tpu_torch.models.sam import preprocess
    from micro_sam_tpu_torch.training.training import SamDataset, SamLoader
    from micro_sam_tpu_torch.util import get_sam_model, precompute_image_embeddings
    out = {"note": PAR_NOTE, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]}
    workdir = os.path.join(root, PAR_DIR)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    log(f"  (b) gloo: {PAR_RANKS} ranks on cuda:0 ({PAR_NOTE})")
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.start_processes(parallel_rank,
                                                args=(root, workdir, time.time()),
                                                nprocs=PAR_RANKS, join=False,
                                                start_method="spawn")
    try:
        # meanwhile: the ranks' data (written whole, then renamed), the NCCL
        # world of one, and the single process's runs
        image = tiled_data()[0]
        imgs, segs = training_data()
        part = os.path.join(workdir, "data.part.npz")
        np.savez(part, image=image, imgs=np.stack(imgs), segs=np.stack(segs))
        os.replace(part, os.path.join(workdir, "data.npz"))
        log(f"  the ranks' data written at +{time.perf_counter() - t0:.1f} s")
        x, y = next(iter(SamLoader(SamDataset(imgs[:4], segs[:4], (512, 512), n_samples=4),
                                   batch_size=2)))
        t = joint_targets(y)
        log("  (a) NCCL, while the gloo world runs")
        models = derived_models()
        out["nccl"], single_derived = nccl_world_of_one(counters, (x, y, t), models)
        single_derived["medsam"] = derived_step("medsam", None, x, y, t, models)
        del models
        single_peft = {key: pred.encode_batch(main_path_inputs()[2]).float().cpu().numpy()
                       for key, pred in peft_predictors().items()}
        single_lora_step = peft_step_grads(None, x, y)
        single_vit_t = vit_t_predict(None)
        pred = get_sam_model("vit_b")
        single_tiled = {t: np.asarray(e["features"]) for t, e in precompute_image_embeddings(
            pred, image, tile_shape=TILE, halo=HALO, batch_size=TILE_BATCH,
            verbose=False)["features"].items()}
        del pred
        single_amg = fixture_records([fixture_amg(root, "cuda")[0]])
        x1 = torch.from_numpy(main_path_inputs()[2])
        single_encode = {dt: get_sam_model("vit_b", compute_dtype=dt).model.encode_image(
            preprocess(x1.cuda())).float().cpu().numpy() for dt in TP_ENCODE_TOL}
        single_step = par_step_grads(None, x, y)
        torch.cuda.empty_cache()
        log(f"  the single process's runs done at +{time.perf_counter() - t0:.1f} s")
    except BaseException:
        for p in ctx.processes:  # no rank outlives a failed parent
            p.terminate()
            p.join()
        raise
    while not ctx.join():
        pass
    out["world_s"] = time.perf_counter() - t0
    r0, r1 = (torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
              for r in range(PAR_RANKS))
    # data = 2
    tiled_rel = max(rel_max(r0["tiled"][t], single_tiled[t]) for t in single_tiled)
    log(f"  data = 2 tiled precompute against the single process: {len(r0['tiled'])} tiles, "
        f"rel {tiled_rel:.3e} (tol 3e-2), {r0['tiled_s']:.3f} s ({PAR_NOTE})")
    if set(r0["tiled"]) != set(single_tiled) or tiled_rel > 3e-2:
        raise AssertionError("the data = 2 tiled precompute differs from the single process")
    # every rank decodes its share of each batch: the survivors of every batch,
    # and the records at the floors (which rank 1's share reaches), too
    amg = match_fixture_records(r0["amg"]["records"], single_amg["records"])
    amg["at_floors"] = match_fixture_records(r0["amg"]["records_at_floors"],
                                             single_amg["records_at_floors"],
                                             thresholds=FIXTURE_FLOORS)
    for r in (r0, r1):
        if (r["amg"]["candidates"], r["amg"]["survivors"]) != (single_amg["candidates"],
                                                               single_amg["survivors"]):
            raise AssertionError(f"data = 2 fixture AMG: candidates {r['amg']['candidates']}, "
                                 f"survivors {r['amg']['survivors']}; one process "
                                 f"{single_amg['candidates']}, {single_amg['survivors']}")
    amg.update(candidates=single_amg["candidates"], survivors=single_amg["survivors"])
    log(f"  data = 2 fixture AMG against the single process (candidates and survivors per batch "
        f"equal on both ranks): {amg}")
    # model = 2
    tp = {}
    for dt, tol in TP_ENCODE_TOL.items():
        rel = rel_max(r0["tp"][dt]["features"], single_encode[dt])
        same_ranks = bool(np.array_equal(r0["tp"][dt]["features"], r1["tp"][dt]["features"]))
        tp[dt] = dict(rel=rel, launches_per_rank=r0["tp"][dt]["launches"],
                      encode_ms=r0["tp"][dt].get("encode_ms"), ranks_equal=same_ranks)
        log(f"  model = 2 encode {dt}: rel {rel:.3e} to the unsplit run (tol {tol}), ranks equal "
            f"{same_ranks}, launches a rank {r0['tp'][dt]['launches']}"
            + (f", {tp[dt]['encode_ms']:.3f} ms ({PAR_NOTE})" if tp[dt]["encode_ms"] else ""))
        if rel > tol or not same_ranks:
            raise AssertionError(f"the model = 2 encode ({dt}) differs from the unsplit run")
    # training
    steps = {name: hold_step_grads(f"f32 step at {name} = 2 vs one process", got, single_step)
             for name, got in r0["step"].items()}
    derived = {kind: hold_derived(kind, r0["derived"][kind], single_derived[kind])
               for kind in DERIVED_GLOO}
    joint_ms = [r["derived"]["joint"]["step_ms"] for r in (r0, r1)]
    log(f"  f32 joint step (vit_b cut to 6 blocks, one image a rank) at data = 2: "
        f"{[round(v, 3) for v in joint_ms]} ms by rank ({PAR_NOTE}; {out['card']})")
    # model = 2: the PEFT encodes, the LoRA step, vit_t
    peft = {}
    for (name, dt), ref in single_peft.items():
        tol = TP_ENCODE_TOL[dt]
        rel = rel_max(r0["peft"][(name, dt)]["features"], ref)
        same_ranks = bool(np.array_equal(r0["peft"][(name, dt)]["features"],
                                         r1["peft"][(name, dt)]["features"]))
        peft[f"{name} {dt}"] = dict(rel=rel, ranks_equal=same_ranks,
                                    launches_per_rank=r0["peft"][(name, dt)]["launches"],
                                    encode_ms=r0["peft"][(name, dt)].get("encode_ms"))
        log(f"  model = 2 {name} encode {dt}: rel {rel:.3e} to the unsplit run (tol {tol}), "
            f"ranks equal {same_ranks}, launches a rank {r0['peft'][(name, dt)]['launches']}"
            + (f", {peft[f'{name} {dt}']['encode_ms']:.3f} ms a rank ({PAR_NOTE}; "
               f"{out['card']})" if name == "lora" and dt == "bfloat16" else ""))
        if rel > tol or not same_ranks:
            raise AssertionError(f"the model = 2 {name} encode ({dt}) differs from the unsplit run")
    lora_step = hold_step_grads("f32 LoRA step at model = 2 vs one process", r0["lora_step"],
                                single_lora_step)
    log(f"  f32 LoRA step at model = 2: K1 / K4 launches a rank {r0['lora_step_launches']}")
    (masks, ious), (s_masks, s_ious) = r0["vit_t"], single_vit_t
    vt = dict(iou_max_abs=float(np.abs(ious - s_ious).max()),
              mask_equal_share=float((masks == s_masks).mean()))
    log(f"  meshed vit_t predict at model = 2 (f32, whole on the model axis) vs one process: {vt} "
        f"(tol: iou {VIT_T_IOU_ATOL}, masks > {VIT_T_MASK_SHARE})")
    if vt["iou_max_abs"] > VIT_T_IOU_ATOL or vt["mask_equal_share"] <= VIT_T_MASK_SHARE:
        raise AssertionError("the meshed vit_t predict differs from one process")
    # the multi-process precompute
    mh_rel = max(rel_max(r0["multihost"][t], single_tiled[t]) for t in single_tiled)
    mh_bitwise = all(np.array_equal(r0["multihost"][t], single_tiled[t]) for t in single_tiled)
    stamps = [r0["stamps"], r1["stamps"]]
    log(f"  multi-process precompute: rel {mh_rel:.3e} (bitwise {mh_bitwise}), signature "
        f"stamped {stamps} times by rank, {r0['multihost_s']:.3f} s ({PAR_NOTE})")
    if mh_rel > 3e-2 or stamps != [1, 0] or set(r0["multihost"]) != set(single_tiled):
        raise AssertionError("the multi-process precompute differs from the single process")
    log(f"  data = 2 bf16 steps at train_sam's defaults: rank 0 {r0['timed']}, rank 1 "
        f"{r1['timed']} ({PAR_NOTE})")
    out["gloo"] = dict(
        tiled=dict(rel=tiled_rel, seconds=r0["tiled_s"], launches_rank0=r0["tiled_launches"]),
        amg=amg, model2_encode=tp,
        f32_step={k: dict(worst_grad_rel=v[0], loss_rel=v[1]) for k, v in steps.items()},
        derived=derived, joint_step_ms=joint_ms, peft_model2_encode=peft,
        lora_step_model2=dict(worst_grad_rel=lora_step[0], loss_rel=lora_step[1],
                              launches_per_rank=r0["lora_step_launches"]),
        vit_t_model2=vt,
        timed_steps=[r0["timed"], r1["timed"]],
        multihost=dict(rel=mh_rel, bitwise=mh_bitwise, stamps=stamps,
                       seconds=r0["multihost_s"]))
    log("  the gemm at vit_b's model = 2 shapes (bf16) against its plain version")
    out["gemm_model2"] = gemm_sweep("vit_b model=2", TP_GEMM_SHAPES)
    return out


def parallel_phase_alone(root):
    """``--phase 18``: phase 18 alone after the build, its numbers on one line
    (and no result lines: the run checks one phase, not the port)."""
    from micro_sam_tpu_torch.ops.gemm import gemm
    from micro_sam_tpu_torch.ops.layernorm import layernorm
    from micro_sam_tpu_torch.ops.relpos_attention import relpos_attention
    counters = {"layernorm": layernorm, "gemm": gemm, "relpos_attention": relpos_attention}
    t18 = time.perf_counter()
    p18 = parallel_phase(counters, root)
    p18["wall_s"] = time.perf_counter() - t18
    log(json.dumps({"multi_gpu": p18}))
    log(f"phase 18 (multi-GPU execution) alone: {p18['wall_s']:.1f} s ({PAR_NOTE})")
    return 0


def add_tp_launches(rows, p18):
    """Phase 18's per-rank launches of the model = 2 vit_b encode (bf16) on
    the kernels line."""
    launches = p18["gloo"]["model2_encode"]["bfloat16"]["launches_per_rank"]
    for r in rows:
        if r["name"] in launches:
            r["launches_tp_vit_b_encode"] = launches[r["name"]]


T_START = time.perf_counter()


def main():
    alone = sys.argv[1:] == ["--phase", "18"]
    if sys.argv[1:] and not alone:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}; run it with none, or with "
              f"--phase 18 for phase 18 alone", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU.",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from micro_sam_tpu_torch.ops import _cuda

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
    for n in _cuda.SOURCES:  # each kernel's registers and any spill or stack frame
        path = os.path.join(_cuda.build_dir(), f"{n}.log")
        if os.path.exists(path):
            entry = ""
            with open(path) as f:
                for line in f:
                    if "Compiling entry function" in line:
                        entry = line.split("'")[1] if "'" in line else ""
                    elif ("registers" in line or "bytes stack frame" in line and
                          " 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
                          not in line):
                        log(f"  ptxas {n} {entry}: {line.strip()}")
                    elif "warn" in line.lower():
                        log(f"  ptxas {n} {entry}: {line.strip()}")
    sass_check("gemm", "wgmma", ("HGMMA", "UTMALDG"))  # the bf16 kernels
    sass_check("dwconv", "dwconv_tma_kernel", ("UTMALDG",))
    sass_check("tiny_attention", "tiny_attention_tma_kernel", ("UTMALDG",))
    sass_check("layernorm", "layernorm_vec_kernel", ())

    # the profiler's first sessions in a process are the ones seen to record
    # nothing: take them on a throwaway measurement
    time_ms(lambda: torch.ones(1024, device="cuda").add_(1), iters=2, warmup=1)
    if alone:
        return parallel_phase_alone(root)

    # CPU references of later phases run beside the card's work in these
    # processes: phase 4's f32 encode from here, phase 12's decoders from phase 9
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    early = ProcessPoolExecutor(3, mp_context=multiprocessing.get_context("spawn"))
    try:
        return run_phases(root, card, early)
    finally:
        early.shutdown(cancel_futures=True)


def run_phases(root, card, early):
    """Phases 3-18 and the result lines; ``early`` runs CPU references
    ahead of the phases that read them."""
    from micro_sam_tpu_torch.ops.dwconv import dwconv
    from micro_sam_tpu_torch.ops.gemm import gemm
    from micro_sam_tpu_torch.ops.layernorm import layernorm
    from micro_sam_tpu_torch.ops.relpos_attention import (relpos_attention,
                                                          relpos_attention_backward,
                                                          relpos_attention_spatial)
    from micro_sam_tpu_torch.ops.tiny_attention import tiny_attention
    vit_b_cpu_ref = early.submit(cpu_reference_encode, root, "vit_b", EARLY_CPU_THREADS)
    # phase 3: kernels vs plain
    t3 = time.perf_counter()
    log("kernels vs plain versions (bf16: plain in f32 on the same bf16 inputs)")
    counters = {"layernorm": layernorm, "gemm": gemm, "relpos_attention": relpos_attention,
                "dwconv": dwconv, "tiny_attention": tiny_attention}
    shapes, chains = kernel_phase(counters)
    log("layernorm at every shape of the vit_b encode and K9's grid mode (bf16) against "
        "F.layer_norm")
    for m in ("vit_b", "vit_b K9", "vit_b K9 4-tile batch"):
        shapes["layernorm"] += layernorm_sweep(m)
    host = {"gemm": host_us("gemm"), "layernorm": host_us("layernorm")}
    log(f"phase 3 (kernels vs plain): {time.perf_counter() - t3:.1f} s")
    t4 = time.perf_counter()
    log("main path: vit_b, 1024^2, random weights (seed 0), bf16")
    launches, per_encode, e2e = main_path_phase(counters, cpu_ref=vit_b_cpu_ref)
    torch.cuda.empty_cache()
    log(f"phase 4 (the vit_b main path): {time.perf_counter() - t4:.1f} s")

    # phase 5: the backward kernel vs plain
    t5 = time.perf_counter()
    log("backward kernel vs plain backward (bf16: within 3e-2 of the f32 plain result)")
    with torch.enable_grad():
        bwd_rows = backward_phase()
    log("K1 and K4 on grids beyond one key rectangle (bf16, sampled rows against the plain "
        "version)")
    large_fwd, large_bwd = large_grid_phase()
    shapes["relpos_attention"] += large_fwd
    bwd_rows += large_bwd
    log(f"phase 5 (the backward kernel, large grids): {time.perf_counter() - t5:.1f} s")
    # phase 6: finetuning
    t6 = time.perf_counter()
    log("training path: train_sam / SamTrainer, vit_b, 512^2 patches -> 1024^2, bf16 compute")
    counters["relpos_attention_backward"] = relpos_attention_backward
    train_launches, k4, training = training_phase(counters, root)
    torch.cuda.empty_cache()
    log(f"phase 6 (vit_b finetuning): {time.perf_counter() - t6:.1f} s")
    # phase 7: vit_t
    t7 = time.perf_counter()
    log("vit_t kernels and chains vs plain versions (bf16: plain in f32 on the same bf16 inputs)")
    tiny_shapes, tiny_chains = tiny_kernel_phase(counters)
    log("dwconv at every depthwise shape of the vit_t encode (bf16) against cuDNN")
    tiny_shapes["dwconv"] += dwconv_sweep()
    log("gemm at every distinct product of the vit_t encode (bf16)")
    tiny_shapes["gemm"] += gemm_sweep("vit_t")
    log("layernorm at every shape of the vit_t encode, tiny_attention at its three stages "
        "(bf16) against F.layer_norm and SDPA")
    tiny_shapes["layernorm"] = layernorm_sweep("vit_t")
    tiny_shapes["tiny_attention"] += tiny_attention_sweep()
    host["tiny_attention"] = host_us("tiny_attention")
    log("main path: vit_t, 1024^2, random weights (seed 0), bf16")
    t_launches, t_per_encode, t_e2e = main_path_phase(counters, "vit_t", chains=TINY_CHAINS)
    tiny = dict(shapes=tiny_shapes, chains=tiny_chains, launches=t_launches,
                per_encode=t_per_encode)
    torch.cuda.empty_cache()
    log(f"phase 7 (vit_t): {time.perf_counter() - t7:.1f} s")
    # phase 8: vit_h / vit_l
    t8 = time.perf_counter()
    log(f"vit_h kernels (head dim {1280 // 16}; relpos_attention also at vit_l's 16 heads of "
        f"64) and attention halves (K10, K5) vs plain versions (bf16: plain in f32 on the "
        f"same bf16 inputs)")
    lh_shapes, lh_chains = kernel_phase(counters, width=1280, heads=16, halves=True,
                                        attn_heads=((16, 64),))
    log("gemm at every distinct product of the vit_l encode (bf16)")
    lh_shapes["gemm"] += gemm_sweep("vit_l")
    log("layernorm at every shape of the vit_h and vit_l encodes and vit_h's K9 (bf16)")
    for m in ("vit_h", "vit_l", "vit_h K9"):
        lh_shapes["layernorm"] += layernorm_sweep(m)
    lh = dict(shapes=lh_shapes, chains=lh_chains)
    for model_type in ("vit_h", "vit_l"):
        log(f"main path: {model_type}, 1024^2, random weights (seed 0), bf16")
        m_launches, m_per_encode, m_e2e = main_path_phase(counters, model_type,
                                                          chains=VIT_CHAINS, reference="card")
        lh[model_type] = dict(launches=m_launches, per_encode=m_per_encode, end_to_end=m_e2e)
        torch.cuda.empty_cache()
    log(f"phase 8 (vit_h / vit_l): {time.perf_counter() - t8:.1f} s")
    # phase 9: vit_h / vit_l finetuning
    t9 = time.perf_counter()
    decoder_refs = start_decoder_references(early, root)
    log("finetuning at vit_h / vit_l width: K4 at head dim 80, K12, the A100 preset (vit_h), "
        "timed vit_h and vit_l steps, bf16 compute")
    ft = finetuning_phase(counters, root)
    log(f"phase 9 (vit_h / vit_l finetuning): {time.perf_counter() - t9:.1f} s")
    # phase 10: the head-dim sweep, K9 / K11, tiled precompute through the routes
    t10 = time.perf_counter()
    log("tiled precompute on vit_b through the default, K9 (spatial window) and K11 (window "
        "stack) routes; rel-pos attention at head dims 16-256; K9 / K11 vs plain and K2")
    counters["relpos_attention_spatial"] = relpos_attention_spatial
    p10 = tiled_phase(counters, root)
    log(f"phase 10 (tiled precompute, K9 / K11, head dims): {time.perf_counter() - t10:.1f} s")
    # phase 11: the prompt layer and AMG
    t11 = time.perf_counter()
    log("the prompt layer and AMG: segment_from_*, batched and tiled inference, "
        "AutomaticMaskGenerator and its tiled form (vit_b, bf16), the trained fixture's AMG "
        "(f32) on the card against the CPU")
    p11 = amg_phase(counters, root, p10)
    p11["wall_s"] = time.perf_counter() - t11
    log(f"phase 11 (the prompt layer and AMG): {p11['wall_s']:.1f} s")
    # phase 12: decoder-based instance segmentation
    t12 = time.perf_counter()
    log("decoder-based instance segmentation: the UNETR decoder on the card against the CPU, "
        "AIS and APG, their tiled forms, automatic_instance_segmentation and cache_amg_state "
        "(vit_b, bf16)")
    p12 = ais_phase(counters, root, p10, decoder_refs)
    p12["wall_s"] = time.perf_counter() - t12
    log(f"phase 12 (decoder-based instance segmentation): {p12['wall_s']:.1f} s")
    # phase 13: multi-dimensional segmentation and tracking
    t13 = time.perf_counter()
    log("multi-dimensional segmentation and tracking: segment_mask_in_volume, automatic 3d "
        "segmentation (AIS, tiled and untiled), the 3d merge, the greedy, learned and auto "
        "trackers, automatic_tracking (vit_b, bf16); the trained fixture's projection (f32) "
        "on the card against the CPU")
    p13 = multi_dim_phase(counters, root)
    p13["wall_s"] = time.perf_counter() - t13
    log(f"phase 13 (multi-dimensional segmentation and tracking): {p13['wall_s']:.1f} s")
    # phase 14: joint finetuning and the other trainers
    t14 = time.perf_counter()
    log("joint finetuning and the other trainers: train_sam at its default (SAM and the UNETR "
        "decoder), its exports into AIS, timed joint steps, the f32 decoder step against the "
        "CPU, train_instance_segmentation, the A100 preset with the decoder, SimpleSamTrainer / "
        "MedSAMTrainer / SemanticSamTrainer, export_custom_sam_model / save_native_checkpoint")
    p14 = joint_phase(counters, root)
    p14["wall_s"] = time.perf_counter() - t14
    log(f"phase 14 (joint finetuning and the other trainers): {p14['wall_s']:.1f} s")
    # phase 15: PEFT, QLoRA, the 3d wrappers, vit_t finetuning
    t15 = time.perf_counter()
    log("PEFT and the 3d wrappers: LoRA serving (vit_b) against the CPU, train_sam with LoRA and "
        "QLoRA, the QLoRA export, get_predictor_and_decoder with PEFT, vit_t finetuning (the "
        "Minimal preset), Sam3DWrapper / SimpleSam3DWrapper on 8 slices (bf16)")
    p15 = peft_phase(counters, root)
    p15["wall_s"] = time.perf_counter() - t15
    log(f"phase 15 (PEFT, the 3d wrappers, vit_t finetuning): {p15['wall_s']:.1f} s")
    # phase 16: evaluation
    t16 = time.perf_counter()
    log("evaluation: precompute_all_embeddings, iterative prompting, the AIS and AMG grid "
        "searches, segment_slices_from_ground_truth, object features and the PCA projection "
        "(vit_b, bf16); the trained fixture (f32) on the card against the CPU")
    p16 = eval_phase(counters, root)
    p16["wall_s"] = time.perf_counter() - t16
    log(f"phase 16 (evaluation): {p16['wall_s']:.1f} s")
    # phase 17: the annotators and model export
    t17 = time.perf_counter()
    log("the annotators and model export: annotator_2d (initialize, key presses, commit), "
        "SegmentNDWidget, track_from_prompts, AutoSegmentWidget (AIS), the image-series "
        "precompute (vit_b, bf16); the bioimage.io package, the TorchScript encoder and the "
        "ONNX decoder (vit_b, f32); the trained fixture's clicks (f32) on the card against the "
        "CPU")
    p17 = annotator_phase(counters, root)
    p17["wall_s"] = time.perf_counter() - t17
    log(f"phase 17 (the annotators and model export): {p17['wall_s']:.1f} s")
    # phase 18: multi-GPU execution
    t18 = time.perf_counter()
    log(f"multi-GPU execution: an NCCL world of one (vit_b, bf16) against the unmeshed "
        f"predictor; a gloo world of {PAR_RANKS} ranks on the one card: data = 2 (tiled "
        f"precompute, the fixture's AMG, bf16 steps), model = 2 (encodes, split gemm shapes), "
        f"f32 steps, the multi-process precompute, against one process; {card}")
    p18 = parallel_phase(counters, root)
    p18["wall_s"] = time.perf_counter() - t18
    log(f"phase 18 (multi-GPU execution): {p18['wall_s']:.1f} s ({PAR_NOTE})")
    log(f"chip_smoke: phases 1-18 in {time.perf_counter() - T_START:.1f} s of wall time")
    rows = summarize(shapes, launches, per_encode, bwd_rows, train_launches, k4, tiny, lh, ft,
                     host)
    rows += summarize_tiled(p10)
    add_peft_launches(rows, p15)
    add_tp_launches(rows, p18)
    # the details first, then the kernels line, short: one entry per kernel
    # and chain with the keys of the contract
    log(json.dumps({"details": {"kernels": rows, "chains": chains + lh_chains, "card": card,
                                "end_to_end": e2e, "end_to_end_vit_t": t_e2e,
                                "end_to_end_vit_h": lh["vit_h"]["end_to_end"],
                                "end_to_end_vit_l": lh["vit_l"]["end_to_end"],
                                "vit_h_chains": lh["vit_h"]["per_encode"]["chains"],
                                "vit_l_chains": lh["vit_l"]["per_encode"]["chains"],
                                "training": training,
                                "training_vit_h": ft["vit_h"]["training"],
                                "training_vit_l": ft["vit_l"]["training"],
                                "tiled": {k: p10[k] for k in ("routes", "cache", "vit_h_k9",
                                                             "costs", "replays")},
                                "amg": p11, "ais": p12, "multi_dim": p13, "joint": p14,
                                "peft": p15, "evaluation": p16, "annotator": p17,
                                "multi_gpu": p18}}))
    log(json.dumps({"kernels": [{k: r[k] for k in KERNEL_KEYS + ("variants", "stages", "head_dims",
                                                                  "plans",
                                                                  "launches_tp_vit_b_encode")
                                  if k in r}
                                for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
