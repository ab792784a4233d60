"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold each of its
kernels against its plain PyTorch version.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure exits nonzero and prints no result):
1. build the eleven kernel sources in ``gaussian_splatting_tpu_torch/csrc/`` with
   nvcc for sm_90a (one process per source, all at once) and print each
   kernel's registers and spills;
2. the bench scene of ``bench.py`` (numpy seed 0, 1M screen-space
   gaussians, 1920x1080, dense binning, chunk 256): intersection counts
   against the JAX package's recorded ones and, gaussian by gaussian,
   against the same binning on the host CPU; the pack kernel against its
   plain version on the sort's own gid, with ``n_live`` (the binning's SoA,
   zero past n_isect) and gathering every column, and the forward kernel
   on that SoA equal to the forward on the full-gather plain SoA bit for
   bit and within its tolerance of its plain version, and the raster
   kernels' warp cull through its plain mirror (no contributing pair
   culled, some culled; also at render view 0 and training view 0); then
   the backward:
   ``bwd_tiles`` + the kernel reduce against ``bwd_tiles_plain`` + the
   plain reduce under a seeded cotangent, and ``pack_rows`` (10 and 11
   rows) and ``segsum`` (``n_rows`` 16 and 10) against their plain versions
   on the kernel's gradient stream; then the queue path: the
   queue forward equal to the loop forward bit for bit, the queue backward
   + reduce against the plain versions, and the ``bench.py`` forward +
   backward workload with ``queue=True`` (the queue kernels must launch,
   the loop kernels not) beside ``queue=False``, with equal occupancy
   probes;
2c. the ``bench.py`` workload as the JAX package runs it: compact class
   budgets (1.05 headroom, squeezed under a power of two), the gradient
   buffer sized to the measured occupancy + 8 %, ``reduce_slices`` 4; its
   slot count, budget drops, gradient-stream occupancy and
   ``grad_buffer_frac`` against ``BENCH_r05.json``, and its forward +
   backward time beside the dense one, in turns;
3. a small 3D scene rendered through the kernels and through the PyTorch
   oracle, which must agree, images and gradients of every parameter;
3b. the raster kernels at tile sizes 8, 16 and 32 on adversarial entries
   for the warp cull (near-singular conics, alpha just above 1/255 at a
   pixel, entries never to be skipped): one entry a tile, where a wrongly
   skipped pair would cost at least 1/255, and 48 a tile over two chunks,
   the forward against its plain version, the queue forward equal to the
   loop forward bit for bit, the backward + reduce against the plain ones;
4. the render path: a seeded 3D scene of 1,000,000 gaussians with SH
   degree 3 loaded with ``state_from_numpy``, rendered at 1920x1080 from 4
   ``look_at`` views by ``GaussianRasterizer(backend="auto")``; both of its
   kernels' launch counts must rise during that run, and both must equal
   their plain versions on its view 0;
5. the training path: 6 steps of ``make_train_step`` (``TrainingConfig()``
   defaults, backend "auto", the dense binning) with batches of the same 4
   views at 1920x1080, from that scene with seeded noise on means,
   features_dc and logit opacities, towards the scene's own renders; the
   loss must descend, everything stay finite, no gradient be dropped, and
   every kernel of the path launch during the steps;
5b. the bucket path at training view 0: the fused partition kernel
   (``bucket_partition``) against its plain version on the view's slots
   (key, gid, counts and drops exact), the bucket binning's n_isect +
   n_bucket_dropped equal to the dense n_isect and, with no bucket drop,
   its forward equal to the dense one bit for bit and its backward +
   reduce against the dense plain sums and meta;
   then 4 steps of ``make_train_step(TrainingConfig(sort_buckets=8))``
   from the same noisy state: the loss must descend and the partition
   launch once a view in every step;
5c. the compact layout at training view 0 with the budgets the trainer
   chooses (``GaussianTrainer._choose_class_budgets``, the per-class
   maximum over the batch's 4 views, each measured alone): counts equal to the
   dense binning's with no budget drop, ``pack_soa`` on the compact gid
   exact, the forward equal to the dense one, the backward + reduce within
   the backward's gates of the dense plain sums; compact + sort_buckets 8:
   the partition with ``slot_gid`` exact against its plain version, no
   bucket intersection lost, the forward equal to the compact flat one;
5d. 4 steps of ``make_train_step`` from phase 5's noisy starting state
   with the budgets the trainer chooses for that state (the same per-class
   maximum): the loss must descend, no gradient entry be dropped, no
   budget entry at step 0 and at most 1 % of n_isect (the trainer's
   rebudget threshold) at the later steps;
6. at training view 0, the entries per tile (max, p50, p99, the share in
   the largest 1 % of tiles), then timings with CUDA events (medians) at
   the main paths' shapes: render,
   training step (dense and bucket), one view's forward + backward, the
   ``bench.py`` forward + backward workload (loop and queue), binning
   (dense and bucket, with the peak memory of one call of each; the
   removed bucket path's key passes timed on tensors of their shapes),
   and each kernel against its bound, its plain
   version and, where there is one, a PyTorch library call (the two pack
   kernels also against an ``index_select`` moving the same bytes and
   against writing their output's zeros, in each of their uses); the
   raster kernels' bound counts the operations of the pairs that carry
   anything, and the operations of every pair evaluated without the cull
   go beside it as ``bound_unculled_ms``;
7. one render and one training step traced with ``torch.profiler``: device
   kernels launched, the device's busy and idle share, the kernels taking
   most time;
8. the trainer through its entry point, ``GaussianTrainer(cfg,
   device).train`` (``trainer_phase``): 8 views of the clean scene at
   1920x1080, 333,333 of its means as points (1M gaussians), binning
   "auto", initial opacity 0.1, batch 4, 40 iterations with densify,
   an opacity reset after the last step, validation and the grad-buffer probe:
   falling finite losses, no budget drop over the trainer's rebudget
   threshold (1 % of n_isect) at a logged iteration after the last
   rebudget, the grad-buffer probe logged and never failing, ``final.npz``
   reloading to the same render bit for bit, ``final.ply`` with the alive
   rows, the native kNN used, the five kernels of the path launched; the
   median iteration time over the iterations under that threshold, each
   event's time and the peak memory;
9. the user journey through the port's CLIs (``cli_phase``):
   ``tests/synthetic_video.py`` writes a 48-frame clip at 1920x1080;
   ``train_cli.main`` runs SfM on it and trains 30 iterations of batch 4
   from 1M gaussians with the trainer's compact budgets; ``eval_cli.main``
   scores 4 views of ``final.npz`` with 10 steps of pose alignment, then of
   ``final.ply``: exit codes, SfM poses and points, n_alive at init, the
   files, falling finite losses, the views, PNGs and metrics, the aligned
   PSNR not below the raw one, the checkpoint's budgets in the eval's
   render settings, the five kernels launched in each CLI; the stage
   times, the budget drops at each log (reported, not gated: the CLI starts
   at opacity 0.005) and the peak memory;
10. the mesh (``mesh_phase``): min(card count, 4) ranks, 1 -> a 1x1 mesh in
   this process, 2-3 -> 1x2, 4 -> 2x2 (one spawned process a card), over
   NCCL (the backend and world size are printed). The sharded step
   (``parallel.make_sharded_train_step``) at 1M gaussians, 1920x1080,
   batch 4, backend auto, from phase 5's noisy state, 6 steps dense and 6
   with the trainer's compact budgets, each in turns with
   ``make_train_step`` from the same state: after step 1 the loss within
   rtol 2e-6, L1 within rtol 1e-5, the four stats equal and the parameters
   within 1e-5 under the sign-flip rule; losses falling, nothing
   non-finite, no gradient entry dropped; each step's collectives counted,
   the collectives' device time in one step (NCCL's device ranges,
   ``torch.profiler``) and the kernels whose time differs most, the
   median step times (CUDA events) and the peak memory of a step beside
   the single-device step's; the five kernels of the path must launch in
   the sharded steps. Then ``GaussianTrainer(cfg, mesh=...)`` for 20
   iterations at 1M gaussians, batch 4, initial opacity 0.1, one densify
   event (iteration 15), validation and the grad-buffer probe at 20:
   falling finite losses, ``final.npz`` written once (by rank 0) and
   reloading equal to the gathered state, the five kernels launched; its
   median iteration time beside phase 8's;
11. the binning modes (``binning_modes_phase``, run before phase 8; alone:
   ``modes_alone``) at training view 0 and on the training path, 1M
   gaussians at 1920x1080: ``depth_bits=16`` on the dense layout (tables
   and n_isect equal to the exact key's, kernels #1-#5 against their plain
   versions on its layout, the forward equal to the exact key's bit for bit
   in every tile where no two depths share a level, the binning and
   ``torch.sort`` of each key timed in turns, 6 steps beside the dense
   step in turns); ``sort_bands`` 2 and 4 on compact budgets covering the
   heaviest band (``band_budgets``), at a tile cap where nothing drops:
   tables equal to the flat compact binning's, kernels #1-#5 against their
   plain versions on the band layout (the pack on its gid with the
   sentinel runs inside the stream), the forward within 1e-6 of the flat
   one, at K = 4 the queue kernels #6-#7 against theirs at the K-scaled
   ``w_cap`` and one ``queue=True`` forward + backward through
   ``rasterize_tiled``, slots, binning time in turns and peak memory
   beside the flat compact binning; dense bands at K = 2 the same way; then
   4 steps with ``sort_bands=4`` beside the flat compact step in turns.
   Kernels #1-#7 must launch through the entry points of the phase.
12. the settings the port used to refuse (``wide_settings_phase``, run after
   phase 11; alone: ``wide_alone``) at training view 0 and on the render and
   training paths, 1M gaussians at 1920x1080: the bucket binning at
   ``sort_buckets`` 64 (more buckets than a warp has lanes) and 2048 (quantum
   1, a window of 4C) at the default headroom, the partition against its
   plain version (key, gid, counts and drops exact), kept + dropped equal to
   the dense n_isect, and the forward and the backward + reduce against
   their plain versions on that bucket layout; at 64 with headroom 4 (no
   drop) the forward equal to the dense one bit for bit; the raster chunks
   2048 and 8192 (staged 256 entries at a time) on the dense layout,
   kernels #1-#7 against their plain versions there (n_written and
   n_dropped equal, the queue forward equal to the loop forward bit for
   bit); each of those kernels timed in turns with the old setting (B 8,
   chunk 256); one chunk-2048 ``render``, a loop and a queue forward +
   backward through ``rasterize_tiled`` at chunk 2048, and 4 steps each of
   ``make_train_step`` with ``sort_buckets=64`` and with
   ``raster_chunk=2048`` in turns with dense steps (falling finite losses,
   no gradient entry dropped), every kernel launched; then deep tiles (``deep_tiles_phase``):
   3,000 entries a tile at tile sizes 8, 16 and 32 whose pixels stop inside
   the first stage of the first chunk, at chunk 2048 and 8192, against the
   plain versions, nothing blended after the stop within a chunk.
   ``parent_alone(DIR)`` holds the old settings' kernels of another
   checkout against this one's, outputs and times in turns.
13. the projection + SH kernel pair (``project_sh_phase``, after phase 12;
   alone: ``project_sh_alone``) at the shapes of the benchmark's three
   cells (1.5M slots at 1920x1080, 4.665M at 1297x840, a third of them
   dead; SH 3, one view; the viewer's cell forward only): the forward's
   outputs within 1e-5 of their plain version's largest magnitude and radii
   equal but for 1 slot in 1e5, by one pixel at most; the backward's
   gradients under seeded cotangents on the visible slots within 1e-4 of
   each leaf's largest plain magnitude; the times of the pair, of each
   kernel alone, of the plain version and of autograd through the plain
   code (the parent's path), the byte bound and the peak memory; every
   other SH degree (0-2 over the K = 16 buffer) and the antialiased mode,
   forward and backward at the first cell's shapes under the same gates;
   and through phases 4 and 5, the forward launched once a render and the
   pair once a training view, no view on the autograd path.
14. Deformable 3D Gaussians (``deform_phase``, after phase 13; alone:
   ``deform_alone``): the pair's deforming instance at the 1080p trainer
   cell's shapes under seeded offsets, against its plain version under
   phase 13's gates with no radius differing, timed beside the static
   instance; the deformation MLP (8 x 256) over 1M rows forward and
   forward + backward, its TFLOP/s, peak memory and the offsets' error with
   TF32 on.
15. the binning's slot enumeration (``bin_slots_phase``, after phase 14;
   alone: ``bin_slots_alone``), the kernel pair of ``csrc/bin_slots.cu`` at
   the cells' shapes (``BIN_SLOTS_CASES``: 1M gaussians dense at max_t 16,
   1920x1080; the 1.5M-slot buffer compact at max_t 32 with the deformable
   cell's budgets; the 4.665M-slot buffer compact at 1297x840, max_t 8):
   keys, gids and counters bit for bit against the plain version on the
   card, then ``isect_and_sort`` in every mode (flat, bands 2 and 3,
   buckets 8 and 64, depth_bits 16) through the pair and through the plain
   version, every output bit for bit, two launches a view (2K with K
   bands); each kernel's time beside its bytes bound and the plain chain's;
   and through phases 4 and 5, the pair launched once a render and once a
   training view.
16. Adam as one kernel (``adam_phase``, after phase 15; alone:
   ``adam_alone``), ``csrc/adam.cu`` through ``optimizer.adam_multi`` at
   the cells' buffers (``ADAM_CASES``: the six groups at 1.5M and 4.665M
   slots, 59 floats a slot; the deformation network's 22 tensors): three
   steps bit for bit against the plain ``adam_step`` on the card, with
   nonzero moments, zero gradient rows and a NaN row, one launch a step;
   the kernel's time alone beside its bytes bound (28 B an element), the
   plain loop's and their peak memory; no launch for CPU tensors; and
   through phases 5 and 8, one launch a training step.

17. 2D Gaussian Splatting (``surfel_phase``, after phase 16; alone:
   ``surfel_alone``): phase 5's scene as surfels (its first two scales) at
   a 1080p view: the projection pair (``gs_project_surfel_fwd`` / ``_bwd``
   of ``csrc/project_sh.cu``) against its plain version, radii bit for
   bit, the rest within 1e-5 of each output's largest magnitude, the
   gradients within 1e-4; the raster pair (``csrc/rasterize_surfel.cu``)
   against its plain version on the compact binning, chunk 256: the stop
   decisions and median depths bit for bit, the maps within 1e-5 (the
   distortion 1e-5 of the largest M2, the size of the terms it cancels
   from), the reduced gradients within 1e-4; each kernel's time alone;
   then ``TRAIN_STEPS`` steps of ``make_train_step`` with surfels at batch
   4 (both regularizers on): finite, descending losses, no gradient entry
   dropped, one projection pair and one raster pair launched a view, the
   step's time and peak memory.

Output: the kernels JSON line (phase 13's numbers under ``project_sh``,
phase 14's under ``project_sh.deform``, phase 15's under ``bin_slots``,
phase 16's under ``adam``, phase 17's under ``surfel``;
each row also with ``kernel_ms``, the kernel's profiler time,
``trainer_launches``, its launches in phase 8,
``train_cli_launches`` / ``eval_cli_launches``, in phase 9's two calls,
``mesh_launches``, in phase 10's sharded steps and trainer, and
``binning_modes_launches`` / ``binning_modes_max_abs_err``, its launches
through phase 11's entry points and its largest error against its plain
version on phase 11's layouts, and for the raster kernels and the
partition ``wide_settings``: phase 12's ms, largest error and bound at each
new setting, with ``old_setting_ms_in_turns`` beside them, and
``wide_launches``, its launches through phase 12's entry points),
the card's name and power limit (``nvidia-smi``), then ``{"ok": true,
"device": {...}}`` as the last line.
"""

import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np

WIDTH, HEIGHT, TILE, CHUNK, MAX_T = 1920, 1080, 16, 256, 16
N_GAUSSIANS = 1_000_000
TRAIN_STEPS = 6
# The bucket path: sort_buckets 8 at the default partition headroom 1.5
# (quantum 96 of a 512-slot chunk's mean share 64 per bucket).
BUCKETS, BUCKET_HEADROOM, BUCKET_STEPS = 8, 1.5, 4
# Phase 11, the binning modes: the quantized depth key's width and the
# image tolerance of tests/test_rasterize_pallas.py:398-420 against the
# exact key (reported: at 1M gaussians two overlapping depths often share
# a level, and the gate is equality in the tiles where none do); the band counts binned at training view 0 on compact budgets
# (dense bands at the first only) and trained BAND_STEPS steps at the last.
DEPTH_BITS, DEPTH_BITS_IMAGE_ATOL = 16, 2e-3
BANDS, BAND_STEPS = (2, 4), 4
# Phase 12, the settings the port used to refuse: the bucket counts above a
# warp's 32 lanes, the chunks above the 1024 entries the kernels stage whole,
# the steps at each, and the entries a tile of its deep tiles.
WIDE_BUCKETS, WIDE_CHUNKS, WIDE_STEPS, DEEP_PER_TILE = (64, 2048), (2048, 8192), 4, 3000
# The cube [-1, 1]^3 the seeded scene fills: the trainer's scene extent.
SCENE_EXTENT = 2.0
# Intersection counts of the bench scene recorded by the JAX package
# (BENCH_r05.json: n_isect, n_tile_overflow_dropped); hardware-independent.
BENCH_N_ISECT, BENCH_N_DROPPED = 3_779_268, 2_290
COUNT_RTOL = 1e-4
# The bench scene's compact binning in the JAX package (BENCH_r05.json:
# n_sort_slots, n_grad_written, grad_buffer_frac); hardware-independent up
# to the n_isect -1 above (one chunk of the gradient stream).
BENCH_N_SORT_SLOTS, BENCH_N_GRAD_WRITTEN, BENCH_GRAD_FRAC = 4_717_952, 3_779_328, 0.8651
# The trainer phase: 8 views at full size, ~334k of the scene's means as
# its points (n_init = initial_gaussians = 1M), batch 4.
TRAINER_VIEWS, TRAINER_POINTS, TRAINER_ITERS = 8, 333_333, 40
# The trainer's initial opacity in that phase, the original 3DGS paper's.
# Near the default 0.005 a footprint's cutoff 2 ln(255 op) is close to 0,
# so the first Adam steps on the opacities grow the footprints past any
# budget headroom, and the watchdog's 500-iteration cooldown allows one
# rebudget in the run. From 0.1 the footprints drift slowly enough that
# the one rebudget (near iteration 26) holds to the end. An opacity reset
# puts every opacity back near 0.01, in the fast regime, and needs a
# rebudget of its own: the phase resets after its last step (the
# validation, the probe and the saved state see the reset).
TRAINER_INIT_OPACITY = 0.1
TRAINER_RESET_EVERY = TRAINER_ITERS
# The trainer's rebudget threshold: budget drops above this share of n_isect.
BUDGET_DROP_FRAC = 0.01
# Phase 10, the mesh: MESH_STEPS sharded steps each dense and with the
# trainer's compact budgets, beside make_train_step; the trainer on the mesh
# for MESH_TRAINER_ITERS iterations with one densify event. Tolerances of
# the sharded step against one device after step 1, as
# tests/test_parallel.py:82-91 (loss, L1; parameters under the sign-flip
# rule of tests/test_torch_training.py).
MESH_STEPS, MESH_TRAINER_ITERS, MESH_DENSIFY_AT = 6, 20, 15
MESH_LOSS_RTOL, MESH_L1_RTOL, MESH_PARAM_ATOL = 2e-6, 1e-5, 1e-5
# The CLI journey (phase 9): tests/synthetic_video.py's clip at full size,
# SfM at stride 4, the train CLI at 1M gaussians (max_gaussians >= 2M, so
# n_init = min(max(3 x points, initial), max / 2) reaches it), batch 4, then
# the eval CLI on 4 views, 10 alignment steps a view.
CLI_FRAMES, CLI_STRIDE, CLI_ITERS = 48, 4, 30
CLI_GAUSSIANS, CLI_MAX_GAUSSIANS = 1_000_000, 3_000_000
CLI_EVAL_VIEWS, CLI_ALIGN_STEPS = 4, 10
# The bench scene's per-gaussian slot counts from the dense binning on a
# CPU (int8, gaussian order), the same with the JAX package and the port:
# 3,779,267 in all. Rounding decides three of them: 288106 and 431192
# change when the binning runs in float64 (4 -> 3, 6 -> 7), and 155272
# gains a tile (4 -> 5, total 3,779,268) when the gate threshold
# Q = 2 (ln(255 op) + 1e-3) is 2 ulp larger.
BENCH_CPU_COUNTS_SHA256 = "d15eaf400cb77735e1ad626b0bf8ee742664afdf36fca3a0382ccbe84f96c959"
BENCH_CPU_N_ISECT = 3_779_267
BENCH_BOUNDARY_GAUSSIANS = {155272: 4, 288106: 4, 431192: 6}
# Published H100 SXM peaks: HBM bytes/s and float32 (non-tensor) flop/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# float32 operations per (pixel, entry) pair the forward kernel evaluates:
# dx, dy (2); sigma (9); exp (1, on the SFU) and its negation (1); op * vis
# (1); two gate compares and the clamp (3); 1 - alpha, the running product
# and T_carry * product (3); the stop compare (1); the weight (2); four
# multiply-adds and one add into the accumulators (9) for pairs that count.
FWD_FLOPS_PER_PAIR = 32
# The backward kernel recomputes the forward for every pair it evaluates:
# dx, dy (2), sigma (9), exp and its negation (2), op * vis (1), gates and
# clamp (3), 1 - alpha, product, T_carry * product (3), stop compare (1).
BWD_RECOMPUTE_FLOPS = 23
# ... and for each pair that counts and passes the gate: T_before and w
# (2); gw, four multiply-adds (8); prefix += gw w (2); d_alpha: gw T, Q -
# prefix, 1 - alpha, the divide, the subtract (5); the clamp gate and
# d_sigma (3); dmx and dmy, each -(c dx + c dy) d_sigma (10); dA, dB, dC
# (8); dop (1); dr, dg, db, ddepth (4); the sum over pixels of the ten
# values (10).
BWD_GRAD_FLOPS = 53
# Tolerances of the backward against its plain version (sums over pixels
# and entries in another order, float atomics in the kernel). Per gaussian:
# atol 2e-4 of the largest gradient, rtol 1e-3, as the repo's own gradient
# tests (tests/test_rasterize_pallas.py:182). Per-gaussian gradients are
# heavy-tailed (footprints of a few pixels to 16 tiles, occluded gaussians
# near 0), so an atol tied to the largest can hide errors in the small
# ones; each key is also held in relative L2, ||kernel - plain|| / ||plain||,
# over all gaussians (GRAD_L2_RTOL; float32 reordering gives ~2e-6) and over
# the half with the smallest nonzero |plain| (GRAD_L2_SMALL_RTOL). Many of
# the small ones sit behind opaque layers, where d_alpha's (Q - prefix) is
# the difference of two sums of order 1 and reordering moves it by ~7e-4 of
# itself on the bench scene; a kernel losing some of their terms moves them
# by percents. segsum: each sum is of at most max_t float32 terms, so 1e-5
# of the row's largest value.
GRAD_ATOL_FRAC, GRAD_RTOL = 2e-4, 1e-3
GRAD_L2_RTOL, GRAD_L2_SMALL_RTOL = 1e-4, 5e-3
SEGSUM_ATOL_FRAC = 1e-5
# The raster kernels' alpha gate (raster_common.cuh::kAlphaSkip).
ALPHA_SKIP = np.float32(1.0 / 255.0)
KERNELS = ("pack_soa", "rasterize_fwd", "rasterize_bwd", "pack_rows", "segsum",
           "rasterize_fwd_q", "rasterize_bwd_q", "partition", "project_sh", "bin_slots",
           "adam", "rasterize_surfel")


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps=7, warmup=2):
    """Median device time (ms) of ``fn()`` over ``reps`` launches, each
    bracketed by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_ms(fn, name, reps=10):
    """Median device time (ms) of the kernels whose name holds ``name``
    among those ``fn()`` launches, from ``torch.profiler`` (CUPTI): the
    kernel alone, without the host time of its wrapper."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name]
    if not times:
        fail(f"the profiler saw no kernel named {name}")
    return statistics.median(times) / 1e3


def launch_counters():
    """The launch counters of the eight kernels, of the projection + SH
    pair's two, of the binning's slot pair and of Adam
    (``utils/profiling``), by kernel name."""
    return {k: f"launch.{k}" for k in ("pack_soa", "rasterize_fwd", "rasterize_bwd",
                                        "pack_rows", "segsum", "rasterize_fwd_q",
                                        "rasterize_bwd_q", "partition", "project_sh_fwd",
                                        "project_sh_bwd", "bin_slots", "adam")}


def reset_launches():
    from gaussian_splatting_tpu_torch.utils import profiling

    profiling.reset_counters(*launch_counters().values())


def read_launches():
    from gaussian_splatting_tpu_torch.utils import profiling

    counts = profiling.counters()
    return {k: counts.get(c, 0) for k, c in launch_counters().items()}


def bench_scene(n, width, height):
    """The screen-space scene of ``bench.py`` (numpy seed 0), as float32 /
    int32 numpy arrays (means2d, conics, colors, opacities, depths, radii)."""
    rng = np.random.default_rng(0)
    means2d = rng.uniform([0, 0], [width, height], size=(n, 2))
    sx = rng.lognormal(mean=0.8, sigma=0.5, size=(n,)).clip(0.7, 12.0)
    sy = rng.lognormal(mean=0.8, sigma=0.5, size=(n,)).clip(0.7, 12.0)
    th = rng.uniform(0, np.pi, size=(n,))
    c, s = np.cos(th), np.sin(th)
    a = c * c * sx**2 + s * s * sy**2
    b = c * s * (sx**2 - sy**2)
    d = s * s * sx**2 + c * c * sy**2
    det = a * d - b * b
    conics = np.stack([d / det, -b / det, a / det], 1)
    colors = rng.uniform(size=(n, 3))
    opac = rng.uniform(0.3, 0.9, size=(n,))
    depths = rng.uniform(1, 10, size=(n,))
    radii = np.ceil(3 * np.maximum(sx, sy)).astype(np.int32)
    return tuple(x.astype(np.float32) for x in (means2d, conics, colors, opac, depths)) + (radii,)


def scene_3d(n, seed, scale_range=(0.001, 0.003)):
    """A seeded 3D scene in the cube [-1, 1]^3: random rotations, scales of
    a few pixels at 1080p from distance 3, SH degree 3 (16 bases), as the
    numpy arrays ``state_from_numpy`` takes."""
    rng = np.random.default_rng(seed)
    dc = (rng.uniform(size=(n, 1, 3)) - 0.5) / 0.28209479177387814
    arrays = {
        "means": rng.uniform(-1.0, 1.0, size=(n, 3)),
        "quats": rng.normal(size=(n, 4)),
        "log_scales": np.log(rng.uniform(*scale_range, size=(n, 3))),
        "logit_opacities": rng.normal(0.0, 1.5, size=(n, 1)),
        "features_dc": dc,
        "features_rest": rng.normal(size=(n, 15, 3)) * 0.1,
    }
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def noisy_train_arrays(scene, seed):
    """A training state, as the arrays ``train_state_from_numpy`` takes:
    ``scene`` with seeded noise on means (0.002), features_dc (0.3) and
    logit opacities (0.5), zero Adam moments and accumulators, step 0."""
    rng = np.random.default_rng(seed)
    params = dict(scene)
    params["means"] = scene["means"] + rng.normal(0, 0.002, scene["means"].shape)
    params["features_dc"] = scene["features_dc"] + rng.normal(0, 0.3, scene["features_dc"].shape)
    params["logit_opacities"] = (scene["logit_opacities"]
                                 + rng.normal(0, 0.5, scene["logit_opacities"].shape))
    n = scene["means"].shape[0]
    arrays = {}
    for k, v in params.items():
        v = v.astype(np.float32)
        arrays.update({f"params/{k}": v, f"adam_mu/{k}": np.zeros_like(v),
                       f"adam_nu/{k}": np.zeros_like(v)})
    arrays.update(alive=np.ones(n, bool), xyz_grad_accum=np.zeros((n, 3), np.float32),
                  xyz_grad_count=np.zeros((n, 1), np.float32),
                  max_radii2d=np.zeros(n, np.int32), adam_step=np.int32(0),
                  iteration=np.int32(0))
    return arrays


def view_eyes(k=4, dist=3.0):
    return [(dist * np.sin(a), 0.6, -dist * np.cos(a))
            for a in np.linspace(0.0, 2 * np.pi, k, endpoint=False)]


def dense_gid(sargs, depth_bits=0):
    """The dense binning's own sort at screen-space inputs ``sargs`` (on
    ``depth_bits`` keys): the sorted slot -> gaussian index (M,) and its
    segment end ``tile_starts[T:]``, the ``n_live`` it passes to
    ``pack_soa``."""
    from gaussian_splatting_tpu_torch.ops.tiling import binning_slots, slot_sort_key, sort_keys

    means2d, conics, _, opac, depths, radii = sargs
    tile_key, _, _, _, T = binning_slots(means2d, conics, opac, radii, WIDTH, HEIGHT, TILE,
                                         MAX_T)
    key, unit = slot_sort_key(tile_key, depths, T, depth_bits=depth_bits)
    tile_starts, gid = sort_keys(key, unit, T, means2d.shape[0])
    return gid, tile_starts[T:]


def per_gaussian_counts(b, n):
    """Real slots per gaussian of one binning, as int8 numpy."""
    import torch

    gid = b.sorted_soa[11, :int(b.n_isect)].long()
    return torch.bincount(gid, minlength=n).to(torch.int8).cpu().numpy()


def compare_counts(args_dev, b):
    """The bench scene's binning gaussian by gaussian: the card's counts
    against the same binning on the host CPU and against the stored CPU
    hash; logs the gaussians that differ and the two boundary gaussians."""
    import torch

    from gaussian_splatting_tpu_torch.ops.tiling import isect_and_sort

    n = args_dev[0].shape[0]
    card = per_gaussian_counts(b, n)
    b_cpu = isect_and_sort(*(x.cpu() for x in args_dev), WIDTH, HEIGHT, TILE, CHUNK, MAX_T)
    cpu = per_gaussian_counts(b_cpu, n)
    sha = hashlib.sha256(cpu.tobytes()).hexdigest()
    diff = np.nonzero(card != cpu)[0]
    named = sorted(BENCH_BOUNDARY_GAUSSIANS)
    log(f"[bench] per-gaussian slot counts, card vs host CPU: {len(diff)} gaussians differ "
        f"{[(int(g), int(card[g]), int(cpu[g])) for g in diff[:8]]} (id, card, CPU); CPU "
        f"total {int(cpu.sum())}, sha256 {'equal to' if sha == BENCH_CPU_COUNTS_SHA256 else 'DIFFERS from'}"
        f" the stored one; boundary gaussians {named}: card "
        f"{[int(card[g]) for g in named]}, CPU {[int(cpu[g]) for g in named]}, stored "
        f"{[BENCH_BOUNDARY_GAUSSIANS[g] for g in named]}")
    del b_cpu
    torch.cuda.empty_cache()


def compare_kernels(sargs, b, tag, depth_bits=0, gid=None, chunk=CHUNK):
    """Both forward-path kernels against their plain versions on the dense
    binning ``b`` of screen-space inputs ``sargs``, with the sort's own gid
    (on ``depth_bits`` keys): pack exact, with ``n_live`` (the binning's
    SoA) and gathering every column; the forward on the binning's SoA equal
    bit for bit to the forward on the full-gather plain SoA, and within
    atol 1e-5 (rgb, sum_w) / 1e-4 (depth) of its plain version. With
    ``gid`` (the band layout's, its sentinel runs inside the stream) the
    pack gathers every column of it, as the binning does. ``chunk`` is the
    binning's and the forward's. Returns a dict of the errors, outputs and
    the pack's inputs."""
    import torch

    from gaussian_splatting_tpu_torch.ops.rasterize_cuda import fwd_tiles, fwd_tiles_plain
    from gaussian_splatting_tpu_torch.ops.tiling import (
        pack_soa, pack_soa_plain, quantity_records)

    records = quantity_records(*sargs[:5])
    n_live = None
    if gid is None:
        gid, n_live = dense_gid(sargs, depth_bits)
    k_soa = pack_soa(records, gid, 2 * chunk, n_live)
    p_soa = pack_soa_plain(records, gid, 2 * chunk, n_live)
    torch.cuda.synchronize()
    pack_err = float((k_soa - p_soa).abs().max())
    if not torch.equal(k_soa, p_soa):
        fail(f"[{tag}] pack kernel differs from pack_soa_plain (max |diff| {pack_err})")
    if not torch.equal(k_soa, b.sorted_soa):
        fail(f"[{tag}] pack kernel output differs from the binning's SoA")
    if n_live is None:
        live, p_full = gid.shape[0], p_soa
    else:
        del p_soa
        k_full = pack_soa(records, gid, 2 * chunk)
        p_full = pack_soa_plain(records, gid, 2 * chunk)
        torch.cuda.synchronize()
        live = int(n_live)
        if not (torch.equal(k_full, p_full)
                and torch.equal(k_full[:, :live], k_soa[:, :live])):
            fail(f"[{tag}] full-gather pack kernel differs from pack_soa_plain or from the "
                 f"n_live pack below n_live")
        del k_full
    del k_soa

    ntx = -(-WIDTH // TILE)
    k_out = fwd_tiles(b.tile_starts, b.counts, b.sorted_soa, TILE, ntx, chunk)
    same = torch.equal(k_out, fwd_tiles(b.tile_starts, b.counts, p_full, TILE, ntx, chunk))
    del p_full
    p_out, pairs = fwd_tiles_plain(b.tile_starts, b.counts, b.sorted_soa, TILE, ntx, chunk)
    torch.cuda.synchronize()
    diff = (k_out - p_out).abs()
    err_rgbw = float(torch.cat([diff[:, 0:3], diff[:, 4:8]], 1).max())
    err_depth = float(diff[:, 3].max())
    n_bad = int(((diff[:, 0:3] > 1e-5).any(1) | (diff[:, 4] > 1e-5)
                 | (diff[:, 3] > 1e-4)).sum())
    gathered = (f"n_live {live}; and gathering all columns" if n_live is not None
                else "no n_live: every column gathered")
    log(f"[{tag}] pack kernel == plain: exact ({gid.shape[0]} columns, {gathered}); forward on it == forward on the full-gather plain SoA: "
        f"{same}; forward kernel vs plain over {b.counts.shape[0]} tiles: max |diff| "
        f"rgb/sum_w {err_rgbw:.3e}, depth {err_depth:.3e}, pixels beyond tolerance {n_bad}")
    if not same:
        fail(f"[{tag}] the forward on the n_live SoA differs from the forward on the full one")
    if not (err_rgbw <= 1e-5 and err_depth <= 1e-4):
        fail(f"[{tag}] forward kernel disagrees with fwd_tiles_plain")
    if not bool(torch.isfinite(k_out).all()):
        fail(f"[{tag}] forward kernel output is not finite")
    culled = check_cull(b, tag)
    return {"pack_err": pack_err, "fwd_err": max(err_rgbw, err_depth), "fwd_out": k_out,
            "pairs": int(pairs), "plain_out": p_out, "records": records, "gid": gid,
            "n_live": n_live, "culled": culled}


def check_cull(b, tag):
    """The raster kernels' warp cull on binning ``b``, through its plain
    mirror ``warp_cull_plain``: no (warp, entry) pair that it culls may hold
    a pixel of the warp's 8x4 block where the plain forward's ``contrib``
    holds, and it must cull some. Returns the culled share of the (warp,
    entry) pairs."""
    from gaussian_splatting_tpu_torch.ops.rasterize_cuda import warp_cull_plain

    keep, touched = warp_cull_plain(b.tile_starts, b.counts, b.sorted_soa, TILE,
                                    -(-WIDTH // TILE))
    pairs = keep.numel()
    missed, n_keep, n_touched = (int(x.sum()) for x in (touched & ~keep, keep, touched))
    culled = 1.0 - n_keep / pairs
    log(f"[{tag}] warp cull (plain mirror): {pairs} (warp, entry) pairs, culled "
        f"{pairs - n_keep} (share {culled:.4f}), with a contributing pixel {n_touched}, "
        f"contributing pairs culled {missed}")
    if missed or n_keep == pairs:
        fail(f"[{tag}] the warp cull skips a contributing pair or culls nothing")
    return culled


def plain_reduce(grad, n, n_written, with_depth):
    """``tiling.reduce_padded_grads`` (one slice) with the plain versions of
    ``pack_rows`` and ``segsum``, on the card."""
    import torch

    from gaussian_splatting_tpu_torch.ops.segsum import segment_sum_sorted_plain
    from gaussian_splatting_tpu_torch.ops.tiling import (
        GRAD_KEYS, pack_rows_plain, sorted_gid_key)

    key, perm = sorted_gid_key(grad, n, n_written, 0, grad.shape[1])
    stacked = pack_rows_plain(grad, perm, key, n_written.reshape(1), 0,
                              11 if with_depth else 10, float(n))
    sums = segment_sum_sorted_plain(stacked, n)
    out = {k: sums[1 + j] for j, k in enumerate(GRAD_KEYS)}
    if not with_depth:
        out["ddepth"] = torch.zeros_like(out["ddepth"])
    return out


def grad_errors(k, p):
    """Per key of two gradient dicts: max |kernel - plain|, max and median
    of the nonzero |plain|, the relative L2 error over all gaussians and
    over the half with the smallest nonzero |plain|; and whether every key
    is inside atol GRAD_ATOL_FRAC * max|plain| + rtol GRAD_RTOL per
    gaussian and inside GRAD_L2_RTOL / GRAD_L2_SMALL_RTOL in L2."""
    import torch

    from gaussian_splatting_tpu_torch.ops.tiling import GRAD_KEYS

    stats, ok = {}, True
    for key in GRAD_KEYS:
        pk = p[key].double()
        d = (k[key].double() - pk).abs()
        a = pk.abs()
        nz = a[a > 0]
        if nz.numel() == 0:
            stats[key] = {"max_err": float(d.max())}
            ok &= bool((d == 0).all())
            continue
        med = float(torch.median(nz))
        small = (a > 0) & (a <= med)
        rel = float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(pk))
        rel_small = float(torch.linalg.vector_norm(d[small])
                          / torch.linalg.vector_norm(pk[small]))
        stats[key] = {"max_err": float(d.max()), "max_abs": float(nz.max()),
                      "median_abs": med, "rel_l2": rel, "rel_l2_small": rel_small}
        ok &= bool((d <= GRAD_ATOL_FRAC * float(nz.max()) + GRAD_RTOL * a).all())
        ok &= rel <= GRAD_L2_RTOL and rel_small <= GRAD_L2_SMALL_RTOL
    return stats, ok


def compare_backward(b, fwd_out, n, tag, seed=0, gcap=None, chunk=CHUNK):
    """Phase 2b: the backward kernel + the kernel reduce against their
    plain versions on binning ``b`` under a seeded cotangent, then
    ``pack_rows`` and ``segsum`` against their plain versions on the
    kernel's stream; the stream's capacity ``gcap`` (the dense one by
    default), ``chunk`` the binning's. Returns the errors and the inputs the
    timings use."""
    import torch

    from gaussian_splatting_tpu_torch.ops.rasterize_cuda import (
        bwd_tiles, bwd_tiles_plain, grad_cap)
    from gaussian_splatting_tpu_torch.ops.segsum import (
        segment_sum_sorted, segment_sum_sorted_plain)
    from gaussian_splatting_tpu_torch.ops.tiling import (
        pack_rows, pack_rows_plain, reduce_padded_grads, sorted_gid_key)

    ntx = -(-WIDTH // TILE)
    gcap = grad_cap(n, MAX_T, chunk) if gcap is None else gcap
    gen = torch.Generator(device=fwd_out.device).manual_seed(seed)
    gout = torch.randn(fwd_out.shape, generator=gen, device=fwd_out.device)
    gout[:, 5:] = 0.0  # rows the image never reads have no cotangent
    k_grad, k_meta = bwd_tiles(b.tile_starts, b.counts, b.sorted_soa, gout, fwd_out,
                               TILE, ntx, chunk, n, gcap)
    k_sums = reduce_padded_grads(k_grad, n, k_meta[0], with_depth=True)
    p_grad, p_meta, active = bwd_tiles_plain(b.tile_starts, b.counts, b.sorted_soa, gout,
                                             fwd_out, TILE, ntx, chunk, n, gcap)
    p_sums = plain_reduce(p_grad, n, p_meta[0], with_depth=True)
    torch.cuda.synchronize()
    del p_grad
    stats, ok = grad_errors(k_sums, p_sums)
    km, pm = k_meta.tolist(), p_meta.tolist()
    finite = all(bool(torch.isfinite(v).all()) for v in k_sums.values())
    log(f"[{tag}] backward kernel + reduce vs plain over {b.counts.shape[0]} tiles, "
        f"n_isect {int(b.n_isect)}: meta [n_written, n_dropped] kernel {km}, plain {pm}")
    for key, s in stats.items():
        log(f"[{tag}]   {key}: " + ", ".join(f"{n} {v:.3e}" for n, v in s.items()))
    if km != pm or not ok or not finite:
        fail(f"[{tag}] backward kernel disagrees with bwd_tiles_plain")

    key, perm = sorted_gid_key(k_grad, n, k_meta[0], 0, k_grad.shape[1])
    nv = k_meta[:1].contiguous()
    stacked = {}
    for n_rows in (10, 11):  # the step's reduce (no depth payload) and with depth
        k_st = pack_rows(k_grad, perm, key, nv, 0, n_rows, float(n))
        p_st = pack_rows_plain(k_grad, perm, key, nv, 0, n_rows, float(n))
        torch.cuda.synchronize()
        pack_rows_err = float((k_st - p_st).abs().max())
        if not torch.equal(k_st, p_st):
            fail(f"[{tag}] pack_rows kernel ({n_rows} rows) differs from pack_rows_plain "
                 f"({pack_rows_err})")
        stacked[n_rows] = k_st
        del p_st
    # segsum reading all 16 rows of the 11-row buffer (the JAX contract) and
    # only the 10 rows of the step's buffer.
    segsum_err = 0.0
    ids = torch.unique_consecutive(stacked[10][0])
    log(f"[{tag}] gradient stream: {int((ids < n).sum())} of {n} gaussians have entries")
    del ids
    for n_rows, st in ((16, stacked[11]), (10, stacked[10])):
        k_seg = segment_sum_sorted(st, n, n_rows)
        p_seg = segment_sum_sorted_plain(st, n, n_rows)
        torch.cuda.synchronize()
        seg_d = (k_seg - p_seg).abs()[1:]
        seg_scale = p_seg.abs()[1:].amax(1, keepdim=True) + 1e-12
        err = float(seg_d.max())
        segsum_err = max(segsum_err, err)
        log(f"[{tag}] segsum kernel (n_rows {n_rows}) vs plain: max |diff| {err:.3e} (rows "
            f"1-15, gate {SEGSUM_ATOL_FRAC} of each row's largest value)")
        if not (bool((seg_d <= SEGSUM_ATOL_FRAC * seg_scale).all())
                and bool((k_seg[n_rows:] == 0).all()) and bool(torch.isfinite(k_seg).all())):
            fail(f"[{tag}] segsum kernel (n_rows {n_rows}) disagrees with "
                 f"segment_sum_sorted_plain")
        del k_seg, p_seg, seg_d
    log(f"[{tag}] pack_rows kernel == plain, 10 and 11 rows: exact ({k_st.shape[1]} "
        f"columns)")
    del stacked[11]
    return {"bwd_err": max(s["max_err"] for s in stats.values()),
            "p_sums": p_sums, "p_meta": p_meta, "pack_rows_err": pack_rows_err,
            "segsum_err": segsum_err, "active": int(active), "gout": gout,
            "grad": k_grad, "meta": k_meta, "key": key, "perm": perm, "stacked": stacked[10],
            "gcap": gcap}


def queue_for(b, w_cap=None, chunk=CHUNK):
    """The chunk queue of binning ``b`` at the rasterizer's capacity
    ``w_cap`` (the dense one, ``N max_t // chunk + T``, by default), n_work
    as a (1,) tensor."""
    from gaussian_splatting_tpu_torch.ops.tiling import chunk_queue

    if w_cap is None:
        w_cap = N_GAUSSIANS * MAX_T // chunk + b.counts.shape[0]
    wtile, cum, n_work = chunk_queue(b.counts, chunk, w_cap)
    return wtile, cum, n_work.reshape(1)


def compare_queue(b, fwd_out, plain_out, bwd, n, tag, w_cap=None, chunk=CHUNK):
    """The queue kernels on binning ``b``: the queue forward (the kernel
    writes empty tiles' zero blocks) equal to the loop kernel's ``fwd_out``
    bit for bit, hence inside the loop forward's gates against the plain
    version's ``plain_out``; the queue backward + kernel reduce against the
    plain sums and meta of ``compare_backward`` (``bwd``), under the
    backward's gates. The queue's plain versions are ``check_queue`` and
    the loop's plain versions on the same inputs."""
    import torch

    from gaussian_splatting_tpu_torch.ops.rasterize_cuda import (
        bwd_tiles_q, check_queue, fwd_tiles_q)
    from gaussian_splatting_tpu_torch.ops.tiling import reduce_padded_grads

    ntx = -(-WIDTH // TILE)
    wtile, cum, n_work = queue_for(b, w_cap, chunk)
    check_queue(wtile, cum, n_work, b.counts, chunk)
    q_out = fwd_tiles_q(wtile, cum, b.tile_starts, b.counts, n_work, b.sorted_soa, TILE,
                        ntx, chunk)
    torch.cuda.synchronize()
    fwd_err = float((q_out - plain_out).abs().max())
    same = torch.equal(q_out, fwd_out)
    log(f"[{tag}] queue forward kernel ({int(n_work)} work items, "
        f"{int((b.counts == 0).sum())} empty tiles): equal to the loop kernel bit for bit: "
        f"{same}; max |diff| against plain {fwd_err:.3e}")
    if not same:
        fail(f"[{tag}] the queue forward differs from the loop forward")
    k_grad, k_meta = bwd_tiles_q(wtile, cum, b.tile_starts, b.counts, n_work, b.sorted_soa,
                                 bwd["gout"], fwd_out, TILE, ntx, chunk, n, bwd["gcap"])
    k_sums = reduce_padded_grads(k_grad, n, k_meta[0], with_depth=True)
    torch.cuda.synchronize()
    del k_grad
    stats, ok = grad_errors(k_sums, bwd["p_sums"])
    km, pm = k_meta.tolist(), bwd["p_meta"].tolist()
    finite = all(bool(torch.isfinite(v).all()) for v in k_sums.values())
    log(f"[{tag}] queue backward kernel + reduce vs plain: meta kernel {km}, plain {pm}")
    for key, st in stats.items():
        log(f"[{tag}]   {key}: " + ", ".join(f"{k} {v:.3e}" for k, v in st.items()))
    if km != pm or not ok or not finite:
        fail(f"[{tag}] queue backward kernel disagrees with bwd_tiles_plain")
    return {"fwd_q_err": fwd_err, "bwd_q_err": max(st["max_err"] for st in stats.values())}


def compare_partition(sargs, b, fwd_out, bwd, tag, buckets=BUCKETS, headroom=BUCKET_HEADROOM):
    """Phase 5b, checks: the fused partition kernel (``bucket_partition``)
    against its plain version on the dense slots' tiles and the depths at
    these screen-space inputs (key, gid, counts and drops exact); the bucket
    binning's kept + dropped equal to the dense binning ``b``'s n_isect
    and, with no drop, on the bucket (gapped) layout: the forward equal to
    the dense ``fwd_out`` bit for bit, and the backward kernel + kernel
    reduce under ``compare_backward``'s cotangent against its plain sums
    and meta (``bwd``) under the backward's gates; with drops, the forward
    and the backward + reduce against their plain versions on the bucket
    layout itself. ``buckets`` and ``headroom`` are the binning's. Returns
    the partition's inputs, quantum, outputs, drop count, the bucket
    binning's gid and the errors on its layout."""
    import torch

    from gaussian_splatting_tpu_torch.ops.partition import (
        bucket_partition, bucket_partition_plain, quantum_for)
    from gaussian_splatting_tpu_torch.ops.rasterize_cuda import bwd_tiles, fwd_tiles
    from gaussian_splatting_tpu_torch.ops.tiling import (
        BUCKET_C, binning_slots, isect_and_sort, reduce_padded_grads)

    means2d, conics, _, opac, depths, radii = sargs
    tile_key, _, _, _, T = binning_slots(means2d, conics, opac, radii, WIDTH, HEIGHT, TILE,
                                         MAX_T)
    q = quantum_for(BUCKET_C, buckets, headroom)
    k_out = bucket_partition(tile_key, depths, T, buckets, q, C=BUCKET_C)
    p_out = bucket_partition_plain(tile_key, depths, T, buckets, q, C=BUCKET_C)
    torch.cuda.synchronize()
    exact = all(torch.equal(a, c) for a, c in zip(k_out, p_out))
    diff = [int((a != c).sum()) for a, c in zip(k_out, p_out)]
    err = max(float((a.double() - c.double()).abs().max()) for a, c in zip(k_out, p_out))
    del p_out
    counts = k_out[2].tolist() if buckets <= 64 else f"sum {int(k_out[2].sum())}"
    drops = k_out[3].tolist() if buckets <= 64 else f"sum {int(k_out[3].sum())}"
    log(f"[{tag}] bucket partition kernel, {tile_key.shape[0]} slots, B {buckets}, quantum "
        f"{q}, (B, cap) = {tuple(k_out[0].shape)}: key, gid, counts, drops equal to plain: "
        f"{exact} (entries differing {diff}); counts {counts}, drops {drops}")
    if not exact:
        fail(f"[{tag}] bucket partition kernel differs from bucket_partition_plain")

    bb = isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T, sort_buckets=buckets,
                        bucket_headroom=headroom)
    n_b, n_drop, n_dense = int(bb.n_isect), int(bb.n_bucket_dropped), int(b.n_isect)
    log(f"[{tag}] bucket binning: n_isect {n_b} + n_bucket_dropped {n_drop} = {n_b + n_drop} "
        f"(dense n_isect {n_dense}); tile_starts[T] {int(bb.tile_starts[-1])}")
    if n_b + n_drop != n_dense or int(k_out[3].sum()) != n_drop:
        fail(f"[{tag}] the bucket binning lost or gained intersections")
    layout_errs = {}
    if n_drop:
        # Another image than the dense one: held against the plain versions
        # on its own (gapped) layout.
        kc = compare_kernels(sargs, bb, f"{tag}, bucket layout", gid=bb.sorted_soa[11].to(
            torch.int32)[:k_out[0].numel()].contiguous())
        bwl = compare_backward(bb, kc["fwd_out"], N_GAUSSIANS, f"{tag}, bucket layout",
                               seed=1, gcap=bwd["gcap"])
        layout_errs = {"rasterize_fwd": kc["fwd_err"], "rasterize_bwd": bwl["bwd_err"]}
        del kc, bwl
    else:
        ntx = -(-WIDTH // TILE)
        bo = fwd_tiles(bb.tile_starts, bb.counts, bb.sorted_soa, TILE, ntx, CHUNK)
        torch.cuda.synchronize()
        same = torch.equal(bo, fwd_out)
        log(f"[{tag}] forward on the bucket layout equal to the dense one bit for bit: {same}")
        if not same:
            fail(f"[{tag}] the bucket layout's forward differs from the dense one")
        del bo
        # The segments are the dense ones, so the sums agree up to atomic
        # order and the chunk-rounded meta exactly.
        k_grad, k_meta = bwd_tiles(bb.tile_starts, bb.counts, bb.sorted_soa, bwd["gout"],
                                   fwd_out, TILE, ntx, CHUNK, N_GAUSSIANS, bwd["gcap"])
        k_sums = reduce_padded_grads(k_grad, N_GAUSSIANS, k_meta[0], with_depth=True)
        torch.cuda.synchronize()
        del k_grad
        stats, ok = grad_errors(k_sums, bwd["p_sums"])
        km, pm = k_meta.tolist(), bwd["p_meta"].tolist()
        finite = all(bool(torch.isfinite(v).all()) for v in k_sums.values())
        log(f"[{tag}] backward kernel + reduce on the bucket layout vs the dense plain sums: "
            f"meta kernel {km}, plain {pm}")
        for key, st in stats.items():
            log(f"[{tag}]   {key}: " + ", ".join(f"{k} {v:.3e}" for k, v in st.items()))
        if km != pm or not ok or not finite:
            fail(f"[{tag}] the backward on the bucket layout disagrees with the dense plain sums")
        del k_sums
    gid_b = bb.sorted_soa[11, :k_out[0].numel()].to(torch.int32)
    del bb
    return {"tile_key": tile_key, "depths": depths, "q": q, "T": T, "out": k_out,
            "err": err, "n_drop": n_drop, "gid": gid_b, "layout_errs": layout_errs}


def bucket_train_phase(dev, scene, views, images):
    """Phase 5b, the bucket path: BUCKET_STEPS steps of ``make_train_step``
    with ``sort_buckets=BUCKETS`` from the dense phase's noisy state. The
    loss must descend, nothing be dropped from the gradient stream, and the
    partition launch once a view in every step. Returns the step function,
    the state, the per-step device times and the launches of the run."""
    import torch

    from gaussian_splatting_tpu_torch.models.gaussians import train_state_from_numpy
    from gaussian_splatting_tpu_torch.training.config import TrainingConfig
    from gaussian_splatting_tpu_torch.training.step import ViewBatch, make_train_step

    config = TrainingConfig(backend="auto", sort_buckets=BUCKETS,
                            partition_headroom=BUCKET_HEADROOM)
    step = make_train_step(config, WIDTH, HEIGHT, 3, config.backend, SCENE_EXTENT, device=dev)
    state = train_state_from_numpy(noisy_train_arrays(scene, seed=1), device=dev)
    batch = ViewBatch(images=images,
                      viewmats=torch.stack([v["world_view_transform"] for v in views]),
                      Ks=torch.stack([v["K"] for v in views]))
    losses, step_ms = [], []
    reset_launches()
    for i in range(BUCKET_STEPS):
        before = read_launches()["partition"]
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = step(state, batch)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
        losses.append(float(m["loss"]))
        rose = read_launches()["partition"] - before
        log(f"[bucket] step {i}: loss {losses[-1]:.6f}, psnr {float(m['psnr']):.3f}, n_isect "
            f"{int(m['stats/n_isect'])}, n_budget_dropped (bucket overflow) "
            f"{int(m['stats/n_budget_dropped'])}, n_grad_dropped "
            f"{int(m['stats/n_grad_dropped'])}, partition launches {rose}, "
            f"{step_ms[-1]:.3f} ms")
        if not np.isfinite(losses[-1]) or int(m["stats/n_grad_dropped"]) > 0:
            fail(f"[bucket] step {i}: loss not finite or gradient entries dropped")
        if rose != images.shape[0]:
            fail(f"[bucket] step {i}: the partition launched {rose} times, not once a view")
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[bucket] {BUCKET_STEPS} steps, sort_buckets {BUCKETS}, headroom {BUCKET_HEADROOM}: "
        f"launches {launches}")
    for k in ("means", "quats", "log_scales", "logit_opacities", "features_dc",
              "features_rest"):
        if not bool(torch.isfinite(getattr(state.gauss.params, k)).all()):
            fail(f"[bucket] parameter {k} is not finite")
    if not losses[-1] < losses[0]:
        fail(f"[bucket] the loss did not descend: {losses}")
    path = ("pack_soa", "rasterize_fwd", "rasterize_bwd", "pack_rows", "segsum", "partition")
    if min(launches[k] for k in path) < 1:
        fail(f"[bucket] a kernel of the bucket path never launched: {launches}")
    return step, state, batch, step_ms, launches


def view_dataset(views, images):
    """A ``ViewDataset`` (host uint8 images, viewmats, Ks) of rendered views."""
    import torch

    from gaussian_splatting_tpu_torch.training.trainer import ViewDataset

    return ViewDataset(
        images=(images.clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy(),
        viewmats=np.stack([v["world_view_transform"].cpu().numpy() for v in views]),
        Ks=np.stack([v["K"].cpu().numpy() for v in views]))


def batch_class_budgets(dev, state, views, images):
    """The trainer's class budgets (``GaussianTrainer._choose_class_budgets``
    at ``TrainingConfig()``, MAX_T) for a batch of views. The trainer
    measures up to 3 views of a dataset and a batch holds 4: the per-class
    maximum of its budgets for each view alone covers them all."""
    from gaussian_splatting_tpu_torch.training.config import TrainingConfig
    from gaussian_splatting_tpu_torch.training.trainer import GaussianTrainer

    cfg = TrainingConfig()
    trainer = GaussianTrainer(cfg, device=dev)
    per_view = [trainer._choose_class_budgets(
        state, view_dataset(views[i:i + 1], images[i:i + 1]), cfg, MAX_T)
        for i in range(len(views))]
    return tuple(max(b) for b in zip(*per_view))


def compact_phase(dev, sargs, b, fwd_out, bw, tstate, views, images, tag="train view 0"):
    """Phase 5c: the compact binning at training view 0 with the budgets the
    trainer chooses for the training state and the 4 views
    (``batch_class_budgets``), against the dense binning ``b`` of the
    same inputs: n_isect and n_dropped equal, no budget drop, ``pack_soa``
    on the compact gid exact against its plain version, the forward equal
    to the dense ``fwd_out``, the backward + reduce under
    ``compare_backward``'s cotangent within the backward's gates of the
    dense plain sums (``bw``); then compact + sort_buckets: the partition
    with ``slot_gid`` exact against its plain version, no bucket
    intersection lost and the forward equal to the compact flat one."""
    import torch

    from gaussian_splatting_tpu_torch.ops.partition import (
        bucket_partition, bucket_partition_plain, quantum_for)
    from gaussian_splatting_tpu_torch.ops.rasterize_cuda import bwd_tiles, fwd_tiles, grad_cap
    from gaussian_splatting_tpu_torch.ops.tiling import (
        BUCKET_C, binning_slots, isect_and_sort, pack_soa, pack_soa_plain, quantity_records,
        reduce_padded_grads, slot_sort_key, sort_keys, total_slots)

    budgets = batch_class_budgets(dev, tstate, views, images)
    bc = isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T, class_budgets=budgets)
    n_slots = total_slots(N_GAUSSIANS, MAX_T, budgets)
    gcap_c = grad_cap(N_GAUSSIANS, MAX_T, CHUNK, 1.0, budgets)
    counts = [int(x) for x in (bc.n_isect, bc.n_dropped, bc.n_budget_dropped)]
    log(f"[{tag} compact] trainer budgets {budgets}: n_sort_slots {n_slots} (dense "
        f"{N_GAUSSIANS * MAX_T}), grad_cap {gcap_c} (dense {bw['gcap']}); n_isect "
        f"{counts[0]} (dense {int(b.n_isect)}), n_dropped {counts[1]} (dense "
        f"{int(b.n_dropped)}), n_budget_dropped {counts[2]}")
    if counts != [int(b.n_isect), int(b.n_dropped), 0]:
        fail(f"[{tag} compact] the compact binning's counts differ from the dense ones")

    # pack_soa on the compact layout's own gid.
    means2d, conics, colors, opac, depths, radii = sargs
    tile_key, slot_gid, _, _, T = binning_slots(means2d, conics, opac, radii, WIDTH, HEIGHT,
                                                TILE, MAX_T, budgets)
    starts, gid = sort_keys(*slot_sort_key(tile_key, depths, T, slot_gid), T, N_GAUSSIANS,
                            slot_gid)
    records = quantity_records(*sargs[:5])
    k_soa = pack_soa(records, gid, 2 * CHUNK, starts[T:])
    exact = (torch.equal(k_soa, pack_soa_plain(records, gid, 2 * CHUNK, starts[T:]))
             and torch.equal(k_soa, bc.sorted_soa))
    del k_soa
    ntx = -(-WIDTH // TILE)
    fc = fwd_tiles(bc.tile_starts, bc.counts, bc.sorted_soa, TILE, ntx, CHUNK)
    torch.cuda.synchronize()
    diff = (fc - fwd_out).abs()
    err_rgbw = float(torch.cat([diff[:, 0:3], diff[:, 4:8]], 1).max())
    err_depth = float(diff[:, 3].max())
    same = torch.equal(fc, fwd_out)
    log(f"[{tag} compact] pack kernel on the compact gid == plain and == the binning's SoA: "
        f"{exact}; forward equal to the dense one bit for bit: {same} (max |diff| rgb/sum_w "
        f"{err_rgbw:.3e}, depth {err_depth:.3e})")
    if not exact or not (err_rgbw <= 1e-5 and err_depth <= 1e-4):
        fail(f"[{tag} compact] pack or forward on the compact layout disagrees")
    k_grad, k_meta = bwd_tiles(bc.tile_starts, bc.counts, bc.sorted_soa, bw["gout"], fwd_out,
                               TILE, ntx, CHUNK, N_GAUSSIANS, gcap_c)
    k_sums = reduce_padded_grads(k_grad, N_GAUSSIANS, k_meta[0], with_depth=True)
    torch.cuda.synchronize()
    stats, ok = grad_errors(k_sums, bw["p_sums"])
    km, pm = k_meta.tolist(), bw["p_meta"].tolist()
    log(f"[{tag} compact] backward kernel + reduce vs the dense plain sums: meta kernel {km}, "
        f"dense plain {pm}; rel_l2 {max(st.get('rel_l2', 0.0) for st in stats.values()):.3e}, "
        f"smaller half {max(st.get('rel_l2_small', 0.0) for st in stats.values()):.3e}")
    if km != pm or not ok or not all(bool(torch.isfinite(v).all()) for v in k_sums.values()):
        for key, st in stats.items():
            log(f"[{tag} compact]   {key}: " + ", ".join(f"{k} {v:.3e}" for k, v in st.items()))
        fail(f"[{tag} compact] the backward on the compact layout disagrees")
    del k_sums

    # Compact + sort_buckets: the partition reads each slot's gaussian.
    q = quantum_for(BUCKET_C, BUCKETS, BUCKET_HEADROOM)
    k_out = bucket_partition(tile_key, depths, T, BUCKETS, q, C=BUCKET_C, slot_gid=slot_gid)
    p_out = bucket_partition_plain(tile_key, depths, T, BUCKETS, q, C=BUCKET_C,
                                   slot_gid=slot_gid)
    torch.cuda.synchronize()
    part_exact = all(torch.equal(x, y) for x, y in zip(k_out, p_out))
    del p_out
    bcb = isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T, class_budgets=budgets,
                         sort_buckets=BUCKETS, bucket_headroom=BUCKET_HEADROOM)
    n_b, n_drop = int(bcb.n_isect), int(bcb.n_bucket_dropped)
    fcb = fwd_tiles(bcb.tile_starts, bcb.counts, bcb.sorted_soa, TILE, ntx, CHUNK)
    torch.cuda.synchronize()
    same_b = torch.equal(fcb, fc)
    log(f"[{tag} compact bucket] partition with slot_gid ({tile_key.shape[0]} slots, "
        f"(B, cap) = {tuple(k_out[0].shape)}) == plain: {part_exact}; n_isect {n_b} + "
        f"n_bucket_dropped {n_drop} (compact flat n_isect {counts[0]}); forward equal to the "
        f"compact flat one bit for bit: {same_b}")
    if not part_exact or n_drop or n_b != counts[0] or not same_b:
        fail(f"[{tag} compact bucket] the partition, its counts or its forward disagree")
    del bcb, fcb, fc
    return {"budgets": budgets, "bc": bc, "n_slots": n_slots, "gcap": gcap_c,
            "grad": k_grad, "meta": k_meta,
            "records": records, "gid": gid, "n_live": starts[T:], "tile_key": tile_key,
            "slot_gid": slot_gid, "depths": depths, "T": T, "q": q}


def compact_train_phase(dev, scene, views, images, steps=4):
    """Phase 5d: ``make_train_step`` from the dense phase's noisy starting
    state with the compact budgets the trainer chooses for that state and
    the 4 views (``batch_class_budgets``): the loss must descend, no
    gradient entry be dropped, no budget entry at step 0 and at most
    BUDGET_DROP_FRAC of n_isect later; the step time is logged beside the
    dense one."""
    import torch

    from gaussian_splatting_tpu_torch.models.gaussians import train_state_from_numpy
    from gaussian_splatting_tpu_torch.training.config import TrainingConfig
    from gaussian_splatting_tpu_torch.training.step import ViewBatch, make_train_step

    state = train_state_from_numpy(noisy_train_arrays(scene, seed=1), device=dev)
    budgets = batch_class_budgets(dev, state, views, images)
    log(f"[compact step] the trainer's budgets for the starting state: {budgets}")
    config = TrainingConfig(backend="auto", class_budgets=budgets)
    step = make_train_step(config, WIDTH, HEIGHT, 3, config.backend, SCENE_EXTENT, device=dev)
    batch = ViewBatch(images=images,
                      viewmats=torch.stack([v["world_view_transform"] for v in views]),
                      Ks=torch.stack([v["K"] for v in views]))
    losses, step_ms = [], []
    for i in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = step(state, batch)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
        losses.append(float(m["loss"]))
        drops = [int(m[f"stats/{k}"]) for k in ("n_budget_dropped", "n_grad_dropped")]
        n_is = int(m["stats/n_isect"])
        log(f"[compact step] step {i}: loss {losses[-1]:.6f}, n_isect {n_is}, "
            f"n_budget_dropped {drops[0]}, n_grad_dropped {drops[1]}, {step_ms[-1]:.3f} ms")
        # Step 0 runs on the state the budgets were measured on: nothing may
        # drop. Later steps move footprints, and a gaussian that grows into
        # a class the squeeze left empty (budget 0) drops; the trainer
        # tolerates that up to its rebudget threshold.
        budget_ok = drops[0] == 0 if i == 0 else drops[0] <= BUDGET_DROP_FRAC * n_is
        if not np.isfinite(losses[-1]) or drops[1] or not budget_ok:
            fail(f"[compact step] step {i}: loss not finite or entries dropped")
    if not losses[-1] < losses[0]:
        fail(f"[compact step] the loss did not descend: {losses}")
    return step, state, batch, step_ms


def peak_gib(fn):
    """Peak device memory (GiB) of one call of ``fn`` above what was
    allocated before it."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def in_turns(fns, reps=5):
    """``cuda_ms`` of each of ``fns`` (a dict) in turns, A B .. B A: both
    medians of each, in that order."""
    out = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        out[k].append(cuda_ms(fns[k], reps=reps))
    return out


def depth_tie_tiles(b, depth_bits):
    """The tiles of the exact binning ``b`` in which two neighbouring
    entries of different depth share a ``depth_bits`` level (quantized as
    ``tiling.slot_sort_key`` does, over the real entries' depth range): the
    only tiles whose order the quantized key may change. Elsewhere equal
    levels mean equal depths, which both keys leave in slot order."""
    import torch

    n = int(b.n_isect)
    d = b.sorted_soa[9, :n]
    levels = (1 << depth_bits) - 1
    dmin, dmax = torch.amin(d), torch.amax(d)
    qd = torch.clamp((d - dmin) * (levels / torch.clamp_min(dmax - dmin, 1e-20)), 0,
                     levels).to(torch.int32)
    T = b.counts.shape[0]
    tile = torch.repeat_interleave(torch.arange(T, device=d.device), b.counts.long())
    tie = (qd[1:] == qd[:-1]) & (d[1:] != d[:-1]) & (tile[1:] == tile[:-1])
    tied = torch.zeros((T,), dtype=torch.bool, device=d.device)
    tied[tile[1:][tie]] = True
    return tied


def hold_layout(sargs, b, tag, n, gcap, flat_out=None, atol=0.0, **kw):
    """Kernels #1-#5 against their plain versions on binning ``b``
    (``compare_kernels``, ``compare_backward`` at capacity ``gcap``; ``kw``
    to ``compare_kernels``), and its forward against ``flat_out`` (rows
    rgb, alpha) within ``atol``. Returns the forward outputs, the backward's
    report and the errors."""
    import torch

    kc = compare_kernels(sargs, b, tag, **kw)
    err = None
    if flat_out is not None:
        d = (kc["fwd_out"] - flat_out).abs()
        err = float(torch.cat([d[:, 0:3], d[:, 4:5]], 1).max())
        log(f"[{tag}] forward against the flat path's: max |diff| rgb/alpha {err:.3e} "
            f"(gate {atol}), depth {float(d[:, 3].max()):.3e}")
        if not err <= atol:
            fail(f"[{tag}] the image differs from the flat path's")
    bwd = compare_backward(b, kc["fwd_out"], n, tag, seed=1, gcap=gcap)
    errs = {"pack_soa": kc["pack_err"], "rasterize_fwd": kc["fwd_err"],
            "rasterize_bwd": bwd["bwd_err"], "pack_rows": bwd["pack_rows_err"],
            "segsum": bwd["segsum_err"]}
    return kc, bwd, errs, err


def _check_steps(tag, rows, budget_check):
    """Falling finite losses and no gradient entry dropped over a run of
    step metrics ``rows``; ``budget_check`` also holds the budget drops (none
    at step 0, at most BUDGET_DROP_FRAC of n_isect later)."""
    losses = [r["loss"] for r in rows]
    for i, r in enumerate(rows):
        bd = r["n_budget_dropped"]
        ok_budget = not budget_check or (bd == 0 if i == 0
                                         else bd <= BUDGET_DROP_FRAC * r["n_isect"])
        if not np.isfinite(r["loss"]) or r["n_grad_dropped"] or not ok_budget:
            fail(f"[{tag}] step {i}: loss not finite or entries dropped: {r}")
    if not losses[-1] < losses[0]:
        fail(f"[{tag}] the loss did not descend: {losses}")


def steps_in_turns(dev, scene, images, views, configs, steps):
    """``steps`` steps of ``make_train_step`` for each of ``configs`` (a
    dict of TrainingConfig), each from phase 5's noisy starting state, in
    turns. Returns per config the step metrics, the CUDA-event ms and the
    launches of its steps."""
    import torch

    from gaussian_splatting_tpu_torch.models.gaussians import train_state_from_numpy
    from gaussian_splatting_tpu_torch.training.step import ViewBatch, make_train_step

    batch = ViewBatch(images=images,
                      viewmats=torch.stack([v["world_view_transform"] for v in views]),
                      Ks=torch.stack([v["K"] for v in views]))
    runs = {k: {"step": make_train_step(c, WIDTH, HEIGHT, 3, c.backend, SCENE_EXTENT,
                                        device=dev),
                "state": train_state_from_numpy(noisy_train_arrays(scene, seed=1), device=dev),
                "rows": [], "ms": [], "launches": {}} for k, c in configs.items()}
    for i in range(steps):
        for k, r in runs.items():
            before = read_launches()
            r["state"], m, ms = _step_ms(r["step"], r["state"], batch)
            r["launches"] = _add(r["launches"], _launch_delta(before))
            row = {"loss": float(m["loss"]), "ms": ms,
                   **{k2: int(m[f"stats/{k2}"]) for k2 in (
                       "n_isect", "n_dropped", "n_budget_dropped", "n_grad_dropped")}}
            r["rows"].append(row)
            r["ms"].append(ms)
            log(f"[steps] {k} step {i}: " + ", ".join(
                f"{k2} {v:.6f}" if isinstance(v, float) else f"{k2} {v}"
                for k2, v in row.items()))
    for k, r in runs.items():
        del r["state"], r["step"]
        log(f"[steps] {k}: median of steps 1-{steps - 1} {statistics.median(r['ms'][1:]):.3f} ms")
    torch.cuda.empty_cache()
    return runs


def binning_modes_phase(dev, scene, views, images, sargs, b, fwd_out):
    """Phase 11: the binning modes ``depth_bits`` and ``sort_bands`` at full
    width, training view 0 (screen-space inputs ``sargs``, the dense
    binning ``b`` and its forward ``fwd_out``) and the training path.
    Returns the errors of kernels #1-#7 on these layouts, their launches
    through the entry points and the times."""
    import torch

    from gaussian_splatting_tpu_torch.models.gaussians import train_state_from_numpy
    from gaussian_splatting_tpu_torch.ops.rasterize_cuda import (
        _config, fwd_tiles, grad_cap, n_sort_slots, rasterize_tiled)
    from gaussian_splatting_tpu_torch.ops.render import project_and_shade
    from gaussian_splatting_tpu_torch.ops.tiling import (
        binning_slots, isect_and_sort, slot_sort_key, total_slots)
    from gaussian_splatting_tpu_torch.training.config import TrainingConfig

    N = N_GAUSSIANS
    errs, launches, rep = {}, {}, {}
    t_phase = time.perf_counter()

    def binned(tag, **kw):
        before = read_launches()
        out = isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T, **kw)
        torch.cuda.synchronize()
        launches.update(_add(launches, _launch_delta(before)))
        log(f"[{tag}] n_isect {int(out.n_isect)}, n_dropped {int(out.n_dropped)}, "
            f"n_budget_dropped {int(out.n_budget_dropped)}, tile_starts[T] "
            f"{int(out.tile_starts[-1])}")
        return out

    def merge(e):
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)

    # depth_bits, dense, training view 0.
    tag = f"depth_bits {DEPTH_BITS}"
    bq = binned(tag, depth_bits=DEPTH_BITS)
    same = (torch.equal(bq.tile_starts, b.tile_starts) and torch.equal(bq.counts, b.counts)
            and int(bq.n_isect) == int(b.n_isect))
    log(f"[{tag}] tile_starts, counts and n_isect equal to the exact key's: {same}")
    if not same:
        fail(f"[{tag}] the quantized key changed the segment tables")
    kc, bwd, e, _ = hold_layout(sargs, bq, tag, N, None, depth_bits=DEPTH_BITS)
    merge(e)
    # Against the exact key: bit for bit in every tile where no two depths
    # share a level; where some do, the blend order of those entries may
    # change (printed, and the share of pixels beyond the JAX test's 2e-3).
    tied = depth_tie_tiles(b, DEPTH_BITS)
    d = (kc["fwd_out"] - fwd_out).abs()
    img = torch.cat([d[:, 0:3], d[:, 4:5]], 1)
    untied_same = torch.equal(kc["fwd_out"][~tied], fwd_out[~tied])
    rep["depth_bits_image"] = {
        "max_abs_diff": float(img.max()), "tied_tiles": int(tied.sum()),
        "pixels_over_atol": float((img > DEPTH_BITS_IMAGE_ATOL).any(1).float().mean())}
    log(f"[{tag}] forward against the exact key's: bit for bit in the {int((~tied).sum())} "
        f"tiles where no two depths share a level: {untied_same}; {int(tied.sum())} tiles hold "
        f"such a tie: max |diff| rgb/alpha {float(img.max()):.3e}, share of pixels over "
        f"{DEPTH_BITS_IMAGE_ATOL} {rep['depth_bits_image']['pixels_over_atol']:.3e}")
    if not untied_same:
        fail(f"[{tag}] the forward differs from the exact key's in a tile with no level tie")
    del kc, bwd, bq, d, img, tied
    means2d, conics, _, opac, depths, radii = sargs
    tile_key, _, _, _, T = binning_slots(means2d, conics, opac, radii, WIDTH, HEIGHT, TILE,
                                         MAX_T)
    k64, _ = slot_sort_key(tile_key, depths, T)
    k32, _ = slot_sort_key(tile_key, depths, T, depth_bits=DEPTH_BITS)
    del tile_key
    t = in_turns({"exact": lambda: isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T),
                  "depth_bits": lambda: isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK,
                                                       MAX_T, depth_bits=DEPTH_BITS),
                  "sort_int64": lambda: torch.sort(k64, stable=True),
                  "sort_int32": lambda: torch.sort(k32, stable=True)})
    rep["depth_bits_ms"] = t
    log(f"[{tag}] binning incl. pack, ms in turns (A B C D D C B A): exact int64 key "
        f"{t['exact']}, depth_bits {t['depth_bits']}; torch.sort alone of the "
        f"{k64.shape[0]} keys: int64 {t['sort_int64']}, int32 {t['sort_int32']}")
    del k64, k32
    torch.cuda.empty_cache()

    # sort_bands on compact budgets covering the heaviest band. Where the
    # tile cap binds, a band keeps more tiles than the flat path (the cap
    # applies per band), so the comparison needs a view where it does not.
    flat_budgets = band_budgets([sargs], 1)
    bf = binned("bands flat compact", class_budgets=flat_budgets)
    if int(b.n_dropped) or int(bf.n_dropped) or int(bf.n_budget_dropped):
        fail("[bands] the flat binning drops tiles at training view 0: bands and flat differ")
    ntx = -(-WIDTH // TILE)
    flat_out = fwd_tiles(bf.tile_starts, bf.counts, bf.sorted_soa, TILE, ntx, CHUNK)
    rep["bands"] = {"flat_budgets": flat_budgets,
                    "flat_slots": total_slots(N, MAX_T, flat_budgets)}
    flat_fn = (lambda: isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T,
                                      class_budgets=flat_budgets))
    rep["bands"]["flat_peak_gib"] = peak_gib(flat_fn)
    for K in BANDS:
        tag = f"sort_bands {K}"
        budgets = band_budgets([sargs], K)
        bb = binned(tag, class_budgets=budgets, sort_bands=K)
        n_slots = n_sort_slots(N, MAX_T, budgets, K)
        ok = (int(bb.tile_starts[-1]) == n_slots and torch.equal(bb.counts, bf.counts)
              and int(bb.n_isect) == int(bf.n_isect)
              and int(bb.n_dropped) == int(bb.n_budget_dropped) == 0)
        log(f"[{tag}] budgets {budgets}: {n_slots} slots ({K} x {n_slots // K}; flat "
            f"{rep['bands']['flat_slots']}); counts and n_isect equal to the flat compact "
            f"binning's, nothing dropped: {ok}")
        if not ok:
            fail(f"[{tag}] the band binning's tables or counters differ from the flat path's")
        gid = bb.sorted_soa[11, :n_slots].to(torch.int32)
        kc, bwd, e, img_err = hold_layout(sargs, bb, tag, N,
                                          grad_cap(N, MAX_T, CHUNK, 1.0, budgets, K),
                                          flat_out=flat_out, atol=1e-6, gid=gid)
        merge(e)
        w_cap = _config(N, WIDTH, HEIGHT, TILE, CHUNK, MAX_T, 1.0, queue=True,
                        class_budgets=budgets, sort_bands=K).w_cap
        if K == BANDS[-1]:
            q = compare_queue(bb, kc["fwd_out"], kc["plain_out"], bwd, N, tag, w_cap=w_cap)
            merge({"rasterize_fwd_q": q["fwd_q_err"], "rasterize_bwd_q": q["bwd_q_err"]})
            # The queue path through the entry point, forward + backward.
            leaves = [x.detach().requires_grad_(True) for x in sargs[:5]]
            before = read_launches()
            img, alpha, _ = rasterize_tiled(*leaves, sargs[5], WIDTH, HEIGHT, tile_size=TILE,
                                            chunk=CHUNK, class_budgets=budgets, sort_bands=K, queue=True,
                                            depth_grad=False)
            (img.sum() + alpha.sum()).backward()
            torch.cuda.synchronize()
            launches.update(_add(launches, _launch_delta(before)))
            finite = all(bool(torch.isfinite(x.grad).all()) for x in leaves)
            log(f"[{tag}] queue=True forward + backward through rasterize_tiled (w_cap "
                f"{w_cap}): gradients finite {finite}")
            if not finite:
                fail(f"[{tag}] the queue path's gradients are not finite")
            del leaves, img, alpha
        t = in_turns({"flat": flat_fn,
                      "bands": lambda: isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T,
                                                      class_budgets=budgets, sort_bands=K)})
        peak = peak_gib(lambda: isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T,
                                               class_budgets=budgets, sort_bands=K))
        rep["bands"][K] = {"budgets": budgets, "slots": n_slots, "ms": t, "peak_gib": peak,
                           "image_err": img_err, "w_cap": w_cap,
                           "grad_cap": bwd["gcap"]}
        log(f"[{tag}] binning incl. pack, ms in turns (flat, bands, bands, flat): flat "
            f"compact {t['flat']}, bands {t['bands']}; peak memory of one binning "
            f"{peak:.3f} GiB (flat {rep['bands']['flat_peak_gib']:.3f}); grad_cap "
            f"{bwd['gcap']}, w_cap {w_cap}")
        del kc, bwd, bb, gid
        torch.cuda.empty_cache()
    del bf, flat_out

    # Dense bands, K = 2, at the full dense layout.
    tag = "sort_bands 2 dense"
    peak = peak_gib(lambda: isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T,
                                           sort_bands=2))
    bd = binned(tag, sort_bands=2)
    ok = (int(bd.tile_starts[-1]) == 2 * N * MAX_T and torch.equal(bd.counts, b.counts)
          and int(bd.n_isect) == int(b.n_isect))
    log(f"[{tag}] {2 * N * MAX_T} slots, peak memory of one binning {peak:.3f} GiB; tables "
        f"as the flat dense binning's: {ok}")
    if not ok:
        fail(f"[{tag}] the dense band binning's tables differ")
    gid = bd.sorted_soa[11, :2 * N * MAX_T].to(torch.int32)
    kc, bwd, e, _ = hold_layout(sargs, bd, tag, N, grad_cap(N, MAX_T, CHUNK, 1.0, None, 2),
                                flat_out=fwd_out, atol=1e-6, gid=gid)
    merge(e)
    t = in_turns({"dense": lambda: isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T),
                  "bands": lambda: isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T,
                                                  sort_bands=2)}, reps=3)
    rep["dense_bands"] = {"ms": t, "peak_gib": peak}
    log(f"[{tag}] binning incl. pack, ms in turns: dense flat {t['dense']}, bands {t['bands']}")
    del kc, bwd, bd, gid
    torch.cuda.empty_cache()

    # The training path: depth_bits beside the dense step; sort_bands beside
    # the flat compact step, on budgets measured per band over the 4 views
    # of the starting state.
    runs = steps_in_turns(dev, scene, images, views, {
        "dense": TrainingConfig(backend="auto"),
        "depth_bits": TrainingConfig(backend="auto", sort_depth_bits=DEPTH_BITS)}, TRAIN_STEPS)
    launches.update(_add(launches, runs["depth_bits"]["launches"]))
    _check_steps("depth_bits steps", runs["depth_bits"]["rows"], False)
    rep["depth_bits_steps"] = {k: r["ms"] for k, r in runs.items()}
    p = train_state_from_numpy(noisy_train_arrays(scene, seed=1), device=dev).gauss.params
    with torch.no_grad():
        vargs = []
        for v in views:
            proj, col, op = project_and_shade(p.means, p.quats, p.log_scales, p.logit_opacities,
                                              p.sh_coeffs, v["world_view_transform"], v["K"],
                                              WIDTH, HEIGHT, sh_degree=3)
            vargs.append((proj.means2d, proj.conics, col, op, proj.depths, proj.radii))
    del p
    b_flat, b_band = band_budgets(vargs, 1), band_budgets(vargs, BANDS[-1])
    del vargs
    log(f"[steps] budgets over the 4 views: flat {b_flat}, {BANDS[-1]} bands {b_band}")
    runs = steps_in_turns(dev, scene, images, views, {
        "compact": TrainingConfig(backend="auto", class_budgets=b_flat),
        "bands": TrainingConfig(backend="auto", class_budgets=b_band,
                                sort_bands=BANDS[-1])}, BAND_STEPS)
    launches.update(_add(launches, runs["bands"]["launches"]))
    _check_steps("band steps", runs["bands"]["rows"], True)
    rep["band_steps"] = {k: r["ms"] for k, r in runs.items()}
    rep["band_step_budgets"] = {"flat": b_flat, "bands": b_band}
    for name in KERNELS[:7]:
        if launches.get(name, 0) < 1:
            fail(f"[binning modes] kernel {name} never launched through the entry points: "
                 f"{launches}")
    log(f"[binning modes] launches through the entry points {launches}; phase 11 in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"errs": errs, "launches": launches, **rep}


def _timed_logger_class():
    from gaussian_splatting_tpu_torch.utils.metrics import MetricsLogger

    class TimedLogger(MetricsLogger):
        """``MetricsLogger`` that keeps the host time of each image write."""

        def log_image(self, *a, **k):
            t = time.perf_counter()
            out = super().log_image(*a, **k)
            self.event_s.setdefault("image write", []).append(time.perf_counter() - t)
            return out

    return TimedLogger


class _Timed:
    """Mixin for ``GaussianTrainer``: CUDA events at the start of every
    step, and host time (synchronized) of each event method."""

    def _make_step(self, *a):
        import torch

        step = super()._make_step(*a)

        def timed(state, batch):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.step_events.append(e)
            return step(state, batch)

        return timed

    def _event(self, name, fn, *a):
        import torch

        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        self.event_s.setdefault(name, []).append(time.perf_counter() - t)
        return out

    def _grow(self, *a):
        return self._event("grow", super()._grow, *a)

    def _densify(self, *a):
        return self._event("densify", super()._densify, *a)

    def validate(self, *a):
        return self._event("validate", super().validate, *a)

    def _save_final(self, *a):
        return self._event("final save + export", super()._save_final, *a)


def trainer_inputs(dev, scene, raster):
    """The trainer phases' inputs: a ``ViewDataset`` of TRAINER_VIEWS views of
    the clean scene rendered by the port, TRAINER_POINTS of its means (numpy
    seed 3) with their colours, and n_init (the scene's size)."""
    import torch

    from gaussian_splatting_tpu_torch.core.cameras import look_at, make_intrinsics
    from gaussian_splatting_tpu_torch.core.sh import sh0_to_rgb
    from gaussian_splatting_tpu_torch.models.gaussians import state_from_numpy

    K = make_intrinsics(WIDTH, HEIGHT, device=dev)
    views = [{"world_view_transform": look_at(e, (0.0, 0.0, 0.0), device=dev), "K": K}
             for e in view_eyes(TRAINER_VIEWS)]
    clean = state_from_numpy(scene, device=dev)
    with torch.no_grad():
        images = torch.stack([torch.clamp(raster.render_single(clean.params, vp).render, 0, 1)
                              for vp in views])
    dataset = view_dataset(views, images)
    del clean, images
    rng = np.random.default_rng(3)
    pick = rng.choice(scene["means"].shape[0], TRAINER_POINTS, replace=False)
    points = scene["means"][pick]
    colors = np.clip(sh0_to_rgb(torch.as_tensor(scene["features_dc"][pick, 0])).numpy(), 0, 1)
    return dataset, points, colors, max(3 * TRAINER_POINTS, scene["means"].shape[0])


def trainer_phase(dev, scene, raster):
    """Phase 8: the port's trainer on the card through its entry point,
    ``GaussianTrainer(cfg, device).train(dataset, out_dir, points, colors)``:
    a ``ViewDataset`` of TRAINER_VIEWS views of the clean scene rendered by
    the port, TRAINER_POINTS of its means with their colours as the point cloud
    (n_init = initial_gaussians = the scene's size), binning "auto" (the
    trainer chooses compact budgets), initial opacity TRAINER_INIT_OPACITY,
    batch 4, densify from iteration 10 every 10 (top 2 %), an opacity reset
    every TRAINER_RESET_EVERY, validation and the grad-buffer probe at 20
    and 40. Checks: finite losses, the last below
    the first; no logged iteration after the last rebudget (or at all,
    without one) with budget drops over BUDGET_DROP_FRAC of n_isect; the
    grad-buffer probe logged and no "grad-buffer probe failed"; ``final.npz``
    reloads and renders bit for bit what the returned state renders;
    ``final.ply`` holds the alive gaussians; the five kernels of the path
    launched; the native kNN ran. Returns the timings and the launches."""
    import dataclasses
    import json as _json
    import logging
    import tempfile

    import torch

    from gaussian_splatting_tpu_torch.training.checkpoint import load_checkpoint
    from gaussian_splatting_tpu_torch.training.config import TrainingConfig
    from gaussian_splatting_tpu_torch.training.export import read_ply
    from gaussian_splatting_tpu_torch.training.trainer import GaussianTrainer

    class Trainer(_Timed, GaussianTrainer):
        pass

    TimedLogger = _timed_logger_class()

    n_points, iters = TRAINER_POINTS, TRAINER_ITERS
    dataset, points, colors, n_init = trainer_inputs(dev, scene, raster)
    cfg = TrainingConfig(iterations=iters, batch_size=4, initial_gaussians=n_init,
                         init_opacity=TRAINER_INIT_OPACITY, max_gaussians=3 * n_init,
                         densify_from_iteration=10, densify_interval=10,
                         densify_topk_fraction=0.02, opacity_reset_interval=TRAINER_RESET_EVERY,
                         val_interval=20, grad_buffer_frac=0.9, log_scalar_interval=2,
                         log_hist_interval=20, log_image_interval=0,
                         checkpoint_interval=10 * iters)

    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Capture(level=logging.INFO)
    loggers = [logging.getLogger(n) for n in ("gaussian_splatting_tpu_torch.utils.native",
                                              "gaussian_splatting_tpu_torch.training.trainer")]
    for lg in loggers:
        lg.addHandler(handler)
        lg.setLevel(logging.INFO)
    with tempfile.TemporaryDirectory() as td:
        trainer = Trainer(cfg, logger=TimedLogger(td, config=dataclasses.asdict(cfg)),
                          device=dev)
        trainer.step_events, trainer.event_s = [], {}
        trainer.logger.event_s = trainer.event_s
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        state = trainer.train(dataset, td, points=points, colors=colors)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        for lg in loggers:
            lg.removeHandler(handler)
        with open(f"{td}/metrics.jsonl") as f:
            recs = [_json.loads(line) for line in f]
        loaded, _ = load_checkpoint(f"{td}/final.npz", device=dev)
        vm, Kd = (torch.as_tensor(x[0], device=dev) for x in (dataset.viewmats, dataset.Ks))
        a = trainer._render_view(state, vm, Kd, 0, WIDTH, HEIGHT)
        c = trainer._render_view(loaded, vm, Kd, 0, WIDTH, HEIGHT)
        reload_same = torch.equal(a, c)
        n_ply = read_ply(f"{td}/final.ply")["means"].shape[0]
    ends = trainer.step_events
    torch.cuda.synchronize()
    periods = [ends[i].elapsed_time(ends[i + 1]) for i in range(len(ends) - 1)]
    scalars = [r for r in recs if "loss" in r]
    losses = [r["loss"] for r in scalars]
    # Budget drops over the rebudget threshold, by logged iteration; those
    # after the last rebudget are left unhandled.
    over = {r["_step"]: (r["stats/n_budget_dropped"]
                         > BUDGET_DROP_FRAC * max(r["stats/n_isect"], 1)) for r in scalars}
    last_rebudget = trainer._last_rebudget_iter
    unhandled = [s for s, o in over.items() if o and s > last_rebudget]
    logged = sorted(over)

    def clean(it):
        """Iteration ``it`` (1-based) is timed when it is not the first, holds
        no event (densify, validation, probe, reset and histograms fall on
        multiples of 10) and the next logged iteration's drops are under the
        threshold."""
        nxt = next((s for s in logged if s >= it), None)
        return it > 1 and it % 10 != 0 and nxt is not None and not over[nxt]

    # Iteration i + 1 (1-based) of period i.
    plain = [p for i, p in enumerate(periods) if clean(i + 1)]
    n_alive = int(state.gauss.n_alive())
    native = any("native pointops" in m for m in records)
    rebudgets = [m for m in records if "rebudget" in m]
    probes = [(r["_step"], r["stats/grad_buf_written"], r["stats/grad_buf_cap"])
              for r in recs if "stats/grad_buf_cap" in r]
    probe_failed = [m for m in records if "grad-buffer probe failed" in m]
    for m in records:
        if ("budgets" in m or "capacity" in m or "max_tiles" in m or "kNN" in m
                or "grad" in m):
            log(f"[trainer] log: {m[:160]}")
    log(f"[trainer] {iters} iterations of batch 4 at {WIDTH}x{HEIGHT} from {n_points} points, "
        f"n_init {n_init}, init opacity {TRAINER_INIT_OPACITY}, opacity reset every "
        f"{TRAINER_RESET_EVERY}: wall {wall:.2f} s")
    log("[trainer] logged iteration: loss, n_isect, n_budget_dropped (share), n_dropped: "
        + "; ".join(f"{r['_step']}: {r['loss']:.5f}, {r['stats/n_isect']}, "
                    f"{r['stats/n_budget_dropped']} "
                    f"({r['stats/n_budget_dropped'] / max(r['stats/n_isect'], 1):.4f}), "
                    f"{r['stats/n_dropped']}" for r in scalars))
    dkeys = ("densify/cloned", "densify/split", "densify/pruned", "densify/n_after")
    densify = [{k: r[k] for k in dkeys} for r in recs if "densify/n_after" in r]
    log(f"[trainer] final config: max_t {trainer.config.max_tiles_per_gaussian}, budgets "
        f"{trainer.config.class_budgets}, grad_buffer_frac {trainer.config.grad_buffer_frac}; "
        f"rebudgets {trainer._rebudget_count}; alive {n_alive} of capacity "
        f"{state.gauss.capacity}; densify events "
        f"{densify}; "
        f"val {[r['val/psnr'] for r in recs if 'val/psnr' in r]}; grad-buffer probes "
        f"(iteration, written, cap) {probes}")
    log(f"[trainer] reload of final.npz renders bit for bit: {reload_same}; final.ply rows "
        f"{n_ply} (alive {n_alive}); native kNN ran: {native}; launches {launches}; peak "
        f"device memory {peak:.2f} GiB")
    med = statistics.median(plain) if plain else float("nan")
    log(f"[trainer] iteration time (CUDA events, start to start) median over the "
        f"{len(plain)} iterations after the first without an event and with budget drops "
        f"under {BUDGET_DROP_FRAC:.0%} of n_isect at the next log: "
        f"{med:.3f} ms (all: {[round(x, 1) for x in periods]}); events (host, synchronized): "
        f"{ {k: [round(x * 1e3, 1) for x in v] for k, v in trainer.event_s.items()} } ms")
    if not (losses and np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"[trainer] losses not finite or not falling: {losses}")
    if unhandled:
        fail(f"[trainer] class-budget drops over {BUDGET_DROP_FRAC:.0%} of n_isect at logged "
             f"iterations {unhandled}, after the last rebudget (iteration "
             f"{last_rebudget if rebudgets else 'none'})")
    if not probes or probe_failed:
        fail(f"[trainer] the grad-buffer probe did not run or failed: {probe_failed}")
    if not plain:
        fail("[trainer] no iteration to time")
    if not reload_same or n_ply != n_alive or not native:
        fail("[trainer] the checkpoint, the PLY or the kNN path is wrong")
    if min(launches[k] for k in KERNELS[:5]) < 1:
        fail(f"[trainer] a kernel of the trainer's path never launched: {launches}")
    return {"iter_ms": med, "periods": periods, "events": trainer.event_s, "launches": launches,
            "peak_gib": peak, "wall_s": wall, "losses": losses}


def mesh_shape(n_cards):
    """Phase 10's ("data", "model") mesh on ``n_cards`` cards: 1 -> 1x1,
    2-3 -> 1x2, 4 or more -> 2x2."""
    n = min(n_cards, 4)
    return (2, 2) if n == 4 else (1, 2) if n >= 2 else (1, 1)


class _HostEvent:
    """``torch.cuda.Event`` on the host clock, for a rehearsal of phase 10's
    spawned ranks on the CPU."""

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def _cpu_stand_ins():
    import torch

    torch.cuda.Event = _HostEvent
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.memory_allocated = lambda *a, **k: 0


def _step_ms(step, state, batch):
    """One training step bracketed by CUDA events: (state, metrics, ms)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    state, m = step(state, batch)
    b.record()
    b.synchronize()
    return state, m, a.elapsed_time(b)


def _launch_delta(before):
    return {k: v - before[k] for k, v in read_launches().items()}


def _add(acc, delta):
    return {k: acc.get(k, 0) + v for k, v in delta.items()}


def _sign_flip_errors(got, want, lrs):
    """Parameters after one Adam step under the sign-flip rule: per group,
    (max |got - want| where |g| > 1e-3 of the group's largest gradient,
    max |got - want| / (2 lr) everywhere), g from the reference's first
    moment (mu = (1 - b1) g after one step from zero moments)."""
    from gaussian_splatting_tpu_torch.models.gaussians import PARAM_KEYS

    out = {}
    for k in PARAM_KEYS:
        g = getattr(want.opt.mu, k) / 0.1
        big = g.abs() > 1e-3 * g.abs().max()
        d = (getattr(got.gauss.params, k) - getattr(want.gauss.params, k)).abs()
        out[k] = (float(d[big].max()) if bool(big.any()) else 0.0,
                  float(d.max()) / (2.0 * float(lrs[k])))
    return out


def device_times(fn):
    """Device time (ms) by kernel name of what ``fn()`` launches, from
    ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name] = (per_name.get(e.name, 0.0)
                                + (e.time_range.end - e.time_range.start) / 1e3)
    return per_name


def mesh_steps(mesh, dev, scene, views, images, rank):
    """Phase 10's steps: MESH_STEPS sharded steps dense, then with the
    trainer's compact budgets for the starting state, each beside
    ``make_train_step`` from the same state in turns (rank 0); after step 1
    the loss, L1, stats and parameters held against it. Returns the
    report."""
    import torch

    from gaussian_splatting_tpu_torch.models.gaussians import train_state_from_numpy
    from gaussian_splatting_tpu_torch.parallel import make_sharded_train_step
    from gaussian_splatting_tpu_torch.parallel import sharded_step as ss
    from gaussian_splatting_tpu_torch.training.config import TrainingConfig
    from gaussian_splatting_tpu_torch.training.step import ViewBatch, make_train_step

    batch = ViewBatch(images=images,
                      viewmats=torch.stack([v["world_view_transform"] for v in views]),
                      Ks=torch.stack([v["K"] for v in views]))
    arrays = noisy_train_arrays(scene, seed=1)

    def fresh():
        return train_state_from_numpy({k: np.array(v) for k, v in arrays.items()}, device=dev)

    budgets = batch_class_budgets(dev, fresh(), views, images)
    rep = {"launches": {}}
    for name, cfg in (("dense", TrainingConfig(backend="auto")),
                      ("compact", TrainingConfig(backend="auto", class_budgets=budgets))):
        single = make_train_step(cfg, WIDTH, HEIGHT, 3, cfg.backend, SCENE_EXTENT, device=dev)
        sharded, band_h, h_pad = make_sharded_train_step(cfg, mesh, WIDTH, HEIGHT, 3,
                                                         cfg.backend, SCENE_EXTENT)
        s_state = fresh() if rank == 0 else None
        m_state = ss.shard_state(fresh(), mesh)
        r = {"single_ms": [], "mesh_ms": [], "single_loss": [], "mesh_loss": [],
             "band_h": band_h, "h_pad": h_pad}
        for i in range(MESH_STEPS):
            if rank == 0:
                if i == 2:
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                s_state, sm, ms = _step_ms(single, s_state, batch)
                if i == 2:
                    r["single_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
                    r["single_total_gib"] = torch.cuda.max_memory_allocated() / 2**30
                r["single_ms"].append(ms)
                r["single_loss"].append(float(sm["loss"]))
            if i == 2:
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            before = read_launches()
            ss.reset_collectives()
            m_state, mm, ms = _step_ms(sharded, m_state, batch)
            coll = ss.collectives()
            rep["launches"] = _add(rep["launches"], _launch_delta(before))
            if i == 2:
                r["mesh_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
                r["mesh_total_gib"] = torch.cuda.max_memory_allocated() / 2**30
            r["mesh_ms"].append(ms)
            r["mesh_loss"].append(float(mm["loss"]))
            stats = {k: int(mm[f"stats/{k}"]) for k in
                     ("n_isect", "n_dropped", "n_budget_dropped", "n_grad_dropped")}
            if rank == 0:
                log(f"[mesh {name}] step {i}: loss {r['mesh_loss'][-1]:.7f} (one device "
                    f"{r['single_loss'][-1]:.7f}), l1 {float(mm['l1']):.6f}, stats {stats}, "
                    f"{ms:.3f} ms (one device {r['single_ms'][-1]:.3f} ms)")
            if not np.isfinite(r["mesh_loss"][-1]) or stats["n_grad_dropped"]:
                fail(f"[mesh {name}] step {i}: loss not finite or gradient entries dropped")
            budget_ok = (stats["n_budget_dropped"] == 0 if i == 0 else
                         stats["n_budget_dropped"] <= BUDGET_DROP_FRAC * stats["n_isect"])
            if not budget_ok:
                fail(f"[mesh {name}] step {i}: budget drops {stats}")
            if i == 0:
                r["collectives"] = {f"{op}/{axis}": sum(1 for c in coll if c[:2] == (op, axis))
                                    for op, axis in sorted({c[:2] for c in coll})}
                full = ss.gather_state(m_state, mesh)
                if rank == 0:
                    lrs = {"means": float(sm["xyz_lr"]), "quats": cfg.lr_rotation,
                           "log_scales": cfg.lr_scaling, "logit_opacities": cfg.lr_opacity,
                           "features_dc": cfg.lr_features_dc,
                           "features_rest": cfg.lr_features_rest}
                    r["param_err"] = _sign_flip_errors(full, s_state, lrs)
                    r["loss_rel"] = abs(float(mm["loss"]) - float(sm["loss"])) / abs(
                        float(sm["loss"]))
                    r["l1_rel"] = abs(float(mm["l1"]) - float(sm["l1"])) / abs(float(sm["l1"]))
                    s_stats = {k: int(sm[f"stats/{k}"]) for k in stats}
                    log(f"[mesh {name}] step 1 against one device: loss rel {r['loss_rel']:.3e}"
                        f", l1 rel {r['l1_rel']:.3e}, stats {stats} vs {s_stats}, parameters "
                        f"(max err where |g| is large, max err / 2 lr): "
                        f"{ {k: (f'{a:.2e}', f'{b:.3f}') for k, (a, b) in r['param_err'].items()} }")
                    if (abs(float(mm["loss"]) - float(sm["loss"]))
                            > 1e-7 + MESH_LOSS_RTOL * abs(float(sm["loss"]))
                            or abs(float(mm["l1"]) - float(sm["l1"]))
                            > 1e-6 + MESH_L1_RTOL * abs(float(sm["l1"]))
                            or stats != s_stats
                            or any(a >= MESH_PARAM_ATOL or b > 1 + 1e-4
                                   for a, b in r["param_err"].values())):
                        fail(f"[mesh {name}] the sharded step disagrees with make_train_step")
                del full
        for who in ("mesh", "single") if rank == 0 else ("mesh",):
            losses = r[f"{who}_loss"]
            if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
                fail(f"[mesh {name}] {who} losses not falling: {losses}")
        if name == "dense":
            # One step of each under the profiler: the collectives' time
            # and the kernels whose time differs most between the two.
            mt = device_times(lambda: sharded(m_state, batch))
            # "nccl:<op>" is a device range around each collective's work
            # (NCCL's kernels, or a copy with one rank): it overlaps that
            # work, so the busy time leaves it out.
            r["nccl_ms"] = {k: v for k, v in mt.items() if k.startswith("nccl:")}
            mt = {k: v for k, v in mt.items() if not k.startswith("nccl:")}
            r["busy_ms"] = sum(mt.values())
            if rank == 0:
                st = device_times(lambda: single(s_state, batch))
                r["single_busy_ms"] = sum(st.values())
                diff = {k: mt.get(k, 0.0) - st.get(k, 0.0) for k in set(mt) | set(st)}
                r["kernel_diff_ms"] = dict(sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:12])
        rep[name] = r
        del s_state, m_state, single, sharded
        torch.cuda.empty_cache()
    rep["budgets"] = budgets
    return rep


def mesh_trainer(mesh, dev, inputs, out_dir, rank):
    """Phase 10's trainer: ``GaussianTrainer(cfg, mesh=mesh).train`` for
    MESH_TRAINER_ITERS iterations at 1M gaussians, 1080p, batch 4, initial
    opacity TRAINER_INIT_OPACITY, one densify event (at MESH_DENSIFY_AT),
    validation and the grad-buffer probe at the end, into ``out_dir`` (the
    same on every rank); ``save_checkpoint`` counted on each rank."""
    import dataclasses

    import torch

    from gaussian_splatting_tpu_torch.models.gaussians import train_state_to_numpy
    from gaussian_splatting_tpu_torch.training import trainer as trainer_mod
    from gaussian_splatting_tpu_torch.training.checkpoint import load_checkpoint
    from gaussian_splatting_tpu_torch.training.config import TrainingConfig

    class Trainer(_Timed, trainer_mod.GaussianTrainer):
        pass

    dataset, points, colors, n_init = inputs
    iters = MESH_TRAINER_ITERS
    cfg = TrainingConfig(iterations=iters, batch_size=4, initial_gaussians=n_init,
                         init_opacity=TRAINER_INIT_OPACITY, max_gaussians=3 * n_init,
                         densify_from_iteration=MESH_DENSIFY_AT - 1,
                         densify_interval=MESH_DENSIFY_AT, densify_topk_fraction=0.02,
                         opacity_reset_interval=TRAINER_RESET_EVERY, val_interval=iters,
                         grad_buffer_frac=0.9, log_scalar_interval=2, log_hist_interval=iters,
                         log_image_interval=0, checkpoint_interval=10 * iters)
    saves = []
    save = trainer_mod.save_checkpoint

    def counted(path, *a, **k):
        saves.append(path.rsplit("/", 1)[-1])
        return save(path, *a, **k)

    logger = _timed_logger_class()(out_dir, config=dataclasses.asdict(cfg)) if rank == 0 else None
    trainer = Trainer(cfg, logger=logger, mesh=mesh)
    trainer.step_events, trainer.event_s = [], {}
    if logger is not None:
        logger.event_s = trainer.event_s
    trainer_mod.save_checkpoint = counted
    try:
        torch.cuda.synchronize()
        before = read_launches()
        t0 = time.perf_counter()
        state = trainer.train(dataset, out_dir, points=points, colors=colors)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launch_delta(before)
    finally:
        trainer_mod.save_checkpoint = save
    ends = trainer.step_events
    periods = [ends[i].elapsed_time(ends[i + 1]) for i in range(len(ends) - 1)]
    # Period i holds iteration i + 1 (1-based) and its events.
    plain = [p for i, p in enumerate(periods) if i + 1 not in (1, MESH_DENSIFY_AT, iters)]
    rep = {"launches": launches, "saves": saves, "wall_s": wall, "periods": periods,
           "iter_ms": statistics.median(plain) if plain else float("nan"),
           "capacity": state.gauss.capacity, "n_alive": int(state.gauss.n_alive()),
           "events": trainer.event_s}
    if rank == 0:
        import json as _json

        with open(f"{out_dir}/metrics.jsonl") as f:
            recs = [_json.loads(line) for line in f]
        rep["losses"] = [r["loss"] for r in recs if "loss" in r]
        rep["densify"] = [r["densify/n_after"] for r in recs if "densify/n_after" in r]
        loaded, _ = load_checkpoint(f"{out_dir}/final.npz", device=dev)
        a, b = train_state_to_numpy(state), train_state_to_numpy(loaded)
        rep["reload_equal"] = set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)
    return rep


def mesh_rank(rank, world, port, device_type, shape, scene, views_np, images_np, inputs,
              out_dir):
    """Phase 10 on one rank: the process group (NCCL on the card, gloo on
    the CPU), the mesh, ``mesh_steps`` and ``mesh_trainer``. Returns the
    report (rank 0's is the phase's)."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    from gaussian_splatting_tpu_torch.parallel import init_multihost, make_mesh

    dev = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    if world > 1:
        os.environ["LOCAL_RANK"] = str(rank)
        init_multihost(f"localhost:{port}", world, rank, device=dev,
                       timeout=datetime.timedelta(seconds=300))
    mesh = make_mesh(*shape, device=dev)
    try:
        backend = dist.get_backend()
        if rank == 0:
            log(f"[mesh] {shape[0]}x{shape[1]} mesh, world {world}, over {backend} on "
                f"{[str(torch.device(device_type, r)) for r in range(world)]}")
        if device_type == "cuda" and backend != "nccl":
            fail(f"[mesh] the process group runs over {backend}, not NCCL")
        views = [{"world_view_transform": torch.as_tensor(v, device=dev),
                  "K": torch.as_tensor(K, device=dev)} for v, K in views_np]
        images = torch.as_tensor(images_np, device=dev)
        rep = mesh_steps(mesh, dev, scene, views, images, rank)
        del views, images
        torch.cuda.empty_cache()
        rep["trainer"] = mesh_trainer(mesh, dev, inputs, out_dir, rank)
        rep.update(shape=shape, world=world, backend=backend)
        return rep
    finally:
        dist.destroy_process_group()


def _mesh_rank_entry(rank, world, port, device_type, shape, out_dir, args):
    import pickle

    import torch

    from gaussian_splatting_tpu_torch.ops import _build

    if device_type == "cpu":
        _cpu_stand_ins()
    else:
        _build.build(KERNELS)
        torch.backends.cuda.matmul.allow_tf32 = False
    rep = mesh_rank(rank, world, port, device_type, shape, *args, out_dir)
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(rep, f)


def mesh_phase(dev, scene, views, images, inputs, trainer_iter_ms, n_cards=None):
    """Phase 10: the mesh (``mesh_shape`` of ``n_cards``, the card count
    unless given): one rank in this process, or one spawned process a card.
    Checks and logs; returns rank 0's report."""
    import pickle
    import socket
    import tempfile

    import torch

    n = n_cards if n_cards is not None else torch.cuda.device_count()
    shape = mesh_shape(n)
    world = shape[0] * shape[1]
    views_np = [(v["world_view_transform"].cpu().numpy(), v["K"].cpu().numpy()) for v in views]
    with tempfile.TemporaryDirectory() as td:
        args = (scene, views_np, images.cpu().numpy(), inputs)
        if world == 1:
            rep = mesh_rank(0, 1, None, dev.type, shape, *args, td)
        else:
            import torch.multiprocessing as mp

            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            mp.start_processes(_mesh_rank_entry, args=(world, port, dev.type, shape, td, args),
                               nprocs=world, start_method="spawn")
            reps = []
            for r in range(world):
                with open(f"{td}/rank{r}.pkl", "rb") as f:
                    reps.append(pickle.load(f))
            rep = reps[0]
            rep["launches"] = {k: sum(x["launches"][k] for x in reps) for k in rep["launches"]}
            rep["trainer"]["saves_by_rank"] = [x["trainer"]["saves"] for x in reps]
    tr = rep["trainer"]
    saves_by_rank = tr.get("saves_by_rank", [tr["saves"]])
    launches = {k: rep["launches"][k] + tr["launches"][k] for k in rep["launches"]}
    for name in ("dense", "compact"):
        r = rep[name]
        log(f"[mesh {name}] median step (CUDA events, steps 1-{MESH_STEPS - 1}): sharded "
            f"{statistics.median(r['mesh_ms'][1:]):.3f} ms, one device "
            f"{statistics.median(r['single_ms'][1:]):.3f} ms ({[round(x, 3) for x in r['mesh_ms']]}"
            f" vs {[round(x, 3) for x in r['single_ms']]}); peak device memory above the "
            f"state during one step: sharded {r['mesh_peak_gib']:.3f} GiB, one device "
            f"{r['single_peak_gib']:.3f} GiB (totals {r['mesh_total_gib']:.3f} / "
            f"{r['single_total_gib']:.3f}); band_h {r['band_h']}, h_pad {r['h_pad']}; "
            f"collectives a step {r['collectives']}")
    d = rep["dense"]
    log(f"[mesh dense] one sharded step under torch.profiler: device time {d['busy_ms']:.3f} "
        f"ms (one device {d['single_busy_ms']:.3f}), NCCL {sum(d['nccl_ms'].values()):.3f} ms "
        f"(with more than one rank this includes the wait for the others): "
        f"{ {k[:60]: round(v, 4) for k, v in d['nccl_ms'].items()} }; kernels whose time "
        f"differs most, sharded - one device (ms): "
        f"{[(k[:160], round(v, 3)) for k, v in d['kernel_diff_ms'].items()]}")
    log(f"[mesh trainer] {MESH_TRAINER_ITERS} iterations on the {shape[0]}x{shape[1]} mesh: "
        f"wall {tr['wall_s']:.2f} s, median iteration {tr['iter_ms']:.3f} ms (phase 8, one "
        f"device: {trainer_iter_ms:.3f} ms; all: {[round(x, 1) for x in tr['periods']]}); "
        f"losses {[round(x, 5) for x in tr['losses']]}; densify n_after {tr['densify']}; "
        f"capacity {tr['capacity']}, alive {tr['n_alive']}; saves by rank {saves_by_rank}; "
        f"final.npz reloads equal to the gathered state: {tr['reload_equal']}; events "
        f"{ {k: [round(x * 1e3, 1) for x in v] for k, v in tr['events'].items()} } ms")
    log(f"[mesh] launches: sharded steps {rep['launches']}, trainer {tr['launches']}")
    losses = tr["losses"]
    if not (losses and np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"[mesh trainer] losses not finite or not falling: {losses}")
    if len(tr["densify"]) != 1 or not tr["reload_equal"]:
        fail("[mesh trainer] no densify event, or final.npz differs from the gathered state")
    if saves_by_rank[0] != ["final.npz"] or any(saves_by_rank[1:]):
        fail(f"[mesh trainer] files not written once by rank 0: {saves_by_rank}")
    for what, counts in (("sharded steps", rep["launches"]), ("trainer", tr["launches"])):
        if min(counts[k] for k in KERNELS[:5]) < 1:
            fail(f"[mesh] a kernel of the training path never launched in the {what}: {counts}")
    rep["all_launches"] = launches
    return rep


def mesh_alone():
    """Phase 10 alone on the card, after the build and the render phase it
    takes its images from: ``python -c "import chip_smoke; chip_smoke.mesh_alone()"``
    from the repository root (one card, or up to four for a 1x2 or 2x2
    mesh). Phase 8's time is not measured in this run."""
    import torch

    from gaussian_splatting_tpu_torch.core.cameras import look_at, make_intrinsics
    from gaussian_splatting_tpu_torch.models.gaussians import state_from_numpy
    from gaussian_splatting_tpu_torch.ops import _build

    _build.build(KERNELS)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    scene = scene_3d(N_GAUSSIANS, seed=0)
    K = make_intrinsics(WIDTH, HEIGHT, device=dev)
    views = [{"world_view_transform": look_at(e, (0.0, 0.0, 0.0), device=dev), "K": K}
             for e in view_eyes()]
    raster, images, _ = render_phase(dev, state_from_numpy(scene, device=dev), views)
    rep = mesh_phase(dev, scene, views, images, trainer_inputs(dev, scene, raster),
                     float("nan"))
    log(f"[mesh] phase 10 alone: launches {rep['all_launches']}")


def modes_inputs(dev, scene, views):
    """Phase 11's inputs when it runs alone: training view 0 of phase 5's
    noisy starting state (screen-space inputs, the dense binning and its
    forward)."""
    import torch

    from gaussian_splatting_tpu_torch.models.gaussians import train_state_from_numpy
    from gaussian_splatting_tpu_torch.ops.rasterize_cuda import fwd_tiles
    from gaussian_splatting_tpu_torch.ops.render import project_and_shade
    from gaussian_splatting_tpu_torch.ops.tiling import isect_and_sort

    p = train_state_from_numpy(noisy_train_arrays(scene, seed=1), device=dev).gauss.params
    with torch.no_grad():
        proj, colors, opac = project_and_shade(
            p.means, p.quats, p.log_scales, p.logit_opacities, p.sh_coeffs,
            views[0]["world_view_transform"], views[0]["K"], WIDTH, HEIGHT, sh_degree=3)
    sargs = (proj.means2d, proj.conics, colors, opac, proj.depths, proj.radii)
    b = isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T)
    return sargs, b, fwd_tiles(b.tile_starts, b.counts, b.sorted_soa, TILE, -(-WIDTH // TILE),
                               CHUNK)


def modes_alone():
    """Phase 11 alone on the card, after the build and the render phase it
    takes its images from, at training view 0 of the noisy starting state:
    ``python -c "import chip_smoke; chip_smoke.modes_alone()"`` from the
    repository root."""
    import torch

    from gaussian_splatting_tpu_torch.core.cameras import look_at, make_intrinsics
    from gaussian_splatting_tpu_torch.models.gaussians import state_from_numpy
    from gaussian_splatting_tpu_torch.ops import _build

    _build.build(KERNELS)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    scene = scene_3d(N_GAUSSIANS, seed=0)
    K = make_intrinsics(WIDTH, HEIGHT, device=dev)
    views = [{"world_view_transform": look_at(e, (0.0, 0.0, 0.0), device=dev), "K": K}
             for e in view_eyes()]
    _, images, _ = render_phase(dev, state_from_numpy(scene, device=dev), views)
    rep = binning_modes_phase(dev, scene, views, images, *modes_inputs(dev, scene, views))
    log(f"[binning modes] phase 11 alone: errors {rep['errs']}")


def deep_tiles(seed, ts, ntx, nty, per_tile):
    """``per_tile`` entries in each tile of a ntx x nty tile image, as the
    raster kernels take them (tile_starts, counts, a (16, M) SoA with rows
    10 = 1 and 11 = entry index, numpy), every one covering its whole tile
    (isotropic, sigma 2 ts, the mean inside the tile): entries [0, 256),
    opacity 0.3-0.6 and blue, take every pixel's transmittance below 1e-4
    within their first few dozen, inside the first 256-entry stage of the
    first chunk; entries [256, 2048), opacity 0.02-0.05 and red, would count
    only if a stage boundary started the stop rule again; entries from 2048
    on, opacity 0.02-0.3 and green, are the second chunk at chunk 2048,
    where the pixels do start again."""
    rng = np.random.default_rng(seed)
    n = ntx * nty * per_tile
    tile = np.repeat(np.arange(ntx * nty), per_tile)
    k = np.tile(np.arange(per_tile), ntx * nty)
    ox, oy = (tile % ntx) * ts, (tile // ntx) * ts
    means = np.stack([ox + rng.uniform(0.0, ts, size=n), oy + rng.uniform(0.0, ts, size=n)])
    ci = np.full(n, 1.0 / (2.0 * ts) ** 2)
    op = np.where(k < 256, rng.uniform(0.3, 0.6, size=n),
                  np.where(k < 2048, rng.uniform(0.02, 0.05, size=n),
                           rng.uniform(0.02, 0.3, size=n)))
    rgb = np.zeros((3, n))
    rgb[2, k < 256] = rng.uniform(0.2, 1.0, size=int((k < 256).sum()))
    rgb[0, (k >= 256) & (k < 2048)] = 1.0
    rgb[1, k >= 2048] = 1.0
    soa = np.zeros((16, n + 8), np.float32)
    soa[:10, :n] = np.concatenate([means, np.stack([ci, np.zeros(n), ci]), op[None], rgb,
                                   rng.uniform(1.0, 10.0, size=(1, n))])
    soa[10, :n] = 1.0
    soa[11, :n] = np.arange(n)
    starts = (np.arange(ntx * nty + 1) * per_tile).astype(np.int32)
    return starts, np.full(ntx * nty, per_tile, np.int32), soa


def deep_tiles_phase(dev):
    """Phase 12, the stages of a long chunk: ``deep_tiles`` at tile sizes 8,
    16 and 32 (32 tiles each), DEEP_PER_TILE entries a tile, at chunk 2048
    (eight stages, then a second chunk) and 8192 (one chunk of twelve
    stages): the forward against its plain version, its red row exactly 0
    (a stage boundary that started the stop rule again would blend red
    entries) and, at chunk 2048, some green (the pixels start again in the
    second chunk); the queue forward equal to the loop forward bit for bit, the backward +
    kernel reduce against the plain backward + plain reduce under the
    backward's gates, and the meta equal. Returns the largest errors."""
    import torch

    from gaussian_splatting_tpu_torch.ops.rasterize_cuda import (
        bwd_tiles, bwd_tiles_plain, cdiv, fwd_tiles, fwd_tiles_plain, fwd_tiles_q)
    from gaussian_splatting_tpu_torch.ops.tiling import chunk_queue, reduce_padded_grads

    errs = {"fwd": 0.0, "bwd": 0.0}
    for ts in (8, 16, 32):
        ntx, nty = 8, 4
        starts, counts, soa = (torch.as_tensor(x, device=dev)
                               for x in deep_tiles(ts, ts, ntx, nty, DEEP_PER_TILE))
        n = int(counts.sum())
        for chunk in WIDE_CHUNKS:
            tag = f"deep tiles ts {ts}, chunk {chunk}"
            k_out = fwd_tiles(starts, counts, soa, ts, ntx, chunk)
            p_out, _ = fwd_tiles_plain(starts, counts, soa, ts, ntx, chunk)
            diff = (k_out - p_out).abs()
            err_rgbw = float(torch.cat([diff[:, 0:3], diff[:, 4:8]], 1).max())
            err_depth = float(diff[:, 3].max())
            red = float(k_out[:, 0].max())
            green = float(p_out[:, 1].max())
            wtile, cum, n_work = chunk_queue(counts, chunk, cdiv(n, chunk) + counts.shape[0])
            q_out = fwd_tiles_q(wtile, cum, starts, counts, n_work.reshape(1), soa, ts, ntx,
                                chunk)
            same = torch.equal(q_out, k_out)
            gen = torch.Generator(device=dev).manual_seed(ts)
            gout = torch.randn(k_out.shape, generator=gen, device=dev)
            gout[:, 5:] = 0.0
            gcap = cdiv(n, chunk) * chunk
            k_grad, k_meta = bwd_tiles(starts, counts, soa, gout, k_out, ts, ntx, chunk, n,
                                       gcap)
            k_sums = reduce_padded_grads(k_grad, n, k_meta[0], with_depth=True)
            p_grad, p_meta, _ = bwd_tiles_plain(starts, counts, soa, gout, k_out, ts, ntx,
                                                chunk, n, gcap)
            p_sums = plain_reduce(p_grad, n, p_meta[0], with_depth=True)
            stats, ok = grad_errors(k_sums, p_sums)
            km, pm = k_meta.tolist(), p_meta.tolist()
            errs["fwd"] = max(errs["fwd"], err_rgbw, err_depth)
            errs["bwd"] = max(errs["bwd"], max(st["max_err"] for st in stats.values()))
            log(f"[{tag}] {n} entries: forward kernel vs plain max |diff| rgb/sum_w "
                f"{err_rgbw:.3e}, depth {err_depth:.3e}; kernel's largest red (entries "
                f"256-2047) {red:.3e}, plain's largest green (entries 2048 on) {green:.3e}; "
                f"queue forward == "
                f"loop forward: {same}; backward kernel + reduce vs plain: meta kernel {km}, "
                f"plain {pm}; rel_l2 {max(st.get('rel_l2', 0.0) for st in stats.values()):.3e}")
            if not (err_rgbw <= 1e-5 and err_depth <= 1e-4) or not bool(
                    torch.isfinite(k_out).all()):
                fail(f"[{tag}] forward kernel disagrees with fwd_tiles_plain")
            if not same:
                fail(f"[{tag}] the queue forward differs from the loop forward")
            if km != pm or not ok or not all(bool(torch.isfinite(v).all())
                                              for v in k_sums.values()):
                for key, st in stats.items():
                    log(f"[{tag}]   {key}: " + ", ".join(f"{k} {v:.3e}" for k, v in st.items()))
                fail(f"[{tag}] backward kernel disagrees with bwd_tiles_plain")
            if red != 0.0:
                fail(f"[{tag}] entries after the stop blended: a stage restarted the stop rule")
            if (chunk < DEEP_PER_TILE) != (green > 0.0):
                fail(f"[{tag}] the second chunk's entries blended {green} (expected only when "
                     f"there is a second chunk)")
    return errs


def wide_settings_phase(dev, state, scene, views, images, sargs, b, fwd_out, bw):
    """Phase 12: the settings the port used to refuse, at full width,
    training view 0 (screen-space inputs ``sargs``, the dense binning ``b``
    at CHUNK, its forward ``fwd_out`` and ``compare_backward``'s report
    ``bw``), and on the render and training paths. Returns the errors,
    times, bounds and launches at each setting."""
    import torch

    from gaussian_splatting_tpu_torch.ops.partition import (
        bucket_partition, bucket_partition_plain, quantum_for)
    from gaussian_splatting_tpu_torch.ops.rasterize_cuda import (
        bwd_tiles, bwd_tiles_q, fwd_tiles, fwd_tiles_plain, fwd_tiles_q, rasterize_tiled)
    from gaussian_splatting_tpu_torch.ops.render import render
    from gaussian_splatting_tpu_torch.ops.tiling import BUCKET_C, isect_and_sort
    from gaussian_splatting_tpu_torch.training.config import TrainingConfig

    t_phase = time.perf_counter()
    N, T, P = N_GAUSSIANS, b.counts.shape[0], TILE * TILE
    ntx = -(-WIDTH // TILE)
    n_is = int(b.n_isect)
    rep = {"partition": {}, "raster": {}}

    # Bucket binning at B = 64 (the default headroom, then 4: no drop) and
    # B = 2048 (q = 1, a window of 4C).
    quanta = {BUCKETS: quantum_for(BUCKET_C, BUCKETS, BUCKET_HEADROOM)}
    for B, h in ((WIDE_BUCKETS[0], BUCKET_HEADROOM), (WIDE_BUCKETS[0], 4.0),
                 (WIDE_BUCKETS[1], BUCKET_HEADROOM)):
        tag = f"wide B {B}, headroom {h}"
        bk = compare_partition(sargs, b, fwd_out, bw, tag, buckets=B, headroom=h)
        if h == 4.0 and bk["n_drop"]:
            fail(f"[{tag}] bucket drops at headroom 4 ({bk['n_drop']}): the forward cannot be "
                 f"held to the dense one")
        tile_key, depths, Tb = bk["tile_key"], bk["depths"], bk["T"]
        if h == BUCKET_HEADROOM:
            quanta[B] = bk["q"]
            kept, cols = int(bk["out"][2].sum()), bk["out"][0].numel()
            rep["partition"][B] = {
                "q": bk["q"], "max_abs_err": bk["err"], "n_bucket_dropped": bk["n_drop"],
                "layout_errs": bk["layout_errs"], "output_columns": cols,
                # tiles of every slot, depths of the kept ones, 12 B an output column
                "bound_ms": (4 * tile_key.shape[0] + 4 * kept + 12 * cols + 8 * B)
                / HBM_BYTES_PER_S * 1e3,
                "plain_ms": cuda_ms(lambda B=B, q=bk["q"]: bucket_partition_plain(
                    tile_key, depths, Tb, B, q, C=BUCKET_C), reps=3, warmup=1)}
        del bk
        torch.cuda.empty_cache()
    part_turns = in_turns({B: (lambda B=B, q=q: bucket_partition(tile_key, depths, Tb, B, q,
                                                                  C=BUCKET_C))
                           for B, q in quanta.items()}, reps=7)
    log(f"[wide] partition kernel ms in turns (each B twice, B {BUCKETS} the old setting): "
        f"{ {B: [round(x, 4) for x in v] for B, v in part_turns.items()} }")
    for B in WIDE_BUCKETS:
        rep["partition"][B]["ms"] = statistics.median(part_turns[B])
    rep["partition"][BUCKETS] = {"ms_in_turns": part_turns[BUCKETS]}
    del tile_key, depths

    # Raster chunks 2048 and 8192 (staged 256 entries at a time) on the
    # dense layout, and the old chunk beside them in turns.
    gout = bw["gout"]
    gcap = bw["gcap"]
    old = {"rasterize_fwd": lambda: fwd_tiles(b.tile_starts, b.counts, b.sorted_soa, TILE, ntx,
                                              CHUNK),
           "rasterize_bwd": lambda: bwd_tiles(b.tile_starts, b.counts, b.sorted_soa, gout,
                                              fwd_out, TILE, ntx, CHUNK, N, gcap)}
    q256 = queue_for(b)
    old["rasterize_fwd_q"] = lambda: fwd_tiles_q(*q256[:2], b.tile_starts, b.counts, q256[2],
                                                 b.sorted_soa, TILE, ntx, CHUNK)
    old["rasterize_bwd_q"] = lambda: bwd_tiles_q(*q256[:2], b.tile_starts, b.counts, q256[2],
                                                 b.sorted_soa, gout, fwd_out, TILE, ntx, CHUNK,
                                                 N, gcap)
    turns = {k: {CHUNK: []} for k in old}
    for chunk in WIDE_CHUNKS:
        tag = f"wide chunk {chunk}"
        bc = isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, chunk, MAX_T)
        if not (torch.equal(bc.tile_starts, b.tile_starts) and torch.equal(bc.counts, b.counts)):
            fail(f"[{tag}] the binning's tables differ from chunk {CHUNK}'s")
        kc = compare_kernels(sargs, bc, tag, chunk=chunk)
        bwc = compare_backward(bc, kc["fwd_out"], N, tag, seed=1, chunk=chunk)
        qc = compare_queue(bc, kc["fwd_out"], kc["plain_out"], bwc, N, tag, chunk=chunk)
        d = (kc["fwd_out"] - fwd_out).abs()
        log(f"[{tag}] forward against chunk {CHUNK}'s: max |diff| {float(d.max()):.3e} in "
            f"{int((d > 0).any(2).any(1).sum())} of {T} tiles (the stop rule is per chunk)")
        del d
        k_out, soa = kc["fwd_out"], bc.sorted_soa
        gc = bwc["gcap"]
        qq = queue_for(bc, chunk=chunk)
        new = {
            "rasterize_fwd": lambda: fwd_tiles(bc.tile_starts, bc.counts, soa, TILE, ntx, chunk),
            "rasterize_bwd": lambda: bwd_tiles(bc.tile_starts, bc.counts, soa, bwc["gout"],
                                               k_out, TILE, ntx, chunk, N, gc),
            "rasterize_fwd_q": lambda: fwd_tiles_q(*qq[:2], bc.tile_starts, bc.counts, qq[2],
                                                   soa, TILE, ntx, chunk),
            "rasterize_bwd_q": lambda: bwd_tiles_q(*qq[:2], bc.tile_starts, bc.counts, qq[2],
                                                   soa, bwc["gout"], k_out, TILE, ntx, chunk,
                                                   N, gc)}
        fwd_plain_ms = cuda_ms(lambda: fwd_tiles_plain(bc.tile_starts, bc.counts, soa, TILE,
                                                       ntx, chunk), reps=3, warmup=1)
        n_written = int(bwc["meta"][0])
        fwd_bytes = (4 * (2 * T + 1) + 4 * 10 * n_is + 4 * T * 8 * P) / HBM_BYTES_PER_S * 1e3
        bwd_bytes = ((4 * (2 * T + 1) + 4 * 11 * n_is + 2 * 4 * T * 8 * P + 64 * n_written
                      + 12) / HBM_BYTES_PER_S * 1e3)
        queue_bytes = (4 * (T + 2) + 4 * int(qq[2])) / HBM_BYTES_PER_S * 1e3
        fwd_bound = max(fwd_bytes, bwc["active"] * FWD_FLOPS_PER_PAIR / FP32_FLOPS * 1e3)
        bwd_bound = max(bwd_bytes, bwc["active"] * (BWD_RECOMPUTE_FLOPS + BWD_GRAD_FLOPS)
                        / FP32_FLOPS * 1e3)
        for k, err, bound in (("rasterize_fwd", kc["fwd_err"], fwd_bound),
                              ("rasterize_bwd", bwc["bwd_err"], bwd_bound),
                              ("rasterize_fwd_q", qc["fwd_q_err"], fwd_bound + queue_bytes),
                              ("rasterize_bwd_q", qc["bwd_q_err"], bwd_bound + queue_bytes)):
            rep["raster"].setdefault(k, {})[chunk] = {"max_abs_err": err, "bound_ms": bound}
        rep["raster"]["rasterize_fwd"][chunk]["plain_ms"] = fwd_plain_ms
        # In turns with the old chunk: old, new, new, old, each cuda_ms.
        for k in old:
            t = in_turns({CHUNK: old[k], chunk: new[k]}, reps=7)
            turns[k][CHUNK] += t[CHUNK]
            rep["raster"][k][chunk]["ms"] = statistics.median(t[chunk])
            rep["raster"][k][chunk]["ms_in_turns"] = t[chunk]
        log(f"[{tag}] n_written {n_written} of grad_cap {gc}; ms in turns with chunk {CHUNK}: "
            + ", ".join(f"{k} {rep['raster'][k][chunk]['ms_in_turns']} (chunk {CHUNK} "
                        f"{turns[k][CHUNK][-2:]})" for k in old)
            + f"; plain forward {fwd_plain_ms:.3f} ms")
        del kc, bwc, qc, bc, new, k_out, soa, qq
        torch.cuda.empty_cache()
    for k in old:
        rep["raster"][k][CHUNK] = {"ms_in_turns": turns[k][CHUNK]}

    # The entry points at the new settings: one render at chunk 2048, a loop
    # and a queue forward + backward at chunk 2048, WIDE_STEPS steps each
    # with sort_buckets=64 and raster_chunk=2048, in turns with dense ones.
    reset_launches()
    p = state.params
    with torch.no_grad():
        img = render(p.means, p.quats, p.log_scales, p.logit_opacities, p.sh_coeffs,
                     views[0]["world_view_transform"], views[0]["K"], WIDTH, HEIGHT,
                     sh_degree=3, backend="auto", raster_chunk=WIDE_CHUNKS[0], device=dev).render
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(img).all()):
        fail("[wide] the chunk-2048 render is not finite or of the wrong shape")
    leaves = [x.detach().clone().requires_grad_(True) for x in sargs[:5]]
    outs = {}
    for queue in (False, True):
        o = rasterize_tiled(*leaves, sargs[5], WIDTH, HEIGHT, chunk=WIDE_CHUNKS[0], queue=queue)
        (o[0].sum() + o[1].sum()).backward()
        outs[queue] = o[0].detach()
    if not torch.equal(outs[True], outs[False]):
        fail("[wide] the chunk-2048 queue image differs from the loop image")
    del leaves, outs, img
    wide_b = f"sort_buckets={WIDE_BUCKETS[0]}"
    runs = steps_in_turns(dev, scene, images, views, {
        "dense": TrainingConfig(backend="auto"),
        wide_b: TrainingConfig(backend="auto", sort_buckets=WIDE_BUCKETS[0]),
        f"raster_chunk={WIDE_CHUNKS[0]}": TrainingConfig(backend="auto",
                                                         raster_chunk=WIDE_CHUNKS[0])},
        WIDE_STEPS)
    for k, r in runs.items():
        _check_steps(f"wide steps {k}", r["rows"], budget_check=False)
    # The new settings' launches: all since the reset but the dense steps'.
    launches = {k: v - runs["dense"]["launches"].get(k, 0) for k, v in read_launches().items()}
    log(f"[wide] launches through the entry points at the new settings (a chunk-"
        f"{WIDE_CHUNKS[0]} render, a queue and a loop forward + backward, {WIDE_STEPS} steps "
        f"each): {launches}; bucket drops a "
        f"step at B {WIDE_BUCKETS[0]}: {[r['n_budget_dropped'] for r in runs[wide_b]['rows']]}")
    need = ("pack_soa", "rasterize_fwd", "rasterize_bwd", "pack_rows", "segsum",
            "rasterize_fwd_q", "rasterize_bwd_q", "partition")
    if min(launches[k] for k in need) < 1 or runs[wide_b]["launches"].get(
            "partition", 0) < WIDE_STEPS:
        fail(f"[wide] a kernel never launched at the new settings: {launches}")
    rep["launches"] = launches
    rep["step_ms"] = {k: statistics.median(r["ms"][1:]) for k, r in runs.items()}
    del runs

    rep["deep"] = deep_tiles_phase(dev)
    rep["seconds"] = time.perf_counter() - t_phase
    log(f"[wide] phase 12 in {rep['seconds']:.1f} s")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rep


def wide_alone():
    """Phase 12 alone on the card, after the build and the render phase it
    takes its images from, at training view 0 of the noisy starting state:
    ``python -c "import chip_smoke; chip_smoke.wide_alone()"`` from the
    repository root."""
    import torch

    from gaussian_splatting_tpu_torch.core.cameras import look_at, make_intrinsics
    from gaussian_splatting_tpu_torch.models.gaussians import state_from_numpy
    from gaussian_splatting_tpu_torch.ops import _build

    _build.build(KERNELS)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    scene = scene_3d(N_GAUSSIANS, seed=0)
    K = make_intrinsics(WIDTH, HEIGHT, device=dev)
    views = [{"world_view_transform": look_at(e, (0.0, 0.0, 0.0), device=dev), "K": K}
             for e in view_eyes()]
    state = state_from_numpy(scene, device=dev)
    _, images, _ = render_phase(dev, state, views)
    sargs, b, fwd_out = modes_inputs(dev, scene, views)
    bw = compare_backward(b, fwd_out, N_GAUSSIANS, "train view 0", seed=1)
    rep = wide_settings_phase(dev, state, scene, views, images, sargs, b, fwd_out, bw)
    log(f"[wide] phase 12 alone: {json.dumps(rep, default=str)}")


def parent_alone(parent_root, reps=7):
    """The old settings (chunk 256, B 8) on this checkout's kernels and on
    those of another checkout of this repository at ``parent_root`` (whose
    kernels take the same C arguments), built there with this checkout's
    flags: at training view 0 of the noisy starting state, each kernel's
    outputs on both (the forward ones bit for bit, the partition exact, the
    backward ones within the backward's gates and meta equal) and each
    kernel's time in turns, parent, this, this, parent:
    ``python -c "import chip_smoke; chip_smoke.parent_alone('DIR')"``."""
    import ctypes
    from pathlib import Path

    import torch

    from gaussian_splatting_tpu_torch.core.cameras import look_at, make_intrinsics
    from gaussian_splatting_tpu_torch.ops import _build
    from gaussian_splatting_tpu_torch.ops.partition import bucket_partition, quantum_for
    from gaussian_splatting_tpu_torch.ops.rasterize_cuda import (
        bwd_tiles, bwd_tiles_q, fwd_tiles, fwd_tiles_q, grad_cap)
    from gaussian_splatting_tpu_torch.ops.tiling import (
        BUCKET_C, binning_slots, reduce_padded_grads)

    names = ("rasterize_fwd", "rasterize_bwd", "rasterize_fwd_q", "rasterize_bwd_q", "partition")
    _build.build(KERNELS)
    mine = {n: _build.load(n) for n in names}
    saved = _build.CSRC, _build.BUILD_DIR
    _build.CSRC = Path(parent_root).resolve() / "gaussian_splatting_tpu_torch" / "csrc"
    _build.BUILD_DIR = saved[1].parent / "parent-kernels"
    try:
        theirs = {n: ctypes.CDLL(str(p)) for n, p in _build.build(names).items()}
    finally:
        _build.CSRC, _build.BUILD_DIR = saved
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    scene = scene_3d(N_GAUSSIANS, seed=0)
    K = make_intrinsics(WIDTH, HEIGHT, device=dev)
    views = [{"world_view_transform": look_at(e, (0.0, 0.0, 0.0), device=dev), "K": K}
             for e in view_eyes()]
    sargs, b, fwd_out = modes_inputs(dev, scene, views)
    ntx, N = -(-WIDTH // TILE), N_GAUSSIANS
    gcap = grad_cap(N, MAX_T, CHUNK)
    gen = torch.Generator(device=dev).manual_seed(1)
    gout = torch.randn(fwd_out.shape, generator=gen, device=dev)
    gout[:, 5:] = 0.0
    qu = queue_for(b)
    means2d, conics, _, opac, depths, radii = sargs
    tile_key, _, _, _, T = binning_slots(means2d, conics, opac, radii, WIDTH, HEIGHT, TILE,
                                         MAX_T)
    q8 = quantum_for(BUCKET_C, BUCKETS, BUCKET_HEADROOM)
    calls = {
        "rasterize_fwd": lambda: fwd_tiles(b.tile_starts, b.counts, b.sorted_soa, TILE, ntx,
                                           CHUNK),
        "rasterize_bwd": lambda: bwd_tiles(b.tile_starts, b.counts, b.sorted_soa, gout, fwd_out,
                                           TILE, ntx, CHUNK, N, gcap),
        "rasterize_fwd_q": lambda: fwd_tiles_q(*qu[:2], b.tile_starts, b.counts, qu[2],
                                               b.sorted_soa, TILE, ntx, CHUNK),
        "rasterize_bwd_q": lambda: bwd_tiles_q(*qu[:2], b.tile_starts, b.counts, qu[2],
                                               b.sorted_soa, gout, fwd_out, TILE, ntx, CHUNK,
                                               N, gcap),
        "partition": lambda: bucket_partition(tile_key, depths, T, BUCKETS, q8, C=BUCKET_C)}

    def on(libs, fn):
        def call():
            _build._loaded.update(libs)
            return fn()
        return call

    report = {}
    for k, fn in calls.items():
        a, c = on(theirs, fn)(), on(mine, fn)()
        torch.cuda.synchronize()
        if k in ("rasterize_bwd", "rasterize_bwd_q"):
            sa = reduce_padded_grads(a[0], N, a[1][0], with_depth=True)
            sc = reduce_padded_grads(c[0], N, c[1][0], with_depth=True)
            _, ok = grad_errors(sc, sa)
            same = ok and a[1].tolist() == c[1].tolist()
            detail = f"meta {a[1].tolist()} / {c[1].tolist()}, within the backward's gates {ok}"
        else:
            pairs = list(zip(a, c)) if isinstance(a, tuple) else [(a, c)]
            same = all(torch.equal(x, y) for x, y in pairs)
            detail = "bit for bit"
        t = in_turns({"parent": on(theirs, fn), "this": on(mine, fn)}, reps=reps)
        _build._loaded.update(mine)
        report[k] = {"equal": same, "parent_ms": t["parent"], "this_ms": t["this"]}
        log(f"[parent] {k}: parent vs this checkout {detail}: {same}; ms in turns parent "
            f"{[round(x, 4) for x in t['parent']]}, this {[round(x, 4) for x in t['this']]}")
        if not same:
            fail(f"[parent] {k}: this checkout's output differs from the parent's")
    log(f"[parent] {json.dumps(report)}")


# Phase 13, the projection + SH kernel pair at the benchmark cells' shapes:
# (cell, slots, width, height, whether the cell runs the backward). The
# buffers hold 1.5 x the alive gaussians (1M at 1080p, 3.11M at 1297x840);
# the last third of each is dead slots at NEG_INF_LOGIT.
PROJ_SH_CELLS = (("train-video1080p-1m", 1_500_000, 1920, 1080, True),
                 ("train-mipnerf360-3m-b1", 4_665_000, 1297, 840, True),
                 ("render-video1080p-1m", 1_500_000, 1920, 1080, False))
# Every other instance of the pair the port launches, forward and backward
# at the first cell's shapes: SH degree 0-3 over the K = 16 buffer (the
# trainer raises the degree from 0), in the classic and the antialiased
# mode. The cells' own instance is degree 3, classic.
PROJ_SH_SWEEP = tuple((d, m) for m in ("classic", "antialiased") for d in range(4)
                      if (d, m) != (3, "classic"))
# Its gates against the plain version on the card: each float output within
# 1e-5 of its largest magnitude; radii equal but for 1 slot in 1e5, and
# those by one pixel; each gradient leaf within 1e-4 of its largest
# magnitude.
PROJ_SH_OUT_RTOL, PROJ_SH_RADII_FRAC, PROJ_SH_GRAD_ATOL_FRAC = 1e-5, 1e-5, 1e-4


def _rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _project_sh_inputs(dev, n, w, h):
    """A seeded ``scene_3d`` buffer of ``n`` slots, a third dead, with SH
    rows of 16 bases, and the first view's camera at ``w`` x ``h``."""
    import torch

    from gaussian_splatting_tpu_torch.core.cameras import look_at, make_intrinsics
    from gaussian_splatting_tpu_torch.models.gaussians import NEG_INF_LOGIT

    sc = scene_3d(n, seed=13)
    logit = sc["logit_opacities"][:, 0].copy()
    logit[n * 2 // 3:] = NEG_INF_LOGIT
    sh = np.concatenate([sc["features_dc"], sc["features_rest"]], axis=1)
    ins = [torch.as_tensor(a, device=dev)
           for a in (sc["means"], sc["quats"], sc["log_scales"], logit, sh)]
    view = (look_at(view_eyes()[0], (0.0, 0.0, 0.0), device=dev),
            make_intrinsics(w, h, device=dev), w, h)
    return ins, view


def _project_sh_case(dev, tag, ins, view, sh_degree, mode, with_bwd, offsets=None):
    """The pair against its plain version on ``ins`` at one SH degree and
    mode: the forward's outputs and radii, and with ``with_bwd`` the
    backward's gradients under seeded cotangents on the visible slots (zero
    elsewhere, as the raster backward hands them; the depth's zero, as the
    photometric loss gives it) against ``project_shade_bwd_plain`` and
    beside autograd through the plain code. ``offsets`` (dx, dr, ds) run
    the deforming instance, their gradients among the leaves. Logs the
    errors and fails on a miss of any gate. Returns the report and the
    closures the timings run."""
    import torch

    from gaussian_splatting_tpu_torch.ops.project_sh import (
        project_shade, project_shade_bwd_plain, project_shade_plain)

    outs = ("means2d", "depths", "conics", "compensations", "colors", "opacities")
    leaves_names = ("means", "quats", "log_scales", "logit_opacities", "sh_coeffs")
    if offsets is not None:
        leaves_names += ("dx", "dr", "ds")
        ins = list(ins) + list(offsets)
    n = ins[0].shape[0]
    args = (*view, sh_degree, mode)

    def call(project, xs):
        return project(*xs[:5], *args, tuple(xs[5:]) if len(xs) > 5 else None)

    def fwd():
        with torch.no_grad():
            return call(project_shade, ins)

    def fwd_plain():
        with torch.no_grad():
            return call(project_shade_plain, ins)

    def flat(out):
        proj, colors, opac = out
        return (proj.means2d, proj.depths, proj.conics, proj.compensations, colors, opac)

    k_out, p_out = fwd(), fwd_plain()
    dr = (k_out[0].radii - p_out[0].radii).abs()
    r = {"slots": n, "size": list(view[2:]), "sh_degree": sh_degree, "mode": mode,
         "visible": int((p_out[0].radii > 0).sum()),
         "radii_differ": int((dr > 0).sum()), "radii_max_diff": int(dr.max()),
         "out_rel_err": {k: _rel_err(a, b) for k, a, b in zip(outs, flat(k_out), flat(p_out))},
         "out_unequal": {k: int((a != b).sum()) for k, a, b in zip(outs, flat(k_out),
                                                                  flat(p_out))}}
    log(f"[project_sh] {tag}: {n} slots at {view[2]}x{view[3]}, SH {sh_degree}, {mode}, "
        f"{r['visible']} visible; forward against the plain version: largest error / largest "
        f"magnitude {r['out_rel_err']}, elements unequal {r['out_unequal']}, radii differing "
        f"{r['radii_differ']} (by at most {r['radii_max_diff']} px)")
    live = p_out[0].radii > 0
    del k_out, p_out, dr
    fns = {"fwd": fwd, "fwd_plain": fwd_plain, "live": live}
    if with_bwd:
        gen = torch.Generator(device=dev)
        gen.manual_seed(13)

        def cot(*shape):
            g = torch.randn((n, *shape), device=dev, generator=gen)
            return g * live.view(n, *([1] * len(shape)))

        cots = [cot(2), torch.zeros(n, device=dev), cot(3), cot(3), cot()]

        def grads(project):
            leaves = [x.detach().requires_grad_(True) for x in ins]
            proj, colors, opac = call(project, leaves)
            return torch.autograd.grad(
                [proj.means2d, proj.depths, proj.conics, colors, opac], leaves, cots)

        def fwd_bwd():
            return grads(project_shade)

        def parent():
            return grads(project_shade_plain)

        def bwd_plain():
            g_m2, g_z, g_con, g_col, g_op = cots
            out = project_shade_bwd_plain(*ins[:5], *args, g_m2, g_z, g_con, None, g_col, g_op,
                                          offsets=tuple(ins[5:]) if len(ins) > 5 else None)
            # dx's gradient is the means'.
            return out if len(out) == 5 else (*out[:5], out[0], *out[5:])

        kg, pg = fwd_bwd(), bwd_plain()
        r["grad_err"] = {k: _rel_err(a, b) for k, a, b in zip(leaves_names, kg, pg)}
        del kg
        r["plain_vs_autograd"] = {k: _rel_err(a, b)
                                  for k, a, b in zip(leaves_names, pg, parent())}
        del pg
        log(f"[project_sh] {tag}: backward against the plain version, largest error / "
            f"largest magnitude {r['grad_err']}; the plain version against autograd "
            f"through the plain code {r['plain_vs_autograd']}")
        fns.update(fwd_bwd=fwd_bwd, parent=parent, bwd_plain=bwd_plain)
    missed = []
    if max(r["out_rel_err"].values()) > PROJ_SH_OUT_RTOL:
        missed.append("a forward output is off its plain version")
    if r["radii_differ"] > PROJ_SH_RADII_FRAC * n or r["radii_max_diff"] > 1:
        missed.append("radii differ from the plain version's")
    if with_bwd and max(r["grad_err"].values()) > PROJ_SH_GRAD_ATOL_FRAC:
        missed.append("a gradient is off its plain version")
    r["missed"] = missed
    return r, fns


def project_sh_phase(dev):
    """Phase 13: the projection + SH kernel pair of ``ops/project_sh.py``
    against its plain version (``_project_sh_case``): at each cell's shapes
    (``PROJ_SH_CELLS``, SH 3, classic, one view) with the times of the pair
    (CUDA events), of each kernel alone (profiler), of the plain version and
    of the parent's path (autograd through the plain code), the byte bound,
    and the peak memory of a forward + backward; then every other SH degree
    and mode the port launches (``PROJ_SH_SWEEP``) at the first cell's
    shapes. Fails after the last case if any missed a gate."""
    import torch

    rep, missed = {}, []
    for cell, n, w, h, with_bwd in PROJ_SH_CELLS:
        ins, view = _project_sh_inputs(dev, n, w, h)
        r, fns = _project_sh_case(dev, cell, ins, view, 3, "classic", with_bwd)
        missed += [f"{cell}: {m}" for m in r["missed"]]
        # Forward: reads 44 B of parameters and 192 B of SH a slot, writes
        # means2d, depth, conic, radius, compensation, colour and opacity.
        fwd_bytes = n * (44 + 192 + 48)
        r.update(fwd_ms=cuda_ms(fns["fwd"]),
                 fwd_kernel_ms=kernel_ms(fns["fwd"], "project_sh_fwd_kernel"),
                 fwd_plain_ms=cuda_ms(fns["fwd_plain"], reps=3),
                 fwd_bound_ms=fwd_bytes / HBM_BYTES_PER_S * 1e3)
        if with_bwd:
            # Backward: reads the 40 B of cotangents of every slot, the 44 B
            # of parameters of a slot with any cotangent and the 192 B SH row
            # of one with a colour cotangent; writes 236 B of gradients.
            n_any = int(fns["live"].sum())
            bwd_bytes = n * (40 + 236) + n_any * (44 + 192)
            r.update(fwd_bwd_ms=cuda_ms(fns["fwd_bwd"]),
                     bwd_kernel_ms=kernel_ms(fns["fwd_bwd"], "project_sh_bwd_kernel"),
                     bwd_plain_ms=cuda_ms(fns["bwd_plain"], reps=3),
                     parent_fwd_bwd_ms=cuda_ms(fns["parent"], reps=3),
                     bwd_bound_ms=bwd_bytes / HBM_BYTES_PER_S * 1e3,
                     peak_gib=peak_gib(fns["fwd_bwd"]), parent_peak_gib=peak_gib(fns["parent"]))
        times = {k: v for k, v in r.items() if "ms" in k or "peak" in k}
        log(f"[project_sh] {cell}: {json.dumps(times)}")
        rep[cell] = r
        del fns
        if cell == PROJ_SH_CELLS[0][0]:
            rep["sweep"] = {}
            for d, mode in PROJ_SH_SWEEP:
                tag = f"{cell} SH {d} {mode}"
                sr, _ = _project_sh_case(dev, tag, ins, view, d, mode, True)
                missed += [f"{tag}: {m}" for m in sr["missed"]]
                rep["sweep"][f"sh{d}.{mode}"] = sr
        del ins, view
        torch.cuda.empty_cache()
    if missed:
        fail(f"[project_sh] the pair missed its gates: {missed}")
    return rep


# Phase 14, Deformable 3D Gaussians: the pair's deforming instance at the
# 1080p trainer cell's shapes under seeded offsets of the deformable cell's
# size (dx ~1 % of the scene's 2.0 extent, dr and ds small), and the
# deformation MLP (8 x 256, the published network) over 1M rows.
DEFORM_ROWS = 1_000_000
DEFORM_OFFSET_SD = (0.02, 0.05, 0.0005)


def deform_phase(dev):
    """Phase 14: the deforming instance of the pair against its plain
    version (``_project_sh_case`` with offsets, under phase 13's gates and
    radii differing on no slot), timed beside the static instance on the
    same slots; then the MLP of ``models/deform.py`` at the published shape
    over ``DEFORM_ROWS`` rows: forward and forward + backward ms (CUDA
    events), their float32 TFLOP/s on 2 x 504,320 multiply-adds a row
    forward and 2 x (504,320 + 482,816) backward, the peak memory, and the
    offsets' largest difference with TF32 on over their RMS."""
    import torch

    from gaussian_splatting_tpu_torch.models import deform as D

    cell, n, w, h, _ = PROJ_SH_CELLS[0]
    ins, view = _project_sh_inputs(dev, n, w, h)
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    offs = [sd * torch.randn((n, k), device=dev, generator=g)
            for sd, k in zip(DEFORM_OFFSET_SD, (3, 4, 3))]
    rep = {}
    r, fns = _project_sh_case(dev, f"{cell} deforming", ins, view, 3, "classic", True, offs)
    missed = list(r["missed"])
    if r["radii_differ"]:
        missed.append("radii differ from the plain version's")
    r.update(fwd_ms=cuda_ms(fns["fwd"]), fwd_bwd_ms=cuda_ms(fns["fwd_bwd"]),
             fwd_kernel_ms=kernel_ms(fns["fwd"], "project_sh_fwd_kernel"),
             bwd_kernel_ms=kernel_ms(fns["fwd_bwd"], "project_sh_bwd_kernel"))
    _, sfns = _project_sh_case(dev, f"{cell} static", ins, view, 3, "classic", True)
    r.update(static_fwd_ms=cuda_ms(sfns["fwd"]), static_fwd_bwd_ms=cuda_ms(sfns["fwd_bwd"]))
    rep["pair"] = r
    del fns, sfns, ins, offs
    torch.cuda.empty_cache()

    spec = D.DeformSpec()
    params = D.init_params(spec, seed=14, device=dev)
    x = (torch.rand((DEFORM_ROWS, 3), device=dev, generator=g) * 4.0 - 2.0)
    t = torch.tensor(0.5, device=dev)

    def fwd():
        with torch.no_grad():
            return D.mlp(params, spec, x, t)

    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    cots = [torch.randn((DEFORM_ROWS, k), device=dev, generator=g) for k in (3, 4, 3)]

    def fwd_bwd():
        return torch.autograd.grad(D.mlp(leaves, spec, x, t), list(leaves.values()), cots)

    macs = spec.macs_per_row()
    in_macs = macs - spec.in_ch * spec.width
    m = {"rows": DEFORM_ROWS, "macs_per_row": macs, "fwd_ms": cuda_ms(fwd, reps=5),
         "fwd_bwd_ms": cuda_ms(fwd_bwd, reps=5), "peak_gib": peak_gib(fwd_bwd)}
    m["fwd_tflops"] = 2 * macs * DEFORM_ROWS / m["fwd_ms"] / 1e9
    m["fwd_bwd_tflops"] = 2 * (2 * macs + in_macs) * DEFORM_ROWS / m["fwd_bwd_ms"] / 1e9
    ref = [o.clone() for o in fwd()]
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf = fwd()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    m["tf32_rel_err"] = max(float((a - b).abs().max() / b.pow(2).mean().sqrt())
                            for a, b in zip(tf, ref))
    log(f"[deform] MLP {spec} over {DEFORM_ROWS} rows: {json.dumps(m)}")
    rep["mlp"] = m
    if missed:
        fail(f"[deform] the deforming pair missed its gates: {missed}")
    return rep


def deform_alone():
    """Phase 14 alone: ``python -c "import chip_smoke; chip_smoke.deform_alone()"``
    from the repository root."""
    import torch

    from gaussian_splatting_tpu_torch.ops import _build

    _build.build(KERNELS)
    for line in _build.build_log("project_sh").splitlines():
        if "Compiling entry function" in line or "Used" in line or "spill" in line:
            log(f"[build] project_sh: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"deform": deform_phase(torch.device("cuda"))}), flush=True)


def project_sh_launches(render_launches, train_launches, n_renders, n_views):
    """The pair's launches through ``render_single`` (the forward once a
    frame, never the backward) and the training step (both once a view),
    and no view taking the autograd path."""
    from gaussian_splatting_tpu_torch.utils import profiling

    got = {"render": [render_launches["project_sh_fwd"], render_launches["project_sh_bwd"]],
           "train": [train_launches["project_sh_fwd"], train_launches["project_sh_bwd"]],
           "autograd_path": profiling.counters().get("project_sh.autograd", 0)}
    log(f"[project_sh] launches (forward, backward): {n_renders} renders {got['render']}, "
        f"{n_views} training views {got['train']}; views on the autograd path "
        f"{got['autograd_path']}")
    if (got["render"] != [n_renders, 0] or got["train"] != [n_views, n_views]
            or got["autograd_path"]):
        fail(f"[project_sh] the render or training path did not run the kernel pair: {got}")
    return got


def project_sh_alone():
    """Phase 13 alone, with the render and training phases it counts the
    pair's launches in: ``python -c "import chip_smoke;
    chip_smoke.project_sh_alone()"`` from the repository root."""
    import torch

    from gaussian_splatting_tpu_torch.core.cameras import look_at, make_intrinsics
    from gaussian_splatting_tpu_torch.models.gaussians import state_from_numpy
    from gaussian_splatting_tpu_torch.ops import _build

    _build.build(KERNELS)
    for line in _build.build_log("project_sh").splitlines():
        if "Compiling entry function" in line or "Used" in line or "spill" in line:
            log(f"[build] project_sh: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rep = {"project_sh": project_sh_phase(dev)}
    scene = scene_3d(N_GAUSSIANS, seed=0)
    K = make_intrinsics(WIDTH, HEIGHT, device=dev)
    views = [{"world_view_transform": look_at(e, (0.0, 0.0, 0.0), device=dev), "K": K}
             for e in view_eyes()]
    _, images, render_launches = render_phase(dev, state_from_numpy(scene, device=dev), views)
    launches = train_phase(dev, scene, views, images)[4]
    rep["launches"] = project_sh_launches(render_launches, launches, len(views),
                                          TRAIN_STEPS * len(views))
    print(json.dumps(rep), flush=True)


# Phase 15, the binning's slot enumeration (csrc/bin_slots.cu) at the
# benchmark cells' shapes: (case, buffer slots, width, height, max_t, class
# budgets; None bins the dense layout). The viewer's 1M live gaussians bin
# dense at max_t 16 (16M slots); the deformable cell's 1.5M-slot buffer (a
# third dead) and the 3.11M cell's 4.665M-slot one bin compact with those
# cells' logged budgets. Each case also runs every other mode of
# isect_and_sort (BIN_SLOTS_MODES) on its layout.
BIN_SLOTS_CASES = (
    ("render-video1080p-1m", 1_000_000, 1920, 1080, 16, None),
    ("train-deform3dgs-1080p-1m-b1", 1_500_000, 1920, 1080, 32,
     (18304, 75264, 2560, 269696, 107264, 2304, 118016, 22656, 11392, 23040)),
    ("train-mipnerf360-3m-b1", 4_665_000, 1297, 840, 8,
     (315136, 707328, 3712, 817664, 96512, 73472)),
)
BIN_SLOTS_MODES = (("flat", {}), ("bands2", {"sort_bands": 2}), ("bands3", {"sort_bands": 3}),
                   ("buckets8", {"sort_buckets": 8}), ("buckets64", {"sort_buckets": 64}),
                   ("depth_bits16", {"depth_bits": 16}))


def _bin_slots_inputs(dev, n, w, h, dead_third):
    """Screen-space inputs ``(means2d, conics, colors, opacities, depths,
    radii)`` of a seeded ``scene_3d`` of ``n`` slots (the last third dead
    with ``dead_third``) projected by the kernel pair at ``w`` x ``h`` from
    the first view."""
    import torch

    from gaussian_splatting_tpu_torch.ops.project_sh import project_shade

    ins, (viewmat, K, _, _) = _project_sh_inputs(dev, n, w, h)
    if not dead_third:
        ins[3] = torch.as_tensor(scene_3d(n, seed=13)["logit_opacities"][:, 0], device=dev)
    with torch.no_grad():
        proj, colors, opac = project_shade(*ins, viewmat, K, w, h, sh_degree=3)
    return (proj.means2d, proj.conics, colors, opac, proj.depths, proj.radii)


def bin_slots_phase(dev):
    """Phase 15: the kernel pair of ``tiling.bin_slots`` against its plain
    version on the card at each of ``BIN_SLOTS_CASES``: keys, gids and the
    three counters bit for bit (exact key and int32 tile), then
    ``isect_and_sort`` through the pair and through the plain version in
    every mode of ``BIN_SLOTS_MODES`` (tile_starts, counts, SoA and
    counters bit for bit, two launches a view, 2K with K bands); the times
    of each kernel alone (profiler) beside its bytes bound, of the pair and
    of the plain chain it replaces (CUDA events), and of a whole binning
    both ways. Fails after the last case if any missed a gate."""
    import torch

    from gaussian_splatting_tpu_torch.ops import tiling
    from gaussian_splatting_tpu_torch.utils import profiling

    kernel_bin_slots = tiling.bin_slots
    rep, missed = {}, []
    for cell, n, w, h, max_t, budgets in BIN_SLOTS_CASES:
        sargs = _bin_slots_inputs(dev, n, w, h, dead_third=budgets is not None)
        means2d, conics, colors, opac, depths, radii = sargs
        geo = (means2d, conics, opac, radii, depths)
        r = {"slots": tiling.total_slots(n, max_t, budgets), "max_t": max_t,
             "budgets": budgets, "modes": {}}
        for depth_bits in (None, 0):
            k = tiling.bin_slots(*geo, w, h, TILE, max_t, budgets, depth_bits=depth_bits)
            p = tiling.bin_slots_plain(*geo, w, h, TILE, max_t, budgets, depth_bits=depth_bits)
            got = {f: int(getattr(k, f)) for f in ("n_isect", "n_dropped", "n_budget_dropped")}
            want = {f: int(getattr(p, f)) for f in got}
            same = {"key": torch.equal(k.key, p.key), "counters": got == want,
                    "gid": (k.slot_gid is None and p.slot_gid is None)
                    or torch.equal(k.slot_gid, p.slot_gid)}
            tag = "exact" if depth_bits is None else "tile"
            r[f"slots_{tag}"] = dict(same, **got)
            if not all(same.values()):
                diff = int((k.key != p.key).sum()) if k.key.shape == p.key.shape else -1
                missed.append(f"{cell} {tag}: {same}, keys differing {diff}, {got} vs {want}")
            del k, p
        for mode, kw in BIN_SLOTS_MODES:
            K = kw.get("sort_bands", 1)
            profiling.reset_counters("launch.bin_slots")
            kb = tiling.isect_and_sort(*sargs, w, h, TILE, CHUNK, max_t, class_budgets=budgets,
                                       **kw)
            launches = profiling.counters().get("launch.bin_slots", 0)
            tiling.bin_slots = tiling.bin_slots_plain
            try:
                pb = tiling.isect_and_sort(*sargs, w, h, TILE, CHUNK, max_t,
                                           class_budgets=budgets, **kw)
            finally:
                tiling.bin_slots = kernel_bin_slots
            same = {f: torch.equal(getattr(kb, f), getattr(pb, f))
                    for f in tiling.TileBinning._fields}
            r["modes"][mode] = {"equal": all(same.values()), "launches": launches,
                                "n_isect": int(kb.n_isect)}
            if not all(same.values()) or launches != 2 * K:
                missed.append(f"{cell} {mode}: fields equal {same}, launches {launches} "
                              f"(want {2 * K})")
            del kb, pb
        # Times: each kernel alone, the pair, the plain chain, a whole binning.
        M = r["slots"]
        cols = n if budgets is None else sum(budgets)
        gid_b = 0 if budgets is None else 4
        perm_b = 0 if budgets is None else 8
        rects_bytes = n * (32 + 48 + (1 if budgets is not None else 0))
        slots_bytes = M * (8 + gid_b) + cols * (48 + perm_b)
        pair = lambda: tiling.bin_slots(*geo, w, h, TILE, max_t, budgets)  # noqa: E731
        plain = lambda: tiling.bin_slots_plain(*geo, w, h, TILE, max_t, budgets)  # noqa: E731
        whole = lambda: tiling.isect_and_sort(*sargs, w, h, TILE, CHUNK, max_t,  # noqa: E731
                                              class_budgets=budgets)

        def whole_plain():
            tiling.bin_slots = tiling.bin_slots_plain
            try:
                return whole()
            finally:
                tiling.bin_slots = kernel_bin_slots
        turns = in_turns({"pair": pair, "plain": plain}, reps=5)
        whole_turns = in_turns({"kernels": whole, "plain": whole_plain}, reps=5)
        r.update(
            rects_kernel_ms=kernel_ms(pair, "bin_rects_kernel"),
            slots_kernel_ms=kernel_ms(pair, "bin_slots_kernel"),
            rects_bound_ms=rects_bytes / HBM_BYTES_PER_S * 1e3,
            slots_bound_ms=slots_bytes / HBM_BYTES_PER_S * 1e3,
            pair_ms=statistics.median(turns["pair"]), plain_ms=statistics.median(turns["plain"]),
            binning_ms=statistics.median(whole_turns["kernels"]),
            binning_plain_ms=statistics.median(whole_turns["plain"]),
            binning_peak_gib=peak_gib(whole), binning_plain_peak_gib=peak_gib(whole_plain))
        r["slots_within_3x_bound"] = r["slots_kernel_ms"] <= 3 * r["slots_bound_ms"]
        log(f"[bin_slots] {cell} ({'dense' if budgets is None else 'compact'}, {M} slots, "
            f"n_isect {r['slots_exact']['n_isect']}, dropped {r['slots_exact']['n_dropped']}, "
            f"budget-dropped {r['slots_exact']['n_budget_dropped']}): "
            f"{json.dumps({k: v for k, v in r.items() if k not in ('budgets',)})}")
        rep[cell] = r
        del sargs, geo, means2d, conics, colors, opac, depths, radii
        torch.cuda.empty_cache()
    if missed:
        fail(f"[bin_slots] the pair missed its gates: {missed}")
    return rep


def bin_slots_launches(render_launches, train_launches, n_renders, n_views):
    """The pair's launches through ``render_single`` and the training step:
    two a view (the gaussian pass and the slot pass)."""
    got = {"render": render_launches["bin_slots"], "train": train_launches["bin_slots"]}
    log(f"[bin_slots] launches: {n_renders} renders {got['render']}, {n_views} training views "
        f"{got['train']}")
    if got != {"render": 2 * n_renders, "train": 2 * n_views}:
        fail(f"[bin_slots] the render or training path did not run the pair once a view: {got}")
    return got


def bin_slots_alone():
    """Phase 15 alone, with the render and training phases it counts the
    pair's launches in: ``python -c "import chip_smoke;
    chip_smoke.bin_slots_alone()"`` from the repository root."""
    import torch

    from gaussian_splatting_tpu_torch.core.cameras import look_at, make_intrinsics
    from gaussian_splatting_tpu_torch.models.gaussians import state_from_numpy
    from gaussian_splatting_tpu_torch.ops import _build

    _build.build(KERNELS)
    for line in _build.build_log("bin_slots").splitlines():
        if "Compiling entry function" in line or "Used" in line or "spill" in line:
            log(f"[build] bin_slots: {line.strip()}")
    dev = torch.device("cuda")
    rep = {"bin_slots": bin_slots_phase(dev)}
    scene = scene_3d(N_GAUSSIANS, seed=0)
    K = make_intrinsics(WIDTH, HEIGHT, device=dev)
    views = [{"world_view_transform": look_at(e, (0.0, 0.0, 0.0), device=dev), "K": K}
             for e in view_eyes()]
    _, images, render_launches = render_phase(dev, state_from_numpy(scene, device=dev), views)
    launches = train_phase(dev, scene, views, images)[4]
    rep["launches"] = bin_slots_launches(render_launches, launches, len(views),
                                         TRAIN_STEPS * len(views))
    print(json.dumps(rep), flush=True)


# Phase 16, Adam as one kernel (csrc/adam.cu) at the benchmark cells'
# buffers: (case, tensor shapes). The 1080p and deformable trainer cells keep
# 1M gaussians in 1.5M slots, the 3.11M cell 4.665M slots; a slot holds 59
# floats over the six groups. The deformable cell's network adds 22 tensors.
ADAM_GROUP_SHAPES = ((3,), (4,), (3,), (1,), (1, 3), (15, 3))
ADAM_CASES = (
    ("groups_1500000", tuple((1_500_000,) + s for s in ADAM_GROUP_SHAPES)),
    ("groups_4665000", tuple((4_665_000,) + s for s in ADAM_GROUP_SHAPES)),
    ("deform_mlp", None),
)
ADAM_BYTES_PER_ELEMENT = 28  # gradient, parameter and moments read; the last three written


def _adam_inputs(dev, shapes, seed):
    """Seeded ``(params, grads, mus, nus, lrs)`` of ``shapes`` on ``dev``:
    nonzero moments, zero gradients on every third row, NaN on row 1 of the
    first gradient; the first rate a 0-dim tensor (the position rate or the
    network's), the others the config's group rates."""
    import torch

    from gaussian_splatting_tpu_torch.models.gaussians import PARAM_KEYS
    from gaussian_splatting_tpu_torch.training.config import TrainingConfig
    from gaussian_splatting_tpu_torch.training.optimizer import group_lrs

    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(scale):
        return [torch.randn(s, generator=g, device=dev) * scale for s in shapes]
    params, grads, mus = draw(1.0), draw(1e-2), draw(1e-3)
    nus = [x.abs() for x in draw(1e-3)]
    for x in grads:
        if x.dim() > 1:
            x[::3] = 0.0
    grads[0][1] = float("nan")
    rate = torch.tensor(1.6e-4, device=dev)
    if len(shapes) == len(ADAM_GROUP_SHAPES):
        rates = group_lrs(TrainingConfig(), rate)
        lrs = [getattr(rates, k) for k in PARAM_KEYS]
    else:
        lrs = [rate] * len(shapes)
    return params, grads, mus, nus, lrs


def adam_phase(dev):
    """Phase 16: ``optimizer.adam_multi`` (``csrc/adam.cu``) against the
    plain ``adam_step`` loop on the card at each of ``ADAM_CASES``: three
    steps bit for bit (NaN where the plain code has NaN), one launch a
    step; the kernel's time alone (profiler) beside its bytes bound, the
    call's and the plain loop's (CUDA events) and their peak memory; and no
    launch for CPU tensors. Fails after the last case if any missed a gate."""
    import torch

    from gaussian_splatting_tpu_torch.models.deform import DeformSpec
    from gaussian_splatting_tpu_torch.training.optimizer import (
        adam_bias_corrections, adam_multi, adam_step)
    from gaussian_splatting_tpu_torch.utils import profiling

    b1, b2, eps = 0.9, 0.999, 1e-15
    rep, missed = {}, []

    def corrections(t):
        return adam_bias_corrections(torch.tensor(t, dtype=torch.int32, device=dev), b1, b2)

    def plain(ps, gs, ms, vs, lrs, c1, c2):
        for p, g, m, v, lr in zip(ps, gs, ms, vs, lrs):
            adam_step(p, g, m, v, lr, c1, c2, b1, b2, eps)

    for case, shapes in ADAM_CASES:
        if shapes is None:
            shapes = tuple(s for _, s in DeformSpec().shapes())
        params, grads, mus, nus, lrs = _adam_inputs(dev, shapes, seed=16)
        want = [[x.clone() for x in xs] for xs in (params, mus, nus)]
        profiling.reset_counters("launch.adam")
        for t in (6081, 6082, 6083):
            c1, c2 = corrections(t)
            plain(want[0], grads, want[1], want[2], lrs, c1, c2)
            adam_multi(params, grads, mus, nus, lrs, c1, c2, b1, b2, eps)
        torch.cuda.synchronize()
        launches = profiling.counters().get("launch.adam", 0)
        differ = 0
        for got, exp in zip((params, mus, nus), want):
            for a, b in zip(got, exp):
                same_nan = torch.equal(torch.isnan(a), torch.isnan(b))
                a0, b0 = (torch.where(torch.isnan(x), 0.0, x).view(torch.int32) for x in (a, b))
                differ += int((a0 != b0).sum()) + (0 if same_nan else 1)
        n = sum(p.numel() for p in params)
        r = {"tensors": len(shapes), "elements": n, "elements_differing": differ,
             "launches_in_3_steps": launches,
             "nan_propagated": bool(torch.isnan(params[0][1]).all())}
        if differ or launches != 3 or not r["nan_propagated"]:
            missed.append(f"{case}: {r}")
        del want
        c1, c2 = corrections(6084)
        call = lambda: adam_multi(params, grads, mus, nus, lrs, c1, c2, b1, b2, eps)  # noqa: E731
        loop = lambda: plain(params, grads, mus, nus, lrs, c1, c2)  # noqa: E731
        turns = in_turns({"kernel": call, "plain": loop}, reps=5)
        r.update(kernel_ms=kernel_ms(call, "adam_kernel"),
                 bound_ms=n * ADAM_BYTES_PER_ELEMENT / HBM_BYTES_PER_S * 1e3,
                 call_ms=statistics.median(turns["kernel"]),
                 plain_ms=statistics.median(turns["plain"]),
                 call_peak_gib=peak_gib(call), plain_peak_gib=peak_gib(loop))
        r["bound_share"] = r["bound_ms"] / r["kernel_ms"]
        log(f"[adam] {case} ({len(shapes)} tensors, {n} elements): {json.dumps(r)}")
        rep[case] = r
        del params, grads, mus, nus, lrs, call, loop
        torch.cuda.empty_cache()
    # CPU tensors take the plain loop: no launch.
    cpu = torch.device("cpu")
    ps, gs, ms, vs, lrs = _adam_inputs(cpu, [(40,) + s for s in ADAM_GROUP_SHAPES], seed=16)
    before = profiling.counters().get("launch.adam", 0)
    c1, c2 = adam_bias_corrections(torch.tensor(1, dtype=torch.int32), b1, b2)
    adam_multi(ps, gs, ms, vs, lrs, c1, c2, b1, b2, eps)
    rep["cpu_launches"] = profiling.counters().get("launch.adam", 0) - before
    if rep["cpu_launches"]:
        missed.append(f"CPU tensors launched the kernel {rep['cpu_launches']} times")
    if missed:
        fail(f"[adam] the kernel missed its gates: {missed}")
    return rep


def adam_launches(train_launches, n_steps, tag):
    """Adam's launches through ``n_steps`` training steps: one a step (the
    six groups in one launch)."""
    got = train_launches["adam"]
    log(f"[adam] launches: {n_steps} steps ({tag}) {got}")
    if got != n_steps:
        fail(f"[adam] the {tag} did not launch the kernel once a step: {got} in {n_steps}")
    return got


def adam_alone():
    """Phase 16 alone, with the training phase it counts the kernel's
    launches in: ``python -c "import chip_smoke; chip_smoke.adam_alone()"``
    from the repository root."""
    import torch

    from gaussian_splatting_tpu_torch.core.cameras import look_at, make_intrinsics
    from gaussian_splatting_tpu_torch.models.gaussians import state_from_numpy
    from gaussian_splatting_tpu_torch.ops import _build

    _build.build(KERNELS)
    for line in _build.build_log("adam").splitlines():
        if "Compiling entry function" in line or "Used" in line or "spill" in line:
            log(f"[build] adam: {line.strip()}")
    dev = torch.device("cuda")
    rep = {"adam": adam_phase(dev)}
    scene = scene_3d(N_GAUSSIANS, seed=0)
    K = make_intrinsics(WIDTH, HEIGHT, device=dev)
    views = [{"world_view_transform": look_at(e, (0.0, 0.0, 0.0), device=dev), "K": K}
             for e in view_eyes()]
    _, images, _ = render_phase(dev, state_from_numpy(scene, device=dev), views)
    launches = train_phase(dev, scene, views, images)[4]
    rep["launches"] = adam_launches(launches, TRAIN_STEPS, "training step")
    print(json.dumps(rep), flush=True)


SURFEL_LAUNCHES = ("project_surfel_fwd", "project_surfel_bwd", "surfel_raster_fwd",
                   "surfel_raster_bwd")


def surfel_phase(dev):
    """Phase 17: the surfel kernel pairs against their plain versions at a
    1080p view of phase 5's scene as surfels, each kernel's time alone,
    then ``TRAIN_STEPS`` surfel training steps at batch 4."""
    import torch

    from gaussian_splatting_tpu_torch.core.cameras import look_at, make_intrinsics
    from gaussian_splatting_tpu_torch.models.gaussians import train_state_from_numpy
    from gaussian_splatting_tpu_torch.ops import surfel as S
    from gaussian_splatting_tpu_torch.ops.tiling import isect_and_sort
    from gaussian_splatting_tpu_torch.training.config import TrainingConfig
    from gaussian_splatting_tpu_torch.training.step import ViewBatch, make_train_step
    from gaussian_splatting_tpu_torch.utils import profiling

    scene = scene_3d(N_GAUSSIANS, seed=0)
    scene["log_scales"] = scene["log_scales"][:, :2].copy()
    K = make_intrinsics(WIDTH, HEIGHT, device=dev)
    vms = [look_at(e, (0.0, 0.0, 0.0), device=dev) for e in view_eyes()]
    p = {k: torch.as_tensor(v, device=dev) for k, v in scene.items()}
    sh = torch.cat([p["features_dc"], p["features_rest"]], 1)
    args = (p["means"], p["quats"], p["log_scales"], p["logit_opacities"].reshape(-1), sh,
            vms[0], K)
    rep, missed = {}, []

    # The projection pair.
    got = S._ProjectSurfels.apply(*args, (WIDTH, HEIGHT, 3))
    want = S.project_surfels_plain(*args, WIDTH, HEIGHT, 3)
    proj = {"radii_differ": int((got[5] != want.radii).sum()),
            "visible": int((want.radii > 0).sum())}
    for i, name in enumerate(S.SurfelProjected._fields):
        if name != "radii":
            proj[f"{name}_rel_err"] = _rel_err(got[i], getattr(want, name))
            if proj[f"{name}_rel_err"] > 1e-5:
                missed.append(f"projection {name}")
    if proj["radii_differ"]:
        missed.append("projection radii")
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    cot = [torch.randn(t.shape, generator=g, device=dev)
           for t in (want.centers, want.tmat, want.normals, want.colors, want.opac)]
    ins = S._surfel_inputs(*args)
    outs = [torch.empty_like(x) for x in ins[:5]]
    S._launch_project("bwd", ins, WIDTH, HEIGHT, 3, [*cot, *outs])
    ref = S.project_surfels_bwd_plain(*args, 3, *cot)
    for name, a, b in zip(("means", "quats", "log_scales", "logits", "sh"), outs, ref):
        proj[f"d_{name}_rel_err"] = _rel_err(a, b)
        if proj[f"d_{name}_rel_err"] > 1e-4:
            missed.append(f"projection backward {name}")
    proj["fwd_kernel_ms"] = kernel_ms(lambda: S._ProjectSurfels.apply(*args, (WIDTH, HEIGHT, 3)),
                                      "project_surfel_fwd_kernel")
    proj["bwd_kernel_ms"] = kernel_ms(
        lambda: S._launch_project("bwd", ins, WIDTH, HEIGHT, 3, [*cot, *outs]),
        "project_surfel_bwd_kernel")
    rep["projection"] = proj
    log(f"[surfel] projection: {json.dumps(proj)}")

    # The raster pair on the view's own binning.
    with torch.no_grad():
        sp = S.SurfelProjected(*got)
        ra, rb = S.surfel_records(sp)
        b = isect_and_sort(sp.centers, sp.conics, sp.colors, sp.opac, sp.depths, sp.radii, WIDTH,
                           HEIGHT, TILE, CHUNK, MAX_T, records=ra)
        ntx = -(-WIDTH // TILE)
        fargs = (b.tile_starts, b.counts, b.sorted_soa, S.second_soa(rb, b.sorted_soa), TILE, ntx,
                 CHUNK)
        fo = S.surfel_fwd(*fargs)
        fp, pairs = S.surfel_fwd_plain(*fargs)
        ras = {"n_isect": int(b.n_isect), "pairs": int(pairs),
               "stop_differ": int(((fo[:, 4] == 0) != (fp[:, 4] == 0)).sum()),
               "median_differ": int((fo[:, 9] != fp[:, 9]).sum())}
        for r in range(12):
            if r == 9:
                continue
            scale = fp[:, 11] if r == 8 else fp[:, r]
            ras[f"row{r}_err"] = float((fo[:, r] - fp[:, r]).abs().max()
                                       / scale.abs().max().clamp_min(1e-30))
            if ras[f"row{r}_err"] > 1e-5:
                missed.append(f"raster forward row {r}")
        if ras["stop_differ"] or ras["median_differ"]:
            missed.append("raster stop decisions or median depths")
        gout = torch.randn(fo.shape, generator=g, device=dev)
        gout[:, 9:] = 0.0
        n = sp.centers.shape[0]
        cap = S.grad_cap(n, MAX_T, CHUNK)
        bargs = (*fargs[:4], gout, fp, TILE, ntx, CHUNK, n, cap)
        grad, meta = S.surfel_bwd(*bargs)
        grad_p, meta_p, active = S.surfel_bwd_plain(*bargs)
        ras["active_pairs"] = int(active)
        s_k = S.reduce_surfel_grads(grad, n, meta[0])
        s_p = S.reduce_surfel_grads(grad_p, n, meta_p[0])
        for r, key in enumerate(S.SURFEL_GRAD_KEYS):
            ras[f"{key}_err"] = _rel_err(s_k[r], s_p[r])
            if ras[f"{key}_err"] > 1e-4:
                missed.append(f"raster backward {key}")
        if not torch.equal(meta, meta_p):
            missed.append("raster backward meta")
        ras["fwd_kernel_ms"] = kernel_ms(lambda: S.surfel_fwd(*fargs), "surfel_fwd_kernel")
        ras["bwd_kernel_ms"] = kernel_ms(lambda: S.surfel_bwd(*bargs), "surfel_bwd_kernel")
        ras["reduce_ms"] = cuda_ms(lambda: S.reduce_surfel_grads(grad, n, meta[0]))
    rep["raster"] = ras
    log(f"[surfel] raster: {json.dumps(ras)}")
    del fo, fp, grad, grad_p, b, sp, got, want, outs, ref
    torch.cuda.empty_cache()

    # Training steps with both terms on.
    config = TrainingConfig(backend="auto", surfels=True)
    step = make_train_step(config, WIDTH, HEIGHT, 3, config.backend, SCENE_EXTENT, device=dev)
    arrays = noisy_train_arrays(scene, seed=1)
    arrays["iteration"] = np.int32(7080)
    state = train_state_from_numpy(arrays, device=dev)
    with torch.no_grad():
        images = torch.stack([torch.clamp(S.rasterize_surfels(S.project_surfels(
            *args[:5], vm, K, WIDTH, HEIGHT, 3), WIDTH, HEIGHT)[0][..., :3], 0, 1) for vm in vms])
    batch = ViewBatch(images=images, viewmats=torch.stack(vms), Ks=torch.stack([K] * len(vms)))
    profiling.reset_counters(*(f"launch.{k}" for k in SURFEL_LAUNCHES))
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for i in range(TRAIN_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = step(state, batch)
        e.record()
        e.synchronize()
        step_ms.append(a.elapsed_time(e))
        losses.append(float(m["loss"]))
        log(f"[surfel] step {i}: loss {losses[-1]:.6f}, l1 {float(m['l1']):.5f}, normal "
            f"{float(m['surfel/normal']):.5f}, dist {float(m['surfel/dist']):.3e}, n_isect "
            f"{int(m['stats/n_isect'])}, n_grad_dropped {int(m['stats/n_grad_dropped'])}, "
            f"{step_ms[-1]:.3f} ms")
        if not np.isfinite(losses[-1]) or int(m["stats/n_grad_dropped"]) > 0:
            missed.append(f"training step {i}: loss not finite or gradient entries dropped")
    counts = profiling.counters()
    launches = {k: counts.get(f"launch.{k}", 0) for k in SURFEL_LAUNCHES}
    n_views = TRAIN_STEPS * len(vms)
    if any(v != n_views for v in launches.values()):
        missed.append(f"launches {launches}, not one of each a view ({n_views} views)")
    if not losses[-1] < losses[0]:
        missed.append(f"the loss did not descend: {losses}")
    rep["train"] = {"step_ms": step_ms, "losses": losses, "launches": launches,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"[surfel] train: {json.dumps(rep['train'])}")
    if missed:
        fail(f"[surfel] missed: {missed}")
    return rep


def surfel_alone():
    """Phase 17 alone: ``python -c "import chip_smoke; chip_smoke.surfel_alone()"``
    from the repository root."""
    import torch

    from gaussian_splatting_tpu_torch.ops import _build

    _build.build(KERNELS)
    for name in ("rasterize_surfel", "project_sh"):
        fn = "?"
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif ("Used" in line or "spill" in line) and "surfel" in fn:
                log(f"[build] {name} {fn}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"surfel": surfel_phase(torch.device("cuda"))}), flush=True)


def _cli_call(main, argv, records):
    """``main(argv)`` of a CLI with its standard output kept off this
    script's (the eval CLI prints a JSON summary line); returns the exit
    code, the output, the host seconds and the log records it emitted as
    (time, message)."""
    import contextlib
    import io

    out = io.StringIO()
    first = len(records)
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue(), time.time() - t0, records[first:], t0


def _first(records, pattern):
    """(time, match) of the first record matching the regex ``pattern``."""
    import re

    for t, m in records:
        hit = re.search(pattern, m)
        if hit:
            return t, hit
    fail(f"[cli] no log line matches {pattern!r}")


def cli_phase(dev):
    """Phase 9: the user journey through the port's two CLIs, in a
    temporary directory: ``tests/synthetic_video.py`` writes a clip of
    CLI_FRAMES frames at WIDTH x HEIGHT; ``train_cli.main`` runs SfM on it
    and trains CLI_ITERS iterations of batch 4 from CLI_GAUSSIANS gaussians
    with the trainer's compact budgets (the CLI's own initial opacity 0.005,
    so budget drops are reported, not gated); ``eval_cli.main`` scores
    CLI_EVAL_VIEWS views of ``final.npz`` with CLI_ALIGN_STEPS steps of pose
    alignment (the SfM cache hit), then of ``final.ply`` without. Checks: exit
    codes 0, SfM >= 5 poses and >= 100 points, n_alive at init within 1 % of
    CLI_GAUSSIANS, the train CLI's files, finite losses with the last below
    the first, the eval's views, PNGs, PLY and finite metrics with
    ``psnr_aligned`` >= ``psnr`` - 1e-4, the checkpoint's compact budgets in
    the render settings, and the five kernels of the path launched in each
    CLI. Returns the launches and the timings."""
    import importlib.util
    import json as _json
    import logging
    import tempfile
    from pathlib import Path

    import torch

    from gaussian_splatting_tpu_torch import eval_cli, train_cli
    from gaussian_splatting_tpu_torch.training import trainer as trainer_mod

    spec = importlib.util.spec_from_file_location(
        "synthetic_video", Path(__file__).resolve().parent / "tests" / "synthetic_video.py")
    synthetic_video = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synthetic_video)

    made = []

    class Trainer(_Timed, trainer_mod.GaussianTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.step_events, self.event_s = [], {}
            made.append(self)

    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append((record.created, record.getMessage()))

    root = logging.getLogger()
    handler, level = Capture(level=logging.INFO), root.level
    root.addHandler(handler)  # the CLIs' basicConfig then adds no console handler
    root.setLevel(logging.INFO)
    plain_trainer = trainer_mod.GaussianTrainer
    trainer_mod.GaussianTrainer = Trainer  # train_cli.main imports it when called
    try:
        with tempfile.TemporaryDirectory() as td:
            d = Path(td)
            clip, cache = str(d / "clip.mp4"), str(d / "cache")
            t0 = time.perf_counter()
            synthetic_video.write_synthetic_video(clip, n_frames=CLI_FRAMES, width=WIDTH,
                                                  height=HEIGHT)
            clip_s = time.perf_counter() - t0
            common = ["--videos", clip, "--frame-stride", str(CLI_STRIDE), "--backend", "cuda",
                      "--device", str(dev), "--cache-dir", cache]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            rc, _, train_s, trecs, t_start = _cli_call(train_cli.main, common + [
                "--output", str(d / "run"), "--iterations", str(CLI_ITERS), "--batch-size", "4",
                "--initial-gaussians", str(CLI_GAUSSIANS),
                "--max-gaussians", str(CLI_MAX_GAUSSIANS)], records)
            torch.cuda.synchronize()
            train_launches = read_launches()
            train_peak = torch.cuda.max_memory_allocated() / 2**30
            if rc != 0:
                fail(f"[cli] train_cli exited {rc}")
            run = d / "run"
            missing = [f for f in ("final.npz", "final.ply", "metrics.jsonl", "config.json",
                                   "debug_reproj.png") if not (run / f).exists()]
            with open(run / "metrics.jsonl") as f:
                recs = [_json.loads(line) for line in f]

            evals = {}
            for name, model, steps in (("npz", "final.npz", CLI_ALIGN_STEPS),
                                       ("ply", "final.ply", 0)):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                out = d / f"eval_{name}"
                rc, stdout, wall, erecs, _ = _cli_call(eval_cli.main, [
                    "--model", str(run / model), "--output", str(out),
                    "--num-views", str(CLI_EVAL_VIEWS), "--pose-align", str(steps)] + common,
                    records)
                torch.cuda.synchronize()
                if rc != 0:
                    fail(f"[cli] eval_cli on {model} exited {rc}")
                evals[name] = {
                    "launches": read_launches(), "wall_s": wall, "records": erecs,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "summary": stdout.strip().splitlines()[-1],
                    "metrics": _json.loads((out / "metrics.json").read_text()),
                    "pngs": len(list(out.glob("view_*.png"))),
                    "ply": (out / "model.ply").exists()}
    finally:
        trainer_mod.GaussianTrainer = plain_trainer
        root.removeHandler(handler)
        root.setLevel(level)

    # --- the train CLI ---
    trainer = made[0]
    _, probe = _first(trecs, r"environment probe: (.*)")
    log(f"[cli] train_cli's environment probe (OpenCV build): {probe.group(1)}")
    t_sfm, sfm = _first(trecs, r"SfM: (\d+) poses, (\d+) points")
    n_poses, n_points = int(sfm.group(1)), int(sfm.group(2))
    t_extent, _ = _first(trecs, r"scene extent")
    _, alive = _first(trecs, r"capacity (\d+), alive (\d+)")
    t_budgets, budgets = _first(trecs, r"compact binning budgets (\(.*?\)) \((\d+) slots")
    t_built, _ = _first(trecs, r"built train step")
    n_alive = int(alive.group(2))
    ends = trainer.step_events
    torch.cuda.synchronize()
    periods = [ends[i].elapsed_time(ends[i + 1]) for i in range(len(ends) - 1)]
    timed = [p for i, p in enumerate(periods) if i > 0 and (i + 1) % 10 != 0]
    scalars = [r for r in recs if "loss" in r]
    losses = [r["loss"] for r in scalars]
    log(f"[cli] clip {CLI_FRAMES} frames at {WIDTH}x{HEIGHT} written in {clip_s:.2f} s; "
        f"train_cli: SfM {n_poses} poses, {n_points} points in {t_sfm - t_start:.2f} s "
        f"(host, from the call); dataset + logger {t_extent - t_sfm:.2f} s; init "
        f"(capacity {alive.group(1)}, alive {n_alive}), max_t and budgets "
        f"{t_budgets - t_extent:.2f} s: budgets {budgets.group(1)} ({budgets.group(2)} "
        f"slots), final config budgets {trainer.config.class_budgets}, max_t "
        f"{trainer.config.max_tiles_per_gaussian}; first step built "
        f"{t_built - t_budgets:.2f} s later; whole call {train_s:.2f} s")
    log("[cli] train_cli logged iteration: loss, n_isect, n_budget_dropped (share of n_isect), "
        "n_dropped: " + "; ".join(
            f"{r['_step']}: {r['loss']:.5f}, {r['stats/n_isect']}, "
            f"{r['stats/n_budget_dropped']} "
            f"({r['stats/n_budget_dropped'] / max(r['stats/n_isect'], 1):.4f}), "
            f"{r['stats/n_dropped']}" for r in scalars)
        + f"; rebudgets {trainer._rebudget_count}")
    med = statistics.median(timed) if timed else float("nan")
    log(f"[cli] train_cli iteration (CUDA events, start to start; not a trainer metric: the "
        f"CLI starts at opacity 0.005 and drops budget entries, phase 8 is the metric): "
        f"median {med:.3f} ms over {len(timed)} iterations without a log (all: "
        f"{[round(x, 1) for x in periods]}); events (host, synchronized): "
        f"{ {k: [round(x * 1e3, 1) for x in v] for k, v in trainer.event_s.items()} } ms; "
        f"launches {train_launches}; peak device memory {train_peak:.2f} GiB")
    if missing:
        fail(f"[cli] train_cli did not write {missing}")
    if n_poses < 5 or n_points < 100:
        fail(f"[cli] SfM gave {n_poses} poses and {n_points} points")
    if abs(n_alive - CLI_GAUSSIANS) > 0.01 * CLI_GAUSSIANS:
        fail(f"[cli] {n_alive} gaussians alive at init, not ~{CLI_GAUSSIANS}")
    if not (losses and np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"[cli] train_cli losses not finite or not falling: {losses}")
    if min(train_launches[k] for k in KERNELS[:5]) < 1:
        fail(f"[cli] a kernel of the path never launched in train_cli: {train_launches}")

    # --- the eval CLI ---
    for name, ev in evals.items():
        m = ev["metrics"]
        views = [(_first(ev["records"], rf"view {r['view']}: .*host ms: render \+ metrics "
                         r"([\d.]+), alignment ([\d.]+), png ([\d.]+)")[1].groups(), r)
                 for r in m["per_view"]]
        log(f"[cli] eval_cli {name}: {ev['summary']}; per view (psnr, psnr_aligned; host ms "
            f"render + metrics, alignment, png): "
            + "; ".join(f"{r['view']}: {r['psnr']:.4f}, {r.get('psnr_aligned', '-')}, "
                        f"{'/'.join(g)}" for g, r in views)
            + f"; whole call {ev['wall_s']:.2f} s; launches {ev['launches']}; peak device "
            f"memory {ev['peak_gib']:.2f} GiB")
        finite = all(np.isfinite(r[k]) for r in m["per_view"] for k in ("l1", "ssim", "psnr"))
        if m["num_views"] != CLI_EVAL_VIEWS or ev["pngs"] != CLI_EVAL_VIEWS or not ev["ply"]:
            fail(f"[cli] eval_cli on {name}: {m['num_views']} views, {ev['pngs']} PNGs, "
                 f"model.ply {ev['ply']}")
        if not finite:
            fail(f"[cli] eval_cli on {name}: metrics not finite")
    npz = evals["npz"]
    if not any("SfM cache hit" in msg for _, msg in npz["records"]):
        fail("[cli] eval_cli ran SfM again instead of hitting the train CLI's cache")
    _, settings = _first(npz["records"], r"render settings from checkpoint meta: .*budgets=(.*)")
    log(f"[cli] eval_cli npz render settings: {settings.group(0)}")
    if settings.group(1) != str(tuple(trainer.config.class_budgets)):
        fail(f"[cli] eval_cli did not render with the checkpoint's compact budgets "
             f"{trainer.config.class_budgets}")
    bad = [r for r in npz["metrics"]["per_view"]
           if not r["psnr_aligned"] >= r["psnr"] - 1e-4]
    if bad:
        fail(f"[cli] psnr_aligned below psnr: {bad}")
    if min(npz["launches"][k] for k in KERNELS[:5]) < 1:
        fail(f"[cli] a kernel of the path never launched in eval_cli: {npz['launches']}")
    return {"train_launches": train_launches, "eval_launches": npz["launches"]}


def binning_peak_gib(sargs, class_budgets=None):
    """Peak device memory (GiB, ``max_memory_allocated``) of one dense and
    one bucket ``isect_and_sort`` at screen-space inputs ``sargs``, and of
    one compact one with ``class_budgets``, above what was allocated before
    the call."""
    import torch

    from gaussian_splatting_tpu_torch.ops.tiling import isect_and_sort

    modes = [("dense", {}), ("bucket", {"sort_buckets": BUCKETS,
                                        "bucket_headroom": BUCKET_HEADROOM})]
    if class_budgets is not None:
        modes.append(("compact", {"class_budgets": class_budgets}))
    return {name: peak_gib(lambda kw=kw: isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK,
                                                        MAX_T, **kw))
            for name, kw in modes}


def trace(fn, tag):
    """One call of ``fn`` under ``torch.profiler``; logs its wall time, the
    number of device activities, the device's busy time (union of their
    intervals) and idle share, and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    per_name = {}
    for a, b, name in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
        per_name[name] = per_name.get(name, 0.0) + (b - a)
    busy_ms = busy_us / 1e3
    log(f"[trace] {tag} under torch.profiler: wall {wall_ms:.3f} ms, "
        f"{len(spans)} device activities, device busy {busy_ms:.3f} ms, idle share "
        f"{1.0 - busy_ms / wall_ms:.3f}")
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[trace]   {us / 1e3:8.3f} ms  {name[:90]}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1

    from gaussian_splatting_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 1. Build.
    t0 = time.perf_counter()
    _build.build(KERNELS)
    log(f"[build] {', '.join(k + '.cu' for k in KERNELS)} for sm_90a in "
        f"{time.perf_counter() - t0:.2f} s")
    for k in KERNELS:
        fn = "?"
        for line in _build.build_log(k).splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "Used" in line or "spill" in line:
                log(f"[build] {k} {fn}: {line.strip()}")

    report = run(torch.device("cuda"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(report), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def bench_phase(dev):
    """Phase 2: the bench scene's counts and all five kernels against their
    plain versions; then the ``bench.py`` forward + backward workload."""
    import torch

    from gaussian_splatting_tpu_torch.ops.rasterize_cuda import (
        rasterize_grad_meta, rasterize_tiled)
    from gaussian_splatting_tpu_torch.ops.tiling import isect_and_sort

    args = tuple(torch.as_tensor(x, device=dev) for x in bench_scene(N_GAUSSIANS, WIDTH, HEIGHT))
    b = isect_and_sort(*args, WIDTH, HEIGHT, TILE, CHUNK, MAX_T)
    n_isect, n_dropped = int(b.n_isect), int(b.n_dropped)
    for name, got, want in (("n_isect", n_isect, BENCH_N_ISECT),
                            ("n_dropped", n_dropped, BENCH_N_DROPPED)):
        log(f"[bench] {name} {got} (JAX package: {want}, difference {got - want:+d})")
        if abs(got - want) > COUNT_RTOL * want:
            fail(f"[bench] {name} differs from the JAX package by more than 0.01%")
    log(f"[bench] n_isect against the CPU binning's {BENCH_CPU_N_ISECT}: "
        f"{n_isect - BENCH_CPU_N_ISECT:+d}")
    compare_counts(args, b)
    kc = compare_kernels(args, b, "bench")
    fwd_out, plain_out = kc["fwd_out"], kc["plain_out"]
    del kc
    bwd = compare_backward(b, fwd_out, N_GAUSSIANS, "bench")
    compare_queue(b, fwd_out, plain_out, bwd, N_GAUSSIANS, "bench")
    del b, fwd_out, plain_out, bwd
    drops = {B: int(isect_and_sort(*args, WIDTH, HEIGHT, TILE, CHUNK, MAX_T, sort_buckets=B,
                                   bucket_headroom=BUCKET_HEADROOM).n_bucket_dropped)
             for B in (BUCKETS, 2 * BUCKETS)}
    log(f"[bench] bucket binning at headroom {BUCKET_HEADROOM}, n_bucket_dropped by "
        f"sort_buckets: {drops}")
    peaks = binning_peak_gib(args)
    log(f"[bench] peak device memory of one binning above its inputs: dense "
        f"{peaks['dense']:.3f} GiB, bucket (sort_buckets {BUCKETS}) {peaks['bucket']:.3f} GiB")
    torch.cuda.empty_cache()

    # The bench.py workload (bench.py:149-168): forward + backward of
    # sum(img) + sum(alpha) with depth_grad=False; dense binning here (phase
    # 2c runs it on compact budgets, as bench.py does). queue=True is its
    # GS_BENCH_QUEUE=1 variant (bench.py:81): the queue path.
    diff = [x.clone().requires_grad_(True) for x in args[:5]]

    def fwd_bwd(queue):
        for x in diff:
            x.grad = None
        img, alpha, _ = rasterize_tiled(*diff, args[5], WIDTH, HEIGHT, tile_size=TILE,
                                        chunk=CHUNK, max_tiles_per_gaussian=MAX_T,
                                        depth_grad=False, queue=queue)
        (img.sum() + alpha.sum()).backward()
        return img.detach(), [x.grad for x in diff]

    loop_img, loop_grads = fwd_bwd(False)
    reset_launches()
    queue_img, queue_grads = fwd_bwd(True)
    torch.cuda.synchronize()
    q_launches = read_launches()
    log(f"[queue] bench.py fwd+bwd workload with queue=True: launches {q_launches}")
    path = ("pack_soa", "rasterize_fwd_q", "rasterize_bwd_q", "pack_rows", "segsum")
    if min(q_launches[k] for k in path) < 1 or q_launches["rasterize_fwd"] \
            or q_launches["rasterize_bwd"]:
        fail(f"[queue] the queue path did not run through its kernels: {q_launches}")
    rel = {}
    for name, gq, gl in zip(("means2d", "conics", "colors", "opacities"), queue_grads,
                            loop_grads):
        scale = float(gl.abs().max()) + 1e-12
        rel[name] = float((gq - gl).abs().max()) / scale
        if not bool(((gq - gl).abs() <= GRAD_ATOL_FRAC * scale + GRAD_RTOL * gl.abs()).all()):
            fail(f"[queue] the queue path's gradient of {name} differs from the loop path's")
    same_img = torch.equal(queue_img, loop_img)
    rel = {k: float(f"{v:.3e}") for k, v in rel.items()}
    log(f"[queue] image equal to the loop path's bit for bit: {same_img}; gradients, max "
        f"|queue - loop| / max |loop|: {json.dumps(rel)}")
    if not same_img:
        fail("[queue] the queue path's image differs from the loop path's")
    del loop_img, loop_grads, queue_img, queue_grads

    # Loop and queue in turns: loop, queue, queue, loop.
    fb = {False: [], True: []}
    for queue in (False, True, True, False):
        fb[queue].append(cuda_ms(lambda q=queue: fwd_bwd(q), reps=5))
    meta = {q: rasterize_grad_meta(*args, WIDTH, HEIGHT, tile_size=TILE, chunk=CHUNK,
                                   max_tiles_per_gaussian=MAX_T, queue=q)
            for q in (False, True)}
    fb_ms, fbq_ms = statistics.mean(fb[False]), statistics.mean(fb[True])
    nw, nd, gcap = meta[False]
    log(f"[bench] bench.py fwd+bwd workload (dense binning): loop {fb_ms:.3f} ms "
        f"{fb[False]}, {WIDTH * HEIGHT / (fb_ms / 1e3):.1f} pixels/s; queue {fbq_ms:.3f} ms "
        f"{fb[True]}, {WIDTH * HEIGHT / (fbq_ms / 1e3):.1f} pixels/s; n_grad_written {nw}, "
        f"n_grad_dropped {nd}, grad_cap {gcap}; queue probe {meta[True]}")
    if nd != 0:
        fail("[bench] the backward dropped gradient entries at grad_buffer_frac 1")
    if meta[True] != meta[False]:
        fail("[queue] rasterize_grad_meta(queue=True) differs from queue=False")
    compact = bench_compact(args, diff, fwd_bwd, fb_ms)
    del diff, args
    torch.cuda.empty_cache()
    return {"bench_fwd_bwd_ms": fb_ms, "bench_fwd_bwd_queue_ms": fbq_ms,
            "queue_launches": q_launches, **compact}


def bench_budgets(args):
    """The compact class budgets of ``bench.py:92-108`` for the bench
    scene (``band_budgets`` of its one view, flat)."""
    return band_budgets([args], 1)


def band_budgets(views_args, bands):
    """The compact class budgets of ``bench.py:86-108`` covering the
    heaviest of ``bands`` bands of tile rows in every view of
    ``views_args``: per band the class histogram of the exact footprints
    clipped to its rows (``exact_tile_counts(row_lo, row_hi)``), capped at
    MAX_T, the maximum over bands and views, 1.05 headroom rounded up to
    128 plus 128, squeezed under a power of two. ``bands`` 1 is the flat
    histogram."""
    from gaussian_splatting_tpu_torch.ops.tiling import (
        cdiv, class_caps, exact_tile_counts, squeeze_budgets_under_pow2)

    caps = np.asarray(class_caps(MAX_T))
    nty = cdiv(HEIGHT, TILE)
    band_h = cdiv(nty, bands)
    hist = np.zeros(len(caps), np.int64)
    for args in views_args:
        means2d, conics, _, opac, _, radii = (x.cpu().numpy() for x in args)
        for k in range(bands):
            lo, hi = min(k * band_h, nty), min((k + 1) * band_h, nty)
            nt = np.minimum(exact_tile_counts(means2d, radii, WIDTH, HEIGHT, TILE,
                                              conics=conics, opacities=opac, row_lo=lo,
                                              row_hi=hi), MAX_T)
            cls = np.searchsorted(caps, np.clip(nt, 1, MAX_T))
            hist = np.maximum(hist,
                              np.bincount(cls[nt > 0], minlength=len(caps))[:len(caps)])
    budgets = tuple(int(np.ceil(h * 1.05 / 128) * 128 + 128) for h in hist)
    hard_min = tuple(int(np.ceil(h / 128) * 128) for h in hist)
    return squeeze_budgets_under_pow2(budgets, hard_min, caps)


def bench_compact(args, diff, dense_fwd_bwd, dense_ms):
    """Phase 2c: the ``bench.py`` workload as the JAX package runs it
    (``bench.py:92-168``): compact budgets, the gradient buffer sized to the
    measured occupancy + 8 %, ``reduce_slices`` 4. Its counts, which do not
    depend on the hardware, against ``BENCH_r05.json``; its forward +
    backward time beside the dense one, in turns."""
    import torch

    from gaussian_splatting_tpu_torch.ops.rasterize_cuda import (
        rasterize_grad_meta, rasterize_tiled)
    from gaussian_splatting_tpu_torch.ops.tiling import total_slots

    budgets = bench_budgets(args)
    n_slots = total_slots(N_GAUSSIANS, MAX_T, budgets)
    with torch.no_grad():
        *_, stats = rasterize_tiled(*args, WIDTH, HEIGHT, tile_size=TILE, chunk=CHUNK,
                                    max_tiles_per_gaussian=MAX_T, class_budgets=budgets,
                                    with_stats=True)
    n_isect, n_bd = int(stats["n_isect"]), int(stats["n_budget_dropped"])
    nw, nd, gcap = rasterize_grad_meta(*args, WIDTH, HEIGHT, tile_size=TILE, chunk=CHUNK,
                                       max_tiles_per_gaussian=MAX_T, class_budgets=budgets)
    frac = min(1.0, max(float(nw + nd) * 1.08, CHUNK) / float(gcap))
    log(f"[bench compact] budgets {budgets}: n_sort_slots {n_slots} (JAX package "
        f"{BENCH_N_SORT_SLOTS}; dense {N_GAUSSIANS * MAX_T}), n_isect {n_isect}, "
        f"n_budget_dropped {n_bd}, n_grad_written {nw} (JAX package {BENCH_N_GRAD_WRITTEN}), "
        f"n_grad_dropped {nd}, grad_cap {gcap}, grad_buffer_frac {frac:.4f} (JAX package "
        f"{BENCH_GRAD_FRAC})")
    if n_slots != BENCH_N_SORT_SLOTS or n_bd != 0 or nd != 0:
        fail("[bench compact] n_sort_slots or a drop count differs from the JAX package's")
    if abs(nw - BENCH_N_GRAD_WRITTEN) > CHUNK or abs(frac - BENCH_GRAD_FRAC) > 5e-4:
        fail("[bench compact] n_grad_written or grad_buffer_frac differs from the JAX package's")

    def fwd_bwd_compact():
        for x in diff:
            x.grad = None
        img, alpha, _ = rasterize_tiled(*diff, args[5], WIDTH, HEIGHT, tile_size=TILE,
                                        chunk=CHUNK, max_tiles_per_gaussian=MAX_T,
                                        class_budgets=budgets, grad_buffer_frac=frac,
                                        reduce_slices=4, depth_grad=False)
        (img.sum() + alpha.sum()).backward()

    fb = {"dense": [], "compact": []}
    for name in ("dense", "compact", "compact", "dense"):
        fn = fwd_bwd_compact if name == "compact" else (lambda: dense_fwd_bwd(False))
        fb[name].append(cuda_ms(fn, reps=5))
    c_ms, d_ms = statistics.mean(fb["compact"]), statistics.mean(fb["dense"])
    log(f"[bench compact] bench.py fwd+bwd workload, compact (frac {frac:.4f}, reduce_slices "
        f"4): {c_ms:.3f} ms {fb['compact']}, {WIDTH * HEIGHT / (c_ms / 1e3):.1f} pixels/s; "
        f"dense in the same turns {d_ms:.3f} ms {fb['dense']} (phase 2: {dense_ms:.3f})")
    return {"bench_compact_fwd_bwd_ms": c_ms, "bench_compact_dense_ms": d_ms,
            "bench_n_slots": n_slots}


def small_phase(dev):
    """Phase 3: a small 3D scene through the kernels and through the
    oracle: images, then gradients of every parameter."""
    import torch

    from gaussian_splatting_tpu_torch.core.cameras import look_at, make_intrinsics
    from gaussian_splatting_tpu_torch.ops.render import render

    small = scene_3d(1500, seed=1, scale_range=(0.01, 0.03))
    K_small = make_intrinsics(160, 120, device=dev)
    view_small = look_at((0.4, 0.5, -3.0), (0.0, 0.0, 0.0), device=dev)
    sh = np.concatenate([small["features_dc"], small["features_rest"]], axis=1)
    names = ("means", "quats", "log_scales", "logit_opacities", "sh")
    timg = torch.as_tensor(np.random.default_rng(2).uniform(size=(120, 160, 3)),
                           dtype=torch.float32, device=dev)
    outs, grads = {}, {}
    for be in ("cuda", "ref"):
        leaves = [torch.as_tensor(small[k] if k != "sh" else sh, device=dev).requires_grad_(True)
                  for k in names]
        o = render(*leaves, view_small, K_small, 160, 120, backend=be, device=dev,
                   render_mode="RGB+D")
        loss = (((o.render[..., :3] - timg) ** 2).sum() + 0.3 * (o.alpha ** 2).sum()
                + 0.05 * (o.depth ** 2).sum())
        loss.backward()
        outs[be] = o
        grads[be] = [x.grad for x in leaves]
    outs = {be: o._replace(**{f: getattr(o, f).detach() for f in ("render", "alpha", "depth")})
            for be, o in outs.items()}
    d_img = float((outs["cuda"].render[..., :3] - outs["ref"].render[..., :3]).abs().max())
    d_alpha = float((outs["cuda"].alpha - outs["ref"].alpha).abs().max())
    d_depth = float((outs["cuda"].depth - outs["ref"].depth).abs().max())
    log(f"[small] 1500 gaussians 160x120, kernels vs oracle: max |diff| image "
        f"{d_img:.3e}, alpha {d_alpha:.3e}, depth {d_depth:.3e}; "
        f"alpha max {float(outs['ref'].alpha.max()):.3f}")
    if not (d_img <= 1e-4 and d_alpha <= 1e-4 and d_depth <= 1e-3):
        fail("[small] the kernel path disagrees with the oracle")
    rel = {}
    for name, gk, gr in zip(names, grads["cuda"], grads["ref"]):
        scale = float(gr.abs().max()) + 1e-12
        rel[name] = float((gk - gr).abs().max()) / scale
        if not (bool(torch.isfinite(gk).all())
                and bool(((gk - gr).abs() <= GRAD_ATOL_FRAC * scale
                          + GRAD_RTOL * gr.abs()).all())):
            fail(f"[small] kernel gradient of {name} disagrees with autograd through the oracle")
    log(f"[small] gradients, kernels vs autograd through the oracle: max |diff| / max |grad| "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in rel.items()})}")


def adversarial_tiles(seed, ts, ntx, nty, per_tile, max_op, max_ratio, finite):
    """``per_tile`` entries in each tile of a ntx x nty tile image, as the
    raster kernels take them: tile_starts, counts and a (16, M) SoA (rows
    10 = 1, 11 = entry index), numpy. They stress the warp cull: means
    within two tiles of their own tile, footprints from a third of a pixel
    to four tiles, near-singular conics at any angle (axis ratio from
    sqrt(max_ratio) to ``max_ratio``), opacities up to ``max_op``, isotropic entries whose alpha at one pixel
    centre of their tile is 1/255 (1 + 1e-6 to 1e-5), so that the pixel
    contributes with its q only the gate's 2e-3 inside Q, and entries the
    cull must never skip: op below 1/255, an indefinite conic and, unless
    ``finite``, a non-finite mean or conic."""
    rng = np.random.default_rng(seed)
    n = ntx * nty * per_tile
    tile = np.repeat(np.arange(ntx * nty), per_tile)
    ox, oy = (tile % ntx) * ts, (tile // ntx) * ts
    kind = rng.integers(0, 5, size=n)
    s1 = np.exp(rng.uniform(np.log(0.3), np.log(4.0 * ts), size=n))
    ratio = np.exp(np.where(kind == 1, rng.uniform(0.5, 1.0, size=n) * np.log(max_ratio),
                            rng.uniform(0.0, np.log(4.0), size=n)))
    th = rng.uniform(0.0, np.pi, size=n)
    c, s = np.cos(th), np.sin(th)
    i1, i2 = 1.0 / s1**2, (ratio / s1) ** 2  # inverse variances along the axes
    conic = np.stack([c * c * i1 + s * s * i2, c * s * (i1 - i2), s * s * i1 + c * c * i2])
    means = np.stack([ox + rng.uniform(-2 * ts, 3 * ts, size=n),
                      oy + rng.uniform(-2 * ts, 3 * ts, size=n)])
    ops = np.array([float(ALPHA_SKIP) * (1 + 1e-5), float(ALPHA_SKIP) * 1.01, 0.02, 0.05, 0.5,
                    1.0])
    op = rng.choice(ops[ops <= max_op], size=n)
    bnd = kind == 2
    ci = rng.uniform(0.01, 2.0, size=n)
    sig = rng.uniform(0.05, np.log(255.0 * max_op) - 1e-3, size=n)
    px = (ox + rng.integers(0, ts, size=n) + 0.5).astype(np.float32)
    py = (oy + rng.integers(0, ts, size=n) + 0.5).astype(np.float32)
    conic[:, bnd] = np.stack([ci, np.zeros(n), ci])[:, bnd]
    means[:, bnd] = np.stack([px - np.sqrt(2.0 * sig / ci), py])[:, bnd]
    means, conic = means.astype(np.float32), conic.astype(np.float32)
    # sigma at the chosen pixel in the kernels' float32 operations and order
    # (raster_common.cuh::eval_entry), and the opacity that puts that
    # pixel's alpha just above 1/255.
    dx, dy = px - means[0], py - means[1]
    sigma = (np.float32(0.5) * (conic[0] * dx * dx + conic[2] * dy * dy)
             + conic[1] * dx * dy)
    u = rng.uniform(1e-6, 1e-5, size=n)
    op = np.where(bnd, float(ALPHA_SKIP) * np.exp(np.where(bnd, sigma, 0.0)) * (1 + u), op)
    never = kind == 4
    sub = rng.integers(0, 2 if finite else 4, size=n)
    op[never & (sub == 0)] = float(ALPHA_SKIP) * 0.999
    indef = never & (sub == 1)
    conic[1, indef] = 2.0 * np.sqrt(conic[0, indef] * conic[2, indef])
    means[0, never & (sub == 2)] = np.nan
    conic[2, never & (sub == 3)] = np.inf
    soa = np.zeros((16, n + 8), np.float32)
    soa[:10, :n] = np.concatenate([means, conic, op[None], rng.uniform(0.2, 1.0, size=(3, n)),
                                   rng.uniform(1.0, 10.0, size=(1, n))])
    soa[10, :n] = 1.0
    soa[11, :n] = np.arange(n)
    starts = (np.arange(ntx * nty + 1) * per_tile).astype(np.int32)
    return starts, np.full(ntx * nty, per_tile, np.int32), soa


def adversarial_phase(dev, width=1024, height=512):
    """Phase 3b: the raster kernels at tile sizes 8, 16 and 32 on
    ``adversarial_tiles`` against their plain versions. First one entry a
    tile (all opacities, axis ratios up to 1e4, non-finite entries too,
    chunk 32): every pixel
    starts at transmittance 1, so a contributing pair that the warp cull
    skipped would cost the sum_w row at least 1/255 at its pixel, far above
    the forward's 1e-5 gate. Then 48 entries a tile (op <= 0.05, chunk 32,
    so two chunks): the transmittance stays above 0.95^47 ~ 0.09, so a
    skipped pair still costs 3.5e-4; there also the queue forward equal to
    the loop forward bit for bit, and the backward + kernel reduce against
    the plain backward + plain reduce under the backward's gates. That
    scene's entries are finite (the plain backward's masked products make a
    NaN mean's terms NaN) and its axis ratios at most 1e2: at 1e4 a mean's
    gradient is the difference of terms ~1e4 times larger, and the
    contraction of the kernel's multiply-adds alone moves it by more than
    the gates. The plain mirror of the cull must find no contributing pair
    culled, and some culled."""
    import torch

    from gaussian_splatting_tpu_torch.ops.rasterize_cuda import (
        bwd_tiles, bwd_tiles_plain, cdiv, fwd_tiles, fwd_tiles_plain, fwd_tiles_q,
        warp_cull_plain)
    from gaussian_splatting_tpu_torch.ops.tiling import chunk_queue, reduce_padded_grads

    chunk = 32
    for ts in (8, 16, 32):
        ntx, nty = width // ts, height // ts
        for per_tile, max_op, max_ratio, finite in ((1, 1.0, 1e4, False),
                                                    (48, 0.05, 1e2, True)):
            tag = f"adversarial ts {ts}, {per_tile} a tile"
            starts, counts, soa = (torch.as_tensor(x, device=dev) for x in adversarial_tiles(
                ts + per_tile, ts, ntx, nty, per_tile, max_op, max_ratio, finite))
            n = int(counts.sum())
            keep, touched = warp_cull_plain(starts, counts, soa, ts, ntx)
            missed = int((touched & ~keep).sum())
            k_out = fwd_tiles(starts, counts, soa, ts, ntx, chunk)
            p_out, _ = fwd_tiles_plain(starts, counts, soa, ts, ntx, chunk)
            diff = (k_out - p_out).abs()
            err_rgbw = float(torch.cat([diff[:, 0:3], diff[:, 4:8]], 1).max())
            err_depth = float(diff[:, 3].max())
            n_bad = int(((diff[:, 0:3] > 1e-5).any(1) | (diff[:, 4] > 1e-5)
                         | (diff[:, 3] > 1e-4)).sum())
            log(f"[{tag}] {n} entries: mirror culls {float((~keep).float().mean()):.4f} of the "
                f"(warp, entry) pairs, contributing pairs culled {missed}; forward kernel vs "
                f"plain: max |diff| rgb/sum_w {err_rgbw:.3e}, depth {err_depth:.3e}, pixels "
                f"beyond tolerance {n_bad}")
            if missed or bool(keep.all()):
                fail(f"[{tag}] the cull's mirror skips a contributing pair or culls nothing")
            if n_bad or not bool(torch.isfinite(k_out).all()):
                fail(f"[{tag}] forward kernel disagrees with fwd_tiles_plain")
            if per_tile == 1:
                continue
            wtile, cum, n_work = chunk_queue(counts, chunk, cdiv(n, chunk) + counts.shape[0])
            q_out = fwd_tiles_q(wtile, cum, starts, counts, n_work.reshape(1), soa, ts, ntx,
                                chunk)
            if not torch.equal(q_out, k_out):
                fail(f"[{tag}] the queue forward differs from the loop forward")
            gen = torch.Generator(device=dev).manual_seed(ts)
            gout = torch.randn(k_out.shape, generator=gen, device=dev)
            gout[:, 5:] = 0.0
            gcap = cdiv(n, chunk) * chunk
            k_grad, k_meta = bwd_tiles(starts, counts, soa, gout, k_out, ts, ntx, chunk, n, gcap)
            k_sums = reduce_padded_grads(k_grad, n, k_meta[0], with_depth=True)
            p_grad, p_meta, _ = bwd_tiles_plain(starts, counts, soa, gout, k_out, ts, ntx,
                                                chunk, n, gcap)
            p_sums = plain_reduce(p_grad, n, p_meta[0], with_depth=True)
            stats, ok = grad_errors(k_sums, p_sums)
            km, pm = k_meta.tolist(), p_meta.tolist()
            log(f"[{tag}] queue forward == loop forward: True; backward kernel + reduce vs "
                f"plain: meta kernel {km}, plain {pm}; rel_l2 "
                f"{max(st.get('rel_l2', 0.0) for st in stats.values()):.3e}, smaller half "
                f"{max(st.get('rel_l2_small', 0.0) for st in stats.values()):.3e}")
            if km != pm or not ok or not all(bool(torch.isfinite(v).all())
                                              for v in k_sums.values()):
                for key, st in stats.items():
                    log(f"[{tag}]   {key}: " + ", ".join(f"{k} {v:.3e}" for k, v in st.items()))
                fail(f"[{tag}] backward kernel disagrees with bwd_tiles_plain")
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def render_phase(dev, state, views):
    """Phase 4: the render path through the facade."""
    import torch

    from gaussian_splatting_tpu_torch.ops.facade import GaussianRasterizer

    raster = GaussianRasterizer(WIDTH, HEIGHT, backend="auto", sh_degree=3, device=dev)
    reset_launches()
    outs = [raster.render_single(state.params, vp) for vp in views]
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[render] backend {raster.backend}, launches during the 4 renders: {launches}")
    for i, o in enumerate(outs):
        img, alpha = o.render, o.alpha
        cover = float((alpha > 0).float().mean())
        log(f"[render] view {i}: image {tuple(img.shape)}, visible gaussians "
            f"{int(o.visibility.sum())}, coverage {cover:.4f}, alpha max "
            f"{float(alpha.max()):.4f}, mean rgb {[round(float(v), 4) for v in img.mean((0, 1))]}")
        if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(img).all()):
            fail(f"[render] view {i}: image not finite or of the wrong shape")
        if not (float(alpha.min()) >= 0.0 and float(alpha.max()) <= 1.0 and cover > 0.0):
            fail(f"[render] view {i}: alpha outside [0, 1] or no coverage")
    if min(launches["pack_soa"], launches["rasterize_fwd"]) < 1:
        fail(f"[render] a kernel of the render path never launched: {launches}")
    images = torch.stack([torch.clamp(o.render, 0.0, 1.0) for o in outs])
    return raster, images, launches


def train_phase(dev, scene, views, images):
    """Phase 5: TRAIN_STEPS training steps at full size. Returns the step
    function, the state, the batch, the per-step device times and the
    launches of the run."""
    import torch

    from gaussian_splatting_tpu_torch.models.gaussians import train_state_from_numpy
    from gaussian_splatting_tpu_torch.training.config import TrainingConfig
    from gaussian_splatting_tpu_torch.training.step import ViewBatch, make_train_step

    config = TrainingConfig(backend="auto")
    step = make_train_step(config, WIDTH, HEIGHT, 3, config.backend, SCENE_EXTENT, device=dev)
    state = train_state_from_numpy(noisy_train_arrays(scene, seed=1), device=dev)
    batch = ViewBatch(images=images,
                      viewmats=torch.stack([v["world_view_transform"] for v in views]),
                      Ks=torch.stack([v["K"] for v in views]))
    losses, step_ms = [], []
    reset_launches()
    for i in range(TRAIN_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = step(state, batch)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
        losses.append(float(m["loss"]))
        log(f"[train] step {i}: loss {losses[-1]:.6f}, psnr {float(m['psnr']):.3f}, "
            f"l1 {float(m['l1']):.5f}, ssim {float(m['ssim']):.5f}, n_isect "
            f"{int(m['stats/n_isect'])}, n_dropped {int(m['stats/n_dropped'])}, "
            f"n_grad_dropped {int(m['stats/n_grad_dropped'])}, grad_norm/means "
            f"{float(m['grad_norm/means']):.4e}, {step_ms[-1]:.3f} ms")
        if not np.isfinite(losses[-1]) or int(m["stats/n_grad_dropped"]) > 0:
            fail(f"[train] step {i}: loss not finite or gradient entries dropped")
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[train] {TRAIN_STEPS} steps of batch {images.shape[0]} at {WIDTH}x{HEIGHT}, "
        f"backend auto -> cuda: launches {launches}")
    for k in ("means", "quats", "log_scales", "logit_opacities", "features_dc",
              "features_rest"):
        if not bool(torch.isfinite(getattr(state.gauss.params, k)).all()):
            fail(f"[train] parameter {k} is not finite")
    if not losses[-1] < losses[0]:
        fail(f"[train] the loss did not descend: {losses}")
    if min(launches[k] for k in KERNELS[:5]) < 1:
        fail(f"[train] a kernel of the training path never launched: {launches}")
    return step, state, batch, step_ms, launches


def run(dev):
    """Phases 2-7 on ``dev``; returns the kernels report."""
    import torch

    from gaussian_splatting_tpu_torch.core.cameras import look_at, make_intrinsics
    from gaussian_splatting_tpu_torch.models.gaussians import (
        PARAM_KEYS, GaussianParams, state_from_numpy)
    from gaussian_splatting_tpu_torch.ops.partition import (
        bucket_partition, bucket_partition_plain)
    from gaussian_splatting_tpu_torch.ops.rasterize_cuda import (
        bwd_tiles, bwd_tiles_plain, bwd_tiles_q, cdiv, check_queue, fwd_tiles,
        fwd_tiles_plain, fwd_tiles_q)
    from gaussian_splatting_tpu_torch.ops.tiling import BUCKET_C
    from gaussian_splatting_tpu_torch.ops.render import project_and_shade, render
    from gaussian_splatting_tpu_torch.ops.segsum import (
        segment_sum_sorted, segment_sum_sorted_plain)
    from gaussian_splatting_tpu_torch.ops.tiling import (
        isect_and_sort, pack_rows, pack_rows_plain, pack_soa, pack_soa_plain,
        reduce_padded_grads, sorted_gid_key)
    from gaussian_splatting_tpu_torch.training.loss import photometric_loss
    from gaussian_splatting_tpu_torch.training.optimizer import AdamState, adam_update

    bench = bench_phase(dev)
    small_phase(dev)
    adversarial_phase(dev)

    scene = scene_3d(N_GAUSSIANS, seed=0)
    state = state_from_numpy(scene, device=dev)
    K = make_intrinsics(WIDTH, HEIGHT, device=dev)
    views = [{"world_view_transform": look_at(e, (0.0, 0.0, 0.0), device=dev), "K": K}
             for e in view_eyes()]
    from gaussian_splatting_tpu_torch.utils import profiling

    profiling.reset_counters("project_sh.autograd")
    raster, images, render_launches = render_phase(dev, state, views)
    # Both render-path kernels against their plain versions on the render
    # path's own view 0.
    rp = state.params
    with torch.no_grad():
        proj, colors, opac = project_and_shade(
            rp.means, rp.quats, rp.log_scales, rp.logit_opacities, rp.sh_coeffs,
            views[0]["world_view_transform"], K, WIDTH, HEIGHT, sh_degree=3)
    rargs = (proj.means2d, proj.conics, colors, opac, proj.depths, proj.radii)
    compare_kernels(rargs, isect_and_sort(*rargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T),
                    "render view 0")
    del proj, colors, opac, rargs
    torch.cuda.empty_cache()
    step, tstate, batch, step_ms, launches = train_phase(dev, scene, views, images)
    psh_launches = project_sh_launches(render_launches, launches, len(views),
                                       TRAIN_STEPS * images.shape[0])
    bsl_launches = bin_slots_launches(render_launches, launches, len(views),
                                      TRAIN_STEPS * images.shape[0])
    adam_step_launches = adam_launches(launches, TRAIN_STEPS, "training step")

    # 6. Timings at the main paths' shapes, CUDA events, medians.
    render_ms = [cuda_ms(lambda vp=vp: raster.render_single(state.params, vp),
                         reps=1, warmup=0) for _ in range(2) for vp in views]
    torch.cuda.reset_peak_memory_stats()
    raster.render_single(state.params, views[0])
    render_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    step(tstate, batch)
    torch.cuda.synchronize()
    step_peak_gb = torch.cuda.max_memory_allocated() / 2**30

    tp = tstate.gauss.params
    shade_args = (tp.means, tp.quats, tp.log_scales, tp.logit_opacities, tp.sh_coeffs,
                  views[0]["world_view_transform"], K, WIDTH, HEIGHT)

    def view_fwd_bwd():
        leaves = [x.detach().requires_grad_(True)
                  for x in (tp.means, tp.quats, tp.log_scales, tp.logit_opacities,
                            tp.sh_coeffs)]
        out = render(*leaves, views[0]["world_view_transform"], K, WIDTH, HEIGHT,
                     sh_degree=3, backend="auto", depth_grad=False, device=dev)
        photometric_loss(out.render, images[0], 0.2)[0].backward()

    view_ms = cuda_ms(view_fwd_bwd, reps=5)
    shade_ms = cuda_ms(lambda: project_and_shade(*shade_args, sh_degree=3))

    def shade_fwd_bwd():
        leaves = [x.detach().requires_grad_(True) for x in shade_args[:5]]
        pr, col, op = project_and_shade(*leaves, *shade_args[5:], sh_degree=3)
        (pr.means2d.sum() + pr.conics.sum() + col.sum() + op.sum()
         + pr.depths.sum()).backward()

    shade_fb_ms = cuda_ms(shade_fwd_bwd, reps=5)

    def loss_fwd_bwd():
        img = images[1].clone().requires_grad_(True)
        photometric_loss(img, images[0], 0.2)[0].backward()

    loss_ms = cuda_ms(loss_fwd_bwd)
    def clone(g):
        return GaussianParams(**{k: getattr(g, k).clone() for k in PARAM_KEYS})

    # Adam on copies of the state, with its first moments as the gradient.
    params, opt = clone(tp), AdamState(mu=clone(tstate.opt.mu), nu=clone(tstate.opt.nu),
                                       step=tstate.opt.step.clone())
    lrs = GaussianParams(**{k: 1e-3 for k in PARAM_KEYS})
    adam_ms = cuda_ms(lambda: adam_update(tstate.opt.mu, opt, params, lrs))
    del params, opt
    with torch.no_grad():
        proj, colors, opac = project_and_shade(*shade_args, sh_degree=3)
    sargs = (proj.means2d, proj.conics, colors, opac, proj.depths, proj.radii)
    b = isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T)
    kc = compare_kernels(sargs, b, "train view 0")
    pack_err, fwd_err, fwd_out, pairs = (kc[k] for k in ("pack_err", "fwd_err", "fwd_out",
                                                           "pairs"))
    plain_out, records, gid, n_live, culled = (kc[k] for k in ("plain_out", "records", "gid",
                                                               "n_live", "culled"))
    del kc
    bw = compare_backward(b, fwd_out, N_GAUSSIANS, "train view 0", seed=1)
    qerr = compare_queue(b, fwd_out, plain_out, bw, N_GAUSSIANS, "train view 0")
    del plain_out
    bk = compare_partition(sargs, b, fwd_out, bw, "train view 0")
    bstep, bstate, bbatch, bstep_ms, blaunches = bucket_train_phase(dev, scene, views, images)
    cp = compact_phase(dev, sargs, b, fwd_out, bw, tstate, views, images)
    cstep, cstate, cbatch, cstep_ms = compact_train_phase(dev, scene, views, images)
    M = gid.shape[0]
    gid_long = gid.long()
    T = b.counts.shape[0]
    P = TILE * TILE
    n_is = int(b.n_isect)
    ntx = cdiv(WIDTH, TILE)
    N = N_GAUSSIANS
    cnt = b.counts.double()
    top = torch.sort(cnt, descending=True).values
    n_top = cdiv(T, 100)
    log(f"[train view 0] entries per tile over {T} tiles: max {int(top[0])}, p50 "
        f"{float(torch.quantile(cnt, 0.5)):.1f}, p99 {float(torch.quantile(cnt, 0.99)):.1f}, "
        f"mean {float(cnt.mean()):.1f}; share of the entries in the largest 1 % of tiles "
        f"({n_top}) {float(top[:n_top].sum() / cnt.sum()):.4f}")
    del cnt, top

    binning_ms = cuda_ms(lambda: isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T), reps=5)
    binning_bucket_ms = cuda_ms(lambda: isect_and_sort(
        *sargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T, sort_buckets=BUCKETS,
        bucket_headroom=BUCKET_HEADROOM), reps=5)
    peaks = binning_peak_gib(sargs)
    # pack_soa: the dense binning's call (n_live), the full gather of the
    # same columns and of the bucket binning's B * cap columns. Yardsticks:
    # index_select of the (10, N) row table (ten rows written of sixteen),
    # of a (16, N) table holding the ten rows, ones, ids and zeros (the
    # same bytes), of the (N, 10) records (a row gather), and writing the
    # (16, m_out) output's zeros.
    pack_ms = cuda_ms(lambda: pack_soa(records, gid, 2 * CHUNK, n_live))
    pack_full_ms = cuda_ms(lambda: pack_soa(records, gid, 2 * CHUNK))
    gid_b = bk["gid"]
    pack_bucket_ms = cuda_ms(lambda: pack_soa(records, gid_b, 2 * CHUNK))
    pack_plain_ms = cuda_ms(lambda: pack_soa_plain(records, gid, 2 * CHUNK, n_live), reps=5)
    table = records.T.contiguous()
    pack_lib_ms = cuda_ms(lambda: torch.index_select(table, 1, gid_long))
    table16 = torch.zeros((16, N), device=dev)
    table16[:10] = table
    table16[10] = 1.0
    table16[11] = torch.arange(N, device=dev, dtype=torch.float32)
    pack_lib16_ms = cuda_ms(lambda: torch.index_select(table16, 1, gid_long))
    pack_lib_rec_ms = cuda_ms(lambda: torch.index_select(records, 0, gid_long))
    gid_b_long = gid_b.long()
    pack_bucket_lib_ms = cuda_ms(lambda: torch.index_select(table, 1, gid_b_long))
    pack_bucket_lib16_ms = cuda_ms(lambda: torch.index_select(table16, 1, gid_b_long))
    del table16, gid_b_long
    pack_zeros_ms = cuda_ms(lambda: torch.zeros_like(b.sorted_soa))
    fwd_ms = cuda_ms(lambda: fwd_tiles(b.tile_starts, b.counts, b.sorted_soa, TILE, ntx, CHUNK))
    fwd_plain_ms = cuda_ms(lambda: fwd_tiles_plain(b.tile_starts, b.counts, b.sorted_soa,
                                                   TILE, ntx, CHUNK), reps=3, warmup=1)
    gout, gcap = bw["gout"], bw["gcap"]
    bwd_args = (b.tile_starts, b.counts, b.sorted_soa, gout, fwd_out, TILE, ntx, CHUNK, N, gcap)
    bwd_ms = cuda_ms(lambda: bwd_tiles(*bwd_args))
    bwd_plain_ms = cuda_ms(lambda: bwd_tiles_plain(*bwd_args), reps=3, warmup=1)
    # The queue kernels at the same shapes; their plain versions are the
    # queue check and the loop's plain versions.
    queue = queue_for(b)
    n_work = int(queue[2])
    fwd_q_ms = cuda_ms(lambda: fwd_tiles_q(*queue[:2], b.tile_starts, b.counts, queue[2],
                                           b.sorted_soa, TILE, ntx, CHUNK))
    fwd_q_plain_ms = cuda_ms(lambda: (check_queue(*queue, b.counts, CHUNK), fwd_tiles_plain(
        b.tile_starts, b.counts, b.sorted_soa, TILE, ntx, CHUNK)), reps=3, warmup=1)
    bwd_q_ms = cuda_ms(lambda: bwd_tiles_q(*queue[:2], b.tile_starts, b.counts, queue[2],
                                           *bwd_args[2:]))
    bwd_q_plain_ms = cuda_ms(lambda: (check_queue(*queue, b.counts, CHUNK),
                                      bwd_tiles_plain(*bwd_args)), reps=3, warmup=1)
    # The partition at the bucket binning's own inputs.
    tile_key, depths_v, q, Tb, part_err = (bk[k] for k in ("tile_key", "depths", "q", "T",
                                                           "err"))
    part_ms = cuda_ms(lambda: bucket_partition(tile_key, depths_v, Tb, BUCKETS, q, C=BUCKET_C))
    part_plain_ms = cuda_ms(lambda: bucket_partition_plain(tile_key, depths_v, Tb, BUCKETS, q,
                                                           C=BUCKET_C), reps=5)
    # The key passes the fused partition removed: the int64 key built from
    # the tile and depth rows of the old (16, B, cap) output, timed on two
    # (B, cap) float32 rows of that shape.
    from gaussian_splatting_tpu_torch.ops.tiling import _float_order_bits

    rows01 = torch.rand((2,) + tuple(bk["out"][0].shape), device=dev)
    key_pass_ms = cuda_ms(lambda: (rows01[0].to(torch.int64) << 32)
                          | _float_order_bits(rows01[1]))
    del rows01
    grad, meta, key, perm, stacked = (bw[k] for k in ("grad", "meta", "key", "perm", "stacked"))
    n_written = int(meta[0])
    nv = meta[:1].contiguous()
    sort_ms = cuda_ms(lambda: sorted_gid_key(grad, N, meta[0], 0, grad.shape[1]))
    reduce_ms = cuda_ms(lambda: reduce_padded_grads(grad, N, meta[0], with_depth=False))
    # The step reduces without the depth payload: 10 rows.
    prow_ms = cuda_ms(lambda: pack_rows(grad, perm, key, nv, 0, 10, float(N)))
    prow_plain_ms = cuda_ms(lambda: pack_rows_plain(grad, perm, key, nv, 0, 10, float(N)),
                            reps=5)
    prow_lib_ms = cuda_ms(lambda: torch.index_select(grad[:10], 1, perm))
    prow_lib16_ms = cuda_ms(lambda: torch.index_select(grad, 1, perm))
    prow_zeros_ms = cuda_ms(lambda: torch.zeros_like(stacked))
    # segsum as the step calls it: the 10-row buffer, n_rows 10. Beside it,
    # a buffer with no entry at all (a slice past n_written): all zeros out.
    seg_ms = cuda_ms(lambda: segment_sum_sorted(stacked, N, 10))
    seg_plain_ms = cuda_ms(lambda: segment_sum_sorted_plain(stacked, N, 10), reps=5)
    empty = torch.zeros_like(stacked)
    empty[0] = float(N)
    seg_empty_ms = cuda_ms(lambda: segment_sum_sorted(empty, N, 10))
    del empty
    # Library yardsticks: index_add_ on the kernel's (16, M) layout and on
    # the (M, 16) one (a contiguous transposed copy made beforehand); the
    # faster one is reported.
    ids = stacked[0].long()
    seg_lib_cols_ms = cuda_ms(
        lambda: torch.zeros((16, N + 1), device=dev).index_add_(1, ids, stacked))
    rows = stacked.T.contiguous()
    seg_lib_rows_ms = cuda_ms(
        lambda: torch.zeros((N + 1, 16), device=dev).index_add_(0, ids, rows))
    del rows
    seg_lib_ms = min(seg_lib_cols_ms, seg_lib_rows_ms)

    # pack_soa: reads the (N, 10) records (40 B a gaussian) and an id (4 B)
    # only for the columns below n_live, and writes 64 B per output column;
    # the full gathers read an id for every column below M.
    m_out = b.sorted_soa.shape[1]
    live = int(n_live)
    pack_bound = (4 * live + 40 * N + 64 * m_out) / HBM_BYTES_PER_S * 1e3
    pack_full_bound = (4 * M + 40 * N + 64 * m_out) / HBM_BYTES_PER_S * 1e3
    mb = gid_b.shape[0]
    mb_out = cdiv(mb + 2 * CHUNK, 8192) * 8192
    pack_bucket_bound = (4 * mb + 40 * N + 64 * mb_out) / HBM_BYTES_PER_S * 1e3
    fwd_bytes_ms = (4 * (2 * T + 1) + 4 * 10 * n_is + 4 * T * 8 * P) / HBM_BYTES_PER_S * 1e3
    fwd_ops_ms = pairs * FWD_FLOPS_PER_PAIR / FP32_FLOPS * 1e3
    # Backward: reads the tables, rows 0-9 and 11 of each entry, the
    # cotangent and forward output; writes one 64-byte column per entry
    # kept (n_written) and the meta.
    bwd_bytes_ms = ((4 * (2 * T + 1) + 4 * 11 * n_is + 2 * 4 * T * 8 * P
                     + 64 * n_written + 12) / HBM_BYTES_PER_S * 1e3)
    bwd_ops_ms = ((pairs * BWD_RECOMPUTE_FLOPS + bw["active"] * BWD_GRAD_FLOPS)
                  / FP32_FLOPS * 1e3)
    # The raster kernels' bound: the bytes above, and the operations of the
    # pairs that carry anything (they count with alpha != 0: the pairs with
    # gradient terms), all that these inputs need once a cull skips the
    # rest. The operations above, of every pair the sweep evaluates without
    # the cull, go into the kernels line as bound_unculled_ms, comparable
    # with the bound of runs made before the kernels culled.
    fwd_needed_ops_ms = bw["active"] * FWD_FLOPS_PER_PAIR / FP32_FLOPS * 1e3
    bwd_needed_ops_ms = (bw["active"] * (BWD_RECOMPUTE_FLOPS + BWD_GRAD_FLOPS)
                         / FP32_FLOPS * 1e3)
    fwd_needed_ms = max(fwd_bytes_ms, fwd_needed_ops_ms)
    bwd_needed_ms = max(bwd_bytes_ms, bwd_needed_ops_ms)
    # The entries the backward wrote (the rest of the stream, up to
    # grad_cap, is sentinel): only these carry payload.
    n_real = int((key < N).sum())
    # pack_rows (10 rows): reads the key (4 B) of every column, and the
    # permutation (8 B) and 9 payloads (36 B) of the real entries; writes
    # 64 B per output column.
    prow_out = stacked.shape[1]
    prow_bound = ((4 * perm.shape[0] + (8 + 4 * 9) * n_real + 64 * prow_out)
                  / HBM_BYTES_PER_S * 1e3)
    # segsum (n_rows 10): reads the id (4 B) and the 9 payload rows (36 B)
    # of the real entries, the columns below the first sentinel; writes 64 B
    # per gaussian.
    seg_bound = ((4 + 36) * n_real + 64 * N) / HBM_BYTES_PER_S * 1e3
    # The queue kernels do the loop kernels' work and read the queue too:
    # cum (T + 1), n_work and one wtile entry per work item.
    queue_bytes_ms = (4 * (T + 2) + 4 * n_work) / HBM_BYTES_PER_S * 1e3
    # partition: reads the tile (4 B) of every slot and the depth (4 B) of
    # each kept one; writes the key (8 B) and gid (4 B) of every output
    # column, and the counts and drops.
    part_kept = int(bk["out"][2].sum())
    part_cols = bk["out"][0].numel()
    part_bound = ((4 * tile_key.shape[0] + 4 * part_kept + 12 * part_cols + 8 * BUCKETS)
                  / HBM_BYTES_PER_S * 1e3)

    per_step = {k: v / (TRAIN_STEPS) for k, v in launches.items()}
    log(f"[time] per-view render {statistics.median(render_ms):.3f} ms (median of "
        f"{len(render_ms)}: {[round(x, 3) for x in render_ms]}); peak device memory "
        f"of one render {render_peak_gb:.2f} GiB")
    log(f"[time] training step (batch 4, {WIDTH}x{HEIGHT}) {statistics.median(step_ms[1:]):.3f} "
        f"ms (median of steps 1-{TRAIN_STEPS - 1}: {[round(x, 3) for x in step_ms]}); peak "
        f"device memory of one step {step_peak_gb:.2f} GiB; one view fwd+bwd "
        f"{view_ms:.3f} ms; bench.py fwd+bwd workload {bench['bench_fwd_bwd_ms']:.3f} ms")
    log(f"[time] train view 0: n_isect {n_is}, slots {M}, pairs evaluated {pairs}, pairs "
        f"with gradient terms {bw['active']}, n_written {n_written}, grad_cap {gcap}; "
        f"projection + SH {shade_ms:.3f} ms, binning incl. pack {binning_ms:.3f} ms, pack "
        f"{pack_ms:.3f} ms, forward {fwd_ms:.3f} ms, backward kernel {bwd_ms:.3f} ms, "
        f"gid sort {sort_ms:.3f} ms, pack_rows {prow_ms:.3f} ms, segsum {seg_ms:.3f} ms, "
        f"whole reduce {reduce_ms:.3f} ms; projection + SH forward and backward "
        f"{shade_fb_ms:.3f} ms; photometric loss forward and backward {loss_ms:.3f} ms; "
        f"Adam over all groups {adam_ms:.3f} ms")
    log(f"[time] bounds: forward bytes {fwd_bytes_ms:.4f} / operations {fwd_ops_ms:.4f} ms; "
        f"backward bytes {bwd_bytes_ms:.4f} / operations {bwd_ops_ms:.4f} ms (every pair "
        f"evaluated without the cull); operations of the {bw['active']} pairs that carry "
        f"anything: forward {fwd_needed_ops_ms:.4f} ms, backward {bwd_needed_ops_ms:.4f} ms; "
        f"bounds: forward {fwd_needed_ms:.4f} ms, backward {bwd_needed_ms:.4f} ms; warp cull "
        f"share at train view 0 {culled:.4f}; pack_rows {prow_bound:.4f} ms; segsum "
        f"{seg_bound:.4f} ms ({n_real} real entries of {stacked.shape[1]} columns); launches "
        f"per step {per_step}; render path launches {render_launches}")
    log(f"[time] segsum (n_rows 10) {seg_ms:.4f} ms, bound {seg_bound:.4f}; on a buffer with "
        f"no entry {seg_empty_ms:.4f} ms")
    log(f"[time] library yardsticks: segsum index_add_ on (16, N+1) {seg_lib_cols_ms:.3f} ms, "
        f"on (N+1, 16) {seg_lib_rows_ms:.3f} ms; pack_rows index_select {prow_lib_ms:.3f} ms; "
        f"pack index_select {pack_lib_ms:.3f} ms")
    log(f"[time] pack_soa (n_live {live} of {M} columns): {pack_ms:.4f} ms, bound "
        f"{pack_bound:.4f}; full gather of the {M} columns {pack_full_ms:.4f} ms, bound "
        f"{pack_full_bound:.4f}; bucket path's full gather of {mb} columns "
        f"{pack_bucket_ms:.4f} ms, bound {pack_bucket_bound:.4f}; yardsticks: index_select "
        f"of the (10, N) table {pack_lib_ms:.4f} ms (bucket columns {pack_bucket_lib_ms:.4f}), "
        f"of a (16, N) table, the same bytes, {pack_lib16_ms:.4f} ms (bucket columns "
        f"{pack_bucket_lib16_ms:.4f}), of the (N, 10) records along dim 0 "
        f"{pack_lib_rec_ms:.4f} ms, zeros of the (16, {m_out}) output {pack_zeros_ms:.4f} ms")
    log(f"[time] pack_rows, reduce (10 rows, {n_real} real of {perm.shape[0]} columns): "
        f"{prow_ms:.4f} ms, bound {prow_bound:.4f}; yardsticks: index_select of 10 rows "
        f"{prow_lib_ms:.4f} ms, of all 16 rows, the same bytes, {prow_lib16_ms:.4f} ms, zeros "
        f"of the (16, {prow_out}) output {prow_zeros_ms:.4f} ms")
    log(f"[time] queue path, train view 0 ({n_work} work items): queue forward {fwd_q_ms:.3f} "
        f"ms (loop {fwd_ms:.3f}), queue backward {bwd_q_ms:.3f} ms (loop {bwd_ms:.3f}); bench.py "
        f"fwd+bwd workload queue {bench['bench_fwd_bwd_queue_ms']:.3f} ms, loop "
        f"{bench['bench_fwd_bwd_ms']:.3f} ms; queue run launches {bench['queue_launches']}")
    log(f"[time] bucket path (sort_buckets {BUCKETS}): binning incl. partition "
        f"{binning_bucket_ms:.3f} ms (dense {binning_ms:.3f}); peak device memory of one "
        f"binning above its inputs: bucket {peaks['bucket']:.3f} GiB, dense "
        f"{peaks['dense']:.3f} GiB; fused partition {part_ms:.4f} ms (plain "
        f"{part_plain_ms:.3f}, bound {part_bound:.4f}: {tile_key.shape[0]} slots, {part_kept} "
        f"kept, {part_cols} output columns); the key passes it removed, on two (B, cap) rows, "
        f"{key_pass_ms:.4f} ms; training step "
        f"{statistics.median(bstep_ms[1:]):.3f} ms (median of steps 1-{BUCKET_STEPS - 1}: "
        f"{[round(x, 3) for x in bstep_ms]}; dense {statistics.median(step_ms[1:]):.3f}); "
        f"launches per step {({k: v / BUCKET_STEPS for k, v in blaunches.items()})}")
    del bk

    # The compact layout at training view 0 (the trainer's budgets).
    budgets = cp["budgets"]
    bc_ms = cuda_ms(lambda: isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T,
                                           class_budgets=budgets), reps=5)
    bcb_ms = cuda_ms(lambda: isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T,
                                            class_budgets=budgets, sort_buckets=BUCKETS,
                                            bucket_headroom=BUCKET_HEADROOM), reps=5)
    c_grad, c_meta = cp["grad"], cp["meta"]
    c_reduce_ms = cuda_ms(lambda: reduce_padded_grads(c_grad, N, c_meta[0], with_depth=False))
    c_pack_ms = cuda_ms(lambda: pack_soa(cp["records"], cp["gid"], 2 * CHUNK, cp["n_live"]))
    c_part_ms = cuda_ms(lambda: bucket_partition(cp["tile_key"], cp["depths"], cp["T"], BUCKETS,
                                                 cp["q"], C=BUCKET_C, slot_gid=cp["slot_gid"]))
    c_peaks = binning_peak_gib(sargs, budgets)
    log(f"[time] compact binning (trainer budgets, {cp['n_slots']} slots of the dense {N * MAX_T}"
        f"): binning incl. pack {bc_ms:.3f} ms (dense {binning_ms:.3f}), with sort_buckets "
        f"{BUCKETS} {bcb_ms:.3f} ms (dense bucket {binning_bucket_ms:.3f}); pack_soa on the "
        f"compact gid {c_pack_ms:.4f} ms (dense {pack_ms:.4f}); partition with slot_gid "
        f"{c_part_ms:.4f} ms (dense {part_ms:.4f}); gradient reduce at grad_cap {cp['gcap']} "
        f"{c_reduce_ms:.3f} ms (dense grad_cap {gcap}: {reduce_ms:.3f}); peak device memory of "
        f"one binning: compact {c_peaks['compact']:.3f} GiB, dense {c_peaks['dense']:.3f}")
    log(f"[time] training step with the trainer's compact budgets "
        f"{statistics.median(cstep_ms[1:]):.3f} ms (median of steps 1-{len(cstep_ms) - 1}: "
        f"{[round(x, 3) for x in cstep_ms]}); dense {statistics.median(step_ms[1:]):.3f} ms")
    del cp, c_grad, c_meta

    trace(lambda: raster.render_single(state.params, views[0]), "one render")
    trace(lambda: step(tstate, batch), "one training step")
    trace(lambda: bstep(bstate, bbatch), "one bucket-path training step")
    trace(lambda: cstep(cstate, cbatch), "one compact training step (the trainer's budgets)")
    trace(lambda: isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T,
                                 class_budgets=budgets), "one compact binning")
    trace(lambda: isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T), "one dense binning")
    del cstep, cstate, cbatch

    # Launches: rows 1-5 from the dense training run, the queue kernels from
    # the queue path's run, the partition from the bucket path's run.
    launches = dict(launches, rasterize_fwd_q=bench["queue_launches"]["rasterize_fwd_q"],
                    rasterize_bwd_q=bench["queue_launches"]["rasterize_bwd_q"],
                    partition=blaunches["partition"])

    # Each kernel's device time alone (profiler), beside the wrapper's time.
    k_ms = {
        "pack_soa": kernel_ms(lambda: pack_soa(records, gid, 2 * CHUNK, n_live), "pack_soa_kernel"),
        "rasterize_fwd": kernel_ms(lambda: fwd_tiles(b.tile_starts, b.counts, b.sorted_soa, TILE,
                                                     ntx, CHUNK), "rasterize_fwd_kernel"),
        "rasterize_bwd": kernel_ms(lambda: bwd_tiles(*bwd_args), "rasterize_bwd_kernel"),
        "pack_rows": kernel_ms(lambda: pack_rows(grad, perm, key, nv, 0, 10, float(N)),
                               "pack_rows_kernel"),
        "segsum": kernel_ms(lambda: segment_sum_sorted(stacked, N, 10), "segsum_kernel"),
        "rasterize_fwd_q": kernel_ms(lambda: fwd_tiles_q(*queue[:2], b.tile_starts, b.counts,
                                                         queue[2], b.sorted_soa, TILE, ntx, CHUNK),
                                     "rasterize_fwd_q_kernel"),
        "rasterize_bwd_q": kernel_ms(lambda: bwd_tiles_q(*queue[:2], b.tile_starts, b.counts,
                                                         queue[2], *bwd_args[2:]),
                                     "rasterize_bwd_q_kernel"),
        "partition": kernel_ms(lambda: bucket_partition(tile_key, depths_v, Tb, BUCKETS, q,
                                                        C=BUCKET_C), "bucket_partition_kernel"),
    }
    log(f"[time] kernels alone (torch.profiler device time, median of 10): "
        f"{json.dumps({k: round(v, 4) for k, v in k_ms.items()})}")
    del tile_key, depths_v
    torch.cuda.empty_cache()

    # 11. The binning modes at training view 0 and on the training path.
    modes = binning_modes_phase(dev, scene, views, images, sargs, b, fwd_out)
    torch.cuda.empty_cache()
    # 12. The settings the port used to refuse, beside the old ones.
    wide = wide_settings_phase(dev, state, scene, views, images, sargs, b, fwd_out, bw)
    torch.cuda.empty_cache()
    # 13. The projection + SH kernel pair at the cells' shapes.
    psh = project_sh_phase(dev)
    # 14. Its deforming instance and the deformation MLP.
    psh["deform"] = deform_phase(dev)
    # 15. The binning's slot enumeration at the cells' shapes.
    bsl = bin_slots_phase(dev)
    # 16. Adam as one kernel at the cells' buffers.
    adm = adam_phase(dev)
    srf = surfel_phase(dev)

    # 8. The trainer through its entry point; its launches beside each row's.
    tr = trainer_phase(dev, scene, raster)
    adam_trainer_launches = adam_launches(tr["launches"], TRAINER_ITERS, "trainer")
    # 9. The user journey through the two CLIs; their launches too.
    cli = cli_phase(dev)
    # 10. The mesh: the sharded step and the trainer on it.
    mesh = mesh_phase(dev, scene, views, images, trainer_inputs(dev, scene, raster),
                      tr["iter_ms"])

    def wide_row(name):
        """Phase 12's numbers for kernel ``name``: at each new setting the
        ms (median of its turns), the largest error against the plain
        version and the bound; the old setting's ms in the same turns; the
        launches through phase 12's entry points."""
        out = {"wide_launches": wide["launches"][name]}
        if name == "partition":
            out["wide_settings"] = {f"sort_buckets={B}": wide["partition"][B]
                                    for B in WIDE_BUCKETS}
            out["old_setting_ms_in_turns"] = wide["partition"][BUCKETS]["ms_in_turns"]
        elif name in wide["raster"]:
            out["wide_settings"] = {f"chunk={c}": wide["raster"][name][c] for c in WIDE_CHUNKS}
            out["old_setting_ms_in_turns"] = wide["raster"][name][CHUNK]["ms_in_turns"]
            deep = wide["deep"]["bwd" if "bwd" in name else "fwd"]
            out["wide_settings"]["deep_tiles_max_abs_err"] = deep
        return out

    def row(name, src, replaces, err, ms, plain_ms, bound_ms, bound_by, lib_ms, **extra):
        return {"name": name, "route": "cuda",
                "source": f"gaussian_splatting_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches[name], "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms, "kernel_ms": k_ms[name],
                "trainer_launches": tr["launches"][name],
                "train_cli_launches": cli["train_launches"][name],
                "eval_cli_launches": cli["eval_launches"][name],
                "mesh_launches": mesh["all_launches"][name],
                "binning_modes_launches": modes["launches"].get(name, 0),
                "binning_modes_max_abs_err": modes["errs"].get(name), **wide_row(name),
                **extra}

    def by(bytes_ms, ops_ms):
        return "operations" if ops_ms >= bytes_ms else "bytes"

    def raster_bound(bytes_ms, needed_ops_ms, unculled_ops_ms):
        return {"bound_ms": max(bytes_ms, needed_ops_ms), "bound_by": by(bytes_ms, needed_ops_ms),
                "bound_unculled_ms": max(bytes_ms, unculled_ops_ms)}

    return {"project_sh": dict(psh, launches=psh_launches),
            "bin_slots": dict(bsl, launches=bsl_launches),
            "adam": dict(adm, launches={"train_steps": adam_step_launches,
                                        "trainer": adam_trainer_launches}),
            "surfel": srf, "kernels": [
        row("pack_soa", "pack_soa.cu", "gaussian_splatting_tpu/ops/tiling.py:335",
            pack_err, pack_ms, pack_plain_ms, pack_bound, "bytes", pack_lib_ms),
        row("rasterize_fwd", "rasterize_fwd.cu",
            "gaussian_splatting_tpu/ops/rasterize_pallas.py:130", fwd_err, fwd_ms,
            fwd_plain_ms, lib_ms=None,
            **raster_bound(fwd_bytes_ms, fwd_needed_ops_ms, fwd_ops_ms)),
        row("rasterize_bwd", "rasterize_bwd.cu",
            "gaussian_splatting_tpu/ops/rasterize_pallas.py:217", bw["bwd_err"], bwd_ms,
            bwd_plain_ms, lib_ms=None,
            **raster_bound(bwd_bytes_ms, bwd_needed_ops_ms, bwd_ops_ms)),
        row("pack_rows", "pack_rows.cu", "gaussian_splatting_tpu/ops/tiling.py:386",
            bw["pack_rows_err"], prow_ms, prow_plain_ms, prow_bound, "bytes", prow_lib_ms),
        row("segsum", "segsum.cu", "gaussian_splatting_tpu/ops/segsum.py:49",
            bw["segsum_err"], seg_ms, seg_plain_ms, seg_bound, "bytes", seg_lib_ms),
        row("rasterize_fwd_q", "rasterize_fwd_q.cu",
            "gaussian_splatting_tpu/ops/rasterize_pallas.py:446", qerr["fwd_q_err"], fwd_q_ms,
            fwd_q_plain_ms, lib_ms=None,
            **raster_bound(fwd_bytes_ms + queue_bytes_ms, fwd_needed_ops_ms, fwd_ops_ms)),
        row("rasterize_bwd_q", "rasterize_bwd_q.cu",
            "gaussian_splatting_tpu/ops/rasterize_pallas.py:565", qerr["bwd_q_err"], bwd_q_ms,
            bwd_q_plain_ms, lib_ms=None,
            **raster_bound(bwd_bytes_ms + queue_bytes_ms, bwd_needed_ops_ms, bwd_ops_ms)),
        row("partition", "partition.cu", "gaussian_splatting_tpu/ops/partition.py:77",
            part_err, part_ms, part_plain_ms, part_bound, "bytes", None,
            key_passes_ms=key_pass_ms),
    ]}


if __name__ == "__main__":
    sys.exit(main())
