"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold each of its
kernels against its plain PyTorch version.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure exits nonzero and prints no result):
1. build the eight kernels in ``gaussian_splatting_tpu_torch/csrc/`` with
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
   most time.

Output: the kernels JSON line, the card's name and power limit
(``nvidia-smi``), then ``{"ok": true, "device": {...}}`` as the last line.
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
# The cube [-1, 1]^3 the seeded scene fills: the trainer's scene extent.
SCENE_EXTENT = 2.0
# Intersection counts of the bench scene recorded by the JAX package
# (BENCH_r05.json: n_isect, n_tile_overflow_dropped); hardware-independent.
BENCH_N_ISECT, BENCH_N_DROPPED = 3_779_268, 2_290
COUNT_RTOL = 1e-4
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
           "rasterize_fwd_q", "rasterize_bwd_q", "partition")


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
    """The launch-count owners of the eight kernels, by kernel name."""
    from gaussian_splatting_tpu_torch.ops import partition, rasterize_cuda, segsum, tiling

    return {"pack_soa": tiling.pack_soa, "rasterize_fwd": rasterize_cuda.fwd_tiles,
            "rasterize_bwd": rasterize_cuda.bwd_tiles, "pack_rows": tiling.pack_rows,
            "segsum": segsum.segment_sum_sorted,
            "rasterize_fwd_q": rasterize_cuda.fwd_tiles_q,
            "rasterize_bwd_q": rasterize_cuda.bwd_tiles_q,
            "partition": partition.bucket_partition}


def reset_launches():
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches():
    return {k: fn.launches for k, fn in launch_counters().items()}


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


def dense_gid(sargs):
    """The dense binning's own sort at screen-space inputs ``sargs``: the
    sorted slot -> gaussian index (M,) and its segment end
    ``tile_starts[T:]``, the ``n_live`` it passes to ``pack_soa``."""
    from gaussian_splatting_tpu_torch.ops.tiling import dense_sort, slot_tiles

    means2d, conics, _, opac, depths, radii = sargs
    tile_key, _, T = slot_tiles(means2d, conics, opac, radii, WIDTH, HEIGHT, TILE, MAX_T)
    tile_starts, gid = dense_sort(tile_key, depths, T)
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


def compare_kernels(sargs, b, tag):
    """Both forward-path kernels against their plain versions on the dense
    binning ``b`` of screen-space inputs ``sargs``, with the sort's own gid:
    pack exact, with ``n_live`` (the binning's SoA) and gathering every
    column; the forward on the binning's SoA equal bit for bit to the
    forward on the full-gather plain SoA, and within atol 1e-5 (rgb, sum_w)
    / 1e-4 (depth) of its plain version. Returns a dict of the errors,
    outputs and the pack's inputs."""
    import torch

    from gaussian_splatting_tpu_torch.ops.rasterize_cuda import fwd_tiles, fwd_tiles_plain
    from gaussian_splatting_tpu_torch.ops.tiling import (
        pack_soa, pack_soa_plain, quantity_records)

    records = quantity_records(*sargs[:5])
    gid, n_live = dense_gid(sargs)
    k_soa = pack_soa(records, gid, 2 * CHUNK, n_live)
    p_soa = pack_soa_plain(records, gid, 2 * CHUNK, n_live)
    torch.cuda.synchronize()
    pack_err = float((k_soa - p_soa).abs().max())
    if not torch.equal(k_soa, p_soa):
        fail(f"[{tag}] pack kernel differs from pack_soa_plain (max |diff| {pack_err})")
    if not torch.equal(k_soa, b.sorted_soa):
        fail(f"[{tag}] pack kernel output differs from the binning's SoA")
    del p_soa
    k_full = pack_soa(records, gid, 2 * CHUNK)
    p_full = pack_soa_plain(records, gid, 2 * CHUNK)
    torch.cuda.synchronize()
    live = int(n_live)
    if not (torch.equal(k_full, p_full) and torch.equal(k_full[:, :live], k_soa[:, :live])):
        fail(f"[{tag}] full-gather pack kernel differs from pack_soa_plain or from the "
             f"n_live pack below n_live")
    del k_full, k_soa

    ntx = -(-WIDTH // TILE)
    k_out = fwd_tiles(b.tile_starts, b.counts, b.sorted_soa, TILE, ntx, CHUNK)
    same = torch.equal(k_out, fwd_tiles(b.tile_starts, b.counts, p_full, TILE, ntx, CHUNK))
    del p_full
    p_out, pairs = fwd_tiles_plain(b.tile_starts, b.counts, b.sorted_soa, TILE, ntx, CHUNK)
    torch.cuda.synchronize()
    diff = (k_out - p_out).abs()
    err_rgbw = float(torch.cat([diff[:, 0:3], diff[:, 4:8]], 1).max())
    err_depth = float(diff[:, 3].max())
    n_bad = int(((diff[:, 0:3] > 1e-5).any(1) | (diff[:, 4] > 1e-5)
                 | (diff[:, 3] > 1e-4)).sum())
    log(f"[{tag}] pack kernel == plain: exact ({gid.shape[0]} columns, n_live {live}; and "
        f"gathering all columns); forward on it == forward on the full-gather plain SoA: "
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


def compare_backward(b, fwd_out, n, tag, seed=0):
    """Phase 2b: the backward kernel + the kernel reduce against their
    plain versions on binning ``b`` under a seeded cotangent, then
    ``pack_rows`` and ``segsum`` against their plain versions on the
    kernel's stream. Returns the errors and the inputs the timings use."""
    import torch

    from gaussian_splatting_tpu_torch.ops.rasterize_cuda import (
        bwd_tiles, bwd_tiles_plain, grad_cap)
    from gaussian_splatting_tpu_torch.ops.segsum import (
        segment_sum_sorted, segment_sum_sorted_plain)
    from gaussian_splatting_tpu_torch.ops.tiling import (
        pack_rows, pack_rows_plain, reduce_padded_grads, sorted_gid_key)

    ntx = -(-WIDTH // TILE)
    gcap = grad_cap(n, MAX_T, CHUNK)
    gen = torch.Generator(device=fwd_out.device).manual_seed(seed)
    gout = torch.randn(fwd_out.shape, generator=gen, device=fwd_out.device)
    gout[:, 5:] = 0.0  # rows the image never reads have no cotangent
    k_grad, k_meta = bwd_tiles(b.tile_starts, b.counts, b.sorted_soa, gout, fwd_out,
                               TILE, ntx, CHUNK, n, gcap)
    k_sums = reduce_padded_grads(k_grad, n, k_meta[0], with_depth=True)
    p_grad, p_meta, active = bwd_tiles_plain(b.tile_starts, b.counts, b.sorted_soa, gout,
                                             fwd_out, TILE, ntx, CHUNK, n, gcap)
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


def queue_for(b):
    """The chunk queue of binning ``b`` at the rasterizer's capacity
    ``w_cap = N max_t // chunk + T``, n_work as a (1,) tensor."""
    from gaussian_splatting_tpu_torch.ops.tiling import chunk_queue

    wtile, cum, n_work = chunk_queue(b.counts, CHUNK, N_GAUSSIANS * MAX_T // CHUNK
                                     + b.counts.shape[0])
    return wtile, cum, n_work.reshape(1)


def compare_queue(b, fwd_out, plain_out, bwd, n, tag):
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
    wtile, cum, n_work = queue_for(b)
    check_queue(wtile, cum, n_work, b.counts, CHUNK)
    q_out = fwd_tiles_q(wtile, cum, b.tile_starts, b.counts, n_work, b.sorted_soa, TILE,
                        ntx, CHUNK)
    torch.cuda.synchronize()
    fwd_err = float((q_out - plain_out).abs().max())
    same = torch.equal(q_out, fwd_out)
    log(f"[{tag}] queue forward kernel ({int(n_work)} work items, "
        f"{int((b.counts == 0).sum())} empty tiles): equal to the loop kernel bit for bit: "
        f"{same}; max |diff| against plain {fwd_err:.3e}")
    if not same:
        fail(f"[{tag}] the queue forward differs from the loop forward")
    k_grad, k_meta = bwd_tiles_q(wtile, cum, b.tile_starts, b.counts, n_work, b.sorted_soa,
                                 bwd["gout"], fwd_out, TILE, ntx, CHUNK, n, bwd["gcap"])
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


def compare_partition(sargs, b, fwd_out, bwd, tag):
    """Phase 5b, checks: the fused partition kernel (``bucket_partition``)
    against its plain version on the dense slots' tiles and the depths at
    these screen-space inputs (key, gid, counts and drops exact); the bucket
    binning's kept + dropped equal to the dense binning ``b``'s n_isect
    and, with no drop, on the bucket (gapped) layout: the forward equal to
    the dense ``fwd_out`` bit for bit, and the backward kernel + kernel
    reduce under ``compare_backward``'s cotangent against its plain sums
    and meta (``bwd``) under the backward's gates. Returns the partition's
    inputs, quantum, outputs, drop count and the bucket binning's gid."""
    import torch

    from gaussian_splatting_tpu_torch.ops.partition import (
        bucket_partition, bucket_partition_plain, quantum_for)
    from gaussian_splatting_tpu_torch.ops.rasterize_cuda import bwd_tiles, fwd_tiles
    from gaussian_splatting_tpu_torch.ops.tiling import (
        BUCKET_C, isect_and_sort, reduce_padded_grads, slot_tiles)

    means2d, conics, _, opac, depths, radii = sargs
    tile_key, _, T = slot_tiles(means2d, conics, opac, radii, WIDTH, HEIGHT, TILE, MAX_T)
    q = quantum_for(BUCKET_C, BUCKETS, BUCKET_HEADROOM)
    k_out = bucket_partition(tile_key, depths, T, BUCKETS, q, C=BUCKET_C)
    p_out = bucket_partition_plain(tile_key, depths, T, BUCKETS, q, C=BUCKET_C)
    torch.cuda.synchronize()
    exact = all(torch.equal(a, c) for a, c in zip(k_out, p_out))
    diff = [int((a != c).sum()) for a, c in zip(k_out, p_out)]
    err = max(float((a.double() - c.double()).abs().max()) for a, c in zip(k_out, p_out))
    del p_out
    log(f"[{tag}] bucket partition kernel, {tile_key.shape[0]} slots, B {BUCKETS}, quantum "
        f"{q}, (B, cap) = {tuple(k_out[0].shape)}: key, gid, counts, drops equal to plain: "
        f"{exact} (entries differing {diff}); counts {k_out[2].tolist()}, drops "
        f"{k_out[3].tolist()}")
    if not exact:
        fail(f"[{tag}] bucket partition kernel differs from bucket_partition_plain")

    bb = isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T, sort_buckets=BUCKETS,
                        bucket_headroom=BUCKET_HEADROOM)
    n_b, n_drop, n_dense = int(bb.n_isect), int(bb.n_bucket_dropped), int(b.n_isect)
    log(f"[{tag}] bucket binning: n_isect {n_b} + n_bucket_dropped {n_drop} = {n_b + n_drop} "
        f"(dense n_isect {n_dense}); tile_starts[T] {int(bb.tile_starts[-1])}")
    if n_b + n_drop != n_dense or int(k_out[3].sum()) != n_drop:
        fail(f"[{tag}] the bucket binning lost or gained intersections")
    if n_drop == 0:
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
            "err": err, "n_drop": n_drop, "gid": gid_b}


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


def binning_peak_gib(sargs):
    """Peak device memory (GiB, ``max_memory_allocated``) of one dense and
    one bucket ``isect_and_sort`` at screen-space inputs ``sargs``, above
    what was allocated before the call."""
    import torch

    from gaussian_splatting_tpu_torch.ops.tiling import isect_and_sort

    peaks = {}
    for name, kw in (("dense", {}), ("bucket", {"sort_buckets": BUCKETS,
                                                "bucket_headroom": BUCKET_HEADROOM})):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T, **kw)
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
        del out
    return peaks


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
    # sum(img) + sum(alpha) with depth_grad=False; dense binning here, as
    # compact class budgets are not ported. queue=True is its
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
    del diff, args
    torch.cuda.empty_cache()
    return {"bench_fwd_bwd_ms": fb_ms, "bench_fwd_bwd_queue_ms": fbq_ms,
            "queue_launches": q_launches}


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

    trace(lambda: raster.render_single(state.params, views[0]), "one render")
    trace(lambda: step(tstate, batch), "one training step")
    trace(lambda: bstep(bstate, bbatch), "one bucket-path training step")

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

    def row(name, src, replaces, err, ms, plain_ms, bound_ms, bound_by, lib_ms, **extra):
        return {"name": name, "route": "cuda",
                "source": f"gaussian_splatting_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches[name], "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms, "kernel_ms": k_ms[name], **extra}

    def by(bytes_ms, ops_ms):
        return "operations" if ops_ms >= bytes_ms else "bytes"

    def raster_bound(bytes_ms, needed_ops_ms, unculled_ops_ms):
        return {"bound_ms": max(bytes_ms, needed_ops_ms), "bound_by": by(bytes_ms, needed_ops_ms),
                "bound_unculled_ms": max(bytes_ms, unculled_ops_ms)}

    return {"kernels": [
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
