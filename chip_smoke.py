"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold each of its
kernels against its plain PyTorch version.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure exits nonzero and prints no result):
1. build the kernels in ``gaussian_splatting_tpu_torch/csrc/`` with nvcc
   for sm_90a (one process per source, all at once);
2. the bench scene of ``bench.py`` (numpy seed 0, 1M screen-space
   gaussians, 1920x1080, dense binning, chunk 256): intersection counts
   against the JAX package's recorded ones, and both kernels against their
   plain versions;
3. a small 3D scene rendered through the kernels and through the PyTorch
   oracle, which must agree;
4. the main path: a seeded 3D scene of 1,000,000 gaussians with SH degree 3
   loaded with ``state_from_numpy``, rendered at 1920x1080 from 4
   ``look_at`` views by ``GaussianRasterizer(backend="auto")``; every
   kernel's launch count must rise during that run;
5. timings with CUDA events (medians) at the main path's shapes, against
   each kernel's bound and plain version;
6. one render traced with ``torch.profiler``: device kernels launched, the
   device's busy and idle share of the render, the kernels taking most time.

Output: the kernels JSON line, the card's name and power limit
(``nvidia-smi``), then ``{"ok": true, "device": {...}}`` as the last line.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

WIDTH, HEIGHT, TILE, CHUNK, MAX_T = 1920, 1080, 16, 256, 16
N_GAUSSIANS = 1_000_000
# Intersection counts of the bench scene recorded by the JAX package
# (BENCH_r05.json: n_isect, n_tile_overflow_dropped); hardware-independent.
BENCH_N_ISECT, BENCH_N_DROPPED = 3_779_268, 2_290
COUNT_RTOL = 1e-4
# Published H100 SXM peaks: HBM bytes/s and float32 (non-tensor) flop/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# float32 operations per (pixel, entry) pair the forward kernel evaluates:
# dx, dy (2); sigma (9); exp (1, on the SFU) and its negation (1); op * vis
# (1); two gate compares and the clamp (3); 1 - alpha, the running product
# and T_carry * product (3); the stop compare (1); the weight (2); four
# multiply-adds and one add into the accumulators (9) for pairs that count.
FWD_FLOPS_PER_PAIR = 32


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


def view_eyes(k=4, dist=3.0):
    return [(dist * np.sin(a), 0.6, -dist * np.cos(a))
            for a in np.linspace(0.0, 2 * np.pi, k, endpoint=False)]


def quantity_table(means2d, conics, colors, opacities, depths):
    import torch

    return torch.stack([means2d[:, 0], means2d[:, 1], conics[:, 0], conics[:, 1],
                        conics[:, 2], opacities, colors[:, 0], colors[:, 1],
                        colors[:, 2], depths]).contiguous()


def compare_kernels(b, table, tag):
    """Both kernels against their plain versions on one binning ``b``:
    pack exact, forward atol 1e-5 (rgb, sum_w) / 1e-4 (depth). Returns
    (pack_err, fwd_err, pairs)."""
    import torch

    from gaussian_splatting_tpu_torch.ops.rasterize_cuda import fwd_tiles, fwd_tiles_plain
    from gaussian_splatting_tpu_torch.ops.tiling import pack_soa, pack_soa_plain

    M = table.shape[1] * MAX_T
    gid = b.sorted_soa[11, :M].to(torch.int32).contiguous()
    k_soa = pack_soa(table, gid, 2 * CHUNK)
    p_soa = pack_soa_plain(table, gid, 2 * CHUNK)
    torch.cuda.synchronize()
    pack_err = float((k_soa - p_soa).abs().max())
    if not torch.equal(k_soa, p_soa):
        fail(f"[{tag}] pack kernel differs from pack_soa_plain (max |diff| {pack_err})")
    if not torch.equal(k_soa, b.sorted_soa):
        fail(f"[{tag}] pack kernel output differs from the binning's SoA")
    del p_soa

    ntx = -(-WIDTH // TILE)
    k_out = fwd_tiles(b.tile_starts, b.counts, b.sorted_soa, TILE, ntx, CHUNK)
    p_out, pairs = fwd_tiles_plain(b.tile_starts, b.counts, b.sorted_soa, TILE, ntx, CHUNK)
    torch.cuda.synchronize()
    diff = (k_out - p_out).abs()
    err_rgbw = float(torch.cat([diff[:, 0:3], diff[:, 4:8]], 1).max())
    err_depth = float(diff[:, 3].max())
    n_bad = int(((diff[:, 0:3] > 1e-5).any(1) | (diff[:, 4] > 1e-5)
                 | (diff[:, 3] > 1e-4)).sum())
    log(f"[{tag}] pack kernel == plain: exact ({M} columns); forward kernel vs "
        f"plain over {b.counts.shape[0]} tiles: max |diff| rgb/sum_w {err_rgbw:.3e}, "
        f"depth {err_depth:.3e}, pixels beyond tolerance {n_bad}")
    if not (err_rgbw <= 1e-5 and err_depth <= 1e-4):
        fail(f"[{tag}] forward kernel disagrees with fwd_tiles_plain")
    if not bool(torch.isfinite(k_out).all()):
        fail(f"[{tag}] forward kernel output is not finite")
    return pack_err, max(err_rgbw, err_depth), int(pairs)


def trace_render(render_once):
    """Phase 6: one call of ``render_once`` under ``torch.profiler``; logs
    its wall time, the number of device activities, the device's busy time
    (union of their intervals) and idle share, and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        render_once()
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
    log(f"[trace] one main-path render under torch.profiler: wall {wall_ms:.3f} ms, "
        f"{len(spans)} device activities, device busy {busy_ms:.3f} ms, idle share "
        f"{1.0 - busy_ms / wall_ms:.3f}")
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:8]:
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
    kernels = ("pack_soa", "rasterize_fwd")
    _build.build(kernels)
    log(f"[build] {', '.join(k + '.cu' for k in kernels)} for sm_90a in "
        f"{time.perf_counter() - t0:.2f} s")
    for k in kernels:
        for line in _build.build_log(k).splitlines():
            if "Used" in line or "spill" in line:
                log(f"[build] {k}: {line.strip()}")

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


def run(dev):
    """Phases 2-5 on ``dev``; returns the kernels report."""
    import torch

    from gaussian_splatting_tpu_torch.core.cameras import look_at, make_intrinsics
    from gaussian_splatting_tpu_torch.models.gaussians import state_from_numpy
    from gaussian_splatting_tpu_torch.ops.facade import GaussianRasterizer
    from gaussian_splatting_tpu_torch.ops.rasterize_cuda import fwd_tiles, fwd_tiles_plain
    from gaussian_splatting_tpu_torch.ops.render import project_and_shade, render
    from gaussian_splatting_tpu_torch.ops.tiling import (
        isect_and_sort, pack_soa, pack_soa_plain)

    # 2. Bench scene: counts and kernels against their plain versions.
    args = tuple(torch.as_tensor(x, device=dev) for x in bench_scene(N_GAUSSIANS, WIDTH, HEIGHT))
    b = isect_and_sort(*args, WIDTH, HEIGHT, TILE, CHUNK, MAX_T)
    n_isect, n_dropped = int(b.n_isect), int(b.n_dropped)
    for name, got, want in (("n_isect", n_isect, BENCH_N_ISECT),
                            ("n_dropped", n_dropped, BENCH_N_DROPPED)):
        log(f"[bench] {name} {got} (JAX package: {want}, difference {got - want:+d})")
        if abs(got - want) > COUNT_RTOL * want:
            fail(f"[bench] {name} differs from the JAX package by more than 0.01%")
    compare_kernels(b, quantity_table(*args[:5]), "bench")
    del args, b
    torch.cuda.empty_cache()

    # 3. Small 3D scene: kernels against the PyTorch oracle.
    small = scene_3d(1500, seed=1, scale_range=(0.01, 0.03))
    K_small = make_intrinsics(160, 120, device=dev)
    view_small = look_at((0.4, 0.5, -3.0), (0.0, 0.0, 0.0), device=dev)
    p = [small[k] for k in ("means", "quats", "log_scales", "logit_opacities")]
    sh = np.concatenate([small["features_dc"], small["features_rest"]], axis=1)
    outs = {be: render(*p, sh, view_small, K_small, 160, 120, backend=be, device=dev,
                       render_mode="RGB+D") for be in ("cuda", "ref")}
    d_img = float((outs["cuda"].render[..., :3] - outs["ref"].render[..., :3]).abs().max())
    d_alpha = float((outs["cuda"].alpha - outs["ref"].alpha).abs().max())
    d_depth = float((outs["cuda"].depth - outs["ref"].depth).abs().max())
    log(f"[small] 1500 gaussians 160x120, kernels vs oracle: max |diff| image "
        f"{d_img:.3e}, alpha {d_alpha:.3e}, depth {d_depth:.3e}; "
        f"alpha max {float(outs['ref'].alpha.max()):.3f}")
    if not (d_img <= 1e-4 and d_alpha <= 1e-4 and d_depth <= 1e-3):
        fail("[small] the kernel path disagrees with the oracle")

    # 4. Main path: 1M gaussians, SH degree 3, 4 views through the facade.
    state = state_from_numpy(scene_3d(N_GAUSSIANS, seed=0), device=dev)
    raster = GaussianRasterizer(WIDTH, HEIGHT, backend="auto", sh_degree=3, device=dev)
    K = make_intrinsics(WIDTH, HEIGHT, device=dev)
    views = [{"world_view_transform": look_at(e, (0.0, 0.0, 0.0), device=dev), "K": K}
             for e in view_eyes()]
    pack_soa.launches = 0
    fwd_tiles.launches = 0
    outs = [raster.render_single(state.params, vp) for vp in views]
    torch.cuda.synchronize()
    launches = {"pack_soa": pack_soa.launches, "rasterize_fwd": fwd_tiles.launches}
    log(f"[main] backend {raster.backend}, launches during the 4 renders: {launches}")
    for i, o in enumerate(outs):
        img, alpha = o.render, o.alpha
        cover = float((alpha > 0).float().mean())
        log(f"[main] view {i}: image {tuple(img.shape)}, visible gaussians "
            f"{int(o.visibility.sum())}, coverage {cover:.4f}, alpha max "
            f"{float(alpha.max()):.4f}, mean rgb {[round(float(v), 4) for v in img.mean((0, 1))]}")
        if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(img).all()):
            fail(f"[main] view {i}: image not finite or of the wrong shape")
        if not (float(alpha.min()) >= 0.0 and float(alpha.max()) <= 1.0 and cover > 0.0):
            fail(f"[main] view {i}: alpha outside [0, 1] or no coverage")
    if min(launches.values()) < 1:
        fail(f"[main] a kernel of the path never launched: {launches}")

    # 5. Timings at the main path's shapes (view 0), CUDA events, medians.
    render_ms = [cuda_ms(lambda vp=vp: raster.render_single(state.params, vp),
                         reps=1, warmup=0) for _ in range(2) for vp in views]
    torch.cuda.reset_peak_memory_stats()
    raster.render_single(state.params, views[0])
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    pp = state.params
    shade_args = (pp.means, pp.quats, pp.log_scales, pp.logit_opacities, pp.sh_coeffs,
                  views[0]["world_view_transform"], K, WIDTH, HEIGHT)
    shade_ms = cuda_ms(lambda: project_and_shade(*shade_args, sh_degree=3))
    proj, colors, opac = project_and_shade(*shade_args, sh_degree=3)
    sargs = (proj.means2d, proj.conics, colors, opac, proj.depths, proj.radii)
    b = isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T)
    table = quantity_table(*sargs[:5])
    pack_err, fwd_err, pairs = compare_kernels(b, table, "main view 0")
    M = table.shape[1] * MAX_T
    gid = b.sorted_soa[11, :M].to(torch.int32).contiguous()
    gid_long = gid.long()
    T = b.counts.shape[0]
    P = TILE * TILE
    n_is = int(b.n_isect)
    ntx = -(-WIDTH // TILE)

    binning_ms = cuda_ms(lambda: isect_and_sort(*sargs, WIDTH, HEIGHT, TILE, CHUNK, MAX_T), reps=5)
    pack_ms = cuda_ms(lambda: pack_soa(table, gid, 2 * CHUNK))
    pack_plain_ms = cuda_ms(lambda: pack_soa_plain(table, gid, 2 * CHUNK), reps=5)
    pack_lib_ms = cuda_ms(lambda: torch.index_select(table, 1, gid_long))
    fwd_ms = cuda_ms(lambda: fwd_tiles(b.tile_starts, b.counts, b.sorted_soa, TILE, ntx, CHUNK))
    fwd_plain_ms = cuda_ms(lambda: fwd_tiles_plain(b.tile_starts, b.counts, b.sorted_soa,
                                                   TILE, ntx, CHUNK), reps=3, warmup=1)

    m_out = b.sorted_soa.shape[1]
    pack_bytes = 4 * M + 4 * 10 * table.shape[1] + 4 * 16 * m_out
    pack_bound = pack_bytes / HBM_BYTES_PER_S * 1e3
    fwd_bytes = 4 * (2 * T + 1) + 4 * 10 * n_is + 4 * T * 8 * P
    fwd_bytes_ms = fwd_bytes / HBM_BYTES_PER_S * 1e3
    fwd_ops_ms = pairs * FWD_FLOPS_PER_PAIR / FP32_FLOPS * 1e3
    log(f"[time] per-view render {statistics.median(render_ms):.3f} ms (median of "
        f"{len(render_ms)}: {[round(x, 3) for x in render_ms]}); peak device memory "
        f"of one render {peak_gb:.2f} GiB")
    log(f"[time] view 0: n_isect {n_is}, slots {M}, pairs evaluated {pairs}; projection "
        f"+ SH {shade_ms:.3f} ms, binning incl. pack {binning_ms:.3f} ms, pack "
        f"{pack_ms:.3f} ms, forward {fwd_ms:.3f} ms")
    log(f"[time] forward bound: bytes {fwd_bytes_ms:.4f} ms, operations {fwd_ops_ms:.4f} ms")

    trace_render(lambda: raster.render_single(state.params, views[0]))

    report = {"kernels": [
        {"name": "pack_soa", "route": "cuda",
         "source": "gaussian_splatting_tpu_torch/csrc/pack_soa.cu",
         "replaces": "gaussian_splatting_tpu/ops/tiling.py:335",
         "launches": launches["pack_soa"], "max_abs_err": pack_err,
         "ms": pack_ms, "plain_ms": pack_plain_ms, "bound_ms": pack_bound,
         "bound_by": "bytes", "library_ms": pack_lib_ms},
        {"name": "rasterize_fwd", "route": "cuda",
         "source": "gaussian_splatting_tpu_torch/csrc/rasterize_fwd.cu",
         "replaces": "gaussian_splatting_tpu/ops/rasterize_pallas.py:130",
         "launches": launches["rasterize_fwd"], "max_abs_err": fwd_err,
         "ms": fwd_ms, "plain_ms": fwd_plain_ms,
         "bound_ms": max(fwd_bytes_ms, fwd_ops_ms),
         "bound_by": "operations" if fwd_ops_ms >= fwd_bytes_ms else "bytes",
         "library_ms": None},
    ]}
    return report


if __name__ == "__main__":
    sys.exit(main())
