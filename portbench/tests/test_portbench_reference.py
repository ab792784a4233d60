"""The plain reference against the program's plain path at a tiny size.
The test imports both; the reference imports nothing of the program."""

import numpy as np
import torch

from portbench import scene as S
from portbench.reference import render as R
from portbench.reference import train as RT
from portbench.tests import tiny

DEV = torch.device("cpu")
SEED = 2**40 + 17


def _inputs():
    c = tiny.tiny_config("video1080p-1m")
    W, H = c["width"], c["height"]
    scene = S.true_scene(c["gaussians"], c["scene"], SEED, DEV)
    vms = S.orbit_views(c["views"], c["cameras"])
    K = R.intrinsics(W, H, c["cameras"]["focal_px"])
    return c, W, H, scene, vms, K


def test_render_matches_the_programs_plain_path():
    from gaussian_splatting_tpu_torch.ops.render import render

    c, W, H, scene, vms, K = _inputs()
    sh = torch.cat([scene["features_dc"], scene["features_rest"]], 1)
    args = (scene["means"], scene["quats"], scene["log_scales"], scene["logit_opacities"], sh)
    alive = torch.ones(c["gaussians"], dtype=torch.bool)
    counts = RT.footprint_counts(dict(zip(RT.PARAM_KEYS[:4], args[:4]),
                                      features_dc=scene["features_dc"],
                                      features_rest=scene["features_rest"]),
                                 alive, vms, [K] * len(vms), W, H, 16)
    budgets = RT.choose_class_budgets(counts, c["gaussians"], 16, 32_000_000, headroom=0.9)
    for b in (None, budgets):
        for vm in vms[:3]:
            got = render(*args, vm, K, W, H, sh_degree=3, backend="cuda",
                         class_budgets=b, with_stats=True, device=DEV)
            want, binned, _ = R.render(*args, vm, K, W, H, 3, class_budgets=b)
            assert binned.n_isect == int(got.stats["n_isect"])
            assert binned.n_budget_dropped == int(got.stats["n_budget_dropped"])
            assert float((got.render - want).abs().max()) < 1e-5


def test_training_step_matches_the_programs_step():
    from gaussian_splatting_tpu_torch.training.checkpoint import load_checkpoint
    from gaussian_splatting_tpu_torch.training.config import TrainingConfig
    from gaussian_splatting_tpu_torch.training.step import ViewBatch, make_train_step

    c, W, H, scene, vms, K = _inputs()
    ext = S.scene_extent(scene["means"], vms)
    imgs = S.targets(scene, vms, K, W, H, 3)
    state0 = S.noisy(scene, c["noise"], SEED)
    tcfg = TrainingConfig(**c["training"]).replace(max_tiles_per_gaussian=16)
    buf, init = S.checkpoint(state0, 4096, 6080, ext,
                             {**c["state"], "densify_grads_threshold": 5e-4}, SEED)
    state, _ = load_checkpoint(buf, device=DEV)
    views = np.array([1, 4])
    step = make_train_step(tcfg, W, H, 3, "cuda", ext, device=DEV)
    state, m = step(state, ViewBatch(images=torch.as_tensor(imgs[views]).float() / 255,
                                     viewmats=vms[views], Ks=K[None].repeat(2, 1, 1),
                                     view_idx=torch.as_tensor(views)))
    rcfg = {k: getattr(tcfg, k) for k in (
        "tile_size", "raster_chunk", "lambda_dssim", "adam_b1", "adam_b2", "adam_eps",
        "lr_rotation", "lr_scaling", "lr_opacity", "lr_features_dc", "lr_features_rest",
        "position_lr_init", "position_lr_final", "position_lr_max_steps",
        "scale_reg_max_ratio", "scale_reg_weight", "scale_clamp_ratio")}
    rcfg.update(width=W, height=H, extent=ext)
    ref = RT.reference_steps(init, init["alive"], vms, [K] * len(vms), imgs, [views], rcfg, 3,
                             16, None, 6080, 6080, DEV)
    assert abs(float(m["loss"]) - ref["losses"][0]) <= 1e-5 * ref["losses"][0]
    for k in RT.PARAM_KEYS:
        got = float(np.linalg.norm(getattr(state.gauss.params, k).numpy() - init[k]))
        assert abs(got - ref["change_norms"][k]) <= 1e-3 * ref["change_norms"][k] + 1e-9, k


def test_densify_matches_the_programs_densify_bit_for_bit():
    from gaussian_splatting_tpu_torch.models.densify import densify_and_prune
    from gaussian_splatting_tpu_torch.models.gaussians import GaussianParams, GaussianState

    c, W, H, scene, vms, K = _inputs()
    g = torch.Generator().manual_seed(5)
    C = 2048
    p = {k: torch.zeros((C,) + v.shape[1:]) for k, v in scene.items()}
    for k, v in scene.items():
        p[k][:1500] = v[:1500]
    alive = torch.zeros(C, dtype=torch.bool)
    alive[:1500] = True
    accum = torch.rand((C, 3), generator=g) * 0.1
    count = torch.full((C, 1), 100.0)
    mu = {k: torch.randn(v.shape, generator=g) for k, v in p.items()}
    nu = {k: torch.rand(v.shape, generator=g) for k, v in p.items()}
    normals = RT.split_normals(C, 42, DEV)
    cfg = {"densify_grads_threshold": 5e-4, "densify_min_opacity": 0.005,
           "densify_clone_extent_ratio": 0.005, "densify_prune_extent_ratio": 0.02,
           "max_gaussians": 1900}
    state = GaussianState(params=GaussianParams(**{k: v.clone() for k, v in p.items()}),
                          alive=alive.clone(), xyz_grad_accum=accum, xyz_grad_count=count,
                          max_radii2d=torch.zeros(C, dtype=torch.int32))
    new, (pmu, pnu), st = densify_and_prune(
        state, (GaussianParams(**mu), GaussianParams(**nu)), grads_threshold=5e-4,
        min_opacity=0.005, extent=3.0, max_gaussians=1900, clone_extent_ratio=0.005,
        prune_extent_ratio=0.02, generator=torch.Generator(device=DEV).manual_seed(42))
    ref = RT.densify(p, mu, nu, alive, accum, count, cfg, 3.0, normals)
    assert (int(st.n_cloned), int(st.n_split)) == (ref["n_cloned"], ref["n_split"])
    assert ref["n_cloned"] + ref["n_split"] > 0 and ref["n_pruned"] > 0
    assert torch.equal(new.alive, ref["alive"])
    for k in RT.PARAM_KEYS:
        assert torch.equal(getattr(new.params, k), ref["params"][k]), k
        assert torch.equal(getattr(pmu, k), ref["mu"][k]) and torch.equal(getattr(pnu, k),
                                                                          ref["nu"][k])
