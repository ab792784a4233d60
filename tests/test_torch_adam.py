"""``training/optimizer.adam_multi``, Adam over a list of tensors: its
argument checks, the plain loop that CPU tensors take, the launch table of
``csrc/adam.cu`` (every element of every tensor updated exactly once), the
training step's update through it, and on a CUDA card the kernel bit for bit
against the plain ``adam_step`` run on the card.

The card test is marked ``chip`` and skips without a card; this file
imports no JAX, so it runs on the card with ``python -m pytest
tests/test_torch_adam.py -m chip --noconftest``."""

import numpy as np
import pytest
import torch

from gaussian_splatting_tpu_torch.models import deform as t_deform
from gaussian_splatting_tpu_torch.models.densify import clamp_scales
from gaussian_splatting_tpu_torch.models.gaussians import (
    PARAM_KEYS, GaussianParams, train_state_from_numpy)
from gaussian_splatting_tpu_torch.training import optimizer as t_opt
from gaussian_splatting_tpu_torch.training import step as t_step
from gaussian_splatting_tpu_torch.training.config import TrainingConfig
from gaussian_splatting_tpu_torch.utils import profiling

B1, B2, EPS = 0.9, 0.999, 1e-15
GROUP_SHAPES = ((3,), (4,), (3,), (1,), (1, 3), (15, 3))
MLP_SHAPES = tuple(s for _, s in t_deform.DeformSpec().shapes())


def _launches():
    return profiling.counters().get("launch.adam", 0)


def _tensors(shapes, seed, device="cpu"):
    """Seeded (params, grads, mus, nus) of ``shapes``: nonzero moments, a
    gradient that is zero on every third row (a row no view reached, as
    ``leaf_grad`` fills it)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(scale=1.0):
        return [torch.randn(s, generator=g, device=device) * scale for s in shapes]
    params, grads, mus = draw(), draw(1e-2), draw(1e-3)
    nus = [x.abs() for x in draw(1e-3)]
    for x in grads:
        if x.dim() > 1:
            x[::3] = 0.0
    return params, grads, mus, nus


def _rates(n, device="cpu"):
    """A 0-dim tensor rate first (as the position rate), numbers after."""
    return [torch.tensor(1.6e-4, device=device)] + [1e-3 * (i + 1) for i in range(n - 1)]


def _plain(params, grads, mus, nus, lrs, steps, start=0):
    """``steps`` updates of clones through the plain ``adam_step``, one
    tensor at a time, as ``adam_update`` did before ``adam_multi``."""
    out = [[x.clone() for x in xs] for xs in (params, mus, nus)]
    for t in range(start + 1, start + steps + 1):
        c1, c2 = t_opt.adam_bias_corrections(
            torch.tensor(t, dtype=torch.int32, device=params[0].device), B1, B2)
        for p, g, m, v, lr in zip(out[0], grads, out[1], out[2], lrs):
            t_opt.adam_step(p, g, m, v, lr, c1, c2, B1, B2, EPS)
    return out


def _multi(params, grads, mus, nus, lrs, steps, start=0):
    for t in range(start + 1, start + steps + 1):
        c1, c2 = t_opt.adam_bias_corrections(
            torch.tensor(t, dtype=torch.int32, device=params[0].device), B1, B2)
        t_opt.adam_multi(params, grads, mus, nus, lrs, c1, c2, B1, B2, EPS)


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


# --- the plain route (CPU) ---


@pytest.mark.parametrize("group", ["gaussians", "mlp", "poses"])
def test_adam_multi_on_cpu_equals_the_adam_step_loop(group):
    shapes = {"gaussians": [(40,) + s for s in GROUP_SHAPES], "mlp": list(MLP_SHAPES),
              "poses": [(5, 6)]}[group]
    params, grads, mus, nus = _tensors(shapes, seed=3)
    lrs = _rates(len(shapes))
    want = _plain(params, grads, mus, nus, lrs, steps=3, start=6)
    before = _launches()
    _multi(params, grads, mus, nus, lrs, steps=3, start=6)
    assert _launches() == before
    for got, exp in zip((params, mus, nus), want):
        for a, b in zip(got, exp):
            assert _bits_equal(a, b)
    assert not torch.equal(params[0], _tensors(shapes, seed=3)[0][0])


# --- argument checks (CPU) ---


def _case(name):
    shapes = [(8, 3), (8, 15, 3)]
    params, grads, mus, nus = _tensors(shapes, seed=1)
    lrs = _rates(2)
    c1, c2 = t_opt.adam_bias_corrections(torch.tensor(1, dtype=torch.int32), B1, B2)
    if name == "float64":
        mus[0] = mus[0].double()
    elif name == "shape":
        nus[1] = nus[1][:7].clone()
    elif name == "device":
        grads[0] = grads[0].to("meta")
    elif name == "missing_moment":
        nus[0] = None
    elif name == "lengths":
        lrs = lrs[:1]
    elif name == "rate":
        lrs[0] = torch.tensor([1e-3])
    elif name == "corrections":
        c1 = 0.1
    elif name == "alias":
        grads[0] = mus[0]
    return params, grads, mus, nus, lrs, c1, c2


@pytest.mark.parametrize("name", ["float64", "shape", "device", "missing_moment", "lengths",
                                  "rate", "corrections", "alias"])
def test_adam_multi_checks_arguments(name):
    params, grads, mus, nus, lrs, c1, c2 = _case(name)
    snapshot = [x.clone() for x in params]
    with pytest.raises(ValueError):
        t_opt.adam_multi(params, grads, mus, nus, lrs, c1, c2, B1, B2, EPS)
    assert all(torch.equal(a, b) for a, b in zip(params, snapshot))


@pytest.mark.parametrize("which", ["param", "grad", "mu", "nu"])
def test_the_kernel_route_refuses_a_non_contiguous_tensor(which):
    """The kernel reads its tensors as flat arrays, so the CUDA route
    (``_check_kernel_layout``, which ``adam_multi`` runs before a launch)
    refuses strides; the plain route on CPU tensors takes them, as CPU
    states made from numpy views have them (``features_dc`` as ``sh[:, :1]``)."""
    params, grads, mus, nus = _tensors([(8, 3), (8, 1, 3)], seed=1)
    rows = {"param": params, "grad": grads, "mu": mus, "nu": nus}
    rows[which][1] = (torch.rand(8, 16, 3) * 1e-3)[:, :1]
    assert not rows[which][1].is_contiguous()
    with pytest.raises(ValueError, match="not contiguous"):
        t_opt._check_kernel_layout(params, grads, mus, nus)
    want = _plain(params, grads, mus, nus, _rates(2), steps=2)
    _multi(params, grads, mus, nus, _rates(2), steps=2)
    for got, exp in zip((params, mus, nus), want):
        for a, b in zip(got, exp):
            assert torch.equal(a, b)


def test_adam_multi_takes_an_empty_list():
    c1, c2 = t_opt.adam_bias_corrections(torch.tensor(1, dtype=torch.int32), B1, B2)
    t_opt.adam_multi([], [], [], [], [], c1, c2, B1, B2, EPS)


# --- the launch table (plain Python) ---


def _block_span(first_blocks, numels, vec, b):
    """What block ``b`` of a launch updates, found as ``csrc/adam.cu``'s
    kernel finds it: ``(k, lo, hi, vec_end)``, elements [lo, hi) of the
    launch's tensor k, [lo, vec_end) as float4s where the tensors all start
    on 16 bytes (``vec[k]``) and the rest one by one."""
    k = 0
    for i in range(1, len(first_blocks)):
        if first_blocks[i] <= b:
            k = i
    lo = (b - first_blocks[k]) * t_opt.ADAM_CHUNK
    hi = min(lo + t_opt.ADAM_CHUNK, numels[k])
    return k, lo, hi, lo + (hi - lo) // 4 * 4 if vec[k] else lo


@pytest.mark.parametrize("numels", [
    [4096, 1, 4097, 0, 3, 8191, 5, 0],
    [0, 0, 12, 0],
    [n * k for n in (1000, 1001) for k in (3, 4, 3, 1, 3, 45)],
    [int(np.prod(s)) for s in MLP_SHAPES],
    [17 * i + 3 for i in range(70)],
], ids=["tails", "empties", "groups", "mlp", "many"])
def test_adam_launches_cover_every_element_once(numels):
    seen = [np.zeros(n, np.int64) for n in numels]
    launches = t_opt.plan_adam_launches(numels)
    assert len(launches) == max(1, -(-sum(n > 0 for n in numels) // t_opt.ADAM_MAX_SEGMENTS))
    for li, (idx, first, blocks) in enumerate(launches):
        assert 0 < len(idx) <= t_opt.ADAM_MAX_SEGMENTS
        assert all(numels[i] > 0 for i in idx)
        sizes = [numels[i] for i in idx]
        assert first == sorted(first) and blocks == first[-1] + -(-sizes[-1] // t_opt.ADAM_CHUNK)
        # Alternate the alignment so both the float4 and the scalar walk run.
        vec = [(j + li) % 2 == 0 for j in range(len(idx))]
        for b in range(blocks):
            k, lo, hi, vec_end = _block_span(first, sizes, vec, b)
            assert 0 <= lo < hi <= sizes[k] and hi - lo <= t_opt.ADAM_CHUNK
            assert lo <= vec_end <= hi and (vec_end - lo) % 4 == 0
            assert (lo % 4 == 0 and hi - vec_end < 4) if vec[k] else vec_end == lo
            seen[idx[k]][lo:hi] += 1
    for n, s in zip(numels, seen):
        assert s.shape == (n,) and np.all(s == 1)


def test_adam_launches_of_nothing():
    assert t_opt.plan_adam_launches([]) == [] and t_opt.plan_adam_launches([0, 0]) == []


# --- the training step's update (CPU) ---


def _train_state(n=30, n_views=4, seed=0):
    rng = np.random.default_rng(seed)
    arrays = {}
    for k, s in zip(PARAM_KEYS, GROUP_SHAPES):
        arrays[f"params/{k}"] = rng.normal(size=(n,) + s).astype(np.float32)
        arrays[f"adam_mu/{k}"] = (rng.normal(size=(n,) + s) * 1e-3).astype(np.float32)
        arrays[f"adam_nu/{k}"] = (rng.uniform(size=(n,) + s) * 1e-6).astype(np.float32)
    alive = np.ones((n,), bool)
    alive[::7] = False
    arrays.update(alive=alive, xyz_grad_accum=rng.uniform(size=(n, 3)).astype(np.float32),
                  xyz_grad_count=np.full((n, 1), 3.0, np.float32),
                  max_radii2d=rng.integers(0, 5, size=(n,)).astype(np.int32),
                  adam_step=np.asarray(3, np.int32), iteration=np.asarray(1200, np.int32))
    arrays["poses/deltas"] = (rng.normal(size=(n_views, 6)) * 1e-3).astype(np.float32)
    arrays["poses/mu"] = (rng.normal(size=(n_views, 6)) * 1e-4).astype(np.float32)
    arrays["poses/nu"] = (rng.uniform(size=(n_views, 6)) * 1e-8).astype(np.float32)
    state = train_state_from_numpy(arrays, device="cpu")
    state.deform = t_deform.deform_state_init(t_deform.DeformSpec(depth=4, width=32, skip=2),
                                              seed=seed, device="cpu")
    for k, v in state.deform.params.items():
        state.deform.mu[k] = torch.as_tensor(rng.normal(size=v.shape) * 1e-3, dtype=torch.float32)
        state.deform.nu[k] = torch.as_tensor(rng.uniform(size=v.shape) * 1e-6,
                                             dtype=torch.float32)
    return state


def _tree(state):
    """Every tensor the update may write, by name."""
    groups = (("params", state.gauss.params), ("mu", state.opt.mu), ("nu", state.opt.nu))
    out = {f"{w}/{k}": getattr(src, k) for w, src in groups for k in PARAM_KEYS}
    out.update({f"deform/{w}/{k}": v for w in ("params", "mu", "nu")
                for k, v in getattr(state.deform, w).items()})
    out.update({f"poses/{k}": getattr(state.poses, k) for k in ("deltas", "mu", "nu")})
    out.update(step=state.opt.step, iteration=state.iteration,
               accum=state.gauss.xyz_grad_accum, count=state.gauss.xyz_grad_count,
               radii=state.gauss.max_radii2d)
    return out


@pytest.mark.parametrize("pose_start", [0, 5000], ids=["poses_on", "poses_gated"])
def test_apply_gradients_updates_groups_poses_and_mlp_as_before(pose_start):
    """The six groups, the pose deltas and the deformation network move as
    they did when each tensor went through ``adam_step`` by itself, the
    accumulators, ``max_radii2d`` and the metrics with them."""
    cfg = TrainingConfig(optimize_poses=True, pose_start_iter=pose_start, deform=True)
    rng = np.random.default_rng(5)
    got, want = _train_state(), _train_state()
    grads = GaussianParams(**{k: torch.as_tensor(rng.normal(size=getattr(
        got.gauss.params, k).shape) * 1e-2, dtype=torch.float32) for k in PARAM_KEYS})
    grads.quats[::4] = 0.0
    pose_grad = torch.as_tensor(rng.normal(size=(4, 6)) * 1e-2, dtype=torch.float32)
    dgrads = {k: torch.as_tensor(rng.normal(size=v.shape) * 1e-2, dtype=torch.float32)
              for k, v in got.deform.params.items()}
    radii = torch.as_tensor(rng.integers(0, 9, size=(30,)), dtype=torch.int32)
    metrics = {}
    before = _launches()
    t_step.apply_gradients(cfg, got, grads, radii, 2.0, metrics, pose_grad=pose_grad,
                           deform_grads=dgrads)
    assert _launches() == before

    # The update as each site wrote it, tensor by tensor.
    with torch.no_grad():
        it = want.iteration
        xyz_lr = t_opt.xyz_lr_schedule(cfg, it)
        lrs = t_opt.group_lrs(cfg, xyz_lr)
        want.opt.step += 1
        c1, c2 = t_opt.adam_bias_corrections(want.opt.step, B1, B2)
        for k in PARAM_KEYS:
            t_opt.adam_step(getattr(want.gauss.params, k), getattr(grads, k),
                            getattr(want.opt.mu, k), getattr(want.opt.nu, k), getattr(lrs, k),
                            c1, c2, B1, B2, EPS)
        clamp_scales(want.gauss.params, 2.0, cfg.scale_clamp_ratio)
        want.gauss.xyz_grad_accum.add_(torch.linalg.norm(grads.means, dim=-1, keepdim=True))
        want.gauss.xyz_grad_count.add_(1.0)
        torch.maximum(want.gauss.max_radii2d, radii, out=want.gauss.max_radii2d)
        plr = t_step.pose_lr_schedule(cfg, it)
        gp = torch.where(plr > 0.0, pose_grad, torch.zeros_like(pose_grad))
        p = want.poses
        t_opt.adam_step(p.deltas, gp, p.mu, p.nu, plr, c1, c2, B1, B2, EPS)
        dlr = t_deform.lr_schedule(cfg, it)
        d = want.deform
        for k in d.params:
            t_opt.adam_step(d.params[k], dgrads[k], d.mu[k], d.nu[k], dlr, c1, c2, B1, B2, EPS)
        want.iteration += 1
    a, b = _tree(got), _tree(want)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(metrics["xyz_lr"], xyz_lr) and torch.equal(metrics["pose_lr"], plr)
    assert torch.equal(metrics["deform_lr"], dlr)
    assert torch.equal(got.poses.deltas, _train_state().poses.deltas) == (pose_start > 0)


# --- the kernel (CUDA card) ---


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# The benchmark cells' buffers (the 1080p and deformable cells' 1M gaussians
# in 1.5M slots, the 3.11M cell's 4.665M), the deformation network's 22
# tensors, and a (V, 6) pose table.
CARD_CASES = {
    "groups_1500000": [(1_500_000,) + s for s in GROUP_SHAPES],
    "groups_4665000": [(4_665_000,) + s for s in GROUP_SHAPES],
    "mlp": list(MLP_SHAPES),
    "poses": [(32, 6)],
}


@pytest.mark.chip
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_equals_adam_step_on_the_card(cuda_device, case):
    """Three steps of the kernel against the plain ``adam_step`` run on the
    card, bit for bit (NaN where the plain code has NaN), one launch a
    step, with nonzero moments, zero and NaN gradient rows."""
    shapes = CARD_CASES[case]
    params, grads, mus, nus = _tensors(shapes, seed=11, device=cuda_device)
    grads[0][1] = float("nan")
    grads[-1][-1] = float("inf")
    lrs = _rates(len(shapes), device=cuda_device)
    want = _plain(params, grads, mus, nus, lrs, steps=3, start=6079)
    before = _launches()
    _multi(params, grads, mus, nus, lrs, steps=3, start=6079)
    assert _launches() - before == 3
    torch.cuda.synchronize()
    for got, exp in zip((params, mus, nus), want):
        for a, b in zip(got, exp):
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            assert _bits_equal(torch.where(torch.isnan(a), 0.0, a),
                               torch.where(torch.isnan(b), 0.0, b))
    assert bool(torch.isnan(params[0][1]).all())
