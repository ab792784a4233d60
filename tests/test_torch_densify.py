"""PyTorch port, ``models/densify.py`` and ``models/gaussians.py``
(``densify_and_prune``, ``reset_opacity``, ``clamp_scales``,
``grow_capacity``, ``init_from_points``, ``knn_mean_distance``) against the
JAX package on the CPU, from the same numpy inputs.

Tolerances: masks, counts and integer buffers equal; parameters and Adam
moments equal bit for bit, except where a transcendental function of the
two frameworks may round differently: the split children's means and log
scales (exp and log of float32) and the reset opacities' logits (sigmoid
and logit) to 2 float32 ulp (rtol 2.4e-7, atol 1e-7). ``init_from_points``:
means and colors bit for bit; log scales to rtol 1e-6, since the two
packages' kNN libraries are the same C++ source built with different
compiler flags (FMA contraction) and agree to ~1 ulp."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.core.activations import opacity_inverse_activation
from gaussian_splatting_tpu.models import densify as j_densify
from gaussian_splatting_tpu.models import gaussians as j_gauss
from gaussian_splatting_tpu_torch.models import densify as t_densify
from gaussian_splatting_tpu_torch.models import gaussians as t_gauss
from torch_parity import PARAM_KEYS

ULP2 = dict(rtol=4.8e-7, atol=4.8e-7)


def _densify_state(C=32, n=8):
    """The JAX state of ``tests/test_training.py::_densify_state``."""
    state = j_gauss.empty_state(C)
    p = state.params
    means = jnp.arange(n * 3, dtype=jnp.float32).reshape(n, 3) * 0.1
    p = dataclasses.replace(
        p, means=p.means.at[:n].set(means),
        logit_opacities=p.logit_opacities.at[:n].set(
            opacity_inverse_activation(jnp.full((n, 1), 0.5))))
    return dataclasses.replace(state, params=p, alive=state.alive.at[:n].set(True)), n


def _to_port(jstate):
    arrays = {k: np.asarray(getattr(jstate.params, k)) for k in PARAM_KEYS}
    arrays.update({k: np.asarray(getattr(jstate, k))
                   for k in ("alive", "xyz_grad_accum", "xyz_grad_count", "max_radii2d")})
    return t_gauss.state_from_numpy(arrays, device="cpu")


def _moments(jstate, rng):
    """Distinct nonzero (mu, nu) in both packages."""
    mu = {k: rng.normal(size=np.asarray(getattr(jstate.params, k)).shape).astype(np.float32)
          for k in PARAM_KEYS}
    nu = {k: rng.uniform(size=v.shape).astype(np.float32) for k, v in mu.items()}
    j = tuple(j_gauss.GaussianParams(**{k: jnp.asarray(v) for k, v in m.items()})
              for m in (mu, nu))
    t = tuple(t_gauss.GaussianParams(**{k: torch.as_tensor(v) for k, v in m.items()})
              for m in (mu, nu))
    return j, t


def _run_both(jstate, rng, key=0, **kw):
    """densify_and_prune in both packages, the port fed JAX's split normals."""
    C = jstate.capacity
    jm, tm = _moments(jstate, rng)
    k = jax.random.PRNGKey(key)
    j_new, (j_mu, j_nu), j_st = j_densify.densify_and_prune(jstate, jm, k, **kw)
    k1, k2 = jax.random.split(k)
    normals = tuple(torch.as_tensor(np.array(jax.random.normal(kk, (C, 3), jnp.float32)))
                    for kk in (k1, k2))
    t_new, (t_mu, t_nu), t_st = t_densify.densify_and_prune(_to_port(jstate), tm,
                                                            _normals=normals, **kw)
    for f in j_st._fields:
        assert int(getattr(t_st, f)) == int(getattr(j_st, f)), f
    for k in ("alive", "xyz_grad_accum", "xyz_grad_count", "max_radii2d"):
        np.testing.assert_array_equal(getattr(t_new, k).numpy(), np.asarray(getattr(j_new, k)),
                                      err_msg=k)
    for k in PARAM_KEYS:
        got, want = getattr(t_new.params, k).numpy(), np.asarray(getattr(j_new.params, k))
        if k in ("means", "log_scales"):
            np.testing.assert_allclose(got, want, err_msg=k, **ULP2)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
        np.testing.assert_array_equal(getattr(t_mu, k).numpy(), np.asarray(getattr(j_mu, k)))
        np.testing.assert_array_equal(getattr(t_nu, k).numpy(), np.asarray(getattr(j_nu, k)))
    return t_new, t_st


BASE = dict(grads_threshold=5e-4, min_opacity=0.005, extent=1.0, max_gaussians=1000)


def test_densify_clone_and_split_match_jax(rng):
    """tests/test_training.py:130: two clones, one split with JAX's normals."""
    state, n = _densify_state()
    accum = state.xyz_grad_accum.at[0].set(1.0).at[1].set(1.0).at[2].set(1.0)
    p = dataclasses.replace(state.params,
                            log_scales=state.params.log_scales.at[2].set(jnp.log(0.5)))
    state = dataclasses.replace(state, params=p, xyz_grad_accum=accum,
                                xyz_grad_count=state.xyz_grad_count + 1.0)
    new, st = _run_both(state, rng, **BASE)
    assert (int(st.n_cloned), int(st.n_split), int(st.n_pruned)) == (2, 1, 0)
    assert int(new.alive.sum()) == n + 3


def test_densify_prune_matches_jax(rng):
    """tests/test_training.py:173: a sub-threshold opacity is pruned."""
    state, n = _densify_state()
    p = dataclasses.replace(state.params, logit_opacities=state.params.logit_opacities.at[5].set(
        opacity_inverse_activation(jnp.full((1,), 1e-4))))
    new, st = _run_both(dataclasses.replace(state, params=p), rng, **BASE)
    assert int(st.n_pruned) == 1 and not bool(new.alive[5])


def test_densify_population_cap_matches_jax(rng):
    """tests/test_training.py:192: max_gaussians n + 2 keeps the two
    highest-gradient candidates."""
    state, n = _densify_state()
    accum = state.xyz_grad_accum.at[:n].set(jnp.arange(1, n + 1, dtype=jnp.float32)[:, None] * 0.01)
    state = dataclasses.replace(state, xyz_grad_accum=accum,
                                xyz_grad_count=state.xyz_grad_count + 1.0)
    _, st = _run_both(state, rng, **dict(BASE, max_gaussians=n + 2))
    assert bool(st.capped) and int(st.n_cloned) == 2


@pytest.mark.parametrize("topk", [0.25, 0.5])
def test_densify_topk_fraction_matches_jax(rng, topk):
    """tests/test_training.py:211: the rank threshold at tiny gradients."""
    state, n = _densify_state()
    accum = state.xyz_grad_accum.at[:n].set(jnp.arange(1, n + 1, dtype=jnp.float32)[:, None] * 2e-6)
    state = dataclasses.replace(state, xyz_grad_accum=accum,
                                xyz_grad_count=state.xyz_grad_count + 1.0)
    _, st = _run_both(state, rng, **dict(BASE, topk_fraction=topk))
    assert int(st.n_cloned) + int(st.n_split) == int(topk * n)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_densify_random_states_match_jax(seed):
    """Seeded random states: mixed clones and splits, ties in the gradient,
    a capacity that runs out of free slots, pruning by scale and opacity."""
    rng = np.random.default_rng(seed)
    C, n = 96, 70
    state = j_gauss.empty_state(C)
    p = state.params
    ls = np.log(rng.uniform(0.01, 1.5, size=(n, 3))).astype(np.float32)
    lo = rng.normal(0.0, 3.0, size=(n, 1)).astype(np.float32)
    p = dataclasses.replace(p, means=p.means.at[:n].set(rng.normal(size=(n, 3)).astype(np.float32)),
                            log_scales=p.log_scales.at[:n].set(ls),
                            logit_opacities=p.logit_opacities.at[:n].set(lo),
                            quats=p.quats.at[:n].set(rng.normal(size=(n, 4)).astype(np.float32)))
    accum = rng.uniform(0, 2e-3, size=(C, 3)).astype(np.float32)
    accum[5] = accum[6]  # a tie
    alive = np.zeros(C, bool)
    alive[:n] = True
    alive[rng.choice(n, 10, replace=False)] = False
    state = dataclasses.replace(state, params=p, alive=jnp.asarray(alive),
                                xyz_grad_accum=jnp.asarray(accum),
                                xyz_grad_count=jnp.full((C, 1), 2.0, jnp.float32))
    for kw in (dict(BASE, max_gaussians=200), dict(BASE, max_gaussians=75),
               dict(BASE, topk_fraction=0.3, extent=2.0)):
        _, st = _run_both(state, rng, key=seed, **kw)
        assert int(st.n_cloned) + int(st.n_split) > 0


def test_densify_draws_its_noise_from_a_generator(rng):
    """Without ``_normals`` the split noise comes from the generator: the
    same seed gives the same state."""
    state, _ = _densify_state()
    accum = state.xyz_grad_accum.at[2].set(1.0)
    p = dataclasses.replace(state.params,
                            log_scales=state.params.log_scales.at[2].set(jnp.log(0.5)))
    ts = _to_port(dataclasses.replace(state, params=p, xyz_grad_accum=accum,
                                      xyz_grad_count=state.xyz_grad_count + 1.0))
    _, tm = _moments(state, rng)
    outs = [t_densify.densify_and_prune(ts, tm, generator=torch.Generator().manual_seed(7),
                                        **BASE)[0] for _ in range(2)]
    assert int(outs[0].alive.sum()) == 9
    assert torch.equal(outs[0].params.means, outs[1].params.means)
    with pytest.raises(ValueError, match="generator"):
        t_densify.densify_and_prune(ts, tm, **BASE)


def test_reset_opacity_and_clamp_scales_match_jax(rng):
    state, n = _densify_state()
    lo = rng.normal(0.0, 4.0, size=(32, 1)).astype(np.float32)
    ls = rng.normal(0.0, 2.0, size=(32, 3)).astype(np.float32)
    jp = dataclasses.replace(state.params, logit_opacities=jnp.asarray(lo),
                             log_scales=jnp.asarray(ls))
    tp = _to_port(dataclasses.replace(state, params=jp)).params
    got = t_densify.reset_opacity(tp).logit_opacities.numpy()
    np.testing.assert_allclose(got, np.asarray(j_densify.reset_opacity(jp).logit_opacities),
                               **ULP2)
    assert tp.logit_opacities.numpy().tolist() == lo.tolist()  # the input is kept
    for extent in (1.0, 0.3):
        # In place, as make_train_step applies it every step.
        tq = t_gauss.GaussianParams(**{k: getattr(tp, k).clone() for k in PARAM_KEYS})
        assert t_densify.clamp_scales(tq, extent, 0.2) is tq
        np.testing.assert_array_equal(
            tq.log_scales.numpy(),
            np.asarray(j_densify.clamp_scales(jp, jnp.float32(extent), 0.2).log_scales))


def test_grow_capacity_matches_jax(rng):
    state, n = _densify_state(C=40)
    state = dataclasses.replace(
        state, xyz_grad_accum=jnp.asarray(rng.uniform(size=(40, 3)), jnp.float32),
        max_radii2d=jnp.arange(40, dtype=jnp.int32))
    j_new = j_gauss.grow_capacity(state, 64)
    t_old = _to_port(state)
    t_new = t_gauss.grow_capacity(t_old, 64)
    assert t_new.capacity == 64 and t_old.capacity == 40
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(getattr(t_new.params, k).numpy(),
                                      np.asarray(getattr(j_new.params, k)), err_msg=k)
    for k in ("alive", "xyz_grad_accum", "xyz_grad_count", "max_radii2d"):
        got = getattr(t_new, k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(j_new, k)), err_msg=k)
        assert got.dtype == getattr(t_old, k).dtype
    with pytest.raises(ValueError):
        t_gauss.grow_capacity(t_old, 40)


@pytest.mark.parametrize("n_gauss,with_colors", [(50, True), (300, True), (120, False)])
def test_init_from_points_matches_jax(rng, n_gauss, with_colors):
    """The same numpy draws from default_rng(seed): sub- and oversampling."""
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    cols = rng.uniform(size=(200, 3)).astype(np.float32) if with_colors else None
    j = j_gauss.init_from_points(pts, cols, n_gauss, seed=3, init_opacity=0.1)
    t = t_gauss.init_from_points(pts, cols, n_gauss, seed=3, init_opacity=0.1, device="cpu")
    assert t.capacity == j.capacity
    np.testing.assert_array_equal(t.alive.numpy(), np.asarray(j.alive))
    for k in PARAM_KEYS:
        got, want = getattr(t.params, k).numpy(), np.asarray(getattr(j.params, k))
        if k == "log_scales":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=2.4e-7, err_msg=k)
        elif k == "logit_opacities":
            np.testing.assert_allclose(got, want, **ULP2)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


def test_knn_mean_distance_matches_scipy(rng):
    """Queries among the points: the mean distance to the 6 nearest other
    points, as scipy's KD-tree gives it (rtol 1e-4, the JAX package's
    tests/test_native.py tolerance). Queries off the points (the jittered
    init positions) keep their nearest point: the native grid skips only an
    exact self match."""
    from scipy.spatial import cKDTree

    pts = rng.normal(size=(3000, 3)).astype(np.float32)
    tree = cKDTree(pts)
    d, _ = tree.query(pts[:400], k=7)
    np.testing.assert_allclose(t_gauss.knn_mean_distance(pts, pts[:400], k=7),
                               d[:, 1:].mean(axis=1), rtol=1e-4, atol=1e-6)
    q = pts[:400] + rng.normal(size=(400, 3)).astype(np.float32) * 1e-3
    d, _ = tree.query(q, k=6)
    np.testing.assert_allclose(t_gauss.knn_mean_distance(pts, q, k=7), d.mean(axis=1),
                               rtol=1e-4, atol=1e-6)
    assert t_gauss.knn_mean_distance(pts[:3], q[:5], k=7).shape == (5,)  # k capped at n


def test_native_never_loads_the_committed_library(monkeypatch):
    """The port builds its own pointops copy; the committed
    native/libpointops.so is never opened."""
    import ctypes

    from gaussian_splatting_tpu_torch.utils import native

    opened = []
    real = ctypes.CDLL

    def spy(path, *a, **kw):
        opened.append(str(path))
        return real(path, *a, **kw)

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(ctypes, "CDLL", spy)
    from gaussian_splatting_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_loaded", {})
    assert native._load() is not None
    assert opened and all("libpointops" not in p and "/build/host/" in p for p in opened)


def test_init_random_contract():
    """``init_random``: n alive standard-normal means at opacity 0.005,
    reproducible from a generator."""
    a = t_gauss.init_random(500, generator=torch.Generator().manual_seed(1), device="cpu")
    b = t_gauss.init_random(500, generator=torch.Generator().manual_seed(1), device="cpu")
    assert a.capacity == 2048 and int(a.alive.sum()) == 500 and bool(a.alive[:500].all())
    assert torch.equal(a.params.means, b.params.means)
    m = a.params.means[:500]
    assert abs(float(m.mean())) < 0.1 and abs(float(m.std()) - 1.0) < 0.1
    assert (a.params.means[500:] == 0).all()
    op = torch.sigmoid(a.params.logit_opacities[:500])
    np.testing.assert_allclose(op.numpy(), 0.005, rtol=1e-5)


def test_radius_dedupe_matches_jax(rng):
    """The port's native radius dedupe keeps the JAX package's points."""
    from gaussian_splatting_tpu.utils import native as j_native
    from gaussian_splatting_tpu_torch.utils import native as t_native

    base = rng.uniform(size=(400, 3)).astype(np.float32)
    pts = np.concatenate([base, base[:80] + rng.normal(size=(80, 3)).astype(np.float32) * 1e-4])
    keep = t_native.radius_dedupe(pts, radius=0.01)
    assert keep.dtype == bool and keep[400:].sum() < 10
    np.testing.assert_array_equal(keep, j_native.radius_dedupe(pts, radius=0.01))
