"""PyTorch port, the trainer against the JAX trainer on the CPU
(``device="cpu"``): the adaptive tile cap and the compact class budgets
chosen from the same state and dataset, and a short training run of both
trainers.

Tolerances: tile caps and budgets equal; every logged loss within rtol
1e-4 (the same float32 renders on backend ``ref``, whose init scales come
from two builds of one kNN source that agree to ~1 ulp).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.models.gaussians import init_from_points as j_init
from gaussian_splatting_tpu.ops.tiling import class_caps
from gaussian_splatting_tpu.training import trainer as j_trainer
from gaussian_splatting_tpu.training.config import TrainingConfig as JConfig
from gaussian_splatting_tpu.training.optimizer import adam_init as j_adam_init
from gaussian_splatting_tpu.training.step import TrainState as JTrainState
from gaussian_splatting_tpu_torch.models.gaussians import state_from_numpy
from gaussian_splatting_tpu_torch.training import trainer as t_trainer
from gaussian_splatting_tpu_torch.training.config import TrainingConfig as TConfig
from gaussian_splatting_tpu_torch.training.optimizer import adam_init
from gaussian_splatting_tpu_torch.training.step import TrainState
from test_torch_trainer import _dataset, _records
from torch_parity import PARAM_KEYS


def _states(points, n, log_scale=None, init_opacity=0.5):
    """The same gaussian state in both packages (JAX ``init_from_points``,
    carried over as arrays)."""
    jg = j_init(points, None, n, capacity=128, init_opacity=init_opacity)
    arrays = {k: np.asarray(getattr(jg.params, k)) for k in PARAM_KEYS}
    if log_scale is not None:
        arrays["log_scales"] = np.full_like(arrays["log_scales"], np.log(log_scale))
        jg = dataclasses.replace(jg, params=dataclasses.replace(
            jg.params, log_scales=jnp.asarray(arrays["log_scales"])))
    arrays["alive"] = np.asarray(jg.alive)
    tg = state_from_numpy(arrays, device="cpu")
    js = JTrainState(gauss=jg, opt=j_adam_init(jg.params), iteration=jnp.int32(0))
    ts = TrainState(gauss=tg, opt=adam_init(tg.params),
                    iteration=torch.zeros((), dtype=torch.int32))
    return js, ts


@pytest.mark.parametrize("log_scale", [0.8, 0.01])
def test_choose_max_tiles_and_class_budgets_match_jax(rng, log_scale):
    """The adaptive tile cap and the compact budgets from the same state and
    dataset (tests/test_training.py:379, at 96x96: 36 tiles): large scales
    raise the cap, tiny ones keep the default."""
    jds, tds, gt = _dataset(rng, n_views=3, width=96, height=96)
    js, ts = _states(gt, 64, log_scale=log_scale)
    jcfg, tcfg = JConfig(), TConfig()
    jt, tt = j_trainer.GaussianTrainer(jcfg), t_trainer.GaussianTrainer(tcfg, device="cpu")
    chosen = tt._choose_max_tiles(ts, tds, tcfg)
    assert chosen == jt._choose_max_tiles(js, jds, jcfg)
    assert chosen & (chosen - 1) == 0
    if log_scale == 0.8:
        assert chosen > tcfg.max_tiles_per_gaussian
    if log_scale == 0.01:
        assert chosen == tcfg.max_tiles_per_gaussian
    for headroom in (1.1, 2.0):
        tb = tt._choose_class_budgets(ts, tds, tcfg, chosen, headroom=headroom)
        assert tb == jt._choose_class_budgets(js, jds, jcfg, chosen, headroom=headroom)
        assert len(tb) == len(class_caps(chosen)) and all(b % 128 == 0 for b in tb)
    small = tcfg.replace(max_sort_entries=2000)
    assert (tt._choose_class_budgets(ts, tds, small, chosen)
            == jt._choose_class_budgets(js, jds, jcfg.replace(max_sort_entries=2000), chosen))


def test_trainer_matches_jax_trainer(rng, tmp_path):
    """The short trainer parity: both packages' trainers, backend ``ref``,
    densify off, an opacity reset at iteration 5, the same seeds: the same
    validation split and batches, every logged loss within rtol 1e-4."""
    jds, tds, gt = _dataset(rng, n_views=6)
    kw = dict(iterations=8, batch_size=2, backend="ref", initial_gaussians=60,
              densify_from_iteration=10_000, opacity_reset_interval=5, val_interval=4,
              checkpoint_interval=10_000, log_scalar_interval=2, sh_degree_max=0,
              log_image_interval=0)
    j_trainer.GaussianTrainer(JConfig(**kw)).train(jds, str(tmp_path / "j"), points=gt)
    t_trainer.GaussianTrainer(TConfig(**kw), device="cpu").train(tds, str(tmp_path / "t"),
                                                                 points=gt)
    jr, tr = (_records(tmp_path / d / "metrics.jsonl") for d in ("j", "t"))
    for key in ("loss", "train/psnr", "val/psnr"):
        jl = [r[key] for r in jr if key in r]
        tl = [r[key] for r in tr if key in r]
        assert len(jl) == len(tl) > 0, key
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=key)
