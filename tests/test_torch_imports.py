"""The PyTorch port stands alone: neither its package nor ``chip_smoke.py``
imports JAX or the JAX package, its entry points refuse to fall back to the
CPU when CUDA is missing and no device was named, and ``chip_smoke.py``
fails without a card."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "gaussian_splatting_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "gaussian_splatting_tpu"}


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(path):
    return [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = _forbidden(path)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_sees_imports_inside_functions(tmp_path):
    """The guard reads every import of a module, also the lazy ones inside
    functions and methods: the processor with its native import left
    unrenamed is caught."""
    src = (ROOT / "gaussian_splatting_tpu_torch" / "video" / "processor.py").read_text()
    lazy = "from gaussian_splatting_tpu_torch.utils.native import radius_dedupe"
    assert lazy in src
    path = tmp_path / "processor.py"
    path.write_text(src.replace(lazy, lazy.replace("_tpu_torch.", "_tpu.")))
    assert _forbidden(path) == ["gaussian_splatting_tpu.utils.native"]


def test_video_modules_and_clis_are_guarded():
    names = {str(p.relative_to(ROOT / "gaussian_splatting_tpu_torch")) for p in PORT_FILES
             if "gaussian_splatting_tpu_torch" in p.parts}
    assert {"train_cli.py", "eval_cli.py", "video/__init__.py", "video/loader.py",
            "video/calibrate.py", "video/sfm.py", "video/align.py", "video/correspond.py",
            "video/processor.py"} <= names


def test_eval_load_model_imports_without_opencv(tmp_path):
    """``eval_cli.load_model`` reads a checkpoint with OpenCV unimportable:
    the CLI keeps its video imports inside ``main``."""
    code = ("import sys; sys.modules['cv2'] = None; "
            "from gaussian_splatting_tpu_torch.eval_cli import load_model; "
            f"g, m = load_model({_checkpoint(tmp_path)!r}, device='cpu'); "
            "assert not [k for k, v in sys.modules.items() if k == 'cv2' and v is not None]; "
            "print(g.capacity)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["3"]


def _arrays(n=3):
    return {"means": np.zeros((n, 3), np.float32),
            "quats": np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
            "log_scales": np.zeros((n, 3), np.float32),
            "logit_opacities": np.zeros((n, 1), np.float32),
            "features_dc": np.zeros((n, 1, 3), np.float32),
            "features_rest": np.zeros((n, 15, 3), np.float32)}


def _train_arrays(n=3):
    arrays = {}
    for k, v in _arrays(n).items():
        arrays.update({f"params/{k}": v, f"adam_mu/{k}": v, f"adam_nu/{k}": v})
    return dict(arrays, alive=np.ones(n, bool), xyz_grad_accum=np.zeros((n, 3), np.float32),
                xyz_grad_count=np.zeros((n, 1), np.float32),
                max_radii2d=np.zeros(n, np.int32), adam_step=np.int32(0),
                iteration=np.int32(0))


def _checkpoint(tmp_path):
    path = tmp_path / "ck.npz"
    np.savez(path, meta_json=np.frombuffer(b"{}", np.uint8), **_train_arrays())
    return str(path)


def _pth(tmp_path):
    path = tmp_path / "ref.pth"
    a = _arrays()
    torch.save({"model_state": {"xyz": torch.zeros(3, 3), "features_dc": torch.zeros(3, 1, 3),
                                "opacity": torch.zeros(3, 1), "scaling": torch.zeros(3, 3),
                                "rotation": torch.as_tensor(a["quats"])}}, path)
    return str(path)


def _entry_points(tmp_path):
    from gaussian_splatting_tpu_torch.core.cameras import look_at, make_intrinsics
    from gaussian_splatting_tpu_torch.models.gaussians import empty_state, state_from_numpy
    from gaussian_splatting_tpu_torch.ops.facade import GaussianRasterizer
    from gaussian_splatting_tpu_torch.models.gaussians import train_state_from_numpy
    from gaussian_splatting_tpu_torch.ops.render import render, render_grad_meta
    from gaussian_splatting_tpu_torch.training.checkpoint import (
        load_checkpoint, save_checkpoint)
    from gaussian_splatting_tpu_torch.training.config import TrainingConfig
    from gaussian_splatting_tpu_torch.training.step import make_train_step, pose_state_init
    from gaussian_splatting_tpu_torch.models.gaussians import init_from_points, init_random
    from gaussian_splatting_tpu_torch.training.checkpoint import load_reference_pth
    from gaussian_splatting_tpu_torch.training.trainer import GaussianTrainer
    from gaussian_splatting_tpu_torch import eval_cli, train_cli

    a = _arrays()
    sh = np.concatenate([a["features_dc"], a["features_rest"]], 1)
    eye3 = np.eye(3, dtype=np.float32)
    return {
        "make_train_step": lambda: make_train_step(TrainingConfig(), 16, 16, 3, "auto", 2.0),
        "train_state_from_numpy": lambda: train_state_from_numpy(_train_arrays()),
        # A state loaded with the defaults is on the card; saving it needs one.
        "save_checkpoint": lambda: save_checkpoint(
            str(tmp_path / "out.npz"), train_state_from_numpy(_train_arrays())),
        "pose_state_init": lambda: pose_state_init(4),
        "render_grad_meta": lambda: render_grad_meta(
            a["means"], a["quats"], a["log_scales"], a["logit_opacities"], sh,
            np.eye(4, dtype=np.float32), eye3, 16, 16),
        "GaussianRasterizer": lambda: GaussianRasterizer(16, 16),
        "render": lambda: render(a["means"], a["quats"], a["log_scales"],
                                 a["logit_opacities"], sh, np.eye(4, dtype=np.float32),
                                 np.eye(3, dtype=np.float32), 16, 16),
        "load_checkpoint": lambda: load_checkpoint(_checkpoint(tmp_path)),
        "state_from_numpy": lambda: state_from_numpy(a),
        "empty_state": lambda: empty_state(4),
        "look_at": lambda: look_at((0, 0, -3), (0, 0, 0)),
        "make_intrinsics": lambda: make_intrinsics(16, 16),
        "GaussianTrainer": lambda: GaussianTrainer(TrainingConfig()),
        "init_random": lambda: init_random(10),
        "init_from_points": lambda: init_from_points(np.zeros((4, 3), np.float32), None, 4),
        "load_reference_pth": lambda: load_reference_pth(_pth(tmp_path)),
        # The CLIs name the device before reading any video.
        "train_cli.main": lambda: train_cli.main(["--videos", str(tmp_path / "none.mp4"),
                                                  "--output", str(tmp_path / "run")]),
        "eval_cli.main": lambda: eval_cli.main(["--model", _checkpoint(tmp_path), "--videos",
                                                str(tmp_path / "none.mp4"), "--output",
                                                str(tmp_path / "eval")]),
        "eval_cli.load_model": lambda: eval_cli.load_model(_checkpoint(tmp_path)),
    }


@pytest.mark.parametrize("name", ["GaussianRasterizer", "render", "load_checkpoint",
                                  "state_from_numpy", "empty_state", "look_at",
                                  "make_intrinsics", "make_train_step",
                                  "train_state_from_numpy", "save_checkpoint",
                                  "pose_state_init", "render_grad_meta", "GaussianTrainer",
                                  "init_random", "init_from_points", "load_reference_pth",
                                  "train_cli.main", "eval_cli.main", "eval_cli.load_model"])
def test_entry_points_raise_without_cuda(monkeypatch, tmp_path, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _entry_points(tmp_path)[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def _run_chip_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    res = _run_chip_smoke(cwd)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
