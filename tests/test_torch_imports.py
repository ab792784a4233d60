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


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _arrays(n=3):
    return {"means": np.zeros((n, 3), np.float32),
            "quats": np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
            "log_scales": np.zeros((n, 3), np.float32),
            "logit_opacities": np.zeros((n, 1), np.float32),
            "features_dc": np.zeros((n, 1, 3), np.float32),
            "features_rest": np.zeros((n, 15, 3), np.float32)}


def _checkpoint(tmp_path):
    path = tmp_path / "ck.npz"
    arrays = {f"params/{k}": v for k, v in _arrays().items()}
    np.savez(path, alive=np.ones(3, bool), meta_json=np.frombuffer(b"{}", np.uint8),
             **arrays)
    return str(path)


def _entry_points(tmp_path):
    from gaussian_splatting_tpu_torch.core.cameras import look_at, make_intrinsics
    from gaussian_splatting_tpu_torch.models.gaussians import empty_state, state_from_numpy
    from gaussian_splatting_tpu_torch.ops.facade import GaussianRasterizer
    from gaussian_splatting_tpu_torch.ops.render import render
    from gaussian_splatting_tpu_torch.training.checkpoint import load_checkpoint

    a = _arrays()
    sh = np.concatenate([a["features_dc"], a["features_rest"]], 1)
    return {
        "GaussianRasterizer": lambda: GaussianRasterizer(16, 16),
        "render": lambda: render(a["means"], a["quats"], a["log_scales"],
                                 a["logit_opacities"], sh, np.eye(4, dtype=np.float32),
                                 np.eye(3, dtype=np.float32), 16, 16),
        "load_checkpoint": lambda: load_checkpoint(_checkpoint(tmp_path)),
        "state_from_numpy": lambda: state_from_numpy(a),
        "empty_state": lambda: empty_state(4),
        "look_at": lambda: look_at((0, 0, -3), (0, 0, 0)),
        "make_intrinsics": lambda: make_intrinsics(16, 16),
    }


@pytest.mark.parametrize("name", ["GaussianRasterizer", "render", "load_checkpoint",
                                  "state_from_numpy", "empty_state", "look_at",
                                  "make_intrinsics"])
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
