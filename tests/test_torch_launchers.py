"""The port's launchers, ``scripts/train_torch.sh`` and
``scripts/eval_torch.sh``, against the JAX package's
``scripts/train_tpu.sh`` and ``scripts/eval_tpu.sh``: with shim ``python``
and ``torchrun`` executables first on ``PATH`` that record how they were
called, each environment knob reaches the port's CLI as it reaches the JAX
package's; a mesh of MESH_DATA x MESH_MODEL > 1 cards starts under
``torchrun --nproc-per-node`` (one process a card); the eval launcher
finds the newest checkpoint under ``runs/`` as the JAX one does."""

import os
import pathlib
import subprocess

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SHIM = '#!/usr/bin/env bash\nprintf "%s\\n" "$(basename "$0")" "$@" > "$SHIM_LOG"\n'


@pytest.fixture
def shims(tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name in ("python", "torchrun"):
        (bin_dir / name).write_text(SHIM)
        (bin_dir / name).chmod(0o755)
    return bin_dir


def _launch(script, shims, cwd, env):
    """Run ``scripts/<script>`` in ``cwd`` with ``env`` on top of a clean
    environment; returns (exit code, the shim's argv: program first)."""
    log = cwd / "argv.txt"
    if log.exists():
        log.unlink()
    full = {"PATH": f"{shims}:{os.environ['PATH']}", "HOME": str(cwd), "SHIM_LOG": str(log),
            **env}
    res = subprocess.run(["bash", str(ROOT / "scripts" / script)], cwd=cwd, env=full,
                         capture_output=True, text=True, timeout=60)
    argv = log.read_text().splitlines() if log.exists() else None
    return res.returncode, argv


def _cli_args(argv, module):
    """The CLI's own arguments: what follows ``-m <module>``."""
    i = argv.index("-m")
    assert argv[i + 1] == module
    return argv[i + 2:]


TRAIN_ENVS = {
    "defaults": {},
    "every_knob": {"ITERATIONS": "10", "BATCH_SIZE": "2", "FRAME_STRIDE": "5",
                   "INITIAL_GAUSSIANS": "300", "MAX_GAUSSIANS": "2000", "FOCAL_35MM": "24",
                   "FOCAL_PX": "1000", "MATCHER": "orb", "RESUME": "runs/a/final.npz"},
    "focal_35mm_empty": {"FOCAL_35MM": ""},
    "mesh_1x1": {"MESH_DATA": "1", "MESH_MODEL": "1"},
    "mesh_2x2": {"MESH_DATA": "2", "MESH_MODEL": "2"},
    "mesh_1x2": {"MESH_MODEL": "2"},
}


@pytest.mark.parametrize("case", sorted(TRAIN_ENVS))
def test_train_launcher_passes_the_knobs_as_the_tpu_one(shims, tmp_path, case):
    env = {"VIDEOS": "a.mp4 b.mp4", "OUTPUT": "out", **TRAIN_ENVS[case]}
    rc_t, t = _launch("train_torch.sh", shims, tmp_path, env)
    rc_j, j = _launch("train_tpu.sh", shims, tmp_path, env)
    assert rc_t == rc_j == 0
    assert j[0] == "python"
    want = _cli_args(j, "gaussian_splatting_tpu.train_cli")
    assert _cli_args(t, "gaussian_splatting_tpu_torch.train_cli") == want
    n = int(env.get("MESH_DATA", 1)) * int(env.get("MESH_MODEL", 1))
    if n > 1:
        assert t[:2] == ["torchrun", f"--nproc-per-node={n}"]
    else:
        assert t[0] == "python"
    assert want[:4] == ["--videos", "a.mp4", "b.mp4", "--output"]
    if case == "defaults":
        assert want == ["--videos", "a.mp4", "b.mp4", "--output", "out", "--iterations",
                        "300000", "--batch-size", "4", "--frame-stride", "30", "--matcher",
                        "sift"]
    if case == "focal_35mm_empty":
        assert "--focal-35mm" not in want
    assert (tmp_path / "out" / "train.log").exists()


def test_train_launcher_needs_videos(shims, tmp_path):
    rc, argv = _launch("train_torch.sh", shims, tmp_path, {})
    assert rc != 0 and argv is None


def _checkpoint(path, age_s):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"")
    t = path.stat().st_mtime - age_s
    os.utime(path, (t, t))


@pytest.mark.parametrize("model", [None, "given.npz"])
def test_eval_launcher_passes_the_knobs_and_finds_the_newest_run(shims, tmp_path, model):
    _checkpoint(tmp_path / "runs" / "old" / "final.npz", 100)
    _checkpoint(tmp_path / "runs" / "new" / "final.npz", 10)
    _checkpoint(tmp_path / "runs" / "older" / "checkpoint_000100.npz", 50)
    env = {"VIDEOS": "a.mp4 b.mp4", "NUM_VIEWS": "3", "FRAME_STRIDE": "7"}
    if model:
        env["MODEL"] = model
    rc_t, t = _launch("eval_torch.sh", shims, tmp_path, env)
    rc_j, j = _launch("eval_tpu.sh", shims, tmp_path, env)
    assert rc_t == rc_j == 0
    want = _cli_args(j, "gaussian_splatting_tpu.eval_cli")
    assert _cli_args(t, "gaussian_splatting_tpu_torch.eval_cli") == want
    chosen = model or "runs/new/final.npz"
    assert want == ["--model", chosen, "--videos", "a.mp4", "b.mp4", "--output",
                    f"{os.path.dirname(chosen) or '.'}/eval", "--num-views", "3",
                    "--frame-stride", "7"]


def test_eval_launcher_without_a_checkpoint_fails(shims, tmp_path):
    rc, argv = _launch("eval_torch.sh", shims, tmp_path, {"VIDEOS": "a.mp4"})
    assert rc == 1 and argv is None
