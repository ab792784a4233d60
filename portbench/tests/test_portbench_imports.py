"""No run loads JAX or the JAX package; the reference loads nothing of the
program; the command fails, with no result, without the program or a
card."""

import shutil
import subprocess
import sys

from portbench import harness

ROOT = harness.ROOT


def test_reference_alone_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.render, portbench.reference.train, portbench.scene, "
            "portbench.work, portbench.trace; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'gaussian_splatting_tpu_torch', 'gaussian_splatting_tpu', 'jax', 'jaxlib', "
            "'flax'}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "gaussian_splatting_tpu_torch_fake", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "gaussian_splatting_tpu.ops", sys)
    assert harness.forbidden_modules() == ["gaussian_splatting_tpu", "jax"]


def test_a_run_of_the_port_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.run, portbench.control; "
            "import portbench.harness as h; d = h.traffic_driver('trainer'); "
            "h.traffic_driver('viewer'); "
            "import gaussian_splatting_tpu_torch.training.trainer, "
            "gaussian_splatting_tpu_torch.ops.facade; "
            "print(h.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_command_fails_without_the_program_or_a_card(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cmd = [sys.executable, "portbench/run.py", "--workload", "render-video1080p-1m",
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    code = ("import sys, torch; sys.path.insert(0, '.'); import portbench.run as r, "
            "portbench.harness as h; r.run_cell(h.load_benchmark(), 'render-video1080p-1m', "
            "1, 1.0, False, torch.device('cpu'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and "gaussian_splatting_tpu_torch" in out.stderr
