"""PyTorch port, the eval CLI on the train CLI's checkpoint:
``gaussian_splatting_tpu_torch/eval_cli.py`` against the JAX package's
``eval_cli.py`` on the same ``.npz`` (compact budgets and pose deltas in
it) and the same seeded synthetic clip (``tests/synthetic_video.py``, 48
frames at 320x240), on the CPU: the port's backend ``cuda`` runs its
kernels' plain versions there, the JAX backend ``pallas`` its kernels in
interpret mode.

Tolerance: every metric of ``metrics.json`` (per view and mean) within
atol 1e-4 of the JAX eval CLI's, with one exception that is the JAX
package's: SfM puts camera 0 at the world origin, where a checkpoint's dead
slots sit (zero means). Unless a pose delta moved that camera, the JAX pose
gradient there is NaN, so its alignment keeps the view as it is; the
port's gradient is finite.
"""

import json

import numpy as np
import pytest

from gaussian_splatting_tpu import eval_cli as j_eval
from gaussian_splatting_tpu_torch import eval_cli as t_eval
from gaussian_splatting_tpu_torch import train_cli as t_train
from synthetic_video import write_synthetic_video

METRIC_ATOL = 1e-4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's train CLI: 2 iterations at half resolution with pose
    refinement, the trainer's compact budgets in the checkpoint's meta."""
    d = tmp_path_factory.mktemp("eval")
    clip = str(d / "clip.mp4")
    write_synthetic_video(clip, n_frames=48, width=320, height=240)
    assert t_train.main([
        "--videos", clip, "--output", str(d / "run"), "--iterations", "2",
        "--batch-size", "2", "--frame-stride", "4", "--initial-gaussians", "300",
        "--max-gaussians", "2000", "--backend", "cuda", "--device", "cpu",
        "--image-scale", "0.5", "--optimize-poses", "--cache-dir", str(d / "cache")]) == 0
    return d, clip


@pytest.mark.parametrize("pose_align", [0, 2])
def test_eval_cli_matches_jax(run, pose_align, capsys):
    d, clip = run
    common = ["--model", str(d / "run" / "final.npz"), "--videos", clip, "--num-views", "2",
              "--frame-stride", "4", "--cache-dir", str(d / "cache"),
              "--pose-align", str(pose_align)]
    t_out, j_out = d / f"t{pose_align}", d / f"j{pose_align}"
    assert t_eval.main(common + ["--output", str(t_out), "--backend", "cuda",
                                 "--device", "cpu"]) == 0
    t_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert j_eval.main(common + ["--output", str(j_out), "--backend", "pallas"]) == 0
    t = json.loads((t_out / "metrics.json").read_text())
    j = json.loads((j_out / "metrics.json").read_text())
    assert t_line == {k: v for k, v in t.items() if k != "per_view"}
    assert set(t) == set(j) and t["num_views"] == j["num_views"] == 2
    assert [r["view"] for r in t["per_view"]] == [r["view"] for r in j["per_view"]]
    with np.load(d / "run" / "final.npz") as z:
        deltas = z["poses/deltas"]
    for a, b in zip(t["per_view"], j["per_view"]):
        assert set(a) == set(b)
        for k in ("l1", "ssim", "psnr"):
            assert np.isfinite(a[k]) and abs(a[k] - b[k]) <= METRIC_ATOL, (k, a[k], b[k])
        if not pose_align:
            continue
        assert a["psnr_aligned"] >= a["psnr"]
        if a["view"] == 0 and not deltas[0].any():  # camera 0 still at the origin
            assert b["psnr_aligned"] == b["psnr"]
        else:
            assert abs(a["psnr_aligned"] - b["psnr_aligned"]) <= METRIC_ATOL
    for k in ("l1", "ssim", "psnr"):
        assert abs(t[k] - j[k]) <= METRIC_ATOL, k
    if pose_align:
        assert t["psnr_aligned"] == np.mean([r["psnr_aligned"] for r in t["per_view"]])
        if deltas[0].any():
            assert abs(t["psnr_aligned"] - j["psnr_aligned"]) <= METRIC_ATOL
    assert len(list(t_out.glob("view_*.png"))) == 2
    assert (t_out / "model.ply").exists()


def test_eval_cli_takes_more_buckets_and_longer_chunks_than_before(run, capsys, caplog):
    """A checkpoint whose render meta asks for ``sort_buckets=64`` and
    ``raster_chunk=2048`` (settings the port used to refuse): the port's
    eval CLI renders with them, as the log says, and its metrics equal the
    JAX eval CLI's on the same checkpoint."""
    import logging

    d, clip = run
    with np.load(d / "run" / "final.npz") as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["meta_json"].tobytes()).decode())
    meta["render"].update(sort_buckets=64, raster_chunk=2048)
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    model = d / "wide.npz"
    np.savez(model, **arrays)
    common = ["--model", str(model), "--videos", clip, "--num-views", "2", "--frame-stride",
              "4", "--cache-dir", str(d / "cache")]
    caplog.set_level(logging.INFO)
    assert t_eval.main(common + ["--output", str(d / "t_wide"), "--backend", "cuda",
                                 "--device", "cpu"]) == 0
    assert "chunk=2048" in caplog.text
    capsys.readouterr()
    assert j_eval.main(common + ["--output", str(d / "j_wide"), "--backend", "pallas"]) == 0
    t = json.loads((d / "t_wide" / "metrics.json").read_text())
    j = json.loads((d / "j_wide" / "metrics.json").read_text())
    for a, b in zip(t["per_view"], j["per_view"]):
        for k in ("l1", "ssim", "psnr"):
            assert np.isfinite(a[k]) and abs(a[k] - b[k]) <= METRIC_ATOL, (k, a[k], b[k])
