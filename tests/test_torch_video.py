"""PyTorch port, the video front end: ``gaussian_splatting_tpu_torch/video/``
(loader, calibration, SfM, cloud alignment, cross-video correspondences,
the multi-video processor) against the JAX package's ``video/`` on the same
seeded synthetic clips (``tests/synthetic_video.py``). The port's copies
differ only in their imports and two docstring lines, so every comparison
is exact: SfM poses, frame indices, points, colours and intrinsics, the
alignment transforms, the correspondences and the merged clouds are equal
array for array.
"""

import logging

import numpy as np
import pytest

from gaussian_splatting_tpu.video import align as j_align
from gaussian_splatting_tpu.video import calibrate as j_calibrate
from gaussian_splatting_tpu.video import correspond as j_correspond
from gaussian_splatting_tpu.video import processor as j_processor
from gaussian_splatting_tpu.video import sfm as j_sfm
from gaussian_splatting_tpu.video.loader import VideoLoader as JVideoLoader
from gaussian_splatting_tpu_torch.video import align as t_align
from gaussian_splatting_tpu_torch.video import calibrate as t_calibrate
from gaussian_splatting_tpu_torch.video import correspond as t_correspond
from gaussian_splatting_tpu_torch.video import processor as t_processor
from gaussian_splatting_tpu_torch.video import sfm as t_sfm
from gaussian_splatting_tpu_torch.video.loader import VideoLoader as TVideoLoader
from synthetic_video import write_synthetic_video

SFM_KEYS = ("poses", "frame_indices", "points_3d", "colors", "K")
MERGED_KEYS = ("points_3d", "colors", "all_poses", "all_intrinsics", "frame_indices")


def _equal(a, b, keys):
    for k in keys:
        x, y = a[k], b[k]
        if isinstance(x, list):
            assert len(x) == len(y), k
            for xi, yi in zip(x, y):
                np.testing.assert_array_equal(np.asarray(xi), np.asarray(yi), err_msg=k)
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=k)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """The clip of ``tests/test_sfm.py``'s ``synth_video``: 60 frames at 320x240."""
    path = tmp_path_factory.mktemp("video") / "synth.mp4"
    write_synthetic_video(path, n_frames=60)
    return str(path)


@pytest.fixture(scope="module")
def two_clips(tmp_path_factory):
    """The two overlapping-arc clips of ``tests/test_cross_video.py``."""
    d = tmp_path_factory.mktemp("two")
    va, vb = d / "a.mp4", d / "b.mp4"
    write_synthetic_video(va, n_frames=40, arc_range=(0.0, 0.65), scene_seed=7)
    write_synthetic_video(vb, n_frames=40, arc_range=(0.35, 1.0), scene_seed=7)
    return str(va), str(vb)


def test_loader_frames_match_jax(clip):
    jl, tl = JVideoLoader(clip), TVideoLoader(clip)
    assert (tl.fps, tl.num_frames, tl.width, tl.height) == (
        jl.fps, jl.num_frames, jl.width, jl.height)
    jf, tf = list(jl.frames(stride=7)), list(tl.frames(stride=7))
    assert [i for i, _ in tf] == [i for i, _ in jf]
    for (_, a), (_, b) in zip(jf, tf):
        np.testing.assert_array_equal(a, b)
    jl.release()
    tl.release()


def test_video_sfm_matches_jax(clip):
    """``VideoSfM.process_video_frames`` on the same frames: equal results."""
    loader = JVideoLoader(clip)
    pairs = list(loader.frames(stride=4))
    loader.release()
    frames, idx = [f for _, f in pairs], [i for i, _ in pairs]
    j = j_sfm.VideoSfM(calibrator=j_calibrate.Calibrator()).process_video_frames(frames, idx)
    t = t_sfm.VideoSfM(calibrator=t_calibrate.Calibrator()).process_video_frames(frames, idx)
    assert len(t.poses) >= 5 and len(t.points_3d) >= 100
    _equal(vars(j), vars(t), SFM_KEYS)
    assert t.skip_stats == j.skip_stats


def test_processor_matches_jax(clip, tmp_path):
    j = j_processor.MultiVideoProcessor(cache_dir=str(tmp_path / "j")).process_videos(
        [clip], stride=4, use_cache=False)
    t = t_processor.MultiVideoProcessor(cache_dir=str(tmp_path / "t")).process_videos(
        [clip], stride=4, use_cache=False)
    _equal(j, t, MERGED_KEYS)
    assert t["video_info"] == j["video_info"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sfm_cache_loads_in_the_other_package(clip, tmp_path, writer, caplog):
    """The SfM cache is a pickled dict of numpy arrays under the same key, so
    a cache written by either package is a hit for the other."""
    cache = str(tmp_path / "cache")
    mods = {"jax": j_processor, "port": t_processor}
    reader = "port" if writer == "jax" else "jax"
    wrote = mods[writer].MultiVideoProcessor(cache_dir=cache)._process_single_video(
        clip, 4, use_cache=False)
    proc = mods[reader].MultiVideoProcessor(cache_dir=cache)
    with open(proc._cache_path(clip, 4), "rb") as f:
        assert b"gaussian_splatting" not in f.read()
    with caplog.at_level(logging.INFO):
        read = proc._process_single_video(clip, 4, use_cache=True)
    assert any("SfM cache hit" in r.getMessage() for r in caplog.records)
    _equal(wrote, read, SFM_KEYS)


def _rot_z(ang):
    return np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                     [0, 0, 1.0]])


def _align_case(name, rng):
    """The seeded inputs of ``tests/test_sfm.py``'s alignment tests: the
    function's name and its arguments."""
    if name == "umeyama_similarity":
        src = rng.normal(size=(50, 3))
        dst = (1.7 * (_rot_z(0.6) @ src.T)).T + np.array([0.5, -1.0, 2.0])
        return (src, dst), {}
    if name == "ransac_similarity":
        src = rng.normal(size=(100, 3))
        R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(R) < 0:
            R[:, 0] *= -1
        dst = (0.8 * (R @ src.T)).T + np.array([1.0, 2.0, 3.0])
        dst[:20] += rng.normal(size=(20, 3)) * 5.0
        return (src, dst), {"seed": 1}
    if name == "apply_similarity_to_pose":
        from synthetic_video import look_at_np

        ang = 0.3
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
        return (look_at_np((0.3, -0.2, -1.0), (0, 0, 3.0)), 1.4, R,
                np.array([0.2, 0.1, -0.4])), {}
    src = rng.normal(size=(300, 3))
    dst = (1.1 * (_rot_z(0.2) @ src.T)).T + np.array([0.3, 0.0, -0.2])
    if name == "align_clouds":
        return (src, dst), {"correspondences": (src, dst)}
    if name == "align_clouds_pca":
        return (src, dst), {}
    if name == "icp_refine":
        return (src, dst, 1.0, np.eye(3), np.zeros(3)), {}
    return (src, dst), {}  # pca_fallback


@pytest.mark.parametrize("name", ["umeyama_similarity", "ransac_similarity",
                                  "apply_similarity_to_pose", "align_clouds",
                                  "align_clouds_pca", "icp_refine", "pca_fallback"])
def test_align_matches_jax(name):
    fn = name.replace("_pca", "")
    args, kw = _align_case(name, np.random.default_rng(0))
    j = getattr(j_align, fn)(*args, **kw)
    t = getattr(t_align, fn)(*args, **kw)
    j, t = (x if isinstance(x, tuple) else (x,) for x in (j, t))
    assert len(t) == len(j)
    for a, b in zip(j, t):
        if isinstance(a, str):
            assert a == b
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cross_video_correspondences_and_merge_match_jax(two_clips, tmp_path):
    """Two clips of one scene over overlapping arcs: equal per-clip SfM, equal
    3D-3D correspondences, and an equal merged (aligned, deduplicated)
    cloud from ``process_videos``."""
    va, vb = two_clips
    jp = j_processor.MultiVideoProcessor(cache_dir=str(tmp_path / "j"))
    tp = t_processor.MultiVideoProcessor(cache_dir=str(tmp_path / "t"))
    ja, jb = (jp._process_single_video(v, 4, use_cache=False) for v in (va, vb))
    ta, tb = (tp._process_single_video(v, 4, use_cache=False) for v in (va, vb))
    _equal(ja, ta, SFM_KEYS)
    _equal(jb, tb, SFM_KEYS)
    jc = j_correspond.cross_video_correspondences(jb, ja)
    tc = t_correspond.cross_video_correspondences(tb, ta)
    assert tc is not None and len(tc[0]) >= 10
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(a, b)
    # The merge reads the caches just written.
    jm = jp.process_videos([va, vb], stride=4, use_cache=True)
    tm = tp.process_videos([va, vb], stride=4, use_cache=True)
    assert len(tm["all_poses"]) == 2
    _equal(jm, tm, MERGED_KEYS)


def test_loftr_requires_kornia_error():
    cal = t_calibrate.Calibrator(matcher="sift")
    f = np.zeros((32, 32, 3), np.uint8)
    with pytest.raises(RuntimeError, match="requires kornia"):
        cal.match_with_loftr(f, f)
