"""The benchmark's frozen copies held equal to their sources in the port
(and ``chip_smoke.py``) at small sizes on the CPU."""

import json

import numpy as np
import pytest
import torch

from slambench import program, roofline, scene, tracing
from slambench.reference import geometry, keypoints
from tpuslam_torch.io import synth, trajectory

SMALL = dict(width=80, height=60, fx=65.0, fy=65.0, cx=39.5, cy=29.5)


def test_trajectory_and_walk():
    walk = scene.walk_poses(60, 0.0, 400.0, 560, 1.6, 1.5, 14.0, 0.05)
    np.testing.assert_array_equal(walk, synth.trajectory(560, synth.SceneSpec())[:60])
    later = scene.walk_poses(5, 90.0, 400.0, 560, 1.6, 1.5, 14.0, 0.05)
    assert np.allclose(later[0, :2, 3], [0.0, 1.6], atol=1e-6)


def test_renderer_and_rows():
    spec, cam = scene.SceneSpec(), scene.CameraSpec(**SMALL)
    poses = scene.walk_poses(6, 210.0, 400.0, 560, 1.6, 1.5, 14.0, 0.05)
    ours = scene.BatchRenderer(cam, spec, "cpu")(torch.as_tensor(poses), stats=True)
    theirs = synth.BatchRenderer(synth.CameraSpec(**SMALL), synth.SceneSpec(), "cpu")(torch.as_tensor(poses),
                                                                                       stats=True)
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)
    frames, counts, sums = scene.render_uint8(scene.BatchRenderer(cam, spec, "cpu"), poses, stats=True)
    ref = synth.render_uint8(synth.make_batch_renderer(synth.CameraSpec(**SMALL), synth.SceneSpec(), "cpu"),
                             poses, stats=True)
    assert torch.equal(frames, ref[0])
    np.testing.assert_array_equal(counts, ref[1])
    np.testing.assert_array_equal(sums, ref[2])
    for f in range(len(poses)):
        assert scene.plane_rows_for_frame(poses[f], counts[f], sums[f], spec, min_pix=50) == \
            synth.plane_rows_for_frame(poses[f], counts[f], sums[f], synth.SceneSpec(), min_pix=50)
        assert scene.cuboid_lines_for_frame(poses[f], counts[f], spec, min_pix=20) == \
            synth.cuboid_lines_for_frame(poses[f], counts[f], synth.SceneSpec(), min_pix=20)


def test_detections_as_mono_icl_reads_them():
    """The harness's rows parsed by the port equal the port's own
    ``frame_detections`` at the golden camera."""
    spec, cam = scene.SceneSpec(), scene.CameraSpec()
    poses = scene.walk_poses(3, 120.0, 400.0, 560, 1.6, 1.5, 14.0, 0.05)
    _, counts, sums = scene.render_uint8(scene.BatchRenderer(cam, spec, "cpu"), poses, stats=True)
    config = {"caps": {"max_planes_per_frame": 16, "max_cuboids_per_frame": 8},
              "camera": {"fx": cam.fx, "fy": cam.fy, "cx": cam.cx, "cy": cam.cy}}
    for f in range(len(poses)):
        rows, lines = scene.detection_rows(poses[f], counts[f], sums[f], spec)
        ours = program.detections(config, rows, lines, poses[f])
        theirs = synth.frame_detections(poses[f], counts[f], sums[f], synth.SceneSpec(), synth.CameraSpec(), 16, 8)
        for a, b in zip(ours, theirs):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        assert ours[0].valid.any()


def test_umeyama_and_ate():
    rng = np.random.default_rng(5)
    src = rng.normal(size=(20, 3))
    dst = 1.7 * src @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + rng.normal(size=3) + 0.01 * rng.normal(size=(20, 3))
    for scale in (True, False):
        for a, b in zip(geometry.umeyama_alignment(src, dst, scale), trajectory.umeyama_alignment(src, dst, scale)):
            np.testing.assert_array_equal(a, b)
    est = [np.linalg.inv(T) for T in scene.walk_poses(12, 0.0, 400.0, 560, 1.6, 1.5, 14.0, 0.05)]
    gt = [T @ np.diag([1, 1, 1, 1.0]) + np.pad(rng.normal(scale=0.01, size=(3, 1)), ((0, 1), (3, 0))) for T in est]
    a, b = geometry.ate_rmse(est, gt), trajectory.ate_rmse(est, gt)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])


def test_pose_alignment_recovers_a_similarity():
    gt = [np.linalg.inv(T).astype(np.float64) for T in scene.walk_poses(8, 0.0, 400.0, 560, 1.6, 1.5, 14.0, 0.05)]
    th = 0.7
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    s, t = 0.4, np.array([0.3, -1.0, 2.0])
    # X_est = (R^T (X_gt - t)) / s, so est_cw = gt_cw composed with that map's inverse
    est = []
    for T in gt:
        A = np.eye(4)
        A[:3, :3], A[:3, 3] = T[:3, :3] @ R, (T[:3, :3] @ t + T[:3, 3]) / s
        est.append(A)
    s2, R2, t2 = geometry.pose_alignment(est, gt)
    assert s2 == pytest.approx(s) and np.allclose(R2, R) and np.allclose(t2, t)
    assert geometry.rotation_drift_deg(est, gt).max() < 1e-6


def test_rpe_leaves_out_the_pairs_it_is_told_to():
    gt = [np.linalg.inv(T).astype(np.float64) for T in scene.walk_poses(5, 0.0, 400.0, 560, 1.6, 1.5, 14.0, 0.05)]
    est = [T.copy() for T in gt]
    th = np.radians(2.0)
    turn = np.array([[np.cos(th), 0, np.sin(th), 0], [0, 1, 0, 0], [-np.sin(th), 0, np.cos(th), 0], [0, 0, 0, 1]])
    est[2] = turn @ est[2]
    assert geometry.rpe_rot_deg(est, gt) == pytest.approx([0, 2, 2, 0], abs=1e-4)
    assert geometry.rpe_rot_deg(est, gt, skip={1}) == pytest.approx([0, 0, 2, 0], abs=1e-4)


def test_rpe_direction_is_scale_free_and_reads_180_for_a_pose_that_stops():
    gt = [np.linalg.inv(T) for T in scene.walk_poses(5, 30.0, 400.0, 560, 1.6, 1.5, 14.0, 0.05).astype(np.float64)]
    scaled = [T.copy() for T in gt]
    for T in scaled:
        T[:3, 3] *= 3.7
    assert geometry.rpe_dir_deg(scaled, gt) == pytest.approx([0, 0, 0, 0], abs=1e-4)
    frozen = [gt[0], gt[1], gt[1], gt[3], gt[4]]
    out = geometry.rpe_dir_deg(frozen, gt)
    assert out[1] == 180.0 and out[3] == pytest.approx(0.0, abs=1e-4)


def test_hamming_reference_matches_the_port_plain_search():
    from slambench.reference import hamming
    from tpuslam_torch.kernels.cuda_match import hamming_top2_plain

    rng = np.random.default_rng(0)
    a = rng.integers(-2**31, 2**31, (300, 8), dtype=np.int64).astype(np.int32)
    b = rng.integers(-2**31, 2**31, (500, 8), dtype=np.int64).astype(np.int32)
    b[7] = b[9] = a[3]  # a tie at distance 0: the first wins, d2 == d1
    valid = rng.random(500) > 0.3
    valid[[7, 9]] = True
    valid[11] = False
    b[11] = a[4]  # an invalid exact match is not found
    i, d1, d2 = (t.numpy() for t in hamming_top2_plain(torch.from_numpy(a), torch.from_numpy(b),
                                                         torch.from_numpy(valid)))
    ri, rd1, rd2 = hamming.hamming_top2(a, b, valid)
    assert (i == ri).all() and (d1 == rd1).all() and (d2 == rd2).all()
    assert (ri[3], rd1[3], rd2[3]) == (7, 0.0, 0.0) and ri[4] != 11
    sample = {"desc_a": a, "desc_b": b, "valid_b": valid, "idx": i, "d1": d1, "d2": d2}
    assert hamming.mismatched_rows(sample) == 0
    assert hamming.mismatched_rows({**sample, "d1": d2}) == int((d1 != d2).sum()) > 0


@pytest.mark.parametrize("completed", [True, False])
def test_a_session_without_poses(completed):
    """A whole clip that never initialized fails its pose numbers and its
    map's; a session the window cut before its first pose has no pose to
    judge."""
    from slambench.reference import checks

    res = {"trajectory": [], "kf_valid": np.zeros(4, bool), "kf_pose": np.tile(np.eye(4), (4, 1, 1)),
           "kf_frame_id": np.zeros(4, np.int32), "completed": completed}
    out = checks.pose_numbers(res, np.tile(np.eye(4), (60, 1, 1)))
    assert out == ({"rot": [np.inf], "dir": [np.inf], "max": np.inf} if completed else
                   {"rot": [], "dir": [], "max": 0.0})
    cfg = {"detections": "offline"}
    assert checks.map_numbers(res, np.tile(np.eye(4), (60, 1, 1)), cfg, scene.SceneSpec()) == {
        k: np.inf for k in checks.map_keys(cfg)}


def _trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "fast_nms_kernel(float const*)", "ts": 20, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 40, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 90, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 62, "dur": 30},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 63, "dur": 28},
        {"ph": "i", "name": "marker", "ts": 5},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return path


def test_trace_reduction_matches_chip_smoke(tmp_path):
    import chip_smoke

    path = _trace(tmp_path)
    ref = chip_smoke.trace_summary(str(path))
    got = tracing.summarize(str(path))
    assert got["busy_s"] * 1e3 == pytest.approx(ref["device_busy_ms"])
    assert got["window_s"] * 1e3 == pytest.approx(ref["window_ms"])
    assert got["kernel_launches"] == ref["kernel_launches"] and got["api_calls"] == ref["api_calls"]
    assert got["busy_s"] == pytest.approx(45e-6)
    # the gap 60-90 us is spanned by aten::item and, innermost, the sync
    assert got["idle_gaps"][0] == ["cudaStreamSynchronize", pytest.approx(30e-6)]
    assert tracing.kernel_call_s(got, "fast_nms_kernel") == (pytest.approx(30e-6), 1)
    assert tracing.kernel_call_s(got, "hamming_top2_kernel") is None


def test_roofline_counts_match_the_kernel_table():
    import chip_smoke

    config = json.load(open("slambench/configs/icl_mono_points.json"))
    dims = torch.tensor(keypoints.level_dims(480, 640, 8, 1.2), dtype=torch.int32)
    live_px = int((dims[:, 0] * dims[:, 1]).sum())
    k1_ms = (live_px + 8 * 480 * 640) * 4 / chip_smoke.HBM_BYTES_PER_MS
    assert roofline.k1_bound_s(config) * 1e3 == pytest.approx(k1_ms, rel=1e-12)
    assert roofline.k1_bound_s(config) * 1e6 == pytest.approx(4.07, abs=0.01)  # PERF.md's kernel table
    n = m = 1024
    k2_ms = max(2 * n * m * 256 / chip_smoke.INT8_OPS_PER_MS, (n * 32 + m * 33 + n * 12) / chip_smoke.HBM_BYTES_PER_MS)
    assert roofline.k2_bound_s(config) * 1e3 == pytest.approx(k2_ms, rel=1e-12)
    assert roofline.k2_bound_s(config) * 1e6 == pytest.approx(0.271, abs=0.001)


def test_keypoint_reference_against_the_port_extractor():
    """The plain selection equals the port's extractor at level 0 and
    nearly so below it (float64 against float32 resizes)."""
    from tpuslam_torch.core.camera import Camera
    from tpuslam_torch.frontend.tracking import frame_from_features
    from tpuslam_torch.kernels.orb import OrbExtractor

    cam = scene.CameraSpec()
    poses = scene.walk_poses(2, 300.0, 400.0, 560, 1.6, 1.5, 14.0, 0.05)
    frames = scene.render_uint8(scene.BatchRenderer(cam, scene.SceneSpec(), "cpu"), poses)
    ext = OrbExtractor(480, 640, "cpu", n_features=1024)
    pcam = Camera.make(cam.fx, cam.fy, cam.cx, cam.cy, "cpu")
    for img in frames:
        f = frame_from_features(ext(img.to(torch.float32)), pcam)
        got = keypoints.keypoint_rows(f.uv, f.octave, f.valid, 1.2, 8)
        want = keypoints.select_keypoints(img, 1024, 8, 1.2, 20.0, 7.0).numpy()
        n, per = keypoints.mismatch(got, want)
        assert per[0][0] == 0 and per[0][1] > 100
        assert n <= 0.02 * len(want)
        assert len(want) > 900
