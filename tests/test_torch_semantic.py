"""Parity of the port's semantic front end with the JAX package, on the CPU:
the offline detections (``io/synth.py`` rows from the renderer's counts,
``semantic/detect.py`` parsing), plane and cuboid association
(``semantic/associate.py``), ``rescale_map`` and the ``Tracker``'s metric
rescale, on the 320x240 golden scene and the small JAX-built map of
``tests/_torch_scene.py``.

The reference's detections are written to files with ``write_sequence``'s
formatting and read back with ``read_offline_planes`` /
``read_offline_cuboids``; the port's are made in memory from its renderer's
per-primitive counts and face sums.  Tolerances: pixel counts, plane
coefficients and every cuboid field equal (the same float32 numpy on the
same parsed text); plane centroids 1e-4 m (a float64 device sum against a
float32 numpy mean; nothing reads them); association results equal, map
planes to 1e-6; the metric scale rtol 1e-5 (the vote reads points
transformed on the device).  Class ids come from a process-wide dict in
each package, so they are compared by pattern (equal / not equal).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_scene as sc
from tpuslam.core import geometry as jgeo
from tpuslam.core.config import FeatureFlags, OrbConfig, SemanticConfig, SlamConfig
from tpuslam.frontend import tracking as jtr
from tpuslam.io import synth as jsynth
from tpuslam.map import mapstate as jms
from tpuslam.semantic import associate as jas
from tpuslam.semantic import detect as jdet
from tpuslam_torch.core import config as tcfg
from tpuslam_torch.core.camera import Camera
from tpuslam_torch.frontend import tracking as ttr
from tpuslam_torch.io import synth as tsynth
from tpuslam_torch.map import mapstate as tms
from tpuslam_torch.semantic import associate as tas
from tpuslam_torch.semantic import detect as tdet

DET_FRAMES = (0, 8, 72, 80)  # 2-3 faces each; the table, then the table and the sofa
L, O = 16, 8
T_CSPEC = tsynth.CameraSpec(**sc.CSPEC.__dict__)


@functools.lru_cache(maxsize=None)
def _oracle(fid):
    return jsynth.render_frame(sc.poses_wc()[fid], sc.CSPEC, jsynth.SceneSpec())


def _reference_dets(fid, folder):
    """The reference's path: rows as write_sequence writes them, read back
    as mono_icl reads them (GT pose: the frame's float32 camera-to-world)."""
    T_wc = sc.poses_wc()[fid]
    _, _, prim_id, p_cam = _oracle(fid)
    spec = jsynth.SceneSpec()
    pp, cp = folder / f"{fid}_planes.txt", folder / f"{fid:04d}_cuboids.txt"
    with open(pp, "w") as fh:
        for r in jsynth._plane_rows_for_frame(T_wc, prim_id, p_cam, spec, 1500):
            fh.write(" ".join(f"{x:.9f}" for x in r) + "\n")
    lines = jsynth._cuboid_lines_for_frame(T_wc, prim_id, spec, 400)
    with open(cp, "w") as fh:
        fh.write("\n".join(lines) + ("\n" if lines else ""))
    K = np.asarray(sc.jax_camera().K)
    return jdet.read_offline_planes(str(pp), L), jdet.read_offline_cuboids(str(cp), T_wc, K, O)


@functools.lru_cache(maxsize=None)
def _port_render():
    renderer = tsynth.make_batch_renderer(T_CSPEC, tsynth.SceneSpec(), "cpu")
    return tsynth.render_uint8(renderer, sc.poses_wc()[list(DET_FRAMES)], chunk=4, stats=True)


def _port_dets(i):
    _, counts, sums = _port_render()
    return tsynth.frame_detections(sc.poses_wc()[DET_FRAMES[i]], counts[i], sums[i], tsynth.SceneSpec(),
                                   T_CSPEC, L, O)


def _same_pattern(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(a[:, None] == a[None, :], b[:, None] == b[None, :])


def test_detections_match_reference_files(tmp_path):
    ref_cls, got_cls = [], []
    for i, fid in enumerate(DET_FRAMES):
        _, counts, _ = _port_render()
        prim_id = _oracle(fid)[2].reshape(-1)
        np.testing.assert_array_equal(counts[i], np.bincount(prim_id[prim_id >= 0], minlength=12))
        rp, rc = _reference_dets(fid, tmp_path)
        gp, gc = _port_dets(i)
        np.testing.assert_array_equal(gp.coef, rp.coef)
        np.testing.assert_array_equal(gp.valid, rp.valid)
        np.testing.assert_allclose(gp.centroid, rp.centroid, atol=1e-4, rtol=0)
        for k in ("local_pose", "local_scale", "global_pose", "global_scale", "bbox", "corners", "quality",
                  "valid"):
            np.testing.assert_array_equal(getattr(gc, k), getattr(rc, k), err_msg=k)
        ref_cls += list(rc.classid[rc.valid])
        got_cls += list(gc.classid[gc.valid])
        assert rp.valid.sum() >= 2 and rc.valid.sum() >= 1
    assert len(set(ref_cls)) == 2  # the table and the sofa
    _same_pattern(got_cls, ref_cls)


def _scene_map():
    return sc.jax_map()


def _port_plane_det(d):
    return tdet.PlaneDetections(*(np.array(x) for x in d))


def test_associate_planes_matches_reference(tmp_path):
    m_j = _scene_map()
    m_t = tms.map_from_numpy(sc.map_fields(m_j), "cpu")
    n_j = n_t = 0
    for slot in (2, 4, 0, 3):  # frame 0 sees a wall that 16 and 32 do not
        det, _ = _reference_dets(sc.KF_FRAMES[slot], tmp_path)
        m_j, n_j = jas.associate_planes(m_j, slot, det, n_j)
        m_t, n_t = tas.associate_planes(m_t, slot, _port_plane_det(det), n_t)
        assert n_t == n_j
    np.testing.assert_allclose(m_t.plane_coef.numpy(), np.asarray(m_j.plane_coef), atol=1e-6, rtol=0)
    for k in ("plane_valid", "plane_obs_count", "kf_plane_coef", "kf_plane_valid", "kf_plane_map",
              "kf_plane_ver", "kf_plane_par"):
        np.testing.assert_array_equal(getattr(m_t, k).numpy(), np.asarray(getattr(m_j, k)), err_msg=k)
    kf_map = np.asarray(m_j.kf_plane_map)
    assert n_j >= 3 and (kf_map >= 0).sum() > n_j  # later keyframes matched existing planes
    assert (np.asarray(m_j.kf_plane_ver) >= 0).any()  # a new wall found vertical to a known plane


def _strip_dets(slot, names, det_id):
    """Detections whose bboxes are vertical strips of the image, 107 px
    apart and 105 wide, one per name, with the table's global cuboid;
    (reference detections, port detections)."""
    T_wc = sc.poses_wc()[sc.KF_FRAMES[slot]]
    line = "table 0.500000 2.300000 0.350000 0 0 -0.300000 0.450000 0.300000 0.350000"
    base = tdet.cuboids_from_lines(*tdet.parse_obj_lines([line] * len(names)), T_wc, np.asarray(sc.jax_camera().K), O)
    fields = {k: np.array(v) for k, v in base._asdict().items()}
    for i in range(len(names)):
        fields["bbox"][i] = [107 * i + 52.5, 119.5, 105.0, 240.0]
    ref = jdet.CuboidDetections(**{**fields, "classid": fields["classid"].copy()})
    got = tdet.CuboidDetections(**{**fields, "classid": fields["classid"].copy()})
    for i, n in enumerate(names):
        ref.classid[i] = jdet.classname_to_id(f"{n}_{det_id}")
        got.classid[i] = tdet.classname_to_id(f"{n}_{det_id}")
    return ref, got


def _cfgs(classname, cull_after=15):
    sem = dict(cuboid_min_own_points=5, cuboid_cull_after_kfs=cull_after)
    j = SlamConfig().replace(caps=sc.CAPS, semantic=SemanticConfig(**sem),
                             flags=FeatureFlags(associate_cuboid_with_classname=classname))
    t = tcfg.SlamConfig().replace(caps=tcfg.Capacities(**sc.CAPS.__dict__), semantic=tcfg.SemanticConfig(**sem),
                                  flags=tcfg.FeatureFlags(associate_cuboid_with_classname=classname))
    return j, t


def test_associate_cuboids_matches_reference():
    """Three keyframes: voting (two new chairs), class names (the first of
    the two tied chairs wins; a table is new; one point is bound to
    keypoints in two strips, so its owner is written twice and the later
    keypoint wins), voting again with the outlier cull."""
    m_j = _scene_map()
    kf_pt = np.array(m_j.kf_pt)
    row = kf_pt[3]
    uv = np.asarray(m_j.kf_uv[3])
    bound = np.flatnonzero(row >= 0)
    left = bound[uv[bound, 0] < 105][0]
    right = bound[(uv[bound, 0] > 107) & (uv[bound, 0] < 212)][-1]
    row[right] = row[left]  # one point, two keypoints, two strips
    m_j = m_j._replace(kf_pt=jnp.asarray(kf_pt))
    m_t = tms.map_from_numpy(sc.map_fields(m_j), "cpu")
    n_j = n_t = 0
    for slot, names, classname, cull in ((2, ["chair", "chair"], False, 15), (3, ["chair", "table"], True, 15),
                                          (4, ["a", "b", "c"], False, 1)):
        det_r, det_t = _strip_dets(slot, names, 0)
        cj, ct = _cfgs(classname, cull)
        m_j, n_j = jas.associate_cuboids(m_j, slot, det_r, m_j.kf_pt[slot], n_j, cj)
        m_t, n_t = tas.associate_cuboids(m_t, slot, det_t, m_t.kf_pt[slot], n_t, ct)
        assert n_t == n_j
        if slot == 3:  # the point of two keypoints goes to the later keypoint's landmark
            owner = 2 if right > left else 0
            assert int(m_t.pt_cub[row[left]]) == owner == int(np.asarray(m_j.pt_cub)[row[left]])
    for k in ("cub_pose", "cub_scale", "cub_valid", "cub_obs_count", "cub_first_kf", "cub_last_kf", "cub_good",
              "kf_cub_local_pose", "kf_cub_local_scale", "kf_cub_bbox", "kf_cub_corners", "kf_cub_quality",
              "kf_cub_valid", "kf_cub_map", "kf_kp_cub", "pt_cub", "pt_cub_votes"):
        np.testing.assert_array_equal(getattr(m_t, k).numpy(), np.asarray(getattr(m_j, k)), err_msg=k)
    _same_pattern(m_t.cub_class.numpy(), np.asarray(m_j.cub_class))
    kf_map = np.asarray(m_j.kf_cub_map)
    assert kf_map[3, 0] == 0 and kf_map[3, 1] == 2  # the tie went to the first chair; the table is new
    assert not np.asarray(m_j.cub_valid)[1]  # the second chair was culled
    np.testing.assert_array_equal(tas.cuboid_plane_pairs(m_t).numpy(), np.asarray(jas.cuboid_plane_pairs(m_j)))


def test_rescale_map_matches_reference():
    m_j = _scene_map()
    m_t = tms.map_from_numpy(sc.map_fields(m_j), "cpu")
    ref = jms.rescale_map(m_j, jnp.float32(1.7321))
    got = tms.map_to_numpy(tms.rescale_map(m_t, 1.7321))
    for k in tms.FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(ref, k)), err_msg=k)


def _trackers(scale):
    flags = dict(enable_loop_closing=False, enable_ground_height_scale=True, detect_plane=True)
    cj = SlamConfig().replace(caps=sc.CAPS, orb=OrbConfig(n_features=sc.N_FEAT), flags=FeatureFlags(**flags))
    ct = tcfg.SlamConfig().replace(caps=tcfg.Capacities(**sc.CAPS.__dict__), orb=tcfg.OrbConfig(n_features=sc.N_FEAT),
                                   flags=tcfg.FeatureFlags(**flags))
    c = sc.CSPEC
    tcam = Camera.make(c.fx, c.fy, c.cx, c.cy, "cpu", width=c.width, height=c.height, bf=c.fx * c.baseline)
    tj = jtr.Tracker(sc.jax_camera(), cj)
    tt = ttr.Tracker(tcam, ct, device="cpu")
    # the points of keyframe RESCALE_SLOT moved onto the rendered surfaces
    # (its keypoints back-projected with the true depth), so that enough of
    # them vote; then the map at `scale` x metric, as a mono map is
    m = _scene_map()
    fid, row = sc.KF_FRAMES[RESCALE_SLOT], np.asarray(m.kf_pt[RESCALE_SLOT])
    uv = np.asarray(m.kf_uv[RESCALE_SLOT])[row >= 0]
    depth = _oracle(fid)[1][np.rint(uv[:, 1]).astype(int), np.rint(uv[:, 0]).astype(int)]
    p_cam = depth[:, None] * np.stack([(uv[:, 0] - c.cx) / c.fx, (uv[:, 1] - c.cy) / c.fy, np.ones(len(uv))], 1)
    T_wc = sc.poses_wc()[fid].astype(np.float64)
    pos = np.array(m.pt_pos)
    pos[row[row >= 0]] = (p_cam @ T_wc[:3, :3].T + T_wc[:3, 3]).astype(np.float32)
    m = jms.rescale_map(m._replace(pt_pos=jnp.asarray(pos)), jnp.float32(scale))
    tj.map = m
    tt.map = tms.map_from_numpy(sc.map_fields(m), "cpu")
    vel = np.eye(4, dtype=np.float32)
    vel[:3, 3] = [0.01, -0.02, 0.03]
    for t in (tj, tt):
        t.T_cur = np.array(m.kf_pose[RESCALE_SLOT])
        t.velocity = vel.copy()
    return tj, tt


RESCALE_SLOT = 2


def test_metric_rescale_matches_reference_and_leaves_the_in_flight_frame_mirrored_reference_fault(tmp_path):
    """``_update_metric_scale`` on a map at 0.4x metric: the same vote s
    (about 2.5), the same rescaled map, pose and velocity.  The frame in
    flight in the pipeline (``_dev_T`` / ``_dev_vel``, dispatched on the
    old map) is left as it was, in the port as in the reference, which has
    no guard for the pipeline: a mirrored reference fault."""
    tj, tt = _trackers(0.4)
    det, _ = _reference_dets(sc.KF_FRAMES[RESCALE_SLOT], tmp_path)
    in_flight = (torch.eye(4), torch.eye(4))
    tj._dev_T, tj._dev_vel = in_flight
    tt._dev_T, tt._dev_vel = in_flight
    tj._update_metric_scale(RESCALE_SLOT, det)
    tt._update_metric_scale(RESCALE_SLOT, _port_plane_det(det))
    s = tj.dbg["metric_s"]
    assert 2.2 < s < 2.8 and tt.n_rescales == 1 and tt._metric_anchored and tj._metric_anchored
    np.testing.assert_allclose(tt.dbg["metric_s"], s, rtol=1e-5)
    for k in ("kf_pose", "pt_pos", "plane_coef", "cub_pose", "cub_scale", "pt_min_dist", "pt_max_dist"):
        np.testing.assert_allclose(getattr(tt.map, k).numpy(), np.asarray(getattr(tj.map, k)), rtol=2e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(tt.T_cur, np.asarray(tj.T_cur), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(tt.velocity, np.asarray(tj.velocity), rtol=2e-5, atol=1e-7)
    assert tt._dev_T is in_flight[0] and tt._dev_vel is in_flight[1]
    assert tj._dev_T is in_flight[0] and tj._dev_vel is in_flight[1]


def test_plane_association_ties_go_to_the_first_plane_as_in_the_reference(tmp_path):
    """Two identical map planes tie on the direct match: argmin takes the
    first index in both packages (``jnp.argmin`` and ``torch.argmin`` both
    document it).  Two more, parallel but 5 m off, tie on the parallel
    relation, which the direct match supersedes."""
    det, _ = _reference_dets(sc.KF_FRAMES[2], tmp_path)
    m_j = _scene_map()
    world = np.asarray(jgeo.plane_transform(jgeo.se3_inv(m_j.kf_pose[2]), jnp.asarray(det.coef)))
    Q = m_j.plane_coef.shape[0]
    coef = np.tile(np.array([[0.0, 0.0, 1.0, 1.0]], np.float32), (Q, 1))
    valid = np.zeros(Q, bool)
    coef[3] = coef[5] = world[0]  # the first detection's plane, twice
    coef[7] = coef[9] = world[0] * np.array([1, 1, 1, 0], np.float32) + np.array([0, 0, 0, 5], np.float32)
    valid[[3, 5, 7, 9]] = True
    m_j = m_j._replace(plane_coef=jnp.asarray(coef), plane_valid=jnp.asarray(valid))
    m_t = tms.map_from_numpy(sc.map_fields(m_j), "cpu")
    ref = jas.plane_association_scores(m_j, m_j.kf_pose[2], det)
    got = tas.plane_association_scores(m_t, m_t.kf_pose[2], torch.from_numpy(det.coef), torch.from_numpy(det.valid))
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(ref[1][0]) == 3 and int(ref[3][0]) == -1  # the first tied plane; no parallel relation
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-6)

