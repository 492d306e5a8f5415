"""Parity of the port's heterogeneous bundle adjustment with the JAX package,
on the CPU: ``pack_local_ba`` with planes and cuboids (backend/local_ba.py),
``build_system`` with all six plane and cuboid bundles valid, the two-phase
``local_ba`` and ``unpack_local_ba``'s write-back of planes, cuboids, poses
and points (graph/lm.py).

The map: the small JAX-built map of ``tests/_torch_scene.py`` with its
planes associated from the offline plane detections of its five keyframes,
and one box on the floor in front of the cameras, made from a cuboid row
(the scene's own objects lie across the image borders, outside the 5 px
field-of-view gate of the bbox factors) and associated by class name; then
points moved ~2 cm, keyframes 1-4 ~1 cm and ~0.3 degrees, planes tilted
~0.05 rad (off the pole of ``plane_rotation``, where a derivative of
atan2(~1e-8, ~1e-8) is all rounding), and the box moved 3 cm.

Tolerances: the packed problem exact; the normal equations rtol 2e-3 with
an absolute floor of 2e-3 of their largest entry (forward-mode Jacobians in
float32, summed in another order); chi2 rtol 1e-3.  After the solve, as in
tests/test_torch_ba.py: gated masks equal, poses 2e-3 (one fixed keyframe,
the scale free), points compared by their projections (0.01 px), planes
3e-3, cuboid poses and scales 3e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

import _torch_scene as sc
from tpuslam.backend import local_ba as jba
from tpuslam.core import geometry as jgeo
from tpuslam.core.config import BAConfig, FeatureFlags, SemanticConfig, SlamConfig
from tpuslam.graph import factors as jfac
from tpuslam.graph import lm as jlm
from tpuslam.semantic import associate as jas
from tpuslam.semantic import detect as jdet
from tpuslam_torch.backend import local_ba as tba
from tpuslam_torch.core import config as tcfg
from tpuslam_torch.core.camera import Camera
from tpuslam_torch.graph import lm as tlm
from tpuslam_torch.map import mapstate as tms

ALL_FLAGS = dict(use_planes=True, use_cub_2d=True, use_corners_2d=True, use_cub_3d=True, use_pt_obj=True,
                 use_cub_plane=True)
BOX_DIST = 2.6  # m in front of keyframe 2's camera, on the floor
BUNDLES = ("plane_obs", "cub_bbox", "cub_corner", "cub_se3", "pt_cub", "cub_plane")


def _tcam():
    c = sc.CSPEC
    return Camera.make(c.fx, c.fy, c.cx, c.cy, "cpu", width=c.width, height=c.height, bf=c.fx * c.baseline)


def _box_line():
    T_wc = sc.poses_wc()[sc.KF_FRAMES[2]]
    fwd = T_wc[:3, 2].astype(np.float64)
    fwd[2] = 0.0
    x, y = T_wc[:2, 3] + BOX_DIST * fwd[:2] / np.linalg.norm(fwd[:2])
    return f"box {x:.6f} {y:.6f} 0.150000 0 0 0.300000 0.200000 0.200000 0.150000"


@functools.lru_cache(maxsize=None)
def _semantic_map():
    from tpuslam.io import synth as jsynth

    m = sc.jax_map()
    spec = jsynth.SceneSpec()
    K = np.asarray(sc.jax_camera().K)
    cfg = SlamConfig().replace(caps=sc.CAPS, semantic=SemanticConfig(cuboid_min_own_points=3),
                               flags=FeatureFlags(associate_cuboid_with_classname=True))
    n_pl = n_cub = 0
    import tempfile
    import pathlib

    folder = pathlib.Path(tempfile.mkdtemp())
    for slot, fid in enumerate(sc.KF_FRAMES):
        T_wc = sc.poses_wc()[fid]
        _, _, prim_id, p_cam = jsynth.render_frame(T_wc, sc.CSPEC, spec)
        pp = folder / f"{fid}_planes.txt"
        with open(pp, "w") as fh:
            for r in jsynth._plane_rows_for_frame(T_wc, prim_id, p_cam, spec, 1500):
                fh.write(" ".join(f"{x:.9f}" for x in r) + "\n")
        m, n_pl = jas.associate_planes(m, slot, jdet.read_offline_planes(str(pp), sc.CAPS.max_planes_per_frame),
                                       n_pl)
        if slot >= 1:
            cp = folder / f"{fid:04d}_cuboids.txt"
            cp.write_text(_box_line() + "\n")
            det = jdet.read_offline_cuboids(str(cp), T_wc, K, sc.CAPS.max_cuboids_per_frame)
            m, n_cub = jas.associate_cuboids(m, slot, det, m.kf_pt[slot], n_cub, cfg)
    assert n_pl >= 3 and n_cub == 1
    # the disturbance
    rng = np.random.RandomState(3)
    pos = np.asarray(m.pt_pos) + rng.normal(0, 0.02, m.pt_pos.shape).astype(np.float32)
    poses = np.array(m.kf_pose)
    for k in range(1, 5):
        d = np.concatenate([rng.normal(0, 0.005, 3), rng.normal(0, 0.01, 3)]).astype(np.float32)
        poses[k] = np.asarray(jgeo.se3_exp(jnp.asarray(d)) @ poses[k])
    dq = np.zeros((m.plane_coef.shape[0], 3), np.float32)
    dq[:n_pl] = rng.normal(0, 0.05, (n_pl, 3))
    planes = np.asarray(jnp.stack([jfac.retract_plane(c, d) for c, d in zip(m.plane_coef, jnp.asarray(dq))]))
    cub_pose = np.array(m.cub_pose)
    cub_pose[0, :3, 3] += np.float32(0.03)
    return m._replace(pt_pos=jnp.asarray(pos), kf_pose=jnp.asarray(poses), plane_coef=jnp.asarray(planes),
                      cub_pose=jnp.asarray(cub_pose))


def _pack_j(flags, center=4):
    return jba.pack_local_ba(_semantic_map(), jnp.int32(center), sc.jax_camera(), n_opt=4, n_fixed=4,
                             n_local_pts=1024, **flags)


def _pack_t(flags, center=4):
    m = tms.map_from_numpy(sc.map_fields(_semantic_map()), "cpu")
    return tba.pack_local_ba(m, center, _tcam(), n_opt=4, n_fixed=4, n_local_pts=1024, **flags)


def _fields(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def test_pack_local_ba_with_planes_and_cuboids_matches_reference():
    ref, got = _pack_j(ALL_FLAGS), _pack_t(ALL_FLAGS)
    for k in tlm.BAState._fields:
        np.testing.assert_array_equal(getattr(got.state, k).numpy(), np.asarray(getattr(ref.state, k)), err_msg=k)
    for k in ("pose_fixed", "point_active", "plane_active", "cuboid_active"):
        np.testing.assert_array_equal(getattr(got.data, k).numpy(), np.asarray(getattr(ref.data, k)), err_msg=k)
    assert got.data.cuboid_fix_scale == ref.data.cuboid_fix_scale
    for b in BUNDLES:
        r, g = _fields(getattr(ref.data, b)), getattr(got.data, b)
        for k, v in r.items():
            np.testing.assert_array_equal(getattr(g, k).numpy(), v, err_msg=f"{b}.{k}")
        assert r["valid"].sum() >= 1, b  # every bundle has live factors
    assert int(np.asarray(ref.data.plane_active).sum()) >= 3 and bool(np.asarray(ref.data.cuboid_active)[0])


def _carry(pack):
    """The reference's packed problem as the port's (numpy round trip)."""
    st = tlm.ba_state_from_numpy(_fields(pack.state), "cpu")
    d = pack.data
    fields = {k: np.asarray(getattr(d, k)) for k in
              ("pose_fixed", "point_active", "plane_active", "cuboid_active", "fx", "fy", "cx", "cy", "bf")}
    for b in ("mono",) + BUNDLES:
        fields[b] = _fields(getattr(d, b))
    fields["cuboid_fix_scale"] = d.cuboid_fix_scale
    return st, tlm.ba_data_from_numpy(fields, "cpu")


def test_build_system_with_all_six_bundles_matches_reference():
    pack = _pack_j(ALL_FLAGS)
    w_j, w_t = jlm.BAWeights.from_config(BAConfig()), tlm.BAWeights.from_config(tcfg.BAConfig())
    st, d = _carry(pack)
    back = tlm.ba_data_from_numpy(tlm.ba_data_to_numpy(d), "cpu")
    for b in ("mono",) + BUNDLES:
        for k, v in getattr(d, b)._asdict().items():
            assert np.array_equal(getattr(getattr(back, b), k).numpy(), v.numpy()), (b, k)
    ref = jax.jit(jlm.build_system, static_argnames=("reproj_n",))(pack.state, pack.data, w_j, reproj_n=sc.N_FEAT)
    got = tlm.build_system(st, d, w_t)
    for name, g, r in zip(("H_cc", "H_cl", "H_ll", "b_c", "b_l", "chi2"), got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-3, atol=2e-3 * np.abs(r).max(), err_msg=name)
    np.testing.assert_allclose(float(tlm.total_chi2(st, d, w_t)),
                               float(jax.jit(jlm.total_chi2)(pack.state, pack.data, w_j)), rtol=1e-3)
    gated_r = jax.jit(jlm.gate_observations)(pack.state, pack.data, w_j)
    gated_g = tlm.gate_observations(st, d, w_t)
    for b in ("mono",) + BUNDLES:
        np.testing.assert_array_equal(getattr(gated_g, b).valid.numpy(), np.asarray(getattr(gated_r, b).valid),
                                      err_msg=b)
    D = 6 * 8 + 9 * sc.CAPS.max_cuboids + 3 * sc.CAPS.max_planes
    assert got[0].shape == (D, D)


def _assert_same_projections(poses_g, pts_g, poses_r, pts_r, kf, pt, tol=0.01):
    def proj(poses, pts):
        pc = np.einsum("fij,fj->fi", poses[kf, :3, :3], pts[pt]) + poses[kf, :3, 3]
        return np.stack([sc.CSPEC.fx * pc[:, 0] / pc[:, 2], sc.CSPEC.fy * pc[:, 1] / pc[:, 2]], 1)

    diff = np.abs(proj(np.asarray(poses_g), np.asarray(pts_g)) - proj(np.asarray(poses_r), np.asarray(pts_r)))
    assert diff.max() <= tol, diff.max()


def test_run_local_ba_with_planes_and_bbox_matches_reference():
    """The flagship's factor set (planes, 2D bboxes): pack -> two-phase
    solve -> unpack, the planes and the cuboid written back."""
    m = _semantic_map()
    flags = dict(optimize_with_plane_3d=True, optimize_with_cuboid_2d=True, enable_loop_closing=False)
    cfg_j = SlamConfig().replace(caps=sc.CAPS, flags=FeatureFlags(**flags))
    cfg_t = tcfg.SlamConfig().replace(caps=tcfg.Capacities(**sc.CAPS.__dict__), flags=tcfg.FeatureFlags(**flags))
    pack = _pack_j(ALL_FLAGS)  # its plane and bbox bundles are those of the flagship's flags
    assert int(pack.data.plane_obs.valid.sum()) >= 6 and int(pack.data.cub_bbox.valid.sum()) >= 2
    ref, c_ref = jba.run_local_ba(m, 4, sc.jax_camera(), cfg_j)
    stats = {}
    got, c_got = tba.run_local_ba(tms.map_from_numpy(sc.map_fields(m), "cpu"), 4, _tcam(), cfg_t, stats=stats)
    assert int(stats["plane_obs"]) == int(pack.data.plane_obs.valid.sum())
    assert int(stats["cub_bbox"]) == int(pack.data.cub_bbox.valid.sum())
    np.testing.assert_allclose(c_got.numpy(), np.asarray(c_ref), rtol=1e-3)
    np.testing.assert_array_equal(got.kf_pt.numpy(), np.asarray(ref.kf_pt))
    np.testing.assert_array_equal(got.pt_valid.numpy(), np.asarray(ref.pt_valid))
    np.testing.assert_allclose(got.kf_pose.numpy(), np.asarray(ref.kf_pose), atol=2e-3, rtol=0)
    np.testing.assert_allclose(got.plane_coef.numpy(), np.asarray(ref.plane_coef), atol=3e-3, rtol=0)
    np.testing.assert_allclose(got.cub_pose.numpy(), np.asarray(ref.cub_pose), atol=3e-3, rtol=0)
    np.testing.assert_allclose(got.cub_scale.numpy(), np.asarray(ref.cub_scale), atol=3e-3, rtol=0)
    kf_pt = np.asarray(ref.kf_pt)
    kf, kp = np.nonzero((kf_pt >= 0) & np.asarray(ref.kf_valid)[:, None])
    _assert_same_projections(got.kf_pose, got.pt_pos, ref.kf_pose, ref.pt_pos, kf, kf_pt[kf, kp])
    # the solve moved the planes and the box
    assert not np.allclose(np.asarray(ref.plane_coef), np.asarray(m.plane_coef), atol=1e-5)
    assert not np.allclose(np.asarray(ref.cub_pose), np.asarray(m.cub_pose), atol=1e-5)
