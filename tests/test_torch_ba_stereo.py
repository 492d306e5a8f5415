"""Parity of the port's stereo bundle with the JAX package, on the CPU: the
analytic stereo Jacobians (graph/factors.py), ``pack_local_ba`` with
``use_stereo``, ``build_system`` / ``total_chi2`` / ``gate_observations``
with both reprojection bundles, ``unpack_local_ba`` with ``stereo_shared``
and ``run_local_ba`` (pack, the two-phase solve, write-back) for the depth
sensors (backend/local_ba.py, graph/lm.py).

The map: the small JAX-built map of ``tests/_torch_scene.py`` with a right
coordinate ``ur = u - bf / z`` (the RGB-D virtual right view, z the point's
true depth in the keyframe) on two of every three bound keypoints, the rest
left mono; then points moved ~2 cm, keyframes 1-4 ~1 cm and ~0.3 degrees,
and 8 stereo and 8 mono observations moved 25 px (BA outliers).

Tolerances, as in tests/test_torch_ba.py: Jacobians rtol 1e-4 / atol 1e-3;
the packed problem exact (inverse sigmas to 1 ulp); the normal equations
rtol 2e-3 with a floor of 2e-3 of their largest entry, chi2 rtol 1e-3;
after the solve gated masks and unlinked observations equal, poses within
2e-3 and points compared by their projections (0.01 px).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_scene as sc
from tpuslam.backend import local_ba as jba
from tpuslam.core import geometry as jgeo
from tpuslam.core.config import BAConfig, FeatureFlags, SlamConfig
from tpuslam.graph import factors as jfac
from tpuslam.graph import lm as jlm
from tpuslam_torch.backend import local_ba as tba
from tpuslam_torch.core import config as tcfg
from tpuslam_torch.core.camera import Camera
from tpuslam_torch.graph import factors as tfac
from tpuslam_torch.graph import lm as tlm
from tpuslam_torch.map import mapstate as tms

C = sc.CSPEC
BF = C.fx * C.baseline


def _tcam():
    return Camera.make(C.fx, C.fy, C.cx, C.cy, "cpu", width=C.width, height=C.height, bf=BF)


def test_stereo_jacobians_match_linearize():
    rng = np.random.RandomState(0)
    n = 200
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1, 1, n), rng.uniform(1, 6, n)], 1).astype(np.float32)
    Ts = np.array(jax.vmap(jgeo.se3_exp)(jnp.asarray(rng.normal(0, 0.2, (n, 6)).astype(np.float32))))
    uvr = rng.uniform([0, 0, -20], [320, 240, 300], (n, 3)).astype(np.float32)

    def lin(T, Xp, u):
        return jfac.linearize(jfac.stereo_residual, ((jfac.retract_pose, 6), (jfac.retract_point, 3)),
                              (T, Xp), u, C.fx, C.fy, C.cx, C.cy, BF)

    r_ref, (Jp_ref, Jx_ref) = jax.jit(jax.vmap(lin))(jnp.asarray(Ts), jnp.asarray(X), jnp.asarray(uvr))
    T_t, X_t = torch.from_numpy(Ts), torch.from_numpy(X)
    Jp, Jx = tfac.stereo_jacobians(T_t, X_t, C.fx, C.fy, BF)
    r = tfac.stereo_residual(T_t, X_t, torch.from_numpy(uvr), C.fx, C.fy, C.cx, C.cy, BF)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(Jp.numpy(), np.asarray(Jp_ref), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(Jx.numpy(), np.asarray(Jx_ref), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(tfac.stereo_jacobian(T_t, X_t, C.fx, C.fy, BF).numpy(), Jp.numpy(), rtol=0, atol=0)


@functools.lru_cache(maxsize=None)
def _stereo_map():
    """The scene map with right coordinates on 2 of 3 bound keypoints, then
    disturbed; 8 stereo and 8 mono observations of keyframes 2 and 3 moved
    25 px."""
    m = sc.jax_map()
    kf_pt, uv = np.asarray(m.kf_pt), np.array(m.kf_uv)
    pos, poses = np.asarray(m.pt_pos), np.asarray(m.kf_pose)
    ur = np.full(kf_pt.shape, -1.0, np.float32)
    for k in range(len(sc.KF_FRAMES)):
        kp = np.flatnonzero(kf_pt[k] >= 0)
        z = (pos[kf_pt[k, kp]] @ poses[k, :3, :3].T + poses[k, :3, 3])[:, 2]
        on = (np.arange(len(kp)) % 3 != 2) & (z > 0)
        ur[k, kp[on]] = uv[k, kp[on], 0] - BF / z[on]
    rng = np.random.RandomState(2)
    pos = pos + rng.normal(0, 0.02, pos.shape).astype(np.float32)
    poses = np.array(poses)
    for k in range(1, 5):
        d = np.concatenate([rng.normal(0, 0.005, 3), rng.normal(0, 0.01, 3)]).astype(np.float32)
        poses[k] = np.asarray(jgeo.se3_exp(jnp.asarray(d)) @ poses[k])
    for k in (2, 3):
        kp = np.flatnonzero(kf_pt[k] >= 0)
        for sel in (kp[ur[k, kp] >= 0][5:9], kp[ur[k, kp] < 0][5:9]):
            uv[k, sel] += 25.0
            ur[k, sel] = np.where(ur[k, sel] >= 0, ur[k, sel] + 25.0, -1.0)
    return m._replace(pt_pos=jnp.asarray(pos), kf_pose=jnp.asarray(poses), kf_uv=jnp.asarray(uv),
                      kf_ur=jnp.asarray(ur))


def _jcam():
    return sc.jax_camera()


@functools.lru_cache(maxsize=None)
def _pack_j(center=4):
    """The reference's pack, called as its ``run_local_ba`` calls it (one
    compiled program for both)."""
    fl, caps = FeatureFlags(), sc.CAPS
    return jba.pack_local_ba(
        _stereo_map(), center, _jcam(), n_opt=caps.local_ba_keyframes, n_fixed=caps.local_ba_fixed_keyframes,
        n_local_pts=caps.local_ba_points, use_planes=fl.optimize_with_plane_3d,
        use_cub_2d=fl.optimize_with_cuboid_2d, use_corners_2d=fl.optimize_with_corners_2d,
        use_cub_3d=fl.optimize_with_cuboid_3d, use_pt_obj=fl.optimize_with_pt_obj_3d,
        use_cub_plane=fl.optimize_with_cuboid_plane, pt_per_cub=caps.max_points_per_cuboid,
        fix_cuboid_scale=BAConfig().cuboid_fix_scale, use_stereo=True)


def _pack_t(center=4):
    return tba.pack_local_ba(tms.map_from_numpy(sc.map_fields(_stereo_map()), "cpu"), center, _tcam(),
                             n_opt=4, n_fixed=4, n_local_pts=1024, use_stereo=True)


def _fields(b):
    return {k: np.asarray(v) for k, v in b._asdict().items()}


def _carry(pack):
    st = tlm.ba_state_from_numpy(_fields(pack.state), "cpu")
    d = pack.data
    fields = {k: np.asarray(getattr(d, k)) for k in
              ("pose_fixed", "point_active", "plane_active", "cuboid_active", "fx", "fy", "cx", "cy", "bf")}
    fields["mono"], fields["stereo"] = _fields(d.mono), _fields(d.stereo)
    return st, tlm.ba_data_from_numpy(fields, "cpu")


def _w():
    return jlm.BAWeights.from_config(BAConfig()), tlm.BAWeights.from_config(tcfg.BAConfig())


def test_pack_local_ba_with_stereo_matches_reference():
    ref, got = _pack_j(), _pack_t()
    for k in ("window_ids", "window_mask", "point_ids", "point_mask"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k)), err_msg=k)
    for b in ("mono", "stereo"):
        for k, v in _fields(getattr(ref.data, b)).items():
            g = getattr(getattr(got.data, b), k).numpy()
            if k == "inv_sigma2":
                np.testing.assert_allclose(g, v, rtol=2e-7, atol=0)
            else:
                np.testing.assert_array_equal(g, v, err_msg=f"{b}.{k}")
    n_st, n_mo = int(ref.data.stereo.valid.sum()), int(ref.data.mono.valid.sum())
    assert n_st > 150 and n_mo > 60, (n_st, n_mo)
    assert not np.any(np.asarray(ref.data.stereo.valid) & np.asarray(ref.data.mono.valid))
    back = tlm.ba_data_from_numpy(tlm.ba_data_to_numpy(got.data), "cpu")
    for k in tlm.StereoFactors._fields:
        assert torch.equal(getattr(back.stereo, k), getattr(got.data.stereo, k).to(getattr(back.stereo, k).dtype))


def test_build_system_total_chi2_and_gate_with_stereo_match_reference():
    pack = _pack_j()
    w_j, w_t = _w()
    st, d = _carry(pack)
    ref = jax.jit(jlm.build_system, static_argnames=("reproj_n",))(pack.state, pack.data, w_j, reproj_n=sc.N_FEAT)
    got = tlm.build_system(st, d, w_t)
    for name, g, r in zip(("H_cc", "H_cl", "H_ll", "b_c", "b_l", "chi2"), got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-3, atol=2e-3 * np.abs(r).max(), err_msg=name)
    chi2_j = float(jax.jit(jlm.total_chi2)(pack.state, pack.data, w_j))
    np.testing.assert_allclose(float(tlm.total_chi2(st, d, w_t)), chi2_j, rtol=1e-3)
    no_stereo = d._replace(stereo=None)
    assert float(tlm.total_chi2(st, no_stereo, w_t)) < 0.9 * chi2_j
    _, gated_r, _, gated_g = _gated()
    for b in ("mono", "stereo"):
        np.testing.assert_array_equal(getattr(gated_g, b).valid.numpy(), np.asarray(getattr(gated_r, b).valid),
                                      err_msg=b)
    assert int(pack.data.stereo.valid.sum()) - int(gated_r.stereo.valid.sum()) >= 4


@functools.lru_cache(maxsize=None)
def _gated():
    """The packed problem's observations gated at its own (disturbed) state,
    as a rejected solve leaves them: the 25 px ones are outliers."""
    pack = _pack_j()
    w_j, w_t = _w()
    st, d = _carry(pack)
    return pack, jax.jit(jlm.gate_observations)(pack.state, pack.data, w_j), st, tlm.gate_observations(st, d, w_t)


def test_unpack_local_ba_rejected_solve_still_unlinks_stereo_outliers_mirrored_reference_fault():
    """local_ba.py:338-339 of the reference: the stereo outlier term is not
    gated by ``accept``, so a rejected solve keeps the poses and points but
    still unlinks the stereo outliers, and kills the points they leave with
    two observers or fewer; mono outliers stay linked.  Mirrored."""
    pack, d_ref, st, d_got = _gated()
    m = _stereo_map()
    pack_t = _pack_t()
    ur, kf_pt0 = np.asarray(m.kf_ur), np.asarray(m.kf_pt)
    for accept in (False, True):
        ref = jba.unpack_local_ba(m, pack, pack.state, d_ref, stereo_shared=True, accept=jnp.asarray(accept))
        got = tba.unpack_local_ba(tms.map_from_numpy(sc.map_fields(m), "cpu"), pack_t, st, d_got,
                                  stereo_shared=True, accept=torch.tensor(accept))
        for k in ("kf_pt", "pt_valid"):
            np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k)), err_msg=k)
        unlinked = (kf_pt0 >= 0) & (np.asarray(ref.kf_pt) < 0)
        alive = np.asarray(ref.pt_valid)[kf_pt0[unlinked & (ur < 0)]]
        if not accept:
            np.testing.assert_array_equal(got.kf_pose.numpy(), np.asarray(m.kf_pose))
            np.testing.assert_array_equal(got.pt_pos.numpy(), np.asarray(m.pt_pos))
            assert (unlinked & (ur >= 0)).sum() >= 4
            assert not alive.any()  # a mono observation goes only with its killed point
        else:
            assert alive.sum() >= 4  # the mono outliers too


def test_run_local_ba_for_a_depth_sensor_matches_reference():
    m = _stereo_map()
    cfg_j = SlamConfig().replace(sensor="rgbd", caps=sc.CAPS)
    cfg_t = tcfg.SlamConfig().replace(sensor="rgbd", caps=tcfg.Capacities(**sc.CAPS.__dict__))
    ref, c_ref = jba.run_local_ba(m, 4, _jcam(), cfg_j)
    stats = {}
    got, c_got = tba.run_local_ba(tms.map_from_numpy(sc.map_fields(m), "cpu"), 4, _tcam(), cfg_t, stats=stats)
    np.testing.assert_allclose(c_got.numpy(), np.asarray(c_ref), rtol=1e-3)
    np.testing.assert_array_equal(got.kf_pt.numpy(), np.asarray(ref.kf_pt))
    np.testing.assert_array_equal(got.pt_valid.numpy(), np.asarray(ref.pt_valid))
    assert (np.asarray(ref.kf_pt) != np.asarray(m.kf_pt)).sum() >= 8
    np.testing.assert_allclose(got.kf_pose.numpy(), np.asarray(ref.kf_pose), atol=2e-3, rtol=0)
    kf_pt = np.asarray(ref.kf_pt)
    kf, kp = np.nonzero((kf_pt >= 0) & np.asarray(ref.kf_valid)[:, None])
    _assert_same_projections(got.kf_pose, got.pt_pos, ref.kf_pose, ref.pt_pos, kf, kf_pt[kf, kp])
    assert int(stats["stereo"]) > 150 and int(stats["mono"]) > 60


def _assert_same_projections(poses_g, pts_g, poses_r, pts_r, kf, pt, tol=0.01):
    def proj(poses, pts):
        pc = np.einsum("fij,fj->fi", poses[kf, :3, :3], pts[pt]) + poses[kf, :3, 3]
        return np.stack([C.fx * pc[:, 0] / pc[:, 2], C.fy * pc[:, 1] / pc[:, 2]], 1)

    diff = np.abs(proj(np.asarray(poses_g), np.asarray(pts_g)) - proj(np.asarray(poses_r), np.asarray(pts_r)))
    assert diff.max() <= tol, diff.max()
