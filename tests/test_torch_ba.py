"""Parity of the port's points-only bundle adjustment with the JAX package,
on the CPU: the analytic mono Jacobians (tpuslam_torch.graph.factors), the
Schur solver, the LM loop and the two-phase local BA (graph/lm.py), and
pack / run_local_ba (backend/local_ba.py) on the small JAX-built map of
tests/_torch_scene.py with its points and poses disturbed and a few
observations moved off their points.

Tolerances: Jacobians rtol 1e-4 / atol 1e-3 (float32, entries up to ~1e3);
schur_solve rtol 1e-3 / atol 1e-5 on the steps; the packed problem exact
(inverse sigmas to 1 ulp of float32 pow); after the solves, chi2s rtol
1e-3 and gated observation masks and unlinked observations equal.  The
normal equations are summed in another order than the reference's one-hot
matmuls, so the solutions differ by rounding, amplified along directions
chi2 barely sees: a two-view point ~3 m away seen over a 0.15 m baseline
has a depth sigma of ~0.2 m per pixel.  So points are compared where the
factors see them, as their projections into every keyframe that observes
them: within 0.01 px after the outlier gates, 0.05 px after the first five
iterations (before the gate, observations 25 px off pull on their points).
With the scale gauge fixed (a second fixed keyframe) poses agree within
1e-4; in ``run_local_ba``'s own window one keyframe is fixed and the scale
is free, so each package's poses are held to a float64 solve of the same
BA (the port within 1e-3, the reference within 3e-3).  A trial step with a non-finite pose
is the one place the port and the reference differ on purpose: the port
rejects it (``lm.lm_iterations``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_scene as sc
from tpuslam.backend import local_ba as jba
from tpuslam.core import geometry as jgeo
from tpuslam.core.config import BAConfig, SlamConfig
from tpuslam.graph import factors as jfac
from tpuslam.graph import lm as jlm
from tpuslam.graph import schur as jschur
from tpuslam_torch.backend import local_ba as tba
from tpuslam_torch.core import config as tcfg
from tpuslam_torch.core.camera import Camera
from tpuslam_torch.graph import factors as tfac
from tpuslam_torch.graph import lm as tlm
from tpuslam_torch.graph import schur as tschur
from tpuslam_torch.map import mapstate as tms

FX, FY, CX, CY = 260.0, 262.0, 159.5, 119.5


def _tcam():
    c = sc.CSPEC
    return Camera.make(c.fx, c.fy, c.cx, c.cy, "cpu", width=c.width, height=c.height, bf=c.fx * c.baseline)


def test_mono_jacobians_match_linearize():
    rng = np.random.RandomState(0)
    n = 200
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1, 1, n), rng.uniform(1, 6, n)], 1).astype(np.float32)
    Ts = np.array(jax.vmap(jgeo.se3_exp)(jnp.asarray(rng.normal(0, 0.2, (n, 6)).astype(np.float32))))
    uv = rng.uniform([0, 0], [320, 240], (n, 2)).astype(np.float32)

    def lin(T, Xp, u):
        return jfac.linearize(jfac.mono_residual, ((jfac.retract_pose, 6), (jfac.retract_point, 3)),
                              (T, Xp), u, FX, FY, CX, CY)

    r_ref, (Jp_ref, Jx_ref) = jax.vmap(lin)(jnp.asarray(Ts), jnp.asarray(X), jnp.asarray(uv))
    T_t, X_t = torch.from_numpy(Ts), torch.from_numpy(X)
    Jp, Jx = tfac.mono_jacobians(T_t, X_t, FX, FY)
    r = tfac.mono_residual(T_t, X_t, torch.from_numpy(uv), FX, FY, CX, CY)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(Jp.numpy(), np.asarray(Jp_ref), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(Jx.numpy(), np.asarray(Jx_ref), rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(tfac.retract_point(X_t, X_t).numpy(), np.asarray(jfac.retract_point(X, X)))


def test_schur_solve_matches_reference():
    rng = np.random.RandomState(1)
    D, P = 30, 50
    J = rng.normal(size=(200, D + 3 * P)).astype(np.float32)
    H = J.T @ J
    H_cc = H[:D, :D]
    H_cl = H[:D, D:].reshape(D, P, 3)
    H_ll = np.stack([H[D + 3 * p:D + 3 * p + 3, D + 3 * p:D + 3 * p + 3] for p in range(P)])
    b_c = rng.normal(size=D).astype(np.float32)
    b_l = rng.normal(size=(P, 3)).astype(np.float32)
    free_c = (rng.rand(D) > 0.2).astype(np.float32)
    act = (rng.rand(P) > 0.1).astype(np.float32)
    args = (H_cc, H_cl, H_ll, b_c, b_l, np.float32(1e-3), free_c, act)
    ref = jschur.schur_solve(*map(jnp.asarray, args))
    got = tschur.schur_solve(*(torch.from_numpy(np.asarray(a)) for a in args))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-3, atol=1e-5)
    M = H_ll[:4] + np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(tschur.inv3x3(torch.from_numpy(M)).numpy(), np.asarray(jschur.inv3x3(M)), rtol=1e-6)


def _disturbed_map():
    """The scene map with points moved ~2 cm, keyframes 1-4 moved ~1 cm and
    ~0.3 degrees, and 8 bound observations moved 25 px (BA outliers)."""
    m = sc.jax_map()
    rng = np.random.RandomState(2)
    pos = np.asarray(m.pt_pos) + rng.normal(0, 0.02, m.pt_pos.shape).astype(np.float32)
    poses = np.array(m.kf_pose)
    for k in range(1, 5):
        d = np.concatenate([rng.normal(0, 0.005, 3), rng.normal(0, 0.01, 3)]).astype(np.float32)
        poses[k] = np.asarray(jgeo.se3_exp(jnp.asarray(d)) @ poses[k])
    uv = np.array(m.kf_uv)
    for k in (2, 3):
        kp = np.flatnonzero(np.asarray(m.kf_pt[k]) >= 0)[5:9]
        uv[k, kp] += 25.0
    return m._replace(pt_pos=jnp.asarray(pos), kf_pose=jnp.asarray(poses), kf_uv=jnp.asarray(uv))


def _pack_j(m, center=4):
    return jba.pack_local_ba(m, jnp.int32(center), sc.jax_camera(), n_opt=4, n_fixed=4, n_local_pts=1024)


def _carry(pack):
    st = tlm.ba_state_from_numpy({k: np.asarray(v) for k, v in pack.state._asdict().items()}, "cpu")
    d = pack.data
    fields = {k: np.asarray(getattr(d, k)) for k in
              ("pose_fixed", "point_active", "plane_active", "cuboid_active", "fx", "fy", "cx", "cy", "bf")}
    fields["mono"] = {k: np.asarray(v) for k, v in d.mono._asdict().items()}
    fields["cuboid_fix_scale"] = d.cuboid_fix_scale
    return st, tlm.ba_data_from_numpy(fields, "cpu")


@pytest.mark.parametrize("center", [4, 2])
def test_pack_local_ba_matches_reference(center):
    m = _disturbed_map()
    ref = _pack_j(m, center)
    got = tba.pack_local_ba(tms.map_from_numpy(sc.map_fields(m), "cpu"), center, _tcam(),
                            n_opt=4, n_fixed=4, n_local_pts=1024)
    for k in ("window_ids", "window_mask", "point_ids", "point_mask"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k)), err_msg=k)
    st_ref, d_ref = _carry(ref)
    for k in tlm.BAState._fields:
        np.testing.assert_array_equal(getattr(got.state, k).numpy(), getattr(st_ref, k).numpy(), err_msg=k)
    for k in tlm.MonoFactors._fields:
        g, r = getattr(got.data.mono, k).numpy(), getattr(d_ref.mono, k).numpy()
        if k == "inv_sigma2":
            np.testing.assert_allclose(g, r, rtol=2e-7, atol=0)
        else:
            np.testing.assert_array_equal(g, r, err_msg=k)
    for k in ("pose_fixed", "point_active", "plane_active", "cuboid_active"):
        np.testing.assert_array_equal(getattr(got.data, k).numpy(), getattr(d_ref, k).numpy(), err_msg=k)
    assert int(ref.data.mono.valid.sum()) > 200


def test_ba_weights_and_data_round_trip():
    w = tlm.BAWeights.from_config(tcfg.BAConfig())
    assert tuple(w) == tuple(jlm.BAWeights.from_config(BAConfig()))
    st, d = _carry(_pack_j(_disturbed_map()))
    back = tlm.ba_data_from_numpy(tlm.ba_data_to_numpy(d), "cpu")
    for k in tlm.MonoFactors._fields:
        assert torch.equal(getattr(back.mono, k), getattr(d.mono, k))
    st2 = tlm.ba_state_from_numpy(tlm.ba_state_to_numpy(st), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(st, st2))


def _assert_same_projections(poses_g, pts_g, poses_r, pts_r, kf, pt, tol=0.01):
    """The two solutions' projections (px) of points ``pt`` into keyframes ``kf``."""
    def proj(poses, pts):
        pc = np.einsum("fij,fj->fi", poses[kf, :3, :3], pts[pt]) + poses[kf, :3, 3]
        return np.stack([sc.CSPEC.fx * pc[:, 0] / pc[:, 2], sc.CSPEC.fy * pc[:, 1] / pc[:, 2]], 1)

    diff = np.abs(proj(np.asarray(poses_g), np.asarray(pts_g)) - proj(np.asarray(poses_r), np.asarray(pts_r)))
    assert diff.max() <= tol, diff.max()


def test_lm_iterations_and_local_ba_match_reference_on_one_packed_problem():
    pack = _pack_j(_disturbed_map())
    fixed = np.array(pack.data.pose_fixed)
    fixed[1] = True  # a second fixed keyframe fixes the scale
    pack = pack._replace(data=pack.data._replace(pose_fixed=jnp.asarray(fixed)))
    w_j = jlm.BAWeights.from_config(BAConfig())
    w_t = tlm.BAWeights.from_config(tcfg.BAConfig())
    st_t, d_t = _carry(pack)
    s_ref, c_ref = jlm.lm_iterations(pack.state, pack.data, w_j, 5, reproj_n=sc.N_FEAT)
    s_got, c_got = tlm.lm_iterations(st_t, d_t, w_t, 5)
    obs = np.asarray(pack.data.mono.valid)
    kf, pt = np.asarray(pack.data.mono.kf)[obs], np.asarray(pack.data.mono.pt)[obs]
    np.testing.assert_allclose(c_got.numpy(), np.asarray(c_ref), rtol=1e-3)
    np.testing.assert_allclose(s_got.poses.numpy(), np.asarray(s_ref.poses), atol=1e-4, rtol=0)
    _assert_same_projections(s_got.poses, s_got.points, s_ref.poses, s_ref.points, kf, pt, tol=0.05)
    s_ref, d_ref, c_ref = jlm.local_ba(pack.state, pack.data, w_j, reproj_n=sc.N_FEAT)
    s_got, d_got, c_got = tlm.local_ba(st_t, d_t, w_t)
    np.testing.assert_array_equal(d_got.mono.valid.numpy(), np.asarray(d_ref.mono.valid))
    assert int(pack.data.mono.valid.sum()) - int(d_ref.mono.valid.sum()) >= 4  # the moved observations
    np.testing.assert_allclose(c_got.numpy(), np.asarray(c_ref), rtol=1e-3)
    np.testing.assert_allclose(s_got.poses.numpy(), np.asarray(s_ref.poses), atol=1e-4, rtol=0)
    kept = np.asarray(d_ref.mono.valid)
    kf, pt = np.asarray(pack.data.mono.kf)[kept], np.asarray(pack.data.mono.pt)[kept]
    _assert_same_projections(s_got.poses, s_got.points, s_ref.poses, s_ref.points, kf, pt)


def test_lm_rejects_a_non_finite_trial_that_the_reference_accepts(monkeypatch):
    """A step that makes the first window pose NaN: the reference's chi2
    drops that pose's factors, so the step "lowers" it and is taken; the
    port rejects any trial with a non-finite pose or point and keeps the
    state.  (This is the port's one divergence from ``lm_iterations``.)"""
    pack = _pack_j(_disturbed_map())
    w_j = jlm.BAWeights.from_config(BAConfig())
    w_t = tlm.BAWeights.from_config(tcfg.BAConfig())
    st_t, d_t = _carry(pack)
    assert not bool(pack.data.pose_fixed[0])

    def poisoned(solve, nan):
        def f(*a):
            dc, dl = solve(*a)
            return dc.at[:6].set(nan) if hasattr(dc, "at") else torch.cat([torch.full_like(dc[:6], nan), dc[6:]]), dl
        return f

    monkeypatch.setattr(jlm, "schur_solve", poisoned(jschur.schur_solve, jnp.nan))
    monkeypatch.setattr(tlm, "schur_solve", poisoned(tschur.schur_solve, float("nan")))
    chi2_0 = float(jlm.total_chi2(pack.state, pack.data, w_j))
    s_ref, c_ref = jlm.lm_iterations(pack.state, pack.data, w_j, 1)
    s_got, c_got = tlm.lm_iterations(st_t, d_t, w_t, 1)
    assert float(c_ref[0]) < chi2_0 and np.isnan(np.asarray(s_ref.poses[0])[:3]).all()
    np.testing.assert_allclose(float(c_got[0]), float(c_ref[0]), rtol=1e-3)
    assert all(torch.equal(a, b) for a, b in zip(s_got, st_t))


def _local_ba_float64(m_t, cfg_t):
    """The window poses of ``run_local_ba``'s solve redone in float64: the
    same float32 pack, weights and iterations, the variables and
    measurements cast to float64.  Returns (optimized window slots, their
    poses, the final mono validity)."""
    caps = cfg_t.caps
    pack = tba.pack_local_ba(m_t, 4, _tcam(), n_opt=caps.local_ba_keyframes, n_fixed=caps.local_ba_fixed_keyframes,
                             n_local_pts=caps.local_ba_points)

    def f64(b):
        return type(b)(*(x.double() if x.dtype == torch.float32 else x for x in b))

    state, data = f64(pack.state), pack.data._replace(mono=f64(pack.data.mono))
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        s64, d64, _ = tlm.local_ba(state, data, tlm.BAWeights.from_config(cfg_t.ba),
                                   phase1_iters=cfg_t.ba.local_ba_iters_phase1,
                                   phase2_iters=cfg_t.ba.local_ba_iters_phase2)
    finally:
        torch.set_default_dtype(default)
    free = (pack.window_mask & ~pack.data.pose_fixed).numpy()
    return pack.window_ids.numpy()[free], s64.poses.numpy()[free], d64.mono


def test_run_local_ba_matches_reference_from_a_carried_map():
    """Poses are held to a float64 solve of the same BA, not to each other:
    the window's scale is free (one fixed keyframe), and where along it the
    reference's float32 solve lands depends on the host XLA compiles for
    (on one host 2.15e-3 from the float64 poses, so 2.45e-3 from the
    port's, at the window's centre keyframe; the port 3.0e-4).  Held: the
    port within 1e-3 of the float64 poses and no further than the
    reference, the reference within 3e-3 (both checks show the float64
    solve is the BA both packages solve); bindings, validity and chi2 as
    before, and the two solutions' projections within 0.01 px."""
    m = _disturbed_map()
    cfg_j = SlamConfig().replace(caps=sc.CAPS)
    cfg_t = tcfg.SlamConfig().replace(caps=tcfg.Capacities(**sc.CAPS.__dict__))
    ref, c_ref = jba.run_local_ba(m, 4, sc.jax_camera(), cfg_j)
    m_t = tms.map_from_numpy(sc.map_fields(m), "cpu")
    got, c_got = tba.run_local_ba(m_t, 4, _tcam(), cfg_t)
    np.testing.assert_allclose(c_got.numpy(), np.asarray(c_ref), rtol=1e-3)
    np.testing.assert_array_equal(got.kf_pt.numpy(), np.asarray(ref.kf_pt))
    np.testing.assert_array_equal(got.pt_valid.numpy(), np.asarray(ref.pt_valid))
    assert (np.asarray(ref.kf_pt) != np.asarray(m.kf_pt)).sum() >= 4  # outliers unlinked
    slots, poses64, mono64 = _local_ba_float64(m_t, cfg_t)
    assert len(slots) == 4 and int(mono64.valid.sum()) > 200
    err_t = np.abs(got.kf_pose.numpy()[slots] - poses64).max()
    err_j = np.abs(np.asarray(ref.kf_pose)[slots] - poses64).max()
    assert err_t <= 1e-3 and err_t <= err_j, (err_t, err_j)
    assert err_j <= 3e-3, err_j
    kf_pt = np.asarray(ref.kf_pt)
    kf, kp = np.nonzero((kf_pt >= 0) & np.asarray(ref.kf_valid)[:, None])
    _assert_same_projections(got.kf_pose, got.pt_pos, ref.kf_pose, ref.pt_pos, kf, kf_pt[kf, kp])
    assert not np.array_equal(np.asarray(ref.kf_pose), np.asarray(m.kf_pose))
