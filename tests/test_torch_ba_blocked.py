"""Parity of the port's kf-major BA assembly (``build_system(reproj_n=N)``,
``tpuslam_torch/graph/lm.py:_assemble_reproj_blocked``) with the
reference's blocked assembly (``tpuslam/graph/lm.py:_assemble_reproj_blocked``)
and with the port's own generic path, on the CPU.

The windows are bench.py's local-BA window cut to K = 4 keyframes of N = 64
kf-major lanes, P = 256 points, Q = 2 planes and C = 2 cuboids
(``workload.ba_window_arrays``): mono alone, mono with a stereo bundle on
the same lanes (a random half of the valid lanes stereo, the rest mono, as
``pack_local_ba`` splits them), and mono with every plane and cuboid bundle
(bench.py's five and a cuboid-SE3 bundle).  Both packages get the same numpy
arrays.

Tolerances: each output against the reference's within rtol 1e-4 and an
atol of 1e-4 x the largest |entry| of that output (float32 sums in another
order: the reference's one-hot matmuls, the port's lane-order sums); the
pose blocks of H_cc also within 1e-4 of their own scale, since the cuboid
rows' entries reach 1e16.  The port's kf-major path against its generic
path: bit for bit on the CPU, where both sum every destination's lanes in
lane order; the pose blocks' batched matmuls that the card runs against
those lane-order sums within rtol 1e-5.  ``lm_iterations`` with
``reproj_n``, 5 iterations on a K = 8 cut with every bundle: chi2s rtol
1e-3, poses (keyframe 0 and the second half fixed: the gauge is held)
1e-4, and the points compared where the factors see them, as their
projections into their keyframes, within 0.05 px (points up to 10 m away
seen over a 1.05 m baseline move 5e-3 m along their depth between two
float32 sums; ``test_torch_ba.py`` holds 5 iterations to the same 0.05 px).
``local_ba`` with ``reproj_n`` on the stereo window (K = 4, 3 + 3
iterations): the gated masks equal, chi2s rtol 1e-3, poses 1e-4, and the
points' projections within 0.01 px (their depths ride on a 0.45 m
baseline).

bench.py's vertical plane lanes measure a plane as perpendicular to itself
(the measurement is the plane's own transform), where the residual's
rotation axis is the cross product of two equal normals: its Jacobian is
about one over float32 rounding (H_cc entries of 1.5e19 at K = 8), and a
solve with those lanes is chaotic in float32, in each package (the port's
two paths part after the first step on the full window).  ``build_system``
is held with them; the LM solves run with those lanes invalid.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_scene  # noqa: F401  (caps torch's threads for the workers)
from tpuslam.graph import lm as jlm
from tpuslam_torch import workload
from tpuslam_torch.backend import local_ba as tba
from tpuslam_torch.graph import lm as tlm

K, N, P, Q, C = 4, 64, 256, 2, 2
BF = 40.0
SEMANTIC = ("plane_obs", "cub_bbox", "cub_corner", "cub_se3", "pt_cub", "cub_plane")
NAMES = ("H_cc", "H_cl", "H_ll", "b_c", "b_l", "chi2")


def _window(case, seed=0, **sizes):
    """(state, data) numpy dicts of one case."""
    sizes = {**dict(K=K, N=N, P=P, Q=Q, C=C), **sizes}
    state, data = workload.ba_window_arrays(seed, **sizes)
    k, n = sizes["K"], sizes["N"]
    if case in ("mono", "stereo"):
        for b in SEMANTIC:
            data.pop(b, None)
        data["plane_active"] = np.zeros_like(data["plane_active"])
        data["cuboid_active"] = np.zeros_like(data["cuboid_active"])
    if case == "stereo":
        m = data["mono"]
        T = state["poses"][m["kf"]]
        z = np.einsum("fj,fj->f", T[:, 2, :3], state["points"][m["pt"]]) + T[:, 2, 3]
        ur = m["uv"][:, 0] - BF / np.maximum(z, 1e-3)
        to_stereo = m["valid"] & (np.random.RandomState(seed + 1).rand(k * n) < 0.5)
        data["stereo"] = {"kf": m["kf"], "pt": m["pt"], "uvr": np.concatenate([m["uv"], ur[:, None]], 1).astype(
            np.float32), "inv_sigma2": m["inv_sigma2"], "valid": to_stereo}
        data["mono"] = {**m, "valid": m["valid"] & ~to_stereo}
        data["bf"] = BF
    if case == "semantic":
        cb = data["cub_bbox"]
        meas = np.einsum("fij,fjk->fik", state["poses"][cb["kf"]], state["cuboid_pose"][cb["cub"]])
        data["cub_se3"] = {"kf": cb["kf"], "cub": cb["cub"], "meas_pose": meas.astype(np.float32),
                           "meas_scale": state["cuboid_scale"][cb["cub"]], "weight": cb["weight"],
                           "valid": cb["valid"]}
    return state, data


def _ref(state, data):
    """The reference's BAState and BAData of the same arrays (absent bundles
    as its one-lane empties)."""
    cls = {"mono": jlm.MonoFactors, "stereo": jlm.StereoFactors, "plane_obs": jlm.PlaneFactors,
           "cub_bbox": jlm.CuboidBBoxFactors, "cub_corner": jlm.CuboidCornerFactors, "cub_se3": jlm.CuboidSE3Factors,
           "pt_cub": jlm.PointCuboidFactors, "cub_plane": jlm.CuboidPlaneFactors}
    st = jlm.BAState(**{k: jnp.asarray(v) for k, v in state.items()})

    cam = SimpleNamespace(**{k: jnp.float32(data[k]) for k in ("fx", "fy", "cx", "cy", "bf")})
    bundles = {b: c(**{f: jnp.asarray(data[b][f]) for f in c._fields}) for b, c in cls.items() if b in data}
    d = jlm.make_ba_data(
        state["poses"].shape[0], state["points"].shape[0], state["planes"].shape[0],
        state["cuboid_pose"].shape[0], cam, **bundles,
        pose_fixed=jnp.asarray(data["pose_fixed"]), point_active=jnp.asarray(data["point_active"]),
        plane_active=jnp.asarray(data["plane_active"]), cuboid_active=jnp.asarray(data["cuboid_active"]))
    return st, d


def _port(state, data):
    return tlm.ba_state_from_numpy(state, "cpu"), tlm.ba_data_from_numpy(data, "cpu")


_REF_BUILD = jax.jit(jlm.build_system, static_argnames=("reproj_n",))


def _ref_build(state, data, reproj_n):
    return [np.asarray(x) for x in _REF_BUILD(*_ref(state, data), jlm.BAWeights(), reproj_n=reproj_n)]


def _assert_same_projections(data, poses_g, pts_g, poses_r, pts_r, tol):
    """Both solutions' projections (px) of the points into the keyframes
    whose valid mono lanes observe them."""
    m = data["mono"]
    kf, pt = m["kf"][m["valid"]], m["pt"][m["valid"]]

    def proj(poses, pts):
        pc = np.einsum("fij,fj->fi", poses[kf, :3, :3], pts[pt]) + poses[kf, :3, 3]
        return np.stack([data["fx"] * pc[:, 0] / pc[:, 2], data["fy"] * pc[:, 1] / pc[:, 2]], 1)

    diff = np.abs(proj(np.asarray(poses_g), np.asarray(pts_g)) - proj(np.asarray(poses_r), np.asarray(pts_r)))
    assert diff.max() <= tol, diff.max()


def _close(got, ref, k, tol):
    for name, g, r in zip(NAMES, got, ref):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, r, rtol=tol, atol=tol * max(np.abs(r).max(), 1e-30), err_msg=name)
    pose_g, pose_r = got[0][: 6 * k, : 6 * k], ref[0][: 6 * k, : 6 * k]
    pose_g = pose_g.numpy() if isinstance(pose_g, torch.Tensor) else pose_g
    np.testing.assert_allclose(pose_g, pose_r, rtol=tol, atol=tol * np.abs(pose_r).max(), err_msg="pose blocks")


@pytest.mark.parametrize("case", ["mono", "stereo", "semantic"])
def test_build_system_kf_major_matches_reference(case):
    state, data = _window(case)
    st, d = _port(state, data)
    got = tlm.build_system(st, d, tlm.BAWeights(), reproj_n=N)
    _close(got, _ref_build(state, data, N), K, 1e-4)
    assert int(data["mono"]["valid"].sum()) > 100
    if case == "stereo":
        assert int(data["stereo"]["valid"].sum()) > 50


@pytest.mark.parametrize("case", ["mono", "stereo", "semantic"])
def test_build_system_kf_major_matches_generic_path(case):
    st, d = _port(*_window(case))
    w = tlm.BAWeights()
    blocked = tlm.build_system(st, d, w, reproj_n=N)
    generic = tlm.build_system(st, d, w)
    for name, a, b in zip(NAMES, blocked, generic):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("case", ["mono", "stereo"])
def test_pose_sums_batched_as_on_the_card_match_the_lane_order_sums(case):
    st, d = _port(*_window(case))
    lanes = [x for _, x in tlm._reproj_lanes(st, d, tlm.BAWeights())]
    batched = tlm._pose_sums(lanes, N, K, batched=True)
    serial = tlm._pose_sums(lanes, N, K, batched=False)
    for a, b in zip(batched, serial):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


def test_a_point_bound_twice_by_one_keyframe_is_summed_as_the_reference_sums_it():
    state, data = _window("mono")
    m = data["mono"]
    lanes = np.flatnonzero(m["valid"][N:2 * N]) + N  # keyframe 1's valid lanes
    a, b = lanes[3], lanes[7]
    pt = m["pt"].copy()
    pt[b] = pt[a]
    data["mono"] = {**m, "pt": pt}
    st, d = _port(state, data)
    got = tlm.build_system(st, d, tlm.BAWeights(), reproj_n=N)
    _close(got, _ref_build(state, data, N), K, 1e-4)
    # the keyframe's six H_cl rows at that point hold both lanes' blocks
    one = dict(data)
    one["mono"] = {**data["mono"], "valid": np.isin(np.arange(K * N), [a, b])}
    st1, d1 = _port(state, one)
    H_cl = tlm.build_system(st1, d1, tlm.BAWeights(), reproj_n=N)[1]
    only_a = dict(one, mono={**one["mono"], "valid": np.arange(K * N) == a})
    only_b = dict(one, mono={**one["mono"], "valid": np.arange(K * N) == b})
    parts = [tlm.build_system(*_port(state, x), tlm.BAWeights(), reproj_n=N)[1] for x in (only_a, only_b)]
    torch.testing.assert_close(H_cl[6:12, pt[a]], parts[0][6:12, pt[a]] + parts[1][6:12, pt[a]])
    assert float(parts[0][6:12, pt[a]].abs().max()) > 0 and float(parts[1][6:12, pt[a]].abs().max()) > 0


def test_a_lane_count_that_is_not_kf_major_raises_as_the_reference():
    state, data = _window("stereo")
    st, d = _port(state, data)
    with pytest.raises(ValueError) as got:
        tlm.build_system(st, d, tlm.BAWeights(), reproj_n=N + 1)
    with pytest.raises(ValueError) as ref:
        _ref_build(state, data, N + 1)
    assert str(got.value) == str(ref.value) == f"reproj_n={N + 1} claims kf-major mono lanes but {K * N} != {N + 1}*{K}"
    # the stereo bundle is checked on its own
    bad = dict(data, stereo={k: v[: K * N - N] for k, v in data["stereo"].items()})
    with pytest.raises(ValueError, match=f"claims kf-major stereo lanes but {K * N - N} != {N}\\*{K}"):
        tlm.build_system(*_port(state, bad), tlm.BAWeights(), reproj_n=N)
    # a one-lane bundle (the reference's .empty() placeholder) takes the generic path
    empty = dict(data, stereo={k: v[:1] for k, v in data["stereo"].items()})
    got = tlm.build_system(*_port(state, empty), tlm.BAWeights(), reproj_n=N)
    _close(got, _ref_build(state, empty, N), K, 1e-4)


def test_lm_iterations_with_reproj_n_matches_reference_on_the_bench_window():
    sizes = dict(K=8, N=128, P=512, Q=8, C=4)
    state, data = _window("semantic", **sizes)
    po = data["plane_obs"]
    data["plane_obs"] = {**po, "valid": po["valid"] & (po["kind"] != 1)}  # see the module's docstring
    assert po["valid"][po["kind"] == 2].any() and data["plane_obs"]["valid"].any()
    st_j, d_j = _ref(state, data)
    st_t, d_t = _port(state, data)
    w_j, w_t = jlm.BAWeights(), tlm.BAWeights()
    fn = jax.jit(jlm.lm_iterations, static_argnames=("n_iters", "reproj_n"))
    s_ref, c_ref = fn(st_j, d_j, w_j, n_iters=5, reproj_n=128)
    s_got, c_got = tlm.lm_iterations(st_t, d_t, w_t, 5, reproj_n=128)
    assert float(c_ref[-1]) < float(c_ref[0])
    np.testing.assert_allclose(c_got.numpy(), np.asarray(c_ref), rtol=1e-3)
    np.testing.assert_allclose(s_got.poses.numpy(), np.asarray(s_ref.poses), atol=1e-4, rtol=0)
    _assert_same_projections(data, s_got.poses, s_got.points, s_ref.poses, s_ref.points, 0.05)


def test_local_ba_with_reproj_n_matches_reference_with_a_stereo_bundle():
    state, data = _window("stereo")
    st_j, d_j = _ref(state, data)
    st_t, d_t = _port(state, data)
    s_ref, d_ref, c_ref = jlm.local_ba(st_j, d_j, jlm.BAWeights(), phase1_iters=3, phase2_iters=3, reproj_n=N)
    s_got, d_got, c_got = tlm.local_ba(st_t, d_t, tlm.BAWeights(), phase1_iters=3, phase2_iters=3, reproj_n=N)
    for b in ("mono", "stereo"):
        np.testing.assert_array_equal(getattr(d_got, b).valid.numpy(), np.asarray(getattr(d_ref, b).valid),
                                      err_msg=b)
    np.testing.assert_allclose(c_got.numpy(), np.asarray(c_ref), rtol=1e-3)
    np.testing.assert_allclose(s_got.poses.numpy(), np.asarray(s_ref.poses), atol=1e-4, rtol=0)
    _assert_same_projections(data, s_got.poses, s_got.points, s_ref.poses, s_ref.points, 0.01)


def test_run_local_ba_and_run_global_ba_pass_the_keypoints_per_keyframe(monkeypatch):
    """The single-device local BA and the global BA, whole and chunked, take
    the kf-major path with ``kf_pt.shape[1]`` lanes per keyframe, as the
    reference's do (local_ba.py:542, :550, :627)."""
    import chip_smoke

    cam, cfg, m = chip_smoke.ba_map("cpu")
    calls = []

    def spy_local(state, data, w, phase1_iters=5, phase2_iters=10, reproj_n=0):
        calls.append(("local_ba", reproj_n, data.mono.kf.shape[0] // state.poses.shape[0]))
        return state, data, torch.zeros(phase2_iters)

    def spy_lm(state, data, w, n_iters, lam0=1e-4, reproj_n=0, reduce=None):
        calls.append(("lm_iterations", reproj_n, data.mono.kf.shape[0] // state.poses.shape[0]))
        return state, torch.zeros(n_iters)

    monkeypatch.setattr(tba.lm, "local_ba", spy_local)
    monkeypatch.setattr(tba.lm, "lm_iterations", spy_lm)
    tba.run_local_ba(m, chip_smoke.BA_CENTER, cam, cfg)
    tba.run_global_ba(m, cam, cfg, n_iters=10)
    tba.run_global_ba(m, cam, cfg, n_iters=10, should_abort=lambda: False, chunk=5)
    n = m.kf_pt.shape[1]
    assert calls == [("local_ba", n, n)] + [("lm_iterations", n, n)] * 3
