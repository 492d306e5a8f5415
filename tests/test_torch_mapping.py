"""Parity of the port's map-state functions (tpuslam_torch.map.mapstate) and
local mapping (tpuslam_torch.backend.mapping) with the JAX package, on the
CPU, on a small map the JAX package built from the golden synth frames and
carried across with map_from_numpy (tests/_torch_scene.py).

Tolerances: integer and boolean fields exact; positions, normals, depths
and distance bands within 1e-4 relative + 1e-5 (float32 sums in another
order).  Triangulated points come from eigh of a float32 4x4 normal matrix
with pixel-scale entries, which both packages solve only to ~1e-3 of the
depth: the points are held to the float64 solution of the same system,
the port's RMS and largest error at most twice the reference's plus 1e-4 m.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_scene as sc
from tpuslam.backend import mapping as jbm
from tpuslam.map import mapstate as jms
from tpuslam_torch.backend import mapping as tbm
from tpuslam_torch.core.camera import Camera, camera_matrix
from tpuslam_torch.map import mapstate as tms

INT_KINDS = "iub"


def _t(a):
    return tms.tensor_from_numpy(np.asarray(a), "cpu")


def _tmap(m_j):
    return tms.map_from_numpy(sc.map_fields(m_j), "cpu")


def _K():
    c = sc.CSPEC
    return camera_matrix(Camera.make(c.fx, c.fy, c.cx, c.cy, "cpu", width=c.width, height=c.height))


def _assert_maps_equal(m_t, m_j, rtol=1e-4, atol=1e-5):
    got, want = tms.map_to_numpy(m_t), sc.map_fields(m_j)
    for k in tms.FIELDS:
        if want[k].dtype.kind in INT_KINDS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _dlt64(T1, T2, uv1, uv2, K):
    """Float64 DLT triangulation of the system the packages solve."""
    K = np.asarray(K, np.float64)
    P1 = K @ np.asarray(T1, np.float64)[..., :3, :]
    P2 = K @ np.asarray(T2, np.float64)[..., :3, :]
    uv1, uv2 = np.asarray(uv1, np.float64), np.asarray(uv2, np.float64)
    A = np.stack([uv1[:, 0, None] * P1[..., 2, :] - P1[..., 0, :], uv1[:, 1, None] * P1[..., 2, :] - P1[..., 1, :],
                  uv2[:, 0, None] * P2[..., 2, :] - P2[..., 0, :], uv2[:, 1, None] * P2[..., 2, :] - P2[..., 1, :]], 1)
    x = np.linalg.eigh(np.swapaxes(A, 1, 2) @ A)[1][..., 0]
    return x[:, :3] / x[:, 3:]


def _assert_as_accurate(got, ref, exact):
    err_ref = np.linalg.norm(ref - exact, axis=1)
    err_got = np.linalg.norm(got - exact, axis=1)
    rms_ref, rms_got = np.sqrt(np.mean(err_ref**2)), np.sqrt(np.mean(err_got**2))
    assert rms_got <= 2 * rms_ref + 1e-4 and err_got.max() <= 2 * err_ref.max() + 1e-4, (
        rms_got, rms_ref, err_got.max(), err_ref.max())


def _with(m_j, **fields):
    return m_j._replace(**{k: jnp.asarray(v) for k, v in fields.items()})


@pytest.mark.parametrize("name", ["scene_median_depth", "keypoint_of_point", "keyframe_redundancy"])
def test_mapstate_reads_match_reference(name):
    m = sc.jax_map()
    mt = _tmap(m)
    if name == "scene_median_depth":
        ref = np.array([float(jms.scene_median_depth(m, jnp.int32(k))) for k in range(8)])
        got = tms.scene_median_depth(mt, torch.arange(8)).numpy()
        assert np.isfinite(ref[:5]).all() and np.isinf(ref[5:]).all()
        np.testing.assert_allclose(got, ref, rtol=1e-6)
        assert float(tms.scene_median_depth(mt, 2)) == pytest.approx(ref[2], rel=1e-6)
    elif name == "keypoint_of_point":
        np.testing.assert_array_equal(tms.keypoint_of_point(mt).numpy(), np.asarray(jms.keypoint_of_point(m)))
    else:
        for th_obs in (2, 3):
            ref = np.asarray(jms.keyframe_redundancy(m, th_obs=th_obs))
            np.testing.assert_array_equal(tms.keyframe_redundancy(mt, th_obs=th_obs).numpy(), ref)
        assert ref.max() > 0


def test_update_point_stats_matches_reference():
    m = sc.jax_map()
    # scramble the stats so the refresh has work to do
    rng = np.random.RandomState(3)
    P = m.pt_pos.shape[0]
    m = _with(m, pt_desc=rng.randint(0, 1 << 32, (P, 8), dtype=np.uint64).astype(np.uint32),
              pt_max_dist=np.full(P, 1e9, np.float32), pt_normal=np.zeros((P, 3), np.float32))
    _assert_maps_equal(tms.update_point_stats(_tmap(m)), jms.update_point_stats(m))


def test_point_cull_mask_and_cull_points_match_reference():
    m = sc.jax_map()
    rng = np.random.RandomState(4)
    P = m.pt_pos.shape[0]
    m = _with(m, pt_found=rng.randint(0, 5, P).astype(np.int32),
              pt_visible=rng.randint(1, 10, P).astype(np.int32))
    mt = _tmap(m)
    for recent, old in ((8, 16), (0, -(1 << 30)), (24, 24)):
        ref = np.asarray(jbm.point_cull_mask(m, jnp.int32(recent), jnp.int32(old)))
        np.testing.assert_array_equal(tbm.point_cull_mask(mt, recent, old).numpy(), ref)
    assert 0 < ref.sum() < np.asarray(m.pt_valid).sum()
    _assert_maps_equal(tms.cull_points(mt, torch.from_numpy(ref.copy())), jms.cull_points(m, jnp.asarray(ref)))


@pytest.mark.parametrize("th_obs,red_th", [(3, 0.9), (2, 0.3)])
def test_cull_keyframes_sequential_matches_reference(th_obs, red_th):
    m = sc.jax_map()
    ref, n_ref = jms.cull_keyframes_sequential(m, jnp.int32(4), jnp.float32(red_th), th_obs=th_obs)
    got, n_got = tms.cull_keyframes_sequential(_tmap(m), 4, red_th, th_obs=th_obs)
    assert int(n_got) == int(n_ref)
    if th_obs == 2:
        assert int(n_ref) >= 1
    _assert_maps_equal(got, ref)


def test_assign_observations_flat_matches_reference():
    m = sc.jax_map()
    rng = np.random.RandomState(5)
    n = 400  # repeated (row, keypoint) cells: the last lane wins
    args = (rng.randint(0, 5, n).astype(np.int32), rng.randint(0, sc.N_FEAT, n).astype(np.int32),
            rng.randint(0, 2000, n).astype(np.int32), rng.rand(n) > 0.3)
    ref = jms.assign_observations_flat(m, *map(jnp.asarray, args))
    _assert_maps_equal(tms.assign_observations_flat(_tmap(m), *map(_t, args)), ref)


def _freed(m, kf, every=2):
    """The map with keyframe ``kf``'s bindings cleared on every ``every``-th
    keypoint, so triangulation has free keypoints with covisible neighbours."""
    kf_pt = np.array(m.kf_pt)
    kf_pt[kf, ::every] = -1
    return _with(m, kf_pt=kf_pt)


def test_fundamental_and_create_new_map_points_match_reference():
    m = _freed(_freed(sc.jax_map(), 1, 1), 2, 1)
    K = sc.jax_camera().K
    F_ref = np.asarray(jbm.fundamental_between(m.kf_pose[2], m.kf_pose[1], K))
    F_got = tbm.fundamental_between(_t(m.kf_pose[2]), _t(m.kf_pose[1]), _K()).numpy()
    np.testing.assert_allclose(F_got, F_ref, rtol=1e-4, atol=1e-9)
    ref = jbm.create_new_map_points(m, jnp.int32(2), jnp.int32(1), K)
    got = tbm.create_new_map_points(_tmap(m), 2, 1, _K())
    ok = np.asarray(ref.ok)
    assert ok.sum() > 30
    np.testing.assert_array_equal(got.ok.numpy(), ok)
    np.testing.assert_array_equal(got.kp2.numpy()[ok], np.asarray(ref.kp2)[ok])
    kp2 = np.asarray(ref.kp2)[ok]
    exact = _dlt64(m.kf_pose[2], m.kf_pose[1], np.asarray(m.kf_uv[2])[ok], np.asarray(m.kf_uv[1])[kp2], K)
    _assert_as_accurate(got.pos.numpy()[ok], np.asarray(ref.pos)[ok], exact)


def test_triangulate_with_neighbors_and_insert_match_reference():
    m = _freed(sc.jax_map(), 2)
    K = sc.jax_camera().K
    pos_r, kp2_r, ch_r, nb_r = jbm.triangulate_with_neighbors(m, jnp.int32(2), K, 0.0, n_nb=4)
    mt = _tmap(m)
    pos_g, kp2_g, ch_g, nb_g = tbm.triangulate_with_neighbors(mt, 2, _K(), n_nb=4)
    ch = np.asarray(ch_r)
    assert ch.sum() > 10
    np.testing.assert_array_equal(nb_g.numpy(), np.asarray(nb_r))
    np.testing.assert_array_equal(ch_g.numpy(), ch)
    np.testing.assert_array_equal(kp2_g.numpy()[ch], np.asarray(kp2_r)[ch])
    lane, kp = np.nonzero(ch)
    nb = np.asarray(nb_r)[lane]
    exact = _dlt64(m.kf_pose[2], np.asarray(m.kf_pose)[nb], np.asarray(m.kf_uv[2])[kp],
                   np.asarray(m.kf_uv)[nb, np.asarray(kp2_r)[lane, kp]], K)
    _assert_as_accurate(pos_g.numpy()[ch], np.asarray(pos_r)[ch], exact)
    # insert the reference's triangulations into both maps: slots from a
    # candidate list with a freed slot first, the last lanes past capacity
    P = m.pt_pos.shape[0]
    avail = np.concatenate([[5], np.arange(P - 20, P), np.full(ch.size, P)])[: ch.size].astype(np.int32)
    ref, n_ref = jbm.insert_triangulated(m, jnp.int32(2), pos_r, kp2_r, ch_r, nb_r,
                                         jnp.asarray(avail), jnp.int32(P), fid=jnp.int32(77))
    got, n_got = tbm.insert_triangulated(mt, 2, _t(pos_r), _t(kp2_r), _t(ch_r), _t(nb_r),
                                         _t(avail), P, fid=77)
    assert int(n_got) == int(n_ref) == 21
    _assert_maps_equal(got, ref)


def test_fuse_duplicates_matches_reference():
    """Keyframe 3's first bound keypoints are rebound to fresh copies of
    their points (duplicates the fuse must merge), and half of keyframe 3's
    other keypoints are freed (the fuse binds them)."""
    m = sc.jax_map()
    kf_pt = np.array(m.kf_pt)
    bound = np.flatnonzero(kf_pt[3] >= 0)
    dup_kp, free_kp = bound[:12], bound[12::2]
    n_pt = int(np.asarray(m.pt_valid).sum()) + 50
    dup_ids = np.arange(n_pt, n_pt + len(dup_kp), dtype=np.int32)
    src = kf_pt[3, dup_kp]
    m = jms.add_points(m, jnp.asarray(dup_ids), m.pt_pos[src], m.pt_desc[src], m.pt_normal[src],
                       m.pt_min_dist[src], m.pt_max_dist[src], jnp.full(len(src), 3, jnp.int32),
                       jnp.ones(len(src), bool))
    kf_pt[3, dup_kp] = dup_ids
    kf_pt[3, free_kp] = -1
    m = _with(m, kf_pt=kf_pt)
    ref = jbm.fuse_duplicates(m, jnp.int32(3), sc.jax_camera().K)
    got = tbm.fuse_duplicates(_tmap(m), 3, _K())
    assert int(np.asarray(m.pt_valid).sum() - np.asarray(ref.pt_valid).sum()) >= 5
    _assert_maps_equal(got, ref)
