"""Parity of the port's plane and cuboid geometry and factors with the JAX
package, on the CPU: every function of ``tpuslam_torch/core/geometry.py``
that the semantic slice added, the plane and cuboid retractions and
residuals of ``graph/factors.py``, and the Jacobians that ``linearize``
returns for each residual (forward mode in both packages).

Inputs are drawn with numpy from fixed seeds.  Tolerances: geometry values
rtol 1e-5 / atol 1e-5 (float32 trig and 3x3 products in another order),
1e-3 atol on pixels, 1e-4 on the SO3 / SE3 logs of large rotations;
Jacobians rtol 1e-3 / atol 1e-3, and NaN exactly where the reference has it
(a plane normal along a frame's z axis gives atan2(0, 0) and the derivative
of a zero norm).  Jacobians are taken at normals away from the poles and at
the floor's world normal (0, 0, 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.core import geometry as jgeo
from tpuslam.graph import factors as jfac
from tpuslam_torch.core import geometry as tgeo
from tpuslam_torch.graph import factors as tfac

RTOL, ATOL = 1e-5, 1e-5
K_NP = np.array([[260.0, 0.0, 159.5], [0.0, 260.0, 119.5], [0.0, 0.0, 1.0]], np.float32)


def _planes(rng, n, floor=False):
    """Unit-normal planes with d in [0.5, 3]; ``floor``: normal (0, 0, 1)."""
    nrm = np.tile([0.0, 0.0, 1.0], (n, 1)) if floor else rng.normal(size=(n, 3))
    nrm = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    return np.concatenate([nrm, rng.uniform(0.5, 3.0, (n, 1))], 1).astype(np.float32)


def _poses(rng, n, s=0.3, t=0.5):
    xi = np.concatenate([rng.normal(0, s, (n, 3)), rng.normal(0, t, (n, 3))], 1).astype(np.float32)
    return np.asarray(jgeo.se3_exp(jnp.asarray(xi)))


def _cuboids(rng, n):
    """Cuboid poses in front of a camera at the origin looking along +z."""
    v9 = np.concatenate([rng.uniform([-0.5, -0.5, 3.0], [0.5, 0.5, 5.0], (n, 3)),
                         rng.normal(0, 0.2, (n, 2)), rng.uniform(-np.pi, np.pi, (n, 1)),
                         rng.uniform(0.2, 0.6, (n, 3))], 1).astype(np.float32)
    pose, scale = jgeo.cuboid_from_minimal(jnp.asarray(v9))
    return np.asarray(pose), np.asarray(scale)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol, equal_nan=True)


def _case(name, rng):
    """(reference function, port function, numpy inputs) of one geometry case."""
    n = 64
    pl_a, pl_b = _planes(rng, n), _planes(rng, n)
    T = _poses(rng, n)
    cp, cs = _cuboids(rng, n)
    cp2, cs2 = _cuboids(rng, n)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    ang = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    xi9 = rng.normal(0, 0.1, (n, 9)).astype(np.float32)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32) + cp[:, :3, 3]
    k = rng.randint(-1, 3, n).astype(np.int32)
    Ks = np.broadcast_to(K_NP, (n, 3, 3)).copy()
    Tcw = np.broadcast_to(np.eye(4, dtype=np.float32), (n, 4, 4)).copy()
    big = _poses(rng, n, s=1.2)
    cases = {
        "plane_normalize": ("plane_normalize", (pl_a * rng.uniform(-3, 3, (n, 1)).astype(np.float32),)),
        "plane_transform": ("plane_transform", (T, pl_a)),
        "plane_rotation": ("plane_rotation", (pl_a[:, :3],)),
        "plane_ominus": ("plane_ominus", (pl_a, pl_b)),
        "plane_ominus_ver": ("plane_ominus_ver", (pl_a, pl_b)),
        "plane_ominus_par": ("plane_ominus_par", (pl_a, pl_b)),
        "quat_to_R": ("quat_to_R", (q,)),
        "euler_zyx_to_R": ("euler_zyx_to_R", (ang[:, 0], ang[:, 1], ang[:, 2])),
        "R_to_euler_zyx": ("R_to_euler_zyx", (big[:, :3, :3],)),
        "se3_exp_norollpitch": ("se3_exp_norollpitch", (xi9[:, :6],)),
        "so3_log": ("so3_log", (big[:, :3, :3],)),
        "so3_log_identity": ("so3_log", (np.broadcast_to(np.eye(3, dtype=np.float32), (4, 3, 3)).copy(),)),
        "se3_log": ("se3_log", (big,)),
        "cuboid_corners": ("cuboid_corners", (cp, cs)),
        "cuboid_to_minimal": ("cuboid_to_minimal", (cp, cs)),
        "cuboid_from_minimal": ("cuboid_from_minimal", (np.concatenate([cp[:, :3, 3], ang, cs], 1),)),
        "cuboid_rotate": ("cuboid_rotate", (cp, cs, k)),
        "cuboid_log_error": ("cuboid_log_error", (cp, cs, cp2, cs2)),
        "cuboid_min_log_error": ("cuboid_min_log_error", (cp, cs, cp2, cs2)),
        "cuboid_project_corners": ("cuboid_project_corners", (cp, cs, Tcw, Ks)),
        "cuboid_project_bbox": ("cuboid_project_bbox", (cp, cs, Tcw, Ks)),
        "cuboid_point_boundary_error": ("cuboid_point_boundary_error", (cp, cs, pts, 1.0)),
        "cuboid_oplus": ("cuboid_oplus", (cp, cs, xi9)),
        "cuboid_oplus_free": ("cuboid_oplus", (cp, cs, xi9, False, False)),
        "cuboid_face_planes": ("cuboid_face_planes", (cp, cs)),
    }
    fn, args = cases[name]
    return getattr(jgeo, fn), getattr(tgeo, fn), args


GEOMETRY_CASES = ["plane_normalize", "plane_transform", "plane_rotation", "plane_ominus", "plane_ominus_ver",
                  "plane_ominus_par", "quat_to_R", "euler_zyx_to_R", "R_to_euler_zyx", "se3_exp_norollpitch",
                  "so3_log", "so3_log_identity", "se3_log", "cuboid_corners", "cuboid_to_minimal",
                  "cuboid_from_minimal", "cuboid_rotate", "cuboid_log_error", "cuboid_min_log_error",
                  "cuboid_project_corners", "cuboid_project_bbox", "cuboid_point_boundary_error",
                  "cuboid_oplus", "cuboid_oplus_free", "cuboid_face_planes"]


@pytest.mark.parametrize("name", GEOMETRY_CASES)
def test_geometry_matches_reference(name):
    jf, tf, args = _case(name, np.random.RandomState(GEOMETRY_CASES.index(name)))
    arrays = [a for a in args if isinstance(a, np.ndarray)]
    consts = args[len(arrays):]  # the numbers and flags come last
    ref = jax.jit(lambda *a: jf(*a, *consts))(*map(jnp.asarray, arrays))
    got = tf(*(_t(a) if isinstance(a, np.ndarray) else a for a in args))
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(ref)
    # pixels (projections) are ~1e2-1e3: 1e-5 relative; the logs of
    # rotations up to ~2 rad divide by sin(theta): 1e-4
    rtol, atol = (1e-4, 1e-4) if "log" in name else (RTOL, 1e-3 if "project" in name else ATOL)
    for g, r in zip(got, ref):
        _close(g, r, rtol=rtol, atol=atol)


def test_cuboid_oplus_fixheight_freezes_world_y_mirrored_reference_fault():
    """The reference's ``fixheight`` keeps the world *y* of the cuboid (its
    comment assumes a y-up ground).  The golden world is z-up, so there it
    pins a horizontal coordinate and leaves the height free: mirrored."""
    rng = np.random.RandomState(5)
    cp, cs = _cuboids(rng, 8)
    d = np.zeros((8, 9), np.float32)
    d[:, 3:6] = 0.2
    ref_p, _ = jax.jit(jgeo.cuboid_oplus)(jnp.asarray(cp), jnp.asarray(cs), jnp.asarray(d))
    got_p, _ = tgeo.cuboid_oplus(_t(cp), _t(cs), _t(d))
    _close(got_p, ref_p)
    np.testing.assert_array_equal(got_p[:, 1, 3].numpy(), cp[:, 1, 3])  # world y pinned
    assert np.all(np.abs(got_p[:, 2, 3].numpy() - cp[:, 2, 3]) > 1e-3)  # world z (the height) moves


@pytest.mark.parametrize("floor", [False, True], ids=["generic", "floor_normal"])
def test_retract_plane_matches_reference(floor):
    rng = np.random.RandomState(11)
    c = _planes(rng, 32, floor)
    d = rng.normal(0, 0.1, (32, 3)).astype(np.float32)
    _close(tfac.retract_plane(_t(c), _t(d)), jax.jit(jax.vmap(jfac.retract_plane))(jnp.asarray(c), jnp.asarray(d)))
    cp, cs = _cuboids(rng, 32)
    d9 = rng.normal(0, 0.1, (32, 9)).astype(np.float32)
    ref = jax.jit(jax.vmap(jfac.retract_cuboid))(jnp.asarray(cp), jnp.asarray(cs), jnp.asarray(d9))
    for g, r in zip(tfac.retract_cuboid(_t(cp), _t(cs), _t(d9)), ref):
        _close(g, r)


def _factor_case(name, floor, rng):
    """(reference residual, port residual, retractions (ref, port), estimates,
    per-factor args) of one factor type, F factors."""
    F = 24
    T = _poses(rng, F, s=0.1, t=0.2)
    pl = _planes(rng, F, floor)
    meas = _planes(rng, F)
    cp, cs = _cuboids(rng, F)
    pose_r = ((jfac.retract_pose, 6), (tfac.retract_pose, 6))
    plane_r = ((jfac.retract_plane, 3), (tfac.retract_plane, 3))
    cub_r = ((jfac.retract_cuboid, 9), (tfac.retract_cuboid, 9))
    K = np.broadcast_to(K_NP, (F, 3, 3)).copy()
    if name in ("plane", "plane_ver", "plane_par"):
        # measurements near the transformed plane, as a live factor sees them
        local = np.asarray(jgeo.plane_transform(jnp.asarray(T), jnp.asarray(pl)))
        if name == "plane_ver":  # a normal near-perpendicular to the plane's
            perp = np.cross(local[:, :3], rng.normal(size=(F, 3)))
            local = np.concatenate([perp / np.linalg.norm(perp, axis=1, keepdims=True), local[:, 3:]], 1)
        meas = np.asarray(jgeo.plane_normalize(jnp.asarray(local + rng.normal(0, 0.05, (F, 4)))))
        meas = meas.astype(np.float32)
        res = {"plane": "plane_residual", "plane_ver": "plane_ver_residual",
               "plane_par": "plane_par_residual"}[name]
        return res, (pose_r, plane_r), (T, pl), (meas,)
    if name in ("bbox", "corner"):
        Tcw = np.broadcast_to(np.eye(4, dtype=np.float32), (F, 4, 4)) @ _poses(rng, F, s=0.02, t=0.05)
        bbox = np.asarray(jgeo.cuboid_project_bbox(jnp.asarray(cp), jnp.asarray(cs), jnp.asarray(Tcw),
                                                   jnp.asarray(K)))
        if name == "bbox":
            return "cuboid_bbox_residual", (pose_r, cub_r), (Tcw, (cp, cs)), \
                ((bbox + rng.normal(0, 2, bbox.shape)).astype(np.float32), K)
        corners = rng.uniform(0, 300, (F, 16)).astype(np.float32)
        return "cuboid_corner_residual", (pose_r, cub_r), (Tcw, (cp, cs)), (corners, K)
    if name == "se3":
        mp, ms_ = _cuboids(rng, F)
        return "cuboid_se3_residual", (pose_r, cub_r), (T, (cp, cs)), (mp, ms_)
    if name == "point_cuboid":
        M = 16
        pts = (cp[:, None, :3, 3] + rng.uniform(-0.8, 0.8, (F, M, 3))).astype(np.float32)
        mask = (rng.rand(F, M) > 0.3).astype(np.float32)
        return "point_cuboid_residual", (cub_r,), ((cp, cs),), (pts, mask, 1.0, 0.2)
    if name == "cuboid_plane":
        faces = np.asarray(jgeo.cuboid_face_planes(jnp.asarray(cp), jnp.asarray(cs)))
        face = rng.randint(0, 6, F).astype(np.int32)
        plw = faces[np.arange(F), face] + rng.normal(0, 0.02, (F, 4)).astype(np.float32)
        if floor:
            plw = pl
        return "cuboid_plane_residual", (cub_r, plane_r), ((cp, cs), plw.astype(np.float32)), (face,)
    raise KeyError(name)


FACTORS = ["plane", "plane_ver", "plane_par", "bbox", "corner", "se3", "point_cuboid", "cuboid_plane"]
FACTOR_CASES = [(n, False) for n in FACTORS] + [
    (n, True) for n in ("plane", "plane_ver", "plane_par", "cuboid_plane")]


@pytest.mark.parametrize("name,floor", FACTOR_CASES,
                         ids=[f"{n}-{'floor_normal' if f else 'generic'}" for n, f in FACTOR_CASES])
def test_linearize_matches_reference(name, floor):
    rng = np.random.RandomState(100 + FACTORS.index(name) + 50 * floor)
    res, rets, ests, args = _factor_case(name, floor, rng)
    jres, tres = getattr(jfac, res), getattr(tfac, res)
    j_rets = tuple(r[0] for r in rets)
    t_rets = tuple(r[1] for r in rets)

    def j_one(*flat):
        it = iter(flat)
        e = tuple(tuple(next(it) for _ in x) if isinstance(x, tuple) else next(it) for x in ests)
        a = [next(it) if isinstance(x, np.ndarray) else x for x in args]
        return jfac.linearize(jres, j_rets, e, *a)

    flat = [y for x in ests for y in (x if isinstance(x, tuple) else (x,))]
    flat += [a for a in args if isinstance(a, np.ndarray)]
    r_ref, J_ref = jax.jit(jax.vmap(j_one))(*map(jnp.asarray, flat))
    t_ests = tuple(tuple(map(_t, x)) if isinstance(x, tuple) else _t(x) for x in ests)
    t_args = tuple(_t(a) if isinstance(a, np.ndarray) else a for a in args)
    r, J = tfac.linearize(tres, t_rets, t_ests, *t_args)
    _close(r, r_ref, rtol=1e-4, atol=1e-4)
    assert len(J) == len(J_ref)
    for g, w in zip(J, J_ref):
        assert g.shape == w.shape
        _close(g, w, rtol=1e-3, atol=1e-3)
    # at the floor normal the retraction's rounding moves the normal off the
    # pole of plane_rotation (R(c) (1, 0, 0) has x ~ -4e-8), so both stay finite
    assert not any(np.isnan(np.asarray(w)).any() for w in J_ref)


def test_plane_rotation_derivative_at_the_pole_is_nan_as_in_the_reference():
    """At a normal along z, atan2(0, 0) and the norm of v[:2] have no finite
    derivative: the reference's forward derivative of ``plane_rotation`` is
    NaN there, and the port's is too (its norms are sqrt(sum(v * v)), not
    ``torch.linalg.vector_norm``, whose derivative at zero is 0)."""
    import torch.autograd.forward_ad as fwAD

    v = np.array([[0.0, 0.0, 1.0], [0.3, -0.2, 0.9]], np.float32)
    dv = np.array([[0.1, 0.2, 0.0], [0.1, 0.2, 0.0]], np.float32)
    _, ref = jax.jvp(jgeo.plane_rotation, (jnp.asarray(v),), (jnp.asarray(dv),))
    with fwAD.dual_level():
        got = fwAD.unpack_dual(tgeo.plane_rotation(fwAD.make_dual(_t(v), _t(dv)))).tangent
    assert np.isnan(np.asarray(ref[0])).any() and not np.isnan(np.asarray(ref[1])).any()
    _close(got, ref, rtol=1e-4, atol=1e-5)
