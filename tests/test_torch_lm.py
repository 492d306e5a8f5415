"""Parity of tpuslam_torch.graph (reprojection factors, motion-only pose LM)
with the JAX package, on the CPU.

Tolerances: residuals rtol 1e-5; the analytic Jacobian against jax.jacfwd
rtol 1e-4 / atol 1e-3 (float32 rounding on entries up to ~1e3);
optimize_pose on identical inputs: T within 1e-4, inlier masks and counts
equal.  The port runs every LM iteration with converged ones frozen where
the reference exits its loop early, and its float32 sums run in another
order, so T agrees to float32 rounding, not bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpuslam.core import geometry as jgeo
from tpuslam.graph import factors as jfac
from tpuslam.graph import lm as jlm
from tpuslam_torch.graph import factors as tfac
from tpuslam_torch.graph import lm as tlm

FX, FY, CX, CY, BF = 500.0, 505.0, 320.0, 240.0, 40.0


def _problem(seed, n=300, stereo=False, outliers=0.15):
    rng = np.random.RandomState(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(3, 8, n)], 1).astype(np.float32)
    T_true = np.array(jgeo.se3_exp(jnp.asarray(rng.normal(0, 0.05, 6).astype(np.float32))))
    pc = X @ T_true[:3, :3].T + T_true[:3, 3]
    u = FX * pc[:, 0] / pc[:, 2] + CX
    v = FY * pc[:, 1] / pc[:, 2] + CY
    uv = np.stack([u, v], 1) + rng.normal(0, 0.7, (n, 2))
    bad = rng.rand(n) < outliers
    uv[bad] = rng.uniform([0, 0], [640, 480], (bad.sum(), 2))
    octave = rng.randint(0, 4, n)
    inv_s2 = (1.0 / 1.2 ** (2.0 * octave)).astype(np.float32)
    valid = rng.rand(n) > 0.1
    ur = np.full(n, -1.0, np.float32)
    if stereo:
        has = rng.rand(n) < 0.5
        ur[has] = (u - BF / pc[:, 2] + rng.normal(0, 0.7, n))[has]
    T_init = np.array(jgeo.se3_exp(jnp.asarray(rng.normal(0, 0.02, 6).astype(np.float32))) @ T_true)
    return dict(T=T_init, X=X, uv=uv.astype(np.float32), inv_s2=inv_s2, valid=valid, ur=ur)


@pytest.mark.parametrize("case", ["mono", "stereo", "clean", "few_points"])
def test_optimize_pose_matches_reference(case):
    p = _problem(
        seed={"mono": 0, "stereo": 1, "clean": 2, "few_points": 3}[case],
        n=12 if case == "few_points" else 300,
        stereo=case == "stereo",
        outliers=0.0 if case == "clean" else 0.15,
    )
    ur = p["ur"] if case == "stereo" else None
    jT, jin, jn = jlm.optimize_pose(
        jnp.asarray(p["T"]), jnp.asarray(p["X"]), jnp.asarray(p["uv"]), jnp.asarray(p["inv_s2"]),
        jnp.asarray(p["valid"]), FX, FY, CX, CY,
        ur=None if ur is None else jnp.asarray(ur), bf=BF,
    )
    tT, tin, tn = tlm.optimize_pose(
        torch.from_numpy(p["T"]), torch.from_numpy(p["X"]), torch.from_numpy(p["uv"]),
        torch.from_numpy(p["inv_s2"]), torch.from_numpy(p["valid"]), FX, FY, CX, CY,
        ur=None if ur is None else torch.from_numpy(ur), bf=BF,
    )
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    assert int(tn) == int(jn) and tn.dtype == torch.int32
    assert int(jn) > 0.7 * p["valid"].sum() * (1.0 if case == "clean" else 0.85)


@pytest.mark.parametrize("name", ["mono_residual", "stereo_residual"])
def test_residuals_match_reference(name):
    p = _problem(4, n=64, stereo=True)
    T = jnp.asarray(p["T"])
    uvr = np.concatenate([p["uv"], p["ur"][:, None]], 1)
    if name == "mono_residual":
        ref = jax.vmap(jfac.mono_residual, in_axes=(None, 0, 0, None, None, None, None))(
            T, jnp.asarray(p["X"]), jnp.asarray(p["uv"]), FX, FY, CX, CY)
        got = tfac.mono_residual(torch.from_numpy(p["T"]), torch.from_numpy(p["X"]),
                                 torch.from_numpy(p["uv"]), FX, FY, CX, CY)
    else:
        ref = jax.vmap(jfac.stereo_residual, in_axes=(None, 0, 0, None, None, None, None, None))(
            T, jnp.asarray(p["X"]), jnp.asarray(uvr), FX, FY, CX, CY, BF)
        got = tfac.stereo_residual(torch.from_numpy(p["T"]), torch.from_numpy(p["X"]),
                                   torch.from_numpy(uvr), FX, FY, CX, CY, BF)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-3)


def test_stereo_jacobian_matches_jacfwd():
    p = _problem(5, n=64)
    X = p["X"].copy()
    X[0] = [0.1, 0.2, 0.0]  # a point on the camera plane: the depth clamp
    T = jnp.asarray(p["T"])

    def res(d6):
        return jax.vmap(jfac.stereo_residual, in_axes=(None, 0, 0, None, None, None, None, None))(
            jfac.retract_pose(T, d6), jnp.asarray(X), jnp.zeros((64, 3)), FX, FY, CX, CY, BF)

    ref = np.asarray(jax.jacfwd(res)(jnp.zeros(6)))  # (64, 3, 6)
    got = tfac.stereo_jacobian(torch.from_numpy(p["T"]), torch.from_numpy(X), FX, FY, BF).numpy()
    np.testing.assert_allclose(got[1:], ref[1:], rtol=1e-4, atol=1e-3)
    assert np.all(np.isfinite(got[0]))


@pytest.mark.parametrize("name", ["huber_weight", "rho_huber", "retract_pose"])
def test_robust_kernels_and_retraction_match_reference(name):
    rng = np.random.RandomState(6)
    if name == "retract_pose":
        T = np.array(jgeo.se3_exp(jnp.asarray(rng.normal(0, 0.3, 6).astype(np.float32))))
        d = rng.normal(0, 0.1, 6).astype(np.float32)
        ref = jfac.retract_pose(jnp.asarray(T), jnp.asarray(d))
        got = tfac.retract_pose(torch.from_numpy(T), torch.from_numpy(d))
    else:
        chi2 = np.concatenate([rng.uniform(0, 20, 200), [0.0, 5.991, 7.815]]).astype(np.float32)
        lim = np.where(rng.rand(203) < 0.5, 5.991, 7.815).astype(np.float32)
        jf = jfac.huber_weight if name == "huber_weight" else jlm._rho_huber
        tf = tfac.huber_weight if name == "huber_weight" else tlm._rho_huber
        ref = jf(jnp.asarray(chi2), jnp.asarray(lim))
        got = tf(torch.from_numpy(chi2), torch.from_numpy(lim))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)

