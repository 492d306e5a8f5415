"""The motion-only pose LM as one CUDA kernel (``kernels/csrc/pose_lm.cu``,
bound by ``kernels/cuda_pose.py`` behind ``graph/lm.py:optimize_pose``).

On the CPU: ``optimize_pose`` runs the plain body and counts it; the
wrapper's input checks, tried on ``meta`` tensors; and the kernel's order
of work written in plain PyTorch (:func:`_kernel_order`: each iteration
linearizes at its trial pose in the pass that prices it, and a round ends
at its first step <= 1e-6) equals the body in float64.  On a card (``cuda``
marker, skipped here): the kernel against the body run on the card, the
same bits from two launches, the launch count, and inputs on a card that is
not the current one.  No JAX: the body is held to the JAX package in
``test_torch_lm.py``.
"""

import numpy as np
import pytest
import torch

from tpuslam_torch.core import geometry as geo
from tpuslam_torch.graph import factors as fac
from tpuslam_torch.graph import lm
from tpuslam_torch.kernels import cuda_pose

FX, FY, CX, CY, BF = 500.0, 505.0, 320.0, 240.0, 40.0
CHI2_TH, CHI2_TH_STEREO = 5.991, 7.815


def _problem(seed, n=300, stereo=False, device="cpu"):
    """A perturbed pose, points seen through it with pixel noise and 15%
    outliers, and per-point inverse sigmas; with ``stereo`` half the
    observations carry a right-view coordinate."""
    rng = np.random.RandomState(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(3, 8, n)], 1).astype(np.float32)
    T_true = geo.se3_exp(torch.from_numpy(rng.normal(0, 0.05, 6).astype(np.float32))).numpy()
    pc = X @ T_true[:3, :3].T + T_true[:3, 3]
    u = FX * pc[:, 0] / pc[:, 2] + CX
    v = FY * pc[:, 1] / pc[:, 2] + CY
    uv = np.stack([u, v], 1) + rng.normal(0, 0.7, (n, 2))
    bad = rng.rand(n) < 0.15
    uv[bad] = rng.uniform([0, 0], [640, 480], (bad.sum(), 2))
    inv_s2 = (1.0 / 1.2 ** (2.0 * rng.randint(0, 4, n))).astype(np.float32)
    valid = rng.rand(n) > 0.1
    ur = np.full(n, -1.0, np.float32)
    if stereo:
        has = rng.rand(n) < 0.5
        ur[has] = (u - BF / pc[:, 2] + rng.normal(0, 0.7, n))[has]
    T_init = geo.se3_exp(torch.from_numpy(rng.normal(0, 0.02, 6).astype(np.float32))).numpy() @ T_true
    t = {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
         for k, a in (("T", T_init.astype(np.float32)), ("X", X), ("uv", uv.astype(np.float32)),
                      ("inv_s2", inv_s2), ("valid", valid), ("ur", ur))}
    return (t["T"], t["X"], t["uv"], t["inv_s2"], t["valid"]), {"ur": t["ur"], "bf": BF if stereo else 0.0}


def _scene(case, seed, n=300, device="cpu", dtype=torch.float32):
    """``_problem``'s mono, stereo and no-``ur`` scenes, a scene with no valid
    observation, and ``converged``: the mono scene started at the body's own
    result in ``dtype``."""
    args, kw = _problem(seed, n=n, stereo=case == "stereo")
    if case == "no_ur":
        kw = {}
    if case == "all_invalid":
        args = (*args[:4], torch.zeros_like(args[4]))
    args = tuple(a.to(dtype) if a.is_floating_point() else a for a in args)
    kw = {k: v.to(dtype) if torch.is_tensor(v) else v for k, v in kw.items()}
    if case == "converged":
        args = (lm._optimize_pose_body(*args, FX, FY, CX, CY, **kw)[0].contiguous(), *args[1:])
    move = (lambda t: t.to(device)) if device != "cpu" else (lambda t: t)
    return tuple(move(a) for a in args), {k: move(v) if torch.is_tensor(v) else v for k, v in kw.items()}


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["mono", "stereo", "no_ur"])
def test_cpu_calls_run_the_plain_body_and_count_it(case):
    args, kw = _scene(case, seed=3)
    before = cuda_pose.counts()
    got = lm.optimize_pose(*args, FX, FY, CX, CY, **kw)
    want = lm._optimize_pose_body(*args, FX, FY, CX, CY, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[1].dtype == torch.bool and got[2].dtype == torch.int32
    assert cuda_pose.counts() == {"launches": before["launches"], "plain": before["plain"] + 1}


def _meta_call(change):
    """``optimize_pose`` on meta tensors of the right kinds, with one input or
    constant replaced by ``change(inputs)``: a dict of the names it sets."""
    n = 64
    meta = dict(device="meta")
    inputs = {"T_init": torch.empty(4, 4, **meta), "points": torch.empty(n, 3, **meta),
              "uv": torch.empty(n, 2, **meta), "inv_sigma2": torch.empty(n, **meta),
              "valid": torch.empty(n, dtype=torch.bool, **meta), "fx": FX, "fy": FY, "cx": CX, "cy": CY,
              "ur": torch.empty(n, **meta), "rounds": 4, "iters_per_round": 10}
    inputs.update(change(inputs))
    return lm.optimize_pose(**inputs)


@pytest.mark.parametrize("change, message", [
    (lambda i: {"T_init": torch.empty(4, 4, dtype=torch.float64, device="meta")}, "T_init must be"),
    (lambda i: {"points": torch.empty(64, 4, device="meta")}, "points must be"),
    (lambda i: {"uv": torch.empty(65, 2, device="meta")}, "uv must be"),
    (lambda i: {"inv_sigma2": torch.empty(64, dtype=torch.float16, device="meta")}, "inv_sigma2 must be"),
    (lambda i: {"valid": torch.empty(64, dtype=torch.uint8, device="meta")}, "valid must be"),
    (lambda i: {"ur": torch.empty(64, 1, device="meta")}, "ur must be"),
    (lambda i: {"uv": torch.empty(2, 64, device="meta").T}, "not contiguous"),
    (lambda i: {"points": torch.empty(64, 6, device="meta")[:, ::2]}, "not contiguous"),
    (lambda i: {"ur": torch.empty(64)}, "ur is on cpu"),
    (lambda i: {"fx": torch.tensor(FX)}, "Python numbers"),
    (lambda i: {"rounds": 4.0}, "whole numbers"),
    (lambda i: {"iters_per_round": -1}, "whole numbers"),
    (lambda i: {}, "unsupported device meta"),
], ids=["T_dtype", "points_shape", "uv_rows", "inv_sigma2_dtype", "valid_dtype", "ur_shape", "uv_strides",
        "points_strides", "two_devices", "constant_tensor", "rounds_float", "iters_negative", "meta_device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(change, message):
    before = cuda_pose.counts()
    with pytest.raises(ValueError, match=message):
        _meta_call(change)
    assert cuda_pose.counts() == before


def _rows(T, X, uv, ur, fx, fy, cx, cy, bf):
    """The kernel's ``project`` and ``linearize``: residual rows (N, 3), the
    Jacobian rows (N, 3, 6) written out, and whether the stereo row is on."""
    p = X @ T[:3, :3].T + T[:3, 3]
    px, py, pz = p.unbind(-1)
    shallow = torch.abs(pz) < 1e-6
    z = torch.where(shallow, torch.full_like(pz, 1e-6), pz)
    live = (~shallow).to(p.dtype)
    u, v = fx * px / z + cx, fy * py / z + cy
    stereo = ur >= 0
    r = torch.stack([u - uv[:, 0], v - uv[:, 1], torch.where(stereo, (u - bf / z) - ur, 0.0)], -1)
    iz = 1.0 / z
    A, B = fx * iz, fy * iz
    C, E = -fx * px * iz * iz * live, -fy * py * iz * iz * live
    F = C + bf * iz * iz * live
    zero = torch.zeros_like(A)
    J = torch.stack([
        torch.stack([C * py, A * pz - C * px, -A * py, A, zero, C], -1),
        torch.stack([-B * pz + E * py, -E * px, B * px, zero, B, E], -1),
        torch.stack([F * py, A * pz - F * px, -A * py, A, zero, F], -1) * stereo[:, None].to(p.dtype),
    ], -2)
    return r, J, stereo


def _kernel_order(T_init, points, uv, inv_sigma2, valid, fx, fy, cx, cy, chi2_th=CHI2_TH, rounds=4,
                  iters_per_round=10, ur=None, bf=0.0, chi2_th_stereo=CHI2_TH_STEREO):
    """The LM in the kernel's order of work: the system at a round's start,
    then per iteration one pass at the trial pose that gives its cost and
    its system, kept if the step is taken; a round ends at its first taken
    step <= 1e-6.  Returns the body's outputs and the iterations run."""
    dt = points.dtype
    if ur is None:
        ur = torch.full((points.shape[0],), -1.0, dtype=dt)

    def system(T, inlier, huber):
        r, J, stereo = _rows(T, points, uv, ur, fx, fy, cx, cy, bf)
        lim = torch.where(stereo, chi2_th_stereo, chi2_th).to(dt)
        chi2 = torch.sum(r * r, -1) * inv_sigma2
        w = (fac.huber_weight(chi2, lim) if huber else 1.0) * inlier * inv_sigma2
        H = torch.einsum("nkp,n,nkq->pq", J, w, J)
        g = torch.einsum("nkp,n,nk->p", J, w, r)
        rho = torch.sum((lm._rho_huber(chi2, lim) if huber else chi2) * inlier)
        return H, g, rho, chi2 <= lim

    T = geo.se3_renorm(T_init)
    inlier = valid.to(dt)
    iterations = 0
    for rnd in range(rounds):
        huber = rnd < 2
        if rnd > 0:
            inlier = (valid & system(T, inlier, huber)[3]).to(dt)
        H, g, rho, _ = system(T, inlier, huber)
        lam, dn = 1e-3, 1.0
        for _ in range(iters_per_round):
            if not dn > 1e-6:
                break
            iterations += 1
            A = H + lam * torch.diag(torch.diagonal(H)) + 1e-6 * torch.eye(6, dtype=dt)
            delta = torch.linalg.solve(A, -g)
            T_new = geo.se3_exp(delta) @ T
            H_new, g_new, rho_new, _ = system(T_new, inlier, huber)
            dn_new = torch.linalg.vector_norm(delta)
            if rho_new < rho and torch.all(torch.isfinite(T_new)) and torch.isfinite(dn_new):
                T, H, g, rho, dn = T_new, H_new, g_new, rho_new, float(dn_new)
                lam = max(lam * 0.3, 1e-7)
            else:
                lam = min(lam * 8.0, 1e4)
    if rounds > 0:
        inlier = (valid & system(T, inlier, False)[3]).to(dt)
    return T, inlier.bool(), torch.sum(inlier).to(torch.int32), iterations


# A round's last steps can be ~1e-9 (the stereo scene's third round: 1.6e-9
# and 1.4e-9), and whether such a step lowers rho is decided by float64
# rounding, which the two orders of summation round differently; a step
# that one takes and the other refuses moves T by its own size.
ORDER_ATOL = 1e-8


@pytest.mark.parametrize("case, n", [("mono", 300), ("stereo", 300), ("no_ur", 300), ("mono", 12),
                                     ("all_invalid", 300), ("converged", 300)])
def test_kernel_order_equals_the_body_in_float64(case, n):
    """T within ``ORDER_ATOL``, the same inliers."""
    args, kw = _scene(case, seed=5, n=n, dtype=torch.float64)
    T, inl, cnt, iterations = _kernel_order(*args, FX, FY, CX, CY, **kw)
    want = lm._optimize_pose_body(*args, FX, FY, CX, CY, **kw)
    np.testing.assert_allclose(T.numpy(), want[0].numpy(), atol=ORDER_ATOL, rtol=0)
    assert torch.equal(inl, want[1]) and int(cnt) == int(want[2])
    assert iterations <= 40


def test_early_exit_skips_only_frozen_iterations():
    """From the body's own float64 result every round ends after a few
    iterations, and the result is the body's, which ran all 40."""
    args, kw = _scene("converged", seed=7, dtype=torch.float64)
    T, inl, cnt, iterations = _kernel_order(*args, FX, FY, CX, CY, **kw)
    want = lm._optimize_pose_body(*args, FX, FY, CX, CY, **kw)
    assert iterations < 20
    np.testing.assert_allclose(T.numpy(), want[0].numpy(), atol=ORDER_ATOL, rtol=0)
    assert torch.equal(inl, want[1]) and int(cnt) == int(want[2])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _near_threshold(T, args, kw):
    """Per observation: chi2 at pose ``T`` within 1e-3 relative of its
    threshold (float64 on the host), where the kernel's and the body's
    float32 sums may classify it either way."""
    T_init, X, uv, inv_s2, _ = (a.detach().cpu().double() if a.is_floating_point() else a.cpu() for a in args)
    ur = kw.get("ur")
    ur = torch.full((X.shape[0],), -1.0, dtype=torch.float64) if ur is None else ur.cpu().double()
    r, _, stereo = _rows(T.cpu().double(), X, uv, ur, FX, FY, CX, CY, kw.get("bf", 0.0))
    chi2 = torch.sum(r * r, -1) * inv_s2
    lim = torch.where(stereo, CHI2_TH_STEREO, CHI2_TH).double()
    return torch.abs(chi2 / lim - 1.0) < 1e-3


def _hold(got, want, args, kw, what):
    """T within 1e-4 (``test_torch_lm.py``'s tolerance for the body against
    the JAX package); inlier masks and counts exact except observations
    within 1e-3 of their threshold.  Returns how many of those differ."""
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(), atol=1e-4, rtol=0, err_msg=what)
    differ = (got[1] != want[1]).cpu()
    near = _near_threshold(want[0], args, kw)
    assert not bool((differ & ~near).any()), f"{what}: {int((differ & ~near).sum())} masks differ away from the threshold"
    assert abs(int(got[2]) - int(want[2])) <= int(differ.sum()), what
    assert int(got[2]) == int(got[1].sum()), what
    n_near = int(differ.sum())
    print(f"{what}: {n_near} near-threshold observations classified otherwise; max |dT| "
          f"{float((got[0] - want[0]).abs().max()):.2e}")
    return n_near


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mono", "stereo", "no_ur", "all_invalid", "converged"])
@pytest.mark.parametrize("n", [1024, 1000])
def test_kernel_matches_the_body_on_card(cuda_device, case, n):
    for seed in (11, 12):
        args, kw = _scene(case, seed=seed, n=n, device=cuda_device)
        got = lm.optimize_pose(*args, FX, FY, CX, CY, **kw)
        want = lm._optimize_pose_body(*args, FX, FY, CX, CY, **kw)
        torch.cuda.synchronize(cuda_device)
        assert all(t.device == cuda_device for t in got)
        assert got[0].dtype == torch.float32 and got[1].dtype == torch.bool and got[2].dtype == torch.int32
        assert got[0].shape == (4, 4) and got[1].shape == (n,) and got[2].shape == ()
        _hold(got, want, args, kw, f"{case} n={n} seed={seed}")
        if case == "all_invalid":
            assert int(got[2]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mono", "stereo"])
def test_two_launches_give_the_same_bits(cuda_device, case):
    args, kw = _scene(case, seed=21, n=1024, device=cuda_device)
    a = lm.optimize_pose(*args, FX, FY, CX, CY, **kw)
    b = lm.optimize_pose(*args, FX, FY, CX, CY, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(x.data_ptr() != y.data_ptr() for x, y in zip(a, b))


@pytest.mark.cuda
def test_launch_count_counts_every_card_call(cuda_device):
    before = cuda_pose.counts()
    for seed in (31, 32, 33):
        args, kw = _scene("mono", seed=seed, n=1024, device=cuda_device)
        lm.optimize_pose(*args, FX, FY, CX, CY, **kw)
    assert cuda_pose.counts() == {"launches": before["launches"] + 3, "plain": before["plain"]}


@pytest.mark.cuda
def test_kernel_on_a_card_that_is_not_the_current_one():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: the inputs on one while the other is current")
    dev = torch.device("cuda", 1)
    with torch.cuda.device(0):
        for seed in (41, 42):
            args, kw = _scene("stereo", seed=seed, n=1024, device=dev)
            got = lm.optimize_pose(*args, FX, FY, CX, CY, **kw)
            assert all(t.device == dev for t in got)
            _hold(got, lm._optimize_pose_body(*args, FX, FY, CX, CY, **kw), args, kw, f"cuda:1 seed={seed}")
        assert torch.cuda.current_device() == 0
