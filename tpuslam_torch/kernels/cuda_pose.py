"""The motion-only pose LM in one launch (``graph/lm.py:optimize_pose``).

The CUDA source is ``csrc/pose_lm.cu``; it replaces no TPU kernel (the JAX
package leaves the pose LM to XLA).  A CPU tensor goes to the plain PyTorch
version, ``lm._optimize_pose_body``; a CUDA tensor launches the kernel or
raises.  :func:`counts` gives the kernel's launches and the plain calls.
"""

from __future__ import annotations

import ctypes
import functools
import numbers

import torch

from . import build

SOURCE = "tpuslam_torch/kernels/csrc/pose_lm.cu"


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("pose_lm")
    fn = lib.pose_lm_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_float] * 7 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    return fn


def check_inputs(T_init, points, uv, inv_sigma2, valid, ur, consts) -> None:
    """Raise ``ValueError`` unless the inputs are what the kernel takes: one
    device; contiguous float32 ``T_init`` (4, 4), ``points`` (N, 3), ``uv``
    (N, 2), ``inv_sigma2`` (N,) and ``ur`` (N,) or None, and bool ``valid``
    (N,); the constants Python numbers (a tensor would be read back to the
    host), the trip counts whole and not negative."""
    n = points.shape[0] if points.dim() == 2 else -1
    want = {"T_init": (T_init, (4, 4), torch.float32), "points": (points, (n, 3), torch.float32),
            "uv": (uv, (n, 2), torch.float32), "inv_sigma2": (inv_sigma2, (n,), torch.float32),
            "valid": (valid, (n,), torch.bool), "ur": (ur, (n,), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if t is None and name == "ur":
            continue
        if t.device != points.device:
            raise ValueError(f"optimize_pose: {name} is on {t.device}, points on {points.device}")
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"optimize_pose: {name} must be a contiguous {shape} {dtype} tensor "
                             f"(N = points' rows), got {tuple(t.shape)} {t.dtype}"
                             f"{'' if t.is_contiguous() else ', not contiguous'}")
    if n >= 2**31:
        raise ValueError(f"optimize_pose: {n} observations, the kernel indexes them with 32-bit integers")
    fx, fy, cx, cy, chi2_th, rounds, iters_per_round, bf, chi2_th_stereo = consts
    if not all(isinstance(c, numbers.Real) and not isinstance(c, bool) for c in consts):
        raise ValueError(f"optimize_pose: the camera, thresholds and trip counts must be Python numbers, got "
                         f"{[type(c).__name__ for c in consts]}")
    if not all(isinstance(c, numbers.Integral) and c >= 0 for c in (rounds, iters_per_round)):
        raise ValueError(f"optimize_pose: rounds and iters_per_round must be whole numbers >= 0, got "
                         f"{rounds}, {iters_per_round}")


def pose_lm(T_init, points, uv, inv_sigma2, valid, fx, fy, cx, cy, chi2_th, rounds, iters_per_round, ur, bf,
            chi2_th_stereo):
    """``lm.optimize_pose``'s arguments, all given -> (T_opt (4, 4), inlier
    mask (N,) bool, n_inliers () int32), new tensors on the inputs' device."""
    tensors = (T_init, points, uv, inv_sigma2, valid, ur)
    if all(t is None or t.device.type == "cpu" for t in tensors):
        from ..graph.lm import _optimize_pose_body

        pose_lm.plain_calls += 1
        return _optimize_pose_body(T_init, points, uv, inv_sigma2, valid, fx, fy, cx, cy, chi2_th, rounds,
                                   iters_per_round, ur, bf, chi2_th_stereo)
    consts = (fx, fy, cx, cy, chi2_th, rounds, iters_per_round, bf, chi2_th_stereo)
    check_inputs(T_init, points, uv, inv_sigma2, valid, ur, consts)
    dev = points.device
    if dev.type != "cuda":
        raise ValueError(f"optimize_pose: unsupported device {dev}")
    n = points.shape[0]
    T_out = torch.empty(4, 4, dtype=torch.float32, device=dev)
    inlier = torch.empty(n, dtype=torch.bool, device=dev)
    n_inliers = torch.empty((), dtype=torch.int32, device=dev)
    launch = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            launch(T_init.data_ptr(), points.data_ptr(), uv.data_ptr(), inv_sigma2.data_ptr(), valid.data_ptr(),
                   None if ur is None else ur.data_ptr(), n, fx, fy, cx, cy, bf, chi2_th, chi2_th_stereo,
                   rounds, iters_per_round, T_out.data_ptr(), inlier.data_ptr(), n_inliers.data_ptr(), stream),
            "pose_lm",
        )
    pose_lm.launches += 1
    return T_out, inlier, n_inliers


pose_lm.launches = 0
pose_lm.plain_calls = 0


def counts() -> dict:
    """``optimize_pose`` calls so far in this process: kernel launches
    (``launches``: CUDA tensors) and plain calls (``plain``: CPU tensors)."""
    return {"launches": pose_lm.launches, "plain": pose_lm.plain_calls}
