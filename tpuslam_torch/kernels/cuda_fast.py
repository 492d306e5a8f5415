"""Kernel K1: fused dense FAST-9 + 3x3 NMS (port of
``tpuslam/kernels/pallas_fast.py:fast_nms_score``).

The CUDA source is ``csrc/fast_nms.cu``.  A CPU tensor goes to the plain
PyTorch version, ``orb.fast_nms_plain``; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

SOURCE = "tpuslam_torch/kernels/csrc/fast_nms.cu"
REPLACES = "tpuslam/kernels/pallas_fast.py:98"


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("fast_nms")
    fn = lib.fast_nms_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def fast_nms_score(pyramid, strict_th: float = 20.0, weak_th: float = 7.0, live_dims=None):
    """(L, H, W) float32 pyramid -> (L, H, W) NMS'd FAST score map.

    ``live_dims``, optional, is an (L, 2) int32 tensor of each level's live
    (h, w); the caller guarantees the pyramid is zero outside the top-left
    h x w region of each level.  The kernel then skips the tiles whose
    wrapped 4-px window holds no live pixel; the result is the same.

    The kernel needs ``weak_th >= 0``: then no pixel has both a bright and a
    dark weak run, and it tests the strict threshold on its weak run's side
    only.  Any ``strict_th`` is exact.
    """
    if pyramid.device.type == "cpu":
        from .orb import fast_nms_plain

        return fast_nms_plain(pyramid, strict_th, weak_th)
    if pyramid.device.type != "cuda":
        raise ValueError(f"fast_nms_score: unsupported device {pyramid.device}")
    if (pyramid.dtype != torch.float32 or pyramid.dim() != 3 or not pyramid.is_contiguous()
            or pyramid.data_ptr() % 16 != 0):  # 16-byte loads of interior tiles
        raise ValueError(
            "fast_nms_score: needs a contiguous, 16-byte aligned (L, H, W) float32 tensor, got "
            f"{tuple(pyramid.shape)} {pyramid.dtype} at offset {pyramid.storage_offset()}"
        )
    if not weak_th >= 0:
        raise ValueError(f"fast_nms_score: the kernel needs weak_th >= 0, got {weak_th}")
    L, H, W = pyramid.shape
    if live_dims is not None and not (
        live_dims.device == pyramid.device and live_dims.dtype == torch.int32
        and live_dims.shape == (L, 2) and live_dims.is_contiguous()
    ):
        raise ValueError(
            f"fast_nms_score: live_dims must be a contiguous ({L}, 2) int32 tensor on "
            f"{pyramid.device}, got {tuple(live_dims.shape)} {live_dims.dtype} on {live_dims.device}"
        )
    out = torch.empty_like(pyramid)
    launch = _library()
    with torch.cuda.device(pyramid.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            launch(pyramid.data_ptr(), out.data_ptr(), L, H, W, strict_th, weak_th,
                   None if live_dims is None else live_dims.data_ptr(), stream),
            "fast_nms",
        )
    fast_nms_score.launches += 1
    return out


fast_nms_score.launches = 0
