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
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def fast_nms_score(pyramid, strict_th: float = 20.0, weak_th: float = 7.0):
    """(L, H, W) float32 pyramid -> (L, H, W) NMS'd FAST score map."""
    if pyramid.device.type == "cpu":
        from .orb import fast_nms_plain

        return fast_nms_plain(pyramid, strict_th, weak_th)
    if pyramid.device.type != "cuda":
        raise ValueError(f"fast_nms_score: unsupported device {pyramid.device}")
    if pyramid.dtype != torch.float32 or pyramid.dim() != 3 or not pyramid.is_contiguous():
        raise ValueError(
            "fast_nms_score: needs a contiguous (L, H, W) float32 tensor, got "
            f"{tuple(pyramid.shape)} {pyramid.dtype}"
        )
    L, H, W = pyramid.shape
    out = torch.empty_like(pyramid)
    launch = _library()
    with torch.cuda.device(pyramid.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            launch(pyramid.data_ptr(), out.data_ptr(), L, H, W, strict_th, weak_th, stream),
            "fast_nms",
        )
    fast_nms_score.launches += 1
    return out


fast_nms_score.launches = 0
