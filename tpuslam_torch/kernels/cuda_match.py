"""Kernel K2: Hamming nearest + second-nearest search (port of
``tpuslam/kernels/pallas_match.py:hamming_top2``).

The CUDA source is ``csrc/hamming_top2.cu``.  A CPU tensor goes to the plain
PyTorch version, :func:`hamming_top2_plain` (the reference's dense
``_dense_top2``); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

SOURCE = "tpuslam_torch/kernels/csrc/hamming_top2.cu"
REPLACES = "tpuslam/kernels/pallas_match.py:89"
BIG = 1e9  # cost of an invalid column
MAX_ROWS = 16 * 65535  # the grid's y extent, 16 query rows a block


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("hamming_top2")
    fn = lib.hamming_top2_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def hamming_top2_plain(desc_a, desc_b, valid_b):
    """Dense reference: (idx (N,) int32, d1 (N,) f32, d2 (N,) f32)."""
    from .match import hamming_matrix, masked_argmin2

    dist = torch.where(valid_b[None, :], hamming_matrix(desc_a, desc_b), BIG)
    idx, d1, d2 = masked_argmin2(dist)
    return idx.to(torch.int32), d1, d2


def hamming_top2(desc_a, desc_b, valid_b):
    """(N, 8), (M, 8) int32 descriptor words, (M,) bool ->
    (idx (N,) int32, d1 (N,) float32, d2 (N,) float32)."""
    if desc_a.device.type == "cpu":
        return hamming_top2_plain(desc_a, desc_b, valid_b)
    if desc_a.device.type != "cuda":
        raise ValueError(f"hamming_top2: unsupported device {desc_a.device}")
    N, M = desc_a.shape[0], desc_b.shape[0]
    ok = (
        desc_b.device == desc_a.device and valid_b.device == desc_a.device
        and desc_a.dtype == desc_b.dtype == torch.int32 and valid_b.dtype == torch.bool
        and desc_a.shape == (N, 8) and desc_b.shape == (M, 8) and valid_b.shape == (M,)
        and 0 < N <= MAX_ROWS and M > 0
        and desc_a.is_contiguous() and desc_b.is_contiguous() and valid_b.is_contiguous()
        and desc_a.data_ptr() % 16 == 0 and desc_b.data_ptr() % 16 == 0  # 16-byte loads
    )
    if not ok:
        raise ValueError(
            "hamming_top2: needs contiguous (N, 8) and (M, 8) int32 and (M,) bool on one "
            f"device, 0 < N <= {MAX_ROWS}, M > 0, 16-byte aligned; got "
            f"{tuple(desc_a.shape)} {desc_a.dtype}, "
            f"{tuple(desc_b.shape)} {desc_b.dtype}, {tuple(valid_b.shape)} {valid_b.dtype}"
        )
    idx = torch.empty(N, dtype=torch.int32, device=desc_a.device)
    d1 = torch.empty(N, dtype=torch.float32, device=desc_a.device)
    d2 = torch.empty(N, dtype=torch.float32, device=desc_a.device)
    launch = _library()
    with torch.cuda.device(desc_a.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            launch(desc_a.data_ptr(), desc_b.data_ptr(), valid_b.data_ptr(), N, M,
                   idx.data_ptr(), d1.data_ptr(), d2.data_ptr(), stream),
            "hamming_top2",
        )
    hamming_top2.launches += 1
    return idx, d1, d2


hamming_top2.launches = 0
