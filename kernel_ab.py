#!/usr/bin/env python3
"""Time kernels K1 and K2 against an earlier version of their sources, in
turns, on one card.

    python3 kernel_ab.py --parent DIR

``DIR`` holds the earlier ``fast_nms.cu`` and ``hamming_top2.cu`` (for
example from ``git show <commit>:tpuslam_torch/kernels/csrc/fast_nms.cu``);
they must export the launch functions under the same names, ``fast_nms``'s
without the trailing ``live_dims`` argument.  Both versions are built with
the same flags and run on the main path's inputs: frame 0's (8, 480, 640)
pyramid for K1 (the current kernel given the live level sizes, as
``OrbExtractor`` calls it) and frame 0's descriptors against keyframe 0's
(1024 x 1024) for K2.  The outputs of the two versions must be equal.  Each
of three rounds times earlier, current, current, earlier by device time
(``tpuslam_torch/kernels/timing.py:device_ms``, the mean of 200 launches).
Prints one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from tpuslam_torch import workload
from tpuslam_torch.kernels import build, cuda_fast, cuda_match
from tpuslam_torch.kernels.timing import device_ms

ROUNDS = 3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device is visible")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    parent = args.parent.resolve()
    p_fast = build.load_source(parent / "fast_nms.cu").fast_nms_launch
    p_fast.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    p_fast.restype = ctypes.c_int
    p_top2 = build.load_source(parent / "hamming_top2.cu").hamming_top2_launch
    p_top2.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
    p_top2.restype = ctypes.c_int

    wl = workload.build_workload(dev)
    pyr = wl.extractor.pyramid(wl.frames[0])
    dims = wl.extractor.live_dims
    a, b = wl.kf0.desc, wl.map.kf_desc[0]
    valid = (wl.kf0_pt >= 0) & wl.kf0.valid
    L, H, W = pyr.shape
    N, M = a.shape[0], b.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    out_p = torch.empty_like(pyr)
    idx_p = torch.empty(N, dtype=torch.int32, device=dev)
    d1_p, d2_p = torch.empty(N, device=dev), torch.empty(N, device=dev)

    def parent_k1():
        build.check(p_fast(pyr.data_ptr(), out_p.data_ptr(), L, H, W, 20.0, 7.0, stream), "parent fast_nms")

    def parent_k2():
        build.check(p_top2(a.data_ptr(), b.data_ptr(), valid.data_ptr(), N, M, idx_p.data_ptr(),
                           d1_p.data_ptr(), d2_p.data_ptr(), stream), "parent hamming_top2")

    kernels = {
        "fast_nms": (parent_k1, lambda: cuda_fast.fast_nms_score(pyr, 20.0, 7.0, dims)),
        "hamming_top2": (parent_k2, lambda: cuda_match.hamming_top2(a, b, valid)),
    }

    parent_k1()
    parent_k2()
    new_k1 = kernels["fast_nms"][1]()
    new_k2 = kernels["hamming_top2"][1]()
    torch.cuda.synchronize()
    if not torch.equal(out_p, new_k1):
        raise RuntimeError("kernel_ab: fast_nms differs from the earlier version")
    if not all(torch.equal(x, y) for x, y in zip((idx_p, d1_p, d2_p), new_k2)):
        raise RuntimeError("kernel_ab: hamming_top2 differs from the earlier version")

    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "shapes": {"fast_nms": [L, H, W], "hamming_top2": [N, M]},
              "device_ms": {name: {"parent": [], "current": []} for name in kernels}}
    for r in range(ROUNDS):
        for name, (earlier, current) in kernels.items():
            p1, c1, c2, p2 = (device_ms(f) for f in (earlier, current, current, earlier))
            result["device_ms"][name]["parent"] += [p1, p2]
            result["device_ms"][name]["current"] += [c1, c2]
            print(f"round {r} {name}: parent {p1:.5f} {p2:.5f} ms, current {c1:.5f} {c2:.5f} ms", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
