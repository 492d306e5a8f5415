#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (``tpuslam_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

In order, it
  1. checks for a card and prints its name and power limit (nvidia-smi);
  2. builds both CUDA kernels from ``tpuslam_torch/kernels/csrc``, one nvcc
     process per source, started together;
  3. holds kernel K1 (FAST + NMS) against its plain PyTorch version: frame
     0's (8, 480, 640) pyramid with and without the live level sizes, the
     4-level 240x320 pyramid of the small workload with them, and a random
     (3, 37, 45) array.  The arrays must be equal (max |err| 0) with the
     same number of corners;
  4. holds kernel K2 (Hamming top-2) against its plain version on frame 0's
     and frame 1's descriptors against keyframe 0's (1024 x 1024), random
     4096 x 4096 and 1000 x 777 with ~20% invalid columns, M = 1, all
     columns invalid, and all columns tied (every B row the same): idx, d1
     and d2 equal;
  5. runs the 64-frame tracking slice (``tpuslam_torch.workload``) at full
     width: 480x640 frames, 1024 features, a map of 512 keyframes and 32768
     points, 4096 local points.  Gates: no host sync in a pass, median final
     inliers 453.5 and final camera x 1.8884 m (the slice's known outcome,
     which exact kernels must not move), every frame finite, each kernel
     launched exactly once per frame; and a 4-frame 240x320 run on the card
     must agree with the same run on the CPU (plain versions);
  6. prints the slice's frames/s and each kernel's device time (launches
     queued behind a spin, ``kernels/timing.py``) beside its bound and its
     plain version's host-paced time, then one JSON line of kernels, the
     card line, and the result.

It imports nothing of JAX.  Any failed phase raises, and the script exits
non-zero without printing the result line.
"""

from __future__ import annotations

import json
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys
import time
import warnings

import numpy as np
import torch


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# NVIDIA H100 SXM peaks (data sheet, dense): memory and int8 tensor cores
HBM_BYTES_PER_MS = 3.35e12 / 1e3
INT8_OPS_PER_MS = 1979e12 / 1e3

def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED {what}")
    print(f"ok: {what}", flush=True)


def check_k1(cases, cuda_fast, orb, timing):
    """Each case: (pyramid, live dims or None).  Equal arrays required."""
    err = 0.0
    for name, (pyr, dims) in cases.items():
        got = cuda_fast.fast_nms_score(pyr, 20.0, 7.0, dims)
        ref = orb.fast_nms_plain(pyr, 20.0, 7.0)
        err = max(err, float((got - ref).abs().max()))
        n_got, n_ref = int((got > 0).sum()), int((ref > 0).sum())
        check(torch.equal(got, ref), f"K1 fast_nms == plain, {name} {tuple(pyr.shape)}, max |err| {err}")
        check(n_got == n_ref, f"K1 corner count {n_got} == plain {n_ref}, {name}")
    pyr, dims = cases["main_path"]
    check(int((orb.fast_nms_plain(pyr) > 0).sum()) > 0, "K1 main path has corners")
    ms = timing.device_ms(lambda: cuda_fast.fast_nms_score(pyr, 20.0, 7.0, dims))
    # given the live level sizes, the call needs only the live pixels in;
    # it writes the whole map
    live_px = int((dims[:, 0] * dims[:, 1]).sum())
    bound_ms = (live_px + pyr.numel()) * 4 / HBM_BYTES_PER_MS
    print(f"K1 bound: {live_px} live of {pyr.numel()} pixels read, {bound_ms * 1e3:.3f} us "
          f"(whole array: {2 * pyr.numel() * 4 / HBM_BYTES_PER_MS * 1e3:.3f} us)", flush=True)
    return {
        "max_abs_err": err,
        "ms": ms,
        # the plain versions allocate as they go, which waits for the device:
        # their time is the host-paced one
        "plain_ms": timing.host_paced_ms(lambda: orb.fast_nms_plain(pyr, 20.0, 7.0), reps=10, warmup=2),
        "bound_ms": bound_ms, "bound_by": "bytes", "bound_kind": "memory",
        "share_of_bound": bound_ms / ms, "library_ms": None,
        "host_paced_ms": timing.host_paced_ms(lambda: cuda_fast.fast_nms_score(pyr, 20.0, 7.0, dims)),
    }


def check_k2(cases, cuda_match, timing):
    err = 0.0
    for name, (a, b, valid) in cases.items():
        idx, d1, d2 = cuda_match.hamming_top2(a, b, valid)
        ridx, rd1, rd2 = cuda_match.hamming_top2_plain(a, b, valid)
        err = max(err, float((d1 - rd1).abs().max()), float((d2 - rd2).abs().max()))
        same = torch.equal(idx, ridx) and torch.equal(d1, rd1) and torch.equal(d2, rd2)
        check(same, f"K2 hamming_top2 == plain, {name} {tuple(a.shape)} x {tuple(b.shape)}")
    a, b, valid = cases["frame0_vs_kf0"]
    n, m = a.shape[0], b.shape[0]
    ops_ms = 2 * n * m * 256 / INT8_OPS_PER_MS  # the +-1 int8 product
    bytes_ms = (n * 32 + m * 33 + n * 12) / HBM_BYTES_PER_MS
    ms = timing.device_ms(lambda: cuda_match.hamming_top2(a, b, valid))
    return {
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": timing.host_paced_ms(lambda: cuda_match.hamming_top2_plain(a, b, valid), reps=20, warmup=2),
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "bound_kind": "int8_tensor" if ops_ms >= bytes_ms else "memory",
        "share_of_bound": max(ops_ms, bytes_ms) / ms, "library_ms": None,
        "host_paced_ms": timing.host_paced_ms(lambda: cuda_match.hamming_top2(a, b, valid)),
    }


def random_descriptors(n, seed, device):
    rng = np.random.RandomState(seed)
    words = rng.randint(0, 1 << 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(words.view(np.int32)).to(device)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run", file=sys.stderr)
        return 2
    import tpuslam_torch  # noqa: F401  (pins float32 matmuls)
    from tpuslam_torch import workload
    from tpuslam_torch.kernels import build, cuda_fast, cuda_match, orb, timing

    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)

    # --- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    names = ("fast_nms", "hamming_top2")
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(build.load, names))
    for name in names:
        log = build.library_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "ptxas info" in line and ("Used" in line or "spill" in line):
                    print(f"{name}: {line.strip()}")
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.3f} s for both kernels", flush=True)

    # --- 3, 4. kernels against their plain versions ----------------------------
    wl = workload.build_workload(dev)
    small = workload.build_workload(dev, **workload.SMALL)
    torch.cuda.synchronize()
    pyr0 = wl.extractor.pyramid(wl.frames[0])
    odd = torch.from_numpy(np.random.RandomState(3).uniform(0, 255, (3, 37, 45)).astype(np.float32)).to(dev)
    k1 = check_k1(
        {
            "main_path": (pyr0, wl.extractor.live_dims),
            "main_path_whole_array": (pyr0, None),
            "small_4_level": (small.extractor.pyramid(small.frames[0]), small.extractor.live_dims),
            "odd_3x37x45": (odd, None),
        },
        cuda_fast, orb, timing,
    )
    f1 = wl.extractor(wl.frames[1])
    kf_valid = (wl.kf0_pt >= 0) & wl.kf0.valid
    rand_valid = torch.from_numpy(np.random.RandomState(2).rand(4096) > 0.2).to(dev)
    b777 = random_descriptors(777, 5, dev)
    k2 = check_k2(
        {
            "frame0_vs_kf0": (wl.kf0.desc, wl.map.kf_desc[0], kf_valid),
            "frame1_vs_kf0": (f1.desc, wl.map.kf_desc[0], kf_valid),
            "random_4096": (random_descriptors(4096, 0, dev), random_descriptors(4096, 1, dev), rand_valid),
            "random_1000x777": (random_descriptors(1000, 4, dev), b777, rand_valid[:777].contiguous()),
            "m_1": (random_descriptors(1000, 4, dev), b777[:1].contiguous(), rand_valid[:1] | True),
            "all_invalid": (random_descriptors(1000, 4, dev), b777, torch.zeros_like(rand_valid[:777])),
            "all_ties": (random_descriptors(1000, 4, dev), b777[:1].repeat(777, 1).contiguous(),
                         rand_valid[:777].contiguous()),
        },
        cuda_match, timing,
    )

    # --- 5. the slice ----------------------------------------------------------
    # a warm-up pass, then a pass that counts the host syncs of the frame path
    workload.run_slice(wl)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        workload.run_slice(wl)
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = Counter(f"{w.filename}:{w.lineno}" for w in caught if "synchroniz" in str(w.message))
    host_syncs = sum(syncs.values())
    print(f"host syncs in one 64-frame pass: {host_syncs} {dict(syncs.most_common(8))}", flush=True)

    cuda_fast.fast_nms_score.launches = 0
    cuda_match.hamming_top2.launches = 0
    t0 = time.perf_counter()
    traj, scalars = workload.run_slice(wl)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"fast_nms": cuda_fast.fast_nms_score.launches,
                "hamming_top2": cuda_match.hamming_top2.launches}
    n_frames = wl.frames.shape[0]
    fps = n_frames / dt

    traj_c, scal_c = traj.cpu(), scalars.cpu()
    n_final = scal_c[:, 3].numpy()
    x_last = float(torch.linalg.inv(traj_c[-1].double())[0, 3])
    x_expect = workload.expected_final_x(n_frames)
    check(bool(torch.isfinite(traj_c).all()), f"all {n_frames} poses finite")
    check(host_syncs == 0, f"no host sync in a 64-frame pass ({host_syncs})")
    check(float(np.median(n_final)) > 150, f"median final inliers {float(np.median(n_final))} > 150")
    check(abs(x_last - x_expect) < 0.15 * x_expect + 0.02, f"final x {x_last:.4f} m vs {x_expect:.4f} m")
    check(float(np.median(n_final)) == 453.5 and round(x_last, 4) == 1.8884,
          f"the slice's known outcome: median n_final {float(np.median(n_final))} == 453.5, "
          f"final x {x_last:.4f} m == 1.8884 m")
    for name, n in launches.items():
        check(n == n_frames, f"{name} launched {n} times in the {n_frames}-frame slice")

    # the card against the CPU (plain versions) on a small input
    tg, sg = workload.run_slice(small)
    tc, sc = workload.run_slice(workload.build_workload(torch.device("cpu"), **workload.SMALL))
    dT = float((tg.cpu() - tc).abs().max())
    nf_g, nf_c = sg[:, 3].cpu().double(), sc[:, 3].double()
    check(dT < 1e-3, f"small slice: card vs CPU pose max |diff| {dT:.2e} < 1e-3")
    check(bool(((nf_g - nf_c).abs() <= 0.02 * nf_c).all()), f"small slice n_final card {sg[:, 3].tolist()} vs CPU {sc[:, 3].tolist()}")

    # --- 6. report --------------------------------------------------------------
    print(json.dumps({
        "slice_frames_per_s": fps, "slice_seconds": dt, "frames": n_frames,
        "median_n_final": float(np.median(n_final)), "final_x_m": x_last, "expected_x_m": x_expect,
        "build_s": build_s, "host_syncs_per_pass": host_syncs, "card": card,
    }))
    kernels = [
        {"name": "fast_nms", "route": "cuda", "source": cuda_fast.SOURCE,
         "replaces": cuda_fast.REPLACES, "launches": launches["fast_nms"], **k1},
        {"name": "hamming_top2", "route": "cuda", "source": cuda_match.SOURCE,
         "replaces": cuda_match.REPLACES, "launches": launches["hamming_top2"], **k2},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
