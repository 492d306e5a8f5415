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
     (3, 37, 45) array; after phases 6 and 7, the first frame's pyramid of
     each replay with its Tracker's live level sizes ((8, 240, 320) and
     (8, 480, 640)).  The arrays must be equal (max |err| 0) with the same
     number of corners;
  4. holds kernel K2 (Hamming top-2) against its plain version on frame 0's
     and frame 1's descriptors against keyframe 0's (1024 x 1024), random
     4096 x 4096 and 1000 x 777 with ~20% invalid columns, M = 1, all
     columns invalid, and all columns tied (every B row the same); after
     phases 6 and 7, each replay's last frame against its reference
     keyframe's bound keypoints (512 x 512 and 1024 x 1024): idx, d1 and d2
     equal;
  5. runs the 64-frame tracking slice (``tpuslam_torch.workload``) at full
     width: 480x640 frames, 1024 features, a map of 512 keyframes and 32768
     points, 4096 local points.  A 4-frame 240x320 run on the card first
     warms the libraries up and must agree with the same run on the CPU
     (plain versions); then one full pass counts the host syncs and one is
     timed.  Gates: no host sync in a pass, median final inliers 453.5 and
     final camera x 1.8884 m (the slice's known outcome, which exact kernels
     must not move), every frame finite, each kernel launched exactly once
     per frame;
  6. runs the port's ``Tracker`` (``tpuslam_torch.apps.golden``) over the
     first 48 frames of the golden sequence at 320x240 (fx = fy = 260, 512
     features, the capacities of ``tests/test_long_replay.py``, loops off)
     on the card and on the CPU: the card's render must equal the CPU's on
     every pixel, both must initialize on the same frame and track the same
     frames, and up to the first keyframe decision that differs (printed
     with the scalars that decided it on each side) every camera centre
     must agree within ``SMALL_CENTRE_TOL`` after Sim3 alignment and every
     rotation within ``SMALL_ANGLE_TOL``, and the initialization
     keyframe's rotation within ``SMALL_INIT_ANGLE_TOL``
     (``replay_agreement``);
  7. renders the first 100 frames of the golden sequence at full width on
     the card, requires them equal to the CPU's render on every pixel, and
     replays them (640x480, 1024 features, default capacities, loops off)
     through ``run_loop`` and ``Tracker`` and prints a ``golden`` line: frames
     tracked, keyframes, live points, raw / corrected / keyframe ATE,
     frames/s, the per-keyframe stage ms and the host waits per hot-path,
     keyframe and initialization frame with their sources.  Gates: the
     first tracked frame below 40, tracked >= 0.9 x the frames after
     initialization, raw ATE <= 1.5 x the JAX package's + 0.01 m, keyframes
     created within 0.7-1.3 x the JAX package's (``JAX_GOLDEN_100``);
  8. the flagship: renders the first 200 frames on the card again with the
     renderer's per-primitive pixel counts and face sums (the first 100
     must equal phase 7's), builds each frame's offline plane and cuboid
     detections from them, and replays them through ``run_loop`` and the
     ``Tracker`` with the flags of ``mono_icl --planes --objects`` on the
     golden ``ICL.yaml`` (loops off), then prints a ``flagship`` line
     (phase 7's keys plus planes, cuboids, metric rescales and the valid
     plane and bbox factors summed over the local BAs).  Gates against
     ``JAX_FLAGSHIP_200``: first tracked frame below 40, tracked >= 0.9 x
     the frames after initialization, keyframes created within 0.7-1.3 x,
     planes and cuboids each >= 1 and within +-2, at least one rescale,
     plane and bbox factors live in BA, raw ATE <= 1.5 x + 0.01 m; and K1
     and K2 held to their plain versions at this replay's shapes;
  9. RGB-D: renders the first 100 golden frames on the card with their
     depth (quantized as the golden depth PNGs) and the per-primitive
     counts (the frames must equal phase 7's), and replays them
     with the flags of ``rgbd_icl --planes online --objects`` (planes
     segmented on every frame), then prints an ``rgbd`` line (phase 8's
     keys plus the valid stereo factors over the local BAs and the online
     plane detections).  Gates against ``JAX_RGBD_100``: first tracked frame
     <= 1, tracked >= 0.9 x the JAX run's, keyframes created within
     0.7-1.3 x, metric raw ATE (no scale) <= 1.5 x + 0.01 m, map planes
     >= 1 and within 2, stereo factors and online planes > 0; K1 and K2 at
     this replay's shapes; and ``segment_planes`` on frame 0's depth on the
     card and on the CPU: the same ``valid``, the valid planes' inlier
     counts within 0.5% and coefficients within ``PLANE_COEF_TOL``;
 10. stereo: renders the first 100 golden frames' right views (the camera
     moved 0.075 m along its +x axis; the left views must equal phase 7's)
     and replays the pairs through ``process_stereo_pair``, points only,
     then prints a ``stereo`` line (with the median count of left keypoints
     with a stereo match per frame).  Gates against ``JAX_STEREO_100``: the
     tracking, ATE and keyframe gates of phase 9, and the stereo matches
     within 10% of the JAX run's; ``compute_stereo_matches`` on frame 0 on
     the card and on the CPU (the card's features): ``ok`` equal and ``ur``
     within 1e-3 px; K1 at both views' shapes and K2 at this replay's;
 11. loop closure: the drifted revisit of ``tests/test_loop_e2e.py``
     (``revisit_map``, built with numpy and the port's ``mapstate``) closed
     by the port's ``LoopCloser`` on the card and on the CPU at the
     fixture's capacities (keyframe 11's corrected pose within
     ``REVISIT_POSE_TOL``, the same live points), then on the card at the
     default capacities (512 keyframes, 32768 points, 1024 keypoints, 1024
     words) with the fixture's gates: the loop closes, keyframe 11's drift
     falls below half, >= 30 duplicates merge and >= 30 of its keypoints
     rebind to the original points; then a global BA on the welded map that
     ``should_abort`` stops after one chunk of 5 LM iterations, and a whole
     one (10) with its kernel launches (torch.profiler) and host waits
     (sync debug mode).  The essential graph's and the global BA's device
     ms are printed (CUDA events);
 12. relocalization: ``tests/test_reloc.py:37``'s fixture (``reloc_scene``)
     on the card: >= 50 inliers and a position within 0.02 m, through the
     widened re-search round, with K2 launched and held to its plain
     version at these shapes;
 13. phase 7's 100 frames again with loop closing on (the default config,
     the seeded 1024-word codebook), printed as a ``loops`` line with the
     loop closer's ``loop_*`` ms per keyframe and the keyframes that
     reached each detector gate; phase 7's gates against
     ``JAX_GOLDEN_LOOPS_100`` and as many loops as that JAX run; on its
     final map, the newest keyframe's word ids (exact), BoW row and scores
     (1e-6) and a fresh detector's gates on the card against the CPU; K1
     and K2 at its shapes;
 14. the CLI from disk: the port writes the first 100 golden frames at
     640x480 with ``synth.write_sequence`` (its PNG encoder) to a temporary
     folder, every decoded pixel must equal phase 7's frames and every
     decoded depth phase 9's (``quantize_depth``), and the decode ms per
     image are printed; then ``mono_icl.main([folder, "--max-frames",
     "100", "--vocab", "lsh", "--checkpoint", ck, "--save-kitti", "--out",
     ...])`` (loops on, the default) is gated as phase 13 against
     ``JAX_GOLDEN_LOOPS_100`` with 0 loops, and its frames/s (one over the
     mean frame time) is printed beside phase 13's; K1 on the decoded frame
     0 and K2 on its features against the checkpoint's reference keyframe;
 15. resume and localize: the same folder with ``--resume ck
     --localization-only --checkpoint ck2``: every ``MapState`` tensor of
     ck2 equal to ck's, no keyframe made, the first frame placed by
     relocalization no later than the map's earliest keyframe that holds
     half the median live keyframe's bound points (frame 0 in the JAX
     package's map), 0.9 x the frames from it on tracked, and the Sim3-aligned raw ATE of the localized
     frames inside the band of the JAX package's CLI run of the same calls
     (``JAX_LOCALIZE_100``); the ms per localized frame and the
     relocalizations are printed;
 16. the depth CLIs from disk, 30 frames each: ``rgbd_icl --planes online
     --objects`` on the same folder and ``stereo_kitti`` on a KITTI layout
     the port writes with its encoder (``image_0`` phase 7's frames,
     ``image_1`` phase 10's right views, the golden ``ICL.yaml`` as
     settings), gated against the JAX package's runs of the same 30 frames
     with loops on (``JAX_RGBD_30``, ``JAX_STEREO_30``): the first tracked
     frame <= 1, tracked >= 0.9 x, keyframes within one, planes within 2,
     stereo matches within 10%, metric raw ATE <= 1.5 x + 0.01 m; K1 on
     both decoded views;
 17. prints each phase's seconds, the slice's frames/s, the device ms of
     plane segmentation and of stereo matching per frame (CUDA events
     around one call), each kernel's device time (launches queued behind a
     spin, ``kernels/timing.py``) beside its bound and its plain version's
     host-paced time, then one JSON line of kernels (launches summed over
     the twelve paths that run on the card and launch them: the slice, the
     card's small replay, the golden, flagship, RGB-D and stereo replays,
     relocalization, the loops-on replay and the four CLI runs of phases
     14-16), the card line, and the result.

It imports nothing of JAX.  Any failed phase raises, and the script exits
non-zero without printing the result line.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys
import tempfile
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

# The JAX package's own CPU runs of the golden replays, the configurations of
# phases 7-10 (PERF.md section 6, "the JAX package's CPU references"; made by
# jax_golden_reference.py with --frames 100, --frames 200 --flagship,
# --frames 100 --rgbd and --frames 100 --stereo)
JAX_GOLDEN_100 = {
    "first_tracked": 4, "tracked": 96, "keyframes_created": 21, "keyframes_live": 9, "points": 949,
    "ate_raw_m": 0.013295897094951907, "ate_m": 0.01699286245898957, "kf_ate_m": 0.0035375663362657087,
}
JAX_FLAGSHIP_200 = {
    "first_tracked": 4, "tracked": 196, "keyframes_created": 40, "keyframes_live": 11, "points": 937,
    "planes": 4, "cuboids": 2, "rescales": 35, "ba_plane_factors": 745, "ba_bbox_factors": 27,
    "ate_raw_m": 0.05880955257317187, "ate_m": 0.07443938331379683, "kf_ate_m": 0.08390803846630975,
}
JAX_RGBD_100 = {
    "first_tracked": 0, "tracked": 100, "keyframes_created": 6, "keyframes_live": 6, "points": 1003,
    "planes": 8, "cuboids": 2, "ba_plane_factors": 75, "ba_bbox_factors": 0, "stereo_factors": 8489,
    "online_planes": 520, "ate_raw_m": 0.004675963467971899, "ate_m": 0.005002573766998834,
    "kf_ate_m": 0.0046654476425606085,
}
# jax_golden_reference.py --loops --frames 100: phase 7's replay with loop
# closing on; ``loop_gates`` counts the keyframes that reached each gate of
# the loop detector
JAX_GOLDEN_LOOPS_100 = {
    "first_tracked": 4, "tracked": 96, "keyframes_created": 21, "keyframes_live": 9, "points": 949, "loops": 0,
    "loop_gates": {"stats": 12, "covisible": 12, "words": 5, "score": 3, "consistent": 0, "sim3": 0},
    "ate_raw_m": 0.013295897094951907, "ate_m": 0.01699286245898957, "kf_ate_m": 0.0035375663362657087,
}
JAX_STEREO_100 = {
    "first_tracked": 0, "tracked": 100, "keyframes_created": 6, "keyframes_live": 6, "points": 937,
    "stereo_factors": 6159, "stereo_matches": 705.0, "ate_raw_m": 0.010202375757706954,
    "ate_m": 0.008088339732164902, "kf_ate_m": 0.006046864757868631,
}
# jax_golden_reference.py --localize --frames 100: the JAX package's mono_icl
# CLI on the written golden folder (--vocab lsh, loops on), then again with
# --resume --localization-only (phases 14 and 15)
JAX_LOCALIZE_100 = {
    "first_tracked": 4, "tracked": 96, "keyframes_created": 21, "points": 949, "loops": 0,
    "ate_raw_m": 0.013295893121452181, "loc_tracked": 100, "loc_first_tracked": 0,
    "loc_ate_raw_m": 0.010533209853483567, "loc_report_tracked": 196, "loc_report_ate_raw_m": 0.01539545293052853,
}
# jax_golden_reference.py --rgbd --loops --frames 30 and --stereo --loops
# --frames 30: phase 16's CLIs' configurations (loops on, their default)
JAX_RGBD_30 = {
    "first_tracked": 0, "tracked": 30, "keyframes_created": 1, "keyframes_live": 1, "points": 1024, "planes": 0,
    "cuboids": 0, "online_planes": 159, "ate_raw_m": 0.0037669180596295753, "ate_m": 0.0037669180596295753,
}
JAX_STEREO_30 = {
    "first_tracked": 0, "tracked": 30, "keyframes_created": 1, "keyframes_live": 1, "points": 687,
    "stereo_matches": 687.5, "ate_raw_m": 0.004978816218322852, "ate_m": 0.004978816218322852,
}
GOLDEN_FRAMES = 100
CLI_FRAMES = 100
DEPTH_CLI_FRAMES = 30
FLAGSHIP_FRAMES = 200
RGBD_FRAMES = 100
STEREO_FRAMES = 100
SMALL_FRAMES = 48
LOOPS_FRAMES = 100
# phase 11, the drifted revisit closed on the card and on the CPU at the
# fixture's capacities: keyframe 11's corrected pose (the essential graph's
# scatter-adds are float atomics on the card)
REVISIT_POSE_TOL = 1e-3
# segment_planes, card against CPU on one frame's depth: the valid planes'
# coefficients (unit normal and distance in metres); float sums of ~34k
# points in another order (1.3e-5 on the H100)
PLANE_COEF_TOL = 1e-3
# card vs CPU, 48 frames, up to the first keyframe decision that differs
# (PERF.md section 6, "card vs CPU limits"): camera centres after Sim3
# alignment, in the CPU run's map units, and rotation angles in radians, at
# three times the largest reading of the sound runs; and the rotation of
# the initialization keyframe, whose pose rests on one BA of the two-view
# map, so that float order moves it 100x less than the later frames: eight
# times the sound runs' largest reading, a sixth of a halved BA step's.
# Local BA leaves the mono scale free and the order of its float sums
# moves the solution along it, so raw pose matrices are not compared.
SMALL_CENTRE_TOL = 2.1e-2
SMALL_ANGLE_TOL = 3.1e-2
SMALL_INIT_ANGLE_TOL = 5e-4


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED {what}")
    print(f"ok: {what}", flush=True)


def hold_k1(cases, cuda_fast, orb) -> float:
    """Each case: (pyramid, live dims or None).  Equal arrays and corner
    counts required; returns the largest |err| (0)."""
    err = 0.0
    for name, (pyr, dims) in cases.items():
        got = cuda_fast.fast_nms_score(pyr, 20.0, 7.0, dims)
        ref = orb.fast_nms_plain(pyr, 20.0, 7.0)
        err = max(err, float((got - ref).abs().max()))
        n_got, n_ref = int((got > 0).sum()), int((ref > 0).sum())
        check(torch.equal(got, ref), f"K1 fast_nms == plain, {name} {tuple(pyr.shape)}, max |err| {err}")
        check(n_got == n_ref, f"K1 corner count {n_got} == plain {n_ref}, {name}")
    return err


def time_k1(pyr, dims, cuda_fast, orb, timing):
    check(int((orb.fast_nms_plain(pyr) > 0).sum()) > 0, "K1 main path has corners")
    ms = timing.device_ms(lambda: cuda_fast.fast_nms_score(pyr, 20.0, 7.0, dims))
    # given the live level sizes, the call needs only the live pixels in;
    # it writes the whole map
    live_px = int((dims[:, 0] * dims[:, 1]).sum())
    bound_ms = (live_px + pyr.numel()) * 4 / HBM_BYTES_PER_MS
    print(f"K1 bound: {live_px} live of {pyr.numel()} pixels read, {bound_ms * 1e3:.3f} us "
          f"(whole array: {2 * pyr.numel() * 4 / HBM_BYTES_PER_MS * 1e3:.3f} us)", flush=True)
    return {
        "ms": ms,
        # the plain versions allocate as they go, which waits for the device:
        # their time is the host-paced one
        "plain_ms": timing.host_paced_ms(lambda: orb.fast_nms_plain(pyr, 20.0, 7.0), reps=10, warmup=2),
        "bound_ms": bound_ms, "bound_by": "bytes", "bound_kind": "memory",
        "share_of_bound": bound_ms / ms, "library_ms": None,
        "host_paced_ms": timing.host_paced_ms(lambda: cuda_fast.fast_nms_score(pyr, 20.0, 7.0, dims)),
    }


def hold_k2(cases, cuda_match) -> float:
    """Each case: (A, B, B's mask).  idx, d1 and d2 equal required."""
    err = 0.0
    for name, (a, b, valid) in cases.items():
        idx, d1, d2 = cuda_match.hamming_top2(a, b, valid)
        ridx, rd1, rd2 = cuda_match.hamming_top2_plain(a, b, valid)
        err = max(err, float((d1 - rd1).abs().max()), float((d2 - rd2).abs().max()))
        same = torch.equal(idx, ridx) and torch.equal(d1, rd1) and torch.equal(d2, rd2)
        check(same, f"K2 hamming_top2 == plain, {name} {tuple(a.shape)} x {tuple(b.shape)}")
    return err


def time_k2(a, b, valid, cuda_match, timing):
    n, m = a.shape[0], b.shape[0]
    ops_ms = 2 * n * m * 256 / INT8_OPS_PER_MS  # the +-1 int8 product
    bytes_ms = (n * 32 + m * 33 + n * 12) / HBM_BYTES_PER_MS
    ms = timing.device_ms(lambda: cuda_match.hamming_top2(a, b, valid))
    return {
        "ms": ms,
        "plain_ms": timing.host_paced_ms(lambda: cuda_match.hamming_top2_plain(a, b, valid), reps=20, warmup=2),
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "bound_kind": "int8_tensor" if ops_ms >= bytes_ms else "memory",
        "share_of_bound": max(ops_ms, bytes_ms) / ms, "library_ms": None,
        "host_paced_ms": timing.host_paced_ms(lambda: cuda_match.hamming_top2(a, b, valid)),
    }


def tracker_kernel_cases(tracker, frame0):
    """K1 and K2 at the shapes a Tracker's own path gives them: the pyramid
    of ``frame0`` (uint8, host) with the tracker's live level sizes, and its
    last frame's descriptors against its reference keyframe's bound ones."""
    ex, m, ref = tracker.extractor, tracker.map, tracker.ref_kf
    pyr = ex.pyramid(frame0.to(tracker.device).to(torch.float32))
    has_pt = (m.kf_pt[ref] >= 0) & m.kf_kp_valid[ref]
    return (pyr, ex.live_dims), (tracker.last_frame.desc, m.kf_desc[ref], has_pt)


def pose_agreement(Ts_a, Ts_b):
    """Distance between two runs' world->camera poses, frame by frame: the
    camera-centre distance after the Sim3 alignment of a's centres onto
    b's (b's map units), and the angle in radians between a's and b's
    camera rotations as they stand.  Keyframe 0 is the BA gauge at the
    identity in both runs, so rotations need no alignment, and aligning
    them by the centres' Sim3 would add that fit's error: over a short
    arc the centres leave the rotation about the path poorly determined."""
    from tpuslam_torch.io.trajectory import umeyama_alignment

    c_a = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Ts_a]).astype(np.float64)
    c_b = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Ts_b]).astype(np.float64)
    s, R, t = umeyama_alignment(c_a, c_b)
    centre = np.linalg.norm((s * (R @ c_a.T)).T + t - c_b, axis=1)
    M = np.stack([Tb[:3, :3] @ Ta[:3, :3].T for Ta, Tb in zip(Ts_a, Ts_b)]).astype(np.float64)
    # atan2 of the axial and the trace parts: exact at small angles, where
    # arccos of the trace loses the float32 rounding of the matrices
    axial = np.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0], M[:, 1, 0] - M[:, 0, 1]], axis=1)
    angle = np.arctan2(np.linalg.norm(axial, axis=1) / 2.0, (np.trace(M, axis1=1, axis2=2) - 1.0) / 2.0)
    return centre, angle


def card_vs_cpu_replay(golden, dev):
    """Phase 6: the small golden replay on the card and on the CPU.  The
    card's render must equal the CPU's on every pixel; both trackers get
    the CPU's frames."""
    cspec, _ = golden.golden_setup(small=True)
    fg = golden.render_golden(SMALL_FRAMES, cspec, dev).frames
    rendered = golden.render_golden(SMALL_FRAMES, cspec, "cpu")
    frames = rendered.frames
    n_px = int((fg != frames).sum())
    check(n_px == 0, f"small replay frames: the card's and the CPU's renders differ on {n_px} of "
          f"{frames.numel()} pixels")
    rep_g, tr_g = golden.run_golden(SMALL_FRAMES, dev, small=True, rendered=rendered)
    rep_c, tr_c = golden.run_golden(SMALL_FRAMES, "cpu", small=True, rendered=rendered)
    print(f"small replay keyframes: card {rep_g['kf_frame_ids']}, CPU {rep_c['kf_frame_ids']}", flush=True)
    dec_g = {f: (d, made) for f, d, made in tr_g.kf_decisions}
    dec_c = {f: (d, made) for f, d, made in tr_c.kf_decisions}
    split = min([f for f in dec_g if f in dec_c and dec_g[f][1] != dec_c[f][1]], default=None)
    if split is not None:
        print(f"small replay: first differing keyframe decision at frame {split}: "
              f"card {dec_g[split]}, CPU {dec_c[split]}", flush=True)
    check(rep_g["first_tracked"] == rep_c["first_tracked"],
          f"small replay: both initialize on frame {rep_g['first_tracked']} (CPU {rep_c['first_tracked']})")
    fids_g = [f for f, _ in tr_g.trajectory]
    check(fids_g == [f for f, _ in tr_c.trajectory], f"small replay: both track the same {len(fids_g)} frames")
    limit = split if split is not None else SMALL_FRAMES
    agree = replay_agreement(tr_g.trajectory, tr_c.trajectory, limit)
    print("small replay: by frame, centre distance after Sim3 alignment / rotation angle (rad) " + json.dumps(
        {f: f"{c:.1e}/{r:.1e}" for f, c, r in agree["by_frame"]}), flush=True)
    print(f"small replay: raw pose-matrix max |diff| {agree['raw_max']:.3e}; raw ATE card "
          f"{rep_g['ate_rmse_raw_m']:.5f} m, CPU {rep_c['ate_rmse_raw_m']:.5f} m", flush=True)
    check(agree["centre_max"] <= SMALL_CENTRE_TOL,
          f"small replay: camera centres up to frame {limit} agree after Sim3 alignment, max "
          f"{agree['centre_max']:.3e} <= {SMALL_CENTRE_TOL}")
    check(agree["angle_max"] <= SMALL_ANGLE_TOL,
          f"small replay: rotations up to frame {limit} agree, max {agree['angle_max']:.3e} rad "
          f"<= {SMALL_ANGLE_TOL}")
    check(agree["init_angle"] <= SMALL_INIT_ANGLE_TOL,
          f"small replay: the initialization keyframe's rotations (frame {agree['init_frame']}) agree, "
          f"{agree['init_angle']:.3e} rad <= {SMALL_INIT_ANGLE_TOL}")
    return {**agree, "split_frame": split, "card": rep_g, "cpu": rep_c, "tracker": tr_g, "cpu_tracker": tr_c,
            "frames": frames}


def replay_agreement(traj_a, traj_b, limit):
    """:func:`pose_agreement` of two replays that tracked the same frames,
    over the frames up to ``limit``: the largest centre distance and angle,
    the angle at the first tracked frame (the initialization keyframe,
    whose pose rests on the two-view initialization and one BA alone), and
    the largest raw pose-matrix difference."""
    pairs = [(f, a, b) for (f, a), (_, b) in zip(traj_a, traj_b) if f <= limit]
    centre, angle = pose_agreement([a for _, a, _ in pairs], [b for _, _, b in pairs])
    fids = [f for f, _, _ in pairs]
    return {"centre_max": float(centre.max()), "angle_max": float(angle.max()),
            "init_angle": float(angle[0]), "init_frame": fids[0],
            "raw_max": max(float(np.abs(a - b).max()) for _, a, b in pairs),
            "by_frame": list(zip(fids, centre.tolist(), angle.tolist()))}


def golden_replay(golden, dev):
    """Phase 7: the first 100 golden frames at full width, rendered on the
    card and held to the CPU's render on every pixel; returns the report
    line, the tracker and the rendered frames."""
    cspec, _ = golden.golden_setup()
    rendered = golden.render_golden(GOLDEN_FRAMES, cspec, dev)
    frames = rendered.frames
    n_px = int((frames != golden.render_golden(GOLDEN_FRAMES, cspec, "cpu").frames).sum())
    check(n_px == 0, f"golden frames: the card's and the CPU's renders differ on {n_px} of {frames.numel()} pixels")
    rep, tr = golden.run_golden(GOLDEN_FRAMES, dev, count_waits=True, rendered=rendered)
    line = {k: rep.get(k) for k in GOLDEN_KEYS}
    line.update(wait_summary(tr))
    print("golden " + json.dumps(line), flush=True)
    replay_gates("golden", rep, JAX_GOLDEN_100, GOLDEN_FRAMES)
    return line, tr, rendered


GOLDEN_KEYS = ("frames", "tracked", "first_tracked", "keyframes_created", "keyframes_live", "points",
               "ate_rmse_raw_m", "ate_rmse_m", "kf_ate_rmse_m", "frames_per_s", "median_frame_ms",
               "kf_stage_ms", "kf_stage_device_ms", "kf_frame_ids")


def wait_summary(tr):
    """Host waits per hot-path, keyframe and initialization frame, with their sources."""
    line = {}
    for kind in ("hot", "keyframe", "init"):
        waits = [w for w in tr.frame_waits if w[1] == kind]
        sources = sum((w[3] for w in waits), Counter())
        line[f"{kind}_frames"] = len(waits)
        line[f"host_waits_per_{kind}_frame"] = float(np.mean([w[2] for w in waits])) if waits else None
        line[f"host_wait_sources_{kind}"] = dict(sources.most_common(8))
    return line


def replay_gates(name, rep, ref, n_frames, depth=False):
    """The gates the replays share, against the JAX package's CPU run.  Mono:
    the first tracked frame below 40 and 0.9 x the frames after it tracked;
    a depth sensor initializes on one frame: the first tracked frame <= 1
    and 0.9 x the JAX run's tracked frames.  The ATE is the report's, Sim3
    for mono and without scale for the metric depth sensors."""
    first = rep["first_tracked"]
    if depth:
        check(first is not None and first <= 1, f"{name}: first tracked frame {first} <= 1")
        check(rep["tracked"] >= 0.9 * ref["tracked"],
              f"{name}: tracked {rep['tracked']} >= 0.9 x the JAX package's {ref['tracked']}")
    else:
        check(first is not None and first < 40, f"{name}: first tracked frame {first} < 40")
        check(rep["tracked"] >= 0.9 * (n_frames - first),
              f"{name}: tracked {rep['tracked']} >= 0.9 x {n_frames - first} frames after initialization")
    lim = 1.5 * ref["ate_raw_m"] + 0.01
    check(rep["ate_rmse_raw_m"] <= lim, f"{name}: raw ATE {rep['ate_rmse_raw_m']:.4f} m <= {lim:.4f} m "
          f"(JAX package {ref['ate_raw_m']:.4f} m)")
    n, n_ref = rep["keyframes_created"], ref["keyframes_created"]
    check(0.7 * n_ref <= n <= 1.3 * n_ref, f"{name}: {n} keyframes created, JAX package {n_ref}")


def event_ms(fn, reps: int = 10) -> float:
    """Median device ms of ``fn`` between CUDA events recorded around one
    call (host waits inside the call included)."""
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out))


def flagship_replay(golden, dev, golden_frames):
    """Phase 8: the flagship over the first 200 golden frames at full width.
    The card renders them again with the per-primitive counts; the first
    100 must equal phase 7's.  Returns the report line and the tracker."""
    cspec, cfg = golden.golden_setup(flagship=True)
    rendered = golden.render_golden(FLAGSHIP_FRAMES, cspec, dev, cfg)
    n = golden_frames.shape[0]
    n_px = int((rendered.frames[:n] != golden_frames).sum())
    check(n_px == 0, f"flagship frames: the first {n} equal to phase 7's ({n_px} pixels differ)")
    n_pdet = sum(int(p.valid.sum()) for p, _ in rendered.dets)
    n_cdet = sum(int(c.valid.sum()) for _, c in rendered.dets)
    print(f"flagship detections: {n_pdet} planes and {n_cdet} cuboids over {FLAGSHIP_FRAMES} frames", flush=True)
    rep, tr = golden.run_golden(FLAGSHIP_FRAMES, dev, count_waits=True, rendered=rendered, flagship=True)
    line = {k: rep.get(k) for k in GOLDEN_KEYS + ("planes", "cuboids", "rescales", "ba_mono_factors",
                                                  "ba_plane_obs_factors", "ba_cub_bbox_factors")}
    line["rescale_fired"] = rep["rescales"] > 0
    line.update(wait_summary(tr))
    print("flagship " + json.dumps(line), flush=True)
    ref = JAX_FLAGSHIP_200
    replay_gates("flagship", rep, ref, FLAGSHIP_FRAMES)
    for key in ("planes", "cuboids"):
        n, n_ref = rep[key], ref[key]
        check(n >= 1 and abs(n - n_ref) <= 2, f"flagship: {n} {key}, JAX package {n_ref} (>= 1, within 2)")
    check(rep["rescales"] >= 1, f"flagship: the metric rescale fired {rep['rescales']} times "
          f"(JAX package {ref['rescales']})")
    for key, ref_key in (("ba_plane_obs_factors", "ba_plane_factors"), ("ba_cub_bbox_factors", "ba_bbox_factors")):
        check(rep.get(key, 0) > 0, f"flagship: {rep.get(key, 0)} valid {key[3:-8]} factors over the local BAs "
              f"(JAX package {ref[ref_key]})")
    return line, tr


SEMANTIC_KEYS = ("planes", "cuboids", "ba_mono_factors", "ba_plane_obs_factors", "ba_cub_bbox_factors")


def rgbd_replay(golden, dev, golden_frames, read_launches):
    """Phase 9: RGB-D, 100 golden frames at full width with online planes and
    objects.  Returns the report line, the tracker, the kernels' launches in
    the replay (``read_launches()`` just after it), the rendered frames and
    the device ms of ``segment_planes`` on frame 0's depth."""
    from tpuslam_torch.kernels.planes import segment_planes

    cspec, cfg = golden.golden_setup(rgbd=True)
    rendered = golden.render_golden(RGBD_FRAMES, cspec, dev, cfg, depth=True)
    n = golden_frames.shape[0]
    n_px = int((rendered.frames[:n] != golden_frames).sum())
    check(n_px == 0, f"rgbd frames: the first {n} equal to phase 7's ({n_px} pixels differ)")
    rep, tr = golden.run_golden(RGBD_FRAMES, dev, count_waits=True, rendered=rendered, rgbd=True)
    launches = read_launches()
    line = {k: rep.get(k) for k in GOLDEN_KEYS + SEMANTIC_KEYS + ("stereo_factors", "online_planes")}
    line.update(wait_summary(tr))
    print("rgbd " + json.dumps(line), flush=True)
    ref = JAX_RGBD_100
    replay_gates("rgbd", rep, ref, RGBD_FRAMES, depth=True)
    n, n_ref = rep["planes"], ref["planes"]
    check(n >= 1 and abs(n - n_ref) <= 2, f"rgbd: {n} map planes, JAX package {n_ref} (>= 1, within 2)")
    for key in ("stereo_factors", "online_planes"):
        check(rep[key] > 0, f"rgbd: {rep[key]} {key.replace('_', ' ')} (JAX package {ref[key]})")

    # segment_planes on frame 0's depth, the card against the CPU
    depth = rendered.depth[0].to(dev)
    intr = (cspec.fx, cspec.fy, cspec.cx, cspec.cy)
    cap = cfg.caps.max_planes_per_frame
    coef_g, _, cnt_g, valid_g = (x.cpu() for x in segment_planes(depth, *intr, max_planes=cap))
    coef_c, _, cnt_c, valid_c = segment_planes(depth.cpu(), *intr, max_planes=cap)
    check(torch.equal(valid_g, valid_c) and int(valid_c.sum()) >= 1,
          f"segment_planes card vs CPU: the same {int(valid_c.sum())} valid planes")
    dc = (cnt_g - cnt_c).abs()[valid_c].double() / cnt_c[valid_c].double()
    check(float(dc.max()) <= 5e-3, f"segment_planes card vs CPU: inlier counts within 0.5% ({float(dc.max()):.2e})")
    de = float((coef_g - coef_c).abs()[valid_c].max())
    check(de <= PLANE_COEF_TOL, f"segment_planes card vs CPU: coefficients within {PLANE_COEF_TOL} ({de:.2e})")
    seg_ms = event_ms(lambda: segment_planes(depth, *intr, max_planes=cap))
    print(f"segment_planes: {seg_ms:.3f} ms per frame (CUDA events around one call)", flush=True)
    return line, tr, launches, rendered, seg_ms


def stereo_replay(golden, dev, golden_frames, read_launches):
    """Phase 10: stereo, 100 golden pairs at full width, points only.
    Returns the report line, the tracker, the kernels' launches in the
    replay (the comparison below extracts features again), the rendered
    pairs and the device ms of ``compute_stereo_matches`` on frame 0."""
    from tpuslam_torch.kernels.stereo import compute_stereo_matches

    cspec, _ = golden.golden_setup(stereo=True)
    rendered = golden.render_golden(STEREO_FRAMES, cspec, dev, right=True)
    n = min(golden_frames.shape[0], STEREO_FRAMES)
    n_px = int((rendered.frames[:n] != golden_frames[:n]).sum())
    check(n_px == 0, f"stereo left frames: equal to phase 7's ({n_px} pixels differ)")
    rep, tr = golden.run_golden(STEREO_FRAMES, dev, count_waits=True, rendered=rendered, stereo=True)
    launches = read_launches()
    line = {k: rep.get(k) for k in GOLDEN_KEYS + ("stereo_factors", "stereo_matches")}
    line.update(wait_summary(tr))
    print("stereo " + json.dumps(line), flush=True)
    ref = JAX_STEREO_100
    replay_gates("stereo", rep, ref, STEREO_FRAMES, depth=True)
    m, m_ref = rep["stereo_matches"], ref["stereo_matches"]
    check(abs(m - m_ref) <= 0.1 * m_ref, f"stereo: a median {m} stereo matches per frame, JAX package {m_ref}")
    check(rep["stereo_factors"] > 0, f"stereo: {rep['stereo_factors']} stereo factors over the local BAs")

    # compute_stereo_matches on frame 0, the card against the CPU, on the card's features
    gl, gr = (x[0].to(dev).to(torch.float32) for x in (rendered.frames, rendered.right))
    fl, fr = tr.extractor(gl), tr.extractor(gr)
    args = (fl.uv, fl.octave, fl.desc, fl.valid, fr.uv, fr.octave, fr.desc, fr.valid)
    kw = dict(bf=tr.cam.bf, fx=tr.cam.fx)
    ur_g, _, ok_g = (x.cpu() for x in compute_stereo_matches(gl, gr, *args, **kw))
    ur_c, _, ok_c = compute_stereo_matches(gl.cpu(), gr.cpu(), *(a.cpu() for a in args), **kw)
    check(torch.equal(ok_g, ok_c) and int(ok_c.sum()) > 100,
          f"compute_stereo_matches card vs CPU: the same {int(ok_c.sum())} matches")
    du = float((ur_g - ur_c).abs()[ok_c].max())
    check(du <= 1e-3, f"compute_stereo_matches card vs CPU: ur within 1e-3 px ({du:.2e})")
    match_ms = event_ms(lambda: compute_stereo_matches(gl, gr, *args, **kw))
    print(f"compute_stereo_matches: {match_ms:.3f} ms per frame (CUDA events around one call)", flush=True)
    return line, tr, launches, rendered, match_ms


REVISIT_NKP, REVISIT_NPT = 128, 100


def revisit_map(device, caps=None):
    """The drifted revisit of ``tests/test_loop_e2e.py:22-134``, built with
    numpy and the port's ``mapstate``: keyframes 0-10 observe 100 points
    while wandering away, keyframe 11 sees keyframe 0's view again in a
    Sim3-drifted world through 100 duplicate points, and 20 helper points
    make keyframes 9-11 covisible.  ``caps``: the fixture's capacities
    (16 keyframes, 512 points, 128 keypoints, 64 words) or larger ones, which
    only pad.  Returns (camera, config, map, vocabulary, kf 0's pose, kf 11's
    pose)."""
    from tpuslam_torch.core import geometry as geo
    from tpuslam_torch.core.camera import Camera
    from tpuslam_torch.core.config import Capacities, SlamConfig
    from tpuslam_torch.map import mapstate as ms
    from tpuslam_torch.place import vocab as vb

    NKP, NPT = REVISIT_NKP, REVISIT_NPT
    caps = caps or Capacities(max_keypoints=NKP, max_keyframes=16, max_points=512, max_planes=4, max_cuboids=2,
                              vocab_words=64)
    nkp = caps.max_keypoints
    rng = np.random.RandomState(5)
    cam = Camera.make(300.0, 300.0, 160.0, 120.0, device, width=320, height=240)
    cfg = SlamConfig(caps=caps)
    pts_w = rng.uniform([-2, -1.5, 4], [2, 1.5, 9], (NPT, 3)).astype(np.float32)
    desc = rng.randint(0, 1 << 32, (NPT, 8), dtype=np.uint64).astype(np.uint32)
    m = ms.empty_map(caps, device)
    vocab = vb.random_vocabulary(caps.vocab_words, seed=3, device=device)

    def T(a, dtype=torch.float32):
        a = np.asarray(a)
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(device)

    def proj(Tcw, P):
        pc = (Tcw[:3, :3] @ P.T).T + Tcw[:3, 3]
        return np.stack([300.0 * pc[:, 0] / pc[:, 2] + 160.0, 300.0 * pc[:, 1] / pc[:, 2] + 120.0], -1)

    def add_kf(slot, pose, uv_pts, pt_ids_pts):
        uv = np.zeros((nkp, 2), np.float32)
        uv[:NPT] = uv_pts
        kp_valid = np.zeros(nkp, bool)
        kp_valid[:NPT] = True
        pt_ids = -np.ones(nkp, np.int32)
        pt_ids[:NPT] = pt_ids_pts
        dsc = np.zeros((nkp, 8), np.uint32)
        dsc[:NPT] = desc
        return ms.add_keyframe(m, slot, T(pose.astype(np.float32)), slot, T(uv), T(np.zeros(nkp, np.int32)),
                               T(np.zeros(nkp, np.float32)), T(dsc), T(kp_valid), T(pt_ids),
                               T(-np.ones(nkp, np.float32)), T(-np.ones(nkp, np.float32)))

    def add_pts(ids, pos, dsc, first_kf):
        n = len(ids)
        return ms.add_points(m, T(np.asarray(ids, np.int64)), T(pos.astype(np.float32)), T(dsc),
                             T(np.zeros((n, 3), np.float32)), T(np.zeros(n, np.float32)),
                             T(np.full(n, 1e9, np.float32)), T(np.full(n, first_kf, np.int32)), T(np.ones(n, bool)))

    # the revisit's drift: a small rotation, a translation and 5% of scale
    xi = torch.tensor([0.02, -0.03, 0.01, 0.15, -0.1, 0.08, 0.05])
    S_drift = geo.sim3_exp(xi).numpy()
    poses = [np.eye(4, dtype=np.float32) for _ in range(12)]
    for k in range(1, 11):
        poses[k][:3, 3] = [0.3 * k, 0.0, -0.1 * k]
    for k in range(11):
        m = add_kf(k, poses[k], proj(poses[k], pts_w), np.arange(NPT))
    m = add_pts(np.arange(NPT), pts_w, desc, 0)
    pts_drift = (S_drift[:3, :3] @ pts_w.T).T + S_drift[:3, 3]
    T11 = poses[0] @ np.linalg.inv(S_drift)
    T11[:3, :3] /= np.cbrt(np.linalg.det(T11[:3, :3]))
    m = add_kf(11, T11, proj(T11, pts_drift), 100 + np.arange(NPT))
    m = add_pts(100 + np.arange(NPT), pts_drift, desc, 11)
    extra_ids = 200 + np.arange(20)
    m = add_pts(extra_ids, rng.uniform(-1, 1, (20, 3)), np.zeros((20, 8), np.uint32), 9)
    kv, kd = m.kf_kp_valid.cpu().numpy(), m.kf_desc.cpu().numpy().view(np.uint32)
    for k in (9, 10, 11):
        m = ms.assign_observations(m, k, T(100 + np.arange(20, dtype=np.int32)), T(extra_ids.astype(np.int32)),
                                   T(np.ones(20, bool)))
        kv[k, 100:120] = True
        kd[k, 100:120] = rng.randint(0, 1 << 32, (20, 8), dtype=np.uint64).astype(np.uint32)
    m = m.replace(kf_kp_valid=T(kv), kf_desc=T(kd))
    for k in range(12):
        m = vb.update_kf_bow(vocab, m, k)[0]
    return cam, cfg, m, vocab, poses[0], T11.astype(np.float32)


def reloc_scene(device):
    """``tests/test_reloc.py:37``'s relocalization fixture, built with numpy
    and the port's ``mapstate``: one keyframe of 130 points (160 keypoints)
    and a query frame at a nearby pose whose keypoint angles agree for only
    35 keypoints, so the first matching pass stays below 50 and only the
    widened re-search round reaches the acceptance threshold.  Returns
    (camera, config, map, vocabulary, frame, the query's true pose)."""
    from tpuslam_torch.core import geometry as geo
    from tpuslam_torch.core.camera import Camera
    from tpuslam_torch.core.config import Capacities, SlamConfig
    from tpuslam_torch.frontend.tracking import Frame
    from tpuslam_torch.map import mapstate as ms
    from tpuslam_torch.place import vocab as vb

    rng = np.random.RandomState(3)
    NKP, NPT, F, C = 160, 130, 400.0, (320.0, 240.0)
    cam = Camera.make(F, F, C[0], C[1], device)
    caps = Capacities(max_keypoints=NKP, max_keyframes=8, max_points=256, max_planes=4, max_cuboids=2,
                      vocab_words=64)
    vocab = vb.random_vocabulary(caps.vocab_words, seed=1, device=device)
    pts = rng.uniform([-3, -2, 4], [3, 2, 10], (NPT, 3)).astype(np.float32)
    desc = rng.randint(0, 1 << 32, (NPT, 8), dtype=np.uint64).astype(np.uint32)

    def T(a):
        a = np.asarray(a)
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(device)

    def proj(Tcw, P):
        pc = (Tcw[:3, :3] @ P.T).T + Tcw[:3, 3]
        return np.stack([F * pc[:, 0] / pc[:, 2] + C[0], F * pc[:, 1] / pc[:, 2] + C[1]], -1).astype(np.float32)

    m = ms.empty_map(caps, device)
    uv0 = np.zeros((NKP, 2), np.float32)
    uv0[:NPT] = proj(np.eye(4, dtype=np.float32), pts)
    kp_valid = np.zeros(NKP, bool)
    kp_valid[:NPT] = True
    pt_ids = -np.ones(NKP, np.int32)
    pt_ids[:NPT] = np.arange(NPT)
    dsc = np.zeros((NKP, 8), np.uint32)
    dsc[:NPT] = desc
    minus1 = T(-np.ones(NKP, np.float32))
    m = ms.add_keyframe(m, 0, T(np.eye(4, dtype=np.float32)), 0, T(uv0), T(np.zeros(NKP, np.int32)),
                        T(np.zeros(NKP, np.float32)), T(dsc), T(kp_valid), T(pt_ids), minus1, minus1)
    m = ms.add_points(m, T(np.arange(NPT)), T(pts), T(desc), T(np.zeros((NPT, 3), np.float32)),
                      T(np.zeros(NPT, np.float32)), T(np.full(NPT, 1e9, np.float32)), T(np.zeros(NPT, np.int32)),
                      T(np.ones(NPT, bool)))
    m = vb.update_kf_bow(vocab, m, 0)[0]
    T_true = geo.se3_exp(torch.tensor([0.02, -0.01, 0.01, 0.1, -0.05, 0.05])).numpy()
    uv = np.zeros((NKP, 2), np.float32)
    uv[:NPT] = proj(T_true, pts) + rng.randn(NPT, 2).astype(np.float32) * 0.3
    angles = np.zeros(NKP, np.float32)
    angles[35:NPT] = rng.uniform(0.3, 2 * np.pi - 0.3, NPT - 35).astype(np.float32)
    frame = Frame(uv=T(uv), octave=T(np.zeros(NKP, np.int32)), angle=T(angles), desc=T(dsc), valid=T(kp_valid),
                  ur=minus1, depth=minus1)
    return cam, SlamConfig(caps=caps), m, vocab, frame, T_true


def close_revisit(dev, caps=None, events=False):
    """The loop closer on :func:`revisit_map` with keyframe 0's group seen
    twice before (``tests/test_loop_e2e.py:137``).  Returns (closed, kf 11's
    pose before and after, kf 0's pose, live points before and after, kf 11's
    bindings, the map, camera, config, and with ``events`` the device ms of
    ``on_keyframe`` and of the essential graph inside it)."""
    from tpuslam_torch.backend import posegraph
    from tpuslam_torch.place.loop import LoopCloser

    cam, cfg, m, vocab, T0, _ = revisit_map(dev, caps)
    lc = LoopCloser(vocab, cam, cfg)
    g0 = np.zeros(cfg.caps.max_keyframes, bool)
    g0[:11] = True
    lc.prev_groups = [(g0, 2)]
    pose_before = m.kf_pose[11].cpu().numpy()
    pts_before = int(m.pt_valid.sum())
    timed = {}
    optimize = posegraph.optimize_essential_graph
    if events:
        def timed_graph(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = optimize(*a, **kw)
            ev[1].record()
            timed["essential_graph"] = ev
            return out

        posegraph.optimize_essential_graph = timed_graph
        ev_all = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev_all[0].record()
    try:
        m2, closed = lc.on_keyframe(m, 11, 12)
    finally:
        posegraph.optimize_essential_graph = optimize
    ms_ = {}
    if events:
        ev_all[1].record()
        ev_all[1].synchronize()
        ms_["on_keyframe_ms"] = ev_all[0].elapsed_time(ev_all[1])
        if "essential_graph" in timed:
            a, b = timed["essential_graph"]
            ms_["essential_graph_ms"] = a.elapsed_time(b)
    return {"closed": closed, "pose_before": pose_before, "pose_after": m2.kf_pose[11].cpu().numpy(), "T0": T0,
            "pts_before": pts_before, "pts_after": int(m2.pt_valid.sum()), "kf11_pt": m2.kf_pt[11].cpu().numpy(),
            "map": m2, "cam": cam, "cfg": cfg, "stage_ms": dict(lc.stage_ms), **ms_}


def loop_closure_phase(dev):
    """Phase 11: the drifted revisit closed on the card and on the CPU at the
    fixture's capacities (keyframe 11's pose agreeing), then on the card at
    the default capacities with the gates of ``tests/test_loop_e2e.py``, and
    a global BA on the welded map that ``should_abort`` stops after one
    chunk.  Returns the numbers for the report."""
    from tpuslam_torch.backend.local_ba import run_global_ba
    from tpuslam_torch.core.config import Capacities

    small_g, small_c = close_revisit(dev), close_revisit(torch.device("cpu"))
    check(small_g["closed"] and small_c["closed"], "revisit at the fixture's capacities: the loop closes on the card "
          "and on the CPU")
    d = float(np.abs(small_g["pose_after"] - small_c["pose_after"]).max())
    check(d <= REVISIT_POSE_TOL, f"revisit: keyframe 11's corrected pose, card vs CPU, max |diff| {d:.2e} <= "
          f"{REVISIT_POSE_TOL}")
    check(small_g["pts_after"] == small_c["pts_after"],
          f"revisit: {small_g['pts_after']} live points after the merge on the card, CPU {small_c['pts_after']}")

    full = close_revisit(dev, Capacities(), events=True)
    T0 = full["T0"]
    before = float(np.linalg.norm((full["pose_before"] - T0)[:3, 3]))
    after = float(np.linalg.norm((full["pose_after"] - T0)[:3, 3]))
    merged = full["pts_before"] - full["pts_after"]
    kf11 = full["kf11_pt"][:REVISIT_NPT]
    rebound = int((kf11[kf11 >= 0] < REVISIT_NPT).sum())
    print(f"revisit at the default capacities: on_keyframe {full['on_keyframe_ms']:.1f} ms, essential graph "
          f"{full['essential_graph_ms']:.1f} ms (CUDA events); loop stages (host ms) "
          + json.dumps({k: round(v, 1) for k, v in full["stage_ms"].items()}), flush=True)
    check(full["closed"], "revisit at the default capacities (512 keyframes, 32768 points, 1024 keypoints, "
          "1024 words): the loop closes")
    check(after < 0.5 * before, f"revisit: keyframe 11's offset from keyframe 0 {before:.3f} -> {after:.3f}, "
          "below half")
    check(merged >= 30, f"revisit: {merged} duplicate points merged (>= 30)")
    check(rebound >= 30, f"revisit: {rebound} of keyframe 11's keypoints bound to the original points (>= 30)")

    # the global BA that follows a closure, on the welded map
    m, cam, cfg = full["map"], full["cam"], full["cfg"]
    polls = []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    _, chi2_abort = run_global_ba(m, cam, cfg, n_kf=12, should_abort=lambda: polls.append(1) or True)
    ev[1].record()
    ev[1].synchronize()
    gba_abort_ms = ev[0].elapsed_time(ev[1])
    check(len(polls) == 1 and chi2_abort.shape[0] == 5,
          f"global BA: should_abort polled {len(polls)} time(s), {chi2_abort.shape[0]} LM iterations (one chunk of 5)")
    # the whole global BA (two chunks of 5): device ms, kernel launches and host waits
    torch.cuda.synchronize()
    ev[0].record()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        warnings.simplefilter("always")
        _, chi2_full = run_global_ba(m, cam, cfg, n_kf=12, should_abort=lambda: False)
        torch.cuda.set_sync_debug_mode("default")
    ev[1].record()
    ev[1].synchronize()
    gba_ms = ev[0].elapsed_time(ev[1])
    waits = sum("synchroniz" in str(w.message) for w in caught)
    launches = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    check(bool(torch.isfinite(chi2_full).all()) and chi2_full.shape[0] == 10,
          f"global BA: 10 finite LM iterations, chi2 {float(chi2_full[0]):.3f} -> {float(chi2_full[-1]):.3f}")
    print(f"global BA at the default capacities (64-keyframe, 8192-point buckets): one chunk {gba_abort_ms:.1f} ms, "
          f"two chunks {gba_ms:.1f} ms (CUDA events, profiled); {launches} kernel launches, {waits} host waits "
          f"(sync debug mode) in all, {launches / 2:.0f} launches per chunk", flush=True)
    return {"revisit_on_keyframe_ms": full["on_keyframe_ms"], "essential_graph_ms": full["essential_graph_ms"],
            "gba_one_chunk_ms": gba_abort_ms, "gba_two_chunks_ms": gba_ms, "gba_launches": launches,
            "gba_host_waits": waits, "revisit_card_vs_cpu": d, "revisit_drift": [before, after], "merged": merged}


def reloc_phase(dev, cuda_match, read_launches, reset_launches):
    """Phase 12: ``tests/test_reloc.py:37``'s relocalization on the card:
    the widened round must reach >= 50 inliers within 0.02 m of the truth,
    with K2 launched (its launches read right after) and held to its plain
    version at these shapes.  Returns (launches, the K2 case, ms)."""
    from tpuslam_torch.frontend.relocalize import relocalize

    cam, cfg, m, vocab, frame, T_true = reloc_scene(dev)
    reset_launches()
    res = relocalize(m, frame, cam, vocab, cfg, n_kf=1)
    launches = read_launches()
    check(res is not None, "relocalization on the card succeeded")
    T_opt, _, n_in = res
    err = float(np.linalg.norm(T_opt.cpu().numpy()[:3, 3] - T_true[:3, 3]))
    check(n_in >= 50 and err < 0.02, f"relocalization: {n_in} inliers (>= 50), position error {err:.4f} m (< 0.02)")
    check(launches["hamming_top2"] >= 1, f"relocalization launched hamming_top2 {launches['hamming_top2']} time(s)")
    has_pt = (m.kf_pt[0] >= 0) & m.kf_kp_valid[0]
    reloc_ms = event_ms(lambda: relocalize(m, frame, cam, vocab, cfg, n_kf=1), reps=3)
    print(f"relocalization: {reloc_ms:.1f} ms (CUDA events around one call)", flush=True)
    return launches, (frame.desc, m.kf_desc[0], has_pt), reloc_ms


def detector_card_vs_cpu(tr):
    """Phase 13's map, the loop detector on the card against the CPU: the
    newest keyframe's word ids (exact; ties are common and both argmaxes
    take the first word), its BoW row and its BoW scores against every
    keyframe (within 1e-6), the shared-word counts and covisibility row
    (exact), and the gates a fresh detector past the 10-keyframe rules
    reaches on that keyframe (the same).  Returns the largest score
    difference."""
    import dataclasses

    from tpuslam_torch.map import mapstate as ms
    from tpuslam_torch.place import loop as lp
    from tpuslam_torch.place import vocab as vb

    slot, voc_g = tr.ref_kf, tr.loop_closer.vocab
    maps = {"card": tr.map, "cpu": ms.map_from_numpy(ms.map_to_numpy(tr.map), "cpu")}
    vocs = {"card": voc_g, "cpu": vb.Vocabulary(centers_pm1=voc_g.centers_pm1.cpu())}
    cams = {"card": tr.cam, "cpu": dataclasses.replace(tr.cam, dist=tr.cam.dist.cpu())}
    out = {}
    for side, m in maps.items():
        words = vb.assign_words(vocs[side], m.kf_desc[slot], m.kf_kp_valid[slot])
        bow = vb.bow_vector(vocs[side], m.kf_desc[slot], m.kf_kp_valid[slot])
        stats = lp._loop_candidate_stats(m, bow, slot)
        lc = lp.LoopCloser(vocs[side], cams[side], tr.cfg)
        lc.kf_seen = lc.last_loop_kf_seen + 100
        lc.on_keyframe(m, slot, max(tr.n_kf, 10))
        out[side] = ([x.cpu() for x in (words, bow) + tuple(stats)], dict(lc.gates),
                     [st for _, st in lc.prev_groups])
    (wg, bg, sg, cg, rg, vg), gates_g, streak_g = out["card"]
    (wc, bc, sc, cc, rc, vc), gates_c, streak_c = out["cpu"]
    sims = vb._pm1(maps["cpu"].kf_desc[slot]) @ vocs["cpu"].centers_pm1.T
    best = (sims == sims.max(dim=1, keepdim=True).values).sum(dim=1)
    ties = int(((best > 1) & maps["cpu"].kf_kp_valid[slot]).sum())
    check(torch.equal(wg, wc), f"word ids of keyframe slot {slot}, card vs CPU: equal ({ties} of "
          f"{wc.shape[0]} keypoints tie for the best word)")
    db, ds = float((bg - bc).abs().max()), float((sg - sc).abs().max())
    check(db <= 1e-6 and ds <= 1e-6, f"BoW row and scores, card vs CPU: within 1e-6 ({db:.1e}, {ds:.1e})")
    check(torch.equal(cg, cc) and torch.equal(rg, rc) and torch.equal(vg, vc),
          "shared-word counts, covisibility row and kf_valid, card vs CPU: equal")
    check(gates_g == gates_c and streak_g == streak_c,
          f"loop detector on slot {slot}, card vs CPU: gates {gates_g}, streaks {streak_g} (CPU {gates_c}, {streak_c})")
    return ds


def loops_replay(golden, dev, rendered, read_launches):
    """Phase 13: phase 7's 100 frames again with loop closing on (the
    default config), gated as phase 7 against ``JAX_GOLDEN_LOOPS_100``, with
    as many loops as the JAX run and the same keyframes reaching each gate
    of the detector.  Returns the report line, the tracker and the launches."""
    rep, tr = golden.run_golden(LOOPS_FRAMES, dev, count_waits=True, rendered=rendered, loops=True)
    launches = read_launches()
    line = {k: rep.get(k) for k in GOLDEN_KEYS + ("loops", "loop_gates", "mean_frame_s")}
    line["loop_ms_per_keyframe"] = {k: v for k, v in rep["kf_stage_ms"].items() if k.startswith(("loop_", "kf_loop"))}
    line.update(wait_summary(tr))
    print("loops " + json.dumps(line), flush=True)
    ref = JAX_GOLDEN_LOOPS_100
    replay_gates("loops", rep, ref, LOOPS_FRAMES)
    check(rep["loops"] == ref["loops"], f"loops: {rep['loops']} loops closed, JAX package {ref['loops']}")
    print(f"loops: keyframes reaching each detector gate {rep['loop_gates']}, JAX package {ref['loop_gates']}",
          flush=True)
    line["detector_score_diff"] = detector_card_vs_cpu(tr)
    return line, tr, launches


def first_tracked_on_disk(out_dir: str):
    """The first frame id of a CLI run's ``TrajectoryRaw.txt``, None if none."""
    rows = np.loadtxt(os.path.join(out_dir, "TrajectoryRaw.txt"), ndmin=2)
    return int(rows[0, 0]) if len(rows) else None


def localization_after_resume(out_dir: str, n_restored: int, gt_cw):
    """``jax_golden_reference.py:localization_after_resume`` on the port's
    files: the frames a resumed run tracked, the first of them and the
    Sim3-aligned ATE of their raw poses against ``gt_cw``."""
    from tpuslam_torch.io.datasets import _tum_rows_to_Tcw
    from tpuslam_torch.io.trajectory import ate_rmse

    rows = np.loadtxt(os.path.join(out_dir, "TrajectoryRaw.txt"), ndmin=2)[n_restored:]
    out = {"loc_tracked": len(rows), "loc_first_tracked": int(rows[0, 0]) if len(rows) else None}
    if len(rows) >= 3:
        fids = rows[:, 0].astype(int)
        out["loc_ate_raw_m"] = ate_rmse(list(_tum_rows_to_Tcw(rows)), [gt_cw[f] for f in fids], with_scale=True)[0]
    return out


def disk_kernel_cases(dev, gray0, m, ref: int):
    """K1 and K2 at a CLI run's shapes: the decoded frame 0's pyramid with
    an extractor's live level sizes, and its features against the map's
    reference keyframe's bound keypoints."""
    from tpuslam_torch.kernels.orb import OrbExtractor

    ex = OrbExtractor(gray0.shape[0], gray0.shape[1], dev)
    g = torch.from_numpy(gray0).to(dev).to(torch.float32)
    f = ex(g)
    has_pt = (m.kf_pt[ref] >= 0) & m.kf_kp_valid[ref]
    return (ex.pyramid(g), ex.live_dims), (f.desc, m.kf_desc[ref].contiguous(), has_pt.contiguous())


def write_golden_folder(work: str, dev, frames, depth):
    """Phase 14's folder: the first ``CLI_FRAMES`` golden frames written by
    the port's ``write_sequence``, each decoded PNG held to the in-memory
    render (``frames``, phase 7's) and each decoded depth to
    ``quantize_depth`` (``depth``, phase 9's).  Returns (folder, decode ms
    per image by kind)."""
    from tpuslam_torch.apps.golden import GOLDEN_ANGLE_DEG, GOLDEN_FRAMES as N_GOLDEN
    from tpuslam_torch.io import datasets, synth

    folder = os.path.join(work, "golden")
    t0 = time.perf_counter()
    synth.write_sequence(folder, n_frames=N_GOLDEN, total_angle_deg=GOLDEN_ANGLE_DEG, device=dev, n_write=CLI_FRAMES)
    print(f"write_sequence: {CLI_FRAMES} frames in {time.perf_counter() - t0:.1f} s", flush=True)
    ds = datasets.IclDataset(folder, native=True)
    bad_px = bad_d = 0
    for it in ds.frames(with_depth=True):
        bad_px += int((torch.from_numpy(it.gray) != frames[it.frame_id]).sum())
        bad_d += int((torch.from_numpy(it.depth) != depth[it.frame_id]).sum())
    check(bad_px == 0 and bad_d == 0, f"the written folder decodes to the in-memory render: {bad_px} pixels and "
          f"{bad_d} depths of {CLI_FRAMES} frames differ")
    plain = datasets.IclDataset(folder, max_frames=10)
    list(plain.frames(with_depth=True))
    dec = {f"{k}_native": float(np.mean(v)) for k, v in ds.decode_ms.items()}
    dec.update({f"{k}_plain": float(np.mean(v)) for k, v in plain.decode_ms.items()})
    print("decode ms per image (host) " + json.dumps(dec), flush=True)
    return folder, dec


def cli_phase(work: str, folder: str, dev, read_launches, reset_launches):
    """Phase 14: ``mono_icl`` from disk with a checkpoint; returns (report
    line, launches, checkpoint path, K1/K2 cases)."""
    from tpuslam_torch.apps import mono_icl
    from tpuslam_torch.io import checkpoint, png

    ck, out = os.path.join(work, "map.npz"), os.path.join(work, "cli_map")
    reset_launches()
    rep = mono_icl.main([folder, "--max-frames", str(CLI_FRAMES), "--vocab", "lsh", "--checkpoint", ck,
                         "--save-kitti", "--out", out])
    launches = read_launches()
    rep["first_tracked"] = first_tracked_on_disk(out)
    line = {k: rep.get(k) for k in ("frames", "tracked", "first_tracked", "keyframes_created", "keyframes_live",
                                    "points", "loops", "ate_rmse_raw_m", "ate_rmse_m", "kf_ate_rmse_m",
                                    "median_frame_s", "mean_frame_s", "wall_s", "frames_per_s",
                                    "decode_ms_per_image", "kf_stage_ms")}
    print("cli " + json.dumps(line), flush=True)
    replay_gates("cli", rep, JAX_GOLDEN_LOOPS_100, CLI_FRAMES)
    check(rep["loops"] == 0, f"cli: {rep['loops']} loops closed (JAX package {JAX_GOLDEN_LOOPS_100['loops']})")
    for name in ("KeyFrameTrajectory.txt", "TrajectoryRaw.txt", "CameraTrajectory_kitti.txt"):
        check(os.path.getsize(os.path.join(out, name)) > 0, f"cli: {name} written")
    m, extra = checkpoint.load_map(ck, dev)
    check(extra["n_kf"] > 0 and len(extra["trajectory"]) == rep["tracked"],
          f"cli: checkpoint with {extra['n_kf']} keyframe slots and {len(extra['trajectory'])} tracked frames")
    check(launches["fast_nms"] == CLI_FRAMES, f"cli: fast_nms launched {launches['fast_nms']} times in "
          f"{CLI_FRAMES} frames from disk")
    check(launches["hamming_top2"] >= rep["tracked"] - 1,
          f"cli: hamming_top2 launched {launches['hamming_top2']} times, once per hot-path frame")
    gray0 = png.imread_gray(os.path.join(folder, "rgb", "0000.png"), native=True)
    return line, launches, ck, disk_kernel_cases(dev, gray0, m, extra["ref_kf"])


def live_keyframe_points(m) -> dict:
    """{frame id: keypoints bound to live points} of the live keyframes."""
    valid, fids = m.kf_valid.cpu().numpy(), m.kf_frame_id.cpu().numpy()
    kf_pt, kp_valid, pt_valid = (x.cpu().numpy() for x in (m.kf_pt, m.kf_kp_valid, m.pt_valid))
    bound = ((kf_pt >= 0) & kp_valid & pt_valid[np.clip(kf_pt, 0, None)]).sum(axis=1)
    return {int(fids[s]): int(bound[s]) for s in np.flatnonzero(valid)}


def localize_phase(work: str, folder: str, ck: str, dev, gt, read_launches, reset_launches):
    """Phase 15: the same folder resumed from ``ck`` in localization mode;
    returns (report line, launches)."""
    from tpuslam_torch.apps import mono_icl
    from tpuslam_torch.io import checkpoint
    from tpuslam_torch.map import mapstate as ms

    ck2, out = os.path.join(work, "after.npz"), os.path.join(work, "cli_loc")
    m0, extra0 = checkpoint.load_map(ck, dev)
    reset_launches()
    rep = mono_icl.main([folder, "--max-frames", str(CLI_FRAMES), "--vocab", "lsh", "--resume", ck,
                         "--localization-only", "--checkpoint", ck2, "--out", out])
    launches = read_launches()
    m1, extra1 = checkpoint.load_map(ck2, dev)
    loc = localization_after_resume(out, len(extra0["trajectory"]), gt)
    line = {k: rep.get(k) for k in ("frames", "tracked", "keyframes_created", "relocalized", "vo_frames",
                                    "median_frame_s", "mean_frame_s", "wall_s", "ate_rmse_raw_m")}
    line.update(loc, ms_per_frame=1e3 * rep["wall_s"] / rep["frames"])
    print("localize " + json.dumps(line), flush=True)
    # the tracked frames commit their points' found/visible counters, as
    # the reference does; everything else of the map stays as it was
    counters = ("pt_found", "pt_visible")
    changed = [k for k in ms.FIELDS if k not in counters and not torch.equal(getattr(m0, k), getattr(m1, k))]
    check(not changed, f"localize: every MapState tensor but {counters} equal before and after "
          f"({len(ms.FIELDS)} fields; changed: {changed})")
    shrunk = [k for k in counters if not bool((getattr(m1, k) >= getattr(m0, k)).all())]
    check(not shrunk, f"localize: the found/visible counters only grow (fell: {shrunk})")
    check(rep["keyframes_created"] == len(extra0["kf_fids"]) and extra1["kf_fids"] == extra0["kf_fids"],
          f"localize: no keyframe made ({rep['keyframes_created']} created, all restored)")
    kf_points = live_keyframe_points(m0)
    line["live_keyframe_points"] = kf_points
    print("localize: live keyframes' bound points by frame id " + json.dumps(kf_points), flush=True)
    ref = JAX_LOCALIZE_100
    first = loc["loc_first_tracked"]
    check(first == ref["loc_first_tracked"] and rep["relocalized"] >= 1,
          f"localize: the first frame placed, {first}, relocalized ({rep['relocalized']} relocalizations; "
          f"JAX package: frame {ref['loc_first_tracked']})")
    check(loc["loc_tracked"] >= 0.9 * ref["loc_tracked"],
          f"localize: {loc['loc_tracked']} of {CLI_FRAMES} frames tracked >= 0.9 x the JAX package's "
          f"{ref['loc_tracked']}")
    lim = 1.5 * ref["loc_ate_raw_m"] + 0.01
    check(loc["loc_ate_raw_m"] <= lim, f"localize: raw ATE of the localized frames {loc['loc_ate_raw_m']:.4f} m <= "
          f"{lim:.4f} m (JAX package {ref['loc_ate_raw_m']:.4f} m)")
    check(launches["fast_nms"] == CLI_FRAMES, f"localize: fast_nms launched {launches['fast_nms']} times")
    check(launches["hamming_top2"] >= loc["loc_tracked"] - 1,
          f"localize: hamming_top2 launched {launches['hamming_top2']} times")
    return line, launches


def write_kitti_pair(work: str, left, right, poses_wc, n: int) -> str:
    """A KITTI odometry layout of the first ``n`` golden pairs, written with
    the port's PNG encoder: ``image_0``, ``image_1``, ``times.txt``,
    ``poses.txt`` (camera-to-world rows) and the golden ``ICL.yaml``."""
    from tpuslam_torch.io import png, synth

    root = os.path.join(work, "kitti")
    for d in ("image_0", "image_1"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i in range(n):
        png.imwrite(os.path.join(root, "image_0", f"{i:06d}.png"), left[i].numpy())
        png.imwrite(os.path.join(root, "image_1", f"{i:06d}.png"), right[i].numpy())
    np.savetxt(os.path.join(root, "times.txt"), np.arange(n) / 30.0)
    np.savetxt(os.path.join(root, "poses.txt"), np.stack([p[:3, :4].reshape(-1) for p in poses_wc[:n]]))
    cam = synth.CameraSpec()
    with open(os.path.join(root, "ICL.yaml"), "w") as fh:
        fh.write("%YAML:1.0\n"
                 f"Camera.fx: {cam.fx}\nCamera.fy: {cam.fy}\nCamera.cx: {cam.cx}\nCamera.cy: {cam.cy}\n"
                 f"Camera.width: {cam.width}\nCamera.height: {cam.height}\nCamera.bf: {cam.fx * cam.baseline}\n")
    return root


def depth_cli_phase(work: str, folder: str, left, right, poses_wc, read_launches, reset_launches):
    """Phase 16: ``rgbd_icl --planes online --objects`` and ``stereo_kitti``
    from disk over ``DEPTH_CLI_FRAMES`` frames; returns (lines, launches of
    each, the decoded stereo pair 0)."""
    from tpuslam_torch.apps import rgbd_icl, stereo_kitti
    from tpuslam_torch.io import png

    n = DEPTH_CLI_FRAMES
    lines, launches = {}, {}
    kitti = write_kitti_pair(work, left, right, poses_wc, n)
    runs = (("rgbd_cli", rgbd_icl, [folder, "--planes", "online", "--objects"], JAX_RGBD_30, 1),
            ("stereo_cli", stereo_kitti, [kitti, "--settings", "ICL.yaml"], JAX_STEREO_30, 2))
    for name, mod, args, ref, per_frame in runs:
        out = os.path.join(work, name)
        reset_launches()
        rep = mod.main(args + ["--max-frames", str(n), "--vocab", "lsh", "--out", out])
        launches[name] = read_launches()
        rep["first_tracked"] = first_tracked_on_disk(out)
        line = {k: rep.get(k) for k in ("frames", "tracked", "first_tracked", "keyframes_created", "points",
                                        "planes", "cuboids", "stereo_matches", "ate_rmse_raw_m", "ate_rmse_m",
                                        "mean_frame_s", "frames_per_s", "decode_ms_per_image")}
        print(f"{name} " + json.dumps(line), flush=True)
        lines[name] = line
        first = rep["first_tracked"]
        check(first is not None and first <= 1, f"{name}: first tracked frame {first} <= 1")
        check(rep["tracked"] >= 0.9 * ref["tracked"], f"{name}: tracked {rep['tracked']} >= 0.9 x the JAX "
              f"package's {ref['tracked']}")
        k, k_ref = rep["keyframes_created"], ref["keyframes_created"]
        check(abs(k - k_ref) <= 1, f"{name}: {k} keyframes created, JAX package {k_ref} (within one)")
        lim = 1.5 * ref["ate_raw_m"] + 0.01
        check(rep["ate_rmse_raw_m"] <= lim, f"{name}: metric raw ATE {rep['ate_rmse_raw_m']:.4f} m <= {lim:.4f} m "
              f"(JAX package {ref['ate_raw_m']:.4f} m)")
        if name == "rgbd_cli":
            check(abs(rep["planes"] - ref["planes"]) <= 2, f"{name}: {rep['planes']} map planes, JAX package "
                  f"{ref['planes']} (within 2)")
        else:
            sm, sm_ref = rep["stereo_matches"], ref["stereo_matches"]
            check(abs(sm - sm_ref) <= 0.1 * sm_ref, f"{name}: a median {sm} stereo matches per pair, JAX "
                  f"package {sm_ref}")
        check(launches[name]["fast_nms"] == per_frame * n,
              f"{name}: fast_nms launched {launches[name]['fast_nms']} times in {n} frames")
        check(launches[name]["hamming_top2"] >= rep["tracked"] - 1,
              f"{name}: hamming_top2 launched {launches[name]['hamming_top2']} times")
    pair0 = [png.imread_gray(os.path.join(kitti, d, "000000.png"), native=True) for d in ("image_0", "image_1")]
    return lines, launches, pair0


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
    from tpuslam_torch.apps import golden
    from tpuslam_torch.io import png
    from tpuslam_torch.kernels import build, cuda_fast, cuda_match, orb, timing
    from tpuslam_torch.place import dbow_compat

    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    phase_s = {}
    t_phase = time.perf_counter()

    # --- 2. build -------------------------------------------------------------
    # both kernels with nvcc, and the CLIs' host helpers (the PNG unfilter and
    # the ORBvoc text scanner) with the host compiler, all started together
    t0 = time.perf_counter()
    names = ("fast_nms", "hamming_top2")
    with ThreadPoolExecutor(len(names) + 2) as pool:
        jobs = [pool.submit(build.load, n) for n in names]
        jobs += [pool.submit(build.load_host, src) for src in (png.UNFILTER_SRC, dbow_compat.NATIVE_SRC)]
        for job in jobs:
            job.result()
    for name in names:
        log = build.library_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "ptxas info" in line and ("Used" in line or "spill" in line):
                    print(f"{name}: {line.strip()}")
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.3f} s for both kernels and the two host helpers", flush=True)
    phase_s["build"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # --- 3, 4. kernels against their plain versions ----------------------------
    wl = workload.build_workload(dev)
    small = workload.build_workload(dev, **workload.SMALL)
    torch.cuda.synchronize()
    pyr0 = wl.extractor.pyramid(wl.frames[0])
    odd = torch.from_numpy(np.random.RandomState(3).uniform(0, 255, (3, 37, 45)).astype(np.float32)).to(dev)
    k1_err = hold_k1(
        {
            "main_path": (pyr0, wl.extractor.live_dims),
            "main_path_whole_array": (pyr0, None),
            "small_4_level": (small.extractor.pyramid(small.frames[0]), small.extractor.live_dims),
            "odd_3x37x45": (odd, None),
        },
        cuda_fast, orb,
    )
    k1 = time_k1(pyr0, wl.extractor.live_dims, cuda_fast, orb, timing)
    f1 = wl.extractor(wl.frames[1])
    kf_valid = (wl.kf0_pt >= 0) & wl.kf0.valid
    rand_valid = torch.from_numpy(np.random.RandomState(2).rand(4096) > 0.2).to(dev)
    b777 = random_descriptors(777, 5, dev)
    k2_err = hold_k2(
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
        cuda_match,
    )
    k2 = time_k2(wl.kf0.desc, wl.map.kf_desc[0], kf_valid, cuda_match, timing)

    phase_s["kernel_checks"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # --- 5. the slice ----------------------------------------------------------
    # the card against the CPU (plain versions) on a small input, which warms
    # the libraries up; then a full pass that counts the host syncs
    tg, sg = workload.run_slice(small)
    tc, sc = workload.run_slice(workload.build_workload(torch.device("cpu"), **workload.SMALL))
    dT = float((tg.cpu() - tc).abs().max())
    nf_g, nf_c = sg[:, 3].cpu().double(), sc[:, 3].double()
    check(dT < 1e-3, f"small slice: card vs CPU pose max |diff| {dT:.2e} < 1e-3")
    check(bool(((nf_g - nf_c).abs() <= 0.02 * nf_c).all()),
          f"small slice n_final card {sg[:, 3].tolist()} vs CPU {sc[:, 3].tolist()}")
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

    wrappers = {"fast_nms": cuda_fast.fast_nms_score, "hamming_top2": cuda_match.hamming_top2}

    def reset_launches():
        for w in wrappers.values():
            w.launches = 0

    def read_launches():
        return {name: w.launches for name, w in wrappers.items()}

    reset_launches()
    t0 = time.perf_counter()
    traj, scalars = workload.run_slice(wl)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
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
    phase_s["slice"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # --- 6. the Tracker, card against CPU ------------------------------------------
    reset_launches()
    small = card_vs_cpu_replay(golden, dev)
    launches_small = read_launches()
    for name, n in launches_small.items():
        check(n > 0, f"{name} launched {n} times by the card's Tracker in the small replay")
    # the kernels at the shapes the small replay gave them: an 8-level
    # 240x320 pyramid and 512 x 512 descriptors
    (pyr, dims), k2_in = tracker_kernel_cases(small["tracker"], small["frames"][0])
    k1_err = max(k1_err, hold_k1({"small_replay_frame0": (pyr, dims)}, cuda_fast, orb))
    k2_err = max(k2_err, hold_k2({"small_replay_frame_vs_ref_kf": k2_in}, cuda_match))
    phase_s["card_vs_cpu_replay"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # --- 7. golden replay at full width ----------------------------------------------
    reset_launches()
    gold, tr_gold, gold_rendered = golden_replay(golden, dev)
    gold_frames = gold_rendered.frames
    launches_golden = read_launches()
    print(f"launches: slice {launches}, small replay {launches_small}, golden replay {launches_golden}",
          flush=True)
    check(launches_golden["fast_nms"] == GOLDEN_FRAMES,
          f"fast_nms launched {launches_golden['fast_nms']} times in {GOLDEN_FRAMES} golden frames")
    check(launches_golden["hamming_top2"] >= gold["tracked"] - 1,
          f"hamming_top2 launched {launches_golden['hamming_top2']} times, once per hot-path frame")
    (pyr, dims), k2_in = tracker_kernel_cases(tr_gold, gold_frames[0])
    k1_err = max(k1_err, hold_k1({"golden_frame0": (pyr, dims)}, cuda_fast, orb))
    k2_err = max(k2_err, hold_k2({"golden_frame_vs_ref_kf": k2_in}, cuda_match))
    phase_s["golden_replay"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # --- 8. the flagship: planes and objects -------------------------------------
    reset_launches()
    flag, tr_flag = flagship_replay(golden, dev, gold_frames)
    launches_flag = read_launches()
    print(f"launches: flagship {launches_flag}", flush=True)
    check(launches_flag["fast_nms"] == FLAGSHIP_FRAMES,
          f"fast_nms launched {launches_flag['fast_nms']} times in {FLAGSHIP_FRAMES} flagship frames")
    check(launches_flag["hamming_top2"] >= flag["tracked"] - 1,
          f"hamming_top2 launched {launches_flag['hamming_top2']} times, once per hot-path frame")
    (pyr, dims), k2_in = tracker_kernel_cases(tr_flag, gold_frames[0])
    k1_err = max(k1_err, hold_k1({"flagship_frame0": (pyr, dims)}, cuda_fast, orb))
    k2_err = max(k2_err, hold_k2({"flagship_frame_vs_ref_kf": k2_in}, cuda_match))
    phase_s["flagship_replay"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # --- 9. RGB-D: online planes and objects ------------------------------------
    reset_launches()
    rgbd, tr_rgbd, launches_rgbd, rend_rgbd, seg_ms = rgbd_replay(golden, dev, gold_frames, read_launches)
    print(f"launches: rgbd {launches_rgbd}", flush=True)
    check(launches_rgbd["fast_nms"] == RGBD_FRAMES,
          f"fast_nms launched {launches_rgbd['fast_nms']} times in {RGBD_FRAMES} RGB-D frames")
    check(launches_rgbd["hamming_top2"] >= rgbd["tracked"] - 1,
          f"hamming_top2 launched {launches_rgbd['hamming_top2']} times, once per hot-path frame")
    (pyr, dims), k2_in = tracker_kernel_cases(tr_rgbd, rend_rgbd.frames[0])
    k1_err = max(k1_err, hold_k1({"rgbd_frame0": (pyr, dims)}, cuda_fast, orb))
    k2_err = max(k2_err, hold_k2({"rgbd_frame_vs_ref_kf": k2_in}, cuda_match))
    phase_s["rgbd_replay"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # --- 10. stereo ---------------------------------------------------------------
    reset_launches()
    ster, tr_ster, launches_ster, rend_ster, match_ms = stereo_replay(golden, dev, gold_frames, read_launches)
    print(f"launches: stereo {launches_ster}", flush=True)
    check(launches_ster["fast_nms"] == 2 * STEREO_FRAMES,
          f"fast_nms launched {launches_ster['fast_nms']} times for {STEREO_FRAMES} stereo pairs (both views)")
    check(launches_ster["hamming_top2"] >= ster["tracked"] - 1,
          f"hamming_top2 launched {launches_ster['hamming_top2']} times, once per tracked frame")
    (pyr, dims), k2_in = tracker_kernel_cases(tr_ster, rend_ster.frames[0])
    pyr_r = tr_ster.extractor.pyramid(rend_ster.right[0].to(dev).to(torch.float32))
    k1_err = max(k1_err, hold_k1({"stereo_left0": (pyr, dims), "stereo_right0": (pyr_r, dims)}, cuda_fast, orb))
    k2_err = max(k2_err, hold_k2({"stereo_frame_vs_ref_kf": k2_in}, cuda_match))
    phase_s["stereo_replay"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # --- 11. loop closure on the drifted revisit ----------------------------------
    loop = loop_closure_phase(dev)
    phase_s["loop_closure"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # --- 12. relocalization ---------------------------------------------------------
    launches_reloc, k2_reloc, reloc_ms = reloc_phase(dev, cuda_match, read_launches, reset_launches)
    print(f"launches: relocalization {launches_reloc}", flush=True)
    k2_err = max(k2_err, hold_k2({"reloc_frame_vs_candidate_kf": k2_reloc}, cuda_match))
    phase_s["relocalization"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # --- 13. the golden replay with loop closing on -----------------------------------
    reset_launches()
    loops, tr_loops, launches_loops = loops_replay(golden, dev, gold_rendered, read_launches)
    print(f"launches: loops replay {launches_loops}", flush=True)
    check(launches_loops["fast_nms"] == LOOPS_FRAMES,
          f"fast_nms launched {launches_loops['fast_nms']} times in {LOOPS_FRAMES} loops-on frames")
    check(launches_loops["hamming_top2"] >= loops["tracked"] - 1,
          f"hamming_top2 launched {launches_loops['hamming_top2']} times, once per hot-path frame")
    (pyr, dims), k2_in = tracker_kernel_cases(tr_loops, gold_frames[0])
    k1_err = max(k1_err, hold_k1({"loops_frame0": (pyr, dims)}, cuda_fast, orb))
    k2_err = max(k2_err, hold_k2({"loops_frame_vs_ref_kf": k2_in}, cuda_match))
    phase_s["loops_replay"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # --- 14-16. the CLIs from disk ----------------------------------------------------
    from tpuslam_torch.apps.golden import GOLDEN_ANGLE_DEG, GOLDEN_FRAMES as N_GOLDEN
    from tpuslam_torch.io import synth

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as work:
        folder, decode_ms = write_golden_folder(work, dev, gold_frames, rend_rgbd.depth)
        cli, launches_cli, ck, (k1_cli, k2_cli) = cli_phase(work, folder, dev, read_launches, reset_launches)
        print(f"launches: cli {launches_cli}; frames/s over the loop's wall time, reads and decodes included: "
              f"cli {cli['frames_per_s']:.3f}, loops replay (phase 13, in memory) {loops['frames_per_s']:.3f}",
              flush=True)
        k1_err = max(k1_err, hold_k1({"cli_decoded_frame0": k1_cli}, cuda_fast, orb))
        k2_err = max(k2_err, hold_k2({"cli_frame0_vs_ref_kf": k2_cli}, cuda_match))
        phase_s["cli_from_disk"] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()

        loc, launches_loc = localize_phase(work, folder, ck, dev, gold_rendered.gt, read_launches, reset_launches)
        print(f"launches: localize {launches_loc}", flush=True)
        phase_s["resume_localize"] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()

        poses_wc = synth.trajectory(N_GOLDEN, synth.SceneSpec(), total_angle_deg=GOLDEN_ANGLE_DEG)
        depth_lines, launches_depth, pair0 = depth_cli_phase(work, folder, gold_frames, rend_ster.right, poses_wc,
                                                             read_launches, reset_launches)
        print(f"launches: depth CLIs {launches_depth}", flush=True)
        ex = orb.OrbExtractor(pair0[0].shape[0], pair0[0].shape[1], dev)
        pyr_l, pyr_r = (ex.pyramid(torch.from_numpy(g).to(dev).to(torch.float32)) for g in pair0)
        k1_err = max(k1_err, hold_k1({"stereo_cli_left0": (pyr_l, ex.live_dims),
                                      "stereo_cli_right0": (pyr_r, ex.live_dims)}, cuda_fast, orb))
        phase_s["depth_clis"] = time.perf_counter() - t_phase
    print("phase seconds " + json.dumps(phase_s), flush=True)

    # --- 17. report -------------------------------------------------------------
    print(json.dumps({
        "slice_frames_per_s": fps, "slice_seconds": dt, "frames": n_frames,
        "median_n_final": float(np.median(n_final)), "final_x_m": x_last, "expected_x_m": x_expect,
        "build_s": build_s, "host_syncs_per_pass": host_syncs, "card": card,
        "small_replay_centre_max": small["centre_max"], "small_replay_angle_max": small["angle_max"],
        "small_replay_init_angle": small["init_angle"],
        "small_replay_raw_pose_max_diff": small["raw_max"], "small_replay_split_frame": small["split_frame"],
        "golden_frames_per_s": gold["frames_per_s"], "flagship_frames_per_s": flag["frames_per_s"],
        "rgbd_frames_per_s": rgbd["frames_per_s"], "stereo_frames_per_s": ster["frames_per_s"],
        "segment_planes_ms_per_frame": seg_ms, "stereo_matches_ms_per_frame": match_ms,
        "loops_frames_per_s": loops["frames_per_s"], "loops": loops["loops"], "relocalization_ms": reloc_ms,
        "cli_frames_per_s": cli["frames_per_s"],
        "decode_ms_per_image": decode_ms, "localize_ms_per_frame": loc["ms_per_frame"],
        "localize_relocalized": loc["relocalized"], "localize_tracked": loc["loc_tracked"],
        "localize_ate_raw_m": loc["loc_ate_raw_m"],
        "rgbd_cli_frames_per_s": depth_lines["rgbd_cli"]["frames_per_s"],
        "stereo_cli_frames_per_s": depth_lines["stereo_cli"]["frames_per_s"],
        **loop, "phase_s": phase_s, "total_s": sum(phase_s.values()),
    }))
    kernels = [
        {"name": name, "route": "cuda", "source": mod.SOURCE, "replaces": mod.REPLACES,
         "launches": sum(n[name] for n in (launches, launches_small, launches_golden, launches_flag,
                                           launches_rgbd, launches_ster, launches_reloc, launches_loops,
                                           launches_cli, launches_loc, *launches_depth.values())),
         "max_abs_err": err, **k}
        for name, mod, k, err in (("fast_nms", cuda_fast, k1, k1_err), ("hamming_top2", cuda_match, k2, k2_err))
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
