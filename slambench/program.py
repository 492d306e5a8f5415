"""The benchmark's one door into the system under test, ``tpuslam_torch``.

Everything the harness asks of the port goes through here: the ``Tracker``
that ``apps/mono_icl.py`` builds for a configuration file, the app loop
``apps/common.run_loop`` that drives it, the offline detections parsed as
``mono_icl`` parses its files, the port's own counters (``stage_ms``,
``waits``, keyframe decisions) and map, copied to the host once the window
has closed, and a sample of kernel K2's calls (:class:`K2Samples`).  No
other module of the benchmark imports the port.
"""

from __future__ import annotations

import numpy as np
import torch

PRECISIONS = ("float32", "tf32")


def set_precision(name: str) -> None:
    """Float32 matmuls as the configuration states (``float32``: TF32 off,
    as the port's apps pin it) or the control's one step below (``tf32``)."""
    if name not in PRECISIONS:
        raise ValueError(f"precision {name!r}: one of {PRECISIONS}")
    tf32 = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


def import_program():
    """Import the modules the window drives (counted as set-up)."""
    from tpuslam_torch.apps import common  # noqa: F401
    from tpuslam_torch.frontend import tracking  # noqa: F401


def load_kernels(device) -> None:
    """Build (first run in a checkout) or load the port's CUDA kernels by one
    small call of each wrapper."""
    from tpuslam_torch.kernels import cuda_fast, cuda_match

    pyr = torch.zeros((1, 32, 32), dtype=torch.float32, device=device)
    cuda_fast.fast_nms_score(pyr, 20.0, 7.0)
    d = torch.zeros((4, 8), dtype=torch.int32, device=device)
    cuda_match.hamming_top2(d, d, torch.ones(4, dtype=torch.bool, device=device))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_tracker(config: dict, device):
    """A fresh ``Tracker`` of the configuration: ``mono_icl``'s camera, flags
    and capacities, with the seeded codebook (``mono_icl`` without
    ``--vocab``)."""
    import dataclasses

    from tpuslam_torch.core.camera import Camera
    from tpuslam_torch.core.config import Capacities, FeatureFlags, OrbConfig, SlamConfig
    from tpuslam_torch.frontend.tracking import Tracker

    c = config["camera"]
    cam = Camera.make(c["fx"], c["fy"], c["cx"], c["cy"], device, width=c["width"], height=c["height"],
                      bf=c["fx"] * c["baseline"])
    orb = dataclasses.replace(OrbConfig(), **config["orb"])
    cfg = SlamConfig().replace(sensor=config["sensor"], caps=Capacities(**config["caps"]), orb=orb,
                               flags=FeatureFlags(**config["flags"]))
    if config["vocabulary"] != "seeded":
        raise ValueError(f"vocabulary {config['vocabulary']!r}: only the seeded codebook is in the repository")
    return Tracker(cam, cfg, device=device)


def detections(config: dict, plane_rows, cuboid_lines, T_wc):
    """(PlaneDetections, CuboidDetections) of one frame from its offline rows,
    as ``mono_icl`` reads its files: the cuboids taken into the camera frame
    with the frame's camera-to-world pose ``T_wc``."""
    from tpuslam_torch.semantic.detect import cuboids_from_lines, parse_obj_lines, planes_from_rows

    caps, c = config["caps"], config["camera"]
    K = np.array([[c["fx"], 0.0, c["cx"]], [0.0, c["fy"], c["cy"]], [0.0, 0.0, 1.0]], np.float32)
    names, vals = parse_obj_lines(cuboid_lines)
    return (planes_from_rows(plane_rows, caps["max_planes_per_frame"]),
            cuboids_from_lines(names, vals, T_wc, K, caps["max_cuboids_per_frame"]))


def run_loop(tracker, items, per_frame):
    """The port's app loop over ``(frame_id, gray)`` items (``(frame_id,
    gray, depth)`` for an RGB-D configuration); returns each frame's seconds
    around the tracker's call."""
    from tpuslam_torch.apps.common import run_loop as loop
    from tpuslam_torch.utils.profiler import Profiler

    return loop(tracker, items, Profiler(enabled=False), per_frame=per_frame).frame_s


def tracking(tracker) -> bool:
    return tracker.state == tracker.OK


def keyframes_made(tracker) -> int:
    """Keyframes the tracker's decisions made (each ran the keyframe chain:
    the semantic step, mapping, local BA, loop detection)."""
    return sum(1 for *_, made in tracker.kf_decisions if made)


def scale_changes(tracker) -> int:
    """How often the tracker has rescaled its map (the flagship's metric
    anchor); a mono map's poses before and after one differ in scale."""
    return int(tracker.n_rescales)


def counters(tracker) -> dict:
    """The port's cumulative spans and counters: host ms per keyframe stage
    (``map_*``, ``kf_*``, the loop closer's as ``loop_*``), host waits on the
    device, keyframes made."""
    stage = dict(tracker.stage_ms)
    if tracker.loop_closer is not None:
        stage.update({f"loop_{k}": v for k, v in tracker.loop_closer.stage_ms.items()})
    return {"stage_ms": stage, "waits": int(sum(tracker.waits.values())), "keyframes": keyframes_made(tracker)}


def session_result(tracker) -> dict:
    """What the checks read of a finished session, as host numpy: the poses
    returned (frame id, world->camera) and the final map."""
    tracker.flush()
    m = tracker.map

    def host(t):
        return t.detach().cpu().numpy()

    return {
        "trajectory": [(int(f), np.asarray(T, np.float64)) for f, T in tracker.trajectory],
        "kf_valid": host(m.kf_valid), "kf_frame_id": host(m.kf_frame_id), "kf_pose": host(m.kf_pose),
        "kf_uv": host(m.kf_uv), "kf_octave": host(m.kf_octave), "kf_kp_valid": host(m.kf_kp_valid),
        "kf_desc": host(m.kf_desc),
        "pt_pos": host(m.pt_pos[m.pt_valid]),
        "plane_coef": host(m.plane_coef[:tracker.n_plane][m.plane_valid[:tracker.n_plane]]),
        "plane_obs": host(m.plane_obs_count[:tracker.n_plane][m.plane_valid[:tracker.n_plane]]),
        "cub_pose": host(m.cub_pose[:tracker.n_cub][m.cub_valid[:tracker.n_cub]]),
        "rescales": scale_changes(tracker),
    }


class K2Samples:
    """Inside ``with``: every ``stride``-th call of kernel K2 on the timed
    path from the ``offset``-th on, at most ``cap`` of them, keeps copies of
    its inputs and outputs on the device (no host wait; ~80 KB a call at
    1024 x 1024).  The search is reached as ``kernels.match.hamming_top2``,
    the name the port's matcher calls it by; ``host()`` reads the copies
    once the window has closed."""

    def __init__(self, stride: int, offset: int, cap: int):
        self.stride, self.offset, self.cap = int(stride), int(offset) % int(stride), int(cap)
        self.calls, self.kept, self._orig = 0, [], None

    def __enter__(self):
        from tpuslam_torch.kernels import match

        self._orig = orig = match.hamming_top2

        def recorded(desc_a, desc_b, valid_b):
            out = orig(desc_a, desc_b, valid_b)
            n, self.calls = self.calls, self.calls + 1
            if n % self.stride == self.offset and len(self.kept) < self.cap:
                self.kept.append(tuple(t.clone() for t in (desc_a, desc_b, valid_b, *out)))
            return out

        match.hamming_top2 = recorded
        return self

    def __exit__(self, *exc):
        from tpuslam_torch.kernels import match

        match.hamming_top2 = self._orig
        return False

    def host(self) -> list:
        keys = ("desc_a", "desc_b", "valid_b", "idx", "d1", "d2")
        out = [{k: t.detach().cpu().numpy() for k, t in zip(keys, call)} for call in self.kept]
        self.kept = []
        return out
