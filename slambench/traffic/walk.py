"""The generator of ``walk`` mixes (``traffic/walk.json``):
``session_frames`` consecutive frames of the golden room loop (a circle
around the room, the loop's angular step), starting at ``start_deg_step x
(seed mod start_count)`` degrees, rendered by the frozen generator
(``scene.py``).

The frames are rendered once on the device and kept in pinned host memory,
as the port's apps keep a dataset's frames; an ``rgbd`` configuration also
gets each frame's depth as the dataset's 16-bit PNGs hold it (metres x
5000, truncated).  The offline plane and cuboid rows are made from the
renderer's per-primitive counts and parsed by the program as ``mono_icl``
parses its files.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import scene
from ..clip import Clip

SENSORS = ("mono", "rgbd")
DEPTH_FACTOR = 5000.0  # the dataset's depth PNG scale


def start_deg(traffic: dict, seed: int) -> float:
    return float(traffic["start_deg_step"]) * (int(seed) % int(traffic["start_count"]))


def camera_spec(config: dict) -> scene.CameraSpec:
    c = config["camera"]
    return scene.CameraSpec(width=c["width"], height=c["height"], fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"],
                            baseline=c["baseline"])


def _depth(renderer, poses, chunk: int = 8):
    out = []
    for i in range(0, len(poses), chunk):
        d = renderer(torch.as_tensor(np.asarray(poses[i:i + chunk], np.float32), device=renderer.d_cam.device))[1]
        out.append((torch.clamp(d * DEPTH_FACTOR, 0, 65535).to(torch.int32).to(torch.float32) / DEPTH_FACTOR))
    return torch.cat(out)


def make_clip(config: dict, traffic: dict, seed: int, device, detections=None, n_frames: int = 0) -> Clip:
    if config["sensor"] not in SENSORS:
        raise ValueError(f"sensor {config['sensor']!r}: a walk renders {SENSORS}")
    spec = scene.SceneSpec(seed=int(traffic["scene_seed"]))
    cam = camera_spec(config)
    a0 = start_deg(traffic, seed)
    poses = scene.walk_poses(n_frames or int(traffic["session_frames"]), a0, traffic["loop_deg"],
                             int(traffic["loop_frames"]), traffic["radius"], traffic["height"],
                             traffic["pitch_down_deg"], traffic["bob"])
    renderer = scene.BatchRenderer(cam, spec, device)
    offline = config["detections"] == "offline"
    on_card = torch.device(device).type == "cuda"
    with torch.no_grad():
        out = scene.render_uint8(renderer, poses, stats=offline)
        extra = (_depth(renderer, poses).cpu(),) if config["sensor"] == "rgbd" else ()
    frames = (out[0] if offline else out).cpu()
    if on_card:
        frames = frames.pin_memory()
        extra = tuple(e.pin_memory() for e in extra)
    dets = None
    if offline:
        counts, sums = out[1], out[2]
        dets = []
        for f in range(len(poses)):
            rows, lines = scene.detection_rows(poses[f], counts[f], sums[f], spec)
            dets.append(detections(config, rows, lines, poses[f]))
    gt = np.linalg.inv(poses.astype(np.float64))
    return Clip(frames=frames, gt_cw=gt, poses_wc=poses, detections=dets, start_deg=a0, scene_seed=spec.seed,
                extra=extra)
