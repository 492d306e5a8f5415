"""A traffic mix's clip: the frames, ground truth and detections that one
session replays, made from the seed by the generator of the mix's kind.

A mix's file, ``traffic/<name>.json``, names its ``kind``; the generator
is ``traffic/<kind>.py``, found by that name, with ``make_clip(config,
traffic, seed, device, detections=None, n_frames=0) -> Clip``.  A new kind
of traffic is a new generator file beside the mixes; a new mix of a known
kind is a data file alone.  The streams a frame hands the program follow
the configuration's ``sensor``: the grey image, and for ``rgbd`` its depth.
"""

from __future__ import annotations

import importlib
from typing import NamedTuple, Optional

import numpy as np
import torch


class Clip(NamedTuple):
    frames: torch.Tensor  # (F, H, W) uint8, pinned on a card run
    gt_cw: np.ndarray  # (F, 4, 4) float64 world->camera
    poses_wc: np.ndarray  # (F, 4, 4) float32 camera->world
    detections: Optional[list]  # per frame (plane, cuboid) detections, or None
    start_deg: float
    scene_seed: int
    extra: tuple = ()  # further per-frame streams the sensor takes: (depth (F, H, W) float32,) for rgbd


def generator(kind: str, package: str = "slambench.traffic"):
    """The ``make_clip`` of ``<package>/<kind>.py``."""
    return importlib.import_module(f"{package}.{kind}").make_clip


def make_clip(config: dict, traffic: dict, seed: int, device, detections=None, n_frames: int = 0) -> Clip:
    """Render the cell's clip for ``seed`` on ``device`` with the mix's
    generator.  ``detections``: the program's parser of one frame's rows
    (``program.detections``), used when the configuration reads offline
    detections.  ``n_frames`` > 0 renders only the clip's first frames."""
    return generator(traffic["kind"])(config, traffic, seed, device, detections=detections, n_frames=n_frames)


def item(clip, fid: int) -> tuple:
    """Frame ``fid`` as the app loop takes it: ``(fid, gray, *extra)``."""
    return (fid, clip.frames[fid], *(s[fid] for s in getattr(clip, "extra", ())))
