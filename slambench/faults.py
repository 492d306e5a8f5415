"""Faults planted in the program under test, for the readings a cell's
limits are set from (``calibrate.py --faults``) and for the tests that see
``correct`` come out false (``tests/test_slambench_faults.py``).  The
benchmark's own runs never plant one.

Each is a context manager that patches the port in this process only:

- ``unchanged_pose``: the motion-only pose step returns the pose it was
  given (a step that returns its state unchanged);
- ``half_keypoints``: the extractor drops the second half of each frame's
  keypoints (half of the batch left out);
- ``altered_pose``: every fifth returned pose is turned 5 degrees and moved
  0.05 map units sideways where the tracker commits it (an answer altered
  where it is produced);
- ``frozen_pose``: every returned pose after a session's first repeats the
  one returned before it, where the tracker commits it (an answer that
  never moves);
- ``ba_unchanged``: the local BA solves and then hands back the map it was
  given (a step that returns its state unchanged);
- ``semantic_off``: the local BA packs no plane or cuboid factor (their
  weights 0): the flagship's bundles left out;
- ``k2_altered``: kernel K2 reports the second-best distance as the best
  one (an answer altered where it is produced).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def _patched(owner, name, value):
    orig = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield orig
    finally:
        setattr(owner, name, orig)


@contextlib.contextmanager
def unchanged_pose():
    from tpuslam_torch.graph import lm

    orig = lm.optimize_pose

    def unchanged(T_init, *a, **k):
        return (T_init, *orig(T_init, *a, **k)[1:])

    with _patched(lm, "optimize_pose", unchanged):
        yield


@contextlib.contextmanager
def half_keypoints():
    from tpuslam_torch.kernels import orb

    orig = orb.OrbExtractor.forward

    def half(self, image):
        f = orig(self, image)
        keep = torch.arange(f.valid.shape[0], device=f.valid.device) < f.valid.shape[0] // 2
        return f._replace(valid=f.valid & keep)

    with _patched(orb.OrbExtractor, "forward", half):
        yield


@contextlib.contextmanager
def altered_pose():
    from tpuslam_torch.frontend.tracking import Tracker

    orig = Tracker._commit
    th = np.radians(5.0)
    turn = np.array([[np.cos(th), 0, np.sin(th), 0.05], [0, 1, 0, 0], [-np.sin(th), 0, np.cos(th), 0], [0, 0, 0, 1]])

    def altered(self, frame_id, *a, **k):
        n = len(self.trajectory)
        out = orig(self, frame_id, *a, **k)
        if len(self.trajectory) > n and frame_id % 5 == 0:
            fid, T = self.trajectory[-1]
            self.trajectory[-1] = (fid, (turn @ np.asarray(T, np.float64)).astype(np.float32))
        return out

    with _patched(Tracker, "_commit", altered):
        yield




@contextlib.contextmanager
def frozen_pose():
    from tpuslam_torch.frontend.tracking import Tracker

    orig = Tracker._commit

    def frozen(self, frame_id, *a, **k):
        n = len(self.trajectory)
        out = orig(self, frame_id, *a, **k)
        if len(self.trajectory) > n and n > 0:
            self.trajectory[-1] = (self.trajectory[-1][0], self.trajectory[n - 1][1])
        return out

    with _patched(Tracker, "_commit", frozen):
        yield


@contextlib.contextmanager
def ba_unchanged():
    from tpuslam_torch.frontend import tracking

    orig = tracking.run_local_ba

    def unchanged(m, *a, **k):
        return (m, orig(m, *a, **k)[1])

    with _patched(tracking, "run_local_ba", unchanged):
        yield


@contextlib.contextmanager
def semantic_off():
    from tpuslam_torch.backend import local_ba

    orig = local_ba.pack_local_ba

    def points_only(*a, **k):
        k.update(use_planes=False, use_cub_2d=False, use_corners_2d=False, use_cub_3d=False, use_pt_obj=False,
                 use_cub_plane=False)
        return orig(*a, **k)

    with _patched(local_ba, "pack_local_ba", points_only):
        yield


@contextlib.contextmanager
def k2_altered():
    from tpuslam_torch.kernels import match

    orig = match.hamming_top2

    def altered(*a, **k):
        idx, d1, d2 = orig(*a, **k)
        return idx, d2, d2

    with _patched(match, "hamming_top2", altered):
        yield


FAULTS = {"unchanged_pose": unchanged_pose, "half_keypoints": half_keypoints, "altered_pose": altered_pose,
          "frozen_pose": frozen_pose, "ba_unchanged": ba_unchanged, "semantic_off": semantic_off,
          "k2_altered": k2_altered}
