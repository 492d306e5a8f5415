"""Stereo EuRoC MAV runner (port of ``tpuslam/apps/stereo_euroc.py``; parity
with Examples/Stereo/stereo_euroc.cc minus live rectification: images are
assumed pre-rectified).

Usage:
  python -m tpuslam_torch.apps.stereo_euroc <sequence_root> [--settings EuRoC.yaml]
      [--max-frames N] [--out DIR] [--device cuda:0|cpu]
"""

from __future__ import annotations

from ..core.camera import Camera
from ..io.datasets import EurocDataset
from . import common


def main(argv=None):
    args = common.base_parser(__doc__).parse_args(argv)
    # bf = fx * 0.11 m baseline (EuRoC.yaml Camera.bf = 47.9)
    cam, _ = common.camera_from_args(
        args, Camera.make(458.654, 457.296, 367.215, 248.375, args.device, width=752, height=480, bf=47.9))
    ds = EurocDataset(args.folder, max_frames=args.max_frames, native=common.native_io(args))
    return common.run_points_only(args, cam, "stereo", ds, gt=ds.gt_poses(), metric=True, stereo=True)


if __name__ == "__main__":
    main()
