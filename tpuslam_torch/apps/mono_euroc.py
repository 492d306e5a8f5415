"""Monocular EuRoC MAV runner (port of ``tpuslam/apps/mono_euroc.py``;
parity with Examples/Monocular/mono_euroc.cc; images assumed pre-rectified).

Usage:
  python -m tpuslam_torch.apps.mono_euroc <sequence_root> [--settings EuRoC.yaml]
      [--max-frames N] [--out DIR] [--device cuda:0|cpu]
"""

from __future__ import annotations

from ..core.camera import Camera
from ..io.datasets import EurocDataset
from . import common


def main(argv=None):
    args = common.base_parser(__doc__).parse_args(argv)
    # EuRoC cam0 intrinsics
    cam, _ = common.camera_from_args(
        args, Camera.make(458.654, 457.296, 367.215, 248.375, args.device, width=752, height=480))
    ds = EurocDataset(args.folder, max_frames=args.max_frames, native=common.native_io(args))
    return common.run_points_only(args, cam, "mono", ds, gt=ds.gt_poses())


if __name__ == "__main__":
    main()
