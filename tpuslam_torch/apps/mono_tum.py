"""Monocular TUM runner (port of ``tpuslam/apps/mono_tum.py``; parity with
Examples/Monocular/mono_tum.cc).

Usage:
  python -m tpuslam_torch.apps.mono_tum <folder> [--settings TUM1.yaml]
      [--max-frames N] [--out DIR] [--device cuda:0|cpu]
"""

from __future__ import annotations

import os

from ..core.camera import Camera
from ..io.datasets import IclDataset
from . import common


def main(argv=None):
    args = common.base_parser(__doc__).parse_args(argv)
    cam, _ = common.camera_from_args(args, Camera.make(517.3, 516.5, 318.6, 255.3, args.device))
    ds = IclDataset(args.folder, max_frames=args.max_frames, native=common.native_io(args))  # rgb.txt-driven
    gt = ds.gt_poses() if os.path.exists(os.path.join(args.folder, ds.truth_file)) else None
    return common.run_points_only(args, cam, "mono", ds, gt=gt)


if __name__ == "__main__":
    main()
