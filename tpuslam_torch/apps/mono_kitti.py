"""Monocular KITTI odometry runner (port of ``tpuslam/apps/mono_kitti.py``;
parity with Examples/Monocular/mono_kitti.cc).  The KITTI trajectory file
is always written.

Usage:
  python -m tpuslam_torch.apps.mono_kitti <sequences/NN> [--settings KITTI00-02.yaml]
      [--max-frames N] [--out DIR] [--device cuda:0|cpu]
"""

from __future__ import annotations

from ..core.camera import Camera
from ..io.datasets import KittiOdometryDataset
from . import common


def main(argv=None):
    args = common.base_parser(__doc__).parse_args(argv)
    # KITTI 00-02 intrinsics
    cam, _ = common.camera_from_args(
        args, Camera.make(718.856, 718.856, 607.1928, 185.2157, args.device, width=1241, height=376))
    ds = KittiOdometryDataset(args.folder, max_frames=args.max_frames, native=common.native_io(args))
    return common.run_points_only(args, cam, "mono", ds, gt=ds.gt_poses(), save_kitti_traj=True)


if __name__ == "__main__":
    main()
