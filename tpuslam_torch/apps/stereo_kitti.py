"""Stereo KITTI odometry runner (port of ``tpuslam/apps/stereo_kitti.py``;
parity with Examples/Stereo/stereo_kitti.cc): left/right pairs through the
stereo matcher, a metric trajectory; the KITTI trajectory file is always
written.

Usage:
  python -m tpuslam_torch.apps.stereo_kitti <sequences/NN> [--settings KITTI00-02.yaml]
      [--max-frames N] [--out DIR] [--device cuda:0|cpu]
"""

from __future__ import annotations

from ..core.camera import Camera
from ..io.datasets import KittiOdometryDataset
from . import common


def main(argv=None):
    args = common.base_parser(__doc__).parse_args(argv)
    # KITTI 00-02: bf = fx * 0.54 m baseline
    cam, _ = common.camera_from_args(
        args, Camera.make(718.856, 718.856, 607.1928, 185.2157, args.device, width=1241, height=376, bf=386.1448))
    ds = KittiOdometryDataset(args.folder, max_frames=args.max_frames, native=common.native_io(args))
    return common.run_points_only(args, cam, "stereo", ds, gt=ds.gt_poses(), metric=True, save_kitti_traj=True,
                                  stereo=True)


if __name__ == "__main__":
    main()
