"""TUM RGB-D runner (port of ``tpuslam/apps/rgbd_tum.py``; parity with
Examples/RGB-D/rgbd_tum.cc): association-file driven RGB-D tracking,
optional online plane segmentation.

Usage:
  python -m tpuslam_torch.apps.rgbd_tum <folder> [--associations associations.txt]
      [--planes] [--settings TUM1.yaml] [--max-frames N] [--out DIR]
      [--device cuda:0|cpu]
"""

from __future__ import annotations

import json
import os

from ..core.camera import Camera
from ..core.config import FeatureFlags, SlamConfig
from ..io.datasets import IclDataset, TumRgbdDataset
from ..semantic.detect import detect_planes_online
from ..utils.profiler import Profiler
from . import common


def main(argv=None):
    ap = common.base_parser(__doc__)
    ap.add_argument("--associations", default="associations.txt")
    ap.add_argument("--planes", action="store_true", help="online plane segmentation")
    args = ap.parse_args(argv)
    # TUM fr1 defaults (the reference ships TUM1/2/3.yaml)
    cam, _ = common.camera_from_args(args, Camera.make(517.3, 516.5, 318.6, 255.3, args.device, bf=40.0))
    flags = FeatureFlags(detect_plane=args.planes, optimize_with_plane_3d=args.planes)
    cfg = common.apply_features(SlamConfig().replace(sensor="rgbd", flags=flags), args.features)
    ds = TumRgbdDataset(args.folder, associations=args.associations, max_frames=args.max_frames,
                        native=common.native_io(args))
    gt = None
    # groundtruth.txt rows are not frame-aligned: only an aligned odom.txt is read
    if os.path.exists(os.path.join(args.folder, "groundtruth.txt")) and os.path.exists(
            os.path.join(args.folder, "odom.txt")):
        gt = IclDataset(args.folder).gt_poses()
    tracker = common.make_tracker(args, cam, cfg, sample_grays=(it.gray for it in ds.frames()))
    prof = Profiler()

    def per_frame(item):
        pdet = None
        if args.planes and item[2] is not None:
            with prof.section("time plane estimation"):
                pdet = detect_planes_online(item[2], cam, cfg.caps.max_planes_per_frame)
        return pdet, None

    ds.decode_ms.clear()
    times = common.run_loop(tracker, common.dataset_items(ds.frames(with_depth=True), "rgbd"), prof,
                            per_frame=per_frame, **common.viz_kw(args))
    report = common.finish(tracker, times, gt=gt, out_dir=args.out, metric=True, save_kitti_traj=args.save_kitti,
                           checkpoint=args.checkpoint, decode_ms=ds.decode_ms)
    print(json.dumps(report))
    prof.print_aggregated()
    return report


if __name__ == "__main__":
    main()
