"""RGB-D ICL-NUIM runner (port of ``tpuslam/apps/rgbd_icl.py``; parity with
rgbd_icl_test, Examples/RGB-D/rgbd_icl_test.cc): depth-driven metric
tracking with offline plane rows or online plane segmentation.

Usage:
  python -m tpuslam_torch.apps.rgbd_icl <folder> [--planes {off,online,offline}]
      [--objects] [--settings ICL.yaml] [--max-frames N] [--out DIR]
      [--device cuda:0|cpu]
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..core.camera import Camera, camera_matrix
from ..core.config import FeatureFlags, SlamConfig
from ..io.datasets import IclDataset
from ..semantic.detect import detect_planes_online, read_offline_cuboids, read_offline_planes
from ..utils.profiler import Profiler
from . import common


def main(argv=None):
    ap = common.base_parser(__doc__)
    ap.add_argument("--planes", choices=["off", "online", "offline"], default="off")
    ap.add_argument("--objects", action="store_true")
    args = ap.parse_args(argv)
    args.settings = args.settings or "ICL.yaml"
    cam, _ = common.camera_from_args(args, Camera.make(481.2, -480.0, 319.5, 239.5, args.device, bf=40.0))
    flags = FeatureFlags(
        detect_plane=args.planes != "off",
        read_offline_planetxt=args.planes == "offline",
        detect_object=args.objects,
        read_offline_cuboidtxt=args.objects,
        optimize_with_plane_3d=args.planes != "off",
        optimize_with_cuboid_2d=args.objects,
    )
    cfg = common.apply_features(SlamConfig().replace(sensor="rgbd", flags=flags), args.features)
    ds = IclDataset(args.folder, max_frames=args.max_frames, native=common.native_io(args))
    gt = ds.gt_poses() if os.path.exists(os.path.join(args.folder, ds.truth_file)) else None
    tracker = common.make_tracker(args, cam, cfg, sample_grays=(it.gray for it in ds.frames()))
    prof = Profiler()
    K_np = camera_matrix(cam).cpu().numpy()

    def per_frame(item):
        fid, pdet, cdet = item[0], None, None
        if args.planes == "online" and item[2] is not None:
            with prof.section("time plane estimation"):
                pdet = detect_planes_online(item[2], cam, cfg.caps.max_planes_per_frame)
        elif args.planes == "offline":
            with prof.section("time plane estimation"):
                pdet = read_offline_planes(
                    os.path.join(args.folder, "plane_seg", f"{fid}_offline_plane_multiplane.txt"),
                    cfg.caps.max_planes_per_frame)
        if args.objects and gt is not None:
            with prof.section("time object detection"):
                cdet = read_offline_cuboids(
                    os.path.join(args.folder, "pred_3d_obj_matched_txt", f"{fid:04d}_3d_cuboids.txt"),
                    np.linalg.inv(gt[fid]), K_np, cfg.caps.max_cuboids_per_frame)
        return pdet, cdet

    ds.decode_ms.clear()
    times = common.run_loop(tracker, common.dataset_items(ds.frames(with_depth=True), "rgbd"), prof,
                         per_frame=per_frame)
    report = common.finish(tracker, times, gt=gt, out_dir=args.out, metric=True, save_kitti_traj=args.save_kitti,
                           checkpoint=args.checkpoint, decode_ms=ds.decode_ms)
    print(json.dumps(report))
    prof.print_aggregated()
    return report


if __name__ == "__main__":
    main()
