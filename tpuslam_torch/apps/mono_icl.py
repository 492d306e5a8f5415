"""Monocular ICL-NUIM runner (port of ``tpuslam/apps/mono_icl.py``; CLI
parity with mono_icl_test, Examples/Monocular/mono_icl_test.cc): dataset
loop, settings YAML, offline semantic detections (planes and cuboids),
trajectory / cuboid / plane dumps, report.

Usage:
  python -m tpuslam_torch.apps.mono_icl <dataset_folder> [--settings ICL.yaml]
      [--max-frames N] [--objects] [--planes] [--out OUTDIR] [--features N]
      [--vocab train|lsh|ORBvoc.txt] [--checkpoint F] [--resume F
      --localization-only] [--device cuda:0|cpu]
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..core.camera import Camera, camera_matrix
from ..core.config import FeatureFlags, SlamConfig
from ..io.datasets import IclDataset
from ..semantic.detect import read_offline_cuboids, read_offline_planes
from ..utils.profiler import Profiler
from . import common


def main(argv=None):
    ap = common.base_parser(__doc__)
    ap.add_argument("--objects", action="store_true")
    ap.add_argument("--planes", action="store_true")
    args = ap.parse_args(argv)
    args.settings = args.settings or "ICL.yaml"
    cam, vals = common.camera_from_args(args, Camera.make(481.2, -480.0, 319.5, 239.5, args.device))
    flags = FeatureFlags(
        detect_object=args.objects,
        read_offline_cuboidtxt=args.objects,
        detect_plane=args.planes,
        read_offline_planetxt=args.planes,
        associate_cuboid_with_classname=bool(vals.get("associate_cuboid_with_classname", 1)),
        optimize_with_plane_3d=args.planes,
        optimize_with_cuboid_2d=args.objects,
        optimize_with_cuboid_3d=bool(vals.get("optimize_with_cuboid_3d", 0)),
        optimize_with_corners_2d=bool(vals.get("optimize_with_corners_2d", 0)),
        optimize_with_pt_obj_3d=bool(vals.get("optimize_with_pt_obj_3d", 0)),
        optimize_with_cuboid_plane=bool(vals.get("optimize_with_cuboid_plane", 0)),
        # the metric scale anchor from the plane detections (the reference's
        # enable_ground_height_scale); TPUSLAM_NO_RESCALE=1 turns it off
        enable_ground_height_scale=args.planes and not os.environ.get("TPUSLAM_NO_RESCALE"),
    )
    cfg = common.apply_features(SlamConfig().replace(sensor="mono", flags=flags), args.features)
    ds = IclDataset(args.folder, max_frames=args.max_frames, native=common.native_io(args))
    gt = ds.gt_poses() if os.path.exists(os.path.join(args.folder, ds.truth_file)) else None
    tracker = common.make_tracker(args, cam, cfg, sample_grays=(it.gray for it in ds.frames()))
    prof = Profiler()
    K_np = camera_matrix(cam).cpu().numpy()

    def per_frame(item):
        fid, pdet, cdet = item[0], None, None
        if args.planes:
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

    ds.decode_ms.clear()  # the vocabulary's sampling pass is not the replay's
    times = common.run_loop(tracker, common.dataset_items(ds.frames(), "mono"), prof, per_frame=per_frame)
    report = common.finish(tracker, times, gt=gt, out_dir=args.out, save_kitti_traj=args.save_kitti,
                           checkpoint=args.checkpoint, decode_ms=ds.decode_ms)
    print(json.dumps(report))
    prof.print_aggregated()
    return report


if __name__ == "__main__":
    main()
