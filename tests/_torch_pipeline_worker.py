"""One rank of ``tests/test_torch_dist_pipeline.py``, the port's twin of
``tests/_pipeline_worker.py``: the real ``Tracker`` (default flags: loop
closing on, ``distributed_ba`` on) over the frames in ``frames.npz`` on the
CPU, in a 2-rank gloo group, so that every keyframe's local BA runs
collectively (``dist/ba.distributed_local_ba``) while the rest of the
pipeline runs in each process.

    python tests/_torch_pipeline_worker.py <rank> <world> <init_method> <frames.npz> <out_dir>

It writes ``<out_dir>/rank<r>.npz``: the trajectory (frame ids and poses),
the tracker's state and keyframe count, and the all-reduce calls made.
Nothing of JAX is imported.
"""

import os
import sys

os.environ.pop("TPUSLAM_FORCE_LOCAL_BA", None)  # the collective path is what this tests

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpuslam_torch.core import config as cfgm  # noqa: E402
from tpuslam_torch.core.camera import Camera  # noqa: E402
from tpuslam_torch.dist import ba as dba, mesh  # noqa: E402
from tpuslam_torch.frontend.tracking import Tracker  # noqa: E402


def main():
    rank, world, init, frames_path, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    mesh.init_group(init, world, rank, "cpu", timeout_s=120)
    z = np.load(frames_path)
    frames, fx, fy, cx, cy, n_feat = z["frames"], *(float(z[k]) for k in ("fx", "fy", "cx", "cy")), int(z["n_feat"])
    cam = Camera.make(fx, fy, cx, cy, "cpu", width=frames.shape[2], height=frames.shape[1])
    cfg = cfgm.SlamConfig().replace(
        caps=cfgm.Capacities(max_keypoints=n_feat, max_keyframes=32, max_points=4096, local_ba_points=2048),
        orb=cfgm.OrbConfig(n_features=n_feat))
    assert cfg.flags.distributed_ba and cfg.flags.enable_loop_closing
    tracker = Tracker(cam, cfg, device="cpu")
    for fid, gray in enumerate(frames):
        tracker.process_image(gray, fid)
    tracker.flush()
    fids = np.array([f for f, _ in tracker.trajectory], np.int64)
    poses = np.stack([p for _, p in tracker.trajectory]).astype(np.float32) if len(fids) else np.zeros((0, 4, 4))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), fids=fids, poses=poses, state=tracker.state,
             n_kf=len(tracker._kf_fids), allreduce_calls=dba.ALLREDUCE["calls"])
    torch.distributed.destroy_process_group()
    print(f"rank {rank}: OK tracked={len(fids)} kf={len(tracker._kf_fids)}", flush=True)


if __name__ == "__main__":
    main()
