"""The port's twin of ``tests/test_multiprocess.py::test_two_process_full_pipeline``:
two OS processes on the CPU, joined into a gloo group through a ``file://``
rendezvous, each run the real ``Tracker`` (default flags: loop closing and
``distributed_ba`` on) over the first frames of ``tests/_torch_scene.py``'s
golden scene at 320x240, so that every keyframe's local BA is solved
collectively (``tests/_torch_pipeline_worker.py``).  Held: the two
trajectories equal bit for bit (the BA is collective and the rest of the
pipeline deterministic), the collective path taken, and the JAX worker's
limits (``tests/_pipeline_worker.py``): tracking at the end, at least 72%
of the frames tracked (18 of its 25), at least 3 keyframes and a
Sim3-aligned ATE below 0.10 m.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_scene as sc
from tpuslam_torch.io.trajectory import ate_rmse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_pipeline_worker.py")
N_FRAMES = 16


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("pipeline")
    c = sc.CSPEC
    np.savez(work / "frames.npz", frames=np.stack([sc.frame_u8(i) for i in range(N_FRAMES)]), fx=c.fx, fy=c.fy,
             cx=c.cx, cy=c.cy, n_feat=512)
    init = f"file://{work / 'rendezvous'}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), "2", init, str(work / "frames.npz"), str(work)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(2)]


def test_trajectories_are_equal_across_ranks(ranks):
    r0, r1 = ranks
    np.testing.assert_array_equal(r0["fids"], r1["fids"])
    np.testing.assert_array_equal(r0["poses"], r1["poses"])
    assert int(r0["n_kf"]) == int(r1["n_kf"])


def test_every_local_ba_was_collective(ranks):
    r0, r1 = ranks
    # two phases of 5 + 10 LM iterations, two all-reduces each, per local BA
    assert int(r0["allreduce_calls"]) == int(r1["allreduce_calls"]) > 0
    assert int(r0["allreduce_calls"]) % 30 == 0


def test_tracking_within_the_jax_workers_limits(ranks):
    r0, _ = ranks
    fids, poses = r0["fids"], r0["poses"]
    assert int(r0["state"]) == 1, "tracker lost"
    assert len(fids) >= 0.72 * N_FRAMES, len(fids)
    assert int(r0["n_kf"]) >= 3
    gt = [np.linalg.inv(sc.poses_wc()[f]) for f in fids]
    rmse, _ = ate_rmse(list(poses), gt, with_scale=True)
    assert rmse < 0.10, rmse
