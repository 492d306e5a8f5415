"""Shared inputs of the port's mapping, BA and initializer parity tests: the
golden synth scene at 320x240 (fx = fy = 260), rendered with the numpy oracle
``tpuslam.io.synth.render_frame`` and truncated to uint8, and a small map
built by the JAX package from it.

The map: keyframes at frames 0, 8, 16, 24 and 32 of the 150-frame cut of the
golden loop (``tests/test_long_replay.py``'s), at their true world->camera
poses, each holding its own ORB features (256 per frame, 8 levels); the
points are what the JAX package's ``create_new_map_points`` triangulates
between consecutive keyframes, written with ``add_points`` and
``assign_observations``, then ``fuse_duplicates`` into every keyframe and
``update_point_stats``.  Built once per process.

Importing this module caps torch's intra-op threads at 2 for the process:
with the suite in 6 pytest-xdist workers on 8 cores (each worker imports
every test file), torch's default of one spinning thread per core in each
worker slowed the port's tests several-fold (``test_torch_tracker_depth``
680 s of worker time in the whole suite against 117 s alone).
"""

import functools

import jax.numpy as jnp
import numpy as np
import torch

from tpuslam.backend import mapping as jbm
from tpuslam.core import camera as jcam
from tpuslam.core.config import Capacities
from tpuslam.frontend import tracking as jtr
from tpuslam.io import synth
from tpuslam.kernels import orb as jorb
from tpuslam.map import mapstate as jms

torch.set_num_threads(2)

N_FEAT = 256
CAPS = Capacities(max_keypoints=N_FEAT, max_keyframes=16, max_points=2048,
                  local_ba_keyframes=4, local_ba_fixed_keyframes=4, local_ba_points=1024)
CSPEC = synth.CameraSpec(width=320, height=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5)
KF_FRAMES = (0, 8, 16, 24, 32)
N_SEQ = 150


def jax_camera():
    return jcam.Camera.make(CSPEC.fx, CSPEC.fy, CSPEC.cx, CSPEC.cy, width=CSPEC.width,
                            height=CSPEC.height, bf=CSPEC.fx * CSPEC.baseline)


def poses_wc(n=N_SEQ):
    spec = synth.SceneSpec()
    return synth.trajectory(n, spec, total_angle_deg=400.0 * n / 560.0)


@functools.lru_cache(maxsize=None)
def frame_u8(fid: int):
    gray, _, _, _ = synth.render_frame(poses_wc()[fid], CSPEC, synth.SceneSpec())
    return gray.astype(np.uint8)


@functools.lru_cache(maxsize=None)
def jax_frame(fid: int, n_feat: int = N_FEAT):
    feats = jorb.extract(jnp.asarray(frame_u8(fid), jnp.float32), n_features=n_feat)
    return jtr.frame_from_features(feats, jax_camera())


def map_fields(m):
    return {k: np.asarray(getattr(m, k)) for k in m._fields}


@functools.lru_cache(maxsize=None)
def jax_map():
    cam = jax_camera()
    m = jms.empty_map(CAPS)
    gt = poses_wc()
    for slot, fid in enumerate(KF_FRAMES):
        f = jax_frame(fid)
        T = jnp.asarray(np.linalg.inv(gt[fid]).astype(np.float32))
        m = jms.add_keyframe(m, slot, T, fid, f.uv, f.octave, f.angle, f.desc, f.valid,
                             jnp.full(N_FEAT, -1, jnp.int32), f.ur, f.depth)
    n_pt = 0
    for slot in range(1, len(KF_FRAMES)):
        tri = jbm.create_new_map_points(m, jnp.int32(slot), jnp.int32(slot - 1), cam.K)
        ok = np.asarray(tri.ok)
        slots = np.where(ok, np.cumsum(ok) - 1 + n_pt, 0).astype(np.int32)
        m = jms.add_points(m, jnp.asarray(slots), tri.pos, m.kf_desc[slot],
                           jnp.zeros((N_FEAT, 3)), jnp.zeros(N_FEAT), jnp.full(N_FEAT, 1e9),
                           jnp.full(N_FEAT, slot, jnp.int32), jnp.asarray(ok),
                           first_fid=jnp.full(N_FEAT, KF_FRAMES[slot], jnp.int32))
        m = jms.assign_observations(m, jnp.int32(slot), jnp.arange(N_FEAT, dtype=jnp.int32),
                                    jnp.asarray(slots), jnp.asarray(ok))
        m = jms.assign_observations(m, jnp.int32(slot - 1), tri.kp2, jnp.asarray(slots), jnp.asarray(ok))
        n_pt += int(ok.sum())
    for slot in range(len(KF_FRAMES)):
        m = jbm.fuse_duplicates(m, jnp.int32(slot), cam.K)
    m = jms.update_point_stats(m)
    assert n_pt > 150, n_pt
    return m
