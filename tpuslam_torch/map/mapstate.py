"""Structure-of-arrays map state (port of ``tpuslam/map/mapstate.py``).

``MapState`` has every field of the reference's NamedTuple, under the same
names and in the same order, so a map crosses between the packages as a
dict of numpy arrays (:func:`map_from_numpy`, :func:`map_to_numpy`).
Packed descriptors (``kf_desc``, ``pt_desc``) are int32 tensors holding the
uint32 bits; the numpy side keeps them uint32.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..core.config import Capacities


@dataclass
class MapState:
    """The whole map as padded tensors (shapes as in the reference)."""

    # keyframes
    kf_pose: torch.Tensor  # (K, 4, 4) world->camera
    kf_valid: torch.Tensor  # (K,) bool
    kf_frame_id: torch.Tensor  # (K,) int32
    kf_uv: torch.Tensor  # (K, N, 2)
    kf_octave: torch.Tensor  # (K, N) int32
    kf_angle: torch.Tensor  # (K, N)
    kf_desc: torch.Tensor  # (K, N, 8) int32 words
    kf_kp_valid: torch.Tensor  # (K, N) bool
    kf_pt: torch.Tensor  # (K, N) int32 map-point id per keypoint, -1 none
    kf_ur: torch.Tensor  # (K, N)
    kf_depth: torch.Tensor  # (K, N)
    # points
    pt_pos: torch.Tensor  # (P, 3)
    pt_valid: torch.Tensor  # (P,) bool
    pt_desc: torch.Tensor  # (P, 8) int32 words
    pt_normal: torch.Tensor  # (P, 3)
    pt_min_dist: torch.Tensor  # (P,)
    pt_max_dist: torch.Tensor  # (P,)
    pt_first_kf: torch.Tensor  # (P,) int32
    pt_first_fid: torch.Tensor  # (P,) int32
    pt_found: torch.Tensor  # (P,) int32
    pt_visible: torch.Tensor  # (P,) int32
    # planes
    plane_coef: torch.Tensor  # (Q, 4)
    plane_valid: torch.Tensor  # (Q,) bool
    plane_obs_count: torch.Tensor  # (Q,) int32
    # cuboids
    cub_pose: torch.Tensor  # (C, 4, 4)
    cub_scale: torch.Tensor  # (C, 3)
    cub_valid: torch.Tensor  # (C,) bool
    cub_class: torch.Tensor  # (C,) int32
    cub_obs_count: torch.Tensor  # (C,) int32
    cub_first_kf: torch.Tensor  # (C,) int32
    cub_last_kf: torch.Tensor  # (C,) int32
    cub_good: torch.Tensor  # (C,) bool
    # per-KF plane detections
    kf_plane_coef: torch.Tensor  # (K, L, 4)
    kf_plane_valid: torch.Tensor  # (K, L) bool
    kf_plane_map: torch.Tensor  # (K, L) int32
    kf_plane_ver: torch.Tensor  # (K, L) int32
    kf_plane_par: torch.Tensor  # (K, L) int32
    # per-KF cuboid detections
    kf_cub_local_pose: torch.Tensor  # (K, O, 4, 4)
    kf_cub_local_scale: torch.Tensor  # (K, O, 3)
    kf_cub_bbox: torch.Tensor  # (K, O, 4)
    kf_cub_corners: torch.Tensor  # (K, O, 16)
    kf_cub_quality: torch.Tensor  # (K, O)
    kf_cub_valid: torch.Tensor  # (K, O) bool
    kf_cub_map: torch.Tensor  # (K, O) int32
    kf_kp_cub: torch.Tensor  # (K, N) int32
    # point -> cuboid ownership
    pt_cub: torch.Tensor  # (P,) int32
    pt_cub_votes: torch.Tensor  # (P,) int32
    # place recognition
    kf_bow: torch.Tensor  # (K, W)

    def replace(self, **changes) -> "MapState":
        return dataclasses.replace(self, **changes)


FIELDS = tuple(f.name for f in dataclasses.fields(MapState))


def empty_map(caps: Capacities, device) -> MapState:
    K, N, P = caps.max_keyframes, caps.max_keypoints, caps.max_points
    Q, C = caps.max_planes, caps.max_cuboids
    L, O = caps.max_planes_per_frame, caps.max_cuboids_per_frame
    f32, i32 = torch.float32, torch.int32

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    def eye4(*batch):
        return torch.eye(4, dtype=f32, device=device).expand(*batch, 4, 4).clone()

    def plane0(*batch):
        return torch.tensor([0.0, 0.0, 1.0, 1.0], device=device).expand(*batch, 4).clone()

    return MapState(
        kf_pose=eye4(K),
        kf_valid=full((K,), False, torch.bool),
        kf_frame_id=full((K,), 0, i32),
        kf_uv=full((K, N, 2), 0.0, f32),
        kf_octave=full((K, N), 0, i32),
        kf_angle=full((K, N), 0.0, f32),
        kf_desc=full((K, N, 8), 0, i32),
        kf_kp_valid=full((K, N), False, torch.bool),
        kf_pt=full((K, N), -1, i32),
        kf_ur=full((K, N), -1.0, f32),
        kf_depth=full((K, N), -1.0, f32),
        pt_pos=full((P, 3), 0.0, f32),
        pt_valid=full((P,), False, torch.bool),
        pt_desc=full((P, 8), 0, i32),
        pt_normal=full((P, 3), 0.0, f32),
        pt_min_dist=full((P,), 0.0, f32),
        pt_max_dist=full((P,), 1e9, f32),
        pt_first_kf=full((P,), 0, i32),
        pt_first_fid=full((P,), -1, i32),
        pt_found=full((P,), 1, i32),
        pt_visible=full((P,), 1, i32),
        plane_coef=plane0(Q),
        plane_valid=full((Q,), False, torch.bool),
        plane_obs_count=full((Q,), 0, i32),
        cub_pose=eye4(C),
        cub_scale=full((C, 3), 1.0, f32),
        cub_valid=full((C,), False, torch.bool),
        cub_class=full((C,), -1, i32),
        cub_obs_count=full((C,), 0, i32),
        cub_first_kf=full((C,), 0, i32),
        cub_last_kf=full((C,), 0, i32),
        cub_good=full((C,), False, torch.bool),
        kf_plane_coef=plane0(K, L),
        kf_plane_valid=full((K, L), False, torch.bool),
        kf_plane_map=full((K, L), -1, i32),
        kf_plane_ver=full((K, L), -1, i32),
        kf_plane_par=full((K, L), -1, i32),
        kf_cub_local_pose=eye4(K, O),
        kf_cub_local_scale=full((K, O, 3), 1.0, f32),
        kf_cub_bbox=full((K, O, 4), 0.0, f32),
        kf_cub_corners=full((K, O, 16), 0.0, f32),
        kf_cub_quality=full((K, O), 0.7, f32),
        kf_cub_valid=full((K, O), False, torch.bool),
        kf_cub_map=full((K, O), -1, i32),
        kf_kp_cub=full((K, N), -1, i32),
        pt_cub=full((P,), -1, i32),
        pt_cub_votes=full((P,), 0, i32),
        kf_bow=full((K, caps.vocab_words), 0.0, f32),
    )


# ---------------------------------------------------------------------------
# Crossing between the packages (numpy in, numpy out)
# ---------------------------------------------------------------------------


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy -> tensor; uint32 (packed descriptor words) becomes int32."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.tensor(a, device=device)


def map_from_numpy(fields: dict, device) -> MapState:
    """Build from ``{name: np.ndarray}`` keyed by the reference's
    ``MapState._fields``."""
    return MapState(**{k: tensor_from_numpy(fields[k], device) for k in FIELDS})


def map_to_numpy(m: MapState) -> dict:
    out = {k: getattr(m, k).cpu().numpy() for k in FIELDS}
    for k in ("kf_desc", "pt_desc"):
        out[k] = out[k].view(np.uint32)
    return out


# ---------------------------------------------------------------------------
# Derived structure
# ---------------------------------------------------------------------------


def incidence(m: MapState):
    """(K, P) float32 observation incidence matrix from kf_pt."""
    K, N = m.kf_pt.shape
    P = m.pt_pos.shape[0]
    rows = torch.arange(K, device=m.kf_pt.device)[:, None].expand(K, N)
    cols = torch.where(m.kf_pt >= 0, m.kf_pt, P).long()  # invalid -> overflow col
    obs = torch.zeros((K, P + 1), dtype=torch.float32, device=m.kf_pt.device)
    obs = obs.index_put((rows, cols), torch.ones((), device=obs.device).expand(K, N),
                        accumulate=True)[:, :P]
    return obs * m.kf_valid[:, None].to(torch.float32)


def covisibility(m: MapState):
    """(K, K) shared-map-point counts (KeyFrame::UpdateConnections weight)."""
    return covisibility_of(incidence(m))


def covisibility_of(obs):
    """Covisibility from a (K, P) incidence matrix (one matmul)."""
    cov = obs @ obs.T
    return cov - torch.diag(torch.diagonal(cov))


def point_obs_counts(m: MapState):
    """(P,) number of keyframes observing each point."""
    return torch.sum(incidence(m) > 0, dim=0).to(torch.int32)


def predict_scale_level(dist, max_dist, n_levels: int = 8, scale_factor: float = 1.2):
    """Predicted pyramid octave of a point seen from ``dist`` (float);
    points without a computed band (max_dist >= 1e8) predict level 0."""
    ratio = torch.clamp(max_dist, min=1e-9) / torch.clamp(dist, min=1e-9)
    lvl = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / float(np.log(np.float32(scale_factor))))
    lvl = torch.clamp(lvl, 0, n_levels - 1)
    return torch.where(max_dist >= 1e8, 0.0, lvl)


# ---------------------------------------------------------------------------
# Mutations (functional: each returns a new MapState)
# ---------------------------------------------------------------------------


def _set_row(a, slot: int, value):
    out = a.clone()
    out[slot] = value
    return out


def add_keyframe(m: MapState, slot: int, pose, frame_id, uv, octave, angle, desc, kp_valid,
                 pt_ids, ur, depth) -> MapState:
    return m.replace(
        kf_pose=_set_row(m.kf_pose, slot, pose),
        kf_valid=_set_row(m.kf_valid, slot, True),
        kf_frame_id=_set_row(m.kf_frame_id, slot, frame_id),
        kf_uv=_set_row(m.kf_uv, slot, uv),
        kf_octave=_set_row(m.kf_octave, slot, octave),
        kf_angle=_set_row(m.kf_angle, slot, angle),
        kf_desc=_set_row(m.kf_desc, slot, desc),
        kf_kp_valid=_set_row(m.kf_kp_valid, slot, kp_valid),
        kf_pt=_set_row(m.kf_pt, slot, pt_ids),
        kf_ur=_set_row(m.kf_ur, slot, ur),
        kf_depth=_set_row(m.kf_depth, slot, depth),
    )


def scatter_last(base, idx, values):
    """``base`` with ``base[idx[i]] = values[i]``, the HIGHEST row i winning
    where indices repeat (XLA's scatter-set applies rows in order on the CPU,
    so the last writer wins there; CUDA's ``index_put_`` would pick any).
    Deterministic: the winning row index is a scatter-max, then a gather."""
    rows = torch.arange(idx.shape[0], device=idx.device)
    winner = torch.full((base.shape[0],), -1, dtype=torch.int64, device=idx.device)
    winner = winner.scatter_reduce(0, idx.long(), rows, "amax")
    hit = winner >= 0
    picked = values[winner.clamp(min=0)].to(base.dtype)
    return torch.where(hit.reshape(hit.shape + (1,) * (base.dim() - 1)), picked, base)


def _padset(arr, idx, vals):
    """Scatter-set that drops rows with index len(arr) (the reference's
    overflow-slot idiom)."""
    padded = torch.cat([arr, torch.zeros_like(arr[:1])], dim=0)
    return scatter_last(padded, idx, vals)[:-1]


def add_points(m: MapState, slots, pos, desc, normal, min_dist, max_dist, first_kf, valid,
               first_fid=None) -> MapState:
    """Write a batch of new points at ``slots``; invalid lanes write nowhere."""
    P = m.pt_pos.shape[0]
    slots = torch.where(valid, slots, P)
    if first_fid is None:
        first_fid = torch.full_like(first_kf, -1)
    return m.replace(
        pt_pos=_padset(m.pt_pos, slots, pos),
        pt_valid=_padset(m.pt_valid, slots, valid),
        pt_desc=_padset(m.pt_desc, slots, desc),
        pt_normal=_padset(m.pt_normal, slots, normal),
        pt_min_dist=_padset(m.pt_min_dist, slots, min_dist),
        pt_max_dist=_padset(m.pt_max_dist, slots, max_dist),
        pt_first_kf=_padset(m.pt_first_kf, slots, first_kf),
        pt_first_fid=_padset(m.pt_first_fid, slots, first_fid),
    )


def assign_observations(m: MapState, kf_slot: int, kp_idx, pt_ids, ok) -> MapState:
    """Set kf_pt[kf_slot, kp_idx] = pt_ids where ok (feature -> point links)."""
    N = m.kf_pt.shape[1]
    kp_idx = torch.where(ok, kp_idx, N)
    row = _padset(m.kf_pt[kf_slot], kp_idx, pt_ids.to(m.kf_pt.dtype))
    return m.replace(kf_pt=_set_row(m.kf_pt, kf_slot, row))
