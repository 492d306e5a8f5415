"""Covisibility-clustered keyframe partitioning for distributed BA (port of
``tpuslam/dist/shard.py``).

Keyframes are partitioned into balanced clusters that keep strongly
covisible keyframes together, and each cluster's factors are placed in one
rank's slice of the factor axis, so that most landmark contributions stay on
one rank and the all-reduce of ``dist/ba.py`` reconciles the frontier.  The
partitioner is the reference's host-side greedy balanced graph grower
(numpy, copied); the reorder gathers the bundles' tensors on their device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph import lm


def cluster_keyframes(cov: np.ndarray, kf_valid: np.ndarray, n_clusters: int) -> np.ndarray:
    """Partition keyframes into ``n_clusters`` balanced clusters.

    ``cov`` (K, K) covisibility weights (shared map-point counts),
    ``kf_valid`` (K,) mask.  Returns (K,) int32 cluster ids (-1 for invalid
    keyframes).

    Greedy growth: seed each cluster with the highest-degree unassigned
    keyframe, then repeatedly give the cluster with the fewest members its
    most-connected unassigned keyframe (capacity-bounded balance)."""
    cov = np.asarray(cov)
    kf_valid = np.asarray(kf_valid).astype(bool)
    K = cov.shape[0]
    ids = np.where(kf_valid)[0]
    out = np.full(K, -1, np.int32)
    if len(ids) == 0:
        return out
    n_clusters = max(1, min(n_clusters, len(ids)))
    cap = -(-len(ids) // n_clusters)

    degree = cov[np.ix_(ids, ids)].sum(axis=1)
    unassigned = set(ids.tolist())
    members: list[list[int]] = []
    order = ids[np.argsort(-degree)]
    for s in order[:n_clusters]:
        members.append([int(s)])
        out[s] = len(members) - 1
        unassigned.discard(int(s))

    while unassigned:
        c = min((ci for ci in range(len(members)) if len(members[ci]) < cap),
                key=lambda ci: len(members[ci]), default=None)
        if c is None:
            c = min(range(len(members)), key=lambda ci: len(members[ci]))
        cand = np.fromiter(unassigned, dtype=np.int64)
        affinity = cov[np.ix_(members[c], cand)].sum(axis=0)
        pick = int(cand[np.argmax(affinity)])
        members[c].append(pick)
        out[pick] = c
        unassigned.discard(pick)
    return out


def _gather(bundle, take: np.ndarray, keep: np.ndarray):
    """The bundle's rows ``take``, ``valid`` cleared where ``keep`` is False."""
    dev = bundle.valid.device
    t = torch.from_numpy(take).to(dev)
    fields = {k: v[t] for k, v in bundle._asdict().items()}
    fields["valid"] = fields["valid"] & torch.from_numpy(keep).to(dev)
    return type(bundle)(**fields)


def _partition_bundle(bundle, cluster_of_kf: np.ndarray, n_clusters: int):
    """Reorder a factor bundle so that the factors of cluster c fill slot c's
    contiguous span, every span padded to the largest cluster's factor
    count (pad factors are invalid).  Returns a bundle with leading dim
    ``n_clusters * span``."""
    kf = bundle.kf.cpu().numpy()
    valid = bundle.valid.cpu().numpy().astype(bool)
    cl = np.where(valid, cluster_of_kf[kf], -1)
    per = [np.where(cl == c)[0] for c in range(n_clusters)]
    span = max(1, max((len(p) for p in per), default=1))
    take = np.zeros(n_clusters * span, np.int64)
    keep = np.zeros(n_clusters * span, bool)
    for c, p in enumerate(per):
        take[c * span:c * span + len(p)] = p
        keep[c * span:c * span + len(p)] = True
    return _gather(bundle, take, keep)


def _spread_bundle(bundle, n_clusters: int):
    """Round-robin a bundle with no keyframe axis (the point-cuboid and
    cuboid-plane factors) into ``n_clusters`` equal spans."""
    n = bundle.valid.shape[0]
    total = n_clusters * max(1, -(-n // n_clusters))
    return _gather(bundle, np.arange(total) % max(n, 1), np.arange(total) < n)


def partition_data(data: lm.BAData, cluster_of_kf: np.ndarray, n_clusters: int) -> lm.BAData:
    """Cluster-align every factor bundle of a BAData (the reorder of the
    reference's ``partition_data``): the factor axes divide by
    ``n_clusters``, so that splitting them over ``n_clusters`` ranks puts
    cluster c's factors on rank c."""
    cluster_of_kf = np.asarray(cluster_of_kf)
    out = {}
    for key in ("mono", "stereo", "plane_obs", "cub_bbox", "cub_corner", "cub_se3"):
        b = getattr(data, key)
        if b is not None:
            out[key] = _partition_bundle(b, cluster_of_kf, n_clusters)
    for key in ("pt_cub", "cub_plane"):
        b = getattr(data, key)
        if b is not None:
            out[key] = _spread_bundle(b, n_clusters)
    return data._replace(**out)
