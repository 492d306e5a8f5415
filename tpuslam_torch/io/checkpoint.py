"""Map and tracker checkpoints (port of ``tpuslam/io/checkpoint.py``).

The file is the reference's: one npz entry per ``MapState`` field, by name
and in the reference's order, plus ``__meta__``, the JSON of
``{"format_version": 1, "extra": {...}}`` as uint8 bytes, written with
``np.savez_compressed``.  Packed descriptors (``kf_desc``, ``pt_desc``) are
stored as uint32, as the JAX package holds them, and become the port's int32
words by a bit view (never a value cast); bool fields stay bool.  So a
checkpoint written by either package loads in the other with every field
equal.
"""

from __future__ import annotations

import json

import numpy as np

from ..map import mapstate as ms

_FORMAT_VERSION = 1


def save_map(path: str, m: ms.MapState, extra: dict | None = None) -> None:
    """Write a MapState (and scalar metadata ``extra``) to ``path`` (npz)."""
    arrays = ms.map_to_numpy(m)
    meta = {"format_version": _FORMAT_VERSION, "extra": extra or {}}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8).copy()
    np.savez_compressed(path, **arrays)


def load_map(path: str, device="cuda:0"):
    """``(MapState on device, extra dict)`` from an npz checkpoint."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8")) if "__meta__" in z.files else {}
        missing = [f for f in ms.FIELDS if f not in z.files]
        if missing:
            raise ValueError(f"checkpoint {path} missing map fields: {missing}")
        m = ms.map_from_numpy({f: z[f] for f in ms.FIELDS}, device)
    return m, meta.get("extra", {})


def save_tracker(path: str, tracker) -> None:
    """Checkpoint a Tracker: the map and the host state machine, with the
    reference's ``extra`` keys."""
    tracker.flush()
    tracker._resolve_pending_alloc()
    extra = {
        "state": int(tracker.state),
        "n_kf": int(tracker.n_kf),
        "n_pt": int(tracker.n_pt),
        "n_plane": int(tracker.n_plane),
        "n_cub": int(tracker.n_cub),
        "ref_kf": int(tracker.ref_kf),
        "frames_since_kf": int(tracker.frames_since_kf),
        "T_cur": np.asarray(tracker.T_cur).tolist(),
        "velocity": np.asarray(tracker.velocity).tolist(),
        "trajectory": [[int(fid), np.asarray(T).tolist()] for fid, T in tracker.trajectory],
        "kf_fids": [int(f) for f in tracker._kf_fids],
    }
    save_map(path, tracker.map, extra=extra)


def load_tracker(path: str, cam, cfg, device="cuda:0", vocab=None):
    """A Tracker on ``device`` restored from a checkpoint.  It resumes LOST
    when it was mid-sequence (the last frame's features are not saved): the
    next frame relocalizes against the restored keyframes, and the tiny-map
    reset never fires on a restored map (``_resumed``)."""
    from ..frontend.tracking import Tracker

    tracker = Tracker(cam, cfg, device=device, vocab=vocab)
    m, extra = load_map(path, tracker.device)
    tracker.map = m
    tracker.n_kf = extra["n_kf"]
    tracker.n_pt = extra["n_pt"]
    tracker.n_plane = extra["n_plane"]
    tracker.n_cub = extra["n_cub"]
    tracker.ref_kf = extra["ref_kf"]
    tracker.frames_since_kf = extra["frames_since_kf"]
    tracker.T_cur = np.array(extra["T_cur"], np.float32)
    tracker.velocity = np.array(extra["velocity"], np.float32)
    tracker.trajectory = [(fid, np.array(T, np.float32)) for fid, T in extra["trajectory"]]
    tracker._kf_fids = [int(f) for f in extra.get("kf_fids", [])]
    kf_valid, kf_fid = (x.cpu().numpy() for x in (m.kf_valid, m.kf_frame_id))
    tracker._kf_slot_fid = {int(s): int(kf_fid[s]) for s in np.flatnonzero(kf_valid)}
    tracker.state = Tracker.LOST if extra["state"] != Tracker.NOT_INITIALIZED else Tracker.NOT_INITIALIZED
    tracker._resumed = True
    return tracker
