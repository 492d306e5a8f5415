"""The port's span helper (``tpuslam_torch/utils/profiler.Spans``) and the
spans the ``Tracker`` opens: the frame program's ``frame_*``, the host's
waits ``wait_*`` and the keyframe chain's ``kf_*``, ``map_*`` and
``loop_*``, each timed into ``stage_ms`` and shown in a ``torch.profiler``
trace as ``tpuslam/<key>`` while a capture records.

The drive: the golden room at 320x240 with 512 features and loop closing
on, rendered by the port's renderer, on the CPU.  The tracker initializes
on frame 3 and makes a keyframe on frame 8; frames 0-6 run with no
profiler, frames 7-9 under one.  No JAX here.
"""

import json

import pytest
import torch

from tpuslam_torch.apps import common, golden
from tpuslam_torch.core.camera import Camera
from tpuslam_torch.frontend.tracking import Tracker
from tpuslam_torch.utils import profiler

torch.set_num_threads(2)

FRAMES, TRACED_FROM = 10, 7
FRAME_KEYS = {"frame_extract", "frame_motion", "frame_ref", "frame_localmap", "frame_pose_opt"}
WAIT_KEYS = {"wait_event", "wait_read"}
KF_KEYS = {"kf_add", "kf_semantic", "kf_mapping", "kf_loop"}
MAP_KEYS = {"map_tri", "map_fuse", "map_ba", "map_kfcull"}


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """The drive, with ``record_function`` replaced in the span helper by a
    stand-in that counts its entries and enters the real one."""
    entered = []
    real = profiler.record_function

    class Counted(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    cspec, cfg = golden.golden_setup(small=True, loops=True)
    frames = golden.render_golden(FRAMES, cspec, "cpu").frames
    cam = Camera.make(cspec.fx, cspec.fy, cspec.cx, cspec.cy, "cpu", width=cspec.width, height=cspec.height,
                      bf=cspec.fx * cspec.baseline)
    tracker = Tracker(cam, cfg, device="cpu")
    tracked = []  # frame ids whose call ran the frame program (tracking as the call began)
    path = tmp_path_factory.mktemp("spans") / "trace.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiler, "record_function", Counted)
        for f in range(TRACED_FROM):
            if tracker.state == tracker.OK:
                tracked.append(f)
            tracker.process_image(frames[f], f)
        entered_untraced = len(entered)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for f in range(TRACED_FROM, FRAMES):
                if tracker.state == tracker.OK:
                    tracked.append(f)
                tracker.process_image(frames[f], f)
        tracker.flush()
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    return {"tracker": tracker, "tracked": tracked, "events": events, "entered_untraced": entered_untraced,
            "entered_traced": entered[entered_untraced:]}


def test_drive_tracks_and_makes_a_keyframe(drive):
    tr = drive["tracker"]
    assert len(drive["tracked"]) >= 4 and drive["tracked"][-1] == FRAMES - 1
    assert any(made for *_, made in tr.kf_decisions)


def test_frame_and_wait_spans_are_in_stage_ms(drive):
    tr = drive["tracker"]
    assert FRAME_KEYS | WAIT_KEYS <= set(tr.stage_ms)
    n = len(drive["tracked"])
    for k in ("frame_extract", "frame_motion", "frame_ref", "frame_localmap"):
        assert tr.spans.count[k] == n  # once per tracked call
    assert tr.spans.count["frame_pose_opt"] == 3 * n  # one in each match
    s = tr.stage_ms
    assert 0 < s["frame_pose_opt"] <= s["frame_motion"] + s["frame_ref"] + s["frame_localmap"]
    assert all(v >= 0 for v in s.values())


def test_keyframe_and_loop_stage_keys_are_unchanged(drive):
    tr = drive["tracker"]
    assert {k for k in tr.stage_ms if k.startswith("kf_")} == KF_KEYS
    assert {k for k in tr.stage_ms if k.startswith("map_")} == MAP_KEYS
    # under 10 keyframes the detector stops after the BoW row
    assert set(tr.loop_closer.stage_ms) == {"bow"}
    assert set(tr.stage_ms) == FRAME_KEYS | WAIT_KEYS | KF_KEYS | MAP_KEYS


def test_report_splits_keyframe_and_frame_stages(drive):
    tr = drive["tracker"]
    rep = common.finish(tr, common.LoopTimes([0.1] * FRAMES, 1.0))
    assert set(rep["kf_stage_ms"]) == KF_KEYS | MAP_KEYS | {"loop_bow"}
    assert set(rep["frame_stage_ms"]) == FRAME_KEYS | WAIT_KEYS
    n_kf = len(tr._kf_fids)
    assert rep["kf_stage_ms"]["map_ba"] == pytest.approx(tr.stage_ms["map_ba"] / n_kf)
    assert rep["frame_stage_ms"]["frame_extract"] == pytest.approx(tr.stage_ms["frame_extract"]
                                                                   / len(drive["tracked"]))


def test_no_range_is_entered_without_a_profiler(drive):
    assert drive["entered_untraced"] == 0
    assert "tpuslam/frame_extract" in drive["entered_traced"]  # the stand-in sat where the helper looks


def _ranges(events, name):
    return [e for e in events if e.get("cat") == "user_annotation" and e["name"] == name]


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_trace_holds_one_extract_range_per_tracked_call(drive):
    events = drive["events"]
    extract = _ranges(events, "tpuslam/frame_extract")
    assert len(extract) == sum(f >= TRACED_FROM for f in drive["tracked"])
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    for r in extract:
        assert any(_inside(op, r) for op in ops)  # the extractor's aten ops nest inside
    motion = _ranges(events, "tpuslam/frame_motion")
    pose = _ranges(events, "tpuslam/frame_pose_opt")
    assert len(pose) == 3 * len(motion)
    assert all(any(_inside(p, m) for m in motion + _ranges(events, "tpuslam/frame_ref")
                   + _ranges(events, "tpuslam/frame_localmap")) for p in pose)
    # the keyframe chain on frame 8: its stages, and the loop closer's under its own prefix
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"tpuslam/kf_add", "tpuslam/kf_mapping", "tpuslam/map_ba", "tpuslam/loop_bow"} <= names
    (ba,) = _ranges(events, "tpuslam/map_ba")
    assert any(_inside(ba, m) for m in _ranges(events, "tpuslam/kf_mapping"))


def test_laps_add_each_closed_stage_and_drop_the_open_one():
    spans = profiler.Spans()
    with spans.laps("a") as lap:
        lap.next("b")
        lap.next("b")
        lap.next("c")  # left open: dropped
    assert spans.count == {"a": 1, "b": 2}
    with spans.laps("a") as lap:
        with spans.span("inner"):
            pass
        lap.end()
    assert spans.count == {"a": 2, "b": 2, "inner": 1}
    assert spans.ms["a"] >= spans.ms.get("inner", 0.0) >= 0.0


def test_spans_sum_into_the_owners_dict_and_nest_in_the_trace():
    owner = {"kept": 1.0}
    spans = profiler.Spans(owner, prefix="p_")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("outer"):
            with spans.span("inner"):
                torch.ones(3).sum()
        with spans.laps("one") as lap:
            lap.next("two")
            lap.end()
    assert set(owner) == {"kept", "outer", "inner", "one", "two"} and owner["kept"] == 1.0
    names = [e.name for e in prof.events()]
    for k in ("outer", "inner", "one", "two"):
        assert names.count(f"tpuslam/p_{k}") == 1
    with profiler.NO_SPANS.span("x"):
        pass
