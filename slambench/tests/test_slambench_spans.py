"""The per-span reduction of a traced stretch (``slambench/spans.py``) on a
handmade Chrome trace, and the frame-program span readers on fake runs."""

import pytest

from slambench import spans, tracing
from slambench.harness import FrameRec
from slambench.metrics import frame_extract_ms, frame_match_ms, frame_pose_opt_ms, host_wait_ms_per_frame


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# microseconds: extract [50, 90]; motion [100, 200] with its pose LM [120, 160]; map_ba [300, 400]
EVENTS = [
    _x("user_annotation", "tpuslam/frame_extract", 50, 40),
    _x("user_annotation", "tpuslam/frame_motion", 100, 100),
    _x("user_annotation", "tpuslam/frame_pose_opt", 120, 40),
    _x("user_annotation", "tpuslam/map_ba", 300, 100),
    _x("user_annotation", "not_a_span", 125, 5),
    _x("cpu_op", "aten::mul", 128, 4),
    _x("cuda_runtime", "cudaLaunchKernel", 60, 2, corr=5),
    _x("kernel", "k_extract", 70, 10, corr=5),
    _x("cuda_runtime", "cudaLaunchKernel", 105, 2, corr=1),
    _x("kernel", "k_motion", 110, 5, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 130, 2, corr=2),
    _x("kernel", "k_pose", 150, 20, corr=2),
    _x("gpu_memcpy", "Memcpy DtoH", 180, 5),
    _x("cuda_runtime", "cudaLaunchKernel", 250, 2, corr=3),
    _x("kernel", "k_between", 260, 20, corr=3),
    _x("cuda_driver", "cuLaunchKernel", 310, 2, corr=4),
    _x("kernel", "k_ba", 320, 10, corr=4),
    _x("kernel", "k_orphan", 350, 2, corr=99),  # launched before the capture
]


def test_each_launch_and_idle_microsecond_lands_on_its_innermost_span():
    t = spans.reduce_spans(EVENTS)
    assert set(t) == {"frame_extract", "frame_motion", "frame_pose_opt", "map_ba", spans.OUTSIDE}
    assert {k: r["ranges"] for k, r in t.items()} == {"frame_extract": 1, "frame_motion": 1, "frame_pose_opt": 1,
                                                      "map_ba": 1, spans.OUTSIDE: 0}
    assert t["frame_motion"]["host_ms"] == pytest.approx(0.1)  # whole, its pose LM inside
    assert {k: r["launches"] for k, r in t.items()} == {"frame_extract": 1, "frame_motion": 1,
                                                        "frame_pose_opt": 1, "map_ba": 1, spans.OUTSIDE: 2}
    assert t["frame_motion"]["launches_under"] == 2 and t["frame_pose_opt"]["launches_under"] == 1
    device = {k: r["device_ms"] for k, r in t.items()}
    assert device == pytest.approx({"frame_extract": 0.010, "frame_motion": 0.005, "frame_pose_opt": 0.020,
                                    "map_ba": 0.010, spans.OUTSIDE: 0.022})
    # gaps by their middle: [50,70] extract; [80,110] none; [115,150] pose LM; [170,180] motion;
    # [185,260] none; [280,320], [330,350], [352,400] map_ba
    idle = {k: r["idle_ms"] for k, r in t.items()}
    assert idle == pytest.approx({"frame_extract": 0.020, "frame_motion": 0.010, "frame_pose_opt": 0.035,
                                  "map_ba": 0.108, spans.OUTSIDE: 0.105})


def test_launches_and_idle_add_up_to_the_stretch():
    t = spans.reduce_spans(EVENTS)
    s = tracing.reduce_events(EVENTS)
    assert sum(r["launches"] for r in t.values()) == s["kernel_launches"] == 6
    idle_s = sum(r["idle_ms"] for r in t.values()) / 1e3
    assert abs(idle_s - (s["window_s"] - s["busy_s"])) < 1e-6


def test_sequential_laps_and_empty_traces():
    """Adjacent ranges (a lap closing as the next opens) and a trace with
    no span: everything lands outside."""
    events = [_x("user_annotation", "tpuslam/kf_add", 0, 10), _x("user_annotation", "tpuslam/kf_mapping", 10, 10),
              _x("cuda_runtime", "cudaLaunchKernel", 10, 1, corr=1), _x("kernel", "k", 12, 1, corr=1)]
    t = spans.reduce_spans(events)
    assert t["kf_mapping"]["launches"] == 1 and t["kf_add"]["launches"] == 0
    plain = [e for e in EVENTS if not e["name"].startswith(spans.PREFIX)]
    t = spans.reduce_spans(plain)
    assert set(t) == {spans.OUTSIDE} and t[spans.OUTSIDE]["launches"] == 6
    assert spans.frame_launches(t) is None and spans.launches_per_range(t, "map_ba") is None
    assert spans.reduce_spans([]) == {}


def test_launch_readings_and_the_table():
    t = spans.reduce_spans(EVENTS)
    assert spans.frame_launches(t) == 3.0  # extract 1, motion 1, pose LM 1 over one extract range
    assert spans.launches_per_range(t, "map_ba") == 1.0
    lines = spans.format_table(t)
    assert lines[0].startswith("span") and len(lines) == 1 + len(t)


def _rec(fid, tracking, kind="hot", call_s=0.1):
    return FrameRec(fid=fid, t_start=0.0, tracking=tracking, kf_before=0, kind=kind, call_s=call_s)


def test_hot_call_share():
    """Keyframe calls are left out, and so is the hook's time (the profiler
    starting) in the call it ran in."""
    a, b, c = _rec(0, True, call_s=1.1), _rec(1, True, kind="keyframe"), _rec(2, True)
    snaps = [(a, {}, 1.0), (b, {"frame_extract": 20.0, "frame_motion": 50.0, "map_ba": 5.0}, 0.0),
             (c, {"frame_extract": 40.0, "frame_motion": 100.0, "map_ba": 500.0}, 0.0),
             (None, {"frame_extract": 60.0, "frame_motion": 150.0, "wait_event": 20.0}, 0.0)]
    got = spans.hot_call_share(snaps)
    assert got["hot_calls"] == 2 and got["covered_share"] == pytest.approx((70.0 + 90.0) / 200.0)
    assert got["hot_call_ms_mean"] == pytest.approx(100.0)


def _run(stage, tracking=(False, True, True, True)):
    return {"calls": [_rec(i, t) for i, t in enumerate(tracking)],
            "counters": {"stage_ms": stage, "waits": 4, "keyframes": 1}, "trace": {}}


STAGE = {"frame_extract": 30.0, "frame_motion": 60.0, "frame_ref": 90.0, "frame_localmap": 150.0,
         "frame_pose_opt": 240.0, "wait_event": 6.0, "wait_read": 2.0, "map_ba": 100.0}


def test_frame_readers_on_a_fake_run():
    run = _run(STAGE)
    assert frame_extract_ms.read(run) == pytest.approx(10.0)  # three tracked calls
    assert frame_match_ms.read(run) == pytest.approx((60.0 + 90.0 + 150.0 - 240.0) / 3)
    assert frame_pose_opt_ms.read(run) == pytest.approx(80.0)
    assert host_wait_ms_per_frame.read(run) == pytest.approx(8.0 / 4)  # four frames handed in


@pytest.mark.parametrize("reader", [frame_extract_ms, frame_match_ms, frame_pose_opt_ms, host_wait_ms_per_frame])
def test_frame_readers_give_none_without_their_spans(reader):
    """A program without the spans (the keyframe chain's alone), or a window
    without a tracked call."""
    assert reader.read(_run({"map_ba": 100.0, "kf_add": 1.0})) is None
    if reader is not host_wait_ms_per_frame:
        assert reader.read(_run(STAGE, tracking=(False, False))) is None
    else:
        assert reader.read({**_run(STAGE), "calls": []}) is None
