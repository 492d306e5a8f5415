"""The session scheduler, the harness's spans and the window's arithmetic,
under a fake program and a fake clock."""

import numpy as np
import pytest

from slambench import harness


class Clock:
    """Whole milliseconds, so that sums of steps compare exactly."""

    def __init__(self):
        self.ms = 0

    def __call__(self):
        return self.ms / 1000

    def advance(self, seconds):
        self.ms += round(seconds * 1000)


class FakeTracker:
    """Pipelined like the port's: frame ``init_at`` initializes and returns
    its pose in its own call; each later frame's pose is appended during the
    next call (or the flush); frames in ``lost`` never get one; every
    ``kf_every``-th tracked frame's commit makes a keyframe."""

    OK = 1

    def __init__(self, init_at=2, lost=(), kf_every=3):
        self.state, self.trajectory, self.kf_decisions = 0, [], []
        self.init_at, self.lost, self.kf_every = init_at, set(lost), kf_every
        self.pending = None

    def _commit(self, fid):
        if fid in self.lost:
            return
        self.trajectory.append((fid, np.eye(4)))
        self.kf_decisions.append((fid, {}, fid % self.kf_every == 0))

    def process(self, fid):
        if self.state != self.OK:
            if fid == self.init_at:
                self.state = self.OK
                self.trajectory.append((fid, np.eye(4)))
            return
        if self.pending is not None:
            self._commit(self.pending)
        self.pending = fid

    def flush(self):
        if self.pending is not None:
            self._commit(self.pending)
            self.pending = None


class FakeProgram:
    def __init__(self, clock, call_s=0.1, **tracker_kw):
        self.clock, self.call_s, self.tracker_kw = clock, call_s, tracker_kw
        self.made = 0

    def make_tracker(self, config, device):
        self.made += 1
        return FakeTracker(**self.tracker_kw)

    def tracking(self, tracker):
        return tracker.state == tracker.OK

    def keyframes_made(self, tracker):
        return sum(1 for *_, m in tracker.kf_decisions if m)

    def scale_changes(self, tracker):
        return 0

    def counters(self, tracker):
        return {"stage_ms": {"map_ba": 10.0 * self.keyframes_made(tracker)}, "waits": len(tracker.trajectory),
                "keyframes": self.keyframes_made(tracker)}

    def run_loop(self, tracker, items, hook):
        """``run_loop``'s order: the next item is drawn before the current
        frame's hook and call."""
        it = iter(items)
        cur, times = next(it, None), []
        while cur is not None:
            nxt = next(it, None)
            hook(cur)
            t0 = self.clock()
            tracker.process(cur[0])
            self.clock.advance(self.call_s)
            times.append(self.clock() - t0)
            cur = nxt
        tracker.flush()
        return times


class FakeClip:
    def __init__(self, n):
        self.frames = list(range(n))
        self.detections = None


def window(seconds=1.5, n=10, **kw):
    clock = Clock()
    prog = FakeProgram(clock, **kw)
    return harness.run_window(prog, {}, FakeClip(n), seconds, "cpu", clock), prog


def test_sessions_back_to_back_and_cut_at_the_close():
    win, prog = window()
    assert prog.made == 2 and len(win.sessions) == 2
    s0, s1 = win.sessions
    assert s0.completed and s0.attempted == 10
    assert not s1.completed and s1.attempted == 6  # items drawn at 1.0, 1.0, 1.1, ..., 1.4
    assert win.attempted() == 16


def test_pose_return_times_and_latency():
    win, _ = window()
    s0, s1 = win.sessions
    lat = {f.fid: round(f.t_return - f.t_start, 9) for f in s0.frames if f.t_return is not None}
    assert lat[2] == 0.1  # the initializing call returns its own pose
    assert all(lat[k] == 0.2 for k in range(3, 9))  # a pipelined pose returns at the end of the next call
    assert lat[9] == 0.1  # the last one in the loop's flush
    assert [f.fid for f in s0.frames if f.t_return is None] == [0, 1]
    # the second session: poses 2 and 3 return by 1.5, 4 and 5 in the flush at 1.6
    assert {f.fid: round(f.t_return, 9) for f in s1.frames if f.t_return is not None} == {2: 1.3, 3: 1.5, 4: 1.6,
                                                                                             5: 1.6}
    e2e = harness.end_to_end(win)
    assert e2e["poses"] == 10
    assert e2e["frames_per_s"] == pytest.approx(10 / 1.5)
    lats = [(f.t_return - f.t_start) * 1e3 for f in win.returned()]
    assert e2e["pose_ms_p90"] == pytest.approx(np.percentile(lats, 90))


def test_call_kinds():
    win, _ = window(seconds=1.0, n=10)
    kinds = {f.fid: f.kind for f in win.sessions[0].frames}
    assert kinds[0] == kinds[1] == kinds[2] == "init"
    # frame k's keyframe decision is made in call k+1: fids 3, 6, 9 make one
    # 9's is made in the loop's flush, which no hook separates from the last call
    assert [k for k, v in kinds.items() if v == "keyframe"] == [4, 7, 9]
    assert kinds[3] == "hot"
    assert [round(f.call_s, 9) for f in win.sessions[0].frames] == [0.1] * 10


@pytest.mark.parametrize("q", [0, 10, 50, 90, 95, 100])
def test_percentile_matches_numpy(q):
    xs = list(np.random.default_rng(3).exponential(size=37))
    assert harness.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_failed_counts_lost_frames_after_the_first_pose():
    win, _ = window(seconds=1.0, n=10, lost=(5, 7))
    assert win.failed() == 2


def test_failed_counts_a_whole_clip_that_never_initializes():
    win, _ = window(seconds=1.0, n=10, init_at=99)
    assert win.sessions[0].completed and win.failed() == 10


def test_a_cut_session_before_its_first_pose_is_not_failed():
    win, _ = window(seconds=1.05, n=10, init_at=99)
    s1 = win.sessions[1]
    assert not s1.completed and s1.failed() == 0
    assert win.failed() == 10


def test_counters_summed_over_sessions():
    win, _ = window()
    c = win.counters()
    assert c["keyframes"] == sum(s.counters["keyframes"] for s in win.sessions)
    assert c["stage_ms"]["map_ba"] == pytest.approx(10.0 * c["keyframes"])


def test_warmup_stops_once_the_keyframes_are_made():
    clock = Clock()
    prog = FakeProgram(clock)
    s = harness.Session(index=-1)
    s.run(prog, prog.make_tracker({}, "cpu"), FakeClip(30), float("inf"), clock, until_keyframes=2)
    # keyframes are decided for fids 3 and 6 in the calls of 4 and 7; the
    # loop drew item 8 before 7's call, and draws none after it
    assert not s.completed and s.attempted == 9
    assert s.counters["keyframes"] == 2


def test_items_carry_the_streams_the_sensor_takes():
    from slambench.clip import item

    clip = FakeClip(4)
    assert item(clip, 2) == (2, 2)
    clip.extra = (["d0", "d1", "d2", "d3"],)
    assert item(clip, 2) == (2, 2, "d2")


def test_per_session_summary():
    win, _ = window()
    s0, s1 = (s.summary() for s in win.sessions)
    assert s0["completed"] and s0["attempted"] == 10 and s0["poses"] == 8
    assert s0["hot_ms_p50"] == pytest.approx(100.0)
    assert s0["poses_per_s"] == pytest.approx(8 / 1.0)
    assert s0["map_ba_ms_per_kf"] == pytest.approx(10.0)
    assert not s1["completed"] and s1["poses"] == 4


def test_a_cut_session_finished_late_counts_in_no_window_figure():
    clock = Clock()
    prog = FakeProgram(clock)
    win = harness.run_window(prog, {}, FakeClip(10), 0.5, "cpu", clock)
    s = win.sessions[0]
    assert len(win.sessions) == 1 and not s.completed and s.attempted == 6
    before = (harness.end_to_end(win), win.attempted(), win.failed(), win.counters(), s.summary())
    s.finish(prog, FakeClip(10), clock)
    assert s.late and not s.completed and s.attempted == 6
    assert [f.fid for f in s.frames] == list(range(10))
    assert [f for f, _ in s.tracker.trajectory] == [2, 3, 4, 5, 6, 7, 8, 9]
    assert (harness.end_to_end(win), win.attempted(), win.failed(), win.counters()) == before[:4]
    assert s.summary() == {**before[4], "late": True}
